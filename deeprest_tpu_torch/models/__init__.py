"""Models of the port: the multi-task quantile GRU and the two baselines.

The public names are the JAX package's
(``deeprest_tpu/models/__init__.py``), each loaded from its module when
first read."""

from deeprest_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "QuantileGRU": "qrnn",
    "ResourceAwareBaseline": "baselines",
    "ComponentAwareBaseline": "baselines",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
