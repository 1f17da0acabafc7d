"""Host-side data helpers of the port: the telemetry contract,
featurization, windowing.

The public names are the JAX package's (``deeprest_tpu/data/__init__.py``),
each loaded from its module when first read."""

from deeprest_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "Span": "schema", "MetricSample": "schema", "Bucket": "schema",
    "load_raw_data": "schema",
    "CallPathSpace": "featurize", "featurize_buckets": "featurize",
    "count_invocations": "featurize",
    "sliding_windows": "windows", "MinMaxStats": "windows",
    "minmax_fit": "windows", "minmax_apply": "windows",
    "minmax_invert": "windows",
    "TraceSynthesizer": "synthesize",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
