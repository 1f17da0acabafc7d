"""Parameter interchange between the JAX package's trees and the port.

The port keeps the JAX leaf names and shapes: ``mask_w1/b1/w2/b2``,
``gru_{fwd,bwd}[_l{n}]_{w_ih,w_hh,b_ih,b_hh}`` (``w_ih [E, F, 3H]``,
``w_hh [E, H, 3H]``, gate order r, z, n) and ``head_w [E, 2D, Q]``,
``head_b [E, Q]``.  Arrays cross as numpy, so neither side imports the
other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _tensor_from_numpy(name: str, leaf) -> torch.Tensor:
    """A copy of one numpy leaf as a CPU tensor; a bf16 leaf (ml_dtypes'
    type, which torch cannot read) crosses as its bits."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.uint16))).view(
            torch.bfloat16)
    if arr.dtype.char not in "?bhilqBHILQefdFD":
        raise TypeError(f"leaf {name!r} has dtype {arr.dtype}; pass "
                        "float32 (or other numpy-native) arrays")
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A nested dict of numpy arrays (a flax ``params`` tree with each leaf
    copied by ``np.array``) → the port's flat parameter dict of CPU tensors.
    Nested keys join with "/"; the QuantileGRU tree is flat already."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), value)
            return
        out[prefix] = _tensor_from_numpy(prefix, node)
    walk("", tree)
    return out


def quant_params_from_jax(tree: Mapping) -> dict:
    """A JAX quantized serving tree (``deeprest_tpu.ops.quantize.
    quantize_params`` output, leaves copied to numpy; a ``QuantTensor``
    leaf is any object with ``data`` and ``scale``) → the port's flat dict
    of CPU tensors with ``ops.quantize.QuantTensor`` leaves: the same int8
    bytes, f32 scales and bf16 bits."""
    from deeprest_tpu_torch.ops.quantize import QuantTensor

    out: dict = {}
    for name, leaf in tree.items():
        if hasattr(leaf, "data") and hasattr(leaf, "scale"):
            out[name] = QuantTensor(
                data=_tensor_from_numpy(f"{name}.data", leaf.data),
                scale=_tensor_from_numpy(f"{name}.scale", leaf.scale))
        else:
            out[name] = _tensor_from_numpy(name, leaf)
    return out


def baseline_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The ResourceAware MLP's JAX params (``{"w1": [W, H], "b1": [H], "w2":
    [H, W], "b2": [W]}``, numpy arrays) → float32 CPU tensors under the same
    names, for ``ResourceAwareBaseline(...).fit_and_estimate(y,
    init_params=...)``."""
    from deeprest_tpu_torch.models.baselines import MLP_LEAVES

    missing = sorted(set(MLP_LEAVES) - set(tree))
    extra = sorted(set(tree) - set(MLP_LEAVES))
    if missing or extra:
        raise KeyError(f"baseline params want leaves {list(MLP_LEAVES)}; "
                       f"missing {missing}, unexpected {extra}")
    flat = params_from_jax({k: tree[k] for k in MLP_LEAVES})
    return {k: v.float() for k, v in flat.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's parameter dict → a flat dict of numpy arrays (bf16 leaves
    widen to float32, which numpy can hold exactly)."""
    out = {}
    for name, value in params.items():
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
