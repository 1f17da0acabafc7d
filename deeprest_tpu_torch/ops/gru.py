"""Expert-batched GRU (``deeprest_tpu/ops/gru.py``).

All experts run together with the expert axis ``E`` leading every weight.
The input projection ``x @ W_ih + b_ih`` has no sequential dependency, so
it is one large matmul over all time steps before the recurrence (left to
torch, as the JAX package leaves it to XLA, so its backward is torch's
too); only the hidden-to-hidden product stays inside the time loop, which
:func:`~deeprest_tpu_torch.ops.cuda_gru.gru_recurrence` runs: the CUDA
kernels for a CUDA tensor, the plain versions for a CPU tensor.  Both
functions are differentiable: with autograd recording, the recurrence goes
through the training forward and the backward kernel; without it, through
the inference forward alone.  The ``rnn_backend`` a config names plays no
part.

Window coalescing (``GroupSpec``, ``coalesce_windows``,
``split_coalesced``, ``gru_coalesced``, ``bidirectional_gru_coalesced``)
folds G independent window batches ``[G, B, T, F]`` into the row axis of
one recurrence call over G·B rows: the groups share ``W_hh``, so the fold
is a reshape, and each group's rows are computed as a standalone call
would compute them.

Feature-axis tensor parallelism (the mesh's ``model`` axis): with
``tp_group``, ``x`` holds this rank's slice of F and ``W_ih`` its shard
``[E, F/M, 3H]``; each rank's partial product is cast to f32, summed over
the model group (``parallel.collectives.reduce_replicated``: what runs
after it is replicated over the group, so its backward is the identity),
and ``b_ih`` is added once, after the sum.  The recurrence then sees the
whole projection, as without a mesh.

``BIDIR_FUSED`` (``DEEPREST_GRU_BIDIR_FUSED=1``, default off as in the JAX
package) makes :func:`bidirectional_gru` stack both directions on the
expert axis of one recurrence call, the backward direction's projections
flipped in time: one K1 launch per layer instead of two, one K2 and one K3
under autograd.

Dtype contract (``_kernel_io_dtype`` / ``_dot_dtype_for`` /
``_out_dtype_for`` of the JAX package): a bf16 projection stays bf16 and
``W_hh`` goes to the recurrence in that dtype, ``b_hh`` and ``h0`` in f32;
the carry and the gate math are f32, bf16 dots accumulate in f32, and h is
stored in the projection's dtype.  Gate order is (r, z, n), and
``n = tanh(x_n + b_in + r * (h @ W_hn + b_hn))`` as in torch's own GRU.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

from deeprest_tpu_torch.ops.cuda_gru import gru_recurrence, kernel_io_dtype

Recurrence = Callable[..., torch.Tensor]

# Both directions in one recurrence call (``ops/gru.py::BIDIR_FUSED`` of the
# JAX package, off there since its TPU runs never showed a win).  Read at
# every call, so the tuning sweep and the tests may set the module global.
BIDIR_FUSED = os.environ.get("DEEPREST_GRU_BIDIR_FUSED", "0") == "1"


class GRUParams(NamedTuple):
    """One direction of weights with a leading expert axis: ``w_ih [E, F,
    3H]``, ``w_hh [E, H, 3H]``, ``b_ih [E, 3H]``, ``b_hh [E, 3H]``."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[-2]


def resolve_weights(params: GRUParams) -> GRUParams:
    """Dequantize-at-use for quantized serving weights (a
    ``ops.quantize.QuantTensor`` ``w_ih`` or ``w_hh``), identity otherwise.
    Called at the top of :func:`gru` and :func:`bidirectional_gru` (the
    coalesced forms delegate to them), so every recurrence path shares the
    one dequant site, ``ops.quantize.dequantize``."""
    from deeprest_tpu_torch.ops.quantize import QuantTensor, dequantize

    if isinstance(params.w_ih, QuantTensor) \
            or isinstance(params.w_hh, QuantTensor):
        return params._replace(w_ih=dequantize(params.w_ih),
                               w_hh=dequantize(params.w_hh))
    return params


def init_gru_params(key, num_experts: int, input_size: int,
                    hidden_size: int, dtype: torch.dtype = torch.float32,
                    device=None) -> GRUParams:
    """Uniform(-1/sqrt(H), 1/sqrt(H)) init, the torch GRU default, on
    ``device`` (None: CUDA).  ``key`` is a numpy seed or
    ``np.random.Generator``; the JAX package's function draws the same
    distribution from its own PRNG, so the two agree in shapes, dtypes and
    bounds, not in values."""
    import numpy as np

    from deeprest_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(key)
    k = 1.0 / np.sqrt(hidden_size)
    shapes = [(num_experts, input_size, 3 * hidden_size),
              (num_experts, hidden_size, 3 * hidden_size),
              (num_experts, 3 * hidden_size),
              (num_experts, 3 * hidden_size)]
    return GRUParams(*[
        torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(
            device=dev, dtype=dtype)
        for s in shapes])


def _project(params: GRUParams, x: torch.Tensor,
             tp_group=None) -> torch.Tensor:
    """``x @ W_ih + b_ih`` → contiguous ``[E, T, B, 3H]`` in the
    recurrence's io dtype.  ``x`` is ``[B, T, F]`` shared by all experts or
    ``[E, B, T, F]``; with ``tp_group`` its F slice and ``W_ih``'s shard,
    the f32 partial products summed over the group before ``b_ih``."""
    eq = "btf,efg->etbg" if x.dim() == 3 else "ebtf,efg->etbg"
    if tp_group is None:
        proj = torch.einsum(eq, x, params.w_ih) + params.b_ih[:, None, None, :]
        return proj.to(kernel_io_dtype(proj.dtype)).contiguous()
    from deeprest_tpu_torch.parallel.collectives import reduce_replicated

    partial = torch.einsum(eq, x, params.w_ih)
    io = kernel_io_dtype(torch.promote_types(partial.dtype,
                                             params.b_ih.dtype))
    proj = (reduce_replicated(partial.float(), tp_group)
            + params.b_ih.float()[:, None, None, :])
    return proj.to(io).contiguous()


def gru(params: GRUParams, x: torch.Tensor, h0: torch.Tensor | None = None,
        reverse: bool = False,
        recurrence: Recurrence | None = None,
        tp_group=None) -> torch.Tensor:
    """Single-direction GRU over the time axis.

    ``x``: ``[E, B, T, F]`` or ``[B, T, F]`` shared across experts; ``h0``:
    ``[E, B, H]`` (zeros if None).  With ``reverse`` the sequence runs back
    to front and the output stays time-aligned with ``x``.  ``recurrence``
    replaces the device dispatch of ``cuda_gru.gru_recurrence`` (a caller
    that wants the plain version on a CUDA tensor passes
    ``gru_recurrence_reference``).  ``tp_group``: ``x`` and ``W_ih`` hold
    this rank's F slice (see the module docstring).  Returns ``[E, B, T,
    H]`` in x's dtype.
    """
    params = resolve_weights(params)
    proj = _project(params, x, tp_group)
    e, _, b, _ = proj.shape
    if h0 is None:
        h0 = torch.zeros((e, b, params.hidden_size), dtype=torch.float32,
                         device=x.device)
    run = recurrence or gru_recurrence
    h_all = run(proj, params.w_hh.to(proj.dtype).contiguous(),
                params.b_hh.float().contiguous(), h0.float().contiguous(),
                reverse)
    return h_all.permute(0, 2, 1, 3).to(x.dtype)


def _bidirectional_fused(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                         recurrence: Recurrence | None,
                         tp_group=None) -> torch.Tensor:
    """Both directions in one recurrence call (``_bidir_pallas``): the
    backward direction's projections flipped in time and stacked after the
    forward's on the expert axis (2E), one forward-in-time run, the result
    split and the backward half flipped back.  Under autograd the flips
    and the split are torch ops, so the gradients route back by
    themselves."""
    proj_f = _project(fwd, x, tp_group)
    proj_b = _project(bwd, x, tp_group).flip(1)
    proj = torch.cat([proj_f, proj_b], dim=0)
    e, _, b, _ = proj_f.shape
    w_hh = torch.cat([fwd.w_hh, bwd.w_hh]).to(proj.dtype).contiguous()
    b_hh = torch.cat([fwd.b_hh, bwd.b_hh]).float().contiguous()
    h0 = torch.zeros((2 * e, b, fwd.hidden_size), dtype=torch.float32,
                     device=x.device)
    h_all = (recurrence or gru_recurrence)(proj, w_hh, b_hh, h0, False)
    out = torch.cat([h_all[:e], h_all[e:].flip(1)], dim=-1)    # [E,T,B,2H]
    return out.permute(0, 2, 1, 3).to(x.dtype)


def bidirectional_gru(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                      recurrence: Recurrence | None = None,
                      tp_group=None) -> torch.Tensor:
    """``[E, B, T, F]`` (or shared ``[B, T, F]``) → ``[E, B, T, 2H]``; the
    last-axis halves are (forward, backward), each time-aligned with x.
    Two recurrence calls, or one over both directions with
    :data:`BIDIR_FUSED`.  ``tp_group`` as for :func:`gru`."""
    fwd, bwd = resolve_weights(fwd), resolve_weights(bwd)
    if BIDIR_FUSED:
        return _bidirectional_fused(fwd, bwd, x, recurrence, tp_group)
    out_f = gru(fwd, x, reverse=False, recurrence=recurrence,
                tp_group=tp_group)
    out_b = gru(bwd, x, reverse=True, recurrence=recurrence,
                tp_group=tp_group)
    return torch.cat([out_f, out_b], dim=-1)


# ---------------------------------------------------------------------------
# window-coalesced batching
# ---------------------------------------------------------------------------


class GroupSpec(NamedTuple):
    """``groups`` independent window batches of ``rows`` windows each,
    stacked group-major on the recurrence's row axis as ``[G·B, ...]``.
    Every group starts from its own h0 and rows never interact, so the
    descriptor is split bookkeeping only."""

    groups: int
    rows: int

    @property
    def coalesced_rows(self) -> int:
        return self.groups * self.rows


def coalesce_windows(x: torch.Tensor) -> tuple[torch.Tensor, GroupSpec]:
    """``[G, B, T, F] → ([G·B, T, F], GroupSpec)``: fold the groups into
    the row axis (group-major, a reshape)."""
    if x.dim() != 4:
        raise ValueError(f"expected [G, B, T, F] window groups, got shape "
                         f"{tuple(x.shape)}")
    g, b = x.shape[:2]
    return x.reshape(g * b, *x.shape[2:]), GroupSpec(groups=g, rows=b)


def split_coalesced(h: torch.Tensor, spec: GroupSpec) -> torch.Tensor:
    """``[E, G·B, T, D] → [E, G, B, T, D]``: unfold a coalesced GRU output
    back to per-group batches."""
    if h.shape[1] != spec.coalesced_rows:
        raise ValueError(
            f"coalesced output has {h.shape[1]} rows; spec says "
            f"{spec.groups}x{spec.rows}={spec.coalesced_rows}")
    return h.reshape(h.shape[0], spec.groups, spec.rows, *h.shape[2:])


def gru_coalesced(params: GRUParams, x: torch.Tensor,
                  h0: torch.Tensor | None = None, reverse: bool = False,
                  recurrence: Recurrence | None = None) -> torch.Tensor:
    """Single-direction GRU over G coalesced window batches: ``x [G, B, T,
    F]`` → ``[E, G, B, T, H]`` through one recurrence call over G·B rows.
    ``h0``, when given, is per group: ``[E, G, B, H]``."""
    flat, spec = coalesce_windows(x)
    if h0 is not None:
        h0 = h0.reshape(h0.shape[0], spec.coalesced_rows, h0.shape[-1])
    out = gru(params, flat, h0=h0, reverse=reverse, recurrence=recurrence)
    return split_coalesced(out, spec)


def bidirectional_gru_coalesced(fwd: GRUParams, bwd: GRUParams,
                                x: torch.Tensor,
                                recurrence: Recurrence | None = None
                                ) -> torch.Tensor:
    """Bidirectional :func:`gru_coalesced`: ``[G, B, T, F] → [E, G, B, T,
    2H]``, each direction's recurrence (or the fused one) run once over
    the G·B rows."""
    flat, spec = coalesce_windows(x)
    out = bidirectional_gru(fwd, bwd, flat, recurrence=recurrence)
    return split_coalesced(out, spec)
