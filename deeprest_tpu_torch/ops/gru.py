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

Dtype contract (``_kernel_io_dtype`` / ``_dot_dtype_for`` /
``_out_dtype_for`` of the JAX package): a bf16 projection stays bf16 and
``W_hh`` goes to the recurrence in that dtype, ``b_hh`` and ``h0`` in f32;
the carry and the gate math are f32, bf16 dots accumulate in f32, and h is
stored in the projection's dtype.  Gate order is (r, z, n), and
``n = tanh(x_n + b_in + r * (h @ W_hn + b_hn))`` as in torch's own GRU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deeprest_tpu_torch.ops.cuda_gru import gru_recurrence, kernel_io_dtype

Recurrence = Callable[..., torch.Tensor]


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


def _project(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """``x @ W_ih + b_ih`` → contiguous ``[E, T, B, 3H]`` in the
    recurrence's io dtype.  ``x`` is ``[B, T, F]`` shared by all experts or
    ``[E, B, T, F]``."""
    eq = "btf,efg->etbg" if x.dim() == 3 else "ebtf,efg->etbg"
    proj = torch.einsum(eq, x, params.w_ih) + params.b_ih[:, None, None, :]
    return proj.to(kernel_io_dtype(proj.dtype)).contiguous()


def gru(params: GRUParams, x: torch.Tensor, h0: torch.Tensor | None = None,
        reverse: bool = False,
        recurrence: Recurrence | None = None) -> torch.Tensor:
    """Single-direction GRU over the time axis.

    ``x``: ``[E, B, T, F]`` or ``[B, T, F]`` shared across experts; ``h0``:
    ``[E, B, H]`` (zeros if None).  With ``reverse`` the sequence runs back
    to front and the output stays time-aligned with ``x``.  ``recurrence``
    replaces the device dispatch of ``cuda_gru.gru_recurrence`` (a caller
    that wants the plain version on a CUDA tensor passes
    ``gru_recurrence_reference``).  Returns ``[E, B, T, H]`` in x's dtype.
    """
    proj = _project(params, x)
    e, _, b, _ = proj.shape
    if h0 is None:
        h0 = torch.zeros((e, b, params.hidden_size), dtype=torch.float32,
                         device=x.device)
    run = recurrence or gru_recurrence
    h_all = run(proj, params.w_hh.to(proj.dtype).contiguous(),
                params.b_hh.float().contiguous(), h0.float().contiguous(),
                reverse)
    return h_all.permute(0, 2, 1, 3).to(x.dtype)


def bidirectional_gru(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                      recurrence: Recurrence | None = None) -> torch.Tensor:
    """``[E, B, T, F]`` (or shared ``[B, T, F]``) → ``[E, B, T, 2H]``; the
    last-axis halves are (forward, backward), each time-aligned with x."""
    out_f = gru(fwd, x, reverse=False, recurrence=recurrence)
    out_b = gru(bwd, x, reverse=True, recurrence=recurrence)
    return torch.cat([out_f, out_b], dim=-1)
