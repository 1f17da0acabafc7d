"""The GRU recurrence: hand-written CUDA kernels, their plain versions, and
the autograd Function that joins the training forward to the backward.

Counterpart of ``deeprest_tpu/ops/pallas_gru.py``:

- K1, the inference forward (``_fwd_call`` with ``emit_prev=False``):
  :func:`gru_fwd_cuda`, kernel ``csrc/gru_fwd.cu`` entry ``gru_fwd``;
- K2, the training forward (``emit_prev=True`` with the gate stash):
  :func:`gru_fwd_train_cuda`, the same source's ``gru_fwd_train`` entry,
  which also streams out ``h_prev`` and the hidden gates;
- K3, the backward (``_bwd_call``): :func:`gru_bwd_cuda`, kernel
  ``csrc/gru_bwd.cu`` (the reverse-time recurrence plus the dW/db product);
- the custom VJP ``gru_recurrence`` → :class:`GRURecurrence`.

Each source note gives the kernel's design and its bound.

- :func:`gru_recurrence` dispatches on what the call needs and where the
  tensors lie.  With autograd recording and an input that requires grad it
  runs :class:`GRURecurrence` (K2 forward, K3 backward); otherwise it runs
  K1, which pays for none of K2's extra streams.  The CPU runs the plain
  versions, anything else the kernels, which launch or raise.  There is no
  fallback from a kernel to a plain version.
- :func:`gru_recurrence_reference`, :func:`gru_fwd_train_reference` and
  :func:`gru_bwd_reference` are the plain PyTorch versions with the
  kernels' dtype contracts; the CPU tests use them and ``chip_smoke.py``
  holds the kernels against them on the card.
- ``GRU_FWD.launches``, ``GRU_FWD_TRAIN.launches`` and
  ``GRU_BWD.launches`` count kernel launches, one per wrapper call.
"""

from __future__ import annotations

import ctypes

import torch

from deeprest_tpu_torch.ops.build import CudaKernel, CudaSource

_PTR = ctypes.c_void_p
_INT = ctypes.c_int

GRU_FWD_SOURCE = CudaSource("gru_fwd.cu", signatures={
    "gru_fwd": (_INT, [_PTR, _PTR, _PTR, _PTR, _PTR,
                       _INT, _INT, _INT, _INT, _INT, _INT, _PTR]),
    "gru_fwd_train": (_INT, [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                             _INT, _INT, _INT, _INT, _INT, _INT, _PTR]),
    "gru_fwd_smem_bytes": (ctypes.c_size_t, [_INT, _INT]),
    "gru_fwd_max_threads": (_INT, []),
    "gru_fwd_row_groups": (_INT, []),
})
GRU_BWD_SOURCE = CudaSource("gru_bwd.cu", signatures={
    "gru_bwd": (_INT, [_PTR] * 12 + [_INT] * 6 + [_PTR]),
    "gru_bwd_smem_bytes": (ctypes.c_size_t, [_INT, _INT, _INT]),
    "gru_bwd_max_threads": (_INT, []),
    "gru_bwd_row_groups": (_INT, []),
    "gru_bwd_row_tile": (_INT, []),
})
SOURCES = (GRU_FWD_SOURCE, GRU_BWD_SOURCE)

GRU_FWD = CudaKernel(GRU_FWD_SOURCE, "gru_fwd")
GRU_FWD_TRAIN = CudaKernel(GRU_FWD_SOURCE, "gru_fwd_train")
GRU_BWD = CudaKernel(GRU_BWD_SOURCE, "gru_bwd")
KERNELS = (GRU_FWD, GRU_FWD_TRAIN, GRU_BWD)


def kernel_io_dtype(dtype: torch.dtype) -> torch.dtype:
    """bf16 proj stays bf16; anything else runs in f32
    (``ops/gru.py::_kernel_io_dtype`` of the JAX package)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _forward_loop(proj, w_hh, b_hh, h0, reverse, emit_prev):
    e, t, b, g3 = proj.shape
    h = g3 // 3
    bf16 = proj.dtype == torch.bfloat16
    w = w_hh.to(proj.dtype).float()
    bias = b_hh.float()[:, None, :]
    carry = h0.float()
    out = torch.empty((e, t, b, h), dtype=proj.dtype, device=proj.device)
    h_prev = torch.empty_like(out) if emit_prev else None
    gates = torch.empty_like(proj) if emit_prev else None
    for s in range(t):
        tt = t - 1 - s if reverse else s
        h_dot = carry.to(torch.bfloat16).float() if bf16 else carry
        g = torch.bmm(h_dot, w) + bias
        if emit_prev:
            h_prev[:, tt] = carry.to(proj.dtype)
            gates[:, tt] = g.to(proj.dtype)
        g_r, g_z, g_n = g.split(h, dim=-1)
        x_r, x_z, x_n = proj[:, tt].float().split(h, dim=-1)
        r = torch.sigmoid(x_r + g_r)
        z = torch.sigmoid(x_z + g_z)
        n = torch.tanh(x_n + r * g_n)
        carry = (1.0 - z) * n + z * carry
        out[:, tt] = carry.to(proj.dtype)
    return out, h_prev, gates


def gru_recurrence_reference(proj: torch.Tensor, w_hh: torch.Tensor,
                             b_hh: torch.Tensor, h0: torch.Tensor,
                             reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch GRU recurrence over pre-projected inputs (K1's plain
    version, differentiable by torch autograd).

    ``proj [E, T, B, 3H]`` (f32 or bf16), ``w_hh [E, H, 3H]``, ``b_hh
    [E, 3H]``, ``h0 [E, B, H]`` → ``h_all [E, T, B, H]`` in proj's dtype,
    time-aligned with proj under ``reverse``.  The carry and gate math are
    f32; for bf16 the dot reads h rounded to bf16 and W_hh in bf16, whose
    products are exact in f32, accumulated in f32.
    """
    return _forward_loop(proj, w_hh, b_hh, h0, reverse, emit_prev=False)[0]


def gru_fwd_train_reference(proj: torch.Tensor, w_hh: torch.Tensor,
                            b_hh: torch.Tensor, h0: torch.Tensor,
                            reverse: bool = False):
    """K2's plain version: :func:`gru_recurrence_reference` plus, per step,
    the carry before the step (``h_prev [E, T, B, H]``) and the
    pre-activation hidden gates ``h·W_hh + b_hh`` (``gates [E, T, B,
    3H]``), both in proj's dtype.  Returns ``(h_all, h_prev, gates)``."""
    return _forward_loop(proj, w_hh, b_hh, h0, reverse, emit_prev=True)


def gru_bwd_reference(proj: torch.Tensor, h_prev: torch.Tensor,
                      gates: torch.Tensor | None, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, dout: torch.Tensor,
                      reverse: bool = False):
    """K3's plain version: the reverse-time GRU backward of
    ``pallas_gru.py::_bwd_kernel``.

    ``dout [E, T, B, H]`` arrives in proj's dtype.  ``gates`` is the
    forward's stash, or None to recompute ``h_prev·W_hh + b_hh`` in f32.
    The dgates operand ``(da_r, da_z, dhn)`` is rounded to proj's dtype for
    both products (``dh·W_hhᵀ`` and ``h_prevᵀ·dgates``); ``db_hh`` sums the
    f32 values.  Returns ``(dproj [E,T,B,3H] proj dtype, dW_hh [E,H,3H]
    f32, db_hh [E,3H] f32, dh0 [E,B,H] f32)``.
    """
    e, t, b, g3 = proj.shape
    h = g3 // 3
    w = w_hh.to(proj.dtype).float()
    w_t = w.transpose(1, 2)
    bias = b_hh.float()[:, None, :]
    dh = torch.zeros((e, b, h), dtype=torch.float32, device=proj.device)
    db = torch.zeros((e, g3), dtype=torch.float32, device=proj.device)
    dproj = torch.empty_like(proj)
    dgates = torch.empty((e, t, b, g3), dtype=torch.float32,
                         device=proj.device)
    for s in range(t):
        tt = s if reverse else t - 1 - s
        hp = h_prev[:, tt].float()
        g = (torch.bmm(hp, w) + bias) if gates is None else gates[:, tt].float()
        g_r, g_z, g_n = g.split(h, dim=-1)
        x_r, x_z, x_n = proj[:, tt].float().split(h, dim=-1)
        r = torch.sigmoid(x_r + g_r)
        z = torch.sigmoid(x_z + g_z)
        n = torch.tanh(x_n + r * g_n)
        dht = dout[:, tt].float() + dh
        dn = dht * (1.0 - z)
        dz = dht * (hp - n)
        dtanh = dn * (1.0 - n * n)
        da_r = dtanh * g_n * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dhn = dtanh * r
        dproj[:, tt] = torch.cat([da_r, da_z, dtanh], dim=-1).to(proj.dtype)
        dg = torch.cat([da_r, da_z, dhn], dim=-1)
        db += dg.sum(dim=1)
        dg = dg.to(proj.dtype).float()
        dgates[:, tt] = dg
        dh = dht * z + torch.bmm(dg, w_t)
    dw = torch.bmm(h_prev.float().reshape(e, t * b, h).transpose(1, 2),
                   dgates.reshape(e, t * b, g3))
    return dproj, dw, db, dh


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _dims(proj: torch.Tensor) -> tuple[int, int, int, int]:
    """``(E, T, B, H)`` of a ``[E, T, B, 3H]`` f32/bf16 proj; raises on
    anything else."""
    if proj.dim() != 4 or proj.shape[-1] % 3:
        raise ValueError(
            f"proj must be [E, T, B, 3H], got {tuple(proj.shape)}")
    if proj.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"proj dtype {proj.dtype}: the kernel takes float32 "
                        "or bfloat16")
    e, t, b, g3 = proj.shape
    if min(e, t, b) < 1:
        raise ValueError(f"empty recurrence: proj shape {tuple(proj.shape)}")
    return e, t, b, g3 // 3


def _check(name: str, proj: torch.Tensor, expect: dict) -> None:
    """Raise unless every tensor of ``expect`` (name → ``(tensor, shape,
    dtype)``) has its shape and dtype, and all of them and proj lie
    contiguous on proj's CUDA device."""
    for key, (tensor, shape, dtype) in expect.items():
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"{key} must be {shape} {dtype}, got "
                f"{tuple(tensor.shape)} {tensor.dtype}")
    tensors = [("proj", proj)] + [(k, v[0]) for k, v in expect.items()]
    for key, tensor in tensors:
        if tensor.device.type != "cuda" or tensor.device != proj.device:
            raise ValueError(
                f"{name} needs every input on one CUDA device; {key} lies "
                f"on {tensor.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs; {key} has "
                             f"strides {tensor.stride()}")


def _check_smem(name: str, smem: int, proj: torch.Tensor, what: str) -> None:
    limit = torch.cuda.get_device_properties(
        proj.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"{name}: {what} needs {smem} bytes of shared memory per CTA, "
            f"above the device's {limit}; proj shape {tuple(proj.shape)}")


def _check_fwd(name, proj, w_hh, b_hh, h0) -> None:
    e, _, b, h = _dims(proj)
    _check(name, proj, {"w_hh": (w_hh, (e, h, 3 * h), proj.dtype),
                        "b_hh": (b_hh, (e, 3 * h), torch.float32),
                        "h0": (h0, (e, b, h), torch.float32)})
    lib = GRU_FWD_SOURCE.library()
    threads = lib.gru_fwd_row_groups() * h
    if h % 4 or threads > lib.gru_fwd_max_threads():
        raise ValueError(
            f"{name} takes hidden sizes H % 4 == 0 with "
            f"{lib.gru_fwd_row_groups()}*H <= {lib.gru_fwd_max_threads()} "
            f"threads; got H={h}")
    smem = lib.gru_fwd_smem_bytes(h, int(proj.dtype == torch.bfloat16))
    _check_smem(name, smem, proj,
                f"W_hh [{h}, {3 * h}] {proj.dtype} plus the carry tile")


def _launch(kernel: CudaKernel, fn: str, proj: torch.Tensor, *args) -> None:
    """Call C entry ``fn`` on proj's device and current stream; count the
    launch and raise on a nonzero CUDA error."""
    lib = kernel.library()
    with torch.cuda.device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
        kernel.launches += 1
    if err != 0:
        raise RuntimeError(
            f"{fn} launch failed with CUDA error {err} at proj shape "
            f"{tuple(proj.shape)} {proj.dtype}")


def gru_fwd_cuda(proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """K1: launch ``csrc/gru_fwd.cu`` (entry ``gru_fwd``) on the current
    stream of proj's device.

    Same contract as :func:`gru_recurrence_reference`, with the dtypes
    already resolved by the caller: ``w_hh`` in proj's dtype, ``b_hh`` and
    ``h0`` in f32, all contiguous on one CUDA device.  Raises on anything
    the kernel does not take, including a hidden size whose ``W_hh`` and
    carry tile do not fit in one CTA's shared memory.
    """
    _check_fwd("gru_fwd_cuda", proj, w_hh, b_hh, h0)
    e, t, b, g3 = proj.shape
    out = torch.empty((e, t, b, g3 // 3), dtype=proj.dtype,
                      device=proj.device)
    _launch(GRU_FWD, "gru_fwd", proj, proj.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(), e, t, b, g3 // 3,
            int(proj.dtype == torch.bfloat16), int(bool(reverse)))
    return out


def gru_fwd_train_cuda(proj: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, h0: torch.Tensor,
                       reverse: bool = False):
    """K2: launch ``csrc/gru_fwd.cu`` (entry ``gru_fwd_train``).  Contract
    of :func:`gru_fwd_train_reference` with the inputs of
    :func:`gru_fwd_cuda`; returns ``(h_all, h_prev, gates)``."""
    _check_fwd("gru_fwd_train_cuda", proj, w_hh, b_hh, h0)
    e, t, b, g3 = proj.shape
    out = torch.empty((e, t, b, g3 // 3), dtype=proj.dtype,
                      device=proj.device)
    h_prev = torch.empty_like(out)
    gates = torch.empty_like(proj)
    _launch(GRU_FWD_TRAIN, "gru_fwd_train", proj, proj.data_ptr(),
            w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(),
            h_prev.data_ptr(), gates.data_ptr(), e, t, b, g3 // 3,
            int(proj.dtype == torch.bfloat16), int(bool(reverse)))
    return out, h_prev, gates


def gru_bwd_cuda(proj: torch.Tensor, h_prev: torch.Tensor,
                 gates: torch.Tensor | None, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, dout: torch.Tensor,
                 reverse: bool = False):
    """K3: launch ``csrc/gru_bwd.cu`` (the backward recurrence, then the
    dW/db product) on the current stream of proj's device.

    Contract of :func:`gru_bwd_reference`: ``h_prev``, ``gates`` (or None),
    ``w_hh`` and ``dout`` in proj's dtype, ``b_hh`` in f32, all contiguous
    on one CUDA device.  Allocates the dgates and db-partial workspaces.
    Raises on anything the kernels do not take, including ``W_hh`` plus the
    tiles above one CTA's shared memory.
    """
    e, t, b, h = _dims(proj)
    g3, io = 3 * h, proj.dtype
    expect = {"h_prev": (h_prev, (e, t, b, h), io),
              "w_hh": (w_hh, (e, h, g3), io),
              "b_hh": (b_hh, (e, g3), torch.float32),
              "dout": (dout, (e, t, b, h), io)}
    if gates is not None:
        expect["gates"] = (gates, (e, t, b, g3), io)
    _check("gru_bwd_cuda", proj, expect)
    lib = GRU_BWD_SOURCE.library()
    if h % 8 or lib.gru_bwd_row_groups() * h > lib.gru_bwd_max_threads():
        raise ValueError(
            f"gru_bwd_cuda takes hidden sizes H % 8 == 0 with "
            f"{lib.gru_bwd_row_groups()}*H <= {lib.gru_bwd_max_threads()} "
            f"threads; got H={h}")
    bf16 = int(io == torch.bfloat16)
    stash = int(gates is not None)
    _check_smem("gru_bwd_cuda", lib.gru_bwd_smem_bytes(h, bf16, stash), proj,
                f"W_hh [{h}, {g3}] {io} plus the dgates"
                + ("" if stash else " and h_prev") + " tiles")
    dev = proj.device
    n_tiles = -(-b // lib.gru_bwd_row_tile())
    dproj = torch.empty_like(proj)
    dw = torch.empty((e, h, g3), dtype=torch.float32, device=dev)
    db = torch.empty((e, g3), dtype=torch.float32, device=dev)
    dh0 = torch.empty((e, b, h), dtype=torch.float32, device=dev)
    dgates = torch.empty_like(proj)
    db_part = torch.empty((e, n_tiles, g3), dtype=torch.float32, device=dev)
    _launch(GRU_BWD, "gru_bwd", proj, proj.data_ptr(), h_prev.data_ptr(),
            gates.data_ptr() if gates is not None else None,
            w_hh.data_ptr(), b_hh.data_ptr(), dout.data_ptr(),
            dproj.data_ptr(), dw.data_ptr(), db.data_ptr(), dh0.data_ptr(),
            dgates.data_ptr(), db_part.data_ptr(), e, t, b, h, bf16,
            int(bool(reverse)))
    return dproj, dw, db, dh0


# ---------------------------------------------------------------------------
# the custom VJP
# ---------------------------------------------------------------------------


class GRURecurrence(torch.autograd.Function):
    """``pallas_gru.py::gru_recurrence`` as an autograd Function.

    Forward runs K2 (its plain version for a CPU tensor) and saves the JAX
    residual set ``(proj, w_hh, b_hh, h0, h_prev, gates)``; ``h_all`` is
    not a residual.  Backward casts ``dout`` to proj's dtype, runs K3 (or
    its plain version) with the stashed gates, and returns each gradient in
    its input's dtype, as ``_vjp_bwd`` does.
    """

    @staticmethod
    def forward(ctx, proj, w_hh, b_hh, h0, reverse):
        fwd = (gru_fwd_train_reference if proj.device.type == "cpu"
               else gru_fwd_train_cuda)
        h_all, h_prev, gates = fwd(proj, w_hh, b_hh, h0, reverse)
        ctx.save_for_backward(proj, w_hh, b_hh, h0, h_prev, gates)
        ctx.reverse = reverse
        return h_all

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        proj, w_hh, b_hh, h0, h_prev, gates = ctx.saved_tensors
        bwd = (gru_bwd_reference if proj.device.type == "cpu"
               else gru_bwd_cuda)
        dproj, dw, db, dh0 = bwd(proj, h_prev, gates, w_hh, b_hh,
                                 dout.to(proj.dtype).contiguous(),
                                 ctx.reverse)
        return (dproj, dw.to(w_hh.dtype), db.to(b_hh.dtype),
                dh0.to(h0.dtype), None)


def gru_recurrence(proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The recurrence on proj's device: differentiable through
    :class:`GRURecurrence` when autograd records and an input requires
    grad, else the inference form (K1, or its plain version on the CPU)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj, w_hh, b_hh, h0)):
        return GRURecurrence.apply(proj, w_hh, b_hh, h0, reverse)
    if proj.device.type == "cpu":
        return gru_recurrence_reference(proj, w_hh, b_hh, h0, reverse)
    return gru_fwd_cuda(proj, w_hh, b_hh, h0, reverse)
