"""The GRU recurrence: hand-written CUDA kernels, their plain versions, the
Hopper block plan, and the autograd Function that joins the training
forward to the backward.

Counterpart of ``deeprest_tpu/ops/pallas_gru.py``:

- K1, the inference forward (``_fwd_call`` with ``emit_prev=False``):
  :func:`gru_fwd_cuda`, kernel ``csrc/gru_fwd.cu`` entry ``gru_fwd``
  (bf16: ``gru_fwd_mma_kernel``, its product on the tensor cores with
  ``mma.sync`` m16n8k16 from ``ldmatrix`` fragments; f32:
  ``gru_fwd_tf32_kernel``, the same layout on ``mma.sync`` m16n8k8 in
  3xTF32, each f32 operand split into two TF32 halves so the product keeps
  the 1e-5 tolerance that one TF32 product would break);
- K2, the training forward (``emit_prev=True``): :func:`gru_fwd_train_cuda`,
  the same source's ``gru_fwd_train`` entry, which also streams out
  ``h_prev`` and, with :data:`STASH_GATES`, the hidden gates; the same two
  kernels as K1 instantiated with those stores (bf16 ``mma.sync``, f32
  3xTF32);
- K3, the backward (``_bwd_call``): :func:`gru_bwd_cuda`, kernel
  ``csrc/gru_bwd.cu`` (the reverse-time recurrence plus the dW/db product),
  which recomputes the hidden gates when the forward stashed none; both
  products on the tensor cores, bf16 like K1's bf16 form and f32 in
  3xTF32 like K1's f32 form;
- ``csrc/gru_mma.cuh``, the device header every source includes (the
  ``ldmatrix`` / ``mma.sync`` / 3xTF32 / ``cp.async`` helpers and the gate
  nonlinearities); its bytes enter every library's digest;
- K4, the blocked forward of the tuning sweep
  (``benchmarks/kernel_tuning.py::make_fwd_call``):
  :func:`gru_fwd_blocked_cuda`, kernel ``csrc/gru_fwd_blocked.cu``, with a
  caller-chosen blocking (rows per CTA, experts per CTA, time steps of
  proj held in shared memory) and an f32 output, both dots on the tensor
  cores, proj through registers (``t_blk = 1``) or a ``cp.async`` ring:
  the bf16 dot (``gru_fwd_blocked_mma_kernel``) like K1's bf16 form, the
  f32 dot (``gru_fwd_blocked_tf32_kernel``) in 3xTF32 like K1's f32 form;
- the custom VJP ``gru_recurrence`` → :class:`GRURecurrence`;
- ``_choose_blocks`` / ``block_plan`` → :func:`block_plan`, the Hopper
  plan: per kernel the rows, threads and shared-memory bytes of one CTA,
  the CTA count, how many CTAs one SM holds and the waves over the H100's
  132 SMs.  It needs no GPU and no built library (its byte formulas mirror
  the sources' ``*_smem_bytes`` entries), and every wrapper refuses through
  it before launching.

Knobs of the JAX package and their counterparts:

- ``STASH_GATES`` → :data:`STASH_GATES`, read from
  ``DEEPREST_GRU_STASH_GATES`` (default on) at every training forward.
- ``LOOP_ORDER`` (expert-inner against time-inner scheduling inside one
  grid program) has no counterpart: each CTA of K1-K3 runs one expert, so
  there is no order of experts within a CTA to choose.  K4's ``e_blk``
  axis is the only place a CTA steps several experts, time outer and
  expert inner as the TPU kernel did.
- ``E_BLK`` / ``T_BLK`` / the VMEM budget are TPU tiling and have no
  counterpart in K1-K3 (one expert and 16 rows per CTA, the whole time loop
  inside); K4 takes its blocking as arguments.

Dispatch and plain versions:

- :func:`gru_recurrence` dispatches on what the call needs and where the
  tensors lie.  With autograd recording and an input that requires grad it
  runs :class:`GRURecurrence` (K2 forward, K3 backward); otherwise it runs
  K1 through the registered operator ``deeprest_torch::gru_fwd``
  (:func:`gru_fwd_op`), which pays for none of K2's extra streams and is
  what an exported program records.  The CPU runs the plain
  versions, anything else the kernels, which launch or raise.  There is no
  fallback from a kernel to a plain version.
- :func:`gru_recurrence_reference`, :func:`gru_fwd_train_reference`,
  :func:`gru_bwd_reference` and :func:`gru_fwd_blocked_reference` are the
  plain PyTorch versions with the kernels' dtype contracts; the CPU tests
  use them and ``chip_smoke.py`` holds the kernels against them on the
  card.
- ``GRU_FWD.launches``, ``GRU_FWD_TRAIN.launches``, ``GRU_BWD.launches``
  and ``GRU_FWD_BLOCKED.launches`` count kernel launches, one per wrapper
  call (``KERNELS``; ``MODEL_KERNELS`` are the three a model call can
  launch, which the CLI reports).  A call on a stream that is capturing a
  CUDA graph inside :func:`held_launches` launches nothing: it is held in
  that capture's tally, and the graph's ledger adds it per replay
  (``train/graphs.py``, ``serve/graphs.py``).  The tally is keyed by the
  stream, not the thread, since autograd runs a captured backward on its
  own thread but on the forward's stream.  Counts move under
  ``LAUNCH_LOCK``, since serving threads replay graphs concurrently.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import threading

import torch

from deeprest_tpu_torch.ops.build import CudaKernel, CudaSource

_PTR = ctypes.c_void_p
_INT = ctypes.c_int

# Stash the pre-activation hidden gates (h·W_hh + b_hh) in the training
# forward so the backward skips its recompute product, for one more
# [E, T, B, 3H] stream each way (pallas_gru.py's STASH_GATES).  Read at
# every call, so a sweep may set the module global.
STASH_GATES = os.environ.get("DEEPREST_GRU_STASH_GATES", "1") != "0"

MMA_HEADERS = ("gru_mma.cuh",)
GRU_FWD_SOURCE = CudaSource("gru_fwd.cu", headers=MMA_HEADERS, signatures={
    "gru_fwd": (_INT, [_PTR, _PTR, _PTR, _PTR, _PTR,
                       _INT, _INT, _INT, _INT, _INT, _INT, _PTR]),
    "gru_fwd_train": (_INT, [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                             _INT, _INT, _INT, _INT, _INT, _INT, _PTR]),
    "gru_fwd_smem_bytes": (ctypes.c_size_t, [_INT, _INT]),
    "gru_fwd_max_threads": (_INT, []),
    "gru_fwd_tf32_max_threads": (_INT, []),
    "gru_fwd_row_groups": (_INT, []),
})
GRU_BWD_SOURCE = CudaSource("gru_bwd.cu", headers=MMA_HEADERS, signatures={
    "gru_bwd": (_INT, [_PTR] * 12 + [_INT] * 6 + [_PTR]),
    "gru_bwd_smem_bytes": (ctypes.c_size_t, [_INT, _INT]),
    "gru_bwd_max_threads": (_INT, []),
    "gru_bwd_tf32_max_threads": (_INT, []),
    "gru_bwd_row_groups": (_INT, []),
    "gru_bwd_row_tile": (_INT, []),
})
GRU_FWD_BLOCKED_SOURCE = CudaSource(
    "gru_fwd_blocked.cu", headers=MMA_HEADERS, signatures={
        "gru_fwd_blocked": (_INT, [_PTR] * 5 + [_INT] * 9 + [_PTR]),
        "gru_fwd_blocked_smem_bytes": (ctypes.c_size_t, [_INT] * 6),
        "gru_fwd_blocked_tf32_max_threads": (_INT, []),
        "gru_fwd_blocked_mma_max_threads": (_INT, []),
    })
SOURCES = (GRU_FWD_SOURCE, GRU_BWD_SOURCE, GRU_FWD_BLOCKED_SOURCE)

GRU_FWD = CudaKernel(GRU_FWD_SOURCE, "gru_fwd")
GRU_FWD_TRAIN = CudaKernel(GRU_FWD_SOURCE, "gru_fwd_train")
GRU_BWD = CudaKernel(GRU_BWD_SOURCE, "gru_bwd")
GRU_FWD_BLOCKED = CudaKernel(GRU_FWD_BLOCKED_SOURCE, "gru_fwd_blocked")
MODEL_KERNELS = (GRU_FWD, GRU_FWD_TRAIN, GRU_BWD)   # what a model call runs
KERNELS = MODEL_KERNELS + (GRU_FWD_BLOCKED,)

LAUNCH_LOCK = threading.Lock()
_HELD: dict[int, dict] = {}      # capturing stream handle -> its tally


@contextlib.contextmanager
def held_launches(stream: torch.cuda.Stream):
    """Tally, instead of counting, the launches recorded on ``stream``
    while it captures a CUDA graph; yields ``{kernel: n}``.  Launches on
    other streams, and replays, go on counting."""
    tally: dict = {}
    with LAUNCH_LOCK:
        _HELD[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        with LAUNCH_LOCK:
            _HELD.pop(stream.cuda_stream, None)


def kernel_io_dtype(dtype: torch.dtype) -> torch.dtype:
    """bf16 proj stays bf16; anything else runs in f32
    (``ops/gru.py::_kernel_io_dtype`` of the JAX package)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


# ---------------------------------------------------------------------------
# the Hopper block plan
# ---------------------------------------------------------------------------

# The card (NVIDIA H100 SXM, compute capability 9.0).
H100_SMS = 132
SMEM_OPTIN_BYTES = 232_448      # one CTA, after the opt-in attribute
SMEM_PER_SM_BYTES = 233_472     # what the CTAs resident on one SM share
SMEM_RESERVED_PER_CTA = 1_024   # the runtime's own share of each CTA
THREADS_PER_SM = 2_048
CTAS_PER_SM = 32
REGISTERS_PER_SM = 65_536
# The bf16 kernels of K1-K3 are compiled with __launch_bounds__(512), which
# caps a thread at 128 registers; the plan counts that cap.  K4's bf16-dot
# form is bounded to 256 threads: its single-chain instantiation (16 rows,
# one expert) at two CTAs an SM, so 128 registers, the others at one, so
# up to 255.  The f32 3xTF32 forms are bounded to the threads of their
# largest admitted H, one CTA an SM: 544 (K1, K2 and K4's f32 dot, H <=
# 132 or 136 on 17 warps of 8 units: 96 registers, as ptxas allots them)
# and 256 (K3, H <= 128 on 8 warps of 16 units: 255).
REGISTERS_PER_THREAD = 128
REGISTERS_PER_THREAD_MAX = 255
TF32_FWD_MAX_THREADS = 544
TF32_BWD_MAX_THREADS = 256
TF32_FWD_UNITS = 8      # hidden units per warp of the f32 K1, K2 and K4
# Mirrors of the sources' constants: csrc/gru_fwd.cu and csrc/gru_bwd.cu
# run 16 rows per CTA: the bf16 forms and the f32 3xTF32 K3 on one warp
# per 16 hidden units (ceil(H/16) warps, 2H threads when H % 16 == 0), the
# f32 3xTF32 K1 and K2 on one warp per 8 units (ceil(H/8) warps);
# csrc/gru_fwd_blocked.cu takes one or two m16 tiles of rows on H/16 warps
# with the bf16 dot, and half an m16 tile, one or two on ceil(H/8) warps
# with the f32 dot.
ROW_GROUPS = 2     # bf16: 2H threads, one warp per 16 units
ROW_TILE = 16
MAX_THREADS = 512
MMA_UNITS = 16   # hidden units per warp (and the k16 step) of the bf16 kernels
# Floats of pad after each shared row of the f32 3xTF32 forms: K1's W_hh
# (8) and carry tile (4), K3's W_hh and dgates tile (4).
TF32_FWD_W_PAD = 8
TF32_FWD_H_PAD = 4
TF32_BWD_PAD = 4
BLOCKED_E_BLKS = (1, 2, 4)      # the e_blk instantiations of K4
BLOCKED_MMA_ROWS = (16, 32)     # K4's bf16-dot batch tiles: 1 or 2 m16 tiles
BLOCKED_MMA_MAX_THREADS = 256   # K4's bf16-dot CTA: H/16 warps, so H <= 128
BLOCKED_TF32_ROWS = (8, 16, 32)  # K4's f32-dot tiles: half an m16, 1 or 2


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _tf32_tile_bytes(h: int, rows: int) -> int:
    """The f32 3xTF32 forward's double-buffered carry tile: ``rows`` rows
    of H rounded up to 8, plus 4 floats."""
    return 2 * rows * (-(-h // 8) * 8 + TF32_FWD_H_PAD) * 4


def fwd_smem_bytes(h: int, bf16: bool) -> int:
    """``gru_fwd_smem_bytes`` of K1 and K2 (one layout for both).  bf16:
    W_hh and the double-buffered bf16 h tile of 16 rows, every row padded
    by 16 bytes against ldmatrix bank conflicts.  f32 (3xTF32): W_hh with
    rows of 3H + 8 floats and the f32 carry tile of 16 rows."""
    if bf16:
        return (h * (3 * h + 8) + 2 * ROW_TILE * (h + 8)) * 2
    return h * (3 * h + TF32_FWD_W_PAD) * 4 + _tf32_tile_bytes(h, ROW_TILE)


def bwd_smem_bytes(h: int, bf16: bool) -> int:
    """``gru_bwd_smem_bytes`` (K3's recurrence kernel): W_hh and the
    dgates tile of 16 rows, every row padded by 16 bytes (bf16: 8
    elements, against ldmatrix bank conflicts; f32: 4 floats, so the A and
    B fragments' rows fall on distinct banks, and W_hh's rows, permuted so
    a lane holds 4 consecutive units, rounded up to whole warps of 16).
    Either way the stash-off recompute reads its h_prev fragments from
    global memory, so the gate stash does not change the bytes."""
    if bf16:
        return (h + ROW_TILE) * (3 * h * 2 + 16)
    return (_round16(h) + ROW_TILE) * (3 * h + TF32_BWD_PAD) * 4


def fwd_blocked_smem_bytes(h: int, rows: int, e_blk: int, t_blk: int,
                           io_bf16: bool, bf16_dot: bool) -> int:
    """``gru_fwd_blocked_smem_bytes`` (K4), per expert of the block, both
    dots on the tensor cores, and for ``t_blk > 1`` a ring of ``t_blk``
    steps of proj rows in the io dtype, each padded by 16 bytes (at
    ``t_blk = 1`` proj goes to registers).  bf16 dot: W_hh in bf16 and the
    double-buffered bf16 h tile of ``rows`` rows, every row padded by 16
    bytes.  f32 dot (3xTF32): W_hh in the io dtype with rows of 3H + 8
    and the f32 carry tile of ``rows`` rows, as K1's f32 form."""
    io = 2 if io_bf16 else 4
    ring = t_blk * rows * (3 * h * io + 16) if t_blk > 1 else 0
    if bf16_dot:
        return e_blk * ((h * (3 * h + 8) + 2 * rows * (h + 8)) * 2 + ring)
    return e_blk * (h * (3 * h + TF32_FWD_W_PAD) * io
                    + _tf32_tile_bytes(h, rows) + ring)


def default_blocked_rows(b: int, bf16_dot: bool = False) -> int:
    """K4's default batch tile: all B rows, rounded up to whole m16 tiles
    and capped at two, or with the f32 dot half a tile when B <= 8."""
    if b <= BLOCKED_TF32_ROWS[0] and not bf16_dot:
        return BLOCKED_TF32_ROWS[0]
    return min(-(-b // MMA_UNITS) * MMA_UNITS, BLOCKED_MMA_ROWS[-1])


def _check_blocking(e: int, t: int, e_blk: int, t_blk: int) -> None:
    """K4's contract: ``e_blk`` divides E (the JAX sweep takes the whole E
    otherwise, which no SM holds) and ``t_blk`` divides T (the JAX kernel
    asserts it)."""
    if e_blk < 1 or e % e_blk:
        raise ValueError(f"e_blk={e_blk} must divide E={e}")
    if t_blk < 1 or t % t_blk:
        raise ValueError(f"T % t_blk must be 0; got T={t}, t_blk={t_blk}")


def _blocked_refusal(h: int, rows: int, e_blk: int, t_blk: int,
                     threads: int, io_bf16: bool,
                     bf16_dot: bool) -> str | None:
    """Why no K4 instantiation takes this blocking (None if one does),
    before its shared memory is counted."""
    if e_blk not in BLOCKED_E_BLKS:
        return f"K4 is built for e_blk in {BLOCKED_E_BLKS}, not {e_blk}"
    if bf16_dot:
        if h % MMA_UNITS:
            return (f"the bf16-dot tensor-core form takes hidden sizes "
                    f"H % {MMA_UNITS} == 0 (one warp per {MMA_UNITS} units, "
                    f"m16n8k16 tiles); got H={h}")
        if threads > BLOCKED_MMA_MAX_THREADS:
            return (f"the bf16-dot tensor-core form runs H/16 warps in at "
                    f"most {BLOCKED_MMA_MAX_THREADS} threads (H <= 128); got "
                    f"H={h}")
        if rows not in BLOCKED_MMA_ROWS:
            return (f"the bf16-dot tensor-core form takes rows in "
                    f"{BLOCKED_MMA_ROWS} (one or two m16 tiles), got "
                    f"rows={rows}")
        return None
    if rows not in BLOCKED_TF32_ROWS:
        return (f"rows must be 8, 16 or 32 with the f32 dot (3xTF32: half "
                f"an m16 tile, one or two), got {rows}")
    if h % 4:
        return (f"the f32-dot 3xTF32 form takes hidden sizes H % 4 == 0; "
                f"got H={h}")
    if threads > TF32_FWD_MAX_THREADS:
        return (f"the f32-dot 3xTF32 form runs ceil(H/8) warps in at most "
                f"{TF32_FWD_MAX_THREADS} threads (H <= 136); got H={h}")
    if io_bf16 and t_blk > 1 and h % 8:
        return (f"the f32-dot form's cp.async ring copies 16-byte rows: "
                f"with bf16 io and t_blk > 1 it takes H % 8 == 0; got H={h}")
    return None


def _register_cap(max_threads: int) -> int:
    """Registers a thread may keep under ``__launch_bounds__(max_threads,
    1)``, in steps of 8, at most 255.  An SM's 65,536 registers sit in 4
    partitions of 16,384, one per warp scheduler, and the warps of a CTA
    are dealt over the 4, so the fullest partition sets the cap: 17 warps
    (544 threads) put 5 on one, 16,384 / (5 x 32) = 102 -> 96 (ptxas on
    the H100 caps every such kernel at 96), not 65,536 / 544 = 120."""
    warps = -(-max_threads // 32)
    per_partition = -(-warps // 4)
    return min(REGISTERS_PER_THREAD_MAX,
               REGISTERS_PER_SM // 4 // (32 * per_partition) // 8 * 8)


def _plan_entry(rows: int, threads: int, smem: int, ctas: int,
                refusal: str | None,
                registers: int = REGISTERS_PER_THREAD,
                max_threads: int = MAX_THREADS) -> dict:
    if refusal is None and smem > SMEM_OPTIN_BYTES:
        refusal = (f"needs {smem} bytes of shared memory per CTA, above the "
                   f"{SMEM_OPTIN_BYTES} one CTA may opt into")
    if refusal is None and threads > max_threads:
        refusal = (f"launches {threads} threads, above the "
                   f"__launch_bounds__({max_threads}) it is built for")
    resident = 0
    if refusal is None:
        resident = min(SMEM_PER_SM_BYTES // (smem + SMEM_RESERVED_PER_CTA),
                       THREADS_PER_SM // threads,
                       REGISTERS_PER_SM // (threads * registers),
                       CTAS_PER_SM)
    return {"rows_per_cta": rows, "threads_per_cta": threads,
            "smem_bytes": smem, "registers_cap": registers,
            "cluster_ctas": 1, "ctas": ctas, "ctas_per_sm": resident,
            "waves": math.ceil(ctas / (resident * H100_SMS)) if resident
            else None, "smem_limit": SMEM_OPTIN_BYTES,
            "fits": refusal is None, "refusal": refusal}


def block_plan(e: int, t: int, b: int, h: int, dtype=torch.float32,
               training: bool = True, rows: int | None = None,
               e_blk: int = 1, t_blk: int = 1, *, blocked: bool = False,
               bf16_dot: bool | None = None) -> dict:
    """The Hopper block plan of one recurrence call at ``proj [E, T, B,
    3H]`` in ``dtype`` (the kernel io dtype, bf16 or f32).

    The kernels the call launches: ``fwd`` (K1) for inference,
    ``fwd_train`` (K2) plus ``bwd`` (K3's recurrence kernel; its dW
    product uses 17 KiB (f32) or 18 KiB (bf16, two cp.async stages) of
    static shared memory and never binds) for training, or with
    ``blocked`` K4 alone (``fwd_blocked``, inference only) at the
    blocking ``rows`` (default :func:`default_blocked_rows`),
    ``e_blk``, ``t_blk`` and ``bf16_dot`` (default: the io dtype's); K4's
    bf16 dot takes H % 16, H <= 128 and 16 or 32 rows (8 rows are refused,
    not run half empty), its f32 dot (3xTF32 in ceil(H/8) warps) H % 4,
    H <= 136 and 8, 16 or 32 rows.  K1-K3
    have a fixed blocking of 16 rows and one expert per CTA, and K3's
    bytes are the same with the gate stash on or off.  In bf16 K1-K3 run
    on the tensor cores in warps of 16 hidden units and refuse ``H % 16``;
    there is no FMA fallback for a bf16 shape.  In f32 K1 and K2 run
    3xTF32 on the tensor cores in ceil(H/8) warps and K3 in ceil(H/16)
    (the last one's units past H masked, so they keep taking H % 4 and
    H % 8), one CTA an SM at H=128.

    Returns ``{"kernels": {name: entry}, "binding": name, **entry of the
    binding kernel}``: the first kernel that does not fit, else the one
    with the most shared memory per CTA.  Each entry holds
    ``rows_per_cta``, ``threads_per_cta``, ``smem_bytes``,
    ``registers_cap`` (what the kernel's ``__launch_bounds__`` lets a
    thread keep), ``cluster_ctas`` (1: no kernel runs in thread block
    clusters), ``ctas``, ``ctas_per_sm`` (the least of what shared memory,
    threads and ``registers_cap`` registers a thread allow), ``waves`` over
    :data:`H100_SMS` (each CTA counted as one slot's worth of work),
    ``smem_limit``, ``fits``
    and ``refusal`` (None, or why the kernel would not launch).  Unlike
    the TPU's VMEM plan, a CTA's bytes do not grow with the row count:
    coalescing G windows only multiplies the CTAs.  Raises ValueError on
    a blocking K4's contract forbids (see :func:`_check_blocking`).
    """
    io_bf16 = dtype == torch.bfloat16
    g3 = 3 * h
    kernels = {}
    if blocked:
        if training:
            raise ValueError("K4 is an inference forward; plan it with "
                             "training=False")
        _check_blocking(e, t, e_blk, t_blk)
        dot16 = io_bf16 if bf16_dot is None else bool(bf16_dot)
        rows = default_blocked_rows(b, dot16) if rows is None else rows
        if dot16:       # H/16 warps, m16 row tiles
            threads = (h // MMA_UNITS) * 32
            registers = (REGISTERS_PER_THREAD
                         if (rows, e_blk) == (MMA_UNITS, 1)
                         else REGISTERS_PER_THREAD_MAX)
            max_threads = MAX_THREADS
        else:           # 3xTF32: one warp per 8 units, those past H masked
            threads = 32 * -(-h // TF32_FWD_UNITS)
            registers = _register_cap(TF32_FWD_MAX_THREADS)
            max_threads = TF32_FWD_MAX_THREADS
        smem = fwd_blocked_smem_bytes(h, rows, e_blk, t_blk, io_bf16, dot16)
        kernels["fwd_blocked"] = _plan_entry(
            rows, threads, smem, -(-b // max(rows, 1)) * (e // e_blk),
            _blocked_refusal(h, rows, e_blk, t_blk, threads, io_bf16, dot16),
            registers, max_threads)
    else:
        if rows is not None or e_blk != 1 or t_blk != 1:
            raise ValueError("K1-K3 run 16 rows and one expert per CTA over "
                             "the whole time loop; rows, e_blk and t_blk "
                             "plan K4 (blocked=True)")
        threads = ROW_GROUPS * h
        ctas = -(-b // ROW_TILE) * e
        mma_refusal = None
        if io_bf16 and h % MMA_UNITS:
            mma_refusal = (f"the bf16 tensor-core kernels take hidden sizes "
                           f"H % {MMA_UNITS} == 0 (one warp per {MMA_UNITS} "
                           f"units, m16n8k16 tiles); got H={h}")
        refusal = mma_refusal
        if refusal is None and (h % 4 or threads > MAX_THREADS):
            refusal = (f"takes hidden sizes H % 4 == 0 with {ROW_GROUPS}*H "
                       f"<= {MAX_THREADS} threads; got H={h}")
        fwd = "fwd_train" if training else "fwd"
        if io_bf16:
            kernels[fwd] = _plan_entry(ROW_TILE, threads,
                                       fwd_smem_bytes(h, True), ctas, refusal)
        else:       # 3xTF32: one warp per 8 units, those past H masked
            kernels[fwd] = _plan_entry(
                ROW_TILE, 32 * -(-h // TF32_FWD_UNITS),
                fwd_smem_bytes(h, False), ctas, refusal,
                _register_cap(TF32_FWD_MAX_THREADS), TF32_FWD_MAX_THREADS)
        if training:
            refusal = mma_refusal
            if refusal is None and (h % 8 or threads > MAX_THREADS):
                refusal = (f"takes hidden sizes H % 8 == 0 with "
                           f"{ROW_GROUPS}*H <= {MAX_THREADS} threads; got "
                           f"H={h}")
            smem = bwd_smem_bytes(h, io_bf16)
            kernels["bwd"] = (
                _plan_entry(ROW_TILE, threads, smem, ctas, refusal)
                if io_bf16 else     # 3xTF32: one warp per 16 units
                _plan_entry(ROW_TILE, 32 * -(-h // MMA_UNITS), smem, ctas,
                            refusal, _register_cap(TF32_BWD_MAX_THREADS),
                            TF32_BWD_MAX_THREADS))
    refused = [k for k, v in kernels.items() if not v["fits"]]
    binding = refused[0] if refused else max(
        kernels, key=lambda k: kernels[k]["smem_bytes"])
    plan = {"kernels": kernels, "binding": binding, **kernels[binding]}
    plan["io_dtype"] = "bfloat16" if io_bf16 else "float32"
    plan["shape"] = {"E": e, "T": t, "B": b, "H": h, "G3": g3}
    return plan


def _refuse(name: str, entry: dict, proj: torch.Tensor) -> None:
    if not entry["fits"]:
        raise ValueError(f"{name}: {entry['refusal']}; proj shape "
                         f"{tuple(proj.shape)} {proj.dtype}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _forward_loop(proj, w_hh, b_hh, h0, reverse, emit_prev, stash=True,
                  bf16_dot=None, out_dtype=None):
    """The forward recurrence step by step.  The dot reads h and W_hh
    rounded to bf16 when ``bf16_dot`` (default: proj is bf16), their exact
    products summed in f32; h is stored in ``out_dtype`` (default proj's),
    ``h_prev`` and ``gates`` in proj's dtype."""
    e, t, b, g3 = proj.shape
    h = g3 // 3
    bf16 = proj.dtype == torch.bfloat16 if bf16_dot is None else bf16_dot
    w = w_hh.float()
    if bf16:
        w = w.to(torch.bfloat16).float()
    bias = b_hh.float()[:, None, :]
    carry = h0.float()
    out = torch.empty((e, t, b, h), dtype=out_dtype or proj.dtype,
                      device=proj.device)
    h_prev = torch.empty((e, t, b, h), dtype=proj.dtype,
                         device=proj.device) if emit_prev else None
    gates = torch.empty_like(proj) if emit_prev and stash else None
    for s in range(t):
        tt = t - 1 - s if reverse else s
        h_dot = carry.to(torch.bfloat16).float() if bf16 else carry
        g = torch.bmm(h_dot, w) + bias
        if emit_prev:
            h_prev[:, tt] = carry.to(proj.dtype)
        if gates is not None:
            gates[:, tt] = g.to(proj.dtype)
        g_r, g_z, g_n = g.split(h, dim=-1)
        x_r, x_z, x_n = proj[:, tt].float().split(h, dim=-1)
        r = torch.sigmoid(x_r + g_r)
        z = torch.sigmoid(x_z + g_z)
        n = torch.tanh(x_n + r * g_n)
        carry = (1.0 - z) * n + z * carry
        out[:, tt] = carry.to(out.dtype)
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
    the carry before the step (``h_prev [E, T, B, H]``) and, with
    :data:`STASH_GATES`, the pre-activation hidden gates ``h·W_hh + b_hh``
    (``gates [E, T, B, 3H]``), both in proj's dtype.  Returns ``(h_all,
    h_prev, gates)``, gates None without the stash."""
    return _forward_loop(proj, w_hh, b_hh, h0, reverse, emit_prev=True,
                         stash=STASH_GATES)


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


def gru_fwd_blocked_reference(proj: torch.Tensor, w_hh: torch.Tensor,
                              b_hh: torch.Tensor, h0: torch.Tensor,
                              e_blk: int = 1, t_blk: int = 1,
                              bf16_dot: bool = False) -> torch.Tensor:
    """K4's plain version: ``make_fwd_call(e_blk, t_blk, bf16_dot)``.

    K1's forward recurrence (no ``reverse``) with an f32 output whatever
    proj's dtype; the dot reads h and W_hh rounded to bf16 iff
    ``bf16_dot`` (so bf16 inputs without it run an f32 dot of bf16
    weights), b_hh and the carry in f32.  The blocking does not change the
    arithmetic; it is checked as K4 checks it (ValueError unless ``e_blk``
    divides E and ``t_blk`` divides T).
    """
    e, t, _, _ = _dims(proj)
    _check_blocking(e, t, e_blk, t_blk)
    return _forward_loop(proj, w_hh, b_hh, h0, False, emit_prev=False,
                         bf16_dot=bool(bf16_dot), out_dtype=torch.float32)[0]


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


def _check_fwd(name, proj, w_hh, b_hh, h0) -> tuple[int, int, int, int]:
    e, t, b, h = _dims(proj)
    _check(name, proj, {"w_hh": (w_hh, (e, h, 3 * h), proj.dtype),
                        "b_hh": (b_hh, (e, 3 * h), torch.float32),
                        "h0": (h0, (e, b, h), torch.float32)})
    return e, t, b, h


def _launch(kernel: CudaKernel, fn: str, proj: torch.Tensor, *args) -> None:
    """Call C entry ``fn`` on proj's device and current stream; count the
    launch and raise on a nonzero CUDA error."""
    lib = kernel.library()
    with torch.cuda.device(proj.device):
        stream = torch.cuda.current_stream(proj.device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
        with LAUNCH_LOCK:
            held = _HELD.get(stream)
            if held is not None:
                held[kernel] = held.get(kernel, 0) + 1
            else:
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
    the kernel does not take, including what :func:`block_plan` refuses (a
    hidden size whose ``W_hh`` and carry tile do not fit in one CTA's
    shared memory).
    """
    e, t, b, h = _check_fwd("gru_fwd_cuda", proj, w_hh, b_hh, h0)
    _refuse("gru_fwd_cuda", block_plan(e, t, b, h, proj.dtype,
                                       training=False)["kernels"]["fwd"],
            proj)
    out = torch.empty((e, t, b, h), dtype=proj.dtype, device=proj.device)
    _launch(GRU_FWD, "gru_fwd", proj, proj.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(), e, t, b, h,
            int(proj.dtype == torch.bfloat16), int(bool(reverse)))
    return out


def gru_fwd_train_cuda(proj: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, h0: torch.Tensor,
                       reverse: bool = False):
    """K2: launch ``csrc/gru_fwd.cu`` (entry ``gru_fwd_train``).  Contract
    of :func:`gru_fwd_train_reference` with the inputs of
    :func:`gru_fwd_cuda`; returns ``(h_all, h_prev, gates)``.  Without
    :data:`STASH_GATES` the kernel gets a null gates pointer, writes no
    gates, and gates is None."""
    e, t, b, h = _check_fwd("gru_fwd_train_cuda", proj, w_hh, b_hh, h0)
    _refuse("gru_fwd_train_cuda", block_plan(
        e, t, b, h, proj.dtype, training=True)["kernels"]["fwd_train"], proj)
    out = torch.empty((e, t, b, h), dtype=proj.dtype, device=proj.device)
    h_prev = torch.empty_like(out)
    gates = torch.empty_like(proj) if STASH_GATES else None
    _launch(GRU_FWD_TRAIN, "gru_fwd_train", proj, proj.data_ptr(),
            w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(),
            h_prev.data_ptr(), None if gates is None else gates.data_ptr(),
            e, t, b, h, int(proj.dtype == torch.bfloat16), int(bool(reverse)))
    return out, h_prev, gates


def gru_bwd_cuda(proj: torch.Tensor, h_prev: torch.Tensor,
                 gates: torch.Tensor | None, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, dout: torch.Tensor,
                 reverse: bool = False):
    """K3: launch ``csrc/gru_bwd.cu`` (the backward recurrence, then the
    dW/db product) on the current stream of proj's device.

    Contract of :func:`gru_bwd_reference`: ``h_prev``, ``gates`` (or None,
    and then the kernel recomputes them), ``w_hh`` and ``dout`` in proj's
    dtype, ``b_hh`` in f32, all contiguous on one CUDA device.  Allocates
    the dgates and db-partial workspaces.  Raises on anything the kernels
    do not take, including what :func:`block_plan` refuses (``W_hh`` plus
    the tiles above one CTA's shared memory).
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
    _refuse("gru_bwd_cuda", block_plan(e, t, b, h, io, training=True)[
        "kernels"]["bwd"], proj)
    dev = proj.device
    n_tiles = -(-b // ROW_TILE)
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
            dgates.data_ptr(), db_part.data_ptr(), e, t, b, h,
            int(io == torch.bfloat16), int(bool(reverse)))
    return dproj, dw, db, dh0


def gru_fwd_blocked_cuda(proj: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, h0: torch.Tensor,
                         e_blk: int = 1, t_blk: int = 1,
                         bf16_dot: bool = False,
                         rows: int | None = None) -> torch.Tensor:
    """K4: launch ``csrc/gru_fwd_blocked.cu`` on the current stream of
    proj's device, at the blocking ``rows`` (batch rows per CTA, default
    :func:`default_blocked_rows`), ``e_blk`` (experts per CTA, stepped
    time outer and expert inner) and ``t_blk`` (steps of proj held in
    shared memory; 1 loads them into registers).  The bf16 dot launches
    ``gru_fwd_blocked_mma_kernel``, the f32 dot the 3xTF32
    ``gru_fwd_blocked_tf32_kernel``.

    Contract of :func:`gru_fwd_blocked_reference` with the inputs of
    :func:`gru_fwd_cuda`; returns ``h_all [E, T, B, H]`` in f32.  Raises
    ValueError on a blocking K4's contract forbids and on what
    :func:`block_plan` refuses, before any launch.
    """
    e, t, b, h = _check_fwd("gru_fwd_blocked_cuda", proj, w_hh, b_hh, h0)
    entry = block_plan(e, t, b, h, proj.dtype, training=False, rows=rows,
                       e_blk=e_blk, t_blk=t_blk, blocked=True,
                       bf16_dot=bf16_dot)["kernels"]["fwd_blocked"]
    _refuse("gru_fwd_blocked_cuda", entry, proj)
    out = torch.empty((e, t, b, h), dtype=torch.float32, device=proj.device)
    _launch(GRU_FWD_BLOCKED, "gru_fwd_blocked", proj, proj.data_ptr(),
            w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), out.data_ptr(),
            e, t, b, h, entry["rows_per_cta"], e_blk, t_blk,
            int(proj.dtype == torch.bfloat16), int(bool(bf16_dot)))
    return out


# ---------------------------------------------------------------------------
# the custom VJP
# ---------------------------------------------------------------------------


class GRURecurrence(torch.autograd.Function):
    """``pallas_gru.py::gru_recurrence`` as an autograd Function.

    Forward runs K2 (its plain version for a CPU tensor) and saves the JAX
    residual set ``(proj, w_hh, b_hh, h0, h_prev, gates)``, gates None
    without :data:`STASH_GATES`; ``h_all`` is not a residual.  Backward
    casts ``dout`` to proj's dtype, runs K3 (or its plain version) with
    the stashed gates or their recompute, and returns each gradient in its
    input's dtype, as ``_vjp_bwd`` does.
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


# ---------------------------------------------------------------------------
# the inference form as a registered operator
# ---------------------------------------------------------------------------


@torch.library.custom_op("deeprest_torch::gru_fwd", mutates_args=(),
                         device_types="cpu")
def gru_fwd_op(proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               h0: torch.Tensor, reverse: bool) -> torch.Tensor:
    """K1 as the operator ``torch.ops.deeprest_torch.gru_fwd``: the
    dispatcher runs :func:`gru_fwd_cuda` for CUDA tensors and
    :func:`gru_recurrence_reference` for CPU tensors.  A traced program
    (``torch.export``, ``serve/export.py``) records this one node, so an
    artifact exported on the CPU still launches K1 once its program is
    placed on a GPU."""
    return gru_recurrence_reference(proj, w_hh, b_hh, h0, reverse)


@gru_fwd_op.register_kernel("cuda")
def _gru_fwd_op_cuda(proj, w_hh, b_hh, h0, reverse):
    return gru_fwd_cuda(proj, w_hh, b_hh, h0, reverse)


@gru_fwd_op.register_fake
def _gru_fwd_op_fake(proj, w_hh, b_hh, h0, reverse):
    e, t, b, g3 = proj.shape
    return proj.new_empty((e, t, b, g3 // 3))


def gru_recurrence(proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The recurrence on proj's device: differentiable through
    :class:`GRURecurrence` when autograd records and an input requires
    grad, else the inference form, the operator :func:`gru_fwd_op` (K1, or
    its plain version on the CPU)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj, w_hh, b_hh, h0)):
        return GRURecurrence.apply(proj, w_hh, b_hh, h0, reverse)
    return gru_fwd_op(proj, w_hh, b_hh, h0, bool(reverse))
