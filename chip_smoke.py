#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeprest_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build: the three CUDA sources (gru_fwd.cu with the inference and
   training forwards K1 and K2, gru_bwd.cu with the backward K3,
   gru_fwd_blocked.cu with the blocked forward K4 of the tuning sweep, all
   three including the tensor-core header gru_mma.cuh), one nvcc per
   source, all started together, into build/kernels/; ptxas's registers
   and spills of every kernel and instantiation; the block plan's
   shared-memory mirrors held against the sources' *_smem_bytes (K4 at
   every --quick blocking, both io dtypes, both dots);
3. each kernel against its plain PyTorch version on the card, with the JAX
   package's kernel tolerances (forward: f32 1e-5, bf16 2e-2; gradients
   relative to each tensor's largest magnitude: f32 2e-4, bf16 2e-2): K1 at
   the flagship serving shape (E=40 experts, T=60, B=256 rows, H=128); K2,
   K3 (gate stash on and off) and the autograd Function (against torch
   autograd through the plain recurrence) at the flagship training shape
   (B=32); all at ragged shapes (E=3, T=7, B=37 at H=128 and H=96;
   E=2, T=5, B=21 at H=64: bf16 runs H/16 warps on the tensor cores) too,
   in bf16 and f32, forward and reverse;
4. times: K1 at the serving shape, K2 and K3 at the training shape, each
   beside its plain version, the least time the card could take (bound),
   and cuDNN's GRU as a yardstick (torch.nn.GRU with W_ih = identity on the
   projections, one module per expert: forward for K1 and K2, autograd
   backward for K3; the port never calls it);
5. the serving main path at full width: a seeded flagship checkpoint
   (F=512, E=40, H=128, bidirectional, bf16) written with the port's
   writer, then `python -m deeprest_tpu_torch predict` on a day of minutes
   (1,440 x 512) held against the host-loop reference over the plain
   recurrence on the card, then predict_series_many on 16 what-if series
   (384 windows);
6. the training main path at full width: a seeded three-day corpus
   (4,320 x 512 Poisson call-path counts, 40 resource series) written with
   the port's FeaturizedData, `python -m deeprest_tpu_torch train` for 2
   epochs at B=32, T=60, bf16 with the default supersteps ("auto": one
   captured CUDA graph per update, replayed; finite, falling losses; K2
   and K3 launched twice per step, replays counted; at least one capture,
   one eager update before each and every other update a replay), the
   trained checkpoint served by one `predict` call, 5 steps on the kernels
   against 5 steps through the plain recurrence from the same params
   (dropout 0), a torch.profiler breakdown of 5 eager steps; then 20
   captured steps (S=10) against 20 eager ones from the same params
   (dropout 0 and 0.5: per-step losses equal, params within 1e-6
   relative), a profile of one captured superstep (10 replays), G=4
   "exact" against "loop" (bit for bit, dropout 0.5) and "flat" against
   "loop" (2e-2 of scale, dropout 0), K2+K3 per microbatch at G·B = 128
   rows against 32, a run killed at step 27 (S=3, snapshots every 10,
   dropout 0.5) and resumed against the uninterrupted run (1e-6
   relative), and steady-state steps/s eager and captured in turns;
7. raw telemetry to what-if answers and anomaly verdicts, through the
   port's CLI alone, at the width of the reference's own deployment (the
   social network: F=128 from 60 call paths, E=88, H=128, bf16):
   `simulate` 720 minutes of the normal scenario (seed 0), `featurize`,
   `train` 2 epochs at B=32, T=60 with both baselines (K2 and K3 launched
   twice per step, the report's resrc and comp columns); `whatif` of the
   sample's mean mix over a day of minutes swept at 0.5, 1, 2 and 4 (the
   synthesizer fit on the first 120 minutes), held against the same sweep
   through the plain recurrence on the card, and estimate_many over 16
   one-day programs timed, host synthesis and device apart; `anomaly` on
   240 minutes of the crypto scenario with a cryptojacking burner on
   compose-post-service over minutes 100-160, held against the plain
   path (flagged set, first_flag_index, scores); `predict --raw` on the
   training corpus equal to `predict --features`; the phase's seconds per
   CLI and its launches per kernel;
8. the kernel-tuning path: K4 (gru_fwd_blocked.cu) at every blocking of
   the sweep's --quick menu that the plan admits against its plain
   version, at the fused flagship stacking (E=80, T=60, B=32, H=128) and
   a ragged shape (E=4, T=12, B=37), f32 and bf16 inputs, the bf16 dot
   (tensor cores) off and on (tolerance 1e-5 with the f32 dot, 2e-2 with
   the bf16 dot); every admitted bf16 blocking timed, K1's blocking (16
   rows, one expert, two CTAs an SM) and at least one two-expert blocking
   required, beside its plain version, its bound and cuDNN's GRU x80;
   bidirectional_gru fused
   (BIDIR_FUSED) against unfused on the card at the flagship training
   shape, forward (1 K1 launch against 2) and gradients (1 K2 and 1 K3
   against 2 each); 5 train steps with STASH_GATES off against 5 with it
   on from the same params (dropout 0); then `python -m
   deeprest_tpu_torch.benchmarks.kernel_tuning --quick`, its JSON printed
   on one line;
9. one JSON line of per-kernel numbers, then the device line last.

The kernel launch counts are set to 0 just before each main path (5, 6, 7
and the sweep of 8) and read just after it; launches made to check or
time a kernel do not count.  A wrapper counts its launch on the host when
it is called, so a CUDA graph records the launches it holds at capture and
adds them once per replay (deeprest_tpu_torch/train/graphs.py).

It exits nonzero, printing no result, without CUDA or without the package
beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # of each tensor's max |value|
FLAGSHIP = dict(E=40, T=60, B=256, H=128)        # serving: 4 pages of 64
TRAIN = dict(E=40, T=60, B=32, H=128)            # training: bench.py:37
RAGGED = dict(E=3, T=7, B=37, H=128)
RAGGED_96 = dict(E=3, T=7, B=37, H=96)           # 6 warps in bf16
RAGGED_64 = dict(E=2, T=5, B=21, H=64)           # 4 warps in bf16
CHECK_SHAPES = (("ragged", RAGGED), ("ragged H=96", RAGGED_96),
                ("ragged H=64", RAGGED_64))
FUSED = dict(E=80, T=60, B=32, H=128)            # both directions stacked
TUNE_RAGGED = dict(E=4, T=12, B=37, H=128)
F, W, DAY = 512, 60, 1440
CORPUS_MINUTES = 3 * DAY
RESOURCES = ("cpu", "memory", "wiops", "wthroughput", "usage")
RAW_BUCKETS = 720                   # simulated social-network minutes
RAW_ANOMALY_BUCKETS = 240
ANOMALY_WINDOW = (100, 160)
SYNTH_BUCKETS = 120                 # the what-if synthesizer's sample
SWEEP = (0.5, 1.0, 2.0, 4.0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def recurrence_inputs(shape: dict, dtype, seed: int = SEED):
    import numpy as np
    import torch

    e, t, b, h = shape["E"], shape["T"], shape["B"], shape["H"]
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    proj = rng.standard_normal((e, t, b, 3 * h), np.float32)
    w_hh = rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-k, k, (e, 3 * h)).astype(np.float32)
    h0 = np.zeros((e, b, h), np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(proj).to(dev, dtype),
            torch.from_numpy(w_hh).to(dev, dtype),
            torch.from_numpy(b_hh).to(dev), torch.from_numpy(h0).to(dev))


def compare(got, want, dtype_name: str) -> tuple[float, float, bool]:
    rtol, atol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    ok = bool((diff <= atol + rtol * ref).all())
    return float(diff.max()), float(diff.max() / ref.max().clamp_min(1e-30)), ok


def compare_scaled(got, want, dtype_name: str) -> tuple[float, float, bool]:
    """Max |diff| against GRAD_TOL times the reference's max |value|."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max().clamp_min(1e-30))
    return diff, diff / scale, diff <= GRAD_TOL[dtype_name] * scale


def report_check(kernel: str, label: str, shape: dict, name: str,
                 what: str, result, tol) -> float:
    mx, rel, ok = result
    print(f"check {kernel} {label} {shape} {name} {what}: max_abs_err={mx:.3e} "
          f"max_err/max|ref|={rel:.3e} tol={tol} {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        fail(f"{kernel} disagrees with its plain version at {label} {name} "
             f"{what}")
    return mx


def check_train_kernels(cuda_gru, label: str, shape: dict, dtype) -> dict:
    """K2, K3 (stash on and off) and the autograd Function against their
    plain versions at one shape and dtype, both directions; returns the
    worst max_abs_err per kernel."""
    import torch

    name = str(dtype).removeprefix("torch.")
    worst = {"gru_fwd_train": 0.0, "gru_bwd": 0.0}
    args = recurrence_inputs(shape, dtype, seed=SEED + 1)
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    dout = torch.randn((shape["E"], shape["T"], shape["B"], shape["H"]),
                       generator=gen, device="cuda")
    for reverse in (False, True):
        got = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
        torch.cuda.synchronize()
        want = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
        for out_name, g, w_ in zip(("h_all", "h_prev", "gates"), got, want):
            worst["gru_fwd_train"] = max(worst["gru_fwd_train"], report_check(
                "gru_fwd_train", label, shape, name,
                f"reverse={reverse} {out_name}", compare(g, w_, name),
                TOL[name]))
        proj, w_hh, b_hh, _ = args
        _, h_prev, gates = want
        for stash in (True, False):
            g_in = gates if stash else None
            got = cuda_gru.gru_bwd_cuda(proj, h_prev, g_in, w_hh, b_hh,
                                        dout.to(dtype), reverse=reverse)
            torch.cuda.synchronize()
            want_b = cuda_gru.gru_bwd_reference(proj, h_prev, g_in, w_hh,
                                                b_hh, dout.to(dtype),
                                                reverse=reverse)
            for out_name, g, w_ in zip(("dproj", "dW_hh", "db_hh", "dh0"),
                                       got, want_b):
                worst["gru_bwd"] = max(worst["gru_bwd"], report_check(
                    "gru_bwd", label, shape, name,
                    f"reverse={reverse} stash={stash} {out_name}",
                    compare_scaled(g, w_, name), GRAD_TOL[name]))

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in args]
            out = fn(*leaves, reverse)
            (out.float() * dout).sum().backward()
            return [out.detach()] + [x.grad for x in leaves]

        got = grads(cuda_gru.gru_recurrence)
        torch.cuda.synchronize()
        want = grads(cuda_gru.gru_recurrence_reference)
        for out_name, g, w_ in zip(("h_all", "dproj", "dW_hh", "db_hh", "dh0"),
                                   got, want):
            report_check("autograd Function", label, shape, name,
                         f"reverse={reverse} {out_name}",
                         compare_scaled(g, w_, name), GRAD_TOL[name])
    return worst


def phase_kernel_checks(cuda_gru) -> dict:
    """Every kernel against its plain version; returns the worst bf16
    max_abs_err at the flagship shapes per kernel."""
    import torch

    worst_bf16 = 0.0
    worst_train = {}
    for label, shape in (("flagship training", TRAIN),) + CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            worst = check_train_kernels(cuda_gru, label, shape, dtype)
            if dtype == torch.bfloat16 and shape is TRAIN:
                worst_train = worst
    for label, shape in (("flagship", FLAGSHIP),) + CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            args = recurrence_inputs(shape, dtype)
            for reverse in (False, True):
                got = cuda_gru.gru_fwd_cuda(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = cuda_gru.gru_recurrence_reference(*args, reverse=reverse)
                mx, rel, ok = compare(got, want, name)
                print(f"check gru_fwd {label} {shape} {name} reverse={reverse}:"
                      f" max_abs_err={mx:.3e} max_rel_err={rel:.3e} "
                      f"tol(rtol,atol)={TOL[name]} {'ok' if ok else 'FAILED'}",
                      flush=True)
                if not ok:
                    fail(f"gru_fwd disagrees with its plain version at "
                         f"{label} {name} reverse={reverse}")
                if name == "bfloat16" and label == "flagship":
                    worst_bf16 = max(worst_bf16, mx)
            del args
    return {"gru_fwd": worst_bf16, **worst_train}


def cudnn_grus(w_hh, b_hh, dtype):
    """One torch.nn.GRU per expert computing the same recurrence on the
    projections: W_ih = identity, b_ih = 0."""
    import torch

    e, h, g3 = w_hh.shape
    grus = []
    with torch.no_grad():
        for i in range(e):
            m = torch.nn.GRU(g3, h).to("cuda", dtype)
            m.weight_ih_l0.copy_(torch.eye(g3))
            m.bias_ih_l0.zero_()
            m.weight_hh_l0.copy_(w_hh[i].t())
            m.bias_hh_l0.copy_(b_hh[i])
            m.flatten_parameters()
            grus.append(m)
    return grus


def cudnn_gru_ms(proj, w_hh, b_hh, h0, backward: bool = False):
    """cuDNN's GRU over the same recurrence, one nn.GRU call per expert.
    Forward: inference form without autograd; with ``backward``, the time
    of the autograd backward of the training forward (dproj and the weight
    gradients).  Returns (ms, the stacked forward outputs) or (None,
    reason) when cuDNN does not take the dtype."""
    import torch

    e = proj.shape[0]
    grus = cudnn_grus(w_hh, b_hh, proj.dtype)
    h0c = h0.to(proj.dtype)
    if not backward:
        def run():
            return [grus[i](proj[i], h0c[i][None])[0] for i in range(e)]
        with torch.no_grad():
            try:
                outs = run()
            except RuntimeError as exc:
                return None, f"cuDNN GRU refused {proj.dtype}: {exc}"
            return time_ms(run, iters=5), torch.stack(outs)
    x = proj.detach().requires_grad_(True)
    try:
        outs = [grus[i](x[i], h0c[i][None])[0] for i in range(e)]
    except RuntimeError as exc:
        return None, f"cuDNN GRU refused {proj.dtype}: {exc}"
    cot = [torch.ones_like(o) for o in outs]
    ms = time_ms(lambda: torch.autograd.backward(outs, cot, retain_graph=True),
                 iters=5)
    return ms, torch.stack([o.detach() for o in outs])


def bound(io_bytes: int, flops: int, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of the dtype, whichever is larger."""
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_times(kernel, library, dtype_name, shape, kernel_fn, plain_fn,
                 io_bytes, flops, library_ms, iters=20) -> dict:
    import torch

    kernel_ms = time_ms(kernel_fn, iters=iters)
    plain_ms = time_ms(plain_fn, iters=3, warmup=1)
    bound_ms, bound_by = bound(io_bytes, flops, dtype_name)
    print(f"times {kernel} {dtype_name} {shape}: kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
          f"bytes {io_bytes}, flops {flops}) library_ms={library_ms} "
          f"({library})", flush=True)
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": io_bytes, "flops": flops,
            "library_ms": library_ms}


def phase_times(cuda_gru) -> dict:
    """{kernel: {dtype name: times}} for K1 at the serving shape and K2, K3
    at the training shape."""
    import torch

    results = {"gru_fwd": {}, "gru_fwd_train": {}, "gru_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        args = recurrence_inputs(FLAGSHIP, dtype)
        proj, w_hh, b_hh, h0 = args
        e, t, b, h = (FLAGSHIP[k] for k in ("E", "T", "B", "H"))
        lib_ms, lib_out = cudnn_gru_ms(*args)
        if lib_ms is None:
            print(f"library {name}: {lib_out}", flush=True)
        else:
            kern = cuda_gru.gru_fwd_cuda(*args)
            print(f"library {name}: cuDNN GRU x{e} experts agrees with the "
                  f"kernel to max |diff| "
                  f"{float((lib_out.float() - kern.float()).abs().max()):.3e}",
                  flush=True)
        results["gru_fwd"][name] = kernel_times(
            "gru_fwd", "cuDNN GRU forward x40", name, FLAGSHIP,
            lambda: cuda_gru.gru_fwd_cuda(*args),
            lambda: cuda_gru.gru_recurrence_reference(*args),
            nbytes(*args) + e * t * b * h * proj.element_size(),
            2 * e * t * b * h * 3 * h, lib_ms)
        del args, proj, w_hh, b_hh, h0, lib_out

        args = recurrence_inputs(TRAIN, dtype)
        proj, w_hh, b_hh, h0 = args
        e, t, b, h = (TRAIN[k] for k in ("E", "T", "B", "H"))
        h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(*args)
        dout = torch.ones_like(h_all)
        flops = 2 * e * t * b * h * 3 * h
        lib_ms, _ = cudnn_gru_ms(*args)
        results["gru_fwd_train"][name] = kernel_times(
            "gru_fwd_train", "cuDNN GRU forward x40", name, TRAIN,
            lambda: cuda_gru.gru_fwd_train_cuda(*args),
            lambda: cuda_gru.gru_fwd_train_reference(*args),
            nbytes(*args, h_all, h_prev, gates), flops, lib_ms)
        lib_ms, _ = cudnn_gru_ms(*args, backward=True)
        bwd_in = (proj, h_prev, gates, w_hh, b_hh, dout)
        dproj, dw, db, dh0 = cuda_gru.gru_bwd_cuda(*bwd_in)
        results["gru_bwd"][name] = kernel_times(
            "gru_bwd", "cuDNN GRU autograd backward x40", name, TRAIN,
            lambda: cuda_gru.gru_bwd_cuda(*bwd_in),
            lambda: cuda_gru.gru_bwd_reference(*bwd_in),
            nbytes(*bwd_in, dproj, dw, db, dh0), 2 * flops, lib_ms)
        del args, proj, w_hh, b_hh, h0, h_all, h_prev, gates, dout, bwd_in
        del dproj, dw, db, dh0
        torch.cuda.empty_cache()
    return results


# Per kernel of the kernels line: its design in bf16 (the dtype of the main
# path) and the substrings that pick that instantiation's ptxas report out
# of its source's build log (K3: the recurrence with the stash, as trained,
# and its dW kernel).
DESIGNS = {
    "gru_fwd": ("mma.sync", ("gru_fwd_mma_kernelILb0E",), None),
    "gru_fwd_train": ("mma.sync", ("gru_fwd_mma_kernelILb1E",), None),
    "gru_bwd": ("mma.sync", ("gru_bwd_mma_kernelILb1E",),
                ("gru_bwd_dw_mma_kernel",)),
    "gru_fwd_blocked": ("mma.sync",
                        ("gru_fwd_blocked_mma_kernelI13__nv_bfloat16Li1ELi1E",),
                        None),
}


def phase_build(build, cuda_gru, kernel_tuning) -> dict:
    """Build every source; print ptxas's registers and spills per kernel;
    hold the plan's shared-memory mirrors against the built entries.
    Returns {kernel name: {"registers", "spill_bytes"[, "registers_dw",
    "spill_bytes_dw"]}} of each kernel's bf16 instantiation."""
    import torch

    build_s = build.build_all(cuda_gru.SOURCES)
    print(f"build: {len(cuda_gru.SOURCES)} sources in {build_s:.2f} s",
          flush=True)
    usage = {}
    for src in cuda_gru.SOURCES:
        for fn, use in build.ptxas_usage(src.build_log).items():
            usage[fn] = use
            print(f"  ptxas {src.name}: {fn}: {use['registers']} registers, "
                  f"{use['spill_bytes']} bytes spilled", flush=True)

    def find(needles):
        hits = [u for fn, u in usage.items() if all(n in fn for n in needles)]
        return hits[0] if hits else {"registers": None, "spill_bytes": None}

    regs = {}
    for name, (_, needles, dw_needles) in DESIGNS.items():
        regs[name] = dict(find(needles))
        if dw_needles:
            dw = find(dw_needles)
            regs[name].update(registers_dw=dw["registers"],
                              spill_bytes_dw=dw["spill_bytes"])
    fwd = cuda_gru.GRU_FWD_SOURCE.library()
    bwd = cuda_gru.GRU_BWD_SOURCE.library()
    blk = cuda_gru.GRU_FWD_BLOCKED_SOURCE.library()
    for h in (64, 96, 128):
        for bf16 in (0, 1):
            pairs = [(fwd.gru_fwd_smem_bytes(h, bf16),
                      cuda_gru.fwd_smem_bytes(h, bool(bf16)))]
            pairs += [(bwd.gru_bwd_smem_bytes(h, bf16, stash),
                       cuda_gru.bwd_smem_bytes(h, bool(bf16), bool(stash)))
                      for stash in (0, 1)]
            pairs += [(blk.gru_fwd_blocked_smem_bytes(h, rows, e_blk, t_blk,
                                                      bf16, dot),
                       cuda_gru.fwd_blocked_smem_bytes(
                           h, rows, e_blk, t_blk, bool(bf16), bool(dot)))
                      for rows, e_blk, t_blk in kernel_tuning.blocking_menu(
                          FUSED["E"], FUSED["T"], FUSED["B"], h, quick=True)
                      for dot in (0, 1)]
            if any(c != py for c, py in pairs):
                fail(f"block_plan's shared-memory mirrors {pairs} disagree "
                     f"with the sources at H={h} bf16={bf16}")
    plan = cuda_gru.block_plan(TRAIN["E"], TRAIN["T"], TRAIN["B"], TRAIN["H"],
                               torch.bfloat16, training=True, stash=True)
    print(f"plan: the mirrors equal the sources; flagship bf16 training: "
          f"{ {k: (v['smem_bytes'], v['ctas_per_sm'], v['waves']) for k, v in plan['kernels'].items()} } "
          f"(bytes, CTAs per SM, waves)", flush=True)
    return regs


def flagship_checkpoint(workdir: str):
    """Seeded flagship params and sidecar, written with the port's writer;
    returns (ckpt dir, traffic, delta mask)."""
    import dataclasses

    import numpy as np

    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.checkpoint import save_checkpoint

    e = FLAGSHIP["E"]
    cfg = ModelConfig(feature_dim=F, num_metrics=e, hidden_size=FLAGSHIP["H"],
                      num_layers=1, bidirectional=True,
                      compute_dtype="bfloat16")
    # names as bench.py builds them; every fifth resource is a level
    # (disk-usage-like) series served as integrated increments
    metric_names = [f"comp{i // 5}_res{i % 5}" for i in range(e)]
    delta = np.array([i % 5 == 4 for i in range(e)])
    rng = np.random.default_rng(SEED)
    traffic = rng.poisson(rng.uniform(0.5, 20.0, F),
                          (DAY, F)).astype(np.float32)
    y_min = rng.uniform(0.0, 1.0, e).astype(np.float32)
    extra = {
        "metric_names": metric_names,
        "x_stats": {"min": 0.0, "max": float(traffic.max())},
        "y_stats": {"min": y_min.tolist(),
                    "max": (y_min + rng.uniform(1.0, 50.0, e)).tolist()},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(cfg), "space": None,
        "delta_mask": delta.tolist(),
    }
    ckpt = os.path.join(workdir, "ckpt")
    save_checkpoint(ckpt, init_params(cfg, seed=SEED), step=0, extra=extra)
    return ckpt, traffic, delta


def device_rows(prof) -> list:
    """(device µs, count, name) of each kernel and copy the profiler saw,
    largest first.  Device-side events only: CPU ops also carry the device
    time of the kernels they launched, and a GPU range of a user annotation
    (such as the optimizer's step) spans kernels counted on their own."""
    import torch

    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def profile_what_if(pred, series) -> None:
    """Where the what-if call's time goes: device time by kernel name and
    the device's busy share of the call's wall time, from torch.profiler
    over one more predict_series_many call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_series_many(series)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("profile what-if: the profiler saw no device time "
              "(device breakdown not measured)", flush=True)
        return
    print(f"profile what-if: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} % of wall)",
          flush=True)
    for dev_us, count, key in rows[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)


def phase_main_path(cuda_gru) -> dict:
    import numpy as np
    import torch

    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import (
        Predictor, rolled_prediction_reference,
    )

    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=os.path.join(REPO, "build")) as wd:
        ckpt, traffic, delta = flagship_checkpoint(wd)
        feats = os.path.join(wd, "input.npz")
        np.savez(feats, traffic=traffic)
        out_path = os.path.join(wd, "preds.npz")

        for k in cuda_gru.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "deeprest_tpu_torch", "predict",
             "--ckpt-dir", ckpt, "--features", feats, "--out", out_path],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"predict CLI exited {proc.returncode}:\n{proc.stderr}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        cli_launches = int(report["kernel_launches"]["gru_fwd"])
        print(f"main predict CLI: {DAY}x{F} traffic in {cli_s:.2f} s "
              f"(process start, load, build check, predict), device "
              f"{report['device']}, gru_fwd launches {cli_launches}",
              flush=True)

        pred = Predictor.from_checkpoint(ckpt, device="cuda")
        t0 = time.perf_counter()
        pred.predict_series(traffic)                     # warm: cuBLAS init
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        scales = np.linspace(0.5, 2.0, 16).astype(np.float32)
        scales[0] = 1.0
        series = [traffic * s for s in scales]
        t0 = time.perf_counter()
        many = pred.predict_series_many(series)
        torch.cuda.synchronize()
        many_s = time.perf_counter() - t0
        n_windows = len(plan_windows([len(s) for s in series], W))
        print(f"main predict_series_many: 16 series, {n_windows} windows in "
              f"{many_s:.4f} s = {n_windows / many_s:.1f} windows/s "
              f"(warm-up call {warm_s:.3f} s); fused stats "
              f"{pred.fused.stats()}", flush=True)
        profile_what_if(pred, series)
        launches = cli_launches + cuda_gru.GRU_FWD.launches
        print(f"main gru_fwd launches: {launches} (CLI {cli_launches}, "
              f"in-process {cuda_gru.GRU_FWD.launches})", flush=True)
        if launches == 0:
            fail("the main path never launched gru_fwd")
        train_forms = (cuda_gru.GRU_FWD_TRAIN.launches
                       + cuda_gru.GRU_BWD.launches
                       + report["kernel_launches"]["gru_fwd_train"]
                       + report["kernel_launches"]["gru_bwd"])
        if train_forms:
            fail(f"serving launched {train_forms} training kernels; it "
                 "must run the inference form only")

        with np.load(out_path) as z:
            got = np.asarray(z["predictions"])
        e = FLAGSHIP["E"]
        if got.shape != (DAY, e, 3) or not np.isfinite(got).all():
            fail(f"CLI predictions have shape {got.shape} or non-finite "
                 "values; want finite [1440, 40, 3]")
        model = pred.model

        def plain_apply(x):
            with torch.inference_mode():
                return model(torch.from_numpy(x).cuda(),
                             recurrence=cuda_gru.gru_recurrence_reference
                             ).cpu().numpy()

        ref = rolled_prediction_reference(
            plain_apply, pred.x_stats, pred.y_stats, W, traffic,
            delta_mask=delta, median_index=pred.median_index())
        checks = {}
        for label, a in (("cli", got), ("many[0]", many[0])):
            for cols, name in ((~delta, "non-delta"), (delta, "delta")):
                diff = np.abs(a[:, cols] - ref[:, cols])
                scale = np.abs(ref[:, cols]).max()
                rel = float(diff.max() / scale)
                checks[f"{label} {name}"] = rel
                print(f"check main {label} {name} columns vs host loop over "
                      f"the plain recurrence: max_abs_err={diff.max():.4e} "
                      f"max_err/max|ref|={rel:.3e} (tol {TOL['bfloat16'][0]})",
                      flush=True)
                if rel > TOL["bfloat16"][0]:
                    fail(f"main path {label} {name} columns disagree with "
                         "the reference")
        for s in many:
            if s.shape != (DAY, e, 3) or not np.isfinite(s).all():
                fail("predict_series_many gave a wrong shape or non-finite "
                     "values")
    return {"launches": launches, "windows_per_s": n_windows / many_s,
            "checks": checks}


def train_step_flops(batch, window, features, experts, hidden, quantiles=3,
                     directions=2) -> float:
    """Analytic FLOPs per training step, as bench.py counts them: the
    input projections, the recurrence and the heads (2*M*N*K each),
    forward plus backward ~ 3x forward."""
    proj = 2 * batch * window * experts * features * 3 * hidden
    recur = 2 * batch * window * experts * hidden * 3 * hidden
    heads = 2 * batch * window * experts * (2 * directions * hidden) * quantiles
    return 3 * (directions * (proj + recur) + heads)


def flagship_corpus(path: str, minutes: int = CORPUS_MINUTES,
                    features: int = F, experts: int = TRAIN["E"]) -> str:
    """A seeded corpus of ``minutes`` x ``features`` Poisson call-path
    counts and ``experts`` resource series comp{c}_{cpu,memory,wiops,
    wthroughput,usage}: each a seeded linear map of the traffic plus noise;
    the usage series accumulate theirs (a disk-usage level, trained as
    per-bucket increments).  Written with the port's FeaturizedData;
    returns the file's path."""
    import numpy as np

    from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData

    rng = np.random.default_rng(SEED)
    traffic = rng.poisson(rng.uniform(0.5, 20.0, features),
                          (minutes, features)).astype(np.float32)
    resources = {}
    for i in range(experts):
        res = RESOURCES[i % len(RESOURCES)]
        w = rng.uniform(0.0, 1.0, features) * (rng.random(features) < 0.2)
        level = traffic @ w
        level = level + rng.normal(0.0, 0.05 * level.std(), minutes)
        if res == "usage":
            level = np.cumsum(np.abs(level)) / minutes
        resources[f"comp{i // len(RESOURCES)}_{res}"] = level.astype(
            np.float32)
    space = {"config": {"capacity": 0, "round_to": 128,
                        "hash_features": False, "hash_seed": 0x5EED},
             "vocabulary": [[f"svc{j % 16}", f"/op{j}"]
                            for j in range(features)],
             "frozen_capacity": features}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space)).save(path)


def run_cli_lines(args: list, timeout: int) -> list[str]:
    """One port CLI call in its own process; returns its stdout lines."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "deeprest_tpu_torch",
                           *map(str, args)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        fail(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stderr}")
    return proc.stdout.strip().splitlines()


def run_cli(args: list, timeout: int) -> dict:
    """One port CLI call in its own process; returns its last-line JSON."""
    return json.loads(run_cli_lines(args, timeout)[-1])


def profile_train_steps(label: str, run, steps: int) -> float | None:
    """Where ``steps`` train steps' time goes (``run()`` takes them): device
    time by kernel and the device's busy share of their wall time, from
    torch.profiler.  Returns the busy share in percent, None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    if not rows:
        print(f"profile {label}: the profiler saw no device time (device "
              "breakdown not measured)", flush=True)
        return None
    busy_us = sum(r[0] for r in rows)
    share = 100 * busy_us / wall_us
    print(f"profile {label}: {steps} steps, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({share:.1f} % of wall)",
          flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return share


def flagship_trainer(data, dropout: float = 0.0, split: float = 0.40,
                     **train):
    """A flagship Trainer on the card (B=32, T=60, H=128, bf16) and the
    bundle of ``data`` at train split ``split``."""
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(hidden_size=TRAIN["H"],
                                   dropout_rate=dropout,
                                   compute_dtype="bfloat16"),
                 train=TrainConfig(batch_size=TRAIN["B"], window_size=W,
                                   train_split=split, **train))
    bundle = prepare_dataset(data, cfg.train)
    return Trainer(cfg, F, bundle.metric_names, device="cuda"), bundle


def train_epochs(trainer, bundle, params, epochs: int = 1):
    """``epochs`` epochs of ``trainer.train_epoch`` from ``params`` (no
    evaluation); returns (state, per-step losses)."""
    import numpy as np

    state = trainer.init_state(params)
    staged = trainer.stage_dataset(bundle)
    rng = np.random.default_rng(SEED)
    losses = []
    for _ in range(epochs):
        state, _ = trainer.train_epoch(state, bundle, rng, staged)
        losses.append(trainer.last_epoch_losses)
    return state, np.concatenate(losses)


def params_rel_diff(a, b) -> tuple[float, float, bool]:
    """Worst max |a - b| / max |b| over the leaves of two states, the worst
    max |a - b|, and whether every leaf is bit-identical."""
    import torch

    rel = absd = 0.0
    same = True
    for name, want in b.params.items():
        got = a.params[name].detach()
        want = want.detach()
        d = float((got - want).abs().max())
        absd = max(absd, d)
        rel = max(rel, d / max(float(want.abs().max()), 1e-30))
        same = same and torch.equal(got, want)
    return rel, absd, same


# 20 steps of B=32 in an epoch: int((4,320 - 60) x 0.1503) = 640 windows
SPLIT_20_STEPS = 0.1503


def phase_supersteps(cuda_gru, feats: str, workdir: str) -> dict:
    """The trainer's supersteps on the card at the flagship width: captured
    against eager updates, the accumulation modes at G=4, a kill and resume,
    a profile of one captured superstep, and steady-state steps/s eager
    and captured."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params

    data = FeaturizedData.load(feats)
    out = {}

    # 20 captured steps (S=10) against 20 eager (S=1), dropout 0 and 0.5
    for dropout in (0.0, 0.5):
        runs = {}
        for label, s in (("eager", 1), ("captured", 10)):
            trainer, bundle = flagship_trainer(
                data, dropout, SPLIT_20_STEPS, steps_per_superstep=s)
            params = init_params(trainer.model_config, SEED)
            for k in cuda_gru.KERNELS:
                k.launches = 0
            state, losses = train_epochs(trainer, bundle, params)
            runs[label] = (trainer, state, losses,
                           {k.name: k.launches for k in cuda_gru.KERNELS})
        (tr_c, st_c, l_c, n_c), (_, st_e, l_e, n_e) = (runs["captured"],
                                                       runs["eager"])
        rel, absd, same = params_rel_diff(st_c, st_e)
        print(f"check captured (S=10) vs eager (S=1) 20 steps, dropout "
              f"{dropout}: losses equal {np.array_equal(l_c, l_e)} "
              f"(first {l_c[:3].tolist()} vs {l_e[:3].tolist()}); params max "
              f"relative difference {rel:.3e} (max abs {absd:.3e}, tol 1e-6), "
              f"bit-identical {same}; captured trainer: captures "
              f"{tr_c.captures}, replays {tr_c.replays}, dispatches "
              f"{tr_c.dispatches}; launches captured {n_c}, eager {n_e}",
              flush=True)
        if len(l_c) != 20 or not np.array_equal(l_c, l_e):
            fail(f"captured steps disagree with eager steps (dropout "
                 f"{dropout}): per-step losses differ")
        if rel > 1e-6:
            fail(f"captured params differ from eager by {rel:.3e} relative "
                 f"after 20 steps (dropout {dropout})")
        if (tr_c.captures, tr_c.replays, tr_c.dispatches) != (1, 19, 20):
            fail("the captured run did not take 1 capture, 19 replays and "
                 "20 dispatches")
        for name in ("gru_fwd_train", "gru_bwd"):
            if n_c[name] != 40 or n_e[name] != 40:
                fail(f"{name} counted {n_c[name]} (captured) and "
                     f"{n_e[name]} (eager) launches over 20 steps; want 40")
        out[f"captured_bit_identical_dropout_{dropout}"] = same
        if dropout == 0.0:
            # one captured superstep, profiled: 10 replays after the epoch
            plan = tr_c._epoch_plan(bundle.num_train_windows,
                                    np.random.default_rng(SEED), 10)
            tr_c._stage_plan(st_c, st_c.plan.staged, plan[0], plan[1], 0)

            def superstep():
                for _ in range(10):
                    tr_c._run_update(st_c, True)
                    st_c.step += 1

            out["busy_captured_pct"] = profile_train_steps(
                "train captured superstep (S=10)", superstep, 10)
        del runs, tr_c, st_c, st_e
        torch.cuda.empty_cache()

    # G=4: "exact" against "loop" with dropout 0.5 (bit for bit), "flat"
    # against "loop" with dropout 0 (bf16 tolerance)
    states = {}
    for label, mode, dropout in (("loop 0.5", "loop", 0.5),
                                 ("exact 0.5", "exact", 0.5),
                                 ("loop 0", "loop", 0.0),
                                 ("flat 0", "flat", 0.0)):
        trainer, bundle = flagship_trainer(
            data, dropout, SPLIT_20_STEPS, grad_accum_windows=4,
            grad_accum_mode=mode)
        params = init_params(trainer.model_config, SEED)
        state, losses = train_epochs(trainer, bundle, params)
        states[label] = (state, losses)
        print(f"G=4 {label}: {len(losses)} microbatches in "
              f"{trainer.dispatches} updates (captures {trainer.captures}), "
              f"losses {losses[:4].tolist()}", flush=True)
    rel, absd, same = params_rel_diff(states["exact 0.5"][0],
                                      states["loop 0.5"][0])
    equal = np.array_equal(states["exact 0.5"][1], states["loop 0.5"][1])
    print(f"check G=4 exact vs loop (dropout 0.5): losses equal {equal}, "
          f"params bit-identical {same} (max abs {absd:.3e})", flush=True)
    if not (equal and same):
        fail("G=4 'exact' is not bit-identical to 'loop'")
    worst = 0.0
    for name, want in states["loop 0"][0].params.items():
        got = states["flat 0"][0].params[name].detach()
        worst = max(worst, float((got - want.detach()).abs().max())
                    / max(float(want.detach().abs().max()), 1e-30))
    print(f"check G=4 flat vs loop (dropout 0): params max difference "
          f"{worst:.3e} of scale (tol 2e-2)", flush=True)
    if worst > 2e-2:
        fail("G=4 'flat' disagrees with 'loop'")
    out["flat_vs_loop"] = worst
    del states
    torch.cuda.empty_cache()

    # K2 + K3 per microbatch: G·B = 128 rows a launch against 32
    per = {}
    for g in (1, 4):
        shape = dict(TRAIN, B=TRAIN["B"] * g)
        args = recurrence_inputs(shape, torch.bfloat16)
        h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(*args)
        dout = torch.ones_like(h_all)
        bwd_in = (args[0], h_prev, gates, args[1], args[2], dout)
        fwd_ms = time_ms(lambda: cuda_gru.gru_fwd_train_cuda(*args), 20)
        bwd_ms = time_ms(lambda: cuda_gru.gru_bwd_cuda(*bwd_in), 20)
        per[g] = (fwd_ms / g, bwd_ms / g)
        del args, h_all, h_prev, gates, dout, bwd_in
    gain = (sum(per[1]) / sum(per[4]))
    print(f"times K2+K3 per microbatch bf16: B=32 K2 {per[1][0]:.4f} + K3 "
          f"{per[1][1]:.4f} ms; G=4 flat (B=128) K2 {per[4][0]:.4f} + K3 "
          f"{per[4][1]:.4f} ms per microbatch: {gain:.2f}x (PR 5 sweep: "
          f"1.59x at G=4)", flush=True)
    out["flat_g4_gain"] = gain

    # kill at step 27 and resume, flagship width, dropout 0.5
    ckpt_a = os.path.join(workdir, "snap_a")
    ckpt_b = os.path.join(workdir, "snap_b")

    class Preempted(BaseException):
        pass

    def kill_at_27(step):
        if step >= 27:
            raise Preempted

    finals = {}
    for label, ckpt in (("uninterrupted", ckpt_a), ("killed", ckpt_b)):
        trainer, bundle = flagship_trainer(
            data, 0.5, steps_per_superstep=3, snapshot_every_steps=10,
            checkpoint_dir=ckpt)
        params = init_params(trainer.model_config, SEED)
        try:
            finals[label] = trainer.fit(
                bundle, state=trainer.init_state(params), num_epochs=1,
                on_step=None if label == "uninterrupted" else kill_at_27)
        except Preempted:
            print(f"killed at step {trainer.global_step}", flush=True)
    trainer, bundle = flagship_trainer(
        data, 0.5, steps_per_superstep=3, snapshot_every_steps=10,
        checkpoint_dir=ckpt_b)
    finals["resumed"] = trainer.resume_training(bundle, num_epochs=1)
    rel, absd, same = params_rel_diff(finals["resumed"][0],
                                      finals["uninterrupted"][0])
    print(f"check kill at 27 and resume (S=3, snapshots every 10, dropout "
          f"0.5): resumed from step {trainer.resumed_from_step}, "
          f"{finals['resumed'][0].step} steps; params max relative "
          f"difference {rel:.3e}, max abs {absd:.3e} (tol 1e-6), "
          f"bit-identical {same}; test loss "
          f"{finals['resumed'][1][-1].test_loss} vs "
          f"{finals['uninterrupted'][1][-1].test_loss}", flush=True)
    if "killed" in finals or trainer.resumed_from_step != 24:
        fail("the kill at step 27 did not land, or the resume did not start "
             "from the snapshot at step 24")
    if rel > 1e-6 or finals["resumed"][0].step != finals["uninterrupted"][
            0].step:
        fail("the resumed run does not end at the uninterrupted run's params")
    out["resume_rel"] = rel
    del finals, trainer
    torch.cuda.empty_cache()

    # steady-state steps/s, eager and captured, in turns
    rates = {"eager": [], "captured": []}
    for label in ("eager", "captured", "captured", "eager"):
        trainer, bundle = flagship_trainer(
            data, 0.5, steps_per_superstep=1 if label == "eager" else "auto")
        params = init_params(trainer.model_config, SEED)
        train_epochs(trainer, bundle, params, epochs=2)
        rates[label].append(trainer.throughput.steps_per_sec)
        del trainer
        torch.cuda.empty_cache()
    print(f"steady-state steps/s (2 epochs of {bundle.num_train_windows} "
          f"windows, first update excluded), in turns: eager "
          f"{rates['eager']}, captured (S=auto) {rates['captured']}",
          flush=True)
    out["steps_per_sec"] = rates
    return out


def phase_training(cuda_gru) -> dict:
    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    e, b, h = TRAIN["E"], TRAIN["B"], TRAIN["H"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=os.path.join(REPO, "build")) as wd:
        feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
        ckpt = os.path.join(wd, "ckpt")
        for k in cuda_gru.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        report = run_cli(["train", "--features", feats, "--epochs", "2",
                          "--batch-size", str(b), "--window", str(W),
                          "--compute-dtype", "bfloat16", "--ckpt-dir", ckpt,
                          "--no-baselines"], timeout=900)
        train_s = time.perf_counter() - t0
        served = run_cli(["predict", "--ckpt-dir", ckpt, "--features", feats,
                          "--out", os.path.join(wd, "preds")], timeout=600)
        launches = dict(report["kernel_launches"])
        launches["gru_fwd"] += served["kernel_launches"]["gru_fwd"]
        steps = int(report["steps"])
        flops = train_step_flops(b, W, F, e, h)
        share = report["steps_per_sec"] * flops / PEAK_FLOPS["bfloat16"]
        print(f"main train CLI: {CORPUS_MINUTES}x{F} corpus, 2 epochs, "
              f"{steps} steps in {train_s:.2f} s of wall time (process "
              f"start, load, 2 evaluations and the checkpoint included); "
              f"steady state {report['steps_per_sec']:.3f} steps/s = "
              f"{100 * share:.4f} % of 989 TFLOP/s at {flops / 1e12:.4f} "
              f"TFLOP per step; epoch losses {report['epoch_losses']}; "
              f"test losses {report['test_losses']}; device "
              f"{report['device']}; launches {launches}", flush=True)
        losses = np.asarray(report["step_losses"], np.float64)
        if not np.isfinite(losses).all():
            fail("train CLI gave non-finite step losses")
        if not report["epoch_losses"][1] < report["epoch_losses"][0]:
            fail(f"epoch losses did not fall: {report['epoch_losses']}")
        for name in ("gru_fwd_train", "gru_bwd"):
            if launches[name] != 2 * steps:
                fail(f"{name} launched {launches[name]} times in {steps} "
                     f"train steps; want 2 x steps (two directions), graph "
                     f"replays counted")
        if launches["gru_fwd"] == 0:
            fail("evaluation and serving never launched gru_fwd")
        eager = report["dispatches"] - report["replays"]
        print(f"main train CLI supersteps: S={report['steps_per_superstep']}"
              f", G={report['grad_accum_windows']}; {report['dispatches']} "
              f"dispatches = {report['replays']} graph replays + {eager} "
              f"eager updates; {report['captures']} captures", flush=True)
        if report["captures"] < 1 or report["dispatches"] != steps \
                or eager != report["captures"]:
            fail("the default train run did not go through a captured graph "
                 "(want captures >= 1, one eager update before each capture "
                 "and every other update a replay)")
        mae = [v for m in report["report"].values()
               for s in m.values() for v in s.values()]
        if not np.isfinite(mae).all():
            fail("the MAE report has non-finite values")
        with np.load(served["out"]) as z:
            preds = np.asarray(z["predictions"])
        if preds.shape != (CORPUS_MINUTES, e, 3) or not np.isfinite(
                preds).all():
            fail(f"predictions of the trained checkpoint have shape "
                 f"{preds.shape} or non-finite values; want finite "
                 f"[{CORPUS_MINUTES}, {e}, 3]")
        print(f"main predict CLI on the trained checkpoint: {preds.shape}, "
              f"finite", flush=True)

        # 5 steps on the kernels against 5 through the plain recurrence
        cfg = Config(model=ModelConfig(hidden_size=h, dropout_rate=0.0,
                                       compute_dtype="bfloat16"),
                     train=TrainConfig(batch_size=b, window_size=W))
        bundle = prepare_dataset(FeaturizedData.load(feats), cfg.train)
        trainer = Trainer(cfg, F, bundle.metric_names, device="cuda")
        params = init_params(trainer.model_config, SEED)
        batches = list(trainer._batches(bundle.num_train_windows,
                                        np.random.default_rng(SEED)))
        runs = {}
        for label, recurrence in (("kernels", None),
                                  ("plain", cuda_gru.gru_recurrence_reference)):
            run = Trainer(cfg, F, bundle.metric_names, device="cuda",
                          recurrence=recurrence)
            state = run.init_state(params)
            staged = run.stage_dataset(bundle)
            runs[label] = [float(run.train_step(state, staged, sel, wt))
                           for sel, wt in batches[:5]]
        rel = max(abs(a - p) / abs(p) for a, p in zip(runs["kernels"],
                                                      runs["plain"]))
        print(f"check train 5 steps, kernels vs plain recurrence on the card "
              f"(dropout 0): {runs['kernels']} vs {runs['plain']}, max "
              f"relative difference {rel:.3e} (tol 2e-2)", flush=True)
        if rel > 2e-2:
            fail("training on the kernels disagrees with training through "
                 "the plain recurrence")

        state = trainer.init_state(params)
        staged = trainer.stage_dataset(bundle)
        for sel, wt in batches[:3]:
            trainer.train_step(state, staged, sel, wt)      # warm

        def eager_steps():
            for sel, wt in batches[3:8]:
                trainer.train_step(state, staged, sel, wt)

        busy_eager = profile_train_steps("train eager", eager_steps, 5)
        del trainer, state, staged
        supersteps = phase_supersteps(cuda_gru, feats, wd)
    return {"launches": launches, "steps": steps,
            "steps_per_sec": report["steps_per_sec"], "peak_share": share,
            "epoch_losses": report["epoch_losses"], "parity_rel": rel,
            "busy_eager_pct": busy_eager, **supersteps}


def rounded(seconds: dict) -> dict:
    return {k: round(v, 3) for k, v in seconds.items()}


def sweep_error(got: list, want: list, y_range) -> float:
    """Worst |kernel peak - plain peak| of a what-if sweep, each metric's
    error over its scale: the largest |plain peak| of that metric in the
    sweep, floored at its train-split range."""
    worst = 0.0
    for e, metric in enumerate(want[0]["peaks"]):
        plain = [r["peaks"][metric][q] for r in want for q in r["peaks"][metric]]
        kern = [r["peaks"][metric][q] for r in got for q in r["peaks"][metric]]
        scale = max(max(abs(v) for v in plain), float(y_range[e]), 1e-12)
        worst = max(worst, max(abs(a - b) for a, b in zip(kern, plain))
                    / scale)
    return worst


def phase_raw_to_answers(cuda_gru) -> dict:
    """Raw telemetry in, what-if answers and anomaly verdicts out, through
    the port's CLI: simulate the social network (the reference's own
    deployment), featurize it (F=128 from 60 call paths, E=88), train at
    H=128 with both baselines, then whatif, anomaly and predict --raw from
    the checkpoint, each held against the plain path on the card."""
    from collections import Counter

    import numpy as np
    import torch

    from deeprest_tpu_torch.data.featurize import featurize_buckets
    from deeprest_tpu_torch.data.schema import (
        load_raw_data, save_raw_data_jsonl,
    )
    from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
    from deeprest_tpu_torch.serve.anomaly import AnomalyDetector
    from deeprest_tpu_torch.serve.fused import plan_windows
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.whatif import WhatIfEstimator
    from deeprest_tpu_torch.workload import SCENARIOS, Anomaly
    from deeprest_tpu_torch.workload.simulator import simulate_corpus

    names = [k.name for k in cuda_gru.MODEL_KERNELS]
    launches = dict.fromkeys(names, 0)

    def count(report):
        for k in names:
            launches[k] += int(report["kernel_launches"][k])

    secs = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_",
                                     dir=os.path.join(REPO, "build")) as wd:
        raw = os.path.join(wd, "raw.jsonl")
        feats = os.path.join(wd, "input.npz")
        ckpt = os.path.join(wd, "ckpt")
        for k in cuda_gru.KERNELS:
            k.launches = 0

        t0 = time.perf_counter()
        run_cli(["simulate", "--scenario", "normal", "--seed", SEED,
                 "--ticks", RAW_BUCKETS, "--out", raw], timeout=600)
        secs["simulate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fz = run_cli(["featurize", "--raw", raw, "--out", feats], timeout=600)
        secs["featurize"] = time.perf_counter() - t0
        sizes = (fz["capacity"], fz["observed_paths"], len(fz["metrics"]))
        print(f"main raw simulate + featurize: {fz['buckets']} buckets of the "
              f"social network (normal, seed {SEED}) -> F={sizes[0]} from "
              f"{sizes[1]} observed call paths, E={sizes[2]} metrics; "
              f"simulate {secs['simulate']:.2f} s, featurize "
              f"{secs['featurize']:.2f} s (CLI wall, process start "
              f"included)", flush=True)
        if sizes != (128, 60, 88):
            fail(f"featurize gave (F, paths, E) = {sizes}; want (128, 60, 88)")

        t0 = time.perf_counter()
        tr = run_cli(["train", "--features", feats, "--compute-dtype",
                      "bfloat16", "--epochs", 2, "--batch-size", TRAIN["B"],
                      "--window", W, "--hidden-size", TRAIN["H"],
                      "--ckpt-dir", ckpt], timeout=900)
        secs["train"] = time.perf_counter() - t0
        count(tr)
        steps = int(tr["steps"])
        if not np.isfinite(np.asarray(tr["step_losses"], np.float64)).all():
            fail("train CLI (baselines on) gave non-finite step losses")
        for name in ("gru_fwd_train", "gru_bwd"):
            if tr["kernel_launches"][name] != 2 * steps:
                fail(f"{name} launched {tr['kernel_launches'][name]} times "
                     f"in {steps} train steps; want 2 x steps")
        methods = {m for v in tr["report"].values() for m in v}
        if methods != {"deepr", "resrc", "comp"}:
            fail(f"train report has methods {sorted(methods)}; want deepr, "
                 "resrc and comp")
        medians = {m: float(np.mean([v[m]["median"]
                                     for v in tr["report"].values()]))
                   for m in sorted(methods)}
        if not all(np.isfinite(list(medians.values()))):
            fail("the train report's MAE is not finite")
        print(f"main raw train CLI (baselines on): {steps} steps, epoch "
              f"losses {tr['epoch_losses']}, launches {tr['kernel_launches']}"
              f", mean median MAE per method {medians}; "
              f"{secs['train']:.2f} s (stages {rounded(tr['seconds'])})",
              flush=True)

        # what-if: the CLI on the kernels against the same sweep through
        # the plain recurrence in-process; the synthesizer is fit on the
        # corpus's first SYNTH_BUCKETS minutes (every endpoint's trace
        # shapes, at a sixth of the load cost)
        sample = os.path.join(wd, "sample.jsonl")
        with open(raw, encoding="utf-8") as src, \
                open(sample, "w", encoding="utf-8") as dst:
            for _, line in zip(range(SYNTH_BUCKETS), src):
                dst.write(line)
        t0 = time.perf_counter()
        buckets = load_raw_data(sample)
        t_load = time.perf_counter() - t0
        plain = Predictor.from_checkpoint(
            ckpt, device="cuda",
            recurrence=cuda_gru.gru_recurrence_reference)
        t0 = time.perf_counter()
        synth = TraceSynthesizer(plain.space()).fit(buckets)
        t_fit = time.perf_counter() - t0
        if len(synth.endpoints) != 7:
            fail(f"the synthesizer found endpoints {synth.endpoints}")
        # the sample's mean calls per minute of each endpoint
        calls = Counter(t.label for b in buckets for t in b.traces)
        mix = {ep: int(round(calls[ep] / len(buckets)))
               for ep in synth.endpoints}
        del buckets
        t0 = time.perf_counter()
        wi = run_cli(["whatif", "--ckpt-dir", ckpt, "--raw", sample, "--mix",
                      json.dumps(mix), "--ticks", DAY, "--sweep",
                      ",".join(str(f) for f in SWEEP)], timeout=900)
        secs["whatif"] = time.perf_counter() - t0
        count(wi)
        if wi["kernel_launches"]["gru_fwd"] == 0:
            fail("the whatif CLI never launched gru_fwd")
        want = WhatIfEstimator(plain, synth).sweep([mix] * DAY, list(SWEEP),
                                                   seed=0)
        y_range = np.asarray(plain.y_stats.range, np.float32).reshape(-1)
        sweep_rel = sweep_error(wi["sweep"], want, y_range)
        peak = {r["factor"]: r["peaks"]["compose-post-service_cpu"]["q50"]
                for r in wi["sweep"]}
        print(f"main raw whatif CLI: mix {mix} x {DAY} ticks, sweep "
              f"{list(SWEEP)}; {secs['whatif']:.2f} s (load and fit of the "
              f"synthesizer on {SYNTH_BUCKETS} buckets included: in-process "
              f"load {t_load:.2f} s, fit {t_fit:.2f} s); gru_fwd launches "
              f"{wi['kernel_launches']['gru_fwd']}; stages "
              f"{rounded(wi['seconds'])}; compose-post-service_cpu "
              f"q50 peak per factor {peak}", flush=True)
        print(f"check main raw whatif sweep vs the plain recurrence on the "
              f"card: max_err/scale={sweep_rel:.3e} (tol "
              f"{TOL['bfloat16'][0]})", flush=True)
        if sweep_rel > TOL["bfloat16"][0]:
            fail("the whatif sweep disagrees with the plain path")

        # estimate_many over 16 one-day programs on the kernels
        pred = Predictor.from_checkpoint(ckpt, device="cuda")
        est = WhatIfEstimator(pred, synth)
        programs = [[{ep: int(round(n * s)) for ep, n in mix.items()}] * DAY
                    for s in np.linspace(0.5, 2.0, 16)]
        est.estimate_many_raw(programs[:1], cache=False)        # warm
        k1_before = cuda_gru.GRU_FWD.launches
        t0 = time.perf_counter()
        est.estimate_many_raw(programs, cache=False)
        torch.cuda.synchronize()
        t_many = time.perf_counter() - t0
        t0 = time.perf_counter()
        series = [synth.synthesize_series(p, seed=i)
                  for i, p in enumerate(programs)]
        t_synth = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred.predict_series_many(series)
        torch.cuda.synchronize()
        t_pred = time.perf_counter() - t0
        n_windows = len(plan_windows([DAY] * len(programs), W))
        print(f"main raw estimate_many: 16 one-day programs, {n_windows} "
              f"windows in {t_many:.4f} s = {n_windows / t_many:.1f} "
              f"windows/s end to end; host synthesis {t_synth:.4f} s, "
              f"predict_series_many {t_pred:.4f} s = "
              f"{n_windows / t_pred:.1f} windows/s; gru_fwd launches "
              f"{cuda_gru.GRU_FWD.launches - k1_before} (in-process)",
              flush=True)
        profile_what_if(pred, series)
        del series

        # anomaly: a cryptojacking burner on compose-post-service
        t0 = time.perf_counter()
        crypto = simulate_corpus(
            SCENARIOS["crypto"](SEED), RAW_ANOMALY_BUCKETS,
            anomalies=[Anomaly("cryptojacking", "compose-post-service",
                               *ANOMALY_WINDOW)])
        crypto_path = os.path.join(wd, "crypto.jsonl")
        save_raw_data_jsonl(crypto, crypto_path)
        t_sim_crypto = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = run_cli_lines(["anomaly", "--ckpt-dir", ckpt, "--raw",
                               crypto_path], timeout=600)
        secs["anomaly"] = time.perf_counter() - t0
        detail, verdict = json.loads(lines[-2]), json.loads(lines[-1])
        count(detail)
        if detail["kernel_launches"]["gru_fwd"] == 0:
            fail("the anomaly CLI never launched gru_fwd")
        data = featurize_buckets(crypto, space=plain.space())
        if data.metric_names != plain.metric_names:
            fail("the crypto corpus's metrics differ from the checkpoint's")
        want_reports = AnomalyDetector(plain).check(data.traffic,
                                                    data.targets())
        flagged = sorted(r.metric for r in want_reports if r.flagged)
        firsts = [r.first_flag_index for r in want_reports]
        score_err = max(abs(r["score"] - w.score) / max(abs(w.score), 1.0)
                        for r, w in zip(detail["reports"], want_reports))
        cpu = next(r for r in detail["reports"]
                   if r["metric"] == "compose-post-service_cpu")
        print(f"main raw anomaly CLI: {RAW_ANOMALY_BUCKETS} crypto buckets, "
              f"cryptojacking on compose-post-service over buckets "
              f"{ANOMALY_WINDOW[0]}-{ANOMALY_WINDOW[1]}; {secs['anomaly']:.2f}"
              f" s (simulated in-process in {t_sim_crypto:.2f} s); "
              f"{len(verdict['flagged'])} of {len(detail['reports'])} metrics "
              f"flagged; compose-post-service_cpu flagged={cpu['flagged']} "
              f"first_flag_index={cpu['first_flag_index']} score="
              f"{cpu['score']:.4f}; gru_fwd launches "
              f"{detail['kernel_launches']['gru_fwd']}; stages "
              f"{rounded(detail['seconds'])}", flush=True)
        print(f"check main raw anomaly vs the plain recurrence on the card: "
              f"flagged sets equal {sorted(verdict['flagged']) == flagged}, "
              f"first_flag_index equal "
              f"{[r['first_flag_index'] for r in detail['reports']] == firsts}"
              f", max score error {score_err:.3e} (tol "
              f"{TOL['bfloat16'][0]} of max(|score|, 1))", flush=True)
        if sorted(verdict["flagged"]) != flagged:
            fail(f"anomaly flagged {sorted(verdict['flagged'])}; the plain "
                 f"path flags {flagged}")
        if [r["first_flag_index"] for r in detail["reports"]] != firsts:
            fail("anomaly first_flag_index differs from the plain path's")
        if score_err > TOL["bfloat16"][0]:
            fail("anomaly scores disagree with the plain path")

        # predict --raw on the training corpus == predict --features
        t0 = time.perf_counter()
        by_raw = run_cli(["predict", "--ckpt-dir", ckpt, "--raw", raw,
                          "--out", os.path.join(wd, "by_raw")], timeout=600)
        secs["predict --raw"] = time.perf_counter() - t0
        by_feats = run_cli(["predict", "--ckpt-dir", ckpt, "--features",
                            feats, "--out", os.path.join(wd, "by_feats")],
                           timeout=600)
        count(by_raw)
        count(by_feats)
        with np.load(by_raw["out"]) as a, np.load(by_feats["out"]) as b:
            same = np.array_equal(a["predictions"], b["predictions"])
            shape = a["predictions"].shape
        print(f"check main raw predict --raw vs --features: {shape}, "
              f"bit-identical {same}; predict --raw {secs['predict --raw']:.2f}"
              f" s (stages {rounded(by_raw['seconds'])})", flush=True)
        if not same or shape != (RAW_BUCKETS, 88, 3):
            fail("predict --raw differs from predict --features")
    total = time.perf_counter() - t_phase
    print(f"main raw phase: {total:.1f} s of wall time; CLI seconds "
          f"{rounded(secs)}; launches of this "
          f"path {launches}", flush=True)
    return {"launches": launches, "seconds": secs, "total_s": total,
            "windows_per_s": n_windows / t_many, "sweep_rel": sweep_rel,
            "score_err": score_err}


def phase_blocked(cuda_gru, kernel_tuning) -> dict:
    """K4 at every blocking of the sweep's --quick menu against its plain
    version, then its times at the fused flagship stacking in bf16; returns
    the kernels-line numbers."""
    import torch

    worst = 0.0
    checked = refused = 0
    for label, shape in (("fused flagship", FUSED), ("ragged", TUNE_RAGGED)):
        e, t, b, h = (shape[k] for k in ("E", "T", "B", "H"))
        for dtype in (torch.float32, torch.bfloat16):
            args = recurrence_inputs(shape, dtype, seed=SEED + 3)
            for bf16_dot in (False, True):
                name = "bfloat16" if bf16_dot else "float32"
                want = cuda_gru.gru_fwd_blocked_reference(*args,
                                                          bf16_dot=bf16_dot)
                for rows, e_blk, t_blk in kernel_tuning.blocking_menu(
                        e, t, b, h, quick=True):
                    what = (f"E{e} rows{rows} e_blk{e_blk} t_blk{t_blk} "
                            f"{str(dtype).removeprefix('torch.')} "
                            f"{'bf16' if bf16_dot else 'f32'} dot")
                    plan = cuda_gru.block_plan(
                        e, t, b, h, dtype, training=False, rows=rows,
                        e_blk=e_blk, t_blk=t_blk, blocked=True,
                        bf16_dot=bf16_dot)
                    if not plan["fits"]:
                        refused += 1
                        print(f"check gru_fwd_blocked {label} {what}: refused "
                              f"by the plan ({plan['refusal']})", flush=True)
                        continue
                    got = cuda_gru.gru_fwd_blocked_cuda(
                        *args, e_blk=e_blk, t_blk=t_blk, bf16_dot=bf16_dot,
                        rows=rows)
                    torch.cuda.synchronize()
                    mx = report_check("gru_fwd_blocked", label, shape, name,
                                      what, compare(got, want, name),
                                      TOL[name])
                    checked += 1
                    if label == "fused flagship" and dtype == torch.bfloat16 \
                            and bf16_dot:
                        worst = max(worst, mx)
            del args, want
    if not checked:
        fail("the plan admitted no blocking of the --quick menu")
    print(f"check gru_fwd_blocked: {checked} blockings held against the plain "
          f"version, {refused} refused by the plan", flush=True)

    # times at the fused stacking, bf16 inputs and the bf16 dot
    args = recurrence_inputs(FUSED, torch.bfloat16)
    proj, w_hh, b_hh, h0 = args
    e, t, b, h = (FUSED[k] for k in ("E", "T", "B", "H"))
    times, plans = {}, {}
    for rows, e_blk, t_blk in kernel_tuning.blocking_menu(e, t, b, h,
                                                          quick=True):
        plan = cuda_gru.block_plan(e, t, b, h, torch.bfloat16, training=False,
                                   rows=rows, e_blk=e_blk, t_blk=t_blk,
                                   blocked=True, bf16_dot=True)
        if plan["fits"]:
            plans[(rows, e_blk, t_blk)] = plan
            times[(rows, e_blk, t_blk)] = time_ms(
                lambda r=rows, eb=e_blk, tb=t_blk:
                cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=eb, t_blk=tb,
                                              bf16_dot=True, rows=r),
                iters=20)
    for key, ms in times.items():
        plan = plans[key]
        print(f"times gru_fwd_blocked {FUSED} bf16 rows{key[0]} "
              f"e_blk{key[1]} t_blk{key[2]}: {ms:.4f} ms ({plan['ctas']} "
              f"CTAs, {plan['ctas_per_sm']} per SM, {plan['waves']} waves, "
              f"{plan['smem_bytes']} bytes)", flush=True)
    k1_blocking = (cuda_gru.ROW_TILE, 1, 1)
    if k1_blocking not in times:
        fail("K1's blocking (16 rows, 1 expert, 1 step) was not timed")
    if (plans[k1_blocking]["ctas_per_sm"], plans[k1_blocking]["waves"]) \
            != (2, 1):
        fail(f"K1's blocking is not planned at two CTAs an SM in one wave: "
             f"{plans[k1_blocking]}")
    if not any(e_blk == 2 for _, e_blk, _ in times):
        fail("no two-expert blocking (e_blk=2) was admitted and timed")
    fastest = min(times, key=times.get)
    lib_ms, lib_out = cudnn_gru_ms(*args)
    if lib_ms is None:
        print(f"library bfloat16 x{e}: {lib_out}", flush=True)
    out_bytes = e * t * b * h * 4                  # the f32 output
    entry = kernel_times(
        "gru_fwd_blocked", f"cuDNN GRU forward x{e}", "bfloat16", FUSED,
        lambda: cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=1, t_blk=1,
                                              bf16_dot=True,
                                              rows=cuda_gru.ROW_TILE),
        lambda: cuda_gru.gru_fwd_blocked_reference(*args, bf16_dot=True),
        nbytes(*args) + out_bytes, 2 * e * t * b * h * 3 * h, lib_ms)
    entry.update(max_abs_err=worst, fastest_ms=times[fastest],
                 fastest_blocking="rows{}_e_blk{}_t_blk{}".format(*fastest),
                 blocking_ms={"rows{}_e_blk{}_t_blk{}".format(*k): ms
                              for k, ms in times.items()})
    del args, proj, w_hh, b_hh, h0, lib_out

    # the f32 dot (FMA) on f32 inputs, at the first blocking the plan admits
    args = recurrence_inputs(FUSED, torch.float32)
    rows, e_blk, t_blk = next(
        k for k in kernel_tuning.blocking_menu(e, t, b, h, quick=True)
        if cuda_gru.block_plan(e, t, b, h, torch.float32, training=False,
                               rows=k[0], e_blk=k[1], t_blk=k[2],
                               blocked=True, bf16_dot=False)["fits"])
    lib_ms, _ = cudnn_gru_ms(*args)
    entry["float32"] = kernel_times(
        "gru_fwd_blocked", f"cuDNN GRU forward x{e}", "float32", FUSED,
        lambda: cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                              rows=rows),
        lambda: cuda_gru.gru_fwd_blocked_reference(*args),
        nbytes(*args) + out_bytes, 2 * e * t * b * h * 3 * h, lib_ms)
    entry["float32"]["blocking"] = f"rows{rows}_e_blk{e_blk}_t_blk{t_blk}"
    del args
    torch.cuda.empty_cache()
    return entry


def phase_bidir(cuda_gru, kernel_tuning) -> None:
    """bidirectional_gru with BIDIR_FUSED against without, on the kernels at
    the flagship training shape in bf16: the forward (K1 launches 1 against
    2) and the gradients through K2 and K3 (1 launch each against 2)."""
    import numpy as np
    import torch

    from deeprest_tpu_torch.ops.gru import GRUParams

    gru_mod = kernel_tuning.gru_mod
    e, t, b, h = (TRAIN[k] for k in ("E", "T", "B", "H"))
    rng = np.random.default_rng(SEED + 4)
    fwd, bwd = (GRUParams(*[w.to(torch.bfloat16) for w in
                            kernel_tuning.gru_params(e, F, h, "cuda", seed)])
                for seed in (SEED + 5, SEED + 6))
    x = torch.from_numpy(rng.standard_normal((b, t, F), np.float32)).to(
        "cuda", torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal((e, b, t, 2 * h),
                                               np.float32)).cuda()
    results = {}
    default = gru_mod.BIDIR_FUSED
    try:
        for fused in (False, True):
            gru_mod.BIDIR_FUSED = fused
            counts = [kk.launches for kk in cuda_gru.MODEL_KERNELS]
            with torch.no_grad():
                out = gru_mod.bidirectional_gru(fwd, bwd, x)
            torch.cuda.synchronize()
            n_fwd = cuda_gru.GRU_FWD.launches - counts[0]
            leaves = [GRUParams(*[w.clone().requires_grad_(True) for w in p])
                      for p in (fwd, bwd)]
            xg = x.clone().requires_grad_(True)
            counts = [kk.launches for kk in cuda_gru.MODEL_KERNELS]
            y = gru_mod.bidirectional_gru(*leaves, xg)
            (y.float() * cot).sum().backward()
            torch.cuda.synchronize()
            n_train = [kk.launches - c for kk, c in
                       zip(cuda_gru.MODEL_KERNELS[1:], counts[1:])]
            want = (1, [1, 1]) if fused else (2, [2, 2])
            print(f"check bidirectional fused={fused}: gru_fwd launches "
                  f"{n_fwd} per forward, gru_fwd_train/gru_bwd launches "
                  f"{n_train} per fwd+bwd (want {want[0]} and {want[1]})",
                  flush=True)
            if (n_fwd, n_train) != want:
                fail(f"bidirectional_gru fused={fused} made {n_fwd} K1 and "
                     f"{n_train} K2/K3 launches; want {want}")
            grads = [w.grad for p in leaves for w in p] + [xg.grad]
            results[fused] = [out, y.detach()] + grads
    finally:
        gru_mod.BIDIR_FUSED = default
    names = ["forward", "fwd+bwd output"] + [
        f"d{d}_{w}" for d in ("fwd", "bwd")
        for w in ("w_ih", "w_hh", "b_ih", "b_hh")] + ["dx"]
    for name, got, want in zip(names, results[True], results[False]):
        check = (compare(got, want, "bfloat16") if name == "forward"
                 else compare_scaled(got, want, "bfloat16"))
        report_check("bidirectional fused vs unfused", "flagship training",
                     TRAIN, "bfloat16", name, check, TOL["bfloat16"])


def phase_stash_steps(cuda_gru) -> None:
    """5 train steps with STASH_GATES off (K2 writes no gates, K3
    recomputes them) against 5 with it on, from the same params, dropout 0,
    at the flagship width."""
    import numpy as np

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    b, h = TRAIN["B"], TRAIN["H"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stash_",
                                     dir=os.path.join(REPO, "build")) as wd:
        feats = flagship_corpus(os.path.join(wd, "corpus.npz"))
        cfg = Config(model=ModelConfig(hidden_size=h, dropout_rate=0.0,
                                       compute_dtype="bfloat16"),
                     train=TrainConfig(batch_size=b, window_size=W))
        bundle = prepare_dataset(FeaturizedData.load(feats), cfg.train)
        trainer = Trainer(cfg, F, bundle.metric_names, device="cuda")
        params = init_params(trainer.model_config, SEED)
        batches = list(trainer._batches(bundle.num_train_windows,
                                        np.random.default_rng(SEED)))[:5]
        runs = {}
        default = cuda_gru.STASH_GATES
        try:
            for stash in (True, False):
                cuda_gru.STASH_GATES = stash
                state = trainer.init_state(params)
                staged = trainer.stage_dataset(bundle)
                runs[stash] = [float(trainer.train_step(state, staged, sel,
                                                        wt))
                               for sel, wt in batches]
        finally:
            cuda_gru.STASH_GATES = default
    rel = max(abs(a - p) / abs(p) for a, p in zip(runs[False], runs[True]))
    print(f"check train 5 steps, STASH_GATES off vs on (dropout 0): "
          f"{runs[False]} vs {runs[True]}, max relative difference "
          f"{rel:.3e} (tol 2e-2)", flush=True)
    if not np.isfinite(runs[False]).all() or rel > 2e-2:
        fail("training with the gate stash off disagrees with training "
             "with it on")


def phase_tuning_sweep(cuda_gru) -> dict:
    """The tuning path's entry point, `python -m
    deeprest_tpu_torch.benchmarks.kernel_tuning --quick`, in its own
    process with the launch counts at 0; returns its JSON."""
    for k in cuda_gru.KERNELS:
        k.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tuning_",
                                     dir=os.path.join(REPO, "build")) as wd:
        out = os.path.join(wd, "kernel_tuning.json")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "deeprest_tpu_torch.benchmarks."
             "kernel_tuning", "--quick", "--out", out], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        sweep_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"kernel_tuning --quick exited {proc.returncode}:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(out, encoding="utf-8") as fh:
            sweep = json.load(fh)
    print(f"tuning sweep JSON: {json.dumps(sweep)}", flush=True)
    launches = sweep["kernel_launches"]
    print(f"main tuning sweep (--quick): {sweep_s:.2f} s of wall time "
          f"(process start and the library load included); launches "
          f"{launches}; bidirectional decision {sweep['bidir_decision']}",
          flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"the tuning sweep never launched {name}")
    for key, value in sweep.items():
        if isinstance(value, float) and not value > 0:
            fail(f"tuning sweep time {key} = {value} is not positive")
    return sweep


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "deeprest_tpu_torch")):
        print("FAIL: chip_smoke.py needs the deeprest_tpu_torch package "
              "beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; chip_smoke.py runs "
              "on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeprest_tpu_torch.benchmarks import kernel_tuning
    from deeprest_tpu_torch.ops import build, cuda_gru

    regs = phase_build(build, cuda_gru, kernel_tuning)
    max_abs_err = phase_kernel_checks(cuda_gru)
    times = phase_times(cuda_gru)
    serving = phase_main_path(cuda_gru)
    training = phase_training(cuda_gru)
    raw = phase_raw_to_answers(cuda_gru)
    blocked = phase_blocked(cuda_gru, kernel_tuning)
    phase_bidir(cuda_gru, kernel_tuning)
    phase_stash_steps(cuda_gru)
    sweep = phase_tuning_sweep(cuda_gru)

    launches = dict(training["launches"])
    launches["gru_fwd"] += serving["launches"]
    for name, count in raw["launches"].items():
        launches[name] += count
    sources = {"gru_fwd": ("gru_fwd.cu", "deeprest_tpu/ops/pallas_gru.py:156"),
               "gru_fwd_train": ("gru_fwd.cu",
                                 "deeprest_tpu/ops/pallas_gru.py:164"),
               "gru_bwd": ("gru_bwd.cu", "deeprest_tpu/ops/pallas_gru.py:298")}
    line = {"kernels": []}
    for name, (src, replaces) in sources.items():
        bf16 = times[name]["bfloat16"]
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"deeprest_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"], "design": DESIGNS[name][0],
            **regs[name]})
        print(f"f32 {name}: {json.dumps(times[name]['float32'])}", flush=True)
    line["kernels"].append({
        "name": "gru_fwd_blocked", "route": "cuda",
        "source": "deeprest_tpu_torch/csrc/gru_fwd_blocked.cu",
        "replaces": "benchmarks/kernel_tuning.py:134",
        "launches": sweep["kernel_launches"]["gru_fwd_blocked"],
        **{k: blocked[k] for k in (
            "max_abs_err", "ms", "fastest_ms", "fastest_blocking",
            "blocking_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "design": DESIGNS["gru_fwd_blocked"][0], **regs["gru_fwd_blocked"]})
    print(f"f32 gru_fwd_blocked: {json.dumps(blocked['float32'])}",
          flush=True)
    print(f"main-path launches: serving gru_fwd {serving['launches']}; "
          f"training {training['launches']}; raw telemetry to answers "
          f"{raw['launches']}; tuning sweep {sweep['kernel_launches']}",
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
