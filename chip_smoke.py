#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeprest_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build: the three CUDA sources (gru_fwd.cu with the inference and
   training forwards K1 and K2, gru_bwd.cu with the backward K3,
   gru_fwd_blocked.cu with the blocked forward K4 of the tuning sweep),
   one nvcc per source, all started together, into build/kernels/;
3. each kernel against its plain PyTorch version on the card, with the JAX
   package's kernel tolerances (forward: f32 1e-5, bf16 2e-2; gradients
   relative to each tensor's largest magnitude: f32 2e-4, bf16 2e-2): K1 at
   the flagship serving shape (E=40 experts, T=60, B=256 rows, H=128); K2,
   K3 (gate stash on and off) and the autograd Function (against torch
   autograd through the plain recurrence) at the flagship training shape
   (B=32); all at a ragged shape (E=3, T=7, B=37) too, in bf16 and f32,
   forward and reverse;
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
   epochs at B=32, T=60, bf16 (finite, falling losses; K2 and K3 launched
   twice per step), the trained checkpoint served by one `predict` call,
   5 steps on the kernels against 5 steps through the plain recurrence
   from the same params (dropout 0), and a torch.profiler breakdown of
   train steps;
7. the kernel-tuning path: K4 (gru_fwd_blocked.cu) at every blocking of
   the sweep's --quick menu against its plain version, at the fused
   flagship stacking (E=80, T=60, B=32, H=128) and a ragged shape (E=4,
   T=12, B=37), f32 and bf16 inputs, the bf16 dot off and on (tolerance
   1e-5 with the f32 dot, 2e-2 with the bf16 dot), and timed beside its
   plain version, its bound and cuDNN's GRU x80; bidirectional_gru fused
   (BIDIR_FUSED) against unfused on the card at the flagship training
   shape, forward (1 K1 launch against 2) and gradients (1 K2 and 1 K3
   against 2 each); 5 train steps with STASH_GATES off against 5 with it
   on from the same params (dropout 0); then `python -m
   deeprest_tpu_torch.benchmarks.kernel_tuning --quick`, its JSON printed
   on one line;
8. one JSON line of per-kernel numbers, then the device line last.

The kernel launch counts are set to 0 just before each main path (5, 6
and the sweep of 7) and read just after it; launches made to check or
time a kernel do not count.

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
FUSED = dict(E=80, T=60, B=32, H=128)            # both directions stacked
TUNE_RAGGED = dict(E=4, T=12, B=37, H=128)
F, W, DAY = 512, 60, 1440
CORPUS_MINUTES = 3 * DAY
RESOURCES = ("cpu", "memory", "wiops", "wthroughput", "usage")


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
    for label, shape in (("flagship training", TRAIN), ("ragged", RAGGED)):
        for dtype in (torch.bfloat16, torch.float32):
            worst = check_train_kernels(cuda_gru, label, shape, dtype)
            if dtype == torch.bfloat16 and shape is TRAIN:
                worst_train = worst
    for label, shape in (("flagship", FLAGSHIP), ("ragged", RAGGED)):
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

    from deeprest_tpu_torch.data.featurize import FeaturizedData

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
                          invocations={}, space_dict=space).save(path)


def run_cli(args: list, timeout: int) -> dict:
    """One port CLI call in its own process; returns its last-line JSON."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "deeprest_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        fail(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_train_steps(trainer, state, staged, batches) -> None:
    """Where a train step's time goes: device time by kernel and the
    device's busy share of the steps' wall time, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sel, weight in batches:
            trainer.train_step(state, staged, sel, weight)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    if not rows:
        print("profile train: the profiler saw no device time (device "
              "breakdown not measured)", flush=True)
        return
    busy_us = sum(r[0] for r in rows)
    print(f"profile train: {len(batches)} steps, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f} % of wall)", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)


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
                     f"train steps; want 2 x steps (two directions)")
        if launches["gru_fwd"] == 0:
            fail("evaluation and serving never launched gru_fwd")
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
        profile_train_steps(trainer, state, staged, batches[3:8])
    return {"launches": launches, "steps": steps,
            "steps_per_sec": report["steps_per_sec"], "peak_share": share,
            "epoch_losses": report["epoch_losses"], "parity_rel": rel}


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
    times = {}
    for rows, e_blk, t_blk in kernel_tuning.blocking_menu(e, t, b, h,
                                                          quick=True):
        if cuda_gru.block_plan(e, t, b, h, torch.bfloat16, training=False,
                               rows=rows, e_blk=e_blk, t_blk=t_blk,
                               blocked=True, bf16_dot=True)["fits"]:
            times[(rows, e_blk, t_blk)] = time_ms(
                lambda r=rows, eb=e_blk, tb=t_blk:
                cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=eb, t_blk=tb,
                                              bf16_dot=True, rows=r),
                iters=20)
    for (rows, e_blk, t_blk), ms in times.items():
        print(f"times gru_fwd_blocked {FUSED} bf16 rows{rows} e_blk{e_blk} "
              f"t_blk{t_blk}: {ms:.4f} ms", flush=True)
    k1_blocking = (cuda_gru.ROW_TILE, 1, 1)
    if k1_blocking not in times:
        fail("K1's blocking (16 rows, 1 expert, 1 step) was not timed")
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
                 fastest_blocking="rows{}_e_blk{}_t_blk{}".format(*fastest))
    del args, proj, w_hh, b_hh, h0, lib_out
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

    build_s = build.build_all(cuda_gru.SOURCES)
    print(f"build: {len(cuda_gru.SOURCES)} sources in {build_s:.2f} s",
          flush=True)
    for src in cuda_gru.SOURCES:
        for line in src.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src.name}: {line.strip()}", flush=True)

    max_abs_err = phase_kernel_checks(cuda_gru)
    times = phase_times(cuda_gru)
    serving = phase_main_path(cuda_gru)
    training = phase_training(cuda_gru)
    blocked = phase_blocked(cuda_gru, kernel_tuning)
    phase_bidir(cuda_gru, kernel_tuning)
    phase_stash_steps(cuda_gru)
    sweep = phase_tuning_sweep(cuda_gru)

    launches = dict(training["launches"])
    launches["gru_fwd"] += serving["launches"]
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
            "library_ms": bf16["library_ms"]})
        print(f"f32 {name}: {json.dumps(times[name]['float32'])}", flush=True)
    line["kernels"].append({
        "name": "gru_fwd_blocked", "route": "cuda",
        "source": "deeprest_tpu_torch/csrc/gru_fwd_blocked.cu",
        "replaces": "benchmarks/kernel_tuning.py:134",
        "launches": sweep["kernel_launches"]["gru_fwd_blocked"],
        **{k: blocked[k] for k in (
            "max_abs_err", "ms", "fastest_ms", "fastest_blocking",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print(f"main-path launches: serving gru_fwd {serving['launches']}; "
          f"training {training['launches']}; tuning sweep "
          f"{sweep['kernel_launches']}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
