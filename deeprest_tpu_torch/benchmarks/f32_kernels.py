"""The f32 recurrence kernels on the card: K1 (``gru_fwd``), K2
(``gru_fwd_train``), K3 (``gru_bwd``) and K4's f32 dot
(``gru_fwd_blocked``) timed at the kernel table's shapes and at the main
paths' shapes, K3's time split into its recurrence and its dW/db kernel,
and each kernel's error against an f64 run of the plain recurrence.

    python -m deeprest_tpu_torch.benchmarks.f32_kernels [--out PATH]
    python -m deeprest_tpu_torch.benchmarks.f32_kernels --against DIR [--out PATH]

The first form measures this checkout's kernels and prints one JSON line.
``--against DIR`` measures the checkout unpacked at DIR (for instance a
parent commit from ``git archive``) and this one in turns, DIR, this,
this, DIR, each in a process of its own that builds its checkout's
sources into that checkout's ``build/kernels/``, and prints (and with
``--out`` writes) the four results beside the card's name and power
limit.  ``--root DIR`` is one such process: it imports the port from DIR.

Shapes (E experts, T steps, B rows, H units), f32 throughout:

- K1: the table's E40 T60 B256 H128 (PERF.md's kernel table) and the
  main paths' E88 T60 B8 H128 (the stream's evaluation of its 8 held-out
  windows, and the verdict server's sweeps on the smallest fused rung);
- K2 (with the gate stash) and K3 (reading it): the table's E40 T60 B32
  H128 and the stream's fine-tune E88 T60 B32 H128;
- K4 with the f32 dot on f32 inputs at the tuning sweep's fused stacking
  E80 T60 B32 H128, at the blockings (rows, e_blk, t_blk) (8, 1, 1) and
  (16, 1, 1); a blocking the checkout's plan refuses is recorded as
  ``{"refused": reason}``.

Times are CUDA events over 20 launches after 3 warm-up launches; K3's
split sums ``torch.profiler`` device time by kernel name over another 20
launches (names with ``dw`` are the dW/db kernel).  Bounds: the bytes
each call must move (every input read once, every output written once)
over 3.35 TB/s, and its operations over 67 TFLOP/s (f32 FMA, the
yardstick of PERF.md's table) and, as three TF32 products, over 495
TFLOP/s.  ``err_f64`` is max |x - ref| / max |ref| of each output against
:func:`recurrence_f64` / :func:`bwd_f64` on the same f32 inputs;
``plain_err_f64`` is the same for the plain f32 versions, the yardstick
of what f32 arithmetic loses.  K2, K3 and K4 are also run twice on the
same inputs (``deterministic``: the same bits).  It needs a CUDA device
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
K1_SHAPES = {"table": (40, 60, 256, 128), "main path": (88, 60, 8, 128)}
K3_SHAPES = {"table": (40, 60, 32, 128), "stream": (88, 60, 32, 128)}
K2_SHAPES = K3_SHAPES
K4_SHAPE = (80, 60, 32, 128)
K4_BLOCKINGS = ((8, 1, 1), (16, 1, 1))      # (rows, e_blk, t_blk)
ITERS = 20
HBM_BYTES_PER_S = 3.35e12
FMA_F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def recurrence_inputs(shape, seed: int = 0, device="cuda"):
    """Seeded f32 ``(proj, w_hh, b_hh, h0)`` at ``shape = (E, T, B, H)``,
    made with numpy: proj ~ N(0, 1), W_hh and b_hh ~ U(-1/sqrt(H),
    1/sqrt(H)), h0 ~ 0.5 N(0, 1)."""
    e, t, b, h = shape
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    arrays = (rng.standard_normal((e, t, b, 3 * h), np.float32),
              rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32),
              rng.uniform(-k, k, (e, 3 * h)).astype(np.float32),
              (0.5 * rng.standard_normal((e, b, h))).astype(np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def recurrence_f64(proj, w_hh, b_hh, h0, reverse: bool = False,
                   emit_prev: bool = False):
    """The plain forward recurrence (``cuda_gru.gru_recurrence_reference``)
    in f64 on the same inputs: ``h_all [E, T, B, H]`` f64, or with
    ``emit_prev`` K2's outputs ``(h_all, h_prev, gates)``
    (``cuda_gru.gru_fwd_train_reference``) in f64."""
    e, t, b, g3 = proj.shape
    h = g3 // 3
    w, bias = w_hh.double(), b_hh.double()[:, None, :]
    carry = h0.double()
    out = torch.empty((e, t, b, h), dtype=torch.float64, device=proj.device)
    h_prev = torch.empty_like(out)
    gates = torch.empty((e, t, b, g3), dtype=torch.float64,
                        device=proj.device)
    for s in range(t):
        tt = t - 1 - s if reverse else s
        g = torch.bmm(carry, w) + bias
        h_prev[:, tt] = carry
        gates[:, tt] = g
        g_r, g_z, g_n = g.split(h, dim=-1)
        x_r, x_z, x_n = proj[:, tt].double().split(h, dim=-1)
        r = torch.sigmoid(x_r + g_r)
        z = torch.sigmoid(x_z + g_z)
        n = torch.tanh(x_n + r * g_n)
        carry = (1.0 - z) * n + z * carry
        out[:, tt] = carry
    return (out, h_prev, gates) if emit_prev else out


def bwd_f64(proj, h_prev, gates, w_hh, b_hh, dout, reverse: bool = False):
    """The plain backward (``cuda_gru.gru_bwd_reference``) in f64 on the
    same inputs: ``(dproj, dW_hh, db_hh, dh0)`` f64."""
    e, t, b, g3 = proj.shape
    h = g3 // 3
    w = w_hh.double()
    bias = b_hh.double()[:, None, :]
    dh = torch.zeros((e, b, h), dtype=torch.float64, device=proj.device)
    db = torch.zeros((e, g3), dtype=torch.float64, device=proj.device)
    dproj = torch.empty((e, t, b, g3), dtype=torch.float64,
                        device=proj.device)
    dgates = torch.empty_like(dproj)
    for s in range(t):
        tt = s if reverse else t - 1 - s
        hp = h_prev[:, tt].double()
        g = (torch.bmm(hp, w) + bias) if gates is None \
            else gates[:, tt].double()
        g_r, g_z, g_n = g.split(h, dim=-1)
        x_r, x_z, x_n = proj[:, tt].double().split(h, dim=-1)
        r = torch.sigmoid(x_r + g_r)
        z = torch.sigmoid(x_z + g_z)
        n = torch.tanh(x_n + r * g_n)
        dht = dout[:, tt].double() + dh
        dtanh = dht * (1.0 - z) * (1.0 - n * n)
        da_r = dtanh * g_n * r * (1.0 - r)
        da_z = dht * (hp - n) * z * (1.0 - z)
        dhn = dtanh * r
        dproj[:, tt] = torch.cat([da_r, da_z, dtanh], dim=-1)
        dg = torch.cat([da_r, da_z, dhn], dim=-1)
        db += dg.sum(dim=1)
        dgates[:, tt] = dg
        dh = dht * z + torch.bmm(dg, w.transpose(1, 2))
    dw = torch.bmm(h_prev.double().reshape(e, t * b, h).transpose(1, 2),
                   dgates.reshape(e, t * b, g3))
    return dproj, dw, db, dh


def scaled_error(got, want) -> float:
    """max |got - want| / max |want|."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-300))


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean ms a call: CUDA events around ``iters`` calls after
    ``warmup``."""
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


def kernel_split(fn, iters: int = ITERS) -> dict:
    """Device ms a call of each ``gru_bwd`` kernel, from ``torch.profiler``
    over ``iters`` calls: ``{"recurrence_ms", "dw_ms", "names"}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if "gru_bwd" in ev.key and us:
            names[ev.key] = us / 1e3 / iters
    dw = sum(ms for name, ms in names.items() if "dw" in name)
    return {"recurrence_ms": sum(names.values()) - dw, "dw_ms": dw,
            "names": names}


def bounds(io_bytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the memory rate, the
    operations on f32 FMA, and as three TF32 products."""
    return {"bytes": io_bytes, "flops": flops,
            "bytes_ms": io_bytes / HBM_BYTES_PER_S * 1e3,
            "fma_ms": flops / FMA_F32_FLOPS * 1e3,
            "tf32x3_ms": 3 * flops / TF32_FLOPS * 1e3}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _errors(names, got, plain, want) -> dict:
    """``err_f64`` and ``plain_err_f64``: each output's
    :func:`scaled_error` against its f64 counterpart."""
    return {"err_f64": {n: scaled_error(g, w)
                        for n, g, w in zip(names, got, want)},
            "plain_err_f64": {n: scaled_error(p, w)
                              for n, p, w in zip(names, plain, want)}}


def measure_fwd(cuda_gru, shape, iters: int = ITERS) -> dict:
    """K1 at one f32 shape: ms, bounds, and its error and the plain
    version's against f64."""
    args = recurrence_inputs(shape)
    e, t, b, h = shape
    got = cuda_gru.gru_fwd_cuda(*args)
    out = {"shape": list(shape),
           "ms": time_ms(lambda: cuda_gru.gru_fwd_cuda(*args), iters),
           **bounds(_nbytes(*args, got), 2 * e * t * b * h * 3 * h),
           **_errors(("h_all",), (got,),
                     (cuda_gru.gru_recurrence_reference(*args),),
                     (recurrence_f64(*args),))}
    del args, got
    torch.cuda.empty_cache()
    return out


def measure_fwd_train(cuda_gru, shape, iters: int = ITERS) -> dict:
    """K2 with the gate stash at one f32 shape: ms, bounds, the error of
    h_all, h_prev and gates and the plain version's against f64, and
    whether two runs give the same bits."""
    args = recurrence_inputs(shape, seed=3)
    e, t, b, h = shape

    def call():
        return cuda_gru.gru_fwd_train_cuda(*args)

    got = call()
    again = call()
    out = {"shape": list(shape), "ms": time_ms(call, iters),
           **bounds(_nbytes(*args, *got), 2 * e * t * b * h * 3 * h),
           **_errors(("h_all", "h_prev", "gates"), got,
                     cuda_gru.gru_fwd_train_reference(*args),
                     recurrence_f64(*args, emit_prev=True)),
           "deterministic": all(torch.equal(x, y)
                                for x, y in zip(got, again))}
    del args, got, again
    torch.cuda.empty_cache()
    return out


def measure_blocked(cuda_gru, blocking, iters: int = ITERS) -> dict:
    """K4 with the f32 dot on f32 inputs at :data:`K4_SHAPE` and one
    blocking ``(rows, e_blk, t_blk)``: ms, the plan's CTAs and waves,
    bounds, its error and the plain version's against f64, and whether two
    runs give the same bits; ``{"refused": reason}`` if the plan refuses
    it."""
    rows, e_blk, t_blk = blocking
    e, t, b, h = K4_SHAPE
    plan = cuda_gru.block_plan(e, t, b, h, torch.float32, training=False,
                               rows=rows, e_blk=e_blk, t_blk=t_blk,
                               blocked=True, bf16_dot=False)
    if not plan["fits"]:
        return {"refused": plan["refusal"]}
    args = recurrence_inputs(K4_SHAPE, seed=4)

    def call():
        return cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                             rows=rows)

    got = call()
    again = call()
    out = {"shape": list(K4_SHAPE), "ms": time_ms(call, iters),
           **{k: plan[k] for k in ("ctas", "ctas_per_sm", "waves",
                                   "smem_bytes")},
           **bounds(_nbytes(*args, got), 2 * e * t * b * h * 3 * h),
           **_errors(("h_all",), (got,),
                     (cuda_gru.gru_fwd_blocked_reference(*args),),
                     (recurrence_f64(*args),)),
           "deterministic": torch.equal(got, again)}
    del args, got, again
    torch.cuda.empty_cache()
    return out


def measure_bwd(cuda_gru, shape, iters: int = ITERS) -> dict:
    """K3 with the gate stash at one f32 shape: ms, the recurrence/dW
    split, bounds, each output's error and the plain version's against
    f64, and whether two runs give the same bits."""
    proj, w_hh, b_hh, h0 = recurrence_inputs(shape, seed=1)
    e, t, b, h = shape
    _, h_prev, gates = cuda_gru.gru_fwd_train_reference(proj, w_hh, b_hh, h0)
    gen = torch.Generator(proj.device).manual_seed(2)
    dout = torch.randn(h_prev.shape, generator=gen, device=proj.device)
    bwd_in = (proj, h_prev, gates, w_hh, b_hh, dout)

    def call():
        return cuda_gru.gru_bwd_cuda(*bwd_in)

    got = call()
    again = call()
    out = {"shape": list(shape), "ms": time_ms(call, iters),
           **kernel_split(call, iters),
           **bounds(_nbytes(*bwd_in, *got), 2 * 2 * e * t * b * h * 3 * h),
           **_errors(("dproj", "dW_hh", "db_hh", "dh0"), got,
                     cuda_gru.gru_bwd_reference(*bwd_in), bwd_f64(*bwd_in)),
           "deterministic": all(torch.equal(x, y)
                                for x, y in zip(got, again))}
    del bwd_in, got, again
    torch.cuda.empty_cache()
    return out


def measure(cuda_gru, iters: int = ITERS) -> dict:
    """K1, K2, K3 and K4 in f32 at every shape of :data:`K1_SHAPES`,
    :data:`K2_SHAPES`, :data:`K3_SHAPES` and blocking of
    :data:`K4_BLOCKINGS`."""
    return {"gru_fwd": {k: measure_fwd(cuda_gru, s, iters)
                        for k, s in K1_SHAPES.items()},
            "gru_fwd_train": {k: measure_fwd_train(cuda_gru, s, iters)
                              for k, s in K2_SHAPES.items()},
            "gru_bwd": {k: measure_bwd(cuda_gru, s, iters)
                        for k, s in K3_SHAPES.items()},
            "gru_fwd_blocked": {
                "rows{}_e_blk{}_t_blk{}".format(*k):
                measure_blocked(cuda_gru, k, iters) for k in K4_BLOCKINGS}}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def run_root(root: str) -> dict:
    """Measure the port of the checkout at ``root`` (built from its own
    sources, into its own ``build/kernels/``)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from deeprest_tpu_torch.ops import build, cuda_gru

    if not os.path.abspath(cuda_gru.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {cuda_gru.__file__}, not the port "
                           f"under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("the f32 kernel measurement needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = (cuda_gru.GRU_FWD_SOURCE, cuda_gru.GRU_BWD_SOURCE,
               cuda_gru.GRU_FWD_BLOCKED_SOURCE)
    build_s = build.build_all(sources)
    ptxas = {fn: use for src in sources
             for fn, use in build.ptxas_usage(src.build_log).items()}
    return {"root": root, "build_s": build_s, "ptxas": ptxas,
            **measure(cuda_gru)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=None,
                        help="measure the port of the checkout at ROOT")
    parser.add_argument("--against", default=None,
                        help="measure the checkout at DIR and this one in "
                             "turns (DIR, this, this, DIR)")
    parser.add_argument("--out", default=None, help="write the JSON here")
    args = parser.parse_args(argv)
    if args.against is None:
        result = {"card": card(), **run_root(args.root or REPO)}
    else:
        runs = []
        for label, root in (("against", args.against), ("this", REPO),
                            ("this", REPO), ("against", args.against)):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root],
                capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                raise RuntimeError(f"measuring {root} failed "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout[-4000:]}"
                                   f"{proc.stderr[-4000:]}")
            runs.append({"label": label,
                         **json.loads(proc.stdout.strip().splitlines()[-1])})
        result = {"card": card(), "runs": runs}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
