"""GRU kernel tuning sweep of the port (the JAX package's
``benchmarks/kernel_tuning.py``, section by section).

    python -m deeprest_tpu_torch.benchmarks.kernel_tuning [--out PATH]
        [--coalesce] [--quick] [--device cpu]

On the card (the default device; it raises without one) it times, at the
flagship width (E=40 experts, 80 with both directions stacked, T=60, B=32
rows, H=128), with CUDA events after ``torch.cuda.synchronize()``:

- the production forward K1 at E40, at the fused E80 stacking, and at E80
  in bf16;
- fwd+bwd through ``GRURecurrence`` (K2 then K3) at E40 and E80, f32 and
  bf16, with ``unfused_equiv_*`` = 2 x E40; every trial ends with a
  readback of a gradient element;
- ``STASH_GATES`` on and off, fwd+bwd in bf16 at E80;
- K4 (``gru_fwd_blocked_cuda``) over a menu of blockings (rows per CTA,
  experts per CTA, steps of proj in shared memory) at E80, f32 inputs
  with the f32 dot (3xTF32) and bf16 inputs with the bf16 dot, both on
  the tensor cores:
  ``ms`` and ``max_err`` against the production f32 output, as the JAX
  sweep records them, each blocking also held against K4's plain version;
- fused against unfused bidirectional (``BIDIR_FUSED``) forward, against
  the plain path;
- the Hopper block plan at G in {1, 2, 4, 8} coalesced window batches;
- with ``--coalesce``, G x stash fwd+bwd at G·32 rows in bf16 and the
  per-microbatch speedups.

A blocking the plan refuses is recorded as ``{"refused": reason}``; one it
admits that fails to launch, or disagrees with its plain version, makes
the run exit nonzero.  The bidirectional decision is computed from this
run's ``prod_fwdbwd_fusedE80_bf16_ms`` against
``unfused_equiv_fwdbwd_bf16_ms``, beside the card's name and power limit.
The sweep changes no default.  ``LOOP_ORDER`` has no counterpart (each CTA
of K1-K3 runs one expert) and is recorded as such.  ``--quick`` shortens
the K4 menu and the timing loops.

On the CPU (``--device cpu``) a reduced arm runs, every number labelled as
a CPU, numerics-grade result: the coalescing sweep on the plain
recurrence, the fused-against-unfused bidirectional check against the
plain path, and the plan table (``--quick``: a tiny shape).

``kernel_tuning_h100.json`` beside this module is the JSON of one full
``--coalesce`` run on an NVIDIA H100 80GB HBM3 at 700 W.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import subprocess
import time

import numpy as np
import torch

from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.ops import cuda_gru
from deeprest_tpu_torch.ops.gru import GRUParams, gru, gru_coalesced

# the module, not the function that deeprest_tpu_torch.ops re-exports
gru_mod = importlib.import_module("deeprest_tpu_torch.ops.gru")

B, T, F, E, H = 32, 60, 512, 40, 128
E2 = 2 * E                      # fused bidirectional stacking
COALESCE_GS = (1, 2, 4, 8)      # window-coalescing factors (G·B rows)
# K4 blockings: rows per CTA (None: all B rows, capped at two m16 tiles),
# experts per CTA, steps of proj held in shared memory (with the bf16 dot,
# 1 loads them into registers)
MENU_ROWS = (None, 16, 8)
MENU_E_BLKS = (1, 2)
MENU_T_BLKS = (1, 2, 6, 10, 12)
QUICK_T_BLKS = (1, 6)
TOL = {False: (1e-5, 1e-5), True: (2e-2, 2e-2)}   # (rtol, atol) by bf16 dot
LOOP_ORDER = ("no counterpart: each CTA of K1-K3 runs one expert over the "
              "whole time loop, so no order of experts within a program "
              "exists to choose; K4's e_blk steps its experts time outer, "
              "expert inner, as the TPU kernel's default did")
CPU_NOTE = ("CPU run: the plain PyTorch recurrence on the host; times are "
            "host times of the plain path and numerics-grade only, not "
            "device metrics")


def blocking_menu(e: int, t: int, b: int, h: int,
                  quick: bool) -> list[tuple[int, int, int]]:
    """``(rows, e_blk, t_blk)`` of the K4 sweep at ``proj [e, t, b, 3h]``:
    rows resolved to the plan's default where the menu says all rows, only
    blockings with ``e_blk | e`` and ``t_blk | t``, no duplicates."""
    menu = []
    for rows in MENU_ROWS:
        r = cuda_gru.default_blocked_rows(b) if rows is None else rows
        for e_blk in MENU_E_BLKS:
            for t_blk in QUICK_T_BLKS if quick else MENU_T_BLKS:
                if not (e % e_blk or t % t_blk or (r, e_blk, t_blk) in menu):
                    menu.append((r, e_blk, t_blk))
    return menu


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def recurrence_args(e: int, t: int, rows: int, h: int, device,
                    dtype=torch.float32, seed: int = 0):
    """Seeded ``(proj, w_hh, b_hh, h0)`` made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = 1.0 / np.sqrt(h)

    def uniform(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * k

    proj = torch.randn((e, t, rows, 3 * h), generator=gen, device=device)
    return (proj.to(dtype), uniform(e, h, 3 * h).to(dtype),
            uniform(e, 3 * h), torch.zeros((e, rows, h), device=device))


def to_bf16(args):
    proj, w, b, h0 = args
    return proj.to(torch.bfloat16), w.to(torch.bfloat16), b, h0


def gru_params(e: int, f: int, h: int, device, seed: int) -> GRUParams:
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return GRUParams(*[
        torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(device)
        for s in ((e, f, 3 * h), (e, h, 3 * h), (e, 3 * h), (e, 3 * h))])


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events after a
    warm-up call and ``torch.cuda.synchronize()``."""
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


def host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def fwdbwd(args):
    """One fwd+bwd through the recurrence (``GRURecurrence`` on the
    kernels): sum of squares of h, every input's gradient, and a readback
    of the last gradient's first element."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]

    def run():
        for leaf in leaves:
            leaf.grad = None
        out = cuda_gru.gru_recurrence(*leaves, False)
        (out.float() ** 2).sum().backward()
        return float(leaves[-1].grad.reshape(-1)[0])

    return run


@contextlib.contextmanager
def knob(module, name: str, value):
    """Set a module global for the block, restoring it after."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


# ---------------------------------------------------------------------------
# device-independent sections
# ---------------------------------------------------------------------------


def block_plan_table(e: int = E, t: int = T, b: int = B, h: int = H) -> dict:
    """The Hopper block plan at G·b coalesced rows for both io dtypes,
    training and inference (no GPU needed): per kernel the rows, threads
    and shared-memory bytes of a CTA, the CTAs, CTAs per SM, waves over
    132 SMs and whether it fits."""
    table = {}
    for g in COALESCE_GS:
        for dtype in (torch.bfloat16, torch.float32):
            for training in (True, False):
                plan = cuda_gru.block_plan(e, t, b * g, h, dtype,
                                           training=training)
                key = (f"G{g}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
                       f"_{'train' if training else 'infer'}")
                table[key] = {"rows": b * g, "binding": plan["binding"],
                              "fits": plan["fits"], **{
                                  name: {k: v[k] for k in (
                                      "rows_per_cta", "threads_per_cta",
                                      "smem_bytes", "ctas", "ctas_per_sm",
                                      "waves", "fits")}
                                  for name, v in plan["kernels"].items()}}
    return table


def bidir_check(device, e: int, b: int, t: int, f: int, h: int, dtype,
                iters: int, timer) -> dict:
    """Fused against unfused bidirectional forward (``BIDIR_FUSED`` off and
    on, the default dispatch: the kernels on a card, the plain path on the
    CPU), each against the unfused plain path, with the K1 launches each
    made."""
    fwd = gru_params(e, f, h, device, seed=1)
    bwd = gru_params(e, f, h, device, seed=2)
    fwd, bwd = (GRUParams(*[w.to(dtype) for w in p]) for p in (fwd, bwd))
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((b, t, f), generator=gen, device=device).to(dtype)
    out = {"shape": {"E": e, "B": b, "T": t, "F": f, "H": h},
           "dtype": str(dtype).removeprefix("torch.")}
    with torch.no_grad(), knob(gru_mod, "BIDIR_FUSED", False):
        ref = gru_mod.bidirectional_gru(
            fwd, bwd, x, recurrence=cuda_gru.gru_recurrence_reference).float()
    for fused in (False, True):
        with torch.no_grad(), knob(gru_mod, "BIDIR_FUSED", fused):
            before = cuda_gru.GRU_FWD.launches
            got = gru_mod.bidirectional_gru(fwd, bwd, x)
            launches = cuda_gru.GRU_FWD.launches - before
            ms = timer(lambda: gru_mod.bidirectional_gru(fwd, bwd, x), iters)
        out["fused_bidir" if fused else "unfused_bidir"] = {
            "ms": ms, "gru_fwd_launches_per_call": launches,
            "max_err_vs_plain": float((got.float() - ref).abs().max())}
    return out


def coalesce_plain_sweep(device, e: int, b: int, t: int, f: int, h: int,
                         iters: int) -> dict:
    """G independent b-row window batches as ONE G·b-row fwd+bwd against G
    sequential calls, on the default dispatch (the plain recurrence on the
    CPU), host clock."""
    params = GRUParams(*[w.requires_grad_(True)
                         for w in gru_params(e, f, h, device, seed=0)])
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"shape": {"B": b, "T": t, "F": f, "E": e, "H": h},
           "iters": iters, "recurrence": "plain"}
    base_rate = None
    for g in COALESCE_GS:
        x = torch.randn((g, b, t, f), generator=gen, device=device)

        def run():
            for w in params:
                w.grad = None
            h_all = gru(params, x[0]) if g == 1 else gru_coalesced(params, x)
            (h_all ** 2).sum().backward()
            return float(params.w_ih.grad.reshape(-1)[0])

        ms = host_ms(run, iters)
        rate = g * 1e3 / ms                     # microbatch steps / s
        entry = {"microbatch_steps_per_sec": rate, "recurrence_rows": g * b}
        if g == 1:
            base_rate = rate
        else:
            entry["speedup_vs_g1"] = rate / base_rate
        out[f"G{g}"] = entry
        print(f"coalesce G{g}", entry, flush=True)
    return out


# ---------------------------------------------------------------------------
# the two arms
# ---------------------------------------------------------------------------


def cpu_main(quick: bool) -> dict:
    """The CPU-feasible subset, labelled as such."""
    if quick:
        e, b, t, f, h, iters = 2, 4, 6, 8, 16, 1
    else:
        e, b, t, f, h, iters = E, B, T, 64, H, 2
    cpu = torch.device("cpu")
    return {
        "platform": "cpu", "note": CPU_NOTE, "quick": quick,
        "bidir": bidir_check(cpu, e, b, t, f, h, torch.float32, iters,
                             host_ms),
        "coalesce_plain": coalesce_plain_sweep(cpu, e, b, t, f, h, iters),
        "block_plan": block_plan_table(),
        "loop_order": LOOP_ORDER,
    }


def cuda_main(device, quick: bool, coalesce: bool) -> tuple[dict, list]:
    """The sweep on the card; returns ``(results, failures)``."""
    iters = 5 if quick else 20
    card = card_line()
    results = {"platform": "gpu", "device": torch.cuda.get_device_name(device),
               "card": card, "quick": quick,
               "shape": {"B": B, "T": T, "E": E, "H": H, "fused_E": E2},
               "stash_gates_default": cuda_gru.STASH_GATES,
               "bidir_fused_default": gru_mod.BIDIR_FUSED,
               "loop_order": LOOP_ORDER}
    failures = []

    def record(key, fn, timer_iters=iters):
        results[key] = cuda_ms(fn, timer_iters)
        print(key, results[key], flush=True)

    args40 = recurrence_args(E, T, B, H, device, seed=0)
    args80 = recurrence_args(E2, T, B, H, device, seed=1)
    with torch.no_grad():
        ref80 = cuda_gru.gru_recurrence(*args80)          # production f32
        record("prod_fwd_E40_ms", lambda: cuda_gru.gru_recurrence(*args40))
        record("prod_fwd_fusedE80_ms",
               lambda: cuda_gru.gru_recurrence(*args80))
        bf80 = to_bf16(args80)
        record("prod_fwd_fusedE80_bf16_ms",
               lambda: cuda_gru.gru_recurrence(*bf80))

    record("prod_fwdbwd_E40_ms", fwdbwd(args40))
    record("prod_fwdbwd_E40_bf16_ms", fwdbwd(to_bf16(args40)))
    record("prod_fwdbwd_fusedE80_ms", fwdbwd(args80))
    record("prod_fwdbwd_fusedE80_bf16_ms", fwdbwd(bf80))
    for suffix in ("", "_bf16"):
        results[f"unfused_equiv_fwdbwd{suffix}_ms"] = (
            2 * results[f"prod_fwdbwd_E40{suffix}_ms"])

    for stash in (True, False):
        with knob(cuda_gru, "STASH_GATES", stash):
            record(f"fwdbwd_bf16_stash{int(stash)}_ms", fwdbwd(bf80))

    # K4 at the fused stacking: f32 inputs with the f32 dot, bf16 inputs
    # with the bf16 dot (the JAX sweep's two variants)
    with torch.no_grad():
        for bf16 in (False, True):
            sweep_args = bf80 if bf16 else args80
            plain = cuda_gru.gru_fwd_blocked_reference(*sweep_args,
                                                       bf16_dot=bf16)
            rtol, atol = TOL[bf16]
            for rows, e_blk, t_blk in blocking_menu(E2, T, B, H, quick):
                key = (f"rows{rows}_E{e_blk}_T{t_blk}_"
                       f"{'bf16' if bf16 else 'f32'}")
                plan = cuda_gru.block_plan(
                    E2, T, B, H, sweep_args[0].dtype, training=False,
                    rows=rows, e_blk=e_blk, t_blk=t_blk, blocked=True,
                    bf16_dot=bf16)
                if not plan["fits"]:
                    results[key] = {"refused": plan["refusal"]}
                    print(key, results[key], flush=True)
                    continue

                def call(rows=rows, e_blk=e_blk, t_blk=t_blk):
                    return cuda_gru.gru_fwd_blocked_cuda(
                        *sweep_args, e_blk=e_blk, t_blk=t_blk,
                        bf16_dot=bf16, rows=rows)

                got = call()
                torch.cuda.synchronize()
                diff = (got - plain).abs()
                agrees = bool((diff <= atol + rtol * plain.abs()).all())
                results[key] = {
                    "ms": cuda_ms(call, iters),
                    "max_err": float((got - ref80).abs().max()),
                    "max_err_vs_plain": float(diff.max()),
                    "ctas": plan["ctas"], "ctas_per_sm": plan["ctas_per_sm"],
                    "waves": plan["waves"], "smem_bytes": plan["smem_bytes"]}
                print(key, results[key], flush=True)
                if not agrees:
                    failures.append(f"{key} disagrees with its plain version "
                                    f"by {float(diff.max())}")
            del plain

    fused = results["prod_fwdbwd_fusedE80_bf16_ms"]
    unfused = results["unfused_equiv_fwdbwd_bf16_ms"]
    results["bidir_decision"] = {
        "fused_bidir_faster": fused < unfused,
        "prod_fwdbwd_fusedE80_bf16_ms": fused,
        "unfused_equiv_fwdbwd_bf16_ms": unfused,
        "unfused_over_fused": unfused / fused,
        "card": card,
        "basis": "this run's fwd+bwd of one E80 recurrence call against two "
                 "E40 calls at bf16 (fused and unfused bidirectional); the "
                 "sweep changes no default (BIDIR_FUSED stays as set)",
    }
    results["bidir"] = bidir_check(device, E, B, T, F, H, torch.bfloat16,
                                   iters, cuda_ms)
    if results["bidir"]["fused_bidir"]["gru_fwd_launches_per_call"] != 1:
        failures.append("the fused bidirectional forward did not make "
                        "exactly one gru_fwd launch")
    results["block_plan"] = block_plan_table()

    if coalesce:
        # G window batches folded into the rows of one E40 call, fwd+bwd
        # at bf16, with the stash on and off; per-microbatch speedups are
        # ms(G=1) * G / ms(G)
        for g in COALESCE_GS:
            args_g = to_bf16(recurrence_args(E, T, B * g, H, device,
                                             seed=10 + g))
            for stash in (True, False):
                with knob(cuda_gru, "STASH_GATES", stash):
                    record(f"coalesce_G{g}_rows{B * g}_stash{int(stash)}"
                           "_bf16_ms", fwdbwd(args_g))
            del args_g
        for stash in (1, 0):
            base = results[f"coalesce_G1_rows{B}_stash{stash}_bf16_ms"]
            for g in COALESCE_GS[1:]:
                v = results[f"coalesce_G{g}_rows{B * g}_stash{stash}_bf16_ms"]
                results[f"coalesce_G{g}_stash{stash}_speedup_per_microbatch"] \
                    = g * base / v
    results["kernel_launches"] = {k.name: k.launches
                                  for k in cuda_gru.KERNELS}
    return results, failures


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m deeprest_tpu_torch.benchmarks.kernel_tuning",
        description="GRU kernel tuning sweep (card by default)")
    parser.add_argument("--out", help="write the result JSON here too")
    parser.add_argument("--coalesce", action="store_true",
                        help="add the G x stash window-coalescing sweep")
    parser.add_argument("--quick", action="store_true",
                        help="short K4 menu and timing loops (CPU: a tiny "
                             "shape)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu for the reduced arm")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    failures = []
    if device.type == "cpu":
        results = cpu_main(args.quick)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        results, failures = cuda_main(device, args.quick, args.coalesce)
    results["failures"] = failures
    print(json.dumps(results, indent=2), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(results, fh, indent=2)
    if failures:
        raise SystemExit("kernel tuning sweep failed: " + "; ".join(failures))
    return results


if __name__ == "__main__":
    main()
