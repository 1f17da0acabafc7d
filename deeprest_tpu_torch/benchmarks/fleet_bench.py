"""fleet_bench: many apps, one serving plane (``benchmarks/fleet_bench.py``
of the JAX package, on the port; serve/fleet.py).

    python -m deeprest_tpu_torch.benchmarks.fleet_bench [--quick]
        [--headline] [--device cpu] [--out PATH]
    python -m deeprest_tpu_torch.benchmarks.fleet_bench --cold-start CKPT
        [--device cpu]

Four arms over the real multi-tenant pool, a PredictorPool admitting N
apps (scaled copies of one seeded init: distinct digests, identical
shapes) behind one plane's captured rung graphs:

- **ledger**: admit every app, warm the plane ONCE, freeze the graph
  ledger, then dispatch every app.  Graphs are keyed by shape with the
  weights bound per replay, so the graph count stays FLAT in the number of
  apps and ZERO graphs are captured after warm-up (``assert_frozen``).
  Records admission ms per app, device bytes allocated and pinned host
  bytes per app beyond its spill.
- **churn**: an LRU storm with the working set larger than
  ``hbm_budget``: random tenant access, spilled tenants restored from
  pinned host memory (never disk, never a capture).  Gates: honest
  spill/restore counters (both nonzero), post-storm outputs bit-identical
  to pre-storm ones, the ledger still frozen, and p99 request latency
  within ``P99_FACTOR`` of the warm median.  Records bind, spill and
  restore ms (median, p99) and device memory before and after.
- **isolation**: tenant A's answers bit-identical with and WITHOUT tenant
  B hammering the plane from another thread, including a mid-storm hot
  reload of B.
- **aot**: the sidecar (serve/aot.py) exported next to a checkpoint
  directory, then a template admission with and without it, by stage
  (admission, first eager call of each program, captures, first request);
  what ``load_aot`` loaded and why, and a stale manifest falling back
  with its mismatched keys named.

``--quick`` is the CPU smoke (tiny shapes, 12 apps, budget 4);
without it the flagship architecture (F=512, E=40, H=128, W=60,
bidirectional, bf16) at 100 apps, budget 16.  ``--headline`` prints one
JSON line with JAX's ``fleet_apps``, ``fleet_cold_start_ms`` and
``fleet_spill_restore_ms``.  ``--cold-start CKPT`` instead measures one
template cold start of that checkpoint in this fresh process (kernel
library load, checkpoint load, admission, each program's first eager
call, the captures, the first request) and prints it as one JSON line.
The device is ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

P99_FACTOR = 100.0     # churn p99 <= factor * warm median (JAX's gate)
T_QUICK, T_FULL = 96, 117            # request series length (buckets)
QUICK = dict(apps=12, budget=4, W=12, E=3, F=96, H=48, ladder=(8,),
             compute="float32", bidir=False)
FULL = dict(apps=100, budget=16, W=60, E=40, F=512, H=128,
            ladder=(8, 16, 32, 64), compute="bfloat16", bidir=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _device_bytes(device) -> int | None:
    import torch

    if torch.device(device).type != "cuda":
        return None
    _sync(device)
    return int(torch.cuda.memory_allocated(device))


def _pinned_bytes(device) -> int | None:
    """Pinned host bytes in use (the caching host allocator's count),
    or None where torch does not report it."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    s = stats()
    return int(s.get("allocated_bytes.current",
                     s.get("allocated_bytes", {}).get("current", 0))
               if isinstance(s, dict) else 0)


def _pct(xs, q) -> float | None:
    return float(np.percentile(xs, q)) if len(xs) else None


def _world(quick: bool, device):
    """One seeded init at the mode's shape → a factory of per-app
    Predictors with DISTINCT weights (copies scaled by 1 + 0.01 i:
    distinct digests, identical shapes, so the graphs are shareable but
    the outputs differ)."""
    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.data.windows import MinMaxStats
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.serve.predictor import Predictor

    s = QUICK if quick else FULL
    w, e, f, h = s["W"], s["E"], s["F"], s["H"]
    mc = ModelConfig(feature_dim=f, num_metrics=e, hidden_size=h,
                     num_layers=1, bidirectional=s["bidir"],
                     compute_dtype=s["compute"], dropout_rate=0.0)
    base = init_params(mc, seed=0)
    rng = np.random.default_rng(0)
    y_min = rng.uniform(0.0, 1.0, e).astype(np.float32)
    y_max = y_min + rng.uniform(1.0, 50.0, e).astype(np.float32)
    # every fifth resource a level series served as integrated increments
    delta = None if quick else np.array([i % 5 == 4 for i in range(e)])

    def make(i: int) -> Predictor:
        scale = np.float32(1.0 + 0.01 * i)
        return Predictor(
            {k: v * scale for k, v in base.items()}, mc,
            x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(20.0)),
            y_stats=MinMaxStats(min=y_min, max=y_max),
            metric_names=[f"comp{j // 5}_res{j % 5}" for j in range(e)],
            window_size=w, delta_mask=delta, ladder=s["ladder"],
            device=device)

    return s, make


def _name(i: int) -> str:
    return f"app{i:03d}"


def measure_ledger(pool, make, apps: int, traffic, device) -> dict:
    """Admit every app, warm once, freeze; every later dispatch, all N
    apps included, must reuse the frozen graph set."""
    dev0, pin0 = _device_bytes(device), _pinned_bytes(device)
    admit_ms, pool_ms = [], []
    for i in range(apps):
        t0 = time.perf_counter()
        pred = make(i)
        t1 = time.perf_counter()
        pool.admit(_name(i), pred)
        t2 = time.perf_counter()
        admit_ms.append((t2 - t0) * 1e3)
        pool_ms.append((t2 - t1) * 1e3)
        del pred
    pool.resolve(_name(0)).predictor().warm()
    cache_after_warmup = pool.freeze()
    for i in range(apps):
        pool.resolve(_name(i)).predictor().predict_series(traffic)
    cache_after_all = pool.assert_frozen()
    plane = pool.resolve(_name(0)).predictor().plane
    graphs = plane.graphs.stats()
    dev1, pin1 = _device_bytes(device), _pinned_bytes(device)
    host = pool.host_bytes()
    spilled = pool.stats()["spilled"]
    out = {
        "apps": apps,
        "hbm_budget": pool.hbm_budget,
        # JAX's key: the predictor's construction and the admission
        "admit_ms_per_app": float(np.mean(admit_ms)),
        # the pool's admit() alone (the first makes the plane)
        "pool_admit_ms_median": float(np.median(pool_ms)),
        "pool_admit_ms_first": pool_ms[0],
        "jit_cache_after_warmup": cache_after_warmup,
        "jit_cache_after_all_apps": cache_after_all,
        "per_app_compiles": (None if cache_after_warmup is None
                             else cache_after_all - cache_after_warmup),
        "captures": graphs["captures"],
        "captures_after_warmup": graphs["captures_after_warmup"],
        "slot_bytes": pool.stats()["plane"]["slot_bytes"],
        "device_bytes_before": dev0,
        "device_bytes_after": dev1,
        "spill_host_bytes": host,
        "pinned_bytes_before": pin0,
        "pinned_bytes_after": pin1,
        # pinned bytes in use beyond the spilled tenants' own copies, per
        # app (the plane's staging and readback are shared, so ~0)
        "pinned_beyond_spill_per_app": (
            None if pin1 is None or pin0 is None
            else (pin1 - pin0 - host) / apps),
        "spilled": spilled,
    }
    out["ok"] = (out["per_app_compiles"] == 0
                 and out["captures_after_warmup"] == 0)
    return out


def time_binds(pool, a: str, b: str, n: int) -> list[float]:
    """ms of ``n`` binds alternating two resident tenants into the
    plane's slot (CUDA events on the card, the host clock on the CPU)."""
    import torch

    pa, pb = pool.resolve(a).predictor(), pool.resolve(b).predictor()
    plane = pa.plane
    slot, cuda = plane.graphs.slot, plane.device.type == "cuda"
    out = []
    with plane.graphs.lock:
        for k in range(n):
            who = pa if k % 2 == 0 else pb
            if cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
                slot.bind(who)
                e1.record()
                e1.synchronize()
                out.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                slot.bind(who)
                out.append((time.perf_counter() - t0) * 1e3)
    return out


def measure_churn(pool, apps: int, traffic, quick: bool, device) -> dict:
    """LRU storm with working set > hbm_budget: random access, honest
    spill/restore counters, bit-exact post-storm outputs, bounded p99."""
    rng = np.random.default_rng(23)
    sample = [_name(i) for i in (0, 1, 2)]
    refs = {t: np.asarray(
        pool.resolve(t).predictor().predict_series(traffic))
        for t in sample}
    binds = time_binds(pool, sample[1], sample[2], 40)
    before = pool.stats()
    seen = {k: len(v) for k, v in pool.timings().items()}
    dev0 = _device_bytes(device)
    n = 150 if quick else 400
    restore_ms, request_ms = [], []
    for _ in range(n):
        tenant = _name(int(rng.integers(0, apps)))
        was_resident = pool.peek(tenant).resident
        t0 = time.perf_counter()
        entry = pool.resolve(tenant)               # restores if spilled
        t1 = time.perf_counter()
        out = entry.predictor().predict_series(traffic)
        t2 = time.perf_counter()
        if not was_resident:
            restore_ms.append((t1 - t0) * 1e3)
        request_ms.append((t2 - t0) * 1e3)
        del out
    after = pool.stats()
    timings = {k: v[seen[k]:] for k, v in pool.timings().items()}
    dev1 = _device_bytes(device)
    bitexact = all(
        np.array_equal(refs[t], np.asarray(
            pool.resolve(t).predictor().predict_series(traffic)))
        for t in sample)
    pool.assert_frozen()
    p99 = float(np.percentile(request_ms, 99))
    warm_median = float(np.median(request_ms))
    out = {
        "requests": n,
        "spills": after["spills"] - before["spills"],
        "restores": after["restores"] - before["restores"],
        "evictions": after["evictions"] - before["evictions"],
        "resident": after["resident"],
        "spilled": after["spilled"],
        "restore_ms_median": (float(np.median(restore_ms))
                              if restore_ms else None),
        "request_ms_median": warm_median,
        "request_ms_p99": p99,
        "p99_over_median": p99 / max(warm_median, 1e-9),
        "post_storm_bit_exact": bitexact,
        "bind_ms_median": _pct(binds, 50), "bind_ms_p99": _pct(binds, 99),
        "spill_ms_median": _pct(timings["spill"], 50),
        "spill_ms_p99": _pct(timings["spill"], 99),
        "restore_copy_ms_median": _pct(timings["restore"], 50),
        "restore_copy_ms_p99": _pct(timings["restore"], 99),
        "device_bytes_before": dev0,
        "device_bytes_after": dev1,
        "spill_host_bytes": pool.host_bytes(),
        "pinned_bytes": _pinned_bytes(device),
    }
    out["ok"] = (out["spills"] > 0 and out["restores"] > 0 and bitexact
                 and out["p99_over_median"] <= P99_FACTOR)
    return out


def measure_isolation(pool, make, traffic, apps: int) -> dict:
    """Tenant A bit-identical with vs without tenant B load from another
    thread, including a mid-storm reload of B."""
    a, b = _name(0), _name(1)
    ref = np.asarray(pool.resolve(a).predictor().predict_series(traffic))
    solo = [bool(np.array_equal(ref, np.asarray(
        pool.resolve(a).predictor().predict_series(traffic))))
        for _ in range(3)]

    b_before = np.asarray(pool.resolve(b).predictor().predict_series(traffic))
    stop = threading.Event()
    errors: list[str] = []
    fresh = make(apps + 7)           # built before the storm

    def hammer():
        k = 0
        while not stop.is_set():
            try:
                pool.resolve(b).predictor().predict_series(traffic)
            except Exception as exc:  # surfaced as a gate failure
                errors.append(repr(exc))
                return
            k += 1
            if k == 3:   # mid-storm hot swap of the NOISY tenant
                try:
                    pool.reload(b, fresh, reason="storm-reload")
                except Exception as exc:
                    errors.append(repr(exc))
                    return

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    concurrent = []
    for _ in range(8):
        got = np.asarray(pool.resolve(a).predictor().predict_series(traffic))
        concurrent.append(bool(np.array_equal(ref, got)))
    stop.set()
    th.join(timeout=60)
    b_after = np.asarray(pool.resolve(b).predictor().predict_series(traffic))
    pool.assert_frozen()
    out = {
        "solo_bit_identical": all(solo),
        "concurrent_bit_identical": all(concurrent),
        "b_reload_took_effect": not np.array_equal(b_before, b_after),
        "b_invalidations": pool.peek(b).invalidations(),
        "hammer_errors": errors,
    }
    out["ok"] = (all(solo) and all(concurrent)
                 and out["b_reload_took_effect"] and not errors)
    return out


def template_cold_start(pred, ckpt: str, traffic) -> dict:
    """One template admission of ``pred`` into a fresh pool (checking the
    sidecar next to ``ckpt``), ``warm()`` and a first request, by stage
    (seconds), with ``load_aot``'s result."""
    from deeprest_tpu_torch.serve.fleet import PredictorPool

    pool = PredictorPool(hbm_budget=2, aot=True)
    t0 = time.perf_counter()
    pool.admit("template", pred, checkpoint_path=ckpt)
    t1 = time.perf_counter()
    pred.warm()
    t2 = time.perf_counter()
    got = np.asarray(pred.predict_series(traffic))
    _sync(pred.device)
    t3 = time.perf_counter()
    g = pred.plane.graphs.stats()
    st = pool.stats()["aot"]
    return {"seconds": {"admit": t1 - t0, "warm": t2 - t1,
                        "warm_eager": g["seconds"]["eager"],
                        "warm_capture": g["seconds"]["capture"],
                        "first_request": t3 - t2},
            "graphs": g["captures"] or pred.jit_cache_size(),
            "aot": st, "answer": got}


def measure_aot(make, traffic) -> dict:
    """The sidecar round trip: export, a template admission with it and
    without it (by stage), a stale manifest falling back whole."""
    from deeprest_tpu_torch.serve.aot import export_aot, load_aot

    out: dict = {}
    with tempfile.TemporaryDirectory() as ckpt, \
            tempfile.TemporaryDirectory() as bare:
        t0 = time.perf_counter()
        manifest = export_aot(make(0), ckpt)
        out["export_ms"] = (time.perf_counter() - t0) * 1e3
        out["executables"] = len(manifest["entries"])
        out["manifest_graphs"] = len(manifest["graphs"])
        with_sidecar = template_cold_start(make(1), ckpt, traffic)
        without = template_cold_start(make(1), bare, traffic)
        out["with_sidecar"] = {k: v for k, v in with_sidecar.items()
                               if k != "answer"}
        out["without_sidecar"] = {k: v for k, v in without.items()
                                  if k != "answer"}
        out["bit_identical"] = bool(np.array_equal(with_sidecar["answer"],
                                                   without["answer"]))
        # a stale manifest: another ladder's fingerprint
        stale = make(2)
        stale_manifest = export_aot(stale, ckpt)
        stale_manifest["fingerprint"]["ladder"] = [1]
        stale_manifest["fingerprint"]["torch"] = "0.0"
        with open(os.path.join(ckpt, "aot", "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(stale_manifest, f)
        res = load_aot(stale, ckpt)
        out["stale"] = {"loaded": res["loaded"],
                        "fallback_rungs": len(res["fallback_rungs"]),
                        "reason": res["reason"]}
    st = out["with_sidecar"]["aot"]
    out["cold_start_ms"] = sum(
        v for k, v in out["with_sidecar"]["seconds"].items()
        if k in ("admit", "warm", "first_request")) * 1e3
    out["ok"] = (st["loaded"] == 0
                 and (st["last_reason"] or "").startswith(
                     "manifest verified")
                 and st["compile_fallbacks"] == out["manifest_graphs"]
                 and out["without_sidecar"]["aot"]["last_reason"]
                 == "no artifacts"
                 and out["bit_identical"]
                 and "ladder" in out["stale"]["reason"]
                 and "torch" in out["stale"]["reason"])
    return out


def cold_start_main(ckpt: str, device) -> int:
    """A template cold start of ``ckpt`` in this fresh process, by stage:
    the kernel library's load (built from the repo's sources if missing),
    the checkpoint load, the pool admission, ``warm()`` (first eager call
    of each program, and the captures) and a first request."""
    import torch

    from deeprest_tpu_torch.serve.predictor import Predictor

    seconds = {}
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from deeprest_tpu_torch.ops import build, cuda_gru

        build.build_all(cuda_gru.SOURCES)
        torch.cuda.synchronize()
    seconds["kernel_library"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(ckpt, device=device)
    _sync(device)
    seconds["checkpoint_load"] = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    traffic = rng.poisson(5.0, (T_FULL, pred.feature_dim)).astype(np.float32)
    res = template_cold_start(pred, ckpt, traffic)
    seconds.update(res["seconds"])
    print(json.dumps({"cold_start": seconds, "graphs": res["graphs"],
                      "aot": res["aot"], "device": str(pred.device)}),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="CPU smoke: tiny shapes, fewer apps and requests")
    ap.add_argument("--headline", action="store_true",
                    help="print one JSON line of JAX's headline keys")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--cold-start", default=None, metavar="CKPT",
                    help="measure one template cold start of CKPT in this "
                         "process and print it")
    args = ap.parse_args(argv)

    from deeprest_tpu_torch.device import resolve_device
    from deeprest_tpu_torch.serve.fleet import PredictorPool

    device = resolve_device(args.device)
    if args.cold_start:
        return cold_start_main(args.cold_start, device)
    t0 = time.perf_counter()
    shape, make = _world(args.quick, device)
    apps, budget = shape["apps"], shape["budget"]
    rng = np.random.default_rng(7)
    traffic = rng.poisson(5.0, (T_QUICK if args.quick else T_FULL,
                                shape["F"])).astype(np.float32)

    pool = PredictorPool(hbm_budget=budget, aot=False)
    ledger = measure_ledger(pool, make, apps, traffic, device)
    churn = measure_churn(pool, apps, traffic, args.quick, device)
    isolation = measure_isolation(pool, make, traffic, apps)
    del pool
    aot = measure_aot(make, traffic)

    record = {
        "bench": "fleet_bench",
        "mode": "quick" if args.quick else "full",
        "device": str(device),
        "shapes": {"window": shape["W"], "feature_dim": shape["F"],
                   "metrics": shape["E"], "hidden": shape["H"],
                   "apps": apps, "hbm_budget": budget},
        "ledger": ledger,
        "churn": churn,
        "isolation": isolation,
        "aot": aot,
        "p99_factor": P99_FACTOR,
        "wall_s": time.perf_counter() - t0,
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(record, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.headline:
        print(json.dumps({
            "fleet_apps": ledger["apps"],
            "fleet_cold_start_ms": aot["cold_start_ms"],
            "fleet_spill_restore_ms": churn["restore_ms_median"],
        }))
    else:
        print(json.dumps(record, indent=2, sort_keys=True))

    failures = []
    if not ledger["ok"]:
        failures.append(
            f"graphs captured after warmup: {ledger['per_app_compiles']}, "
            f"{ledger['captures_after_warmup']}")
    if not churn["ok"]:
        failures.append(
            f"churn gate: spills={churn['spills']} "
            f"restores={churn['restores']} "
            f"bit_exact={churn['post_storm_bit_exact']} "
            f"p99/median={churn['p99_over_median']}")
    if not isolation["ok"]:
        failures.append(f"isolation gate: {isolation}")
    if not aot["ok"]:
        failures.append(f"aot gate: {aot}")
    if failures:
        print(f"fleet_bench GATES FAILED: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
