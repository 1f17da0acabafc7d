"""Closed-loop load benchmark of the port's HTTP prediction service (the JAX
package's ``benchmarks/serve_bench.py``, on the port).

    python -m deeprest_tpu_torch.benchmarks.serve_bench [--ckpt-dir DIR]
        [--replica-mode thread|process] [--client-procs N] [--quick]
        [--device cpu] [--out PATH]

Two measurement planes, each a ``PredictionServer`` on port 0 in this
process, driven over real sockets:

1. **Single engine**: N concurrent clients post ``/v1/predict`` with mixed
   series lengths (1-3 windows with a ragged tail) against ONE
   Predictor/MicroBatcher stack, batched and per request.
2. **Replica sweep**: the same load against a ReplicaRouter of R replicas
   (``--replica-mode thread``: engine replicas sharing one stack a card;
   ``process``: worker processes, each with its own stack and CUDA
   context) behind bounded admission.  Cells record goodput (200s a
   second), p50/p95/p99 of SERVED requests, 429s, errors, the in-plane
   latency the admission bound controls and each replica's served
   requests.

Closed loop: each client posts its next request as soon as the previous
one returns (a 429 sleeps its Retry-After first, at most 0.25 s).  With
``--client-procs N`` the clients run as threads in N spawned processes, so
the bench's own interpreter lock does not cap the offered load.  A cell
counts the requests that complete after its first ``--warmup`` seconds and
before its end.

The model is a seeded random checkpoint at the JAX bench's shape (F=32,
E=8, H=128, W=24) written to a temporary directory, or ``--ckpt-dir`` (the
flagship on the card); ``--quick`` is a tiny model and short cells for the
CPU tests.  The device is ``cuda`` unless ``--device cpu``; every rung
graph is captured before a cell starts, and the document counts the
captures after warm-up (0 is the bar).  One JSON document is written to
``--out`` with the card's name and power limit (``nvidia-smi``) on a GPU.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

SCHEMA_VERSION = 2
F, E, H, W = 32, 8, 128, 24          # the JAX bench's serving shape
QUICK = dict(F=8, E=3, H=8, W=12)
SERIES_LENGTHS = (24, 24, 24, 31, 36, 47)   # at W=24: 1-3 windows
LADDER = (8, 16, 32, 64)


# -- the closed-loop client ------------------------------------------------


def _client_threads(addr, payloads, concurrency: int, start: float,
                    stop: float, keep: int) -> dict:
    """``concurrency`` closed-loop client threads between the wall-clock
    times ``start`` and ``stop``: (completion time, latency) of every 200,
    errors, 429s, and the first ``keep`` answers to each payload."""
    lock = threading.Lock()
    out = {"lat": [], "errors": 0, "rejected": 0, "retry_after": set(),
           "samples": {i: [] for i in range(len(payloads))}}

    def client(c):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        k = c
        time.sleep(max(0.0, start - time.time()))
        try:
            while time.time() < stop:
                i = k % len(payloads)
                k += 1
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/v1/predict", body=payloads[i],
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    body = resp.read()
                except (OSError, http.client.HTTPException):
                    with lock:
                        out["errors"] += 1
                    conn.close()
                    conn = http.client.HTTPConnection(*addr, timeout=120)
                    continue
                dt = time.perf_counter() - t0
                if resp.status == 429:
                    retry = resp.getheader("Retry-After")
                    with lock:
                        out["rejected"] += 1
                        out["retry_after"].add(retry)
                    try:
                        time.sleep(min(float(retry or 0.05), 0.25))
                    except ValueError:
                        time.sleep(0.05)
                    continue
                with lock:
                    if resp.status != 200:
                        out["errors"] += 1
                        continue
                    out["lat"].append((time.time(), dt))
                    if len(out["samples"][i]) < keep:
                        out["samples"][i].append(body)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(stop - time.time() + 180)
    if any(t.is_alive() for t in threads):
        out["errors"] += sum(t.is_alive() for t in threads)
    return out


def _client_proc_main(addr, payloads, concurrency, keep, conn) -> None:
    """Spawned client process: reports ready, receives the cell's (start,
    stop) wall times, and sends its threads' results back over ``conn``."""
    try:
        conn.send("ready")
        start, stop = conn.recv()
        conn.send(_client_threads(addr, payloads, concurrency, start, stop,
                                  keep))
    finally:
        conn.close()


def closed_loop(addr, payloads: list, concurrency: int, duration_s: float,
                warmup_s: float = 0.0, procs: int = 1,
                keep: int = 0) -> dict:
    """One closed-loop cell against a live server at ``addr`` (host,
    port): ``concurrency`` clients spread over ``procs`` processes (1: in
    this process).  Returns requests, errors, 429s, rps and latency
    percentiles in ms over the requests completed between ``warmup_s`` and
    the end of the cell, and under ``samples`` the first ``keep`` raw
    answers to each payload."""
    import multiprocessing as mp

    procs = max(1, min(procs, concurrency))
    share = [concurrency // procs + (1 if i < concurrency % procs else 0)
             for i in range(procs)]

    def window():
        start = time.time() + 0.05
        return start, start + warmup_s, start + warmup_s + duration_s

    if procs == 1:
        start, cut, stop = window()
        parts = [_client_threads(addr, payloads, concurrency, start, stop,
                                 keep)]
    else:
        ctx = mp.get_context("spawn")
        running = []
        try:
            for n in share:
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_client_proc_main, daemon=True,
                                args=(addr, payloads, n, keep, child))
                p.start()
                child.close()
                running.append((p, parent))
            for p, parent in running:      # every client process is up
                if not parent.poll(120) or parent.recv() != "ready":
                    raise RuntimeError("a client process never started")
            start, cut, stop = window()
            for p, parent in running:
                parent.send((start, stop))
            parts = []
            for p, parent in running:
                if not parent.poll(stop - time.time() + 240):
                    raise RuntimeError("a client process never reported")
                parts.append(parent.recv())
        finally:
            for p, parent in running:
                parent.close()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    # a request counts when it completes inside the cell: the ones still
    # in flight at ``stop`` finish afterwards and would inflate the rate
    lats = sorted(dt for part in parts for done, dt in part["lat"]
                  if cut <= done <= stop)
    samples = {i: [] for i in range(len(payloads))}
    for part in parts:
        for i, got in part["samples"].items():
            samples[i].extend(got[:max(0, keep - len(samples[i]))])

    def pct(p):
        if not lats:
            return None
        return 1e3 * lats[min(len(lats) - 1,
                              int(round(p / 100 * (len(lats) - 1))))]

    return {"concurrency": concurrency, "client_procs": procs,
            "requests": len(lats),
            "errors": sum(p["errors"] for p in parts),
            "rejected_429": sum(p["rejected"] for p in parts),
            "retry_after": sorted({str(v) for p in parts
                                   for v in p["retry_after"]}),
            "rps": len(lats) / duration_s,
            "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
            "samples": samples}


# -- the planes -------------------------------------------------------------


def write_bench_checkpoint(directory: str, quick: bool) -> str:
    """A seeded random checkpoint at the bench's shape (load benching
    needs the serving path, not trained weights)."""
    import dataclasses

    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.models.qrnn import init_params
    from deeprest_tpu_torch.train.checkpoint import save_checkpoint

    dims = QUICK if quick else dict(F=F, E=E, H=H, W=W)
    mc = ModelConfig(feature_dim=dims["F"], num_metrics=dims["E"],
                     hidden_size=dims["H"], dropout_rate=0.0)
    extra = {
        "metric_names": [f"comp{i // 2}_res{i % 2}"
                         for i in range(dims["E"])],
        "x_stats": {"min": 0.0, "max": 20.0},
        "y_stats": {"min": [0.0] * dims["E"], "max": [1.0] * dims["E"]},
        "window_size": dims["W"], "feature_dim": dims["F"],
        "model_config": dataclasses.asdict(mc), "space": None,
        "delta_mask": None,
    }
    save_checkpoint(directory, init_params(mc, seed=0), step=0, extra=extra)
    return directory


def request_payloads(window: int, features: int, seed: int = 0) -> list:
    """The JAX bench's mix of series lengths, scaled to ``window``:
    Poisson call-path counts, one JSON body each."""
    rng = np.random.default_rng(seed)
    return [json.dumps({"traffic": rng.poisson(
        5.0, (max(window, round(t * window / 24)), features)).astype(
            np.float32).tolist()}).encode() for t in SERIES_LENGTHS]


def card() -> dict:
    """The card of this run: its name, count, and name and power limit as
    ``nvidia-smi`` reports them."""
    import torch

    from deeprest_tpu_torch.benchmarks.kernel_tuning import card_line

    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def _worker_graphs_after_warmup(router) -> int:
    total = 0
    for r in router.replicas:
        stats = r.worker_stats() or {}
        total += (stats.get("jit_cache") or {}).get(
            "captures_after_warmup", 0)
    return total


def _cell(addr, payloads, conc, args, procs) -> dict:
    cell = closed_loop(addr, payloads, conc, args.duration, args.warmup,
                       procs=procs)
    cell.pop("samples")
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=4.0,
                    help="steady-state seconds per (mode, concurrency) cell")
    ap.add_argument("--warmup", type=float, default=1.0,
                    help="per-cell warmup seconds (excluded from stats)")
    ap.add_argument("--concurrency", default="1,4,16,64",
                    help="single-engine closed-loop client counts")
    ap.add_argument("--replicas", default="1,2,4",
                    help="replica counts for the routing-plane sweep")
    ap.add_argument("--replica-concurrency", default="16,64,256",
                    help="closed-loop client counts for the replica sweep")
    ap.add_argument("--replica-mode", choices=("thread", "process"),
                    default="process",
                    help="engine replicas in this process or worker "
                         "processes")
    ap.add_argument("--admission-depth", type=int, default=64,
                    help="router admission bound (in-flight requests)")
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--client-procs", type=int, default=4,
                    help="processes the clients of a cell run in")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve this checkpoint (default: a seeded random "
                         "one at the bench's shape)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the CPU arm)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny model and short cells (the CPU tests)")
    ap.add_argument("--out", default="serve_bench.json")
    args = ap.parse_args(argv)
    if args.quick:
        args.duration = min(args.duration, 0.6)
        args.warmup = min(args.warmup, 0.3)
        args.concurrency = "2,4"
        args.replicas = "1,2"
        args.replica_concurrency = "4,8"
        args.admission_depth = 8
        args.client_procs = min(args.client_procs, 2)
    concurrencies = [int(c) for c in args.concurrency.split(",")]
    replica_counts = [int(r) for r in args.replicas.split(",")]
    replica_conc = [int(c) for c in args.replica_concurrency.split(",")]

    from deeprest_tpu_torch.serve.batcher import BatcherConfig
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.router import ReplicaRouter, RouterConfig
    from deeprest_tpu_torch.serve.server import (
        PredictionServer, PredictionService,
    )

    with tempfile.TemporaryDirectory(prefix="serve_bench_") as tmp:
        ckpt = args.ckpt_dir or write_bench_checkpoint(
            os.path.join(tmp, "ckpt"), args.quick)
        ladder = (8,) if args.quick else LADDER
        max_batch = min(args.max_batch, max(ladder))
        knobs = dict(ladder=ladder, device=args.device)
        pred = Predictor.from_checkpoint(ckpt, **knobs)
        pred.warm()
        warm_size = pred.jit_cache_size()
        payloads = request_payloads(pred.window_size, pred.feature_dim)
        batching = BatcherConfig(max_batch=max_batch,
                                 max_linger_s=args.linger_ms / 1e3)

        results = []
        for mode, cfg in (("batched", batching), ("per_request", None)):
            service = PredictionService(pred, None, backend=f"bench:{mode}",
                                        batching=cfg)
            server = PredictionServer(service, port=0).start()
            try:
                for conc in concurrencies:
                    cell = _cell(server.address, payloads, conc, args,
                                 args.client_procs)
                    cell.update(mode=mode, replicas=1)
                    if service.batcher is not None:
                        s = service.batcher.stats()
                        cell["batcher"] = {k: s[k] for k in (
                            "batches", "windows", "coalesced_batches",
                            "max_batch_windows")}
                    results.append(cell)
                    print(json.dumps(cell), file=sys.stderr, flush=True)
            finally:
                server.stop()
        new_graphs = pred.jit_cache_size() - warm_size

        replica_results, replica_new_graphs = [], 0
        spec = {"ckpt_dir": ckpt, "device": args.device or "cuda",
                "kwargs": {"ladder": ladder}}
        for nrep in replica_counts:
            config = RouterConfig(admission_depth=args.admission_depth,
                                  max_wait_s=0.1, retry_after_s=0.25)
            if args.replica_mode == "process":
                router = ReplicaRouter.build_process(spec, nrep,
                                                     config=config,
                                                     batching=batching)
            else:
                router = ReplicaRouter.build(pred, nrep, config=config,
                                             batching=batching)
                before = pred.jit_cache_size()
            service = PredictionService(router, None,
                                        backend=f"bench:replicas={nrep}")
            server = PredictionServer(service, port=0).start()
            try:
                for conc in replica_conc:
                    router.admission.reset_window()
                    served0 = [r.served_requests() for r in router.replicas]
                    cell = _cell(server.address, payloads, conc, args,
                                 args.client_procs)
                    stats = router.router_stats()
                    cell.update(
                        mode="replicated", replica_mode=args.replica_mode,
                        replicas=nrep,
                        per_replica_served=[
                            r["served_requests"] - s0 for r, s0 in
                            zip(stats["replicas"], served0)],
                        admission={k: stats["admission"][k] for k in (
                            "depth", "admitted", "rejected", "queued")},
                        in_plane_p50_ms=stats["admission"]["in_plane_p50_ms"],
                        in_plane_p99_ms=stats["admission"]["in_plane_p99_ms"])
                    if args.replica_mode == "process":
                        cell["worker_memory"] = [
                            (r.get("worker") or {}).get("memory")
                            for r in stats["replicas"]]
                    replica_results.append(cell)
                    print(json.dumps(cell), file=sys.stderr, flush=True)
                replica_new_graphs += (
                    _worker_graphs_after_warmup(router)
                    if args.replica_mode == "process"
                    else pred.jit_cache_size() - before)
            finally:
                server.stop()           # closes the router's replicas too

    def rcell(nrep, conc):
        return next((r for r in replica_results if r["replicas"] == nrep
                     and r["concurrency"] == conc), None)

    sweep_conc = 64 if 64 in replica_conc else replica_conc[-1]
    replica_sweep = {
        "concurrency": sweep_conc,
        "rps_by_replicas": {str(n): (rcell(n, sweep_conc) or {}).get("rps")
                            for n in replica_counts},
        "p99_ms_by_replicas": {str(n): (rcell(n, sweep_conc) or {}).get(
            "p99_ms") for n in replica_counts},
    }
    r1, r2 = rcell(1, sweep_conc), rcell(2, sweep_conc)
    if r1 and r2 and r1["rps"]:
        replica_sweep["speedup_2_vs_1"] = r2["rps"] / r1["rps"]
    top = rcell(max(replica_counts), max(replica_conc))
    doc = {
        "schema_version": SCHEMA_VERSION,
        "metric": "serve_predict_rps",
        "device": card() if (args.device or "cuda") != "cpu"
        else {"platform": "cpu", "name": None, "nvidia_smi": None},
        "model": {"F": pred.feature_dim, "E": len(pred.metric_names),
                  "W": pred.window_size, "checkpoint": args.ckpt_dir,
                  "weights": "random-init" if not args.ckpt_dir
                  else "checkpoint"},
        "workload": {"closed_loop": True,
                     "series_lengths": [len(json.loads(p)["traffic"])
                                        for p in payloads],
                     "duration_s": args.duration, "warmup_s": args.warmup,
                     "client_procs": args.client_procs},
        "batcher": {"max_batch": max_batch,
                    "max_linger_ms": args.linger_ms, "ladder": list(ladder)},
        "router": {"admission_depth": args.admission_depth,
                   "replica_counts": replica_counts,
                   "replica_mode": args.replica_mode,
                   "dispatch": "least-outstanding-windows"},
        "results": results,
        "replica_results": replica_results,
        "replica_sweep": replica_sweep,
        "admission_at_max": None if top is None else {
            k: top[k] for k in ("concurrency", "replicas", "rps", "p99_ms",
                                "rejected_429", "errors", "in_plane_p99_ms")},
        "new_graphs_after_warmup": new_graphs,
        "replica_new_graphs_after_warmup": replica_new_graphs,
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print(json.dumps({"out": args.out, "device": doc["device"],
                      "replica_sweep": replica_sweep,
                      "admission_at_max": doc["admission_at_max"],
                      "new_graphs_after_warmup": new_graphs,
                      "replica_new_graphs_after_warmup":
                          replica_new_graphs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
