"""Command-line drivers of the port (``deeprest_tpu/cli.py``: the simulate,
featurize, ingest, train, stream, synthesize, whatif, predict, anomaly,
export and serve subcommands, with the JAX package's flags and last JSON
lines):

    python -m deeprest_tpu_torch simulate   --scenario=normal --ticks=480 --out=raw.jsonl
    python -m deeprest_tpu_torch featurize  --raw=raw.jsonl --out=input.npz
    python -m deeprest_tpu_torch train      --features=input.npz --ckpt-dir=ckpt
    python -m deeprest_tpu_torch whatif     --ckpt-dir=ckpt --raw=raw.jsonl --mix='{"nginx-thrift_/wrk2-api/post/compose": 40}' --sweep=0.5,1,2
    python -m deeprest_tpu_torch predict    --ckpt-dir=ckpt --raw=raw.jsonl --out=preds.npz
    python -m deeprest_tpu_torch anomaly    --ckpt-dir=ckpt --raw=raw.jsonl
    python -m deeprest_tpu_torch serve      --ckpt-dir=ckpt --raw=raw.jsonl --surface --port=2021
    python -m deeprest_tpu_torch export     --ckpt-dir=ckpt --out=artifact
    python -m deeprest_tpu_torch stream     --raw=growing.jsonl --ckpt-dir=ckpt
    python -m deeprest_tpu_torch serve      --ckpt-dir=ckpt --verdict-raw=growing.jsonl --watch=5
    python -m deeprest_tpu_torch serve      --artifact=artifact --port=2021
    python -m deeprest_tpu_torch serve      --ckpt-dir=ckpt --replicas=4 --replica-mode=process --admission-depth=64
    python -m deeprest_tpu_torch profile    --url=http://127.0.0.1:2021 --seconds=1 --out-dir=trace

``simulate``, ``featurize``, ``ingest`` and ``synthesize`` are host-only
and touch no device.  ``train``, ``predict``, ``whatif``, ``anomaly`` and
``serve`` run on CUDA unless ``--device cpu`` asks for the CPU; their JSON
lines add the device, the kernel launches the call made and the seconds
of its stages (``seconds``: loading and featurizing the input, the model
work).
``train`` takes the JAX CLI's ``--steps-per-superstep`` (default "auto":
captured CUDA graphs on a GPU), ``--grad-accum-windows``,
``--grad-accum-mode``, ``--snapshot-every-steps`` and ``--snapshot-keep``;
with snapshots on, running the same command again after a kill resumes
from the newest cursor snapshot.  ``serve`` takes the JAX CLI's
single-engine flags (batcher, ladder, fused inference, obs, capacity
surfaces, ``--watch``); it captures every rung's CUDA graph before it
listens.  ``--quant off|int8|bf16`` reaches ``predict``, ``whatif``,
``anomaly`` and ``serve``; ``--sparse-feed`` and ``--sparse-nnz-cap``
reach ``train`` and ``serve``.  ``export`` writes a ``torch.export``
artifact (``serve/export.py``) that ``serve --artifact`` serves; the JAX
package's StableHLO artifacts are refused.  ``stream`` tails a growing
corpus (or polls live endpoints, or listens for pushed span batches),
fine-tunes on the device every ``--refresh-buckets`` buckets and
re-checkpoints; run again it resumes, and ``--drift-detect`` arms the
drift→retrain loop.  ``serve --verdict-raw`` (or
``--verdict-wire-listen``) arms ``GET /v1/verdict``.  ``serve --replicas
N`` puts the routing front (serve/router.py) over N engine replicas
(``--replica-mode thread``: one shared stack a card) or N worker
processes (``process``: each its own CUDA context and rung graphs), with
bounded admission, per-tenant fairness, health ejection, retry, rolling
reload under ``--watch`` and the optional ``--autoscale`` loop.
``profile`` opens a ``torch.profiler`` window on a running server, and
``train --profile-dir`` traces the first epoch.  Mesh, elastic
remeshing (``stream --elastic`` exits 2), the fleet tier and AOT
executables (``export --aot``) are not ported, and the port's CLI does
not offer them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


# -- shared loaders ---------------------------------------------------------


def _load_buckets(path: str):
    from deeprest_tpu_torch.data.schema import iter_raw_data_jsonl, load_raw_data

    if path.endswith((".jsonl", ".jsl")):
        return list(iter_raw_data_jsonl(path))
    return load_raw_data(path)


def _load_features(args):
    from deeprest_tpu_torch.config import FeaturizeConfig
    from deeprest_tpu_torch.data.featurize import (
        FeaturizedData, featurize_buckets,
    )

    if getattr(args, "features", None):
        return FeaturizedData.load(_ensure_npz(args.features))
    cfg = FeaturizeConfig(
        capacity=args.capacity, round_to=args.round_to,
        hash_features=args.hash_features,
    )
    return featurize_buckets(_load_buckets(args.raw), cfg,
                             workers=getattr(args, "workers", 1))


def _add_input_args(p: argparse.ArgumentParser, features_ok: bool = True):
    if features_ok:
        p.add_argument("--features", default=None,
                       help="featurized .npz (from the featurize subcommand)")
    p.add_argument("--raw", default=None,
                   help="raw corpus: reference pickle or JSONL stream")
    p.add_argument("--capacity", type=int, default=0,
                   help="feature capacity (0 = size to observed, rounded)")
    p.add_argument("--round-to", type=int, default=128)
    p.add_argument("--hash-features", action="store_true",
                   help="stable hash-bucketing instead of a grown vocabulary")


def _require_input(args, features_ok: bool = True):
    if getattr(args, "features", None) is None and args.raw is None:
        sys.exit("error: provide --raw" + (" or --features" if features_ok else ""))


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run the "
                        "plain PyTorch path on the CPU)")


def _add_fused_infer_args(p: argparse.ArgumentParser):
    p.add_argument("--no-fused-infer", action="store_true",
                   help="serve through the host-loop reference path instead "
                        "of the fused one-call-per-page device pipeline")
    p.add_argument("--infer-page-windows", type=int, default=None,
                   metavar="N",
                   help="fused-inference page size in windows (default: the "
                        "ladder's top rung on CUDA, the smallest rung >= 8 "
                        "on the CPU)")
    p.add_argument("--infer-coalesce-pages", type=int, default=None,
                   metavar="G",
                   help="fold up to G consecutive pages into one model call "
                        "(default: 4 on CUDA, 1 on the CPU)")
    p.add_argument("--quant", choices=("off", "int8", "bf16"),
                   default="off",
                   help="quantized serving weights (ops/quantize.py): int8 "
                        "stores GRU/dense matrices per-output-channel "
                        "symmetric int8 (~3.9x fewer weight bytes), bf16 "
                        "halves them; dequant happens at use inside each "
                        "rung's program, drift vs f32 is pinned by a parity "
                        "envelope stored next to the checkpoint (violations "
                        "raise; default off)")
    _add_device_arg(p)


def _add_sparse_args(p: argparse.ArgumentParser, serving: bool = False):
    where = ("the fused engine / shape ladder densifies on device"
             if serving else
             "the staged train feed densifies on device inside each "
             "update")
    p.add_argument("--sparse-feed", action="store_true",
                   help="sparse-first traffic pipeline (the 10k-endpoint "
                        "tier): ship per-window call-path counts as "
                        f"padded-COO (cols, vals) pairs — {where} "
                        "(ops/densify.py) — cutting host->device bytes "
                        "~F/(2K) at 10k width; bit-identical to the "
                        "dense default")
    p.add_argument("--sparse-nnz-cap", type=int, default=64, metavar="K",
                   help="max nonzero traffic columns per bucket under "
                        "--sparse-feed (the padded-COO row width); a "
                        "fatter row raises rather than dropping call "
                        "paths (default 64)")


def _superstep_arg(v: str):
    """``--steps-per-superstep`` parser: int >= 1, 'auto', or 'epoch'."""
    if v in ("auto", "epoch"):
        return v
    try:
        n = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{v!r} is not an int, 'auto', or 'epoch'")
    if n < 1:
        raise argparse.ArgumentTypeError(f"{v} must be >= 1")
    return n


def _ensure_npz(path: str) -> str:
    """np.savez appends '.npz' when missing — report the real filename."""
    return path if path.endswith(".npz") else path + ".npz"


def _kernel_launches() -> dict[str, int]:
    from deeprest_tpu_torch.ops.cuda_gru import MODEL_KERNELS

    return {k.name: k.launches for k in MODEL_KERNELS}


# -- host-only subcommands --------------------------------------------------


def cmd_simulate(args) -> int:
    from deeprest_tpu_torch.data.schema import (
        save_raw_data_jsonl, save_raw_data_pickle,
    )
    from deeprest_tpu_torch.workload.scenarios import SCENARIOS
    from deeprest_tpu_torch.workload.simulator import (
        build_shifted_app, build_synthetic_app, simulate_corpus,
        simulate_drift_corpus_iter, write_corpus_jsonl,
    )

    scenario = SCENARIOS[args.scenario](args.seed)
    if args.shift_at:
        # mid-corpus topology change (services added/removed)
        if args.app != "synthetic":
            sys.exit("error: --shift-at needs --app synthetic (the "
                     "social topology is fixed)")
        after_n = (args.services_after if args.services_after is not None
                   else args.services + max(args.services // 2, 1))
        before, after, endpoints = build_shifted_app(
            scenario, args.services, after_n, args.endpoints, args.seed)
        it = simulate_drift_corpus_iter(scenario, args.ticks,
                                        args.shift_at, before, after,
                                        endpoints)
        if args.out.endswith((".jsonl", ".jsl")):
            n = 0

            def counted():
                nonlocal n
                for b in it:
                    n += 1
                    yield b

            save_raw_data_jsonl(counted(), args.out)
        else:
            buckets = list(it)
            save_raw_data_pickle(buckets, args.out)
            n = len(buckets)
        print(json.dumps({"scenario": args.scenario, "buckets": n,
                          "app": args.app, "shift_at": args.shift_at,
                          "services": [args.services, after_n],
                          "out": args.out}))
        return 0
    app = endpoints = None
    if args.app == "synthetic":
        app, endpoints = build_synthetic_app(scenario, args.services,
                                             args.endpoints, args.seed)
    if args.out.endswith((".jsonl", ".jsl")):
        # streaming write: long corpora never accumulate in memory
        stats = write_corpus_jsonl(scenario, args.ticks, args.out,
                                   app=app, endpoints=endpoints)
        n = stats["buckets"]
    else:
        buckets = simulate_corpus(scenario, args.ticks, app=app,
                                  endpoints=endpoints)
        save_raw_data_pickle(buckets, args.out)
        n = len(buckets)
    print(json.dumps({"scenario": args.scenario, "buckets": n,
                      "app": args.app, "out": args.out}))
    return 0


def cmd_featurize(args) -> int:
    _require_input(args, features_ok=False)
    data = _load_features(args)
    written = data.save(args.out)
    print(json.dumps({
        "out": written,
        "buckets": int(data.traffic.shape[0]),
        "capacity": int(data.traffic.shape[1]),
        "observed_paths": data.space.num_observed,
        "metrics": data.metric_names,
    }))
    return 0


def _parse_metric_map(specs, metric_rule_cls):
    """``PROM_METRIC:RESOURCE[:MODE]`` specs → {metric: MetricRule}.

    None → None (use the cadvisor-style defaults).  An explicitly-empty
    list is honored (traces only, suppress all metrics) rather than
    silently falling back to the default.  Raises ValueError on bad
    entries — a typo'd mode must not silently average a cumulative
    counter into monotonically exploding values.
    """
    if specs is None:
        return None
    resource_map = {}
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3) or not all(parts):
            raise ValueError(f"bad --metric-map entry {spec!r} "
                             "(want prom_metric:resource[:gauge|counter])")
        mode = parts[2] if len(parts) == 3 else "gauge"
        if mode not in ("gauge", "counter"):
            raise ValueError(f"bad --metric-map mode {mode!r} in {spec!r} "
                             "(must be 'gauge' or 'counter')")
        resource_map[parts[0]] = metric_rule_cls(parts[1], mode)
    return resource_map


def cmd_ingest(args) -> int:
    """Jaeger/OTLP trace dumps + Prometheus range dumps (files, or live
    endpoints over a time range) → raw JSONL."""
    from deeprest_tpu_torch.data.ingest import (
        MetricRule, ingest_files, ingest_live,
    )
    from deeprest_tpu_torch.data.schema import save_raw_data_jsonl

    try:
        resource_map = _parse_metric_map(args.metric_map, MetricRule)
    except ValueError as exc:
        print(exc)
        return 2
    live = bool(args.jaeger_url or args.prom_url)
    if live and (args.traces or args.prom):
        print("ingest: --traces/--prom dumps and --jaeger-url/--prom-url "
              "are mutually exclusive sources")
        return 2
    if not live and not args.traces:
        print("ingest: need either --traces dump files or a live "
              "--jaeger-url/--prom-url")
        return 2
    if live:
        import time as _time

        end_s = args.end if args.end is not None else _time.time()
        start_s = (args.start if args.start is not None
                   else end_s - args.last_seconds)
        if start_s >= end_s:
            print(f"ingest: empty time range [{start_s}, {end_s})")
            return 2
        buckets = ingest_live(
            args.jaeger_url, args.prom_url, start_s, end_s,
            args.bucket_seconds, step_s=args.step_seconds,
            resource_map=resource_map,
            services=args.jaeger_services or None)
    else:
        buckets = ingest_files(args.traces, args.prom or [],
                               args.bucket_seconds,
                               resource_map=resource_map)
    if not buckets:
        print("ingest: no buckets produced (empty dumps or disjoint ranges)")
        return 1
    save_raw_data_jsonl(buckets, args.out)
    keys = sorted({(m.component, m.resource) for m in buckets[0].metrics})
    print(json.dumps({
        "out": args.out,
        "buckets": len(buckets),
        "traces": sum(len(b.traces) for b in buckets),
        "metric_keys": len(keys),
        "components": sorted({c for c, _ in keys}),
    }))
    return 0


def _checkpoint_space(ckpt_dir: str):
    """The CallPathSpace of a checkpoint's sidecar, read without restoring
    the model (no device); None when the checkpoint has none."""
    from deeprest_tpu_torch.data.featurize import CallPathSpace
    from deeprest_tpu_torch.train.checkpoint import load_sidecar

    space = load_sidecar(ckpt_dir).get("space")
    return None if space is None else CallPathSpace.from_dict(space)


def cmd_synthesize(args) -> int:
    from deeprest_tpu_torch.config import FeaturizeConfig
    from deeprest_tpu_torch.data.featurize import CallPathSpace
    from deeprest_tpu_torch.data.synthesize import TraceSynthesizer

    _require_input(args, features_ok=False)
    buckets = _load_buckets(args.raw)
    if args.ckpt_dir:
        # Use the checkpoint's training-time space so the synthesized
        # columns are exact for that model by construction.
        space = _checkpoint_space(args.ckpt_dir)
        if space is None:
            sys.exit("error: checkpoint has no feature space")
    else:
        space = CallPathSpace(config=FeaturizeConfig(
            capacity=args.capacity, round_to=args.round_to,
            hash_features=args.hash_features))
    synth = TraceSynthesizer(space).fit(buckets)
    mix = json.loads(args.mix)
    series = synth.synthesize_series([mix] * args.ticks, seed=args.seed)
    out = _ensure_npz(args.out)
    # Embed the space so `predict --features` can verify column identity
    # against the serving checkpoint (same contract as FeaturizedData.save);
    # a bare traffic array would silently bypass that guard.
    np.savez_compressed(
        out, traffic=series.astype(np.float32),
        space_json=np.frombuffer(
            json.dumps(space.to_dict()).encode(), dtype=np.uint8),
    )
    print(json.dumps({"out": out, "ticks": args.ticks,
                      "endpoints": synth.endpoints,
                      "capacity": int(space.capacity)}))
    return 0


# -- device subcommands -----------------------------------------------------


def cmd_train(args) -> int:
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.models.baselines import baseline_predictions
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.metrics import format_report
    from deeprest_tpu_torch.train.trainer import Trainer

    _require_input(args)
    t0 = time.perf_counter()
    data = _load_features(args)
    seconds = {"load": time.perf_counter() - t0}
    cfg = Config(
        model=ModelConfig(hidden_size=args.hidden_size,
                          dropout_rate=args.dropout,
                          compute_dtype=args.compute_dtype),
        train=TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                          window_size=args.window, learning_rate=args.lr,
                          train_split=args.split, seed=args.seed,
                          eval_stride=args.window,
                          checkpoint_dir=args.ckpt_dir or "",
                          steps_per_superstep=args.steps_per_superstep,
                          grad_accum_windows=args.grad_accum_windows,
                          grad_accum_mode=args.grad_accum_mode,
                          sparse_feed=args.sparse_feed,
                          sparse_nnz_cap=args.sparse_nnz_cap,
                          snapshot_every_steps=args.snapshot_every_steps,
                          snapshot_keep=args.snapshot_keep),
    )
    bundle = prepare_dataset(data, cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device=args.device)
    baselines = None
    if not args.no_baselines:
        t0 = time.perf_counter()
        baselines = baseline_predictions(data, bundle, device=trainer.device)
        seconds["baselines"] = time.perf_counter() - t0
    step_losses = []
    # The first epoch is traced (its kernel loads, capture and steady
    # steps); the Chrome trace lands in --profile-dir.
    profiler = None
    if args.profile_dir:
        import os

        import torch

        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    def stop_profiling():
        nonlocal profiler
        if profiler is not None:
            import os

            profiler.stop()
            path = os.path.join(args.profile_dir, "trace_epoch1.json")
            profiler.export_chrome_trace(path)
            profiler = None
            print(f"profiler trace written to {path}", flush=True)

    def on_epoch(result, state):
        stop_profiling()    # first epoch captured
        step_losses.append(trainer.last_epoch_losses.tolist())
        print(f"epoch {result.epoch}: train {result.train_loss:.4f} "
              f"test {result.test_loss:.4f}", flush=True)

    # Preemption-safe restarts: with --snapshot-every-steps and a cursor
    # snapshot on disk, running the same command again resumes the killed
    # run instead of starting over.
    resume = False
    if args.snapshot_every_steps and args.ckpt_dir:
        from deeprest_tpu_torch.train.checkpoint import latest_cursor_step

        resume = latest_cursor_step(args.ckpt_dir) is not None
        if resume:
            print(f"resuming preempted run from {args.ckpt_dir} "
                  "(newest cursor snapshot)", flush=True)
    t0 = time.perf_counter()
    try:
        if resume:
            _, history = trainer.resume_training(
                bundle, baseline_preds=baselines, on_epoch=on_epoch)
        else:
            _, history = trainer.fit(bundle, baseline_preds=baselines,
                                     on_epoch=on_epoch)
    finally:
        stop_profiling()    # a run with no epoch left still writes one
    seconds["fit"] = time.perf_counter() - t0
    if history:
        print(format_report(history[-1].report))
    else:
        print("resume point is already past the final epoch; nothing to do")
    print(f"steady-state throughput: "
          f"{trainer.throughput.steps_per_sec:.2f} steps/s")
    print(json.dumps({
        "epoch_losses": [h.train_loss for h in history],
        "test_losses": [h.test_loss for h in history],
        "step_losses": step_losses,
        "steps": trainer.global_step,
        "steps_per_sec": trainer.throughput.steps_per_sec,
        "report": history[-1].report if history else None,
        "ckpt_dir": args.ckpt_dir,
        "device": str(trainer.device),
        "kernel_launches": _kernel_launches(),
        "dispatches": trainer.dispatches,
        "replays": trainer.replays,
        "captures": trainer.captures,
        "resumed_from_step": trainer.resumed_from_step,
        "grad_accum_windows": cfg.train.grad_accum_windows,
        "steps_per_superstep": trainer.superstep_len,
        "seconds": seconds}))
    return 0


def _predictor(args):
    from deeprest_tpu_torch.config import InferConfig
    from deeprest_tpu_torch.serve.predictor import Predictor

    try:
        infer = InferConfig(fused=not args.no_fused_infer,
                            page_windows=args.infer_page_windows,
                            coalesce_pages=args.infer_coalesce_pages,
                            quant=args.quant)
    except ValueError as exc:
        sys.exit(f"error: {exc}")
    # model architecture comes from the checkpoint sidecar
    return Predictor.from_checkpoint(
        args.ckpt_dir, fused=infer.fused, page_windows=infer.page_windows,
        coalesce_pages=infer.coalesce_pages, quant=infer.quant,
        device=args.device)


def _serving_traffic(args, pred) -> np.ndarray:
    """Traffic features for serving, column-exact with the checkpoint.

    ``--features`` artifacts embed the space they were extracted with,
    which must equal the checkpoint's (matching width alone would let a
    permuted vocabulary through); ``--raw`` corpora are featurized against
    the *checkpoint's* space (the training vocabulary) directly.
    """
    if args.features and not args.raw:
        with np.load(_ensure_npz(args.features)) as z:
            traffic = np.asarray(z["traffic"])
            space_json = (bytes(z["space_json"]).decode()
                          if "space_json" in z else None)
        if space_json is not None and pred.space_dict is not None:
            embedded = json.loads(space_json)
            if embedded["vocabulary"] != pred.space_dict["vocabulary"]:
                sys.exit("error: the features file was extracted with a "
                         "different call-path vocabulary than the checkpoint "
                         "was trained on; re-featurize the raw corpus with "
                         "--raw (uses the checkpoint's space)")
    else:
        space = pred.space()
        if space is None:
            sys.exit("error: checkpoint has no feature space; featurize the "
                     "raw corpus with the training-time space and pass "
                     "--features instead of --raw")
        from deeprest_tpu_torch.data.featurize import featurize_buckets

        traffic = featurize_buckets(_load_buckets(args.raw),
                                    space=space).traffic
    if traffic.ndim != 2 or traffic.shape[1] != pred.feature_dim:
        sys.exit(f"error: feature dim {traffic.shape[1:]} != model "
                 f"{pred.feature_dim}")
    return traffic


def cmd_predict(args) -> int:
    _require_input(args)
    pred = _predictor(args)
    t0 = time.perf_counter()
    traffic = _serving_traffic(args, pred)
    seconds = {"traffic": time.perf_counter() - t0}
    out_path = _ensure_npz(args.out)
    t0 = time.perf_counter()
    out = pred.predict_series(traffic)                           # [T, E, Q]
    seconds["predict"] = time.perf_counter() - t0
    np.savez_compressed(out_path, predictions=out,
                        metric_names=np.array(pred.metric_names))
    print(json.dumps({"out": out_path, "steps": int(out.shape[0]),
                      "metrics": pred.metric_names,
                      "device": str(pred.device),
                      "kernel_launches": _kernel_launches(),
                      "seconds": seconds}))
    return 0


def cmd_stream(args) -> int:
    """Continuous retrain (train/stream.py): tail a growing raw-data JSONL,
    poll live Jaeger/Prometheus endpoints or listen for pushed span
    batches, fine-tune on the device every ``--refresh-buckets`` buckets
    and re-checkpoint; run again on the same ``--ckpt-dir`` it resumes.
    One JSON line per refresh, with the JAX CLI's keys plus ``device``,
    ``steps``, ``captures`` (CUDA graphs captured in the refresh),
    ``seconds`` (its stages) and ``kernel_launches``."""
    from deeprest_tpu_torch.config import (
        Config, EtlConfig, FeaturizeConfig, ModelConfig, QualityConfig,
        TrainConfig,
    )
    from deeprest_tpu_torch.train.stream import (
        BucketTailer, StreamConfig, StreamingTrainer,
    )

    if args.elastic:
        print("stream: --elastic is not ported yet: elastic remeshing "
              "comes with the multi-GPU work (ROADMAP queue 1, item 6)")
        return 2
    live = bool(args.jaeger_url or args.prom_url)
    wire = bool(args.wire_listen)
    if sum((bool(args.raw), live, wire)) != 1:
        print("stream: need exactly one source — --raw JSONL, live "
              "--jaeger-url/--prom-url endpoints, or a --wire-listen "
              "push receiver")
        return 2
    if wire and not args.sparse_feed:
        print("stream: --wire-listen requires the sparse feed "
              "(the firehose is sparse-first by design; drop "
              "--no-sparse-feed)")
        return 2
    if args.metric_map is not None and not live:
        print("stream: --metric-map only applies to the live "
              "Jaeger/Prometheus source, not --raw JSONL")
        return 2

    quality = None
    if args.drift_detect:
        quality = QualityConfig(
            enabled=True,
            sweep_every_buckets=args.drift_sweep_every,
            live_window=args.drift_live_window,
            reference_window=args.drift_reference_window,
            drift_enter=args.drift_enter, drift_exit=args.drift_exit,
            auto_retrain=not args.no_drift_auto_retrain,
            retrain_cooldown_buckets=args.drift_cooldown_buckets)
    cfg = Config(
        model=ModelConfig(feature_dim=args.capacity,
                          hidden_size=args.hidden_size,
                          compute_dtype=args.compute_dtype),
        train=TrainConfig(batch_size=args.batch_size, window_size=args.window,
                          learning_rate=args.lr, seed=args.seed,
                          eval_stride=1, eval_max_cycles=args.eval_holdout,
                          log_every_steps=0,
                          steps_per_superstep=args.steps_per_superstep,
                          grad_accum_windows=args.grad_accum_windows,
                          grad_accum_mode=args.grad_accum_mode,
                          sparse_feed=args.sparse_feed,
                          sparse_nnz_cap=args.sparse_nnz_cap,
                          snapshot_every_steps=args.snapshot_every_steps,
                          snapshot_keep=args.snapshot_keep),
        etl=EtlConfig(overlap=not args.no_etl_overlap,
                      queue_depth=args.etl_queue_depth),
        quality=quality or QualityConfig(),
    )
    st = StreamingTrainer(
        cfg,
        StreamConfig(refresh_buckets=args.refresh_buckets,
                     finetune_epochs=args.finetune_epochs,
                     history_max=args.history_max,
                     eval_holdout=args.eval_holdout,
                     poll_interval_s=args.poll_interval,
                     keep_checkpoints=args.keep_checkpoints),
        ckpt_dir=args.ckpt_dir,
        feature_config=FeaturizeConfig(hash_features=True,
                                       capacity=args.capacity,
                                       hash_seed=args.hash_seed),
        device=args.device,
    )
    receiver = None
    if live:
        from deeprest_tpu_torch.data.ingest import (
            LiveEndpointTailer, MetricRule,
        )

        try:
            rmap = _parse_metric_map(args.metric_map, MetricRule)
        except ValueError as exc:
            print(exc)
            return 2
        tailer = LiveEndpointTailer(
            jaeger_url=args.jaeger_url, prom_url=args.prom_url,
            bucket_s=args.bucket_seconds, resource_map=rmap)
    elif wire:
        from deeprest_tpu_torch.data.wire import (
            SpanFirehoseReceiver, parse_hostport,
        )

        host, port = parse_hostport(args.wire_listen)
        # The receiver featurizes in its connection threads against the
        # trainer's own CallPathSpace, so wire rows land in the ring
        # bit-identical to the tailer path.
        receiver = SpanFirehoseReceiver(
            host, port, space=st.space, sparse=True,
            queue_depth=args.wire_queue_depth).start()
        print(json.dumps({"wire_listen": "%s:%d" % receiver.address}),
              flush=True)
        tailer = receiver
    else:
        tailer = BucketTailer(args.raw)
    controller = None
    if quality is not None:
        from deeprest_tpu_torch.train.stream import DriftController

        controller = DriftController(st, quality)
    try:
        for r in st.run(tailer,
                        max_refreshes=args.max_refreshes or None,
                        deadline_s=args.deadline or None):
            rec = {
                "refresh": r.refresh, "buckets": r.num_buckets,
                "train_loss": round(r.train_loss, 6),
                "eval_loss": round(r.eval_loss, 6),
                "checkpoint": r.checkpoint_path,
                "trigger": r.trigger,
                "etl": {"stall_s": round(r.etl_stall_s, 4),
                        "lag_buckets": r.etl_lag_buckets,
                        "dropped": r.etl_dropped},
            }
            if receiver is not None:
                rec["wire"] = receiver.stats()
            if controller is not None and controller.monitor is not None:
                v = controller.monitor.verdicts()
                rec["quality"] = {"states": v.get("states"),
                                  "feature_drift":
                                      v["feature_drift"].get("state"),
                                  "psi": v["feature_drift"].get("psi"),
                                  **{k: controller.stats[k]
                                     for k in ("sweeps",
                                               "retrains_triggered")}}
            rec.update(device=str(st.device), steps=r.steps,
                       captures=r.captures, seconds=r.seconds,
                       kernel_launches=_kernel_launches())
            print(json.dumps(rec), flush=True)
    finally:
        tailer.close()
    return 0


def cmd_whatif(args) -> int:
    """What-if capacity estimation from the command line: a hypothetical
    traffic mix (optionally swept over a scale grid) → per-metric peak
    utilization, batched through the fused multi-scenario prediction
    pipeline (serve/whatif.py estimate_many / sweep)."""
    from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
    from deeprest_tpu_torch.serve.whatif import WhatIfEstimator

    pred = _predictor(args)
    space = pred.space()
    if space is None:
        sys.exit("error: checkpoint has no feature space; cannot fit the "
                 "what-if synthesizer from --raw")
    t0 = time.perf_counter()
    buckets = _load_buckets(args.raw)
    seconds = {"load": time.perf_counter() - t0}
    t0 = time.perf_counter()
    synth = TraceSynthesizer(space).fit(buckets)
    seconds["fit"] = time.perf_counter() - t0
    del buckets
    est = WhatIfEstimator(pred, synth)
    try:
        mix = {str(k): int(v) for k, v in json.loads(args.mix).items()}
    except (ValueError, AttributeError) as exc:
        sys.exit(f"error: --mix is not a JSON endpoint→count object: {exc}")
    unknown = sorted(set(mix) - set(est.endpoints))
    if unknown:
        sys.exit(f"error: unknown API endpoints {unknown} "
                 f"(known: {est.endpoints})")
    program = [mix] * args.ticks
    t0 = time.perf_counter()
    if args.sweep:
        try:
            factors = [float(f) for f in args.sweep.split(",")]
        except ValueError:
            sys.exit(f"error: --sweep {args.sweep!r} is not a "
                     "comma-separated list of scale factors")
        records = est.sweep(program, factors, seed=args.seed)
        result = {"ticks": args.ticks, "mix": mix, "sweep": records}
    else:
        bands = est.estimate(program, seed=args.seed)
        dm = pred.delta_mask
        peaks = {
            metric: {q: (max(float(np.max(s) - s[0]), 0.0)
                         if dm is not None and dm[e]
                         else float(np.max(s)))
                     for q, s in bands[metric].items()}
            for e, metric in enumerate(pred.metric_names)
        }
        result = {"ticks": args.ticks, "mix": mix, "peaks": peaks}
    seconds["estimate"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        result["out"] = args.out
    result.update(device=str(pred.device), kernel_launches=_kernel_launches(),
                  seconds=seconds)
    print(json.dumps(result))
    return 0


def cmd_anomaly(args) -> int:
    """Observed utilization against the traffic-justified band.  One line
    per metric report, then a JSON line with the device, the kernel
    launches and every report's score and first flag, then the JAX
    package's last line, ``{"flagged": [...]}``."""
    from deeprest_tpu_torch.serve.anomaly import AnomalyDetector

    _require_input(args)
    pred = _predictor(args)
    t0 = time.perf_counter()
    if args.features and not args.raw:
        from deeprest_tpu_torch.data.featurize import FeaturizedData

        data = FeaturizedData.load(_ensure_npz(args.features))
        # Same vocabulary-identity guard as `predict --features`: equal
        # width with a permuted vocabulary would silently produce bogus
        # anomaly reports.
        if (pred.space_dict is not None
                and data.space.to_dict()["vocabulary"]
                != pred.space_dict["vocabulary"]):
            sys.exit("error: the features file was extracted with a "
                     "different call-path vocabulary than the checkpoint "
                     "was trained on; re-featurize the raw corpus with "
                     "--raw (uses the checkpoint's space)")
    else:
        # featurize against the checkpoint's space for column exactness
        space = pred.space()
        if space is None:
            sys.exit("error: checkpoint has no feature space; pass --features")
        from deeprest_tpu_torch.data.featurize import featurize_buckets

        data = featurize_buckets(_load_buckets(args.raw), space=space)
    if list(data.metric_names) != list(pred.metric_names):
        sys.exit("error: corpus metrics do not match the checkpoint's")
    if data.traffic.shape[1] != pred.feature_dim:
        sys.exit(f"error: feature dim {data.traffic.shape[1]} != model "
                 f"{pred.feature_dim}")
    seconds = {"traffic": time.perf_counter() - t0}
    detector = AnomalyDetector(pred, tolerance=args.tolerance,
                               min_run=args.min_run)
    t0 = time.perf_counter()
    reports = detector.check(data.traffic, data.targets())
    seconds["check"] = time.perf_counter() - t0
    for r in reports:
        print(r)
    flagged = [r.metric for r in reports if r.flagged]
    print(json.dumps({
        "device": str(pred.device), "kernel_launches": _kernel_launches(),
        "seconds": seconds,
        "reports": [{"metric": r.metric, "score": r.score,
                     "flagged": r.flagged,
                     "first_flag_index": r.first_flag_index}
                    for r in reports]}))
    print(json.dumps({"flagged": flagged}))
    return 1 if flagged and args.fail_on_anomaly else 0


def cmd_export(args) -> int:
    """Checkpoint → portable inference artifact (serve/export.py): the
    forward program traced on the CPU with ``torch.export`` and its
    manifest.  ``--aot`` (serialized executables next to the checkpoint
    for fleet pool admission) is not ported."""
    if args.aot:
        sys.exit("error: --aot is not ported yet: serialized serving "
                 "executables belong to the fleet tier (ROADMAP queue 1, "
                 "item 7c)")
    from deeprest_tpu_torch.serve.export import export_predictor
    from deeprest_tpu_torch.serve.predictor import Predictor

    pred = Predictor.from_checkpoint(args.ckpt_dir, fused=False,
                                     device="cpu")
    out = export_predictor(pred, args.out)
    print(json.dumps({
        "out": out,
        "metrics": len(pred.metric_names),
        "feature_dim": pred.feature_dim,
        "window_size": pred.window_size,
    }))
    return 0


def _parse_tenant_weights(spec: str | None) -> dict[str, float] | None:
    """``a=3,b=1`` → {"a": 3.0, "b": 1.0} (None/empty → None)."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        name, _, w = part.partition("=")
        try:
            out[name.strip()] = float(w)
        except ValueError:
            raise ValueError(f"bad --tenant-weights entry {part!r} "
                             "(want name=weight)") from None
        if not name.strip() or out[name.strip()] <= 0:
            raise ValueError(f"bad --tenant-weights entry {part!r} "
                             "(weight must be > 0)")
    return out


def _load_autoscaler_module():
    """deploy/autoscaler.py is deployment-plane code living next to the
    manifests it rewrites (it imports no JAX); load it by path from the
    repo layout."""
    import importlib.util
    import os

    import deeprest_tpu_torch

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(
            deeprest_tpu_torch.__file__))), "deploy", "autoscaler.py")
    if not os.path.isfile(path):
        sys.exit(f"error: autoscaler module not found at {path}")
    spec = importlib.util.spec_from_file_location("deeprest_autoscaler", path)
    mod = importlib.util.module_from_spec(spec)
    # register BEFORE exec: the module's @dataclass decorators resolve
    # sys.modules[cls.__module__] at class-creation time
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _router_config(args):
    """The routing front's config from the ``serve`` flags, or None when
    the plane is a single engine (JAX's rule: ``--replicas`` > 1, an
    admission depth or tenant weights turn the router on)."""
    if not (args.replicas > 1 or args.admission_depth
            or args.tenant_weights):
        if args.autoscale:
            sys.exit("error: --autoscale needs --replicas > 1 (the router "
                     "is the autoscaler's actuator)")
        return None
    from deeprest_tpu_torch.serve.router import RouterConfig

    try:
        weights = _parse_tenant_weights(args.tenant_weights)
    except ValueError as exc:
        sys.exit(f"error: {exc}")
    if args.replica_timeout_ms < 0:
        sys.exit(f"error: --replica-timeout-ms "
                 f"{args.replica_timeout_ms} must be >= 0 (0 = none)")
    try:
        return RouterConfig(
            admission_depth=args.admission_depth or 64,
            max_wait_s=args.admission_wait_ms / 1e3,
            retry_after_s=args.admission_retry_after_ms / 1e3,
            tenant_weights=weights,
            replica_timeout_s=(args.replica_timeout_ms / 1e3
                               if args.replica_timeout_ms else None),
            eject_after_failures=args.eject_after_failures,
            retry_budget=args.retry_budget)
    except ValueError as exc:
        sys.exit(f"error: {exc}")


def cmd_serve(args) -> int:
    """Serve predict / what-if / anomaly over HTTP from a checkpoint or an
    exported artifact (serve/server.py), with cross-request micro-batching
    on by default (serve/batcher.py; disable with --no-batcher).  Every rung graph is
    captured before the socket listens; with --watch a newer checkpoint
    step is loaded and warmed in the background, then swapped in.  With
    --replicas N the backend becomes a routing front over N engine
    replicas (serve/router.py): least-outstanding-work dispatch, bounded
    admission (--admission-depth → fast 429 + Retry-After), per-tenant
    weighted round-robin on the X-Tenant header, health ejection and
    retry, zero-downtime rolling reload under --watch, and an optional
    self-sizing control loop (--autoscale, deploy/autoscaler.py).  Process
    replicas build and warm their own stacks; the front then loads no
    model."""
    from deeprest_tpu_torch import obs
    from deeprest_tpu_torch.serve.batcher import BatcherConfig
    from deeprest_tpu_torch.serve.server import (
        CheckpointReloader, PredictionServer, PredictionService,
    )

    if bool(args.ckpt_dir) == bool(args.artifact):
        sys.exit("error: provide exactly one of --ckpt-dir or --artifact")
    try:
        ladder = tuple(int(r) for r in args.batch_ladder.split(","))
    except ValueError:
        sys.exit(f"error: --batch-ladder {args.batch_ladder!r} is not a "
                 "comma-separated list of window counts")
    if not ladder or min(ladder) < 1:
        sys.exit(f"error: --batch-ladder {args.batch_ladder!r}: rungs must "
                 "be >= 1")
    if args.batch_coalesce_groups < 1:
        sys.exit(f"error: --batch-coalesce-groups "
                 f"{args.batch_coalesce_groups} must be >= 1")
    batching = None
    if not args.no_batcher:
        top = max(ladder) * args.batch_coalesce_groups
        if args.batch_max_windows > top:
            sys.exit(f"error: --batch-max-windows {args.batch_max_windows} "
                     f"exceeds the top (coalesced) ladder rung {top}")
        batching = BatcherConfig(max_batch=args.batch_max_windows,
                                 max_linger_s=args.batch_linger_ms / 1e3)
    if args.watch and not args.ckpt_dir:
        sys.exit("error: --watch requires --ckpt-dir (artifacts are "
                 "immutable; re-export and restart instead)")
    if args.watch < 0:
        sys.exit(f"error: --watch {args.watch} must be >= 0")
    if args.obs_span_capacity < 1:
        sys.exit(f"error: --obs-span-capacity {args.obs_span_capacity} "
                 "must be >= 1")
    obs.configure(enabled=not args.no_obs,
                  span_capacity=args.obs_span_capacity)
    router_cfg = _router_config(args)
    process = router_cfg is not None and args.replica_mode == "process"
    from deeprest_tpu_torch.config import InferConfig
    from deeprest_tpu_torch.serve.predictor import Predictor

    try:
        infer = InferConfig(fused=not args.no_fused_infer,
                            page_windows=args.infer_page_windows,
                            coalesce_pages=args.infer_coalesce_pages,
                            sparse_feed=args.sparse_feed,
                            sparse_nnz_cap=args.sparse_nnz_cap,
                            quant=args.quant)
    except ValueError as exc:
        sys.exit(f"error: {exc}")
    knobs = dict(ladder=ladder, fused=infer.fused,
                 page_windows=infer.page_windows,
                 coalesce_pages=infer.coalesce_pages,
                 coalesce_groups=args.batch_coalesce_groups,
                 quant=infer.quant, device=args.device)
    seconds = {}
    reloader = None
    sparse = (dict(sparse_feed=infer.sparse_feed,
                   sparse_nnz_cap=infer.sparse_nnz_cap)
              if args.ckpt_dir else {})
    if args.ckpt_dir:
        backend = f"checkpoint:{args.ckpt_dir}"
        if args.watch:
            # Built BEFORE the initial load: a checkpoint the live trainer
            # writes while we load would otherwise be recorded as already
            # served and never reloaded.  A process plane's workers load
            # the new step themselves, so its front only watches.
            reloader = CheckpointReloader(
                args.ckpt_dir, min_interval_s=args.watch, load=not process,
                **knobs, **sparse)
            backend += " (watching)"
    else:
        backend = f"artifact:{args.artifact}"
    autoscaler = None
    if process:
        from deeprest_tpu_torch.serve.router import ReplicaRouter

        # -- worker-process replicas: each rebuilds and warms its stack
        spec = {"ckpt_dir": args.ckpt_dir, "artifact": args.artifact,
                "device": args.device or "cuda",
                "kwargs": {k: v for k, v in {**knobs, **sparse}.items()
                           if k != "device"}}
        t0 = time.perf_counter()
        pred = ReplicaRouter.build_process(
            spec, args.replicas, config=router_cfg, batching=batching)
        seconds["boot"] = time.perf_counter() - t0
        boots = [r.boot_info() for r in pred.replicas]
        graphs = [b["graphs"] for b in boots]
        seconds["workers"] = [b["seconds"] for b in boots]
        device, quant, parity_max = spec["device"], infer.quant, None
    else:
        t0 = time.perf_counter()
        if args.ckpt_dir:
            pred = Predictor.from_checkpoint(args.ckpt_dir, **knobs, **sparse)
        else:
            from deeprest_tpu_torch.serve.export import ExportedPredictor

            pred = ExportedPredictor.load(args.artifact, **knobs)
        seconds["load"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graphs = pred.warm()
        seconds["warm"] = time.perf_counter() - t0
        device, quant = str(pred.device), pred.quant
        parity_max = (max(pred.parity_envelope["measured"].values())
                      if pred.parity_envelope else None)
        if router_cfg is not None:
            from deeprest_tpu_torch.serve.router import ReplicaRouter

            # -- engine replicas: one shared stack on each card
            pred = ReplicaRouter.build(pred, args.replicas,
                                       config=router_cfg, batching=batching)
    if router_cfg is not None:
        batching = None          # the router owns per-replica batchers
        backend = f"{backend} x{args.replicas} ({args.replica_mode})"
        if args.autoscale:
            mod = _load_autoscaler_module()
            autoscaler = mod.Autoscaler(
                pred,
                mod.AutoscalerConfig(
                    min_replicas=args.autoscale_min,
                    max_replicas=args.autoscale_max,
                    interval_s=args.autoscale_interval,
                    capacity_rps_per_replica=args.autoscale_rps_per_replica),
                manifest_path=args.autoscale_manifest or None).start()

    synthesizer = None
    if args.raw:
        from deeprest_tpu_torch.data.synthesize import TraceSynthesizer

        space = pred.space()
        if space is None:
            sys.exit("error: model has no feature space; cannot fit the "
                     "what-if synthesizer from --raw")
        t0 = time.perf_counter()
        synthesizer = TraceSynthesizer(space).fit(_load_buckets(args.raw))
        seconds["fit"] = time.perf_counter() - t0

    surface_cfg = None
    if args.surface:
        from deeprest_tpu_torch.config import SurfaceConfig

        if synthesizer is None:
            sys.exit("error: --surface needs --raw (capacity surfaces are "
                     "built through the what-if synthesizer)")
        try:
            surface_cfg = SurfaceConfig(
                enabled=True,
                grid=tuple(float(x)
                           for x in args.surface_grid.split(",") if x),
                max_axes=args.surface_max_axes,
                jitter=args.surface_jitter,
                max_surfaces=args.surface_max_surfaces,
                max_bytes=int(args.surface_max_bytes_mb * 1024 * 1024),
                warm_async=not args.surface_sync)
        except ValueError as e:
            sys.exit(f"error: {e}")

    service = PredictionService(pred, synthesizer, backend=backend,
                                reloader=reloader, batching=batching,
                                surface=surface_cfg)
    verdict_wire = args.verdict_wire_listen
    if args.verdict_raw and verdict_wire:
        sys.exit("error: --verdict-raw and --verdict-wire-listen are "
                 "alternative verdict-corpus sources; pick one")
    vtailer = None
    if args.verdict_raw or verdict_wire:
        from deeprest_tpu_torch.config import QualityConfig
        from deeprest_tpu_torch.obs.quality import QualityMonitor
        from deeprest_tpu_torch.serve.server import VerdictIngestor
        from deeprest_tpu_torch.train.stream import BucketTailer

        space = pred.space()
        if space is None:
            sys.exit("error: model has no feature space; the verdict "
                     "surface needs the training-time call-path space to "
                     "featurize the tailed corpus")
        monitor = QualityMonitor(
            list(pred.metric_names),
            QualityConfig(enabled=True,
                          sweep_every_buckets=args.verdict_sweep_every,
                          live_window=args.verdict_live_window))
        if verdict_wire:
            from deeprest_tpu_torch.data.wire import (
                SpanFirehoseReceiver, parse_hostport,
            )

            # Bucket-mode receiver: the VerdictIngestor featurizes the
            # buckets itself, so the wire stays a transport here.
            whost, wport = parse_hostport(verdict_wire)
            vtailer = SpanFirehoseReceiver(whost, wport).start()
            service.attach_wire(vtailer)
        else:
            vtailer = BucketTailer(args.verdict_raw)
        ingestor = VerdictIngestor(service, vtailer,
                                   space, monitor).start()
        service.attach_quality(monitor, ingestor)
    server = PredictionServer(service, host=args.host, port=args.port)
    host, port = server.address
    print(json.dumps({"listening": f"http://{host}:{port}",
                      "backend": backend,
                      "whatif": synthesizer is not None,
                      "surface": ({"grid": list(surface_cfg.grid),
                                   "max_axes": surface_cfg.max_axes,
                                   "jitter": surface_cfg.jitter,
                                   "max_surfaces": surface_cfg.max_surfaces,
                                   "max_bytes": surface_cfg.max_bytes}
                                  if surface_cfg is not None else None),
                      "replicas": args.replicas, "fleet": None,
                      "autoscale": autoscaler is not None,
                      "verdict": ({"raw": args.verdict_raw,
                                   "wire": ("%s:%d" % vtailer.address
                                            if verdict_wire else None),
                                   "sweep_every": args.verdict_sweep_every}
                                  if vtailer is not None else None),
                      "obs": {"spans": not args.no_obs,
                              "span_capacity": args.obs_span_capacity,
                              "metrics": "/metrics"},
                      "batching": (None if args.no_batcher else {
                          "max_batch": args.batch_max_windows,
                          "max_linger_ms": args.batch_linger_ms,
                          "ladder": list(ladder),
                      }),
                      "quant": quant, "quant_parity_max": parity_max,
                      "sparse_feed": bool(sparse.get("sparse_feed")),
                      "device": device, "graphs": graphs,
                      "seconds": seconds}), flush=True)
    try:
        if args.deadline:
            server.start()
            time.sleep(args.deadline)
        else:
            server.serve_forever()
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        server.stop()
    return 0


def cmd_profile(args) -> int:
    """Open a torch.profiler capture window on a RUNNING serving plane
    (POST /v1/profile, obs/profiler.py): the server keeps answering
    traffic on its other handler threads while the window is open, so the
    trace shows the plane under its live load.  The server writes a
    Chrome trace into --out-dir on its host."""
    import urllib.error
    import urllib.request

    if args.seconds <= 0:
        sys.exit(f"error: --seconds {args.seconds} must be > 0")
    payload = {"seconds": args.seconds}
    if args.out_dir:
        payload["out_dir"] = args.out_dir
    req = urllib.request.Request(
        args.url.rstrip("/") + "/v1/profile",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req,
                                    timeout=args.seconds + 60.0) as resp:
            body = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode(errors="replace")[:300]
        sys.exit(f"error: server answered {exc.code}: {detail}")
    except (urllib.error.URLError, OSError) as exc:
        sys.exit(f"error: cannot reach {args.url}: {exc}")
    print(json.dumps(body))
    return 0


# -- parser -----------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deeprest_tpu_torch",
        description="API-aware resource estimation, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate a raw corpus (no cluster)")
    from deeprest_tpu_torch.workload.scenarios import SCENARIOS

    p.add_argument("--scenario", choices=sorted(SCENARIOS), default="normal")
    p.add_argument("--ticks", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="raw_data.jsonl")
    p.add_argument("--app", choices=("social", "synthetic"), default="social",
                   help="topology: the 12-service social network or a seeded "
                        "synthetic service DAG (TrainTicket scale)")
    p.add_argument("--services", type=int, default=40,
                   help="synthetic app: number of services")
    p.add_argument("--endpoints", type=int, default=12,
                   help="synthetic app: number of API endpoints")
    p.add_argument("--shift-at", type=int, default=0,
                   help="mid-corpus topology change: buckets at/after "
                        "this index generate from a re-drawn synthetic "
                        "topology with --services-after services (0 = no "
                        "shift)")
    p.add_argument("--services-after", type=int, default=None,
                   help="post-shift service count (default: --services "
                        "+ 50%%)")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("featurize", help="raw corpus → model-ready features")
    _add_input_args(p, features_ok=False)
    p.add_argument("--workers", type=int, default=1,
                   help="shard trace walking across a forked process pool "
                        "(0 = one per CPU, 1 = serial); bit-identical "
                        "output in both featurization modes")
    p.add_argument("--out", default="input.npz")
    p.set_defaults(fn=cmd_featurize)

    p = sub.add_parser(
        "ingest",
        help="Jaeger/OTLP + Prometheus (dumps or live endpoints) → raw "
             "corpus JSONL")
    p.add_argument("--traces", nargs="*", default=[],
                   help="Jaeger query-API or OTLP/JSON trace dump files")
    p.add_argument("--prom", nargs="*", default=[],
                   help="Prometheus query_range JSON dump files")
    p.add_argument("--jaeger-url", default=None,
                   help="live Jaeger query API base URL (e.g. "
                        "http://jaeger-query:16686)")
    p.add_argument("--prom-url", default=None,
                   help="live Prometheus base URL (e.g. "
                        "http://prometheus:9090)")
    p.add_argument("--start", type=float, default=None,
                   help="live pull range start (epoch seconds; default "
                        "end - --last-seconds)")
    p.add_argument("--end", type=float, default=None,
                   help="live pull range end (epoch seconds; default now)")
    p.add_argument("--last-seconds", type=float, default=3600.0,
                   help="live pull lookback when --start is omitted")
    p.add_argument("--step-seconds", type=float, default=None,
                   help="Prometheus query_range step (default: the bucket "
                        "width — scrape interval = bucket contract)")
    p.add_argument("--jaeger-services", nargs="*", default=None,
                   help="restrict the live Jaeger pull to these services "
                        "(default: discover via /api/services)")
    p.add_argument("--bucket-seconds", type=float, default=5.0,
                   help="discretization window (= the cluster's scrape "
                        "interval; the reference scrapes at 5s)")
    p.add_argument("--metric-map", nargs="*", default=None,
                   metavar="PROM_METRIC:RESOURCE[:MODE]",
                   help="override the cadvisor-style default metric map "
                        "(mode: gauge|counter)")
    p.add_argument("--out", default="raw_data.jsonl")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("train", help="train + eval vs both baselines")
    _add_input_args(p)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--window", type=int, default=60)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--split", type=float, default=0.40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden-size", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--steps-per-superstep", type=_superstep_arg,
                   default="auto", metavar="N|auto|epoch",
                   help="train steps per superstep; on a GPU a superstep "
                        "of N > 1 replays one captured CUDA graph per "
                        "optimizer update (1 = the eager per-step loop; "
                        "'epoch' = the whole epoch; 'auto' sizes it from "
                        "the logging cadence)")
    p.add_argument("--grad-accum-windows", type=int, default=1, metavar="G",
                   help="window-coalesced gradient accumulation: one "
                        "optimizer update per G consecutive microbatches "
                        "on summed grads (1 = per-step updates, default)")
    p.add_argument("--grad-accum-mode", default="exact",
                   choices=("exact", "flat", "loop"),
                   help="how the G microbatches run: 'exact' (default) is "
                        "bit-identical to the 'loop' reference of G "
                        "accumulating passes; 'flat' runs them as G*batch "
                        "rows through each recurrence launch (weight-grad "
                        "sums re-associate)")
    p.add_argument("--snapshot-every-steps", type=int, default=0,
                   metavar="N",
                   help="preemption-safe training: atomically checkpoint "
                        "the full state plus the epoch-plan cursor (epoch, "
                        "step offset, shuffle-rng state) into --ckpt-dir "
                        "every N real steps; running the same command again "
                        "after a kill resumes the run, as the uninterrupted "
                        "run would have gone on (0 = off)")
    p.add_argument("--snapshot-keep", type=int, default=3, metavar="K",
                   help="newest cursor snapshots kept (pruned only after a "
                        "durable newer save; checkpoints without a cursor "
                        "are never touched; 0 = keep everything)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the first epoch "
                        "(a Chrome trace, trace_epoch1.json, in this "
                        "directory)")
    p.add_argument("--no-baselines", action="store_true",
                   help="skip the ResourceAware and ComponentAware "
                        "baselines (the resrc and comp columns of the report)")
    _add_device_arg(p)
    _add_sparse_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("synthesize", help="what-if traffic feature synthesis")
    _add_input_args(p, features_ok=False)
    p.add_argument("--mix", required=True,
                   help='JSON {endpoint: count} per time step')
    p.add_argument("--ticks", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="use this checkpoint's feature space (column-exact "
                        "for that model)")
    p.add_argument("--out", default="synthetic.npz")
    p.set_defaults(fn=cmd_synthesize)

    p = sub.add_parser("stream",
                       help="tail a growing raw corpus (or poll live "
                            "Jaeger/Prometheus, or take pushed span "
                            "batches); fine-tune + re-checkpoint "
                            "continuously")
    p.add_argument("--raw", default=None,
                   help="raw-data JSONL being appended to (collector --out)")
    p.add_argument("--jaeger-url", default=None,
                   help="live Jaeger query API base URL (alternative "
                        "source to --raw)")
    p.add_argument("--prom-url", default=None,
                   help="live Prometheus base URL (alternative source "
                        "to --raw)")
    p.add_argument("--wire-listen", default=None, metavar="HOST:PORT",
                   help="push-based span firehose: listen for framed "
                        "span batches (data/wire.py protocol) and "
                        "featurize them straight into the sparse ring "
                        "— requires --sparse-feed")
    p.add_argument("--wire-queue-depth", type=int, default=256,
                   help="per-connection inflight frame budget before "
                        "the receiver sends SLOWDOWN (2x = fast-drop "
                        "with accounting, 4x drop streak = eviction)")
    p.add_argument("--bucket-seconds", type=float, default=5.0,
                   help="live-source discretization window (= scrape "
                        "interval)")
    p.add_argument("--metric-map", nargs="*", default=None,
                   metavar="PROM_METRIC:RESOURCE[:MODE]",
                   help="live-source metric map override "
                        "(default: cadvisor names; mode: gauge|counter)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--capacity", type=int, default=512,
                   help="hash-feature width (static model input dim)")
    p.add_argument("--hash-seed", type=int, default=0x5EED)
    p.add_argument("--window", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden-size", type=int, default=128)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--steps-per-superstep", type=_superstep_arg,
                   default="auto", metavar="N|auto|epoch",
                   help="train steps per superstep of the fine-tune "
                        "epochs (on a GPU one captured CUDA graph per "
                        "update, replayed; 1 = per-step loop)")
    p.add_argument("--grad-accum-windows", type=int, default=1, metavar="G",
                   help="fold G consecutive microbatches into one "
                        "optimizer update on summed grads (1 = per-step "
                        "updates, the default)")
    p.add_argument("--grad-accum-mode", default="exact",
                   choices=("exact", "flat", "loop"),
                   help="how the G microbatches fuse: 'exact' (default) "
                        "is bit-identical to the unfused accumulation "
                        "loop; 'flat' runs the G batches as one row batch "
                        "(weight-grad sums re-associate); 'loop' is the "
                        "unfused reference")
    p.add_argument("--snapshot-every-steps", type=int, default=0,
                   metavar="N",
                   help="preemption-safe fine-tuning: checkpoint the full "
                        "state + stream sidecar (frozen metric set, "
                        "stats, refresh counter, retained-ring "
                        "watermarks) every N fine-tune steps, so a "
                        "stream killed MID-refresh resumes at most N "
                        "steps stale instead of losing the refresh "
                        "(0 = off; refresh-end checkpoints always "
                        "happen)")
    p.add_argument("--elastic", action="store_true",
                   help="survive device loss in-process (elastic "
                        "remeshing; not ported: exits 2)")
    p.add_argument("--remesh-max-attempts", type=int, default=3,
                   metavar="N", help="elastic remeshing knob (not ported)")
    p.add_argument("--remesh-backoff-ms", type=float, default=100.0,
                   metavar="MS", help="elastic remeshing knob (not ported)")
    p.add_argument("--snapshot-keep", type=int, default=3, metavar="K",
                   help="newest cursor snapshots retained (0 = keep "
                        "everything)")
    _add_sparse_args(p)
    p.add_argument("--refresh-buckets", type=int, default=60,
                   help="fine-tune after this many new buckets")
    p.add_argument("--finetune-epochs", type=int, default=2)
    p.add_argument("--history-max", type=int, default=4096)

    def positive_int(v: str) -> int:
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError(f"{v} must be >= 1")
        return n

    p.add_argument("--keep-checkpoints", type=positive_int, default=3,
                   help="newest checkpoint steps retained (disk bound, "
                        ">= 1)")
    p.add_argument("--eval-holdout", type=int, default=8,
                   help="newest windows held out for eval each refresh")
    p.add_argument("--poll-interval", type=float, default=0.5)
    p.add_argument("--no-etl-overlap", action="store_true",
                   help="run tail→parse→featurize inline on the train "
                        "thread instead of the background ETL thread "
                        "(same refresh results; only the overlap differs)")
    p.add_argument("--etl-queue-depth", type=int, default=512,
                   help="buckets buffered between the ETL thread and the "
                        "train loop (backpressure bound)")
    p.add_argument("--max-refreshes", type=int, default=0,
                   help="stop after N refreshes (0 = run forever)")
    p.add_argument("--deadline", type=float, default=0,
                   help="stop after this many seconds (0 = no deadline)")
    p.add_argument("--drift-detect", action="store_true",
                   help="arm the online quality monitors + the "
                        "drift→retrain loop (obs/quality.py, "
                        "DriftController): streaming per-call-path "
                        "PSI/KS vs the training reference, rolling band "
                        "coverage/pinball, the continuous "
                        "not-justified-by-traffic check, and "
                        "auto-retrain on sustained drift")
    p.add_argument("--drift-sweep-every", type=int, default=30,
                   metavar="N", help="buckets between monitor sweeps")
    p.add_argument("--drift-live-window", type=int, default=120,
                   metavar="N",
                   help="trailing buckets the drift score compares "
                        "against the training reference")
    p.add_argument("--drift-reference-window", type=int, default=240,
                   metavar="N",
                   help="retained-ring tail re-anchored as the drift "
                        "reference after each (re)train")
    p.add_argument("--drift-enter", type=float, default=0.25,
                   help="weighted-PSI threshold entering the drift "
                        "verdict (sustained sweeps required — "
                        "hysteresis)")
    p.add_argument("--drift-exit", type=float, default=0.10,
                   help="weighted-PSI threshold exiting the drift "
                        "verdict")
    p.add_argument("--drift-cooldown-buckets", type=int, default=240,
                   metavar="N",
                   help="minimum buckets between drift-triggered "
                        "retrains")
    p.add_argument("--no-drift-auto-retrain", action="store_true",
                   help="manual override: verdicts only — sustained "
                        "drift never fires a retrain by itself")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("whatif",
                       help="hypothetical traffic mix → per-metric peak "
                            "utilization; --sweep runs a batched capacity-"
                            "sweep grid through the fused pipeline")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--raw", required=True,
                   help="raw corpus to fit the what-if trace synthesizer")
    p.add_argument("--mix", required=True,
                   help='JSON {endpoint: count} per time step')
    p.add_argument("--ticks", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sweep", default=None, metavar="F1,F2,...",
                   help="scale the mix by each factor and estimate ALL "
                        "scenarios in one batched prediction train "
                        "(e.g. 0.5,1,2,4)")
    p.add_argument("--out", default=None,
                   help="also write the full result JSON here")
    _add_fused_infer_args(p)
    p.set_defaults(fn=cmd_whatif)

    p = sub.add_parser("predict", help="checkpoint + traffic → utilization")
    _add_input_args(p)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", default="predictions.npz")
    _add_fused_infer_args(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("anomaly", help="traffic-justified utilization check")
    _add_input_args(p)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--tolerance", type=float, default=0.10)
    p.add_argument("--min-run", type=int, default=5)
    p.add_argument("--fail-on-anomaly", action="store_true")
    _add_fused_infer_args(p)
    p.set_defaults(fn=cmd_anomaly)

    p = sub.add_parser("export",
                       help="checkpoint → portable inference artifact "
                            "(torch.export program + JSON manifest)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--aot", action="store_true",
                   help="also serialize the fused serving executables next "
                        "to the checkpoint for fleet pool admission (not "
                        "ported: exits with an error)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve",
                       help="HTTP prediction service: predict / what-if / "
                            "anomaly")
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the in-process predictor from this checkpoint")
    p.add_argument("--watch", type=float, default=0, metavar="SECONDS",
                   help="hot-reload newer checkpoints, polling at most every "
                        "SECONDS (0 = off); a new step is loaded and its "
                        "graphs captured before it is swapped in")
    p.add_argument("--artifact", default=None,
                   help="serve the exported artifact from this directory")
    p.add_argument("--raw", default=None,
                   help="raw corpus to fit the what-if trace synthesizer")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2021)
    p.add_argument("--deadline", type=float, default=0,
                   help="stop after this many seconds (0 = run forever)")
    p.add_argument("--no-batcher", action="store_true",
                   help="disable cross-request micro-batching (each request "
                        "dispatches its own device batches; the shape "
                        "ladder still bounds the rung graphs)")
    p.add_argument("--batch-max-windows", type=int, default=64,
                   help="flush a coalesced batch at this many windows "
                        "(should equal the top ladder rung)")
    p.add_argument("--batch-linger-ms", type=float, default=2.0,
                   help="max time the first request in a batch waits for "
                        "co-arrivals before flushing")
    p.add_argument("--batch-ladder", default="8,16,32,64",
                   help="comma-separated window-count rungs every device "
                        "batch is padded up to (one captured CUDA graph "
                        "per rung)")
    p.add_argument("--batch-coalesce-groups", type=int, default=1,
                   metavar="G",
                   help="extend the ladder with top-rung*{2..G} "
                        "super-rungs so a deep cross-request backlog "
                        "dispatches one batch of top*G windows instead "
                        "of G sequential top-rung dispatches; raise "
                        "--batch-max-windows to match")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="engine replicas behind the routing front "
                        "(serve/router.py): each a full Predictor/"
                        "MicroBatcher/fused-engine stack on its own "
                        "device (replicas sharing a device share one "
                        "stack and its rung graphs), dispatched "
                        "least-outstanding-work; 1 = the single-engine "
                        "path")
    p.add_argument("--replica-mode", choices=("thread", "process"),
                   default="thread",
                   help="replica isolation: in-process threads (default) "
                        "or worker subprocesses that each rebuild the "
                        "full stack from --ckpt-dir/--artifact (their own "
                        "CUDA context and rung graphs)")
    p.add_argument("--admission-depth", type=int, default=0, metavar="N",
                   help="max concurrently admitted requests across the "
                        "plane; beyond it (plus a same-size bounded wait "
                        "queue) requests fail fast with 429 + Retry-After "
                        "instead of queueing into collapse (0 = default "
                        "64 when the router is on)")
    p.add_argument("--admission-wait-ms", type=float, default=250.0,
                   help="max time a request may wait in the fairness "
                        "queue for a slot before the 429")
    p.add_argument("--admission-retry-after-ms", type=float, default=50.0,
                   help="Retry-After hint sent with admission 429s")
    p.add_argument("--tenant-weights", default=None, metavar="a=3,b=1",
                   help="weighted round-robin shares per X-Tenant header "
                        "value (unknown tenants weigh 1)")
    p.add_argument("--replica-timeout-ms", type=float, default=30000.0,
                   metavar="MS",
                   help="per-request deadline on process replicas: a "
                        "worker dead between heartbeats becomes a typed "
                        "ReplicaDeadError instead of an indefinite pipe "
                        "recv (0 = no deadline)")
    p.add_argument("--eject-after-failures", type=int, default=3,
                   metavar="N",
                   help="consecutive dead-replica failures that eject a "
                        "replica from dispatch (a confirmed-dead worker "
                        "ejects immediately); the background probe "
                        "reboots process replicas and rejoins them")
    p.add_argument("--retry-budget", type=int, default=1, metavar="N",
                   help="max re-dispatches of ONE request onto survivor "
                        "replicas — only for failures proving the "
                        "request never produced a response (worker dead "
                        "/ send failed); deadline expiries on a live "
                        "worker are never retried (no double-execution)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the self-sizing control loop "
                        "(deploy/autoscaler.py): observed traffic -> "
                        "what-if capacity estimate -> router.scale_to; "
                        "decisions surface on /healthz under "
                        "router.autoscaler")
    p.add_argument("--autoscale-min", type=int, default=1)
    p.add_argument("--autoscale-max", type=int, default=8)
    p.add_argument("--autoscale-interval", type=float, default=10.0,
                   help="control-tick seconds")
    p.add_argument("--autoscale-rps-per-replica", type=float, default=None,
                   help="measured per-replica capacity basis (rps; "
                        "deeprest_tpu_torch/benchmarks/serve_bench.py "
                        "measures it)")
    p.add_argument("--autoscale-manifest", default=None, metavar="PATH",
                   help="mirror decisions into this k8s manifest's "
                        "deeprest-predictor Deployment spec.replicas "
                        "(deploy/k8s/predictor.yaml)")
    p.add_argument("--no-obs", action="store_true",
                   help="disable span recording; /metrics and its counters "
                        "stay live, only the trace ring is gated")
    p.add_argument("--obs-span-capacity", type=int, default=4096,
                   metavar="N",
                   help="bound on retained spans (newest win; GET "
                        "/v1/spans exports them as Jaeger JSON)")
    p.add_argument("--surface", action="store_true",
                   help="arm the capacity-surface plane (serve/surface.py; "
                        "needs --raw): in-space /v1/whatif reads answer by "
                        "multilinear interpolation over precomputed "
                        "surfaces, POST /v1/whatif/surface serves sweep-"
                        "style peak queries, and every reload invalidates "
                        "the cache eagerly")
    p.add_argument("--surface-grid", default="0.5,1,2,4", metavar="S,S,...",
                   help="per-axis scale ladder a surface sweeps around its "
                        "base traffic program")
    p.add_argument("--surface-max-axes", type=int, default=3, metavar="K",
                   help="max independent per-endpoint scale axes (more "
                        "active endpoints collapse to one shared axis; "
                        "vertex count is len(grid)**K)")
    p.add_argument("--surface-jitter", type=int, default=8, metavar="N",
                   help="Monte-Carlo probe mixes per build, held out of the "
                        "grid; they measure the surface-vs-direct parity "
                        "envelope reported on /healthz")
    p.add_argument("--surface-max-surfaces", type=int, default=8,
                   metavar="N",
                   help="LRU bound on resident surfaces")
    p.add_argument("--surface-max-bytes-mb", type=float, default=64.0,
                   metavar="MB",
                   help="host-byte budget across resident surfaces "
                        "(oversized mix spaces refuse to build and answer "
                        "from the frontier instead)")
    p.add_argument("--surface-sync", action="store_true",
                   help="build cache-miss surfaces inline instead of on a "
                        "background warm thread (first query pays the "
                        "build)")
    p.add_argument("--verdict-raw", default=None, metavar="PATH",
                   help="arm the streaming verdict surface (GET "
                        "/v1/verdict): tail this growing collector JSONL, "
                        "featurize against the served model's call-path "
                        "space, and run the online quality monitors "
                        "(drift PSI/KS, band coverage/pinball, the "
                        "continuous not-justified-by-traffic check) — "
                        "the streaming replacement for the batch anomaly "
                        "CLI")
    p.add_argument("--verdict-wire-listen", default=None,
                   metavar="HOST:PORT",
                   help="arm the verdict surface from a push firehose "
                        "instead of a tailed JSONL: listen for framed "
                        "span batches (data/wire.py) and feed them to "
                        "the VerdictIngestor — alternative to "
                        "--verdict-raw")
    p.add_argument("--verdict-sweep-every", type=int, default=30,
                   metavar="N",
                   help="buckets between verdict-surface monitor sweeps")
    p.add_argument("--verdict-live-window", type=int, default=120,
                   metavar="N",
                   help="trailing buckets in the drift live window (also "
                        "the auto-arm reference size)")
    _add_fused_infer_args(p)
    _add_sparse_args(p, serving=True)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("profile",
                       help="open a torch.profiler capture window on a "
                            "running serving plane (POST /v1/profile); "
                            "inspect the Chrome trace in Perfetto")
    p.add_argument("--url", default="http://127.0.0.1:2021",
                   help="base URL of the running `serve` plane")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="capture window length (server bounds it)")
    p.add_argument("--out-dir", default=None,
                   help="trace directory on the SERVER host (default: a "
                        "server-side temp dir, echoed back)")
    p.set_defaults(fn=cmd_profile)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
