"""Demo CLI (``python -m deeprest_tpu.demo``'s commands and flags).

    python -m deeprest_tpu_torch.demo precompute --raw=corpus.jsonl \\
        --ckpt-dir=ckpt --out=results.json.gz [--ticks=120] [--quick] \\
        [--device=cpu]
    python -m deeprest_tpu_torch.demo serve --results=results.json.gz --port=2021

``precompute`` estimates every dataset of its grid through the port's
``Predictor`` on CUDA unless ``--device cpu`` asks for the CPU; its last
line is JSON (datasets, device, kernel launches, seconds).  ``serve`` is
host-only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_precompute(args) -> int:
    from deeprest_tpu_torch.cli import _kernel_launches, _load_buckets
    from deeprest_tpu_torch.data.featurize import featurize_buckets
    from deeprest_tpu_torch.demo.precompute import (
        DemoConfig, precompute_results, save_results,
    )
    from deeprest_tpu_torch.serve.predictor import Predictor

    t0 = time.perf_counter()
    predictor = Predictor.from_checkpoint(args.ckpt_dir, device=args.device)
    space = predictor.space()
    if space is None:
        sys.exit("error: checkpoint has no feature space; re-train first")
    buckets = _load_buckets(args.raw)
    observed = featurize_buckets(buckets, space=space)
    seconds = {"load": time.perf_counter() - t0}

    kwargs = {"ticks": args.ticks}
    if args.quick:   # small grid for smoke runs
        kwargs.update(shapes=("waves",), multipliers=(1, 3))
    cfg = DemoConfig(**kwargs)
    t0 = time.perf_counter()
    results = precompute_results(predictor, observed, buckets, cfg)
    seconds["precompute"] = time.perf_counter() - t0
    path = save_results(results, args.out)
    print(f"wrote {len(results['datasets'])} datasets -> {path}")
    print(json.dumps({"datasets": len(results["datasets"]), "out": path,
                      "device": str(predictor.device),
                      "kernel_launches": _kernel_launches(),
                      "seconds": seconds}))
    return 0


def cmd_serve(args) -> int:
    from deeprest_tpu_torch.demo.results import ResultsStore
    from deeprest_tpu_torch.demo.server import DemoServer

    store = ResultsStore.load(args.results)
    server = DemoServer(store, host=args.host, port=args.port)
    host, port = server.address
    print(f"demo at http://{host}:{port}/ "
          f"({len(store.datasets)} datasets)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    from deeprest_tpu_torch.cli import _add_device_arg

    ap = argparse.ArgumentParser(prog="deeprest_tpu_torch.demo")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("precompute", help="build the results artifact")
    p.add_argument("--raw", required=True, help="observed training corpus")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", default="results.json.gz")
    p.add_argument("--ticks", type=int, default=120)
    p.add_argument("--quick", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_precompute)

    p = sub.add_parser("serve", help="serve the demo UI")
    p.add_argument("--results", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2021)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
