"""Command-line entry point of the port (``deeprest_tpu/cli.py``, ``train``
and ``predict``):

    python -m deeprest_tpu_torch train --features=input.npz --ckpt-dir=ckpt --no-baselines
    python -m deeprest_tpu_torch predict --ckpt-dir=ckpt --features=input.npz --out=preds.npz

Runs on CUDA unless ``--device cpu`` asks for the CPU.  Each prints one JSON
object as its last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _ensure_npz(path: str) -> str:
    """np.savez appends '.npz' when missing — report the real filename."""
    return path if path.endswith(".npz") else path + ".npz"


def _predictor(args):
    from deeprest_tpu_torch.config import InferConfig
    from deeprest_tpu_torch.serve.predictor import Predictor

    try:
        infer = InferConfig(fused=not args.no_fused_infer,
                            page_windows=args.infer_page_windows,
                            coalesce_pages=args.infer_coalesce_pages)
    except ValueError as exc:
        sys.exit(f"error: {exc}")
    return Predictor.from_checkpoint(
        args.ckpt_dir, fused=infer.fused, page_windows=infer.page_windows,
        coalesce_pages=infer.coalesce_pages, device=args.device)


def _serving_traffic(args, pred) -> np.ndarray:
    """Traffic features column-exact with the checkpoint: a features file
    embeds the vocabulary it was extracted with, which must equal the
    checkpoint's (equal width alone would let a permuted vocabulary
    through)."""
    with np.load(_ensure_npz(args.features)) as z:
        traffic = np.asarray(z["traffic"])
        space_json = (bytes(z["space_json"]).decode()
                      if "space_json" in z else None)
    if space_json is not None and pred.space_dict is not None:
        embedded = json.loads(space_json)
        if embedded["vocabulary"] != pred.space_dict["vocabulary"]:
            sys.exit("error: the features file was extracted with a "
                     "different call-path vocabulary than the checkpoint "
                     "was trained on; re-featurize the raw corpus with the "
                     "checkpoint's space")
    if traffic.ndim != 2 or traffic.shape[1] != pred.feature_dim:
        sys.exit(f"error: traffic shape {traffic.shape} does not match the "
                 f"model's feature dim {pred.feature_dim}")
    return traffic


def _kernel_launches() -> dict[str, int]:
    from deeprest_tpu_torch.ops.cuda_gru import MODEL_KERNELS

    return {k.name: k.launches for k in MODEL_KERNELS}


def cmd_train(args) -> int:
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.featurize import FeaturizedData
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.metrics import format_report
    from deeprest_tpu_torch.train.trainer import Trainer

    if not args.no_baselines:
        sys.exit("error: the baselines (the ResourceAware MLP and the "
                 "ComponentAware scaler of models/baselines.py) are not "
                 "ported yet; pass --no-baselines")
    data = FeaturizedData.load(_ensure_npz(args.features))
    cfg = Config(
        model=ModelConfig(hidden_size=args.hidden_size,
                          dropout_rate=args.dropout,
                          compute_dtype=args.compute_dtype),
        train=TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                          window_size=args.window, learning_rate=args.lr,
                          train_split=args.split, seed=args.seed,
                          eval_stride=args.window,
                          checkpoint_dir=args.ckpt_dir or ""),
    )
    bundle = prepare_dataset(data, cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device=args.device)
    step_losses = []

    def on_epoch(result, state):
        step_losses.append(trainer.last_epoch_losses.tolist())
        print(f"epoch {result.epoch}: train {result.train_loss:.4f} "
              f"test {result.test_loss:.4f}", flush=True)

    _, history = trainer.fit(bundle, on_epoch=on_epoch)
    print(format_report(history[-1].report))
    print(f"steady-state throughput: "
          f"{trainer.throughput.steps_per_sec:.2f} steps/s")
    print(json.dumps({
        "epoch_losses": [h.train_loss for h in history],
        "test_losses": [h.test_loss for h in history],
        "step_losses": step_losses,
        "steps": trainer.global_step,
        "steps_per_sec": trainer.throughput.steps_per_sec,
        "report": history[-1].report,
        "ckpt_dir": args.ckpt_dir,
        "device": str(trainer.device),
        "kernel_launches": _kernel_launches()}))
    return 0


def cmd_predict(args) -> int:
    if args.raw is not None:
        sys.exit("error: --raw needs the featurizer, which the PyTorch port "
                 "does not have yet; featurize with `python -m deeprest_tpu "
                 "featurize` and pass --features")
    if args.features is None:
        sys.exit("error: provide --features")
    pred = _predictor(args)
    traffic = _serving_traffic(args, pred)
    out_path = _ensure_npz(args.out)
    out = pred.predict_series(traffic)                           # [T, E, Q]
    np.savez_compressed(out_path, predictions=out,
                        metric_names=np.array(pred.metric_names))
    print(json.dumps({"out": out_path, "steps": int(out.shape[0]),
                      "metrics": pred.metric_names,
                      "device": str(pred.device),
                      "kernel_launches": _kernel_launches()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="deeprest_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="train + eval on a featurized corpus")
    p.add_argument("--features", required=True,
                   help="featurized .npz (from `deeprest_tpu featurize`)")
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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run the "
                        "plain PyTorch path on the CPU)")
    p.add_argument("--no-baselines", action="store_true",
                   help="train without the baseline comparison (required: "
                        "the baselines are not ported yet)")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("predict", help="checkpoint + traffic → utilization")
    p.add_argument("--features", default=None,
                   help="featurized .npz (from `deeprest_tpu featurize`)")
    p.add_argument("--raw", default=None,
                   help="raw corpus (not supported by the port yet)")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", default="predictions.npz")
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
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run the "
                        "plain PyTorch path on the CPU)")
    p.set_defaults(fn=cmd_predict)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
