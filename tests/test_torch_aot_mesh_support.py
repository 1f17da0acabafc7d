"""Importable-by-name helpers of tests/test_torch_aot_mesh.py.

It imports numpy and the port only, never JAX or the JAX package, so the
processes that load it load neither.

- :func:`write_checkpoint`, a small model (F=8, E=4, H=8, W=8, one delta
  metric) saved by the port's ``Trainer.save`` from its seeded init: a
  whole TrainState, which the JAX package's ``Predictor.from_checkpoint``
  restores too.
- :func:`aot_rank`, one rank of a spawned gloo job that loads each case of
  ``workdir/spec.json`` (a mesh, a quant mode and a checkpoint) as the
  fleet's mesh ``default``: ``Predictor.from_checkpoint(mesh_config=...)``,
  its plane on every rank, and a ``PredictorPool`` admitting it with the
  AOT check on.  Each rank writes, by case, the plane's
  ``engine_fingerprint``, the pool's ``aot.last_reason`` and the shapes of
  the weight leaves it holds to ``aot{rank}.json``.
"""

import json
import os
import sys
import types

import numpy as np

F, E, H, W = 8, 4, 8, 8


def write_checkpoint(directory: str, seed: int = 0) -> str:
    """The small model's step 0 (module docstring); returns the
    directory."""
    from deeprest_tpu_torch.config import Config, ModelConfig
    from deeprest_tpu_torch.data.windows import MinMaxStats
    from deeprest_tpu_torch.train.trainer import Trainer

    names = [f"c{i}_cpu" for i in range(E - 1)] + ["c0_usage"]
    trainer = Trainer(Config(model=ModelConfig(hidden_size=H,
                                               dropout_rate=0.0)),
                      F, names, device="cpu")
    bundle = types.SimpleNamespace(
        metric_names=names, window_size=W, feature_dim=F, space_dict=None,
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(1.0)),
        y_stats=MinMaxStats(min=np.zeros((E,), np.float32),
                            max=np.full((E,), 2.0, np.float32)),
        delta_mask=np.arange(E) == E - 1)
    trainer.save(str(directory), trainer.init_state(seed=seed), bundle)
    return str(directory)


def aot_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the AOT job (module docstring)."""
    import traceback

    log = open(os.path.join(workdir, f"aot{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import initialize_distributed
        from deeprest_tpu_torch.serve.aot import engine_fingerprint
        from deeprest_tpu_torch.serve.fleet import PredictorPool
        from deeprest_tpu_torch.serve.predictor import Predictor

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        out = {}
        for case, (mesh, quant, ckpt) in spec["cases"].items():
            pred = Predictor.from_checkpoint(
                ckpt, device="cpu", quant=quant,
                mesh_config=MeshConfig(*mesh))
            pred.params_digest()        # a collective on a sharded mesh
            plane = pred.fleet_plane()
            pool = PredictorPool(hbm_budget=1, aot=True)
            pool.admit("default", pred, ckpt)
            out[case] = {
                "fingerprint": engine_fingerprint(plane),
                "reason": pool.stats()["aot"]["last_reason"],
                "shapes": {k: list(t.shape)
                           for k, t in plane.bound_state().items()
                           if k.startswith("w.")}}
        with open(os.path.join(workdir, f"aot{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()
