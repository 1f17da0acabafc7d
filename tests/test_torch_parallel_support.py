"""Importable-by-name helpers of tests/test_torch_parallel.py: a gloo job
of spawned ranks on the CPU, and the training scenarios each rank runs.

It imports numpy and the port only, never JAX or the JAX package, so a
spawned rank that loads it (the spawn's ``sys_path`` carries the tests
directory into the child) loads neither.  A scenario is a dict of
``model`` and ``train`` config fields plus ``epochs`` and, for a resume,
``resume`` (the snapshot directory); :func:`run_scenario` runs it on a
``Trainer`` from the params in ``params.npz`` and returns its per-step
losses, test losses, final params and the checks only a rank can make.
"""

import json
import multiprocessing
import os
import socket

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(world: int, workdir: str, timeout: float = 240.0) -> list[dict]:
    """Run every scenario of ``workdir/spec.json`` in a gloo job of
    ``world`` spawned ranks; returns each rank's results (``rank{r}.npz``
    read back as dicts of arrays).  A rank that fails or outlives
    ``timeout`` fails the job."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"gloo ranks exited {codes}; see "
                           f"{workdir}/rank*.log")
    return [read_results(os.path.join(workdir, f"rank{r}.npz"))
            for r in range(world)]


def read_results(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import sys
    import traceback

    log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import torch.distributed as dist

        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import (
            initialize_distributed, make_mesh,
        )

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        mesh = make_mesh(MeshConfig(data=world), device="cpu")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        out = {}
        for name, scenario in spec["scenarios"].items():
            for key, value in run_scenario(workdir, scenario, mesh).items():
                out[f"{name}/{key}"] = value
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def load_corpus(workdir: str):
    from deeprest_tpu_torch.data.featurize import FeaturizedData

    return FeaturizedData.load(os.path.join(workdir, "corpus.npz"))


def run_scenario(workdir: str, scenario: dict, mesh=None) -> dict:
    """One scenario on this process's mesh (None: the one-process
    trainer, no group)."""
    import torch

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.obs import metrics as obs_metrics
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(**scenario["model"]),
                 train=TrainConfig(**scenario["train"]))
    bundle = prepare_dataset(load_corpus(workdir), cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device=None if mesh is not None else "cpu", mesh=mesh)
    losses = []

    def on_epoch(result, state):
        losses.append(trainer.last_epoch_losses)

    if scenario.get("resume"):
        state, hist = trainer.resume_training(
            bundle, scenario["resume"], on_epoch=on_epoch,
            num_epochs=scenario["epochs"])
    else:
        with np.load(os.path.join(workdir, "params.npz")) as z:
            params = {k: z[k] for k in z.files}
        state, hist = trainer.fit(bundle, state=trainer.init_state(params),
                                  on_epoch=on_epoch,
                                  num_epochs=scenario["epochs"])
    out = {f"params/{k}": v.detach().numpy().copy()
           for k, v in state.params.items()}
    out["losses"] = np.concatenate(losses)
    out["test_losses"] = np.asarray([h.test_loss for h in hist])
    out["step"] = np.asarray(state.step)
    out["mesh_devices"] = np.asarray(obs_metrics.REGISTRY.gauge(
        "deeprest_train_mesh_devices").value())
    # a captured superstep (S > 1 on a CUDA device) under gloo raises
    trainer.device = torch.device("cuda")
    try:
        trainer._captured(2)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    out["captured_refusal"] = np.asarray(refused)
    return out
