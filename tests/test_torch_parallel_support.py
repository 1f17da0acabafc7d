"""Importable-by-name helpers of tests/test_torch_parallel.py and
tests/test_torch_parallel_axes.py: a gloo job of spawned ranks on the CPU,
and the training scenarios each rank runs.

It imports numpy and the port only, never JAX or the JAX package, so a
spawned rank that loads it (the spawn's ``sys_path`` carries the tests
directory into the child) loads neither.  ``spec.json`` holds the job's
``mesh`` (``[data, expert, model]``, default every rank on the data axis)
and its ``scenarios``.  A scenario is a dict of ``model`` and ``train``
config fields plus ``epochs`` and, for a resume, ``resume`` (the snapshot
directory); :func:`run_scenario` runs it on a ``Trainer`` from the params
in ``params.npz`` and returns its per-step losses, test losses, final
params gathered whole (``params/*``), the rank's own boxes of them
(``local/*``), with ``grads`` the first update's gradients gathered whole
(``grads/*``), with ``save`` a checkpoint of the final state written
there, and the checks only a rank can make.  A scenario with ``restore``
(a checkpoint directory) restores it instead and returns its params; one
with ``predict`` (a checkpoint directory) serves the corpus's traffic
through ``Predictor.from_checkpoint`` on the job's mesh and returns the
answer.
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
        import torch
        import torch.distributed as dist

        # the ranks share the host's cores: one intra-op thread each keeps
        # them from thrashing one another between collectives
        torch.set_num_threads(1)

        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import (
            initialize_distributed, make_mesh,
        )

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        d, e, m = spec.get("mesh", (world, 1, 1))
        mesh = make_mesh(MeshConfig(data=d, expert=e, model=m), device="cpu")
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


def _whole(mesh, tensors, model_config) -> dict:
    """Each rank's boxes gathered whole (the tensors as they are without a
    mesh), as numpy."""
    from deeprest_tpu_torch.models.qrnn import param_shapes
    from deeprest_tpu_torch.parallel.sharding import gather_params

    if mesh is not None:
        tensors = gather_params(mesh, tensors, param_shapes(model_config))
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def run_predict(workdir: str, scenario: dict, mesh=None) -> dict:
    """The corpus's traffic through the predictor of checkpoint
    ``scenario["predict"]`` on ``mesh``'s shape (None: one process)."""
    from deeprest_tpu_torch.serve.predictor import Predictor

    pred = Predictor.from_checkpoint(
        scenario["predict"], device="cpu",
        mesh_config=None if mesh is None else mesh.config)
    traffic = load_corpus(workdir).traffic
    return {"answer": pred.predict_series(traffic),
            "many": pred.predict_series_many([traffic[:40], traffic[7:]])[1],
            "digest": np.asarray(pred.params_digest())}


def run_tenk(mesh=None) -> dict:
    """``tests/test_parallel.py``'s F=10240 case on this process's mesh:
    E=4, H=128, W=8, B=8, f32, dropout 0, seeded random windows, one epoch
    and an evaluation."""
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.data.windows import MinMaxStats
    from deeprest_tpu_torch.train.data import DatasetBundle
    from deeprest_tpu_torch.train.trainer import Trainer

    f, e, h, w, b = 10240, 4, 128, 8, 8
    rng = np.random.default_rng(0)
    names = [f"c{i}_cpu" for i in range(e)]
    bundle = DatasetBundle(
        x_train=rng.random((b, w, f)).astype(np.float32),
        y_train=rng.random((b, w, e)).astype(np.float32),
        x_test=rng.random((2 * w, w, f)).astype(np.float32),
        y_test=rng.random((2 * w, w, e)).astype(np.float32),
        x_stats=MinMaxStats(min=np.float32(0), max=np.float32(1)),
        y_stats=MinMaxStats(min=np.zeros((1, e), np.float32),
                            max=np.ones((1, e), np.float32)),
        metric_names=names, split=b, window_size=w)
    cfg = Config(model=ModelConfig(hidden_size=h, dropout_rate=0.0),
                 train=TrainConfig(batch_size=b, window_size=w,
                                   eval_stride=w, eval_max_cycles=2,
                                   log_every_steps=0, steps_per_superstep=1))
    trainer = Trainer(cfg, f, names, device=None if mesh else "cpu",
                      mesh=mesh)
    state = trainer.init_state()
    state, loss = trainer.train_epoch(state, bundle,
                                      np.random.default_rng(1))
    evaluated, _ = trainer.evaluate(state, bundle)
    whole = _whole(mesh, {"mask_w2": state.params["mask_w2"]},
                   trainer.model_config)
    return {"loss": np.asarray(loss), "eval": np.asarray(evaluated),
            "mask_w2": whole["mask_w2"],
            "w_ih_box": np.asarray(state.params["gru_fwd_w_ih"].shape)}


def run_scenario(workdir: str, scenario: dict, mesh=None) -> dict:
    """One scenario on this process's mesh (None: the one-process
    trainer, no group)."""
    import torch

    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.obs import metrics as obs_metrics
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    if scenario.get("predict"):
        return run_predict(workdir, scenario, mesh)
    if scenario.get("tenk"):
        return run_tenk(mesh)
    cfg = Config(model=ModelConfig(**scenario["model"]),
                 train=TrainConfig(**scenario["train"]))
    bundle = prepare_dataset(load_corpus(workdir), cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device=None if mesh is not None else "cpu", mesh=mesh)
    if scenario.get("restore"):
        state, _ = trainer.restore_state(scenario["restore"])
        out = {f"params/{k}": v for k, v in _whole(
            mesh, state.params, trainer.model_config).items()}
        out["step"] = np.asarray(state.step)
        return out
    losses = []
    grads = {}

    def on_epoch(result, state):
        losses.append(trainer.last_epoch_losses)

    def on_step(global_step):
        if scenario.get("grads") and global_step == 1 and not grads:
            grads.update(_whole(mesh, {
                n: p.grad for n, p in trainer_state.model.named_parameters()},
                trainer.model_config))

    if scenario.get("resume"):
        state, hist = trainer.resume_training(
            bundle, scenario["resume"], on_epoch=on_epoch,
            num_epochs=scenario["epochs"])
    else:
        with np.load(os.path.join(workdir, "params.npz")) as z:
            params = {k: z[k] for k in z.files}
        trainer_state = trainer.init_state(params)
        state, hist = trainer.fit(bundle, state=trainer_state,
                                  on_epoch=on_epoch, on_step=on_step,
                                  num_epochs=scenario["epochs"])
    if scenario.get("save"):
        trainer.save(scenario["save"], state, bundle)
    out = {f"params/{k}": v for k, v in _whole(
        mesh, state.params, trainer.model_config).items()}
    out.update({f"local/{k}": v.detach().numpy().copy()
                for k, v in state.params.items()})
    out.update({f"grads/{k}": v for k, v in grads.items()})
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
