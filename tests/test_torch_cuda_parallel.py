"""Data-parallel training (parallel/, the trainer's mesh) on the card.

Needs an NVIDIA GPU and nvcc (the updates launch K2 and K3, which have no
CPU mode); without CUDA every test here skips.  Run on the card (the
repository's conftest imports JAX, which the GPU machine does not have):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_parallel.py

- NCCL at world size 1, captured S=2 (the all-reduce inside the graph),
  bf16, dropout 0.5, 2 epochs: losses and params bit-equal to the trainer
  with no process group, K2 = K3 = 2 launches in the captured update.
- gloo at world size 2, two spawned processes on the one card, f32,
  dropout 0, eager: params bit-equal across the ranks and within JAX's
  sharded-training tolerances of world size 1 (losses rtol 2e-3, atol
  1e-5; params rtol 5e-3, atol 1e-4); a captured superstep under gloo
  raises.
- The expert and model axes, gloo at world size 2 on the one card: mesh
  1x2x1 with E=40 (K2 and K3 at 20 experts a rank, two launches a step,
  one a direction, on each rank) within the same tolerances of world size 1, its checkpoint
  saved per shard; the Predictor on mesh 1,1,2 (eager; captured rung
  graphs under gloo raise) within 1e-4 of scale of the one-process
  captured answer on that checkpoint, the same on both ranks.
- Elastic remeshing, gloo at world size 2 on the one card: bf16, dropout 0,
  a cursor snapshot every 2 steps, ``FaultInjector({3: 1})``: rank 1 leaves
  with DeviceLossError, rank 0 remeshes to 1,1,1, restores step 2 and
  finishes bit for bit a trainer with no process group resuming from that
  snapshot.
- ``serve --mesh 1,2,1``, gloo at world size 2 on the one card, bf16,
  eager: rank 0 fronts HTTP and rank 1 replays each device call;
  ``/v1/predict`` within 2e-2 of scale of the one-process captured
  answer, K1 launched as often on both ranks, both exit 0 at the deadline.
- ``serve --mesh 1,1,2 --quant int8 --watch``, gloo at world size 2 on the
  one card, bf16, eager: the answers before and after one reload within
  2e-2 of scale of the one-process int8 predictor of each step, the
  reloaded step's digest, K1 launched as often on both ranks, both exit 0
  at the deadline.
- A one-device clone of the 1,2,1 mesh predictor, gloo at world size 2 on
  the one card: rank 0 gathers the params through its front's mirrored
  ``GATHER`` (rank 1 joins it), and the clone, captured on ``cuda:0``,
  answers bit for bit as the one-process captured predictor.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.config import (
    Config, MeshConfig, ModelConfig, TrainConfig,
)
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.models.qrnn import init_params
from deeprest_tpu_torch.parallel import (
    Mesh, initialize_distributed, make_mesh,
)
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

F, E, H, W, T = 24, 5, 64, 12, 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the update launches K2 and K3, "
                    "which have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def corpus(metrics: int = E) -> FeaturizedData:
    rng = np.random.default_rng(0)
    traffic = rng.poisson(5.0, (T, F)).astype(np.float32)
    resources = {f"c{i}_cpu": (traffic @ rng.uniform(0.0, 1.0, F)
                               + rng.normal(0.0, 1.0, T)).astype(np.float32)
                 for i in range(metrics)}
    space = {"config": {"capacity": 0, "round_to": 8,
                        "hash_features": False, "hash_seed": 0},
             "vocabulary": [["s", f"/op{j}"] for j in range(F)],
             "frozen_capacity": F}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space))


def train(mesh, compute, dropout, superstep, epochs=2, metrics=E):
    """``epochs`` epochs (115 train windows at B=16: 8 steps, the last
    with 3 real rows) on ``mesh``; returns (trainer, state, losses)."""
    cfg = Config(model=ModelConfig(hidden_size=H, dropout_rate=dropout,
                                   compute_dtype=compute),
                 train=TrainConfig(batch_size=16, window_size=W,
                                   steps_per_superstep=superstep,
                                   log_every_steps=0))
    bundle = prepare_dataset(corpus(metrics), cfg.train)
    trainer = Trainer(cfg, F, bundle.metric_names, mesh=mesh)
    state = trainer.init_state(init_params(trainer.model_config, 0))
    staged = trainer.stage_dataset(bundle)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(epochs):
        state, _ = trainer.train_epoch(state, bundle, rng, staged)
        losses.append(trainer.last_epoch_losses)
    return trainer, state, np.concatenate(losses)


def numpy_params(state) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in
            state.params.items()}


@pytest.mark.cuda
def test_nccl_world_size_1_captured_equals_no_group(cuda):
    initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0, device="cuda")
    try:
        mesh = make_mesh(MeshConfig(data=1), device="cuda")
        assert mesh.backend == "nccl" and mesh.group is not None
        tr_n, st_n, l_n = train(mesh, "bfloat16", 0.5, 2)
        tr_p, st_p, l_p = train(Mesh(MeshConfig(), 0, cuda), "bfloat16",
                                0.5, 2)
    finally:
        torch.distributed.destroy_process_group()
    assert tr_n.captures == 1 and tr_n.replays == tr_p.replays > 0
    ledger = {k.name: n for k, n in st_n.graph.launches.items()}
    assert ledger["gru_fwd_train"] == ledger["gru_bwd"] == 2
    np.testing.assert_array_equal(l_n, l_p)
    for name, value in numpy_params(st_p).items():
        np.testing.assert_array_equal(numpy_params(st_n)[name], value)


def rank_main(rank: int, port: int, out: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(MeshConfig(data=2), device="cuda")
    trainer, state, losses = train(mesh, "float32", 0.0, 1)
    try:
        trainer._captured(2)
        refusal = ""
    except ValueError as exc:
        refusal = str(exc)
    np.savez(out, losses=losses, refusal=np.asarray(refusal),
             **{f"params/{k}": v for k, v in numpy_params(state).items()})
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_gloo_world_size_2_on_one_card(cuda, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=rank_main, args=(r, port, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(path)) for path in outs]
    _, st_1, l_1 = train(Mesh(MeshConfig(), 0, cuda), "float32", 0.0, 1)
    for key in ranks[0]:
        if key.startswith("params/") or key == "losses":
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    np.testing.assert_allclose(ranks[0]["losses"], l_1, rtol=2e-3,
                               atol=1e-5)
    for name, value in numpy_params(st_1).items():
        np.testing.assert_allclose(ranks[0][f"params/{name}"], value,
                                   rtol=5e-3, atol=1e-4)
    assert "gloo's collectives cannot be captured" in str(
        ranks[0]["refusal"])


AXES_E = 40


def whole_params(trainer, state) -> dict:
    from deeprest_tpu_torch.models.qrnn import param_shapes
    from deeprest_tpu_torch.parallel.sharding import gather_params

    full = gather_params(trainer.mesh, state.params,
                         param_shapes(trainer.model_config))
    return {k: v.detach().float().cpu().numpy() for k, v in full.items()}


def axes_rank_main(rank: int, port: int, ckpt: str, out: str) -> None:
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.serve.predictor import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(MeshConfig(expert=2), device="cuda")
    for k in cuda_gru.KERNELS:
        k.launches = 0
    trainer, state, losses = train(mesh, "float32", 0.0, 1, epochs=1,
                                   metrics=AXES_E)
    launches = {k.name: k.launches for k in cuda_gru.KERNELS}
    experts = state.params["head_w"].shape[0]
    bundle = prepare_dataset(corpus(AXES_E), trainer.config.train)
    trainer.save(ckpt, state, bundle)
    params = whole_params(trainer, state)
    try:
        Predictor.from_checkpoint(ckpt, device="cuda",
                                  mesh_config=MeshConfig(model=2))
        refusal = ""
    except ValueError as exc:
        refusal = str(exc)
    pred = Predictor.from_checkpoint(ckpt, device="cuda", cuda_graphs=False,
                                     mesh_config=MeshConfig(model=2))
    answer = pred.predict_series(corpus(AXES_E).traffic)
    np.savez(out, losses=losses, refusal=np.asarray(refusal),
             experts=np.asarray(experts), answer=answer,
             **{f"launches/{k}": v for k, v in launches.items()},
             **{f"params/{k}": v for k, v in params.items()})
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_gloo_expert_and_model_axes_on_one_card(cuda, tmp_path):
    from deeprest_tpu_torch.serve.predictor import Predictor

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    ckpt = str(tmp_path / "ckpt")
    outs = [str(tmp_path / f"axes{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=axes_rank_main, args=(r, port, ckpt, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [dict(np.load(path)) for path in outs]
    _, st_1, l_1 = train(Mesh(MeshConfig(), 0, cuda), "float32", 0.0, 1,
                         epochs=1, metrics=AXES_E)
    steps = len(l_1)
    for r in ranks:
        assert int(r["experts"]) == AXES_E // 2
        # one launch a direction a step
        assert int(r["launches/gru_fwd_train"]) == 2 * steps
        assert int(r["launches/gru_bwd"]) == 2 * steps
        assert "gloo's collectives cannot be captured" in str(r["refusal"])
    for key in ranks[0]:
        if key.startswith("params/") or key in ("losses", "answer"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    np.testing.assert_allclose(ranks[0]["losses"], l_1, rtol=2e-3,
                               atol=1e-5)
    for name, value in numpy_params(st_1).items():
        np.testing.assert_allclose(ranks[0][f"params/{name}"], value,
                                   rtol=5e-3, atol=1e-4)
    one = Predictor.from_checkpoint(ckpt, device="cuda")
    want = one.predict_series(corpus(AXES_E).traffic)
    assert ranks[0]["answer"].shape == want.shape
    assert np.abs(ranks[0]["answer"] - want).max() \
        <= 1e-4 * np.abs(want).max()


def elastic_rank_main(rank: int, port: int, ckpt: str, out: str) -> None:
    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.parallel import FaultInjector
    from deeprest_tpu_torch.parallel.distributed import leave_job

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    mesh = make_mesh(MeshConfig(data=2), device="cuda")
    cfg = Config(model=ModelConfig(hidden_size=H, dropout_rate=0.0,
                                   compute_dtype="bfloat16"),
                 train=elastic_train(ckpt, elastic=True))
    bundle = prepare_dataset(corpus(), cfg.train)
    trainer = Trainer(cfg, F, bundle.metric_names, mesh=mesh)
    trainer.install_fault_injector(FaultInjector({3: 1}))
    for k in cuda_gru.KERNELS:
        k.launches = 0
    try:
        state, _ = trainer.fit(
            bundle, state=trainer.init_state(init_params(
                trainer.model_config, 0)))
        outcome = "done"
    except Exception as exc:
        outcome, state = type(exc).__name__, None
    arrays = {"outcome": np.asarray(outcome),
              "history": np.asarray(repr(trainer.remesh_history)),
              **{f"launches/{k.name}": np.asarray(k.launches)
                 for k in cuda_gru.KERNELS}}
    if state is not None:
        arrays.update({"losses": trainer.last_epoch_losses,
                       "restored": np.asarray(
                           trainer.last_remesh["restored_step"]),
                       **{f"params/{k}": v for k, v in
                          numpy_params(state).items()}})
    np.savez(out, **arrays)
    leave_job()


def elastic_train(ckpt: str, elastic: bool) -> TrainConfig:
    return TrainConfig(batch_size=16, window_size=W, steps_per_superstep=1,
                       log_every_steps=0, num_epochs=2, checkpoint_dir=ckpt,
                       snapshot_every_steps=2, snapshot_keep=0,
                       elastic=elastic, remesh_backoff_ms=1.0)


@pytest.mark.cuda
def test_gloo_elastic_on_one_card(cuda, tmp_path):
    import os
    import shutil

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    ckpt = str(tmp_path / "snap")
    outs = [str(tmp_path / f"elastic{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=elastic_rank_main,
                         args=(r, port, ckpt, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    r0, r1 = (dict(np.load(path)) for path in outs)
    assert str(r1["outcome"]) == "DeviceLossError"
    assert str(r0["outcome"]) == "done", str(r0["history"])
    assert int(r0["restored"]) == 2
    assert int(r0["launches/gru_fwd_train"]) > 0
    assert int(r0["launches/gru_bwd"]) > 0
    cut = str(tmp_path / "cut")
    os.makedirs(cut)
    shutil.copytree(os.path.join(ckpt, "step_00000002"),
                    os.path.join(cut, "step_00000002"))
    cfg = Config(model=ModelConfig(hidden_size=H, dropout_rate=0.0,
                                   compute_dtype="bfloat16"),
                 train=elastic_train(cut, elastic=False))
    bundle = prepare_dataset(corpus(), cfg.train)
    ref = Trainer(cfg, F, bundle.metric_names,
                  mesh=Mesh(MeshConfig(), 0, cuda))
    state, _ = ref.resume_training(bundle, cut)
    np.testing.assert_array_equal(r0["losses"], ref.last_epoch_losses)
    for name, value in numpy_params(state).items():
        np.testing.assert_array_equal(r0[f"params/{name}"], value, name)


SERVE_DEADLINE_S = 20


def serve_rank_main(rank: int, port: int, ckpt: str, out: str) -> None:
    """One rank of ``serve --mesh 1,2,1`` on the card, in a gloo job that
    shares it: the CLI's stdout to ``out + ".log"``, then its exit code
    and K1 launches to ``out``."""
    import contextlib
    import json

    from deeprest_tpu_torch.cli import main
    from deeprest_tpu_torch.ops import cuda_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    with open(out + ".log", "w") as log, contextlib.redirect_stdout(log):
        rc = main(["serve", "--ckpt-dir", ckpt, "--mesh", "1,2,1",
                   "--port", "0", "--deadline", str(SERVE_DEADLINE_S)])
    with open(out, "w") as fh:
        json.dump({"rc": rc, "gru_fwd": cuda_gru.GRU_FWD.launches}, fh)


@pytest.mark.cuda
def test_gloo_serve_mesh_on_one_card(cuda, tmp_path):
    """``serve --mesh 1,2,1`` (bf16, E=4: two experts a rank) as two gloo
    ranks sharing the card, eager: /v1/predict within 2e-2 of scale of
    the one-process captured answer, K1 launched as often on both ranks,
    and both ranks exit 0 at the deadline."""
    import json
    import os
    import time
    import urllib.request

    from deeprest_tpu_torch.serve.predictor import Predictor

    trainer, state, _ = train(Mesh(MeshConfig(), 0, cuda), "bfloat16", 0.0,
                              1, epochs=1, metrics=4)
    ckpt = str(tmp_path / "ckpt")
    trainer.save(ckpt, state, prepare_dataset(corpus(4),
                                              trainer.config.train))
    traffic = corpus(4).traffic
    want = Predictor.from_checkpoint(ckpt, device="cuda").predict_series(
        traffic)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [str(tmp_path / f"serve{r}.json") for r in range(2)]
    procs = [ctx.Process(target=serve_rank_main, args=(r, port, ckpt, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        url, deadline = None, time.monotonic() + 300
        while url is None and time.monotonic() < deadline:
            time.sleep(0.2)
            assert all(p.is_alive() for p in procs)
            if not os.path.exists(outs[0] + ".log"):
                continue
            with open(outs[0] + ".log") as fh:
                for line in fh:
                    if line.startswith('{"listening"'):
                        url = json.loads(line)["listening"]
        assert url is not None
        req = urllib.request.Request(
            url + "/v1/predict",
            data=json.dumps({"traffic": traffic.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = np.asarray(json.loads(resp.read())["predictions"])
        for p in procs:
            p.join(SERVE_DEADLINE_S + 120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = []
    for path in outs:
        with open(path) as fh:
            ranks.append(json.load(fh))
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[0]["gru_fwd"] == ranks[1]["gru_fwd"] > 0
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def quant_serve_rank_main(rank: int, port: int, args: list,
                          out: str) -> None:
    """One rank of ``serve`` with ``args`` on the card, in a gloo job that
    shares it: the CLI's stdout to ``out + ".log"``, then its exit code
    and K1 launches to ``out``."""
    import contextlib
    import json

    from deeprest_tpu_torch.cli import main
    from deeprest_tpu_torch.ops import cuda_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    with open(out + ".log", "w") as log, contextlib.redirect_stdout(log):
        rc = main(["serve", *args])
    with open(out, "w") as fh:
        json.dump({"rc": rc, "gru_fwd": cuda_gru.GRU_FWD.launches}, fh)


@pytest.mark.cuda
def test_gloo_quant_serve_mesh_reload_on_one_card(cuda, tmp_path):
    """``serve --mesh 1,1,2 --quant int8 --watch`` (bf16, F=24: 12 columns
    a rank) as two gloo ranks sharing the card, eager: /v1/predict within
    2e-2 of scale of the one-process int8 predictor; a newer step (params
    x 1.1, the stored envelope removed with it: in bf16 the int8 deviation
    sits at the rounding noise, which the new params draw anew) served
    once /healthz names it, within 2e-2 of that step's one-process int8
    predictor, with its digest; K1 launched as often on both ranks, both
    exit 0 at the deadline."""
    import json
    import os
    import shutil
    import time
    import urllib.request

    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.train.checkpoint import (
        latest_step, load_params, load_sidecar, save_checkpoint,
    )

    trainer, state, _ = train(Mesh(MeshConfig(), 0, cuda), "bfloat16", 0.0,
                              1, epochs=1, metrics=4)
    ckpt = str(tmp_path / "ckpt")
    trainer.save(ckpt, state, prepare_dataset(corpus(4),
                                              trainer.config.train))
    step = latest_step(ckpt)
    traffic = corpus(4).traffic

    def post(url):
        req = urllib.request.Request(
            url + "/v1/predict",
            data=json.dumps({"traffic": traffic.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            return np.asarray(json.loads(resp.read())["predictions"])

    def health(url):
        with urllib.request.urlopen(url + "/healthz", timeout=120) as resp:
            return json.loads(resp.read())

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [str(tmp_path / f"serve{r}.json") for r in range(2)]
    args = ["--ckpt-dir", ckpt, "--mesh", "1,1,2", "--quant", "int8",
            "--watch", "0.5", "--no-batcher", "--port", "0", "--deadline",
            str(SERVE_DEADLINE_S + 10)]
    procs = [ctx.Process(target=quant_serve_rank_main,
                         args=(r, port, args, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        url, deadline = None, time.monotonic() + 300
        while url is None and time.monotonic() < deadline:
            time.sleep(0.2)
            assert all(p.is_alive() for p in procs)
            if not os.path.exists(outs[0] + ".log"):
                continue
            with open(outs[0] + ".log") as fh:
                for line in fh:
                    if line.startswith('{"listening"'):
                        url = json.loads(line)["listening"]
        assert url is not None
        got = {step: post(url)}
        os.remove(os.path.join(ckpt, "quant_parity_int8.json"))
        save_checkpoint(ckpt, {k: v * 1.1 for k, v in
                               load_params(ckpt, step).items()}, step + 1,
                        extra=load_sidecar(ckpt, step))
        deadline = time.monotonic() + 120
        while (health(url)["mesh"]["step"] != step + 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        served = health(url)
        assert served["mesh"]["step"] == step + 1
        got[step + 1] = post(url)
        for p in procs:
            p.join(SERVE_DEADLINE_S + 130)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = []
    for path in outs:
        with open(path) as fh:
            ranks.append(json.load(fh))
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[0]["gru_fwd"] == ranks[1]["gru_fwd"] > 0
    one = str(tmp_path / "one")
    shutil.copytree(ckpt, one,
                    ignore=shutil.ignore_patterns("quant_parity_*"))
    for s in (step, step + 1):
        stored = os.path.join(one, "quant_parity_int8.json")
        if os.path.exists(stored):
            os.remove(stored)           # each step measures its own
        pred = Predictor.from_checkpoint(one, step=s, device="cuda",
                                         quant="int8")
        want = pred.predict_series(traffic)
        assert got[s].shape == want.shape
        assert np.abs(got[s] - want).max() <= 2e-2 * np.abs(want).max(), s
    tenant = served["fleet"]["tenants"]["default"]
    assert tenant["params_digest"] == pred.params_digest()


def clone_rank_main(rank: int, port: int, ckpt: str, out: str) -> None:
    """One rank of a gloo job sharing the card: the 1,2,1 mesh predictor
    (eager), warmed and digested.  Rank 0 fronts it and clones it onto
    ``cuda:0`` (``clone_backend``: the gather a mirrored op), warms the
    clone (captured) and answers ``out``'s traffic through it; rank 1
    follows.  Each rank writes its K1 launches (and rank 0 the clone's
    answer, its graph mode and the mirrored calls) to ``out``."""
    import json

    from deeprest_tpu_torch.ops import cuda_gru
    from deeprest_tpu_torch.serve.mesh_front import MeshFront, follow
    from deeprest_tpu_torch.serve.predictor import Predictor
    from deeprest_tpu_torch.serve.replica import clone_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, backend="gloo",
                           device="cuda")
    pred = Predictor.from_checkpoint(ckpt, mesh_config=MeshConfig(1, 2, 1),
                                     cuda_graphs=False)
    pred.warm()
    pred.params_digest()
    result = {}
    if rank:
        follow(pred)
    else:
        front = MeshFront(pred)
        clone = clone_backend(pred, device=torch.device("cuda", 0))
        clone.warm()
        result["answer"] = clone.predict_series(
            np.load(out + ".traffic.npy")).tolist()
        result["captured"] = clone.graphs.captured
        result["front"] = clone.front is not None
        result["calls"] = front.calls
        front.stop()
    result["gru_fwd"] = cuda_gru.GRU_FWD.launches
    with open(out, "w") as fh:
        json.dump(result, fh)


@pytest.mark.cuda
def test_gloo_mesh_clone_on_one_card(cuda, tmp_path):
    """The 1,2,1 mesh predictor (bf16, E=4) as two gloo ranks sharing the
    card: rank 0's one-device clone of its gathered params on ``cuda:0``
    is captured, has no front, mirrors no call, and answers bit for bit
    as the one-process captured predictor of the checkpoint."""
    import json

    from deeprest_tpu_torch.serve.predictor import Predictor

    trainer, state, _ = train(Mesh(MeshConfig(), 0, cuda), "bfloat16", 0.0,
                              1, epochs=1, metrics=4)
    ckpt = str(tmp_path / "ckpt")
    trainer.save(ckpt, state, prepare_dataset(corpus(4),
                                              trainer.config.train))
    traffic = corpus(4).traffic
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [str(tmp_path / f"clone{r}.json") for r in range(2)]
    np.save(outs[0] + ".traffic.npy", traffic)
    procs = [ctx.Process(target=clone_rank_main,
                         args=(r, port, ckpt, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = []
    for path in outs:
        with open(path) as fh:
            ranks.append(json.load(fh))
    assert ranks[0]["captured"] and not ranks[0]["front"]
    assert ranks[0]["calls"] == 0
    # the warm-ups ran on both ranks; the clone's K1 on rank 0 alone
    assert ranks[0]["gru_fwd"] > ranks[1]["gru_fwd"] > 0
    one = Predictor.from_checkpoint(ckpt, device="cuda")
    assert one.graphs.captured
    want = one.predict_series(traffic)
    got = np.asarray(ranks[0]["answer"], np.float32)
    assert got.shape == want.shape and np.array_equal(got, want)
