"""Elastic remeshing in one process (parallel/elastic.py, parallel/mesh.py,
parallel/distributed.py, the trainer's barrier, the CLI flags) against the
JAX package: ``shrink_mesh_config`` and ``FaultInjector`` on the same
inputs, JAX's error words, the device-loss classification on the messages
gloo gives when a peer is SIGKILLed, and a one-rank job's census and rejoin.
The spawned gloo jobs are tests/test_torch_elastic_gloo.py and
tests/test_torch_elastic_stream.py.
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from conftest import make_series_buckets
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.parallel import FaultInjector as JaxFaultInjector
from deeprest_tpu.parallel import NoValidMeshError as JaxNoValidMeshError
from deeprest_tpu.parallel import shrink_mesh_config as jax_shrink
from deeprest_tpu_torch.config import (
    Config, MeshConfig, ModelConfig, TrainConfig,
)
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.parallel import (
    DeviceLossError, FaultInjector, NoValidMeshError, enumerate_healthy,
    initialize_distributed, is_device_loss, make_mesh, shrink_mesh_config,
)
from deeprest_tpu_torch.parallel.distributed import (
    JOB_TIMEOUT_S, JobStoreLostError, census, current_job, leave_job, rejoin,
    teardown,
)
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

import test_torch_parallel_support as support

# What gloo raised on the CPU when a peer of a two- and a four-rank job was
# SIGKILLed mid-allreduce (the read side and the far side of the ring), and
# when a peer stopped answering past the group's timeout.
GLOO_PEER_GONE = [
    "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:537] "
    "Read error [127.0.0.1]:4291: Connection reset by peer. This is "
    "typically caused by a remote worker hanging or bugs in the "
    "application. Check the logs of the remote worker before reporting an "
    "error. GLHF!",
    "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
    "Connection closed by peer [127.0.0.1]:8845. This is typically caused "
    "by a remote worker crashing. Check the logs of the remote worker "
    "before reporting an error. GLHF!",
    "[/__w/pytorch/pytorch/third_party/gloo/gloo/transport/tcp/"
    "unbound_buffer.cc:78] Timed out waiting 3000ms for recv operation to "
    "complete",
]
NCCL_AND_CUDA_LOSS = [
    "NCCL communicator was aborted on rank 1.",
    "[Rank 0] Watchdog caught collective operation timeout: "
    "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 600000 milliseconds",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
]

GRID = [(MeshConfig(8, 1, 1), n) for n in range(0, 10)] + [
    (MeshConfig(4, 2, 1), n) for n in (1, 2, 3, 5, 7, 8)] + [
    (MeshConfig(2, 1, 2), n) for n in (1, 2, 3, 4)] + [
    (MeshConfig(6, 1, 1), n) for n in (4, 5)] + [
    (MeshConfig(2, 2, 2), n) for n in (3, 4, 7)]


@pytest.mark.parametrize("cfg,healthy", GRID,
                         ids=[f"{c.data}x{c.expert}x{c.model}-{n}"
                              for c, n in GRID])
def test_shrink_mesh_config_matches_jax(cfg, healthy):
    jcfg = JaxMeshConfig(cfg.data, cfg.expert, cfg.model)
    try:
        want = jax_shrink(jcfg, healthy)
    except JaxNoValidMeshError as exc:
        with pytest.raises(NoValidMeshError) as got:
            shrink_mesh_config(cfg, healthy)
        assert str(got.value) == str(exc)
        return
    got = shrink_mesh_config(cfg, healthy)
    assert (got.data, got.expert, got.model) == (want.data, want.expert,
                                                  want.model)


@pytest.mark.parametrize("schedule,dispatches", [
    ({3: 2}, [(0, 1), (1, 1), (2, 1), (3, 1), (2, 1)]),
    ({3: 2, 7: 1}, [(0, 2), (2, 2), (4, 4), (2, 2), (6, 2)]),
    ({2: 1, 5: 1}, [(0, 4), (4, 4), (1, 4)]),
    ({4: 3}, [(0, 4), (0, 4)]),
])
def test_fault_injector_matches_jax(schedule, dispatches):
    """The same dispatches raise at the same calls with the same words, each
    event once, and the tail drop keeps the same prefix."""
    ours, ref = FaultInjector(schedule), JaxFaultInjector(schedule)
    ranks = list(range(8))
    for before, n in dispatches:
        raised = []
        for inj in (ours, ref):
            try:
                inj.note_steps(before, n)
                raised.append(None)
            except RuntimeError as exc:
                raised.append((str(exc), exc.lost))
        assert raised[0] == raised[1]
        if raised[0] is not None:
            kept = ours.healthy(ranks)
            assert kept == ref.healthy(ranks)
            ranks = kept
    assert ours.events == ref.events


@pytest.mark.parametrize("bad", [{0: 1}, {3: 0}, {-1: 2}])
def test_fault_injector_validation_matches_jax(bad):
    with pytest.raises(ValueError) as ref:
        JaxFaultInjector(bad)
    with pytest.raises(ValueError) as got:
        FaultInjector(bad)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("message", GLOO_PEER_GONE + NCCL_AND_CUDA_LOSS)
def test_peer_and_device_loss_messages_are_device_loss(message):
    assert is_device_loss(RuntimeError(message))
    assert is_device_loss(dist.DistBackendError(message))


def test_what_is_not_device_loss():
    from deeprest_tpu_torch.ops.cuda_gru import block_plan

    with pytest.raises(ValueError) as planned:
        block_plan(4, 8, 16, 8, dtype=torch.bfloat16, blocked=True, rows=8)
    try:
        torch.zeros(2, 3) @ torch.zeros(4, 5)
    except RuntimeError as exc:
        shape_error = exc
    assert is_device_loss(DeviceLossError("synthetic", lost=2))
    assert is_device_loss(dist.DistNetworkError("Broken pipe"))
    for exc in (planned.value, shape_error,
                torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB"),
                RuntimeError("nvcc failed building gru_fwd.cu"),
                JobStoreLostError("the job's store stopped answering "
                                  "(Broken pipe)"),
                ValueError("Connection reset by peer"),
                KeyError("x")):
        assert not is_device_loss(exc), exc


def test_elastic_config_and_fit_refusals_in_jax_words(tmp_path):
    with pytest.raises(ValueError) as ref:
        JaxTrainConfig(elastic=True)
    with pytest.raises(ValueError) as got:
        TrainConfig(elastic=True)
    assert str(got.value) == str(ref.value)
    assert "snapshot_every_steps" in str(got.value)
    assert TrainConfig(elastic=True, snapshot_every_steps=2).elastic
    bundle, cfg = _tiny(tmp_path, checkpoint_dir="")
    tr = Trainer(cfg, bundle.feature_dim, bundle.metric_names, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.fit(bundle)


def _tiny(tmp_path, **train):
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    data = FeaturizedData(traffic=data.traffic,
                          resources=dict(data.resources),
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(
                              data.space.to_dict()))
    kw = dict(num_epochs=1, batch_size=16, window_size=12, eval_stride=12,
              eval_max_cycles=2, log_every_steps=0, steps_per_superstep=2,
              checkpoint_dir=str(tmp_path / "snap"), snapshot_every_steps=2,
              elastic=True, remesh_backoff_ms=1.0)
    kw.update(train)
    cfg = Config(model=ModelConfig(hidden_size=8), train=TrainConfig(**kw))
    return prepare_dataset(data, cfg.train), cfg


def test_one_rank_losing_its_device_raises_no_valid_mesh(tmp_path):
    bundle, cfg = _tiny(tmp_path)
    tr = Trainer(cfg, bundle.feature_dim, bundle.metric_names, device="cpu")
    tr.install_fault_injector(FaultInjector({3: 1}))
    with pytest.raises(NoValidMeshError, match="no healthy devices remain"):
        tr.fit(bundle)
    assert tr.remesh_count == 0 and not tr.remesh_in_flight


def test_one_process_loss_with_a_live_device_restores_in_place(tmp_path):
    """Without a job and without an injector the probe finds the device
    alive: the same one-process mesh, the newest snapshot restored, the
    run completed."""
    bundle, cfg = _tiny(tmp_path, num_epochs=2)
    tr = Trainer(cfg, bundle.feature_dim, bundle.metric_names, device="cpu")
    calls = []
    run_epochs = tr._run_epochs

    def lose_once(*args, **kwargs):
        if not calls:
            calls.append(1)
            raise RuntimeError(GLOO_PEER_GONE[1])
        return run_epochs(*args, **kwargs)

    tr._run_epochs = lose_once
    assert enumerate_healthy(torch.device("cpu")) == [0]
    state, hist = tr.fit(bundle)
    assert tr.remesh_count == 1
    assert tr.last_remesh["restored_step"] is None
    assert tr.last_remesh["mesh"] == {"data": 1, "expert": 1, "model": 1}
    assert state.step == 8 and len(hist) == 2


def test_one_rank_job_census_rejoin_and_severed_meshes():
    """A one-rank gloo job in this process: the census agrees through the
    store (a rank that does not check in is not on the list, and a later
    census of the same generation reads the first list), the rejoin forms
    generation 1, and a mesh of generation 0 refuses its groups."""
    port = support.free_port()
    assert initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                                  world_size=1, rank=0, device="cpu")
    try:
        job = current_job()
        assert (job.rank, job.world, job.generation) == (0, 1, 0)
        assert job.timeout == datetime.timedelta(seconds=JOB_TIMEOUT_S)
        old = make_mesh(MeshConfig(), device="cpu")
        teardown()
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="torn down by an elastic"):
            dist.all_reduce(torch.ones(1), group=old.data_group)
        assert census(True, 1.0) == [0]
        assert census(False, 0.05) == [0]      # the first list stands
        assert rejoin([0], 1) == 0
        assert (job.rank, job.world, job.generation) == (0, 1, 1)
        mesh = make_mesh(MeshConfig(), device="cpu")
        t = torch.ones(3)
        dist.all_reduce(t, group=mesh.data_group)
        assert t.tolist() == [1.0, 1.0, 1.0]
        teardown()
        job.generation = 5
        assert census(False, 0.05) == []       # nobody checked in
        with pytest.raises(ValueError, match="not among"):
            rejoin([], 6)
    finally:
        leave_job()
    assert current_job() is None


def test_census_on_a_store_that_is_gone_raises_typed():
    port = support.free_port()
    master = dist.TCPStore("127.0.0.1", port, 1, True,
                           timeout=datetime.timedelta(seconds=5))
    client = dist.TCPStore("127.0.0.1", port, 1, False,
                           timeout=datetime.timedelta(seconds=5))
    import deeprest_tpu_torch.parallel.distributed as pd

    pd._JOB = pd.Job(store=client, backend="gloo",
                     timeout=datetime.timedelta(seconds=5), rank=0, world=2)
    try:
        del master
        with pytest.raises(JobStoreLostError, match="rank 0 of the first"):
            census(True, 0.2)
    finally:
        pd._JOB = None


def test_elastic_cli_help_covers_flags(capsys):
    """JAX's ``test_elastic_cli_help_covers_flags`` on the port's parser,
    and the flags parse as JAX's do."""
    from deeprest_tpu.cli import build_parser as jax_parser
    from deeprest_tpu_torch.cli import build_parser

    for sub in ("train", "stream"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([sub, "--help"])
        out = capsys.readouterr().out
        for flag in ("--elastic", "--remesh-max-attempts",
                     "--remesh-backoff-ms", "--snapshot-keep"):
            assert flag in out, f"{sub} --help missing {flag}"
    argv = ["train", "--features", "f.npz", "--elastic",
            "--remesh-max-attempts", "5", "--remesh-backoff-ms", "2.5",
            "--snapshot-every-steps", "2"]
    ours, ref = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for key in ("elastic", "remesh_max_attempts", "remesh_backoff_ms",
                "snapshot_every_steps", "snapshot_keep"):
        assert getattr(ours, key) == getattr(ref, key), key
    defaults = build_parser().parse_args(["train", "--features", "f.npz"])
    assert (defaults.elastic, defaults.remesh_max_attempts,
            defaults.remesh_backoff_ms) == (False, 3, 100.0)


def test_train_cli_elastic_without_snapshots_exits_with_jax_message(
        tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    path = str(tmp_path / "corpus.npz")
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                   invocations=data.invocations,
                   space=CallPathSpace.from_dict(data.space.to_dict())
                   ).save(path)
    assert main(["train", "--features", path, "--elastic", "--device",
                 "cpu", "--no-baselines"]) == 2
    err = capsys.readouterr().err
    with pytest.raises(ValueError) as ref:
        JaxTrainConfig(elastic=True)
    assert str(ref.value) in err
