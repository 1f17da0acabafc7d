"""The mesh's data axis (parallel/) and data-parallel training, on the CPU
under gloo, against the JAX package's ``data=2`` mesh and the port at one
process.

- The feeds' arithmetic: ``process_batch_slice`` partitions exactly,
  ``feed_global_batch`` keeps a rank's rows (equal to JAX's shard of that
  device) and raises JAX's message on a batch axis the data axis does not
  divide; ``initialize_distributed`` is a no-op without configuration; the
  default mesh is pure data; ``make_mesh`` refuses a mesh the job cannot
  lay out (the expert and model axes themselves are
  tests/test_torch_parallel_axes.py's).
- The pinball loss's global denominator: the ranks' losses and gradients
  on their slices sum to the global ones, a rank whose rows are all
  zero-weight padding included.  Dropout's rank rows are cut from the
  global mask.
- Two spawned gloo ranks (f32, H=8, ``make_series_buckets`` corpus: 51
  train windows, B=16, so every epoch's last batch holds 3 real rows and
  rank 1's half of it is all padding) from JAX-initialized params: against
  the JAX ``Trainer`` on ``make_mesh(MeshConfig(data=2))`` at dropout 0
  over 2 epochs (per-step losses within 1e-5 relative, params within 1e-4
  of each leaf's largest magnitude) and against the port at one process
  (dropout 0 and 0.5, the three accumulation modes at G=2, the
  host-streamed feed: the same tolerances); params bit-equal across
  ranks, test losses equal on every rank.
- Resume across world sizes and packages: a world-size-2 snapshot resumed
  at one process, a JAX ``data=2`` snapshot resumed by the two ranks, and
  a snapshot of the two ranks resumed by JAX on ``data=2`` each end as the
  uninterrupted run does.
- ``train --mesh 2,1,1`` as two CLI processes (``env://``, ``--device
  cpu``): rank 0 prints the JSON line and rank 1 only its distributed
  line; ``--mesh`` exits on a bad spec as JAX's CLI does, a mesh the job
  cannot lay out exits 2, and ``serve`` on a mesh above one rank exits 2
  naming ROADMAP item 6d.
"""

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_series_buckets
from deeprest_tpu.cli import _parse_mesh as jax_parse_mesh
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.parallel import feed_global_batch as jax_feed_global_batch
from deeprest_tpu.parallel import make_mesh as jax_make_mesh
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.models.qrnn import dropout
from deeprest_tpu_torch.ops.quantile import pinball_loss
from deeprest_tpu_torch.parallel import (
    AXES, Mesh, feed_global_batch, feed_global_coo, gather_to_host,
    global_mesh, initialize_distributed, make_mesh, process_batch_slice,
    stage_plan,
)
from deeprest_tpu_torch.train.checkpoint import list_steps

import test_torch_parallel_support as support

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_STEPS = 4          # ceil(51 train windows / 16)
MODEL = dict(hidden_size=8, dropout_rate=0.0)
TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=3, seed=0, log_every_steps=0,
             steps_per_superstep=1)
ACCUM = ("exact", "flat", "loop")


def cpu_mesh(data: int, rank: int) -> Mesh:
    return Mesh(MeshConfig(data=data), rank, torch.device("cpu"))


# -- the feeds' arithmetic -------------------------------------------------

def test_process_batch_slice_partitions_exactly():
    slices = [process_batch_slice(32, process_index=i, process_count=4)
              for i in range(4)]
    covered = []
    for s in slices:
        covered.extend(range(32)[s])
    assert covered == list(range(32))
    with pytest.raises(ValueError, match="not divisible"):
        process_batch_slice(30, process_index=0, process_count=4)
    assert process_batch_slice(16) == slice(0, 16)


def test_feed_global_batch_keeps_the_ranks_rows_as_jax_shards_them():
    local = np.arange(16 * 3 * 2, dtype=np.float32).reshape(16, 3, 2)
    arr = jax_feed_global_batch(jax_make_mesh(JaxMeshConfig(data=4)), local)
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    for rank in range(4):
        got = feed_global_batch(cpu_mesh(4, rank), local)
        assert got.shape == (4, 3, 2)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(shards[rank].data))
    cols, vals = feed_global_coo(cpu_mesh(4, 3), local.astype(np.int32),
                                 local)
    np.testing.assert_array_equal(cols.numpy(), local[12:].astype(np.int32))
    np.testing.assert_array_equal(vals.numpy(), local[12:])
    # the plan's trailing batch axis, and the global weight sums
    starts = np.arange(2 * 3 * 16).reshape(2, 3, 16)
    weights = np.ones((2, 3, 16), np.float32)
    weights[1, 2, 3:] = 0
    s, w, den = stage_plan(cpu_mesh(2, 1), starts, weights)
    np.testing.assert_array_equal(s, starts[..., 8:])
    assert w[1, 2].sum() == 0 and den.tolist() == [[16] * 3, [16, 16, 3]]
    assert gather_to_host(cpu_mesh(1, 0), torch.arange(3)).tolist() == [
        0, 1, 2]


def test_batch_axis_not_divisible_raises_jax_message():
    x = np.zeros((30, 12, 8), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_feed_global_batch(jax_make_mesh(JaxMeshConfig(data=4)), x)
    with pytest.raises(ValueError) as port_err:
        feed_global_batch(cpu_mesh(4, 0), x)
    assert str(port_err.value) == str(jax_err.value)
    assert "not divisible by the mesh data axis (4 shards)" in str(
        port_err.value)


def test_initialize_distributed_noop_without_config(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_default_mesh_is_pure_data_and_refusals():
    mesh = global_mesh(device="cpu")
    assert mesh.axis_names == AXES == ("data", "expert", "model")
    assert mesh.shape == {"data": 1, "expert": 1, "model": 1}
    assert mesh.group is None and mesh.backend is None and mesh.rank == 0
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(JaxMeshConfig(data=16))
    with pytest.raises(ValueError) as port_err:
        make_mesh(MeshConfig(data=2), device="cpu")
    assert str(jax_err.value) == ("mesh 16x1x1 needs 16 devices, only 8 "
                                  "available")
    assert str(port_err.value) == ("mesh 2x1x1 needs 2 devices, only 1 "
                                   "available")
    # the expert and model axes are laid out like the data axis: only a
    # mesh of another size than the job raises
    for cfg, name in ((MeshConfig(expert=2), "1x2x1"),
                      (MeshConfig(model=2), "1x1x2")):
        with pytest.raises(ValueError) as exc:
            make_mesh(cfg, device="cpu")
        assert str(exc.value) == (f"mesh {name} needs 2 devices, only 1 "
                                  "available")
    assert mesh.coords == {"data": 0, "expert": 0, "model": 0}
    assert (mesh.data_group, mesh.expert_group, mesh.model_group) == (
        None, None, None)


# -- the loss's global denominator, dropout's rank rows ---------------------

@pytest.mark.parametrize("real", [16, 3, 0])
def test_ranks_loss_shares_sum_to_the_global_loss(real):
    """With ``weight_sum`` the global batch's sum, two ranks' losses and
    gradients on their halves sum to the global ones, also when rank 1's
    half is all zero-weight padding (``real`` 3) and when the whole batch
    is (``real`` 0, the ``allow_empty`` floor)."""
    g = torch.Generator().manual_seed(real)
    preds = torch.rand((16, 5, 3, 3), generator=g, requires_grad=True)
    y = torch.rand((16, 5, 3), generator=g)
    w = torch.zeros(16)
    w[:real] = 1
    q = (0.05, 0.5, 0.95)
    full = pinball_loss(preds, y, q, sample_weight=w, allow_empty=True)
    (want,) = torch.autograd.grad(full, preds)
    den = w.sum()
    parts, grads = [], []
    for rows in (slice(0, 8), slice(8, 16)):
        p = preds.detach()[rows].requires_grad_(True)
        loss = pinball_loss(p, y[rows], q, sample_weight=w[rows],
                            allow_empty=True, weight_sum=den)
        grads.append(torch.autograd.grad(loss, p)[0])
        parts.append(loss.detach())
    torch.testing.assert_close(sum(parts), full.detach(), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(torch.cat(grads), want, rtol=1e-6, atol=1e-9)
    if real < 9:
        assert float(parts[1]) == 0 and not grads[1].any()


def test_dropout_rank_rows_are_cut_from_the_global_mask():
    x = torch.ones((3, 2 * 16, 5, 4))       # [E, G*B, T, D], G=2, B=16
    whole = dropout(x, 0.5, torch.Generator().manual_seed(7))
    for lo, hi in ((0, 8), (8, 16)):
        part = dropout(x[:, :16], 0.5, torch.Generator().manual_seed(7),
                       rows=(16, lo, hi))
        want = whole.reshape(3, 2, 16, 5, 4)[:, :, lo:hi].reshape(part.shape)
        assert torch.equal(part, want)
    assert torch.equal(
        dropout(x, 0.5, torch.Generator().manual_seed(7), rows=(32, 0, 32)),
        whole)


# -- two gloo ranks ---------------------------------------------------------

def scenario(epochs=2, model=None, **train):
    return {"model": dict(MODEL, **(model or {})),
            "train": dict(TRAIN, **train), "epochs": epochs}


def jax_configs(ckpt_dir):
    return JaxConfig(model=JaxModelConfig(rnn_backend="scan", **MODEL),
                     train=JaxTrainConfig(
                         device_data="always", checkpoint_dir=str(ckpt_dir),
                         snapshot_every_steps=2, snapshot_keep=0, **TRAIN))


def keep_through(src, dst, step: int) -> str:
    """A copy of the snapshot directory ``src`` holding the steps up to
    ``step``: the directory a run killed just after it left."""
    shutil.copytree(src, dst)
    for s in list_steps(dst):
        if s > step:
            shutil.rmtree(os.path.join(dst, f"step_{s:08d}"))
    return str(dst)


def jax_fit(jcfg, jbundle, params=None, resume=None):
    jt = JaxTrainer(jcfg, jbundle.feature_dim, jbundle.metric_names,
                    mesh=jax_make_mesh(JaxMeshConfig(data=2)))
    losses = []

    def on_epoch(result, state):
        losses.append(np.array(jt._last_epoch_losses))

    if resume:
        state, hist = jt.resume_training(jbundle, resume, on_epoch=on_epoch)
    else:
        state = jt.init_state(jbundle.x_train[:1])
        state = state.replace(params={k: np.asarray(params[k])
                                      for k in state.params})
        state, hist = jt.fit(jbundle, state=state, on_epoch=on_epoch)
    return ({k: np.asarray(v) for k, v in state.params.items()},
            np.concatenate(losses), int(state.step))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX ``data=2`` runs, the two gloo ranks' scenarios and the
    port's one-process runs of the same scenarios."""
    wd = tmp_path_factory.mktemp("parallel")
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                   invocations=data.invocations,
                   space=CallPathSpace.from_dict(data.space.to_dict())
                   ).save(str(wd / "corpus.npz"))
    jcfg = jax_configs(wd / "jax_snap")
    jbundle = jax_prepare_dataset(data, jcfg.train)
    assert jbundle.num_train_windows == 51
    jt = JaxTrainer(jcfg, jbundle.feature_dim, jbundle.metric_names)
    params = params_from_jax({k: np.array(v) for k, v in jt.init_state(
        jbundle.x_train[:1]).params.items()})
    np.savez(wd / "params.npz", **{k: v.numpy() for k, v in params.items()})
    jax_run = jax_fit(jcfg, jbundle, params=params)
    jax_cut = keep_through(wd / "jax_snap", wd / "jax_cut", 2)
    scenarios = {
        "base": scenario(checkpoint_dir=str(wd / "snap2"),
                         snapshot_every_steps=2, snapshot_keep=0),
        "dropout": scenario(model=dict(dropout_rate=0.5)),
        "host": scenario(epochs=1, device_data="off"),
        "resume_jax": dict(scenario(), resume=jax_cut),
        **{f"accum_{m}": scenario(epochs=1, grad_accum_windows=2,
                                  grad_accum_mode=m) for m in ACCUM},
    }
    with open(wd / "spec.json", "w") as fh:
        json.dump({"scenarios": scenarios}, fh)
    ranks = support.run_job(2, str(wd))
    port_cut = keep_through(wd / "snap2", wd / "snap2_cut", 2)
    single = {name: support.run_scenario(str(wd), sc)
              for name, sc in scenarios.items() if name != "resume_jax"}
    single["resume_ws2"] = support.run_scenario(
        str(wd), dict(scenario(), resume=port_cut))
    jax_resumed = jax_fit(jax_configs(wd / "snap2_cut"), jbundle,
                          resume=port_cut)
    return {"ranks": ranks, "single": single, "jax": jax_run,
            "jax_resumed": jax_resumed, "wd": wd}


def part(results: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in results.items() if k.startswith(pre)}


def params_of(res: dict) -> dict:
    return {k[len("params/"):]: v for k, v in res.items()
            if k.startswith("params/")}


def assert_params_close(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err)


def test_two_ranks_match_jax_data2_mesh(job):
    """Per-step losses (the last step of each epoch mostly padding) within
    1e-5 relative, params within 1e-4 of each leaf's scale."""
    got = part(job["ranks"][0], "base")
    want_params, want_losses, want_step = job["jax"]
    assert int(got["step"]) == want_step == 2 * EPOCH_STEPS
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_params_close(params_of(got), want_params)


@pytest.mark.parametrize("name", ["base", "dropout", "host"]
                         + [f"accum_{m}" for m in ACCUM])
def test_two_ranks_match_one_process(job, name):
    got = part(job["ranks"][0], name)
    want = job["single"][name]
    assert int(got["step"]) == int(want["step"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["test_losses"], want["test_losses"],
                               rtol=1e-5)
    assert_params_close(params_of(got), params_of(want))


def test_params_bit_equal_across_ranks_and_rank_checks(job):
    r0, r1 = job["ranks"]
    assert r0.keys() == r1.keys()
    for key in r0:
        if key.split("/", 1)[1].startswith(("params/", "losses",
                                            "test_losses")):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    assert float(r0["base/mesh_devices"]) == 2.0
    assert float(job["single"]["base"]["mesh_devices"]) == 1.0
    assert "gloo's collectives cannot be captured" in str(
        r1["base/captured_refusal"])
    assert str(job["single"]["base"]["captured_refusal"]) == ""


def test_two_rank_snapshot_resumes_at_one_process(job):
    """Cut after step 2 of epoch 0: one process resumes the two ranks'
    snapshot and ends as the uninterrupted two-rank run did (1e-5)."""
    got = job["single"]["resume_ws2"]
    want = part(job["ranks"][0], "base")
    assert int(got["step"]) == int(want["step"])
    np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=1e-5)
    assert_params_close(params_of(got), params_of(want), tol=1e-5)


def test_checkpoints_cross_packages_under_data2(job):
    """A JAX ``data=2`` snapshot resumed by the two ranks, and theirs by
    JAX on ``data=2``, each against the other package's uninterrupted run."""
    got = part(job["ranks"][0], "resume_jax")
    want_params, want_losses, _ = job["jax"]
    np.testing.assert_allclose(got["losses"], want_losses[2:], rtol=1e-5)
    assert_params_close(params_of(got), want_params)
    jax_params, jax_losses, step = job["jax_resumed"]
    base = part(job["ranks"][0], "base")
    assert step == int(base["step"])
    np.testing.assert_allclose(jax_losses, base["losses"][2:], rtol=1e-5)
    assert_params_close(jax_params, params_of(base))


# -- the CLI ----------------------------------------------------------------

def test_train_cli_two_processes(job, tmp_path):
    args = ["train", "--features", str(job["wd"] / "corpus.npz"),
            "--epochs", "1",
            "--batch-size", "16", "--window", "12", "--hidden-size", "8",
            "--dropout", "0", "--steps-per-superstep", "1",
            "--no-baselines", "--device", "cpu"]
    port = support.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", *args,
             "--mesh", "2,1,1", "--ckpt-dir", str(tmp_path / "ckpt")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert [p.returncode for p in procs] == [0, 0], outs
    lines0 = outs[0][0].strip().splitlines()
    lines1 = outs[1][0].strip().splitlines()
    assert lines0[0] == "distributed: process 0 of 2, 2 global devices (gloo)"
    assert lines1 == ["distributed: process 1 of 2, 2 global devices (gloo)"]
    report = json.loads(lines0[-1])
    assert report["mesh"] == {"data": 2, "expert": 1, "model": 1}
    assert report["steps"] == EPOCH_STEPS and list_steps(
        str(tmp_path / "ckpt")) == [EPOCH_STEPS]
    # the same command at one process
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch", *args, "--mesh",
         "1,1,1"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    single = json.loads(proc.stdout.strip().splitlines()[-1])
    np.testing.assert_allclose(report["epoch_losses"],
                               single["epoch_losses"], rtol=1e-5)
    np.testing.assert_allclose(report["step_losses"], single["step_losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("spec", ["2,x,1", "1,1", "0,1,1"])
def test_bad_mesh_spec_exits_as_jax_cli(spec):
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    with pytest.raises(SystemExit) as jax_exit:
        jax_parse_mesh(argparse.Namespace(mesh=spec))
    for cmd in (["train", "--features", "x.npz"],
                ["predict", "--ckpt-dir", "c", "--features", "x.npz"],
                ["whatif", "--ckpt-dir", "c", "--raw", "r", "--mix", "{}"],
                ["serve", "--ckpt-dir", "c"]):
        with pytest.raises(SystemExit) as port_exit:
            cli.main(cmd + ["--mesh", spec, "--device", "cpu"])
        assert port_exit.value.code == jax_exit.value.code, cmd


def test_mesh_beyond_the_data_axis_exits_2(job, tmp_path, capsys):
    """A mesh the job cannot lay out exits 2 from ``train``, ``predict``
    and ``serve`` (before ``serve`` loads anything); ``predict --mesh
    1,1,1`` runs (a multi-rank ``predict --mesh`` is
    tests/test_torch_sharded_ckpt.py's, a multi-rank ``serve --mesh``
    tests/test_torch_serve_mesh.py's)."""
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    corpus, ckpt = job["wd"] / "corpus.npz", job["wd"] / "snap2"
    assert cli.main(["train", "--features", str(corpus), "--epochs", "1",
                     "--mesh", "1,2,1", "--device", "cpu"]) == 2
    assert capsys.readouterr().err == ("train: mesh 1x2x1 needs 2 devices, "
                                       "only 1 available\n")
    with pytest.raises(SystemExit) as exc:
        cli.main(["predict", "--ckpt-dir", str(ckpt), "--features",
                  str(corpus), "--mesh", "1,1,2", "--device", "cpu"])
    assert exc.value.code == 2
    assert capsys.readouterr().err == ("predict: mesh 1x1x2 needs 2 "
                                       "devices, only 1 available\n")
    for mesh in ("2,1,1", "1,2,1", "1,1,2"):
        with pytest.raises(SystemExit) as exc:
            cli.main(["serve", "--ckpt-dir", str(ckpt), "--mesh", mesh,
                      "--device", "cpu"])
        assert exc.value.code == 2
        assert capsys.readouterr().err == (
            f"serve: mesh {mesh.replace(',', 'x')} needs 2 devices, only 1 "
            "available\n")
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--artifact", "a", "--mesh", "1,1,1"])
    assert "--mesh requires --ckpt-dir" in str(exc.value.code)
    out = str(tmp_path / "preds")
    assert cli.main(["predict", "--ckpt-dir", str(ckpt), "--features",
                     str(corpus), "--mesh", "1,1,1", "--out", out,
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "steps"] == 140
