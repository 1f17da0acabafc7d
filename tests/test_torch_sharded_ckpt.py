"""Checkpoints and serving on the mesh's expert and model axes, on the
CPU under gloo (tests/test_torch_parallel_axes.py holds the training).

- A 1x2x2 job (four spawned gloo ranks) trains one epoch from JAX's init
  and saves per shard: each distinct box written once, every file named in
  the manifest.  The step restores bit-equal (params and Adam's moments)
  at 1x1x1 here, at 2x1x1 (a job) and by JAX on 1x1x1 and 2x2x2; JAX's
  own 2x2x2 checkpoint restores bit-equal on the port's 1x2x2.
- ``Predictor.from_checkpoint(mesh_config=...)`` on 1x2x2 and 2x1x1 (each
  rank its boxes, answers gathered on the expert axis) answers within
  1e-5 of the one-process answer on every rank, with the one-process
  ``params_digest``; ``predict --mesh 1,2,1 --device cpu`` as two
  ``env://`` processes writes, from rank 0 alone, what one process writes.
- JAX's F=10240 TP case (``tests/test_parallel.py:160-188``) at
  ``model=2``: ``w_ih``'s box halves F, and loss, eval loss and
  ``mask_w2`` match the port at one process within JAX's tolerances there
  (rtol 2e-3 / atol 1e-5, 5e-3 / 1e-4).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deeprest_tpu.train.checkpoint import restore_checkpoint as jax_restore
from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.train.checkpoint import list_steps
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

import test_torch_parallel_support as support
from test_torch_parallel_axes import (
    EPOCH_STEPS, MODEL, SCENARIOS, TRAIN, jax_fit, jax_trainer, leaves,
    make_corpus, part, run_mesh_job, scenario,
    test_params_bit_equal_across_replicas as replicas_bit_equal,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, JAX's init, a one-process checkpoint to serve, and
    JAX's 2x2x2 checkpoint."""
    wd = tmp_path_factory.mktemp("sharded")
    jbundle, params = make_corpus(wd)
    support.run_scenario(str(wd), dict(SCENARIOS["base"],
                                       save=str(wd / "ckpt_single")))
    _, _, jt8, st8 = jax_fit(jbundle, params, (2, 2, 2), epochs=1)
    jt8.save(str(wd / "jax_ckpt"), st8, jbundle)
    return {"wd": wd, "jbundle": jbundle,
            "jax_2x2x2": {k: np.asarray(v) for k, v in st8.params.items()}}


@pytest.fixture(scope="module")
def jobs(setup):
    wd = setup["wd"]
    serve = {"predict": str(wd / "ckpt_single")}
    return {
        # 1x2x2 saves per shard, restores JAX's 2x2x2 checkpoint, serves
        "1x2x2": run_mesh_job(wd, "1x2x2", (1, 2, 2), {
            "base": dict(scenario(epochs=1), save=str(wd / "ckpt_122")),
            "restore_jax": {**scenario(), "restore": str(wd / "jax_ckpt")},
            "predict": serve}),
        "2x1x1": run_mesh_job(wd, "2x1x1", (2, 1, 1), {
            "restore": {**scenario(), "restore": str(wd / "ckpt_122")},
            "predict": serve}),
    }


def test_sharded_job_params_bit_equal_across_replicas(jobs):
    replicas_bit_equal(jobs, "1x2x2")


# -- checkpoints across meshes and packages ---------------------------------

def test_checkpoint_saved_per_shard(jobs, setup):
    path = setup["wd"] / "ckpt_122"
    step = list_steps(str(path))[-1]
    with open(path / f"step_{step:08d}" / "manifest.json") as fh:
        manifest = {e["name"]: e for e in json.load(fh)["leaves"]}
    w_ih = manifest["params/gru_fwd_w_ih"]
    assert [s["index"] for s in w_ih["shards"]] == [
        [[0, 1], [0, 4], [0, 24]], [[0, 1], [4, 8], [0, 24]],
        [[1, 2], [0, 4], [0, 24]], [[1, 2], [4, 8], [0, 24]]]
    assert len(manifest["opt_state/0/mu/head_w"]["shards"]) == 2
    assert len(manifest["step"]["shards"]) == 1
    files = os.listdir(path / f"step_{step:08d}" / "arrays")
    assert len(files) == sum(len(e["shards"]) for e in manifest.values())


def test_checkpoint_crosses_meshes_and_packages(jobs, setup):
    """The 1x2x2 job's checkpoint at 1x1x1 (here), at 2x1x1 (a job) and by
    JAX on 1x1x1 and 2x2x2, all bit-equal to the params the job held;
    JAX's 2x2x2 checkpoint on the port's 1x2x2, bit-equal to JAX's."""
    wd = setup["wd"]
    saved = leaves(part(jobs["1x2x2"][0], "base"), "params")
    cfg = Config(model=ModelConfig(**MODEL), train=TrainConfig(**TRAIN))
    bundle = prepare_dataset(support.load_corpus(str(wd)), cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    state, _ = trainer.restore_state(str(wd / "ckpt_122"))
    for name, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), saved[name])
    assert state.step == EPOCH_STEPS
    moments = {n: state.optimizer.state[p] for n, p
               in state.model.named_parameters()}
    for name, p in saved.items():
        np.testing.assert_array_equal(
            leaves(part(jobs["2x1x1"][0], "restore"), "params")[name], p)
    for mesh in ((1, 1, 1), (2, 2, 2)):
        jt = jax_trainer(setup["jbundle"], mesh)
        restored, _ = jax_restore(str(wd / "ckpt_122"),
                                  jt.init_state(setup["jbundle"].x_train[:1]))
        assert int(restored.step) == EPOCH_STEPS
        for name, p in saved.items():
            np.testing.assert_array_equal(np.asarray(restored.params[name]),
                                          p, err_msg=(mesh, name))
            adam = restored.opt_state[0]
            np.testing.assert_array_equal(
                np.asarray(adam.mu[name]),
                moments[name]["exp_avg"].numpy(), err_msg=(mesh, name))
            np.testing.assert_array_equal(
                np.asarray(adam.nu[name]),
                moments[name]["exp_avg_sq"].numpy(), err_msg=(mesh, name))
    got = leaves(part(jobs["1x2x2"][0], "restore_jax"), "params")
    assert got.keys() == setup["jax_2x2x2"].keys()
    for name, p in setup["jax_2x2x2"].items():
        np.testing.assert_array_equal(got[name], p, err_msg=name)


# -- serving ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_answer(setup):
    return support.run_predict(str(setup["wd"]),
                               {"predict": str(setup["wd"] / "ckpt_single")})


@pytest.mark.parametrize("mesh", ["1x2x2", "2x1x1"])
def test_predictor_on_a_mesh_matches_one_process(jobs, one_process_answer,
                                                 mesh):
    want = one_process_answer
    for res in jobs[mesh]:
        got = part(res, "predict")
        for key in ("answer", "many"):
            assert got[key].shape == want[key].shape
            scale = np.abs(want[key]).max()
            assert np.abs(got[key] - want[key]).max() <= 1e-5 * scale, key
        np.testing.assert_array_equal(got["answer"],
                                      part(jobs[mesh][0], "predict")["answer"])
        assert str(got["digest"]) == str(want["digest"])


def test_predict_cli_on_two_processes(setup, tmp_path):
    wd = setup["wd"]
    args = ["predict", "--ckpt-dir", str(wd / "ckpt_single"), "--features",
            str(wd / "corpus.npz"), "--device", "cpu"]
    port = support.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", *args, "--mesh",
             "1,2,1", "--out", str(tmp_path / f"mesh{rank}.npz")],
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
    assert lines0[0] == "distributed: process 0 of 2, 2 global devices (gloo)"
    assert outs[1][0].strip().splitlines() == [
        "distributed: process 1 of 2, 2 global devices (gloo)"]
    assert json.loads(lines0[-1])["steps"] == 140
    assert not (tmp_path / "mesh1.npz").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch", *args, "--out",
         str(tmp_path / "one.npz")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    with np.load(tmp_path / "mesh0.npz") as a, \
            np.load(tmp_path / "one.npz") as b:
        np.testing.assert_array_equal(a["metric_names"], b["metric_names"])
        scale = np.abs(b["predictions"]).max()
        assert np.abs(a["predictions"] - b["predictions"]).max() \
            <= 1e-5 * scale


# -- JAX's F=10240 tensor-parallel case at model=2 ---------------------------

def test_tenk_feature_axis_at_model_2(tmp_path):
    """``tests/test_parallel.py:160-188`` at ``model=2``: F=10240, E=4,
    H=128, W=8, B=8, one epoch; ``w_ih``'s box really halves F; loss,
    eval loss and ``mask_w2`` against the port at one process with JAX's
    tolerances there."""
    spec = {"tenk": True}
    job = run_mesh_job(tmp_path, "tenk", (1, 1, 2), {"tenk": spec})
    single = support.run_scenario(str(tmp_path), spec)
    for res in job:
        got = part(res, "tenk")
        assert tuple(got["w_ih_box"]) == (4, 10240 // 2, 384)
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(got["eval"], single["eval"], rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(got["mask_w2"], single["mask_w2"],
                                   rtol=5e-3, atol=1e-4)


