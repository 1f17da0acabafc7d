"""Elastic remeshing on the CPU under gloo: jobs of spawned ranks lose ranks
to the ``FaultInjector`` behind the trainer's fault barrier, and the
survivors are held against the port's ``resume_training`` on the shrunk job
from the same snapshot (bit for bit) and against the JAX package's elastic
``Trainer`` on the same ``MeshConfig`` and schedule (the 8 virtual CPU
devices; per-step losses within 1e-5 relative, params within 1e-4 of each
leaf's largest magnitude, dropout 0, the ``restored_step`` of every loss
equal).

The jobs (tests/test_torch_elastic_support.py: no JAX in a rank) train f32,
H=8, from JAX-initialized params on the ``make_series_buckets`` corpus
(F=8, E=2, 51 train windows, B=16: 4 steps an epoch, 2 epochs), snapshots
every 2 steps:

- data=4 losing 2 ranks at step 3, at superstep/accumulation (1,1) and
  (2,2): ranks 2 and 3 leave with ``DeviceLossError``, ranks 0 and 1 go on
  at data=2;
- a double loss, ``{3: 2, 7: 1}``, 4 → 2 → 1;
- the attempt budget, ``remesh_max_attempts=1`` and ``{2: 1, 5: 1}`` at
  data=4: the first loss leaves 3 ranks, so data=2 and rank 2 stands down;
  the second raises ``RemeshExhaustedError`` chained to the loss;
- the expert axis kept, 2x2x1 losing 2 → 1x2x1;
- a real death in a 4-rank job: rank 3 SIGKILLs itself after step 3, the
  three survivors notice through gloo (a survivor blocked on a peer that
  has torn its groups down fails over at once), the census finds them,
  data=2 takes ranks 0 and 1 and rank 2 stands down (JAX: the injector
  losing one device at step 3).

The elastic jobs run three at a time while JAX's runs take the test's
process, then one job a reference mesh runs the resumes.  Losses before the first snapshot, a rank killed for real, the
stream and the CLI are tests/test_torch_elastic_stream.py.
"""

import json
import os
import shutil

import numpy as np
import pytest

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.parallel import FaultInjector as JaxFaultInjector
from deeprest_tpu.parallel import RemeshExhaustedError as JaxExhausted
from deeprest_tpu.parallel import make_mesh as jax_make_mesh
from deeprest_tpu.parallel import shard_params as jax_shard_params
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax

import test_torch_elastic_support as es
import test_torch_parallel_support as support

MODEL = dict(hidden_size=8, dropout_rate=0.0)
TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=3, seed=0, log_every_steps=0,
             device_data="always", snapshot_every_steps=2, snapshot_keep=0)
ELASTIC = dict(elastic=True, remesh_backoff_ms=1.0)
# name: (mesh, schedule, superstep, accumulation, extra train fields)
CASES = {
    "s1g1": ((4, 1, 1), {3: 2}, 1, 1, {}),
    "s2g2": ((4, 1, 1), {3: 2}, 2, 2, {}),
    "double": ((4, 1, 1), {3: 2, 7: 1}, 2, 1, {}),
    "budget": ((4, 1, 1), {2: 1, 5: 1}, 1, 1, {"remesh_max_attempts": 1}),
    "expert": ((2, 2, 1), {3: 2}, 1, 1, {}),
    # rank 3 SIGKILLs itself after step 3 (JAX: the injector losing one
    # device at step 3, the same restored step and shrunk mesh)
    "kill": ((4, 1, 1), {3: 1}, 1, 1, {}),
}
KILLED = {"kill": 3}


def train_fields(name: str, ckpt: str, elastic: bool = True) -> dict:
    _, _, s, g, extra = CASES[name]
    return dict(TRAIN, steps_per_superstep=s, grad_accum_windows=g,
                checkpoint_dir=ckpt, **(ELASTIC if elastic else {}), **extra)


def jax_elastic(jbundle, params, name, ckpt):
    """JAX's elastic trainer on the case's mesh and schedule: the trainer,
    the state (None when it raised), the error, the last epoch's losses."""
    mesh, schedule = CASES[name][:2]
    cfg = JaxConfig(model=JaxModelConfig(rnn_backend="scan", **MODEL),
                    train=JaxTrainConfig(**train_fields(name, ckpt)))
    jt = JaxTrainer(cfg, jbundle.feature_dim, jbundle.metric_names,
                    mesh=jax_make_mesh(JaxMeshConfig(*mesh)))
    jt.install_fault_injector(JaxFaultInjector(schedule))
    state = jt.init_state(jbundle.x_train[:1])
    state = state.replace(params=jax_shard_params(
        jt.mesh, {k: np.asarray(params[k]) for k in state.params}))
    losses = []

    def on_epoch(result, st):
        losses.append(np.array(jt._last_epoch_losses))

    try:
        state, _ = jt.fit(jbundle, state=state, on_epoch=on_epoch)
    except JaxExhausted as exc:
        return jt, None, exc, None
    return jt, state, None, losses[-1]


def keep_only(src: str, dst: str, step: int) -> str:
    """A snapshot directory holding only ``src``'s step ``step``: the
    directory a job killed at that snapshot resumes from."""
    os.makedirs(dst)
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    wd = tmp_path_factory.mktemp("elastic")
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                   invocations=data.invocations,
                   space=CallPathSpace.from_dict(data.space.to_dict())
                   ).save(str(wd / "corpus.npz"))
    jbundle = jax_prepare_dataset(data, JaxTrainConfig(**TRAIN))
    assert jbundle.num_train_windows == 51
    jt = JaxTrainer(JaxConfig(model=JaxModelConfig(**MODEL),
                              train=JaxTrainConfig(**TRAIN)),
                    jbundle.feature_dim, jbundle.metric_names)
    params = params_from_jax({k: np.array(v) for k, v in jt.init_state(
        jbundle.x_train[:1]).params.items()})
    np.savez(wd / "params.npz", **{k: v.numpy() for k, v in params.items()})

    def spec(name):
        mesh, schedule = CASES[name][:2]
        job_dir = wd / name
        job_dir.mkdir()
        for f in ("corpus.npz", "params.npz"):
            os.symlink(wd / f, job_dir / f)
        out = {"kind": "fit", "mesh": list(mesh), "model": MODEL,
               "train": train_fields(name, str(job_dir / "snap")),
               "epochs": 2}
        if name in KILLED:
            out["sigkill"] = [KILLED[name], 3]
        else:
            out["lose_at"] = {str(k): v for k, v in schedule.items()}
        with open(job_dir / "spec.json", "w") as fh:
            json.dump(out, fh)
        return int(np.prod(mesh)), str(job_dir)

    # three jobs at a time, JAX's runs of them while their ranks train
    ranks, jax = {}, {}
    names = list(CASES)
    for batch in (names[:3], names[3:]):
        started = es.start_jobs([spec(name) for name in batch])
        for name in batch:
            jax[name] = jax_elastic(jbundle, params, name,
                                    str(wd / f"jax_{name}"))
        ranks.update(zip(batch, es.wait_jobs(
            started, killed={str(wd / n): r for n, r in KILLED.items()})))

    # the port's resume references on the shrunk jobs, from the snapshot
    # each elastic job restored last
    def restored(name):
        return json.loads(str(ranks[name][0]["remesh_history"]))[-1][
            "restored_step"]

    def reference(name):
        cut = keep_only(str(wd / name / "snap"), str(wd / f"{name}_ref"),
                        restored(name))
        return {"model": MODEL, "train": train_fields(name, cut, False),
                "epochs": 2, "resume": cut}

    refs = {}
    for ref_name, mesh, names in (("ref_data2", (2, 1, 1),
                                   ("s1g1", "s2g2", "kill")),
                                  ("ref_expert", (1, 2, 1), ("expert",))):
        ref_dir = wd / ref_name
        ref_dir.mkdir()
        for f in ("corpus.npz", "params.npz"):
            os.symlink(wd / f, ref_dir / f)
        with open(ref_dir / "spec.json", "w") as fh:
            json.dump({"kind": "scenarios", "mesh": list(mesh),
                       "scenarios": {n: reference(n) for n in names}}, fh)
        refs[ref_name] = str(ref_dir)
    started = es.start_jobs([(2, refs["ref_data2"]),
                             (2, refs["ref_expert"])])
    double = support.run_scenario(str(wd), reference("double"))
    ref_ranks = es.wait_jobs(started)
    resumed = {n: [part(r, n) for r in ref_ranks[0]]
               for n in ("s1g1", "s2g2", "kill")}
    resumed["expert"] = [part(r, "expert") for r in ref_ranks[1]]
    resumed["double"] = [double]
    return {"ranks": ranks, "resumed": resumed, "jax": jax, "wd": wd}


def part(results: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in results.items() if k.startswith(pre)}


def done(ranks: list) -> list[dict]:
    """The ranks that finished the run (a SIGKILLed one wrote nothing)."""
    return [r for r in ranks if r is not None and str(r["outcome"]) == "done"]


def leaves(res: dict) -> dict:
    return {k[len("params/"):]: v for k, v in res.items()
            if k.startswith("params/")}


def history(res: dict) -> list[dict]:
    return json.loads(str(res["remesh_history"]))


def assert_jax_close(res: dict, jt, jstate, jlosses):
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5, atol=1e-7)
    got = leaves(res)
    want = {k: np.asarray(v) for k, v in jstate.params.items()}
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    assert int(res["step"]) == int(np.asarray(jstate.step))


@pytest.mark.parametrize("name", ["s1g1", "s2g2", "double", "expert",
                                  "kill"])
def test_survivors_bit_equal_to_resume_on_the_shrunk_job(job, name):
    survivors = done(job["ranks"][name])
    refs = job["resumed"][name]
    assert len(survivors) == len(refs)
    for got, ref in zip(survivors, refs):
        assert leaves(got).keys() == leaves(ref).keys()
        for leaf, value in leaves(ref).items():
            np.testing.assert_array_equal(leaves(got)[leaf], value, leaf)
        np.testing.assert_array_equal(got["losses"], ref["losses"][-4:])
        np.testing.assert_array_equal(got["test_losses"][-1],
                                      ref["test_losses"][-1])
        assert int(got["step"]) == int(ref["step"]) == 8


@pytest.mark.parametrize("name", ["s1g1", "s2g2", "double", "expert",
                                  "kill"])
def test_survivors_match_jax_elastic_trainer(job, name):
    jt, jstate, _, jlosses = job["jax"][name]
    for res in done(job["ranks"][name]):
        assert_jax_close(res, jt, jstate, jlosses)
        ours = history(res)
        assert [h["restored_step"] for h in ours] == \
            [h["restored_step"] for h in jt.remesh_history]
        assert [h["mesh"] for h in ours] == \
            [h["mesh"] for h in jt.remesh_history]
        assert all(h["recovery_s"] > 0 for h in ours)


def test_lost_ranks_leave_and_survivors_keep_their_coordinates(job):
    outcomes = {name: [None if r is None else str(r["outcome"])
                       for r in ranks]
                for name, ranks in job["ranks"].items()}
    # a real death: the census finds 3 ranks, data=2 takes two, and the
    # third stands down
    assert outcomes["kill"] == ["done", "done", "stood_down", None]
    assert all(h["recovery_s"] >= 5.0 for h in history(
        job["ranks"]["kill"][0]))
    assert outcomes["s1g1"] == outcomes["s2g2"] == outcomes["expert"] == [
        "done", "done", "DeviceLossError", "DeviceLossError"]
    assert outcomes["double"] == ["done", "DeviceLossError",
                                  "DeviceLossError", "DeviceLossError"]
    lost = job["ranks"]["double"][1]
    assert "rank 1 of 2 was lost" in str(lost["error"])
    assert [h["mesh"]["data"] for h in history(lost)] == [2]
    for name in ("s1g1", "expert"):
        for rank, res in enumerate(job["ranks"][name][:2]):
            assert int(res["rank"]) == rank
        assert [list(r["mesh"]) for r in job["ranks"][name][:2]] == (
            [[2, 1, 1]] * 2 if name == "s1g1" else [[1, 2, 1]] * 2)
    # the data replicas hold the same params
    a, b = job["ranks"]["s1g1"][:2]
    for leaf, value in leaves(a).items():
        np.testing.assert_array_equal(leaves(b)[leaf], value)


def test_attempt_budget_stands_down_then_exhausts(job):
    r0, r1, r2, r3 = job["ranks"]["budget"]
    assert [str(r["outcome"]) for r in (r0, r1, r2, r3)] == [
        "RemeshExhaustedError", "RemeshExhaustedError", "stood_down",
        "DeviceLossError"]
    for res in (r0, r1):
        assert str(res["cause"]) == "DeviceLossError"
        assert "remesh_max_attempts=1" in str(res["error"])
        assert [h["mesh"]["data"] for h in history(res)] == [2]
    jt, jstate, jexc, _ = job["jax"]["budget"]
    assert jstate is None and isinstance(jexc, JaxExhausted)
    assert str(r0["error"]) == str(jexc)
    assert jt.remesh_count == len(history(r0)) == 1
    # the first loss struck before the first snapshot: both re-initialized
    assert history(r0)[0]["restored_step"] is None
    assert jt.remesh_history[0]["restored_step"] is None
