"""Elastic remeshing on the CPU under gloo, the rest of the cases: a loss
before the first snapshot, a rank killed for real (SIGKILL, no injector),
the streaming trainer's remesh, and the ``train`` and ``stream`` commands
as env:// jobs.  The jobs are tests/test_torch_elastic_support.py's (no JAX
in a rank) on the corpus and params of tests/test_torch_elastic_gloo.py.

- A loss at step 1 of a data=2 job, before anything durable exists: the
  survivor re-initializes on data=1 (``restored_step`` None, as JAX's
  elastic trainer on the same mesh and schedule) and runs all 8 steps, bit
  for bit a one-process ``fit`` from the same init.
- Rank 1 of a data=2 job SIGKILLs itself in ``on_step`` at step 3: rank 0
  notices through gloo, takes the census alone, rejoins as a job of one,
  restores its newest snapshot and finishes bit for bit a one-process
  ``resume_training`` from that snapshot.
- ``tests/test_chaos.py::test_stream_elastic_remesh_defers_refresh`` on
  data=2 → 1: the queued manual trigger survives, the refresh completes,
  ``ready()`` is False while the remesh is in flight; JAX's stream on
  ``MeshConfig(data=2)`` ends the same way.
- ``train --elastic --mesh 2,1,1`` as two env:// processes with no loss
  is bit for bit the same command without ``--elastic``; ``stream
  --elastic`` as two env:// processes refreshes once (rank 0 reads the
  file and prints) as the one-process stream does.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.data.schema import Bucket as JaxBucket
from deeprest_tpu.data.schema import MetricSample as JaxMetricSample
from deeprest_tpu.data.schema import save_raw_data_jsonl
from deeprest_tpu.parallel import FaultInjector as JaxFaultInjector
from deeprest_tpu.parallel import make_mesh as jax_make_mesh
from deeprest_tpu.parallel import shard_params as jax_shard_params
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.stream import StreamConfig as JaxStreamConfig
from deeprest_tpu.train.stream import StreamingTrainer as JaxStreamingTrainer
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

import test_torch_elastic_support as es
import test_torch_parallel_support as support

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(hidden_size=8, dropout_rate=0.0)
TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=3, seed=0, log_every_steps=0,
             device_data="always", steps_per_superstep=1,
             snapshot_keep=0)
ELASTIC = dict(elastic=True, remesh_backoff_ms=1.0)
FIT = {
    # a loss before anything durable exists
    "presnap": dict(lose_at={"1": 1},
                    train=dict(TRAIN, snapshot_every_steps=100, **ELASTIC)),
    # rank 1 SIGKILLs itself after step 3
    "sigkill": dict(sigkill=[1, 3],
                    train=dict(TRAIN, snapshot_every_steps=2, **ELASTIC)),
}


def job_dir(wd, name):
    d = wd / name
    d.mkdir()
    for f in ("corpus.npz", "params.npz"):
        os.symlink(wd / f, d / f)
    return d


def jax_presnap(jbundle, params, ckpt):
    cfg = JaxConfig(model=JaxModelConfig(rnn_backend="scan", **MODEL),
                    train=JaxTrainConfig(**dict(FIT["presnap"]["train"],
                                                checkpoint_dir=ckpt)))
    jt = JaxTrainer(cfg, jbundle.feature_dim, jbundle.metric_names,
                    mesh=jax_make_mesh(JaxMeshConfig(data=2)))
    jt.install_fault_injector(JaxFaultInjector({1: 1}))
    state = jt.init_state(jbundle.x_train[:1])
    state = state.replace(params=jax_shard_params(
        jt.mesh, {k: np.asarray(params[k]) for k in state.params}))
    state, _ = jt.fit(jbundle, state=state)
    return jt, state


def jax_stream(ckpt):
    """``tests/test_chaos.py``'s stream scenario on ``MeshConfig(data=2)``,
    losing one device: (first refresh, second refresh, trainer)."""
    cfg = JaxConfig(
        model=JaxModelConfig(feature_dim=32, hidden_size=8,
                             dropout_rate=0.0),
        train=JaxTrainConfig(batch_size=8, window_size=6, seed=0,
                             eval_stride=1, eval_max_cycles=2,
                             log_every_steps=0, snapshot_every_steps=2,
                             steps_per_superstep=1, device_data="always",
                             elastic=True, remesh_backoff_ms=1.0),
        mesh=JaxMeshConfig(data=2))
    st = JaxStreamingTrainer(
        cfg, JaxStreamConfig(refresh_buckets=30, finetune_epochs=1,
                             history_max=64, eval_holdout=4),
        ckpt_dir=ckpt,
        feature_config=JaxFeaturizeConfig(hash_features=True, capacity=32))
    rng = np.random.default_rng(0)

    def feed(n):
        for _ in range(n):
            st.ingest(JaxBucket(traces=[], metrics=[
                JaxMetricSample("svc", "cpu", float(rng.random()))]))

    feed(40)
    r1 = st.refresh()
    st.request_refresh("manual")
    st.trainer.install_fault_injector(
        JaxFaultInjector({st.trainer._global_step + 2: 1}))
    feed(40)
    assert st.ready()
    return r1, st.refresh(), st.trainer


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    wd = tmp_path_factory.mktemp("elastic_stream")
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             JaxFeaturizeConfig(round_to=8))
    FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                   invocations=data.invocations,
                   space=CallPathSpace.from_dict(data.space.to_dict())
                   ).save(str(wd / "corpus.npz"))
    jbundle = jax_prepare_dataset(data, JaxTrainConfig(**TRAIN))
    jt = JaxTrainer(JaxConfig(model=JaxModelConfig(**MODEL),
                              train=JaxTrainConfig(**TRAIN)),
                    jbundle.feature_dim, jbundle.metric_names)
    params = params_from_jax({k: np.array(v) for k, v in jt.init_state(
        jbundle.x_train[:1]).params.items()})
    np.savez(wd / "params.npz", **{k: v.numpy() for k, v in params.items()})
    jobs = []
    for name, spec in FIT.items():
        d = job_dir(wd, name)
        spec = dict(spec, kind="fit", mesh=[2, 1, 1], model=MODEL, epochs=2)
        spec["train"] = dict(spec["train"], checkpoint_dir=str(d / "snap"))
        with open(d / "spec.json", "w") as fh:
            json.dump(spec, fh)
        jobs.append((2, str(d)))
    d = job_dir(wd, "stream")
    with open(d / "spec.json", "w") as fh:
        json.dump({"kind": "stream", "mesh": [2, 1, 1], "lose": 1}, fh)
    jobs.append((2, str(d)))
    started = es.start_jobs(jobs)
    # the references while the ranks run: JAX's, and the one-process fit
    # from the port's own init a re-initialized survivor must equal
    jax = {"presnap": jax_presnap(jbundle, params, str(wd / "jax_presnap")),
           "stream": jax_stream(str(wd / "jax_stream"))}
    cfg = Config(model=ModelConfig(**MODEL),
                 train=TrainConfig(**dict(TRAIN, checkpoint_dir=str(
                     wd / "fresh"), snapshot_every_steps=100)))
    bundle = prepare_dataset(FeaturizedData.load(str(wd / "corpus.npz")),
                             cfg.train)
    fresh = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                    device="cpu")
    fresh_losses = []
    fresh_state, fresh_hist = fresh.fit(
        bundle, on_epoch=lambda r, s: fresh_losses.append(
            fresh.last_epoch_losses))
    results = es.wait_jobs(started, killed={str(wd / "sigkill"): 1})
    ranks = dict(zip(list(FIT) + ["stream"], results))
    restored = json.loads(str(ranks["sigkill"][0]["remesh_history"]))[0][
        "restored_step"]
    cut = str(wd / "sigkill_ref")
    os.makedirs(cut)
    shutil.copytree(wd / "sigkill" / "snap" / f"step_{restored:08d}",
                    os.path.join(cut, f"step_{restored:08d}"))
    resumed = support.run_scenario(str(wd), {
        "model": MODEL, "epochs": 2, "resume": cut,
        "train": dict(TRAIN, snapshot_every_steps=2, checkpoint_dir=cut)})
    return {"ranks": ranks, "jax": jax, "wd": wd, "resumed": resumed,
            "fresh": (fresh_state, fresh_hist, fresh_losses)}


def leaves(res: dict) -> dict:
    return {k[len("params/"):]: v for k, v in res.items()
            if k.startswith("params/")}


def history(res: dict) -> list[dict]:
    return json.loads(str(res["remesh_history"]))


def test_loss_before_the_first_snapshot_reinitializes(job):
    r0, r1 = job["ranks"]["presnap"]
    assert str(r1["outcome"]) == "DeviceLossError"
    assert str(r0["outcome"]) == "done"
    (h,) = history(r0)
    jt, jstate = job["jax"]["presnap"]
    assert h["restored_step"] is None
    assert jt.last_remesh["restored_step"] is None
    assert h["mesh"] == jt.last_remesh["mesh"] == {"data": 1, "expert": 1,
                                                    "model": 1}
    assert int(r0["step"]) == int(np.asarray(jstate.step)) == 8
    state, hist, losses = job["fresh"]
    for name, value in state.params.items():
        np.testing.assert_array_equal(leaves(r0)[name], value.detach().numpy(),
                                      name)
    np.testing.assert_array_equal(r0["losses"], losses[-1])
    assert float(r0["test_losses"][-1]) == hist[-1].test_loss


def test_rank_killed_for_real_is_survived_in_process(job):
    r0, r1 = job["ranks"]["sigkill"]
    assert r1 is None                   # SIGKILLed: it wrote nothing
    assert str(r0["outcome"]) == "done"
    (h,) = history(r0)
    assert h["restored_step"] == 2
    assert h["mesh"] == {"data": 1, "expert": 1, "model": 1}
    # the census waited out the dead rank's check-in
    assert h["recovery_s"] >= 5.0
    ref = job["resumed"]
    for name, value in leaves(ref).items():
        np.testing.assert_array_equal(leaves(r0)[name], value, name)
    np.testing.assert_array_equal(r0["losses"], ref["losses"][-4:])
    assert int(r0["step"]) == int(ref["step"]) == 8


def test_stream_remesh_defers_the_refresh(job):
    r0, r1 = job["ranks"]["stream"]
    jr1, jr2, jtr = job["jax"]["stream"]
    assert str(r1["outcome"]) == "DeviceLossError"
    assert str(r0["outcome"]) == "done"
    assert int(r0["mesh_before"]) == 2 and bool(r0["ready"])
    assert list(r0["ready_in_flight"]) == [False]
    assert str(r0["r2_trigger"]) == jr2.trigger == "manual"
    assert int(r0["r2_refresh"]) == int(r0["r1_refresh"]) + 1 == \
        jr2.refresh == jr1.refresh + 1
    assert int(r0["mesh_after"]) == dict(jtr.mesh.shape)["data"] == 1
    assert len(history(r0)) == jtr.remesh_count == 1
    assert history(r0)[0]["restored_step"] == \
        jtr.last_remesh["restored_step"]
    assert np.isfinite(float(r0["r2_eval_loss"]))
    assert not bool(r0["in_flight"]) and not jtr.remesh_in_flight


def _spawn(argv, rank, port, world=2):
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
               LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "deeprest_tpu_torch",
                             *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(procs, timeout=180):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


def test_train_and_stream_commands_as_two_process_jobs(job, tmp_path):
    wd = job["wd"]
    train = ["train", "--features", str(wd / "corpus.npz"), "--epochs", "2",
             "--batch-size", "16", "--window", "12", "--hidden-size", "8",
             "--dropout", "0", "--steps-per-superstep", "1",
             "--no-baselines", "--device", "cpu", "--mesh", "2,1,1",
             "--snapshot-every-steps", "2"]
    raw = str(tmp_path / "raw.jsonl")
    save_raw_data_jsonl(make_series_buckets(60, seed=6), raw)
    stream = ["stream", "--raw", raw, "--capacity", "32", "--window", "6",
              "--hidden-size", "8", "--batch-size", "8",
              "--refresh-buckets", "12", "--finetune-epochs", "1",
              "--eval-holdout", "2", "--poll-interval", "0.05",
              "--device", "cpu", "--max-refreshes", "1", "--elastic",
              "--snapshot-every-steps", "2"]
    runs = {"elastic": train + ["--elastic", "--ckpt-dir",
                                str(tmp_path / "e")],
            "plain": train + ["--ckpt-dir", str(tmp_path / "p")],
            "stream": stream + ["--ckpt-dir", str(tmp_path / "s")]}
    procs = {}
    for name, argv in runs.items():
        port = support.free_port()
        procs[name] = [_spawn(argv, r, port) for r in range(2)]
    procs["stream1"] = [subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", *stream, "--ckpt-dir",
         str(tmp_path / "s1")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    outs = {name: _finish(ps) for name, ps in procs.items()}
    for name, ps in procs.items():
        assert [p.returncode for p in ps] == [0] * len(ps), outs[name]
    lines = {name: [o[0].strip().splitlines() for o in out]
             for name, out in outs.items()}
    for name in ("elastic", "plain", "stream"):
        assert lines[name][1] == [
            "distributed: process 1 of 2, 2 global devices (gloo)"]
    elastic = json.loads(lines["elastic"][0][-1])
    plain = json.loads(lines["plain"][0][-1])
    assert elastic["remeshes"] == plain["remeshes"] == 0
    assert elastic["mesh"] == {"data": 2, "expert": 1, "model": 1}
    for key in ("epoch_losses", "test_losses", "step_losses", "steps",
                "report"):
        assert elastic[key] == plain[key], key
    two, one = (json.loads(lines[n][0][-1]) for n in ("stream", "stream1"))
    assert two["refresh"] == one["refresh"] == 1
    assert two["remeshes"] == 0 and two["buckets"] == one["buckets"]
    assert two["steps"] == one["steps"]
    np.testing.assert_allclose([two["train_loss"], two["eval_loss"]],
                               [one["train_loss"], one["eval_loss"]],
                               rtol=1e-4)
