"""The mesh's expert and model axes (parallel/sharding.py,
parallel/collectives.py) on the CPU under gloo: training against the JAX
package's ``Trainer`` on the same ``MeshConfig`` and the port at one
process.

One module-scoped spawned job a mesh (tests/test_torch_parallel_support.py:
factories and scenarios with no JAX import): 1x2x1 and 1x1x2 (two ranks)
and 2x1x2 (four).  Each trains f32, H=8, from JAX-initialized params on
the ``make_series_buckets`` corpus (F=8, E=2, 51 train windows, B=16):
against JAX's ``Trainer`` on the same mesh at dropout 0 over 2 epochs and
against the port at one process (dropout 0 and 0.5, the three
accumulation modes at G=2), per-step losses within 1e-5 relative and
params within 1e-4 of each leaf's largest magnitude (the data axis's
tolerances in tests/test_torch_parallel.py: the re-associated sums over
the expert and model groups stay far inside them), the first update's
gradients within 1e-5 of each leaf's scale, and the params bit-equal
across the replicas of every axis.  The
rank layout is JAX's C order.  A 2x2x2 job (eight ranks) against one
process is marked slow.  Checkpoints and serving on these meshes are
tests/test_torch_sharded_ckpt.py.
"""

import json
import os

import numpy as np
import pytest

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.parallel import make_mesh as jax_make_mesh
from deeprest_tpu.parallel import shard_params as jax_shard_params
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import MeshConfig, ModelConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.parallel.mesh import axis_ranks, rank_coords

import test_torch_parallel_support as support

EPOCH_STEPS = 4          # ceil(51 train windows / 16)
MODEL = dict(hidden_size=8, dropout_rate=0.0)
TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=3, seed=0, log_every_steps=0,
             steps_per_superstep=1)
ACCUM = ("exact", "flat", "loop")
MESHES = {"1x2x1": (1, 2, 1), "1x1x2": (1, 1, 2), "2x1x2": (2, 1, 2)}


def scenario(epochs=2, model=None, **train):
    return {"model": dict(MODEL, **(model or {})),
            "train": dict(TRAIN, **train), "epochs": epochs}


SCENARIOS = {
    "base": dict(scenario(), grads=True),
    "dropout": scenario(epochs=1, model=dict(dropout_rate=0.5)),
    **{f"accum_{m}": scenario(epochs=1, grad_accum_windows=2,
                              grad_accum_mode=m) for m in ACCUM},
}


def part(results: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in results.items() if k.startswith(pre)}


def leaves(res: dict, kind: str) -> dict:
    pre = kind + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def assert_leaves_close(got, want, tol):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err)


def jax_config(mesh=(1, 1, 1), epochs=2):
    return JaxConfig(model=JaxModelConfig(rnn_backend="scan", **MODEL),
                     train=JaxTrainConfig(device_data="always",
                                          **dict(TRAIN, num_epochs=epochs)),
                     mesh=JaxMeshConfig(*mesh))


def jax_trainer(jbundle, mesh, epochs=2):
    return JaxTrainer(jax_config(mesh, epochs), jbundle.feature_dim,
                      jbundle.metric_names,
                      mesh=jax_make_mesh(JaxMeshConfig(*mesh)))


def jax_fit(jbundle, params, mesh, epochs=2):
    """JAX's trainer on ``mesh`` from the shared params: (params, per-step
    losses, trainer, state)."""
    jt = jax_trainer(jbundle, mesh, epochs)
    state = jt.init_state(jbundle.x_train[:1])
    state = state.replace(params=jax_shard_params(
        jt.mesh, {k: np.asarray(params[k]) for k in state.params}))
    losses = []

    def on_epoch(result, st):
        losses.append(np.array(jt._last_epoch_losses))

    state, _ = jt.fit(jbundle, state=state, on_epoch=on_epoch)
    return ({k: np.asarray(v) for k, v in state.params.items()},
            np.concatenate(losses), jt, state)


def run_mesh_job(wd, name, mesh, scenarios) -> list[dict]:
    job = wd / name
    job.mkdir()
    for f in ("corpus.npz", "params.npz"):
        if (wd / f).exists():
            os.symlink(wd / f, job / f)
    with open(job / "spec.json", "w") as fh:
        json.dump({"mesh": list(mesh), "scenarios": scenarios}, fh)
    return support.run_job(int(np.prod(mesh)), str(job))


def make_corpus(wd):
    """The ``make_series_buckets`` corpus in ``wd/corpus.npz`` and JAX's
    init in ``wd/params.npz``; returns JAX's bundle and the params."""
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                   invocations=data.invocations,
                   space=CallPathSpace.from_dict(data.space.to_dict())
                   ).save(str(wd / "corpus.npz"))
    jbundle = jax_prepare_dataset(data, jax_config().train)
    assert jbundle.num_train_windows == 51
    assert (jbundle.feature_dim, len(jbundle.metric_names)) == (8, 2)
    jt = jax_trainer(jbundle, (1, 1, 1))
    params = params_from_jax({k: np.array(v) for k, v in jt.init_state(
        jbundle.x_train[:1]).params.items()})
    np.savez(wd / "params.npz", **{k: v.numpy() for k, v in params.items()})
    return jbundle, params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, JAX's init and the port's one-process runs of every
    scenario."""
    wd = tmp_path_factory.mktemp("axes")
    jbundle, params = make_corpus(wd)
    single = {name: support.run_scenario(str(wd), sc)
              for name, sc in SCENARIOS.items()}
    return {"wd": wd, "jbundle": jbundle, "params": params,
            "single": single}


@pytest.fixture(scope="module")
def jobs(setup):
    """Every mesh's job, and JAX's trainer on each mesh."""
    out = {name: run_mesh_job(setup["wd"], name, mesh, SCENARIOS)
           for name, mesh in MESHES.items()}
    out["jax"] = {name: jax_fit(setup["jbundle"], setup["params"], mesh)[:2]
                  for name, mesh in MESHES.items()}
    return out


# -- the rank layout --------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 2, 2), (2, 1, 2), (4, 2, 1)])
def test_rank_coords_follow_jax_c_order(mesh):
    """Rank r sits where JAX's ``reshape(data, expert, model)`` of the
    device list puts device r; each axis group holds the ranks that share
    the other two coordinates."""
    cfg = MeshConfig(*mesh)
    grid = np.arange(cfg.size).reshape(mesh)
    for r in range(cfg.size):
        assert grid[rank_coords(cfg, r)] == r
    assert axis_ranks(cfg, "data") == [
        list(grid[:, e, m]) for e in range(mesh[1]) for m in range(mesh[2])]
    assert axis_ranks(cfg, "expert") == [
        list(grid[d, :, m]) for d in range(mesh[0]) for m in range(mesh[2])]
    assert axis_ranks(cfg, "model") == [
        list(grid[d, e, :]) for d in range(mesh[0]) for e in range(mesh[1])]


# -- training against JAX and one process -----------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_jax_trainer_on_the_same_mesh(jobs, setup, mesh):
    got = part(jobs[mesh][0], "base")
    want_params, want_losses = jobs["jax"][mesh]
    assert int(got["step"]) == 2 * EPOCH_STEPS
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_leaves_close(leaves(got, "params"), want_params, 1e-4)


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_matches_one_process(jobs, setup, mesh, name):
    got = part(jobs[mesh][0], name)
    want = setup["single"][name]
    assert int(got["step"]) == int(want["step"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["test_losses"], want["test_losses"],
                               rtol=1e-5)
    assert_leaves_close(leaves(got, "params"), leaves(want, "params"), 1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_update_gradients_match_one_process(jobs, setup, mesh):
    got = leaves(part(jobs[mesh][0], "base"), "grads")
    want = leaves(setup["single"]["base"], "grads")
    assert got and got.keys() == want.keys()
    assert_leaves_close(got, want, 1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_params_bit_equal_across_replicas(jobs, mesh):
    """Ranks holding the same box of a leaf (the replicas along the axes
    it is not sharded on) hold the same bits; every rank gathers the same
    whole params, losses and test losses."""
    ranks = jobs[mesh]
    cfg = MeshConfig(*(int(x) for x in mesh.split("x")))
    from deeprest_tpu_torch.models.qrnn import param_shapes
    from deeprest_tpu_torch.parallel.sharding import spec_of

    shapes = param_shapes(ModelConfig(feature_dim=8, num_metrics=2,
                                      hidden_size=8))
    for key in ranks[0]:
        if key.split("/", 1)[1].startswith(("params/", "losses",
                                            "test_losses")):
            for res in ranks[1:]:
                np.testing.assert_array_equal(res[key], ranks[0][key],
                                              err_msg=key)
    for name, shape in shapes.items():
        spec = spec_of(name, shape)
        boxes = {}
        for r, res in enumerate(ranks):
            d, e, m = rank_coords(cfg, r)
            key = tuple(c for axis, c in zip(("data", "expert", "model"),
                                             (d, e, m)) if axis in spec)
            local = res[f"base/local/{name}"]
            if key in boxes:
                np.testing.assert_array_equal(local, boxes[key],
                                              err_msg=(name, r))
            boxes[key] = local
        assert len(boxes) == np.prod([getattr(cfg, a) for a in spec
                                      if a is not None] or [1])
    assert str(ranks[-1]["base/captured_refusal"]).startswith(
        "steps_per_superstep resolves to 2")


# -- eight ranks ------------------------------------------------------------

@pytest.mark.slow
def test_2x2x2_losses_match_one_process(setup):
    """The port's counterpart of ``test_mesh_shape_loss_parity_one_executable``:
    eight gloo ranks on 2x2x2 against one process, losses 1e-5 relative,
    params 1e-4 of leaf scale."""
    job = run_mesh_job(setup["wd"], "2x2x2", (2, 2, 2),
                       {"base": SCENARIOS["base"]})
    got = part(job[0], "base")
    want = setup["single"]["base"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert_leaves_close(leaves(got, "params"), leaves(want, "params"), 1e-4)
    assert_leaves_close(leaves(got, "grads"), leaves(want, "grads"), 1e-5)
