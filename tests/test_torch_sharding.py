"""The partition-rule table (``deeprest_tpu_torch/parallel/sharding.py``)
against the JAX package's (``deeprest_tpu/parallel/sharding.py``), on the
CPU with no process group.

- JAX's ``tests/test_sharding_rules.py`` cases on the port's leaf names:
  every leaf of a port ``TrainState`` (params, Adam's moments and count,
  step, rng; one and two GRU layers) resolves to the spec JAX resolves for
  the same path of a JAX ``TrainState``, the two name sets equal.
- Strict mode raises JAX's ``KeyError`` on an unmatched leaf; non-strict
  replicates it; scalars never consult the table.
- ``rank_box`` and ``shard_params`` equal JAX's ``devices_indices_map``
  shard of the same device on ``make_mesh(MeshConfig(1, 2, 2))`` and
  ``(2, 2, 2)``, for every leaf and rank; ``all_boxes`` lists JAX's
  distinct shards; ``replica_writer`` picks JAX's ``replica_id == 0``.
- E=40 on ``expert=3`` raises in both packages, in the same words.
- A ``QuantileGRU`` on a mesh holds the boxes, from whole params or from
  the boxes themselves; ``params_from_jax(mesh=...)`` cuts them; the
  collectives are identities on an axis of one rank.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import make_series_buckets
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.parallel import make_mesh as jax_make_mesh
from deeprest_tpu.parallel import match_partition_rules as jax_match
from deeprest_tpu.parallel import shard_params as jax_shard_params
from deeprest_tpu.parallel import state_specs as jax_state_specs
from deeprest_tpu.parallel.sharding import leaf_path_name as jax_leaf_name
from deeprest_tpu.train import Trainer as JaxTrainer
from deeprest_tpu.train import prepare_dataset as jax_prepare_dataset
from deeprest_tpu_torch.config import Config, MeshConfig, ModelConfig
from deeprest_tpu_torch.config import TrainConfig
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.models.qrnn import QuantileGRU, param_shapes
from deeprest_tpu_torch.parallel import (
    PARTITION_RULES, Mesh, copy_replicated, gather_along, match_partition_rules,
    max_replicated, param_specs, rank_box, reduce_replicated, shard_params,
    state_specs, sum_partials,
)
from deeprest_tpu_torch.parallel.sharding import (
    all_boxes, leaf_path_name, replica_writer, spec_of,
)
from deeprest_tpu_torch.train.trainer import Trainer

from test_sharding_rules import TINY


@pytest.fixture(scope="module")
def jbundle():
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    return jax_prepare_dataset(data, TINY.train)


def jax_named_specs(state) -> dict:
    specs = jax_state_specs(state)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax_leaf_name(path): tuple(spec) for path, spec in flat}


def port_state(layers: int, feature_dim: int, metrics: list[str]):
    cfg = Config(model=ModelConfig(hidden_size=8, num_layers=layers),
                 train=TrainConfig(batch_size=16, window_size=12))
    trainer = Trainer(cfg, feature_dim, metrics, device="cpu")
    return trainer, trainer.init_state()


@pytest.mark.parametrize("layers", [1, 2])
def test_rule_table_resolves_every_leaf_as_jax_does(jbundle, layers):
    cfg = TINY.replace(model=dataclasses.replace(TINY.model,
                                                 num_layers=layers))
    jt = JaxTrainer(cfg, jbundle.feature_dim, jbundle.metric_names)
    want = jax_named_specs(jt.init_state(jbundle.x_train))
    trainer, state = port_state(layers, jbundle.feature_dim,
                                jbundle.metric_names)
    got = state_specs(trainer.state_leaves(state))
    assert got == want
    assert got["params/gru_fwd_w_ih"] == ("expert", "model", None)
    assert got["params/mask_w2"] == ("expert", None, "model")
    assert got["opt_state/0/nu/mask_b2"] == ("expert", "model")
    if layers == 2:
        assert got["params/gru_fwd_l1_w_ih"] == ("expert", None, None)
        assert got["opt_state/0/mu/gru_bwd_l1_w_hh"] == (
            "expert", None, None)
    assert got["step"] == got["rng"] == got["opt_state/0/count"] == ()
    assert [tuple(spec) for _, spec in PARTITION_RULES] == [
        tuple(spec) for _, spec in
        __import__("deeprest_tpu.parallel.sharding",
                   fromlist=["x"]).PARTITION_RULES]
    # the param slice of the table, and one leaf by its name and shape
    assert param_specs(state.params) == {
        k[len("params/"):]: v for k, v in got.items()
        if k.startswith("params/")}
    assert spec_of("opt_state/0/mu/head_w", (2, 32, 3)) == (
        "expert", None, None)


def test_strict_mode_raises_on_unmatched_leaf():
    leaf = {"mystery_leaf": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError) as jax_err:
        jax_match(leaf)
    with pytest.raises(KeyError) as port_err:
        match_partition_rules(leaf)
    assert str(port_err.value) == str(jax_err.value)
    assert "mystery_leaf" in str(port_err.value)
    assert match_partition_rules(leaf, strict=False) == {"mystery_leaf": ()}
    assert match_partition_rules({"unnamed_scalar": np.float32(3.0)}) == \
        {"unnamed_scalar": ()}
    assert leaf_path_name(["opt_state", 0, "mu", "head_w"]) == \
        "opt_state/0/mu/head_w"


def port_mesh(cfg: MeshConfig, rank: int) -> Mesh:
    return Mesh(cfg, rank, torch.device("cpu"))


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2), (1, 2, 1),
                                   (1, 1, 2)])
def test_rank_boxes_equal_jax_shards(shape):
    """Every rank's box of every leaf (E=4, F=16, H=8, two layers) is the
    index JAX's sharding gives the same device of the same mesh; the
    manifest's box list is JAX's distinct shards; the writers are JAX's
    replica 0."""
    mc = ModelConfig(feature_dim=16, num_metrics=4, hidden_size=8,
                     num_layers=2)
    shapes = param_shapes(mc)
    rng = np.random.default_rng(0)
    params = {k: rng.random(v).astype(np.float32) for k, v in shapes.items()}
    jmesh = jax_make_mesh(JaxMeshConfig(*shape))
    jparams = jax_shard_params(jmesh, params)
    cfg = MeshConfig(*shape)
    devices = list(jmesh.devices.flat)
    for name, arr in jparams.items():
        spec = spec_of(name, shapes[name])
        index = arr.sharding.devices_indices_map(arr.shape)
        replica0 = {s.device: s.replica_id == 0
                    for s in arr.addressable_shards}
        data = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for rank, device in enumerate(devices):
            mesh = port_mesh(cfg, rank)
            want = tuple(sl.indices(d)[:2]
                         for sl, d in zip(index[device], arr.shape))
            assert rank_box(mesh, spec, arr.shape, name) == want, (name, rank)
            np.testing.assert_array_equal(
                shard_params(mesh, params)[name], data[device])
            assert replica_writer(mesh, spec) == replica0[device], (name,
                                                                    rank)
        distinct = {tuple(sl.indices(d)[:2] for sl, d in zip(idx, arr.shape))
                    for idx in index.values()}
        assert set(all_boxes(cfg, spec, arr.shape)) == distinct
        assert len(all_boxes(cfg, spec, arr.shape)) == len(distinct)


def test_expert_axis_that_does_not_divide_raises_in_both():
    leaf = {"mask_w1": np.zeros((40, 8), np.float32)}
    with pytest.raises(ValueError) as jax_err:
        jax_shard_params(jax_make_mesh(JaxMeshConfig(expert=3)), leaf)
    with pytest.raises(ValueError) as port_err:
        shard_params(port_mesh(MeshConfig(expert=3), 0), leaf)
    words = ("should be divisible by 3, but it is equal to 40 (full shape: "
             "(40, 8))")
    assert words in str(jax_err.value) and words in str(port_err.value)
    assert "'mask_w1'" in str(port_err.value) and "'expert'" in str(
        port_err.value)
    cfg = Config(model=ModelConfig(hidden_size=8),
                 train=TrainConfig(batch_size=16),
                 mesh=MeshConfig(model=3))
    with pytest.raises(ValueError, match="mesh axis 'model'"):
        Trainer(cfg, 16, ["a", "b"], mesh=port_mesh(cfg.mesh, 0))


def test_module_on_a_mesh_holds_its_boxes():
    mc = ModelConfig(feature_dim=16, num_metrics=4, hidden_size=8)
    shapes = param_shapes(mc)
    rng = np.random.default_rng(1)
    params = {k: rng.random(v).astype(np.float32) for k, v in shapes.items()}
    mesh = port_mesh(MeshConfig(1, 2, 2), 3)         # expert 1, model 1
    whole = QuantileGRU(mc, device="cpu", mesh=mesh).load_params(params)
    boxes = QuantileGRU(mc, device="cpu", mesh=mesh).load_params(
        shard_params(mesh, params))
    assert (whole.experts, whole.features) == (slice(2, 4), slice(8, 16))
    for name, p in whole.params().items():
        want = shard_params(mesh, params)[name]
        assert tuple(p.shape) == want.shape
        np.testing.assert_array_equal(p.detach().numpy(), want)
        np.testing.assert_array_equal(boxes.params()[name].detach().numpy(),
                                      want)
    assert whole.params()["gru_bwd_w_ih"].shape == (2, 8, 24)
    # JAX's init crosses cut to the rank's boxes
    cut = params_from_jax(params, mesh=mesh)
    assert cut.keys() == params.keys()
    for name, value in shard_params(mesh, params).items():
        np.testing.assert_array_equal(cut[name].numpy(), value)
        assert cut[name].is_contiguous()
    with pytest.raises(ValueError, match="process groups it lacks"):
        whole(torch.zeros((1, 4, 16)))
    with pytest.raises(ValueError, match=r"its box here \(2, 8\)"):
        QuantileGRU(mc, device="cpu", mesh=mesh).load_params(
            dict(params, mask_b2=np.zeros((4, 8), np.float32)))


def test_collectives_are_identities_on_an_axis_of_one_rank():
    x = torch.randn(3, 4, requires_grad=True)
    for op in (sum_partials, reduce_replicated, copy_replicated):
        y = op(x, None)
        assert y is x
    assert gather_along(x, 0, None) is x
    torch.testing.assert_close(max_replicated(x, None), x.detach())
    assert not max_replicated(x, None).requires_grad
