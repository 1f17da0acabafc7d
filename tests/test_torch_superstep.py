"""The port's supersteps against its per-step loop and against the JAX
package's supersteps, on the CPU.

- ``_superstep_len`` and ``_epoch_plan``: equal to the JAX trainer's.
- Port S in {2, "epoch", "auto"} against the port's S=1, dropout 0.5: bit
  for bit in per-step losses and params (the CPU runs the superstep as a
  plain loop over the same update code; its dropout stream is a function
  of the step).
- Port against JAX at the same S, dropout 0, from identical params (the
  JAX side stages its data, ``device_data="always"``, and runs its
  ``scan`` backend in f32): per-step losses within 1e-5 relative, params
  within 1e-4 of each leaf's largest magnitude.
- The epoch plan's device buffers, the launch ledger of a captured update,
  the capture's error naming its op, and a resume cursor off a superstep
  boundary refused.
"""

import numpy as np
import pytest
import torch

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch import graphs
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.graphs import EpochPlan
from deeprest_tpu_torch.train.trainer import Trainer

TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=4, seed=0, log_every_steps=3)


def configs(dropout=0.0, **train):
    train = dict(TRAIN, **train)
    model = dict(hidden_size=8, dropout_rate=dropout)
    return (JaxConfig(model=JaxModelConfig(rnn_backend="scan", **model),
                      train=JaxTrainConfig(device_data="always", **train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    """(JAX FeaturizedData, port FeaturizedData) of one small corpus."""
    data = featurize_buckets(make_series_buckets(150, seed=4),
                             FeaturizeConfig(round_to=8))
    port = FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(data.space.to_dict()))
    return data, port


@pytest.fixture(scope="module")
def init_params(corpus):
    """JAX-initialized params (numpy) of the corpus's model."""
    jcfg, _ = configs()
    jb = jax_prepare_dataset(corpus[0], jcfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    state = jt.init_state(jb.x_train[:1])
    return {k: np.array(v) for k, v in state.params.items()}


def port_run(corpus, params, dropout=0.0, **train):
    """Fit the port for TRAIN's epochs; (per-step losses, numpy params,
    trainer, state)."""
    _, cfg = configs(dropout, **train)
    bundle = prepare_dataset(corpus[1], cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    losses = []
    state, _ = trainer.fit(
        bundle, state=trainer.init_state(params_from_jax(params)),
        on_epoch=lambda r, s: losses.append(trainer.last_epoch_losses))
    return (np.concatenate(losses),
            {k: v.detach().numpy().copy() for k, v in state.params.items()},
            trainer, state)


def jax_run(corpus, **train):
    jcfg, _ = configs(0.0, **train)
    bundle = jax_prepare_dataset(corpus[0], jcfg.train)
    trainer = JaxTrainer(jcfg, bundle.feature_dim, bundle.metric_names)
    losses = []
    state, _ = trainer.fit(
        bundle, state=trainer.init_state(bundle.x_train[:1]),
        on_epoch=lambda r, s: losses.append(
            np.array(trainer._last_epoch_losses)))
    return (np.concatenate(losses),
            {k: np.asarray(v) for k, v in state.params.items()}, state)


def assert_params_close(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("num_steps", [1, 3, 4, 7, 50, 200])
@pytest.mark.parametrize("train", [
    dict(steps_per_superstep="auto"), dict(steps_per_superstep="epoch"),
    dict(steps_per_superstep=5), dict(steps_per_superstep="auto",
                                      log_every_steps=0),
    dict(steps_per_superstep=3, grad_accum_windows=2),
    dict(steps_per_superstep="auto", grad_accum_windows=4)],
    ids=["auto", "epoch", "5", "auto-nolog", "3-g2", "auto-g4"])
def test_superstep_len_matches_jax(corpus, train, num_steps):
    jcfg, cfg = configs(**train)
    jt = JaxTrainer(jcfg, 8, ["a_cpu"])
    pt = Trainer(cfg, 8, ["a_cpu"], device="cpu")
    assert pt._superstep_len(num_steps) == jt._superstep_len(num_steps)


@pytest.mark.parametrize("s", [1, 3, 16])
def test_epoch_plan_matches_jax(s):
    jcfg, cfg = configs()
    jt = JaxTrainer(jcfg, 8, ["a_cpu"])
    pt = Trainer(cfg, 8, ["a_cpu"], device="cpu")
    want = jt._epoch_plan(45, np.random.default_rng(5), s)
    got = pt._epoch_plan(45, np.random.default_rng(5), s)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2] == want[2] == 3


@pytest.mark.parametrize("s", [2, "epoch", "auto"])
def test_port_superstep_bit_identical_to_per_step(corpus, init_params, s):
    want_losses, want, _, state_1 = port_run(corpus, init_params, dropout=0.5,
                                             steps_per_superstep=1)
    got_losses, got, trainer, state = port_run(
        corpus, init_params, dropout=0.5, steps_per_superstep=s)
    np.testing.assert_array_equal(got_losses, want_losses)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert state.step == state_1.step == trainer.global_step == 2 * 4
    # the CPU runs every update eagerly: one dispatch per step, no capture
    assert trainer.dispatches == 8 and trainer.captures == 0
    assert trainer.superstep_len == {2: 2, "epoch": 4, "auto": 3}[s]


@pytest.mark.parametrize("s", [2, "epoch", "auto"])
def test_port_superstep_matches_jax(corpus, init_params, s):
    want_losses, want, jstate = jax_run(corpus, steps_per_superstep=s)
    got_losses, got, _, state = port_run(corpus, init_params,
                                         steps_per_superstep=s)
    assert state.step == int(jstate.step) == 8
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert_params_close(got, want)


def test_log_lines_come_from_one_readback_per_superstep(corpus, init_params,
                                                        capsys):
    losses, _, _, _ = port_run(corpus, init_params, dropout=0.5,
                               steps_per_superstep="epoch")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert lines == [f"step {k}: loss {losses[k - 1]:.6f}" for k in (3, 6)]


def test_epoch_plan_buffers_take_and_put():
    plan = EpochPlan(3, 2, 4, torch.device("cpu"))
    starts = np.arange(24).reshape(6, 4)
    weights = np.ones((6, 4), np.float32)
    weights[5] = 0
    plan.stage(starts, weights, weights.sum(-1), first_update=1)
    s, w, den = plan.take()
    assert s.tolist() == [[8, 9, 10, 11], [12, 13, 14, 15]]
    assert w.dtype == torch.float32 and w.shape == (2, 4)
    assert den.dtype == torch.float32 and den.tolist() == [4.0, 4.0]
    plan.put(torch.tensor([0.5, 1.5]))
    assert int(plan.cursor) == 2
    assert plan.microbatch_losses(2, 4).tolist() == [0.5, 1.5]
    s, w, den = plan.take()
    assert w[1].sum() == 0 and s[0, 0] == 16
    assert den.tolist() == [4.0, 0.0]


class _Kernel:
    def __init__(self):
        self.launches = 0


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_ledger_counts_replays():
    k2, k3 = _Kernel(), _Kernel()
    update = graphs.CapturedGraph(_Graph(), {k2: 2, k3: 2})
    for _ in range(5):
        update.replay()
    assert (k2.launches, k3.launches) == (10, 10)
    assert update.graph.replays == 5


def test_failing_op_names_the_port_source_line():
    def body():
        torch.zeros(2).view(3)

    try:
        body()
    except RuntimeError as exc:
        where = graphs._failing_op(exc)
    assert where.startswith("test_torch_superstep.py:")
    assert "torch.zeros(2).view(3)" in where


def test_skip_off_a_superstep_boundary_raises(corpus):
    _, cfg = configs(steps_per_superstep=2)
    bundle = prepare_dataset(corpus[1], cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError, match="superstep boundary"):
        trainer.train_epoch(state, bundle, np.random.default_rng(0),
                            skip_steps=1)
    with pytest.raises(ValueError, match="NEXT epoch"):
        trainer.train_epoch(state, bundle, np.random.default_rng(0),
                            skip_steps=4)
