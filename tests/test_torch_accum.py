"""The port's window-coalesced gradient accumulation against the JAX
package's, on the CPU.

- G=2 "loop", "exact" and "flat" against JAX's "loop" at the same S, dropout
  0, from identical params (JAX stages its data and runs its ``scan``
  backend in f32): per-microbatch losses within 1e-5 relative, params
  within 1e-4 of each leaf's largest magnitude.  (JAX's own "exact" is not
  the oracle: its bit-equality with its "loop" does not hold under this
  container's JAX.)
- The port's "exact" bit-identical to its "loop" at G=2 and G=4 with
  dropout 0.5, over epochs with a partly padded trailing group; the step
  counter counts real microbatches and Adam's count updates.
- "flat" runs one ``[G·B]``-row recurrence per direction; its first
  update's losses equal "loop"'s bit for bit (rows are independent).
"""

import importlib

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
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=4, seed=0, steps_per_superstep=4)


def configs(dropout=0.0, **train):
    train = dict(TRAIN, **train)
    model = dict(hidden_size=8, dropout_rate=dropout)
    return (JaxConfig(model=JaxModelConfig(rnn_backend="scan", **model),
                      train=JaxTrainConfig(device_data="always", **train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    """(JAX FeaturizedData, port FeaturizedData): 140 minutes, 51 train
    windows, so 4 microbatches an epoch, the last one ragged."""
    data = featurize_buckets(make_series_buckets(140, seed=6),
                             FeaturizeConfig(round_to=8))
    port = FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(data.space.to_dict()))
    return data, port


@pytest.fixture(scope="module")
def jax_loop(corpus):
    """JAX's G=2 "loop" reference: (init params, per-step losses, final
    params)."""
    jcfg, _ = configs(grad_accum_windows=2, grad_accum_mode="loop")
    bundle = jax_prepare_dataset(corpus[0], jcfg.train)
    trainer = JaxTrainer(jcfg, bundle.feature_dim, bundle.metric_names)
    state0 = trainer.init_state(bundle.x_train[:1])
    params = {k: np.array(v) for k, v in state0.params.items()}
    losses = []
    state, _ = trainer.fit(bundle, state=state0, on_epoch=lambda r, s:
                           losses.append(np.array(trainer._last_epoch_losses)))
    assert int(state.step) == 8
    return (params, np.concatenate(losses),
            {k: np.asarray(v) for k, v in state.params.items()})


def port_run(corpus, params, dropout=0.0, **train):
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


@pytest.mark.parametrize("mode", ["loop", "exact", "flat"])
def test_accum_modes_match_jax_loop(corpus, jax_loop, mode):
    params, want_losses, want = jax_loop
    losses, got, trainer, state = port_run(corpus, params,
                                           grad_accum_windows=2,
                                           grad_accum_mode=mode)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    assert state.step == trainer.global_step == 8
    assert trainer.dispatches == 4          # 2 updates an epoch
    count = {int(s["step"]) for s in state.optimizer.state.values()}
    assert count == {4}


@pytest.mark.parametrize("g", [2, 4])
def test_port_exact_bit_identical_to_loop(corpus, jax_loop, g):
    params = jax_loop[0]
    want_losses, want, _, want_state = port_run(
        corpus, params, dropout=0.5, grad_accum_windows=g,
        grad_accum_mode="loop", steps_per_superstep=3)
    losses, got, trainer, state = port_run(
        corpus, params, dropout=0.5, grad_accum_windows=g,
        grad_accum_mode="exact", steps_per_superstep=3)
    np.testing.assert_array_equal(losses, want_losses)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for p, q in zip(state.model.parameters(), want_state.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][key],
                               want_state.optimizer.state[q][key])
    # S=3 rounds up to a multiple of G; real microbatches are counted
    assert trainer.superstep_len == -(-3 // g) * g
    assert state.step == 8
    assert losses.shape == (8,) and np.isfinite(losses).all()


def test_flat_folds_groups_into_rows(corpus, jax_loop, monkeypatch):
    params = jax_loop[0]
    port_gru = importlib.import_module("deeprest_tpu_torch.ops.gru")
    rows = []
    real = port_gru.gru

    def spy(p, x, *args, **kw):
        rows.append(x.shape[0])
        return real(p, x, *args, **kw)

    monkeypatch.setattr(port_gru, "gru", spy)
    flat, _, _, _ = port_run(corpus, params, grad_accum_windows=2,
                             grad_accum_mode="flat", num_epochs=1)
    assert set(rows[:2]) == {32}            # G·B rows a recurrence call
    rows.clear()
    loop, _, _, _ = port_run(corpus, params, grad_accum_windows=2,
                             grad_accum_mode="loop", num_epochs=1)
    assert set(rows[:2]) == {16}
    np.testing.assert_array_equal(flat[:2], loop[:2])
