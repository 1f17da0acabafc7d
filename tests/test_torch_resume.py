"""Cursor snapshots and resume in the port, against its own uninterrupted
runs and across packages, on the CPU.

- Kill and resume (the pattern of tests/test_chaos.py): an ``on_step``
  hook raises a ``BaseException`` at a superstep boundary, a fresh
  ``Trainer`` runs ``resume_training``, dropout 0.5.  The resumed final
  params, Adam's moments and the last test loss are bit-identical to the
  uninterrupted run's: per-step path, superstep path, G=2, and a kill at an
  epoch boundary.
- Across packages, dropout 0: a JAX cursor snapshot resumed by the port
  ends within 1e-4 of each leaf's scale of JAX's uninterrupted run, and a
  port snapshot resumed by the JAX ``Trainer.resume_training`` within 1e-4
  of the port's, so params, Adam's moments and count, step and cursor all
  cross over.
- No snapshot raises FileNotFoundError; retention keeps the newest K cursor
  snapshots and spares checkpoints without a cursor; a truncated shard
  raises ValueError naming its leaf.
- The ``train`` CLI: a ``--snapshot-every-steps`` run killed by the hook,
  then the same command again, resumes and ends bit-identical to an
  uninterrupted run; a third run finds nothing left to do.
"""

import importlib
import json
import os

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
from deeprest_tpu_torch.train.checkpoint import (
    latest_cursor_step, list_steps, load_params, load_sidecar,
    prune_checkpoints, save_checkpoint,
)
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

EPOCH_STEPS = 4          # ceil(51 train windows / 16)


class _Preempted(BaseException):
    """Raised from the on_step hook: a kill at a superstep boundary that no
    handler of the training path may swallow."""


def configs(ckpt_dir, dropout=0.5, snapshot_every=2, superstep=2, accum=1,
            snapshot_keep=0):
    train = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
                 eval_max_cycles=2, seed=0, steps_per_superstep=superstep,
                 grad_accum_windows=accum, log_every_steps=0,
                 checkpoint_dir=str(ckpt_dir),
                 snapshot_every_steps=snapshot_every,
                 snapshot_keep=snapshot_keep)
    model = dict(hidden_size=8, dropout_rate=dropout)
    return (JaxConfig(model=JaxModelConfig(rnn_backend="scan", **model),
                      train=JaxTrainConfig(device_data="always", **train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    port = FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(data.space.to_dict()))
    return data, port


def preempt_at(kill_at):
    def hook(global_step):
        if global_step >= kill_at:
            raise _Preempted
    return hook


def port_trainer(cfg, corpus):
    bundle = prepare_dataset(corpus[1], cfg.train)
    return Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                   device="cpu"), bundle


def numpy_params(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def kill_and_resume(corpus, tmp_path, kill_at, params=None, **kw):
    """Run A uninterrupted, run B killed at the first boundary >= kill_at,
    a fresh trainer resumes B: (state A, history A, trainer C, state C,
    history C)."""
    _, cfg_a = configs(tmp_path / "a", **kw)
    tr_a, bundle = port_trainer(cfg_a, corpus)
    state_a, hist_a = tr_a.fit(bundle, state=tr_a.init_state(params))
    _, cfg_b = configs(tmp_path / "b", **kw)
    tr_b, _ = port_trainer(cfg_b, corpus)
    with pytest.raises(_Preempted):
        tr_b.fit(bundle, state=tr_b.init_state(params),
                 on_step=preempt_at(kill_at))
    tr_c, _ = port_trainer(cfg_b, corpus)
    state_c, hist_c = tr_c.resume_training(bundle)
    return state_a, hist_a, tr_c, state_c, hist_c


@pytest.mark.parametrize("case", [
    dict(kill_at=3, superstep=1), dict(kill_at=3, superstep=2),
    dict(kill_at=3, superstep=2, accum=2),
    dict(kill_at=EPOCH_STEPS + 1, snapshot_every=100)],
    ids=["per-step-path", "superstep-path", "grad-accum-g2",
         "epoch-boundary"])
def test_kill_and_resume_bit_identical(corpus, tmp_path, case):
    state_a, hist_a, tr_c, state_c, hist_c = kill_and_resume(
        corpus, tmp_path, **case)
    assert state_c.step == state_a.step == 2 * EPOCH_STEPS
    assert tr_c.global_step == 2 * EPOCH_STEPS
    for name, value in numpy_params(state_a).items():
        np.testing.assert_array_equal(numpy_params(state_c)[name], value)
    for p, q in zip(state_a.model.parameters(), state_c.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state_a.optimizer.state[p][key],
                               state_c.optimizer.state[q][key]), key
    assert hist_c[-1].test_loss == hist_a[-1].test_loss
    assert hist_c[-1].epoch == hist_a[-1].epoch == 1
    if case["kill_at"] > EPOCH_STEPS:
        # the epoch-end snapshot already pointed at epoch 1, step 0
        assert hist_c[0].epoch == 1
        assert tr_c.resumed_from_step == EPOCH_STEPS
        assert hist_c[-1].train_loss == hist_a[-1].train_loss
    else:
        assert hist_c[0].epoch == 0 and tr_c.resumed_from_step == 2


def assert_params_close(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(np.asarray(got[name]) - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("direction", ["jax-snapshot-port-resume",
                                       "port-snapshot-jax-resume"])
def test_cursor_snapshots_resume_across_packages(corpus, tmp_path,
                                                 direction):
    kw = dict(dropout=0.0, snapshot_every=2, superstep=2)
    jcfg_a, cfg_a = configs(tmp_path / "a", **kw)
    jcfg_b, cfg_b = configs(tmp_path / "b", **kw)
    jbundle = jax_prepare_dataset(corpus[0], jcfg_a.train)
    jt_a = JaxTrainer(jcfg_a, jbundle.feature_dim, jbundle.metric_names)
    jstate0 = jt_a.init_state(jbundle.x_train[:1])
    params = params_from_jax({k: np.array(v)
                              for k, v in jstate0.params.items()})
    if direction == "jax-snapshot-port-resume":
        state_a, _ = jt_a.fit(jbundle, state=jstate0)
        want = {k: np.asarray(v) for k, v in state_a.params.items()}
        jt_b = JaxTrainer(jcfg_b, jbundle.feature_dim, jbundle.metric_names)
        with pytest.raises(_Preempted):
            jt_b.fit(jbundle, on_step=preempt_at(3))
        tr_c, bundle = port_trainer(cfg_b, corpus)
        state_c, hist_c = tr_c.resume_training(bundle)
        got = numpy_params(state_c)
        assert state_c.step == int(state_a.step) == 2 * EPOCH_STEPS
    else:
        tr_a, bundle = port_trainer(cfg_a, corpus)
        state_a, _ = tr_a.fit(bundle, state=tr_a.init_state(params))
        want = numpy_params(state_a)
        tr_b, _ = port_trainer(cfg_b, corpus)
        with pytest.raises(_Preempted):
            tr_b.fit(bundle, state=tr_b.init_state(params),
                     on_step=preempt_at(3))
        jt_c = JaxTrainer(jcfg_b, jbundle.feature_dim, jbundle.metric_names)
        state_c, hist_c = jt_c.resume_training(jbundle)
        got = {k: np.asarray(v) for k, v in state_c.params.items()}
        assert int(state_c.step) == state_a.step == 2 * EPOCH_STEPS
    assert latest_cursor_step(str(tmp_path / "b")) == 2 * EPOCH_STEPS
    assert hist_c[0].epoch == 0 and hist_c[-1].epoch == 1
    assert_params_close(got, want)


def test_resume_without_a_cursor_snapshot_raises(corpus, tmp_path):
    _, cfg = configs(tmp_path / "ckpt")
    trainer, bundle = port_trainer(cfg, corpus)
    with pytest.raises(FileNotFoundError, match="cursor-bearing"):
        trainer.resume_training(bundle)
    # a plain checkpoint (no cursor) is no resume anchor
    trainer.save(str(tmp_path / "ckpt"), trainer.init_state(), bundle)
    assert list_steps(str(tmp_path / "ckpt")) == [0]
    with pytest.raises(FileNotFoundError, match="cursor-bearing"):
        trainer.resume_training(bundle)


def test_retention_keeps_newest_cursor_snapshots(corpus, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, cfg = configs(ckpt, snapshot_every=1, superstep=1, snapshot_keep=2)
    trainer, bundle = port_trainer(cfg, corpus)
    state = trainer.init_state()
    # a checkpoint without a cursor, newer than every snapshot: spared
    save_checkpoint(ckpt, {k: v.detach() for k, v in state.params.items()},
                    1000, {"metric_names": bundle.metric_names})
    state, _ = trainer.fit(bundle, state=state)
    assert list_steps(ckpt) == [7, 8, 1000]
    assert latest_cursor_step(ckpt) == 8
    cursor = load_sidecar(ckpt, 8)["train_cursor"]
    rng = np.random.default_rng(0)
    rng.permutation(51)
    rng.permutation(51)
    assert cursor == {"epoch": 2, "steps_done": 0, "global_step": 8,
                      "rng_state": json.loads(json.dumps(
                          rng.bit_generator.state))}
    assert prune_checkpoints(ckpt, 1) == [7, 8]
    assert list_steps(ckpt) == [1000]


def test_truncated_shard_raises_value_error(corpus, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, cfg = configs(ckpt, snapshot_every=2)
    trainer, bundle = port_trainer(cfg, corpus)
    trainer.fit(bundle, num_epochs=1)
    step = latest_cursor_step(ckpt)
    state, extra = trainer.restore_state(ckpt, step)
    assert state.step == EPOCH_STEPS and extra["train_cursor"]["epoch"] == 1
    arrays = os.path.join(ckpt, f"step_{step:08d}", "arrays")
    shard = next(f for f in sorted(os.listdir(arrays))
                 if "opt_state-0-mu-head_w" in f)
    with open(os.path.join(arrays, shard), "r+b") as fh:
        fh.truncate(os.path.getsize(fh.name) // 2)
    with pytest.raises(ValueError, match="opt_state/0/mu/head_w"):
        trainer.restore_state(ckpt, step)


def test_train_cli_resumes_a_killed_run(corpus, tmp_path, monkeypatch,
                                        capsys):
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    feats = corpus[1].save(str(tmp_path / "input"))

    def args(ckpt):
        return ["train", "--features", feats, "--epochs", "2",
                "--batch-size", "16", "--window", "12", "--hidden-size", "8",
                "--steps-per-superstep", "2", "--snapshot-every-steps", "2",
                "--snapshot-keep", "2", "--ckpt-dir", str(tmp_path / ckpt),
                "--no-baselines", "--device", "cpu"]

    assert cli.main(args("a")) == 0
    whole = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert whole["resumed_from_step"] is None and whole["steps"] == 8
    assert (whole["dispatches"], whole["captures"]) == (8, 0)
    assert whole["steps_per_superstep"] == 2
    assert whole["grad_accum_windows"] == 1

    real = Trainer._note_steps

    def killed(self, state, bundle, n, on_step=None):
        real(self, state, bundle, n, on_step)
        if self.global_step >= 6:
            raise _Preempted

    monkeypatch.setattr(Trainer, "_note_steps", killed)
    with pytest.raises(_Preempted):
        cli.main(args("b"))
    monkeypatch.undo()
    capsys.readouterr()
    assert cli.main(args("b")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("resuming preempted run")
    resumed = json.loads(lines[-1])
    assert resumed["resumed_from_step"] == 6 and resumed["steps"] == 8
    assert resumed["dispatches"] == 2
    assert resumed["test_losses"][-1] == whole["test_losses"][-1]
    want, got = load_params(str(tmp_path / "a")), load_params(
        str(tmp_path / "b"))
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # the newest snapshot is the last epoch's end: nothing is left to do
    assert cli.main(args("b")) == 0
    out = capsys.readouterr().out
    assert "already past the final epoch" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["epoch_losses"] == [] and last["report"] is None
