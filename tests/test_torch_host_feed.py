"""The host-streamed trainer feed of the port against the JAX package's and
against the port's own staged feed, on the CPU.

- ``device_data="off"`` against JAX's ``"off"`` from the same JAX-initialized
  params (dropout 0): f32 against the ``scan`` backend, per-step losses
  within 1e-5 relative and params within 1e-4 of each leaf's largest
  magnitude; bf16 against JAX asked for ``pallas_interpret`` (its
  ``scan`` at this width), both within 2e-2.
- Host-fed against staged in the port, f32 and bf16, dropout 0 and 0.5,
  S = 1 and S = 2: per-step losses, params, Adam's moments and the test
  loss bit for bit.
- A bundle with no base series trains host-fed in both packages (1e-5,
  1e-4); "off" with ``grad_accum_windows=2`` and a sparse bundle raise.
- A host-fed run killed at a step that is not a superstep boundary and
  resumed is bit-identical to the uninterrupted run; host-fed cursor
  snapshots cross packages both ways (1e-4 of leaf scale).
- Host-fed ``evaluate`` equals staged ``evaluate``; log lines fire on the
  host path's steps.
"""

import dataclasses

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
from deeprest_tpu_torch.train.checkpoint import latest_cursor_step
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

TRAIN = dict(num_epochs=2, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=3, seed=0, log_every_steps=0)
EPOCH_STEPS = 4          # ceil(51 train windows / 16)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}   # losses, params


class _Preempted(BaseException):
    """Raised from the on_step hook: a kill no handler may swallow."""


def configs(compute="float32", dropout=0.0, device_data="off", **train):
    model = dict(hidden_size=8, dropout_rate=dropout, compute_dtype=compute)
    backend = "scan" if compute == "float32" else "pallas_interpret"
    train = dict(TRAIN, device_data=device_data, **train)
    return (JaxConfig(model=JaxModelConfig(rnn_backend=backend, **model),
                      train=JaxTrainConfig(**train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    data = featurize_buckets(make_series_buckets(140, seed=7),
                             FeaturizeConfig(round_to=8))
    port = FeaturizedData(traffic=data.traffic, resources=dict(data.resources),
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(data.space.to_dict()))
    return data, port


@pytest.fixture(scope="module")
def jax_params(corpus):
    """JAX-initialized params (the ``init_state`` of a JAX trainer) as a
    port params dict."""
    jcfg, _ = configs()
    jb = jax_prepare_dataset(corpus[0], jcfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    state = jt.init_state(jb.x_train[:1])
    return params_from_jax({k: np.array(v) for k, v in state.params.items()})


def port_run(cfg, corpus, params, bundle=None, **fit):
    bundle = bundle or prepare_dataset(corpus[1], cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    losses = []
    state, hist = trainer.fit(
        bundle, state=trainer.init_state(params),
        on_epoch=lambda r, s: losses.append(trainer.last_epoch_losses), **fit)
    return trainer, state, hist, np.concatenate(losses)


def jax_run(jcfg, corpus, params, bundle=None):
    jb = bundle or jax_prepare_dataset(corpus[0], jcfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    state = jt.init_state(jb.x_train[:1])
    state = state.replace(params={k: np.asarray(params[k])
                                  for k in state.params})
    losses = []
    state, hist = jt.fit(jb, state=state, on_epoch=lambda r, s: losses.append(
        np.array(jt._last_epoch_losses)))
    return state, hist, np.concatenate(losses)


def assert_params_close(got, want, tol):
    for name, ref in want.items():
        ref = np.asarray(ref, np.float32)
        err = np.abs(got[name].detach().float().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_off_matches_jax_off(corpus, jax_params, compute):
    """bf16 asks JAX for ``pallas_interpret``; at H=8 JAX's dispatcher runs
    its ``scan`` backend instead (the kernel takes H % 128 == 0), which
    carries h in bf16, hence 2e-2."""
    jcfg, cfg = configs(compute)
    trainer, state, hist, losses = port_run(cfg, corpus, jax_params)
    jstate, jhist, jlosses = jax_run(jcfg, corpus, jax_params)
    loss_tol, param_tol = TOL[compute]
    assert trainer.feed == "host" and state.step == int(jstate.step) \
        == 2 * EPOCH_STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=loss_tol)
    assert_params_close(state.params, jstate.params, param_tol)
    np.testing.assert_allclose([h.test_loss for h in hist],
                               [h.test_loss for h in jhist], rtol=loss_tol)


def moments(state):
    return [state.optimizer.state[p][k].clone()
            for p in state.model.parameters()
            for k in ("exp_avg", "exp_avg_sq", "step")]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("superstep", [1, 2])
def test_host_fed_bit_identical_to_staged(corpus, jax_params, compute,
                                          dropout, superstep):
    runs = {}
    for device_data in ("off", "always"):
        _, cfg = configs(compute, dropout, device_data,
                         steps_per_superstep=superstep)
        runs[device_data] = port_run(cfg, corpus, jax_params)
    (host, s_h, h_h, l_h), (staged, s_s, h_s, l_s) = (runs["off"],
                                                      runs["always"])
    assert (host.feed, staged.feed) == ("host", "staged")
    assert host.superstep_len == staged.superstep_len == superstep
    np.testing.assert_array_equal(l_h, l_s)
    for name, value in s_s.params.items():
        assert torch.equal(s_h.params[name], value), name
    for a, b in zip(moments(s_h), moments(s_s)):
        assert torch.equal(a, b)
    assert [h.test_loss for h in h_h] == [h.test_loss for h in h_s]
    assert host.dispatches == staged.dispatches == 2 * EPOCH_STEPS


def test_auto_over_budget_trains_host_fed(corpus, jax_params):
    _, cfg = configs(device_data="auto", device_data_max_bytes=1)
    host = port_run(cfg, corpus, jax_params)
    _, cfg = configs(device_data="auto")
    staged = port_run(cfg, corpus, jax_params)
    assert (host[0].feed, staged[0].feed) == ("host", "staged")
    np.testing.assert_array_equal(host[3], staged[3])


def test_baseless_bundle_trains_in_both_packages(corpus, jax_params):
    """A bundle without base series (windows only) has nothing to stage:
    both packages train it from host windows, even under "always"."""
    jcfg, cfg = configs(device_data="always")
    jb = dataclasses.replace(jax_prepare_dataset(corpus[0], jcfg.train),
                             x_base=None, y_base=None)
    pb = dataclasses.replace(prepare_dataset(corpus[1], cfg.train),
                             x_base=None, y_base=None)
    trainer, state, hist, losses = port_run(cfg, corpus, jax_params,
                                            bundle=pb)
    jstate, jhist, jlosses = jax_run(jcfg, corpus, jax_params, bundle=jb)
    assert trainer.feed == "host"
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_params_close(state.params, jstate.params, 1e-4)


def test_host_feed_refuses_accumulation_and_sparse_bundles(corpus):
    _, cfg = configs(grad_accum_windows=2)
    bundle = prepare_dataset(corpus[1], cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    with pytest.raises(ValueError, match="grad_accum_windows=2 requires "
                       "the staged"):
        trainer.fit(bundle, num_epochs=1)
    _, sparse_cfg = configs(device_data="auto", sparse_feed=True)
    sparse = prepare_dataset(corpus[1], sparse_cfg.train)
    assert sparse.is_sparse
    _, cfg = configs()
    trainer = Trainer(cfg, sparse.feature_dim, sparse.metric_names,
                      device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError, match="sparse .* staged"):
        trainer.train_epoch(state, sparse, np.random.default_rng(0))
    with pytest.raises(ValueError, match="sparse .* evaluate only"):
        trainer.evaluate(state, sparse)


def preempt_at(kill_at):
    def hook(global_step):
        if global_step >= kill_at:
            raise _Preempted
    return hook


def test_host_fed_kill_off_a_superstep_boundary_resumes_bit_identical(
        corpus, jax_params, tmp_path):
    """S = 2, snapshots every 3 steps, dropout 0.5: the host path snapshots
    at step 3 (inside a superstep), the kill lands there, and the resumed
    run ends where the uninterrupted one does."""
    kw = dict(dropout=0.5, steps_per_superstep=2, snapshot_every_steps=3,
              snapshot_keep=0)
    _, cfg_a = configs(checkpoint_dir=str(tmp_path / "a"), **kw)
    tr_a, state_a, hist_a, _ = port_run(cfg_a, corpus, jax_params)
    _, cfg_b = configs(checkpoint_dir=str(tmp_path / "b"), **kw)
    with pytest.raises(_Preempted):
        port_run(cfg_b, corpus, jax_params, on_step=preempt_at(3))
    assert latest_cursor_step(str(tmp_path / "b")) == 3
    bundle = prepare_dataset(corpus[1], cfg_b.train)
    tr_c = Trainer(cfg_b, bundle.feature_dim, bundle.metric_names,
                   device="cpu")
    state_c, hist_c = tr_c.resume_training(bundle)
    assert tr_c.resumed_from_step == 3 and tr_c.feed == "host"
    assert state_c.step == state_a.step == 2 * EPOCH_STEPS
    for name, value in state_a.params.items():
        assert torch.equal(state_c.params[name], value), name
    for a, b in zip(moments(state_c), moments(state_a)):
        assert torch.equal(a, b)
    assert hist_c[-1].test_loss == hist_a[-1].test_loss


@pytest.mark.parametrize("direction", ["jax-snapshot-port-resume",
                                       "port-snapshot-jax-resume"])
def test_host_fed_snapshots_resume_across_packages(corpus, jax_params,
                                                   tmp_path, direction):
    kw = dict(steps_per_superstep=2, snapshot_every_steps=3,
              snapshot_keep=0)
    jcfg_a, cfg_a = configs(checkpoint_dir=str(tmp_path / "a"), **kw)
    jcfg_b, cfg_b = configs(checkpoint_dir=str(tmp_path / "b"), **kw)
    jbundle = jax_prepare_dataset(corpus[0], jcfg_a.train)
    bundle = prepare_dataset(corpus[1], cfg_a.train)
    if direction == "jax-snapshot-port-resume":
        want, _, _ = jax_run(jcfg_a, corpus, jax_params, bundle=jbundle)
        jt_b = JaxTrainer(jcfg_b, jbundle.feature_dim, jbundle.metric_names)
        state = jt_b.init_state(jbundle.x_train[:1])
        state = state.replace(params={k: np.asarray(jax_params[k])
                                      for k in state.params})
        with pytest.raises(_Preempted):
            jt_b.fit(jbundle, state=state, on_step=preempt_at(3))
        tr_c = Trainer(cfg_b, bundle.feature_dim, bundle.metric_names,
                       device="cpu")
        state_c, hist_c = tr_c.resume_training(bundle)
        got = state_c.params
        assert tr_c.resumed_from_step == 3
        want = want.params
    else:
        _, state_a, _, _ = port_run(cfg_a, corpus, jax_params)
        with pytest.raises(_Preempted):
            port_run(cfg_b, corpus, jax_params, on_step=preempt_at(3))
        jt_c = JaxTrainer(jcfg_b, jbundle.feature_dim, jbundle.metric_names)
        state_c, hist_c = jt_c.resume_training(jbundle)
        got = {k: torch.from_numpy(np.array(v))
               for k, v in state_c.params.items()}
        want = {k: v.detach().numpy() for k, v in state_a.params.items()}
    assert latest_cursor_step(str(tmp_path / "b")) == 2 * EPOCH_STEPS
    assert hist_c[0].epoch == 0 and hist_c[-1].epoch == 1
    assert_params_close(got, want, 1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_host_fed_evaluate_equals_staged(corpus, jax_params, compute,
                                         capsys):
    results = {}
    for device_data in ("off", "always"):
        _, cfg = configs(compute, device_data=device_data,
                         log_every_steps=3)
        bundle = prepare_dataset(corpus[1], cfg.train)
        trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                          device="cpu")
        state = trainer.init_state(jax_params)
        trainer.train_epoch(state, bundle, np.random.default_rng(0))
        results[device_data] = (trainer.evaluate(state, bundle),
                                capsys.readouterr().out)
    (loss_h, report_h), log_h = results["off"]
    (loss_s, report_s), log_s = results["always"]
    assert loss_h == loss_s and report_h == report_s
    assert log_h == log_s and "step 3: loss" in log_h


@pytest.mark.slow
def test_bf16_h128_update_grads_against_jax_pallas_interpret():
    """One bf16 update's gradients at H=128 (F=16, E=3, B=8 with 2
    zero-weight rows, T=12) on shared JAX-initialized params, against JAX
    asked for ``pallas_interpret`` (the kernel engages at H=128), each
    held to the f32 gradients of the same params (JAX ``scan`` in f32).
    The port's bf16 gradients lie within 2e-2 of each leaf's scale of the
    f32 ones everywhere, and of JAX's on every leaf but the GRU input
    biases ``*_b_ih``, where JAX's bf16 gradient is the one that parts
    from the f32 gradient (measured 2.7e-2 and 3.8e-2 of scale, against
    the port's 6.5e-3 and 4.2e-3).  That is where the host-fed runs at
    H=128 parted after a few Adam steps (ROADMAP §3, known differences).
    ~60 s: interpret mode runs the kernels in Python."""
    import jax
    import jax.numpy as jnp

    from deeprest_tpu.models import qrnn as jax_qrnn
    from deeprest_tpu.ops.quantile import pinball_loss as jax_pinball_loss
    from deeprest_tpu_torch.models.qrnn import QuantileGRU
    from deeprest_tpu_torch.ops.quantile import pinball_loss

    kw = dict(feature_dim=16, num_metrics=3, hidden_size=128,
              dropout_rate=0.0)
    rng = np.random.default_rng(0)
    x = rng.random((8, 12, 16)).astype(np.float32)
    y = rng.random((8, 12, 3)).astype(np.float32)
    w = np.asarray([1] * 6 + [0] * 2, np.float32)
    q = (0.05, 0.5, 0.95)

    def jax_grads(backend, compute):
        model = jax_qrnn.QuantileGRU(config=JaxModelConfig(
            rnn_backend=backend, compute_dtype=compute, **kw))
        tree = model.init(jax.random.PRNGKey(1), x,
                          deterministic=True)["params"]
        loss, grads = jax.value_and_grad(lambda p: jax_pinball_loss(
            model.apply({"params": p}, x, deterministic=True), y, q,
            sample_weight=w))(tree)
        return ({k: np.array(v) for k, v in tree.items()}, float(loss),
                {k: np.asarray(v, np.float32) for k, v in grads.items()})

    tree, jax_loss, jax_bf16 = jax_grads("pallas_interpret", "bfloat16")
    _, _, truth = jax_grads("scan", "float32")
    model = QuantileGRU(ModelConfig(compute_dtype="bfloat16", **kw))
    model.load_params(params_from_jax(tree)).requires_grad_(True)
    loss = pinball_loss(model(torch.from_numpy(x)), torch.from_numpy(y), q,
                        sample_weight=torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_loss, rtol=2e-2)

    def dist(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    for name, p in model.named_parameters():
        got = p.grad.float().numpy()
        assert dist(got, truth[name]) <= 2e-2, name
        if name.endswith("_b_ih"):
            assert dist(got, truth[name]) < dist(jax_bf16[name],
                                                 truth[name]), name
        else:
            assert dist(got, jax_bf16[name]) <= 2e-2, name
