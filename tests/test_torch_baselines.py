"""The port's baselines against the JAX package's, on the CPU.

- ComponentAware (numpy in both): equal, including the ``general``
  fallback, the degenerate (zero) invocation range and an idle series.
- ResourceAware from the JAX initial weights, carried across with
  ``interop.baseline_params_from_jax``, trained a few epochs: within 1e-5
  relative of JAX (both run optax-default Adam in float32 on the same
  batches; only the float association of the products differs).
- The batched ``[E]`` training equals E separate runs.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import make_series_buckets
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.data.windows import sliding_windows
from deeprest_tpu.models import baselines as jax_baselines
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu_torch.interop import baseline_params_from_jax
from deeprest_tpu_torch.models import baselines

W, SPLIT = 12, 40


@pytest.fixture(scope="module")
def corpus():
    data = featurize_buckets(make_series_buckets(100, seed=3),
                             FeaturizeConfig(round_to=8))
    targets = data.targets()
    ys = np.stack([sliding_windows(targets[:, [i]], W)
                   for i in range(targets.shape[1])])       # [E, N, W, 1]
    return data, ys


def jax_init(hidden=16, seed=0):
    model = jax_baselines.ResourceAwareBaseline(split=SPLIT, window_size=W,
                                                hidden_size=hidden, seed=seed)
    tree = model._init_params(jax.random.PRNGKey(seed))
    return {k: np.array(v) for k, v in tree.items()}


def test_component_aware_matches_jax(corpus):
    data, ys = corpus
    inv = dict(data.invocations)
    inv["flat-svc"] = np.full_like(inv["general"], 3.0)     # zero range
    inv["idle-svc"] = np.zeros_like(inv["general"])          # no invocations
    for component in ("store-db", "gateway", "not-in-traces", "flat-svc",
                      "idle-svc"):
        for e in range(len(ys)):
            kw = dict(split=SPLIT, window_size=W, component=component,
                      invocations=inv)
            got = baselines.ComponentAwareBaseline(**kw).fit_and_estimate(ys[e])
            want = jax_baselines.ComponentAwareBaseline(**kw).fit_and_estimate(
                ys[e])
            assert got.shape == (len(ys[e]) - SPLIT, W, 1)
            np.testing.assert_array_equal(got, want)
    weights = (1.0, 2.0, 0.0, 5.0)
    for series in (inv["gateway"], inv["idle-svc"]):
        np.testing.assert_array_equal(
            baselines.component_scaling_apply(series, weights),
            jax_baselines.component_scaling_apply(series, weights))


def test_resource_aware_from_the_jax_weights_matches_jax(corpus):
    _, ys = corpus
    init = jax_init()
    kw = dict(split=SPLIT, window_size=W, hidden_size=16, num_epochs=4,
              batch_size=8)
    for e in range(len(ys)):
        want = jax_baselines.ResourceAwareBaseline(**kw).fit_and_estimate(ys[e])
        got = baselines.ResourceAwareBaseline(**kw, device="cpu"
                                              ).fit_and_estimate(
            ys[e], init_params=baseline_params_from_jax(init))
        assert got.shape == want.shape == (len(ys[e]) - SPLIT, W, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        # the training moved the weights: untrained gives another answer
        untrained = baselines.ResourceAwareBaseline(
            **dict(kw, num_epochs=0), device="cpu").fit_and_estimate(
            ys[e], init_params=baseline_params_from_jax(init))
        assert not np.allclose(untrained, got, rtol=1e-3)


def test_batched_training_equals_separate_runs(corpus):
    _, ys = corpus
    model = baselines.ResourceAwareBaseline(split=SPLIT, window_size=W,
                                            hidden_size=16, num_epochs=3,
                                            batch_size=8, seed=4,
                                            device="cpu")
    many = model.fit_and_estimate_many(ys)
    assert many.shape == (len(ys), ys.shape[1] - SPLIT, W, 1)
    for e in range(len(ys)):
        np.testing.assert_array_equal(many[e], model.fit_and_estimate(ys[e]))


def test_baseline_predictions_match_jax(corpus):
    data, _ = corpus
    cfg = JaxTrainConfig(window_size=W, batch_size=8)
    bundle = jax_prepare_dataset(data, cfg)
    init = jax_init(hidden=128)
    want = jax_baselines.baseline_predictions(data, bundle, resource_epochs=2)
    got = baselines.baseline_predictions(
        data, bundle, resource_epochs=2, device="cpu",
        init_params=baseline_params_from_jax(init))
    n_test = len(bundle.x_test)
    for method in ("resrc", "comp"):
        assert got[method].shape == (n_test, W, len(bundle.metric_names))
    np.testing.assert_array_equal(got["comp"], want["comp"])
    np.testing.assert_allclose(got["resrc"], want["resrc"], rtol=1e-5)


def test_seeded_init_bounds_and_default_device(monkeypatch):
    a = baselines.init_mlp_params(W, 16, seed=7)
    b = baselines.init_mlp_params(W, 16, seed=7)
    c = baselines.init_mlp_params(W, 16, seed=8)
    assert {k: v.shape for k, v in a.items()} == {
        "w1": (W, 16), "b1": (16,), "w2": (16, W), "b2": (W,)}
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    for k, bound in (("w1", W), ("b1", W), ("w2", 16), ("b2", 16)):
        assert float(a[k].abs().max()) <= 1.0 / np.sqrt(bound)
        assert float(a[k].abs().max()) > 0.5 / np.sqrt(bound)
    with pytest.raises(KeyError, match="missing"):
        baseline_params_from_jax({"w1": np.zeros((W, 4), np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.ResourceAwareBaseline(split=SPLIT, window_size=W
                                        ).fit_and_estimate(np.ones((60, W, 1)))
