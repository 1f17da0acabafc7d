"""The port's what-if trace synthesizer against the JAX package's, on the
CPU: the same corpus gives the same endpoints and per-endpoint
distributions, and the same mix and seed the same synthetic series, bit
for bit (both sample with numpy's multinomial from the same Generator)."""

import numpy as np
import pytest

from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.data.featurize import CallPathSpace as JaxSpace
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.workload import SCENARIOS
from deeprest_tpu.workload.simulator import simulate_corpus
from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.data.synthesize import TraceSynthesizer, synthesize_span


@pytest.fixture(scope="module")
def corpus():
    jb = simulate_corpus(SCENARIOS["normal"](2), 10)
    return jb, [Bucket.from_dict(b.to_dict()) for b in jb]


@pytest.mark.parametrize("cfg", [dict(), dict(round_to=8),
                                 dict(hash_features=True, capacity=48)],
                         ids=["dict", "dict round 8", "hash"])
def test_fit_and_synthesize_series_match_jax(corpus, cfg):
    jb, pb = corpus
    synth = TraceSynthesizer(CallPathSpace(config=FeaturizeConfig(**cfg))).fit(pb)
    jsynth = JaxSynth(JaxSpace(config=JaxFeaturizeConfig(**cfg))).fit(jb)
    assert synth.endpoints == jsynth.endpoints and len(synth.endpoints) == 7
    assert synth.space.to_dict() == jsynth.space.to_dict()
    for ep in synth.endpoints:
        np.testing.assert_array_equal(synth._dists[ep].vectors,
                                      jsynth._dists[ep].vectors)
        np.testing.assert_array_equal(synth._dists[ep].counts,
                                      jsynth._dists[ep].counts)
    eps = synth.endpoints
    mixes = [{eps[0]: 30, eps[3]: 7}, {eps[1]: 0, eps[5]: 12, eps[6]: 2},
             {e: 5 for e in eps}]
    for seed in (0, 9):
        got = synth.synthesize_series(mixes * 4, seed=seed)
        want = jsynth.synthesize_series(mixes * 4, seed=seed)
        assert got.shape == (12, synth.space.capacity)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # one step against an explicit Generator, and an unseen mix scale
    np.testing.assert_array_equal(
        synth.synthesize({eps[2]: 400}, np.random.default_rng(5)),
        jsynth.synthesize({eps[2]: 400}, np.random.default_rng(5)))
    with pytest.raises(KeyError, match="unknown API endpoint"):
        synth.synthesize({"nope": 1})


def test_synthesized_trace_counts_follow_the_mix(corpus):
    """A synthesized step counts each endpoint's root path once per call."""
    _, pb = corpus
    synth = TraceSynthesizer(CallPathSpace()).fit(pb)
    mix = {ep: i + 1 for i, ep in enumerate(synth.endpoints)}
    x = synth.synthesize(mix, np.random.default_rng(0))
    for ep, n in mix.items():
        assert x[synth.space.column_of((ep,))] == n
    span = synthesize_span({"component": "a", "operation": "/b",
                            "children": [{"component": "c",
                                          "operation": "/d"}]})
    assert [p for p, _ in span.walk()] == [("a_/b",), ("a_/b", "c_/d")]
