"""The port's raw-data schema and featurizer against the JAX package's, on
the CPU.

Both are host numpy over the same inputs, so they are held bit-identical:
vocabulary (``to_dict()``), capacity rounding, traffic, resources and
invocation counts, in dictionary and hash modes, serial and forked; the
``.npz`` artifact loads across packages with an equal space.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from conftest import make_series_buckets, make_toy_buckets
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.data import featurize as jax_featurize
from deeprest_tpu.data import schema as jax_schema
from deeprest_tpu.workload import SCENARIOS as JAX_SCENARIOS
from deeprest_tpu.workload.simulator import simulate_corpus as jax_simulate
from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data import featurize, schema

# Seeded FNV-1a golden vectors, the same constants tests/test_featurize.py
# pins the JAX package's _stable_hash to.
GOLDEN_HASHES = [
    (("a_/op",), 0x5EED, 0x267F5D0AF14CE5E2),
    (("a_/op", "b_/x"), 0x5EED, 0x2D695A7BD72FF9BF),
    (("nginx-thrift_/wrk2-api/post/compose",), 7, 0xB90C66B5AA4F17A3),
    (("ünïcode_/päth",), 99, 0x03B0AB79FC6FC3DB),
    (("gateway_/compose", "store-svc_/store", "store-db_/insert"),
     0x5EED, 0xBEC2695AF78E0A04),
]

MODES = {
    "dict": dict(round_to=8),
    "dict default width": dict(),
    "hash": dict(hash_features=True, capacity=32, hash_seed=3),
}


def port_buckets(jax_buckets):
    """The same corpus as the port's Bucket objects."""
    return [schema.Bucket.from_dict(b.to_dict()) for b in jax_buckets]


@pytest.fixture(scope="module")
def corpora():
    """(JAX buckets, port buckets) of two corpora: the series corpus of the
    trainer tests and 16 buckets of the simulated social network."""
    social = jax_simulate(JAX_SCENARIOS["normal"](0), 16)
    series = make_series_buckets(24, seed=4)
    return {name: (b, port_buckets(b))
            for name, b in (("social", social), ("series", series))}


def assert_featurized_equal(got, want):
    assert got.space.to_dict() == want.space.to_dict()
    assert got.space.capacity == want.space.capacity
    assert got.traffic.dtype == want.traffic.dtype == np.float32
    np.testing.assert_array_equal(got.traffic, want.traffic)
    assert got.metric_names == want.metric_names
    for k in want.metric_names:
        np.testing.assert_array_equal(got.resources[k], want.resources[k])
    # the invocation keys come out of a set, so their order is not defined
    assert set(got.invocations) == set(want.invocations)
    for k in want.invocations:
        np.testing.assert_array_equal(got.invocations[k], want.invocations[k])


@pytest.mark.parametrize("corpus", ["social", "series"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_featurize_buckets_matches_jax(corpora, corpus, mode):
    jb, pb = corpora[corpus]
    want = jax_featurize.featurize_buckets(jb, JaxFeaturizeConfig(**MODES[mode]))
    got = featurize.featurize_buckets(pb, FeaturizeConfig(**MODES[mode]))
    assert_featurized_equal(got, want)
    if mode != "hash":
        assert got.space.endpoints() == want.space.endpoints()
        assert got.space.num_observed == want.space.num_observed
    if corpus == "social" and mode == "dict default width":
        # the reference deployment: 60 observed paths in 128 columns
        assert (got.space.num_observed, got.space.capacity) == (60, 128)
        assert len(got.metric_names) == 88 and len(got.space.endpoints()) == 7


@pytest.mark.parametrize("mode", ["dict", "hash"])
def test_workers_are_bit_identical_to_serial(corpora, mode):
    _, pb = corpora["social"]
    serial = featurize.featurize_buckets(pb, FeaturizeConfig(**MODES[mode]))
    forked = featurize.featurize_buckets(pb, FeaturizeConfig(**MODES[mode]),
                                         workers=2)
    assert_featurized_equal(forked, serial)


def test_workers_refuse_to_fork_after_cuda_is_set_up(corpora, monkeypatch):
    _, pb = corpora["series"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="unsafe once CUDA"):
        featurize.featurize_buckets(pb, workers=2)
    # serial featurization needs no fork and still runs
    assert featurize.featurize_buckets(pb, workers=1).traffic.shape[0] == 24


def test_count_invocations_and_extract_match_jax(corpora):
    jb, pb = corpora["social"]
    for j, p in zip(jb, pb):
        assert featurize.count_invocations(p.traces) == \
            jax_featurize.count_invocations(j.traces)
    for cfg in (dict(round_to=8), dict(hash_features=True, capacity=16)):
        space = featurize.CallPathSpace.fit(pb, FeaturizeConfig(**cfg))
        jspace = jax_featurize.CallPathSpace.fit(jb, JaxFeaturizeConfig(**cfg))
        for j, p in zip(jb, pb):
            got = space.extract(p.traces)
            np.testing.assert_array_equal(got, space.extract_reference(p.traces))
            np.testing.assert_array_equal(got, jspace.extract(j.traces))
        for path in list(jspace.index)[:5] + [("never_/seen",)]:
            assert space.column_of(path) == jspace.column_of(path)
        np.testing.assert_array_equal(space.extract_buckets(pb),
                                      jspace.extract_buckets(jb))


def test_stable_hash_golden_vectors():
    for path, seed, expect in GOLDEN_HASHES:
        assert featurize._stable_hash(path, seed) == expect, (path, seed)
        assert jax_featurize._stable_hash(path, seed) == expect


def test_dictionary_overflow_and_frozen_space_semantics():
    """A fixed capacity drops overflow paths, and a frozen space never
    grows under featurize_buckets, as in the JAX package."""
    jb = make_toy_buckets(6, seed=1)
    pb = port_buckets(jb)
    for cfg in (dict(capacity=3), dict(round_to=1)):
        want = jax_featurize.featurize_buckets(jb, JaxFeaturizeConfig(**cfg))
        got = featurize.featurize_buckets(pb, FeaturizeConfig(**cfg))
        assert_featurized_equal(got, want)
    frozen = featurize.CallPathSpace.from_dict(got.space.to_dict())
    again = featurize.featurize_buckets(port_buckets(make_toy_buckets(4, 9)),
                                        space=frozen)
    assert frozen.to_dict() == got.space.to_dict()
    assert again.traffic.shape == (4, got.space.capacity)
    with pytest.raises(ValueError, match="explicit capacity"):
        FeaturizeConfig(hash_features=True)


def test_npz_loads_across_packages_with_an_equal_space(corpora, tmp_path):
    jb, pb = corpora["social"]
    got = featurize.featurize_buckets(pb)
    want = jax_featurize.featurize_buckets(jb)
    port_file = got.save(str(tmp_path / "port"))
    jax_file = want.save(str(tmp_path / "jax"))
    assert port_file.endswith(".npz")
    from_port = jax_featurize.FeaturizedData.load(port_file)
    from_jax = featurize.FeaturizedData.load(jax_file)
    assert_featurized_equal(from_jax, want)
    assert_featurized_equal(got, from_port)
    assert from_jax.space_dict == want.space.to_dict()
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["space_json"]).decode()) == \
            json.loads(bytes(b["space_json"]).decode())


def test_schema_encodings_round_trip_across_packages(corpora, tmp_path):
    jb, pb = corpora["series"]
    want = [b.to_dict() for b in jb]
    schema.save_raw_data_jsonl(pb, str(tmp_path / "port.jsonl"))
    schema.save_raw_data_pickle(pb, str(tmp_path / "port.pkl"))
    jax_schema.save_raw_data_jsonl(jb, str(tmp_path / "jax.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
    for name in ("port.jsonl", "port.pkl", "jax.jsonl"):
        path = str(tmp_path / name)
        assert [b.to_dict() for b in schema.load_raw_data(path)] == want
        assert [b.to_dict() for b in jax_schema.load_raw_data(path)] == want
    assert [b.to_dict() for b in schema.iter_raw_data_jsonl(
        str(tmp_path / "jax.jsonl"))] == want
    # the reference's plain-dict pickle and a JSON array load too
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump(want, f)
    (tmp_path / "array.json").write_text(json.dumps(want))
    for name in ("ref.pkl", "array.json"):
        assert [b.to_dict() for b in schema.load_raw_data(
            str(tmp_path / name))] == want
    span = pb[0].traces[0]
    assert [(p, n.label) for p, n in span.walk()] == \
        [(p, n.label) for p, n in jb[0].traces[0].walk()]
    assert pb[0].metrics[0].key == jb[0].metrics[0].key
