"""The port's native ETL (``deeprest_tpu_torch/data/native.py`` over
``native/featurizer.cpp``) against the JAX package's Python pipeline and
the port's numpy featurizer, on the CPU.

Every case of ``tests/test_native.py`` with its tolerances: ``traffic``
bit-equal, ``resources`` within rtol 1e-6, invocation counts, the
vocabulary order and ``frozen_capacity`` equal, in dictionary and hash
modes.  The library is built from the checkout into ``build/native/`` by
the first test that needs it (~4 s with g++ 12).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.data import featurize as jax_featurize
from deeprest_tpu.data import schema as jax_schema
from deeprest_tpu.workload import normal_scenario as jax_normal
from deeprest_tpu.workload import simulate_corpus as jax_simulate
from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data import featurize, native, schema
from deeprest_tpu_torch.workload import normal_scenario
from deeprest_tpu_torch.workload.simulator import (
    build_synthetic_app, simulate_corpus,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = {
    "dict": dict(round_to=32),
    "dict default width": dict(),
    "hash": dict(hash_features=True, capacity=96, hash_seed=1234),
    "overflow": dict(capacity=8),
}


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    """JAX's corpus of tests/test_native.py: 50 buckets of the normal
    scenario at 0.4 calls a user, written by JAX's JSONL writer."""
    scn = jax_normal(0)
    scn.calls_per_user = 0.4
    buckets = jax_simulate(scn, 50)
    path = tmp_path_factory.mktemp("corpus") / "corpus.jsonl"
    jax_schema.save_raw_data_jsonl(buckets, str(path))
    return str(path), buckets


def assert_featurized_equal(got, want, vocab=True):
    np.testing.assert_array_equal(got.traffic, want.traffic)
    assert got.traffic.dtype == want.traffic.dtype == np.float32
    assert got.space.capacity == want.space.capacity
    if vocab:
        assert got.space.vocabulary() == want.space.vocabulary()
    assert set(got.resources) == set(want.resources)
    for k in want.resources:
        np.testing.assert_allclose(got.resources[k], want.resources[k],
                                   rtol=1e-6)
    assert set(got.invocations) == set(want.invocations)
    for k in want.invocations:
        np.testing.assert_array_equal(got.invocations[k], want.invocations[k])


def three_ways(path, cfg: dict, jax_buckets=None):
    """(native, the port's numpy featurizer, JAX's Python pipeline) on one
    JSONL corpus."""
    got = native.featurize_jsonl(path, FeaturizeConfig(**cfg))
    port = featurize.featurize_buckets(schema.load_raw_data(path),
                                       FeaturizeConfig(**cfg))
    if jax_buckets is None:
        jax_buckets = jax_schema.load_raw_data(path)
    want = jax_featurize.featurize_buckets(jax_buckets,
                                           JaxFeaturizeConfig(**cfg))
    return got, port, want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_matches_python_pipelines(corpus_file, mode):
    path, buckets = corpus_file
    got, port, want = three_ways(path, MODES[mode], buckets)
    assert_featurized_equal(got, want)
    assert_featurized_equal(got, port)
    # the native space is frozen at the header's capacity, as JAX sets it
    assert got.space.frozen_capacity == got.traffic.shape[1]
    assert got.space.frozen_capacity == want.space.capacity
    if not got.space.config.hash_features:
        assert list(got.space.index) == list(want.space.index)
        assert got.space.endpoints() == want.space.endpoints()
    else:
        assert got.space.index == {}
    if mode == "overflow":
        assert got.traffic.shape[1] == 8
        assert got.space.num_observed > 8     # paths past 8 columns dropped


def test_the_library_is_built_under_build_native():
    lib = native.load_library()
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(REPO, "build", "native")
    assert os.path.basename(lib._name).startswith("libdeeprest_etl-")
    assert native.native_available()
    # nothing half-written is left beside it
    assert not [n for n in os.listdir(native.BUILD_DIR) if ".tmp" in n]


def test_stable_hash_matches_jax_over_many_paths_and_seeds():
    rng = np.random.default_rng(7)
    alphabet = list("abcxyz_/-.") + ["ü", "ï", "ä", "\U0001F600", "\x1f"]
    joined = ["a_/op", "a_/op\x1fb_/x", "nginx-thrift_/wrk2-api/post/compose",
              "ünïcode_/päth", ""]
    joined += ["".join(rng.choice(alphabet, size=int(rng.integers(1, 40))))
               for _ in range(200)]
    seeds = [0, 7, 99, 0x5EED, (1 << 64) - 1] + [
        int(s) for s in rng.integers(0, 1 << 62, size=20)]
    for text in joined:
        for seed in seeds:
            want = jax_featurize._stable_hash(tuple(text.split("\x1f")), seed)
            assert native.stable_hash_native(text, seed) == want, (text, seed)
            assert featurize._stable_hash(tuple(text.split("\x1f")),
                                          seed) == want


def test_duplicate_metric_in_later_bucket_raises_as_jax_raises(tmp_path):
    lines = [
        '{"metrics":[{"component":"a","resource":"cpu","value":1},'
        '{"component":"b","resource":"cpu","value":2}],"traces":[]}',
        '{"metrics":[{"component":"a","resource":"cpu","value":1},'
        '{"component":"a","resource":"cpu","value":3}],"traces":[]}',
    ]
    p = tmp_path / "dup.jsonl"
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="duplicate metric") as jax_err:
        jax_featurize.featurize_buckets(jax_schema.load_raw_data(str(p)))
    assert "bucket 1" in str(jax_err.value)
    with pytest.raises(ValueError, match="duplicate metric"):
        featurize.featurize_buckets(schema.load_raw_data(str(p)))
    with pytest.raises(ValueError, match="native featurize failed.*"
                                         "duplicate metric"):
        native.featurize_jsonl(str(p), FeaturizeConfig())


def test_empty_corpus(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    got = native.featurize_jsonl(str(p), FeaturizeConfig())
    want = jax_featurize.featurize_buckets([], JaxFeaturizeConfig())
    assert got.traffic.shape == want.traffic.shape == (0, 128)
    assert got.resources == want.resources == {}
    assert list(got.invocations) == list(want.invocations) == ["general"]
    assert got.invocations["general"].shape == (0,)


def test_astral_unicode(tmp_path):
    """Non-BMP characters (JSON surrogate pairs) hash and enter the
    vocabulary alike in C++ and Python."""
    bucket = {
        "metrics": [{"component": "svc", "resource": "cpu", "value": 1.0}],
        "traces": [{"component": "svc", "operation": "/p\U0001F600th",
                    "children": [{"component": "d\U0001F680b",
                                  "operation": "/q", "children": []}]}],
    }
    p = tmp_path / "astral.jsonl"
    p.write_text(json.dumps(bucket) + "\n")        # ensure_ascii: 😀
    for cfg in (dict(hash_features=True, capacity=64, hash_seed=5),
                dict(round_to=8)):
        got, port, want = three_ways(str(p), cfg)
        assert_featurized_equal(got, want)
        assert_featurized_equal(got, port)
    assert ("svc_/p\U0001F600th",) in got.space.index


def test_huge_numbers(tmp_path):
    p = tmp_path / "huge.jsonl"
    p.write_text('{"metrics":[{"component":"a","resource":"cpu",'
                 '"value":1e999},{"component":"a","resource":"memory",'
                 '"value":-1e999},{"component":"b","resource":"cpu",'
                 '"value":1e38}],"traces":[]}\n')
    got, port, want = three_ways(str(p), {})
    assert np.isposinf(got.resources["a_cpu"][0])
    assert np.isneginf(got.resources["a_memory"][0])
    assert_featurized_equal(got, want)
    assert_featurized_equal(got, port)


def test_error_report_for_malformed_lines(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"metrics": [}\n')
    with pytest.raises(ValueError, match="native featurize failed"):
        native.featurize_jsonl(str(bad), FeaturizeConfig())
    with pytest.raises(ValueError):           # JAX's json.loads refuses it
        jax_schema.load_raw_data(str(bad))
    # the C++-side hash-capacity guard, past the dataclass's own check
    cfg = FeaturizeConfig()
    object.__setattr__(cfg, "hash_features", True)
    object.__setattr__(cfg, "capacity", 0)
    with pytest.raises(ValueError, match="hash mode requires"):
        native.featurize_jsonl(str(bad), cfg)
    with pytest.raises(ValueError, match="native featurize failed"):
        native.featurize_jsonl(str(tmp_path / "missing.jsonl"),
                               FeaturizeConfig())


def test_component_named_general(tmp_path):
    """A real component named "general" shares the synthetic whole-trace
    counter as the Python side merges them."""
    buckets = [
        jax_schema.Bucket(
            metrics=[jax_schema.MetricSample("general", "cpu", float(t))],
            traces=[jax_schema.Span("general", "/op",
                                    [jax_schema.Span("svc", "/x")])] * (t + 1),
        )
        for t in range(3)
    ]
    path = tmp_path / "general.jsonl"
    jax_schema.save_raw_data_jsonl(buckets, str(path))
    got, port, want = three_ways(str(path), dict(round_to=8), buckets)
    assert_featurized_equal(got, want)
    assert_featurized_equal(got, port)
    np.testing.assert_array_equal(got.invocations["general"], [2, 4, 6])


def test_nan_and_infinity_metric_values(tmp_path):
    """json.dump writes bare NaN/Infinity literals; the native parser reads
    them as the Python loader does."""
    buckets = [
        jax_schema.Bucket(metrics=[jax_schema.MetricSample("c", "cpu", v)],
                          traces=[jax_schema.Span("c", "/op")])
        for v in (float("nan"), float("inf"), float("-inf"))
    ]
    path = tmp_path / "nan.jsonl"
    jax_schema.save_raw_data_jsonl(buckets, str(path))
    got, port, want = three_ways(str(path), dict(round_to=8), buckets)
    series = got.resources["c_cpu"]
    assert np.isnan(series[0]) and np.isposinf(series[1])
    assert np.isneginf(series[2])
    np.testing.assert_array_equal(series, want.resources["c_cpu"])
    np.testing.assert_array_equal(series, port.resources["c_cpu"])
    np.testing.assert_array_equal(got.traffic, want.traffic)


def test_10k_hash_corpus_of_the_synthetic_app(tmp_path):
    """F=10240 in hash mode on the port's synthetic microservice app (160
    buckets of 60 services and 300 endpoints: thousands of call paths)."""
    scn = normal_scenario(3)
    scn.calls_per_user = 0.1
    app, endpoints = build_synthetic_app(scn, 60, 300, 3)
    buckets = simulate_corpus(scn, 160, app=app, endpoints=endpoints)
    path = tmp_path / "tenk.jsonl"
    schema.save_raw_data_jsonl(buckets, str(path))
    cfg = dict(hash_features=True, capacity=10240)
    got, port, want = three_ways(str(path), cfg)
    assert got.traffic.shape == (160, 10240)
    assert_featurized_equal(got, want)
    assert_featurized_equal(got, port)
    paths = {p for b in buckets for t in b.traces for p, _ in t.walk()}
    assert len(paths) > 1000
    assert int((got.traffic.sum(0) > 0).sum()) > 1000


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                      corpus_file):
    path, _ = corpus_file
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "false")    # a compiler that fails
    for require in (False, True):
        with pytest.raises(RuntimeError, match="building the native ETL"):
            native.featurize_jsonl(path, FeaturizeConfig(),
                                   require_native=require)
    with pytest.raises(RuntimeError, match="building the native ETL"):
        native.native_available()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        native.featurize_jsonl(path, FeaturizeConfig())
    # a wrapper that leaves libstdc++ out of the link: without -z defs the
    # library would build and crash at its first call into the runtime
    wrapper = tmp_path / "g++"
    wrapper.write_text(f"#!/bin/sh\nexec {shutil.which('g++')} "
                       "-nodefaultlibs -lc -lm -lgcc_s \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(wrapper))
    with pytest.raises(RuntimeError, match="undefined reference"):
        native.featurize_jsonl(path, FeaturizeConfig())
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setenv(native.ENV_OVERRIDE, str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="does not exist"):
        native.featurize_jsonl(path, FeaturizeConfig())
    junk = tmp_path / "junk.so"
    junk.write_text("not a shared object")
    monkeypatch.setenv(native.ENV_OVERRIDE, str(junk))
    with pytest.raises(OSError):
        native.featurize_jsonl(path, FeaturizeConfig())
    assert native._lib is None


_BUILDER = """
import sys
import numpy as np
from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data import native
build_dir, corpus, out = sys.argv[1:4]
lib = native.build_library(build_dir)
native.os.environ[native.ENV_OVERRIDE] = lib
data = native.featurize_jsonl(
    corpus, FeaturizeConfig(hash_features=True, capacity=96, hash_seed=1234))
assert native.load_library()._name == lib
np.save(out, data.traffic)
print(lib)
"""


def test_two_processes_building_at_once_both_load_it_and_agree(tmp_path,
                                                               corpus_file):
    """Two processes build into one empty directory at once; each loads a
    whole library (through DEEPREST_ETL_LIB) and featurizes alike."""
    path, buckets = corpus_file
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(native.ENV_OVERRIDE, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(build_dir), path,
         str(tmp_path / f"traffic{i}.npy")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {out.strip() for out, _ in outs}
    assert libs == {native.library_path(str(build_dir))}
    assert os.listdir(build_dir) == [os.path.basename(libs.pop())]
    a, b = (np.load(tmp_path / f"traffic{i}.npy") for i in range(2))
    np.testing.assert_array_equal(a, b)
    want = jax_featurize.featurize_buckets(
        buckets, JaxFeaturizeConfig(hash_features=True, capacity=96,
                                    hash_seed=1234))
    np.testing.assert_array_equal(a, want.traffic)
