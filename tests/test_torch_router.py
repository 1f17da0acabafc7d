"""The port's replica plane (serve/replica.py, serve/router.py and the
router half of serve/server.py and the serve CLI) against the JAX
package's, on the CPU.

The models are tests/router_test_support.py's (F=6, E=3, H=8, W=8, one
rung): the JAX stack's params are carried into the port with
``interop.params_from_jax``, and the port's stacks run on
``device="cpu"`` through the plain recurrence.  Routed answers are bit
for bit one engine's and within 1e-5 of the JAX router's; the admission
front, pure host code, is held against JAX's grant for grant; metadata,
``/healthz`` keys, ``/metrics`` names, 429 headers, validation messages
and CLI flags equal JAX's.  Every server, router and worker is closed in a
``finally``; every wait has a deadline.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
from router_test_support import E, F, W
from router_test_support import build_tiny as jax_build_tiny
from test_torch_router_support import build_tiny, write_checkpoint

from deeprest_tpu.serve import PredictionServer as JaxServer
from deeprest_tpu.serve import PredictionService as JaxService
from deeprest_tpu.serve.replica import EngineReplica as JaxEngineReplica
from deeprest_tpu.serve.router import AdmissionError as JaxAdmissionError
from deeprest_tpu.serve.router import ReplicaRouter as JaxRouter
from deeprest_tpu.serve.router import RouterConfig as JaxRouterConfig
from deeprest_tpu.serve.router import WeightedAdmission as JaxAdmission
from deeprest_tpu_torch.serve.replica import (
    EngineReplica, ProcessReplica, clone_backend,
)
from deeprest_tpu_torch.serve.router import (
    AdmissionError, ReplicaRouter, RouterConfig, WeightedAdmission,
)
from deeprest_tpu_torch.serve.server import (
    PredictionServer, PredictionService,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
DEADLINE = 30.0


def jax_params(jax_pred) -> dict:
    return {k: np.array(v) for k, v in jax_pred.params.items()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX predictor, port predictor on the same params, npz of them)."""
    jpred = jax_build_tiny(ladder=(8,))
    params = jax_params(jpred)
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    np.savez(path, **params)
    return jpred, build_tiny(ladder=(8,), params_path=path), path


@pytest.fixture
def traffic():
    return np.random.default_rng(0).random((2 * W, F)).astype(np.float32)


def wait_until(cond, what: str, timeout: float = DEADLINE):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# Routing correctness


@pytest.mark.parametrize("n", [1, 2, 4])
def test_routed_results_bit_equal_and_match_jax(pair, traffic, n):
    """Concurrent routed answers equal one engine's bit for bit at N in
    {1, 2, 4}, and the JAX router's within 1e-5 on the same params."""
    jpred, pred, _ = pair
    reference = pred.predict_series(traffic)
    jrouter = JaxRouter.build(jpred, n, devices=[jax.devices()[0]])
    router = ReplicaRouter.build(pred, n)
    try:
        want = jrouter.predict_series(traffic)
        results: dict[int, np.ndarray] = {}

        def worker(i):
            results[i] = router.predict_series(traffic)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3 * n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
        assert len(results) == 3 * n
        for i, got in results.items():
            assert np.array_equal(got, reference), f"request {i} diverged"
        np.testing.assert_allclose(reference, want, rtol=TOL, atol=TOL)
        many = router.predict_series_many([traffic, traffic[:W + 3]])
        jmany = jrouter.predict_series_many([traffic, traffic[:W + 3]])
        for got, w in zip(many, jmany):
            np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
        stats = router.router_stats()
        assert stats["num_replicas"] == n
        assert sum(r["served_requests"]
                   for r in stats["replicas"]) == 3 * n + 2
    finally:
        router.close()
        jrouter.close()


def test_router_protocol_and_metadata_match_jax(pair):
    jpred, pred, _ = pair
    jrouter = JaxRouter.build(jpred, 2, devices=[jax.devices()[0]])
    router = ReplicaRouter.build(pred, 2)
    try:
        for key in ("metric_names", "window_size", "feature_dim",
                    "quantiles", "delta_mask", "space_dict"):
            assert getattr(router, key) == getattr(jrouter, key), key
        assert router.median_index() == jrouter.median_index()
        assert router.space() is None and jrouter.space() is None
        assert router.y_stats.to_dict() == jrouter.y_stats.to_dict()
        assert router.window_size == pred.window_size
        assert router.quantiles == pred.quantiles
    finally:
        router.close()
        jrouter.close()


def test_least_outstanding_work_prefers_idle_replica(pair):
    router = ReplicaRouter.build(pair[1], 2)
    try:
        busy, idle = router.replicas
        busy._begin(100)       # synthetic outstanding windows
        try:
            for _ in range(4):
                assert router._pick() is idle
        finally:
            busy._end(100, requests=0)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# Admission: pure host code, held against JAX grant for grant


def _comparable(stats: dict) -> dict:
    """Admission stats less the in-plane latency percentiles (clock)."""
    return {k: v for k, v in stats.items() if not k.startswith("in_plane")}


def run_admission_script(admission_cls, error_cls, config,
                         tenants: str) -> dict:
    """Depth-1 plane held by tenant "a"; waiters of ``tenants`` queue one
    by one (so the queue order is the script's), then each grant is
    recorded and released in turn: the grant order is the WRR's alone."""
    adm = admission_cls(config)
    hold = adm.try_acquire("a")
    order, release, errors = [], {}, []
    lock = threading.Lock()

    def waiter(i, tenant):
        try:
            ticket = adm.try_acquire(tenant)
        except error_cls as exc:
            with lock:
                errors.append((tenant, exc.status, str(exc),
                               exc.headers.get("Retry-After")))
            return
        with lock:
            order.append(tenant)
            ev = release[i] = threading.Event()
        ev.wait(DEADLINE)
        ticket.__exit__(None, None, None)

    threads = []
    for i, tenant in enumerate(tenants):
        t = threading.Thread(target=waiter, args=(i, tenant), daemon=True)
        threads.append(t)
        t.start()
        wait_until(lambda: adm.stats()["waiting"] + len(errors) >= i + 1,
                   "waiter never queued")
    hold.__exit__(None, None, None)
    for k in range(len(tenants) - len(errors)):
        wait_until(lambda: len(order) > k, "grant never landed")
        with lock:
            ev = list(release.values())[k]
        ev.set()
    for t in threads:
        t.join(timeout=DEADLINE)
        assert not t.is_alive()
    return {"order": order, "errors": errors, "counts": adm.counts(),
            "stats": _comparable(adm.stats())}


@pytest.mark.parametrize("weights,tenants", [
    ({"a": 3.0, "b": 1.0}, "aaaaaaaaaaaabbbb"),
    ({"a": 3.0, "b": 1.0, "c": 2.0}, "abcabcaabbccacb"),
    (None, "babab"),
])
def test_weighted_admission_grant_order_equals_jax(weights, tenants):
    kw = dict(admission_depth=1, max_wait_s=30.0, max_waiting=64,
              tenant_weights=weights)
    got = run_admission_script(WeightedAdmission, AdmissionError,
                               RouterConfig(**kw), tenants)
    want = run_admission_script(JaxAdmission, JaxAdmissionError,
                                JaxRouterConfig(**kw), tenants)
    assert got == want
    if weights == {"a": 3.0, "b": 1.0}:
        # the light tenant is not starved behind the heavy one's queue
        assert got["order"][:8].count("b") >= 1
        assert got["stats"]["tenants"]["a"]["admitted"] == 13


def test_admission_fast_429_and_wait_timeout_equal_jax():
    """max_wait 0: past the depth every request is a fast 429 with
    Retry-After; a wait that times out turns into a 429 too; a bounded
    wait grants when a slot frees.  Messages, headers and counts equal
    JAX's."""
    def script(adm_cls, err_cls, cfg_cls):
        out = {}
        adm = adm_cls(cfg_cls(admission_depth=2, max_wait_s=0.0,
                              retry_after_s=0.123))
        held = [adm.try_acquire("a"), adm.try_acquire("b")]
        fast = []
        for tenant in ("a", "c", None):
            with pytest.raises(err_cls) as exc:
                adm.try_acquire(tenant)
            fast.append((exc.value.status, str(exc.value),
                         exc.value.headers, exc.value.retry_after_s))
        for t in held:
            t.__exit__(None, None, None)
        out["fast"] = (fast, adm.counts(), _comparable(adm.stats()))
        adm = adm_cls(cfg_cls(admission_depth=1, max_wait_s=0.05,
                              retry_after_s=0.01))
        ticket = adm.try_acquire("a")
        with pytest.raises(err_cls) as exc:
            adm.try_acquire("b")
        ticket.__exit__(None, None, None)
        out["timeout"] = (exc.value.status, str(exc.value),
                          exc.value.headers, adm.counts(),
                          _comparable(adm.stats()))
        adm = adm_cls(cfg_cls(admission_depth=1, max_wait_s=DEADLINE))
        first = adm.try_acquire("a")
        granted = []

        def waiter():
            with adm.try_acquire("b"):
                granted.append("b")

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        wait_until(lambda: adm.stats()["waiting"] == 1, "never queued")
        first.__exit__(None, None, None)
        t.join(timeout=DEADLINE)
        assert not t.is_alive() and granted == ["b"]
        out["granted"] = (adm.counts(), _comparable(adm.stats()))
        return out

    got = script(WeightedAdmission, AdmissionError, RouterConfig)
    want = script(JaxAdmission, JaxAdmissionError, JaxRouterConfig)
    assert got == want
    assert got["fast"][0][0][2] == {"Retry-After": "0.123"}
    assert got["timeout"][0] == 429
    assert got["granted"][1]["inflight"] == 0


@pytest.mark.parametrize("kwargs", [
    {"admission_depth": 0}, {"max_waiting": -1}, {"max_wait_s": -1.0},
    {"retry_after_s": -0.5}, {"tenant_weights": {"a": 0.0}},
    {"replica_timeout_s": 0.0}, {"eject_after_failures": 0},
    {"retry_budget": -1}, {"probe_interval_s": 0.0},
])
def test_router_config_messages_equal_jax(kwargs):
    with pytest.raises(ValueError) as got:
        RouterConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JaxRouterConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["a=3,b=1", "a", "a=x", "=2", "a=0",
                                  "a=-1,b=2", None, ""])
def test_tenant_weights_parse_equals_jax(spec):
    from deeprest_tpu.cli import _parse_tenant_weights as jax_parse
    from deeprest_tpu_torch.cli import _parse_tenant_weights

    def run(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as exc:
            return ("error", str(exc))

    assert run(_parse_tenant_weights) == run(jax_parse)


# ---------------------------------------------------------------------------
# Rolling reload


def test_rolling_reload_no_mixed_params_under_live_load(pair, traffic):
    """Under continuous load every response during a rolling reload equals
    EITHER the old params' output or the new params' output, and no
    request fails."""
    pred_a = build_tiny(scale=1.0, params_path=pair[2])
    pred_b = build_tiny(scale=1.5, params_path=pair[2])
    ref_a = pred_a.predict_series(traffic)
    ref_b = pred_b.predict_series(traffic)
    assert not np.allclose(ref_a, ref_b)
    router = ReplicaRouter.build(pred_a, 2)
    try:
        stop = threading.Event()
        outputs, failures = [], []
        lock = threading.Lock()

        def load():
            while not stop.is_set():
                try:
                    out = router.predict_series(traffic)
                except BaseException as exc:
                    with lock:
                        failures.append(exc)
                    return
                with lock:
                    outputs.append(out)

        threads = [threading.Thread(target=load, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        wait_until(lambda: len(outputs) >= 8, "no load before the reload")
        router.rolling_reload_from(pred_b)
        with lock:
            at_reload = len(outputs)
        wait_until(lambda: len(outputs) >= at_reload + 8,
                   "no load after the reload")
        stop.set()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
        assert not failures, failures
        n_a = sum(np.array_equal(o, ref_a) for o in outputs)
        n_b = sum(np.array_equal(o, ref_b) for o in outputs)
        assert n_a + n_b == len(outputs), "a response mixed old and new"
        assert n_a >= 1 and n_b >= 1
        stats = router.router_stats()
        assert stats["rolling_reloads"] == 1
        assert stats["last_reload_reason"] == "watch"
        # one device: the fresh stack itself replaced the shared one
        assert {id(r.backend()) for r in router.replicas} == {id(pred_b)}
    finally:
        router.close()


class OneShotReloader:
    def __init__(self, fresh):
        self._fresh = fresh

    def poll(self):
        fresh, self._fresh = self._fresh, None
        return fresh


def test_service_maybe_reload_rolls_the_router(pair, traffic):
    pred_b = build_tiny(scale=2.0, params_path=pair[2])
    ref_b = pred_b.predict_series(traffic)
    router = ReplicaRouter.build(build_tiny(params_path=pair[2]), 2)
    service = PredictionService(router, None, backend="roll",
                                reloader=OneShotReloader(pred_b))
    try:
        service.maybe_reload()
        health = service.healthz()
        assert health["reloads"] == 1
        assert health["router"]["rolling_reloads"] == 1
        out = service.predict({"traffic": traffic.tolist()})
        assert np.array_equal(np.asarray(out["predictions"], np.float32),
                              ref_b)
    finally:
        service.close()


# ---------------------------------------------------------------------------
# Stacks


def test_replicas_on_one_device_share_one_stack(pair, traffic):
    """Four replicas on the CPU share the base stack: routing adds no
    (program, rung) key beyond the warmed ones (on a GPU, no captured
    graph)."""
    pred = build_tiny(params_path=pair[2])
    pred.warm()
    pred.predict_series(traffic)
    warm = pred.jit_cache_size()
    assert warm >= 1
    router = ReplicaRouter.build(pred, 4)
    try:
        assert {id(r.backend()) for r in router.replicas} == {id(pred)}
        assert {str(r.device) for r in router.replicas} == {"cpu"}
        for _ in range(6):
            assert router.predict_series(traffic).shape == (len(traffic),
                                                            E, 3)
        assert pred.jit_cache_size() == warm
        assert router.jit_cache_size() == warm
    finally:
        router.close()


def test_clone_backend_matches_base(pair, traffic):
    pred = pair[1]
    clone = clone_backend(pred)
    assert clone is not pred and clone.device == pred.device
    assert np.array_equal(clone.predict_series(traffic),
                          pred.predict_series(traffic))
    assert clone.ladder.base_ladder == pred.ladder.base_ladder
    assert clone.params_digest() == pred.params_digest()


def test_clone_of_a_quantized_predictor_is_refused(pair):
    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.serve.predictor import Predictor

    p = pair[1]
    q = Predictor({k: v.detach().numpy() for k, v in p.params.items()},
                  ModelConfig(feature_dim=F, num_metrics=E, hidden_size=8,
                              dropout_rate=0.0),
                  p.x_stats, p.y_stats, p.metric_names, W, ladder=(8,),
                  quant="int8", device="cpu")
    with pytest.raises(ValueError, match="--replica-mode process"):
        clone_backend(q)


# ---------------------------------------------------------------------------
# Scaling and the autoscaler


def test_scale_to_grows_and_shrinks(pair, traffic):
    pred = pair[1]
    router = ReplicaRouter.build(pred, 1)
    try:
        assert router.scale_to(3) == 3
        assert len(router.replicas) == 3
        ref = pred.predict_series(traffic)
        for _ in range(6):
            assert np.array_equal(router.predict_series(traffic), ref)
        assert router.scale_to(1) == 1
        assert len(router.replicas) == 1
        assert np.array_equal(router.predict_series(traffic), ref)
    finally:
        router.close()


class _SwapBatcher:
    def __init__(self):
        self.closed = 0

    def close(self):
        self.closed += 1


class _SwapStack:
    """Minimal backend surface for reload_backend: a batcher slot."""

    def __init__(self):
        self.batcher = _SwapBatcher()

    def attach_batcher(self, b):
        self.batcher = b


def test_reload_backend_swap_chain_under_concurrent_reloads():
    """Concurrent reloads form an exact swap chain: every retired stack's
    batcher is closed exactly once and only the final stack's survives."""
    base = _SwapStack()
    replica = EngineReplica(base, name="swap")
    fresh = [_SwapStack() for _ in range(120)]
    batchers = {id(s): s.batcher for s in [base] + fresh}

    def worker(chunk):
        for s in chunk:
            replica.reload_backend(s)

    threads = [threading.Thread(target=worker, args=(fresh[i::4],))
               for i in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    final = replica.backend()
    assert batchers[id(final)].closed == 0
    retired = [b for sid, b in batchers.items() if sid != id(final)]
    assert sorted(b.closed for b in retired) == [1] * len(retired)


def test_scale_to_concurrent_growth_never_overshoots():
    import torch

    stack = _SwapStack()
    stack.batcher = None
    stack.device = torch.device("cpu")
    stack.metric_names = ["c0_cpu"]
    stack.window_size = W
    stack.feature_dim = F
    stack.quantiles = (0.5,)
    stack.delta_mask = None
    stack.median_index = lambda: 0

    class _Lead:
        def __init__(self, name):
            self.name = name
            self.device = torch.device("cpu")

        def backend(self):
            return stack

        def drain(self):
            pass

        def close(self):
            pass

    router = ReplicaRouter([_Lead("r0")])
    try:
        threads = [threading.Thread(target=router.scale_to, args=(6,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
        assert len(router.replicas) == 6
    finally:
        router.close()


def _load_autoscaler():
    from deeprest_tpu_torch.cli import _load_autoscaler_module

    return _load_autoscaler_module()


def test_autoscaler_measured_basis_scales_with_demand(pair, traffic):
    mod = _load_autoscaler()
    router = ReplicaRouter.build(pair[1], 1)
    try:
        asc = mod.Autoscaler(
            router,
            mod.AutoscalerConfig(min_replicas=1, max_replicas=4,
                                 capacity_rps_per_replica=10.0,
                                 target_utilization=0.5),
            actuate=True)
        asc.sample(now=0.0)
        for _ in range(20):
            router.predict_series(traffic)
        decision = asc.step(now=1.0)     # ~20 rps -> ceil(20/5) = 4
        assert decision["desired"] == 4 and decision["applied"]
        assert len(router.replicas) == 4
        assert decision["basis"]["mode"] == "measured"
        service = PredictionService(router, None, backend="asc")
        assert service.healthz()["router"]["autoscaler"]["desired"] == 4
        with asc._lock:
            asc._samples.clear()
        asc.sample(now=10.0)
        decision = asc.step(now=20.0)
        assert decision["desired"] == 1
        assert len(router.replicas) == 1
    finally:
        router.close()


def test_autoscaler_model_basis_with_a_stub_estimator(pair):
    mod = _load_autoscaler()

    class StubEstimator:
        def __init__(self):
            self.programs = []

        def estimate(self, program, seed=0):
            self.programs.append(program)
            rps = program[0]["serve_/v1/predict"]
            series = np.full((len(program),), 0.9 * rps, np.float32)
            return {"predictor_cpu": {"q50": series}}

    router = ReplicaRouter.build(pair[1], 1)
    try:
        est = StubEstimator()
        asc = mod.Autoscaler(
            router,
            mod.AutoscalerConfig(min_replicas=1, max_replicas=8,
                                 endpoint="serve_/v1/predict",
                                 metric="predictor_cpu",
                                 unit_capacity=3.0,
                                 target_utilization=1.0),
            estimator=est, actuate=False)
        decision = asc.desired_replicas(mean_rps=10.0, peak_rps=10.0)
        assert decision["desired"] == 3
        assert decision["basis"]["mode"] == "model"
        assert est.programs[0][0] == {"serve_/v1/predict": 10}
    finally:
        router.close()


def test_autoscaler_writes_k8s_manifest(pair, tmp_path):
    import shutil

    import yaml

    mod = _load_autoscaler()
    manifest = tmp_path / "predictor.yaml"
    shutil.copy(os.path.join(REPO, "deploy", "k8s", "predictor.yaml"),
                manifest)
    router = ReplicaRouter.build(pair[1], 1)
    try:
        asc = mod.Autoscaler(
            router,
            mod.AutoscalerConfig(min_replicas=1, max_replicas=8,
                                 capacity_rps_per_replica=1.0),
            manifest_path=str(manifest), actuate=False)
        asc.write_manifest(5)
        with open(manifest) as f:
            docs = list(yaml.safe_load_all(f))
        dep = next(d for d in docs if d["kind"] == "Deployment")
        assert dep["spec"]["replicas"] == 5
        assert dep["metadata"]["name"] == "deeprest-predictor"
    finally:
        router.close()


# ---------------------------------------------------------------------------
# HTTP: /healthz, /metrics and the 429 against the JAX service


def test_healthz_router_block_and_metrics_names_match_jax(pair, traffic):
    jpred, pred, _ = pair
    jrouter = JaxRouter.build(jpred, 2, devices=[jax.devices()[0]])
    router = ReplicaRouter.build(pred, 2)
    jsvc = JaxService(jrouter, None, backend="jax")
    svc = PredictionService(router, None, backend="port")
    try:
        for s in (svc, jsvc):
            s.predict({"traffic": traffic.tolist()})
        got, want = svc.healthz()["router"], jsvc.healthz()["router"]
        assert set(got) == set(want)
        assert set(got["admission"]) == set(want["admission"])
        assert set(got["health"]) == set(want["health"])
        for g, w in zip(got["replicas"], want["replicas"]):
            assert set(g) == set(w)
            assert set(g["health"]) == set(w["health"])

        def names(text):
            return {line.split()[2] for line in text.splitlines()
                    if line.startswith("# TYPE")
                    and line.split()[2].startswith(
                        ("deeprest_router_", "deeprest_replica_",
                         "deeprest_admission_", "deeprest_in_plane_"))}

        jnames = names(jsvc.metrics_text())
        assert jnames and names(svc.metrics_text()) == jnames
    finally:
        svc.close()
        jsvc.close()


class _GatedBackend:
    """A serving backend whose predict blocks on a gate: holds admission
    slots deterministically."""

    metric_names = [f"c{i}_cpu" for i in range(E)]
    window_size = W
    feature_dim = F
    quantiles = (0.05, 0.5, 0.95)
    delta_mask = None
    space_dict = None
    batcher = None

    def __init__(self):
        self.gate = threading.Event()

    def median_index(self):
        return 1

    def attach_batcher(self, b):
        self.batcher = b

    def predict_series(self, traffic, integrate=True):
        self.gate.wait(timeout=DEADLINE)
        return np.zeros((len(traffic), E, 3), np.float32)

    def predict_series_many(self, series_list, integrate=True):
        return [self.predict_series(s, integrate) for s in series_list]


def admission_429_over_http(server_cls, service_cls, router_cls, replica_cls,
                            config, traffic):
    stub = _GatedBackend()
    router = router_cls([replica_cls(stub, name="r0")], config=config)
    server = server_cls(service_cls(router, None, backend="adm"),
                        port=0).start()
    payload = json.dumps({"traffic": traffic.tolist()}).encode()
    statuses = {}

    def client(i):
        conn = http.client.HTTPConnection(*server.address, timeout=DEADLINE)
        try:
            conn.request("POST", "/v1/predict", body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            statuses[i] = (resp.status, resp.getheader("Retry-After"),
                           json.loads(resp.read()))
        finally:
            conn.close()

    try:
        t0 = threading.Thread(target=client, args=(0,), daemon=True)
        t0.start()
        wait_until(lambda: router.admission.stats()["inflight"] >= 1,
                   "first request never admitted")
        client(1)
        stub.gate.set()
        t0.join(timeout=DEADLINE)
        assert not t0.is_alive()
        adm = router.admission.stats()
        return statuses, (adm["admitted"], adm["rejected"])
    finally:
        stub.gate.set()
        server.stop()


def test_admission_429_retry_after_over_http_equals_jax(traffic):
    kw = dict(admission_depth=1, max_wait_s=0.0, retry_after_s=0.123)
    got = admission_429_over_http(PredictionServer, PredictionService,
                                  ReplicaRouter, EngineReplica,
                                  RouterConfig(**kw), traffic)
    want = admission_429_over_http(JaxServer, JaxService, JaxRouter,
                                   JaxEngineReplica, JaxRouterConfig(**kw),
                                   traffic)
    statuses, counts = got
    assert statuses[1] == want[0][1]
    assert statuses[1][:2] == (429, "0.123")
    assert "saturated" in statuses[1][2]["error"]
    assert statuses[0][0] == want[0][0][0] == 200
    assert counts == want[1] == (1, 1)


# ---------------------------------------------------------------------------
# CLI


REPLICA_FLAGS = ("--replicas", "--replica-mode", "--admission-depth",
                 "--admission-wait-ms", "--admission-retry-after-ms",
                 "--tenant-weights", "--replica-timeout-ms",
                 "--eject-after-failures", "--retry-budget", "--autoscale",
                 "--autoscale-min", "--autoscale-max",
                 "--autoscale-interval", "--autoscale-rps-per-replica",
                 "--autoscale-manifest")


def test_serve_help_covers_replica_flags(capsys):
    from deeprest_tpu_torch.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--help"])
    out = capsys.readouterr().out
    for flag in REPLICA_FLAGS:
        assert flag in out, f"serve --help missing {flag}"


def _serve_actions(parser) -> dict:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {opt: a for a in sub.choices["serve"]._actions
            for opt in a.option_strings}


def test_serve_parsers_agree_on_replica_flags():
    from deeprest_tpu.cli import build_parser as jax_parser
    from deeprest_tpu_torch.cli import build_parser

    got, want = _serve_actions(build_parser()), _serve_actions(jax_parser())
    for flag in REPLICA_FLAGS:
        g, w = got[flag], want[flag]
        assert (g.dest, g.default, g.type, g.choices, g.nargs) == \
            (w.dest, w.default, w.type, w.choices, w.nargs), flag
    args = build_parser().parse_args(["serve", "--ckpt-dir", "c"])
    jargs = jax_parser().parse_args(["serve", "--ckpt-dir", "c"])
    for flag in REPLICA_FLAGS:
        dest = got[flag].dest
        assert getattr(args, dest) == getattr(jargs, dest)


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value.code)


@pytest.mark.parametrize("argv", [
    ["--tenant-weights", "a=0"],
    ["--tenant-weights", "a=x"],
    ["--replicas", "2", "--replica-timeout-ms", "-1"],
    ["--autoscale"],
])
def test_serve_router_flag_errors_equal_jax(argv, pair, tmp_path,
                                            monkeypatch):
    """The router flags' errors equal JAX's.  The JAX CLI checks them after
    it loads its model (here handed the tiny JAX predictor); the port
    checks them before it loads anything."""
    from deeprest_tpu import cli as jax_cli
    from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
    from deeprest_tpu_torch import cli as port_cli

    monkeypatch.setattr(JaxPredictor, "from_checkpoint",
                        classmethod(lambda cls, *a, **k: pair[0]))
    want = _exit_message(jax_cli.main, ["serve", "--ckpt-dir",
                                        str(tmp_path), *argv])
    got = _exit_message(port_cli.main, ["serve", "--ckpt-dir",
                                        str(tmp_path / "none"), *argv,
                                        "--device", "cpu"])
    assert got == want and got.startswith("error: ")


def test_serve_cli_process_replicas_answer(pair, tmp_path, traffic):
    """``serve --replicas 2 --replica-mode process --device cpu --port 0``
    in its own process answers /v1/predict (bit for bit one engine) and
    /healthz with the router block; killed in a ``finally``."""
    ckpt = write_checkpoint(tmp_path / "ckpt", pair[2])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         ckpt, "--replicas", "2", "--replica-mode", "process", "--device",
         "cpu", "--port", "0", "--deadline", "60", "--batch-ladder", "8",
         "--batch-max-windows", "8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        start = json.loads(line)
        assert start["replicas"] == 2 and start["device"] == "cpu"
        assert len(start["graphs"]) == 2
        host, port = start["listening"][len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=DEADLINE)
        conn.request("POST", "/v1/predict",
                     json.dumps({"traffic": traffic.tolist()}))
        resp = conn.getresponse()
        assert resp.status == 200
        got = np.asarray(json.loads(resp.read())["predictions"], np.float32)
        from deeprest_tpu_torch.serve.predictor import Predictor

        want = Predictor.from_checkpoint(ckpt, device="cpu",
                                         ladder=(8,)).predict_series(traffic)
        assert np.array_equal(got, want)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        router = health["router"]
        assert router["num_replicas"] == 2
        assert [r["kind"] for r in router["replicas"]] == ["process"] * 2
        assert all(r["worker"]["jit_cache"]["captures_after_warmup"] == 0
                   for r in router["replicas"])
    finally:
        proc.kill()
        proc.communicate(timeout=DEADLINE)


# ---------------------------------------------------------------------------
# Process replicas


def test_process_replica_same_interface_results_and_no_jax(pair, traffic,
                                                           tmp_path):
    """One worker subprocess behind the replica interface: bit-identical
    answers, outstanding accounting, clean shutdown, and a child that has
    loaded neither JAX nor the JAX package."""
    reference = pair[1].predict_series(traffic)
    probe = str(tmp_path / "modules.txt")
    spec = {"factory": "test_torch_router_support:build_tiny",
            "kwargs": {"ladder": [8], "params_path": pair[2]},
            "sys_path": [HERE]}
    rep = ProcessReplica(spec, name="p0", boot_timeout_s=120.0,
                         request_timeout_s=DEADLINE)
    router = None
    try:
        assert rep.window_size == W
        assert np.array_equal(rep.predict_series(traffic), reference)
        outs = rep.predict_series_many([traffic, traffic])
        assert all(np.array_equal(o, reference) for o in outs)
        assert rep.outstanding() == 0
        stats = rep.stats()
        assert stats["kind"] == "process" and stats["served_requests"] == 3
        assert stats["worker"]["jit_cache"]["captures_after_warmup"] == 0
        router = ReplicaRouter([rep])
        assert router.window_size == W
        assert np.array_equal(router.predict_series(traffic), reference)
        assert router.params_digest() == pair[1].params_digest()
    finally:
        if router is not None:
            router.close()
        rep.close()
    assert not rep.alive()

    spec = {"factory": "test_torch_router_support:build_probe",
            "kwargs": {"path": probe}, "sys_path": [HERE]}
    rep = ProcessReplica(spec, name="probe", boot_timeout_s=120.0,
                         request_timeout_s=DEADLINE)
    try:
        rep.predict_series(traffic)
    finally:
        rep.close()
    with open(probe, encoding="utf-8") as fh:
        modules = fh.read().split()
    assert "deeprest_tpu_torch.serve.replica" in modules
    bad = [m for m in modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "deeprest_tpu")]
    assert not bad, bad
