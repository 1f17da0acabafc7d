"""Chaos on the port's replica plane (the router half of
tests/test_chaos.py, on serve/router.py and serve/replica.py of the port):
retry on a survivor after a worker dies, no retry of a request that may
still be executing, a fast 503 once the retry budget is spent or every
replica is ejected, ejection after consecutive failures with a probe that
restarts the replica, a deadline that turns a wedged worker into a typed
error, and SIGKILL of a real worker mid-request, retried on a survivor
bit for bit and rejoined.  Each scenario runs against the JAX router too
where the fake replicas allow it, and the outcomes are compared.

The worker subprocesses build the tiny port model of
tests/test_torch_router_support.py (no JAX in the child); every router
and worker is closed in a ``finally`` and every wait has a deadline.
"""

import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
from test_torch_router_support import W, build_tiny

from deeprest_tpu.serve.replica import ReplicaDeadError as JaxDeadError
from deeprest_tpu.serve.router import ReplicaRouter as JaxRouter
from deeprest_tpu.serve.router import RouterConfig as JaxRouterConfig
from deeprest_tpu.serve.server import ServingError as JaxServingError
from deeprest_tpu_torch.serve.replica import ProcessReplica, ReplicaDeadError
from deeprest_tpu_torch.serve.router import ReplicaRouter, RouterConfig
from deeprest_tpu_torch.serve.server import ServingError

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE = 30.0

PORT = (ReplicaRouter, RouterConfig, ReplicaDeadError, ServingError)
JAX = (JaxRouter, JaxRouterConfig, JaxDeadError, JaxServingError)


class _FakeReplica:
    """A replica-protocol stub that fails on demand: the fast,
    deterministic half of the chaos matrix."""

    kind = "thread"

    def __init__(self, dead_error, name, fail_times=0, retriable=True,
                 alive=True, result="ok"):
        self.dead_error = dead_error
        self.name = name
        self.device = None
        self.fail_times = fail_times
        self.retriable = retriable
        self.alive_flag = alive
        self.result = result
        self.calls = 0
        self.restarts = 0
        self._meta = {
            "metric_names": ["m0"], "window_size": W, "feature_dim": 6,
            "quantiles": [0.05, 0.5, 0.95], "median_index": 1,
            "delta_mask": None,
        }

    def outstanding(self):
        return 0

    def available(self):
        return True

    def alive(self):
        return self.alive_flag

    def served_requests(self):
        return self.calls

    def served_windows(self):
        return self.calls

    def predict_series(self, traffic, integrate=True):
        self.calls += 1
        if self.fail_times > 0:
            self.fail_times -= 1
            raise self.dead_error(f"{self.name} down", replica=self.name,
                                  retriable=self.retriable)
        return self.result

    def predict_series_many(self, series_list, integrate=True):
        return [self.predict_series(s, integrate) for s in series_list]

    def drain(self):
        pass

    def resume(self):
        pass

    def wait_idle(self, timeout_s=0):
        return True

    def close(self):
        pass

    def stats(self):
        return {"name": self.name, "kind": self.kind,
                "outstanding_windows": 0,
                "served_requests": self.calls, "served_windows": 0,
                "state": "live"}


class _FakeProcessReplica(_FakeReplica):
    kind = "process"

    def restart(self):
        self.restarts += 1
        self.fail_times = 0
        self.alive_flag = True


def _router(pkg, replicas, **cfg):
    router_cls, config_cls = pkg[0], pkg[1]
    cfg.setdefault("probe_interval_s", 30.0)   # probe parked off-stage
    return router_cls(list(replicas), config=config_cls(**cfg))


def _wait(cond, what, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def retry_on_survivor(pkg):
    dead = _FakeReplica(pkg[2], "r0", fail_times=5, retriable=True,
                        alive=False)
    good = _FakeReplica(pkg[2], "r1", result="good")
    router = _router(pkg, [dead, good], retry_budget=1,
                     eject_after_failures=3)
    try:
        outs = {router.predict_series(np.zeros((W, 6))) for _ in range(4)}
        stats = router.router_stats()
        calls_before = dead.calls
        router.predict_series(np.zeros((W, 6)))
        by_name = {r["name"]: r["health"] for r in stats["replicas"]}
        return (outs, by_name["r0"]["ejected"], stats["health"],
                dead.calls == calls_before)
    finally:
        router.close()


def non_retriable_is_503(pkg):
    wedged = _FakeReplica(pkg[2], "r0", fail_times=1, retriable=False,
                          alive=True)
    bystander = _FakeReplica(pkg[2], "r1")
    router = _router(pkg, [wedged, bystander], retry_budget=3,
                     eject_after_failures=1)
    try:
        router.eject("r1")      # the wedged replica is the first pick
        with pytest.raises(pkg[3]) as exc:
            router.predict_series(np.zeros((W, 6)))
        return (exc.value.status, "double-execution" in str(exc.value),
                bystander.calls)
    finally:
        router.close()


def budget_exhausted_is_fast_503(pkg):
    all_dead = [_FakeReplica(pkg[2], f"r{i}", fail_times=10,
                             retriable=True, alive=False) for i in range(3)]
    router = _router(pkg, all_dead, retry_budget=1, eject_after_failures=1)
    try:
        t0 = time.monotonic()
        with pytest.raises(pkg[3]) as exc:
            router.predict_series(np.zeros((W, 6)))
        fast = time.monotonic() - t0 < 2.0
        return exc.value.status, str(exc.value), fast, sum(
            r.calls for r in all_dead)
    finally:
        router.close()


def all_ejected_sheds_until_rejoin(pkg):
    r = _FakeReplica(pkg[2], "r0", result="back")
    router = _router(pkg, [r], eject_after_failures=1, probe_interval_s=0.3)
    try:
        router.eject("r0", reason="chaos schedule")
        t0 = time.monotonic()
        with pytest.raises(pkg[3]) as exc:
            router.predict_series(np.zeros((W, 6)))
        shed = (exc.value.status, str(exc.value),
                time.monotonic() - t0 < 2.0)
        _wait(lambda: not router.router_stats()["replicas"][0]["health"][
            "ejected"], "probe never rejoined")
        return shed, router.predict_series(np.zeros((W, 6))), \
            router.router_stats()["health"]
    finally:
        router.close()


def threshold_ejects_and_probe_restarts(pkg):
    flaky = _FakeProcessReplica(pkg[2], "p0", fail_times=2, retriable=True,
                                alive=True)
    good = _FakeReplica(pkg[2], "r1", result="ok")
    router = _router(pkg, [flaky, good], retry_budget=1,
                     eject_after_failures=2, probe_interval_s=0.05)
    try:
        outs = [router.predict_series(np.zeros((W, 6))) for _ in range(6)]
        _wait(lambda: flaky.restarts > 0, "probe never restarted p0")
        _wait(lambda: not router.router_stats()["replicas"][0]["health"][
            "ejected"], "p0 never rejoined")
        return outs, router.router_stats()["health"]
    finally:
        router.close()


@pytest.mark.parametrize("scenario", [
    retry_on_survivor, non_retriable_is_503, budget_exhausted_is_fast_503,
    all_ejected_sheds_until_rejoin, threshold_ejects_and_probe_restarts,
], ids=lambda f: f.__name__)
def test_router_chaos_equals_jax(scenario):
    """Each scenario's outcome (answers, statuses, messages, health totals,
    calls made) on the port's router equals the JAX router's."""
    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    if scenario is retry_on_survivor:
        outs, ejected, health, untouched = got
        assert outs == {"good"} and ejected and untouched
        assert health["ejections"] == 1 and health["retries"] >= 1
    elif scenario is non_retriable_is_503:
        assert got == (503, True, 0)
    elif scenario is budget_exhausted_is_fast_503:
        assert got[0] == 503 and got[2] and got[3] == 2
    elif scenario is all_ejected_sheds_until_rejoin:
        assert got[0][0] == 503 and got[0][2] and got[1] == "back"
        assert got[2]["rejoins"] == 1
    else:
        assert got[0] == ["ok"] * 6 and got[1]["rejoins"] == 1


# ---------------------------------------------------------------------------
# real worker subprocesses: deadline, SIGKILL mid-request, rejoin


def _proc_spec(delay_s=0.0):
    if not delay_s:
        return {"factory": "test_torch_router_support:build_tiny",
                "kwargs": {"ladder": [8]}, "sys_path": [HERE]}
    return {"factory": "test_torch_router_support:build_slow",
            "kwargs": {"delay_s": delay_s, "ladder": [8]},
            "sys_path": [HERE]}


def test_process_replica_deadline_turns_wedge_into_typed_error():
    """A worker that outlives the per-request deadline while staying ALIVE
    surfaces ReplicaDeadError(retriable=False)."""
    traffic = np.random.default_rng(0).random((W, 6)).astype(np.float32)
    rep = ProcessReplica(_proc_spec(delay_s=5.0), name="p0",
                         boot_timeout_s=120.0, request_timeout_s=1.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(ReplicaDeadError) as exc:
            rep.predict_series(traffic)
        assert time.monotonic() - t0 < 10.0
        assert exc.value.retriable is False
        assert "alive" in str(exc.value)
        assert rep.alive()
        assert rep.outstanding() == 0
    finally:
        rep.close()
    assert not rep.alive()


def test_sigkill_mid_request_retries_on_survivor_and_rejoins():
    """SIGKILL one real worker mid-request: the in-flight request is
    re-dispatched onto the survivor and answers bit for bit; the victim
    ejects, the probe reboots it, it serves again, and nothing leaks."""
    traffic = np.random.default_rng(0).random((2 * W, 6)).astype(
        np.float32)
    reference = build_tiny(ladder=(8,)).predict_series(traffic)
    baseline_children = len(multiprocessing.active_children())
    router = ReplicaRouter.build_process(   # two workers booted at once
        _proc_spec(delay_s=1.5), 2,
        config=RouterConfig(retry_budget=1, eject_after_failures=1,
                            probe_interval_s=0.2, replica_timeout_s=20.0))
    reps = router.replicas
    try:
        result = {}

        def client():
            result["out"] = router.predict_series(traffic)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        victim = []
        _wait(lambda: victim.extend(r for r in reps if r.outstanding() > 0)
              or victim, "request never dispatched", timeout=DEADLINE)
        victim = victim[0]
        os.kill(victim.pid(), signal.SIGKILL)
        t.join(timeout=60.0)
        assert not t.is_alive(), "request hung past every deadline"
        assert np.array_equal(result["out"], reference)

        def rejoined():
            stats = router.router_stats()
            h = {r["name"]: r["health"] for r in stats["replicas"]}
            return not h[victim.name]["ejected"] and victim.alive()

        _wait(rejoined, "victim never rejoined", timeout=120.0)
        health = router.router_stats()["health"]
        assert health["ejections"] >= 1 and health["retries"] >= 1
        assert health["rejoins"] >= 1
        assert np.array_equal(router.predict_series(traffic), reference)
    finally:
        router.close()
    assert not any(rep.alive() for rep in reps)
    _wait(lambda: len(multiprocessing.active_children())
          <= baseline_children, "leaked worker subprocesses", timeout=10.0)
