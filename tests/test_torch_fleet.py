"""The port's fleet tier (serve/fleet.py, the bound slot of serve/graphs.py,
``Predictor.share_executables_from``) against the JAX package's, on the
CPU.

The models are tests/router_test_support.py's (F=6, E=3, H=8, W=8, one
rung): JAX's stacks as they are, and the port's on the same params
(``interop.params_from_jax``, then scaled as JAX scales them), through the
plain recurrence.  The JAX pools are built with ``aot=False``.  Pooled
answers are within 1e-5 of the JAX pool's for each tenant and bit for bit
the tenant's own standalone predictor; the pool's counters equal JAX's
under one seeded access sequence; refusals carry JAX's messages.  The
bind: tenants alternated on one plane answer with their own weights on
the ladder, fused and sparse paths, and with the bind switched off they
answer with another tenant's.
"""

import dataclasses
import threading

import numpy as np
import pytest
from router_test_support import E, F, H, W
from router_test_support import build_tiny as jax_build_tiny
from test_torch_router_support import build_tiny

from deeprest_tpu.config import FleetConfig as JaxFleetConfig
from deeprest_tpu.serve.fleet import PredictorPool as JaxPool
from deeprest_tpu.serve.fleet import UnknownTenantError as JaxUnknown
from deeprest_tpu_torch import interop
from deeprest_tpu_torch.config import Config, FleetConfig, ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.ops.densify import sparsify_rows
from deeprest_tpu_torch.serve.fleet import PredictorPool, UnknownTenantError
from deeprest_tpu_torch.serve.graphs import BoundSlot
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.router import ReplicaRouter

TOL = 1e-5
SCALES = {"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0}


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The JAX stack's params, carried into the port, as an npz."""
    jpred = jax_build_tiny(ladder=(8,))
    params = {k: v.numpy() for k, v in interop.params_from_jax(
        {k: np.array(v) for k, v in jpred.params.items()}).items()}
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    np.savez(path, **params)
    return path


@pytest.fixture
def traffic():
    return np.random.default_rng(0).random((2 * W, F)).astype(np.float32)


def port(scale, path, ladder=(8,)):
    return build_tiny(scale=scale, ladder=ladder, params_path=path)


def tiny(scale, path, **kwargs):
    """A port tenant with the JAX params and serving knobs of its own."""
    from test_torch_router_support import tiny_params

    mc = ModelConfig(feature_dim=F, num_metrics=E, hidden_size=H,
                     dropout_rate=0.0)
    return Predictor(
        tiny_params(scale, path), mc,
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(1.0)),
        y_stats=MinMaxStats(min=np.zeros((E,), np.float32),
                            max=np.ones((E,), np.float32)),
        metric_names=[f"c{i}_cpu" for i in range(E)], window_size=W,
        device="cpu", **kwargs)


def raised(fn) -> str:
    with pytest.raises(Exception) as err:
        fn()
    return f"{type(err.value).__name__}: {err.value}"


# ---------------------------------------------------------------------------
# Pool mechanics: admission, sharing, the flat ledger


def test_admission_shares_graphs_flat_ledger_against_jax(params_path,
                                                         traffic):
    jpool, pool = JaxPool(hbm_budget=8, aot=False), PredictorPool(
        hbm_budget=8, aot=False)
    jpool.admit("a", jax_build_tiny(scale=1.0, ladder=(8,)))
    pool.admit("a", port(1.0, params_path))
    ref_a = pool.resolve("a").predictor().predict_series(traffic)
    after_one = pool.jit_cache_size()
    for name in ("b", "c", "d"):
        jpool.admit(name, jax_build_tiny(scale=SCALES[name], ladder=(8,)))
        pool.admit(name, port(SCALES[name], params_path))
        pool.resolve(name).predictor().predict_series(traffic)
    # graphs key by shape with weights bound per run: FLAT in tenants
    assert pool.jit_cache_size() == after_one
    for name, scale in SCALES.items():
        got = pool.resolve(name).predictor().predict_series(traffic)
        want = np.asarray(
            jpool.resolve(name).predictor().predict_series(traffic))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        # ... and bit for bit the tenant's own standalone predictor
        assert np.array_equal(
            got, port(scale, params_path).predict_series(traffic))
    assert not np.array_equal(
        ref_a, pool.resolve("b").predictor().predict_series(traffic))
    st, jst = pool.stats(), jpool.stats()
    assert st["tenants"] == jst["tenants"] == 4
    assert st["admissions"] == jst["admissions"] == 4
    # JAX's keys, plus the plane's (port-only; the plane is no tenant)
    assert set(st) - set(jst) == {"plane"} and set(jst) <= set(st)
    assert set(st["aot"]) == set(jst["aot"])
    assert st["plane"]["slot_bytes"] > 0
    assert pool.tenant_meta().keys() == jpool.tenant_meta().keys()


def test_admit_refuses_duplicates_and_mismatched_geometry(params_path):
    jpool, pool = JaxPool(hbm_budget=4, aot=False), PredictorPool(
        hbm_budget=4, aot=False)
    jpool.admit("a", jax_build_tiny(ladder=(8,)))
    pool.admit("a", port(1.0, params_path))
    want = raised(lambda: jpool.admit("a", jax_build_tiny(ladder=(8,))))
    assert raised(lambda: pool.admit("a", port(1.0, params_path))) == want
    assert "reload" in want
    # another ladder cannot share the plane's graphs: refused, not
    # silently captured as a second graph set
    want = raised(lambda: jpool.admit("other",
                                      jax_build_tiny(ladder=(4,))))
    got = raised(lambda: pool.admit("other",
                                    port(1.0, params_path, ladder=(4,))))
    assert got == want.replace("deeprest_tpu.", "deeprest_tpu_torch.")
    assert pool.tenants() == ["a"]


def test_refuses_other_backends_and_architectures(params_path):
    from deeprest_tpu.serve.predictor import Predictor as JaxPredictor

    jpred, pred = jax_build_tiny(ladder=(8,)), port(1.0, params_path)
    want = raised(lambda: JaxPredictor.share_executables_from(
        jpred, object()))
    assert raised(lambda: pred.share_executables_from(object())) == want
    assert raised(lambda: PredictorPool(aot=False).admit(
        "x", object())) == want
    other = tiny(1.0, params_path, ladder=(8,), quant="bf16")
    assert "quant modes" in raised(lambda: pred.share_executables_from(
        other))
    for knobs, words in (
            (dict(sparse_feed=True, sparse_nnz_cap=4), "sparse-feed"),
            (dict(fused=False), "fused and an unfused")):
        assert words in raised(lambda: pred.share_executables_from(
            tiny(1.0, params_path, ladder=(8,), **knobs)))


def test_unknown_tenant_raises_and_counts(params_path):
    jpool, pool = JaxPool(hbm_budget=2, aot=False), PredictorPool(
        hbm_budget=2, aot=False)
    jpool.admit("a", jax_build_tiny(ladder=(8,)))
    pool.admit("a", port(1.0, params_path))
    with pytest.raises(JaxUnknown):
        jpool.resolve("ghost")
    with pytest.raises(UnknownTenantError):
        pool.resolve("ghost")
    with pytest.raises(UnknownTenantError):
        pool.peek("ghost")
    assert pool.stats()["unknown_tenants"] == \
        jpool.stats()["unknown_tenants"] == 1


def test_spill_restore_bit_exact_no_capture(params_path, traffic):
    pool = PredictorPool(hbm_budget=1, aot=False)
    pool.admit("a", port(1.0, params_path))
    ref = pool.resolve("a").predictor().predict_series(traffic)
    pool.freeze()
    pool.admit("b", port(2.0, params_path))           # evicts a
    assert not pool.peek("a").resident
    spill = pool.peek("a")._tenant_spill             # the host tier
    assert spill and all(t.device.type == "cpu" for t in spill.values())
    assert pool.host_bytes() == sum(
        t.numel() * t.element_size() for t in spill.values())
    entry = pool.resolve("a")                         # restored
    assert entry.resident and entry._tenant_spill is None
    assert np.array_equal(ref, entry.predictor().predict_series(traffic))
    pool.assert_frozen()                              # no capture
    st = pool.stats()
    assert st["spills"] >= 1 and st["restores"] == 1
    assert len(pool.timings()["spill"]) == st["spills"]


def test_counters_equal_jax_under_one_seeded_sequence(params_path, traffic):
    names = [f"t{i}" for i in range(6)]
    jpool, pool = JaxPool(hbm_budget=2, aot=False), PredictorPool(
        hbm_budget=2, aot=False)
    for i, name in enumerate(names):
        jpool.admit(name, jax_build_tiny(scale=1.0 + 0.5 * i, ladder=(8,)))
        pool.admit(name, port(1.0 + 0.5 * i, params_path))
    rng = np.random.default_rng(23)
    for _ in range(40):
        name = names[int(rng.integers(0, len(names)))]
        got = pool.resolve(name).predictor().predict_series(traffic)
        want = jpool.resolve(name).predictor().predict_series(traffic)
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    st, jst = pool.stats(), jpool.stats()
    for key in ("tenants", "resident", "spilled", "admissions", "hits",
                "unknown_tenants", "spills", "restores", "evictions",
                "per_tenant"):
        assert st[key] == jst[key], key
    assert pool.tenant_meta(limit=3).keys() == jpool.tenant_meta(
        limit=3).keys()
    assert pool.tenant_meta(limit=3)["__other__"] == \
        jpool.tenant_meta(limit=3)["__other__"]


def test_reload_swaps_params_and_counts_invalidations(params_path, traffic):
    pool = PredictorPool(hbm_budget=2, aot=False)
    pool.admit("a", port(1.0, params_path))
    before = pool.resolve("a").predictor().predict_series(traffic)
    pool.freeze()
    pool.reload("a", port(3.0, params_path), reason="drift")
    pool.reload("a", port(4.0, params_path), reason="drift")
    pool.reload("a", port(5.0, params_path), reason="manual")
    after = pool.resolve("a").predictor().predict_series(traffic)
    assert not np.array_equal(before, after)
    assert np.array_equal(after,
                          port(5.0, params_path).predict_series(traffic))
    pool.assert_frozen()          # hot swaps never capture
    counts = pool.peek("a").invalidations()
    assert counts == {"drift": 2, "manual": 1}
    counts["drift"] = 99          # the accessor returns a COPY
    assert pool.peek("a").invalidations()["drift"] == 2
    with pytest.raises(UnknownTenantError):
        pool.reload("ghost", port(1.0, params_path))


def test_frozen_ledger_trips_on_growth(params_path, traffic):
    jpool, pool = JaxPool(hbm_budget=2, aot=False), PredictorPool(
        hbm_budget=2, aot=False)
    jpool.admit("a", jax_build_tiny(ladder=(8,)))
    pool.admit("a", port(1.0, params_path))
    jpool.freeze(), pool.freeze()
    # a fresh rung dispatch after freeze IS a post-warmup capture
    jpool.resolve("a").predictor().predict_series(traffic)
    pool.resolve("a").predictor().predict_series(traffic)
    want = raised(jpool.assert_frozen)
    assert raised(pool.assert_frozen) == want
    assert "jit cache grew post-freeze" in want


# ---------------------------------------------------------------------------
# The bind


def _ladder_answer(pred, traffic):
    return pred.predict_series(traffic)


def _sparse_answer(pred, traffic):
    cols, vals, _ = sparsify_rows(traffic, F)
    x = np.stack([traffic[:W], traffic[W:2 * W]])
    xc, xv, _ = sparsify_rows(x, F)
    return np.concatenate([
        pred.predict_series_sparse(cols, vals).reshape(-1),
        pred.apply_windows_sparse(xc, xv).reshape(-1)])


PATHS = {
    # the shape ladder's apply (no fused engine)
    "ladder": (dict(fused=False), _ladder_answer),
    # the fused engine's page program
    "fused": ({}, _ladder_answer),
    # the padded-COO programs: the fused sparse page and the ladder's
    # sparse apply
    "sparse": (dict(sparse_feed=True, sparse_nnz_cap=F), _sparse_answer),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_alternated_tenants_answer_with_their_own_weights(params_path,
                                                          traffic, path):
    knobs, answer = PATHS[path]
    want = {s: answer(tiny(s, params_path, ladder=(8,), **knobs), traffic)
            for s in (1.0, 2.0)}
    a = tiny(1.0, params_path, ladder=(8,), **knobs)
    b = tiny(2.0, params_path, ladder=(8,), **knobs)
    a_params = {k: v.clone() for k, v in a.bound_state().items()}
    b.share_executables_from(a)
    assert a.plane is b.plane and a.plane not in (a, b)
    assert a.graphs is b.graphs is a.plane.graphs
    a.warm()
    for _ in range(2):
        assert np.array_equal(answer(a, traffic), want[1.0])
        assert np.array_equal(answer(b, traffic), want[2.0])
    # no tenant's own tensors were written: the slot is the plane's copy
    for k, v in a.bound_state().items():
        assert torch_equal(v, a_params[k]), k
    assert a.jit_cache_size() == b.jit_cache_size() == \
        a.plane.jit_cache_size()


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def test_a_missed_bind_serves_another_tenants_weights(params_path, traffic,
                                                      monkeypatch):
    """The bind is what keeps tenants apart: without it a tenant served
    through the shared plane answers with whoever was bound last."""
    want_a = port(1.0, params_path).predict_series(traffic)
    want_b = port(2.0, params_path).predict_series(traffic)
    pool = PredictorPool(hbm_budget=4, aot=False)
    pool.admit("a", port(1.0, params_path))
    pool.admit("b", port(2.0, params_path))
    assert np.array_equal(
        pool.resolve("a").predictor().predict_series(traffic), want_a)
    monkeypatch.setattr(BoundSlot, "bind", lambda self, owner: None)
    wrong = pool.resolve("b").predictor().predict_series(traffic)
    assert np.array_equal(wrong, want_a)          # a's weights, not b's
    monkeypatch.undo()
    assert np.array_equal(
        pool.resolve("b").predictor().predict_series(traffic), want_b)


def test_resolved_before_its_spill_still_answers_bit_exact(params_path,
                                                           traffic):
    pool = PredictorPool(hbm_budget=1, aot=False)
    pool.admit("a", port(1.0, params_path))
    held = pool.resolve("a").predictor()           # resolved, then evicted
    ref = held.predict_series(traffic)
    pool.admit("b", port(2.0, params_path))
    pool.resolve("b").predictor().predict_series(traffic)
    assert not pool.peek("a").resident
    spill = pool.peek("a")._tenant_spill
    assert all(t.data_ptr() == spill[k].data_ptr()
               for k, t in held.bound_state().items())
    assert np.array_equal(held.predict_series(traffic), ref)
    assert pool.peek("a").restores == 0            # bound from the host


# ---------------------------------------------------------------------------
# Chaos (tests/test_fleet.py's scenarios)


def test_replica_death_mid_rolling_reload_survivors_byte_identical(
        params_path, traffic):
    """Kill a replica mid-rolling-reload with tenant traffic in flight:
    every tenant response stays byte-identical to its own model."""
    pool = PredictorPool(hbm_budget=2, aot=False)
    pool.admit("a", port(1.0, params_path))
    pool.admit("b", port(2.0, params_path))
    router = ReplicaRouter.build(port(1.0, params_path), 2)
    try:
        router.attach_fleet(pool)
        ref_a = router.predict_series(traffic, tenant="a").tobytes()
        ref_b = router.predict_series(traffic, tenant="b").tobytes()
        pool.freeze()
        bad: list = []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                if router.predict_series(traffic, tenant="a").tobytes() \
                        != ref_a:
                    bad.append("a")
                if router.predict_series(traffic, tenant="b").tobytes() \
                        != ref_b:
                    bad.append("b")

        th = threading.Thread(target=hammer, daemon=True)
        th.start()
        reloader = threading.Thread(
            target=lambda: router.rolling_reload_from(
                port(1.0, params_path), reason="manual"),
            daemon=True)
        reloader.start()
        name = router.router_stats()["replicas"][0]["name"]
        router.eject(name, reason="chaos: killed mid-reload")
        reloader.join(timeout=60)
        stop.set()
        th.join(timeout=60)
        assert not bad, f"tenant responses diverged: {bad}"
        assert not reloader.is_alive()
        pool.assert_frozen()
        stats = router.router_stats()
        assert any(r["health"]["ejections"] >= 1
                   for r in stats["replicas"])
    finally:
        router.close()


def test_eviction_under_live_load_restores_without_capture(params_path,
                                                           traffic):
    """hbm_budget=1 with two tenants hammered concurrently: every access
    of one evicts the other, every response stays byte-identical, and no
    restore ever captures or touches disk (there is no checkpoint)."""
    pool = PredictorPool(hbm_budget=1, aot=False)
    pool.admit("a", port(1.0, params_path))
    ref = {"a": pool.resolve("a").predictor().predict_series(traffic)}
    pool.freeze()
    pool.admit("b", port(2.0, params_path))
    ref["b"] = pool.resolve("b").predictor().predict_series(traffic)
    bad: list = []

    def churn(tenant):
        for _ in range(12):
            got = pool.resolve(tenant).predictor().predict_series(traffic)
            if not np.array_equal(got, ref[tenant]):
                bad.append(tenant)

    threads = [threading.Thread(target=churn, args=(t,))
               for t in ("a", "b", "a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, f"eviction churn corrupted tenants: {bad}"
    pool.assert_frozen()
    st = pool.stats()
    assert st["spills"] > 0 and st["restores"] > 0
    assert st["resident"] == 1          # the budget held


def test_router_refuses_a_fleet_on_process_replicas():
    """JAX's message, checked on a replica that has no in-process backend
    (the process replica's shape) without spawning a worker."""
    from deeprest_tpu.serve.router import ReplicaRouter as JaxRouter

    class Remote:
        name, kind, device = "p0", "process", None
        alive = True

    want = raised(lambda: JaxRouter.attach_fleet(
        _router_shell(JaxRouter, [Remote()]), JaxPool(aot=False)))
    got = raised(lambda: ReplicaRouter.attach_fleet(
        _router_shell(ReplicaRouter, [Remote()]), PredictorPool(aot=False)))
    assert got == want and "fleet" in got


def _router_shell(cls, replicas):
    """A router's registry with no replica behind it (attach_fleet reads
    the registry and the lock only)."""
    shell = object.__new__(cls)
    shell._lock = threading.Lock()
    shell._replicas = list(replicas)
    shell._fleet = None
    return shell


# ---------------------------------------------------------------------------
# FleetConfig (config.py)


def test_fleet_config_defaults_and_validation_equal_jax():
    cfg = FleetConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxFleetConfig())
    assert (cfg.enabled, cfg.hbm_budget, cfg.aot,
            cfg.top_k_tenants, cfg.quality) == (False, 4, True, 8, True)
    for kwargs in (dict(hbm_budget=0), dict(top_k_tenants=-1),
                   dict(hbm_budget=True)):
        assert raised(lambda: FleetConfig(**kwargs)) == raised(
            lambda: JaxFleetConfig(**kwargs))


def test_fleet_config_round_trip():
    cfg = FleetConfig(enabled=True, hbm_budget=2, aot=False)
    assert FleetConfig(**dataclasses.asdict(cfg)) == cfg
    assert Config().fleet == FleetConfig()
    from deeprest_tpu.config import Config as JaxConfig

    jcfg = JaxConfig.from_dict({"fleet": dataclasses.asdict(cfg)})
    assert FleetConfig(**dataclasses.asdict(jcfg.fleet)) == cfg
