"""The port's fleet tier over HTTP and on the CLI, against the JAX
package's, on the CPU: ``X-Tenant`` on ``/v1/predict`` and
``/v1/verdict`` (404 for an unknown tenant, 503 without per-tenant
quality), the ``/healthz`` ``fleet`` views with and without a pool, the
``/metrics`` series and the per-tenant quality rollup bounded to top-K plus
``__other__``; the ``serve --fleet`` flags, exits and startup line, and
``export --aot`` with a pool checking its sidecar (a stale fingerprint
falls back whole, naming the keys).

The models are tests/router_test_support.py's tiny stacks on JAX's params,
on the CPU.  Every server is stopped in a ``finally``; the ``serve``
subprocess is killed in one.
"""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
from router_test_support import F, W
from router_test_support import build_tiny as jax_build_tiny
from test_torch_router_support import build_tiny, write_checkpoint

from deeprest_tpu.serve.fleet import PredictorPool as JaxPool
from deeprest_tpu_torch import interop
from deeprest_tpu_torch.config import QualityConfig
from deeprest_tpu_torch.serve.fleet import PredictorPool
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import (
    PredictionServer, PredictionService, ServingError,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60.0
FLEET_FLAGS = ("--fleet", "--fleet-hbm-budget", "--no-fleet-aot",
               "--fleet-top-k", "--no-fleet-quality")


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    jpred = jax_build_tiny(ladder=(8,))
    params = {k: v.numpy() for k, v in interop.params_from_jax(
        {k: np.array(v) for k, v in jpred.params.items()}).items()}
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    np.savez(path, **params)
    return path


@pytest.fixture
def traffic():
    return np.random.default_rng(0).random((2 * W, F)).astype(np.float32)


def port(scale, path):
    return build_tiny(scale=scale, ladder=(8,), params_path=path)


@pytest.fixture(scope="module")
def fleet_server(params_path):
    base_pred = port(1.0, params_path)
    pool = PredictorPool(hbm_budget=4, aot=False,
                         quality_config=QualityConfig(enabled=True),
                         top_k_tenants=2)
    pool.admit("default", base_pred)
    pool.admit("blue", port(2.0, params_path))
    pool.admit("green", port(3.0, params_path))
    pool.admit("violet", port(4.0, params_path))
    service = PredictionService(base_pred, backend="fleet-test")
    service.attach_fleet(pool)
    server = PredictionServer(service, port=0).start()
    host, port_ = server.address
    try:
        yield {"base": f"http://{host}:{port_}", "pool": pool,
               "service": service}
    finally:
        server.stop()


def _get(url, tenant=None):
    headers = {"X-Tenant": tenant} if tenant else {}
    with urllib.request.urlopen(
            urllib.request.Request(url, headers=headers),
            timeout=DEADLINE) as r:
        return json.loads(r.read())


def _post(url, payload, tenant=None):
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=DEADLINE) as r:
        return json.loads(r.read())


def test_predict_header_selects_the_model(fleet_server, params_path,
                                          traffic):
    base, pool = fleet_server["base"], fleet_server["pool"]
    payload = {"traffic": traffic.tolist()}
    body_default = _post(base + "/v1/predict", payload)
    body_blue = _post(base + "/v1/predict", payload, tenant="blue")
    assert body_default["tenant"]["name"] == "default"
    assert body_blue["tenant"]["name"] == "blue"
    np.testing.assert_array_equal(
        np.asarray(body_blue["predictions"], np.float32),
        port(2.0, params_path).predict_series(traffic))
    np.testing.assert_array_equal(
        np.asarray(body_default["predictions"], np.float32),
        port(1.0, params_path).predict_series(traffic))
    assert (body_blue["tenant"]["params_digest"]
            == pool.peek("blue").key[1])


def test_predict_unknown_tenant_is_404(fleet_server, traffic):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(fleet_server["base"] + "/v1/predict",
              {"traffic": traffic.tolist()}, tenant="ghost")
    assert err.value.code == 404
    assert json.loads(err.value.read())["error"] == (
        "unknown tenant 'ghost': not admitted to the fleet pool")


def test_verdict_honors_tenant_header(fleet_server):
    base = fleet_server["base"]
    body = _get(base + "/v1/verdict", tenant="blue")
    assert body["tenant"]["name"] == "blue"
    assert body["tenant"]["invalidations"] == {}
    assert "metrics" in body and "states" in body
    assert _get(base + "/v1/verdict")["tenant"]["name"] == "default"
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/v1/verdict", tenant="ghost")
    assert err.value.code == 404


def test_verdict_503_when_pool_has_no_quality(params_path):
    from deeprest_tpu.serve import PredictionService as JaxService
    from deeprest_tpu.serve.server import ServingError as JaxServingError

    messages = []
    for Pool, Service, Error, pred in (
            (JaxPool, JaxService, JaxServingError,
             jax_build_tiny(ladder=(8,))),
            (PredictorPool, PredictionService, ServingError,
             port(1.0, params_path))):
        pool = Pool(hbm_budget=2, aot=False)      # quality off
        pool.admit("default", pred)
        service = Service(pred, backend="no-quality")
        try:
            service.attach_fleet(pool)
            with pytest.raises(Error) as err:
                service.verdict("default")
            assert err.value.status == 503
            messages.append(str(err.value))
        finally:
            service.close()
    assert messages[0] == messages[1] and "quality" in messages[1]


def test_healthz_fleet_view_with_pool(fleet_server):
    body = _get(fleet_server["base"] + "/healthz")
    fleet = body["fleet"]
    assert fleet["pool"]["hbm_budget"] == 4
    assert fleet["pool"]["tenants"] == 4
    tenants = fleet["tenants"]
    named = {k: v for k, v in tenants.items() if k != "__other__"}
    assert len(named) == 2                      # top_k_tenants=2
    assert tenants["__other__"]["tenants"] == 2
    for meta in named.values():
        assert set(meta) == {"quant", "params_digest", "resident"}
        assert meta["quant"] == "off" and meta["params_digest"]
    jpool = JaxPool(aot=False)
    jpool.admit("a", jax_build_tiny(ladder=(8,)))
    assert set(fleet["pool"]) == set(jpool.stats()) | {"plane"}
    assert body["quant"]["mode"] == "off" and body["ok"] is True


def test_healthz_fleet_view_without_pool(params_path):
    pred = port(1.0, params_path)
    service = PredictionService(pred, backend="solo")
    try:
        out = service.healthz()
    finally:
        service.close()
    assert out["fleet"] == {"tenants": {"default": {
        "quant": "off", "params_digest": pred.params_digest(),
        "resident": True}}, "pool": None}


def test_metrics_per_tenant_rollup_bounded(fleet_server, traffic):
    base = fleet_server["base"]
    # the "serving" collector is replace-by-name (newest plane owns
    # /metrics): re-assert this module's plane before reading it
    from deeprest_tpu_torch.obs import metrics as obs_metrics

    svc = fleet_server["service"]
    obs_metrics.REGISTRY.register_collector("serving",
                                            svc._collect_metrics)
    _post(base + "/v1/predict", {"traffic": traffic.tolist()},
          tenant="blue")
    with urllib.request.urlopen(base + "/metrics", timeout=DEADLINE) as r:
        text = r.read().decode()
    assert "deeprest_fleet_tenants 4" in text
    for name in ("deeprest_fleet_resident_tenants",
                 "deeprest_fleet_spills_total",
                 "deeprest_fleet_restores_total",
                 "deeprest_fleet_aot_loaded_total",
                 "deeprest_fleet_compile_fallbacks_total"):
        assert name in text, name
    assert 'deeprest_quality_tenant_sweeps_total{tenant="blue"}' in text
    assert 'tenant="__other__"' in text
    named = {line.split('tenant="')[1].split('"')[0]
             for line in text.splitlines()
             if line.startswith("deeprest_quality_tenant_verdict{")}
    assert len(named) <= 3                      # 2 named + __other__


# ---------------------------------------------------------------------------
# The CLI: serve --fleet, export --aot


def _serve_actions(parser) -> dict:
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {opt: a for a in sub.choices["serve"]._actions
            for opt in a.option_strings}


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value.code)


def test_serve_parsers_agree_on_fleet_flags():
    from deeprest_tpu.cli import build_parser as jax_parser
    from deeprest_tpu_torch.cli import build_parser

    got, want = _serve_actions(build_parser()), _serve_actions(jax_parser())
    for flag in FLEET_FLAGS:
        g, w = got[flag], want[flag]
        assert (g.dest, g.default, g.type, g.nargs, g.const) == \
            (w.dest, w.default, w.type, w.nargs, w.const), flag


@pytest.mark.parametrize("argv", [
    ["--artifact", "A", "--fleet", "x=y"],
    ["--ckpt-dir", "C", "--fleet", "x=y", "--replicas", "2",
     "--replica-mode", "process"],
    ["--ckpt-dir", "C", "--fleet", "x=y", "--fleet-hbm-budget", "0"],
])
def test_serve_fleet_exits_equal_jax(argv, monkeypatch):
    """JAX checks these after it builds its backend (here stubbed); the
    port checks them before it loads anything."""
    from deeprest_tpu import cli as jax_cli
    from deeprest_tpu.serve.export import ExportedPredictor
    from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
    from deeprest_tpu.serve.router import ReplicaRouter as JaxRouter
    from deeprest_tpu_torch import cli as port_cli

    stub = jax_build_tiny(ladder=(8,))
    monkeypatch.setattr(JaxPredictor, "from_checkpoint",
                        classmethod(lambda cls, *a, **k: stub))
    monkeypatch.setattr(ExportedPredictor, "load",
                        classmethod(lambda cls, *a, **k: stub))
    monkeypatch.setattr(JaxRouter, "build_process",
                        classmethod(lambda cls, *a, **k: stub))
    want = _exit_message(jax_cli.main, ["serve", *argv])
    got = _exit_message(port_cli.main, ["serve", *argv, "--device", "cpu"])
    assert got == want and got.startswith("error: ")


def test_export_aot_sidecar_and_pool_admission(params_path, tmp_path,
                                               capsys):
    from deeprest_tpu_torch import cli as port_cli
    from deeprest_tpu_torch.serve.aot import MANIFEST_NAME, planned_graphs

    ckpt = write_checkpoint(tmp_path / "ckpt", params_path)
    assert port_cli.main(["export", "--ckpt-dir", ckpt, "--out",
                          str(tmp_path / "art"), "--aot", "--device",
                          "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    man = os.path.join(ckpt, "aot", MANIFEST_NAME)
    assert out["aot"]["dir"] == os.path.dirname(man) and os.path.exists(man)
    assert out["aot"]["executables"] == 0 and out["aot"]["bytes"] == 0
    with open(man, encoding="utf-8") as f:
        manifest = json.load(f)
    fp = manifest["fingerprint"]
    assert fp["device"] == "cpu" and fp["torch"] and fp["kernels"]
    assert set(fp["kernels"]) == {"gru_fwd", "gru_bwd", "gru_fwd_blocked"}

    def admit(**kwargs):
        pool = PredictorPool(hbm_budget=2, aot=True)
        pred = Predictor.from_checkpoint(ckpt, device="cpu", **kwargs)
        pool.admit("a", pred, checkpoint_path=ckpt)
        return pool, pred

    pool, pred = admit()
    st = pool.stats()["aot"]
    # nothing is labelled loaded that was not: the manifest is verified
    # and every planned graph is a capture
    assert st["loaded"] == 0 and st["bytes"] == 0
    assert st["compile_fallbacks"] == len(planned_graphs(pred)) == \
        out["aot"]["graphs"]
    assert st["last_reason"].startswith("manifest verified")
    pred.warm()                  # the plan is what warm() dispatches
    assert pred.jit_cache_size() == st["compile_fallbacks"]
    # a different ladder: a different fingerprint, never partly trusted
    pool, _ = admit(ladder=(4,))
    st = pool.stats()["aot"]
    assert st["loaded"] == 0 and "rungs" in st["last_reason"]
    assert st["last_reason"] == \
        "fingerprint mismatch: ['ladder', 'rungs']"
    # a stale torch and kernel digest: named, whole load falls back
    fp["torch"] = "0.0"
    fp["kernels"]["gru_fwd"] = "libgru_fwd-000000000000.so"
    with open(man, "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    pool, _ = admit()
    assert pool.stats()["aot"]["last_reason"] == \
        "fingerprint mismatch: ['kernels', 'torch']"
    with open(man, "w", encoding="utf-8") as f:
        f.write("{not json")
    pool, _ = admit()
    assert pool.stats()["aot"]["last_reason"].startswith(
        "unreadable manifest")
    pool = PredictorPool(hbm_budget=2, aot=True)
    pool.admit("a", Predictor.from_checkpoint(ckpt, device="cpu"),
               checkpoint_path=str(tmp_path / "none"))
    assert pool.stats()["aot"]["last_reason"] == "no artifacts"


def test_serve_cli_fleet_startup_and_tenants(params_path, tmp_path,
                                             traffic):
    """``serve --fleet blue=… --fleet green=… --device cpu`` in its own
    process: the startup line's ``fleet`` keys equal JAX's, ``X-Tenant``
    selects the model, an unknown tenant is a 404, ``/healthz`` has the
    pool's view and ``/metrics`` the fleet series; killed in a
    ``finally``."""
    ckpts = {name: write_checkpoint(tmp_path / name, params_path,
                                    scale=scale)
             for name, scale in (("default", 1.0), ("blue", 2.0),
                                 ("green", 3.0))}
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         ckpts["default"], "--fleet", f"blue={ckpts['blue']}", "--fleet",
         f"green={ckpts['green']}", "--fleet-hbm-budget", "2", "--device",
         "cpu", "--port", "0", "--deadline", "60", "--batch-ladder", "8",
         "--batch-max-windows", "8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        start = json.loads(proc.stdout.readline())
        jpool = JaxPool(aot=False)
        assert set(start["fleet"]) == {"tenants", "hbm_budget", "aot"}
        assert set(start["fleet"]["aot"]) == set(jpool.stats()["aot"])
        assert start["fleet"]["tenants"] == ["default", "blue", "green"]
        assert start["fleet"]["hbm_budget"] == 2
        assert start["fleet"]["aot"]["last_reason"] == "no artifacts"
        host, port_ = start["listening"][len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port_),
                                          timeout=DEADLINE)

        def post(tenant):
            headers = {"X-Tenant": tenant} if tenant else {}
            conn.request("POST", "/v1/predict",
                         json.dumps({"traffic": traffic.tolist()}),
                         headers=headers)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        for tenant in ("green", "blue", None, "green"):
            status, body = post(tenant)
            assert status == 200
            want = Predictor.from_checkpoint(
                ckpts[tenant or "default"], device="cpu",
                ladder=(8,)).predict_series(traffic)
            assert np.array_equal(
                np.asarray(body["predictions"], np.float32), want)
            assert body["tenant"]["name"] == (tenant or "default")
        assert post("ghost")[0] == 404
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        pool = health["fleet"]["pool"]
        assert pool["tenants"] == 3 and pool["resident"] == 2
        assert pool["spills"] >= 1 and pool["restores"] >= 1
        assert health["jit_cache"]["captures_after_warmup"] == 0
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert "deeprest_fleet_tenants 3" in text
        conn.close()
    finally:
        proc.kill()
        proc.communicate(timeout=DEADLINE)


def test_fleet_stats_keys_equal_jax(params_path):
    """The pool's ``stats()`` and ``per_tenant`` keys and the
    ``quality_rollup`` row keys are JAX's (plus the port's ``plane``)."""
    from deeprest_tpu.config import QualityConfig as JaxQualityConfig

    jpool = JaxPool(aot=False, top_k_tenants=1,
                    quality_config=JaxQualityConfig(enabled=True))
    pool = PredictorPool(aot=False, top_k_tenants=1,
                         quality_config=QualityConfig(enabled=True))
    for i, name in enumerate(("a", "b")):
        jpool.admit(name, jax_build_tiny(scale=1.0 + i, ladder=(8,)))
        pool.admit(name, port(1.0 + i, params_path))
    st, jst = pool.stats(), jpool.stats()
    assert set(st) == set(jst) | {"plane"}
    assert set(st["per_tenant"]["a"]) == set(jst["per_tenant"]["a"])
    assert dataclasses.is_dataclass(QualityConfig)
    rows, jrows = pool.quality_rollup(), jpool.quality_rollup()
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert [set(r[1]) for r in rows] == [set(r[1]) for r in jrows]
