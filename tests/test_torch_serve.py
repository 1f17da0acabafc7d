"""The port's serving plane against the JAX package's, on the CPU: the same
payloads through both ``PredictionService``s (transport-free), one HTTP
round trip through ``PredictionServer``, the ``serve`` CLI, a ``--watch``
hot reload, and ``params_digest``.

The checkpoint is written by the JAX ``Trainer`` over a simulated
social-network corpus cut to three components (tests/test_torch_whatif.py);
both services batch through a MicroBatcher and carry the capacity-surface
plane.  Answers agree within 1e-5 relative (1e-5 absolute near 0), the
tolerance of tests/test_torch_predictor.py; error statuses and messages
are equal.  Every server, service and batcher started here is closed in a
``finally`` or a fixture, and every client call has a timeout.
"""

import json
import os
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_whatif import (
    W, assert_json_close, simulated_corpus, write_checkpoint,
)

from deeprest_tpu.config import SurfaceConfig as JaxSurfaceConfig
from deeprest_tpu.data.featurize import featurize_buckets as jax_featurize
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.serve.batcher import BatcherConfig as JaxBatcherConfig
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu.serve.server import ServingError as JaxServingError
from deeprest_tpu_torch.config import SurfaceConfig
from deeprest_tpu_torch.data.schema import load_raw_data
from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
from deeprest_tpu_torch.serve.batcher import BatcherConfig
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import (
    CheckpointReloader, PredictionServer, PredictionService, ServingError,
)
from deeprest_tpu_torch.train.checkpoint import (
    load_params, load_sidecar, save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURFACE = dict(enabled=True, grid=(0.5, 1.0, 2.0), max_axes=2, jitter=2,
               warm_async=False)
TIMEOUT = 60


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    raw = d / "raw.jsonl"
    buckets = simulated_corpus(raw, buckets=40)
    ckpt = write_checkpoint(d / "ckpt", buckets)
    jax_pred = JaxPredictor.from_checkpoint(ckpt)
    port = Predictor.from_checkpoint(ckpt, device="cpu")
    data = jax_featurize(buckets, space=jax_pred.space())
    jax_svc = JaxService(jax_pred, JaxSynth(jax_pred.space()).fit(buckets),
                         backend="jax", batching=JaxBatcherConfig(),
                         surface=JaxSurfaceConfig(**SURFACE))
    svc = PredictionService(
        port, TraceSynthesizer(port.space()).fit(load_raw_data(str(raw))),
        backend="port", batching=BatcherConfig(),
        surface=SurfaceConfig(**SURFACE))
    try:
        yield dict(ckpt=ckpt, raw=str(raw), jax=jax_svc, port=svc,
                   traffic=data.traffic, observed=data.targets(),
                   endpoints=svc.whatif.endpoints)
    finally:
        svc.close()
        jax_svc.close()


def mix_program(endpoints, ticks, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    base = {ep: int(rng.integers(1, 20)) for ep in endpoints[:4]}
    return [{ep: int(round(n * scale)) for ep, n in base.items()}] * ticks


def payloads(s):
    eps, traffic = s["endpoints"], s["traffic"]
    prog = mix_program(eps, 2 * W + 3)
    return {
        "predict": {"traffic": traffic[:3 * W + 5].tolist()},
        # 70 windows: past the ladder's top rung, so the fused engine
        "predict_long": {"traffic": np.tile(traffic, (21, 1))[:70 * W]
                         .tolist()},
        "whatif_estimate": {"expected_traffic": prog, "seed": 1},
        "whatif_scaling": {"baseline_traffic": prog,
                           "hypothetical_traffic": mix_program(
                               eps, 2 * W + 3, scale=2.0), "seed": 2},
        "whatif_surface": {"base_traffic": prog, "factor": 2, "wait": True},
        "whatif_surface_scales": {"base_traffic": prog, "wait": True,
                                  "scales": {eps[0]: 1.5, eps[1]: 0.75}},
        "anomaly": {"traffic": traffic.tolist(),
                    "observed": s["observed"].tolist(), "tolerance": 0.05,
                    "min_run": 2},
    }


def call(svc, route, payload):
    method = route.replace("_long", "").replace("_scales", "")
    return getattr(svc, method)(payload)


@pytest.mark.parametrize("route", ["predict", "predict_long",
                                   "whatif_estimate", "whatif_scaling",
                                   "whatif_surface", "whatif_surface_scales",
                                   "anomaly"])
def test_service_payloads_match_jax(setup, route):
    payload = payloads(setup)[route]
    want = call(setup["jax"], route, payload)
    got = call(setup["port"], route, payload)
    assert_json_close(got, want)


def test_meta_and_whatif_surface_hit_match_jax(setup):
    assert setup["port"].meta() | {"backend": "jax"} == setup["jax"].meta()
    s = payloads(setup)
    for svc in (setup["jax"], setup["port"]):
        call(svc, "whatif_surface", s["whatif_surface"])   # resident now
    scaled = {"expected_traffic": mix_program(setup["endpoints"], 2 * W + 3,
                                              scale=2.0), "seed": 0}
    got = setup["port"].whatif_estimate(scaled)
    want = setup["jax"].whatif_estimate(scaled)
    assert got["surface"]["hit"] and want["surface"]["hit"]
    assert_json_close(got, want)


def errors(svc, s):
    traffic = s["traffic"]
    eps = s["endpoints"]
    bad = [
        ("predict", {"traffic": traffic[:, :-1].tolist()}),
        ("predict", {"traffic": traffic[:W - 1].tolist()}),
        ("predict", {"traffic": [1.0, 2.0]}),
        ("predict", {}),
        ("whatif_estimate", {"expected_traffic": [{"nope": 1}] * W}),
        ("whatif_estimate", {"expected_traffic": [{eps[0]: 1}] * (W - 1)}),
        ("whatif_scaling", {"baseline_traffic": [{eps[0]: 1}] * W,
                            "hypothetical_traffic": "x"}),
        ("whatif_surface", {"base_traffic": [{eps[0]: 1}] * W,
                            "scales": {"nope": 2.0}, "wait": True}),
        ("whatif_surface", {"base_traffic": [{eps[0]: 1}] * W}),
        ("anomaly", {"traffic": traffic.tolist(),
                     "observed": s["observed"][:-1].tolist()}),
        ("anomaly", {"traffic": traffic.tolist(),
                     "observed": s["observed"][:, :-1].tolist()}),
        ("anomaly", {"traffic": traffic.tolist(),
                     "observed": s["observed"].tolist(), "tolerance": "x"}),
    ]
    out = []
    for route, payload in bad:
        try:
            getattr(svc, route)(payload)
        except (ServingError, JaxServingError) as e:
            out.append((route, e.status, str(e)))
        else:
            out.append((route, 200, None))
    return out


def test_error_statuses_and_messages_match_jax(setup):
    got = errors(setup["port"], setup)
    want = errors(setup["jax"], setup)
    assert got == want
    assert all(status == 400 for _, status, _ in got)


def failure(fn, *args):
    try:
        fn(*args)
    except (ServingError, JaxServingError) as e:
        return e.status, str(e)
    return 200, None


def test_unavailable_routes(setup):
    port = Predictor.from_checkpoint(setup["ckpt"], device="cpu")
    jax_pred = JaxPredictor.from_checkpoint(setup["ckpt"])
    bare, jax_bare = PredictionService(port), JaxService(jax_pred)
    try:
        for route in ("whatif_estimate", "whatif_surface",
                      "whatif_scaling"):
            got = failure(getattr(bare, route), {})
            assert got == failure(getattr(jax_bare, route), {})
            assert got[0] == 503
        assert failure(bare.verdict)[0] == failure(jax_bare.verdict)[0] == 503
        bad = {"seconds": -1}
        status, message = failure(bare.profile, bad)
        assert (status, message) == failure(jax_bare.profile, bad)
        assert status == 400 and "capture seconds" in message
    finally:
        bare.close()
        jax_bare.close()


def test_healthz_keys_and_digest_match_jax(setup):
    got, want = setup["port"].healthz(), setup["jax"].healthz()
    assert set(want) - {"wire", "router", "quality"} <= set(got)
    assert set(got) - set(want) == {"jit_cache", "kernel_launches",
                                    "device_memory"}
    assert got["device_memory"] is None          # no CUDA on the CPU
    assert set(got["batcher"]) == set(want["batcher"])
    assert set(got["batcher"]["shape_ladder"]) == set(
        want["batcher"]["shape_ladder"])
    assert got["quant"] == {"mode": "off"}
    digest = got["fleet"]["tenants"]["default"]["params_digest"]
    assert digest == want["fleet"]["tenants"]["default"]["params_digest"]
    assert digest == JaxPredictor.from_checkpoint(
        setup["ckpt"]).params_digest()
    assert set(got["surface"]) == set(want["surface"])
    assert set(got["obs"]) == set(want["obs"])
    fused = got["fused_infer"]
    assert {"dispatched_rungs", "graphs"} <= set(fused)
    assert fused["graphs"]["captured"] is False
    assert got["jit_cache"]["captures"] == 0
    assert got["kernel_launches"] == {"gru_fwd": 0, "gru_fwd_train": 0,
                                      "gru_bwd": 0}


def test_metrics_names_match_jax(setup):
    def names(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE")}

    # the newest plane owns the render-time collector: hand it back to the
    # module's services (a test above built and closed newer ones)
    from deeprest_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
    from deeprest_tpu_torch.obs.metrics import REGISTRY

    JAX_REGISTRY.register_collector("serving", setup["jax"]._collect_metrics)
    REGISTRY.register_collector("serving", setup["port"]._collect_metrics)
    serving = ("deeprest_http_", "deeprest_batcher_", "deeprest_fused_",
               "deeprest_serving_", "deeprest_surface_", "deeprest_obs_",
               "deeprest_plane_")
    got = names(setup["port"].metrics_text())
    want = {n for n in names(setup["jax"].metrics_text())
            if n.startswith(serving)}
    assert want <= got
    assert "deeprest_kernel_launches_total" in got
    assert {"deeprest_http_requests_total", "deeprest_plane_jit_executables",
            "deeprest_batcher_queue_windows"} <= got


def http(url, payload=None, timeout=TIMEOUT):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=(
        "GET" if payload is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode()
            return resp.status, body
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_round_trip(setup):
    port = Predictor.from_checkpoint(setup["ckpt"], device="cpu")
    server = PredictionServer(PredictionService(port), port=0,
                              batching=BatcherConfig())
    server.start()
    try:
        base = "http://%s:%d" % server.address
        payload = payloads(setup)["predict"]
        status, body = http(base + "/v1/predict", payload)
        assert status == 200
        want = setup["jax"].predict(payload)
        assert_json_close(json.loads(body), want)
        status, body = http(base + "/healthz")
        assert status == 200 and json.loads(body)["ok"]
        assert http(base + "/nope")[0] == 404
        assert http(base + "/v1/verdict")[0] == 503
        assert http(base + "/v1/profile", {"seconds": 0})[0] == 400
        assert http(base + "/v1/whatif", {"expected_traffic": []})[0] == 503
        status, body = http(base + "/metrics")
        assert status == 200
        assert 'deeprest_http_requests_total{route="/v1/predict",code="200"}' \
            in body
    finally:
        server.stop()


def test_concurrent_requests_coalesce_and_match_sequential(setup):
    port = Predictor.from_checkpoint(setup["ckpt"], device="cpu")
    svc = PredictionService(port, batching=BatcherConfig(max_linger_s=0.2))
    traffic = setup["traffic"]
    lengths = [W, W + 5, 2 * W + 1, 3 * W, W + 7, 2 * W]
    want = [setup["jax"].predict({"traffic": traffic[:n].tolist()})
            for n in lengths]
    got = [None] * len(lengths)

    def worker(i):
        got[i] = svc.predict({"traffic": traffic[:lengths[i]].tolist()})

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(lengths))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for g, w in zip(got, want):
            assert_json_close(g, w)
        stats = svc.healthz()["batcher"]
        assert stats["submitted"] == len(lengths)
        assert stats["coalesced_batches"] >= 1
    finally:
        svc.close()


def newer_step(ckpt_dir, dst):
    """Copy the checkpoint's newest step into ``dst``; return that step,
    its params scaled by 1.5 and its sidecar, for a newer step."""
    from deeprest_tpu_torch.train.checkpoint import latest_step

    step = latest_step(ckpt_dir)
    params = {k: v * 1.5 for k, v in load_params(ckpt_dir, step).items()}
    extra = load_sidecar(ckpt_dir, step)
    save_checkpoint(str(dst), load_params(ckpt_dir, step), step, extra)
    return step, params, extra


def test_watch_reload_picks_up_a_newer_step(setup, tmp_path):
    step, params, extra = newer_step(setup["ckpt"], tmp_path)
    reloader = CheckpointReloader(str(tmp_path), min_interval_s=0.0,
                                  device="cpu")
    old = Predictor.from_checkpoint(str(tmp_path), device="cpu")
    svc = PredictionService(old, reloader=reloader,
                            batching=BatcherConfig())
    try:
        payload = payloads(setup)["predict"]
        before = svc.predict(payload)
        svc.maybe_reload()
        assert svc.reloads == 0
        save_checkpoint(str(tmp_path), params, step + 1, extra)
        deadline = time.monotonic() + TIMEOUT
        while svc.reloads == 0 and time.monotonic() < deadline:
            svc.maybe_reload()
            time.sleep(0.05)
        assert svc.reloads == 1
        fresh = svc.predictor
        assert fresh is not old and old.batcher is not None
        assert fresh.batcher is svc.batcher
        assert fresh.params_digest() != old.params_digest()
        # warmed before the swap: every rung of both programs dispatched
        assert len(fresh.graphs.stats()["rungs"]) == (
            len(fresh.ladder.ladder) + 2 * len(fresh.fused.rungs))
        after = svc.predict(payload)
        want = Predictor.from_checkpoint(str(tmp_path), step=step + 1,
                                         device="cpu").predict_series(
            np.asarray(payload["traffic"], np.float32))
        np.testing.assert_allclose(after["predictions"], want, rtol=1e-6)
        assert after["predictions"] != before["predictions"]
    finally:
        svc.close()


def test_serve_cli_answers_and_stops_at_its_deadline(setup):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         setup["ckpt"], "--raw", setup["raw"], "--surface",
         "--surface-sync", "--port", "0", "--deadline", "20",
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT)
        assert ready, "serve printed no startup line"
        line = json.loads(proc.stdout.readline())
        assert line["whatif"] and line["device"] == "cpu"
        assert line["batching"]["ladder"] == [8, 16, 32, 64]
        assert line["surface"]["grid"] == [0.5, 1.0, 2.0, 4.0]
        assert line["graphs"]["captured"] is False
        assert set(line["seconds"]) == {"load", "warm", "fit"}
        base = line["listening"]
        status, body = http(base + "/v1/predict", payloads(setup)["predict"])
        assert status == 200
        assert_json_close(json.loads(body),
                          setup["jax"].predict(payloads(setup)["predict"]))
        health = json.loads(http(base + "/healthz")[1])
        assert health["jit_cache"]["captures_after_warmup"] == 0
        assert health["backend"] == f"checkpoint:{setup['ckpt']}"
    finally:
        proc.kill()
        proc.communicate(timeout=TIMEOUT)


@pytest.mark.parametrize("argv, message", [
    (["--batch-ladder", "8,x"], "is not a comma-separated list"),
    (["--batch-ladder", "0,8"], "rungs must be >= 1"),
    (["--batch-coalesce-groups", "0"], "must be >= 1"),
    (["--batch-max-windows", "65"], "exceeds the top (coalesced) ladder"),
    (["--watch", "-1"], "must be >= 0"),
    (["--obs-span-capacity", "0"], "must be >= 1"),
    (["--surface"], "--surface needs --raw"),
])
def test_serve_cli_validation_matches_jax(setup, argv, message):
    from deeprest_tpu.cli import main as jax_main
    from deeprest_tpu_torch.cli import main

    args = ["serve", "--ckpt-dir", setup["ckpt"], "--deadline", "0.01",
            "--port", "0"] + argv
    with pytest.raises(SystemExit) as got:
        main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jax_main(args)
    assert str(got.value) == str(want.value) and message in str(got.value)
