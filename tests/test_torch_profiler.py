"""The port's profiler (obs/profiler.py on torch.profiler) against the JAX
package's on the CPU: ``POST /v1/profile`` writes a trace while the server
keeps serving, a second window at once gets 409, bad windows get JAX's 400
message, the ``profile`` CLI drives a live port server, ``train
--profile-dir --device cpu`` writes a trace of the first epoch, and
``measure_step_breakdown`` closes each trial with a readback (the ledger
JAX's tool keeps, with its keys).  Every server is stopped in a
``finally``.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_router_support import E, F, W, build_tiny

from deeprest_tpu.obs import profiler as jax_profiler
from deeprest_tpu_torch.obs import profiler
from deeprest_tpu_torch.serve.server import (
    PredictionServer, PredictionService, ServingError,
)

TIMEOUT = 60


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def server():
    srv = PredictionServer(PredictionService(build_tiny(), backend="prof"),
                           port=0).start()
    try:
        yield srv
    finally:
        srv.stop()


def trace_names(path) -> set:
    with open(path, encoding="utf-8") as fh:
        trace = json.load(fh)
    return {ev.get("name") for ev in trace["traceEvents"]}


def test_profile_route_writes_a_trace_under_load(server, tmp_path):
    base = "http://%s:%d" % server.address
    traffic = np.random.default_rng(0).random((2 * W, F)).astype(np.float32)
    stop, served = threading.Event(), []

    def load():
        while not stop.is_set():
            served.append(post(base + "/v1/predict",
                               {"traffic": traffic.tolist()})[0])

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        status, body = post(base + "/v1/profile",
                            {"seconds": 0.3, "out_dir": str(tmp_path / "t")})
    finally:
        stop.set()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert status == 200
    assert body["trace_dir"] == os.path.abspath(tmp_path / "t")
    assert body["seconds"] == 0.3
    assert os.path.dirname(body["trace"]) == body["trace_dir"]
    assert served and set(served) == {200}
    # the window saw the serving plane's own ops (the plain recurrence on
    # the CPU; K1's kernel by its symbol on a GPU)
    names = trace_names(body["trace"])
    assert any(n and n.startswith("aten::") for n in names), sorted(names)[:20]
    # a bad window is a client error with JAX's message, not a 500
    status, body = post(base + "/v1/profile", {"seconds": -1})
    assert status == 400
    with pytest.raises(ValueError) as want:
        jax_profiler.capture("/nonexistent", -1)
    assert body["error"] == str(want.value)


def test_second_window_is_busy_409(server, tmp_path):
    with pytest.raises(ValueError) as got:
        profiler.capture(str(tmp_path), 0)
    with pytest.raises(ValueError) as want:
        jax_profiler.capture(str(tmp_path), 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        profiler.capture(str(tmp_path), 121.0)
    assert profiler._capture_lock.acquire(blocking=False)   # a held window
    try:
        with pytest.raises(profiler.ProfilerBusy):
            profiler.capture(str(tmp_path), 0.1)
        with pytest.raises(ServingError) as exc:
            server.service.profile({"seconds": 0.1})
        assert exc.value.status == 409
        base = "http://%s:%d" % server.address
        status, body = post(base + "/v1/profile", {"seconds": 0.1})
        assert status == 409 and "already open" in body["error"]
    finally:
        profiler._capture_lock.release()


def test_profile_cli_against_a_live_port_server(server, tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    base = "http://%s:%d" % server.address
    out = str(tmp_path / "cli")
    assert main(["profile", "--url", base, "--seconds", "0.2",
                 "--out-dir", out]) == 0
    body = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert body["trace_dir"] == os.path.abspath(out)
    assert os.path.isfile(body["trace"])
    with pytest.raises(SystemExit, match="must be > 0"):
        main(["profile", "--url", base, "--seconds", "0"])
    with pytest.raises(SystemExit, match="server answered 400"):
        main(["profile", "--url", base, "--seconds", "500"])


def tiny_corpus(path: str, minutes: int = 90) -> str:
    from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData

    rng = np.random.default_rng(0)
    traffic = rng.poisson(rng.uniform(0.5, 5.0, F),
                          (minutes, F)).astype(np.float32)
    resources = {f"c{i}_cpu": (traffic @ rng.random(F)).astype(np.float32)
                 for i in range(E)}
    space = {"config": {"capacity": 0, "round_to": 128,
                        "hash_features": False, "hash_seed": 0x5EED},
             "vocabulary": [[f"svc{j}", f"/op{j}"] for j in range(F)],
             "frozen_capacity": F}
    return FeaturizedData(traffic=traffic, resources=resources,
                          invocations={},
                          space=CallPathSpace.from_dict(space)).save(path)


def test_train_profile_dir_writes_a_trace(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    feats = tiny_corpus(str(tmp_path / "input.npz"))
    prof = tmp_path / "prof"
    assert main(["train", "--features", feats, "--epochs", "2",
                 "--window", str(W), "--batch-size", "4", "--hidden-size",
                 "8", "--no-baselines", "--profile-dir", str(prof),
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    path = prof / "trace_epoch1.json"
    assert f"profiler trace written to {path}" in out
    assert out.count("profiler trace written") == 1      # the first epoch
    names = trace_names(path)
    assert any(n and n.startswith("aten::") for n in names)
    assert json.loads(out.strip().splitlines()[-1])["steps"] > 0


def test_step_breakdown_ledger_closes_each_trial_with_a_readback():
    import jax  # noqa: F401  (the JAX trainer below)

    from deeprest_tpu.config import Config as JaxConfig
    from deeprest_tpu.config import ModelConfig as JaxModelConfig
    from deeprest_tpu.config import TrainConfig as JaxTrainConfig
    from deeprest_tpu.train import Trainer as JaxTrainer
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.train.trainer import Trainer

    names = [f"c{i}_cpu" for i in range(E)]
    rng = np.random.default_rng(0)
    x = rng.random((4, W, F), np.float32)
    y = rng.random((4, W, E), np.float32)
    w = np.ones((4,), np.float32)
    cfg = Config(model=ModelConfig(hidden_size=8, dropout_rate=0.0),
                 train=TrainConfig(batch_size=4, window_size=W))
    got = profiler.measure_step_breakdown(
        Trainer(cfg, F, names, device="cpu"), x, y, w, steps=3, warmup=1)
    jcfg = JaxConfig(model=JaxModelConfig(feature_dim=F, num_metrics=E,
                                          hidden_size=8, dropout_rate=0.0),
                     train=JaxTrainConfig(batch_size=4, window_size=W))
    want = jax_profiler.measure_step_breakdown(
        JaxTrainer(jcfg, F, names), x, y, w, steps=3, warmup=1)
    assert got["ledger"] == want["ledger"] == {"started": 3, "synced": 3}
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    assert got["device"] == "cpu" and got["steps"] == 3
    for k in ("host_feed_ms_per_step", "dispatch_ms_per_step",
              "device_wait_ms_per_step", "total_ms_per_step"):
        assert got[k] >= 0
