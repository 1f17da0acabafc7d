"""``serve --mesh`` over a multi-rank job, on the CPU under gloo: rank 0
fronts the HTTP plane and mirrors each device call to the other ranks,
which replay it (deeprest_tpu_torch/serve/mesh_front.py).

The model is small: the simulated social-network corpus of
tests/test_torch_whatif.py, cut to eight metrics so that the expert axis
divides them (F=64, H=8, dropout 0, one delta metric).  Its checkpoint is
written by the port's ``Trainer`` from JAX's init.  Every plane is two
``env://`` processes of ``serve --mesh ... --device cpu`` on a free port,
one intra-op thread each.

- The planes on 1x2x1, 1x1x2 and 2x1x1 (``--no-batcher``) start once per
  module.  Their ``/v1/predict`` (four windows, and seventy: past the
  ladder's top rung), ``/v1/whatif`` and ``/v1/anomaly`` answer within
  1e-5 of scale of JAX's ``Predictor.from_checkpoint(mesh_config=...)``
  through its own ``PredictionService``, in this process on conftest's 8
  host devices.  They are bit for bit the port's in-process ``Predictor``
  on the same mesh, through the same service calls, in one spawned gloo
  job that makes each mesh in turn.
- The 1x2x1 plane runs with its ranks' group timeout cut to a few
  seconds: it idles past it and answers.  ``/healthz`` answers again and
  again with the one-process ``params_digest`` and mirrors no call.
  Concurrent clients from many threads get their single-client answers.
- A plane with the MicroBatcher gets concurrent clients and stops at its
  ``--deadline``; SIGTERM to rank 0 stops a plane; a SIGKILLed follower
  gives the request in flight a 503 and rank 0 a nonzero exit naming it.
  Every rank of a plane that stops exits 0.
- JAX's own refusals of the flags ROADMAP item 6f brought to the mesh
  (the replica router, admission, tenant weights, the autoscaler, the
  fleet; tests/test_torch_serve_mesh_plane.py) exit on a mesh as on one
  device, and ``--mesh 1,1,1`` serves as one device does.  Quantized serving,
  ``--watch``, the capacity and verdict surfaces on a mesh:
  tests/test_torch_serve_mesh_quant.py and test_torch_serve_mesh_reload.py.

Every wait on a process and every HTTP call has a timeout, and every
process started here is killed at the end of its test or module.
"""

import json
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_torch_whatif import W, simulated_corpus

import test_torch_parallel_support as parallel_support
import test_torch_serve_mesh_support as support
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets as jax_featurize
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.cli import main
from deeprest_tpu_torch.config import (
    Config, FeaturizeConfig, ModelConfig, TrainConfig,
)
from deeprest_tpu_torch.data.featurize import featurize_buckets
from deeprest_tpu_torch.data.schema import save_raw_data_jsonl
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120                  # any one wait: a process, a line, a request
MESHES = {"1x2x1": (1, 2, 1), "1x1x2": (1, 1, 2), "2x1x1": (2, 1, 1)}
IDLE_TIMEOUT_S = 5.0           # the 1x2x1 plane's group timeout
DROPPED = "post-storage-mongodb_write-tp"      # nine metrics -> eight
ROUTES = {"predict": "/v1/predict", "predict_long": "/v1/predict",
          "whatif": "/v1/whatif", "anomaly": "/v1/anomaly"}
METHODS = {"predict": "predict", "predict_long": "predict",
           "whatif": "whatif_estimate", "anomaly": "anomaly"}


def write_port_checkpoint(directory, raw_path):
    """The port's ``Trainer.save`` at step 0 of JAX's init (seed 3) over
    the corpus at ``raw_path``."""
    buckets = support.load_buckets(raw_path)
    data = featurize_buckets(buckets, FeaturizeConfig(round_to=8))
    train = dict(window_size=W, eval_stride=W)
    cfg = Config(model=ModelConfig(hidden_size=8, dropout_rate=0.0),
                 train=TrainConfig(**train))
    bundle = prepare_dataset(data, cfg.train)
    jcfg = JaxConfig(model=JaxModelConfig(hidden_size=8, dropout_rate=0.0),
                     train=JaxTrainConfig(**train))
    jbundle = jax_prepare_dataset(jax_featurize(
        jax_buckets(raw_path), JaxFeaturizeConfig(round_to=8)), jcfg.train)
    jt = JaxTrainer(jcfg, jbundle.feature_dim, jbundle.metric_names)
    params = params_from_jax({k: np.asarray(v) for k, v in jt.init_state(
        jbundle.x_train[:1], seed=3).params.items()})
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    trainer.save(str(directory), trainer.init_state(params), bundle)
    return str(directory)


def jax_buckets(raw_path):
    from deeprest_tpu.data.schema import iter_raw_data_jsonl

    return list(iter_raw_data_jsonl(raw_path))


def http(url, payload=None, timeout=TIMEOUT):
    """(status, parsed body) of one GET (``payload`` None) or POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=(
        "GET" if payload is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class Plane:
    """``serve --mesh MESH`` as one env:// process a rank, stdout and
    stderr to files under ``wd``."""

    def __init__(self, wd, name, mesh, setup, *args, env=None):
        self.name, self.wd = name, wd
        world = int(np.prod(MESHES[mesh]))
        port = parallel_support.free_port()
        self.procs = []
        for r in range(world):
            rank_env = dict(
                os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                LOCAL_RANK=str(r), OMP_NUM_THREADS="1", **(env or {}))
            with open(self.path(r, "out"), "w") as out, \
                    open(self.path(r, "err"), "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", support.LAUNCH, "serve",
                     "--ckpt-dir", setup["ckpt"], "--raw", setup["raw"],
                     "--mesh", mesh.replace("x", ","), "--device", "cpu",
                     "--port", "0", *args],
                    cwd=REPO, env=rank_env, stdout=out, stderr=err))
        self.startup = None

    def path(self, rank, what):
        return os.path.join(self.wd, f"{self.name}.rank{rank}.{what}")

    def text(self, rank, what="out"):
        with open(self.path(rank, what)) as fh:
            return fh.read()

    def listening(self) -> dict:
        """Rank 0's startup JSON line, once it listens."""
        deadline = time.monotonic() + TIMEOUT
        while self.startup is None and time.monotonic() < deadline:
            for line in self.text(0).splitlines():
                if line.startswith('{"listening"'):
                    self.startup = json.loads(line)
            if self.startup is None:
                assert all(p.poll() is None for p in self.procs), (
                    self.text(0, "err")[-3000:], self.text(1, "err")[-3000:])
                time.sleep(0.05)
        assert self.startup is not None, "the plane did not listen"
        return self.startup

    @property
    def url(self) -> str:
        return self.listening()["listening"]

    def wait(self) -> list:
        """Every rank's exit code (each wait bounded)."""
        for p in self.procs:
            p.wait(TIMEOUT)
        return [p.returncode for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(TIMEOUT)


def mix_program(endpoints, ticks, seed=0):
    rng = np.random.default_rng(seed)
    return [{ep: int(rng.integers(0, 30)) for ep in endpoints[:5]}
            for _ in range(ticks)]


def run_service_job(wd, setup, payloads):
    """The port's in-process answers on every mesh (a spawned gloo job of
    two ranks, tests/test_torch_serve_mesh_support.py)."""
    job = wd / "service_job"
    job.mkdir()
    with open(job / "spec.json", "w") as fh:
        json.dump({"ckpt": setup["ckpt"], "raw": setup["raw"],
                   "meshes": MESHES, "payloads": {
                       route: (METHODS[route], payloads[route])
                       for route in ROUTES}}, fh)
    ctx = multiprocessing.get_context("spawn")
    port = parallel_support.free_port()
    procs = [ctx.Process(target=support.service_rank,
                         args=(r, 2, port, str(job))) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0], (job / "service0.log"
                                                   ).read_text()[-3000:]
    with open(job / "service.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve_mesh")
    buckets = simulated_corpus(wd / "raw9.jsonl", buckets=40)
    for b in buckets:
        b.metrics = [m for m in b.metrics
                     if f"{m.component}_{m.resource}" != DROPPED]
    raw = str(wd / "raw.jsonl")
    save_raw_data_jsonl(buckets, raw)
    ckpt = write_port_checkpoint(wd / "ckpt", raw)
    one = Predictor.from_checkpoint(ckpt, device="cpu")
    assert len(one.metric_names) == 8 and one.feature_dim == 64
    assert one.delta_mask.any() and not one.delta_mask.all()
    data = featurize_buckets(support.load_buckets(raw), space=one.space())
    traffic, observed = data.traffic, data.targets()
    endpoints = JaxSynth(JaxPredictor.from_checkpoint(ckpt).space()).fit(
        jax_buckets(raw)).endpoints
    payloads = {
        "predict": {"traffic": traffic[:3 * W + 5].tolist()},
        "predict_long": {"traffic": np.tile(traffic, (21, 1))[:70 * W]
                         .tolist()},
        "whatif": {"expected_traffic": mix_program(endpoints, 2 * W + 3),
                   "seed": 1},
        "anomaly": {"traffic": traffic.tolist(),
                    "observed": observed.tolist(), "tolerance": 0.05,
                    "min_run": 2},
    }
    return dict(wd=wd, ckpt=ckpt, raw=raw, one=one, traffic=traffic,
                payloads=payloads, endpoints=endpoints)


@pytest.fixture(scope="module")
def planes(setup):
    """The three --no-batcher planes and the two 2x1x1 planes the stop
    tests end, started together; the 1x2x1 plane's ranks with their group
    timeout cut to IDLE_TIMEOUT_S."""
    barrier = setup["wd"] / "barrier"
    barrier.mkdir()
    started = {
        "1x2x1": Plane(setup["wd"], "p121", "1x2x1", setup, "--no-batcher",
                       env={"JOB_TIMEOUT_S": str(IDLE_TIMEOUT_S),
                            "RANK_BARRIER": str(barrier)}),
        "1x1x2": Plane(setup["wd"], "p112", "1x1x2", setup, "--no-batcher"),
        "2x1x1": Plane(setup["wd"], "p211", "2x1x1", setup, "--no-batcher"),
        "sigterm": Plane(setup["wd"], "sigterm", "2x1x1", setup),
        "sigkill": Plane(setup["wd"], "sigkill", "2x1x1", setup),
    }
    try:
        yield started
    finally:
        for plane in started.values():
            if plane.procs[0].poll() is None:
                plane.procs[0].send_signal(signal.SIGTERM)
        for plane in started.values():
            try:
                plane.wait()
            finally:
                plane.kill()


@pytest.fixture(scope="module")
def answers(setup, planes):
    """Each mesh's plane's answer to each payload, posted once."""
    out = {}
    for mesh in MESHES:
        plane = planes[mesh]
        out[mesh] = {}
        for route, path in ROUTES.items():
            status, body = http(plane.url + path, setup["payloads"][route])
            assert status == 200, (mesh, route, body)
            out[mesh][route] = body
    return out


@pytest.fixture(scope="module")
def in_process(setup):
    return run_service_job(setup["wd"], setup, setup["payloads"])


@pytest.fixture(scope="module")
def jax_answers(setup):
    """JAX's mesh Predictor through its own PredictionService, each mesh."""
    out = {}
    buckets = jax_buckets(setup["raw"])
    for mesh, shape in MESHES.items():
        pred = JaxPredictor.from_checkpoint(
            setup["ckpt"], mesh_config=JaxMeshConfig(*shape))
        svc = JaxService(pred, JaxSynth(pred.space()).fit(buckets))
        try:
            out[mesh] = {route: getattr(svc, METHODS[route])(payload)
                         for route, payload in setup["payloads"].items()}
        finally:
            svc.close()
    return out


def assert_scaled(got, want, tol=1e-5, where="body"):
    """Equal structure, strings, ints and bools; every numeric array (a
    list of numbers, nested or not) and float within ``tol`` of its
    largest magnitude."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_scaled(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, list) and want and not isinstance(
            np.asarray(want).flat[0], (np.floating, float)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_scaled(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, (list, float)):
        g = np.asarray(got, np.float64)
        w = np.asarray(want, np.float64)
        assert g.shape == w.shape, where
        if w.size:
            scale = max(float(np.abs(w).max()), 1e-6)
            assert float(np.abs(g - w).max()) <= tol * scale, where
    else:
        assert got == want, where


# -- the planes against JAX and against the port in-process ---------------

@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_plane_answers_within_1e5_of_jax_mesh_predictor(answers, jax_answers,
                                                        mesh, route):
    assert_scaled(answers[mesh][route], jax_answers[mesh][route])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_plane_answers_bit_for_bit_the_in_process_mesh_predictor(
        answers, in_process, mesh):
    for route in ROUTES:
        assert answers[mesh][route] == in_process[mesh][route], route


def test_startup_line_names_the_mesh_and_world(planes):
    for mesh in MESHES:
        line = planes[mesh].listening()
        assert line["mesh"] == list(MESHES[mesh]) and line["world"] == 2
        assert line["device"] == "cpu" and line["batching"] is None
        assert line["graphs"]["captured"] is False
        assert set(line["seconds"]) == {"load", "warm", "digest", "fit"}


# -- the 1x2x1 plane: /healthz, concurrency, idling ------------------------

def test_healthz_answers_the_digest_and_mirrors_no_call(setup, planes,
                                                        answers):
    url = planes["1x2x1"].url
    before = http(url + "/healthz")[1]["mesh"]
    for _ in range(20):
        status, health = http(url + "/healthz")
        assert status == 200 and health["ok"]
        tenant = health["fleet"]["tenants"]["default"]
        assert tenant["params_digest"] == setup["one"].params_digest()
    after = health["mesh"]
    assert after["world"] == 2 and after["error"] is None
    assert after["calls"] == before["calls"] > 0


def test_concurrent_clients_get_their_single_client_answers(setup, planes,
                                                            answers):
    """Predict, what-if and anomaly requests from eight threads at once
    (no batcher: each request is its own fused call, so bit for bit)."""
    url = planes["1x2x1"].url
    p = setup["payloads"]
    jobs = [(route, p[route]) for route in ROUTES]
    jobs += [("predict", {"traffic": setup["traffic"][:n].tolist()})
             for n in (W, W + 5, 2 * W + 1, 3 * W)]
    single = [http(url + ROUTES[r], body)[1] for r, body in jobs]
    got = [None] * len(jobs)

    def client(i):
        route, body = jobs[i]
        got[i] = http(url + ROUTES[route], body)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for (status, body), want in zip(got, single):
        assert status == 200 and body == want


def test_idle_plane_outlives_the_group_timeout(setup, planes, answers):
    url = planes["1x2x1"].url
    time.sleep(IDLE_TIMEOUT_S * 1.4)
    status, body = http(url + "/v1/predict", setup["payloads"]["predict"])
    assert status == 200 and body == answers["1x2x1"]["predict"]
    health = http(url + "/healthz")[1]["mesh"]
    assert health["heartbeats"] >= 2 and health["error"] is None


# -- planes that stop --------------------------------------------------------

def test_batcher_plane_serves_concurrent_clients_and_stops_at_deadline(
        setup):
    """The MicroBatcher's flush thread and the request threads on 1x2x1:
    coalesced answers equal the single-client ones within 1e-5 of scale;
    then --deadline stops every rank with exit 0."""
    plane = Plane(setup["wd"], "batcher", "1x2x1", setup, "--deadline", "8",
                  "--batch-linger-ms", "50")
    try:
        url = plane.url
        assert plane.listening()["batching"]["ladder"] == [8, 16, 32, 64]
        bodies = [{"traffic": setup["traffic"][:n].tolist()}
                  for n in (W, W + 5, 2 * W + 1, 3 * W, W + 7, 2 * W,
                            3 * W + 5, 26)]
        single = [http(url + "/v1/predict", b)[1] for b in bodies]
        got = [None] * len(bodies)

        def client(i):
            got[i] = http(url + "/v1/predict", bodies[i])

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for (status, body), want in zip(got, single):
            assert status == 200
            assert_scaled(body, want)
        health = http(url + "/healthz")[1]
        assert health["batcher"]["coalesced_batches"] >= 1
        assert plane.wait() == [0, 0], plane.text(0, "err")[-3000:]
        assert plane.text(1).splitlines() == [
            "distributed: process 1 of 2, 2 global devices (gloo)"]
    finally:
        plane.kill()


def test_sigterm_to_rank_0_stops_every_rank(setup, planes):
    plane = planes["sigterm"]
    status, _ = http(plane.url + "/v1/predict", setup["payloads"]["predict"])
    assert status == 200
    plane.procs[0].send_signal(signal.SIGTERM)
    assert plane.wait() == [0, 0], plane.text(0, "err")[-3000:]


def test_lost_follower_gives_503_and_ends_rank_0_naming_it(setup, planes):
    plane = planes["sigkill"]
    url = plane.url
    assert http(url + "/v1/predict", setup["payloads"]["predict"])[0] == 200
    plane.procs[1].kill()
    plane.procs[1].wait(TIMEOUT)
    status, body = http(url + "/v1/predict", setup["payloads"]["predict"])
    assert status == 503 and "serving mesh is gone" in body["error"]
    assert plane.procs[0].wait(TIMEOUT) == 1
    assert "the 2-rank serving mesh lost rank(s) [1]" in plane.text(0, "err")


# -- flags ----------------------------------------------------------------

@pytest.mark.parametrize("flag", [
    ["--replicas", "2", "--replica-timeout-ms", "-1"],
    ["--admission-depth", "4", "--admission-wait-ms", "-1"],
    ["--tenant-weights", "a=0"], ["--autoscale"],
    ["--fleet", "b=ckpt", "--replicas", "2", "--replica-mode", "process"]])
def test_deferred_flags_exit_2_naming_roadmap_6e(setup, capsys, flag):
    """The five flags ROADMAP item 6f deferred on a mesh above one rank
    are taken there now (tests/test_torch_serve_mesh_plane.py); each of
    JAX's own refusals of them exits on 1x2x1 as on one device, before
    anything loads."""
    exits = []
    for mesh in (["--mesh", "1,2,1"], []):
        with pytest.raises(SystemExit) as exc:
            main(["serve", "--ckpt-dir", setup["ckpt"], "--raw",
                  setup["raw"], *mesh, "--device", "cpu", "--port", "0",
                  *flag])
        exits.append(exc.value.code)
    assert exits[0] == exits[1]
    assert exits[0].startswith("error: ") and "ROADMAP" not in exits[0]


def test_mesh_of_one_serves_as_one_device(setup):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         setup["ckpt"], "--mesh", "1,1,1", "--no-batcher", "--port", "0",
         "--deadline", "3", "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["mesh"] == [1, 1, 1] and line["world"] == 1
        assert set(line["seconds"]) == {"load", "warm"}
        status, body = http(line["listening"] + "/v1/predict",
                            setup["payloads"]["predict"])
        assert status == 200
        assert body["predictions"] == setup["one"].predict_series(
            np.asarray(setup["payloads"]["predict"]["traffic"],
                       np.float32)).tolist()
        assert "mesh" not in http(line["listening"] + "/healthz")[1]
        assert proc.wait(TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=TIMEOUT)


def test_front_needs_a_mesh_above_one_rank(setup):
    from deeprest_tpu_torch.serve.mesh_front import MeshFront

    one = setup["one"]
    assert one.front is None and one.fused._front is None
    with pytest.raises(ValueError, match="more than one rank"):
        MeshFront(one)
    assert one.front is None
