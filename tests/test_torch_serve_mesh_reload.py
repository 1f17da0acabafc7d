"""``serve --mesh --watch`` and the capacity and verdict surfaces on a
multi-rank mesh, on the CPU under gloo (serve/mesh_front.py,
serve/server.py ``CheckpointReloader``).

The model and corpus are tests/test_torch_serve_mesh.py's (F=64, E=8,
H=8); every plane reads its own copy of the checkpoint.

- A 1x2x1 int8 plane with ``--watch 0.2 --surface`` answers step 0 as
  JAX's quantized mesh ``Predictor`` does.  While four clients post
  ``/v1/predict`` without pause, step 1 (step 0's params x 1.1) is written
  into the watched directory: every answer is bit for bit the plane's
  whole step-0 or whole step-1 answer, and once ``/healthz`` names step 1
  the plane answers within 1e-5 of scale of JAX's mesh predictor at step
  1, its digest and its surfaces' ``params_hash`` the one-process int8
  predictor's at step 1.  Then steps 2 and 3 are written back to back
  under the four clients, step 3 as soon as step 2 is loaded and before
  or while it is swapped in: every answer is 200 and whole, no client
  goes back a step, and the plane ends on step 3 with every rank alive.
  Then a step 4 whose shard of rank 1's experts is cut short is written:
  the reload fails on rank 1, so every rank stays on step 3.
- A 1x1x2 int8 plane with ``--surface`` and ``--verdict-raw`` answers
  ``/v1/whatif`` (a miss, then a hit of the surface its warm thread
  built), ``/v1/whatif/surface`` and ``/v1/verdict`` within 1e-5 of scale
  of the one-process service (``serve`` without ``--mesh``), with the
  same verdict states, surface keys and digest.

- A spawned gloo job drives the mesh front and its follower through
  what the plane makes only by chance (test_torch_serve_mesh_support.py
  ``front_rank``): step 2 loaded before step 1 is swapped in, then step
  1 served; a step 3 whose warm-up fails on rank 1 alone, refused on both;
  a call of step 0's predictor, dropped at that reload, refused with 503;
  then step 2 served.  Each answer within 1e-5 of scale of the
  one-process predictor at its step.

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

import numpy as np
import pytest
import torch
from test_torch_serve_mesh import (
    MESHES, METHODS, REPO, TIMEOUT, Plane, assert_scaled, http, jax_buckets,
)
from test_torch_serve_mesh_quant import build_setup, copy_ckpt

import test_torch_parallel_support as parallel_support
import test_torch_serve_mesh_support as support
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train.checkpoint import (
    load_leaves, load_sidecar, save_checkpoint,
)

SCALES = {1: 1.1, 2: 1.2, 3: 1.15, 4: 1.4}  # newer steps' params, x this
CLIENTS = 4
SURFACE = ["--surface", "--surface-max-axes", "2", "--surface-jitter", "2"]
VERDICT = ["--verdict-sweep-every", "12", "--verdict-live-window", "24"]
ROUTES = {"predict": "/v1/predict", "whatif": "/v1/whatif",
          "anomaly": "/v1/anomaly"}


def write_step(ckpt, base, step):
    """Step ``step`` of ``ckpt``: step 0 of ``base`` (a whole TrainState,
    as either package restores it) with every param scaled by
    ``SCALES[step]`` and the same sidecar, written whole, then renamed
    into place.  Returns the step's directory."""
    leaves = load_leaves(base, 0)
    params = {k[len("params/"):]: v * SCALES[step]
              for k, v in leaves.items() if k.startswith("params/")}
    other = {k: v for k, v in leaves.items() if not k.startswith("params/")}
    other["step"] = torch.tensor(step, dtype=other["step"].dtype)
    return save_checkpoint(ckpt, params, step, extra=load_sidecar(base, 0),
                           other_leaves=other)


def write_torn_step(ckpt, base, step, staging):
    """Step ``step`` with each param stored as two shards of the expert
    axis and the second shard of ``head_w`` cut short: rank 1 of a 1x2x1
    mesh cannot read it, rank 0 can.  Built in ``staging`` and renamed
    into ``ckpt`` whole."""
    step_dir = write_step(staging, base, step)
    arrays = os.path.join(step_dir, "arrays")
    with open(os.path.join(step_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    for leaf in manifest["leaves"]:
        if not leaf["name"].startswith("params/"):
            continue
        (shard,) = leaf["shards"]
        whole = np.load(os.path.join(arrays, shard["file"]))
        os.remove(os.path.join(arrays, shard["file"]))
        half = leaf["shape"][0] // 2
        leaf["shards"] = []
        for i in range(2):
            name = f"{shard['file'][:-4]}.e{i}.npy"
            np.save(os.path.join(arrays, name),
                    whole[i * half:(i + 1) * half])
            leaf["shards"].append({
                "index": [[i * half, (i + 1) * half]]
                + [[0, d] for d in leaf["shape"][1:]], "file": name})
            if i == 1 and leaf["name"] == "params/head_w":
                torn = os.path.join(arrays, name)
                with open(torn, "rb") as fh:
                    blob = fh.read()
                with open(torn, "wb") as fh:
                    fh.write(blob[:len(blob) // 2])
    with open(os.path.join(step_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    os.replace(step_dir, os.path.join(ckpt, f"step_{step:08d}"))


def wait_health(url, ready, what):
    """``/healthz`` polled until ``ready(body)``."""
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        status, health = http(url + "/healthz")
        if status == 200 and ready(health):
            return health
        time.sleep(0.1)
    raise AssertionError(f"/healthz never showed {what}: {health}")


def surface_query(url, endpoints, factor=2):
    program = [{ep: 3 for ep in endpoints[:2]}] * 30
    return http(url + "/v1/whatif/surface", {
        "base_traffic": program, "factor": factor, "wait": True})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(tmp_path_factory.mktemp("serve_mesh_reload"))


@pytest.fixture(scope="module")
def planes(setup):
    """The watched 1x2x1 int8 plane, and the 1x1x2 int8 surface and
    verdict plane beside a one-process one, started together."""
    wd = setup["wd"]
    watched = copy_ckpt(setup["ckpt"], wd, "watched")
    started = {
        "watch": Plane(wd, "watch", "1x2x1",
                       {"ckpt": watched, "raw": setup["raw"]},
                       "--no-batcher", "--quant", "int8", "--watch", "0.2",
                       *SURFACE),
        "surface": Plane(wd, "surface", "1x1x2",
                         {"ckpt": copy_ckpt(setup["ckpt"], wd, "surface"),
                          "raw": setup["raw"]},
                         "--no-batcher", "--quant", "int8", *SURFACE,
                         "--verdict-raw", setup["raw"], *VERDICT),
    }
    one = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         copy_ckpt(setup["ckpt"], wd, "one"), "--raw", setup["raw"],
         "--no-batcher", "--quant", "int8", *SURFACE, "--verdict-raw",
         setup["raw"], *VERDICT, "--port", "0", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield dict(started, watched=watched, one=one)
    finally:
        for plane in started.values():
            if plane.procs[0].poll() is None:
                plane.procs[0].send_signal(signal.SIGTERM)
        one.kill()
        one.communicate(timeout=TIMEOUT)
        for plane in started.values():
            try:
                plane.wait()
            finally:
                plane.kill()


def answer_all(url, payloads):
    out = {}
    for route, path in ROUTES.items():
        status, body = http(url + path, payloads[route])
        assert status == 200, (route, body)
        out[route] = body
    return out


class Clients:
    """``CLIENTS`` threads posting ``payload`` to ``/v1/predict`` without
    pause while the block runs; ``seen`` holds each one's answers."""

    def __init__(self, url, payload):
        self.url, self.payload = url, payload
        self.stop = threading.Event()
        self.seen = [[] for _ in range(CLIENTS)]
        self.threads = [threading.Thread(target=self.client, args=(i,),
                                         daemon=True)
                        for i in range(CLIENTS)]

    def client(self, i):
        while not self.stop.is_set():
            self.seen[i].append(http(self.url + "/v1/predict", self.payload))

    def __enter__(self):
        for t in self.threads:
            t.start()
        time.sleep(0.5)
        return self

    def __exit__(self, *exc):
        time.sleep(0.5)
        self.stop.set()
        for t in self.threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in self.threads)


def step_kinds(clients, answers):
    """Each client's answers as indices into ``answers`` (every one must
    be 200 and one of them)."""
    out = []
    for seen in clients:
        kinds = []
        for status, body in seen:
            assert status == 200, body
            assert body in answers
            kinds.append(answers.index(body))
        out.append(kinds)
    return out


@pytest.fixture(scope="module")
def reload_run(setup, planes):
    """The watched plane through step 0, the reload to step 1 under four
    clients, steps 2 and 3 back to back under them, and the torn step
    4."""
    url = planes["watch"].url
    watched, payload = planes["watched"], setup["payloads"]["predict"]
    out = {"step0": answer_all(url, setup["payloads"]),
           "surface0": surface_query(url, setup["endpoints"]),
           "health0": http(url + "/healthz")[1]}
    with Clients(url, payload) as clients:
        write_step(watched, setup["ckpt"], 1)
        t0 = time.monotonic()
        out["health1"] = wait_health(url, lambda h: h["mesh"]["step"] == 1,
                                     "step 1")
        out["reload_s"] = time.monotonic() - t0
    out["clients"] = clients.seen
    out["step1"] = answer_all(url, setup["payloads"])
    out["surface1"] = surface_query(url, setup["endpoints"])
    with Clients(url, payload) as clients:
        write_step(watched, setup["ckpt"], 2)
        wait_health(url, lambda h: h["mesh"]["reloads"]["ok"] == 2,
                    "step 2 loaded")
        write_step(watched, setup["ckpt"], 3)
        out["health3"] = wait_health(
            url, lambda h: h["mesh"]["step"] == 3, "step 3")
    out["clients_b2b"] = clients.seen
    out["step3"] = answer_all(url, setup["payloads"])
    write_torn_step(watched, setup["ckpt"], 4, str(setup["wd"] / "staging"))
    # the reloader tries the torn step again after 0.4 s, then 0.8 s: two
    # refusals show that a failed reload leaves it watching
    out["health4"] = wait_health(
        url, lambda h: h["mesh"]["reloads"]["failed"] >= 2,
        "two failed reloads")
    out["step4"] = answer_all(url, setup["payloads"])
    return out


@pytest.fixture(scope="module")
def references(setup):
    """JAX's int8 mesh Predictor at steps 0 and 1 through its own
    PredictionService, and the port's one-process int8 digests."""
    wd = setup["wd"]
    jax_dir = copy_ckpt(setup["ckpt"], wd, "jax_steps")
    port_dir = copy_ckpt(setup["ckpt"], wd, "port_steps")
    for d in (jax_dir, port_dir):
        write_step(d, setup["ckpt"], 1)
    write_step(port_dir, setup["ckpt"], 3)
    buckets = jax_buckets(setup["raw"])
    out = {"jax": {}, "digest": {}}
    for step in (0, 1):
        pred = JaxPredictor.from_checkpoint(
            jax_dir, step=step, mesh_config=JaxMeshConfig(*MESHES["1x2x1"]),
            quant="int8")
        svc = JaxService(pred, JaxSynth(pred.space()).fit(buckets))
        try:
            out["jax"][step] = {
                route: getattr(svc, METHODS[route])(setup["payloads"][route])
                for route in ROUTES}
        finally:
            svc.close()
    for step in (0, 1, 3):
        out["digest"][step] = Predictor.from_checkpoint(
            port_dir, step=step, device="cpu", quant="int8").params_digest()
    return out


# -- --watch on the mesh -----------------------------------------------------

@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("route", list(ROUTES))
def test_watch_plane_answers_each_step_within_1e5_of_jax(
        reload_run, references, step, route):
    got = dict(reload_run[f"step{step}"][route])
    if route == "whatif":       # a miss: the step's surfaces not built yet
        assert got.pop("surface") == {"hit": False}
    assert_scaled(got, references["jax"][step][route])


def test_watch_plane_names_the_served_step_and_its_digest(reload_run,
                                                          references):
    for step in (0, 1):
        health = reload_run[f"health{step}"]
        assert health["mesh"]["step"] == step
        assert health["mesh"]["reloads"] == {"ok": step, "failed": 0}
        assert health["reloads"] == step
        tenant = health["fleet"]["tenants"]["default"]
        assert tenant["params_digest"] == references["digest"][step]
        assert health["quant"]["mode"] == "int8"
    assert reload_run["reload_s"] < TIMEOUT


def test_reload_never_mixes_steps_within_an_answer(reload_run):
    """Every answer to the clients hammering through the reload is the
    plane's whole step-0 answer or its whole step-1 answer, both occur,
    and no client sees step 0 after it saw step 1."""
    old = reload_run["step0"]["predict"]
    new = reload_run["step1"]["predict"]
    assert old != new
    seen = []
    for kinds in step_kinds(reload_run["clients"], [old, new]):
        assert kinds == sorted(kinds)
        seen += kinds
    assert any(seen) and not all(seen)


def test_back_to_back_steps_keep_every_rank_serving(reload_run, planes,
                                                   references):
    """Step 3 written once step 2 is loaded, so its reload can start
    before step 2's swap: every client answer is 200 and the plane's
    whole step-1, step-2 or step-3 answer, in that order, and the plane
    ends on step 3 with every rank alive and no reload refused."""
    first, last = (reload_run[s]["predict"] for s in ("step1", "step3"))
    middle = [body for seen in reload_run["clients_b2b"]
              for status, body in seen if body not in (first, last)]
    answers = [first, *middle[:1], last]
    for kinds in step_kinds(reload_run["clients_b2b"], answers):
        assert kinds == sorted(kinds)
    health = reload_run["health3"]
    assert health["mesh"]["step"] == 3 and health["reloads"] == 3
    assert health["mesh"]["reloads"] == {"ok": 3, "failed": 0}
    assert health["mesh"]["error"] is None
    tenant = health["fleet"]["tenants"]["default"]
    assert tenant["params_digest"] == references["digest"][3]
    assert all(p.poll() is None for p in planes["watch"].procs)


def test_surface_keys_follow_the_reload(reload_run, references):
    for step in (0, 1):
        status, body = reload_run[f"surface{step}"]
        assert status == 200, body
        assert body["surface"]["params_hash"] == (
            references["digest"][step] + ":int8")


def test_torn_step_leaves_every_rank_on_the_old_step(reload_run, planes):
    health = reload_run["health4"]
    assert health["mesh"]["step"] == 3 and health["reloads"] == 3
    assert health["mesh"]["reloads"]["ok"] == 3
    assert health["mesh"]["error"] is None
    for route in ("predict", "anomaly"):
        assert reload_run["step4"][route] == reload_run["step3"][route]
    assert "refused on every rank" in planes["watch"].text(1, "err")


@pytest.fixture(scope="module")
def front_job(setup):
    """The spawned gloo job of ``support.front_rank`` on steps 0-3, and
    the one-process answers at steps 1 and 2."""
    wd = setup["wd"] / "front_job"
    wd.mkdir()
    ckpt = copy_ckpt(setup["ckpt"], wd, "ckpt")
    for step in (1, 2, 3):
        write_step(ckpt, setup["ckpt"], step)
    traffic = setup["payloads"]["predict"]["traffic"]
    with open(wd / "spec.json", "w") as fh:
        json.dump({"ckpt": ckpt, "traffic": traffic}, fh)
    ctx = multiprocessing.get_context("spawn")
    port = parallel_support.free_port()
    procs = [ctx.Process(target=support.front_rank,
                         args=(r, 2, port, str(wd))) for r in range(2)]
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
    logs = [(wd / f"front{r}.log").read_text() for r in range(2)]
    assert [p.exitcode for p in procs] == [0, 0], (
        logs[0][-3000:], logs[1][-3000:])
    with open(wd / "front.json") as fh:
        out = json.load(fh)
    x = np.asarray(traffic, np.float32)
    one = {step: Predictor.from_checkpoint(ckpt, step=step, device="cpu")
           .predict_series(x) for step in (1, 2)}
    return dict(out=out, one=one, follower=logs[1])


def test_front_keeps_a_loaded_step_until_its_swap(front_job):
    out, one = front_job["out"], front_job["one"]
    for step in (1, 2):
        got = np.asarray(out[f"step{step}"])
        assert np.abs(got - one[step]).max() <= 1e-5 * np.abs(
            one[step]).max(), step
    assert out["stats"]["reloads"] == {"ok": 2, "failed": 1}
    assert out["stats"]["error"] is None


def test_front_refuses_a_step_one_rank_failed_to_warm(front_job):
    out = front_job["out"]
    assert "failed to warm on another rank" in out["reload3"]
    assert "refused on every rank" in front_job["follower"]
    assert out["step0_after"] == 503


# -- the capacity and verdict surfaces on the mesh --------------------------

@pytest.fixture(scope="module")
def surfaces(setup, planes):
    """The same queries on the 1x1x2 plane and the one-process plane."""
    one = json.loads(planes["one"].stdout.readline())["listening"]
    urls = {"mesh": planes["surface"].url, "one": one}
    program = [{ep: 2 for ep in setup["endpoints"][:2]}] * 30
    doubled = [{ep: 4 for ep in setup["endpoints"][:2]}] * 30
    out = {}
    for name, url in urls.items():
        miss = http(url + "/v1/whatif", {"expected_traffic": program})
        wait_health(url, lambda h: h["surface"]["builds"] >= 1,
                    "a built surface")
        hit = http(url + "/v1/whatif", {"expected_traffic": doubled})
        query = surface_query(url, setup["endpoints"], factor=3)

        def swept(h):
            return (h.get("quality") or {}).get("sweeps", 0) >= 1

        wait_health(url, swept, "a verdict sweep")
        time.sleep(1.0)                      # the tail is read whole
        out[name] = {"miss": miss, "hit": hit, "query": query,
                     "verdict": http(url + "/v1/verdict"),
                     "health": http(url + "/healthz")[1]}
    return out


def test_surface_answers_within_1e5_of_the_one_process_service(surfaces):
    mesh, one = surfaces["mesh"], surfaces["one"]
    for key in ("miss", "hit", "query"):
        assert mesh[key][0] == one[key][0] == 200, (key, mesh[key])
    assert mesh["miss"][1]["surface"] == {"hit": False}
    assert_scaled(mesh["miss"][1]["estimates"], one["miss"][1]["estimates"])
    got, want = mesh["hit"][1], one["hit"][1]
    assert got["surface"]["hit"] is True
    assert_scaled(got["estimates"], want["estimates"])
    got, want = mesh["query"][1], one["query"][1]
    assert_scaled(got["peaks"], want["peaks"])
    for meta in ("hit", "params_hash", "space", "scales"):
        assert got["surface"].get(meta) == want["surface"].get(meta), meta
    digest = one["health"]["fleet"]["tenants"]["default"]["params_digest"]
    assert got["surface"]["params_hash"] == digest + ":int8"
    assert mesh["health"]["fleet"]["tenants"]["default"][
        "params_digest"] == digest


def test_verdict_within_1e5_of_the_one_process_service(surfaces):
    (status, got), (status_one, want) = (surfaces["mesh"]["verdict"],
                                         surfaces["one"]["verdict"])
    assert status == status_one == 200
    assert got["sweeps"] == want["sweeps"] >= 1
    assert got["states"] == want["states"]
    parity_got, parity_want = got.pop("quant_parity"), want.pop(
        "quant_parity")
    assert parity_got["mode"] == parity_want["mode"] == "int8"
    assert sorted(parity_got["measured"]) == sorted(parity_want["measured"])
    assert_scaled(got, want)
