"""The replica router, admission, tenant weights, the autoscaler and the
fleet tier on a multi-rank ``serve --mesh``, on the CPU under gloo, held
against JAX's ``serve`` layout on the same mesh (serve/router.py,
serve/replica.py ``clone_backend``, serve/fleet.py, serve/mesh_front.py).

The model and corpus are tests/test_torch_serve_mesh.py's (F=64, E=8,
H=8); the fleet's other tenants are its checkpoint's params scaled.  The
planes are two ``env://`` processes a plane, started together once per
module; JAX runs in this process on conftest's 8 host devices.

- Admission and tenant weights (``--admission-depth 1
  --admission-wait-ms 0 --tenant-weights default=3,t1=1``) on 1x2x1: the
  answers within 1e-5 of scale of JAX's mesh ``Predictor``; a burst of
  clients gets 429 with ``Retry-After`` for the ones shed, and the
  mirrored calls count the answered requests alone; ``/healthz`` keeps
  its ``mesh`` block behind the router.  (``/healthz`` waits for a device
  call in flight, so the grant order is read in the gloo job below.)
- Thread replicas on 1x1x2 (a spawned gloo job,
  tests/test_torch_serve_mesh_plane_support.py): a router with two device
  keys clones the mesh predictor through ``GATHER``; the clone answers
  within 1e-5 of scale of JAX's clone on ``jax.devices()[1]``, and
  ``scale_to`` down and up keeps the mesh stack and makes fresh clones;
  a rolling reload clones step 1.  A pool at budget 1 spills and
  restores the mesh ``default`` on both ranks.  A weighted router at
  depth 1 over the mesh predictor grants a ``default`` waiter before an earlier ``t1`` one
  and sheds a third.  Rank 1 runs as many sharded forwards as rank 0 and
  no one-device forward.
- Process replicas on 1x2x1: each worker serves a one-device predictor,
  within 1e-5 of scale of JAX's one-device one, and no call is mirrored.
- The fleet on 1x1x2 with budget 1: ``default`` (the mesh predictor) and
  two one-device tenants within 1e-5 of scale of JAX's pool on the same
  mesh; ``default`` spilled and restored on every rank with its answer
  unchanged; the pool's graph count flat from the second one-device
  tenant on.
- ``--watch`` with ``--replicas 2``: steps 1 and 2 written back to back;
  after each swap every rank holds only the served generation.
- The JAX CLI's own refusals on the new flags exit on a mesh as on one
  device (tests/test_torch_serve_mesh.py).

Every wait on a process and every HTTP call has a timeout, and every
process started here is killed at the end of its test or module.
"""

import json
import multiprocessing
import os
import shutil
import signal
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_torch_serve_mesh import TIMEOUT, Plane, assert_scaled, http
from test_torch_serve_mesh_quant import build_setup

import test_torch_parallel_support as parallel_support
import test_torch_serve_mesh_plane_support as support
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.serve.fleet import PredictorPool as JaxPool
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.replica import clone_backend as jax_clone_backend
from deeprest_tpu_torch.train.checkpoint import (
    load_leaves, load_sidecar, save_checkpoint,
)

TENANTS = {"t1": 1.3, "t2": 0.8}     # the fleet's tenants: params x this
WATCH_SCALES = {1: 1.1, 2: 1.2}      # the watched plane's newer steps
BURST = 8                            # concurrent clients at depth 1
BURST_SERIES = 20                    # each burst request: this many series


def write_scaled(directory, base, scale, step=0):
    """``base``'s step 0 (a whole TrainState) with every param x
    ``scale``, saved as step ``step`` of ``directory``."""
    leaves = load_leaves(base, 0)
    params = {k[len("params/"):]: v * scale
              for k, v in leaves.items() if k.startswith("params/")}
    other = {k: v for k, v in leaves.items() if not k.startswith("params/")}
    other["step"] = torch.tensor(step, dtype=other["step"].dtype)
    return save_checkpoint(str(directory), params, step,
                           extra=load_sidecar(base, 0), other_leaves=other)


def post(url, payload, tenant=None, timeout=TIMEOUT):
    """(status, body, headers) of one POST (``payload`` a dict, or its
    JSON bytes), with ``X-Tenant``."""
    data = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, method="POST")
    if tenant is not None:
        req.add_header("X-Tenant", tenant)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve_mesh_plane")
    out = build_setup(wd)
    for name, scale in TENANTS.items():
        out[name] = str(wd / name)
        write_scaled(out[name], out["ckpt"], scale)
    out["watched"] = str(wd / "watched")
    shutil.copytree(out["ckpt"], out["watched"])
    out["stepped"] = str(wd / "stepped")
    shutil.copytree(out["ckpt"], out["stepped"])
    write_scaled(out["stepped"], out["ckpt"], WATCH_SCALES[1], step=1)
    traffic = np.asarray(out["payloads"]["predict"]["traffic"], np.float32)
    out["traffic"] = traffic
    out["burst"] = json.dumps({"traffic": np.tile(
        traffic, (BURST_SERIES, 1)).tolist()}).encode()
    return out


@pytest.fixture(scope="module")
def planes(setup):
    """The module's planes, started together, and the replica job."""
    wd = setup["wd"]
    fleet = [f"--fleet={t}={setup[t]}" for t in TENANTS]
    started = {
        "admit": Plane(wd, "admit", "1x2x1", setup, "--no-batcher",
                       "--admission-depth", "1", "--admission-wait-ms", "0",
                       "--tenant-weights", "default=3,t1=1"),
        "process": Plane(wd, "process", "1x2x1", setup, "--no-batcher",
                         "--replicas", "2", "--replica-mode", "process"),
        "fleet": Plane(wd, "fleet", "1x1x2", setup, "--no-batcher",
                       "--fleet-hbm-budget", "1", *fleet),
        "watch": Plane(wd, "watch", "1x2x1", dict(setup,
                                                  ckpt=setup["watched"]),
                       "--no-batcher", "--replicas", "2", "--watch", "0.2"),
    }
    job = start_replica_job(setup)
    try:
        yield dict(started, job=job)
    finally:
        for plane in started.values():
            if plane.procs[0].poll() is None:
                plane.procs[0].send_signal(signal.SIGTERM)
        for plane in started.values():
            try:
                plane.wait()
            finally:
                plane.kill()
        for p in job["procs"]:
            if p.is_alive():
                p.kill()
                p.join(10)


def start_replica_job(setup):
    job = setup["wd"] / "replica_job"
    job.mkdir()
    with open(job / "spec.json", "w") as fh:
        json.dump({"ckpt": setup["stepped"],
                   "traffic": setup["traffic"].tolist()}, fh)
    ctx = multiprocessing.get_context("spawn")
    port = parallel_support.free_port()
    procs = [ctx.Process(target=support.replica_rank,
                         args=(r, 2, port, str(job))) for r in range(2)]
    for p in procs:
        p.start()
    return {"dir": job, "procs": procs}


@pytest.fixture(scope="module")
def replica_job(planes):
    job = planes["job"]
    for p in job["procs"]:
        p.join(TIMEOUT)
    assert [p.exitcode for p in job["procs"]] == [0, 0], (
        job["dir"] / "replica0.log").read_text()[-3000:]
    out = {}
    for name in ("replicas", "counts0", "counts1"):
        with open(job["dir"] / f"{name}.json") as fh:
            out[name] = json.load(fh)
    return out


def jax_mesh(ckpt, mesh, step=None):
    return JaxPredictor.from_checkpoint(ckpt, step=step,
                                        mesh_config=JaxMeshConfig(*mesh))


def jax_series(pred, traffic):
    return np.asarray(pred.predict_series(np.asarray(traffic, np.float32)))


# -- admission and tenant weights on 1x2x1 ----------------------------------

def test_admitted_answers_within_1e5_of_jax_mesh_predictor(setup, planes):
    url = planes["admit"].url
    want = jax_series(jax_mesh(setup["ckpt"], (1, 2, 1)), setup["traffic"])
    for tenant in (None, "default", "t1"):
        status, body, _ = post(url + "/v1/predict",
                               setup["payloads"]["predict"], tenant)
        assert status == 200, body
        assert_scaled(body["predictions"], want.tolist())
    health = http(url + "/healthz")[1]
    assert health["router"]["num_replicas"] == 1
    assert health["mesh"]["world"] == 2 and health["mesh"]["error"] is None


def test_a_burst_gets_429_and_only_admitted_calls_are_mirrored(setup,
                                                              planes):
    """``BURST`` clients at once against depth 1 with no wait: the ones
    shed get 429 with ``Retry-After``, decided on rank 0 alone, so the
    mirrored calls count the answered requests only."""
    url = planes["admit"].url
    before = http(url + "/healthz")[1]
    barrier = threading.Barrier(BURST)
    got = [None] * BURST

    def client(i):
        barrier.wait(TIMEOUT)
        got[i] = post(url + "/v1/predict", setup["burst"],
                      ("default", "t1")[i % 2])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(BURST)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    after = http(url + "/healthz")[1]
    answered = [g for g in got if g[0] == 200]
    shed = [g for g in got if g[0] == 429]
    assert len(answered) + len(shed) == BURST and answered and shed
    for _, body, headers in shed:
        assert "Retry-After" in headers and "saturated" in body["error"]
    assert after["mesh"]["calls"] - before["mesh"]["calls"] == len(answered)
    assert after["router"]["admission"]["rejected"] \
        - before["router"]["admission"]["rejected"] == len(shed)
    assert after["router"]["admission"]["tenants"]["t1"]["admitted"] >= 1 \
        or after["router"]["admission"]["tenants"]["default"]["admitted"] >= 1


# -- thread replicas: clones through GATHER, scale_to, a rolling reload ----

def test_clone_through_gather_within_1e5_of_jax_clone(setup, replica_job):
    built = replica_job["replicas"]["build"]
    assert built["stacks"] == ["mesh", "clone"]
    assert built["calls"] == 1          # the mesh stack's call alone
    jp = jax_mesh(setup["stepped"], (1, 1, 2), step=0)
    mesh_want = jax_series(jp, setup["traffic"])
    clone_want = jax_series(jax_clone_backend(jp, device=jax.devices()[1]),
                            setup["traffic"])
    assert_scaled(built["answers"][0], mesh_want.tolist())
    assert_scaled(built["answers"][1], clone_want.tolist())


def test_scale_to_keeps_the_mesh_stack_and_clones_anew(setup, replica_job):
    scaled = replica_job["replicas"]["scaled"]
    assert scaled["1"]["stacks"] == ["mesh"]
    assert scaled["3"]["stacks"] == ["mesh", "clone", "mesh"]
    assert scaled["2"]["stacks"] == ["mesh", "clone"]
    first = replica_job["replicas"]["build"]["answers"][0]
    for n, cell in scaled.items():
        for answer in cell["answers"]:
            assert_scaled(answer, first)
        assert cell["answers"][0] == first, n


def test_rolling_reload_clones_the_fresh_generation(setup, replica_job):
    reloaded = replica_job["replicas"]["reloaded"]
    assert reloaded["stacks"] == ["front", "clone"]
    want = jax_series(jax_mesh(setup["stepped"], (1, 1, 2), step=1),
                      setup["traffic"])
    for answer in reloaded["answers"]:
        assert_scaled(answer, want.tolist())
    assert replica_job["replicas"]["generations"] == {
        "live": [1], "most_on_a_rank": 1, "oldest_on_a_rank": 1}


def test_weights_grant_default_before_an_earlier_t1(replica_job):
    """The mesh router at depth 1 with weights default=3,t1=1: a ``t1``
    waiter queued before a ``default`` one is granted after it (without
    weights, smooth WRR grants the first queued on a tie); a third waiter
    beyond the waiting bound is shed."""
    weighted = replica_job["replicas"]["weighted"]
    assert weighted["order"] == ["default", "t1"]
    assert weighted["shed"].startswith("AdmissionError")
    assert weighted["answer"] == \
        replica_job["replicas"]["reloaded"]["answers"][0]


def test_mesh_tenant_spill_and_restore_move_every_ranks_shards(
        replica_job):
    """``SPILL`` and ``RESTORE`` are mirrored: the follower's bound
    tensors moved as rank 0's did, and ``default`` answers as before."""
    fleet = replica_job["replicas"]["fleet"]
    assert fleet["spills"] == 1 and fleet["restores"] == 1
    assert replica_job["counts0"]["moved"] == fleet["tensors"]
    assert replica_job["counts1"]["moved"] == fleet["tensors"]
    assert fleet["answer"] == replica_job["replicas"]["build"]["answers"][0]


def test_no_one_device_forward_is_mirrored(replica_job):
    rank0, rank1 = replica_job["counts0"], replica_job["counts1"]
    assert rank0["mesh"] == rank1["mesh"] > 0
    assert rank0["one"] > 0 and rank1["one"] == 0


# -- process replicas -----------------------------------------------------

def test_process_workers_serve_one_device_predictors(setup, planes):
    plane = planes["process"]
    line = plane.listening()
    assert line["world"] == 2 and len(line["graphs"]) == 2
    want = jax_series(JaxPredictor.from_checkpoint(setup["ckpt"]),
                      setup["traffic"])
    for _ in range(3):
        status, body, _ = post(plane.url + "/v1/predict",
                               setup["payloads"]["predict"])
        assert status == 200
        assert_scaled(body["predictions"], want.tolist())
    health = http(plane.url + "/healthz")[1]
    assert len(health["router"]["replicas"]) == 2
    assert health["mesh"]["calls"] == 0 and health["mesh"]["error"] is None


# -- the fleet on 1x1x2 ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_fleet(setup):
    """JAX's pool on 1x1x2: the mesh predictor as 'default' and the
    template, each other tenant loaded without a mesh; each tenant's
    answer and the template's executable count after each tenant's
    first answer."""
    pool = JaxPool(hbm_budget=1)
    pool.admit("default", jax_mesh(setup["ckpt"], (1, 1, 2)),
               checkpoint_path=setup["ckpt"])
    for t in TENANTS:
        pool.admit(t, JaxPredictor.from_checkpoint(setup[t]),
                   checkpoint_path=setup[t])
    out, cache = {}, []
    for t in ("default", *TENANTS):
        out[t] = jax_series(pool.resolve(t).predictor(), setup["traffic"])
        cache.append(pool.jit_cache_size())
    return {"answers": out, "cache": cache,
            "reason": pool.stats()["aot"]["last_reason"]}


def test_fleet_tenants_within_1e5_of_jax_pool(setup, planes, jax_fleet):
    url = planes["fleet"].url
    health = http(url + "/healthz")[1]
    line = planes["fleet"].listening()
    assert line["fleet"]["tenants"] == ["default", *TENANTS]
    pool = health["fleet"]["pool"]
    assert pool["aot"]["last_reason"] == jax_fleet["reason"]
    sizes = []
    for t in ("default", *TENANTS, "default"):
        status, body, _ = post(url + "/v1/predict",
                               setup["payloads"]["predict"], t)
        assert status == 200, body
        assert body["tenant"]["name"] == t
        assert_scaled(body["predictions"], jax_fleet["answers"][t].tolist())
        sizes.append(http(url + "/healthz")[1]["fleet"]["pool"][
            "jit_cache_size"])
    # JAX's template: one executable, a second at the first one-device
    # tenant, then flat; the port's planes: the mesh's and one
    # one-device plane's graphs, flat from the start
    assert jax_fleet["cache"][1] == jax_fleet["cache"][2]
    assert sizes[1] == sizes[2] == sizes[3]


def test_fleet_default_spills_and_restores_unchanged(setup, planes):
    url = planes["fleet"].url
    first = post(url + "/v1/predict", setup["payloads"]["predict"],
                 "default")[1]["predictions"]
    for t in ("t1", "default", "t2", "default"):
        status, body, _ = post(url + "/v1/predict",
                               setup["payloads"]["predict"], t)
        assert status == 200
        if t == "default":
            assert body["predictions"] == first
    pool = http(url + "/healthz")[1]["fleet"]["pool"]
    default = pool["per_tenant"]["default"]
    assert default["spills"] >= 2 and default["restores"] >= 2
    assert pool["resident"] == 1 and pool["plane"]["device_plane"]


# -- --watch with --replicas 2 --------------------------------------------

def test_watch_swaps_drop_older_generations_on_every_rank(setup, planes):
    """Steps 1 and 2 written back to back, each once the last is served:
    after each swap (a rolling reload of the router) every rank holds the
    served generation alone, and the plane answers as JAX at the step."""
    url = planes["watch"].url
    for step, scale in WATCH_SCALES.items():
        write_scaled(setup["watched"], setup["ckpt"], scale, step=step)
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            health = http(url + "/healthz")[1]
            if health["router"]["rolling_reloads"] == step and \
                    health["mesh"]["generations"]["live"] == [step]:
                break
            time.sleep(0.05)
        assert health["mesh"]["generations"] == {
            "live": [step], "most_on_a_rank": 1, "oldest_on_a_rank": step}
        assert health["mesh"]["step"] == step
        status, body, _ = post(url + "/v1/predict",
                               setup["payloads"]["predict"])
        assert status == 200
        want = jax_series(jax_mesh(setup["watched"], (1, 2, 1), step=step),
                          setup["traffic"])
        assert_scaled(body["predictions"], want.tolist())
