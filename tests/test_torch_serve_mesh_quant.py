"""Quantized serving on a multi-rank ``serve --mesh``, on the CPU under
gloo (deeprest_tpu_torch/ops/quantize.py, serve/predictor.py,
serve/mesh_front.py).

The model and corpus are tests/test_torch_serve_mesh.py's (F=64, E=8,
H=8).  Each plane or job reads its own copy of the checkpoint, so each
measures and writes its own parity envelope.

- A spawned gloo job of two ranks quantizes the checkpoint on 1x2x1 and
  1x1x2 in int8 and bf16: every rank's int8 data and f32 scales (bf16
  leaves) are bit for bit its box of the one-process ``quantize_params``,
  the digest is the one-process quantized predictor's, and rank 0 alone
  writes the envelope file.
- The int8 planes on 1x2x1 and 1x1x2 and a bf16 plane on 1x1x2 (``--no-
  batcher``) answer ``/v1/predict``, ``/v1/whatif`` and ``/v1/anomaly``
  within 1e-5 of scale of JAX's ``Predictor.from_checkpoint(mesh_config=
  ..., quant=...)`` through its own ``PredictionService`` on conftest's 8
  host devices, and ``/healthz`` names the one-process quantized digest.
- The 1x1x2 int8 plane also listens on ``--verdict-wire-listen``: only
  rank 0 binds that port.
- A plane whose stored budget is a quarter of the measured envelope exits
  nonzero on every rank, none left waiting in a collective.
- ``predict --mesh 1,1,2 --quant int8`` as two ``env://`` processes writes
  what one process writes, from rank 0 alone.

Every wait on a process and every HTTP call has a timeout, and every
process started here is killed at the end of its test or module.
"""

import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_serve_mesh import (
    DROPPED, MESHES, METHODS, REPO, TIMEOUT, Plane, assert_scaled, http,
    jax_buckets, mix_program, write_port_checkpoint,
)
from test_torch_whatif import W, simulated_corpus

import test_torch_parallel_support as parallel_support
import test_torch_serve_mesh_support as support
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.data.featurize import featurize_buckets
from deeprest_tpu_torch.data.schema import save_raw_data_jsonl
from deeprest_tpu_torch.models.qrnn import param_shapes
from deeprest_tpu_torch.ops.quantize import QuantTensor, quantize_params
from deeprest_tpu_torch.parallel.mesh import Mesh
from deeprest_tpu_torch.parallel.sharding import box_slices, rank_box, spec_of
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train.checkpoint import load_params

# (mesh, quant mode) of each plane
PLANES = {"int8-1x2x1": ("1x2x1", "int8"), "int8-1x1x2": ("1x1x2", "int8"),
          "bf16-1x1x2": ("1x1x2", "bf16")}
JOB_CASES = [(m, q) for m in ("1x2x1", "1x1x2") for q in ("int8", "bf16")]
ROUTES = {"predict": "/v1/predict", "whatif": "/v1/whatif",
          "anomaly": "/v1/anomaly"}


def copy_ckpt(ckpt, wd, name):
    """A private copy of the checkpoint directory (no envelope in it)."""
    dst = str(wd / name)
    shutil.copytree(ckpt, dst)
    return dst


def build_setup(wd):
    """The corpus, the checkpoint and the payloads of a module (its
    ``wd``): tests/test_torch_serve_mesh.py's model."""
    buckets = simulated_corpus(wd / "raw9.jsonl", buckets=40)
    for b in buckets:
        b.metrics = [m for m in b.metrics
                     if f"{m.component}_{m.resource}" != DROPPED]
    raw = str(wd / "raw.jsonl")
    save_raw_data_jsonl(buckets, raw)
    ckpt = write_port_checkpoint(wd / "ckpt", raw)
    space = Predictor.from_checkpoint(ckpt, device="cpu").space()
    data = featurize_buckets(support.load_buckets(raw), space=space)
    endpoints = JaxSynth(JaxPredictor.from_checkpoint(ckpt).space()).fit(
        jax_buckets(raw)).endpoints
    payloads = {
        "predict": {"traffic": data.traffic[:3 * W + 5].tolist()},
        "whatif": {"expected_traffic": mix_program(endpoints, 2 * W + 3),
                   "seed": 1},
        "anomaly": {"traffic": data.traffic.tolist(),
                    "observed": data.targets().tolist(), "tolerance": 0.05,
                    "min_run": 2},
    }
    return dict(wd=wd, ckpt=ckpt, raw=raw, payloads=payloads,
                endpoints=endpoints)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(tmp_path_factory.mktemp("serve_mesh_quant"))


@pytest.fixture(scope="module")
def one_process(setup):
    """The one-process quantized predictor of each mode (its digest)."""
    return {q: Predictor.from_checkpoint(
        copy_ckpt(setup["ckpt"], setup["wd"], f"one_{q}"), device="cpu",
        quant=q) for q in ("int8", "bf16")}


@pytest.fixture(scope="module")
def planes(setup, one_process):
    """The three quantized planes and the quarter-budget plane, started
    together; the 1x1x2 int8 plane listens on the verdict wire too."""
    wd = setup["wd"]
    bad = copy_ckpt(setup["ckpt"], wd, "quarter")
    Predictor.from_checkpoint(bad, device="cpu", quant="int8")
    env_path = os.path.join(bad, "quant_parity_int8.json")
    with open(env_path) as fh:
        envelope = json.load(fh)
    envelope["budget"] = {k: v / 4 for k, v in envelope["measured"].items()}
    with open(env_path, "w") as fh:
        json.dump(envelope, fh)
    started = {}
    for name, (mesh, quant) in PLANES.items():
        extra = (["--verdict-wire-listen", "127.0.0.1:0"]
                 if name == "int8-1x1x2" else [])
        started[name] = Plane(
            wd, name, mesh, {"ckpt": copy_ckpt(setup["ckpt"], wd, name),
                             "raw": setup["raw"]},
            "--no-batcher", "--quant", quant, *extra)
    started["quarter"] = Plane(wd, "quarter", "1x2x1",
                               {"ckpt": bad, "raw": setup["raw"]},
                               "--no-batcher", "--quant", "int8")
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
    out = {}
    for name in PLANES:
        url = planes[name].url
        out[name] = {}
        for route, path in ROUTES.items():
            status, body = http(url + path, setup["payloads"][route])
            assert status == 200, (name, route, body)
            out[name][route] = body
    return out


@pytest.fixture(scope="module")
def jax_answers(setup):
    """JAX's quantized mesh Predictor through its own PredictionService,
    each plane's (mesh, mode), on its own copy of the checkpoint."""
    out = {}
    buckets = jax_buckets(setup["raw"])
    for name, (mesh, quant) in PLANES.items():
        pred = JaxPredictor.from_checkpoint(
            copy_ckpt(setup["ckpt"], setup["wd"], f"jax_{name}"),
            mesh_config=JaxMeshConfig(*MESHES[mesh]), quant=quant)
        svc = JaxService(pred, JaxSynth(pred.space()).fit(buckets))
        try:
            out[name] = {route: getattr(svc, METHODS[route])(payload)
                         for route, payload in setup["payloads"].items()}
        finally:
            svc.close()
    return out


@pytest.fixture(scope="module")
def job(setup):
    """The spawned gloo job's leaves, digests and envelope writes."""
    wd = setup["wd"] / "quant_job"
    wd.mkdir()
    cases = {f"{q}-{m}": (MESHES[m], q,
                          copy_ckpt(setup["ckpt"], wd, f"ckpt_{q}_{m}"))
             for m, q in JOB_CASES}
    with open(wd / "spec.json", "w") as fh:
        json.dump({"cases": cases}, fh)
    ctx = multiprocessing.get_context("spawn")
    port = parallel_support.free_port()
    procs = [ctx.Process(target=support.quant_rank,
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
    assert [p.exitcode for p in procs] == [0, 0], (
        (wd / "quant0.log").read_text()[-3000:],
        (wd / "quant1.log").read_text()[-3000:])
    ranks = []
    for r in range(2):
        with open(wd / f"quant{r}.json") as fh:
            ranks.append(json.load(fh))
    return dict(wd=wd, cases=cases, ranks=ranks)


# -- the quantized shards and the digest ----------------------------------

@pytest.mark.parametrize("mesh,quant", JOB_CASES)
def test_rank_leaves_are_bit_for_bit_the_one_process_quantization(
        setup, job, mesh, quant):
    """Every rank's stored leaves are its box of the one-process
    ``quantize_params``: int8 data, f32 scales (the weight's box with the
    contraction dimension whole), bf16 bits and the f32 leaves."""
    whole = load_params(setup["ckpt"])
    want = quantize_params(whole, quant)
    shapes = param_shapes(Predictor.from_checkpoint(
        setup["ckpt"], device="cpu").model_config)
    case = f"{quant}-{mesh}"
    for r in range(2):
        m = Mesh(MeshConfig(*MESHES[mesh]), r, torch.device("cpu"))
        with np.load(job["wd"] / f"{case}.rank{r}.npz") as z:
            got = dict(z)
        assert len(got) == sum(2 if isinstance(v, QuantTensor) else 1
                               for v in want.values())
        for name, leaf in want.items():
            spec = spec_of(name, shapes[name])
            box = box_slices(rank_box(m, spec, shapes[name], name))
            if isinstance(leaf, QuantTensor):
                k = len(shapes[name]) - 2
                scale_box = tuple(slice(None) if d == k else b
                                  for d, b in enumerate(box))
                assert np.array_equal(got[f"{name}.data"],
                                      leaf.data[box].numpy()), (case, name)
                assert got[f"{name}.scale"].dtype == np.float32
                assert np.array_equal(got[f"{name}.scale"],
                                      leaf.scale[scale_box].numpy()), (
                    case, name)
            elif leaf.dtype == torch.bfloat16:
                assert np.array_equal(
                    got[name], leaf[box].view(torch.int16).numpy()), (
                    case, name)
            else:
                assert np.array_equal(got[name], leaf[box].numpy()), (
                    case, name)


@pytest.mark.parametrize("mesh,quant", JOB_CASES)
def test_digest_is_the_one_process_quantized_digest(job, one_process, mesh,
                                                    quant):
    case = f"{quant}-{mesh}"
    want = one_process[quant].params_digest()
    assert [r["digests"][case] for r in job["ranks"]] == [want, want]


def test_rank_0_alone_writes_the_envelope(job):
    assert job["ranks"][1]["writes"] == []
    paths = job["ranks"][0]["writes"]
    assert sorted(paths) == sorted(
        os.path.join(ckpt, f"quant_parity_{quant}.json")
        for _, quant, ckpt in job["cases"].values())
    for _, quant, ckpt in job["cases"].values():
        with open(os.path.join(ckpt, f"quant_parity_{quant}.json")) as fh:
            envelope = json.load(fh)
        assert envelope["mode"] == quant and envelope["step"] == 0
        assert len(envelope["measured"]) == 8 * 3


# -- the planes --------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(PLANES))
def test_quantized_plane_within_1e5_of_jax_mesh_predictor(
        answers, jax_answers, name, route):
    assert_scaled(answers[name][route], jax_answers[name][route])


@pytest.mark.parametrize("name", list(PLANES))
def test_plane_healthz_names_the_quant_mode_and_digest(planes, answers,
                                                       one_process, name):
    mesh, quant = PLANES[name]
    line = planes[name].listening()
    assert line["quant"] == quant and line["quant_parity_max"] > 0
    assert line["mesh"] == list(MESHES[mesh]) and line["world"] == 2
    status, health = http(planes[name].url + "/healthz")
    assert status == 200 and health["quant"]["mode"] == quant
    tenant = health["fleet"]["tenants"]["default"]
    assert tenant["params_digest"] == one_process[quant].params_digest()
    assert health["mesh"]["step"] == 0 and health["mesh"]["error"] is None


def _listening_inodes(port: int) -> set:
    """Socket inodes in LISTEN on TCP ``port`` (any address)."""
    out = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        if not os.path.exists(table):
            continue
        with open(table) as fh:
            next(fh)
            for row in fh:
                cols = row.split()
                if (int(cols[1].rsplit(":", 1)[1], 16) == port
                        and cols[3] == "0A"):
                    out.add(int(cols[9]))
    return out


def _socket_inodes(pid: int) -> set:
    out = set()
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("socket:["):
            out.add(int(target[8:-1]))
    return out


def test_only_rank_0_binds_the_verdict_wire(planes, answers):
    plane = planes["int8-1x1x2"]
    wire = plane.listening()["verdict"]["wire"]
    port = int(wire.rsplit(":", 1)[1])
    listening = _listening_inodes(port)
    assert listening, f"nothing listens on the wire port {port}"
    assert listening <= _socket_inodes(plane.procs[0].pid)
    assert not listening & _socket_inodes(plane.procs[1].pid)
    health = http(plane.url + "/healthz")[1]
    assert health["wire"] is not None
    assert plane.text(1).splitlines() == [
        "distributed: process 1 of 2, 2 global devices (gloo)"]


def test_quarter_budget_fails_every_rank(planes):
    """Both ranks measure the envelope over the stored budget and exit
    nonzero (each waits bounded); neither listens."""
    plane = planes["quarter"]
    codes = plane.wait()
    assert all(c != 0 for c in codes), codes
    for r in range(2):
        assert "stored parity envelope" in plane.text(r, "err"), (
            plane.text(r, "err")[-2000:])
    assert '{"listening"' not in plane.text(0)


def test_predict_cli_quantized_on_two_processes(setup, tmp_path):
    """``predict --mesh 1,1,2 --quant int8`` as two ``env://`` processes
    writes, from rank 0 alone, what one process's ``predict --quant int8``
    writes (within 1e-5 of scale), and rank 0 stores the envelope."""
    args = ["predict", "--raw", setup["raw"], "--quant", "int8", "--device",
            "cpu"]
    mesh_ckpt = copy_ckpt(setup["ckpt"], tmp_path, "mesh_ckpt")
    port = parallel_support.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeprest_tpu_torch", *args, "--ckpt-dir",
             mesh_ckpt, "--mesh", "1,1,2", "--out",
             str(tmp_path / f"mesh{rank}.npz")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1][0].strip().splitlines() == [
        "distributed: process 1 of 2, 2 global devices (gloo)"]
    assert not (tmp_path / "mesh1.npz").exists()
    assert os.path.exists(os.path.join(mesh_ckpt, "quant_parity_int8.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch", *args, "--ckpt-dir",
         copy_ckpt(setup["ckpt"], tmp_path, "one_ckpt"), "--out",
         str(tmp_path / "one.npz")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    with np.load(tmp_path / "mesh0.npz") as a, \
            np.load(tmp_path / "one.npz") as b:
        np.testing.assert_array_equal(a["metric_names"], b["metric_names"])
        scale = np.abs(b["predictions"]).max()
        assert np.abs(a["predictions"] - b["predictions"]).max() \
            <= 1e-5 * scale
