"""The fleet's AOT sidecar on a mesh (deeprest_tpu_torch/serve/aot.py):
a manifest written on one device verifies at a mesh plane's admission.

The checkpoint is tests/test_torch_aot_mesh_support.py's (F=8, E=4, H=8,
W=8, one delta metric), written once per module, with a copy for each
quant mode and one with no sidecar.

- One device: the params-tree hash is bit for bit the formula the port
  used before it hashed global shapes (each bound weight leaf's name,
  shape as held and dtype), f32 and int8, on a predictor and its plane.
- A spawned gloo job of two ranks admits the checkpoint as the fleet's
  mesh ``default`` on 1x2x1 and 1x1x2, f32 and int8: each rank holds
  boxes of the weights, its plane's whole ``engine_fingerprint`` is the
  one-device export's, and the pool's ``aot.last_reason`` reads
  ``manifest verified``; with no manifest it reads ``no artifacts``.
- JAX on conftest's host devices: its ``params_tree`` on 1x2x1 and 1x1x2
  is its one-device one, and with no manifest it says ``no artifacts``.

About 20 s alone.
"""

import hashlib
import json
import multiprocessing
import os
import shutil

import pytest

import test_torch_aot_mesh_support as support
import test_torch_parallel_support as parallel_support
from deeprest_tpu.config import MeshConfig as JaxMeshConfig
from deeprest_tpu.serve import aot as jax_aot
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu_torch.serve.aot import engine_fingerprint
from deeprest_tpu_torch.serve.export import export_aot_sidecar
from deeprest_tpu_torch.serve.predictor import Predictor

MESHES = {"1x2x1": (1, 2, 1), "1x1x2": (1, 1, 2)}
QUANTS = ("off", "int8")
JOB_TIMEOUT = 180


def held_shape_signature(predictor) -> str:
    """The params-tree hash as the port computed it before it hashed
    global shapes: the bound weight leaves' names, shapes as held on this
    rank, and dtypes."""
    h = hashlib.sha1()
    for name, t in sorted(predictor.bound_state().items()):
        if name.startswith("w."):
            h.update(str((name, tuple(t.shape), str(t.dtype))).encode())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The checkpoint's copies: one per quant mode with the one-device
    export's sidecar (its fingerprint kept), and one with none."""
    wd = tmp_path_factory.mktemp("aot_mesh")
    base = support.write_checkpoint(wd / "base")
    out = {"wd": wd, "ckpt": {}, "exported": {}}
    for quant in QUANTS:
        ckpt = str(wd / quant)
        shutil.copytree(base, ckpt)
        one = Predictor.from_checkpoint(ckpt, device="cpu", quant=quant)
        export_aot_sidecar(one, ckpt)
        with open(os.path.join(ckpt, "aot", "manifest.json")) as fh:
            out["exported"][quant] = json.load(fh)["fingerprint"]
        out["ckpt"][quant] = ckpt
    out["bare"] = str(wd / "bare")
    shutil.copytree(base, out["bare"])
    return out


@pytest.fixture(scope="module")
def job(setup):
    """Each rank's fingerprints, reasons and held shapes, by case."""
    wd = setup["wd"] / "job"
    wd.mkdir()
    cases = {f"{m}-{q}": [MESHES[m], q, setup["ckpt"][q]]
             for m in MESHES for q in QUANTS}
    cases["1x2x1-bare"] = [MESHES["1x2x1"], "off", setup["bare"]]
    with open(wd / "spec.json", "w") as fh:
        json.dump({"cases": cases}, fh)
    ctx = multiprocessing.get_context("spawn")
    port = parallel_support.free_port()
    procs = [ctx.Process(target=support.aot_rank, args=(r, 2, port, str(wd)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOB_TIMEOUT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0], f"see {wd}/aot*.log"
    ranks = []
    for r in range(2):
        with open(wd / f"aot{r}.json") as fh:
            ranks.append(json.load(fh))
    return ranks


@pytest.mark.parametrize("quant", QUANTS)
def test_one_device_hash_is_bit_equal_to_the_held_shape_formula(setup,
                                                                quant):
    pred = Predictor.from_checkpoint(setup["ckpt"][quant], device="cpu",
                                     quant=quant)
    plane = pred.fleet_plane()
    for p in (pred, plane):
        assert engine_fingerprint(p)["params_tree"] == \
            held_shape_signature(p)
    assert setup["exported"][quant]["params_tree"] == \
        held_shape_signature(pred)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("quant", QUANTS)
def test_mesh_plane_verifies_the_one_device_sidecar(setup, job, mesh,
                                                    quant):
    want = setup["exported"][quant]
    one_shapes = {k: list(t.shape) for k, t in Predictor.from_checkpoint(
        setup["ckpt"][quant], device="cpu",
        quant=quant).bound_state().items() if k.startswith("w.")}
    for rank in job:
        got = rank[f"{mesh}-{quant}"]
        # each rank holds boxes of the leaves, not the whole of them
        assert sorted(got["shapes"]) == sorted(one_shapes)
        assert got["shapes"] != one_shapes
        assert got["fingerprint"] == want
        assert got["reason"].startswith("manifest verified"), got["reason"]


def test_mesh_plane_with_no_manifest_says_no_artifacts(job):
    assert [r["1x2x1-bare"]["reason"] for r in job] == ["no artifacts"] * 2


@pytest.fixture(scope="module")
def jax_predictors(setup):
    ckpt = setup["ckpt"]["off"]
    out = {"one": JaxPredictor.from_checkpoint(ckpt)}
    for name, shape in MESHES.items():
        out[name] = JaxPredictor.from_checkpoint(
            ckpt, mesh_config=JaxMeshConfig(*shape))
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_jax_hashes_the_same_tree_on_its_mesh(jax_predictors, mesh):
    one = jax_aot.engine_fingerprint(jax_predictors["one"])
    got = jax_aot.engine_fingerprint(jax_predictors[mesh])
    assert got["params_tree"] == one["params_tree"]
    assert got == one


def test_jax_with_no_manifest_says_no_artifacts(setup, jax_predictors):
    res = jax_aot.load_aot(jax_predictors["1x2x1"], setup["bare"])
    assert res["reason"] == "no artifacts"
