"""The port's what-if demo (``deeprest_tpu_torch/demo/``) against the JAX
package's (``deeprest_tpu/demo/``), on the CPU.

One checkpoint, written by the port's ``train`` on the CPU from 60
simulated minutes (hidden 8, window 12, as ``tests/test_demo.py`` sets it
up through the JAX CLI from 120), is read by both packages' ``Predictor``
and both ``precompute_results`` run on the same 30-tick grid (25 base
users, a quarter of the default, to keep the host simulation short):

- ``calls``, ``groundtruth``, ``resrc``, ``comp``, ``observed``, the
  metadata and the dataset keys are equal (the host simulation and
  baselines are the same code with the same seeds);
- ``ours``, ``ours_lo`` and ``ours_hi`` agree within 1e-5 (the model's
  f32 estimates, rounded to 5 decimals by both);
- the port's ``ResultsStore`` round-trips its saved artifact and builds
  JAX's panels; its ``DemoServer`` answers JAX's routes with JAX's JSON;
- ``python -m deeprest_tpu_torch.demo precompute --device cpu`` writes the
  artifact and reports its datasets and device.
"""

import functools
import http.client
import json

import numpy as np
import pytest

from deeprest_tpu.data.featurize import featurize_buckets as jax_featurize
from deeprest_tpu.data.schema import iter_raw_data_jsonl
from deeprest_tpu.demo.precompute import DemoConfig as JaxDemoConfig
from deeprest_tpu.demo.precompute import \
    precompute_results as jax_precompute_results
from deeprest_tpu.demo.results import ResultsStore as JaxResultsStore
from deeprest_tpu.demo.server import DemoServer as JaxDemoServer
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu_torch import cli
from deeprest_tpu_torch.data.featurize import featurize_buckets
from deeprest_tpu_torch.demo import __main__ as demo_main
from deeprest_tpu_torch.demo.precompute import (
    DemoConfig, dataset_name, precompute_results, save_results,
)
from deeprest_tpu_torch.demo.results import ResultsStore
from deeprest_tpu_torch.demo.server import DemoServer
from deeprest_tpu_torch.serve.predictor import Predictor

TICKS = 30
WINDOW = 12
GRID = dict(shapes=("waves", "flat"), multipliers=(1, 2),
            seen=((0.2, 0.5, 0.25), (0.3, 0.4, 0.25)),
            unseen=((0.6, 0.2, 0.15),), ticks=TICKS, base_users=25.0,
            components=("nginx-thrift", "post-storage-mongodb"))
OURS = ("ours", "ours_lo", "ours_hi")


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    raw = str(root / "raw.jsonl")
    ckpt = str(root / "ckpt")
    assert cli.main(["simulate", "--scenario", "normal", "--ticks", "60",
                     "--out", raw]) == 0
    assert cli.main(["train", "--raw", raw, "--epochs", "1",
                     "--batch-size", "16", "--window", str(WINDOW),
                     "--hidden-size", "8", "--dropout", "0.1",
                     "--no-baselines", "--ckpt-dir", ckpt, "--round-to", "8",
                     "--device", "cpu"]) == 0
    port_pred = Predictor.from_checkpoint(ckpt, device="cpu")
    buckets = cli._load_buckets(raw)
    port = precompute_results(
        port_pred, featurize_buckets(buckets, space=port_pred.space()),
        buckets, DemoConfig(**GRID))
    jax_pred = JaxPredictor.from_checkpoint(ckpt)
    jbuckets = list(iter_raw_data_jsonl(raw))
    jax = jax_precompute_results(
        jax_pred, jax_featurize(jbuckets, space=jax_pred.space()), jbuckets,
        JaxDemoConfig(**GRID))
    path = save_results(port, str(root / "results.json.gz"))
    return {"port": port, "jax": jax, "path": path, "raw": raw,
            "ckpt": ckpt, "root": root}


def test_precompute_matches_jax(demo):
    port, jax = demo["port"], demo["jax"]
    assert port["meta"] == jax["meta"]
    assert sorted(port["datasets"]) == sorted(jax["datasets"])
    assert len(port["datasets"]) == 8
    for key, ds in jax["datasets"].items():
        got = port["datasets"][key]
        assert got["calls"] == ds["calls"], key
        assert {k: got[k] for k in ("shape", "multiplier", "group", "index",
                                    "composition")} == \
            {k: ds[k] for k in ("shape", "multiplier", "group", "index",
                                "composition")}
        assert got["components"].keys() == ds["components"].keys()
        for comp, resources in ds["components"].items():
            assert got["components"][comp].keys() == resources.keys()
            for res, rec in resources.items():
                mine = got["components"][comp][res]
                assert mine.keys() == rec.keys()
                for series in ("groundtruth", "resrc", "comp", "observed"):
                    assert mine[series] == rec[series], (key, comp, res,
                                                         series)
                for series in OURS:
                    np.testing.assert_allclose(mine[series], rec[series],
                                               rtol=1e-5, atol=1e-5)
                for method, value in rec["scale"].items():
                    np.testing.assert_allclose(mine["scale"][method], value,
                                               rtol=1e-5, atol=1e-5)


def test_store_round_trips_and_builds_jax_panels(demo):
    store = ResultsStore.load(demo["path"])
    assert store.results == json.loads(json.dumps(demo["port"]))
    want = JaxResultsStore(json.loads(json.dumps(demo["port"])))
    assert store.options_shape() == want.options_shape()
    for shape in ("waves", "flat"):
        assert store.options_multiplier(shape) == \
            want.options_multiplier(shape)
        assert store.options_composition(shape) == \
            want.options_composition(shape)
    assert store.panel("waves", 2, "unseen", 0) == \
        want.panel("waves", 2, "unseen", 0)
    with pytest.raises(KeyError, match="no dataset"):
        store.dataset("waves", 3, "seen", 0)


def _get(server, path):
    host, port = server.address
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_server_answers_jax_routes(demo):
    store = ResultsStore.load(demo["path"])
    servers = [DemoServer(store, port=0).start_background(),
               JaxDemoServer(JaxResultsStore.load(demo["path"]),
                             port=0).start_background()]
    try:
        answers = []
        for server in servers:
            got = {}
            for path in ("/", "/api/meta",
                         "/api/panel?shape=waves&multiplier=1&group=seen"
                         "&index=1",
                         "/api/panel?shape=flat&multiplier=9&group=seen"
                         "&index=0",
                         "/api/nothing"):
                status, body = _get(server, path)
                got[path] = (status, body if path == "/"
                             else json.loads(body))
            answers.append(got)
        port, jax = answers
        assert port == jax
        assert port["/"][0] == 200 and b"what-if" in port["/"][1]
        panel = port["/api/panel?shape=waves&multiplier=1&group=seen&index=1"]
        assert panel[0] == 200 and panel[1]["composition"] == [0.3, 0.4, 0.25]
        assert panel[1]["key"] == dataset_name("waves", 1, "seen", 1)
        assert port["/api/nothing"][0] == 404
        assert port["/api/panel?shape=flat&multiplier=9&group=seen"
                    "&index=0"][0] == 400
    finally:
        for server in servers:
            server.stop()


def test_precompute_cli_on_the_cpu(demo, capsys, monkeypatch):
    """The quick grid at 5 users a tick, so the host simulation is short."""
    from deeprest_tpu_torch.demo import precompute

    monkeypatch.setattr(precompute, "DemoConfig", functools.partial(
        DemoConfig, base_users=5.0))
    out = str(demo["root"] / "cli.json")
    assert demo_main.main(["precompute", "--raw", demo["raw"], "--ckpt-dir",
                           demo["ckpt"], "--out", out, "--ticks", "13",
                           "--quick", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["out"] == out
    store = ResultsStore.load(out)
    assert line["datasets"] == len(store.datasets) == 2 * (9 + len(
        store.meta["compositions"]["unseen"]))
    assert store.meta["ticks"] == 13 and store.meta["multipliers"] == [1, 3]
