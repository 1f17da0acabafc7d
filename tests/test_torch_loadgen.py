"""The port's load generator (``deeprest_tpu_torch/loadgen/``) against the
JAX package's, on the CPU.

Everything but the live cluster is held against JAX on the same inputs:
the social graph, the proof of work, the collector and ChaosBurn frames
(raw bytes a stub socket receives), every ``GatewayClient`` request as a
stub HTTP server records it, warmup, the runner's per-user request
sequences, the burner's child and the capture CLI.

The live cases at the end boot ``snsd`` (``native/sns``) and skip where it
is not built, as ``tests/test_loadgen.py``'s do.  Every role but the
collector joins a cpuacct cgroup when the cgroupfs is writable
(``native/sns/main.cpp``), so they belong on a host where that is allowed;
no test here builds ``snsd``.
"""

import collections
import http.server
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np
import pytest

import deeprest_tpu.loadgen as jax_loadgen
import deeprest_tpu.loadgen.__main__ as jax_main
import deeprest_tpu.loadgen.burner as jax_burner
import deeprest_tpu.loadgen.client as jax_client
import deeprest_tpu.loadgen.cluster as jax_cluster
import deeprest_tpu.loadgen.runner as jax_runner
from deeprest_tpu.workload.scenarios import LoadScenario as JaxLoadScenario
import deeprest_tpu_torch.loadgen as port_loadgen
import deeprest_tpu_torch.loadgen.__main__ as port_main
import deeprest_tpu_torch.loadgen.burner as port_burner
import deeprest_tpu_torch.loadgen.client as port_client
import deeprest_tpu_torch.loadgen.cluster as port_cluster
import deeprest_tpu_torch.loadgen.runner as port_runner
from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data.featurize import featurize_buckets
from deeprest_tpu_torch.data.schema import load_raw_data
from deeprest_tpu_torch.loadgen import (
    Burner, GatewayClient, LoadRunner, RunnerConfig, SnsCluster,
    snsd_available, synthetic_social_graph, warmup,
)
from deeprest_tpu_torch.workload.scenarios import LoadScenario
from deeprest_tpu_torch.workload.scenarios import normal_scenario
from deeprest_tpu_torch.workload.topology import API_ENDPOINTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jax_loadgen, "port": port_loadgen}

needs_snsd = pytest.mark.skipif(
    not snsd_available(), reason="snsd not built (make -C native/sns)")


# ---------------------------------------------------------------------------
# Stubs: an HTTP gateway that records every request, a framed socket

class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"      # keep-alive, as the client expects

    def log_message(self, *args):
        pass

    def _serve(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        url = urllib.parse.urlsplit(self.path)
        record = (self.command, url.path, url.query, body,
                  self.headers.get("Content-Type"))
        stub = self.server
        with stub.lock:
            stub.records.append(record)
        status, payload = 200, b'{"ok": true}'
        if any(f in body or f.decode() in url.query for f in stub.fail):
            status, payload = 500, b'{"error": "stub refuses this one"}'
        elif url.path == "/upload-media":
            payload = json.dumps({"media_id": f"m{len(body)}"}).encode()
        elif stub.empty:
            payload = b""
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = _serve


class StubGateway(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.records = []
        self.lock = threading.Lock()
        self.fail = ()          # byte strings: a body or query holding one gets 500
        self.empty = False      # answer 200 with no body
        self.thread = threading.Thread(target=self.serve_forever, daemon=True)
        self.thread.start()

    @property
    def addr(self):
        return self.server_address[:2]

    def take(self):
        with self.lock:
            out, self.records = self.records, []
        return out

    def close(self):
        self.shutdown()
        self.server_close()


@pytest.fixture
def stub():
    server = StubGateway()
    try:
        yield server
    finally:
        server.close()


class FrameServer:
    """Accepts connections and keeps each one's raw bytes; answers a
    length-prefixed frame with ``reply`` when one is given."""

    def __init__(self, reply=None):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.reply = reply
        self.received = []
        self.thread = threading.Thread(target=self._accept, daemon=True)
        self.thread.start()

    @property
    def addr(self):
        return self.sock.getsockname()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                data = b""
                while True:
                    if self.reply is not None and len(data) >= 4 and \
                            len(data) >= 4 + struct.unpack(">I", data[:4])[0]:
                        conn.sendall(struct.pack(">I", len(self.reply))
                                     + self.reply)
                        break
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                self.received.append(data)

    def frames(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.received) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return list(self.received)

    def close(self):
        self.sock.close()


def closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Graph and proof of work

@pytest.mark.parametrize("num_users,attach,seed", [
    (2, 3, 0), (8, 1, 0), (8, 3, 1), (24, 2, 1), (96, 3, 3), (200, 5, 7)])
def test_synthetic_social_graph_matches_jax(num_users, attach, seed):
    want = jax_loadgen.synthetic_social_graph(num_users, attach, seed)
    got = port_loadgen.synthetic_social_graph(num_users, attach, seed)
    assert got.num_users == want.num_users == num_users
    assert got.edges == want.edges
    for u in range(1, num_users + 1):
        assert got.friends(u) == want.friends(u)
        assert got.username(u) == want.username(u)
        assert got.password(u) == want.password(u)
    with pytest.raises(ValueError, match="need at least 2 users"):
        port_loadgen.synthetic_social_graph(1)


def test_graph_is_scale_free():
    g = port_loadgen.synthetic_social_graph(96, seed=3)
    degrees = [len(g.friends(u)) for u in range(1, 97)]
    assert min(degrees) >= 1
    assert max(degrees) >= 3 * int(np.median(degrees))
    assert (1, 2) in g.edges and (2, 1) in g.edges


@pytest.mark.parametrize("header,bits,iters,start", [
    (b"header", 8, 100_000, 0), (b"header", 12, 100_000, 5),
    (b"\x00" * 32, 4, 1000, 77), (b"header", 255, 10, 0)])
def test_proof_of_work_matches_jax(header, bits, iters, start):
    want = jax_burner.proof_of_work(header, bits, iters, start)
    got = port_burner.proof_of_work(header, bits, iters, start)
    assert got == want
    if bits == 255:
        assert got == (-1, b"")                  # exhausted
    else:
        assert got[0] >= start
        assert int.from_bytes(got[1], "big") < 1 << (256 - bits)


# ---------------------------------------------------------------------------
# Frames

def test_register_with_collector_sends_jax_bytes():
    raw = {}
    for name, mod in (("jax", jax_client), ("port", port_client)):
        srv = FrameServer()
        try:
            mod.register_with_collector(*srv.addr, "victim", 4242)
            raw[name] = srv.frames(1)[0]
        finally:
            srv.close()
    assert raw["port"] == raw["jax"]
    (length,) = struct.unpack(">I", raw["port"][:4])
    assert json.loads(raw["port"][4:4 + length]) == {"register": "victim",
                                                     "pid": 4242}


@pytest.mark.parametrize("reply", [
    {"ok": True, "r": {"pid": 31337}}, {"ok": True},
    {"ok": False, "e": "chaos disabled"}])
def test_chaos_burn_frames_and_answers_match_jax(reply):
    raw, answers = {}, {}
    for name, mod in (("jax", jax_client), ("port", port_client)):
        srv = FrameServer(reply=json.dumps(reply).encode())
        try:
            try:
                answers[name] = mod.chaos_burn(*srv.addr, seconds=1.5)
            except RuntimeError as e:
                answers[name] = ("raised", str(e))
            raw[name] = srv.frames(1)[0]
        finally:
            srv.close()
    assert raw["port"] == raw["jax"]
    assert json.loads(raw["port"][4:]) == {
        "m": "ChaosBurn", "t": [0, 0, False], "a": {"seconds": 1.5}}
    assert answers["port"] == answers["jax"]


def test_recv_exact_raises_on_a_closed_socket():
    a, b = socket.socketpair()
    with a, b:
        b.sendall(b"abc")
        b.close()
        with pytest.raises(ConnectionError, match="mid-frame"):
            port_client._recv_exact(a, 4)


# ---------------------------------------------------------------------------
# The HTTP client

CALLS = [
    ("register", (7, "user7", "pw7")),
    ("follow", (7, 9)),
    ("unfollow", (7, 9)),
    ("login", ("user7", "pw 7&x=1")),
    ("compose", (7, "user7", "hello @user9 https://ex.ample/p1")),
    ("compose", (7, "user7", "with media", "m12", "png")),
    ("read_home_timeline", (7,)),
    ("read_home_timeline", (7, 3, 20)),
    ("read_user_timeline", (9,)),
    ("read_user_timeline", (9, 1, 2)),
    ("upload_media", (b"\x00\x01payload" * 10,)),
    ("upload_media", (b"gif", "gif")),
    ("get_media", ("m12",)),
    ("healthz", ()),
]


def drive_client(mod, stub):
    client = mod.GatewayClient(*stub.addr)
    answers = []
    try:
        for name, args in CALLS:
            answers.append(getattr(client, name)(*args))
        stub.fail = (b"user_id=666",)
        for call in (lambda: client.register(666, "x", "y"),
                     lambda: client.read_home_timeline(666)):
            with pytest.raises(RuntimeError) as err:
                call()
            answers.append(str(err.value))
        stub.fail = ()
        stub.empty = True
        answers.append(client.read_home_timeline(1))
        stub.empty = False
    finally:
        client.close()
    return answers, stub.take()


def test_every_gateway_client_request_matches_jax(stub):
    want_answers, want = drive_client(jax_client, stub)
    got_answers, got = drive_client(port_client, stub)
    assert got == want
    assert got_answers == want_answers
    assert want_answers[-1] is None and "-> 500" in want_answers[-2]
    by_path = {r[1]: r for r in reversed(got)}     # each path's first
    assert by_path["/wrk2-api/user/register"][4] == \
        "application/x-www-form-urlencoded"
    assert by_path["/upload-media"][2] == "media_type=jpg"
    assert by_path["/upload-media"][4] == "application/octet-stream"
    assert by_path["/get-media"][:4] == ("GET", "/get-media",
                                         "media_id=m12", b"")
    for mod in (jax_client, port_client):        # nothing listens there
        assert mod.GatewayClient("127.0.0.1", closed_port(),
                                 timeout=1.0).healthz() is False


def test_client_reconnects_after_the_server_drops_it(stub):
    client = port_client.GatewayClient(*stub.addr)
    try:
        client.follow(1, 2)
        client._conn.sock.close()            # a dead keep-alive socket
        assert client.follow(1, 3) == {"ok": True}
    finally:
        client.close()
    assert [r[3] for r in stub.take()][-1] == b"user_id=1&followee_id=3"


# ---------------------------------------------------------------------------
# Warmup and the runner

def test_warmup_matches_jax(stub):
    graph = port_loadgen.synthetic_social_graph(24, seed=1)
    stub.fail = (b"user_id=5&followee_id=", b"username=user9&")
    stats, seen = {}, {}
    for name, pkg in PKGS.items():
        stats[name] = pkg.warmup(*stub.addr, pkg.synthetic_social_graph(
            24, seed=1), concurrency=4)
        seen[name] = collections.Counter(stub.take())
    assert stats["port"] == stats["jax"]
    assert seen["port"] == seen["jax"]
    assert stats["port"]["registered"] == 23
    assert stats["port"]["followed"] == len(graph.edges) - len(
        graph.friends(5))
    assert sum(seen["port"].values()) == 24 + len(graph.edges)


REGISTER = "/wrk2-api/user/register"


def run_recorded(monkeypatch, runner_mod, client_mod, scenario, stub):
    """One tick of the runner, every request recorded with the user whose
    thread sent it; a register's new id comes from a counter shared by
    the threads, so it is masked."""
    calls = collections.defaultdict(list)
    seeds = {}
    lock = threading.Lock()

    class Client(client_mod.GatewayClient):
        def _request(self, method, path, params=None, body=None,
                     content_type=None):
            rec = dict(params or {})
            if path == REGISTER:
                assert rec["user_id"] > graph.num_users
                rec = {k: "*" for k in rec}
            with lock:
                calls[threading.current_thread().name].append(
                    (method, path, rec, body, content_type))
            return super()._request(method, path, params, body,
                                    content_type)

    class Worker(runner_mod._UserWorker):
        def __init__(self, runner, user_id, seed):
            super().__init__(runner, user_id, seed)
            seeds[user_id] = seed
            self.thread.name = f"user{user_id}"

    monkeypatch.setattr(runner_mod, "GatewayClient", Client)
    monkeypatch.setattr(runner_mod, "_UserWorker", Worker)
    graph = synthetic_social_graph(16, seed=2)
    runner = runner_mod.LoadRunner(
        stub.addr, graph, scenario,
        runner_mod.RunnerConfig(tick_seconds=0.5, think_time=(0.004, 0.008),
                                seed=5, media_bytes=64),
        media_addr=stub.addr)
    stats = runner.run(1)
    wire = stub.take()
    assert len(wire) == sum(len(v) for v in calls.values())
    return calls, seeds, list(runner._checkout), stats


def test_runner_per_user_sequences_match_jax(monkeypatch, stub):
    # every action of the mix: compose, both reads, register, follow, login
    fields = dict(name="t", base_users=4.0, peak_range=(4.0, 4.0), noise=0.0,
                  compositions=((0.2, 0.2, 0.2),))
    want = run_recorded(monkeypatch, jax_runner, jax_client,
                        JaxLoadScenario(**fields), stub)
    got = run_recorded(monkeypatch, port_runner, port_client,
                       LoadScenario(**fields), stub)
    calls_w, seeds_w, checkout_w, stats_w = want
    calls_g, seeds_g, checkout_g, stats_g = got
    assert seeds_g == seeds_w and len(seeds_g) == 4
    assert checkout_g == checkout_w
    assert sorted(checkout_g) == list(range(1, 17))
    assert stats_g["peak_users"] == stats_w["peak_users"] == 4
    assert "error" not in stats_g and "error" not in stats_w
    assert set(calls_g) == set(calls_w) == {f"user{u}" for u in seeds_g}
    actions = set()
    for user in calls_g:
        n = min(len(calls_g[user]), len(calls_w[user]))
        assert n >= 5, (user, n)
        assert calls_g[user][:n] == calls_w[user][:n], user
        actions |= {c[1] for c in calls_g[user]}
    assert {"/wrk2-api/post/compose", "/wrk2-api/home-timeline/read",
            "/wrk2-api/user-timeline/read"} <= actions


# ---------------------------------------------------------------------------
# The burner

def test_burner_runs_the_ports_own_file_and_registers_its_child():
    srv = FrameServer()
    try:
        burner = Burner(0.5, collector_addr=srv.addr, component="victim")
        with burner:
            args = burner._proc.args
            frame = srv.frames(1)[0]
            pid = burner._proc.pid
            assert burner._proc.poll() is None
        assert burner._proc.poll() is not None       # reaped by stop()
    finally:
        srv.close()
    assert args == [sys.executable, os.path.abspath(port_burner.__file__),
                    "--duration=0.5"]
    assert args[1] == os.path.join(REPO, "deeprest_tpu_torch", "loadgen",
                                   "burner.py")
    assert json.loads(frame[4:]) == {"register": "victim", "pid": pid}
    # JAX's burner runs its own file with the same arguments and frame
    jsrv = FrameServer()
    try:
        with jax_burner.Burner(0.2, collector_addr=jsrv.addr,
                               component="victim") as jb:
            jargs, jpid = jb._proc.args, jb._proc.pid
            jframe = jsrv.frames(1)[0]
    finally:
        jsrv.close()
    assert jargs[1] == os.path.abspath(jax_burner.__file__)
    assert jframe == struct.pack(">I", len(jframe) - 4) + json.dumps(
        {"register": "victim", "pid": jpid}).encode()
    assert frame[:4] == struct.pack(">I", len(frame) - 4)


def test_burner_falls_back_to_the_ports_module(monkeypatch, tmp_path):
    """Where its file is not on disk (a zipped install) the burner runs
    ``-m deeprest_tpu_torch.loadgen.burner`` with the package's root on
    the child's path."""
    fake = tmp_path / "pkg" / "deeprest_tpu_torch" / "loadgen" / "burner.py"
    monkeypatch.setattr(port_burner, "__file__", str(fake))
    monkeypatch.setenv("PYTHONPATH", REPO)
    burner = port_burner.Burner(0.1).start()
    burner.wait()
    assert burner._proc.args == [sys.executable, "-m",
                                 "deeprest_tpu_torch.loadgen.burner",
                                 "--duration=0.1"]
    assert burner._proc.returncode == 0


def test_burner_refused_registration_raises_and_stops_the_child():
    for mod in (jax_burner, port_burner):
        burner = mod.Burner(5.0, collector_addr=("127.0.0.1", closed_port()),
                            component="victim")
        with pytest.raises(ConnectionRefusedError):
            burner.start()
        assert burner._proc.poll() is not None


def test_burner_main_registers_itself():
    srv = FrameServer()
    try:
        proc = subprocess.run(
            [sys.executable, port_burner.__file__, "--duration=0.2",
             f"--collector=127.0.0.1:{srv.addr[1]}", "--component=victim"],
            capture_output=True, timeout=60)
        frame = srv.frames(1)[0]
    finally:
        srv.close()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(frame[4:])["register"] == "victim"
    assert port_burner.burn(0.05, difficulty_bits=4) > 0


# ---------------------------------------------------------------------------
# The capture CLI

def test_cli_against_a_stub_gateway_prints_jax_keys(stub):
    addr = f"{stub.addr[0]}:{stub.addr[1]}"
    argv = ["--target", addr, "--media", addr, "--ticks", "2",
            "--tick-seconds", "0.2"]
    env = dict(os.environ, PYTHONPATH=REPO)
    lines, seen = {}, {}
    for name, module in (("jax", "deeprest_tpu.loadgen"),
                         ("port", "deeprest_tpu_torch.loadgen")):
        proc = subprocess.run([sys.executable, "-m", module, *argv],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        lines[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        seen[name] = stub.take()
    got, want = lines["port"], lines["jax"]
    fixed = {"scenario", "target", "peak_users"}
    assert fixed <= set(got) and fixed <= set(want)
    # the rest count each user's requests: one each, at 1-3 s of think time
    assert set(got) - fixed <= set(API_ENDPOINTS) | {"error"}
    assert set(want) - fixed <= set(API_ENDPOINTS) | {"error"}
    assert got["scenario"] == want["scenario"] == "normal"
    assert got["target"] == want["target"] == list(stub.addr)
    assert got["peak_users"] == want["peak_users"]
    graph = synthetic_social_graph(96, seed=0)
    for records in seen.values():
        paths = collections.Counter(r[1] for r in records)
        assert paths[REGISTER] >= 96
        assert paths["/wrk2-api/user/follow"] >= len(graph.edges)


def run_main(module, argv, capsys):
    rc = module.main(argv)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_cli_crypto_burner_paths_match_jax(stub, capsys):
    addr = f"{stub.addr[0]}:{stub.addr[1]}"
    base = ["--target", addr, "--scenario", "crypto", "--ticks", "1",
            "--tick-seconds", "0.4", "--users", "8", "--think-min", "5",
            "--think-max", "5"]
    # without --burn-local the burner is skipped, loudly
    for module in (jax_main, port_main):
        rc, line, err = run_main(module, base, capsys)
        assert rc == 0 and "burner_failed" not in line
        assert "proof-of-work burner is SKIPPED" in err
    # --burn-local registers the burner's child with the collector
    srv = FrameServer()
    try:
        rc, line, _ = run_main(port_main, base + [
            "--burn-local", "--collector", f"127.0.0.1:{srv.addr[1]}"],
            capsys)
        frames = srv.frames(1)
    finally:
        srv.close()
    assert rc == 0 and "burner_failed" not in line
    assert len(frames) == 1
    assert json.loads(frames[0][4:])["register"] == "compose-post-service"
    # a collector that refuses: exit 1 and the failure in the line
    refused = f"127.0.0.1:{closed_port()}"
    results = {}
    for name, module in (("jax", jax_main), ("port", port_main)):
        rc, line, err = run_main(module, base + [
            "--burn-local", "--collector", refused], capsys)
        assert "crypto burner registration failed" in err
        results[name] = (rc, line["scenario"], line["target"],
                         line["burner_failed"])
    assert results["port"] == results["jax"]
    assert results["port"][0] == 1


def test_cli_flag_errors_match_jax(capsys):
    msgs = {}
    for name, module in (("jax", jax_main), ("port", port_main)):
        for argv in (["--burn-local"], ["--target", "nohost"],
                     ["--scenario", "nope"]):
            with pytest.raises(SystemExit) as exc:
                module.main(argv)
            assert exc.value.code == 2
            err = capsys.readouterr().err
            # the usage above it wraps at the program name's length
            msgs.setdefault(name, []).append(
                err.strip().splitlines()[-1].replace(
                    "deeprest_tpu_torch.loadgen", "deeprest_tpu.loadgen"))
    assert msgs["port"] == msgs["jax"]
    assert "--burn-local requires --collector" in msgs["port"][0]


# ---------------------------------------------------------------------------
# The cluster supervisor (nothing booted)

def test_cluster_components_and_paths_match_jax(monkeypatch, tmp_path):
    for name in ("STORES", "SERVICES", "GATEWAYS", "CONSUMER", "COLLECTOR"):
        assert getattr(port_cluster, name) == getattr(jax_cluster, name)
    for c in (*port_cluster.STORES, *port_cluster.SERVICES,
              *port_cluster.GATEWAYS, port_cluster.CONSUMER):
        assert port_cluster._is_durable_store(c) == \
            jax_cluster._is_durable_store(c)
    monkeypatch.delenv("DEEPREST_SNSD", raising=False)
    assert port_cluster.snsd_path() == jax_cluster.snsd_path() == \
        os.path.join(REPO, "native", "sns", "snsd")
    assert port_cluster.snsd_available() == jax_cluster.snsd_available()
    fake = tmp_path / "snsd"
    monkeypatch.setenv("DEEPREST_SNSD", str(fake))
    assert port_cluster.snsd_path() == str(fake)
    assert not port_cluster.snsd_available()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    assert port_cluster.snsd_available() and jax_cluster.snsd_available()
    ports = port_cluster._free_ports(5)
    assert len(set(ports)) == 5


def test_cluster_start_without_snsd_raises_before_touching_anything(
        monkeypatch, tmp_path):
    monkeypatch.setenv("DEEPREST_SNSD", str(tmp_path / "missing"))
    msgs = []
    for mod in (jax_cluster, port_cluster):
        cluster = mod.SnsCluster(out_path=str(tmp_path / "raw.jsonl"))
        with pytest.raises(RuntimeError, match="snsd not built") as err:
            cluster.start()
        msgs.append(str(err.value))
        assert cluster.components == {} and cluster._config_path is None
    assert msgs[0] == msgs[1]
    assert os.listdir(tmp_path) == []


def test_cluster_cgroup_names_match_jax(tmp_path):
    names = []
    for mod in (jax_cluster, port_cluster):
        cluster = mod.SnsCluster(out_path=str(tmp_path / "raw.jsonl"),
                                 data_dir=str(tmp_path / "pvc"), chaos=True)
        cluster._config_path = cluster.out_path + ".cluster.json"
        names.append([cluster.cgroup_dir(c) for c in
                      ("", "user-mongodb", "trace-collector")])
        assert cluster.data_dir == str(tmp_path / "pvc")
    assert names[0] == names[1]
    assert names[1][1].startswith("/sys/fs/cgroup/cpuacct/deeprest/")


# ---------------------------------------------------------------------------
# Live: a booted snsd cluster (skipped where snsd is not built)

def _cgroupfs_writable() -> bool:
    # a read-only probe: this module creates no cgroup to find out
    return os.access("/sys/fs/cgroup/cpuacct", os.W_OK)


@pytest.fixture(scope="module")
def live_corpus(tmp_path_factory):
    if not snsd_available():
        pytest.skip("snsd not built (make -C native/sns)")
    live_dir = tmp_path_factory.mktemp("live")
    out = str(live_dir / "raw.jsonl")
    graph = synthetic_social_graph(24, seed=1)
    with SnsCluster(out_path=out, interval_ms=500, grace_ms=300,
                    data_dir=str(live_dir / "pvc")) as cluster:
        stats = warmup(*cluster.gateway_addr, graph)
        runner = LoadRunner(
            cluster.gateway_addr, graph, normal_scenario(0),
            RunnerConfig(tick_seconds=0.7, think_time=(0.02, 0.08),
                         user_scale=0.05, seed=0),
            media_addr=cluster.media_addr,
        )
        run_stats = runner.run(6)
        cluster.stop(drain_s=1.5)
    return load_raw_data(out), stats, run_stats


@needs_snsd
def test_live_warmup_registers_everyone(live_corpus):
    _, stats, _ = live_corpus
    assert stats["registered"] == 24
    assert stats["followed"] == stats["edges"]


@needs_snsd
def test_live_traffic_flows_and_traces_collected(live_corpus):
    buckets, _, run_stats = live_corpus
    total = sum(v for k, v in run_stats.items()
                if k not in ("error", "peak_users"))
    assert total > 10, run_stats
    assert run_stats.get("error", 0) <= total * 0.1, run_stats
    assert len(buckets) >= 3
    roots = {t.operation for b in buckets for t in b.traces}
    assert "/wrk2-api/post/compose" in roots or \
        "/wrk2-api/home-timeline/read" in roots


@needs_snsd
def test_live_corpus_featurizes_natively_and_in_numpy(live_corpus,
                                                      tmp_path):
    from deeprest_tpu_torch.data.native import featurize_jsonl
    from deeprest_tpu_torch.data.schema import save_raw_data_jsonl

    buckets, _, _ = live_corpus
    data = featurize_buckets(buckets, FeaturizeConfig(round_to=32))
    assert data.traffic.shape[0] == len(buckets)
    assert data.traffic.sum() > 0
    assert "cpu" in {k.rsplit("_", 1)[1] for k in data.resources}
    cpu_keys = [k for k in data.resources if k.endswith("_cpu")]
    assert any(np.asarray(data.resources[k]).sum() > 0 for k in cpu_keys)
    path = str(tmp_path / "live.jsonl")
    save_raw_data_jsonl(buckets, path)
    native = featurize_jsonl(path, FeaturizeConfig(round_to=32))
    np.testing.assert_array_equal(native.traffic, data.traffic)


@needs_snsd
def test_live_corpus_write_telemetry_nonzero(live_corpus):
    buckets, _, _ = live_corpus

    def series(component, resource):
        return [m.value for b in buckets for m in b.metrics
                if m.component == component and m.resource == resource]

    mongo = {m.component for b in buckets for m in b.metrics
             if m.component.endswith("-mongodb")}
    assert mongo
    assert any(max(series(c, "write-iops"), default=0) > 0 for c in mongo)
    assert any(max(series(c, "write-tp"), default=0) > 0 for c in mongo)
    usage = [u for u in series("post-storage-mongodb", "usage") if u > 0]
    assert usage and usage[-1] >= usage[0] and usage[-1] > 0
    redis = {m.component for b in buckets for m in b.metrics
             if m.component.endswith("-redis")}
    assert any(max(series(c, "write-tp"), default=0) > 0 for c in redis)


@needs_snsd
@pytest.mark.slow
def test_live_end_to_end_read_your_own_write(live_corpus, tmp_path):
    _ = live_corpus                  # the module's cluster is torn down
    with SnsCluster(out_path=str(tmp_path / "e2e.jsonl"),
                    interval_ms=800) as cluster:
        c = GatewayClient(*cluster.gateway_addr)
        c.register(901, "user901", "pw901")
        c.register(902, "user902", "pw902")
        c.follow(902, 901)
        c.compose(901, "user901", "ship it @user902 https://go.example/x")
        time.sleep(0.8)
        assert "ship it" in str(c.read_home_timeline(902))
        assert "ship it" in str(c.read_user_timeline(901))
        media = GatewayClient(*cluster.media_addr)
        media_id = media.upload_media(b"\x00" * 512)["media_id"]
        assert str(media.get_media(media_id).get("media_id")) == media_id
        c.close()
        media.close()


def _victim_cpu(path, victim):
    buckets = load_raw_data(path)
    return buckets, [m.value for b in buckets for m in b.metrics
                     if m.component == victim and m.resource == "cpu"]


@needs_snsd
@pytest.mark.slow
def test_live_burner_attributes_cpu_to_victim_component(tmp_path):
    out = str(tmp_path / "burn.jsonl")
    victim = "compose-post-service"
    with SnsCluster(out_path=out, interval_ms=500, grace_ms=200) as cluster:
        with Burner(3.0, collector_addr=cluster.collector_addr,
                    component=victim):
            time.sleep(3.0)
        cluster.stop(drain_s=1.0)
    buckets, cpu = _victim_cpu(out, victim)
    assert len(buckets) >= 3
    assert max(cpu) > 0.3, cpu


@needs_snsd
@pytest.mark.slow
def test_live_unregistered_burner_is_attributed_non_cooperatively(tmp_path):
    out = str(tmp_path / "chaos.jsonl")
    victim = "compose-post-service"
    with SnsCluster(out_path=out, interval_ms=500, grace_ms=200,
                    chaos=True) as cluster:
        info = port_client.chaos_burn(*cluster.components[victim],
                                      seconds=3.0)
        assert int(info["pid"]) > 0
        time.sleep(3.0)
        cluster.stop(drain_s=1.0)
    buckets, cpu = _victim_cpu(out, victim)
    assert len(buckets) >= 3
    assert max(cpu) > 100.0, cpu


@needs_snsd
@pytest.mark.slow
@pytest.mark.skipif(not _cgroupfs_writable(),
                    reason="no writable cgroupfs on this host")
def test_live_short_lived_unregistered_burn_survives_process_death(tmp_path):
    out = str(tmp_path / "cg.jsonl")
    victim = "compose-post-service"
    with SnsCluster(out_path=out, interval_ms=2000, grace_ms=200,
                    chaos=True) as cluster:
        time.sleep(2.2)
        port_client.chaos_burn(*cluster.components[victim], seconds=0.8)
        time.sleep(3.2)
        cluster.stop(drain_s=0.5)
    _, cpu = _victim_cpu(out, victim)
    assert max(cpu, default=0.0) > 50.0, cpu


@needs_snsd
@pytest.mark.slow
def test_live_collector_metrics_endpoint(tmp_path):
    import urllib.request

    with SnsCluster(out_path=str(tmp_path / "m.jsonl"), interval_ms=400,
                    grace_ms=200) as cluster:
        c = GatewayClient(*cluster.gateway_addr)
        c.register(801, "user801", "pw801")
        c.register(802, "user802", "pw802")
        c.follow(802, 801)
        for i in range(5):
            c.compose(801, "user801", f"observable post {i}")
            c.read_home_timeline(802)
        time.sleep(1.2)
        host, port = cluster.metrics_addr
        text = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=10).read().decode()
        assert 'deeprest_resource{component="nginx-thrift",resource="cpu"}' \
            in text
        for res in ("memory", "write-iops", "write-tp", "usage"):
            assert f'resource="{res}"' in text, res

        def counter(name):
            for line in text.splitlines():
                if line.startswith(name + " "):
                    return float(line.split()[1])
            raise AssertionError(f"{name} not exposed")

        assert counter("deeprest_spans_ingested_total") > 0
        assert counter("deeprest_traces_assembled_total") > 0
        assert counter("deeprest_buckets_written_total") > 0
        html = urllib.request.urlopen(
            f"http://{host}:{port}/dashboard", timeout=10).read().decode()
        assert "<html" in html and "/metrics" in html
        assert urllib.request.urlopen(
            f"http://{host}:{port}/healthz",
            timeout=10).read().decode().strip() == "ok"
        c.close()


@needs_snsd
@pytest.mark.slow
def test_live_gateway_serves_browsable_pages(tmp_path):
    import urllib.error
    import urllib.request

    with SnsCluster(out_path=str(tmp_path / "p.jsonl"),
                    interval_ms=800) as cluster:
        host, port = cluster.gateway_addr
        base = f"http://{host}:{port}"
        for path in ("/", "/signup.html", "/main.html", "/profile.html",
                     "/contact.html"):
            html = urllib.request.urlopen(base + path,
                                          timeout=10).read().decode()
            assert "<html" in html, path
            assert "wrk2-api" in html or path == "/contact.html", path

        def form_post(path, **params):
            req = urllib.request.Request(
                base + path, data=urllib.parse.urlencode(params).encode(),
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            return urllib.request.urlopen(req, timeout=10).read().decode()

        form_post("/wrk2-api/user/register", user_id=701,
                  username="user701", password="pw")
        form_post("/wrk2-api/post/compose", user_id=701,
                  username="user701", text="posted from the browser page")
        assert "posted from the browser page" in form_post(
            "/wrk2-api/user-timeline/read", user_id=701)
        mh, mp = cluster.media_addr
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://{mh}:{mp}/signup.html",
                                   timeout=10)
        assert err.value.code in (404, 500)


@needs_snsd
@pytest.mark.slow
@pytest.mark.skipif(not _cgroupfs_writable(),
                    reason="no writable cgroupfs on this host")
def test_live_foreign_process_in_cgroup_gets_io_attribution(tmp_path):
    out = str(tmp_path / "foreign_io.jsonl")
    victim = "post-storage-mongodb"
    with SnsCluster(out_path=out, interval_ms=1000, grace_ms=200) as cluster:
        cgdir = cluster.cgroup_dir(victim)
        assert os.path.isdir(cgdir), "service did not join its cgroup"
        writer = subprocess.Popen(
            [sys.executable, "-c", (
                "import os, time\n"
                "end = time.time() + 6.0\n"
                "fd = os.open('foreign.dat', os.O_WRONLY | os.O_CREAT, 0o600)\n"
                "blob = b'x' * (1 << 20)\n"
                "while time.time() < end:\n"
                "    os.pwrite(fd, blob, 0)\n"
                "    os.fsync(fd)\n"
                "    time.sleep(0.05)\n"
            )], cwd=str(tmp_path))
        try:
            with open(os.path.join(cgdir, "cgroup.procs"), "w",
                      encoding="ascii") as f:
                f.write(str(writer.pid))
            time.sleep(4.5)
        finally:
            writer.terminate()
            writer.wait()
        cluster.stop(drain_s=1.0)
    buckets = load_raw_data(out)
    wtp = [m.value for b in buckets for m in b.metrics
           if m.component == victim and m.resource == "write-tp"]
    assert max(wtp, default=0.0) > 100.0, wtp
