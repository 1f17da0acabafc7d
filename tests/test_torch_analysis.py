"""The port's graftlint framework tests (deeprest_tpu_torch/analysis), the
counterpart of tests/test_analysis.py: every rule fires on its minimal bad
fixture and stays SILENT on the minimally-corrected variant (the
false-positive guard), plus the suppression, baseline, reporter, cache,
autofix and CLI machinery, run against ``deeprest_tpu_torch.analysis`` and
the port's ``cli.main(["lint", ...])``.  The fixtures are the reference
file's, so tests/test_torch_analysis_parity.py can hold the two analyzers
against each other on them.  tests/test_torch_lint_clean.py pins the port
itself clean."""

import json

import pytest

from deeprest_tpu_torch.analysis import (
    all_rules, lint_sources, load_baseline, render_json, render_text,
    save_baseline,
)


def findings_for(rule_id: str, source: str, rel: str = "mod.py"):
    rules = [all_rules()[rule_id]] if rule_id else []
    result = lint_sources({rel: source}, rules=rules)
    return [f for f in result.findings if not rule_id or f.rule == rule_id]


def assert_pair(rule_id: str, bad: str, good: str, rel: str = "mod.py"):
    fired = findings_for(rule_id, bad, rel)
    assert fired, f"{rule_id} must fire on the bad fixture"
    assert all(f.rule == rule_id for f in fired)
    silent = findings_for(rule_id, good, rel)
    assert not silent, (f"{rule_id} false positive on the corrected "
                        f"fixture: {silent}")


# ---------------------------------------------------------------------------
# JX001: closure-captured params in jitted functions


JX001_BAD = """
import jax

def make_step(params, model):
    def step(x):
        return model.apply(params, x)
    return jax.jit(step)
"""

JX001_GOOD = """
import jax

def make_step(model):
    def step(params, x):
        return model.apply(params, x)
    return jax.jit(step)
"""


def test_jx001_pair():
    assert_pair("JX001", JX001_BAD, JX001_GOOD)


def test_jx001_attribute_chain_capture():
    bad = """
import jax

def export(pred):
    fn = jax.jit(lambda x: pred.model.apply({"p": pred.params}, x))
    return fn
"""
    assert findings_for("JX001", bad)


def test_jx001_local_helper_function_not_flagged():
    # trainer.py's `pin_state` pattern: a closure-captured local FUNCTION
    # whose name matches the device-state pattern is a static callable
    src = """
import jax

def build(mesh):
    def pin_state(s):
        return s
    def step(state):
        return pin_state(state)
    return jax.jit(step)
"""
    assert not findings_for("JX001", src)


# ---------------------------------------------------------------------------
# JX002: recompile hazards


JX002_LOOP_BAD = """
import jax

def run(fns, xs):
    outs = []
    for fn in fns:
        outs.append(jax.jit(fn)(xs))
    return outs
"""

JX002_LOOP_GOOD = """
import jax

def run(fn, xs_list):
    jfn = jax.jit(fn)
    outs = []
    for xs in xs_list:
        outs.append(jfn(xs))
    return outs
"""


def test_jx002_jit_in_loop_pair():
    assert_pair("JX002", JX002_LOOP_BAD, JX002_LOOP_GOOD)


def test_jx002_fresh_lambda_immediately_invoked():
    bad = """
import jax

def apply_once(x):
    return jax.jit(lambda y: y * 2)(x)
"""
    good = """
import jax

_double = jax.jit(lambda y: y * 2)

def apply_once(x):
    return _double(x)
"""
    assert_pair("JX002", bad, good)


def test_jx002_nonliteral_static_argnums():
    bad = """
import jax

def build(fn, which):
    return jax.jit(fn, static_argnums=which)
"""
    good = """
import jax

def build(fn):
    return jax.jit(fn, static_argnums=(0, 2))
"""
    assert_pair("JX002", bad, good)


# ---------------------------------------------------------------------------
# JX003: device→host readbacks in loops (hot modules only)


JX003_BAD = """
import numpy as np

def epoch(step, state, batches):
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
    return state, losses
"""

JX003_GOOD = """
import numpy as np
import jax.numpy as jnp

def epoch(step, state, batches):
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    return state, np.asarray(jnp.stack(losses))
"""


def test_jx003_pair_in_hot_module():
    assert_pair("JX003", JX003_BAD, JX003_GOOD, rel="train/trainer.py")


def test_jx003_silent_outside_hot_modules():
    # the same readback in host-side ETL code is not a pipeline stall
    assert not findings_for("JX003", JX003_BAD, rel="data/ingest.py")


def test_jx003_item_and_asarray_kinds():
    bad = """
import numpy as np

def drain(xs):
    out = [np.asarray(x) for x in xs]
    tot = 0.0
    for x in xs:
        tot += x.item()
    return out, tot
"""
    fired = findings_for("JX003", bad, rel="serve/fused.py")
    kinds = {f.message.split()[0] for f in fired}
    assert any("asarray" in k for k in kinds)
    assert any("item" in k for k in kinds)


# ---------------------------------------------------------------------------
# JX005: NamedSharding literals outside parallel/sharding.py


JX005_BAD = """
from jax.sharding import NamedSharding, PartitionSpec as P

def pin(mesh, leaf):
    return jax.lax.with_sharding_constraint(
        leaf, NamedSharding(mesh, P("expert", None)))
"""

JX005_GOOD = """
from deeprest_tpu.parallel.sharding import state_sharding

def pin(mesh, state):
    return jax.tree.map(jax.lax.with_sharding_constraint,
                        state, state_sharding(mesh, state))
"""


def test_jx005_pair():
    assert_pair("JX005", JX005_BAD, JX005_GOOD,
                rel="train/trainer.py")


def test_jx005_silent_in_the_table_owner_module():
    # the one module allowed to construct NamedSharding, under both
    # lint-root-relative spellings
    for rel in ("parallel/sharding.py", "deeprest_tpu/parallel/sharding.py"):
        assert not findings_for("JX005", JX005_BAD, rel=rel)


def test_jx005_dotted_constructor_and_suppression():
    bad = """
import jax

def feed(mesh, arr):
    return jax.device_put(arr, jax.sharding.NamedSharding(mesh, P()))
"""
    assert findings_for("JX005", bad, rel="serve/predictor.py")
    suppressed = """
import jax

def feed(mesh, arr):
    # graftlint: disable=JX005 -- designed feed-path site: input placement
    return jax.device_put(arr, jax.sharding.NamedSharding(mesh, P()))
"""
    assert not findings_for("JX005", suppressed, rel="serve/predictor.py")


# ---------------------------------------------------------------------------
# JX004: use-after-donation


JX004_BAD = """
import jax

step = jax.jit(lambda s, x: (s + x, x), donate_argnums=0)

def train(state, xs):
    new_state, out = step(state, xs)
    return new_state, state.step
"""

JX004_GOOD = """
import jax

step = jax.jit(lambda s, x: (s + x, x), donate_argnums=0)

def train(state, xs):
    state, out = step(state, xs)
    return state, state.step
"""


def test_jx004_pair():
    assert_pair("JX004", JX004_BAD, JX004_GOOD)


def test_jx004_self_attribute_callable_and_rebinding_loop():
    # the trainer idiom: donated callable held on self, canonical
    # `state, loss = self._step(state, ...)` rebinding inside a loop
    good = """
import jax

class T:
    def __init__(self, fn):
        self._step = jax.jit(fn, donate_argnums=0)

    def epoch(self, state, batches):
        for b in batches:
            state, loss = self._step(state, b)
        return state
"""
    bad = """
import jax

class T:
    def __init__(self, fn):
        self._step = jax.jit(fn, donate_argnums=0)

    def epoch(self, state, batches):
        for b in batches:
            new, loss = self._step(state, b)
        return state
"""
    assert_pair("JX004", bad, good)


# ---------------------------------------------------------------------------
# TH001: attribute races


TH001_BAD = """
import threading

class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _worker(self):
        self.count += 1

    def healthz(self):
        return {"count": self.count}
"""

TH001_GOOD = """
import threading

class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _worker(self):
        with self._lock:
            self.count += 1

    def healthz(self):
        with self._lock:
            return {"count": self.count}
"""


def test_th001_pair():
    assert_pair("TH001", TH001_BAD, TH001_GOOD)


def test_th001_http_handler_module_counts_as_concurrent():
    # no explicit Thread spawn: ThreadingHTTPServer makes every method a
    # potential concurrent entry (the /healthz reload-counter bug class)
    bad = """
from http.server import ThreadingHTTPServer

class Service:
    def __init__(self):
        self.reloads = 0

    def maybe_reload(self):
        self.reloads += 1

    def healthz(self):
        return {"reloads": self.reloads}
"""
    good = """
import threading
from http.server import ThreadingHTTPServer

class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self.reloads = 0

    def maybe_reload(self):
        with self._lock:
            self.reloads += 1

    def healthz(self):
        with self._lock:
            return {"reloads": self.reloads}
"""
    assert_pair("TH001", bad, good)


def test_th001_init_only_attributes_are_silent():
    src = """
import threading

class Worker:
    def __init__(self, cfg):
        self.cfg = cfg
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        return self.cfg
"""
    assert not findings_for("TH001", src)


def test_th001_shared_capture_pair():
    # the streaming-ETL pattern: an unsynchronized object captured by the
    # thread target AND still used by the spawner after start()
    bad = """
import threading

class Tailer:
    def __init__(self):
        self.dropped = 0

class Runner:
    def run(self, tailer):
        def loop():
            tailer.poll()
        t = threading.Thread(target=loop)
        t.start()
        while True:
            print(tailer.dropped)
"""
    good = """
import threading

class Tailer:
    def __init__(self):
        self.dropped = 0

class Buffer:
    def __init__(self):
        self._cv = threading.Condition()
        self._dropped = 0

    def note(self, n):
        with self._cv:
            self._dropped = n

    def dropped(self):
        with self._cv:
            return self._dropped

class Runner:
    def run(self, tailer):
        buf = Buffer()

        def loop():
            tailer.poll()
            buf.note(tailer.dropped)
        t = threading.Thread(target=loop)
        t.start()
        while True:
            print(buf.dropped())
"""
    assert_pair("TH001", bad, good)


# ---------------------------------------------------------------------------
# TH002: lock-ordering cycles


TH002_BAD = """
import threading

class AB:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def forward(self):
        with self._a:
            with self._b:
                pass

    def backward(self):
        with self._b:
            with self._a:
                pass
"""

TH002_GOOD = """
import threading

class AB:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def forward(self):
        with self._a:
            with self._b:
                pass

    def backward(self):
        with self._a:
            with self._b:
                pass
"""


def test_th002_pair():
    assert_pair("TH002", TH002_BAD, TH002_GOOD)


def test_th002_cross_class_cycle_via_annotated_attr():
    bad = """
import threading

class Ladder:
    def __init__(self, svc: "Service"):
        self._lock = threading.Lock()
        self._svc = svc

    def dispatch(self):
        with self._lock:
            self._svc.note()

class Service:
    def __init__(self, ladder: Ladder):
        self._lock = threading.Lock()
        self._ladder = ladder

    def note(self):
        with self._lock:
            pass

    def serve(self):
        with self._lock:
            self._ladder.dispatch()
"""
    fired = findings_for("TH002", bad)
    assert fired and "cycle" in fired[0].message


# ---------------------------------------------------------------------------
# TH003: state mutated across a multiprocessing boundary


TH003_BAD = """
import multiprocessing as mp

class Replica:
    def __init__(self):
        self.served = 0
        self._proc = mp.Process(target=self._worker)
        self._proc.start()

    def _worker(self):
        self.served += 1          # mutates the CHILD's copy only

    def outstanding(self):
        return self.served        # parent reads frozen state forever
"""

TH003_GOOD = """
import multiprocessing as mp

class Replica:
    def __init__(self):
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(target=_worker_main, args=(child,))
        self._proc.start()

    def outstanding(self):
        self._conn.send("stats")
        return self._conn.recv()

def _worker_main(conn):
    served = 0
    while True:
        msg = conn.recv()
        served += 1
        conn.send(served)
"""


def test_th003_pair():
    assert_pair("TH003", TH003_BAD, TH003_GOOD)


def test_th003_transitive_child_side_write():
    bad = """
import multiprocessing

class Worker:
    def __init__(self):
        self.count = 0
        multiprocessing.Process(target=self._run).start()

    def _run(self):
        self._bump()

    def _bump(self):
        self.count += 1

    def report(self):
        return self.count
"""
    fired = findings_for("TH003", bad)
    assert fired and "child" in fired[0].message


def test_th003_child_only_state_is_silent():
    # the child may freely mutate state nothing parent-side reads
    src = """
import multiprocessing

class Worker:
    def __init__(self):
        multiprocessing.Process(target=self._run).start()

    def _run(self):
        self.local_count = 0
        self.local_count += 1
"""
    assert not findings_for("TH003", src)


# ---------------------------------------------------------------------------
# TH004: inconsistent lock discipline


TH004_BAD = """
import threading

class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._replicas = []

    def add(self, r):
        with self._lock:
            self._replicas = self._replicas + [r]

    def pick(self):
        return self._replicas[0]      # unguarded read of guarded state
"""

TH004_GOOD = """
import threading

class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._replicas = []

    def add(self, r):
        with self._lock:
            self._replicas = self._replicas + [r]

    def pick(self):
        with self._lock:
            return self._replicas[0]
"""


def test_th004_pair():
    assert_pair("TH004", TH004_BAD, TH004_GOOD)


def test_th004_unguarded_write_fires():
    bad = """
import threading

class Counters:
    def __init__(self):
        self._lock = threading.Lock()
        self._served = 0

    def snapshot(self):
        with self._lock:
            return self._served

    def bump(self):
        self._served += 1             # write outside the lock
"""
    fired = findings_for("TH004", bad)
    assert fired and "without the class lock" in fired[0].message


def test_th004_locked_suffix_convention_is_silent():
    # *_locked helpers run with the lock already held by their caller
    src = """
import threading

class Admission:
    def __init__(self):
        self._lock = threading.Lock()
        self._inflight = 0

    def release(self):
        with self._lock:
            self._inflight -= 1
            self._grant_next_locked()

    def _grant_next_locked(self):
        self._inflight += 1
"""
    assert not findings_for("TH004", src)


def test_th004_consistently_unlocked_class_is_silent():
    # no lock discipline declared for the attribute: TH004 has no
    # inconsistency to flag (TH001 owns the thread-entry race proof)
    src = """
import threading

class Plain:
    def __init__(self):
        self._lock = threading.Lock()
        self.mode = "idle"

    def set_mode(self, m):
        self.mode = m

    def get_mode(self):
        return self.mode
"""
    assert not findings_for("TH004", src)


# ---------------------------------------------------------------------------
# HY rules


# ---------------------------------------------------------------------------
# OB001: ad-hoc latency timers in hot modules


OB001_BAD = """
import time

class Handler:
    def handle(self, request):
        t0 = time.monotonic()
        result = work(request)
        self.latency_s = time.monotonic() - t0
        return result
"""

OB001_GOOD = """
from deeprest_tpu.obs.metrics import Stopwatch

class Handler:
    def handle(self, request):
        sw = Stopwatch()
        result = work(request)
        self.latency_s = sw.elapsed()
        return result
"""


def test_ob001_pair():
    assert_pair("OB001", OB001_BAD, OB001_GOOD, rel="serve/handler.py")


def test_ob001_wall_clock_fires():
    bad = """
import time

def measure():
    start = time.time()
    work()
    return time.time() - start
"""
    fired = findings_for("OB001", bad, rel="train/loop.py")
    assert fired and "time.time()" in fired[0].message


def test_ob001_deadline_patterns_are_silent():
    src = """
import time

def run(deadline_s):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:   # elapsed IN a compare
        work()
    deadline = time.monotonic() + 5.0           # remaining-time math
    left = deadline - time.monotonic()          # timer on the right
    return left
"""
    assert not findings_for("OB001", src, rel="serve/loop.py")


def test_ob001_non_hot_modules_are_silent():
    # host-side ETL and the workload simulator measure with numpy-era
    # timers by design — only serve/ and train/ are on the watchlist
    src = """
import time

def measure():
    t0 = time.perf_counter()
    work()
    return time.perf_counter() - t0
"""
    assert not findings_for("OB001", src, rel="data/etl.py")
    assert not findings_for("OB001", src, rel="workload/sim.py")
    assert findings_for("OB001", src, rel="serve/hot.py")


# ---------------------------------------------------------------------------
# TN001: per-tenant mutable state outside a pool-entry accessor


TN001_BAD = """
class Router:
    def dispatch(self, entry, traffic):
        backend = entry._tenant_predictor       # bypasses the pool lock
        entry._tenant_invalidations["manual"] = 1
        return backend.predict_series(traffic)
"""

TN001_GOOD = """
class Router:
    def dispatch(self, entry, traffic):
        backend = entry.predictor()             # accessor: pool-lock safe
        entry.note_invalidation("manual")
        return backend.predict_series(traffic)
"""


def test_tn001_pair():
    assert_pair("TN001", TN001_BAD, TN001_GOOD, rel="serve/router.py")


def test_tn001_owner_module_is_silent():
    # serve/fleet.py OWNS the _tenant_* attributes — the accessors and the
    # spill/restore bookkeeping live there, under the pool lock
    assert not findings_for("TN001", TN001_BAD, rel="serve/fleet.py")


def test_tn001_outside_serve_is_silent():
    # the watchlist is the serving plane; a bench harness or test helper
    # poking at entries is out of scope by construction
    assert not findings_for("TN001", TN001_BAD, rel="benchmarks/bench.py")
    assert not findings_for("TN001", TN001_BAD, rel="train/loop.py")
    assert findings_for("TN001", TN001_BAD, rel="serve/server.py")


# ---------------------------------------------------------------------------
# WR001: per-frame allocation / blocking call in a wire recv hot loop


WR001_BAD = """
import json

class Tap:
    def serve(self, sock):
        buf = b""
        while self.alive:
            buf += sock.recv(4096)
            msg = json.loads(buf)               # O(connection) per frame
            print("frame", msg["seq"])          # blocking shared stream
            open("/tmp/tap.log", "a").write("x")  # file I/O mid-frame
            self.frames.append(msg)             # no len() bound anywhere
"""

WR001_GOOD = """
import json

class Tap:
    def serve(self, sock):
        while self.alive:
            n = self._recv_exact(sock, self.hdr)   # framed: no re-parse
            if not n:
                break
            self._on_frame(bytes(self.hdr))        # work outside the loop

    def _on_frame(self, payload):
        msg = json.loads(payload)                  # once per frame, helper
        if len(self.frames) >= self.max_buffered:  # explicit bound
            self.dropped += 1
            return
        self.frames.append(msg)
"""


def test_wr001_pair():
    assert_pair("WR001", WR001_BAD, WR001_GOOD,
                rel="deeprest_tpu/data/wire_tap.py")


def test_wr001_scoped_to_wire_modules():
    # the recv-loop discipline is a wire-transport contract; the same
    # shape in an ingest poller or a test helper is out of scope
    assert not findings_for("WR001", WR001_BAD, rel="data/ingest.py")
    assert not findings_for("WR001", WR001_BAD, rel="tests/helpers.py")
    assert findings_for("WR001", WR001_BAD, rel="serve/wire_fanin.py")


def test_wr001_each_shape_reported():
    # all four banned shapes in the bad fixture produce findings
    fired = findings_for("WR001", WR001_BAD, rel="data/wire_tap.py")
    msgs = " ".join(f.message for f in fired)
    assert "open()" in msgs
    assert "print()" in msgs
    assert "json.loads(buf)" in msgs
    assert "self.frames.append()" in msgs


def test_wr001_real_receiver_is_silent():
    # the shipped receiver keeps its recv loop frame-accounting-only:
    # the rule must hold on the real module, not just fixtures
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "deeprest_tpu_torch", "data", "wire.py")
    src = open(path, encoding="utf-8").read()
    assert not findings_for("WR001", src,
                            rel="deeprest_tpu_torch/data/wire.py")


# ---------------------------------------------------------------------------
# DN001: dense traffic materialization in sparse-first hot modules


DN001_BAD = """
import numpy as np

def refresh(self):
    x = np.zeros((len(self.metrics), self.space.capacity), np.float32)
    return x
"""

DN001_GOOD = """
import numpy as np

def refresh(self):
    cols, vals, nnz = self.traffic.view()
    return cols, vals, nnz
"""


def test_dn001_pair():
    assert_pair("DN001", DN001_BAD, DN001_GOOD, rel="train/stream.py")
    assert_pair("DN001", DN001_BAD, DN001_GOOD, rel="data/featurize.py")


def test_dn001_leading_axis_and_literals_are_silent():
    # a capacity-sized LEADING axis (e.g. a per-column stats vector of
    # small width) and literal shapes are not the F-wide materialization
    src = """
import numpy as np

def stats(self):
    counts = np.zeros((self.capacity,), np.int64)[:, None] * 0
    small = np.zeros((self.space.capacity, 4), np.float32)
    fixed = np.zeros((1024, 64), np.float32)
    return counts, small, fixed
"""
    fired = findings_for("DN001", src, rel="train/stream.py")
    # only the bare (self.capacity,) single-axis alloc fires (its last
    # axis IS the width); the (capacity, 4) and literal shapes stay silent
    assert len(fired) == 1


def test_dn001_non_watchlist_modules_are_silent():
    # the dense offline path (train/data.py prepare_dataset) and serving
    # are out of scope by design — only the converted hot modules are
    # watched
    assert not findings_for("DN001", DN001_BAD, rel="train/data.py")
    assert not findings_for("DN001", DN001_BAD, rel="serve/fused.py")


# round 18: ALL of obs/ is watched — the quality monitors touch the
# F-wide feature space per sweep; their contract is COO rows in with the
# one dense window built through ops/densify.py, never a local F-wide
# np.zeros
DN001_OBS_BAD = """
import numpy as np

class Monitor:
    def sweep(self, rows):
        window = np.zeros((len(rows), self.capacity), np.float32)
        return window
"""
DN001_OBS_GOOD = """
import numpy as np
from deeprest_tpu.ops.densify import densify_rows

class Monitor:
    def sweep(self, cols, vals):
        kmax = max(len(c) for c in cols)
        pad_c = np.zeros((len(cols), kmax), np.int32)
        return densify_rows(pad_c, vals, self.capacity)
"""


def test_dn001_obs_directory_pair():
    # any file under obs/ is hot (the quality monitors live there); the
    # sanctioned path pads COO rows (K-wide, not F-wide) and densifies
    # through ops/densify.py
    assert_pair("DN001", DN001_OBS_BAD, DN001_OBS_GOOD,
                rel="obs/quality.py")
    assert_pair("DN001", DN001_OBS_BAD, DN001_OBS_GOOD,
                rel="deeprest_tpu/obs/metrics.py")
    # ops/ itself stays out of scope — it IS the densification home
    assert not findings_for("DN001", DN001_OBS_BAD, rel="ops/densify.py")


# round 21: serve/surface.py joins the DN001 watchlist — a capacity
# surface build folds the whole mix grid through the estimator, so one
# F-wide dense staging buffer there multiplies by hundreds of scenarios


def test_dn001_surface_module_pair():
    assert_pair("DN001", DN001_BAD, DN001_GOOD, rel="serve/surface.py")


def test_dn002_leaves_surface_sites_to_dn001():
    # with surface.py on DN001's watchlist, a marker-shaped alloc there
    # is DN001's finding — DN002 must not double-report it even though
    # serve/ is a DN002 zone
    assert not findings_for("DN002", DN001_BAD, rel="serve/surface.py")
    assert findings_for("DN001", DN001_BAD, rel="serve/surface.py")


def test_jx003_surface_module_pair():
    # the surface build loop folds scenario batches — a per-iteration
    # device→host readback there stalls the whole grid sweep
    assert_pair("JX003", JX003_BAD, JX003_GOOD, rel="serve/surface.py")


def test_hy001_unused_import_pair():
    bad = "import os\nimport sys\n\nprint(sys.argv)\n"
    good = "import sys\n\nprint(sys.argv)\n"
    assert_pair("HY001", bad, good)


def test_hy001_init_py_exempt():
    assert not findings_for("HY001", "from mod import thing\n",
                            rel="pkg/__init__.py")


def test_hy002_unreachable_pair():
    bad = "def f():\n    return 1\n    print('dead')\n"
    good = "def f():\n    return 1\n"
    assert_pair("HY002", bad, good)


# ---------------------------------------------------------------------------
# suppressions


def test_suppression_with_reason_silences_finding():
    src = ("import os\n"
           "# graftlint: disable=HY001 -- kept for the doctest namespace\n"
           "import sys\n\nprint(sys.argv)\n")
    # os (line 1) still fires; sys would not have fired anyway — move the
    # suppression to the real finding:
    fired = findings_for("HY001", src)
    assert len(fired) == 1 and fired[0].line == 1
    src2 = ("# graftlint: disable=HY001 -- kept for the doctest namespace\n"
            "import os\n"
            "import sys\n\nprint(sys.argv)\n")
    assert not findings_for("HY001", src2)


def test_suppression_trailing_same_line():
    src = ("import os  # graftlint: disable=HY001 -- re-exported via star\n"
           "print(1)\n")
    assert not findings_for("HY001", src)


def test_suppression_without_reason_is_gl001_and_does_not_suppress():
    src = ("# graftlint: disable=HY001\n"
           "import os\n"
           "print(1)\n")
    result = lint_sources({"mod.py": src})
    rules = {f.rule for f in result.findings}
    assert "GL001" in rules, "bare suppression must be reported"
    assert "HY001" in rules, "a reasonless suppression must not suppress"


def test_suppression_unknown_rule_is_gl002():
    src = ("# graftlint: disable=ZZ999 -- because\n"
           "print(1)\n")
    result = lint_sources({"mod.py": src})
    assert any(f.rule == "GL002" for f in result.findings)


def test_syntax_error_is_gl003_not_a_crash():
    result = lint_sources({"mod.py": "def broken(:\n"})
    assert any(f.rule == "GL003" for f in result.findings)


# ---------------------------------------------------------------------------
# baseline round-trip


def test_baseline_roundtrip(tmp_path):
    src = "import os\nprint(1)\n"
    first = lint_sources({"mod.py": src})
    assert first.findings
    path = tmp_path / "baseline.json"
    save_baseline(str(path), first.findings)
    keys = load_baseline(str(path))
    assert keys == sorted(f.key() for f in first.findings)
    second = lint_sources({"mod.py": src}, baseline_keys=keys)
    assert not second.findings
    assert len(second.baselined) == len(first.findings)
    # keys are line-independent: shifting the file must not churn
    shifted = lint_sources({"mod.py": "\n\n" + src}, baseline_keys=keys)
    assert not shifted.findings


def test_empty_baseline_masks_nothing():
    result = lint_sources({"mod.py": "import os\nprint(1)\n"},
                          baseline_keys=[])
    assert result.findings and not result.baselined


# ---------------------------------------------------------------------------
# reporters


def test_json_reporter_schema():
    result = lint_sources({"mod.py": "import os\nprint(1)\n"})
    payload = json.loads(render_json(result))
    assert payload["version"] == 1
    assert payload["counts"]["findings"] == len(result.findings) >= 1
    f = payload["findings"][0]
    assert {"path", "line", "col", "rule", "message"} <= set(f)
    assert f["rule"] == "HY001"


def test_text_reporter_clean_and_dirty():
    dirty = render_text(lint_sources({"mod.py": "import os\nprint(1)\n"}))
    assert "mod.py:1:1: HY001" in dirty
    clean = render_text(lint_sources({"mod.py": "print(1)\n"}))
    assert clean.startswith("clean:")


# ---------------------------------------------------------------------------
# CLI


def test_cli_lint_exit_codes_and_baseline(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    bad = tmp_path / "bad.py"
    bad.write_text("import os\nprint(1)\n")
    baseline = tmp_path / "baseline.json"

    assert main(["lint", str(bad), "--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert "HY001" in out

    assert main(["lint", str(bad), "--baseline", str(baseline),
                 "--write-baseline"]) == 0
    assert main(["lint", str(bad), "--baseline", str(baseline)]) == 0
    out = capsys.readouterr().out
    assert "clean" in out

    assert main(["lint", str(bad), "--baseline", str(baseline),
                 "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["findings"] == 0
    assert payload["counts"]["baselined"] == 1


def test_cli_lint_unknown_rule_is_usage_error(tmp_path):
    from deeprest_tpu_torch.cli import main

    f = tmp_path / "ok.py"
    f.write_text("print(1)\n")
    assert main(["lint", str(f), "--rules", "QQ123"]) == 2


def test_cli_list_rules(capsys):
    from deeprest_tpu_torch.cli import main

    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("JX001", "JX002", "JX003", "JX004", "TH001", "TH002",
                "TH003", "TH004", "HY001", "HY002", "GL001"):
        assert rid in out
    assert "1-ulp drift" in out   # rules cite the incidents they guard


def test_rule_registry_complete():
    rules = all_rules()
    assert {"JX001", "JX002", "JX003", "JX004", "JX005",
            "JX006", "JX007", "QT001",
            "TH001", "TH002", "TH003", "TH004",
            "HY001", "HY002", "OB001", "DN001", "DN002",
            "RS001", "RS002", "RS003", "RS004",
            "EX001", "EX002", "EX003", "EX004",
            "TN001", "WR001"} <= set(rules)
    for rule in rules.values():
        assert rule.title and rule.guards


# ---------------------------------------------------------------------------
# the whole-program call graph (core.CallGraph)


CG_WORKERS = """
import threading

def make_worker(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t

def make_indirect(fn):
    return make_worker(fn)

class Pool:
    def spawn(self, fn):
        return self._spawn_impl(fn)

    def _spawn_impl(self, fn):
        return make_worker(fn)
"""


def test_call_graph_resolves_self_module_and_cross_module_calls():
    from deeprest_tpu_torch.analysis.core import FuncKey, Project

    caller = """
from pkg.workers import make_worker
import pkg.workers

def local_helper():
    pass

def run(fn):
    local_helper()
    t = make_worker(fn)
    u = pkg.workers.make_indirect(fn)
    return t, u
"""
    project = Project.from_sources({"pkg/workers.py": CG_WORKERS,
                                    "pkg/caller.py": caller})
    graph = project.call_graph()
    run_key = FuncKey("pkg/caller.py", None, "run")
    edges = graph.edges(run_key)
    assert FuncKey("pkg/caller.py", None, "local_helper") in edges
    assert FuncKey("pkg/workers.py", None, "make_worker") in edges
    assert FuncKey("pkg/workers.py", None, "make_indirect") in edges
    # self._helper() resolves within the class
    spawn = FuncKey("pkg/workers.py", "Pool", "spawn")
    assert FuncKey("pkg/workers.py", "Pool", "_spawn_impl") \
        in graph.edges(spawn)
    assert graph.class_method_edges("pkg/workers.py", "Pool")["spawn"] \
        == {"_spawn_impl"}


def test_call_graph_reachable_is_depth_bounded():
    from deeprest_tpu_torch.analysis.core import FuncKey, Project

    chain = "\n".join(
        [f"def f{i}():\n    return f{i + 1}()" for i in range(12)]
        + ["def f12():\n    return 0"])
    project = Project.from_sources({"chain.py": chain})
    graph = project.call_graph()
    seed = {FuncKey("chain.py", None, "f0")}
    shallow = graph.reachable(seed, max_depth=3)
    assert FuncKey("chain.py", None, "f3") in shallow
    assert FuncKey("chain.py", None, "f5") not in shallow
    deep = graph.reachable(seed)        # the default bounded depth
    assert FuncKey("chain.py", None, "f8") in deep


def test_call_graph_ambiguous_module_suffix_resolves_to_nothing():
    from deeprest_tpu_torch.analysis.core import Project

    a = "def fn():\n    return 1\n"
    b = "def fn():\n    return 2\n"
    caller = "from util import fn\n\ndef go():\n    return fn()\n"
    project = Project.from_sources({
        "red/util.py": a, "blue/util.py": b, "app/caller.py": caller})
    graph = project.call_graph()
    # "util" is ambiguous between two files: the graph must not guess
    assert graph.resolve_module(("util",)) is None


# ---------------------------------------------------------------------------
# RS001: spawned resources discharged on every path


RS001_THREAD_BAD = """
import threading

def run(work):
    t = threading.Thread(target=work)
    t.start()
    work.wait()
"""

RS001_THREAD_GOOD = """
import threading

def run(work):
    t = threading.Thread(target=work)
    t.start()
    try:
        work.wait()
    finally:
        t.join()
"""

RS001_THREAD_DAEMON = """
import threading

def run(work):
    t = threading.Thread(target=work, daemon=True)
    t.start()
    work.wait()
"""


def test_rs001_thread_pair():
    assert_pair("RS001", RS001_THREAD_BAD, RS001_THREAD_GOOD)


def test_rs001_daemon_thread_is_silent():
    # a daemon thread dies with the process — no join obligation (a
    # daemon PROCESS still zombies until reaped and is NOT exempt)
    assert not findings_for("RS001", RS001_THREAD_DAEMON)


RS001_BOOT_BAD = """
import multiprocessing as mp

class Replica:
    def _boot(self, spec):
        ctx = mp.get_context("spawn")
        conn, child = ctx.Pipe(duplex=True)
        proc = ctx.Process(target=worker, args=(spec, child), daemon=True)
        proc.start()
        child.close()
        tag, ok, meta = conn.recv()   # EOFError here leaks conn AND proc
        self._conn = conn
        self._proc = proc
"""

RS001_BOOT_GOOD = """
import multiprocessing as mp

class Replica:
    def _boot(self, spec):
        ctx = mp.get_context("spawn")
        conn, child = ctx.Pipe(duplex=True)
        proc = None
        try:
            proc = ctx.Process(target=worker, args=(spec, child),
                               daemon=True)
            proc.start()
            child.close()
            tag, ok, meta = conn.recv()
            if not ok:
                raise RuntimeError(meta)
        except Exception:
            conn.close()
            child.close()
            if proc is not None and proc.pid is not None:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=5)
            raise
        self._conn = conn
        self._proc = proc
"""


def test_rs001_worker_boot_pair():
    # the round-16 incident shape: the handshake recv raising with the
    # worker subprocess and both pipe ends live
    fired = findings_for("RS001", RS001_BOOT_BAD, rel="serve/replica.py")
    kinds = {f.message.split()[0] for f in fired}
    assert "pipe" in kinds and "process" in kinds, fired
    assert not findings_for("RS001", RS001_BOOT_GOOD,
                            rel="serve/replica.py")


def test_rs001_escape_to_owner_discharges():
    # storing the handle on self transfers ownership — no leak even
    # though this function never joins
    src = """
import threading

class Server:
    def start(self):
        self._thread = threading.Thread(target=self._serve)
        self._thread.start()
        return self
"""
    assert not findings_for("RS001", src)


RS001_PROFILER_BAD = """
import jax

def capture(out_dir, seconds):
    jax.profiler.start_trace(out_dir)
    work(seconds)
    jax.profiler.stop_trace()
"""

RS001_PROFILER_GOOD = """
import jax

def capture(out_dir, seconds):
    jax.profiler.start_trace(out_dir)
    try:
        work(seconds)
    finally:
        jax.profiler.stop_trace()
"""


def test_rs001_profiler_window_pair():
    assert_pair("RS001", RS001_PROFILER_BAD, RS001_PROFILER_GOOD,
                rel="obs/profiler.py")


def test_rs001_profiler_stop_through_local_wrapper_is_silent():
    # cli.py's shape: stop_trace lives in a local def the finally calls
    src = """
import jax

def train(profile_dir):
    jax.profiler.start_trace(profile_dir)

    def stop_profiling():
        jax.profiler.stop_trace()

    try:
        fit()
    finally:
        stop_profiling()
"""
    assert not findings_for("RS001", src)


def test_rs001_cross_module_factory_pair():
    # the call graph resolves a factory in ANOTHER module that returns a
    # started thread; the caller owns the join obligation
    caller_bad = """
from pkg.workers import make_worker

def run(fn, work):
    t = make_worker(fn)
    work.wait()
"""
    caller_good = """
from pkg.workers import make_worker

def run(fn, work):
    t = make_worker(fn)
    try:
        work.wait()
    finally:
        t.join()
"""
    from deeprest_tpu_torch.analysis import lint_sources

    rules = [all_rules()["RS001"]]
    bad = lint_sources({"pkg/workers.py": CG_WORKERS,
                        "pkg/caller.py": caller_bad}, rules=rules)
    assert [f for f in bad.findings if f.path == "pkg/caller.py"], \
        "cross-module factory leak must fire in the CALLER"
    good = lint_sources({"pkg/workers.py": CG_WORKERS,
                         "pkg/caller.py": caller_good}, rules=rules)
    assert not good.findings


def test_rs001_cross_module_wrapper_chain_resolves():
    # a wrapper of a wrapper: make_indirect -> make_worker -> Thread
    caller = """
from pkg.workers import make_indirect

def run(fn, work):
    t = make_indirect(fn)
    work.wait()
"""
    from deeprest_tpu_torch.analysis import lint_sources

    res = lint_sources({"pkg/workers.py": CG_WORKERS,
                        "pkg/caller.py": caller},
                       rules=[all_rules()["RS001"]])
    assert [f for f in res.findings if f.path == "pkg/caller.py"]


def test_rs001_with_statement_file_is_silent():
    src = """
def read(path):
    with open(path) as f:
        return f.read()
"""
    assert not findings_for("RS001", src)


# ---------------------------------------------------------------------------
# RS002: lifecycle drain without resume/close (serve/ watchlist)


RS002_BAD = """
class Router:
    def stop_half(self, replicas):
        for r in replicas:
            r.drain()
"""

RS002_GOOD = """
class Router:
    def stop_half(self, replicas):
        for r in replicas:
            r.drain()
        for r in replicas:
            r.close()
"""


def test_rs002_pair():
    assert_pair("RS002", RS002_BAD, RS002_GOOD, rel="serve/router.py")


def test_rs002_early_return_between_drain_and_resume_fires():
    src = """
class Router:
    def reload(self, r, fresh):
        r.drain()
        if fresh is None:
            return None
        r.reload_backend(fresh)
        r.resume()
"""
    fired = findings_for("RS002", src, rel="serve/router.py")
    assert fired and "resume" in fired[0].message


def test_rs002_data_pop_drain_is_silent():
    # the span ring's drain() RETURNS the popped records — consuming the
    # result marks it a data pop, not a lifecycle pause
    src = """
class Forwarder:
    def flush(self, recorder, conn):
        batch = [r.to_dict() for r in recorder.drain()]
        if batch:
            conn.send(batch)
"""
    assert not findings_for("RS002", src, rel="serve/replica.py")


def test_rs002_outside_serve_watchlist_is_silent():
    assert not findings_for("RS002", RS002_BAD, rel="train/stream.py")


# ---------------------------------------------------------------------------
# RS003: __del__-reliance on hot objects


RS003_BAD = """
class Replica:
    def __del__(self):
        self._conn.close()
"""

RS003_GOOD = """
class Replica:
    def close(self):
        self._conn.close()
"""


def test_rs003_pair():
    assert_pair("RS003", RS003_BAD, RS003_GOOD, rel="serve/replica.py")


def test_rs003_non_cleanup_del_and_non_hot_dirs_are_silent():
    trivial = """
class Counted:
    def __del__(self):
        _COUNT.discard(id(self))
"""
    assert not findings_for("RS003", trivial, rel="serve/replica.py")
    assert not findings_for("RS003", RS003_BAD, rel="data/ingest.py")


# ---------------------------------------------------------------------------
# RS004: unbounded retry loops in the serving plane


RS004_BAD = """
class Router:
    def dispatch(self, replica, x):
        while True:
            try:
                return replica.predict(x)
            except ReplicaDeadError:
                pass
"""

RS004_GOOD = """
class Router:
    def dispatch(self, replica, x, budget=2):
        attempt = 0
        while True:
            try:
                return replica.predict(x)
            except ReplicaDeadError:
                attempt += 1
                if attempt > budget:
                    raise
"""


def test_rs004_pair():
    assert_pair("RS004", RS004_BAD, RS004_GOOD, rel="serve/router.py")


def test_rs004_backoff_discharges():
    # a paced retry (sleep/Event.wait) is bounded-RATE even when
    # unbounded in count — the probe-loop shape, silent by design
    src = """
import time

class Prober:
    def watch(self, replica):
        while True:
            try:
                replica.probe()
            except ReplicaDeadError:
                time.sleep(0.5)
"""
    assert not findings_for("RS004", src, rel="serve/router.py")


def test_rs004_loop_with_break_in_handler_is_silent():
    src = """
class Reader:
    def loop(self, conn):
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
"""
    assert not findings_for("RS004", src, rel="serve/replica.py")


RS004_RECURSIVE_BAD = """
class Client:
    def fetch(self, x):
        try:
            return self._do(x)
        except OSError:
            return self.fetch(x)
"""

RS004_RECURSIVE_GOOD = """
class Client:
    def fetch(self, x, attempt=0):
        if attempt >= 3:
            raise RuntimeError("gave up")
        try:
            return self._do(x)
        except OSError:
            return self.fetch(x, attempt + 1)
"""


def test_rs004_recursive_pair():
    assert_pair("RS004", RS004_RECURSIVE_BAD, RS004_RECURSIVE_GOOD,
                rel="serve/predictor.py")


def test_rs004_outside_serve_watchlist_is_silent():
    assert not findings_for("RS004", RS004_BAD, rel="train/stream.py")
    assert not findings_for("RS004", RS004_RECURSIVE_BAD,
                            rel="data/ingest.py")


# ---------------------------------------------------------------------------
# EX001: bare lock acquire not released on a raising path


EX001_BAD = """
import threading
_lock = threading.Lock()

def handle(req):
    _lock.acquire()
    out = work(req)
    _lock.release()
    return out
"""

EX001_GOOD = """
import threading
_lock = threading.Lock()

def handle(req):
    _lock.acquire()
    try:
        return work(req)
    finally:
        _lock.release()
"""


def test_ex001_pair():
    assert_pair("EX001", EX001_BAD, EX001_GOOD)


def test_ex001_fast_fail_acquire_shape_is_silent():
    # obs/profiler.py's capture window: on the `not acquire(...)` branch
    # the lock was never taken, so the raise there holds nothing
    src = """
import threading
_lock = threading.Lock()

def capture(seconds):
    if not _lock.acquire(blocking=False):
        raise RuntimeError("busy")
    try:
        return window(seconds)
    finally:
        _lock.release()
"""
    assert not findings_for("EX001", src)


def test_ex001_with_lock_is_silent():
    src = """
import threading
_lock = threading.Lock()

def handle(req):
    with _lock:
        return work(req)
"""
    assert not findings_for("EX001", src)


def test_ex001_early_return_with_lock_held_fires():
    src = """
import threading
_lock = threading.Lock()

def peek(flag):
    _lock.acquire()
    if flag:
        return True
    _lock.release()
    return False
"""
    fired = findings_for("EX001", src)
    assert fired and "not released" in fired[0].message


# ---------------------------------------------------------------------------
# EX002: exception strands the plane between paired publish points


EX002_BAD = """
class Router:
    def reload(self, replicas, fresh):
        for r in replicas:
            r.drain()
        for r in replicas:
            r.wait_idle()
            r.reload_backend(fresh)
            r.resume()
"""

EX002_GOOD = """
class Router:
    def reload(self, replicas, fresh):
        for r in replicas:
            r.drain()
        try:
            for r in replicas:
                r.wait_idle()
                r.reload_backend(fresh)
        finally:
            for r in replicas:
                r.resume()
"""


def test_ex002_pair():
    assert_pair("EX002", EX002_BAD, EX002_GOOD, rel="serve/router.py")


def test_ex002_caught_region_is_silent():
    # a per-replica except that keeps reclaiming the rest (scale_to's
    # fixed shape) absorbs the exception edge; the handler body must
    # itself be non-raising bookkeeping, or IT re-strands the plane
    src = """
class Router:
    def shrink(self, drop):
        errors = []
        for r in drop:
            r.drain()
        for r in drop:
            try:
                r.wait_idle()
                r.close()
            except Exception as exc:
                errors.append(str(exc))
"""
    assert not findings_for("EX002", src, rel="serve/router.py")


def test_ex002_outside_serve_watchlist_is_silent():
    assert not findings_for("EX002", EX002_BAD, rel="obs/spans.py")


# ---------------------------------------------------------------------------
# EX003: swallowed exceptions in the serve/train/obs watchlists


EX003_BAD = """
def poll(conn):
    try:
        return conn.recv()
    except Exception:
        pass
"""

EX003_GOOD = """
def poll(conn):
    try:
        return conn.recv()
    except Exception as exc:
        RECORDER.note_error(exc)
        return None
"""


def test_ex003_pair():
    assert_pair("EX003", EX003_BAD, EX003_GOOD, rel="serve/server.py")
    assert_pair("EX003", EX003_BAD, EX003_GOOD, rel="train/stream.py")
    assert_pair("EX003", EX003_BAD, EX003_GOOD, rel="obs/spans.py")


def test_ex003_bare_except_fires():
    src = "def f():\n    try:\n        g()\n    except:\n        pass\n"
    fired = findings_for("EX003", src, rel="serve/x.py")
    assert fired and "bare except" in fired[0].message


def test_ex003_narrow_typed_except_pass_is_silent():
    # best-effort shutdown sends on a closing pipe are a deliberate idiom
    src = """
def shutdown(conn):
    try:
        conn.send(None)
    except (OSError, BrokenPipeError):
        pass
"""
    assert not findings_for("EX003", src, rel="serve/replica.py")


def test_ex003_outside_watchlists_is_silent():
    assert not findings_for("EX003", EX003_BAD, rel="loadgen/cluster.py")


# ---------------------------------------------------------------------------
# EX004: device-loss family swallowed outside the elastic fault barrier


EX004_BAD = """
def run_epoch(trainer, state, batch):
    try:
        state, loss = trainer._train_step(state, batch)
    except XlaRuntimeError:
        state = None
    return state
"""

EX004_GOOD = """
def run_epoch(trainer, state, batch, bundle):
    try:
        state, loss = trainer._train_step(state, batch)
    except XlaRuntimeError as exc:
        if not is_device_loss(exc):
            raise
        state = trainer._handle_device_loss(bundle)
    return state
"""


def test_ex004_pair():
    assert_pair("EX004", EX004_BAD, EX004_GOOD, rel="train/trainer.py")
    assert_pair("EX004", EX004_BAD, EX004_GOOD, rel="parallel/elastic.py")


def test_ex004_broad_except_around_dispatch_fires():
    # a broad except is the family exactly when it wraps a dispatch —
    # the shape the ONE fault barrier owns
    src = """
def drive(superstep, state, plan):
    for c in range(8):
        try:
            state, losses = superstep(state, plan, c)
        except Exception as exc:
            print("oops", exc)
    return state
"""
    fired = findings_for("EX004", src, rel="train/trainer.py")
    assert fired and "barrier" in fired[0].message


def test_ex004_broad_except_without_dispatch_is_silent():
    # broad excepts around non-dispatch work (file IO, probes) are
    # EX003's turf, not the device-loss family
    src = """
def load(path):
    try:
        with open(path) as f:
            return f.read()
    except Exception:
        return None
"""
    assert not findings_for("EX004", src, rel="train/checkpoint.py")


def test_ex004_reraising_barrier_is_silent():
    # the real barrier's shape: classify, re-raise what it does not own
    src = """
def barrier(run, bundle):
    try:
        return run(bundle)
    except Exception as exc:
        if not is_device_loss(exc):
            raise
        return remesh_and_restore(bundle)
"""
    assert not findings_for("EX004", src, rel="train/trainer.py")


def test_ex004_outside_watchlist_is_silent():
    assert not findings_for("EX004", EX004_BAD, rel="serve/replica.py")
    assert not findings_for("EX004", EX004_BAD, rel="loadgen/cluster.py")


# ---------------------------------------------------------------------------
# TH001/TH003 call-graph migration: pre-migration verdicts, bit for bit


def test_th001_th003_verdicts_unchanged_after_callgraph_migration():
    """The transitive walks moved onto core.CallGraph; these verdicts
    were captured from the PRE-migration rule packs and must reproduce
    exactly (path, line, col, rule, full message)."""
    expected = {
        ("TH001", TH001_BAD): [
            ("mod.py", 11, 0, "TH001",
             "Service.count is written in _worker() (thread-side, no "
             "lock) and accessed in healthz() line 14 (no lock) — a "
             "data race between the class's threads; hold self._lock "
             "around every access")],
        ("TH001", TH001_GOOD): [],
        ("TH003", TH003_BAD): [
            ("mod.py", 11, 0, "TH003",
             "Replica.served is written in _worker() — a "
             "multiprocessing child entry — and read parent-side in "
             "outstanding() line 14; the child mutates its OWN copy of "
             "the object, so the parent never observes this write.  "
             "Route it through the process boundary explicitly "
             "(Pipe/Queue/Value/shared memory)")],
        ("TH003", TH003_GOOD): [],
    }
    for (rid, src), want in expected.items():
        result = lint_sources({"mod.py": src}, rules=[all_rules()[rid]])
        got = [(f.path, f.line, f.col, f.rule, f.message)
               for f in result.findings]
        assert got == want, f"{rid} verdict drifted: {got}"


# ---------------------------------------------------------------------------
# reporters: SARIF + suppression inventory


def test_sarif_reporter_schema():
    from deeprest_tpu_torch.analysis import render_sarif

    result = lint_sources({"mod.py": "import os\nprint(1)\n"})
    payload = json.loads(render_sarif(result))
    assert payload["version"] == "2.1.0"
    run = payload["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftlint"
    assert any(r["id"] == "HY001"
               for r in run["tool"]["driver"]["rules"])
    res = run["results"][0]
    assert res["ruleId"] == "HY001"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "mod.py"
    assert loc["region"]["startLine"] == 1
    assert loc["region"]["startColumn"] >= 1


def test_suppression_inventory_and_renderings():
    from deeprest_tpu_torch.analysis import (
        Project, render_suppressions_json, render_suppressions_markdown,
        render_suppressions_text, suppression_inventory,
    )

    src = ("import threading\n"
           "# graftlint: disable=HY001 -- kept for the doc example\n"
           "import os\n"
           "# graftlint: disable=HY001\n"
           "import sys\n")
    entries = suppression_inventory(Project.from_sources({"m.py": src}))
    # the reasonless disable is a GL001 finding, NOT an inventory row
    assert [(e.rule, e.path, e.line) for e in entries] \
        == [("HY001", "m.py", 2)]
    text = render_suppressions_text(entries)
    assert "HY001  m.py:2  -- kept for the doc example" in text
    payload = json.loads(render_suppressions_json(entries))
    assert payload["count"] == 1
    md = render_suppressions_markdown(entries)
    assert "| HY001 | `m.py` | 1 | kept for the doc example |" in md
    assert "m.py:2" not in md      # line numbers would churn the doc


# ---------------------------------------------------------------------------
# CLI: --changed, --list-suppressions, --jobs


def test_cli_lint_changed_scopes_findings_to_git_diff(tmp_path):
    import shutil
    import subprocess

    from deeprest_tpu_torch.cli import main

    if shutil.which("git") is None:
        pytest.skip("git unavailable")
    repo = tmp_path / "repo"
    repo.mkdir()

    def git(*argv):
        return subprocess.run(
            ["git", "-C", str(repo), *argv], capture_output=True,
            text=True, env={"GIT_AUTHOR_NAME": "t",
                            "GIT_AUTHOR_EMAIL": "t@t",
                            "GIT_COMMITTER_NAME": "t",
                            "GIT_COMMITTER_EMAIL": "t@t",
                            "HOME": str(tmp_path), "PATH": "/usr/bin:/bin"})

    assert git("init", "-q").returncode == 0
    clean = repo / "clean.py"
    dirty = repo / "dirty.py"
    clean.write_text("import os\nprint(1)\n")      # committed finding
    dirty.write_text("print(1)\n")
    git("add", ".")
    assert git("commit", "-q", "-m", "seed").returncode == 0
    dirty.write_text("import sys\nprint(1)\n")     # NEW finding, changed

    baseline = tmp_path / "b.json"
    # unscoped: both files' findings fail the run
    assert main(["lint", str(repo), "--baseline", str(baseline)]) == 1
    # --changed: only dirty.py's finding is reported; it still fails...
    assert main(["lint", str(repo), "--baseline", str(baseline),
                 "--changed", "--format", "json"]) == 1
    # ...and with only clean.py's finding live, --changed exits 0
    dirty.write_text("print(1)\n")
    assert main(["lint", str(repo), "--baseline", str(baseline),
                 "--changed"]) == 0


def test_cli_lint_changed_json_only_reports_changed_files(tmp_path,
                                                          capsys):
    import shutil
    import subprocess

    from deeprest_tpu_torch.cli import main

    if shutil.which("git") is None:
        pytest.skip("git unavailable")
    repo = tmp_path / "repo"
    repo.mkdir()
    env = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
           "HOME": str(tmp_path), "PATH": "/usr/bin:/bin"}
    subprocess.run(["git", "-C", str(repo), "init", "-q"], env=env)
    (repo / "clean.py").write_text("import os\nprint(1)\n")
    subprocess.run(["git", "-C", str(repo), "add", "."], env=env)
    subprocess.run(["git", "-C", str(repo), "commit", "-q", "-m", "s"],
                   env=env)
    (repo / "dirty.py").write_text("import sys\nprint(1)\n")  # untracked

    main(["lint", str(repo), "--baseline", str(tmp_path / "b.json"),
          "--changed", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    paths = {f["path"] for f in payload["findings"]}
    assert paths == {"dirty.py"}


def test_cli_list_suppressions(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    f = tmp_path / "m.py"
    f.write_text("# graftlint: disable=HY001 -- doc example\n"
                 "import os\nprint(1)\n")
    assert main(["lint", str(f), "--list-suppressions"]) == 0
    out = capsys.readouterr().out
    assert "HY001  m.py:1  -- doc example" in out
    assert main(["lint", str(f), "--list-suppressions",
                 "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == 1
    assert payload["suppressions"][0]["rule"] == "HY001"


def test_parallel_parse_matches_serial(tmp_path, monkeypatch):
    from deeprest_tpu_torch.analysis import core as analysis_core

    paths = []
    for i in range(30):
        p = tmp_path / f"m{i}.py"
        p.write_text(f"import os\n\ndef f{i}():\n    return {i}\n")
        paths.append((f"m{i}.py", str(p)))
    serial = analysis_core.parse_files(paths, jobs=1)
    monkeypatch.setattr(analysis_core, "_PARALLEL_MIN_FILES", 8)
    parallel = analysis_core.parse_files(paths, jobs=2)
    assert [(s.rel, s.source) for s in serial] \
        == [(s.rel, s.source) for s in parallel]
    # parsed trees survive the pool round-trip
    assert all(s.tree is not None for s in parallel)
    from deeprest_tpu_torch.analysis.core import Project, lint_project

    a = lint_project(Project(serial))
    b = lint_project(Project(parallel))
    assert [f.key() for f in a.findings] == [f.key() for f in b.findings]


# ---------------------------------------------------------------------------
# graftflow: the value-flow engine (analysis/dataflow.py) — lattice units


def test_absval_join_and_bottom_identity():
    from deeprest_tpu_torch.analysis.dataflow import AbsVal, BOTTOM, TOP

    a = AbsVal(dtype="f32", domain="device")
    b = AbsVal(dtype="f64", domain="host", dense=True,
               origins=(("m.py", 1, 0),))
    j = a.join(b)
    # join is the lattice join (least upper bound), NOT dtype promotion
    assert j.dtype == TOP and j.domain == TOP
    assert j.dense and j.width is False
    assert j.origins == (("m.py", 1, 0),)
    assert BOTTOM.join(a) == a and a.join(BOTTOM) == a
    assert a.join(a) == a


def test_dtype_promotion_lattice():
    from deeprest_tpu_torch.analysis.dataflow import promote_dtype

    # f64 infects everything it touches
    assert promote_dtype("f32", "f64") == "f64"
    assert promote_dtype("bf16", "f64") == "f64"
    # a weak python scalar never widens a strong array
    assert promote_dtype("wfloat", "bf16") == "bf16"
    assert promote_dtype("wfloat", "f32") == "f32"
    # ...but it DOES float an integer array (the JX006 class)
    assert promote_dtype("int", "wfloat") == "wfloat"
    assert promote_dtype("wint", "f32") == "f32"
    assert promote_dtype("bot", "f32") == "f32"


def test_origin_widening_cap():
    from deeprest_tpu_torch.analysis.dataflow import AbsVal, _MAX_ORIGINS

    a = AbsVal(dense=True,
               origins=tuple((f"a{i}.py", i, 0) for i in range(3)))
    b = AbsVal(dense=True,
               origins=tuple((f"b{i}.py", i, 0) for i in range(3)))
    j = a.join(b)
    assert len(j.origins) == _MAX_ORIGINS   # widened, never unbounded


def test_tuple_structure_join_and_collapse():
    from deeprest_tpu_torch.analysis.dataflow import AbsVal, make_tuple

    dense = AbsVal(dense=True, origins=(("m.py", 1, 0),))
    plain = AbsVal()
    t1 = make_tuple([dense, plain])
    t2 = make_tuple([plain, plain])
    j = t1.join(t2)
    assert j.elts is not None and len(j.elts) == 2
    assert j.elts[0].dense and not j.elts[1].dense
    # arity mismatch collapses structure but keeps the scalar join
    t3 = make_tuple([plain])
    k = t1.join(t3)
    assert k.elts is None and k.dense


def test_valueflow_summary_reuse_and_interprocedural_join():
    from deeprest_tpu_torch.analysis import Project
    from deeprest_tpu_torch.analysis.core import FuncKey
    from deeprest_tpu_torch.analysis.dataflow import ValueFlow

    project = Project.from_sources({
        "serve/a.py": (
            "from helpers.h import use\n"
            "import numpy as np\n\n"
            "def run(capacity):\n"
            "    buf = np.zeros((4, capacity), np.float32)\n"
            "    return use(buf)\n"),
        "serve/b.py": (
            "from helpers.h import use\n\n"
            "def other(x):\n"
            "    return use(x)\n"),
        "helpers/h.py": "def use(x):\n    return x\n",
    })
    vf = ValueFlow.of(project)
    assert ValueFlow.of(project) is vf      # one engine per Project
    key = FuncKey("helpers/h.py", None, "use")
    # the callee's param is the JOIN of both call sites' arguments:
    # serve/a passes a dense buffer, serve/b an unknown — may-taint wins
    param = vf.param_summary(key)["x"]
    assert param.dense and param.origins
    # ...and the identity return carries the taint back out
    assert vf.summary_return(key).dense
    assert vf.rounds_used <= 4              # termination bound held


# ---------------------------------------------------------------------------
# DN002: interprocedural dense taint (graftflow)


DN002_BAD = """
import numpy as np

class Pool:
    def refresh(self, rows):
        buf = np.zeros((len(rows), self.capacity), np.float32)
        return buf
"""

DN002_GOOD = """
import numpy as np

class Pool:
    def refresh(self, rows, kmax):
        cols = np.zeros((len(rows), kmax), np.int32)
        return cols
"""


def test_dn002_pair():
    # an F-trailing host alloc in serve/ fires even though DN001's
    # watchlist never covered serve/ — the zone itself is the sink
    assert_pair("DN002", DN002_BAD, DN002_GOOD, rel="serve/pool.py")


def test_dn002_cross_module_chain_fires_at_origin():
    # the dense buffer is allocated in a helper OUTSIDE every watchlist
    # and reaches the serving plane through a call chain; the finding
    # anchors at the ORIGIN allocation, in the helper
    caller = """
from helpers.alloc import make_buffer

def stage(n, capacity):
    buf = make_buffer(n, capacity)
    return buf
"""
    callee = """
import numpy as np

def make_buffer(n, width):
    return np.zeros((n, width), np.float32)
"""
    result = lint_sources({"serve/stage.py": caller,
                           "helpers/alloc.py": callee},
                          rules=[all_rules()["DN002"]])
    assert [(f.path, f.rule) for f in result.findings] == [
        ("helpers/alloc.py", "DN002")]
    # same helper with no dense flow into a zone stays silent
    result = lint_sources({"etl/stage.py": caller,
                           "helpers/alloc.py": callee},
                          rules=[all_rules()["DN002"]])
    assert not result.findings


def test_dn002_tuple_unpack_propagation():
    src = """
import numpy as np

def build(n, capacity):
    shape = (n, capacity)
    bufs = (np.zeros(shape, np.float32), np.zeros((n, 4), np.float32))
    dense, small = bufs
    return dense
"""
    fired = findings_for("DN002", src, rel="serve/unpack.py")
    # exactly the F-wide member of the unpacked tuple fires (through a
    # shape VARIABLE, no literal marker at the alloc site), the small
    # one stays silent
    assert len(fired) == 1
    assert fired[0].line == 6


def test_dn002_dn001_sites_have_one_owner():
    # a marker-shaped alloc inside DN001's own watchlist is DN001's
    # finding; DN002 must not double-report it
    fired = findings_for("DN002", DN001_BAD, rel="train/stream.py")
    assert not fired
    assert findings_for("DN001", DN001_BAD, rel="train/stream.py")


def test_dn002_attribute_store_propagation():
    # the dense buffer crosses METHODS through the attribute table
    # (stored in fill(), read through view()) and crosses MODULES into
    # the serving zone through a resolved Class.method call; the
    # finding still anchors at the origin allocation in the helper
    ring = """
import numpy as np

class Ring:
    def fill(self, n, capacity):
        self._buf = np.zeros((n, capacity), np.float32)

    def view(self):
        return self._buf
"""
    reader = """
from helpers.ring import Ring

def read(r):
    return Ring.view(r)
"""
    result = lint_sources({"helpers/ring.py": ring,
                           "serve/reader.py": reader},
                          rules=[all_rules()["DN002"]])
    assert [(f.path, f.line) for f in result.findings] == [
        ("helpers/ring.py", 6)]
    # without the zone-side reader the helper alone stays silent
    result = lint_sources({"helpers/ring.py": ring},
                          rules=[all_rules()["DN002"]])
    assert not result.findings


# ---------------------------------------------------------------------------
# JX006: dtype-promotion hazards inside jit-traced code (graftflow)


JX006_BAD = """
import jax
import numpy as np
import jax.numpy as jnp

def make_step():
    def step(params, x):
        mask = np.zeros(x.shape)
        return jnp.sum(x * mask)
    return jax.jit(step)
"""

JX006_GOOD = """
import jax
import jax.numpy as jnp

def make_step():
    def step(params, x):
        mask = jnp.zeros(x.shape, jnp.float32)
        return jnp.sum(x * mask)
    return jax.jit(step)
"""


def test_jx006_pair():
    assert_pair("JX006", JX006_BAD, JX006_GOOD)


def test_jx006_helper_reached_through_call_graph():
    # the f64-defaulting np call hides in a helper the jitted function
    # calls — the syntactic packs cannot see it, the closure can
    src = """
import jax
import numpy as np

def scale_table(n):
    return np.linspace(0.0, 1.0, n)

def make_step():
    def step(params, x):
        return x * scale_table(4)
    return jax.jit(step)
"""
    fired = findings_for("JX006", src)
    assert len(fired) == 1 and fired[0].line == 6
    # explicit dtype silences: the constant is deliberate, no silent f64
    src_ok = src.replace("np.linspace(0.0, 1.0, n)",
                         "np.linspace(0.0, 1.0, n, dtype=np.float32)")
    assert not findings_for("JX006", src_ok)


def test_jx006_f64_cast_inside_jit_fires():
    src = """
import jax
import jax.numpy as jnp
import numpy as np

@jax.jit
def step(x):
    return x.astype(np.float64) * 2.0
"""
    fired = findings_for("JX006", src)
    assert fired and "float64" in fired[0].message


def test_jx006_np_outside_jit_is_silent():
    src = """
import numpy as np

def host_etl(rows):
    return np.zeros((len(rows), 8))
"""
    assert not findings_for("JX006", src)


# ---------------------------------------------------------------------------
# JX007: transitive host/device crossings (graftflow)


JX007_BAD = {
    "train/trainer.py": """
from train.helpers import collect

class Trainer:
    def fit(self, batches):
        return collect(batches)
""",
    "train/helpers.py": """
import jax.numpy as jnp
import numpy as np

def collect(batches):
    out = []
    for b in batches:
        dev = jnp.sum(b)
        out.append(np.asarray(dev))
    return out
""",
}

JX007_GOOD = {
    "train/trainer.py": JX007_BAD["train/trainer.py"],
    "train/helpers.py": """
import jax.numpy as jnp
import numpy as np

def collect(batches):
    out = []
    for b in batches:
        out.append(jnp.sum(b))
    return np.asarray(out)
""",
}


def test_jx007_transitive_readback_pair():
    result = lint_sources(JX007_BAD, rules=[all_rules()["JX007"]])
    assert [(f.path, f.line) for f in result.findings] == [
        ("train/helpers.py", 9)]
    assert "device" in result.findings[0].message
    result = lint_sources(JX007_GOOD, rules=[all_rules()["JX007"]])
    assert not result.findings


def test_jx007_unreached_helper_is_silent():
    # same loop readback, but nothing from the trainer/fused/batcher
    # entry points reaches it — reachability, not directory, decides
    sources = {"workload/helpers.py": JX007_BAD["train/helpers.py"]}
    result = lint_sources(sources, rules=[all_rules()["JX007"]])
    assert not result.findings


def test_jx007_host_value_is_silent():
    # np.asarray on a value the engine can only prove is HOST data must
    # not fire — that was JX003's false-positive class, solved here by
    # the domain lattice instead of suppressions
    sources = {
        "train/trainer.py": JX007_BAD["train/trainer.py"],
        "train/helpers.py": """
import numpy as np

def collect(batches):
    out = []
    for b in batches:
        row = np.asarray([float(x) for x in b])
        out.append(row)
    return out
""",
    }
    result = lint_sources(sources, rules=[all_rules()["JX007"]])
    assert not result.findings


def test_jx007_jx003_watchlist_stays_jx003s():
    # inside serve/ (JX003's syntactic beat) JX007 must stay silent even
    # on a proven device readback — one owner per site
    sources = {
        "serve/batcher.py": """
import jax.numpy as jnp
import numpy as np

def drain(pages):
    out = []
    for p in pages:
        d = jnp.sum(p)
        out.append(np.asarray(d))
    return out
""",
    }
    result = lint_sources(sources, rules=[all_rules()["JX007"]])
    assert not result.findings
    assert lint_sources(sources,
                        rules=[all_rules()["JX003"]]).findings


# ---------------------------------------------------------------------------
# QT001: int8 quantized weight promoted to float outside ops/quantize.py


QT001_BAD = """
import jax.numpy as jnp

def apply_weight(x):
    w = jnp.zeros((4, 8), dtype=jnp.int8)
    return jnp.dot(x, w.astype(jnp.float32))
"""

QT001_GOOD = """
import jax.numpy as jnp

def apply_weight(x):
    w = jnp.zeros((4, 8), dtype=jnp.float32)
    return jnp.dot(x, w)
"""


def test_qt001_pair():
    assert_pair("QT001", QT001_BAD, QT001_GOOD, rel="ops/mod.py")


def test_qt001_matmul_consumer_fires():
    # no astype, no BinOp — handing the raw int8 operand to the
    # matmul family must fire at the consumer (XLA promotes inside
    # the op with the scale never applied)
    bad = """
import jax.numpy as jnp

def apply_weight(x):
    w = jnp.zeros((4, 8), dtype=jnp.int8)
    return jnp.dot(x, w)
"""
    fired = findings_for("QT001", bad, rel="serve/mod.py")
    assert fired and "dot" in fired[0].message


def test_qt001_binop_promotion_fires():
    bad = """
import jax.numpy as jnp

def scale_weight(x):
    w = jnp.zeros((4, 8), dtype=jnp.int8)
    return w * 0.5 + x
"""
    assert findings_for("QT001", bad, rel="ops/mod.py")


QT001_INTERPROC_BAD = {
    "serve/engine.py": """
from ops.helpers import apply_weight
import jax.numpy as jnp

def serve(x):
    w = jnp.zeros((4, 8), dtype=jnp.int8)
    return apply_weight(w, x)
""",
    "ops/helpers.py": """
import jax.numpy as jnp

def apply_weight(w, x):
    return jnp.dot(x, w.astype(jnp.float32))
""",
}


def test_qt001_interprocedural_fires_at_origin():
    # the int8 tensor is born in serve/, the raw cast happens in a
    # helper — the finding lands where the scale was dropped, along
    # ANY call chain into ops//serve/
    result = lint_sources(QT001_INTERPROC_BAD,
                          rules=[all_rules()["QT001"]])
    assert [(f.path, f.line) for f in result.findings] == [
        ("ops/helpers.py", 5)]


def test_qt001_sanctioned_dequant_site_is_silent():
    # the IDENTICAL cast inside ops/quantize.py is the sanctioned
    # dequant helper — the one place i8 -> f32 is the whole point
    sources = {
        "serve/engine.py": """
from ops.quantize import dequantize
import jax.numpy as jnp

def serve(x):
    w = jnp.zeros((4, 8), dtype=jnp.int8)
    return dequantize(w, x)
""",
        "ops/quantize.py": """
import jax.numpy as jnp

def dequantize(w, x):
    return jnp.dot(x, w.astype(jnp.float32) * 0.01)
""",
    }
    result = lint_sources(sources, rules=[all_rules()["QT001"]])
    assert not result.findings


def test_qt001_outside_hot_dirs_is_silent():
    # int8 escapes in fixture/tooling files are not weight data
    assert not findings_for("QT001", QT001_BAD, rel="tools/mod.py")


# ---------------------------------------------------------------------------
# DN001-on-graftflow: pre-migration verdicts, bit for bit


DN001_PIN_MSG = (
    "dense traffic allocation with a capacity-wide trailing dimension "
    "in a sparse-first hot module: carry (cols, vals) padded-COO rows "
    "and let ops/densify.py scatter on device (suppress with a reason "
    "only for the pinned dense reference paths)")


def test_dn001_verdicts_unchanged_after_dataflow_migration():
    """DN001 moved onto the value-flow engine's allocation-site table
    (round 19); these verdicts were captured from the PRE-migration
    syntactic rule and must reproduce exactly (path, line, col, rule,
    full message) — the TH001/TH003 round-16 playbook."""
    expected = {
        ("train/stream.py", DN001_BAD): [
            ("train/stream.py", 5, 8, "DN001", DN001_PIN_MSG)],
        ("data/featurize.py", DN001_BAD): [
            ("data/featurize.py", 5, 8, "DN001", DN001_PIN_MSG)],
        ("train/stream.py", DN001_GOOD): [],
        ("obs/quality.py", DN001_OBS_BAD): [
            ("obs/quality.py", 6, 17, "DN001", DN001_PIN_MSG)],
        ("obs/quality.py", DN001_OBS_GOOD): [],
        ("ops/densify.py", DN001_OBS_BAD): [],
        # round 22: quantization walks every weight tensor per reload —
        # ops/quantize.py joins the sparse-first watchlist
        ("ops/quantize.py", DN001_BAD): [
            ("ops/quantize.py", 5, 8, "DN001", DN001_PIN_MSG)],
    }
    for (rel, src), want in expected.items():
        result = lint_sources({rel: src}, rules=[all_rules()["DN001"]])
        got = [(f.path, f.line, f.col, f.rule, f.message)
               for f in result.findings]
        assert got == want, f"DN001 verdict drifted for {rel}: {got}"


# ---------------------------------------------------------------------------
# GL004 + the registry audit


def test_gl004_uncited_rule_fires():
    from deeprest_tpu_torch.analysis.core import Rule

    class UncitedRule(Rule):
        id = "ZZ901"
        title = "a rule with no citation"
        guards = ""

        def run(self, project):
            return iter(())

    result = lint_sources({"mod.py": "x = 1\n"}, rules=[UncitedRule()])
    gl = [f for f in result.findings if f.rule == "GL004"]
    assert len(gl) == 1
    assert "ZZ901" in gl[0].message and "UncitedRule" in gl[0].message
    assert gl[0].path == "<registry>"   # class not in the linted tree


def test_gl004_cited_rules_are_silent():
    result = lint_sources({"mod.py": "x = 1\n"})
    assert not [f for f in result.findings if f.rule == "GL004"]


# ---------------------------------------------------------------------------
# TX: the port's CUDA-graph pack (rules_torch.py), on the fixture pairs it
# shares with chip_smoke.py's phase 22 (analysis/torch_fixtures.py; the
# cross-module pairs and the torch vocabulary of JX007/QT001 are in
# tests/test_torch_analysis_torch.py)

from deeprest_tpu_torch.analysis import torch_fixtures as _torch_fixtures

TX001_BAD, TX001_GOOD = _torch_fixtures.PAIRS["TX001"][1:]
TX002_BAD, TX002_GOOD = _torch_fixtures.PAIRS["TX002"][1:]
TX004_BAD, TX004_GOOD = _torch_fixtures.PAIRS["TX004"][1:]
TX005_BAD, TX005_GOOD = _torch_fixtures.PAIRS["TX005"][1:]
TX006_BAD, TX006_GOOD = _torch_fixtures.PAIRS["TX006"][1:]


@pytest.mark.parametrize("rule,bad,good", [
    ("TX001", TX001_BAD, TX001_GOOD), ("TX002", TX002_BAD, TX002_GOOD),
    ("TX004", TX004_BAD, TX004_GOOD), ("TX005", TX005_BAD, TX005_GOOD),
    ("TX006", TX006_BAD, TX006_GOOD)])
def test_tx_pack_fires_on_bad_and_is_silent_on_good(rule, bad, good):
    fired = lint_sources(bad, rules=[all_rules()[rule]]).findings
    assert fired and all(f.rule == rule for f in fired)
    assert not lint_sources(good, rules=[all_rules()[rule]]).findings


def test_registry_audit_every_rule_cited_and_fixtured():
    """The GL004 contract, enforced at the registry: every registered
    rule declares its guarded incident AND has a fire+silent fixture
    pair in this file (assert_pair("<ID>", ...) or <ID>_BAD/<ID>_GOOD
    constants) — a future pack cannot land uncited or untested."""
    import os

    src = open(os.path.abspath(__file__), encoding="utf-8").read()
    for rid, rule in sorted(all_rules().items()):
        assert rule.title, f"{rid} has no title"
        assert rule.guards, (
            f"{rid} has no guarded-incident citation (GL004 would fire "
            "on any lint run including it)")
        has_fixtures = (f'assert_pair("{rid}"' in src
                        or (f"{rid}_BAD" in src and f"{rid}_GOOD" in src))
        assert has_fixtures, (
            f"{rid} has no fire/silent fixture pair in "
            "tests/test_torch_analysis.py")


# ---------------------------------------------------------------------------
# RC pack: graftrace interprocedural lockset race detection
# (analysis/locksets.py + analysis/rules_races.py)


# The round-24 incident shape: commit() extends the latency deque under
# _stats_lock while stats() iterates it with no lock.  The mutation is
# an ast.Load plus a method call — invisible to TH001/TH004's
# written_outside_init, which is why the RC pack exists.
RC001_BAD = """
import collections
import threading


class Receiver:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self._lat = collections.deque(maxlen=4096)

    def commit(self, batch):
        with self._stats_lock:
            self._lat.extend(batch)

    def stats(self):
        return sorted(self._lat)
"""

RC001_GOOD = """
import collections
import threading


class Receiver:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self._lat = collections.deque(maxlen=4096)

    def commit(self, batch):
        with self._stats_lock:
            self._lat.extend(batch)

    def stats(self):
        with self._stats_lock:
            return sorted(self._lat)
"""


def test_rc001_pair():
    assert_pair("RC001", RC001_BAD, RC001_GOOD)


def test_rc001_two_site_witness_and_guard_inference():
    f = findings_for("RC001", RC001_BAD)[0]
    assert (f.line, f.col) == (16, 22)          # the unguarded read
    assert "inferred guard self._stats_lock covers 1/2 accesses" \
        in f.message
    assert "external caller" in f.message       # both call chains inline
    # the guarded witness site rides in Finding.related → SARIF
    assert f.related == (("mod.py", 13, 12,
                          "guarded witness: commit() holds "
                          "self._stats_lock"),)


def test_rc001_fully_unguarded_attr_is_out_of_scope():
    # the RacerD precision trade: no guarded access anywhere means no
    # evidence of guard intent — the single-writer / GIL-atomic designs
    # (SpanFirehoseReceiver._out) stay silent by construction
    src = RC001_BAD.replace(
        "        with self._stats_lock:\n"
        "            self._lat.extend(batch)\n",
        "        self._lat.extend(batch)\n")
    assert not findings_for("RC001", src)


RC002_BAD = """
import threading


class Plane:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._a:
            self.total += n

    def drain(self):
        with self._b:
            self.total = 0
"""

RC002_GOOD = """
import threading


class Plane:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._a:
            self.total += n

    def drain(self):
        with self._a:
            self.total = 0
"""


def test_rc002_pair():
    assert_pair("RC002", RC002_BAD, RC002_GOOD)


RC_CONDITION_ALIAS = """
import threading


class Replica:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.outstanding = 0

    def begin(self, n):
        with self._lock:
            self.outstanding += n

    def end(self, n):
        with self._cv:
            self.outstanding -= n
            self._cv.notify_all()
"""


def test_rc002_condition_wrapping_the_lock_aliases_it():
    """threading.Condition(self._lock) WRAPS the lock: `with self._cv`
    and `with self._lock` take the same mutex, so the EngineReplica
    _cv/_lock pair is ONE guard — the first whole-repo run's two false
    positives, fixed in the engine rather than suppressed."""
    assert not findings_for("RC002", RC_CONDITION_ALIAS)
    assert not findings_for("RC001", RC_CONDITION_ALIAS)


# The round-23 incident shape: dispatch reads the params tree under the
# engine lock, releases, and acts on the stale snapshot under a fresh
# acquire — minting a second C++ dispatch-cache signature when a spill
# interleaves.
RC003_BAD = """
import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.params = {}

    def swap(self, fresh):
        with self._lock:
            self.params = fresh

    def dispatch(self, x):
        with self._lock:
            tree = self.params
        sig = trace_signature(tree, x)
        with self._lock:
            self.params = retrace(sig)
"""

RC003_GOOD = """
import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.params = {}

    def swap(self, fresh):
        with self._lock:
            self.params = fresh

    def dispatch(self, x):
        with self._lock:
            tree = self.params
            sig = trace_signature(tree, x)
            self.params = retrace(sig)
"""


def test_rc003_pair():
    assert_pair("RC003", RC003_BAD, RC003_GOOD)


def test_rc003_revalidation_in_the_act_section_is_silent():
    # the other sanctioned remediation (ReplicaRouter.scale_to): re-read
    # the attribute inside the act section before writing
    src = RC003_BAD.replace(
        "        with self._lock:\n"
        "            self.params = retrace(sig)\n",
        "        with self._lock:\n"
        "            if self.params is tree:\n"
        "                self.params = retrace(sig)\n")
    assert not findings_for("RC003", src)


def test_rc003_check_site_rides_in_related():
    f = findings_for("RC003", RC003_BAD)[0]
    assert f.line == 19                          # the act (stale write)
    assert f.related[0][1] == 16                 # the check (locked read)
    assert "released before the act" in f.related[0][3]


RC004_BAD = """
import threading


class Ring:
    def __init__(self):
        self._lock = threading.Lock()
        self._slots = []

    def add(self, item):
        with self._lock:
            self._slots.append(item)

    def snapshot(self):
        with self._lock:
            return self._slots
"""

RC004_GOOD = """
import threading


class Ring:
    def __init__(self):
        self._lock = threading.Lock()
        self._slots = []

    def add(self, item):
        with self._lock:
            self._slots.append(item)

    def snapshot(self):
        with self._lock:
            return list(self._slots)
"""


def test_rc004_pair():
    assert_pair("RC004", RC004_BAD, RC004_GOOD)


TH_RC_PIN = """
import threading


class Plane:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.mode = "idle"

    def start(self):
        threading.Thread(target=self._worker, daemon=True).start()

    def _worker(self):
        while True:
            self.count += 1

    def healthz(self):
        return self.count


class Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def snapshot(self):
        return self.total
"""


def test_th001_th004_verdicts_unchanged_with_rc_pack_live():
    """These verdicts were captured BEFORE the RC pack landed and must
    reproduce bit-for-bit (path, line, col, rule, full message): the
    lockset engine shares rules_threading's factories and runs the TH
    rules internally for its ownership ledger, so any drift here means
    the pack changed the rules it was built to complement."""
    expected = {
        "TH001": [
            ("mod.py", 16, 0, "TH001",
             "Plane.count is written in _worker() (thread-side, no "
             "lock) and accessed in healthz() line 19 (no lock) — a "
             "data race between the class's threads; hold self._lock "
             "around every access")],
        "TH004": [
            ("mod.py", 32, 0, "TH004",
             "Ledger.total is read in snapshot() without the class "
             "lock, but add() line 29 guards the same attribute with "
             "self._lock — one unguarded access defeats the lock; hold "
             "it on every access")],
    }
    for rid, want in expected.items():
        result = lint_sources({"mod.py": TH_RC_PIN},
                              rules=[all_rules()[rid]])
        got = [(f.path, f.line, f.col, f.rule, f.message)
               for f in result.findings]
        assert got == want, f"{rid} verdict drifted: {got}"


def test_rc_never_double_reports_a_th_owned_site():
    """One owner per site: Plane.count is TH001's, Ledger.total is
    TH004's — a full-registry run reports each exactly once, with no RC
    finding stacked on top."""
    result = lint_sources({"mod.py": TH_RC_PIN})
    rules = sorted(f.rule for f in result.findings)
    assert rules == ["TH001", "TH004"], rules


def test_sarif_related_locations_for_two_site_witness():
    from deeprest_tpu_torch.analysis import render_sarif

    result = lint_sources({"mod.py": RC001_BAD},
                          rules=[all_rules()["RC001"]])
    payload = json.loads(render_sarif(result))
    res = payload["runs"][0]["results"][0]
    assert res["ruleId"] == "RC001"
    rel = res["relatedLocations"][0]
    assert rel["physicalLocation"]["artifactLocation"]["uri"] == "mod.py"
    assert rel["physicalLocation"]["region"]["startLine"] == 13
    assert rel["physicalLocation"]["region"]["startColumn"] == 13
    assert "holds self._stats_lock" in rel["message"]["text"]
    # findings without a witness carry no relatedLocations key at all
    plain = lint_sources({"mod.py": "import os\nprint(1)\n"})
    payload = json.loads(render_sarif(plain))
    assert all("relatedLocations" not in r
               for r in payload["runs"][0]["results"])


def test_cli_lint_timings(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    f = tmp_path / "ok.py"
    f.write_text("print(1)\n")
    assert main(["lint", str(f), "--timings"]) == 0
    out = capsys.readouterr().out
    assert "pack timings (wall):" in out
    assert "total" in out

    assert main(["lint", str(f), "--timings", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert "RC" in payload["timings"]          # the new pack is charged
    assert "parse" in payload["timings"]
    assert all(v >= 0 for v in payload["timings"].values())


# ---------------------------------------------------------------------------
# incremental lint cache (analysis/cache.py)


def test_cache_warm_hit_matches_cold_run(tmp_path):
    from deeprest_tpu_torch.analysis.cache import lint_paths_cached

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "mod.py").write_text("import os\n")
    cache_dir = str(tmp_path / "cache")

    cold, c1 = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert c1 is not None and not c1.result_hit
    assert [f.rule for f in cold.findings] == ["HY001"]

    warm, c2 = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert c2.result_hit
    assert ([(f.path, f.line, f.col, f.rule, f.message)
             for f in warm.findings]
            == [(f.path, f.line, f.col, f.rule, f.message)
                for f in cold.findings])
    assert warm.files == cold.files
    assert warm.suppressed_count == cold.suppressed_count


def test_cache_invalidates_on_content_change(tmp_path):
    from deeprest_tpu_torch.analysis.cache import lint_paths_cached

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "mod.py").write_text("import os\n")
    (proj / "other.py").write_text("VALUE = 1\n")
    cache_dir = str(tmp_path / "cache")
    lint_paths_cached([str(proj)], cache_dir=cache_dir)

    (proj / "mod.py").write_text("import os\nprint(os.sep)\n")
    fixed, cache = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert not cache.result_hit          # whole-tree findings key moved
    assert not fixed.findings
    # ...but the untouched file's parse came from the per-file layer
    assert cache.parse_hits == 1 and cache.parse_misses == 1


def test_cache_result_applies_baseline_after_load(tmp_path):
    # the baseline can change without the tree changing; the cache
    # stores PRE-baseline findings and re-splits on every load
    from deeprest_tpu_torch.analysis.cache import lint_paths_cached

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "mod.py").write_text("import os\n")
    cache_dir = str(tmp_path / "cache")
    cold, _ = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    key = cold.findings[0].key()

    masked, cache = lint_paths_cached([str(proj)], cache_dir=cache_dir,
                                      baseline_keys=[key])
    assert cache.result_hit
    assert not masked.findings and len(masked.baselined) == 1


def test_cache_suppression_edit_invalidates(tmp_path):
    # suppressions live in file content, so the content hash covers
    # them: adding one must flip the verdict even with a warm cache
    from deeprest_tpu_torch.analysis.cache import lint_paths_cached

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "mod.py").write_text("import os\n")
    cache_dir = str(tmp_path / "cache")
    cold, _ = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert cold.findings
    (proj / "mod.py").write_text(
        "# graftlint: disable=HY001 -- doc example import\n"
        "import os\n")
    after, _ = lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert not after.findings and after.suppressed_count == 1


def test_cache_pack_version_covers_new_pack_modules(tmp_path, monkeypatch):
    """The pack digest walks analysis/*.py by directory listing, so a
    NEW module (this round: locksets.py + rules_races.py) shifts it
    without a hand-bumped constant — and a shifted digest refuses every
    stored result."""
    import os

    from deeprest_tpu_torch.analysis import cache as cache_mod

    here = os.path.dirname(os.path.abspath(cache_mod.__file__))
    names = {n for n in os.listdir(here) if n.endswith(".py")}
    assert {"locksets.py", "rules_races.py"} <= names

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "mod.py").write_text("import os\n")
    cache_dir = str(tmp_path / "cache")
    cold, _ = cache_mod.lint_paths_cached([str(proj)], cache_dir=cache_dir)
    warm, c2 = cache_mod.lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert c2.result_hit
    # simulate the NEXT new pack file: a different digest must miss the
    # stored result and recompute to the same verdicts
    monkeypatch.setattr(cache_mod, "_PACK_VERSION", "0" * 16)
    miss, c3 = cache_mod.lint_paths_cached([str(proj)], cache_dir=cache_dir)
    assert not c3.result_hit
    assert ([(f.path, f.line, f.rule) for f in miss.findings]
            == [(f.path, f.line, f.rule) for f in cold.findings])


# ---------------------------------------------------------------------------
# deeprest lint --fix (analysis/autofix.py)


def test_lint_fix_round_trip(tmp_path):
    """The acceptance contract: fix → re-lint reports zero HY001/HY002
    → a second fix is a byte-identical no-op."""
    from deeprest_tpu_torch.analysis import fix_paths, lint_paths

    mod = tmp_path / "mod.py"
    mod.write_text(
        "import os\n"
        "import sys, json\n"
        "from collections import OrderedDict, defaultdict\n"
        "\n"
        "def f(x):\n"
        "    return os.path.join('a', x)\n"
        "    y = json.dumps(x)\n"
        "    return y\n"
        "\n"
        "def g():\n"
        "    return defaultdict(list)\n")
    report = fix_paths([str(tmp_path)])
    assert report.applied
    result = lint_paths([str(tmp_path)],
                        rules=[all_rules()["HY001"],
                               all_rules()["HY002"]])
    assert not result.findings, render_text(result)
    before = mod.read_bytes()
    again = fix_paths([str(tmp_path)])
    assert mod.read_bytes() == before    # byte-identical no-op
    assert not again.applied


def test_lint_fix_cascade_unreachable_then_import(tmp_path):
    # deleting unreachable code orphans the import it was the only user
    # of; the fixer loops until stable and catches both
    mod = tmp_path / "mod.py"
    mod.write_text(
        "import json\n"
        "\n"
        "def f(x):\n"
        "    return x\n"
        "    return json.dumps(x)\n")
    from deeprest_tpu_torch.analysis import fix_paths

    report = fix_paths([str(tmp_path)])
    assert report.passes >= 2
    text = mod.read_text()
    assert "json" not in text
    assert not findings_for("HY001", text)
    assert not findings_for("HY002", text)


def test_lint_fix_refuses_suppressed_findings(tmp_path):
    from deeprest_tpu_torch.analysis import fix_paths

    mod = tmp_path / "mod.py"
    original = ("# graftlint: disable=HY001 -- doc example, kept\n"
                "import os\n")
    mod.write_text(original)
    report = fix_paths([str(tmp_path)])
    assert mod.read_text() == original   # a documented deviation stays
    assert not report.applied
    assert any(e.rule == "HY001" for e in report.refused)


def test_lint_fix_only_statement_becomes_pass(tmp_path):
    from deeprest_tpu_torch.analysis import fix_paths

    mod = tmp_path / "mod.py"
    mod.write_text("def f():\n    import os\n")
    fix_paths([str(tmp_path)])
    import ast as ast_mod

    text = mod.read_text()
    ast_mod.parse(text)                  # still a valid module
    assert "import os" not in text and "pass" in text


def test_cli_lint_fix_and_no_cache(tmp_path, capsys):
    from deeprest_tpu_torch.cli import build_parser

    mod = tmp_path / "mod.py"
    mod.write_text("import os\n")
    parser = build_parser()
    args = parser.parse_args(["lint", "--fix", str(tmp_path)])
    assert args.fn(args) == 0
    out = capsys.readouterr().out
    assert "fixed HY001" in out
    assert "import os" not in mod.read_text()

    # --no-cache still lints (now clean) with exit 0
    args = parser.parse_args(["lint", "--no-cache", str(tmp_path)])
    assert args.fn(args) == 0


# ---------------------------------------------------------------------------
# the port's own surface: its lint flags, usage exits, baseline, document
# and module alias


LINT_FLAGS = {"--format", "--rules", "--changed", "--jobs",
              "--list-suppressions", "--baseline", "--write-baseline",
              "--list-rules", "--fix", "--no-cache", "--timings",
              "--cache-dir"}


def _lint_parser():
    import argparse

    from deeprest_tpu_torch.cli import build_parser

    sub = next(a for a in build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices["lint"]


def test_lint_takes_the_reference_flags_and_no_device():
    flags = {s for a in _lint_parser()._actions for s in a.option_strings
             if s.startswith("--") and s != "--help"}
    assert flags == LINT_FLAGS
    assert "--device" not in flags


@pytest.mark.parametrize("argv", [
    ["--format", "markdown"],
    ["--list-suppressions", "--format", "sarif"],
    ["--jobs", "0"],
    ["--rules", "HY001,QQ999"],
], ids=["markdown-without-inventory", "sarif-inventory", "jobs-0",
        "unknown-rule"])
def test_cli_lint_usage_errors_exit_2(tmp_path, capsys, argv):
    from deeprest_tpu_torch.cli import main

    f = tmp_path / "ok.py"
    f.write_text("print(1)\n")
    assert main(["lint", str(f), "--no-cache", *argv]) == 2
    assert capsys.readouterr().out.startswith("lint: ")


def test_cli_lint_missing_path_exits_2(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    assert main(["lint", str(tmp_path / "absent.py")]) == 2
    assert "no such path" in capsys.readouterr().out


def test_cli_lint_malformed_baseline_exits_2(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    f = tmp_path / "ok.py"
    f.write_text("print(1)\n")
    baseline = tmp_path / "b.json"
    baseline.write_text('{"version": 1, "findings": "HY001"}\n')
    assert main(["lint", str(f), "--baseline", str(baseline)]) == 2


def test_default_baseline_is_the_ports_and_empty():
    import os

    import deeprest_tpu_torch
    from deeprest_tpu_torch.analysis import (
        default_baseline_path, load_baseline,
    )

    path = default_baseline_path()
    assert path == os.path.join(
        os.path.dirname(os.path.abspath(deeprest_tpu_torch.__file__)),
        "analysis", "baseline.json")
    assert load_baseline(path) == []


def test_sarif_information_uri_names_the_ports_document():
    import os

    from deeprest_tpu_torch.analysis import render_sarif

    doc = json.loads(render_sarif(lint_sources({"mod.py": "x = 1\n"})))
    uri = doc["runs"][0]["tool"]["driver"]["informationUri"]
    assert uri == "deeprest_tpu_torch/analysis/ANALYSIS.md"
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    assert os.path.isfile(os.path.join(root, uri))


def test_module_alias_runs_the_ports_lint(tmp_path):
    """``python -m deeprest_tpu_torch.analysis`` is ``python -m
    deeprest_tpu_torch lint``: one unused import, one HY001, exit 1."""
    import os
    import subprocess
    import sys

    bad = tmp_path / "bad.py"
    bad.write_text("import os\nprint(1)\n")
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch.analysis", str(bad),
         "--rules", "HY001", "--no-cache", "--format", "json"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert [f["rule"] for f in payload["findings"]] == ["HY001"]
