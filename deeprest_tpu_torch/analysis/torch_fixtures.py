"""Fire/silent fixture pairs of the analyzer's torch vocabulary.

:data:`PAIRS` maps a case name to ``(rule, bad, good)``: two small projects
(``{rel: source}``) on which ``rule`` must fire and must stay silent.  They
cover the TX pack (``rules_torch.py``), JX007's capture arm and its loop
arm on torch values, and QT001 on ``torch.int8``, each also across modules
(a capture in ``serve/`` reaching a helper in ``ops/``).  The tests hold the
rules to them (``tests/test_torch_analysis_torch.py``), and ``chip_smoke.py``
phase 22 lints them on the card's host.

The fixtures named in :data:`RUNTIME` are programs too: their module
``demo(device)`` runs the hazard on a CUDA device, so the card shows what
the rule predicts (a stale replay, an overwritten output, a refused
capture) and that the silent twin answers as eager code does.
"""

from __future__ import annotations

TX001_BAD = {"serve/scaler.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture


class Scaler:
    """y = x * weight through one captured graph."""

    def __init__(self, weight):
        self.weight = weight
        self.x = torch.arange(1.0, 9.0, device=weight.device)
        self.graph, self.out = capture(lambda: self.x * self.weight,
                                       weight.device, "scale")

    def load(self, weight):
        self.weight = weight

    def __call__(self):
        self.graph.replay()
        return self.out.clone()


def demo(device):
    """(the replay after a load, eager with the old weight, eager with
    the new weight)."""
    first = torch.full((8,), 2.0, device=device)
    scaler = Scaler(first)
    old = scaler.x * first
    scaler.load(torch.full((8,), 3.0, device=device))
    return scaler(), old, scaler.x * scaler.weight
'''}

TX001_GOOD = {"serve/scaler.py": TX001_BAD["serve/scaler.py"].replace(
    "        self.weight = weight\n\n    def __call__",
    "        self.weight.copy_(weight)\n\n    def __call__")}

# the captured program is a base class's method in ops/; the subclass in
# serve/ that captures it rebinds the weight it reads
TX001_CROSS_BAD = {
    "ops/program.py": '''\
class Program:
    def _program(self, x):
        return x * self.weight
''',
    "serve/plane.py": '''\
from deeprest_tpu_torch.graphs import capture
from ops.program import Program


class Plane(Program):
    def __init__(self, weight, x):
        self.weight = weight
        self.graph, self.out = capture(lambda: self._program(x),
                                       x.device, "plane")

    def swap(self, weight):
        self.weight = weight
''',
}

TX001_CROSS_GOOD = dict(TX001_CROSS_BAD, **{
    "serve/plane.py": TX001_CROSS_BAD["serve/plane.py"].replace(
        "    def swap(self, weight):\n        self.weight = weight\n",
        "    def swap(self, weight):\n        self.weight.copy_(weight)\n")})

TX002_BAD = {"serve/compiled.py": '''\
import torch


def predict(model, batches):
    outs = []
    for x in batches:
        fast = torch.compile(model)
        outs.append(fast(x))
    return outs


def step(model, x):
    fast = torch.compile(lambda t: model(t) * 2.0)
    return fast(x)


def record(bodies):
    graphs = []
    for body in bodies:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        graphs.append(graph)
    return graphs
'''}

TX002_GOOD = {"serve/compiled.py": '''\
import torch

_COMPILED = {}


def compiled(model):
    fast = _COMPILED.get(id(model))
    if fast is None:
        fast = _COMPILED[id(model)] = torch.compile(
            lambda t: model(t) * 2.0)
    return fast


def predict(model, batches):
    fast = compiled(model)
    return [fast(x) for x in batches]


def record(body):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph
'''}

# the capture function is the project's own graphs.py, called per key in
# a loop from another module
TX002_CROSS_BAD = {
    "graphs.py": '''\
def capture(body, device, what):
    return body(), what
''',
    "serve/warm.py": '''\
from graphs import capture


def warm(programs, device):
    out = []
    for key, program in programs.items():
        out.append(capture(program, device, key))
    return out
''',
}

TX002_CROSS_GOOD = dict(TX002_CROSS_BAD, **{"serve/warm.py": '''\
from graphs import capture

_GRAPHS = {}


def graph_for(key, program, device):
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _GRAPHS[key] = capture(program, device, key)
    return graph
'''})

TX004_BAD = {"serve/doubler.py": '''\
import torch

from deeprest_tpu_torch.serve.graphs import RungGraphs


class Doubler:
    def __init__(self, device):
        self.graphs = RungGraphs(device)

    def _program(self, x):
        return x * 2.0

    def answer(self, x):
        with self.graphs.lock:
            (y,) = self.graphs.run(("double", len(x)), self._program, (x,))
        return y

    def pair(self, a, b):
        with self.graphs.lock:
            (ya,) = self.graphs.run(("double", len(a)), self._program, (a,))
            (yb,) = self.graphs.run(("double", len(b)), self._program, (b,))
            return ya, yb


def demo(device):
    """(the first call's held output, the second call's, eager a * 2,
    eager b * 2)."""
    doubler = Doubler(device)
    a = torch.arange(8.0, device=device)
    b = torch.arange(8.0, 16.0, device=device)
    ya, yb = doubler.pair(a, b)
    return ya, yb, a * 2.0, b * 2.0
'''}

TX004_GOOD = {"serve/doubler.py": TX004_BAD["serve/doubler.py"].replace(
    '''            (y,) = self.graphs.run(("double", len(x)), self._program, (x,))
        return y''',
    '''            (y,) = self.graphs.run(("double", len(x)), self._program, (x,))
            return y.clone()''').replace(
    '''            (ya,) = self.graphs.run(("double", len(a)), self._program, (a,))
''',
    '''            ya = self.graphs.run(("double", len(a)), self._program,
                                 (a,))[0].clone()
''')}

# the run is wrapped by a helper in ops/ that the engine in serve/ calls
TX004_CROSS_BAD = {
    "ops/pages.py": '''\
def page(graphs, program, x):
    return graphs.run(("page", len(x)), program, (x,))
''',
    "serve/engine.py": '''\
from ops.pages import page


class Engine:
    def two(self, a, b):
        with self.graphs.lock:
            (ya,) = page(self.graphs, self.program, a)
            (yb,) = page(self.graphs, self.program, b)
            return ya + yb
''',
}

TX004_CROSS_GOOD = dict(TX004_CROSS_BAD, **{
    "serve/engine.py": TX004_CROSS_BAD["serve/engine.py"].replace(
        "            (ya,) = page(self.graphs, self.program, a)\n",
        "            (ya,) = page(self.graphs, self.program, a)\n"
        "            ya = ya.clone()\n")})

TX005_BAD = {"train/placement.py": '''\
from deeprest_tpu_torch.parallel.sharding import rank_box


def metric_rows(mesh, num_metrics):
    ((lo, hi),) = rank_box(mesh, ("expert",), (num_metrics,), "metrics")
    return slice(lo, hi)
'''}

TX005_GOOD = {"train/placement.py": '''\
from deeprest_tpu_torch.parallel.sharding import rank_box, spec_of


def metric_rows(mesh, num_metrics, num_quantiles):
    spec = spec_of("head_b", (num_metrics, num_quantiles))[:1]
    ((lo, hi),) = rank_box(mesh, spec, (num_metrics,), "metrics")
    return slice(lo, hi)
'''}

# the helpers are the project's own parallel/sharding.py, where a spec
# literal is the table's business
TX005_CROSS_BAD = {
    "parallel/sharding.py": '''\
def gather_leaf(mesh, value, spec):
    return value


def gather_metrics(mesh, value):
    return gather_leaf(mesh, value, ("expert", None))
''',
    "serve/answers.py": '''\
from parallel.sharding import gather_leaf


def whole(mesh, value):
    return gather_leaf(mesh, value, ("expert", None))
''',
}

TX005_CROSS_GOOD = dict(TX005_CROSS_BAD, **{"serve/answers.py": '''\
from parallel.sharding import gather_metrics


def whole(mesh, value):
    return gather_metrics(mesh, value)
'''})

TX006_BAD = {"serve/steps.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture


def body(counts, scale):
    bias = torch.tensor([0.5, 0.25], device=counts.device)
    mean = counts * 0.5
    done = torch.cuda.Event()
    staged = torch.empty(2, pin_memory=True)
    return (mean.double() + bias) * scale


def build(device):
    counts = torch.zeros(2, dtype=torch.long, device=device)
    scale = torch.ones(2, device=device)
    return capture(lambda: body(counts, scale), device, "step")
'''}

TX006_GOOD = {"serve/steps.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture


def body(counts, bias, scale):
    mean = counts.float() * 0.5
    return (mean + bias) * scale


def build(device):
    counts = torch.zeros(2, dtype=torch.long, device=device)
    scale = torch.ones(2, device=device)
    bias = torch.tensor([0.5, 0.25], device=device)
    done = torch.cuda.Event()
    return capture(lambda: body(counts, bias, scale), device, "step"), done
'''}

TX006_CROSS_BAD = {
    "ops/offsets.py": '''\
import torch


def offsets(x):
    return x + torch.tensor([1.0, 2.0], device=x.device)
''',
    "serve/plane.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture
from ops.offsets import offsets


def build(device):
    x = torch.zeros(2, device=device)
    return capture(lambda: offsets(x), device, "offsets")
''',
}

TX006_CROSS_GOOD = dict(TX006_CROSS_BAD, **{"ops/offsets.py": '''\
def offsets(x, table):
    return x + table
''', "serve/plane.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture
from ops.offsets import offsets


def build(device):
    x = torch.zeros(2, device=device)
    table = torch.tensor([1.0, 2.0], device=device)
    return capture(lambda: offsets(x, table), device, "offsets")
'''})

JX007_CAPTURE_BAD = {"serve/norm.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture


def normalized(x):
    total = x.sum().item()
    return x / total


def build(x):
    return capture(lambda: normalized(x), x.device, "normalized")


def demo(device):
    return build(torch.arange(1.0, 9.0, device=device))
'''}

JX007_CAPTURE_GOOD = {"serve/norm.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture


def normalized(x):
    return x / x.sum()


def build(x):
    return capture(lambda: normalized(x), x.device, "normalized")


def demo(device):
    """(the replay, eager)."""
    x = torch.arange(1.0, 9.0, device=device)
    graph, out = build(x)
    graph.replay()
    return out.clone(), normalized(x)
'''}

# a capture body in serve/ calls a helper in ops/ that syncs
JX007_CAPTURE_CROSS_BAD = {
    "ops/stats.py": '''\
import torch


def scale_of(x):
    torch.cuda.synchronize()
    return x.abs().max()
''',
    "serve/engine.py": '''\
import torch

from deeprest_tpu_torch.graphs import capture
from ops.stats import scale_of


def build(device):
    x = torch.ones(4, device=device)
    return capture(lambda: x / scale_of(x), device, "scaled")
''',
}

JX007_CAPTURE_CROSS_GOOD = dict(JX007_CAPTURE_CROSS_BAD, **{
    "ops/stats.py": '''\
def scale_of(x):
    return x.abs().max()
'''})

# JX007's loop arm on torch device values, reached from the trainer
JX007_LOOP_BAD = {
    "train/trainer.py": '''\
from train.helpers import collect


class Trainer:
    def fit(self, batches):
        return collect(batches)
''',
    "train/helpers.py": '''\
import torch


def collect(batches):
    out = []
    for b in batches:
        dev = torch.sum(b.cuda())
        out.append(dev.item())
    return out
''',
}

JX007_LOOP_GOOD = dict(JX007_LOOP_BAD, **{"train/helpers.py": '''\
import torch


def collect(batches):
    out = []
    for b in batches:
        out.append(torch.sum(b.cuda()))
    return torch.stack(out).cpu()
'''})

QT001_BAD = {"ops/qproj.py": '''\
import torch


def quantize(w, scale):
    return torch.round(w / scale).to(torch.int8)


def project(x, w):
    scale = w.abs().amax(dim=0) / 127.0
    return torch.matmul(x, quantize(w, scale))


def widen(w):
    scale = w.abs().amax(dim=0) / 127.0
    return quantize(w, scale).to(torch.float32)
'''}

QT001_GOOD = {
    "ops/qproj.py": '''\
import torch

from ops.quantize import dequantize


def quantize(w, scale):
    return torch.round(w / scale).to(torch.int8)


def project(x, w):
    scale = w.abs().amax(dim=0) / 127.0
    return torch.matmul(x, dequantize(quantize(w, scale), scale))
''',
    "ops/quantize.py": '''\
def dequantize(q, scale):
    return q.float() * scale
''',
}

PAIRS = {
    "TX001": ("TX001", TX001_BAD, TX001_GOOD),
    "TX001 across modules": ("TX001", TX001_CROSS_BAD, TX001_CROSS_GOOD),
    "TX002": ("TX002", TX002_BAD, TX002_GOOD),
    "TX002 across modules": ("TX002", TX002_CROSS_BAD, TX002_CROSS_GOOD),
    "TX004": ("TX004", TX004_BAD, TX004_GOOD),
    "TX004 across modules": ("TX004", TX004_CROSS_BAD, TX004_CROSS_GOOD),
    "TX005": ("TX005", TX005_BAD, TX005_GOOD),
    "TX005 across modules": ("TX005", TX005_CROSS_BAD, TX005_CROSS_GOOD),
    "TX006": ("TX006", TX006_BAD, TX006_GOOD),
    "TX006 across modules": ("TX006", TX006_CROSS_BAD, TX006_CROSS_GOOD),
    "JX007 capture": ("JX007", JX007_CAPTURE_BAD, JX007_CAPTURE_GOOD),
    "JX007 capture across modules": ("JX007", JX007_CAPTURE_CROSS_BAD,
                                     JX007_CAPTURE_CROSS_GOOD),
    "JX007 loop": ("JX007", JX007_LOOP_BAD, JX007_LOOP_GOOD),
    "QT001": ("QT001", QT001_BAD, QT001_GOOD),
}

# the pairs whose module ``demo(device)`` runs the hazard on a CUDA device
RUNTIME = {"TX001": "serve/scaler.py", "TX004": "serve/doubler.py",
           "JX007 capture": "serve/norm.py"}

# ``python -c DEMO_CHILD <module path>``: one runtime fixture's demo on the
# card in a process of its own (a refused capture poisons no other), its
# last line the JSON of its answer (tensors as lists) or of the error it
# raised, with the process's peak reservation in MiB
DEMO_CHILD = """
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("fixture", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
try:
    spec.loader.exec_module(mod)
    out = mod.demo("cuda")
    torch.cuda.synchronize()
    res = {"values": [t.cpu().tolist() for t in out]}
except Exception as exc:
    res = {"error": type(exc).__name__, "message": str(exc)}
res["reserved_mib"] = torch.cuda.max_memory_reserved() / 2**20
print(json.dumps(res))
"""
