"""graftflow: interprocedural value-flow analysis for graftlint.

The syntactic rule packs catch this repo's invariant violations at the
allocation or call site, inside hand-kept watchlists.  The plane's
hardest bugs were never that polite: the jit closure-constant
1-ulp drift, the round-15 dense F-wide materializations, the silent
host↔device readbacks the early rounds hand-hunted — all *value-provenance*
bugs, where the offending value crossed functions (and modules) between
its origin and the site where it hurt.  graftflow tracks values through
calls the way GSPMD propagates shardings through a program rather than
per-op: a forward abstract interpretation over the round-16
``core.CallGraph``, with bounded interprocedural summaries per function
so whole-repo analysis stays inside the lint time budget.

Abstract domain — one product lattice per value (:class:`AbsVal`):

- **dtype**: ``bot < {bool, wint, int, wfloat, bf16, f32, f64} < top``.
  ``wint``/``wfloat`` are Python's weak-typed scalars; the strong
  members mirror the numeric dtypes this plane actually runs (bf16/f32
  compute, f64 only as the np-default hazard).  Binary ops promote
  along JAX's lattice (weak scalars do not widen strong arrays; f64
  infects everything it touches).
- **denseness taint** (may-analysis, union join): True when the value's
  trailing dimension derives from the feature-space size F — seeded at
  ``np.zeros((..., capacity))``-shaped allocations (the DN001 width
  markers, or a trailing dim whose *value* is width-tainted through the
  env) and propagated through returns, call arguments, attribute
  stores, and tuple unpacking.  Each tainted value carries its origin
  allocation sites (capped at :data:`_MAX_ORIGINS` — the widening
  bound) so rules can fire **at the origin**, not the sink.
- **host/device domain**: ``bot < {host, device} < top``.  ``np.*``
  allocates host; ``jnp.*``/``jax.device_put`` produce device;
  ``np.asarray``/``float()``/``.item()`` on a *device* value is a
  domain-crossing edge, recorded as a :class:`Crossing` fact.
- **torch** (the port's vocabulary): a flag on values that torch calls and
  tensor methods make.  ``torch.*`` given a non-CPU ``device=``,
  ``.cuda()``, ``.to(<device>)``, a module moved to the card and
  ``torch.ops.*`` produce device; ``.cpu()``/``.tolist()``/``.numpy()``,
  ``int()``/``bool()`` of a tensor and ``torch.cuda.synchronize()`` are
  crossings too; ``torch.int8`` is the i8 member.  Every torch fact is
  gated on the flag, so JAX code analyzes as it did without it.

Interprocedural machinery: every function the call graph knows gets a
summary — the join of all argument values observed at resolved call
sites (context-insensitive, one context per function) and the join of
its return values.  The engine iterates analyze-all-functions rounds
until summaries stop changing or :data:`MAX_ROUNDS` is hit (the
termination bound; every lattice chain is finite and joins are
monotone, so convergence is typically 2-3 rounds).  ``self.attr``
stores join into a per-(module, class, attr) table; module-level
assignments join into a global table readable across modules through
the import graph — the same resolution ``CallGraph`` already does for
calls.

Facts exposed to rule packs (all collected in the FINAL round, so they
reflect fixpoint knowledge):

- :attr:`ValueFlow.alloc_sites` — every recognized array allocation,
  with syntactic flags (literal tuple shape, trailing width marker,
  host vs device) and the fixpoint ``env_dense`` verdict.  DN001's
  migrated implementation is a pure filter over this table.
- :attr:`ValueFlow.zone_hits` — dense origin → the hot-zone function
  (train/stream, serve/, obs/) its taint first reached (DN002).
- :attr:`ValueFlow.crossings` — host/device conversion sites with the
  argument's abstract domain (JX007 fires only on *proven* device
  values, which is what lets it range beyond JX003's watchlist without
  drowning in false positives).
- :attr:`ValueFlow.np_calls` / :attr:`ValueFlow.f64_casts` /
  :attr:`ValueFlow.promotions` — the JX006 dtype-hazard inputs.

Use :meth:`ValueFlow.of` (cached per Project, like
``project.call_graph()``) so every rule shares one engine run.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from deeprest_tpu_torch.analysis.captured import captured_scope
from deeprest_tpu_torch.analysis.core import (
    CallGraph, FuncKey, Project, SourceFile, call_name,
)

# -- lattice ----------------------------------------------------------------

BOT = "bot"
TOP = "top"

# dtype promotion rank (JAX-flavored): weak scalars sit between the
# strong ints and the strong floats so int<op>wfloat promotes to float
# (rank of the float side) and wfloat<op>f32 stays f32.  "i8" is the
# quantized-weight storage dtype (round 22): it is tracked separately
# from the generic "int" member because leaving i8 — promoting into any
# float — is only legal inside the sanctioned dequant helper
# (ops/quantize.py dequantize); everywhere else that promotion is a
# silent de-quantization bug and QT001 fires at the origin.
_DTYPE_RANK = {"bool": 0, "wint": 1, "i8": 2, "int": 3, "wfloat": 4,
               "bf16": 5, "f32": 6, "f64": 7}

# float members of the rank lattice — an i8 value reaching any of these
# outside the sanctioned dequant site is the QT001 hazard class
_FLOATS = ("wfloat", "bf16", "f32", "f64")

_MAX_ORIGINS = 4        # dense-origin set widening cap
_MAX_ELTS = 8           # tuple-structure tracking cap (arity)
MAX_ROUNDS = 4          # global fixpoint bound


def _join_flat(a: str, b: str) -> str:
    """Join on a flat lattice: bot < {members} < top."""
    if a == b:
        return a
    if a == BOT:
        return b
    if b == BOT:
        return a
    return TOP


def promote_dtype(a: str, b: str) -> str:
    """Result dtype of a binary op between values of dtype a and b."""
    if a == b:
        return a
    if a == BOT:
        return b
    if b == BOT:
        return a
    if a in _DTYPE_RANK and b in _DTYPE_RANK:
        hi = a if _DTYPE_RANK[a] >= _DTYPE_RANK[b] else b
        lo = b if hi == a else a
        # a weak scalar never widens a strong array: wfloat op bf16/f32
        # keeps the array dtype (hi already is the array side); but
        # int op wfloat DOES become float — Python float constants
        # silently promote integer arrays (the JX006 class)
        if hi == "wfloat" and lo in ("bool", "wint", "i8", "int"):
            return "wfloat"
        return hi
    return TOP


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """One abstract value: dtype x denseness x host/device domain.

    ``width`` marks *scalars* that derive from the feature-space size F
    (the thing that makes a trailing dim dense when used as one);
    ``dense`` marks arrays whose trailing dim is such a scalar.
    ``origins`` is the (capped) set of allocation sites responsible for
    the dense taint.  ``elts`` preserves tuple structure through
    packing/unpacking; the scalar fields of a tuple value hold the join
    of its elements, so collapsing structure loses precision, never
    soundness."""

    dtype: str = TOP
    dense: bool = False
    width: bool = False
    domain: str = TOP
    origins: tuple = ()
    elts: tuple | None = None
    torch: bool = False          # a torch tensor (torch vocabulary)

    def join(self, other: "AbsVal") -> "AbsVal":
        origins = self.origins
        if other.origins:
            merged = dict.fromkeys(self.origins)
            merged.update(dict.fromkeys(other.origins))
            origins = tuple(sorted(merged))[:_MAX_ORIGINS]
        elts = None
        if (self.elts is not None and other.elts is not None
                and len(self.elts) == len(other.elts)):
            elts = tuple(a.join(b) for a, b in zip(self.elts, other.elts))
        return AbsVal(
            dtype=_join_flat(self.dtype, other.dtype),
            dense=self.dense or other.dense,
            width=self.width or other.width,
            domain=_join_flat(self.domain, other.domain),
            origins=origins,
            elts=elts,
            torch=self.torch or other.torch,
        )


BOTTOM = AbsVal(dtype=BOT, domain=BOT)
NEUTRAL = AbsVal()
HOST_SCALAR = AbsVal(domain="host")


def make_tuple(elts: Iterable[AbsVal]) -> AbsVal:
    """Tuple value: structure preserved (up to the cap) with the scalar
    fields holding the elementwise join."""
    elts = tuple(elts)
    summary = BOTTOM
    for e in elts:
        summary = summary.join(e)
    return dataclasses.replace(
        summary, elts=elts if len(elts) <= _MAX_ELTS else None)


# -- width markers (shared with DN001's syntactic check) --------------------

# Identifier fragments that mark a feature-space/capacity width.  The
# engine seeds the width taint from these; DN001's migrated syntactic
# check uses exactly this predicate, so its verdicts are pinned.
WIDTH_MARKERS = ("capacity", "feature_dim", "num_features")


def is_width_marker_expr(node: ast.AST) -> bool:
    """True when any identifier fragment in ``node`` names a traffic
    width (the pre-migration DN001 ``_is_width_expr``, verbatim)."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None and any(m in name.lower()
                                    for m in WIDTH_MARKERS):
            return True
    return False


# -- recognized operations --------------------------------------------------

NP_ALLOCS = {"np.zeros", "np.empty", "np.ones", "np.full",
             "numpy.zeros", "numpy.empty", "numpy.ones", "numpy.full"}
JNP_ALLOCS = {"jnp.zeros", "jnp.empty", "jnp.ones", "jnp.full",
              "jax.numpy.zeros", "jax.numpy.empty", "jax.numpy.ones",
              "jax.numpy.full"}
# np calls that produce a float64-defaulting host array when no dtype is
# given — inside jit-traced code each is a trace-time host constant
# (JX006's np/jnp-mixing input)
NP_FLOAT_PRODUCERS = {
    "np.zeros", "np.ones", "np.full", "np.empty", "np.linspace",
    "np.arange", "np.eye", "np.array",
    "numpy.zeros", "numpy.ones", "numpy.full", "numpy.empty",
    "numpy.linspace", "numpy.arange", "numpy.eye", "numpy.array",
}
_HOST_CONVERTERS = {"np.asarray", "numpy.asarray", "np.array",
                    "numpy.array", "np.ascontiguousarray",
                    "numpy.ascontiguousarray"}
_DEVICE_CONVERTERS = {"jnp.asarray", "jnp.array", "jax.numpy.asarray",
                      "jax.numpy.array", "jax.device_put", "device_put"}
_F64_NAMES = {"np.float64", "numpy.float64", "jnp.float64",
              "jax.numpy.float64", "torch.float64", "torch.double"}
_F32_NAMES = {"np.float32", "numpy.float32", "jnp.float32",
              "jax.numpy.float32", "torch.float32", "torch.float"}
_BF16_NAMES = {"jnp.bfloat16", "jax.numpy.bfloat16", "torch.bfloat16"}
# int8 is split out of the generic int bucket (round 22): it is the
# quantized-weight storage dtype and QT001 tracks where it may leave
_I8_NAMES = {"np.int8", "numpy.int8", "jnp.int8", "jax.numpy.int8",
             "torch.int8"}
_INT_NAMES = {"np.int16", "np.int32", "np.int64", "np.intp",
              "np.uint8", "np.uint16", "np.uint32", "np.uint64",
              "jnp.int16", "jnp.int32", "jnp.int64",
              "numpy.int32", "numpy.int64", "int",
              "torch.int16", "torch.int32", "torch.int64", "torch.long",
              "torch.int", "torch.short", "torch.uint8"}
# methods that preserve array identity closely enough to carry taint
_TAINT_PRESERVING_METHODS = {"astype", "copy", "reshape", "view",
                             "block_until_ready"}

# -- torch vocabulary (the port's tensors) ----------------------------------
#
# Every torch fact is gated on ``AbsVal.torch``, which only torch calls
# and tensor methods set, so JAX code analyzes exactly as before.
# constructors: the device= keyword decides the domain (none: the CPU)
_TORCH_CTORS = {"zeros", "ones", "empty", "full", "rand", "randn",
                "randint", "arange", "linspace", "eye", "tensor",
                "as_tensor", "zeros_like", "ones_like", "empty_like",
                "full_like", "rand_like", "randn_like"}
# tensor methods that read the value back to the host (JX007 crossings)
_TORCH_READBACKS = {"cpu", "tolist", "numpy"}
# tensor methods that convert the dtype, by the dtype they convert to
# (the lattice's one 16-bit float member stands for half too)
_TORCH_CASTS = {"float": "f32", "half": "bf16", "bfloat16": "bf16",
                "double": "f64", "long": "int", "int": "int"}
# torch's matmul family: an int8 operand here skipped the dequant (QT001)
_TORCH_MATMULS = {"matmul", "mm", "bmm", "einsum", "linear", "mv", "dot",
                  "addmm", "baddbmm", "tensordot"}


def _device_domain(node: ast.AST) -> str:
    """The domain a ``device=`` / ``.to(...)`` argument names: a literal
    "cpu" (or ``torch.device("cpu")``) is the host, any other device
    expression the card (the port's entry points default to CUDA)."""
    if isinstance(node, ast.Call) and call_name(node.func) == \
            "torch.device" and node.args:
        node = node.args[0]
    if isinstance(node, ast.Constant):
        if node.value is None:
            return "host"
        if isinstance(node.value, str):
            return "host" if node.value.startswith("cpu") else "device"
    return "device"

# hot zones a dense F-trailing value must never reach (DN002): the
# sparse-first streaming trainer, the whole serving plane, the whole
# obs plane.  data/featurize.py is DN001's (origin-side) watch, not a
# sink zone — its pinned dense REFERENCE products are allowed to exist
# as long as they stay out of these zones.
ZONE_SUFFIXES = (("train", "stream.py"),)
ZONE_DIRS = ("serve", "obs")


def in_zone(rel: str) -> bool:
    parts = tuple(rel.replace("\\", "/").split("/"))
    if any(d in parts[:-1] for d in ZONE_DIRS):
        return True
    return any(parts[-len(s):] == s for s in ZONE_SUFFIXES
               if len(parts) >= len(s))


# positional index of the dtype parameter per np constructor leaf name
# (np.full's second positional is the FILL VALUE, np.arange's are the
# range bounds — "second positional == dtype" only holds for a few)
_DTYPE_POS = {"zeros": 1, "ones": 1, "empty": 1, "array": 1,
              "asarray": 1, "full": 2, "eye": 3, "arange": 3,
              "linspace": 5}


def has_explicit_dtype(node: ast.Call, dotted: str) -> bool:
    if any(kw.arg == "dtype" for kw in node.keywords):
        return True
    pos = _DTYPE_POS.get(dotted.rsplit(".", 1)[-1])
    return pos is not None and len(node.args) > pos


def _dtype_of_annotation(node: ast.AST | None) -> str:
    """dtype lattice member named by a dtype expression, or TOP."""
    if node is None:
        return TOP
    dotted = call_name(node)
    if dotted in _F64_NAMES:
        return "f64"
    if dotted in _F32_NAMES:
        return "f32"
    if dotted in _BF16_NAMES:
        return "bf16"
    if dotted in _I8_NAMES:
        return "i8"
    if dotted in _INT_NAMES:
        return "int"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        s = node.value
        return {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
                "int8": "i8", "int32": "int", "int64": "int",
                "bool": "bool"}.get(s, TOP)
    return TOP


# -- facts ------------------------------------------------------------------


@dataclasses.dataclass
class AllocSite:
    """One recognized array allocation (syntactic pass; ``env_dense``
    is filled in by the fixpoint when the trailing dim's *value* is
    width-tainted even without a marker identifier)."""

    rel: str
    node: ast.Call
    dotted: str
    host: bool                   # np.* (host) vs jnp.* (device)
    literal_tuple: bool          # shape is a literal ast.Tuple
    trailing_marker: bool        # last shape element names a width
    has_dtype: bool
    env_dense: bool = False

    @property
    def origin(self) -> tuple[str, int, int]:
        return (self.rel, self.node.lineno, self.node.col_offset)

    @property
    def dense(self) -> bool:
        return self.trailing_marker or self.env_dense


@dataclasses.dataclass(frozen=True)
class Crossing:
    """One host/device domain crossing: a host-conversion op whose
    argument's abstract domain is recorded at fixpoint."""

    key: FuncKey | None          # enclosing analyzed function
    rel: str
    node: ast.AST
    kind: str                    # "np.asarray", "float()", ".item()", ...
    arg_domain: str
    torch: bool = False          # the argument is a torch tensor


@dataclasses.dataclass(frozen=True)
class Promotion:
    """A dtype-promotion hazard observed at a BinOp: ``kinds`` is
    ("f64", other) for f64 infection or ("int", "wfloat") for a Python
    float constant silently floating an integer array."""

    key: FuncKey | None
    rel: str
    node: ast.AST
    left: str
    right: str


@dataclasses.dataclass(frozen=True)
class I8Hazard:
    """An int8 value escaping into float math OUTSIDE the sanctioned
    dequant site (round 22, QT001): a quantized weight reaching a
    matmul/add/astype as float means the scale multiply was skipped —
    the output is silently wrong by ~scale^-1, not slightly off.  The
    engine never records hazards inside ops/quantize.py (``dequantize``
    is the one place i8 -> f32 is the whole point)."""

    key: FuncKey | None
    rel: str
    node: ast.AST
    why: str                     # "promotion:f32", "astype:bf16", "matmul"


@dataclasses.dataclass(frozen=True)
class NpCall:
    """A float64-defaulting np.* producer call (syntactic)."""

    rel: str
    node: ast.Call
    dotted: str
    has_dtype: bool


@dataclasses.dataclass(frozen=True)
class F64Cast:
    """An explicit float64 widening (syntactic): astype(np.float64),
    dtype=np.float64, or an np.float64(...) scalar cast."""

    rel: str
    node: ast.AST
    why: str


# -- the engine -------------------------------------------------------------


class ValueFlow:
    """Forward abstract interpretation over the project call graph.

    Build via :meth:`of` so the (expensive) fixpoint runs once per
    Project and every rule pack shares the result."""

    def __init__(self, project: Project, max_rounds: int = MAX_ROUNDS):
        self.project = project
        self.graph: CallGraph = project.call_graph()
        self.max_rounds = max_rounds
        self.rounds_used = 0

        # syntactic facts (one pass, round-independent)
        self.alloc_sites: dict[tuple[str, int, int], AllocSite] = {}
        self.np_calls: list[NpCall] = []
        self.f64_casts: list[F64Cast] = []

        # fixpoint facts (cleared per round; final round's survive)
        self.zone_hits: dict[tuple[str, int, int], FuncKey] = {}
        self.crossings: list[Crossing] = []
        self.promotions: list[Promotion] = []
        self.i8_hazards: list[I8Hazard] = []

        # interprocedural state
        self._params: dict[FuncKey, dict[str, AbsVal]] = {}
        self._rets: dict[FuncKey, AbsVal] = {}
        self._attrs: dict[tuple[str, str | None, str], AbsVal] = {}
        self._globals: dict[tuple[str, str], AbsVal] = {}
        self._changed = False

        # current-function context (set by _analyze)
        self._rel = ""
        self._cls: str | None = None
        self._self_name = ""
        self._key: FuncKey | None = None
        self._nested = 0             # inside a nested captured body

        # the nested defs and lambdas handed to a CUDA-graph capture or
        # torch.compile run as code of their own: their bodies are
        # analyzed in the enclosing function's environment (no other
        # nested body is, so JAX code analyzes as before)
        self._captured_bodies = captured_scope(project).bodies

        self._syntactic_pass()
        self._fixpoint()

    @classmethod
    def of(cls, project: Project) -> "ValueFlow":
        cached = getattr(project, "_value_flow", None)
        if cached is None:
            cached = cls(project)
            project._value_flow = cached
        return cached

    # -- syntactic pass ---------------------------------------------------

    def _syntactic_pass(self) -> None:
        """Whole-AST sweep per file: allocation sites (module level,
        nested defs, and class bodies included — the migrated DN001
        keeps its exact pre-migration coverage), np float producers,
        and explicit f64 casts."""
        for sf in self.project.files:
            if sf.tree is None:
                continue
            for node in sf.walk():
                if not isinstance(node, ast.Call):
                    continue
                dotted = call_name(node.func)
                if isinstance(node.func, ast.Attribute) and (
                        (node.func.attr == "double" and not node.args)
                        or (node.func.attr == "to" and any(
                            _dtype_of_annotation(a) == "f64"
                            for a in node.args))):
                    self.f64_casts.append(F64Cast(
                        sf.rel, node, f"{node.func.attr}(float64)"))
                if dotted is None:
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "astype" and node.args
                            and _dtype_of_annotation(node.args[0]) == "f64"):
                        self.f64_casts.append(F64Cast(
                            sf.rel, node, "astype(float64)"))
                    continue
                has_dtype = has_explicit_dtype(node, dotted)
                if dotted in NP_ALLOCS or dotted in JNP_ALLOCS:
                    if node.args:
                        shape = node.args[0]
                        lit = isinstance(shape, ast.Tuple) and bool(
                            shape.elts)
                        marker = (is_width_marker_expr(shape.elts[-1])
                                  if lit else False)
                        site = AllocSite(
                            rel=sf.rel, node=node, dotted=dotted,
                            host=dotted in NP_ALLOCS,
                            literal_tuple=lit, trailing_marker=marker,
                            has_dtype=has_dtype)
                        self.alloc_sites[site.origin] = site
                if dotted in NP_FLOAT_PRODUCERS:
                    self.np_calls.append(NpCall(
                        sf.rel, node, dotted, has_dtype))
                if dotted in _F64_NAMES:
                    self.f64_casts.append(F64Cast(
                        sf.rel, node, f"{dotted}(...)"))
                if dotted.endswith(".astype") and node.args and \
                        _dtype_of_annotation(node.args[0]) == "f64":
                    self.f64_casts.append(F64Cast(
                        sf.rel, node, "astype(float64)"))
                for kw in node.keywords:
                    if kw.arg == "dtype" and \
                            _dtype_of_annotation(kw.value) == "f64":
                        self.f64_casts.append(F64Cast(
                            sf.rel, node, "dtype=float64"))

    # -- fixpoint ---------------------------------------------------------

    def _fixpoint(self) -> None:
        for rnd in range(self.max_rounds):
            self.rounds_used = rnd + 1
            self._changed = False
            # final-round fact collection starts clean so the exposed
            # facts reflect fixpoint knowledge, not round-1 guesses
            self.zone_hits = {}
            self.crossings = []
            self.promotions = []
            self.i8_hazards = []
            for sf in self.project.files:
                self._analyze_module(sf)
            for key, node in self.graph.functions.items():
                self._analyze_function(key, node)
            if not self._changed:
                break

    def _note_change(self) -> None:
        self._changed = True

    # -- per-scope analysis -----------------------------------------------

    def _analyze_module(self, sf: SourceFile) -> None:
        if sf.tree is None:
            return
        self._rel, self._cls, self._self_name = sf.rel, None, ""
        self._key = None
        env: dict[str, AbsVal] = {}
        self._exec_block(
            [s for s in sf.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))],
            env)
        for name, val in env.items():
            self._join_global((sf.rel, name), val)
        # class-body constants (WATCH = (...), F = cfg.capacity, ...)
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            self._cls = node.name
            cenv: dict[str, AbsVal] = {}
            self._exec_block(
                [s for s in node.body
                 if isinstance(s, (ast.Assign, ast.AnnAssign))], cenv)
            for name, val in cenv.items():
                self._join_attr((sf.rel, node.name, name), val)
            self._cls = None

    def _analyze_function(self, key: FuncKey, node: ast.AST) -> None:
        sf = self.project.by_rel.get(key.rel)
        if sf is None:
            return
        self._rel, self._cls, self._key = key.rel, key.cls, key
        args = getattr(node, "args", None)
        names = []
        if args is not None:
            names = [a.arg for a in (list(args.posonlyargs)
                                     + list(args.args)
                                     + list(args.kwonlyargs))]
        self._self_name = names[0] if key.cls and names else ""
        seen = self._params.get(key, {})
        env = {n: seen.get(n, BOTTOM) for n in names}
        body = node.body if isinstance(node.body, list) else []
        self._exec_block(body, env)

    # -- statement execution ----------------------------------------------

    def _exec_block(self, stmts: list[ast.stmt],
                    env: dict[str, AbsVal]) -> None:
        for stmt in stmts:
            self._exec_stmt(stmt, env)

    def _exec_stmt(self, stmt: ast.stmt, env: dict[str, AbsVal]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                id(stmt) in self._captured_bodies:
            self._exec_nested(stmt.body, stmt.args, env)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            val = self._eval(stmt.value, env)
            for t in stmt.targets:
                self._bind(t, val, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self._eval(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            val = self._eval(stmt.value, env)
            cur = self._eval(stmt.target, env)
            self._bind(stmt.target, cur.join(val), env)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                val = self._eval(stmt.value, env)
                if self._key is not None and not self._nested:
                    prev = self._rets.get(self._key, BOTTOM)
                    new = prev.join(val)
                    if new != prev:
                        self._rets[self._key] = new
                        self._note_change()
        elif isinstance(stmt, (ast.Expr, ast.Assert, ast.Delete,
                               ast.Raise)):
            for n in ast.iter_child_nodes(stmt):
                if isinstance(n, ast.expr):
                    self._eval(n, env)
        elif isinstance(stmt, ast.If):
            self._eval(stmt.test, env)
            e1, e2 = dict(env), dict(env)
            self._exec_block(stmt.body, e1)
            self._exec_block(stmt.orelse, e2)
            self._merge_envs(env, e1, e2)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self._eval(stmt.iter, env)
            # iterating a dense [T, F] array yields [F]-trailing rows:
            # taint flows through the loop target (structure dropped)
            self._bind(stmt.target, dataclasses.replace(it, elts=None),
                       env)
            # two passes over the body reach the loop-carried fixpoint
            # for the flow-insensitive facts we track
            self._exec_block(stmt.body, env)
            self._exec_block(stmt.body, env)
            self._exec_block(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self._eval(stmt.test, env)
            self._exec_block(stmt.body, env)
            self._exec_block(stmt.body, env)
            self._exec_block(stmt.orelse, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self._eval(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, v, env)
            self._exec_block(stmt.body, env)
        elif isinstance(stmt, ast.Try):
            self._exec_block(stmt.body, env)
            for h in stmt.handlers:
                he = dict(env)
                self._exec_block(h.body, he)
                self._merge_envs(env, env, he)
            self._exec_block(stmt.orelse, env)
            self._exec_block(stmt.finalbody, env)

    def _exec_nested(self, body, args: ast.arguments,
                     env: dict[str, AbsVal]) -> AbsVal | None:
        """A captured nested body (a def's statements, or a lambda's
        expression) in a copy of the enclosing environment, its own
        parameters unknown; returns a lambda's value."""
        inner = dict(env)
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            inner[a.arg] = NEUTRAL
        self._nested += 1
        try:
            if isinstance(body, list):
                self._exec_block(body, inner)
                return None
            return self._eval(body, inner)
        finally:
            self._nested -= 1

    @staticmethod
    def _merge_envs(dst: dict[str, AbsVal], a: dict[str, AbsVal],
                    b: dict[str, AbsVal]) -> None:
        a, b = dict(a), dict(b)      # dst may alias either input
        dst.clear()
        for name in set(a) | set(b):
            va, vb = a.get(name), b.get(name)
            if va is None:
                dst[name] = vb
            elif vb is None:
                dst[name] = va
            else:
                dst[name] = va.join(vb)

    def _bind(self, target: ast.AST, val: AbsVal,
              env: dict[str, AbsVal]) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = val
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if val.elts is not None and len(val.elts) == len(elts):
                for t, v in zip(elts, val.elts):
                    self._bind(t, v, env)
            else:
                scalar = dataclasses.replace(val, elts=None)
                for t in elts:
                    if isinstance(t, ast.Starred):
                        self._bind(t.value, scalar, env)
                    else:
                        self._bind(t, scalar, env)
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, dataclasses.replace(val, elts=None),
                       env)
            return
        if isinstance(target, ast.Attribute):
            base = target.value
            if (isinstance(base, ast.Name) and self._self_name
                    and base.id == self._self_name
                    and self._cls is not None):
                self._join_attr((self._rel, self._cls, target.attr), val)
            return
        # subscript stores etc.: no tracked container model

    def _join_attr(self, akey: tuple[str, str | None, str],
                   val: AbsVal) -> None:
        prev = self._attrs.get(akey, BOTTOM)
        new = prev.join(val)
        if new != prev:
            self._attrs[akey] = new
            self._note_change()

    def _join_global(self, gkey: tuple[str, str], val: AbsVal) -> None:
        prev = self._globals.get(gkey, BOTTOM)
        new = prev.join(val)
        if new != prev:
            self._globals[gkey] = new
            self._note_change()

    # -- expression evaluation --------------------------------------------

    def _eval(self, node: ast.AST, env: dict[str, AbsVal]) -> AbsVal:
        val = self._eval_inner(node, env)
        if val.dense and val.origins and in_zone(self._rel):
            for origin in val.origins:
                self.zone_hits.setdefault(
                    origin,
                    self._key or FuncKey(self._rel, None, "<module>"))
        return val

    def _eval_inner(self, node: ast.AST,
                    env: dict[str, AbsVal]) -> AbsVal:
        if isinstance(node, ast.Constant):
            v = node.value
            if isinstance(v, bool):
                return AbsVal(dtype="bool", domain="host")
            if isinstance(v, int):
                return AbsVal(dtype="wint", domain="host")
            if isinstance(v, float):
                return AbsVal(dtype="wfloat", domain="host")
            return HOST_SCALAR
        if isinstance(node, ast.Name):
            val = env.get(node.id)
            if val is None:
                val = self._lookup_global(node.id)
            if val is None:
                val = NEUTRAL
            if any(m in node.id.lower() for m in WIDTH_MARKERS):
                val = dataclasses.replace(val, width=True)
            return val
        if isinstance(node, ast.Attribute):
            base = node.value
            val = None
            if (isinstance(base, ast.Name) and self._self_name
                    and base.id == self._self_name):
                val = self._attrs.get((self._rel, self._cls, node.attr))
            if val is None:
                self._eval(base, env)
                val = NEUTRAL
            if any(m in node.attr.lower() for m in WIDTH_MARKERS):
                val = dataclasses.replace(val, width=True)
            return val
        if isinstance(node, (ast.Tuple, ast.List)):
            return make_tuple(self._eval(e, env) for e in node.elts
                              if not isinstance(e, ast.Starred))
        if isinstance(node, ast.BinOp):
            left = self._eval(node.left, env)
            right = self._eval(node.right, env)
            self._note_promotion(node, left, right)
            domain = ("device" if "device" in (left.domain, right.domain)
                      else _join_flat(left.domain, right.domain))
            joined = left.join(right)
            return dataclasses.replace(
                joined, dtype=promote_dtype(left.dtype, right.dtype),
                domain=domain, elts=None)
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand, env)
        if isinstance(node, ast.BoolOp):
            out = BOTTOM
            for v in node.values:
                out = out.join(self._eval(v, env))
            return out
        if isinstance(node, ast.Compare):
            vals = [self._eval(node.left, env)] + [
                self._eval(c, env) for c in node.comparators]
            out = BOTTOM
            for v in vals:
                out = out.join(v)
            return dataclasses.replace(out, dtype="bool", elts=None)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, env)
            if base.elts is not None and isinstance(node.slice,
                                                    ast.Constant):
                idx = node.slice.value
                if isinstance(idx, int) and -len(base.elts) <= idx \
                        < len(base.elts):
                    return base.elts[idx]
            self._eval(node.slice, env)
            return dataclasses.replace(base, elts=None)
        if isinstance(node, ast.IfExp):
            self._eval(node.test, env)
            return self._eval(node.body, env).join(
                self._eval(node.orelse, env))
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env)
        if isinstance(node, ast.Lambda) and id(node) in self._captured_bodies:
            self._exec_nested(node.body, node.args, env)
            return NEUTRAL
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp, ast.Lambda, ast.JoinedStr,
                             ast.Dict, ast.Set, ast.Await, ast.Yield,
                             ast.YieldFrom, ast.NamedExpr)):
            return NEUTRAL
        return NEUTRAL

    def _lookup_global(self, name: str) -> AbsVal | None:
        val = self._globals.get((self._rel, name))
        if val is not None:
            return val
        entry = self.graph._imports.get(self._rel, {}).get(name)
        if entry is not None and entry[0] == "obj":
            target = self.graph.resolve_module(entry[1])
            if target is not None:
                return self._globals.get((target, entry[2]))
        return None

    def _note_promotion(self, node: ast.BinOp, left: AbsVal,
                        right: AbsVal) -> None:
        a, b = left.dtype, right.dtype
        hazard = False
        if "f64" in (a, b) and {a, b} & {"bf16", "f32", "wfloat",
                                         "wint", "int"}:
            hazard = True
        if {a, b} == {"int", "wfloat"}:
            hazard = True
        if hazard:
            self.promotions.append(Promotion(
                self._key, self._rel, node, a, b))
        # QT001 (round 22): int8 meeting float math outside the
        # sanctioned dequant helper skipped the scale multiply
        if "i8" in (a, b) and {a, b} & set(_FLOATS):
            other = b if a == "i8" else a
            self._note_i8_hazard(node, f"promotion:{other}")

    def _in_sanctioned_dequant(self) -> bool:
        """True inside ops/quantize.py — the ONE module where i8→float
        is the point (``dequantize`` applies the scale there)."""
        parts = tuple(self._rel.replace("\\", "/").split("/"))
        return len(parts) >= 2 and parts[-2:] == ("ops", "quantize.py")

    def _note_i8_hazard(self, node: ast.AST, why: str) -> None:
        if self._in_sanctioned_dequant():
            return
        self.i8_hazards.append(I8Hazard(self._key, self._rel, node, why))

    # -- call evaluation --------------------------------------------------

    def _eval_call(self, node: ast.Call,
                   env: dict[str, AbsVal]) -> AbsVal:
        arg_vals = [self._eval(a, env) for a in node.args
                    if not isinstance(a, ast.Starred)]
        kw_vals = {kw.arg: self._eval(kw.value, env)
                   for kw in node.keywords if kw.arg is not None}
        dotted = call_name(node.func)

        # .item() — the canonical readback
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "item" and not node.args):
            recv = self._eval(node.func.value, env)
            self._note_crossing(node, ".item()", recv)
            return AbsVal(dtype="wfloat", domain="host")

        # a call the graph resolves is an interprocedural edge — and it
        # wins over the name-based heuristics below (a project method
        # named `view`/`copy` is that method, not an array op)
        key = self.graph.resolve_call(self._rel, self._cls,
                                      self._self_name, node)
        if key is not None:
            self._propagate_args(key, node, arg_vals, kw_vals)
            return self._rets.get(key, BOTTOM)

        # taint-preserving methods on a tracked receiver
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TAINT_PRESERVING_METHODS:
            recv = self._eval(node.func.value, env)
            dtype = recv.dtype
            if node.func.attr == "astype" and node.args:
                dtype = _dtype_of_annotation(node.args[0])
                if recv.dtype == "i8" and dtype in _FLOATS:
                    # raw-cast de-quantization (QT001): .astype(f32) on
                    # an int8 weight drops the per-channel scale
                    self._note_i8_hazard(node, f"astype:{dtype}")
            return dataclasses.replace(recv, dtype=dtype, elts=None)

        if self._is_torch_call(dotted):
            return self._eval_torch_call(node, dotted, arg_vals)
        if isinstance(node.func, ast.Attribute):
            val = self._eval_tensor_method(node, env)
            if val is not None:
                return val

        if dotted is not None:
            if dotted in NP_ALLOCS or dotted in JNP_ALLOCS:
                return self._eval_alloc(node, dotted, env)
            if dotted in _HOST_CONVERTERS:
                src = arg_vals[0] if arg_vals else NEUTRAL
                self._note_crossing(node, f"{dotted}()", src)
                dtype = src.dtype
                if dtype == "wfloat":
                    dtype = "f64"          # np strong-types a python float
                elif dtype == "wint":
                    dtype = "int"
                if any(kw.arg == "dtype" for kw in node.keywords) \
                        or len(node.args) >= 2:
                    dtype = _dtype_of_annotation(
                        node.args[1] if len(node.args) >= 2 else
                        next(kw.value for kw in node.keywords
                             if kw.arg == "dtype"))
                return dataclasses.replace(
                    src, dtype=dtype, domain="host", elts=None)
            if dotted in _DEVICE_CONVERTERS:
                src = arg_vals[0] if arg_vals else NEUTRAL
                return dataclasses.replace(src, domain="device",
                                           elts=None)
            if dotted in ("float", "int", "bool") and node.args:
                src = arg_vals[0] if arg_vals else NEUTRAL
                if dotted == "float" and not isinstance(
                        node.args[0], ast.Constant):
                    self._note_crossing(node, "float()", src)
                elif src.torch:
                    # int()/bool() of a torch tensor read it back too
                    self._note_crossing(node, f"{dotted}()", src)
                return AbsVal(dtype={"float": "wfloat", "int": "wint",
                                     "bool": "bool"}[dotted],
                              domain="host")
            if dotted == "len":
                src = arg_vals[0] if arg_vals else NEUTRAL
                # len() of a width-sized container is itself a width
                return AbsVal(dtype="wint", domain="host",
                              width=src.width)
            if dotted in _F64_NAMES:
                return AbsVal(dtype="f64", domain="host")
            if dotted in _F32_NAMES:
                return AbsVal(dtype="f32", domain="host")
            # jnp.* / jax.* ops produce device values; dense taint does
            # NOT propagate through device compute (the one on-device
            # densify is the sanctioned design — DN taint is about HOST
            # memory and feed bytes)
            root = dotted.split(".", 1)[0]
            if root in ("jnp", "jax") or dotted.startswith("jax.numpy."):
                # matmul-family consumption of an i8 operand (QT001):
                # jnp.dot(int8_w, x) promotes inside XLA with the scale
                # never applied — the hazard fires HERE, at the consumer,
                # even when no BinOp ever sees the int8 value
                tail = dotted.rsplit(".", 1)[-1]
                if tail in ("einsum", "dot", "matmul", "tensordot",
                            "dot_general") and any(
                                v.dtype == "i8" for v in arg_vals):
                    self._note_i8_hazard(node, tail)
                dtype = TOP
                if "dtype" in kw_vals:
                    dtype = _dtype_of_annotation(
                        next(kw.value for kw in node.keywords
                             if kw.arg == "dtype"))
                width = any(v.width for v in arg_vals)
                return AbsVal(dtype=dtype, domain="device", width=width)

        # an nn.Module (or any callable) moved to the card answers there
        callee = self._peek(node.func, env)
        if callee.torch and callee.domain == "device":
            return AbsVal(domain="device", torch=True)
        return NEUTRAL

    # -- torch vocabulary -------------------------------------------------

    def _is_torch_call(self, dotted: str | None) -> bool:
        """``torch.*``, or a name the file imports from torch
        (``import torch.nn.functional as F``)."""
        if dotted is None or "." not in dotted:
            return False
        head = dotted.split(".", 1)[0]
        if head == "torch":
            return True
        entry = self.graph._imports.get(self._rel, {}).get(head)
        return entry is not None and entry[1][:1] == ("torch",)

    def _eval_torch_call(self, node: ast.Call, dotted: str,
                         arg_vals: list[AbsVal]) -> AbsVal:
        tail = dotted.rsplit(".", 1)[-1]
        if dotted == "torch.cuda.synchronize":
            self._note_crossing(node, "torch.cuda.synchronize()",
                                AbsVal(domain="device", torch=True))
            return NEUTRAL
        if dotted.startswith(("torch.cuda.", "torch.distributed.",
                              "torch.backends.")):
            return NEUTRAL
        if tail in _TORCH_MATMULS and any(v.dtype == "i8"
                                          for v in arg_vals):
            self._note_i8_hazard(node, tail)
        dtype = TOP
        for kw in node.keywords:
            if kw.arg == "dtype":
                dtype = _dtype_of_annotation(kw.value)
        if tail.endswith("_like") and arg_vals and dtype == TOP:
            dtype = arg_vals[0].dtype
        if dotted.startswith("torch.ops."):
            return AbsVal(dtype=dtype, domain="device", torch=True)
        device = next((kw.value for kw in node.keywords
                       if kw.arg == "device"), None)
        if device is not None:
            domain = _device_domain(device)
        elif tail == "from_numpy":
            domain = "host"
            dtype = arg_vals[0].dtype if arg_vals else TOP
        elif tail in _TORCH_CTORS and not tail.endswith("_like"):
            domain = "host"
        else:
            domain = BOT
            for v in arg_vals:
                domain = ("device" if "device" in (domain, v.domain)
                          else _join_flat(domain, v.domain))
            if domain == BOT:
                domain = TOP
        return AbsVal(dtype=dtype, domain=domain, torch=True,
                      width=any(v.width for v in arg_vals))

    def _peek(self, node: ast.AST, env: dict[str, AbsVal]) -> AbsVal:
        """A name's or ``self.`` attribute's value, recording no fact."""
        if isinstance(node, ast.Name):
            val = env.get(node.id)
            return val if val is not None else (
                self._lookup_global(node.id) or NEUTRAL)
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name) and self._self_name
                and node.value.id == self._self_name):
            return self._attrs.get((self._rel, self._cls, node.attr),
                                   NEUTRAL)
        return NEUTRAL

    def _is_tensor(self, node: ast.AST, env: dict[str, AbsVal]) -> bool:
        """Whether ``node`` is a torch tensor, decided without evaluating
        it (so a non-torch receiver is analyzed as before)."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Call):
            if self._is_torch_call(call_name(node.func)):
                return True
            return (isinstance(node.func, ast.Attribute)
                    and (node.func.attr in ("cuda", "to")
                         or self._is_tensor(node.func.value, env)))
        return self._peek(node, env).torch

    def _eval_tensor_method(self, node: ast.Call,
                            env: dict[str, AbsVal]) -> AbsVal | None:
        """A method of a torch tensor (``.cuda()`` and ``.to(...)`` in a
        module that imports torch make one); None for any other
        receiver."""
        attr = node.func.attr
        imports_torch = "torch" in self.graph._imports.get(self._rel, {})
        if not (self._is_tensor(node.func.value, env)
                or (attr in ("cuda", "to") and imports_torch)):
            return None
        recv = self._eval(node.func.value, env)
        if attr == "cuda":
            return dataclasses.replace(recv, domain="device", torch=True,
                                       elts=None)
        if attr == "to":
            dtype, domain = recv.dtype, recv.domain
            for a in list(node.args) + [kw.value for kw in node.keywords
                                        if kw.arg in ("device", "dtype")]:
                named = _dtype_of_annotation(a)
                if named != TOP:
                    dtype = named
                elif not isinstance(a, ast.Constant) or isinstance(
                        a.value, str):
                    domain = _device_domain(a)
            self._note_i8_cast(node, recv, dtype, f"to:{dtype}")
            return dataclasses.replace(recv, dtype=dtype, domain=domain,
                                       torch=True, elts=None)
        if attr in _TORCH_CASTS and not node.args:
            dtype = _TORCH_CASTS[attr]
            self._note_i8_cast(node, recv, dtype, f"{attr}()")
            return dataclasses.replace(recv, dtype=dtype, elts=None)
        if attr in _TORCH_READBACKS and not node.args:
            self._note_crossing(node, f".{attr}()", recv)
            return dataclasses.replace(recv, domain="host",
                                       torch=attr == "cpu", elts=None)
        return dataclasses.replace(recv, dtype=TOP, elts=None)

    def _note_i8_cast(self, node: ast.AST, recv: AbsVal, dtype: str,
                      why: str) -> None:
        if recv.dtype == "i8" and dtype in _FLOATS:
            # a raw cast of an int8 weight drops its per-channel scale
            self._note_i8_hazard(node, why)

    def _eval_alloc(self, node: ast.Call, dotted: str,
                    env: dict[str, AbsVal]) -> AbsVal:
        host = dotted in NP_ALLOCS
        site = self.alloc_sites.get(
            (self._rel, node.lineno, node.col_offset))
        dense = False
        if node.args:
            shape = node.args[0]
            if isinstance(shape, ast.Tuple) and shape.elts:
                last = shape.elts[-1]
                dense = (is_width_marker_expr(last)
                         or self._eval(last, env).width)
            else:
                sv = self._eval(shape, env)
                if sv.elts is not None and sv.elts:
                    dense = sv.elts[-1].width
                else:
                    # 1-d alloc from a bare width scalar: np.zeros(F)
                    dense = sv.width and sv.dtype in ("wint", "int", TOP,
                                                      BOT)
        dtype = "f64" if host else "f32"
        pos = _DTYPE_POS.get(dotted.rsplit(".", 1)[-1])
        if pos is not None and len(node.args) > pos:
            dtype = _dtype_of_annotation(node.args[pos])
        for kw in node.keywords:
            if kw.arg == "dtype":
                dtype = _dtype_of_annotation(kw.value)
        # dense taint is a HOST-memory discipline: the one on-device
        # densify is sanctioned, so jnp allocs carry no taint
        taint = dense and host
        if site is not None and taint and not site.trailing_marker:
            if not site.env_dense:
                site.env_dense = True
                self._note_change()
        origins = ((self._rel, node.lineno, node.col_offset),) \
            if taint else ()
        return AbsVal(dtype=dtype, dense=taint,
                      domain="host" if host else "device",
                      origins=origins)

    def _propagate_args(self, key: FuncKey, node: ast.Call,
                        arg_vals: list[AbsVal],
                        kw_vals: dict[str, AbsVal]) -> None:
        fn = self.graph.function_node(key)
        args = getattr(fn, "args", None)
        if args is None:
            return
        names = [a.arg for a in (list(args.posonlyargs) + list(args.args))]
        kwonly = [a.arg for a in args.kwonlyargs]
        # method-style calls bind the receiver to the first parameter
        offset = 0
        if key.cls is not None and isinstance(node.func, ast.Attribute):
            offset = 1
        params = self._params.setdefault(key, {})

        def join_param(name: str, val: AbsVal) -> None:
            prev = params.get(name, BOTTOM)
            new = prev.join(val)
            if new != prev:
                params[name] = new
                self._note_change()

        for i, val in enumerate(arg_vals):
            pos = i + offset
            if pos < len(names):
                join_param(names[pos], val)
        for kname, val in kw_vals.items():
            if kname in names or kname in kwonly:
                join_param(kname, val)

    def _note_crossing(self, node: ast.AST, kind: str,
                       src: AbsVal) -> None:
        self.crossings.append(Crossing(
            self._key, self._rel, node, kind, src.domain, src.torch))

    # -- queries ----------------------------------------------------------

    def summary_return(self, key: FuncKey) -> AbsVal:
        return self._rets.get(key, BOTTOM)

    def param_summary(self, key: FuncKey) -> dict[str, AbsVal]:
        return dict(self._params.get(key, {}))

    def attr_summary(self, rel: str, cls: str | None,
                     attr: str) -> AbsVal:
        return self._attrs.get((rel, cls, attr), BOTTOM)
