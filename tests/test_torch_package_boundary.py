"""The port's package boundary against the JAX package's.

Every name in the ``__all__`` of JAX's ``data``, ``ops``, ``serve``,
``train``, ``parallel`` and ``models`` resolves in the matching port
subpackage, or is one of the names ``parallel.JAX_COUNTERPARTS`` maps to a
counterpart the port has.  Every public member of each class among those
names (what the class and its bases in the JAX package define, and its
dataclass or NamedTuple fields) resolves on the port's class of that
name, or ``parallel.JAX_MEMBER_COUNTERPARTS`` maps it to a counterpart
that resolves.  ``QuantileGRU.quantiles`` and
``FusedRolledEngine.cache_size()`` read JAX's values on one checkpoint
and the same calls.  The functions the port added for it
(``minmax_apply``, ``minmax_invert``, ``init_gru_params``,
``restore_checkpoint``) are held against JAX's on the CPU.  The re-exports
are lazy: importing a subpackage loads none of its modules.  About 11 s
alone, 8.6 s under pytest-xdist's ``-n 6 --dist loadfile`` (junit).
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_aot_mesh_support as aot_support
from deeprest_tpu.data import windows as jax_windows
from deeprest_tpu.ops.gru import init_gru_params as jax_init_gru_params
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.train import checkpoint as jax_ckpt
from deeprest_tpu_torch.data import windows
from deeprest_tpu_torch.ops import init_gru_params
from deeprest_tpu_torch.parallel import (
    JAX_COUNTERPARTS, JAX_MEMBER_COUNTERPARTS,
)
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("data", "ops", "serve", "train", "parallel", "models")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_public_name_resolves_in_the_port(sub):
    jax_pkg = importlib.import_module(f"deeprest_tpu.{sub}")
    port_pkg = importlib.import_module(f"deeprest_tpu_torch.{sub}")
    missing = []
    for name in jax_pkg.__all__:
        if name in JAX_COUNTERPARTS:
            assert sub == "parallel", name
            with pytest.raises(AttributeError, match=JAX_COUNTERPARTS[name]):
                getattr(port_pkg, name)
            continue
        if not hasattr(port_pkg, name):
            missing.append(name)
            continue
        value = getattr(port_pkg, name)
        jax_value = getattr(jax_pkg, name)
        # the same kind of thing: a class for a class, a function for one
        assert isinstance(value, type) == isinstance(jax_value, type), name
        assert callable(value) == callable(jax_value), name
    assert not missing, missing
    assert set(jax_pkg.__all__) - set(JAX_COUNTERPARTS) <= set(
        port_pkg.__all__)


def _fields(cls) -> set:
    """A class's dataclass or NamedTuple fields."""
    names = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def _has_member(cls, name: str) -> bool:
    """Whether ``cls`` has ``name``: an attribute, a field, or an
    instance attribute one of its classes annotates."""
    return hasattr(cls, name) or isinstance(cls, type) and (
        name in _fields(cls) or any(name in vars(k).get("__annotations__",
                                                        {})
                                    for k in cls.__mro__))


def _public_members(cls) -> set:
    """What a JAX package class and its bases in that package define, and
    its fields: its public members."""
    names = _fields(cls)
    for klass in cls.__mro__:
        if klass.__module__.partition(".")[0] == "deeprest_tpu":
            names |= set(vars(klass))
    return {n for n in names if not n.startswith("_")}


def _resolves(path: str) -> bool:
    """Whether a counterpart (``train.Trainer.init_state`` under
    deeprest_tpu_torch, or ``torch.nn.Module.named_children``) names a
    member or object that exists."""
    parts = (path if path.startswith("torch.")
             else f"deeprest_tpu_torch.{path}").split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        break
    for attr in parts[cut:-1]:
        obj = getattr(obj, attr)
    return _has_member(obj, parts[-1])


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_public_member_resolves_on_the_port_class(sub):
    jax_pkg = importlib.import_module(f"deeprest_tpu.{sub}")
    port_pkg = importlib.import_module(f"deeprest_tpu_torch.{sub}")
    missing, mapped = [], set()
    for cls_name in jax_pkg.__all__:
        jax_cls = getattr(jax_pkg, cls_name)
        if cls_name in JAX_COUNTERPARTS or not isinstance(jax_cls, type):
            continue
        port_cls = getattr(port_pkg, cls_name)
        for member in sorted(_public_members(jax_cls)):
            key = f"{sub}.{cls_name}.{member}"
            if key in JAX_MEMBER_COUNTERPARTS:
                mapped.add(key)
                # a member the port has now leaves the table
                assert not _has_member(port_cls, member), key
                assert _resolves(JAX_MEMBER_COUNTERPARTS[key]), key
            elif not _has_member(port_cls, member):
                missing.append(key)
    assert not missing, missing
    # every entry of the table names a public member of a JAX class
    assert mapped == {k for k in JAX_MEMBER_COUNTERPARTS
                      if k.startswith(f"{sub}.")}


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    return aot_support.write_checkpoint(
        tmp_path_factory.mktemp("members") / "ckpt")


def test_quantiles_and_fused_cache_size_read_jax_values(checkpoint_dir):
    """One checkpoint, the same calls.  The module's quantiles are JAX's.
    The fused engine's count reads JAX's after a first short call (one
    program at one rung) and after the whole mix, and neither count moves
    when the mix runs again.  The two count different things: the
    port one graph (on the CPU one key) a (program, rung), with
    ``integrate=False`` a program of its own; JAX one executable a
    signature of its program, where ``integrate`` is an argument and a
    page whose carry is the previous page's output compiles a second
    executable at the same rung."""
    jax_pred = JaxPredictor.from_checkpoint(checkpoint_dir)
    pred = Predictor.from_checkpoint(checkpoint_dir, device="cpu")
    assert pred.model.quantiles == tuple(jax_pred.model.quantiles)
    assert pred.model.quantiles == pred.quantiles
    w, f = aot_support.W, aot_support.F
    traffic = np.random.default_rng(0).random((12 * w + 3, f)).astype(
        np.float32)
    calls = [(traffic[:3 * w], True), (traffic, True), (traffic, False),
             (traffic[:5 * w + 1], True)]

    def run(calls):
        for series, integrate in calls:
            for p in (pred, jax_pred):
                p.predict_series(series, integrate=integrate)
            assert pred.fused.cache_size() == pred.jit_cache_stats()[
                "fused"] == len(pred.fused.stats()["graphs"]["rungs"])
        return pred.fused.cache_size(), jax_pred.fused.cache_size()

    assert run(calls[:1]) == (1, 1)
    # the port: fused and fused_increments at 8; JAX: its program at 8
    # with a zero carry and with the previous page's
    assert run(calls) == (2, 2)
    assert run(calls) == (2, 2)
    tenant = Predictor.from_checkpoint(checkpoint_dir, device="cpu")
    tenant.share_executables_from(pred)
    assert tenant.fused.cache_size() == pred.plane.fused.cache_size()


def test_jax_counterparts_exist_in_the_port():
    jax_parallel = importlib.import_module("deeprest_tpu.parallel")
    assert set(JAX_COUNTERPARTS) == {"batch_sharding", "param_sharding",
                                     "state_sharding", "shard_batch",
                                     "prefetch_to_device"}
    for jax_name, target in JAX_COUNTERPARTS.items():
        assert jax_name in jax_parallel.__all__
        module, _, name = f"deeprest_tpu_torch.{target}".rpartition(".")
        assert callable(getattr(importlib.import_module(module), name)), \
            target


def test_subpackages_load_their_modules_lazily():
    """Importing a subpackage loads none of its modules, and the analyzer
    loads no subpackage's modules (phase 22's run with no JAX)."""
    code = (
        "import sys\n"
        "import deeprest_tpu_torch.analysis\n"
        "import deeprest_tpu_torch.serve, deeprest_tpu_torch.train\n"
        "import deeprest_tpu_torch.data, deeprest_tpu_torch.models\n"
        "loaded = sorted(m for m in sys.modules if m.startswith("
        "('deeprest_tpu_torch.serve.', 'deeprest_tpu_torch.train.', "
        "'deeprest_tpu_torch.data.', 'deeprest_tpu_torch.models.')))\n"
        "assert not loaded, loaded\n"
        "assert 'torch' not in sys.modules\n"
        "from deeprest_tpu_torch.serve import Predictor\n"
        "assert 'deeprest_tpu_torch.serve.predictor' in sys.modules\n"
        "assert 'Predictor' in dir(deeprest_tpu_torch.serve)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'deeprest_tpu.')) or m == 'deeprest_tpu' for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_minmax_apply_and_invert_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6, 3)).astype(np.float32)
    x[:, :, 1] = 2.5          # a constant metric: its range is 0
    stats = windows.minmax_fit(x, 30, axis=(0, 1))
    jax_stats = jax_windows.minmax_fit(x, 30, axis=(0, 1))
    got = windows.minmax_apply(x, stats)
    want = jax_windows.minmax_apply(x, jax_stats)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(windows.minmax_invert(got, stats),
                               jax_windows.minmax_invert(want, jax_stats),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(windows.minmax_invert(got, stats), x,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_gru_params_matches_jax_in_shape_dtype_and_bounds(dtype):
    """The two draw from different PRNGs, so values agree in distribution
    only: shapes, dtypes, the Uniform(-1/sqrt(H), 1/sqrt(H)) bounds, and
    the spread of the draw.  A numpy seed gives the port the same values
    on every call."""
    e, f, h = 3, 7, 16
    mine = init_gru_params(5, e, f, h, dtype=getattr(torch, dtype),
                           device="cpu")
    ref = jax_init_gru_params(jax.random.PRNGKey(5), e, f, h,
                              dtype=getattr(jnp, dtype))
    k = 1.0 / np.sqrt(h)
    for name, a, b in zip(mine._fields, mine, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        a32 = a.float().numpy()
        b32 = np.asarray(b, np.float32)
        for arr in (a32, b32):
            assert arr.min() >= -k - 1e-6 and arr.max() <= k + 1e-6, name
            # a uniform draw's standard deviation is k / sqrt(3)
            assert abs(arr.std() - k / np.sqrt(3)) < 0.15 * k, name
    again = init_gru_params(5, e, f, h, device="cpu")
    for a, b in zip(init_gru_params(5, e, f, h, device="cpu"), again):
        assert torch.equal(a, b)


def _state(rng) -> dict:
    return {"params": {"mask_w1": rng.normal(size=(4, 8)).astype(np.float32),
                       "head_b": rng.normal(size=(4, 3)).astype(np.float32)},
            "opt_state": [{"mu": {"head_b": rng.normal(size=(4, 3))
                                  .astype(np.float32)}}],
            "step": np.asarray(7, np.int32)}


def _torch_target(state):
    if isinstance(state, dict):
        return {k: _torch_target(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_torch_target(v) for v in state]
    return torch.zeros(np.shape(state), dtype=torch.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def test_restore_checkpoint_matches_jax_on_a_jax_checkpoint(tmp_path):
    state = _state(np.random.default_rng(1))
    jax_ckpt.save_checkpoint(str(tmp_path), jax.tree.map(jnp.asarray,
                                                         state), 3,
                             extra={"note": "jax"})
    want, want_side = jax_ckpt.restore_checkpoint(
        str(tmp_path), jax.tree.map(jnp.zeros_like, state))
    got, side = checkpoint.restore_checkpoint(str(tmp_path),
                                              _torch_target(state))
    assert side == want_side and side["note"] == "jax"
    got_flat, want_flat = dict(_flat(got)), dict(_flat(want))
    assert sorted(got_flat) == sorted(want_flat)
    for name, value in got_flat.items():
        assert isinstance(value, torch.Tensor), name
        np.testing.assert_allclose(value.numpy(), np.asarray(want_flat[name]),
                                   rtol=1e-6, atol=1e-6)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_restore_checkpoint_reads_a_port_checkpoint_as_jax_does(tmp_path):
    state = _state(np.random.default_rng(2))
    checkpoint.save_checkpoint(
        str(tmp_path), {k: torch.from_numpy(v)
                        for k, v in state["params"].items()}, 4,
        extra={"note": "port"},
        other_leaves={"opt_state/0/mu/head_b": torch.from_numpy(
            state["opt_state"][0]["mu"]["head_b"]),
            "step": torch.tensor(7, dtype=torch.int32)})
    want, _ = jax_ckpt.restore_checkpoint(
        str(tmp_path), jax.tree.map(jnp.zeros_like, state), step=4)
    got, side = checkpoint.restore_checkpoint(str(tmp_path),
                                              _torch_target(state), step=4)
    assert side["note"] == "port"
    want_flat = dict(_flat(want))
    for name, value in _flat(got):
        np.testing.assert_allclose(value.numpy(), np.asarray(want_flat[name]),
                                   rtol=1e-6, atol=1e-6)


def test_restore_checkpoint_refuses_what_jax_refuses(tmp_path):
    state = _state(np.random.default_rng(3))
    jax_ckpt.save_checkpoint(str(tmp_path), state, 1)
    bad = _torch_target(state)
    bad["params"]["head_b"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="architecture drift"):
        checkpoint.restore_checkpoint(str(tmp_path), bad)
    extra = _torch_target(state)
    extra["params"]["head_w"] = torch.zeros(2)
    with pytest.raises(KeyError, match="head_w"):
        checkpoint.restore_checkpoint(str(tmp_path), extra)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"), extra)
