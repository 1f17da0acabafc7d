"""The port's package boundary against the JAX package's.

Every name in the ``__all__`` of JAX's ``data``, ``ops``, ``serve``,
``train``, ``parallel`` and ``models`` resolves in the matching port
subpackage, or is one of the names ``parallel.JAX_COUNTERPARTS`` maps to a
counterpart the port has.  The functions the port added for it
(``minmax_apply``, ``minmax_invert``, ``init_gru_params``,
``restore_checkpoint``) are held against JAX's on the CPU.  The re-exports
are lazy: importing a subpackage loads none of its modules.  About 11 s
alone, 8.6 s under pytest-xdist's ``-n 6 --dist loadfile`` (junit).
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprest_tpu.data import windows as jax_windows
from deeprest_tpu.ops.gru import init_gru_params as jax_init_gru_params
from deeprest_tpu.train import checkpoint as jax_ckpt
from deeprest_tpu_torch.data import windows
from deeprest_tpu_torch.ops import init_gru_params
from deeprest_tpu_torch.parallel import JAX_COUNTERPARTS
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
