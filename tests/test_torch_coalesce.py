"""The port's window-coalesced recurrence, its fused bidirectional launch
and its gate-stash knob against the JAX package, on the CPU.

Tolerances are the JAX package's own kernel tolerances
(tests/test_pallas_gru.py): f32 at 1e-5 against the `scan` backend, bf16
at 2e-2 against the Pallas kernel in interpret mode (whose f32 carry the
port follows), gradients at 2e-4 relative to each gradient's largest
magnitude.  A coalesced group is held against a standalone call within
1e-6, not to the bit: a product over G·B rows may sum in another order
than one over B rows (ROADMAP queue 3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprest_tpu_torch.ops import cuda_gru
from deeprest_tpu_torch.ops.gru import (
    GroupSpec, GRUParams, bidirectional_gru_coalesced, coalesce_windows, gru,
    gru_coalesced, split_coalesced,
)

# the modules, not the functions the packages re-export as `gru`
port_gru = importlib.import_module("deeprest_tpu_torch.ops.gru")
jax_gru = importlib.import_module("deeprest_tpu.ops.gru")
pallas_gru = importlib.import_module("deeprest_tpu.ops.pallas_gru")

E, G, B, T, F, H = 3, 2, 8, 9, 16, 128
# dtype → (torch dtype, jax dtype, JAX backend, tolerance)
DTYPES = {"float32": (torch.float32, jnp.float32, "scan", 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, "pallas_interpret",
                       2e-2)}


def _weights(seed, e=E, f=F, h=H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return [rng.uniform(-k, k, s).astype(np.float32)
            for s in ((e, f, 3 * h), (e, h, 3 * h), (e, 3 * h), (e, 3 * h))]


def _both(arrays, dtype):
    tdt, jdt = DTYPES[dtype][:2]
    return (GRUParams(*[torch.from_numpy(a).to(tdt) for a in arrays]),
            jax_gru.GRUParams(*[jnp.asarray(a, jdt) for a in arrays]))


def _close(got, want, dtype):
    want = np.asarray(want).astype(np.float32)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _close_to_scale(got, want, tol, what):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


def _windows(seed, g=G):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, B, T, F)).astype(np.float32),
            (0.3 * rng.standard_normal((E, g, B, H))).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_coalesced_matches_jax(dtype, reverse):
    port, ref = _both(_weights(1), dtype)
    x, h0 = _windows(2)
    tdt, jdt, backend, _ = DTYPES[dtype]
    want = jax_gru.gru_coalesced(ref, jnp.asarray(x, jdt),
                                 h0=jnp.asarray(h0), reverse=reverse,
                                 backend=backend)
    got = gru_coalesced(port, torch.from_numpy(x).to(tdt),
                        h0=torch.from_numpy(h0), reverse=reverse)
    assert tuple(got.shape) == want.shape == (E, G, B, T, H)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_gru_coalesced_matches_jax(dtype):
    fwd, jfwd = _both(_weights(3), dtype)
    bwd, jbwd = _both(_weights(4), dtype)
    x, _ = _windows(5, g=3)
    tdt, jdt, backend, _ = DTYPES[dtype]
    want = jax_gru.bidirectional_gru_coalesced(jfwd, jbwd,
                                               jnp.asarray(x, jdt),
                                               backend=backend)
    got = bidirectional_gru_coalesced(fwd, bwd, torch.from_numpy(x).to(tdt))
    assert tuple(got.shape) == want.shape == (E, 3, B, T, 2 * H)
    _close(got, want, dtype)


@pytest.mark.parametrize("reverse", [False, True])
def test_each_group_matches_a_standalone_call(reverse):
    port, _ = _both(_weights(6), "float32")
    x, h0 = _windows(7, g=3)
    xt, h0t = torch.from_numpy(x), torch.from_numpy(h0)
    got = gru_coalesced(port, xt, h0=h0t, reverse=reverse)
    for g in range(3):
        alone = gru(port, xt[g], h0=h0t[:, g], reverse=reverse)
        torch.testing.assert_close(got[:, g], alone, rtol=0, atol=1e-6)


def test_each_group_of_the_bidirectional_fold_matches_a_standalone_call():
    fwd, _ = _both(_weights(8), "float32")
    bwd, _ = _both(_weights(9), "float32")
    x = torch.from_numpy(_windows(10, g=4)[0])
    got = bidirectional_gru_coalesced(fwd, bwd, x)
    for g in range(4):
        alone = port_gru.bidirectional_gru(fwd, bwd, x[g])
        torch.testing.assert_close(got[:, g], alone, rtol=0, atol=1e-6)


def test_group_spec_round_trip_and_shape_errors():
    x = torch.arange(G * B * T * F, dtype=torch.float32).reshape(G, B, T, F)
    flat, spec = coalesce_windows(x)
    assert spec == GroupSpec(groups=G, rows=B) and spec.coalesced_rows == G * B
    assert tuple(flat.shape) == (G * B, T, F)
    assert torch.equal(flat[B:2 * B], x[1])               # group-major
    _, jspec = jax_gru.coalesce_windows(jnp.asarray(x.numpy()))
    assert tuple(jspec) == tuple(spec)
    h = torch.randn(E, G * B, T, 5)
    split = split_coalesced(h, spec)
    assert tuple(split.shape) == (E, G, B, T, 5)
    assert torch.equal(split.reshape(E, G * B, T, 5), h)
    with pytest.raises(ValueError, match=r"\[G, B, T, F\]"):
        coalesce_windows(x[0])
    with pytest.raises(ValueError, match="spec says"):
        split_coalesced(h[:, 1:], spec)


def test_default_knobs_match_the_jax_package():
    assert port_gru.BIDIR_FUSED is False and jax_gru.BIDIR_FUSED is False
    assert cuda_gru.STASH_GATES is True and pallas_gru.STASH_GATES is True


@pytest.mark.parametrize("shared_input", [True, False])
def test_fused_bidirectional_matches_unfused(shared_input, monkeypatch):
    arrays = [_weights(11), _weights(12)]
    rng = np.random.default_rng(13)
    shape = (B, T, F) if shared_input else (E, B, T, F)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = torch.from_numpy(
        rng.standard_normal((E, B, T, 2 * H)).astype(np.float32))

    def run(fused):
        monkeypatch.setattr(port_gru, "BIDIR_FUSED", fused)
        leaves = [[torch.from_numpy(a).requires_grad_(True) for a in ws]
                  for ws in arrays]
        xt = torch.from_numpy(x).requires_grad_(True)
        out = port_gru.bidirectional_gru(GRUParams(*leaves[0]),
                                         GRUParams(*leaves[1]), xt)
        (out * cot).sum().backward()
        return out.detach(), [w.grad for ws in leaves for w in ws] + [xt.grad]

    out_u, grads_u = run(False)
    out_f, grads_f = run(True)
    torch.testing.assert_close(out_f, out_u, rtol=1e-5, atol=1e-5)
    for i, (g, w) in enumerate(zip(grads_f, grads_u)):
        _close_to_scale(g, w.numpy(), 2e-4, f"grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bidirectional_matches_jax_fused(dtype, monkeypatch):
    """As tests/test_coalesce.py pins the JAX fused path against its scan
    spec: the port's fused path against the JAX one."""
    fwd, jfwd = _both(_weights(14, f=8), dtype)
    bwd, jbwd = _both(_weights(15, f=8), dtype)
    x = np.random.default_rng(16).standard_normal((4, T, 8)).astype(
        np.float32)
    tdt, jdt = DTYPES[dtype][:2]
    monkeypatch.setattr(jax_gru, "BIDIR_FUSED", True)
    monkeypatch.setattr(port_gru, "BIDIR_FUSED", True)
    want = jax_gru.bidirectional_gru(jfwd, jbwd, jnp.asarray(x, jdt),
                                     backend="pallas_interpret")
    got = port_gru.bidirectional_gru(fwd, bwd, torch.from_numpy(x).to(tdt))
    assert tuple(got.shape) == want.shape == (E, 4, T, 2 * H)
    _close(got, want, dtype)


def test_fused_bidirectional_is_one_recurrence_call(monkeypatch):
    calls = []

    def counted(proj, w_hh, b_hh, h0, reverse):
        calls.append((tuple(proj.shape), reverse))
        return cuda_gru.gru_recurrence(proj, w_hh, b_hh, h0, reverse)

    fwd, _ = _both(_weights(17), "float32")
    x = torch.from_numpy(_windows(18)[0])
    for fused, want in ((False, [((E, T, G * B, 3 * H), False),
                                 ((E, T, G * B, 3 * H), True)]),
                        (True, [((2 * E, T, G * B, 3 * H), False)])):
        monkeypatch.setattr(port_gru, "BIDIR_FUSED", fused)
        calls.clear()
        bidirectional_gru_coalesced(fwd, fwd, x, recurrence=counted)
        assert calls == want


@pytest.mark.parametrize("reverse", [False, True])
def test_stash_off_grads_match_jax_grad(reverse, monkeypatch):
    monkeypatch.setattr(cuda_gru, "STASH_GATES", False)
    monkeypatch.setattr(pallas_gru, "STASH_GATES", False)
    arrays = _weights(19)
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    cot = rng.standard_normal((E, B, T, H)).astype(np.float32)

    def jax_loss(params, xx):
        out = jax_gru.gru(jax_gru.GRUParams(*params), xx, reverse=reverse,
                          backend="pallas_interpret")
        return jnp.sum(out * cot)

    jgrads = jax.grad(jax_loss, argnums=(0, 1))(
        [jnp.asarray(a) for a in arrays], jnp.asarray(x))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gru(GRUParams(*leaves), xt, reverse=reverse)
    assert out.grad_fn.next_functions[0][0].saved_tensors[-1] is None
    (out * torch.from_numpy(cot)).sum().backward()
    for name, leaf, want in zip(("w_ih", "w_hh", "b_ih", "b_hh"), leaves,
                                jgrads[0]):
        _close_to_scale(leaf.grad, want, 2e-4, name)
    _close_to_scale(xt.grad, jgrads[1], 2e-4, "x")


def test_stash_knob_drives_the_training_forward(monkeypatch):
    rng = np.random.default_rng(21)
    proj = torch.from_numpy(rng.standard_normal((2, 5, 3, 48)).astype(
        np.float32))
    w_hh = torch.from_numpy((0.1 * rng.standard_normal((2, 16, 48))).astype(
        np.float32))
    b_hh, h0 = torch.zeros(2, 48), torch.zeros(2, 3, 16)
    on = cuda_gru.gru_fwd_train_reference(proj, w_hh, b_hh, h0)
    monkeypatch.setattr(cuda_gru, "STASH_GATES", False)
    off = cuda_gru.gru_fwd_train_reference(proj, w_hh, b_hh, h0)
    assert on[2] is not None and off[2] is None
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    dout = torch.ones_like(on[0])
    with_stash = cuda_gru.gru_bwd_reference(proj, on[1], on[2], w_hh, b_hh,
                                            dout)
    recompute = cuda_gru.gru_bwd_reference(proj, off[1], None, w_hh, b_hh,
                                           dout)
    for a, b in zip(with_stash, recompute):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
