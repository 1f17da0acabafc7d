"""The training half of the port's GRU recurrence against the JAX package's
Pallas kernels in interpret mode, on the CPU.

- K2's plain version (``gru_fwd_train_reference``) against
  ``_fwd_call(emit_prev=True, interpret=True)`` on ``(h_all, h_prev,
  gates)``, and K3's plain version (``gru_bwd_reference``) against
  ``_bwd_call(..., interpret=True)`` with the gate stash on and off, at
  E=2, T=12 (a multiple of the kernel's time block), B=16, H=128.  Under
  ``reverse`` the JAX side runs the time-flipped input, as its
  ``_gru_pallas`` does.
- The autograd Function (its CPU route) against torch autograd through
  the plain forward (tests/test_torch_gru_grad.py holds it against
  ``jax.grad`` through the JAX kernels).

Tolerances are the JAX package's kernel tolerances
(tests/test_pallas_gru.py): forward 1e-5 in f32, gradients 2e-4 in f32,
2e-2 in bf16, gradients relative to each tensor's largest magnitude (they
are summed in another order on the two sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprest_tpu.ops import pallas_gru
from deeprest_tpu_torch.ops import cuda_gru
from deeprest_tpu_torch.ops.gru import GRUParams, bidirectional_gru

E, T, B, H = 2, 12, 16, 128
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _recurrence_inputs(seed, e=E, t=T, b=B, h=H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return (rng.standard_normal((e, t, b, 3 * h)).astype(np.float32),
            rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32),
            rng.uniform(-k, k, (e, 3 * h)).astype(np.float32),
            (0.5 * rng.standard_normal((e, b, h))).astype(np.float32))


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


def _close_to_scale(got, want, tol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


def _flip(x, reverse):
    return x[:, ::-1] if reverse else x


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_plain_matches_jax_pallas(dtype, reverse):
    tdt, jdt = DTYPES[dtype]
    proj, w, b, h0 = _recurrence_inputs(0)
    want = pallas_gru._fwd_call(
        jnp.asarray(_flip(proj, reverse), jdt), jnp.asarray(w, jdt),
        jnp.asarray(b), jnp.asarray(h0), True, emit_prev=True)
    got = cuda_gru.gru_fwd_train_reference(
        torch.from_numpy(proj).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(b), torch.from_numpy(h0), reverse=reverse)
    for name, g, w_ in zip(("h_all", "h_prev", "gates"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == w_.shape, name
        w_ = _flip(_np(w_), reverse)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), w_, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            _close_to_scale(g, w_, 2e-2, name)
    # the inference form is the training form's first output
    torch.testing.assert_close(
        cuda_gru.gru_recurrence_reference(
            torch.from_numpy(proj).to(tdt), torch.from_numpy(w).to(tdt),
            torch.from_numpy(b), torch.from_numpy(h0), reverse=reverse),
        got[0], rtol=0, atol=0)


@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_jax_pallas(dtype, reverse, stash):
    tdt, jdt = DTYPES[dtype]
    proj, w, b, h0 = _recurrence_inputs(1)
    dout = np.random.default_rng(2).standard_normal(
        (E, T, B, H)).astype(np.float32)
    jproj = jnp.asarray(_flip(proj, reverse), jdt)
    _, jh_prev, jgates = pallas_gru._fwd_call(
        jproj, jnp.asarray(w, jdt), jnp.asarray(b), jnp.asarray(h0), True,
        emit_prev=True)
    want = pallas_gru._bwd_call(
        jproj, jh_prev, jgates if stash else None, jnp.asarray(w, jdt),
        jnp.asarray(b), jnp.asarray(_flip(dout, reverse), jdt), True)
    # the port reads the same residuals, time-aligned with its own proj
    h_prev = torch.from_numpy(_flip(_np(jh_prev), reverse).copy()).to(tdt)
    gates = torch.from_numpy(_flip(_np(jgates), reverse).copy()).to(tdt)
    got = cuda_gru.gru_bwd_reference(
        torch.from_numpy(proj).to(tdt), h_prev, gates if stash else None,
        torch.from_numpy(w).to(tdt), torch.from_numpy(b),
        torch.from_numpy(dout).to(tdt), reverse=reverse)
    for name, g, w_ in zip(("dproj", "dW_hh", "db_hh", "dh0"), got, want):
        assert tuple(g.shape) == w_.shape, name
        w_ = _np(w_)
        if name == "dproj":
            w_ = _flip(w_, reverse)
        _close_to_scale(g, w_, GRAD_TOL[dtype], name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_autograd_through_plain_forward(dtype, reverse):
    tdt, _ = DTYPES[dtype]
    proj, w, b, h0 = _recurrence_inputs(5, e=3, t=7, b=5, h=16)
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 7, 5, 16)).astype(np.float32))

    def grads(fn):
        leaves = [torch.from_numpy(proj).to(tdt), torch.from_numpy(w).to(tdt),
                  torch.from_numpy(b), torch.from_numpy(h0)]
        leaves = [x.requires_grad_(True) for x in leaves]
        out = fn(*leaves, reverse)
        (out.float() * cot).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    out, got = grads(cuda_gru.GRURecurrence.apply)
    ref_out, want = grads(cuda_gru.gru_recurrence_reference)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for name, g, w_ in zip(("dproj", "dW_hh", "db_hh", "dh0"), got, want):
        assert g.dtype == w_.dtype, name
        _close_to_scale(g, w_, GRAD_TOL[dtype], name)


def _gru_weights(h, seed, e=3, f=11):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return [rng.uniform(-k, k, s).astype(np.float32)
            for s in ((e, f, 3 * h), (e, h, 3 * h), (e, 3 * h), (e, 3 * h))]


def test_dispatch_picks_the_form_autograd_needs():
    proj, w, b, h0 = (torch.from_numpy(a)
                      for a in _recurrence_inputs(7, e=2, t=3, b=4, h=8))
    assert cuda_gru.gru_recurrence(proj, w, b, h0).grad_fn is None
    w.requires_grad_(True)
    out = cuda_gru.gru_recurrence(proj, w, b, h0)
    assert type(out.grad_fn).__name__ == "GRURecurrenceBackward"
    with torch.no_grad():
        assert cuda_gru.gru_recurrence(proj, w, b, h0).grad_fn is None
    # the bidirectional model path trains through the Function as well
    fwd = GRUParams(*[torch.from_numpy(a).requires_grad_(True)
                      for a in _gru_weights(8, seed=8, e=2, f=4)])
    out = bidirectional_gru(fwd, fwd, torch.zeros((4, 3, 4)))
    out.sum().backward()
    assert all(p.grad is not None for p in fwd)


def test_backward_wrapper_raises_on_cpu_tensors():
    proj, w, b, h0 = (torch.from_numpy(a)
                      for a in _recurrence_inputs(9, e=2, t=3, b=4, h=128))
    h_prev = torch.zeros((2, 3, 4, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_gru.gru_bwd_cuda(proj, h_prev, None, w, b, h_prev)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_gru.gru_fwd_train_cuda(proj, w, b, h0)
    with pytest.raises(ValueError, match="dout"):
        cuda_gru.gru_bwd_cuda(proj, h_prev, None, w, b, h_prev[:, :2])
