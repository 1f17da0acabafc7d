"""Gradients of the port's GRU (the autograd Function on its CPU route)
against ``jax.grad`` through the JAX package's Pallas kernels in interpret
mode (``gru(..., backend="pallas_interpret")``), on the CPU.

Both directions, at the kernel tolerances of tests/test_pallas_gru.py:
2e-4 in f32 and 2e-2 in bf16, relative to each gradient's largest
magnitude (the two sides sum in another order).  T=6 is one time block of
the JAX kernel; the ragged cases are in tests/test_torch_gru_train.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprest_tpu_torch.ops.gru import GRUParams, gru

jax_gru = importlib.import_module("deeprest_tpu.ops.gru")

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _close_to_scale(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


def _gru_weights(h, seed, e=3, f=11):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return [rng.uniform(-k, k, s).astype(np.float32)
            for s in ((e, f, 3 * h), (e, h, 3 * h), (e, 3 * h), (e, 3 * h))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_jax_grad_pallas_interpret(dtype, reverse):
    tdt, jdt = DTYPES[dtype]
    e, b, t, f, h = 3, 5, 6, 11, 128
    arrays = _gru_weights(h, seed=3, e=e, f=f)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    cot = rng.standard_normal((e, b, t, h)).astype(np.float32)

    def jax_loss(params, xx):
        out = jax_gru.gru(jax_gru.GRUParams(*params), xx, reverse=reverse,
                          backend="pallas_interpret")
        return jnp.sum(out.astype(jnp.float32) * cot)

    jparams = [jnp.asarray(a, jdt) for a in arrays]
    jgrads = jax.grad(jax_loss, argnums=(0, 1))(jparams, jnp.asarray(x, jdt))

    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in arrays]
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = gru(GRUParams(*leaves), xt, reverse=reverse)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    for name, leaf, want in zip(names, leaves, jgrads[0]):
        assert leaf.grad.dtype == tdt, name
        _close_to_scale(leaf.grad, want, GRAD_TOL[dtype], name)
    _close_to_scale(xt.grad, jgrads[1], GRAD_TOL[dtype], "x")
