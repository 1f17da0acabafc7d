"""The port's pinball loss against the JAX package's, on the CPU.

Loss and gradient at rtol 1e-6 (float32, the same reductions on both
sides); the ``allow_empty`` contract exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprest_tpu.ops.quantile import pinball_loss as jax_pinball_loss
from deeprest_tpu_torch.ops.quantile import pinball_loss

Q = (0.05, 0.5, 0.95)


def _inputs(seed, b=6, t=5, e=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, e, len(Q))).astype(np.float32),
            rng.standard_normal((b, t, e)).astype(np.float32))


@pytest.mark.parametrize("weights", [None, [1, 1, 0, 1, 0, 1],
                                     [0.5, 2, 1, 1, 3, 0]])
@pytest.mark.parametrize("allow_empty", [False, True])
def test_pinball_loss_and_grad_match_jax(weights, allow_empty):
    preds, targets = _inputs(0)
    w = None if weights is None else np.asarray(weights, np.float32)

    def jax_loss(p):
        return jax_pinball_loss(p, targets, Q,
                                sample_weight=None if w is None else w,
                                allow_empty=allow_empty)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    got = pinball_loss(p, torch.from_numpy(targets), Q,
                       sample_weight=None if w is None else torch.from_numpy(w),
                       allow_empty=allow_empty)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-9)


def test_allow_empty_all_zero_weights_gives_zero_loss_and_zero_grads():
    preds, targets = _inputs(1)
    zeros = torch.zeros(preds.shape[0])
    p = torch.from_numpy(preds).requires_grad_(True)
    loss = pinball_loss(p, torch.from_numpy(targets), Q, sample_weight=zeros,
                        allow_empty=True)
    loss.backward()
    assert float(loss) == 0.0
    assert torch.count_nonzero(p.grad) == 0
    # without the guard the weighted mean is 0/0, as in the JAX package
    assert torch.isnan(pinball_loss(torch.from_numpy(preds),
                                    torch.from_numpy(targets), Q,
                                    sample_weight=zeros))


def test_allow_empty_changes_nothing_for_real_batches():
    preds, targets = _inputs(2)
    w = torch.tensor([1, 0, 1, 1, 1, 0], dtype=torch.float32)
    args = (torch.from_numpy(preds), torch.from_numpy(targets), Q)
    assert torch.equal(pinball_loss(*args, sample_weight=w),
                       pinball_loss(*args, sample_weight=w, allow_empty=True))
    # zero-weight rows contribute nothing: the loss of the real rows alone
    real = w.bool()
    alone = pinball_loss(args[0][real], args[1][real], Q)
    torch.testing.assert_close(pinball_loss(*args, sample_weight=w), alone,
                               rtol=1e-6, atol=0)
