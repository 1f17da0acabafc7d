"""Quantile (pinball) regression loss (``deeprest_tpu/ops/quantile.py``).

The same reductions as the JAX package: sum over quantiles, mean over
batch × time (weighted when ``sample_weight`` is given), mean over metrics.
"""

from __future__ import annotations

from typing import Sequence

import torch


def pinball_loss(preds: torch.Tensor, targets: torch.Tensor,
                 quantiles: Sequence[float] | torch.Tensor,
                 sample_weight: torch.Tensor | None = None,
                 allow_empty: bool = False,
                 weight_sum: torch.Tensor | None = None,
                 num_metrics: int | None = None) -> torch.Tensor:
    """Mean pinball loss.

    ``preds [B, T, E, Q]``, ``targets [B, T, E]``, ``quantiles`` the Q
    levels in prediction order (a tensor on preds' device keeps the call
    free of host-to-device copies, as a CUDA-graph capture needs);
    ``sample_weight [B]`` makes the batch mean
    a weighted mean (zero-weight rows pad a ragged batch to its static
    size).  ``allow_empty`` floors the weighted mean's denominator at 1, so
    an all-zero-weight batch gives loss 0 and exactly-zero gradients
    instead of 0/0; a real batch has ``sum(weight) >= 1`` and the floor
    changes nothing.  ``weight_sum`` replaces ``sum(sample_weight)`` as
    the denominator (the floor applies to it): a data-parallel rank holds
    a slice of the batch's weights and divides by the GLOBAL batch's sum,
    so its loss is its share of the global loss and the ranks' losses and
    gradients sum to the global ones.  ``num_metrics`` replaces the
    metric count of the mean over metrics the same way: an expert rank
    holds its experts' columns (``preds [B, T, E/e, Q]``) and divides their
    sum by the GLOBAL E; without it the mean is ``per_metric.mean()``, bit
    for bit.  Returns the scalar
    ``mean_E(mean_{B,T}(sum_Q max((q-1)·err, q·err)))``, ``err = target -
    pred``.
    """
    q = (quantiles.to(preds.dtype) if isinstance(quantiles, torch.Tensor)
         # graftlint: disable=TX006 -- host callers only: the captured update passes the quantiles as a device tensor (Trainer._quantiles), which the branch above takes
         else torch.as_tensor(quantiles, dtype=preds.dtype,
                              device=preds.device))
    err = targets[..., None] - preds                        # [B, T, E, Q]
    per_q = torch.maximum((q - 1.0) * err, q * err)
    per_sample = per_q.sum(dim=-1)                          # [B, T, E]
    if sample_weight is None:
        per_metric = per_sample.mean(dim=(0, 1))
    else:
        w = sample_weight.to(per_sample.dtype)[:, None, None]
        den = sample_weight.sum() if weight_sum is None else weight_sum
        if allow_empty:
            den = torch.clamp_min(den, 1.0)
        per_metric = (per_sample * w).sum(dim=(0, 1)) / (
            den * per_sample.shape[1])
    if num_metrics is None:
        return per_metric.mean()
    return per_metric.sum() / num_metrics
