"""Tensor ops of the port: the GRU recurrence with its CUDA kernels, and
the pinball loss."""

from deeprest_tpu_torch.ops.gru import (
    GroupSpec,
    GRUParams,
    bidirectional_gru,
    bidirectional_gru_coalesced,
    gru,
    gru_coalesced,
    init_gru_params,
)
from deeprest_tpu_torch.ops.quantile import pinball_loss

__all__ = [
    "GroupSpec",
    "GRUParams",
    "gru",
    "gru_coalesced",
    "bidirectional_gru",
    "bidirectional_gru_coalesced",
    "init_gru_params",
    "pinball_loss",
]
