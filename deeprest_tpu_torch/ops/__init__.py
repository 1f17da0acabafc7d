"""Tensor ops of the port: the GRU recurrence with its CUDA kernels, and
the pinball loss."""
