"""Benchmarks of the port: ``kernel_tuning``, the GRU kernel tuning sweep
(counterpart of the JAX package's ``benchmarks/kernel_tuning.py``)."""
