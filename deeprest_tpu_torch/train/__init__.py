"""Training side of the port: dataset preparation, the per-step trainer,
metrics, and the checkpoint format."""
