"""Serving: checkpoint in, rolled quantile predictions out.

The public names are the JAX package's (``deeprest_tpu/serve/__init__.py``),
each loaded from its module when first read."""

from deeprest_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "BatcherConfig": "batcher", "MicroBatcher": "batcher",
    "ShapeLadder": "batcher",
    "FusedRolledEngine": "fused",
    "Predictor": "predictor", "rolled_prediction": "predictor",
    "rolled_prediction_reference": "predictor",
    "CapacitySurface": "surface", "CapacitySurfaceManager": "surface",
    "MixSpace": "surface",
    "WhatIfEstimator": "whatif",
    "AnomalyDetector": "anomaly", "AnomalyReport": "anomaly",
    "ExportedPredictor": "export", "export_predictor": "export",
    "CheckpointReloader": "server", "PredictionServer": "server",
    "PredictionService": "server", "ServingError": "server",
    "EngineReplica": "replica", "ProcessReplica": "replica",
    "ReplicaDeadError": "replica", "clone_backend": "replica",
    "AdmissionError": "router", "ReplicaRouter": "router",
    "RouterConfig": "router",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
