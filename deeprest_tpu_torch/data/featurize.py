"""The featurized corpus container (``deeprest_tpu/data/featurize.py``,
``FeaturizedData`` only).

The port has no featurizer yet: it reads the ``.npz`` files that
``python -m deeprest_tpu featurize`` writes, and writes files of the same
layout.  The call-path vocabulary stays as the JSON dict the file embeds
(``space_json``, the JAX ``CallPathSpace.to_dict()``): the trainer copies
it into the checkpoint sidecar and the ``predict`` CLI compares it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class FeaturizedData:
    """Traffic features, resource series and invocation counts of one
    corpus, with its call-path vocabulary."""

    traffic: np.ndarray                    # [T, capacity] float32 path counts
    resources: dict[str, np.ndarray]       # metric key → [T] float32
    invocations: dict[str, np.ndarray]     # component → [T] float32
    space_dict: dict                       # CallPathSpace.to_dict() of JAX

    @property
    def metric_names(self) -> list[str]:
        return list(self.resources)

    def targets(self) -> np.ndarray:
        """[T, num_metrics] resource matrix in metric_names order."""
        return np.stack([self.resources[k] for k in self.metric_names], axis=-1)

    def save(self, path: str) -> str:
        """One ``.npz`` file in the JAX package's layout; returns the path
        written (``.npz`` is appended when missing)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez_compressed(
            path,
            traffic=self.traffic,
            resource_names=np.array(self.metric_names),
            resource_values=self.targets(),
            invocation_names=np.array(list(self.invocations)),
            invocation_values=np.stack(
                [self.invocations[k] for k in self.invocations], axis=-1
            ) if self.invocations else np.zeros((len(self.traffic), 0)),
            space_json=np.frombuffer(
                json.dumps(self.space_dict).encode(), dtype=np.uint8
            ),
        )
        return path

    @classmethod
    def load(cls, path: str) -> "FeaturizedData":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            resources = {
                str(name): z["resource_values"][:, i].astype(np.float32)
                for i, name in enumerate(z["resource_names"])
            }
            invocations = {
                str(name): z["invocation_values"][:, i].astype(np.float32)
                for i, name in enumerate(z["invocation_names"])
            }
            return cls(traffic=z["traffic"].astype(np.float32),
                       resources=resources, invocations=invocations,
                       space_dict=json.loads(bytes(z["space_json"]).decode()))
