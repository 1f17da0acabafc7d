"""Read-side access to the precomputed demo results artifact
(``deeprest_tpu/demo/results.py``).

The counterpart of the reference demo's DataLoader (reference:
web-demo/dataloader.py:30-49,82-167), over the JSON artifact written by
precompute.py.  Re-anchoring and scale factors are already baked in at
precompute time, so reads are plain lookups; this class adds the option
wiring (which multipliers/compositions exist for a shape — reference:
dataloader.py:34-49) and panel assembly for the UI.
"""

from __future__ import annotations

import gzip
import json

from deeprest_tpu_torch.demo.precompute import dataset_name


class ResultsStore:
    def __init__(self, results: dict):
        self.results = results
        self.meta = results["meta"]
        self.datasets = results["datasets"]

    @classmethod
    def load(cls, path: str) -> "ResultsStore":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            return cls(json.loads(f.read().decode()))

    # -- option wiring (reference: dataloader.py:34-49) --------------------

    def options_shape(self) -> list[dict]:
        labels = {"waves": "Two peak hours per day", "flat": "Roughly stable"}
        return [{"label": labels.get(s, s), "value": s}
                for s in self.meta["shapes"]]

    def options_multiplier(self, shape: str) -> list[int]:
        if shape != "waves":
            return [1]
        return list(self.meta["multipliers"])

    def options_composition(self, shape: str) -> dict[str, list[list[float]]]:
        out = {"seen": self.meta["compositions"]["seen"]}
        if shape == "waves":
            out["unseen"] = self.meta["compositions"]["unseen"]
        return out

    # -- panel assembly ----------------------------------------------------

    def dataset(self, shape: str, multiplier: int, group: str,
                index: int) -> dict:
        key = dataset_name(shape, multiplier, group, index)
        if key not in self.datasets:
            raise KeyError(f"no dataset {key!r}; available: "
                           f"{sorted(self.datasets)[:5]}...")
        return self.datasets[key]

    def panel(self, shape: str, multiplier: int, group: str,
              index: int) -> dict:
        """Everything one UI render needs: traffic program, per-component
        scale factors (the bar charts) and utilization series (the line
        charts), in method order groundtruth/resrc/comp/ours."""
        ds = self.dataset(shape, multiplier, group, index)
        methods = self.meta["methods"]
        components = {}
        for comp, resources in ds["components"].items():
            rec = {}
            for resource, r in resources.items():
                rec[resource] = {
                    "scale": [r["scale"].get(m, 0.0) for m in methods],
                    "series": {m: r[m] for m in methods if m in r},
                    "band": {"lo": r["ours_lo"], "hi": r["ours_hi"]},
                    "observed": r["observed"],
                }
            components[comp] = rec
        return {
            "key": dataset_name(shape, multiplier, group, index),
            "composition": ds["composition"],
            "calls": ds["calls"],
            "methods": methods,
            "components": components,
        }
