"""Interactive what-if estimation demo (SURVEY.md §2.4;
``deeprest_tpu/demo/``, ported: ``precompute`` estimates through the
port's ``Predictor``, on the GPU unless ``--device cpu``).

Capability parity with the reference's Dash app (reference: web-demo/):
precomputed what-if estimation results over load shapes × multipliers ×
API compositions, browsed through a web UI with per-component scaling-
factor comparisons and utilization time series.  Re-designed: results are
a JSON artifact produced by `precompute` (the reference ships only an
opaque results.pkl, its generator missing), ground truth for hypothetical
mixes comes from the workload simulator's resource model (the reference
needed real cluster runs), and the server is stdlib http.server + vanilla
JS/SVG instead of a Dash/Plotly dependency.
"""

from deeprest_tpu_torch.demo.precompute import DemoConfig, precompute_results
from deeprest_tpu_torch.demo.results import ResultsStore

__all__ = ["DemoConfig", "precompute_results", "ResultsStore"]
