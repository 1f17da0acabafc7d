"""The capability harness: a scenario-driven workload + telemetry simulator
(``deeprest_tpu/workload/``, copied module for module; numpy only, so the
same seeds give the same corpus as the JAX package's, bucket for bucket).

The reference obtains training corpora by deploying a 12-service social
network on Kubernetes, driving it with locust, and scraping Jaeger +
Prometheus (reference: social-network/, locust/, minikube-openebs/ —
SURVEY.md L0-L3).  None of that infrastructure can exist inside a training
job, but the *capability* it provides — realistic span trees and
traffic-correlated per-component resource series, under controllable load
scenarios including anomalies — is reproduced here as a deterministic,
seedable simulator emitting the exact raw-data contract the data plane
consumes.  Long corpora stream bucket-by-bucket to JSONL
(:func:`simulator.simulate_corpus_iter`, constant memory).
"""

from deeprest_tpu_torch.workload.topology import SocialNetworkApp, API_ENDPOINTS
from deeprest_tpu_torch.workload.scenarios import (
    LoadScenario,
    normal_scenario,
    shape_scenario,
    scale_scenario,
    composition_scenario,
    crypto_scenario,
    SCENARIOS,
)
from deeprest_tpu_torch.workload.telemetry import ResourceModel, Anomaly
from deeprest_tpu_torch.workload.simulator import simulate_corpus
from deeprest_tpu_torch.workload.microtopo import (
    SyntheticMicroserviceApp,
    TopologyParams,
)

__all__ = [
    "SocialNetworkApp",
    "API_ENDPOINTS",
    "SyntheticMicroserviceApp",
    "TopologyParams",
    "LoadScenario",
    "normal_scenario",
    "shape_scenario",
    "scale_scenario",
    "composition_scenario",
    "crypto_scenario",
    "SCENARIOS",
    "ResourceModel",
    "Anomaly",
    "simulate_corpus",
]
