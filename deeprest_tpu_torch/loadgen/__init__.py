"""L3 — the load-generation plane (reference: locust/ — SURVEY.md §2.3;
``deeprest_tpu/loadgen/``, copied module for module: host-only, stdlib and
numpy, no torch).

Drives the *real* native application (native/sns/snsd) over HTTP the way the
reference drives its social network with locust: a synthetic social graph is
registered and followed (warmup), then open-loop simulated users execute the
scenario's per-cycle API composition under the scenario's user curve, with
think times. The crypto scenario pairs with :mod:`burner` — a double-SHA-256
proof-of-work CPU burner whose usage the trace collector attributes to a
victim component, reproducing the reference's cryptojack injection
(locust/pow.py into a pod).

The five load envelopes (normal/shape/scale/composition/crypto) are shared
with the offline simulator — :mod:`deeprest_tpu_torch.workload.scenarios` is the
single source of truth for user curves and API mixes.
"""

from deeprest_tpu_torch.loadgen.graph import SocialGraph, synthetic_social_graph
from deeprest_tpu_torch.loadgen.cluster import SnsCluster, snsd_available, snsd_path
from deeprest_tpu_torch.loadgen.client import GatewayClient, register_with_collector
from deeprest_tpu_torch.loadgen.warmup import warmup
from deeprest_tpu_torch.loadgen.runner import LoadRunner, RunnerConfig
from deeprest_tpu_torch.loadgen.burner import proof_of_work, Burner

__all__ = [
    "SocialGraph",
    "synthetic_social_graph",
    "SnsCluster",
    "snsd_available",
    "snsd_path",
    "GatewayClient",
    "register_with_collector",
    "warmup",
    "LoadRunner",
    "RunnerConfig",
    "proof_of_work",
    "Burner",
]
