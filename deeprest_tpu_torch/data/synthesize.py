"""What-if trace synthesis: hypothetical traffic → feature vectors.

Capability parity with the reference's TraceSynthesizer (reference:
resource-estimation/synthesizer.py:10-52): learn, per API endpoint (root
span), the empirical distribution over observed *single-trace* feature
vectors; then synthesize a traffic feature vector for any requested
``{endpoint: count}`` mix — including shapes/scales/compositions never
observed — by sampling that many per-trace vectors per endpoint and summing.

Differences from the reference: vectors are keyed by compact byte signatures
instead of ``str``/``eval`` round-trips, sampling draws counts from a
multinomial instead of looping per call (O(#distinct) not O(#calls)), and
the synthesizer shares the corpus-wide :class:`CallPathSpace` so synthetic
vectors are column-compatible with training features by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprest_tpu_torch.data.featurize import CallPathSpace
from deeprest_tpu_torch.data.schema import Bucket, Span


@dataclasses.dataclass
class _EndpointDist:
    vectors: np.ndarray    # [num_distinct, capacity] observed per-trace vectors
    counts: np.ndarray     # [num_distinct] observation counts

    @property
    def probs(self) -> np.ndarray:
        return self.counts / self.counts.sum()


class TraceSynthesizer:
    """Per-endpoint empirical distribution over single-trace feature vectors."""

    def __init__(self, space: CallPathSpace):
        self.space = space
        self._dists: dict[str, _EndpointDist] = {}

    # ------------------------------------------------------------------

    def fit(self, buckets: list[Bucket]) -> "TraceSynthesizer":
        self.space.observe(buckets)
        acc: dict[str, dict[bytes, tuple[np.ndarray, int]]] = {}
        for bucket in buckets:
            for trace in bucket.traces:
                endpoint = trace.label
                vec = self.space.extract([trace])
                key = vec.tobytes()
                per_ep = acc.setdefault(endpoint, {})
                if key in per_ep:
                    per_ep[key] = (per_ep[key][0], per_ep[key][1] + 1)
                else:
                    per_ep[key] = (vec, 1)
        self._dists = {
            ep: _EndpointDist(
                vectors=np.stack([v for v, _ in entries.values()]),
                counts=np.asarray([c for _, c in entries.values()], np.float64),
            )
            for ep, entries in acc.items()
        }
        return self

    @property
    def endpoints(self) -> list[str]:
        return sorted(self._dists)

    # ------------------------------------------------------------------

    def synthesize(self, expected_api_calls: dict[str, int],
                   rng: np.random.Generator | None = None) -> np.ndarray:
        """One time step: ``{endpoint: count}`` → [capacity] feature vector."""
        rng = rng or np.random.default_rng()
        x = np.zeros((self.space.capacity,), dtype=np.float32)
        for endpoint, count in expected_api_calls.items():
            if endpoint not in self._dists:
                raise KeyError(
                    f"unknown API endpoint {endpoint!r}; observed: {self.endpoints}"
                )
            if count <= 0:
                continue
            dist = self._dists[endpoint]
            draws = rng.multinomial(count, dist.probs)     # [num_distinct]
            x += draws.astype(np.float32) @ dist.vectors
        return x

    def synthesize_series(self, traffic: list[dict[str, int]],
                          seed: int = 0) -> np.ndarray:
        """A whole hypothetical timeline: list of per-step mixes → [T, capacity]."""
        rng = np.random.default_rng(seed)
        return np.stack([self.synthesize(step, rng) for step in traffic])


def synthesize_span(trace_dict: dict) -> Span:
    """Convenience: dict literal → Span (for handwritten what-if traces)."""
    return Span.from_dict(trace_dict)
