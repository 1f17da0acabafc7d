"""Load scenarios: user curves + API compositions per time bucket.

Reproduces the five locust scenario envelopes (reference:
locust/locustfile-{normal,shape,scale,composition,crypto}.py — SURVEY.md
§2.3): a double-Gaussian two-peaks-per-"day" user curve with fresh random
peaks each cycle and ±20% noise (normal), a flat curve at peak level
(unseen *shape*), 3× peak heights (unseen *scale*), unseen API mixes up to
65% compose (unseen *composition*), and a randomly flat-or-wavy curve paired
with an injected CPU burner (crypto).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from deeprest_tpu_torch.workload.topology import API_ENDPOINTS

# (composePost, readHomeTimeline, readUserTimeline) weights; the remaining
# mass spreads over register/follow/login (reference: locustfile-normal.py
# keeps 13 seen compositions; composition scenario uses unseen mixes).
SEEN_COMPOSITIONS: tuple[tuple[float, float, float], ...] = (
    (0.10, 0.60, 0.25), (0.15, 0.55, 0.25), (0.20, 0.50, 0.25),
    (0.10, 0.50, 0.35), (0.25, 0.45, 0.25), (0.15, 0.45, 0.35),
    (0.30, 0.40, 0.25), (0.10, 0.40, 0.45), (0.20, 0.40, 0.35),
    (0.35, 0.35, 0.25), (0.25, 0.35, 0.35), (0.15, 0.35, 0.45),
    (0.30, 0.30, 0.35),
)
UNSEEN_COMPOSITIONS: tuple[tuple[float, float, float], ...] = (
    (0.45, 0.30, 0.20), (0.50, 0.25, 0.20), (0.55, 0.25, 0.15),
    (0.60, 0.20, 0.15), (0.65, 0.15, 0.15), (0.05, 0.75, 0.15),
    (0.05, 0.15, 0.75), (0.40, 0.10, 0.45), (0.65, 0.30, 0.05),
)


@dataclasses.dataclass
class LoadScenario:
    """A reproducible traffic program: bucket index → (#calls per endpoint)."""

    name: str
    base_users: float = 100.0
    peak_range: tuple[float, float] = (140.0, 200.0)
    cycle_len: int = 60                 # buckets per "day" (1h day, 1-min buckets)
    noise: float = 0.20
    flat: bool = False                  # shape scenario: hold the peak level
    random_mode: bool = False           # crypto scenario: flat-or-wavy per cycle
    compositions: Sequence[tuple[float, float, float]] = SEEN_COMPOSITIONS
    calls_per_user: float = 2.0         # API calls per user per bucket
    seed: int = 0
    # None → the 6 social-network endpoints with the reference's seen/unseen
    # composition tables.  Set to N for a generic N-endpoint app (synthetic
    # topologies): per-cycle compositions are then Dirichlet draws, which
    # preserves the "API mix shifts every cycle" property without a
    # hand-written table per app.
    generic_endpoints: int | None = None

    def users_curve(self, num_buckets: int) -> np.ndarray:
        """Double-Gaussian two-peaks-per-cycle curve, fresh peaks each cycle
        (reference: locustfile-normal.py:53-74)."""
        rng = np.random.default_rng(self.seed)
        users = np.empty(num_buckets)
        d = self.cycle_len
        for c0 in range(0, num_buckets, d):
            p1, p2 = rng.uniform(*self.peak_range, size=2)
            m1, m2 = sorted(rng.uniform(0.1 * d, 0.9 * d, size=2))
            sigma = d / 8.0
            flat_cycle = self.flat or (self.random_mode and rng.random() < 0.5)
            for i in range(c0, min(c0 + d, num_buckets)):
                t = i - c0
                if flat_cycle:
                    level = max(p1, p2)
                else:
                    level = self.base_users + (
                        (p1 - self.base_users) * np.exp(-((t - m1) ** 2) / (2 * sigma ** 2))
                        + (p2 - self.base_users) * np.exp(-((t - m2) ** 2) / (2 * sigma ** 2))
                    )
                users[i] = max(0.0, level * (1 + rng.uniform(-self.noise, self.noise)))
        return users

    def composition_curve(self, num_buckets: int) -> np.ndarray:
        """Per-cycle composition over the endpoints → [T, n_endpoints]."""
        rng = np.random.default_rng(self.seed + 1)
        d = self.cycle_len
        if self.generic_endpoints is not None:
            n = self.generic_endpoints
            weights = np.empty((num_buckets, n))
            for c0 in range(0, num_buckets, d):
                weights[c0:c0 + d] = rng.dirichlet(np.ones(n))
            return weights[:num_buckets]
        weights = np.empty((num_buckets, len(API_ENDPOINTS)))
        for c0 in range(0, num_buckets, d):
            compose, read_home, read_user = self.compositions[
                int(rng.integers(0, len(self.compositions)))
            ]
            rest = max(0.0, 1.0 - compose - read_home - read_user)
            w = np.asarray([compose, read_home, read_user,
                            rest * 0.2, rest * 0.3, rest * 0.5])
            weights[c0:c0 + d] = w / w.sum()
        return weights[:num_buckets]

    def traffic(self, num_buckets: int) -> np.ndarray:
        """[T, 6] integer call counts per endpoint per bucket."""
        rng = np.random.default_rng(self.seed + 2)
        users = self.users_curve(num_buckets)
        comp = self.composition_curve(num_buckets)
        rates = users[:, None] * self.calls_per_user * comp
        return rng.poisson(rates).astype(np.int64)


def normal_scenario(seed: int = 0) -> LoadScenario:
    return LoadScenario(name="normal", seed=seed)


def shape_scenario(seed: int = 0) -> LoadScenario:
    return LoadScenario(name="shape", flat=True, seed=seed)


def scale_scenario(seed: int = 0) -> LoadScenario:
    return LoadScenario(name="scale", peak_range=(420.0, 600.0), seed=seed)


def composition_scenario(seed: int = 0) -> LoadScenario:
    return LoadScenario(name="composition", compositions=UNSEEN_COMPOSITIONS,
                        seed=seed)


def crypto_scenario(seed: int = 0) -> LoadScenario:
    return LoadScenario(name="crypto", random_mode=True, seed=seed)


SCENARIOS: dict[str, Callable[[int], LoadScenario]] = {
    "normal": normal_scenario,
    "shape": shape_scenario,
    "scale": scale_scenario,
    "composition": composition_scenario,
    "crypto": crypto_scenario,
}
