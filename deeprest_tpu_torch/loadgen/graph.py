"""Synthetic social graph for warmup and user simulation
(``deeprest_tpu/loadgen/graph.py``: the same edges for the same seed).

The reference bootstraps its user population from the Facebook Reed College
graph (``socfb-Reed98.mtx``: 962 users — reference: locust/warmup.py,
locustfile-normal.py:29-44). Shipping that dataset is neither possible nor
the point; what the workload needs is a scale-free follower graph of the
same character, so we generate one deterministically by preferential
attachment (Barabási–Albert).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SocialGraph:
    """User ids are 1-based (the app treats 0 as "missing")."""

    num_users: int
    edges: tuple[tuple[int, int], ...]   # (follower, followee), both directions listed

    def friends(self, user_id: int) -> list[int]:
        """Users this user follows (mention / read-timeline candidates)."""
        return self._adjacency().get(user_id, [])

    def username(self, user_id: int) -> str:
        return f"user{user_id}"

    def password(self, user_id: int) -> str:
        return f"pw{user_id}"

    def _adjacency(self) -> dict[int, list[int]]:
        adj = getattr(self, "_adj", None)
        if adj is None:
            adj = {}
            for follower, followee in self.edges:
                adj.setdefault(follower, []).append(followee)
            object.__setattr__(self, "_adj", adj)
        return adj


def synthetic_social_graph(num_users: int = 96, attach: int = 3,
                           seed: int = 0) -> SocialGraph:
    """Preferential-attachment graph; follow edges are made bidirectional at
    warmup exactly as the reference does (warmup.py:69-84 follows both
    directions per .mtx edge)."""
    if num_users < 2:
        raise ValueError("need at least 2 users")
    attach = max(1, min(attach, num_users - 1))
    rng = np.random.default_rng(seed)
    targets = list(range(1, attach + 1))       # seed clique
    repeated: list[int] = list(targets)
    undirected: set[tuple[int, int]] = set()
    for new in range(attach + 1, num_users + 1):
        chosen: set[int] = set()
        while len(chosen) < min(attach, len(set(repeated))):
            chosen.add(int(repeated[rng.integers(0, len(repeated))]))
        for t in chosen:
            undirected.add((min(new, t), max(new, t)))
            repeated.extend((new, t))
    for i in range(1, attach + 1):             # connect the seed clique
        for j in range(i + 1, attach + 1):
            undirected.add((i, j))
    edges: list[tuple[int, int]] = []
    for a, b in sorted(undirected):
        edges.append((a, b))
        edges.append((b, a))
    return SocialGraph(num_users=num_users, edges=tuple(edges))
