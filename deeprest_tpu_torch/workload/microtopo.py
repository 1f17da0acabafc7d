"""Synthetic microservice topologies at TrainTicket scale (40+ services).

The social-network app (:mod:`topology`) mirrors the reference's fixed
12-service DeathStarBench deployment.  BASELINE.json configs[2] names a
second application class — "TrainTicket (40+ services) 7-day trace" — whose
defining property is *topology scale*: an order of magnitude more services,
deeper call chains, and many more distinct call paths, with no hand-written
per-service logic to copy.  This module generates such applications
synthetically:

- A seeded, layered service DAG: gateways → service layers → stores.  The
  graph is deterministic in ``TopologyParams`` (same seed → identical
  topology → identical call-path feature space across runs/processes).
- Per-endpoint span-tree generation with per-trace randomness (optional
  downstream calls, cache hit/miss branches) so the trace synthesizer has
  real per-endpoint distributions to learn, exactly like the hand-written
  app.
- Store components carry the ``-mongodb``/``-redis``/``-memcached``
  suffixes the telemetry plane keys on (telemetry.is_stateful), so write
  IOps/throughput/usage series appear for the stateful tier.

The emitted traces flow through the same contract as every other corpus:
``simulate_corpus(..., app=SyntheticMicroserviceApp(params),
endpoints=app.endpoints)`` → featurize → train.  Nothing downstream knows
which application generated the data — that is the point: the estimator is
app-agnostic, as in the reference (its featurizer never hardcodes the app,
reference: resource-estimation/featurize.py:11-24).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprest_tpu_torch.data.schema import Span


@dataclasses.dataclass(frozen=True)
class TopologyParams:
    """Shape of the generated service graph."""

    num_services: int = 40
    num_endpoints: int = 12
    num_gateways: int = 2
    depth: int = 4                  # service layers between gateway and stores
    max_fanout: int = 3             # downstream service calls per service
    store_fraction: float = 0.45    # services owning a backing store
    cache_fraction: float = 0.35    # stateful services fronted by a cache
    write_fraction: float = 0.35    # endpoints that mutate state
    p_optional_call: float = 0.35   # per-trace probability of optional edges
    p_cache_miss: float = 0.30
    seed: int = 0

    def __post_init__(self):
        if self.num_services < self.depth:
            raise ValueError("need at least one service per layer")
        if self.num_gateways < 1 or self.num_endpoints < 1:
            raise ValueError("need >= 1 gateway and endpoint")


@dataclasses.dataclass(frozen=True)
class _ServiceSpec:
    name: str
    layer: int
    children: tuple[int, ...]       # indices of downstream services
    optional: tuple[bool, ...]      # per-child: optional (per-trace coin)?
    store: str | None               # backing store component, if stateful
    cache: str | None               # look-aside cache component, if cached


class SyntheticMicroserviceApp:
    """Generates one span tree per API call over a seeded layered DAG.

    Drop-in peer of :class:`topology.SocialNetworkApp`: ``generate(endpoint,
    rng)`` returns the span trees of one API invocation; ``endpoints`` lists
    the API surface in a stable order.
    """

    def __init__(self, params: TopologyParams | None = None):
        self.params = p = params or TopologyParams()
        rng = np.random.default_rng(p.seed)

        # Layer assignment: round-robin keeps layers balanced regardless of
        # num_services; layer 0 is called by gateways, deeper layers by
        # shallower ones.
        layers: list[list[int]] = [[] for _ in range(p.depth)]
        for i in range(p.num_services):
            layers[i % p.depth].append(i)

        specs: list[_ServiceSpec] = []
        for i in range(p.num_services):
            layer = i % p.depth
            name = f"svc-{i:03d}"
            if layer + 1 < p.depth and layers[layer + 1]:
                pool = layers[layer + 1]
                k = int(rng.integers(1, p.max_fanout + 1))
                kids = tuple(
                    int(c) for c in rng.choice(pool, size=min(k, len(pool)),
                                               replace=False))
            else:
                kids = ()
            optional = tuple(bool(rng.random() < 0.5) for _ in kids)
            store = cache = None
            if rng.random() < p.store_fraction:
                store = f"{name}-{'mongodb' if rng.random() < 0.7 else 'redis'}"
                if rng.random() < p.cache_fraction:
                    cache = f"{name}-memcached"
            specs.append(_ServiceSpec(name=name, layer=layer, children=kids,
                                      optional=optional, store=store,
                                      cache=cache))
        self._services = specs

        # Endpoints: each rooted at a gateway, entering 1..max_fanout
        # layer-0 services; a write_fraction of endpoints mutate state.
        eps: list[tuple[str, str, tuple[int, ...], bool]] = []
        for j in range(p.num_endpoints):
            gateway = f"gateway-{j % p.num_gateways}"
            k = int(rng.integers(1, p.max_fanout + 1))
            entry = tuple(int(c) for c in rng.choice(
                layers[0], size=min(k, len(layers[0])), replace=False))
            is_write = rng.random() < p.write_fraction
            eps.append((f"/api/ep{j:02d}", gateway, entry, is_write))
        self._endpoints = eps

    # -- public surface -------------------------------------------------

    @property
    def endpoints(self) -> tuple[str, ...]:
        return tuple(name for name, *_ in self._endpoints)

    @property
    def components(self) -> tuple[str, ...]:
        """Every component the topology can emit (stable order)."""
        out: list[str] = sorted({gw for _, gw, _, _ in self._endpoints})
        for s in self._services:
            out.append(s.name)
            if s.cache:
                out.append(s.cache)
            if s.store:
                out.append(s.store)
        return tuple(out)

    def generate(self, endpoint: str, rng: np.random.Generator) -> list[Span]:
        for name, gateway, entry, is_write in self._endpoints:
            if name == endpoint:
                children = [self._expand(self._services[i], is_write, rng)
                            for i in entry]
                return [Span(component=gateway, operation=endpoint,
                             children=children)]
        raise KeyError(f"unknown endpoint {endpoint!r}")

    # -- internals ------------------------------------------------------

    def _expand(self, spec: _ServiceSpec, is_write: bool,
                rng: np.random.Generator) -> Span:
        p = self.params
        children: list[Span] = []
        if spec.store is not None:
            if is_write:
                children.append(Span(spec.store, "/insert"))
            elif spec.cache is not None:
                children.append(Span(spec.cache, "/mget"))
                if rng.random() < p.p_cache_miss:
                    children.append(Span(spec.store, "/find"))
                    children.append(Span(spec.cache, "/set"))
            else:
                children.append(Span(spec.store, "/find"))
        for idx, optional in zip(spec.children, spec.optional):
            if optional and rng.random() >= p.p_optional_call:
                continue
            children.append(self._expand(self._services[idx], is_write, rng))
        op = "/write" if is_write else "/read"
        return Span(component=spec.name, operation=op, children=children)
