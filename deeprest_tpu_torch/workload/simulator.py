"""Corpus simulation: scenario → raw-data buckets (and a CLI).

Two-phase so every bucket carries the identical metric-key set the
featurizer requires: (1) generate every bucket's span trees from the
scenario's traffic program, discovering the full component set; (2) run the
stateful resource model over the trace timeline.

CLI:
    python -m deeprest_tpu_torch.workload.simulator \
        --scenario normal --buckets 480 --seed 0 --out corpus.jsonl \
        [--anomaly cryptojacking:media-mongodb:300:360]
"""

from __future__ import annotations

import argparse

import numpy as np

from deeprest_tpu_torch.data.schema import Bucket, save_raw_data_jsonl, save_raw_data_pickle
from deeprest_tpu_torch.workload.scenarios import SCENARIOS, LoadScenario
from deeprest_tpu_torch.workload.telemetry import Anomaly, ResourceModel, count_ops
from deeprest_tpu_torch.workload.topology import API_ENDPOINTS, AppParams, SocialNetworkApp


def simulate_corpus(
    scenario: LoadScenario,
    num_buckets: int,
    app_params: AppParams | None = None,
    anomalies: list[Anomaly] | None = None,
    resource_seed: int | None = None,
    app=None,
    endpoints: tuple[str, ...] | None = None,
) -> list[Bucket]:
    """Deterministic: same scenario/seeds → identical corpus.

    ``app``/``endpoints`` default to the social-network topology; pass any
    object with ``generate(endpoint, rng) -> list[Span]`` (e.g.
    :class:`microtopo.SyntheticMicroserviceApp`) plus its endpoint tuple to
    simulate a different application.  The scenario's traffic matrix must be
    as wide as ``endpoints`` (use ``LoadScenario.generic_endpoints``).
    """
    if endpoints is None:
        if app is None:
            endpoints = API_ENDPOINTS
        else:
            # A custom app must declare its surface — defaulting it to the
            # social-network endpoint list could pass the width check by
            # coincidence and fail deep in the bucket loop.
            try:
                endpoints = tuple(app.endpoints)
            except AttributeError:
                raise TypeError(
                    "custom app has no .endpoints attribute; pass "
                    "endpoints= explicitly") from None
    if app is None:
        app = SocialNetworkApp(app_params)
    trace_rng = np.random.default_rng(scenario.seed + 3)
    traffic = scenario.traffic(num_buckets)          # [T, num_endpoints]
    if traffic.shape[1] != len(endpoints):
        raise ValueError(
            f"scenario emits {traffic.shape[1]}-endpoint traffic but the app "
            f"has {len(endpoints)} endpoints — set scenario.generic_endpoints")

    # Phase 1: generate traces, counting ops in the same walk (count_ops is
    # the only tree traversal; trees are not re-walked in phase 2).
    per_bucket_traces: list[list] = []
    per_bucket_counts: list[tuple[dict, dict]] = []
    components: set[str] = set()
    for t in range(num_buckets):
        traces = []
        for api_idx, api in enumerate(endpoints):
            for _ in range(int(traffic[t, api_idx])):
                traces.extend(app.generate(api, trace_rng))
        ops, writes = count_ops(traces)
        per_bucket_traces.append(traces)
        per_bucket_counts.append((ops, writes))
        components.update(ops)
    # An app that declares its full graph (synthetic topologies) gets metric
    # keys for every deployed component, invoked or idle — like a real
    # scrape — and keeps the keyset identical to simulate_corpus_iter's.
    components.update(getattr(app, "components", ()))

    # Phase 2: stateful telemetry over the full component set.
    model = ResourceModel(
        seed=scenario.seed if resource_seed is None else resource_seed,
        anomalies=anomalies,
    )
    ordered = sorted(components)
    return [
        Bucket(metrics=model.step_counts(ops, writes, components=ordered),
               traces=traces)
        for traces, (ops, writes) in zip(per_bucket_traces, per_bucket_counts)
    ]


def simulate_corpus_iter(
    scenario: LoadScenario,
    num_buckets: int,
    app_params: AppParams | None = None,
    anomalies: list[Anomaly] | None = None,
    resource_seed: int | None = None,
    app=None,
    endpoints: tuple[str, ...] | None = None,
    components: tuple[str, ...] | None = None,
    discovery_buckets: int = 120,
):
    """Constant-memory variant of :func:`simulate_corpus`: yields buckets
    one at a time, so month-scale corpora stream straight to JSONL without
    ever holding tens of millions of span objects.

    The fixed metric keyset every bucket must carry comes from (in order):
    ``components``, the app's declared ``components`` attribute (synthetic
    topologies know their full graph), or a discovery pre-pass of
    ``discovery_buckets`` buckets re-generated deterministically — the
    series prefix plus a stride/peak-traffic sample across the whole run,
    so a branch that only fires under late peak load is still likely in
    the keyset.  Discovery is sampling, not proof: pass ``components``
    explicitly for apps with very rare branches (the generator fail-fasts
    on any component outside the keyset rather than poisoning the corpus).
    Two sampling caveats, accepted deliberately: tier-2 buckets are
    re-generated with per-bucket rngs whose draws differ from the real
    pass, so (rarely) a discovered component may never occur in the actual
    corpus — its metric key is then present but always idle — and the
    bit-identity with :func:`simulate_corpus` noted below is therefore
    guaranteed only when the component set comes from ``components=`` or
    the app, not from discovery on a series longer than the prefix.

    Identical RNG draw order to :func:`simulate_corpus`, so for an equal
    component set the streamed corpus is bit-identical to the in-memory
    one.
    """
    # Plain function (not a generator): every argument error surfaces HERE,
    # before any caller opens/truncates an output file on the iterator's
    # behalf.
    if endpoints is None:
        if app is None:
            endpoints = API_ENDPOINTS
        else:
            try:
                endpoints = tuple(app.endpoints)
            except AttributeError:
                raise TypeError(
                    "custom app has no .endpoints attribute; pass "
                    "endpoints= explicitly") from None
    if app is None:
        app = SocialNetworkApp(app_params)
    traffic = scenario.traffic(num_buckets)
    if traffic.shape[1] != len(endpoints):
        raise ValueError(
            f"scenario emits {traffic.shape[1]}-endpoint traffic but the app "
            f"has {len(endpoints)} endpoints — set scenario.generic_endpoints")

    if components is None:
        components = getattr(app, "components", None)
    if components is None:
        # Discovery pre-pass, two tiers sharing the budget:
        #   1. the series PREFIX, regenerated with the same sequential rng
        #      the real pass uses (same seed → bit-identical traces), so
        #      everything in those buckets is in the keyset by construction;
        #   2. buckets SAMPLED ACROSS the whole series — an even stride plus
        #      the highest-traffic buckets — each with a per-bucket rng.
        # Tier 2 exists because a rare branch can first fire deep into a
        # month-scale run (e.g. only under peak traffic); a prefix-only
        # pre-pass would then fail-fast in _corpus_gen hours in, after the
        # caller has already streamed a large partial JSONL.  Peak buckets
        # see the most traces, so they are the best places to observe rare
        # branches.
        # The full budget still goes to the prefix (so every run that was
        # safe before stays safe by construction); tier 2 ADDS up to
        # budget//2 sampled buckets on top.
        prefix_n = min(num_buckets, discovery_buckets)
        scratch_rng = np.random.default_rng(scenario.seed + 3)
        seen: set[str] = set()

        def observe(t: int, rng) -> None:
            traces = []
            for api_idx, api in enumerate(endpoints):
                for _ in range(int(traffic[t, api_idx])):
                    traces.extend(app.generate(api, rng))
            ops, _ = count_ops(traces)
            seen.update(ops)

        for t in range(prefix_n):
            observe(t, scratch_rng)
        rest = discovery_buckets // 2 if num_buckets > prefix_n else 0
        if rest > 0:
            stride = np.linspace(prefix_n, num_buckets - 1,
                                 num=rest // 2, dtype=np.int64)
            # Peak candidates come from BEYOND the prefix (an early-peaking
            # series must not consume the peak budget on buckets the prefix
            # already covered).
            tail_traffic = traffic[prefix_n:].sum(axis=1)
            peak = prefix_n + np.argsort(tail_traffic)[::-1][:rest - len(stride)]
            for t in sorted(set(stride.tolist()) | set(peak.tolist())):
                observe(int(t), np.random.default_rng((scenario.seed + 3, int(t))))
        components = tuple(seen)
    return _corpus_gen(scenario, num_buckets, anomalies, resource_seed, app,
                       endpoints, traffic, sorted(components))


def _corpus_gen(scenario, num_buckets, anomalies, resource_seed, app,
                endpoints, traffic, ordered):
    comp_set = set(ordered)
    trace_rng = np.random.default_rng(scenario.seed + 3)
    model = ResourceModel(
        seed=scenario.seed if resource_seed is None else resource_seed,
        anomalies=anomalies,
    )
    for t in range(num_buckets):
        traces = []
        for api_idx, api in enumerate(endpoints):
            for _ in range(int(traffic[t, api_idx])):
                traces.extend(app.generate(api, trace_rng))
        ops, writes = count_ops(traces)
        # Fail FAST on a component outside the fixed keyset (first seen
        # after the discovery window): emitting it would make this bucket's
        # metric keys diverge and poison the whole corpus for featurization.
        unknown = set(ops) - comp_set
        if unknown:
            raise ValueError(
                f"bucket {t}: components {sorted(unknown)} first appear "
                f"after the discovery window — pass components= explicitly "
                "or raise discovery_buckets")
        yield Bucket(metrics=model.step_counts(ops, writes, components=ordered),
                     traces=traces)


def build_synthetic_app(scenario: LoadScenario, num_services: int,
                        num_endpoints: int, seed: int):
    """Construct the synthetic topology for a CLI run and point the
    scenario's composition at its endpoint surface.  Shared by the two
    simulate CLIs (this module's main and deeprest_tpu_torch.cli simulate)."""
    from deeprest_tpu_torch.workload.microtopo import (
        SyntheticMicroserviceApp, TopologyParams,
    )

    app = SyntheticMicroserviceApp(TopologyParams(
        num_services=num_services, num_endpoints=num_endpoints, seed=seed))
    scenario.generic_endpoints = len(app.endpoints)
    return app, app.endpoints


def build_shifted_app(scenario: LoadScenario, num_services: int,
                      num_services_after: int, num_endpoints: int,
                      seed: int):
    """The mid-corpus topology-change pair (ROADMAP item 6's scenario
    library): the BEFORE and AFTER synthetic topologies of a rolling
    deployment that adds/removes services.

    Both apps share the seed and the endpoint surface (names are
    ``/api/epNN``, so the scenario's traffic matrix stays valid across
    the shift), but a different ``num_services`` re-draws the layered
    DAG — services appear, vanish, and rewire, which is exactly the
    call-path composition shift the drift monitors must flag (new hash
    columns gain mass, old ones go dark)."""
    from deeprest_tpu_torch.workload.microtopo import (
        SyntheticMicroserviceApp, TopologyParams,
    )

    before = SyntheticMicroserviceApp(TopologyParams(
        num_services=num_services, num_endpoints=num_endpoints, seed=seed))
    after = SyntheticMicroserviceApp(TopologyParams(
        num_services=num_services_after, num_endpoints=num_endpoints,
        seed=seed))
    scenario.generic_endpoints = len(before.endpoints)
    return before, after, before.endpoints


def simulate_drift_corpus_iter(
    scenario: LoadScenario,
    num_buckets: int,
    shift_at: int,
    app_before,
    app_after,
    endpoints: tuple[str, ...],
    anomalies: list[Anomaly] | None = None,
    resource_seed: int | None = None,
):
    """Constant-memory corpus with a MID-CORPUS topology change: buckets
    before ``shift_at`` generate traces from ``app_before``, buckets at
    and after it from ``app_after`` (the rolling-deployment scenario the
    synthetic ``--services`` generator owed ROADMAP item 6).

    The fixed metric keyset is the UNION of both topologies' declared
    component sets, so every bucket carries identical keys — removed
    services go idle (their resource series fall to base load), added
    services come alive at the shift, exactly like a real scrape across
    a deployment.  Combine with an ``Anomaly`` whose window starts after
    ``shift_at`` for the ransomware-mid-drift scenario (the anomaly
    component must exist in ``app_after``)."""
    if not (0 < shift_at <= num_buckets):
        raise ValueError(
            f"shift_at {shift_at} must be in (0, num_buckets"
            f"={num_buckets}]")
    for app in (app_before, app_after):
        if not getattr(app, "components", ()):
            raise TypeError(
                "drift corpora need apps that declare .components "
                "(synthetic topologies do) — the union keyset cannot be "
                "discovered from a prefix that predates the shift")
    traffic = scenario.traffic(num_buckets)
    if traffic.shape[1] != len(endpoints):
        raise ValueError(
            f"scenario emits {traffic.shape[1]}-endpoint traffic but the "
            f"app has {len(endpoints)} endpoints — set "
            "scenario.generic_endpoints")
    ordered = sorted(set(app_before.components) | set(app_after.components))
    comp_set = set(ordered)
    trace_rng = np.random.default_rng(scenario.seed + 3)
    model = ResourceModel(
        seed=scenario.seed if resource_seed is None else resource_seed,
        anomalies=anomalies,
    )
    for t in range(num_buckets):
        app = app_before if t < shift_at else app_after
        traces = []
        for api_idx, api in enumerate(endpoints):
            for _ in range(int(traffic[t, api_idx])):
                traces.extend(app.generate(api, trace_rng))
        ops, writes = count_ops(traces)
        unknown = set(ops) - comp_set
        if unknown:
            raise ValueError(
                f"bucket {t}: components {sorted(unknown)} outside the "
                "declared union keyset — both apps must declare "
                ".components")
        yield Bucket(
            metrics=model.step_counts(ops, writes, components=ordered),
            traces=traces)


def write_corpus_jsonl(scenario: LoadScenario, num_buckets: int,
                       out_path: str, app=None, endpoints=None,
                       anomalies=None) -> dict:
    """Stream a corpus to JSONL at constant memory; returns counts."""
    stats = {"buckets": 0, "traces": 0, "metric_keys": 0}
    it = simulate_corpus_iter(scenario, num_buckets, anomalies=anomalies,
                              app=app, endpoints=endpoints)

    def counted():
        for b in it:
            stats["buckets"] += 1
            stats["traces"] += len(b.traces)
            stats["metric_keys"] = len(b.metrics)
            yield b

    save_raw_data_jsonl(counted(), out_path)
    return stats


def parse_anomaly(spec: str) -> Anomaly:
    """``kind:component:start:end[:magnitude]``"""
    parts = spec.split(":")
    if len(parts) not in (4, 5):
        raise argparse.ArgumentTypeError(
            f"anomaly spec {spec!r} != kind:component:start:end[:magnitude]"
        )
    return Anomaly(
        kind=parts[0], component=parts[1], start=int(parts[2]), end=int(parts[3]),
        magnitude=float(parts[4]) if len(parts) == 5 else 1.0,
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="normal")
    ap.add_argument("--buckets", type=int, default=480,
                    help="number of time buckets (a 'day' is 60)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="output path (.jsonl or .pkl by extension)")
    ap.add_argument("--anomaly", type=parse_anomaly, action="append", default=[],
                    help="kind:component:start:end[:magnitude], repeatable")
    ap.add_argument("--calls-per-user", type=float, default=2.0)
    ap.add_argument("--app", choices=("social", "synthetic"), default="social",
                    help="application topology: the 12-service social network "
                         "or a seeded synthetic DAG (TrainTicket scale)")
    ap.add_argument("--services", type=int, default=40,
                    help="synthetic app: number of services")
    ap.add_argument("--endpoints", type=int, default=12,
                    help="synthetic app: number of API endpoints")
    ap.add_argument("--shift-at", type=int, default=0,
                    help="mid-corpus topology change: buckets at/after "
                         "this index generate from a re-drawn synthetic "
                         "topology with --services-after services "
                         "(0 = no shift; synthetic app only)")
    ap.add_argument("--services-after", type=int, default=None,
                    help="service count of the post-shift topology "
                         "(default: --services + 50%%)")
    args = ap.parse_args(argv)

    scenario = SCENARIOS[args.scenario](args.seed)
    scenario.calls_per_user = args.calls_per_user
    app = endpoints = None
    if args.shift_at:
        if args.app != "synthetic":
            ap.error("--shift-at needs --app synthetic (the social "
                     "topology is fixed)")
        after_n = (args.services_after if args.services_after is not None
                   else args.services + max(args.services // 2, 1))
        before, after, endpoints = build_shifted_app(
            scenario, args.services, after_n, args.endpoints, args.seed)
        it = simulate_drift_corpus_iter(
            scenario, args.buckets, args.shift_at, before, after,
            endpoints, anomalies=args.anomaly)
        if args.out.endswith(".pkl"):
            buckets = list(it)
            save_raw_data_pickle(buckets, args.out)
            stats = {"buckets": len(buckets),
                     "traces": sum(len(b.traces) for b in buckets),
                     "metric_keys": len(buckets[0].metrics)}
        else:
            from deeprest_tpu_torch.data.schema import save_raw_data_jsonl

            stats = {"buckets": 0, "traces": 0, "metric_keys": 0}

            def counted():
                for b in it:
                    stats["buckets"] += 1
                    stats["traces"] += len(b.traces)
                    stats["metric_keys"] = len(b.metrics)
                    yield b

            save_raw_data_jsonl(counted(), args.out)
        print(f"wrote {stats['buckets']} buckets ({args.services}->"
              f"{after_n} services at bucket {args.shift_at}), "
              f"{stats['traces']} traces, {stats['metric_keys']} metric "
              f"keys -> {args.out}")
        return
    if args.app == "synthetic":
        app, endpoints = build_synthetic_app(scenario, args.services,
                                             args.endpoints, args.seed)
    if args.out.endswith(".pkl"):
        buckets = simulate_corpus(scenario, args.buckets,
                                  anomalies=args.anomaly,
                                  app=app, endpoints=endpoints)
        save_raw_data_pickle(buckets, args.out)
        stats = {"buckets": len(buckets),
                 "traces": sum(len(b.traces) for b in buckets),
                 "metric_keys": len(buckets[0].metrics)}
    else:
        # JSONL streams bucket-by-bucket: month-scale corpora never hold
        # more than one bucket of span objects in memory.
        stats = write_corpus_jsonl(scenario, args.buckets, args.out,
                                   app=app, endpoints=endpoints,
                                   anomalies=args.anomaly)
    print(f"wrote {stats['buckets']} buckets, {stats['traces']} traces, "
          f"{stats['metric_keys']} metric keys -> {args.out}")


if __name__ == "__main__":
    main()
