"""Boot and supervise a native snsd cluster (process-per-role;
``deeprest_tpu/loadgen/cluster.py``: the same components, ports and
cgroup names).  It builds nothing: ``snsd`` comes from ``make -C
native/sns`` or ``DEEPREST_SNSD``.  Every role but the collector places
itself into a cpuacct cgroup when the cgroupfs is writable
(``native/sns/main.cpp``), so boot a cluster only on a host where that is
allowed.

The reference's equivalent is the Kubernetes deployment: 31 Service +
Deployment YAMLs, one pod per microservice/datastore (reference:
social-network/social-network-deploy/k8s-yaml/ — SURVEY.md §2.2). Here the
same component set runs as local processes of the one ``snsd`` binary, with
the trace collector in the Jaeger+Prometheus role writing the raw-data JSONL
contract.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import time

STORES = (
    "compose-post-redis", "user-timeline-redis", "home-timeline-redis",
    "social-graph-redis", "user-mongodb", "post-storage-mongodb",
    "user-timeline-mongodb", "social-graph-mongodb", "url-shorten-mongodb",
    "media-mongodb", "user-memcached", "post-storage-memcached", "rabbitmq",
)
SERVICES = (
    "compose-post-service", "unique-id-service", "text-service",
    "url-shorten-service", "user-mention-service", "media-service",
    "user-service", "social-graph-service", "post-storage-service",
    "user-timeline-service", "home-timeline-service",
)
GATEWAYS = ("nginx-thrift", "media-frontend")
CONSUMER = "write-home-timeline-service"
COLLECTOR = "trace-collector"


def _is_durable_store(component: str) -> bool:
    """kv (redis-role) and doc (mongodb-role) stores persist; caches and the
    queue are RAM-only by fidelity to their reference counterparts."""
    return component.endswith("-redis") or component.endswith("-mongodb")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def snsd_path() -> str:
    return os.environ.get(
        "DEEPREST_SNSD", os.path.join(_REPO_ROOT, "native", "sns", "snsd")
    )


def snsd_available() -> bool:
    return os.access(snsd_path(), os.X_OK)


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            socks.append(s)        # owned by the finally from birth
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


class SnsCluster:
    """Context manager owning one process per component.

    >>> with SnsCluster(out_path="raw.jsonl", interval_ms=1000) as cluster:
    ...     GatewayClient(*cluster.gateway_addr) ...
    """

    def __init__(self, out_path: str, interval_ms: int = 5000,
                 grace_ms: int = 1000, verbose: bool = False,
                 data_dir: str | None = None, chaos: bool = False):
        # chaos=True arms the ChaosBurn fault-injection RPC in every
        # service (DEEPREST_CHAOS=1): a service can be told to fork an
        # unregistered cpu-burner child — the non-cooperative cryptojack
        # scenario (SURVEY.md §5.3).
        self.chaos = chaos
        # Collector /metrics + dashboard port, allocated at start()
        # (the reference's Prometheus scrape surface,
        # monitor-openebs-pg.yaml:38-173).
        self.metrics_addr: tuple[str, int] | None = None
        self.out_path = os.path.abspath(out_path)
        self.interval_ms = interval_ms
        self.grace_ms = grace_ms
        self.verbose = verbose
        # When set, kv/doc stores run durably (WAL + snapshots) under this
        # directory — the process-cluster stand-in for the reference's
        # per-store PVC mounts (user-timeline-mongodb.yaml:50-56).
        self.data_dir = os.path.abspath(data_dir) if data_dir else None
        self.components: dict[str, tuple[str, int]] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._extras: dict[str, list[str]] = {}   # per-component spawn args
        self._config_path: str | None = None

    # -- addresses ------------------------------------------------------

    @property
    def gateway_addr(self) -> tuple[str, int]:
        return self.components["nginx-thrift"]

    @property
    def media_addr(self) -> tuple[str, int]:
        return self.components["media-frontend"]

    @property
    def collector_addr(self) -> tuple[str, int]:
        return self.components[COLLECTOR]

    # -- lifecycle ------------------------------------------------------

    def start(self, timeout: float = 20.0) -> "SnsCluster":
        if not snsd_available():
            raise RuntimeError(f"snsd not built at {snsd_path()} (make -C native/sns)")
        # Sweep EMPTY leftover component cgroups from crashed/killed
        # clusters (rmdir refuses non-empty dirs, so live clusters are
        # untouched).  Without this, SIGKILLed runs would leak dirs
        # forever — there is no owner left to clean them.  Only dirs older
        # than a minute are swept: a concurrent cluster's service sits
        # briefly between mkdir and its cgroup.procs write, and sweeping
        # that window would silently strip its death-surviving CPU tier.
        base = "/sys/fs/cgroup/cpuacct/deeprest"
        try:
            now = time.time()
            for name in os.listdir(base):
                full = os.path.join(base, name)
                try:
                    if now - os.stat(full).st_mtime > 60:
                        os.rmdir(full)
                except OSError:
                    pass
        except OSError:
            pass  # no cgroupfs tier on this host
        named = list(STORES) + list(SERVICES) + list(GATEWAYS) + [COLLECTOR]
        ports = _free_ports(len(named) + 1)
        self.metrics_addr = ("127.0.0.1", ports.pop())
        self.components = {c: ("127.0.0.1", p) for c, p in zip(named, ports)}

        self._config_path = self.out_path + ".cluster.json"
        with open(self._config_path, "w", encoding="utf-8") as f:
            json.dump({"components": {
                c: {"host": h, "port": p} for c, (h, p) in self.components.items()
            }}, f, indent=2)

        try:
            # Collector first (registration target), then state, then logic.
            self._spawn(COLLECTOR, extra=[
                f"--out={self.out_path}",
                f"--interval-ms={self.interval_ms}",
                f"--grace-ms={self.grace_ms}",
                f"--metrics-port={self.metrics_addr[1]}",
            ])
            for c in STORES:
                self._spawn(c)
            for c in SERVICES:
                self._spawn(c)
            self._spawn(CONSUMER)
            for c in GATEWAYS:
                self._spawn(c)
            self._wait_ready(timeout)
        except Exception:
            self.stop()
            raise
        return self

    def _spawn(self, component: str, extra: list[str] | None = None) -> None:
        if extra is not None:
            self._extras[component] = list(extra)
        cmd = [snsd_path(), f"--service={component}", f"--config={self._config_path}"]
        cmd += self._extras.get(component, [])
        if self.data_dir and _is_durable_store(component):
            os.makedirs(self.data_dir, exist_ok=True)
            cmd.append(f"--data-dir={self.data_dir}")
        if self.verbose:
            cmd.append("--verbose")
        out = None if self.verbose else subprocess.DEVNULL
        env = None
        if self.chaos:
            env = dict(os.environ)
            env["DEEPREST_CHAOS"] = "1"
        self._procs[component] = subprocess.Popen(cmd, stdout=out, stderr=out,
                                                  env=env)

    def restart(self, component: str, timeout: float = 10.0,
                graceful: bool = False) -> None:
        """Kill one component's process and respawn it on the same port.

        ``graceful=False`` (SIGKILL) models a crash: a durable store must
        come back with its pre-crash state from WAL replay.
        """
        proc = self._procs.get(component)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM if graceful else signal.SIGKILL)
            proc.wait()
        self._spawn(component)
        host, port = self.components[component]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with socket.create_connection((host, port), timeout=0.25):
                    return
            except OSError:
                time.sleep(0.05)
        raise TimeoutError(f"{component} did not come back after restart")

    def _wait_ready(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        pending = set(self.components)
        while pending and time.monotonic() < deadline:
            for c in sorted(pending):
                proc = self._procs.get(c)
                if proc is not None and proc.poll() is not None:
                    raise RuntimeError(f"{c} exited with {proc.returncode} during boot")
                host, port = self.components[c]
                try:
                    with socket.create_connection((host, port), timeout=0.25):
                        pending.discard(c)
                except OSError:
                    pass
            if pending:
                time.sleep(0.05)
        if pending:
            raise TimeoutError(f"components never came up: {sorted(pending)}")

    def stop(self, drain_s: float = 0.0) -> None:
        """SIGTERM the app first so span sinks flush into the collector,
        then the collector so its final buckets land in the output file."""
        if drain_s:
            time.sleep(drain_s)
        app = [c for c in self._procs if c != COLLECTOR]
        for c in app:
            self._terminate(c)
        for c in app:
            self._reap(c)
        if COLLECTOR in self._procs:
            self._terminate(COLLECTOR)
            self._reap(COLLECTOR)
        self._procs.clear()
        self._remove_cgroups()

    def cgroup_dir(self, component: str) -> str:
        """This cluster's cpuacct cgroup directory for ``component`` —
        the same FNV-1a64(config_path) naming native/sns/common.cpp
        ComponentCgroupDir uses (the single Python mirror of that
        scheme; _remove_cgroups and tests both go through here)."""
        assert self._config_path, "cluster not started"
        h = 0xCBF29CE484222325
        for b in self._config_path.encode():
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return f"/sys/fs/cgroup/cpuacct/deeprest/{h:016x}_{component}"

    def _remove_cgroups(self) -> None:
        """Best-effort rmdir of this cluster's per-component cpuacct
        cgroups (services self-placed into them at startup; a cgroup dir
        is only removable once empty, i.e. after every member exited)."""
        if not self._config_path:
            return
        base, prefix = os.path.split(self.cgroup_dir(""))
        try:
            names = os.listdir(base)
        except OSError:
            return  # no cgroupfs tier on this host
        for name in names:
            if name.startswith(prefix):
                try:
                    os.rmdir(os.path.join(base, name))
                except OSError:
                    pass  # member still exiting; next cluster run retries

    def _terminate(self, component: str) -> None:
        proc = self._procs.get(component)
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def _reap(self, component: str, timeout: float = 8.0) -> None:
        proc = self._procs.get(component)
        if proc is None:
            return
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def __enter__(self) -> "SnsCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
