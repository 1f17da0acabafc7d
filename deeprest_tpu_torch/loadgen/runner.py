"""Open-loop scenario runner: simulated users driving the live gateways
(``deeprest_tpu/loadgen/runner.py``: the same per-user request sequence
for the same seed, on the port's ``workload`` scenarios).

The reference's locust layer (locustfile-*.py): a LoadShape ticks once per
time unit setting the target concurrent-user count from a double-Gaussian
two-peak curve, users re-weight their task mix per cycle, each task is an
HTTP call followed by 1-3 s of think time, media rides on 20% of composes,
mentions tag 0-5 graph friends (reference: locustfile-normal.py:14-155).

The same ``LoadScenario`` objects that parameterize the offline simulator
drive this runner, so a corpus captured from the live app and a simulated
corpus share their traffic envelope by construction.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from deeprest_tpu_torch.loadgen.client import GatewayClient
from deeprest_tpu_torch.loadgen.graph import SocialGraph
from deeprest_tpu_torch.workload.scenarios import LoadScenario
from deeprest_tpu_torch.workload.topology import API_ENDPOINTS


@dataclasses.dataclass
class RunnerConfig:
    tick_seconds: float = 1.0            # wall-clock per scenario bucket
    think_time: tuple[float, float] = (1.0, 3.0)   # reference: 1-3 s
    user_scale: float = 1.0              # scales the scenario's user curve
    max_spawn_per_tick: int = 70         # reference spawn-rate cap
    p_media: float = 0.20                # reference: 20% of composes
    p_urls: float = 0.30
    max_mentions: int = 5
    media_bytes: int = 4096
    seed: int = 0


_WORDS = ("systems", "latency", "timeline", "deploy", "trace", "bucket",
          "rollout", "cache", "quantile", "estimate", "shard", "mesh")


class _UserWorker:
    """One simulated user bound to a graph identity."""

    def __init__(self, runner: "LoadRunner", user_id: int, seed: int):
        self.runner = runner
        self.user_id = user_id
        self.rng = np.random.default_rng(seed)
        self.stop_event = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def _loop(self) -> None:
        r = self.runner
        gateway = GatewayClient(*r.gateway_addr)
        media = GatewayClient(*r.media_addr) if r.media_addr else None
        graph = r.graph
        username = graph.username(self.user_id)
        friends = graph.friends(self.user_id) or [self.user_id]
        lo, hi = r.config.think_time
        while not self.stop_event.is_set():
            weights = r.current_weights
            action = API_ENDPOINTS[
                int(self.rng.choice(len(API_ENDPOINTS), p=weights))
            ]
            try:
                if action == "compose_post":
                    self._compose(gateway, media, username, friends)
                elif action == "read_home_timeline":
                    gateway.read_home_timeline(self.user_id)
                elif action == "read_user_timeline":
                    friend = int(friends[self.rng.integers(0, len(friends))])
                    gateway.read_user_timeline(friend)
                elif action == "register":
                    new_id = r.next_user_id()
                    gateway.register(new_id, f"user{new_id}", f"pw{new_id}")
                elif action == "follow":
                    friend = int(friends[self.rng.integers(0, len(friends))])
                    gateway.follow(self.user_id, friend)
                else:  # login
                    gateway.login(username, graph.password(self.user_id))
                r.count(action)
            except Exception:
                r.count("error")
            self.stop_event.wait(float(self.rng.uniform(lo, hi)))
        gateway.close()
        if media is not None:
            media.close()

    def _compose(self, gateway: GatewayClient, media: GatewayClient | None,
                 username: str, friends: list[int]) -> None:
        cfg = self.runner.config
        words = [str(w) for w in self.rng.choice(_WORDS, size=6)]
        n_mentions = int(self.rng.integers(0, cfg.max_mentions + 1))
        for f in self.rng.choice(friends, size=min(n_mentions, len(friends)),
                                 replace=False):
            words.append(f"@user{int(f)}")
        if self.rng.random() < cfg.p_urls:
            words.append(f"https://ex.ample/p{int(self.rng.integers(1e6))}")
        media_id = None
        if media is not None and self.rng.random() < cfg.p_media:
            payload = self.rng.bytes(cfg.media_bytes)
            media_id = media.upload_media(payload)["media_id"]
        gateway.compose(self.user_id, username, " ".join(words),
                        media_id=media_id)


class LoadRunner:
    def __init__(self, gateway_addr: tuple[str, int], graph: SocialGraph,
                 scenario: LoadScenario, config: RunnerConfig | None = None,
                 media_addr: tuple[str, int] | None = None):
        self.gateway_addr = gateway_addr
        self.media_addr = media_addr
        self.graph = graph
        self.scenario = scenario
        self.config = config or RunnerConfig()
        self.current_weights = np.full(len(API_ENDPOINTS),
                                       1.0 / len(API_ENDPOINTS))
        self._counts: dict[str, int] = {}
        self._count_lock = threading.Lock()
        self._next_user = graph.num_users + 1
        self._workers: list[_UserWorker] = []
        self._stopped: list[_UserWorker] = []
        self._checkout: list[int] = []

    # -- shared state used by workers ----------------------------------

    def count(self, key: str) -> None:
        with self._count_lock:
            self._counts[key] = self._counts.get(key, 0) + 1

    def next_user_id(self) -> int:
        with self._count_lock:
            uid = self._next_user
            self._next_user += 1
            return uid

    # -- control loop ---------------------------------------------------

    def run(self, num_ticks: int) -> dict:
        """Drive ``num_ticks`` scenario buckets; blocks for
        ``num_ticks * tick_seconds`` wall-clock, then winds all users down."""
        cfg = self.config
        users_curve = self.scenario.users_curve(num_ticks) * cfg.user_scale
        comp_curve = self.scenario.composition_curve(num_ticks)
        rng = np.random.default_rng(cfg.seed)
        # user-id checkout from the graph population (reference:
        # locustfile-normal.py:29-44,148-155)
        self._checkout = list(rng.permutation(np.arange(1, self.graph.num_users + 1)))
        peak = 0
        try:
            for tick in range(num_ticks):
                self.current_weights = comp_curve[tick]
                target = max(1, int(round(users_curve[tick])))
                self._resize(target, rng)
                peak = max(peak, len(self._workers))
                time.sleep(cfg.tick_seconds)
        finally:
            self._resize(0, rng)
        with self._count_lock:
            stats = dict(self._counts)
        stats["peak_users"] = peak
        return stats

    def _resize(self, target: int, rng: np.random.Generator) -> None:
        cfg = self.config
        while len(self._workers) > target:
            worker = self._workers.pop()
            worker.stop_event.set()
            self._checkout.append(worker.user_id)
            self._stopped.append(worker)
        spawned = 0
        while len(self._workers) < target and spawned < cfg.max_spawn_per_tick:
            if not self._checkout:
                break  # population exhausted; run with what we have
            uid = int(self._checkout.pop(0))
            worker = _UserWorker(self, uid, seed=int(rng.integers(1 << 31)))
            worker.start()
            self._workers.append(worker)
            spawned += 1
        # Reap finished threads as we go; at wind-down (target 0), join every
        # worker ever stopped so no request lands after run() returns.
        deadline = time.monotonic() + (15.0 if target == 0 else 0.0)
        remaining = []
        for worker in self._stopped:
            worker.thread.join(timeout=max(0.0, deadline - time.monotonic()))
            if worker.thread.is_alive():
                remaining.append(worker)
        self._stopped = remaining
