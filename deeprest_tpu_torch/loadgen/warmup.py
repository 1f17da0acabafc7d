"""Warmup: bulk-register the social graph and establish follow edges
(``deeprest_tpu/loadgen/warmup.py``).

The reference does this with 200-way asyncio/aiohttp concurrency over
``/user/register`` then bidirectional ``/user/follow`` per graph edge
(reference: locust/warmup.py:53-84). Here: a thread pool over keep-alive
connections (aiohttp is not in the environment; threads saturate a local
gateway just as well).
"""

from __future__ import annotations

import concurrent.futures
import threading

from deeprest_tpu_torch.loadgen.client import GatewayClient
from deeprest_tpu_torch.loadgen.graph import SocialGraph


def warmup(host: str, port: int, graph: SocialGraph,
           concurrency: int = 16) -> dict[str, int]:
    """Returns counts of successful registrations / follows."""
    local = threading.local()
    all_clients: list[GatewayClient] = []
    clients_lock = threading.Lock()

    def get_client() -> GatewayClient:
        client = getattr(local, "client", None)
        if client is None:
            client = local.client = GatewayClient(host, port)
            with clients_lock:
                all_clients.append(client)
        return client

    def worker_batch(fn, items):
        ok = 0
        with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
            def one(item):
                try:
                    fn(get_client(), item)
                    return True
                except Exception:
                    get_client().close()  # reconnects on next use
                    return False
            for success in pool.map(one, items):
                ok += success
        return ok

    registered = worker_batch(
        lambda c, uid: c.register(uid, graph.username(uid), graph.password(uid)),
        range(1, graph.num_users + 1),
    )
    # graph.edges already lists both directions per undirected edge, matching
    # the reference's bidirectional follow loop.
    followed = worker_batch(
        lambda c, e: c.follow(e[0], e[1]),
        graph.edges,
    )
    for c in all_clients:
        c.close()
    return {"registered": registered, "followed": followed,
            "users": graph.num_users, "edges": len(graph.edges)}
