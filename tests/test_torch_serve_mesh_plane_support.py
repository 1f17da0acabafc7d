"""Importable-by-name helpers of tests/test_torch_serve_mesh_plane.py.

It imports numpy and the port only, never JAX or the JAX package, so the
processes that load it load neither.

- :func:`replica_rank`, one rank of a spawned gloo job on 1x1x2 that puts
  the port's ``ReplicaRouter`` over a mesh ``Predictor`` with two device
  keys (the CPU as ``cpu`` and ``cpu:1``), so a replica is a one-device
  clone of the gathered params, then scales the router down and up and
  rolls it onto step 1; and a weighted router at depth 1 over the step-1
  mesh predictor grants a ``default`` waiter before an earlier ``t1``
  one.  First, a fleet pool at budget 1 over the mesh predictor and a
  one-device tenant spills and restores ``default``: every rank's shards
  move.  Every rank counts the model's forward calls by whether the
  module is sharded.
"""

import json
import os
import sys


def _counting_forward(counts: dict) -> None:
    """Count ``QuantileGRU.forward`` calls into ``counts`` under "mesh"
    (a sharded module) or "one" (a one-device one)."""
    from deeprest_tpu_torch.models.qrnn import QuantileGRU

    forward = QuantileGRU.forward

    def counted(self, *args, **kwargs):
        counts["mesh" if self.sharded else "one"] += 1
        return forward(self, *args, **kwargs)

    QuantileGRU.forward = counted


def weighted_grants(router, pred, traffic) -> dict:
    """The grant order of a ``t1`` and a later ``default`` waiter on a
    router over ``pred`` at depth 1 with weights default=3,t1=1 and room
    for two waiters, while its slot is held; the error a third waiter
    gets; ``default``'s answer."""
    import threading
    import time

    plane = router.ReplicaRouter.build(pred, 1, config=router.RouterConfig(
        admission_depth=1, max_waiting=2, max_wait_s=60.0,
        tenant_weights={"default": 3.0, "t1": 1.0}))
    order, answers = [], {}

    def client(tenant):
        with plane.admit(tenant):
            order.append(tenant)
            answers[tenant] = plane.predict_series(traffic).tolist()

    held = plane.admit("other")
    threads = []
    for waiting, tenant in enumerate(("t1", "default"), 1):
        threads.append(threading.Thread(target=client, args=(tenant,)))
        threads[-1].start()
        while plane.admission.stats()["waiting"] < waiting:
            time.sleep(0.001)
    try:
        plane.admit("t1")
        shed = "admitted"
    except Exception as exc:
        shed = f"{type(exc).__name__}: {exc}"
    held.__exit__(None, None, None)
    for t in threads:
        t.join(60)
    return {"order": order, "shed": shed, "answer": answers["default"]}


def replica_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the replica job on ``workdir/spec.json``'s checkpoint
    (steps 0 and 1) on 1x1x2.  Rank 0: a front over the step-0 mesh
    predictor and a router of two replicas on ``cpu`` and ``cpu:1`` (the
    second a clone through ``GATHER``); each replica's answer; then
    ``scale_to`` 1, 3 and 1 (the mesh stack answering after each), 2 (a
    fresh clone), a reload of step 1 rolled onto both stacks with the
    ``SWAP`` that drops step 0; a router at depth 1 with weights
    default=3,t1=1 over the step-1 predictor, its one slot held while
    ``t1`` then ``default`` queue (a third waiter shed), then released;
    and ``STOP``.  Rank 1 follows.  Each rank
    writes its forward counts to ``counts{rank}.json``, rank 0 its
    answers to ``replicas.json``.  Before it all, the step-0 predictor
    serves through a plane of its mesh on both ranks, and rank 0 admits
    it to a pool at budget 1 beside a one-device clone (its admission
    spills ``default``), then resolves ``default`` (a restore): each rank
    records whether its own bound tensors moved."""
    import functools
    import traceback

    log = open(os.path.join(workdir, f"replica{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import initialize_distributed
        from deeprest_tpu_torch.serve import mesh_front, router
        from deeprest_tpu_torch.serve.predictor import Predictor

        counts = {"mesh": 0, "one": 0}
        _counting_forward(counts)
        devices = [torch.device("cpu"), torch.device("cpu", 1)]
        router._thread_devices = lambda backend: devices
        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        pred = Predictor.from_checkpoint(spec["ckpt"], step=0, device="cpu",
                                         mesh_config=MeshConfig(1, 1, 2))
        pred.warm()
        pred.params_digest()
        load = functools.partial(Predictor.from_checkpoint, spec["ckpt"],
                                 mesh=pred.mesh, device="cpu")
        pred.fleet_plane()
        held = {k: t.data_ptr() for k, t in pred.bound_state().items()}

        def moved():
            now = pred.bound_state()
            return sum(now[k].data_ptr() != p for k, p in held.items())

        if rank:
            mesh_front.follow(pred, load)
            counts["moved"] = moved()
        else:
            from deeprest_tpu_torch.serve.fleet import PredictorPool
            from deeprest_tpu_torch.serve.replica import clone_backend

            traffic = np.asarray(spec["traffic"], np.float32)
            front = mesh_front.MeshFront(pred, load=load)
            out = {}
            pool = PredictorPool(hbm_budget=1, aot=False)
            pool.admit("default", pred)
            pool.admit("solo", clone_backend(pred, device="cpu"))
            entry = pool.resolve("default")
            out["fleet"] = {
                "answer": entry.predictor().predict_series(traffic).tolist(),
                "spills": entry.spills, "restores": entry.restores,
                "tensors": len(held)}
            counts["moved"] = moved()
            plane = router.ReplicaRouter.build(pred, 2)

            def answers():
                return [r.predict_series(traffic).tolist()
                        for r in plane.replicas]

            def stacks():
                return [("mesh" if r.backend() is pred else
                         "front" if r.backend().front is not None else
                         "clone") for r in plane.replicas]

            calls = front.calls
            out["build"] = {"stacks": stacks(), "answers": answers(),
                            "calls": front.calls - calls}
            out["scaled"] = {}
            for n in (1, 3, 1, 2):
                plane.scale_to(n)
                out["scaled"][str(n)] = {"stacks": stacks(),
                                         "answers": answers()}
            fresh = front.reload(1)
            plane.rolling_reload_from(fresh)
            fresh.front.swapped(drop=True)
            out["reloaded"] = {"stacks": stacks(), "answers": answers()}
            out["generations"] = front.stats()["generations"]
            out["weighted"] = weighted_grants(router, fresh, traffic)
            front.stop()
            with open(os.path.join(workdir, "replicas.json"), "w") as fh:
                json.dump(out, fh)
        with open(os.path.join(workdir, f"counts{rank}.json"), "w") as fh:
            json.dump(counts, fh)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()
