"""Importable-by-name helpers of tests/test_torch_serve_mesh.py.

It imports numpy and the port only, never JAX or the JAX package, so the
processes that load it load neither.

- :data:`LAUNCH`, the ``python -c`` program of one rank of a ``serve
  --mesh`` plane (:func:`cli_rank`): the CLI's ``main`` on the arguments
  after it, in a job its ``env://`` variables describe.  With
  ``JOB_TIMEOUT_S`` in its environment the rank cuts the job's group
  timeout to that many seconds before the job starts; with
  ``RANK_BARRIER`` (a directory) every rank first waits there for the
  others, so that a short timeout counts from one moment.
- :func:`service_rank`, one rank of a spawned gloo job that answers the
  same payloads through the port's in-process ``PredictionService`` over
  a ``Predictor`` on each mesh of ``spec.json`` in turn.
- :func:`quant_rank`, one rank of a spawned gloo job that builds a
  quantized ``Predictor`` on each (mesh, mode) of ``spec.json`` from its
  own copy of the checkpoint and writes its local leaves, its digest and
  the envelope files it wrote.
- :func:`front_rank`, one rank of a spawned gloo job that drives a
  ``MeshFront`` (rank 0) and its follower (rank 1) through reloads in an
  order the watched plane makes only by chance: a newer step loaded
  before the older one is swapped in, a warm-up that fails on rank 1
  alone, and a call from a generation the ranks dropped.
"""

import json
import os
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
LAUNCH = (f"import sys; sys.path.insert(0, {TESTS!r}); "
          "import test_torch_serve_mesh_support as s; s.cli_rank()")


def cli_rank() -> None:
    import deeprest_tpu_torch.parallel.distributed as job
    from deeprest_tpu_torch import cli
    from deeprest_tpu_torch.serve import mesh_front, predictor  # noqa: F401

    if os.environ.get("JOB_TIMEOUT_S"):
        job.JOB_TIMEOUT_S = float(os.environ["JOB_TIMEOUT_S"])
    barrier = os.environ.get("RANK_BARRIER")
    if barrier:
        world = int(os.environ["WORLD_SIZE"])
        open(os.path.join(barrier, f"ready{os.environ['RANK']}"), "w").close()
        deadline = time.monotonic() + 120
        while (len(os.listdir(barrier)) < world
               and time.monotonic() < deadline):
            time.sleep(0.01)
    sys.exit(cli.main(sys.argv[1:]))


def load_buckets(path: str) -> list:
    from deeprest_tpu_torch.data.schema import iter_raw_data_jsonl

    return list(iter_raw_data_jsonl(path))


def service_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the in-process reference job: for each mesh of
    ``workdir/spec.json`` the payloads' answers through a
    ``PredictionService`` (no batcher) over ``Predictor.from_checkpoint(
    mesh_config=...)``; rank 0 writes them to ``service.json``."""
    import traceback

    log = open(os.path.join(workdir, f"service{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
        from deeprest_tpu_torch.parallel import initialize_distributed
        from deeprest_tpu_torch.serve.predictor import Predictor
        from deeprest_tpu_torch.serve.server import PredictionService

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        buckets = load_buckets(spec["raw"])
        out = {}
        for label, mesh in spec["meshes"].items():
            pred = Predictor.from_checkpoint(
                spec["ckpt"], device="cpu", mesh_config=MeshConfig(*mesh))
            svc = PredictionService(
                pred, TraceSynthesizer(pred.space()).fit(buckets))
            out[label] = {route: getattr(svc, method)(payload)
                          for route, (method, payload)
                          in spec["payloads"].items()}
            svc.close()
        if rank == 0:
            with open(os.path.join(workdir, "service.json"), "w") as fh:
                json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def quant_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the quantization job: for each case of
    ``workdir/spec.json`` (a mesh, a quant mode and a checkpoint copy with
    no envelope yet) ``Predictor.from_checkpoint(mesh_config=...,
    quant=...)``; this rank's leaves go to ``{case}.rank{r}.npz`` (a
    ``QuantTensor`` as ``name.data`` and ``name.scale``, bf16 as its
    int16 view) and its digest and envelope writes to ``quant{r}.json``."""
    import builtins
    import traceback

    log = open(os.path.join(workdir, f"quant{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.ops.quantize import QuantTensor
        from deeprest_tpu_torch.parallel import initialize_distributed
        from deeprest_tpu_torch.serve import predictor as predictor_mod

        writes = []

        def counting_open(path, mode="r", *args, **kwargs):
            if "w" in mode and os.path.basename(str(path)).startswith(
                    "quant_parity_"):
                writes.append(str(path))
            return builtins.open(path, mode, *args, **kwargs)

        predictor_mod.open = counting_open
        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        out = {"digests": {}, "writes": writes}
        for case, (mesh, mode, ckpt) in spec["cases"].items():
            pred = predictor_mod.Predictor.from_checkpoint(
                ckpt, device="cpu", quant=mode,
                mesh_config=MeshConfig(*mesh))
            leaves = {}
            for name, leaf in pred.params.items():
                if isinstance(leaf, QuantTensor):
                    leaves[f"{name}.data"] = leaf.data.numpy()
                    leaves[f"{name}.scale"] = leaf.scale.numpy()
                elif leaf.dtype == torch.bfloat16:
                    leaves[name] = leaf.view(torch.int16).numpy()
                else:
                    leaves[name] = leaf.detach().numpy()
            np.savez(os.path.join(workdir, f"{case}.rank{rank}.npz"),
                     **leaves)
            out["digests"][case] = pred.params_digest()
        with open(os.path.join(workdir, f"quant{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def front_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the mesh-front job on ``workdir/spec.json``'s
    checkpoint (steps 0-3) on 1x2x1.  Rank 0: ``reload(1)``, then
    ``reload(2)`` before step 1's swap; step 1's answer; the swap; a
    ``reload(3)`` that rank 1's warm-up fails; a call of step 0's
    predictor (dropped at that ``RELOAD``); step 2's swap and answer; then
    ``STOP``.  Rank 1 follows, its last warm-up unit of step 3 raising
    after it ran.  Rank 0 writes what it saw to ``front.json``."""
    import functools
    import traceback

    log = open(os.path.join(workdir, f"front{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import initialize_distributed
        from deeprest_tpu_torch.serve import mesh_front
        from deeprest_tpu_torch.serve.predictor import Predictor
        from deeprest_tpu_torch.serve.server import ServingError

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        pred = Predictor.from_checkpoint(spec["ckpt"], step=0, device="cpu",
                                         mesh_config=MeshConfig(1, 2, 1))
        pred.warm()
        pred.params_digest()
        load = functools.partial(Predictor.from_checkpoint, spec["ckpt"],
                                 mesh=pred.mesh, device="cpu")
        if rank:
            real = Predictor.warm_units

            def warm_units(self):
                units = real(self)
                if self.step != 3:
                    return units
                last = units[-1]

                def failing():
                    last()
                    raise RuntimeError("injected warm-up failure")

                return units[:-1] + [failing]

            Predictor.warm_units = warm_units
            mesh_front.follow(pred, load)
        else:
            traffic = np.asarray(spec["traffic"], np.float32)
            out = {}
            front = mesh_front.MeshFront(pred, load=load)
            one = front.reload(1)
            two = front.reload(2)
            out["step1"] = one.predict_series(traffic).tolist()
            one.front.swapped()
            try:
                front.reload(3)
                out["reload3"] = None
            except Exception as exc:
                out["reload3"] = f"{type(exc).__name__}: {exc}"
            try:
                pred.predict_series(traffic)
                out["step0_after"] = 200
            except ServingError as exc:
                out["step0_after"] = exc.status
            two.front.swapped()
            out["step2"] = two.predict_series(traffic).tolist()
            out["stats"] = two.front.stats()
            front.stop()
            with open(os.path.join(workdir, "front.json"), "w") as fh:
                json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()
