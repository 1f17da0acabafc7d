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
