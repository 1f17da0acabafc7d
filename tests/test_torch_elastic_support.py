"""Importable-by-name helpers of the elastic remeshing tests
(tests/test_torch_elastic_gloo.py, tests/test_torch_elastic_stream.py): gloo
jobs of spawned ranks on the CPU whose ranks train behind the fault barrier.

It imports numpy and the port only, never JAX or the JAX package, so a
spawned rank that loads it loads neither.  A job's ``spec.json`` holds its
``mesh`` (``[data, expert, model]``) and one scenario: ``kind`` "fit" (a
``Trainer.fit`` from the params in ``params.npz`` with ``model`` and
``train`` config fields, ``epochs``, an optional ``lose_at`` schedule every
rank installs as a ``FaultInjector`` and an optional ``sigkill`` ``[rank,
global step]`` at which that rank SIGKILLs itself from ``on_step``) or
"stream" (the streaming trainer's remesh scenario), or "scenarios"
(``scenarios`` of tests/test_torch_parallel_support.py run in turn, a
resume reference among them).  Each rank writes
``rank{r}.npz``: its ``outcome`` ("done", "stood_down" or the name of the
error it left with), the error's message and cause, the remesh record and,
when done, the final params gathered whole on the final mesh, the last
epoch's per-step losses, the test losses and the step.  A rank that
SIGKILLed itself writes nothing.
"""

import json
import multiprocessing
import os
import signal

import numpy as np

from test_torch_parallel_support import (
    _whole, free_port, load_corpus, run_scenario,
)


def start_job(world: int, workdir: str) -> list:
    """Spawn the ``world`` ranks of the job in ``workdir``; returns the
    processes."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def start_jobs(jobs: list[tuple[int, str]]) -> list:
    """Start the jobs ``(world, workdir)`` side by side; :func:`wait_jobs`
    collects them."""
    return [(world, wd, start_job(world, wd)) for world, wd in jobs]


def wait_jobs(started: list, timeout: float = 240.0,
              killed: dict | None = None) -> list[list[dict | None]]:
    """Each started job's ranks' results (None for a rank that wrote none).
    Every rank must exit 0, except those ``killed`` names (``{workdir:
    rank}``), which must die by SIGKILL; a rank that outlives ``timeout``
    fails the run."""
    try:
        for _, _, procs in started:
            for p in procs:
                p.join(timeout)
    finally:
        for _, _, procs in started:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    out = []
    for world, wd, procs in started:
        want = [0] * world
        if killed and wd in killed:
            want[killed[wd]] = -signal.SIGKILL
        codes = [p.exitcode for p in procs]
        if codes != want:
            raise RuntimeError(f"ranks of {wd} exited {codes}, not {want}; "
                               f"see {wd}/rank*.log")
        out.append([read(os.path.join(wd, f"rank{r}.npz"))
                    for r in range(world)])
    return out


def run_jobs(jobs: list[tuple[int, str]], timeout: float = 240.0,
             killed: dict | None = None) -> list[list[dict | None]]:
    """:func:`start_jobs` then :func:`wait_jobs`."""
    return wait_jobs(start_jobs(jobs), timeout, killed)


def read(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    import sys
    import traceback

    log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
    sys.stdout = sys.stderr = log
    os.dup2(log.fileno(), 2)        # the c10d and gloo logs too
    try:
        import torch

        # the ranks share the host's cores
        torch.set_num_threads(1)

        from deeprest_tpu_torch.config import MeshConfig
        from deeprest_tpu_torch.parallel import (
            initialize_distributed, make_mesh,
        )
        from deeprest_tpu_torch.parallel.distributed import leave_job

        if not initialize_distributed(
                init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                rank=rank, device="cpu"):
            raise RuntimeError("the gloo job was not joined")
        with open(os.path.join(workdir, "spec.json")) as fh:
            spec = json.load(fh)
        if spec["kind"] == "stream":
            out = run_stream(workdir, spec)
        else:
            mesh = make_mesh(MeshConfig(*spec["mesh"]), device="cpu")
            if spec["kind"] == "scenarios":
                out = {f"{name}/{key}": value
                       for name, sc in spec["scenarios"].items()
                       for key, value in run_scenario(workdir, sc,
                                                      mesh).items()}
            else:
                out = run_fit(workdir, spec, mesh)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        leave_job()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def _outcome(exc: BaseException | None, stood_down: bool) -> dict:
    if exc is None:
        return {"outcome": np.asarray("stood_down" if stood_down
                                      else "done")}
    cause = exc.__cause__
    return {"outcome": np.asarray(type(exc).__name__),
            "error": np.asarray(str(exc)),
            "cause": np.asarray("" if cause is None
                                else type(cause).__name__)}


def run_fit(workdir: str, spec: dict, mesh) -> dict:
    """One elastic ``fit`` on this rank (see the module docstring)."""
    from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deeprest_tpu_torch.parallel import FaultInjector
    from deeprest_tpu_torch.train.data import prepare_dataset
    from deeprest_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(**spec["model"]),
                 train=TrainConfig(**spec["train"]))
    bundle = prepare_dataset(load_corpus(workdir), cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      mesh=mesh)
    if spec.get("lose_at"):
        trainer.install_fault_injector(FaultInjector(
            {int(k): int(v) for k, v in spec["lose_at"].items()}))
    with np.load(os.path.join(workdir, "params.npz")) as z:
        state = trainer.init_state({k: z[k] for k in z.files})
    kill = spec.get("sigkill")
    losses = []

    def on_epoch(result, st):
        losses.append(trainer.last_epoch_losses)

    def on_step(global_step):
        if kill and mesh.rank == kill[0] and global_step == kill[1]:
            os.kill(os.getpid(), signal.SIGKILL)

    exc = None
    try:
        state, hist = trainer.fit(bundle, state=state, on_epoch=on_epoch,
                                  on_step=on_step,
                                  num_epochs=spec["epochs"])
    except Exception as e:          # the outcome is what the test reads
        exc = e
    out = _outcome(exc, trainer.stood_down)
    out["remesh_history"] = np.asarray(json.dumps(trainer.remesh_history))
    if exc is None and not trainer.stood_down:
        out.update({f"params/{k}": v for k, v in _whole(
            trainer.mesh, state.params, trainer.model_config).items()})
        out["losses"] = np.asarray(losses[-1])
        out["test_losses"] = np.asarray([h.test_loss for h in hist])
        out["step"] = np.asarray(state.step)
        out["global_step"] = np.asarray(trainer.global_step)
        out["rank"] = np.asarray(trainer.mesh.rank)
        out["mesh"] = np.asarray([trainer.mesh.config.data,
                                  trainer.mesh.config.expert,
                                  trainer.mesh.config.model])
    return out


def stream_buckets(rng, n: int) -> list:
    """``tests/test_chaos.py``'s stream feed: ``n`` buckets of one cpu
    sample drawn from ``rng``, no traces."""
    from deeprest_tpu_torch.data.schema import Bucket, MetricSample

    return [Bucket(traces=[], metrics=[
        MetricSample("svc", "cpu", float(rng.random()))]) for _ in range(n)]


def run_stream(workdir: str, spec: dict) -> dict:
    """``tests/test_chaos.py::test_stream_elastic_remesh_defers_refresh`` on
    this rank's job: a refresh on ``data`` ranks, a queued manual trigger,
    one rank lost two steps into the next refresh."""
    from deeprest_tpu_torch.config import (
        Config, FeaturizeConfig, MeshConfig, ModelConfig, TrainConfig,
    )
    from deeprest_tpu_torch.parallel import FaultInjector
    from deeprest_tpu_torch.train.stream import (
        StreamConfig, StreamingTrainer,
    )

    data = spec["mesh"][0]
    cfg = Config(
        model=ModelConfig(feature_dim=32, hidden_size=8, dropout_rate=0.0),
        train=TrainConfig(batch_size=8, window_size=6, seed=0,
                          eval_stride=1, eval_max_cycles=2,
                          log_every_steps=0, snapshot_every_steps=2,
                          steps_per_superstep=1, device_data="always",
                          elastic=True, remesh_backoff_ms=1.0),
        mesh=MeshConfig(data=data))
    st = StreamingTrainer(
        cfg, StreamConfig(refresh_buckets=30, finetune_epochs=1,
                          history_max=64, eval_holdout=4),
        ckpt_dir=os.path.join(workdir, "ckpt"),
        feature_config=FeaturizeConfig(hash_features=True, capacity=32),
        device="cpu")
    rng = np.random.default_rng(0)
    for b in stream_buckets(rng, 40):
        st.ingest(b)
    r1 = st.refresh()
    out = {"r1_refresh": np.asarray(r1.refresh),
           "mesh_before": np.asarray(st.trainer.mesh.config.data)}
    st.request_refresh("manual")
    st.trainer.install_fault_injector(FaultInjector(
        {st.trainer.global_step + 2: spec["lose"]}))
    ready_in_flight = []
    remesh = st.trainer.remesh

    def spy(*args, **kwargs):
        ready_in_flight.append(st.ready())
        return remesh(*args, **kwargs)

    st.trainer.remesh = spy
    for b in stream_buckets(rng, 40):
        st.ingest(b)
    out["ready"] = np.asarray(st.ready())
    exc = r2 = None
    try:
        r2 = st.refresh()
    except Exception as e:          # the outcome is what the test reads
        exc = e
    out.update(_outcome(exc, st.trainer.stood_down))
    out["ready_in_flight"] = np.asarray(ready_in_flight)
    out["remesh_history"] = np.asarray(
        json.dumps(st.trainer.remesh_history))
    if r2 is not None:
        out.update({"r2_refresh": np.asarray(r2.refresh),
                    "r2_trigger": np.asarray(r2.trigger),
                    "r2_eval_loss": np.asarray(r2.eval_loss),
                    "mesh_after": np.asarray(st.trainer.mesh.config.data),
                    "in_flight": np.asarray(st.trainer.remesh_in_flight)})
    return out
