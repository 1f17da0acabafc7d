"""Reader and writer of the ``deeprest-sharded-v1`` checkpoint format, with
numpy and torch only (``deeprest_tpu/train/checkpoint.py``).

A checkpoint step is ``directory/step_NNNNNNNN/`` holding ``manifest.json``
(every leaf's "/"-joined name, global shape, dtype and shard files with
their global index boxes), one ``.npy`` per shard under ``arrays/``, and
the ``host_state.json`` sidecar (normalization stats, metric names, model
config).  Writes are per shard, as JAX's: on a mesh each rank writes its
box of each leaf (``parallel/sharding.py``), a leaf replicated on an axis
only from coordinate 0 of that axis, so every distinct box is written
once; after a barrier rank 0 writes the manifest of all boxes and
publishes the step.  A read cuts whatever box it asks for from whatever
boxes are on disk, so a checkpoint saved on any mesh restores on any
other, in either package.  Dtypes that ``.npy`` cannot hold, such as bfloat16, are stored as
a same-width unsigned integer view with the real dtype named in the
manifest; the reader turns them back into torch tensors without ml_dtypes.

:func:`load_params` returns the ``params/*`` leaves of a checkpoint,
:func:`load_leaves` any leaves by name prefix (the trainer's resume reads
``step`` and the optimizer state ``opt_state/0/{mu,nu}/*``,
``opt_state/0/count``, from a checkpoint either package wrote), and
:func:`restore_checkpoint` the leaves a target state names, shaped like
it.
:func:`save_checkpoint` writes params plus the sidecar in the same layout,
one shard per leaf, with any other leaves a caller names beside them (the
trainer writes the step, the optimizer state and rng under the JAX
``TrainState`` names, so the JAX package's restore finds every leaf it
expects).  :func:`latest_cursor_step` finds the newest snapshot whose
sidecar carries a full ``train_cursor`` (epoch, steps done in it, the
numpy ``PCG64`` state of the shuffle at the epoch's start, global step);
:func:`prune_cursor_snapshots` keeps the newest K of them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from deeprest_tpu_torch.parallel.sharding import (
    all_boxes, leaf_path_name, rank_box, replica_writer, spec_of,
)

_STEP_RE = re.compile(r"^step_(\d+)$")
_SIDECAR = "host_state.json"
_MANIFEST = "manifest.json"
_FORMAT = "deeprest-sharded-v1"
_PARAMS = "params/"
# .npy round-trips these numpy dtype characters natively
_NATIVE_DTYPES = frozenset("?bhilqBHILQefdFD")
# integer view of each storage width, the manifest's dtype naming the real one
_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_TORCH_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def list_steps(directory: str) -> list[int]:
    """All checkpoint step numbers under ``directory``, ascending."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)))


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def load_sidecar(directory: str, step: int | None = None,
                 missing_ok: bool = False) -> dict | None:
    """One checkpoint's host-state sidecar; with ``missing_ok`` an absent
    or unparseable sidecar gives None instead of raising."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = os.path.join(_step_dir(directory, step), _SIDECAR)
    if missing_ok and not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except ValueError:
        if missing_ok:
            return None
        raise


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array → a torch tensor of the manifest's dtype."""
    if arr.dtype.name == dtype_name:
        return torch.from_numpy(np.array(arr))
    if dtype_name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint dtype {dtype_name!r} stored as "
                         f"{arr.dtype} has no torch counterpart here")
    signed = np.array(arr).view(arr.dtype.str.replace("u", "i"))
    return torch.from_numpy(signed).view(_TORCH_DTYPES[dtype_name])


def _intersect(a, b):
    """Overlap of two ``[[lo, hi], ...]`` boxes → (slices relative to
    ``a``'s origin, slices relative to ``b``'s) or None."""
    dst, src = [], []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        dst.append(slice(lo - alo, hi - alo))
        src.append(slice(lo - blo, hi - blo))
    return tuple(dst), tuple(src)


def _assemble(arrays_dir: str, entry: dict, box=None) -> torch.Tensor:
    """The ``box`` (``[(lo, hi), ...]``; None: the whole) of one saved leaf
    from whatever shard boxes are on disk."""
    shape = tuple(entry["shape"])
    box = [(0, d) for d in shape] if box is None else [tuple(b) for b in box]
    out_shape = tuple(hi - lo for lo, hi in box)
    out = None
    filled = 0
    for shard in entry["shards"]:
        hit = _intersect(box, shard["index"])
        if hit is None:
            continue
        fpath = os.path.join(arrays_dir, shard["file"])
        try:
            data = np.load(fpath, mmap_mode="r")
        except (ValueError, OSError, EOFError) as exc:
            raise ValueError(
                f"checkpoint shard {shard['file']!r} of leaf "
                f"{entry['name']!r} is truncated or corrupt ({exc})") from exc
        expect = tuple(hi - lo for lo, hi in shard["index"])
        if data.shape != expect:
            raise ValueError(
                f"checkpoint shard {shard['file']!r} of leaf "
                f"{entry['name']!r} has shape {data.shape}, the manifest "
                f"says {expect}")
        dst, src = hit
        if out is None:
            out = np.empty(out_shape, data.dtype)
        out[dst] = data[src]
        filled += int(np.prod([s.stop - s.start for s in dst],
                              dtype=np.int64))
    if out is None or filled != int(np.prod(out_shape, dtype=np.int64)):
        raise ValueError(f"checkpoint leaf {entry['name']!r}: its shards "
                         f"cover {filled} of {int(np.prod(out_shape))} "
                         "elements")
    return _to_torch(out, entry["dtype"])


def _manifest(directory: str, step: int | None
              ) -> tuple[int, str, dict]:
    """``(step, its arrays directory, its manifest)``; the newest step
    when ``step`` is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, _MANIFEST), encoding="utf-8") as fh:
        manifest = json.load(fh)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unknown checkpoint format "
                         f"{manifest.get('format')!r} at {path}")
    return step, os.path.join(path, "arrays"), manifest


def load_leaves(directory: str, step: int | None = None,
                prefix: str = "", box_of=None) -> dict[str, torch.Tensor]:
    """Every leaf of one checkpoint step whose "/"-joined name starts with
    ``prefix``, by its name with the prefix cut, as CPU tensors in their
    stored dtypes.  ``box_of(name, shape)`` (the leaf's full name and
    global shape → a ``[(lo, hi), ...]`` box, or None for the whole) cuts
    each leaf's box from the boxes on disk, a rank's restore on a mesh.
    A shard that is missing, torn or short raises ValueError naming its
    leaf."""
    _, arrays_dir, manifest = _manifest(directory, step)
    return {e["name"][len(prefix):]: _assemble(
                arrays_dir, e,
                None if box_of is None else box_of(e["name"],
                                                   tuple(e["shape"])))
            for e in manifest["leaves"] if e["name"].startswith(prefix)}


def load_params(directory: str, step: int | None = None, box_of=None
                ) -> dict[str, torch.Tensor]:
    """The ``params/*`` leaves of one checkpoint step, by leaf name
    (``mask_w1``, ``gru_fwd_w_ih``, ...), as CPU tensors in their stored
    dtypes; ``box_of`` as for :func:`load_leaves`."""
    params = load_leaves(directory, step, _PARAMS, box_of)
    if not params:
        raise ValueError(f"checkpoint under {directory!r} holds no params/* "
                         "leaves")
    return params


def restore_checkpoint(directory: str, target: Any,
                       step: int | None = None) -> tuple[Any, dict | None]:
    """The state of one checkpoint step shaped like ``target``, and its
    sidecar (``deeprest_tpu/train/checkpoint.py::restore_checkpoint``).

    ``target`` is a nested mapping (lists and tuples too) of tensors or
    arrays whose "/"-joined key paths name the leaves (``{"params":
    {"mask_w1": ...}, "step": ...}`` reads ``params/mask_w1`` and
    ``step``); each leaf comes back as a tensor of its stored dtype on the
    target leaf's device (the CPU for an array).  A missing leaf raises
    KeyError, a shape that differs from the target's ValueError.  (A rank
    of a sharded mesh reads its boxes with :func:`load_leaves`.)"""
    step, arrays_dir, manifest = _manifest(directory, step)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def restore(node, path: tuple):
        if isinstance(node, Mapping):
            return {k: restore(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(restore(v, path + (i,))
                              for i, v in enumerate(node))
        name = leaf_path_name(path)
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint step {step} under {directory!r} "
                           f"has no leaf {name!r} (saved leaves: "
                           f"{sorted(by_name)[:8]}...)")
        shape = tuple(entry["shape"])
        if shape != tuple(np.shape(node)):
            raise ValueError(f"checkpoint leaf {name!r} shape {shape} != "
                             f"target {tuple(np.shape(node))} "
                             "(architecture drift?)")
        leaf = _assemble(arrays_dir, entry)
        if isinstance(node, torch.Tensor):
            leaf = leaf.to(node.device)
        return leaf

    return (restore(target, ()),
            load_sidecar(directory, step, missing_ok=True))


def _has_full_cursor(extra: dict | None) -> bool:
    """Does this sidecar carry a full epoch-plan cursor (a resume anchor)?
    A light cursor (epoch None) and plain epoch-cadence checkpoints (no
    cursor) do not."""
    if extra is None:
        return False
    cur = extra.get("train_cursor")
    return (isinstance(cur, dict) and cur.get("epoch") is not None
            and cur.get("rng_state") is not None)


def latest_cursor_step(directory: str) -> int | None:
    """Newest checkpoint step whose sidecar carries a full ``train_cursor``
    (the trainer's snapshots), the anchor ``Trainer.resume_training``
    restarts from; steps without one are skipped."""
    for step in reversed(list_steps(directory)):
        if _has_full_cursor(load_sidecar(directory, step, missing_ok=True)):
            return step
    return None


def prune_cursor_snapshots(directory: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` cursor snapshots; returns the
    pruned steps.  Checkpoints without a cursor are never touched.  The
    trainer calls it after a durable newer save, so the restore target is
    always among the kept; the parent directory is fsynced after the
    removals."""
    if keep < 1:
        raise ValueError(f"prune_cursor_snapshots(keep={keep}): must be "
                         ">= 1 (the newest snapshot is the restore "
                         "target and must survive)")
    cursor_steps = [
        step for step in list_steps(directory)
        if _has_full_cursor(load_sidecar(directory, step, missing_ok=True))]
    pruned = []
    for step in cursor_steps[:-keep]:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
        pruned.append(step)
    if pruned:
        _fsync(os.path.abspath(directory))
    return pruned


def prune_checkpoints(directory: str, keep: int) -> list[int]:
    """Delete all but the newest ``keep`` checkpoint steps; returns the
    pruned steps."""
    if keep < 1:
        raise ValueError(f"keep={keep} must be >= 1")
    pruned = []
    for step in list_steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
        pruned.append(step)
    return pruned


def _storage(tensor) -> tuple[np.ndarray, str]:
    """(.npy-safe array, the dtype name the manifest records)."""
    if isinstance(tensor, np.ndarray):
        arr = tensor
        name = arr.dtype.name
    else:
        t = tensor.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _TORCH_DTYPES.values():
            arr = t.view(_TORCH_VIEW[t.element_size()]).numpy()
            return arr.view(_VIEW[arr.dtype.itemsize]), name
        arr = t.numpy()
    if arr.dtype.char not in _NATIVE_DTYPES:
        return arr.view(_VIEW[arr.dtype.itemsize]), name
    return arr, name


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json(path: str, obj: Any, **kwargs) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, **kwargs)
        fh.flush()
        os.fsync(fh.fileno())


def _shard_file(ord_: int, leaf: str, box) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "-", leaf).strip("-") or "leaf"
    start = "_".join(str(lo) for lo, _ in box) if box else "scalar"
    return f"{ord_:03d}.{safe}.{start}.npy"


def save_checkpoint(directory: str, params: Mapping[str, Any], step: int,
                    extra: dict | None = None,
                    other_leaves: Mapping[str, Any] | None = None,
                    mesh=None,
                    shapes: Mapping[str, tuple] | None = None) -> str:
    """Write ``directory/step_NNNNNNNN/`` with ``params/<name>`` leaves,
    ``other_leaves`` under their own "/"-joined names, and the sidecar
    ``extra``.  Staged under ``.tmp`` and renamed, with every file fsynced
    first, so a crash leaves no step or a whole one.

    On a ``mesh`` with a process group every rank calls this with its
    boxes of the leaves (``shapes`` gives each leaf's global shape by its
    full name, default the value's own): each rank writes the boxes it
    owns (:func:`parallel.sharding.replica_writer`), and rank 0 writes the
    manifest of every box, the sidecar, and publishes the step between
    barriers."""
    group = None if mesh is None else mesh.group
    chief = group is None or mesh.rank == 0
    path = _step_dir(directory, step)
    tmp = path + ".tmp"
    arrays_dir = os.path.join(tmp, "arrays")
    if chief:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(arrays_dir)
    if group is not None:
        dist.barrier(group=group)
    named = {_PARAMS + name: value for name, value in params.items()}
    named.update(other_leaves or {})
    shapes = shapes or {}
    leaves = []
    for ord_, (leaf, value) in enumerate(sorted(named.items())):
        arr, dtype_name = _storage(value)
        arr = np.ascontiguousarray(arr) if arr.ndim else arr
        shape = tuple(int(d) for d in shapes.get(leaf, arr.shape))
        if mesh is None:
            spec, mine, boxes = (), True, [tuple((0, d) for d in shape)]
        else:
            spec = spec_of(leaf, shape)
            mine = replica_writer(mesh, spec)
            boxes = all_boxes(mesh.config, spec, shape)
        if mine:
            box = (boxes[0] if mesh is None
                   else rank_box(mesh, spec, shape, leaf))
            if arr.shape != tuple(hi - lo for lo, hi in box):
                raise ValueError(
                    f"checkpoint leaf {leaf!r}: this rank holds shape "
                    f"{arr.shape}, its box {box} of {shape} wants "
                    f"{tuple(hi - lo for lo, hi in box)}")
            fpath = os.path.join(arrays_dir, _shard_file(ord_, leaf, box))
            np.save(fpath, arr)
            _fsync(fpath)
        leaves.append({"name": leaf, "shape": list(shape),
                       "dtype": dtype_name,
                       "shards": [{"index": [[lo, hi] for lo, hi in b],
                                   "file": _shard_file(ord_, leaf, b)}
                                  for b in boxes]})
    if group is not None:
        # every shard file exists before the manifest names it
        dist.barrier(group=group)
    if chief:
        _write_json(os.path.join(tmp, _MANIFEST),
                    {"format": _FORMAT, "step": int(step), "leaves": leaves},
                    indent=1, sort_keys=True)
        if extra is not None:
            _write_json(os.path.join(tmp, _SIDECAR), extra, indent=2,
                        sort_keys=True)
        _fsync(arrays_dir)
        _fsync(tmp)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync(os.path.dirname(path))
    if group is not None:
        dist.barrier(group=group)
    return path
