"""Reader and writer of the ``deeprest-sharded-v1`` checkpoint format, with
numpy and torch only (``deeprest_tpu/train/checkpoint.py``).

A checkpoint step is ``directory/step_NNNNNNNN/`` holding ``manifest.json``
(every leaf's "/"-joined name, global shape, dtype and shard files with
their global index boxes), one ``.npy`` per shard under ``arrays/``, and
the ``host_state.json`` sidecar (normalization stats, metric names, model
config).  Dtypes that ``.npy`` cannot hold, such as bfloat16, are stored as
a same-width unsigned integer view with the real dtype named in the
manifest; the reader turns them back into torch tensors without ml_dtypes.

:func:`load_params` returns the ``params/*`` leaves of a checkpoint
(optimizer state, step and rng are skipped), and :func:`save_checkpoint`
writes params plus the sidecar in the same layout, one shard per leaf,
with any other leaves a caller names beside them (the trainer writes the
step, the optimizer state and rng under the JAX ``TrainState`` names, so
the JAX package's restore finds every leaf it expects).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Mapping

import numpy as np
import torch

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


def _assemble(arrays_dir: str, entry: dict) -> torch.Tensor:
    """The whole of one saved leaf from whatever shard boxes are on disk."""
    shape = tuple(entry["shape"])
    out = None
    filled = 0
    for shard in entry["shards"]:
        fpath = os.path.join(arrays_dir, shard["file"])
        try:
            data = np.load(fpath)
        except (ValueError, OSError, EOFError) as exc:
            raise ValueError(
                f"checkpoint shard {shard['file']!r} of leaf "
                f"{entry['name']!r} is truncated or corrupt ({exc})") from exc
        box = tuple(slice(lo, hi) for lo, hi in shard["index"])
        expect = tuple(hi - lo for lo, hi in shard["index"])
        if data.shape != expect:
            raise ValueError(
                f"checkpoint shard {shard['file']!r} of leaf "
                f"{entry['name']!r} has shape {data.shape}, the manifest "
                f"says {expect}")
        if out is None:
            out = np.empty(shape, data.dtype)
        out[box] = data
        filled += int(np.prod(expect, dtype=np.int64))
    if out is None or filled != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"checkpoint leaf {entry['name']!r}: its shards "
                         f"cover {filled} of {int(np.prod(shape))} elements")
    return _to_torch(out, entry["dtype"])


def load_params(directory: str, step: int | None = None
                ) -> dict[str, torch.Tensor]:
    """The ``params/*`` leaves of one checkpoint step, by leaf name
    (``mask_w1``, ``gru_fwd_w_ih``, ...), as CPU tensors in their stored
    dtypes."""
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
    arrays_dir = os.path.join(path, "arrays")
    params = {e["name"][len(_PARAMS):]: _assemble(arrays_dir, e)
              for e in manifest["leaves"] if e["name"].startswith(_PARAMS)}
    if not params:
        raise ValueError(f"checkpoint at {path} holds no params/* leaves")
    return params


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


def save_checkpoint(directory: str, params: Mapping[str, Any], step: int,
                    extra: dict | None = None,
                    other_leaves: Mapping[str, Any] | None = None) -> str:
    """Write ``directory/step_NNNNNNNN/`` with ``params/<name>`` leaves,
    ``other_leaves`` under their own "/"-joined names, and the sidecar
    ``extra``.  Staged under ``.tmp`` and renamed, with every file fsynced
    first, so a crash leaves no step or a whole one."""
    path = _step_dir(directory, step)
    tmp = path + ".tmp"
    arrays_dir = os.path.join(tmp, "arrays")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(arrays_dir)
    named = {_PARAMS + name: value for name, value in params.items()}
    named.update(other_leaves or {})
    leaves = []
    for ord_, (leaf, value) in enumerate(sorted(named.items())):
        arr, dtype_name = _storage(value)
        arr = np.ascontiguousarray(arr) if arr.ndim else arr
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "-", leaf).strip("-") or "leaf"
        start = "_".join("0" for _ in arr.shape) if arr.ndim else "scalar"
        fname = f"{ord_:03d}.{safe}.{start}.npy"
        fpath = os.path.join(arrays_dir, fname)
        np.save(fpath, arr)
        _fsync(fpath)
        leaves.append({"name": leaf, "shape": list(arr.shape),
                       "dtype": dtype_name,
                       "shards": [{"index": [[0, int(d)] for d in arr.shape],
                                   "file": fname}]})
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
    return path
