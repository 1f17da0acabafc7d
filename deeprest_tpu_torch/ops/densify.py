"""On-device densification of padded-COO traffic rows
(``deeprest_tpu/ops/densify.py``).

At the 10k-endpoint width the per-window call-path count vector is >99%
zeros: one window touches a handful of F=10240 columns.  The sparse feed
carries traffic as padded-COO rows, ``(cols[..., K], vals[..., K])`` with
``K = nnz_cap`` real entries padded by ``(0, 0.0)``, from featurization
(``CallPathSpace.extract_sparse``) through the host→device copy, and
densifies to the model's static ``[..., F]`` on the device with one
``scatter_add_`` on the last axis.  Host→device bytes drop ~F/(2K): ~80×
at F=10240, K=64.  The scatter is a torch op, as the JAX package leaves it
to XLA outside any Pallas kernel.

Numerics contract, as in the JAX package:

- :func:`densify_coo` is BIT-EXACT against the dense reference: real
  columns within a row are unique (``extract_sparse`` goes through
  ``np.unique``, :func:`sparsify_rows` through ``np.flatnonzero``), so each
  output element receives at most one real value, and the ``(0, 0.0)``
  padding adds exact zeros to the non-negative counts.  The order of a
  CUDA scatter's atomic adds therefore cannot change a bit.  Never add two
  real values into one column.
- :func:`normalize_minmax` mirrors ``MinMaxStats.apply`` exactly,
  degenerate ranges passing through; its stats are device tensors, read
  at run time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_NNZ_CAP = 64


@dataclasses.dataclass
class SparseBase:
    """The device-staged padded-COO base series plus its normalization:
    ``cols``/``vals`` are ``[T, K]`` RAW traffic rows (int32 / f32) on the
    device; a window gather densifies them with :func:`densify_coo` and
    normalizes with the staged ``mn``/``rg``.  ``capacity`` is the dense
    width F."""

    cols: torch.Tensor           # [T, K] int32
    vals: torch.Tensor           # [T, K] float32
    mn: torch.Tensor             # broadcastable x_stats.min
    rg: torch.Tensor             # broadcastable x_stats.range
    capacity: int = 0


def densify_coo(cols: torch.Tensor, vals: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """``(cols[..., K], vals[..., K])`` padded COO → ``[..., capacity]``
    f32: one ``scatter_add_`` into zeros, batched over every leading
    axis (bit-exact; see the module docstring)."""
    out = torch.zeros((*cols.shape[:-1], capacity), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, cols.long(), vals)


def normalize_minmax(x: torch.Tensor, mn: torch.Tensor,
                     rg: torch.Tensor) -> torch.Tensor:
    """The device mirror of ``MinMaxStats.apply`` (degenerate ranges pass
    through raw)."""
    return torch.where(rg == 0.0, x,
                       (x - mn) / torch.where(rg == 0.0, 1.0, rg))


def gather_densify_normalize(base: SparseBase,
                             idx: torch.Tensor) -> torch.Tensor:
    """Window gather + densify + normalize for a staged sparse base:
    ``idx [..., W]`` row indices → normalized dense ``[..., W,
    capacity]`` windows."""
    x = densify_coo(base.cols[idx], base.vals[idx], base.capacity)
    return normalize_minmax(x, base.mn, base.rg)


# -- host twins (numpy, copied from the JAX package) ------------------------


def densify_rows(cols: np.ndarray, vals: np.ndarray, capacity: int,
                 out: np.ndarray | None = None) -> np.ndarray:
    """Host-side dense reconstruction of padded-COO rows, the parity
    reference for :func:`densify_coo` and the serving fallback where no
    sparse device path is up.  ``cols``/``vals`` are ``[..., K]``; returns
    float32 ``[..., capacity]``."""
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    shape = (*cols.shape[:-1], capacity)
    if out is None:
        out = np.zeros(shape, np.float32)
    else:
        if out.shape != shape:
            raise ValueError(f"out shape {out.shape} != {shape}")
        out[:] = 0.0
    if cols.size == 0:          # K=0 rows (e.g. an empty bucket): all zeros
        return out
    flat_o = out.reshape(-1, capacity)
    flat_c = cols.reshape(-1, cols.shape[-1])
    flat_v = vals.reshape(-1, vals.shape[-1])
    # np.add.at handles the (0, 0.0) padding exactly like the device
    # scatter: a zero add is a no-op on the non-negative counts here.
    rows = np.repeat(np.arange(flat_c.shape[0]), flat_c.shape[1])
    np.add.at(flat_o, (rows, flat_c.reshape(-1)), flat_v.reshape(-1))
    return out


def sparsify_rows(dense: np.ndarray, nnz_cap: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``[..., F]`` rows → padded-COO ``(cols, vals, nnz)``.

    The inverse of :func:`densify_rows` for rows whose nonzero count fits
    ``nnz_cap``; a row that does not RAISES (size ``--sparse-nnz-cap`` to
    the corpus; dropping call paths would corrupt the count vector).  The
    round trip is bit-exact: the nonzero values are copied.
    """
    dense = np.asarray(dense)
    flat = dense.reshape(-1, dense.shape[-1])
    n = flat.shape[0]
    cols = np.zeros((n, nnz_cap), np.int32)
    vals = np.zeros((n, nnz_cap), np.float32)
    nnz = np.zeros((n,), np.int32)
    for i in range(n):
        nz = np.flatnonzero(flat[i])
        if len(nz) > nnz_cap:
            raise ValueError(
                f"row {i} has {len(nz)} nonzero traffic columns, over the "
                f"sparse nnz cap {nnz_cap}; raise --sparse-nnz-cap (or "
                f"disable --sparse-feed) — silently dropping call paths "
                f"would corrupt the count vector")
        cols[i, :len(nz)] = nz
        vals[i, :len(nz)] = flat[i, nz]
        nnz[i] = len(nz)
    return (cols.reshape(*dense.shape[:-1], nnz_cap),
            vals.reshape(*dense.shape[:-1], nnz_cap),
            nnz.reshape(dense.shape[:-1]))


def sparse_minmax(cols: np.ndarray, vals: np.ndarray, nnz: np.ndarray,
                  span: int, capacity: int):
    """Per-column min/max over the first ``span`` padded-COO rows, equal to
    ``minmax_fit`` over the equivalent dense rows per column: a column
    absent from some row of the span folds that row's implicit 0.0 in.
    Presence is decided by the ``nnz`` row lengths, so padding at column 0
    cannot pollute column 0's statistics.  Returns a ``MinMaxStats`` with
    the per-feature ``[1, F]`` broadcast shape."""
    from deeprest_tpu_torch.data.windows import MinMaxStats

    c = np.asarray(cols[:span])
    v = np.asarray(vals[:span], np.float32)
    n = np.asarray(nnz[:span])
    mask = np.arange(c.shape[1])[None, :] < n[:, None]
    cm = c[mask]
    vm = v[mask]
    mx = np.full((capacity,), -np.inf, np.float32)
    mn = np.full((capacity,), np.inf, np.float32)
    np.maximum.at(mx, cm, vm)
    np.minimum.at(mn, cm, vm)
    cnt = np.zeros((capacity,), np.int64)
    np.add.at(cnt, cm, 1)
    everywhere = cnt == span
    mx = np.where(everywhere, mx, np.maximum(mx, np.float32(0.0)))
    mn = np.where(everywhere, mn, np.minimum(mn, np.float32(0.0)))
    return MinMaxStats(min=mn[None, :].astype(np.float32),
                       max=mx[None, :].astype(np.float32))
