"""Device-resident rolled inference, one model call per window page
(``deeprest_tpu/serve/fused.py``, dense path).

:class:`FusedRolledEngine` runs the rolled-prediction pipeline on the
device page by page: raw windows go to the device once per page, then
``x_stats`` normalization, the model, and the ``1e-6`` clamp run there;
delta-mask columns are de-normalized and integrated there with a parallel
prefix sum instead of the host loop's sequential per-window carry.  Ragged
right-aligned last windows and multi-series folds are expressed by
per-window carry offsets (``g``: the in-window step the next window's
carry reads) and segment starts (``seg``: windows where the carry resets,
a new series).  Long series page through a fixed rung ladder with the
carry threaded between pages as a device tensor, never read back.

On CUDA every page runs as one replay of its rung's captured graph
(serve/graphs.py; one per rung and ``integrate`` flag), so ``n_valid``
enters the program as a device scalar.  A page's raw windows are
assembled straight into a pinned host slot (double-buffered, one event
each), copied ``non_blocking`` into the graph's static inputs, and every
page's output is copied into one pinned host buffer before the next page
runs; one event wait then reads them all.  The carry out of a page is
copied into the next page's static input on the device.

Numerics contract, as in the JAX package: non-delta columns come back
NORMALIZED and the host inverts them with numpy after readback, the exact
per-element operations of ``y_stats.invert`` in
``rolled_prediction_reference`` (on the page's own layout); delta
columns carry a <= 1e-5 relative tolerance, since the prefix sum
re-associates the reference's left-to-right float32 adds.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.serve.graphs import (
    PinnedReadback, PinnedStaging, RungGraphs,
)

DEFAULT_FUSED_RUNGS = (8, 16, 32, 64)


def plan_windows(lengths: list[int], window_size: int):
    """Global window plan over a list of series lengths:
    ``[(series_idx, start, carry_offset, seg_start), ...]`` in dispatch
    order.  ``carry_offset`` is the in-window step the NEXT window's carry
    reads (``W - 1`` for regular tiling, less when the next window is the
    ragged right-aligned tail); ``seg_start`` marks each series' first
    window, where the integration carry resets to zero."""
    w = window_size
    metas: list[tuple[int, int, int, bool]] = []
    for si, t in enumerate(lengths):
        if t < w:
            raise ValueError(f"series length {t} < window_size {w}")
        starts = list(range(0, t - w + 1, w))
        if starts[-1] != t - w:
            starts.append(t - w)
        for j, s in enumerate(starts):
            g = starts[j + 1] - 1 - s if j + 1 < len(starts) else w - 1
            metas.append((si, s, g, j == 0))
    return metas


def _runs(chunk, window_size: int):
    """``(lo, hi)`` row ranges of a page whose windows tile one series back
    to back (one host copy each); a ragged right-aligned tail window
    starts a range of its own."""
    lo, n = 0, len(chunk)
    while lo < n:
        hi = lo + 1
        while (hi < n and chunk[hi][0] == chunk[lo][0]
               and chunk[hi][1] == chunk[hi - 1][1] + window_size):
            hi += 1
        yield lo, hi
        lo = hi


class FusedRolledEngine:
    """Rolled prediction over a batched apply, one model call per page.

    ``apply_fn`` maps normalized ``[n, W, F]`` windows (a tensor on
    ``device``) to ``[n, W, E, Q]`` float32 predictions on the same device.
    Page defaults follow ``device``: on CUDA the widest rung and
    ``ACCEL_COALESCE_PAGES`` pages per call (256 recurrence rows at the
    default ladder); on the CPU the smallest rung >= 8 and one page.
    ``graphs`` runs the page programs (captured on CUDA unless it was
    built with graphs off); a private one when None.
    """

    ACCEL_COALESCE_PAGES = 4

    def __init__(self, apply_fn, x_stats, y_stats, window_size: int, device,
                 delta_mask: np.ndarray | None = None,
                 median_index: int | None = None,
                 rungs=DEFAULT_FUSED_RUNGS,
                 page_windows: int | None = None,
                 coalesce_pages: int | None = None,
                 graphs: RungGraphs | None = None):
        self.device = torch.device(device)
        on_cpu = self.device.type == "cpu"
        rung_set = {int(r) for r in rungs}
        if page_windows is not None:
            if page_windows < 1:
                raise ValueError(f"page_windows {page_windows} must be >= 1")
            rung_set.add(int(page_windows))
        if coalesce_pages is None:
            coalesce_pages = 1 if on_cpu else self.ACCEL_COALESCE_PAGES
        if coalesce_pages < 1:
            raise ValueError(f"coalesce_pages {coalesce_pages} must be >= 1")
        self.coalesce_pages = int(coalesce_pages)
        base_rungs = tuple(sorted(rung_set))
        if not base_rungs or base_rungs[0] < 1:
            raise ValueError(f"bad fused rung set {rungs!r}")
        if page_windows is not None:
            self.page = int(page_windows)
        elif on_cpu:
            at_least_8 = [r for r in base_rungs if r >= 8]
            self.page = at_least_8[0] if at_least_8 else base_rungs[-1]
        else:
            self.page = base_rungs[-1]
        rung_set.update(self.page * g for g in range(2, self.coalesce_pages + 1))
        self.rungs = tuple(sorted(rung_set))
        self._apply_fn = apply_fn
        self.window_size = int(window_size)
        self.x_stats = x_stats
        self.y_stats = y_stats
        dm = np.asarray(delta_mask, bool) if delta_mask is not None else None
        self._has_delta = dm is not None and bool(dm.any())
        if self._has_delta and median_index is None:
            raise ValueError("delta_mask requires median_index for the "
                             "cross-window carry")
        self._median = int(median_index) if median_index is not None else 0
        self._graphs = graphs if graphs is not None else RungGraphs(
            self.device)

        def staged(a, shape):
            return torch.from_numpy(
                np.asarray(a, np.float32).reshape(shape)).to(self.device)

        self._x_mn = staged(x_stats.min, -1)
        self._x_rg = staged(x_stats.range, -1)
        self._y_mn = staged(y_stats.min, (1, 1, -1, 1))
        self._y_rg = staged(y_stats.range, (1, 1, -1, 1))
        n_carry = len(dm) if self._has_delta else 1
        self._carry0 = torch.zeros((n_carry,), dtype=torch.float32,
                                   device=self.device)
        if self._has_delta:
            self._delta_dev = torch.from_numpy(dm).to(
                self.device)[None, None, :, None]
        # The host invert's operands for [R, W, E, Q] pages: the
        # reference's ops (``x * range + min`` where range != 0) on every
        # element, on the contiguous layout instead of its transposed
        # view; delta columns keep the device's integrated values.
        rg, mn = np.asarray(y_stats.range), np.asarray(y_stats.min)
        self._inv_rg = rg.reshape(-1, 1) if rg.ndim else rg
        self._inv_mn = mn.reshape(-1, 1) if mn.ndim else mn
        self._keep = self._inv_rg == 0.0
        self._keep_delta = (self._keep | dm[:, None] if self._has_delta
                            else self._keep)
        self._staging: tuple[int, PinnedStaging] | None = None
        self._readback = PinnedReadback(self.device)
        self._lock = threading.Lock()       # the counters below
        self._pages = 0
        self._windows = 0
        self._padded_windows = 0
        self._series = 0
        self._max_dispatch_rows = 0
        self._dispatched: set[int] = set()

    # -- device program -------------------------------------------------

    def _program(self, x, carry_in, g, seg, n_valid, integrate: bool):
        """``[R, W, F]`` raw windows → (``[R, W, E, Q]``, carry ``[E]``);
        ``n_valid`` is a ``[1]`` device tensor, so one captured graph serves
        every fill of its rung.

        Delta metrics (when ``integrate``) come back de-normalized and
        integrated; everything else clamped and NORMALIZED (the host
        inverts them)."""
        r = x.shape[0]
        rg = self._x_rg
        xn = torch.where(rg == 0.0, x,
                         (x - self._x_mn) / torch.where(rg == 0.0, 1.0, rg))
        preds = torch.clamp_min(self._apply_fn(xn), 1e-6)        # [R,W,E,Q]
        if not self._has_delta:
            return preds, carry_in
        denorm = torch.where(self._y_rg == 0.0, preds,
                             preds * self._y_rg + self._y_mn)
        csum = torch.cumsum(denorm, dim=1)
        med = csum[..., self._median]                             # [R, W, E]
        totals = torch.gather(
            med, 1, g.view(r, 1, 1).expand(r, 1, med.shape[-1]))[:, 0, :]
        idx = torch.arange(r, device=x.device)
        totals = torch.where(idx[:, None] < n_valid, totals, 0.0)  # [R, E]
        # segmented EXCLUSIVE prefix sum over the window axis: the carry
        # since the segment start, or carry_in + prefix for the segment
        # that continues from the previous page
        excl = torch.cumsum(totals, dim=0) - totals
        start_pos = torch.cummax(
            torch.where(seg, idx, torch.full_like(idx, -1)), dim=0).values
        seg_base = excl[start_pos.clamp(0, r - 1)]
        base = torch.where(start_pos[:, None] >= 0, excl - seg_base,
                           excl + carry_in[None, :])
        last = (n_valid - 1).clamp(0, r - 1)
        carry_out = (base.index_select(0, last)
                     + totals.index_select(0, last))[0]
        if not integrate:
            return preds, carry_out
        integrated = base[:, None, :, None] + csum
        return torch.where(self._delta_dev, integrated, preds), carry_out

    def _staging_for(self, feature_dim: int) -> PinnedStaging:
        if self._staging is None or self._staging[0] != feature_dim:
            r, w = self.rungs[-1], self.window_size
            self._staging = (feature_dim, PinnedStaging(self.device, {
                "x": ((r, w, feature_dim), torch.float32),
                "g": ((r,), torch.int64), "seg": ((r,), torch.bool),
                "n": ((1,), torch.int64)}))
        return self._staging[1]

    def _fill(self, slot, arrays, chunk, rung: int) -> None:
        """Assemble one page into a staging slot: the windows of each run
        in one copy, zero padding rows (whose outputs are dropped)."""
        w, n = self.window_size, len(chunk)
        xs = slot["x"].numpy()
        for lo, hi in _runs(chunk, w):
            si, s = chunk[lo][0], chunk[lo][1]
            xs[lo:hi] = arrays[si][s:s + (hi - lo) * w].reshape(hi - lo, w, -1)
        xs[n:rung] = 0.0
        gs, ss = slot["g"].numpy(), slot["seg"].numpy()
        gs[:n] = [m[2] for m in chunk]
        gs[n:rung] = w - 1
        ss[:n] = [m[3] for m in chunk]
        ss[n:rung] = False
        slot["n"].numpy()[0] = n

    def _page(self, slot, rung: int, integrate: bool, carry):
        """One page through its rung's program; returns the (static on
        CUDA) outputs ``(out [R, W, E, Q], carry [E])``."""
        program = ("fused_increments" if self._has_delta and not integrate
                   else "fused")
        return self._graphs.run(
            (program, rung),
            lambda x, c, g, s, n: self._program(x, c, g, s, n, integrate),
            (slot["x"][:rung], carry, slot["g"][:rung], slot["seg"][:rung],
             slot["n"]), staged=slot)

    def warm(self, feature_dim: int) -> None:
        """Run every rung once per program in use (integrated and
        increments with a delta carry, else one) on zero pages: on CUDA
        this captures each one's graph."""
        flags = (True, False) if self._has_delta else (False,)
        with self._graphs.lock, torch.inference_mode():
            staging = self._staging_for(feature_dim)
            for rung in self.rungs:
                for integrate in flags:
                    slot = staging.take()
                    self._fill(slot, [], [], rung)
                    self._page(slot, rung, integrate, self._carry0)
            self._readback.landed()

    # -- host paging ----------------------------------------------------

    @property
    def page_windows(self) -> int:
        return self.page

    def rung_for(self, n: int) -> int:
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(f"page of {n} windows exceeds top rung "
                         f"{self.rungs[-1]}; chunk before dispatching")

    def predict_many(self, series_list, integrate: bool = True):
        """Raw ``[T_i, F]`` series → de-normalized ``[T_i, E, Q]`` each.

        All series fold into one window stream (carry resets at series
        boundaries), paged through the model with the carry chained
        between pages on the device.  ``integrate=False`` leaves delta
        columns as per-bucket increments."""
        arrays = [np.ascontiguousarray(s, dtype=np.float32)
                  for s in series_list]
        if not arrays:
            return []
        metas = plan_windows([len(a) for a in arrays], self.window_size)
        # One span for the whole train of pages (per-page spans would put
        # recorder traffic inside the paging loop); it inherits the
        # request's trace context from the calling thread.
        with obs_spans.RECORDER.span("fused.predict",
                                     component="deeprest-engine") as sp:
            sp.tag(series=len(arrays), windows=len(metas))
            return self._predict_many_inner(arrays, metas, integrate)

    def _predict_many_inner(self, arrays, metas, integrate: bool):
        w = self.window_size
        stride = self.page * self.coalesce_pages
        chunks = [metas[lo:lo + stride] for lo in range(0, len(metas), stride)]
        rungs = [self.rung_for(len(c)) for c in chunks]
        use_device_delta = self._has_delta and bool(integrate)
        # The engine's graphs and its host buffers are held from the first
        # staging copy until the pages are back on the host.
        with self._graphs.lock, self._readback.lock, torch.inference_mode():
            staging = self._staging_for(arrays[0].shape[1])
            carry, host, row = self._carry0, None, 0
            for chunk, rung in zip(chunks, rungs):
                slot = staging.take()
                self._fill(slot, arrays, chunk, rung)
                out, carry = self._page(slot, rung, use_device_delta, carry)
                if host is None:
                    host = self._readback.buffer(
                        (sum(rungs), *out.shape[1:]), out.dtype)
                host[row:row + rung].copy_(out, non_blocking=True)
                row += rung
            self._readback.landed()
            arr = host.numpy()                               # [ΣR,W,E,Q]
            # the host invert (the reference's ops); a fresh array, off
            # the pinned buffer
            keep = self._keep_delta if use_device_delta else self._keep
            arr = np.where(keep, arr, arr * self._inv_rg + self._inv_mn)
        outs = [np.empty((len(a), *arr.shape[2:]), np.float32)
                for a in arrays]
        row = 0
        for chunk, rung in zip(chunks, rungs):
            for lo, hi in _runs(chunk, w):
                si, s = chunk[lo][0], chunk[lo][1]
                # later (ragged) windows overwrite: runs go in plan order
                outs[si][s:s + (hi - lo) * w] = arr[row + lo:row + hi].reshape(
                    -1, *arr.shape[2:])
            row += rung
        with self._lock:
            self._pages += len(chunks)
            self._windows += len(metas)
            self._padded_windows += sum(rungs) - len(metas)
            self._series += len(arrays)
            self._max_dispatch_rows = max(self._max_dispatch_rows, *rungs)
            self._dispatched.update(rungs)
        return outs

    def stats(self) -> dict:
        with self._lock:
            out = {"rungs": list(self.rungs), "page_windows": self.page,
                   "coalesce_pages": self.coalesce_pages,
                   "pages": self._pages, "windows": self._windows,
                   "padded_windows": self._padded_windows,
                   "series": self._series,
                   "max_dispatch_rows": self._max_dispatch_rows,
                   "dispatched_rungs": sorted(self._dispatched)}
        out["graphs"] = self._graphs.stats()
        return out


class FusedInferenceMixin:
    """``predict_series`` / ``predict_series_many`` over the fused engine,
    or over the shape-laddered host loop when the engine is disabled.

    Routing, as in the JAX package: the fused engine serves every series
    when no MicroBatcher is attached.  With one attached, a series that
    fits a single ladder dispatch goes through it (coalescing small
    concurrent requests is the batcher's win), and longer series take the
    fused path."""

    _fused: FusedRolledEngine | None = None

    def _init_fused(self, apply_fn, enabled: bool = True,
                    page_windows: int | None = None,
                    coalesce_pages: int | None = None) -> None:
        if not enabled:
            self._fused = None
            return
        self._fused = FusedRolledEngine(
            apply_fn, self.x_stats, self.y_stats, self.window_size,
            device=self.device, delta_mask=self.delta_mask,
            median_index=self.median_index(), rungs=self.ladder.base_ladder,
            page_windows=page_windows, coalesce_pages=coalesce_pages,
            graphs=self.graphs)

    @property
    def fused(self) -> FusedRolledEngine | None:
        return self._fused

    def _num_windows(self, t: int) -> int:
        w = self.window_size
        n = (t - w) // w + 1
        return n + (1 if (t - w) % w != 0 else 0)

    def _route_fused(self, t: int) -> bool:
        if self._fused is None:
            return False
        if getattr(self, "_batcher", None) is None:
            return True
        return self._num_windows(t) > self.ladder.max_rung

    def predict_series(self, traffic: np.ndarray,
                       integrate: bool = True) -> np.ndarray:
        """``[T, F]`` raw traffic → de-normalized ``[T, E, Q]`` predictions.
        ``integrate=False`` leaves delta-trained columns as per-bucket
        increments."""
        traffic = np.asarray(traffic)
        if self._route_fused(len(traffic)):
            return self._fused.predict_many([traffic], integrate=integrate)[0]
        from deeprest_tpu_torch.serve.predictor import (
            rolled_prediction_reference,
        )

        return rolled_prediction_reference(
            self.apply_windows, self.x_stats, self.y_stats,
            self.window_size, traffic,
            delta_mask=self.delta_mask if integrate else None,
            median_index=self.median_index())

    def predict_series_many(self, series_list,
                            integrate: bool = True) -> list[np.ndarray]:
        """S raw ``[T_i, F]`` series folded into shared pages of the fused
        engine (per-series carry resets); one by one when it is off."""
        if self._fused is not None:
            return self._fused.predict_many(list(series_list),
                                            integrate=integrate)
        return [self.predict_series(s, integrate=integrate)
                for s in series_list]
