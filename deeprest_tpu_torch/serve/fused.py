"""Device-resident rolled inference, one model call per window page
(``deeprest_tpu/serve/fused.py``).

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

The sparse feed (``sparse_nnz_cap``): pages ship as padded-COO
``(cols [R, W, K] int32, vals [R, W, K] f32)`` instead of ``[R, W, F]``
floats, ~F/(2K) fewer host→device bytes, and :meth:`_program_sparse`
densifies them on the device (one ``scatter_add_``, ``ops/densify.py``)
before the same body runs, so sparse pages give the dense pages' outputs
bit for bit.  A sparse engine's pinned slots hold cols/vals only; its
sparse programs are captured per ``(rung, integrate)`` in :meth:`warm`.

The fleet tier (serve/fleet.py): :meth:`FusedRolledEngine.adopt_executables`
makes an engine page through a plane engine's programs, graphs, pinned
staging and readback; the engine keeps its own stats on the device
(:meth:`~FusedRolledEngine.bound_state`, bound into the plane's before
each page) and its own host invert operands.

On a mesh (``Predictor(mesh=...)``) the page program's model call is
the predictor's apply, which returns every expert's answer (gathered on
the expert axis), so the engine pages, integrates and reads back as on
one device; every rank pages the same series in the same order.

Numerics contract, as in the JAX package: non-delta columns come back
NORMALIZED and the host inverts them with numpy after readback, the exact
per-element operations of ``y_stats.invert`` in
``rolled_prediction_reference`` (on the page's own layout); delta
columns carry a <= 1e-5 relative tolerance, since the prefix sum
re-associates the reference's left-to-right float32 adds.
"""

from __future__ import annotations

import contextlib
import functools
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
                 graphs: RungGraphs | None = None,
                 sparse_nnz_cap: int | None = None,
                 feature_dim: int | None = None,
                 quant: str = "off"):
        self.device = torch.device(device)
        self.quant = quant
        self._sparse_nnz_cap = (int(sparse_nnz_cap)
                                if sparse_nnz_cap is not None else None)
        self._feature_dim = (int(feature_dim) if feature_dim is not None
                             else None)
        if self._sparse_nnz_cap is not None and self._feature_dim is None:
            raise ValueError("sparse_nnz_cap requires feature_dim (the "
                             "static dense width the scatter targets)")
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
        self._sparse_staging: PinnedStaging | None = None
        self._readback = PinnedReadback(self.device)
        self._lock = threading.Lock()       # the counters below
        self._pages = 0
        self._sparse_pages = 0
        self._windows = 0
        self._padded_windows = 0
        self._series = 0
        self._max_dispatch_rows = 0
        self._dispatched: set[int] = set()
        # the engine whose programs, staging and readback serve this one's
        # pages (itself, or a plane's after adopt_executables), and the
        # predictor each page binds into the plane's slot
        self._exec = self
        self._owner = None
        self._front = None       # rank 0's mesh front (serve/mesh_front.py)

    # -- the fleet tier ---------------------------------------------------

    _STATS = ("x_mn", "x_rg", "y_mn", "y_rg")

    def bound_state(self) -> dict:
        """The per-tenant device stats the page program reads, by name."""
        return {f"fused.{k}": getattr(self, f"_{k}") for k in self._STATS}

    def load_bound_state(self, state: dict) -> None:
        for k in self._STATS:
            setattr(self, f"_{k}", state[f"fused.{k}"])

    def _geometry(self) -> dict:
        return dict(window_size=self.window_size, rungs=self.rungs,
                    page=self.page, quant=self.quant,
                    has_delta=self._has_delta, median=self._median,
                    sparse_nnz_cap=self._sparse_nnz_cap,
                    feature_dim=self._feature_dim)

    def check_adoptable(self, donor: "FusedRolledEngine") -> None:
        """Raise unless this engine can page through ``donor``'s programs:
        JAX's trace-time constants (window, rungs, page, quant, delta,
        median, sparse cap, feature dim) and the delta mask, which the
        programs read from the plane."""
        mine, theirs = self._geometry(), donor._geometry()
        if mine != theirs:
            diff = {k: (mine[k], theirs[k]) for k in mine
                    if mine[k] != theirs[k]}
            raise ValueError(
                "cannot share fused executables across mismatched engine "
                f"geometry (mine vs donor): {diff}")
        if self._has_delta and not torch.equal(
                self._delta_dev.cpu(), donor._delta_dev.cpu()):
            raise ValueError(
                "cannot share fused executables: delta masks differ "
                "(the mask is a trace-time constant of the program)")

    def adopt_executables(self, donor: "FusedRolledEngine",
                          owner=None) -> None:
        """Page through ``donor``'s programs, graphs, pinned staging and
        readback (fleet tier), binding ``owner`` (the tenant predictor)
        into the donor plane's slot before each page.  The dispatched-rung
        ledger and its lock are shared too, so ``stats()`` reads plane-wide
        truth from any adopted engine.  It runs before this engine's first
        page (the fleet adopts a tenant's plane at admission, before the
        tenant serves), so the page path reads what it set without this
        lock."""
        if donor is self:
            return
        self.check_adoptable(donor)
        with self._lock:
            self._exec = donor._exec
            self._graphs = donor._graphs
            self._readback = donor._readback
            self._carry0 = donor._carry0
            self._staging = self._sparse_staging = None
            self._owner = owner
            self._dispatched = donor._dispatched
            self._lock = donor._lock

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

    def _program_sparse(self, cols, vals, carry_in, g, seg, n_valid,
                        integrate: bool):
        """Padded-COO twin of :meth:`_program`: one scatter-add rebuilds
        the raw ``[R, W, F]`` page on the device (bit-exact, see
        ``ops/densify.py``), then the same body runs."""
        from deeprest_tpu_torch.ops.densify import densify_coo

        x = densify_coo(cols, vals, self._feature_dim)
        return self._program(x, carry_in, g, seg, n_valid, integrate)

    def _plan_buffers(self) -> dict:
        r = self.rungs[-1]
        return {"g": ((r,), torch.int64), "seg": ((r,), torch.bool),
                "n": ((1,), torch.int64)}

    def _staging_for(self, feature_dim: int) -> PinnedStaging:
        # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
        if self._exec is not self:
            return self._exec._staging_for(feature_dim)
        if self._staging is None or self._staging[0] != feature_dim:
            r, w = self.rungs[-1], self.window_size
            # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
            self._staging = (feature_dim, PinnedStaging(self.device, {
                "x": ((r, w, feature_dim), torch.float32),
                **self._plan_buffers()}))
        return self._staging[1]

    def _sparse_staging_for(self) -> PinnedStaging:
        """Pinned cols/vals slots at ``[top rung, W, K]``; a sparse page
        never allocates the dense ``[R, W, F]`` slot."""
        if self._exec is not self:
            return self._exec._sparse_staging_for()
        if self._sparse_staging is None:
            r, w, k = self.rungs[-1], self.window_size, self._sparse_nnz_cap
            # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
            self._sparse_staging = PinnedStaging(self.device, {
                "cols": ((r, w, k), torch.int32),
                "vals": ((r, w, k), torch.float32),
                **self._plan_buffers()})
        return self._sparse_staging

    def _fill(self, slot, arrays, chunk, rung: int,
              names: tuple[str, ...] = ("x",)) -> None:
        """Assemble one page into a staging slot: the windows of each run
        in one copy per buffer of ``names`` (``arrays[si]`` holds one
        ``[T, ...]`` array per name), zero padding rows (whose outputs are
        dropped; a zero COO row densifies to zeros)."""
        w, n = self.window_size, len(chunk)
        for i, name in enumerate(names):
            xs = slot[name].numpy()
            for lo, hi in _runs(chunk, w):
                si, s = chunk[lo][0], chunk[lo][1]
                xs[lo:hi] = arrays[si][i][s:s + (hi - lo) * w].reshape(
                    hi - lo, w, -1)
            xs[n:rung] = 0
        gs, ss = slot["g"].numpy(), slot["seg"].numpy()
        gs[:n] = [m[2] for m in chunk]
        gs[n:rung] = w - 1
        ss[:n] = [m[3] for m in chunk]
        ss[n:rung] = False
        slot["n"].numpy()[0] = n

    def _page(self, slot, rung: int, integrate: bool, carry,
              sparse: bool = False):
        """One page through its rung's program (``sparse_fused*`` for a
        COO page); returns the (static on CUDA) outputs ``(out [R, W, E,
        Q], carry [E])``."""
        program = ("fused_increments" if self._has_delta and not integrate
                   else "fused")
        plan = (carry, slot["g"][:rung], slot["seg"][:rung], slot["n"])
        prog = self._exec
        if sparse:
            # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
            return self._graphs.run(
                ("sparse_" + program, rung),
                lambda c, v, *rest: prog._program_sparse(c, v, *rest,
                                                         integrate),
                (slot["cols"][:rung], slot["vals"][:rung], *plan),
                # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
                staged=slot, owner=self._owner)
        return self._graphs.run(
            (program, rung),
            lambda x, *rest: prog._program(x, *rest, integrate),
            (slot["x"][:rung], *plan), staged=slot, owner=self._owner)

    def warm(self, feature_dim: int) -> None:
        """Run every rung once per program in use (integrated and
        increments with a delta carry, else one) on zero pages: on CUDA
        this captures each one's graph.  A sparse engine warms its sparse
        programs (its dense ones run only for a series with a row over the
        cap, and capture then)."""
        for unit in self.warm_units(feature_dim):
            unit()

    def warm_units(self, feature_dim: int) -> list:
        """:meth:`warm`'s pages in order, each a call of no arguments."""
        flags = (True, False) if self._has_delta else (False,)
        return [functools.partial(self._warm_page, feature_dim, rung,
                                  integrate)
                for rung in self.rungs for integrate in flags]

    def _warm_page(self, feature_dim: int, rung: int,
                   integrate: bool) -> None:
        sparse = self.sparse_enabled
        names = ("cols", "vals") if sparse else ("x",)
        with self._graphs.lock, torch.inference_mode():
            staging = (self._sparse_staging_for() if sparse
                       else self._staging_for(feature_dim))
            slot = staging.take()
            self._fill(slot, [], [], rung, names)
            # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
            self._page(slot, rung, integrate, self._carry0, sparse)
            # graftlint: disable=TH004 -- adopt_executables runs before this engine's first page (fleet admission); pages hold the plane's graph lock
            self._readback.landed()

    # -- host paging ----------------------------------------------------

    @property
    def page_windows(self) -> int:
        return self.page

    @property
    def sparse_enabled(self) -> bool:
        return self._sparse_nnz_cap is not None

    @property
    def sparse_nnz_cap(self) -> int | None:
        return self._sparse_nnz_cap

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
            return self._predict_many_inner([(a,) for a in arrays], metas,
                                            integrate)

    def predict_many_sparse(self, sparse_series_list,
                            integrate: bool = True):
        """Sparse entry: each series is a padded-COO ``(cols [T_i, K],
        vals [T_i, K])`` pair of RAW counts (``CallPathSpace.
        extract_sparse`` rows or ``ops.densify.sparsify_rows`` output);
        returns the de-normalized ``[T_i, E, Q]`` arrays, bit for bit
        those of :meth:`predict_many` on the equivalent dense series.
        Pages ship as ``(cols, vals)`` and densify on the device."""
        if not self.sparse_enabled:
            raise ValueError(
                "sparse feed is not enabled on this engine; construct it "
                "with sparse_nnz_cap/feature_dim (InferConfig.sparse_feed)")
        k = self._sparse_nnz_cap
        arrays = []
        for cols, vals in sparse_series_list:
            cols = np.ascontiguousarray(cols, dtype=np.int32)
            vals = np.ascontiguousarray(vals, dtype=np.float32)
            if cols.shape != vals.shape or cols.ndim != 2:
                raise ValueError(
                    f"sparse series must be matching [T, K] cols/vals "
                    f"pairs, got {cols.shape} vs {vals.shape}")
            if cols.shape[1] != k:
                raise ValueError(
                    f"sparse series K={cols.shape[1]} != engine nnz cap "
                    f"{k}; pad rows to the configured --sparse-nnz-cap "
                    f"(a per-request K would compile per-request "
                    f"executables)")
            arrays.append((cols, vals))
        if not arrays:
            return []
        metas = plan_windows([len(c) for c, _ in arrays], self.window_size)
        with obs_spans.RECORDER.span("fused.predict_sparse",
                                     component="deeprest-engine") as sp:
            sp.tag(series=len(arrays), windows=len(metas))
            return self._predict_many_inner(arrays, metas, integrate,
                                            sparse=True)

    def _predict_many_inner(self, arrays, metas, integrate: bool,
                            sparse: bool = False):
        w = self.window_size
        stride = self.page * self.coalesce_pages
        chunks = [metas[lo:lo + stride] for lo in range(0, len(metas), stride)]
        rungs = [self.rung_for(len(c)) for c in chunks]
        use_device_delta = self._has_delta and bool(integrate)
        names = ("cols", "vals") if sparse else ("x",)
        # The engine's graphs and its host buffers are held from the first
        # staging copy until the pages are back on the host; rank 0 of a
        # serving mesh announces the call to the other ranks inside them
        # (serve/mesh_front.py).
        with self._graphs.lock, self._readback.lock, torch.inference_mode(), (
                contextlib.nullcontext() if self._front is None
                else self._front.fused(arrays, integrate, sparse)):
            staging = (self._sparse_staging_for() if sparse
                       else self._staging_for(arrays[0][0].shape[1]))
            carry, host, row = self._carry0, None, 0
            for chunk, rung in zip(chunks, rungs):
                slot = staging.take()
                self._fill(slot, arrays, chunk, rung, names)
                out, carry = self._page(slot, rung, use_device_delta, carry,
                                        sparse)
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
        outs = [np.empty((len(a[0]), *arr.shape[2:]), np.float32)
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
            if sparse:
                self._sparse_pages += len(chunks)
            self._windows += len(metas)
            self._padded_windows += sum(rungs) - len(metas)
            self._series += len(arrays)
            self._max_dispatch_rows = max(self._max_dispatch_rows, *rungs)
            self._dispatched.update(rungs)
        return outs

    def cache_size(self) -> int:
        """Captured graphs of the dense and sparse fused programs (on the
        CPU, or with graphs off, the keys dispatched), one a (program,
        rung): the port's count behind JAX's compiled-executable count,
        which counts signatures of its one program and so may differ, and
        like it flat once a mix of calls has run.  It reads the graphs an
        adopted engine shares with its plane, so any tenant reads the
        plane's truth."""
        return self._graphs.size("fused") + self._graphs.size("sparse_fused")

    def stats(self) -> dict:
        with self._lock:
            out = {"rungs": list(self.rungs), "page_windows": self.page,
                   "coalesce_pages": self.coalesce_pages,
                   "pages": self._pages,
                   "sparse_pages": self._sparse_pages,
                   "sparse_nnz_cap": self._sparse_nnz_cap,
                   "quant": self.quant,
                   "windows": self._windows,
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
    fused path.  A backend with ``sparse_feed`` converts dense series to
    padded COO on the host and ships those (:meth:`_maybe_sparsify`)."""

    _fused: FusedRolledEngine | None = None
    _warned_fat_rows = False

    def _init_fused(self, apply_fn, enabled: bool = True,
                    page_windows: int | None = None,
                    coalesce_pages: int | None = None,
                    sparse_nnz_cap: int | None = None) -> None:
        if not enabled:
            self._fused = None
            return
        self._fused = FusedRolledEngine(
            apply_fn, self.x_stats, self.y_stats, self.window_size,
            device=self.device, delta_mask=self.delta_mask,
            median_index=self.median_index(), rungs=self.ladder.base_ladder,
            page_windows=page_windows, coalesce_pages=coalesce_pages,
            graphs=self.graphs, sparse_nnz_cap=sparse_nnz_cap,
            feature_dim=(self.feature_dim if sparse_nnz_cap is not None
                         else None),
            quant=getattr(self, "quant", "off"))

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
            sparse = self._maybe_sparsify([traffic])
            if sparse is not None:
                return self._fused.predict_many_sparse(
                    sparse, integrate=integrate)[0]
            return self._fused.predict_many([traffic], integrate=integrate)[0]
        from deeprest_tpu_torch.serve.predictor import (
            rolled_prediction_reference,
        )

        return rolled_prediction_reference(
            self.apply_windows, self.x_stats, self.y_stats,
            self.window_size, traffic,
            delta_mask=self.delta_mask if integrate else None,
            median_index=self.median_index())

    def _maybe_sparsify(self, series_list):
        """Dense → padded COO on the host for a ``sparse_feed`` backend,
        so the device gets the smaller pages (outputs are bit-identical
        either way).  None (ship dense) when the feature is off or a row
        is over the cap; that overflow is warned once, not raised: a dense
        caller never chose the COO form and must not fail because one
        bucket ran hot."""
        if not (getattr(self, "sparse_feed", False)
                and self._fused is not None
                and self._fused.sparse_enabled):
            return None
        from deeprest_tpu_torch.ops.densify import sparsify_rows

        try:
            return [sparsify_rows(s, self._fused.sparse_nnz_cap)[:2]
                    for s in series_list]
        except ValueError as exc:
            if not FusedInferenceMixin._warned_fat_rows:
                FusedInferenceMixin._warned_fat_rows = True
                print(f"sparse-feed: dense fallback for a request "
                      f"({exc}); raise --sparse-nnz-cap to keep the "
                      "sparse feed (warned once)")
            return None

    def predict_series_sparse(self, cols: np.ndarray, vals: np.ndarray,
                              integrate: bool = True) -> np.ndarray:
        """``(cols [T, K], vals [T, K])`` padded-COO raw traffic →
        de-normalized ``[T, E, Q]``, bit-identical to the dense entry on
        the equivalent series: through the engine's sparse program when
        the backend has one at this K, else densified on the host and
        served dense."""
        if (self._fused is not None and self._fused.sparse_enabled
                and np.asarray(cols).shape[-1]
                == self._fused.sparse_nnz_cap):
            return self._fused.predict_many_sparse(
                [(cols, vals)], integrate=integrate)[0]
        from deeprest_tpu_torch.ops.densify import densify_rows

        return self.predict_series(
            densify_rows(cols, vals, self.feature_dim),
            integrate=integrate)

    def predict_series_many_sparse(self, sparse_series_list,
                                   integrate: bool = True
                                   ) -> list[np.ndarray]:
        """S ``(cols [T_i, K], vals [T_i, K])`` pairs folded into shared
        pages of the engine's sparse program, as
        :meth:`predict_series_many` folds dense series."""
        sparse_series_list = list(sparse_series_list)
        if (self._fused is not None and self._fused.sparse_enabled
                and all(np.shape(c)[-1] == self._fused.sparse_nnz_cap
                        for c, _ in sparse_series_list)):
            return self._fused.predict_many_sparse(sparse_series_list,
                                                   integrate=integrate)
        return [self.predict_series_sparse(c, v, integrate=integrate)
                for c, v in sparse_series_list]

    def predict_series_many(self, series_list,
                            integrate: bool = True) -> list[np.ndarray]:
        """S raw ``[T_i, F]`` series folded into shared pages of the fused
        engine (per-series carry resets); one by one when it is off."""
        if self._fused is not None:
            series_list = list(series_list)
            # graftlint: disable=JX003 -- host data: wire-format series are numpy arrays/lists, asarray never touches a device buffer
            sparse = self._maybe_sparsify([np.asarray(s)
                                           for s in series_list])
            if sparse is not None:
                return self._fused.predict_many_sparse(sparse,
                                                       integrate=integrate)
            return self._fused.predict_many(series_list,
                                            integrate=integrate)
        return [self.predict_series(s, integrate=integrate)
                for s in series_list]
