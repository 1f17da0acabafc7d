"""The port's capacity surfaces (serve/surface.py) against the JAX
package's, on the CPU: ``MixSpace`` keys, axes, vertices, jitter probes,
programs and matches; ``CapacitySurface`` interpolation and metadata;
``peaks_from_series``; ``SurfaceConfig`` validation; and the manager's
LRU, byte budget and reload invalidation over a stub estimator.  The
module is numpy in both packages, so everything is equal, not close.
"""

import threading

import numpy as np
import pytest

from deeprest_tpu.config import SurfaceConfig as JaxSurfaceConfig
from deeprest_tpu.serve import surface as jax_surface
from deeprest_tpu_torch.config import SurfaceConfig
from deeprest_tpu_torch.serve import surface

W = 6
GRID = (0.5, 1.0, 2.0, 4.0)
BASES = {
    "two": [{"svc_/a": 10, "svc_/b": 4}] * W,
    "shared": [{"a": 3, "b": 5, "c": 7, "d": 1}] * W,
    "ragged": [{"a": t + 1, "b": 2 * t} for t in range(W)],
}


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("max_axes", [1, 3])
def test_mixspace_equals_jax(base, max_axes):
    prog = BASES[base]
    ms = surface.MixSpace(prog, GRID, max_axes=max_axes, seed=3)
    ref = jax_surface.MixSpace(prog, GRID, max_axes=max_axes, seed=3)
    assert (ms.key, ms.axes, ms.num_vertices) == (ref.key, ref.axes,
                                                  ref.num_vertices)
    assert ms.vertices() == ref.vertices()
    assert ms.jitter_scales(5) == ref.jitter_scales(5)
    assert ms.to_meta() == ref.to_meta()
    for scales in ms.vertices()[::3] + ms.jitter_scales(3):
        assert ms.program_at(scales) == ref.program_at(scales)
        assert ms.contains(scales) == ref.contains(scales)
        assert ms.match(ms.program_at(scales)) == ref.match(
            ref.program_at(scales))
    assert ms.match(prog[:-1]) is ref.match(prog[:-1]) is None


def test_mixspace_errors_equal_jax():
    for args in (([], GRID), (BASES["two"], (1.0,)),
                 (BASES["two"], (2.0, 1.0)), ([{"a": 0}] * W, GRID)):
        with pytest.raises(ValueError) as got:
            surface.MixSpace(*args)
        with pytest.raises(ValueError) as want:
            jax_surface.MixSpace(*args)
        assert str(got.value) == str(want.value)


def test_surface_interpolation_and_peaks_equal_jax():
    rng = np.random.default_rng(0)
    prog = BASES["two"]
    ms = surface.MixSpace(prog, GRID, max_axes=3)
    ref = jax_surface.MixSpace(prog, GRID, max_axes=3)
    values = rng.random((len(GRID), len(GRID), W, 3, 3)).astype(np.float32)
    values.setflags(write=False)
    parity = {"probes": 2, "max_rel_err": 0.1, "mean_rel_err": 0.05}
    got = surface.CapacitySurface(ms, "h", values, dict(parity), 0.5, 18)
    want = jax_surface.CapacitySurface(ref, "h", values, dict(parity), 0.5,
                                       18)
    for point in [(0.5, 0.5), (1.0, 4.0), (1.7, 0.6), (3.99, 2.5)]:
        np.testing.assert_array_equal(got.interpolate(point),
                                      want.interpolate(point))
        assert got.meta(point) == want.meta(point)
    assert got.nbytes == want.nbytes
    names, qs = ["c0_cpu", "c1_usage", "c2_cpu"], (0.05, 0.5, 0.95)
    series = got.interpolate((1.7, 0.6))
    for delta in (None, np.array([False, True, False])):
        assert surface.peaks_from_series(series, names, qs, delta) == \
            jax_surface.peaks_from_series(series, names, qs, delta)


@pytest.mark.parametrize("kwargs", [
    dict(grid=(1.0,)), dict(grid=(2.0, 1.0)), dict(grid=(0.0, 1.0)),
    dict(jitter=-1), dict(max_surfaces=0), dict(max_axes=True),
    dict(max_bytes=0)])
def test_surface_config_validation_equals_jax(kwargs):
    with pytest.raises(ValueError) as got:
        SurfaceConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JaxSurfaceConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert SurfaceConfig().__dict__ == JaxSurfaceConfig().__dict__


class StubPredictor:
    metric_names = ["c0_cpu", "c1_usage"]
    quantiles = (0.05, 0.5, 0.95)
    delta_mask = np.array([False, True])

    def __init__(self, digest="p0"):
        self.digest = digest

    def params_digest(self):
        return self.digest


class StubEstimator:
    """estimate_many_raw with a closed form (each series' value is its
    program's total calls per tick), counting calls."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def estimate_many_raw(self, programs, seeds=None, cache=True):
        with self.lock:
            self.calls += 1
        return [np.full((len(p), 2, 3),
                        float(sum(sum(s.values()) for s in p)) / len(p),
                        np.float32) for p in programs]


def managers(**kwargs):
    cfg = dict(enabled=True, grid=(0.5, 1.0, 2.0), jitter=2,
               warm_async=False, **kwargs)
    return (surface.CapacitySurfaceManager(SurfaceConfig(**cfg)),
            jax_surface.CapacitySurfaceManager(JaxSurfaceConfig(**cfg)))


def test_manager_queries_and_reload_equal_jax():
    prog = BASES["two"]
    outs = []
    for mgr in managers():
        pred, est = StubPredictor(), StubEstimator()
        try:
            first = mgr.query(pred, est, prog, factor=2, wait=True)
            hit = mgr.lookup_program(pred, surface.MixSpace(
                prog, (0.5, 1.0, 2.0)).program_at((2.0, 2.0)))
            frontier = mgr.query(pred, est, prog, factor=8)
            mgr.begin_reload()
            mgr.end_reload(reason="watch")
            stats = mgr.stats()
            outs.append((first, hit[1], frontier, stats, est.calls))
        finally:
            mgr.close()
    assert outs[0] == outs[1]
    first, hit_meta, frontier, stats, _ = outs[0]
    assert first["surface"]["hit"] and hit_meta["hit"]
    assert frontier["surface"]["frontier"] is True
    assert stats["invalidations"] == 1 and stats["surfaces"] == 0


def test_manager_byte_budget_and_lru_equal_jax():
    outs = []
    for mgr in managers(max_surfaces=2):
        pred, est = StubPredictor(), StubEstimator()
        try:
            for n in range(4):
                mgr.query(pred, est, [{"a": n + 1}] * W, factor=1.0,
                          wait=True)
            outs.append(mgr.stats())
        finally:
            mgr.close()
    assert outs[0] == outs[1]
    assert outs[0]["surfaces"] == 2 and outs[0]["evictions"] == 2
    tiny = managers(max_bytes=1)
    for mgr in tiny:
        try:
            with pytest.raises(ValueError, match="max_bytes"):
                mgr.query(StubPredictor(), StubEstimator(), BASES["two"],
                          factor=1.0, wait=True)
        finally:
            mgr.close()
