"""The Hopper block plan of the f32 recurrence kernels, on the CPU.

K1 (``gru_fwd``) and K3 (``gru_bwd``) run their f32 products in 3xTF32 on
the tensor cores; K2 (``gru_fwd_train``) keeps plain FMA.  The plan
(``ops/cuda_gru.py::block_plan``) mirrors the sources' shared-memory
formulas and launch bounds without a compiler, so these tests hold it to
the layouts written out here and to the constants in the sources' text;
on the card ``tests/test_torch_cuda_gru.py`` holds the mirrors against the
built libraries.
"""

import os
import re

import pytest
import torch

from deeprest_tpu_torch.ops import build, cuda_gru

F32 = torch.float32
SMEM_LIMIT = 232_448


def _source_constant(name: str, source: str) -> int:
    with open(os.path.join(build.CSRC_DIR, source)) as fh:
        found = re.findall(rf"constexpr int {name} = (\d+);", fh.read())
    assert len(found) == 1, (name, source, found)
    return int(found[0])


def test_plan_constants_equal_the_sources():
    fwd, bwd = "gru_fwd.cu", "gru_bwd.cu"
    assert _source_constant("kTf32MaxThreads", fwd) == \
        cuda_gru.TF32_FWD_MAX_THREADS
    assert _source_constant("kTf32MaxThreads", bwd) == \
        cuda_gru.TF32_BWD_MAX_THREADS
    assert _source_constant("kTf32WPad", fwd) == cuda_gru.TF32_FWD_W_PAD
    assert _source_constant("kTf32HPad", fwd) == cuda_gru.TF32_FWD_H_PAD
    assert _source_constant("kTf32Units", fwd) == cuda_gru.TF32_FWD_UNITS
    assert _source_constant("kTf32Pad", bwd) == cuda_gru.TF32_BWD_PAD
    assert _source_constant("kMaxThreads", fwd) == \
        _source_constant("kMaxThreads", bwd) == cuda_gru.MAX_THREADS
    assert _source_constant("kRowTile", bwd) == cuda_gru.ROW_TILE
    # each source's launch bound is its constant, one CTA an SM
    for source in (fwd, bwd):
        with open(os.path.join(build.CSRC_DIR, source)) as fh:
            text = fh.read()
        assert "__launch_bounds__(kTf32MaxThreads, 1)" in text, source


# (H, K1 bytes, K1 CTAs an SM, K3 bytes, K3 CTAs an SM): K1 is W_hh
# [H][3H+8] and the carry tile [2][16][round8(H)+4] on ceil(H/8) warps, K3
# W_hh and the dgates tile [round16(H)+16][3H+4] on ceil(H/16) warps, all
# f32; K1 may keep 120 registers a thread, K3 255.
LAYOUTS = [
    (40, (40 * 128 + 2 * 16 * 44) * 4, 3, 64 * 124 * 4, 2),
    (64, (64 * 200 + 2 * 16 * 68) * 4, 2, 80 * 196 * 4, 2),
    (96, (96 * 296 + 2 * 16 * 100) * 4, 1, 112 * 292 * 4, 1),
    (128, (128 * 392 + 2 * 16 * 132) * 4, 1, 144 * 388 * 4, 1),
]


@pytest.mark.parametrize("h,k1_bytes,k1_ctas,k3_bytes,k3_ctas", LAYOUTS)
def test_f32_tensor_core_layouts(h, k1_bytes, k1_ctas, k3_bytes, k3_ctas):
    warps = -(-h // 16)
    k1 = cuda_gru.block_plan(88, 60, 8, h, F32, training=False)
    assert k1["binding"] == "fwd" and k1["fits"]
    assert (k1["smem_bytes"], k1["ctas_per_sm"], k1["cluster_ctas"]) == \
        (k1_bytes, k1_ctas, 1)
    assert k1["threads_per_cta"] == 32 * -(-h // 8)
    assert k1["registers_cap"] == 120
    assert cuda_gru.fwd_smem_bytes(h, False, train=False) == k1_bytes
    plan = cuda_gru.block_plan(88, 60, 32, h, F32, training=True)
    k3 = plan["kernels"]["bwd"]
    assert (k3["smem_bytes"], k3["ctas_per_sm"], k3["cluster_ctas"]) == \
        (k3_bytes, k3_ctas, 1)
    assert k3["threads_per_cta"] == 32 * warps
    assert k3["registers_cap"] == 255
    assert cuda_gru.bwd_smem_bytes(h, False) == k3_bytes
    # K2 keeps its FMA layout: 2H threads, 128 registers
    k2 = plan["kernels"]["fwd_train"]
    assert k2["threads_per_cta"] == 2 * h
    assert k2["registers_cap"] == 128
    assert k2["smem_bytes"] == -(-12 * h * h // 16) * 16 + 128 * h


@pytest.mark.parametrize("e,b,waves", [
    (40, 256, 5),     # the K1 table shape: 640 CTAs, 4.85 waves
    (88, 32, 2),      # the stream's fine-tune: 176 CTAs, 1.33 waves
    (88, 8, 1),       # the verdict sweeps' smallest rung: 88 CTAs
    (40, 32, 1)])     # the K3 table shape: 80 CTAs
def test_f32_waves_at_the_main_path_shapes(e, b, waves):
    for training in (False, True):
        plan = cuda_gru.block_plan(e, 60, b, 128, F32, training=training)
        for entry in plan["kernels"].values():
            assert entry["ctas"] == -(-b // 16) * e
            assert entry["ctas_per_sm"] == 1 and entry["waves"] == waves


def _fma_admitted(h: int, training: bool, stash: bool) -> bool:
    """What the FMA forms of K1 and K3 admitted: H % 4 (K1) or H % 8 (K3)
    with 2H <= 512 threads, W_hh and the f32 tiles (without the stash K3
    also staged an h_prev tile) within one CTA's shared memory."""
    if 2 * h > 512:
        return False
    if not training:
        return h % 4 == 0 and \
            -(-12 * h * h // 16) * 16 + 128 * h <= SMEM_LIMIT
    return h % 8 == 0 and (h * (12 * h + 16) + 192 * h
                           + (0 if stash else 64 * h)) <= SMEM_LIMIT


@pytest.mark.parametrize("training,stash", [(False, True), (True, True),
                                            (True, False)])
def test_f32_refusals_no_stricter_than_the_fma_forms(training, stash):
    name = "bwd" if training else "fwd"
    old, new = set(), set()
    for h in range(1, 260):
        if _fma_admitted(h, training, stash):
            old.add(h)
        if cuda_gru.block_plan(2, 3, 5, h, F32,
                               training=training)["kernels"][name]["fits"]:
            new.add(h)
    assert old <= new, sorted(old - new)
    # the largest admitted hidden sizes are what they were
    assert max(old) == max(new) == (128 if training else 132)


def test_f32_refusals_keep_their_reasons():
    assert "H % 4" in cuda_gru.block_plan(2, 3, 5, 6, F32,
                                          training=False)["refusal"]
    assert "H % 8" in cuda_gru.block_plan(2, 3, 5, 12, F32)["refusal"]
    for training in (False, True):
        # above the largest H the shared memory refuses, before the threads
        for h in (136, 256):
            refusal = cuda_gru.block_plan(2, 3, 5, h, F32,
                                          training=training)["refusal"]
            assert "bytes of shared memory" in refusal, (h, refusal)
        assert "threads" in cuda_gru.block_plan(
            2, 3, 5, 260, F32, training=training)["refusal"]
