"""The Hopper block plan of the f32 recurrence kernels, on the CPU.

K1 (``gru_fwd``), K2 (``gru_fwd_train``), K3 (``gru_bwd``) and K4's f32
dot (``gru_fwd_blocked``) run their f32 products in 3xTF32 on the tensor
cores.  The plan
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

from deeprest_tpu_torch.benchmarks import f32_kernels
from deeprest_tpu_torch.ops import build, cuda_gru

F32 = torch.float32
SMEM_LIMIT = 232_448


def _source_constant(name: str, source: str) -> int:
    with open(os.path.join(build.CSRC_DIR, source)) as fh:
        found = re.findall(rf"constexpr int {name} = (\d+);", fh.read())
    assert len(found) == 1, (name, source, found)
    return int(found[0])


def test_plan_constants_equal_the_sources():
    fwd, bwd, blk = "gru_fwd.cu", "gru_bwd.cu", "gru_fwd_blocked.cu"
    # K4's f32 dot takes the layout of the f32 K1 and K2
    for source in (fwd, blk):
        assert _source_constant("kTf32MaxThreads", source) == \
            cuda_gru.TF32_FWD_MAX_THREADS
        assert _source_constant("kTf32WPad", source) == \
            cuda_gru.TF32_FWD_W_PAD
        assert _source_constant("kTf32HPad", source) == \
            cuda_gru.TF32_FWD_H_PAD
        assert _source_constant("kTf32Units", source) == \
            cuda_gru.TF32_FWD_UNITS
    assert _source_constant("kMmaRows", blk) == cuda_gru.MMA_UNITS == \
        cuda_gru.ROW_TILE == cuda_gru.BLOCKED_TF32_ROWS[1]
    assert _source_constant("kMmaMaxThreads", blk) == \
        cuda_gru.BLOCKED_MMA_MAX_THREADS
    assert _source_constant("kTf32MaxThreads", bwd) == \
        cuda_gru.TF32_BWD_MAX_THREADS
    assert _source_constant("kTf32Pad", bwd) == cuda_gru.TF32_BWD_PAD
    assert _source_constant("kMaxThreads", fwd) == \
        _source_constant("kMaxThreads", bwd) == cuda_gru.MAX_THREADS
    assert _source_constant("kRowTile", fwd) == \
        _source_constant("kRowTile", bwd) == cuda_gru.ROW_TILE
    assert _source_constant("kRowGroups", fwd) == cuda_gru.ROW_GROUPS
    # each source's launch bound is its constant, one CTA an SM
    for source in (fwd, bwd, blk):
        with open(os.path.join(build.CSRC_DIR, source)) as fh:
            text = fh.read()
        assert "__launch_bounds__(kTf32MaxThreads, 1)" in text, source


# (H, K1 bytes, K1 CTAs an SM, K3 bytes, K3 CTAs an SM): K1 and K2 are
# W_hh [H][3H+8] and the carry tile [2][16][round8(H)+4] on ceil(H/8)
# warps, K3 W_hh and the dgates tile [round16(H)+16][3H+4] on ceil(H/16)
# warps, all f32; K1 and K2 may keep 96 registers a thread (17 warps: 5
# on one of the SM's four register partitions), K3 255.
LAYOUTS = [
    (40, (40 * 128 + 2 * 16 * 44) * 4, 4, 64 * 124 * 4, 2),
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
    assert k1["registers_cap"] == 96
    assert cuda_gru.fwd_smem_bytes(h, False) == k1_bytes
    plan = cuda_gru.block_plan(88, 60, 32, h, F32, training=True)
    k3 = plan["kernels"]["bwd"]
    assert (k3["smem_bytes"], k3["ctas_per_sm"], k3["cluster_ctas"]) == \
        (k3_bytes, k3_ctas, 1)
    assert k3["threads_per_cta"] == 32 * warps
    assert k3["registers_cap"] == 255
    assert cuda_gru.bwd_smem_bytes(h, False) == k3_bytes
    # K2 is K1 with two more streamed outputs: K1's layout and launch bound
    k2 = plan["kernels"]["fwd_train"]
    assert (k2["smem_bytes"], k2["ctas_per_sm"], k2["cluster_ctas"]) == \
        (k1_bytes, k1_ctas, 1)
    assert k2["threads_per_cta"] == 32 * -(-h // 8)
    assert k2["registers_cap"] == 96


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


def _fma_admitted(name: str, stash: bool, h: int) -> bool:
    """What the FMA forms of K1, K2 and K3 admitted: H % 4 (K1, K2) or
    H % 8 (K3) with 2H <= 512 threads, W_hh and the f32 tiles (without the
    stash K3 also staged an h_prev tile) within one CTA's shared memory."""
    if 2 * h > 512:
        return False
    if name != "bwd":
        return h % 4 == 0 and \
            -(-12 * h * h // 16) * 16 + 128 * h <= SMEM_LIMIT
    return h % 8 == 0 and (h * (12 * h + 16) + 192 * h
                           + (0 if stash else 64 * h)) <= SMEM_LIMIT


@pytest.mark.parametrize("name,stash", [("fwd", True), ("fwd_train", True),
                                        ("bwd", True), ("bwd", False)])
def test_f32_refusals_no_stricter_than_the_fma_forms(name, stash):
    training = name != "fwd"
    old, new = set(), set()
    for h in range(1, 260):
        if _fma_admitted(name, stash, h):
            old.add(h)
        if cuda_gru.block_plan(2, 3, 5, h, F32,
                               training=training)["kernels"][name]["fits"]:
            new.add(h)
    assert old <= new, sorted(old - new)
    # the largest admitted hidden sizes are what they were: K2 alone takes
    # H = 132 (K3 beside it does not)
    assert max(old) == max(new) == (128 if name == "bwd" else 132)


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


# K4's f32 dot at the sweep's shape (E80, T60, B32, H128): (rows, e_blk,
# t_blk, io dtype) -> bytes, or the reason the plan refuses it.  W_hh
# [H][3H+8] in the io dtype, the f32 carry tile [2][rows][132], and at
# t_blk > 1 a ring of t_blk x rows proj rows of 3H io elements + 16 bytes.
W_F32, W_BF16 = 128 * 392 * 4, 128 * 392 * 2


def _carry(rows):
    return 2 * rows * 132 * 4


def _ring(rows, t_blk, io):
    return t_blk * rows * (384 * io + 16)


K4_F32_DOT = [
    (8, 1, 1, F32, W_F32 + _carry(8)),
    (16, 1, 1, F32, W_F32 + _carry(16)),
    (32, 1, 1, F32, "bytes of shared memory"),
    (8, 1, 2, F32, "bytes of shared memory"),    # FMA took it: 229,376
    (8, 2, 1, F32, "bytes of shared memory"),
    (8, 1, 1, torch.bfloat16, W_BF16 + _carry(8)),
    (16, 1, 6, torch.bfloat16, W_BF16 + _carry(16) + _ring(16, 6, 2)),
    (32, 1, 1, torch.bfloat16, W_BF16 + _carry(32)),
    (8, 2, 1, torch.bfloat16, 2 * (W_BF16 + _carry(8))),
    (16, 2, 1, torch.bfloat16, "bytes of shared memory"),
    (24, 1, 1, torch.bfloat16, "rows must be 8, 16 or 32"),
]


@pytest.mark.parametrize("rows,e_blk,t_blk,dtype,want", K4_F32_DOT)
def test_blocked_f32_dot_layouts_and_waves(rows, e_blk, t_blk, dtype, want):
    plan = cuda_gru.block_plan(80, 60, 32, 128, dtype, training=False,
                               rows=rows, e_blk=e_blk, t_blk=t_blk,
                               blocked=True, bf16_dot=False)
    assert plan["binding"] == "fwd_blocked"
    # one warp per 8 units, K1's launch bound
    assert (plan["threads_per_cta"], plan["registers_cap"]) == (512, 96)
    if isinstance(want, str):
        assert not plan["fits"] and want in plan["refusal"], plan["refusal"]
        assert plan["ctas_per_sm"] == 0 and plan["waves"] is None
        return
    assert plan["fits"] and plan["refusal"] is None
    assert plan["smem_bytes"] == want == cuda_gru.fwd_blocked_smem_bytes(
        128, rows, e_blk, t_blk, dtype == torch.bfloat16, False)
    ctas = -(-32 // rows) * (80 // e_blk)
    assert (plan["ctas"], plan["ctas_per_sm"]) == (ctas, 1)
    assert plan["waves"] == -(-ctas // 132)
    if (rows, e_blk, t_blk, dtype) == (16, 1, 1, F32):
        # the new f32-io blocking: K1's bytes, 160 CTAs in 2 waves (the
        # FMA form's only f32-io blocking, (8, 1, 1), took 3)
        assert want == cuda_gru.fwd_smem_bytes(128, False) == 217_600
        assert plan["waves"] == 2


@pytest.mark.parametrize("h,reason", [
    (36, None), (132, None), (136, None),
    (6, "H % 4 == 0"), (140, "H <= 136")])
def test_blocked_f32_dot_hidden_sizes(h, reason):
    """K4's f32 dot takes H % 4 up to 136 threads-wise (the f32 W_hh then
    refuses above 128 at 8 rows); bf16 io with a ring takes H % 8."""
    plan = cuda_gru.block_plan(2, 6, 8, h, torch.bfloat16, training=False,
                               rows=8, blocked=True, bf16_dot=False)
    assert plan["refusal"] is None if reason is None else \
        reason in plan["refusal"]
    ring = cuda_gru.block_plan(2, 6, 8, h, torch.bfloat16, training=False,
                               rows=8, t_blk=2, blocked=True, bf16_dot=False)
    if reason is None:
        assert ring["fits"] == (h % 8 == 0)
        if h % 8:
            assert "H % 8 == 0" in ring["refusal"]


@pytest.mark.parametrize("reverse", [False, True])
def test_f64_recurrence_equals_the_plain_versions(reverse):
    """The f64 yardstick of the card's f32 measurements computes what the
    plain K1 and K2 compute: at a small shape on the CPU its h_all, h_prev
    and gates agree with the plain f32 versions to f32 rounding."""
    args = f32_kernels.recurrence_inputs((3, 7, 5, 12), seed=2,
                                         device="cpu")
    want = f32_kernels.recurrence_f64(*args, reverse=reverse,
                                      emit_prev=True)
    got = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
    assert torch.equal(f32_kernels.recurrence_f64(*args, reverse=reverse),
                       want[0])
    torch.testing.assert_close(
        cuda_gru.gru_recurrence_reference(*args, reverse=reverse),
        want[0].float(), rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("h_all", "h_prev", "gates"), got, want):
        assert w.dtype == torch.float64
        assert f32_kernels.scaled_error(g, w) < 1e-6, name


@pytest.mark.parametrize("threads,cap", [(544, 96), (512, 128), (256, 255),
                                         (128, 255)])
def test_register_cap_counts_the_fullest_partition(threads, cap):
    """ptxas's cap under __launch_bounds__(threads, 1) on the H100: the
    warps are dealt over 4 register partitions of 16,384, and the fullest
    one bounds a thread (K1 f32 and K2 f32 compile to 93 and 92 registers
    under the 96 of 544 threads; K4's f32-dot instantiations that need
    more spill at 96)."""
    assert cuda_gru._register_cap(threads) == cap
