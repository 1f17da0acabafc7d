"""The port's tuning path on the CPU: K4's plain version against the JAX
package's ``benchmarks/kernel_tuning.py::make_fwd_call`` (run in TPU
interpret mode), the Hopper block plan, and the CPU arm of the port's
sweep.

Tolerances are the JAX package's kernel tolerances
(tests/test_pallas_gru.py): 1e-5 with the f32 dot; 2e-2 with the bf16
dot, where a sum taken in another order can round h to the other bf16
neighbour and the difference then travels through the recurrence.
"""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeprest_tpu_torch.benchmarks import kernel_tuning
from deeprest_tpu_torch.ops import cuda_gru

jax_tuning = importlib.import_module("benchmarks.kernel_tuning")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, T, B, H = 8, 12, 16, 128
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(e=E, t=T, b=B, h=H, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    return (rng.standard_normal((e, t, b, 3 * h)).astype(np.float32),
            rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32),
            rng.uniform(-k, k, (e, 3 * h)).astype(np.float32),
            (0.5 * rng.standard_normal((e, b, h))).astype(np.float32))


def _jax_blocked(arrays, dtype, e_blk, t_blk, bf16_dot):
    proj, w_hh, b_hh, h0 = arrays
    jdt = DTYPES[dtype][1]
    with pltpu.force_tpu_interpret_mode():
        call = jax_tuning.make_fwd_call(e_blk, t_blk, bf16_dot=bf16_dot)
        return np.asarray(call(jnp.asarray(proj, jdt), jnp.asarray(w_hh, jdt),
                               jnp.asarray(b_hh), jnp.asarray(h0)))


def _port_blocked(arrays, dtype, e_blk, t_blk, bf16_dot):
    tdt = DTYPES[dtype][0]
    proj, w_hh, b_hh, h0 = arrays
    return cuda_gru.gru_fwd_blocked_reference(
        torch.from_numpy(proj).to(tdt), torch.from_numpy(w_hh).to(tdt),
        torch.from_numpy(b_hh), torch.from_numpy(h0), e_blk=e_blk,
        t_blk=t_blk, bf16_dot=bf16_dot)


@pytest.mark.parametrize("e_blk,t_blk", [(1, 1), (2, 6), (4, 3), (8, 12)])
@pytest.mark.parametrize("bf16_dot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_plain_matches_jax_make_fwd_call(dtype, bf16_dot, e_blk,
                                                 t_blk):
    arrays = _inputs(seed=e_blk + t_blk)
    want = _jax_blocked(arrays, dtype, e_blk, t_blk, bf16_dot)
    got = _port_blocked(arrays, dtype, e_blk, t_blk, bf16_dot)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape == (E, T, B, H)
    tol = 2e-2 if bf16_dot else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_blocked_plain_is_the_forward_recurrence():
    """K4 with the io dtype's own dot is K1 with an f32 output."""
    proj, w_hh, b_hh, h0 = (torch.from_numpy(a) for a in _inputs(seed=9))
    for dtype in (torch.float32, torch.bfloat16):
        args = (proj.to(dtype), w_hh.to(dtype), b_hh, h0)
        got = cuda_gru.gru_fwd_blocked_reference(
            *args, bf16_dot=dtype == torch.bfloat16)
        want = cuda_gru.gru_recurrence_reference(*args).float()
        tol = 1e-6 if dtype == torch.float32 else 8e-3   # want is rounded
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_both_refuse_a_time_block_that_does_not_divide_t():
    arrays = _inputs()
    with pytest.raises(AssertionError):
        _jax_blocked(arrays, "float32", 1, 5, False)
    with pytest.raises(ValueError, match="T % t_blk"):
        _port_blocked(arrays, "float32", 1, 5, False)


def test_expert_block_that_does_not_divide_e():
    """JAX falls back to the whole E as one block (80 W_hh tiles in one
    program at the fused stacking, which no SM holds); the port raises."""
    arrays = _inputs()
    want = _jax_blocked(arrays, "float32", 3, 1, False)
    np.testing.assert_allclose(
        _port_blocked(arrays, "float32", E, 1, False).numpy(), want,
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must divide E"):
        _port_blocked(arrays, "float32", 3, 1, False)
    with pytest.raises(ValueError, match="must divide E"):
        cuda_gru.block_plan(E, T, B, H, torch.float32, training=False,
                            e_blk=3, blocked=True)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
def test_block_plan_flagship_at_coalesced_rows(g, dtype, training):
    """The Hopper counterpart of test_block_plan_fat_rows_flagship: at the
    flagship E=40, T=60, H=128 every G fits (a CTA's bytes do not depend
    on the rows; the TPU's G=8 training overflowed VMEM), the CTAs grow
    with G, and K3 binds training."""
    plan = cuda_gru.block_plan(40, 60, 32 * g, 128, dtype, training=training)
    bf16 = dtype == torch.bfloat16
    assert plan["fits"] and plan["refusal"] is None
    assert set(plan["kernels"]) == ({"fwd_train", "bwd"} if training
                                    else {"fwd"})
    assert plan["binding"] == ("bwd" if training else "fwd")
    for name, entry in plan["kernels"].items():
        # the f32 K1 and K2 run one warp per 8 units, the others 2H threads
        assert entry["rows_per_cta"] == 16 and entry["threads_per_cta"] == (
            512 if not bf16 and name != "bwd" else 256)
        assert entry["ctas"] == 2 * g * 40
        assert entry["smem_limit"] == 232_448
        assert entry["ctas_per_sm"] >= 1
        assert entry["waves"] == -(-entry["ctas"] // (
            entry["ctas_per_sm"] * cuda_gru.H100_SMS))
    fwd = plan["kernels"]["fwd_train" if training else "fwd"]
    # bf16: W_hh [128][392] and the h tile [2][16][136], bf16; f32 K1 and
    # K2 (3xTF32): W_hh [128][392] and the carry tile [2][16][132], f32
    assert fwd["smem_bytes"] == (
        (128 * 392 + 2 * 16 * 136) * 2 if bf16
        else (128 * 392 + 2 * 16 * 132) * 4)
    assert fwd["ctas_per_sm"] == (2 if bf16 else 1)
    if training:
        # bf16: W_hh and the dgates tile [16][392], bf16; f32 (3xTF32):
        # W_hh and the dgates tile [16][388], f32
        assert plan["smem_bytes"] == ((128 + 16) * 392 * 2 if bf16 else
                                      (128 + 16) * 388 * 4)


def test_block_plan_bf16_training_fits_two_ctas_per_sm():
    """At the flagship the bf16 K2 and K3 CTAs (109,056 and 112,896 bytes)
    both fit twice in an SM's 233,472 bytes; K3's bytes are the same with
    the gate stash on or off (its recompute reads h_prev from global
    memory)."""
    plan = cuda_gru.block_plan(40, 60, 32, 128, torch.bfloat16,
                               training=True)
    fwd, bwd = plan["kernels"]["fwd_train"], plan["kernels"]["bwd"]
    assert (fwd["smem_bytes"], bwd["smem_bytes"]) == (109_056, 112_896)
    assert fwd["ctas_per_sm"] == bwd["ctas_per_sm"] == 2
    assert 2 * (bwd["smem_bytes"] + cuda_gru.SMEM_RESERVED_PER_CTA) \
        <= cuda_gru.SMEM_PER_SM_BYTES
    assert plan["binding"] == "bwd" and plan["waves"] == 1


@pytest.mark.parametrize("e,g,waves", [
    (40, 1, 1), (40, 2, 1), (40, 4, 2), (40, 8, 3),     # coalesced G
    (80, 1, 1), (80, 2, 2), (80, 4, 3), (80, 8, 5)])    # fused, coalesced
def test_block_plan_bf16_training_waves(e, g, waves):
    """2 x G x E CTAs at two CTAs an SM over 132 SMs."""
    plan = cuda_gru.block_plan(e, 60, 32 * g, 128, torch.bfloat16,
                               training=True)
    for entry in plan["kernels"].values():
        assert entry["ctas"] == 2 * g * e
        assert entry["ctas_per_sm"] == 2 and entry["waves"] == waves


@pytest.mark.parametrize("training", [True, False])
def test_block_plan_f32_entries_keep_the_fma_bytes(training):
    """K1, K2 and K3 in f32 run 3xTF32 with padded rows, K2 in K1's
    layout and bytes (the FMA K2 took 212,992 at H=128), K3's bytes the
    same with the stash on or off.  All hold one CTA an SM at H=128, so
    the fused E=80 training call takes twice the waves of E=40."""
    for e, waves in ((40, 1), (80, 2)):
        plan = cuda_gru.block_plan(e, 60, 32, 128, torch.float32,
                                   training=training)
        fwd = plan["kernels"]["fwd_train" if training else "fwd"]
        assert fwd["smem_bytes"] == 217_600
        assert (fwd["ctas_per_sm"], fwd["waves"]) == (1, waves)
        if training:
            assert plan["kernels"]["bwd"]["smem_bytes"] == 223_488
    assert cuda_gru.fwd_smem_bytes(72, False) == \
        72 * 224 * 4 + 2 * 16 * 76 * 4


@pytest.mark.parametrize("training", [True, False])
def test_block_plan_bf16_refuses_h_not_a_multiple_of_16(training):
    """bf16 K1-K3 run one warp per 16 hidden units: H=72 is refused with a
    reason that names 16 (never sent to an FMA kernel), while f32 H=72 and
    the bf16 K4 at H=72 with the f32 dot (3xTF32 in warps of 8 units)
    still fit; K4's bf16 dot refuses H=72 too."""
    plan = cuda_gru.block_plan(2, 4, 8, 72, torch.bfloat16,
                               training=training)
    assert not plan["fits"]
    for entry in plan["kernels"].values():
        assert not entry["fits"]
        assert "H % 16" in entry["refusal"] and "H=72" in entry["refusal"]
        assert entry["ctas_per_sm"] == 0 and entry["waves"] is None
    assert cuda_gru.block_plan(2, 4, 8, 72, torch.float32,
                               training=training)["fits"]
    for h in (64, 96):
        assert cuda_gru.block_plan(2, 4, 8, h, torch.bfloat16,
                                   training=training)["fits"]
    if not training:
        assert cuda_gru.block_plan(2, 4, 8, 72, torch.bfloat16,
                                   training=False, blocked=True,
                                   bf16_dot=False)["fits"]
        k4 = cuda_gru.block_plan(2, 4, 8, 72, torch.bfloat16,
                                 training=False, blocked=True)
        assert not k4["fits"] and "H % 16" in k4["refusal"]


def test_block_plan_refusals():
    # H=256 in f32: W_hh alone is 768 KiB
    for training in (True, False):
        plan = cuda_gru.block_plan(40, 60, 32, 256, torch.float32,
                                   training=training)
        assert not plan["fits"]
        assert "bytes of shared memory" in plan["refusal"]
    # K4 at e_blk=2 in f32 at H=128: two 192 KiB W_hh tiles
    plan = cuda_gru.block_plan(80, 60, 32, 128, torch.float32,
                               training=False, rows=8, e_blk=2,
                               blocked=True)
    assert not plan["fits"] and "bytes of shared memory" in plan["refusal"]
    # the same blocking fits in bf16 with the f32 dot (3xTF32, W_hh 98 KiB
    # each); the bf16 dot takes whole m16 tiles, so 8 rows are refused
    assert cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, rows=8, e_blk=2,
                               blocked=True, bf16_dot=False)["fits"]
    assert "rows in (16, 32)" in cuda_gru.block_plan(
        80, 60, 32, 128, torch.bfloat16, training=False, rows=8, e_blk=2,
        blocked=True)["refusal"]
    # threads, rows, hidden sizes
    assert "H % 8" in cuda_gru.block_plan(2, 4, 4, 12, torch.float32,
                                          training=True)["refusal"]
    assert "rows must be" in cuda_gru.block_plan(
        2, 4, 4, 128, torch.float32, training=False, rows=12,
        blocked=True)["refusal"]
    assert "threads" in cuda_gru.block_plan(
        2, 4, 16, 144, torch.bfloat16, training=False, rows=16,
        blocked=True, bf16_dot=False)["refusal"]
    assert "threads (H <= 128)" in cuda_gru.block_plan(
        2, 4, 16, 144, torch.bfloat16, training=False, rows=16,
        blocked=True)["refusal"]
    with pytest.raises(ValueError, match="blocked=True"):
        cuda_gru.block_plan(40, 60, 32, 128, rows=16)
    with pytest.raises(ValueError, match="training=False"):
        cuda_gru.block_plan(40, 60, 32, 128, blocked=True)


def test_block_plan_blocked_defaults_and_waves():
    # all 32 rows by default: two m16 tiles on H/16 = 8 warps with the
    # bf16 dot; 8 rows with the f32 dot (half an m16 tile on 16 warps of 8
    # units, one CTA an SM) give 320 CTAs at E80, 3 waves
    plan = cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, blocked=True)
    assert plan["binding"] == "fwd_blocked"
    assert (plan["rows_per_cta"], plan["threads_per_cta"]) == (32, 256)
    assert plan["ctas"] == 80
    eight = cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                                training=False, rows=8, blocked=True,
                                bf16_dot=False)
    assert eight["ctas"] == 320 and eight["ctas_per_sm"] == 1
    assert eight["waves"] == 3
    assert cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, rows=16,
                               blocked=True)["ctas"] == 160
    # the ragged batch rounds up to whole m16 tiles, at most two, or with
    # the f32 dot to half a tile when it holds 8 rows or fewer
    assert cuda_gru.default_blocked_rows(37) == 32
    assert cuda_gru.default_blocked_rows(20) == 32
    assert cuda_gru.default_blocked_rows(9) == 16
    assert cuda_gru.default_blocked_rows(5) == 8
    assert cuda_gru.default_blocked_rows(20, bf16_dot=True) == 32
    assert cuda_gru.default_blocked_rows(9, bf16_dot=True) == 16
    assert cuda_gru.default_blocked_rows(5, bf16_dot=True) == 16
    assert cuda_gru.default_blocked_rows(37, bf16_dot=True) == 32
    # the bf16 dot keeps W_hh and the h tile in bf16 with 16-byte row pads,
    # f32 inputs or not; at t_blk = 1 proj goes to registers, so at K1's
    # blocking K4 needs K1's bytes
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 1, False, True) \
        == 128 * 392 * 2 + 2 * 16 * 136 * 2 == 109_056
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 1, True, True) \
        == cuda_gru.fwd_smem_bytes(128, True)
    # t_blk > 1: a ring of t_blk proj steps, rows padded by 16 bytes
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 6, True, True) \
        == 109_056 + 6 * 16 * (384 * 2 + 16)
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 2, False, True) \
        == 109_056 + 2 * 16 * (384 * 4 + 16)
    # the f32 dot takes the layout of the f32 K1 and K2 (W_hh rows of 3H +
    # 8 in the io dtype, the f32 carry tile of rows of 132 floats); at K1's
    # blocking, f32 io, it needs K1's bytes
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 1, False, False) \
        == cuda_gru.fwd_smem_bytes(128, False) == 217_600
    assert cuda_gru.fwd_blocked_smem_bytes(128, 8, 1, 1, True, False) \
        == 128 * 392 * 2 + 2 * 8 * 132 * 4


@pytest.mark.parametrize("rows,e_blk,smem,ctas,per_sm,waves", [
    (16, 1, 109_056, 160, 2, 1),     # K1's blocking: one wave
    (16, 2, 218_112, 80, 1, 1),      # two experts a CTA
    (32, 1, 117_760, 80, 1, 1)])     # two m16 tiles a CTA
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_plan_blocked_bf16_dot_fits_hopper(dtype, rows, e_blk, smem,
                                                 ctas, per_sm, waves):
    """At E80, B32, H128 the tensor-core K4 (bf16 W_hh and h tile, proj in
    registers at t_blk = 1) needs the same bytes for f32 and bf16 inputs:
    K1's blocking keeps its second CTA per SM."""
    plan = cuda_gru.block_plan(80, 60, 32, 128, dtype, training=False,
                               rows=rows, e_blk=e_blk, blocked=True,
                               bf16_dot=True)
    assert plan["fits"] and plan["refusal"] is None
    assert plan["threads_per_cta"] == 256
    assert (plan["smem_bytes"], plan["ctas"], plan["ctas_per_sm"],
            plan["waves"]) == (smem, ctas, per_sm, waves)


@pytest.mark.parametrize("h", [72, 24, 136])
def test_block_plan_blocked_bf16_dot_refuses_h(h):
    """One warp per 16 hidden units, at most 8 warps: H % 16 and H > 128
    are refused with the bf16 dot, whatever the io dtype, before any
    launch; the f32 dot (3xTF32, one warp per 8 units) takes them (at
    H=136 in bf16 only: the padded f32 W_hh alone is 226,304 bytes)."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = cuda_gru.block_plan(2, 4, 16, h, dtype, training=False,
                                   rows=16, blocked=True, bf16_dot=True)
        assert not plan["fits"] and plan["ctas_per_sm"] == 0
        assert ("H % 16" if h % 16 else "H <= 128") in plan["refusal"]
        assert f"H={h}" in plan["refusal"]
        assert cuda_gru.block_plan(2, 4, 16, h, dtype, training=False,
                                   rows=8, blocked=True,
                                   bf16_dot=False)["fits"] == (
            dtype == torch.bfloat16 or h < 128)


@pytest.mark.parametrize("rows,e_blk,t_blk", [
    (8, 1, 1), (8, 2, 1), (16, 1, 2), (32, 1, 1), (8, 4, 3), (16, 1, 6)])
@pytest.mark.parametrize("io_bf16", [False, True])
@pytest.mark.parametrize("h", [64, 96, 128])
def test_block_plan_blocked_f32_dot_keeps_fma_bytes(h, io_bf16, rows, e_blk,
                                                    t_blk):
    """The f32-dot form takes the layout of the f32 K1: per expert W_hh
    in the io dtype with rows of 3H + 8, the double-buffered f32 carry
    tile with rows of H rounded up to 8, plus 4, and for t_blk > 1 a ring
    of t_blk steps of proj rows padded by 16 bytes; one warp per 8
    units."""
    io = 2 if io_bf16 else 4
    ring = t_blk * rows * (3 * h * io + 16) if t_blk > 1 else 0
    want = e_blk * (h * (3 * h + 8) * io + 2 * rows * (h + 4) * 4 + ring)
    assert cuda_gru.fwd_blocked_smem_bytes(h, rows, e_blk, t_blk, io_bf16,
                                           False) == want
    plan = cuda_gru.block_plan(4 * e_blk, 6 * t_blk, 37, h,
                               torch.bfloat16 if io_bf16 else torch.float32,
                               training=False, rows=rows, e_blk=e_blk,
                               t_blk=t_blk, blocked=True, bf16_dot=False)
    assert plan["smem_bytes"] == want
    assert plan["threads_per_cta"] == 32 * h // 8


QUICK_BF16_DOT_ADMITTED = {(32, 1, 1), (16, 1, 1), (16, 1, 6), (16, 2, 1)}
QUICK_F32_IO_BF16_DOT_ADMITTED = {(32, 1, 1), (16, 1, 1), (16, 2, 1)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quick_menu_bf16_dot_admissions(dtype):
    """Which blockings of the sweep's --quick menu at E80, B32, H128 the
    plan admits with the bf16 dot, and why it refuses the rest: 8 rows
    are not a whole m16 tile; the others need more than one CTA's shared
    memory (two experts of 32 rows, or a proj ring beside them)."""
    menu = kernel_tuning.blocking_menu(80, 60, 32, 128, quick=True)
    want = (QUICK_BF16_DOT_ADMITTED if dtype == torch.bfloat16
            else QUICK_F32_IO_BF16_DOT_ADMITTED)
    admitted = set()
    for rows, e_blk, t_blk in menu:
        plan = cuda_gru.block_plan(80, 60, 32, 128, dtype, training=False,
                                   rows=rows, e_blk=e_blk, t_blk=t_blk,
                                   blocked=True, bf16_dot=True)
        if plan["fits"]:
            admitted.add((rows, e_blk, t_blk))
        elif rows == 8:
            assert "rows in (16, 32)" in plan["refusal"]
        else:
            assert "bytes of shared memory" in plan["refusal"]
            assert plan["smem_bytes"] > cuda_gru.SMEM_OPTIN_BYTES
    assert admitted == want
    assert any(e_blk == 2 for _, e_blk, _ in admitted)
    k1 = cuda_gru.block_plan(80, 60, 32, 128, dtype, training=False,
                             rows=16, blocked=True, bf16_dot=True)
    assert (k1["ctas_per_sm"], k1["waves"]) == (2, 1)


def test_blocking_menu_keeps_the_contract():
    for quick in (True, False):
        for e, t, b in ((80, 60, 32), (4, 12, 37), (3, 7, 5)):
            menu = kernel_tuning.blocking_menu(e, t, b, 128, quick)
            assert menu and len(set(menu)) == len(menu)
            assert all(e % eb == 0 and t % tb == 0 and r % 8 == 0
                       for r, eb, tb in menu)
    quick = kernel_tuning.blocking_menu(80, 60, 32, 128, True)
    assert (16, 1, 1) in quick and (32, 1, 1) in quick and (8, 2, 6) in quick


def test_cpu_arm_emits_sound_json(tmp_path):
    out = tmp_path / "tuning.json"
    results = kernel_tuning.main(["--device", "cpu", "--quick", "--out",
                                  str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert results["platform"] == "cpu" and "CPU" in results["note"]
    assert results["failures"] == []
    assert "no counterpart" in results["loop_order"]
    bidir = results["bidir"]
    for key in ("unfused_bidir", "fused_bidir"):
        assert bidir[key]["max_err_vs_plain"] <= 1e-5
        assert bidir[key]["ms"] > 0
    coal = results["coalesce_plain"]
    for g in (1, 2, 4, 8):
        entry = coal[f"G{g}"]
        assert entry["microbatch_steps_per_sec"] > 0
        assert entry["recurrence_rows"] == g * coal["shape"]["B"]
        assert (g == 1) == ("speedup_vs_g1" not in entry)
    table = results["block_plan"]
    assert len(table) == 16
    assert table["G8_bf16_train"]["fits"] and table["G8_f32_train"]["fits"]
    assert table["G8_bf16_train"]["bwd"]["ctas"] == 640


def test_sweep_refuses_to_start_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch.benchmarks.kernel_tuning",
         "--quick"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
