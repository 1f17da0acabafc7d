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
    for entry in plan["kernels"].values():
        assert entry["rows_per_cta"] == 16 and entry["threads_per_cta"] == 256
        assert entry["ctas"] == 2 * g * 40
        assert entry["smem_limit"] == 232_448
        assert entry["ctas_per_sm"] >= 1
        assert entry["waves"] == -(-entry["ctas"] // (
            entry["ctas_per_sm"] * cuda_gru.H100_SMS))
    fwd = plan["kernels"]["fwd_train" if training else "fwd"]
    assert fwd["smem_bytes"] == (98_304 if bf16 else 196_608) + 16_384
    assert fwd["ctas_per_sm"] == (2 if bf16 else 1)
    if training:
        assert plan["smem_bytes"] == 128 * (384 * (2 if bf16 else 4) + 16) \
            + 16 * 384 * 4
        off = cuda_gru.block_plan(40, 60, 32 * g, 128, dtype, stash=False)
        assert off["smem_bytes"] == plan["smem_bytes"] + 16 * 128 * 4
        assert off["fits"]


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
    # the same blocking fits in bf16, W_hh 96 KiB each
    assert cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, rows=8, e_blk=2,
                               blocked=True)["fits"]
    # threads, rows, hidden sizes
    assert "H % 8" in cuda_gru.block_plan(2, 4, 4, 12, torch.float32,
                                          training=True)["refusal"]
    assert "rows must be" in cuda_gru.block_plan(
        2, 4, 4, 128, torch.float32, training=False, rows=12,
        blocked=True)["refusal"]
    assert "threads" in cuda_gru.block_plan(
        2, 4, 64, 128, torch.bfloat16, training=False, rows=64,
        blocked=True)["refusal"]
    with pytest.raises(ValueError, match="blocked=True"):
        cuda_gru.block_plan(40, 60, 32, 128, rows=16)
    with pytest.raises(ValueError, match="training=False"):
        cuda_gru.block_plan(40, 60, 32, 128, blocked=True)


def test_block_plan_blocked_defaults_and_waves():
    # all 32 rows (512 threads) by default; 8 rows give 320 CTAs at E80
    plan = cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, blocked=True)
    assert plan["binding"] == "fwd_blocked"
    assert (plan["rows_per_cta"], plan["threads_per_cta"]) == (32, 512)
    assert plan["ctas"] == 80
    eight = cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                                training=False, rows=8, blocked=True)
    assert eight["ctas"] == 320 and eight["ctas_per_sm"] == 2
    assert eight["waves"] == 2
    assert cuda_gru.block_plan(80, 60, 32, 128, torch.bfloat16,
                               training=False, rows=16,
                               blocked=True)["ctas"] == 160
    # the ragged batch rounds up to whole row groups, under the cap
    assert cuda_gru.default_blocked_rows(37, 128) == 32
    assert cuda_gru.default_blocked_rows(20, 128) == 24
    assert cuda_gru.default_blocked_rows(37, 64) == 40
    # a bf16 dot keeps W_hh in bf16 in shared memory, f32 inputs or not
    assert cuda_gru.fwd_blocked_smem_bytes(128, 8, 1, 1, False, True) \
        == 98_304 + 2 * 8 * 128 * 4 + 8 * 384 * 4
    # the plan's shared memory mirrors the K1 formula at K1's blocking
    assert cuda_gru.fwd_blocked_smem_bytes(128, 16, 1, 1, True, True) \
        == cuda_gru.fwd_smem_bytes(128, True) + 16 * 384 * 2


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
