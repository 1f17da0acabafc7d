"""The CUDA GRU kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; on a machine without CUDA every test
here skips.  Run on the card (the repository's conftest imports JAX, which
the GPU machine does not have, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_gru.py

Tolerances are the JAX package's own kernel tolerances
(tests/test_pallas_gru.py): forward 1e-5 in float32, 2e-2 relative in
bfloat16; gradients 2e-4 (float32) and 2e-2 (bfloat16) relative to each
tensor's largest magnitude, since the kernels sum in another order than the
plain versions.  Every float32 kernel (K1, K2, K3 and K4's f32 dot) runs
3xTF32 on the tensor cores; each is also held against an f64 run of the
plain recurrence.
"""

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.benchmarks import f32_kernels, kernel_tuning
from deeprest_tpu_torch.ops import cuda_gru

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# flagship training (E=40, T=60, B=32, H=128), a ragged shape, and ragged
# shapes at H=96 (6 warps) and H=64 (4 warps) for the bf16 tensor-core
# kernels' warp-per-16-units layout
NEW_H_SHAPES = [(3, 7, 37, 96), (2, 5, 21, 64)]
TRAIN_SHAPES = [(40, 60, 32, 128), (3, 7, 37, 128)] + NEW_H_SHAPES
# the main paths' f32 shapes: the stream's fine-tune (E=88, B=32) and the
# verdict sweeps' smallest rung (B=8); and H=40, where the f32 tensor-core
# forms run a last warp with units past H (the bf16 forms refuse it)
MAIN_PATH_SHAPES = [(88, 60, 32, 128), (88, 60, 8, 128)]
F32_ONLY_SHAPES = [(3, 7, 37, 40)]
# f32 K1 and K2 take H % 4: at H % 8 == 4 their last k step is half past H
F32_FORWARD_ONLY_SHAPES = [(3, 7, 37, 36), (2, 4, 9, 132)]
BOTH = (torch.float32, torch.bfloat16)


def _shapes_and_dtypes(shapes):
    return ([(s, d) for s in shapes + MAIN_PATH_SHAPES for d in BOTH]
            + [(s, torch.float32) for s in F32_ONLY_SHAPES])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(e, t, b, h, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(h)
    proj = rng.standard_normal((e, t, b, 3 * h)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (e, h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-k, k, (e, 3 * h)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((e, b, h))).astype(np.float32)
    return (torch.from_numpy(proj).to(device, dtype),
            torch.from_numpy(w_hh).to(device, dtype),
            torch.from_numpy(b_hh).to(device),
            torch.from_numpy(h0).to(device))


def _close_to_scale(got, want, tol, what):
    got, want = got.float(), want.float()
    scale = float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", _shapes_and_dtypes(
    [(3, 7, 37, 128), (40, 60, 256, 128), (2, 1, 1, 64)] + NEW_H_SHAPES)
    + [(s, torch.float32) for s in F32_FORWARD_ONLY_SHAPES])
def test_kernel_matches_plain(cuda, shape, reverse, dtype):
    args = _inputs(*shape, dtype, cuda)
    before = cuda_gru.GRU_FWD.launches
    got = cuda_gru.gru_fwd_cuda(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.GRU_FWD.launches == before + 1
    want = cuda_gru.gru_recurrence_reference(*args, reverse=reverse)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", _shapes_and_dtypes(TRAIN_SHAPES)
                         + [(s, torch.float32)
                            for s in F32_FORWARD_ONLY_SHAPES])
def test_train_forward_matches_plain(cuda, shape, reverse, dtype):
    args = _inputs(*shape, dtype, cuda, seed=1)
    before = cuda_gru.GRU_FWD_TRAIN.launches
    got = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.GRU_FWD_TRAIN.launches == before + 1
    want = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
    for name, g, w in zip(("h_all", "h_prev", "gates"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype],
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", _shapes_and_dtypes(TRAIN_SHAPES))
def test_backward_matches_plain(cuda, shape, reverse, dtype, stash):
    proj, w_hh, b_hh, h0 = _inputs(*shape, dtype, cuda, seed=2)
    _, h_prev, gates = cuda_gru.gru_fwd_train_reference(proj, w_hh, b_hh, h0,
                                                        reverse)
    gates = gates if stash else None
    dout = torch.randn(h_prev.shape, generator=torch.Generator(
        cuda).manual_seed(3), device=cuda).to(dtype)
    before = cuda_gru.GRU_BWD.launches
    got = cuda_gru.gru_bwd_cuda(proj, h_prev, gates, w_hh, b_hh, dout,
                                reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_gru.GRU_BWD.launches == before + 1
    want = cuda_gru.gru_bwd_reference(proj, h_prev, gates, w_hh, b_hh, dout,
                                      reverse=reverse)
    for name, g, w in zip(("dproj", "dW_hh", "db_hh", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _close_to_scale(g, w, GRAD_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_is_deterministic(cuda, dtype):
    proj, w_hh, b_hh, h0 = _inputs(40, 60, 32, 128, dtype, cuda)
    _, h_prev, gates = cuda_gru.gru_fwd_train_cuda(proj, w_hh, b_hh, h0)
    dout = torch.ones_like(h_prev)
    for stash in (gates, None):     # the tensor-core K3, both forms
        first = cuda_gru.gru_bwd_cuda(proj, h_prev, stash, w_hh, b_hh, dout)
        again = cuda_gru.gru_bwd_cuda(proj, h_prev, stash, w_hh, b_hh, dout)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _within_f64(got, plain, want, what):
    """``got`` within 4x the plain f32 version's distance from the f64
    recurrence (cuBLAS f32 products) and under 1e-5 of scale."""
    err = f32_kernels.scaled_error(got, want)
    bound = min(1e-5, 4 * f32_kernels.scaled_error(plain, want))
    assert err <= bound, (what, err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(40, 60, 32, 128), (88, 60, 32, 128),
                                   (88, 60, 8, 128), (3, 7, 37, 40)])
def test_f32_kernels_against_an_f64_recurrence(cuda, shape, reverse):
    """The 3xTF32 K1, K2 (h_all, h_prev and gates), K3 and, forward, K4's
    f32 dot at every f32 blocking of the sweep's --quick menu the plan
    admits, against the plain recurrence run in f64 on the same f32
    inputs."""
    args = f32_kernels.recurrence_inputs(shape, seed=6)
    want, want_prev, want_gates = f32_kernels.recurrence_f64(
        *args, reverse=reverse, emit_prev=True)
    _within_f64(cuda_gru.gru_fwd_cuda(*args, reverse=reverse),
                cuda_gru.gru_recurrence_reference(*args, reverse=reverse),
                want, "K1 h_all")
    got = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
    plain = cuda_gru.gru_fwd_train_reference(*args, reverse=reverse)
    for name, g, p, w in zip(("h_all", "h_prev", "gates"), got, plain,
                             (want, want_prev, want_gates)):
        _within_f64(g, p, w, f"K2 {name}")
    if not reverse:             # K4 runs forward only
        e, t, b, h = shape
        blocked = 0
        for rows, e_blk, t_blk in kernel_tuning.blocking_menu(e, t, b, h,
                                                              quick=True):
            if not cuda_gru.block_plan(e, t, b, h, torch.float32,
                                       training=False, rows=rows,
                                       e_blk=e_blk, t_blk=t_blk, blocked=True,
                                       bf16_dot=False)["fits"]:
                continue
            blocked += 1
            _within_f64(cuda_gru.gru_fwd_blocked_cuda(
                *args, e_blk=e_blk, t_blk=t_blk, rows=rows),
                plain[0], want, f"K4 {(rows, e_blk, t_blk)}")
        assert blocked > 0
    proj, w_hh, b_hh, h0 = args
    _, h_prev, gates = plain
    dout = torch.randn(h_prev.shape, generator=torch.Generator(
        cuda).manual_seed(7), device=cuda)
    for stash in (gates, None):
        bwd_in = (proj, h_prev, stash, w_hh, b_hh, dout)
        want_b = f32_kernels.bwd_f64(*bwd_in, reverse=reverse)
        got_b = cuda_gru.gru_bwd_cuda(*bwd_in, reverse=reverse)
        plain_b = cuda_gru.gru_bwd_reference(*bwd_in, reverse=reverse)
        for name, g, p, w in zip(("dproj", "dW_hh", "db_hh", "dh0"), got_b,
                                 plain_b, want_b):
            _within_f64(g, p, w, (name, stash is not None))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_f32_forwards_repeat_their_bits(cuda, reverse):
    """K2 and K4's f32 dot give the same bits on a second run (a captured
    update equals an eager one, and a resumed run the uninterrupted one,
    only if they do); K4 at one and two m16 tiles, half a tile, and with
    the cp.async ring in bf16 io."""
    args = f32_kernels.recurrence_inputs((40, 60, 32, 128), seed=8)
    first = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
    again = cuda_gru.gru_fwd_train_cuda(*args, reverse=reverse)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    if reverse:
        return
    bf16 = (args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)) + args[2:]
    for inputs, rows, t_blk in ((args, 8, 1), (args, 16, 1), (bf16, 32, 1),
                                (bf16, 16, 6)):
        runs = [cuda_gru.gru_fwd_blocked_cuda(*inputs, t_blk=t_blk, rows=rows)
                for _ in range(2)]
        assert torch.equal(*runs), (rows, t_blk, inputs[0].dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", _shapes_and_dtypes(TRAIN_SHAPES))
def test_function_grads_match_autograd_through_plain(cuda, shape, reverse,
                                                     dtype):
    base = _inputs(*shape, dtype, cuda, seed=4)
    cot = torch.randn(shape[:3] + (shape[3],), generator=torch.Generator(
        cuda).manual_seed(5), device=cuda)

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in base]
        out = fn(*leaves, reverse)
        (out.float() * cot).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    counts = [k.launches for k in cuda_gru.KERNELS]
    out, got = grads(cuda_gru.gru_recurrence)
    assert [k.launches for k in cuda_gru.KERNELS] == [
        counts[0], counts[1] + 1, counts[2] + 1, counts[3]]
    ref_out, want = grads(cuda_gru.gru_recurrence_reference)
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    for name, g, w in zip(("dproj", "dW_hh", "db_hh", "dh0"), got, want):
        assert g.dtype == w.dtype, name
        _close_to_scale(g, w, GRAD_TOL[dtype], name)


@pytest.mark.cuda
def test_kernel_refuses_what_does_not_fit(cuda):
    # f32 W_hh at H=256 is 768 KiB: far above one CTA's shared memory.
    args = _inputs(1, 2, 4, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_gru.gru_fwd_cuda(*args)
    proj, w_hh, b_hh, h0 = args
    h_prev = torch.zeros_like(h0)[:, None].expand(1, 2, 4, 256).contiguous()
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_gru.gru_bwd_cuda(proj, h_prev, None, w_hh, b_hh, h_prev)
    bad = list(_inputs(1, 2, 4, 128, torch.float32, cuda))
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="w_hh"):
        cuda_gru.gru_fwd_cuda(*bad)
    odd = _inputs(1, 2, 4, 12, torch.float32, cuda)
    h_prev = torch.zeros((1, 2, 4, 12), device=cuda)
    with pytest.raises(ValueError, match="H % 8"):
        cuda_gru.gru_bwd_cuda(odd[0], h_prev, None, odd[1], odd[2], h_prev)
    # bf16 runs only on the tensor cores: H=72 is refused, never run on FMA
    before = [k.launches for k in cuda_gru.KERNELS]
    proj, w_hh, b_hh, h0 = _inputs(1, 2, 4, 72, torch.bfloat16, cuda)
    h_prev = torch.zeros((1, 2, 4, 72), device=cuda, dtype=torch.bfloat16)
    for call in (lambda: cuda_gru.gru_fwd_cuda(proj, w_hh, b_hh, h0),
                 lambda: cuda_gru.gru_fwd_train_cuda(proj, w_hh, b_hh, h0),
                 lambda: cuda_gru.gru_bwd_cuda(proj, h_prev, None, w_hh,
                                               b_hh, h_prev)):
        with pytest.raises(ValueError, match="H % 16"):
            call()
    assert [k.launches for k in cuda_gru.KERNELS] == before


@pytest.mark.cuda
def test_dispatch_launches_kernel_on_cuda(cuda):
    args = _inputs(2, 3, 5, 128, torch.float32, cuda)
    before = [k.launches for k in cuda_gru.KERNELS]
    cuda_gru.gru_recurrence(*args)
    with torch.no_grad():
        w = args[1].clone().requires_grad_(True)
        cuda_gru.gru_recurrence(args[0], w, *args[2:])
    assert [k.launches for k in cuda_gru.KERNELS] == [
        before[0] + 2, before[1], before[2], before[3]]


# ---------------------------------------------------------------------------
# K4, the block plan, the gate stash and the fused bidirectional launch
# ---------------------------------------------------------------------------

# the fused flagship stacking (both directions, E=80), a ragged shape, and
# ragged shapes at H=96 (6 warps) and H=64 (4 warps) for the bf16-dot
# tensor-core form, whose last m16 tile then holds masked rows
BLOCKED_SHAPES = [(80, 60, 32, 128), (4, 12, 37, 128), (4, 12, 37, 96),
                  (2, 6, 21, 64)]
BLOCKED_MENU = [(rows, e_blk, t_blk) for rows in (None, 32, 16, 8)
                for e_blk in (1, 2, 4) for t_blk in (1, 2, 6, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dot", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_blocked_matches_plain_at_every_admitted_blocking(cuda, shape, dtype,
                                                          bf16_dot):
    e, t, b, h = shape
    args = _inputs(*shape, dtype, cuda, seed=6)
    want = cuda_gru.gru_fwd_blocked_reference(*args, bf16_dot=bf16_dot)
    assert want.dtype == torch.float32
    tol = TOL[torch.bfloat16 if bf16_dot else torch.float32]
    admitted = 0
    for rows, e_blk, t_blk in BLOCKED_MENU:
        if e % e_blk or t % t_blk:
            continue
        plan = cuda_gru.block_plan(e, t, b, h, dtype, training=False,
                                   rows=rows, e_blk=e_blk, t_blk=t_blk,
                                   blocked=True, bf16_dot=bf16_dot)
        if not plan["fits"]:
            continue
        admitted += 1
        before = cuda_gru.GRU_FWD_BLOCKED.launches
        got = cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                            bf16_dot=bf16_dot, rows=rows)
        torch.cuda.synchronize()
        assert cuda_gru.GRU_FWD_BLOCKED.launches == before + 1
        torch.testing.assert_close(
            got, want, **tol,
            msg=lambda m, k=(rows, e_blk, t_blk): f"blocking {k}: {m}")
    assert admitted > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_bf16_dot_is_deterministic(cuda, dtype):
    """Two launches of the tensor-core K4 give the same bits, one and two
    experts a CTA, registers and the cp.async ring (t_blk 6)."""
    args = _inputs(80, 60, 32, 128, dtype, cuda, seed=10)
    for rows, e_blk, t_blk in ((16, 1, 1), (16, 2, 1), (32, 1, 1),
                               (16, 1, 6)):
        if not cuda_gru.block_plan(80, 60, 32, 128, dtype, training=False,
                                   rows=rows, e_blk=e_blk, t_blk=t_blk,
                                   blocked=True, bf16_dot=True)["fits"]:
            continue
        first = cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                              bf16_dot=True, rows=rows)
        again = cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=e_blk, t_blk=t_blk,
                                              bf16_dot=True, rows=rows)
        assert torch.equal(first, again), (rows, e_blk, t_blk)


@pytest.mark.cuda
def test_plan_bytes_equal_the_sources(cuda):
    fwd = cuda_gru.GRU_FWD_SOURCE.library()
    bwd = cuda_gru.GRU_BWD_SOURCE.library()
    blk = cuda_gru.GRU_FWD_BLOCKED_SOURCE.library()
    assert fwd.gru_fwd_row_groups() == cuda_gru.ROW_GROUPS
    assert bwd.gru_bwd_row_tile() == cuda_gru.ROW_TILE
    assert fwd.gru_fwd_max_threads() == bwd.gru_bwd_max_threads() \
        == cuda_gru.MAX_THREADS
    assert fwd.gru_fwd_tf32_max_threads() == \
        blk.gru_fwd_blocked_tf32_max_threads() == cuda_gru.TF32_FWD_MAX_THREADS
    assert bwd.gru_bwd_tf32_max_threads() == cuda_gru.TF32_BWD_MAX_THREADS
    assert blk.gru_fwd_blocked_mma_max_threads() == \
        cuda_gru.BLOCKED_MMA_MAX_THREADS
    for h in (12, 40, 64, 72, 96, 128, 132, 256):
        for bf16 in (0, 1):
            assert fwd.gru_fwd_smem_bytes(h, bf16) == \
                cuda_gru.fwd_smem_bytes(h, bool(bf16))
            assert bwd.gru_bwd_smem_bytes(h, bf16) == \
                cuda_gru.bwd_smem_bytes(h, bool(bf16))
            for rows, e_blk, t_blk in BLOCKED_MENU:
                rows = rows or 32
                for dot in (0, 1):
                    assert blk.gru_fwd_blocked_smem_bytes(
                        h, rows, e_blk, t_blk, bf16, dot) == \
                        cuda_gru.fwd_blocked_smem_bytes(
                            h, rows, e_blk, t_blk, bool(bf16), bool(dot))


@pytest.mark.cuda
def test_every_wrapper_refuses_what_the_plan_refuses_without_launching(cuda):
    before = [k.launches for k in cuda_gru.KERNELS]
    # H=256 f32: W_hh alone is 768 KiB
    proj, w_hh, b_hh, h0 = _inputs(2, 6, 8, 256, torch.float32, cuda)
    h_prev = torch.zeros((2, 6, 8, 256), device=cuda)
    for call in (lambda: cuda_gru.gru_fwd_cuda(proj, w_hh, b_hh, h0),
                 lambda: cuda_gru.gru_fwd_train_cuda(proj, w_hh, b_hh, h0),
                 lambda: cuda_gru.gru_bwd_cuda(proj, h_prev, None, w_hh,
                                               b_hh, h_prev)):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            call()
    # K4's f32 dot runs one warp per 8 units: H=256 needs 32 warps
    with pytest.raises(ValueError, match="threads"):
        cuda_gru.gru_fwd_blocked_cuda(proj, w_hh, b_hh, h0, rows=8)
    # e_blk=2 f32 at H=128: two 192 KiB W_hh tiles
    args = _inputs(2, 6, 8, 128, torch.float32, cuda)
    assert not cuda_gru.block_plan(2, 6, 8, 128, torch.float32,
                                   training=False, rows=8, e_blk=2,
                                   blocked=True)["fits"]
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=2, rows=8)
    with pytest.raises(ValueError, match="rows must be"):
        cuda_gru.gru_fwd_blocked_cuda(*args, rows=12)
    # f32 io with the f32 dot: a 2-step ring of 8 rows does not fit beside
    # the padded f32 W_hh (the FMA form took it)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_gru.gru_fwd_blocked_cuda(*args, rows=8, t_blk=2)
    with pytest.raises(ValueError, match="T % t_blk"):
        cuda_gru.gru_fwd_blocked_cuda(*args, t_blk=4)
    with pytest.raises(ValueError, match="must divide E"):
        cuda_gru.gru_fwd_blocked_cuda(*args, e_blk=4)
    # the bf16 dot runs only on the tensor cores: whole m16 tiles of rows,
    # H % 16, and two 32-row experts do not fit
    with pytest.raises(ValueError, match=r"rows in \(16, 32\)"):
        cuda_gru.gru_fwd_blocked_cuda(*args, rows=8, bf16_dot=True)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_gru.gru_fwd_blocked_cuda(*args, rows=32, e_blk=2, bf16_dot=True)
    odd = _inputs(2, 6, 8, 72, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="H % 16"):
        cuda_gru.gru_fwd_blocked_cuda(*odd, bf16_dot=True)
    assert [k.launches for k in cuda_gru.KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stash_off_writes_no_gates_and_backward_recomputes(cuda, dtype,
                                                          monkeypatch):
    proj, w_hh, b_hh, h0 = _inputs(40, 60, 32, 128, dtype, cuda, seed=7)
    h_all, h_prev, gates = cuda_gru.gru_fwd_train_cuda(proj, w_hh, b_hh, h0)
    assert gates is not None
    monkeypatch.setattr(cuda_gru, "STASH_GATES", False)
    h_off, prev_off, gates_off = cuda_gru.gru_fwd_train_cuda(proj, w_hh,
                                                             b_hh, h0)
    assert gates_off is None
    assert torch.equal(h_all, h_off) and torch.equal(h_prev, prev_off)
    dout = torch.randn(h_all.shape, generator=torch.Generator(
        cuda).manual_seed(8), device=cuda).to(dtype)
    on = cuda_gru.gru_bwd_cuda(proj, h_prev, gates, w_hh, b_hh, dout)
    off = cuda_gru.gru_bwd_cuda(proj, h_prev, None, w_hh, b_hh, dout)
    for name, g, w in zip(("dproj", "dW_hh", "db_hh", "dh0"), off, on):
        _close_to_scale(g, w, GRAD_TOL[dtype], name)
    # the Function saves no gates and its backward takes the recompute
    leaves = [x.clone().requires_grad_(True) for x in (proj, w_hh, b_hh, h0)]
    out = cuda_gru.gru_recurrence(*leaves)
    assert out.grad_fn.saved_tensors[-1] is None
    (out.float() * dout.float()).sum().backward()
    for name, leaf, w in zip(("dproj", "dW_hh", "db_hh", "dh0"), leaves, on):
        _close_to_scale(leaf.grad, w, GRAD_TOL[dtype], name)


@pytest.mark.cuda
def test_fused_bidirectional_forward_makes_one_launch(cuda, monkeypatch):
    import importlib

    from deeprest_tpu_torch.ops.gru import GRUParams

    gru_mod = importlib.import_module("deeprest_tpu_torch.ops.gru")
    rng = np.random.default_rng(9)
    k = 1.0 / np.sqrt(128)

    def params():
        return GRUParams(*[
            torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32)).to(
                cuda, torch.bfloat16)
            for s in ((40, 64, 384), (40, 128, 384), (40, 384), (40, 384))])

    fwd, bwd = params(), params()
    x = torch.from_numpy(rng.standard_normal((32, 60, 64), np.float32)).to(
        cuda, torch.bfloat16)
    outs = {}
    for fused, launches in ((False, 2), (True, 1)):
        monkeypatch.setattr(gru_mod, "BIDIR_FUSED", fused)
        before = cuda_gru.GRU_FWD.launches
        with torch.no_grad():
            outs[fused] = gru_mod.bidirectional_gru(fwd, bwd, x)
        assert cuda_gru.GRU_FWD.launches == before + launches
    torch.testing.assert_close(outs[True].float(), outs[False].float(),
                               **TOL[torch.bfloat16])
