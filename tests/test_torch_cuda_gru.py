"""The CUDA GRU kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; on a machine without CUDA every test
here skips.  Run on the card (the repository's conftest imports JAX, which
the GPU machine does not have, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_gru.py

Tolerances are the JAX package's own kernel tolerances
(tests/test_pallas_gru.py): forward 1e-5 in float32, 2e-2 relative in
bfloat16; gradients 2e-4 (float32) and 2e-2 (bfloat16) relative to each
tensor's largest magnitude, since the kernels sum in another order than the
plain versions.
"""

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.ops import cuda_gru

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# flagship training (E=40, T=60, B=32, H=128) and a ragged shape
TRAIN_SHAPES = [(40, 60, 32, 128), (3, 7, 37, 128)]


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 37, 128), (40, 60, 256, 128),
                                   (2, 1, 1, 64)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
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
def test_backward_is_deterministic(cuda):
    proj, w_hh, b_hh, h0 = _inputs(40, 60, 32, 128, torch.bfloat16, cuda)
    _, h_prev, gates = cuda_gru.gru_fwd_train_cuda(proj, w_hh, b_hh, h0)
    dout = torch.ones_like(h_prev)
    first = cuda_gru.gru_bwd_cuda(proj, h_prev, gates, w_hh, b_hh, dout)
    again = cuda_gru.gru_bwd_cuda(proj, h_prev, gates, w_hh, b_hh, dout)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
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
        counts[0], counts[1] + 1, counts[2] + 1]
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


@pytest.mark.cuda
def test_dispatch_launches_kernel_on_cuda(cuda):
    args = _inputs(2, 3, 5, 128, torch.float32, cuda)
    before = [k.launches for k in cuda_gru.KERNELS]
    cuda_gru.gru_recurrence(*args)
    with torch.no_grad():
        w = args[1].clone().requires_grad_(True)
        cuda_gru.gru_recurrence(args[0], w, *args[2:])
    assert [k.launches for k in cuda_gru.KERNELS] == [
        before[0] + 2, before[1], before[2]]
