"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips itself when no card is present. Run on the
H100 with ``python -m pytest tests/test_torch_cuda.py --noconftest`` (the
suite's conftest imports the JAX package, which needs orbax).
Tolerances: bf16 atol 0.05, f32 atol 1e-4 with TF32 off (the plain version
then multiplies in full float32 too). The backward kernels, and the k
softmax's statistics from the context kernel, are held to their plain
oracles relative to each output's largest magnitude: 1e-5 in
f32 (sums in another order), 0.02 in bf16 (an intermediate rounded to bf16
may land one ulp apart when its float32 sum was taken in another order).
"""

import numpy as np
import pytest
import torch

from video_diffusion_nnx_tpu_torch import ops
from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as sla
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

torch.set_num_threads(1)  # the suite runs 6 workers on 8 cores
pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 0.05, torch.float32: 1e-4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale, device, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,f,c", [(2, 64, 10, 32), (1, 16, 64, 256), (3, 5, 7, 48)])
def test_temporal_kernel_matches_plain(device, dtype, b, s, f, c):
    heads, dim = 8, 32
    x = _rand((b, s, f, c), 0, 0.5, device, dtype)
    wqkv = _rand((c, 3 * heads * dim), 1, c ** -0.5, device)
    bqkv = _rand((3 * heads * dim,), 2, 0.1, device)
    wo = _rand((heads * dim, c), 3, (heads * dim) ** -0.5, device)
    bo = _rand((c,), 4, 0.1, device)
    ops.reset_launch_counts()
    got = ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, heads, dim)
    torch.cuda.synchronize()
    assert ops.launch_counts()["temporal_attention_fwd"] == 1
    want = ta.temporal_attention_plain(x, wqkv, bqkv, wo, bo, heads, dim)
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,hw,c", [(2, 10, 64, 32), (1, 3, 16, 128), (1, 2, 7, 24)])
def test_sla_kernels_match_plain(device, dtype, b, f, hw, c):
    heads, dim = 8, 32
    x = _rand((b, f, hw, hw, c), 0, 0.5, device, dtype)
    wqkv = _rand((c, 3 * heads * dim), 1, c ** -0.5, device)
    wo = _rand((heads * dim, c), 3, (heads * dim) ** -0.5, device)
    xt = x.reshape(b * f, hw * hw, c)
    ops.reset_launch_counts()
    ctx, stats = sla.sla_context(xt, wqkv, heads, dim)
    got = sla.sla_out(xt, wqkv, wo, ctx, heads, dim, 1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"temporal_attention_fwd": 0, "temporal_attention_bwd": 0,
                                   "sla_context": 1, "sla_out": 1, "sla_bwd_q": 0, "sla_bwd_kv": 0}
    ctx_plain = sla.sla_context_plain(xt, wqkv, heads, dim)
    want = sla.sla_out_plain(xt, wqkv, wo, ctx_plain, heads, dim, 1.0)
    assert (ctx - ctx_plain).abs().max().item() <= TOL[dtype]
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    stats_plain = sla.sla_stats_plain(xt, wqkv, heads, dim)
    for name, a, w in zip(("max", "sum"), stats, stats_plain):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def test_unsupported_shape_raises_on_the_card(device):
    x = torch.zeros(1, 2, 65, 16, device=device)
    w = torch.zeros(16, 3 * 64, device=device)
    with pytest.raises(NotImplementedError, match="B7"):
        ta.fused_temporal_attention_block(x, w, torch.zeros(192, device=device),
                                          torch.zeros(64, 16, device=device),
                                          torch.zeros(16, device=device), 2, 32)


BWD_TOL = {torch.bfloat16: 0.02, torch.float32: 1e-5}


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-6)).item()


def _temporal_args(shape, device, dtype, heads=8, dim=32):
    b, s, f, c = shape
    hd = heads * dim
    return (_rand(shape, 0, 0.5, device, dtype), _rand((c, 3 * hd), 1, c ** -0.5, device),
            _rand((3 * hd,), 2, 0.1, device), _rand((hd, c), 3, hd ** -0.5, device),
            _rand((c,), 4, 0.1, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 10, 32), (1, 10, 64, 256), (3, 5, 7, 48)])
def test_temporal_bwd_kernel_matches_plain(device, dtype, shape):
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    g = _rand(shape, 5, 0.1, device, dtype)
    ops.reset_launch_counts()
    got = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["temporal_attention_bwd"] == 1
    want = ta.temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, 8, 32)
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, w in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got, want):
        assert a.shape == w.shape, name
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def _sla_args(shape, device, dtype, heads=8, dim=32):
    b, f, hh, ww, c = shape
    hd = heads * dim
    xt = _rand((b * f, hh * ww, c), 0, 0.5, device, dtype)
    return xt, _rand((c, 3 * hd), 1, c ** -0.5, device), _rand((hd, c), 3, hd ** -0.5, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 10, 64, 64, 32), (1, 3, 16, 16, 128), (1, 2, 7, 5, 24)])
def test_sla_bwd_kernels_match_plain(device, dtype, shape):
    xt, wqkv, wo = _sla_args(shape, device, dtype)
    g = _rand(xt.shape, 5, 0.1, device, dtype)
    ctx, stats = sla.sla_context(xt, wqkv, 8, 32)
    ops.reset_launch_counts()
    dxq, dctx, dwq, dwo = sla.sla_bwd_q(xt, g, wqkv, wo, ctx, 8, 32, 1.0)
    dx, dwk, dwv = sla.sla_bwd_kv(xt, wqkv, dctx, dxq, stats, 8, 32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sla_bwd_q"] == 1 and ops.launch_counts()["sla_bwd_kv"] == 1
    want_q = sla.sla_bwd_q_plain(xt, g, wqkv, wo, ctx, 8, 32, 1.0)
    for name, a, w in zip(("dx_q", "dctx", "dwq", "dwo"), (dxq, dctx, dwq, dwo), want_q):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))
    want_kv = sla.sla_bwd_kv_plain(xt, wqkv, dctx, dxq, 8, 32)  # the kernel's own dctx and dx_q
    for name, a, w in zip(("dx", "dwk", "dwv"), (dx, dwk, dwv), want_kv):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def test_gradients_flow_through_both_ops(device):
    """loss.backward() on CUDA reaches x and every weight, through the backward kernels."""
    x, wqkv, bqkv, wo, bo = _temporal_args((2, 16, 10, 32), device, torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, wqkv, bqkv, wo, bo)]
    ops.reset_launch_counts()
    ta.fused_temporal_attention_block(*leaves, 8, 32).float().square().mean().backward()
    xs, sw, so = _sla_args((2, 3, 8, 8, 32), device, torch.bfloat16)
    xs = xs.reshape(2, 3, 8, 8, 32)
    sla_leaves = [t.requires_grad_() for t in (xs, sw, so)]
    sla.fused_spatial_linear_attention_block(*sla_leaves, 8, 32, 1.0).float().square().mean().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["temporal_attention_bwd"] == 1 and counts["sla_bwd_q"] == 1 and counts["sla_bwd_kv"] == 1
    for t in leaves + sla_leaves:
        assert t.grad is not None and t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all())
        assert t.grad.abs().max().item() > 0


def test_weight_gradient_reduction_is_deterministic(device):
    x, wqkv, bqkv, wo, bo = _temporal_args((4, 1024, 10, 32), device, torch.float32)
    g = _rand(x.shape, 5, 0.1, device)
    a = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    b = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    xt, sw, so = _sla_args((2, 10, 32, 32, 32), device, torch.float32)
    g = _rand(xt.shape, 5, 0.1, device)
    ctx, stats = sla.sla_context(xt, sw, 8, 32)
    runs = []
    for _ in range(2):
        dxq, dctx, dwq, dwo = sla.sla_bwd_q(xt, g, sw, so, ctx, 8, 32, 1.0)
        runs.append((dxq, dctx, dwq, dwo, *sla.sla_bwd_kv(xt, sw, dctx, dxq, stats, 8, 32)))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_unsupported_backward_shape_raises_on_the_card(device):
    x = torch.zeros(1, 2, 65, 16, device=device)
    with pytest.raises(NotImplementedError, match="B7"):
        ta.temporal_attention_bwd(x, x, torch.zeros(16, 192, device=device), torch.zeros(192, device=device),
                                  torch.zeros(64, 16, device=device), torch.zeros(16, device=device), 2, 32)
    xt = torch.zeros(2, 4, 8, device=device, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        sla.sla_bwd_kv(xt, torch.zeros(8, 192, device=device, dtype=torch.float16), torch.zeros(2, 2, 32, 32, device=device),
                       xt, torch.zeros(2, 2, 2, 32, device=device), 2, 32)
