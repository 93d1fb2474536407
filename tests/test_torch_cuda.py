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

import math

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
    assert {k: v for k, v in ops.launch_counts().items() if v} == {"sla_context": 1, "sla_out": 1}
    ctx_plain = sla.sla_context_plain(xt, wqkv, heads, dim)
    want = sla.sla_out_plain(xt, wqkv, wo, ctx_plain, heads, dim, 1.0)
    assert (ctx - ctx_plain).abs().max().item() <= TOL[dtype]
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    stats_plain = sla.sla_stats_plain(xt, wqkv, heads, dim)
    for name, a, w in zip(("max", "sum"), stats, stats_plain):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def test_unsupported_shape_raises_on_the_card(device):
    """A column too long for shared memory raises; nothing falls back to the plain or the dense route."""
    x = torch.zeros(1, 2, 4096, 16, device=device)
    w = torch.zeros(16, 3 * 64, device=device)
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        ta.fused_temporal_attention_block(x, w, torch.zeros(192, device=device),
                                          torch.zeros(64, 16, device=device),
                                          torch.zeros(16, device=device), 2, 32)
    assert set(ops.launch_counts().values()) == {0}


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
    dx, dwk, dwv = sla.sla_bwd_kv(xt, wqkv, ctx, dctx, dxq, stats, 8, 32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sla_bwd_q"] == 1 and ops.launch_counts()["sla_bwd_kv"] == 1
    want_q = sla.sla_bwd_q_plain(xt, g, wqkv, wo, ctx, 8, 32, 1.0)
    for name, a, w in zip(("dx_q", "dctx", "dwq", "dwo"), (dxq, dctx, dwq, dwo), want_q):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))
    want_kv = sla.sla_bwd_kv_plain(xt, wqkv, ctx, dctx, dxq, 8, 32)  # the kernel's own dctx and dx_q
    for name, a, w in zip(("dx", "dwk", "dwv"), (dx, dwk, dwv), want_kv):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


# The padding edges of the backward kernels' tiles: f of 1 (a token is one row), 16 (whole 16-row
# blocks) and 64 (the longest dense column); c of 24 and 40 (not multiples of 16) and 256; head dims
# 16 and 64 (64 takes the CUDA-core kernel where the tensor-core tile does not fit, and at f = 64, c =
# 256, where no dense tile holds one token, the wide kernel: the streaming kernel in mode DENSE, with
# the dense kernels' rounding points); three heads, so that the weight ring's slots alternate unevenly
# across tiles.
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 64])
@pytest.mark.parametrize("c", [24, 40, 256])
@pytest.mark.parametrize("f", [1, 16, 64])
def test_temporal_bwd_padding_edges_match_plain(device, f, c, dim, dtype, bias):
    heads = 3
    shape = (2, 37 if f < 64 else 5, f, c)
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype, heads, dim)
    g = _rand(shape, 5, 0.1, device, dtype)
    pos_bias = _rand((heads, f, f), 6, 0.5, device) if bias else None
    family = "attention"
    if f * 4 * (2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1) > 227 * 1024:  # one token over the dense tile
        family = "wide"
    name = f"temporal_{family}{'_biased' if bias else ''}_bwd"
    ops.reset_launch_counts()
    got = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, heads, dim, pos_bias=pos_bias)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {name: 1}
    want = ta.temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads, dim, pos_bias=pos_bias)
    for k, a, w in zip(GRADS6, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, k
        assert _rel_err(a, w) <= BWD_TOL[dtype], (k, _rel_err(a, w))


@pytest.mark.parametrize("scale", [1.0, 32 ** -0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 7, 5, 40), (2, 3, 9, 9, 40), (1, 2, 6, 6, 256)])
def test_sla_bwd_q_padding_edges_match_plain(device, shape, dtype, scale):
    """c = 40 (not a multiple of 16) and token counts that are not multiples of 16 (35, 81, 36)."""
    xt, wqkv, wo = _sla_args(shape, device, dtype)
    g = _rand(xt.shape, 5, 0.1, device, dtype)
    ctx = sla.sla_context_plain(xt, wqkv, 8, 32)
    ops.reset_launch_counts()
    got = sla.sla_bwd_q(xt, g, wqkv, wo, ctx, 8, 32, scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sla_bwd_q"] == 1
    for k, a, w in zip(("dx_q", "dctx", "dwq", "dwo"), got, sla.sla_bwd_q_plain(xt, g, wqkv, wo, ctx, 8, 32, scale)):
        assert a.shape == w.shape and a.dtype == w.dtype, k
        assert _rel_err(a, w) <= BWD_TOL[dtype], (k, _rel_err(a, w))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1024, 10, 32), (8, 4096, 10, 32)])
def test_weight_gradient_reduction_is_deterministic(device, dtype, shape):
    """Two backward runs are bit-equal (per-CTA partials summed in a fixed order, no atomics), at the
    flagship's top-level temporal shape too, in both types (bf16 takes the tensor-core kernels)."""
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    g = _rand(x.shape, 5, 0.1, device, dtype)
    a = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    b = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    xt, sw, so = _sla_args((2, 10, 32, 32, 32), device, dtype)
    g = _rand(xt.shape, 5, 0.1, device, dtype)
    ctx, stats = sla.sla_context(xt, sw, 8, 32)
    runs = []
    for _ in range(2):
        dxq, dctx, dwq, dwo = sla.sla_bwd_q(xt, g, sw, so, ctx, 8, 32, 1.0)
        runs.append((dxq, dctx, dwq, dwo, *sla.sla_bwd_kv(xt, sw, ctx, dctx, dxq, stats, 8, 32)))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_unsupported_backward_shape_raises_on_the_card(device):
    x = torch.zeros(1, 2, 4096, 16, device=device)
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        ta.temporal_attention_bwd(x, x, torch.zeros(16, 192, device=device), torch.zeros(192, device=device),
                                  torch.zeros(64, 16, device=device), torch.zeros(16, device=device), 2, 32)
    x = torch.zeros(1, 2, 330, 16, device=device)  # the forward refuses what the backward could not hold
    with pytest.raises(NotImplementedError, match="f=330"):
        ta.fused_temporal_attention_block(x, torch.zeros(16, 192, device=device), torch.zeros(192, device=device),
                                          torch.zeros(64, 16, device=device), torch.zeros(16, device=device), 2, 32)
    xt = torch.zeros(2, 4, 8, device=device, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        sla.sla_bwd_kv(xt, torch.zeros(8, 192, device=device, dtype=torch.float16), torch.zeros(2, 2, 32, 32, device=device),
                       torch.zeros(2, 2, 32, 32, device=device), xt, torch.zeros(2, 2, 2, 32, device=device), 2, 32)


# The last two columns are near the longest the panels of one KV block width leave room for (321 frames).
BLOCKWISE_SHAPES = [(1, 64, 128, 32), (1, 8, 128, 256), (1, 3, 256, 256), (2, 5, 65, 48), (1, 7, 100, 64),
                    (1, 3, 300, 32), (1, 2, 316, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKWISE_SHAPES)
def test_blockwise_kernels_match_plain(device, dtype, shape):
    """Beyond 64 frames the op launches the blockwise pair: forward and all five gradients against
    the plain blockwise versions at the kernel's block width, and in f32 against the dense ones."""
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    g = _rand(shape, 5, 0.1, device, dtype)
    kb = ta.KV_BLOCK
    ops.reset_launch_counts()
    got = ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, 8, 32)
    grads = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["temporal_blockwise_fwd"] == 1 and counts["temporal_blockwise_bwd"] == 1
    assert counts["temporal_attention_fwd"] == 0 and counts["temporal_attention_bwd"] == 0
    want = ta.temporal_attention_blockwise_plain(x, wqkv, bqkv, wo, bo, 8, 32, kb)
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    want_grads = ta.temporal_attention_blockwise_bwd_plain(x, g, wqkv, bqkv, wo, bo, 8, 32, kb)
    assert grads[0].dtype == dtype and all(t.dtype == torch.float32 for t in grads[1:])
    for name, a, w in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), grads, want_grads):
        assert a.shape == w.shape, name
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))
    if dtype == torch.float32:
        dense = ta.temporal_attention_plain(x, wqkv, bqkv, wo, bo, 8, 32)
        assert (got - dense).abs().max().item() <= TOL[dtype]
        for name, a, w in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), grads,
                              ta.temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, 8, 32)):
            assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def test_blockwise_gradients_flow_and_are_deterministic(device):
    """loss.backward() over 128 frames reaches x and every weight through the blockwise backward
    kernel, and two runs of it give bit-equal results (per-CTA partials, summed in a fixed order)."""
    x, wqkv, bqkv, wo, bo = _temporal_args((1, 300, 128, 32), device, torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, wqkv, bqkv, wo, bo)]
    ops.reset_launch_counts()
    out = ta.fused_temporal_attention_block(*leaves, 8, 32)
    assert out.grad_fn is not None
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["temporal_blockwise_bwd"] == 1
    for t in leaves:
        assert t.grad is not None and t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all())
        assert t.grad.abs().max().item() > 0
    tensors = [t.detach() for t in leaves]
    g = _rand(x.shape, 5, 0.1, device, torch.bfloat16)
    a = ta.temporal_attention_bwd(tensors[0], g, *tensors[1:], 8, 32)
    b = ta.temporal_attention_bwd(tensors[0], g, *tensors[1:], 8, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(ta.fused_temporal_attention_block(*tensors, 8, 32), out.detach())


def test_unet_remat_blocks_on_the_card(device):
    """A 72-frame Unet3D on the kernels: remat_blocks leaves launches, output and gradients as they are."""
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    kw = dict(dim=8, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", use_fused_attention=True,
              use_fused_spatial_attention=True)
    plain, remat = Unet3D(**kw).to(device), Unet3D(**kw, remat_blocks=True).to(device)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    remat.load_state_dict(plain.state_dict())
    x, t = _rand((1, 1, 72, 16, 16), 0, 1.0, device), torch.tensor([3], device=device)
    results = []
    for net in (plain, remat):
        ops.reset_launch_counts()
        out = net(x, t)
        out.square().mean().backward()
        torch.cuda.synchronize()
        results.append((out.detach(), ops.launch_counts(), {k: p.grad for k, p in net.named_parameters()}))
    (y0, c0, g0), (y1, c1, g1) = results
    assert c0 == c1 and c0["temporal_blockwise_fwd"] == c0["temporal_blockwise_bwd"] == 6
    assert c0["temporal_attention_fwd"] == c0["temporal_attention_bwd"] == 1  # the bottleneck's 8x8 tokens
    assert torch.equal(y0, y1)
    for k, g in g0.items():
        if g is not None:
            assert _rel_err(g1[k], g) <= 1e-3, k


# The biased (fixed-math) instantiations: a position bias (H, f, f) on the logits, and its gradient.
BIASED_DENSE = [(2, 64, 10, 32), (1, 10, 64, 256), (3, 5, 7, 48)]
BIASED_BLOCKWISE = [(1, 64, 128, 32), (1, 8, 128, 256), (2, 5, 65, 48)]
GRADS6 = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BIASED_DENSE + BIASED_BLOCKWISE)
def test_biased_kernels_match_plain(device, dtype, shape):
    """All four biased kernels against their plain versions, dbias held like the weight gradients; a zero
    bias reproduces the unbiased kernel bit for bit; in f32 the blockwise pair also meets the dense plain versions."""
    f = shape[2]
    family = "attention" if f <= ta.MAX_FRAMES else "blockwise"
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    w = (wqkv, bqkv, wo, bo)
    g = _rand(shape, 5, 0.1, device, dtype)
    bias = _rand((8, f, f), 6, 0.5, device)
    ops.reset_launch_counts()
    got = ta.fused_temporal_attention_block_biased(x, *w, bias, 8, 32)
    grads = ta.temporal_attention_bwd(x, g, *w, 8, 32, pos_bias=bias)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        f"temporal_{family}_biased_fwd": 1, f"temporal_{family}_biased_bwd": 1}
    if family == "attention":
        want = ta.temporal_attention_plain(x, *w, 8, 32, pos_bias=bias)
        want_grads = ta.temporal_attention_bwd_plain(x, g, *w, 8, 32, pos_bias=bias)
    else:
        want = ta.temporal_attention_blockwise_plain(x, *w, 8, 32, ta.KV_BLOCK, pos_bias=bias)
        want_grads = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, 8, 32, ta.KV_BLOCK, pos_bias=bias)
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert len(grads) == 6 and grads[5].dtype == torch.float32 and tuple(grads[5].shape) == (8, f, f)
    for name, a, v in zip(GRADS6, grads, want_grads):
        assert a.shape == v.shape, name
        assert _rel_err(a, v) <= BWD_TOL[dtype], (name, _rel_err(a, v))
    if dtype == torch.float32 and family == "blockwise":
        assert (got - ta.temporal_attention_plain(x, *w, 8, 32, pos_bias=bias)).abs().max().item() <= TOL[dtype]
        for name, a, v in zip(GRADS6, grads, ta.temporal_attention_bwd_plain(x, g, *w, 8, 32, pos_bias=bias)):
            assert _rel_err(a, v) <= BWD_TOL[dtype], (name, _rel_err(a, v))
    zero = torch.zeros_like(bias)
    assert torch.equal(ta.fused_temporal_attention_block_biased(x, *w, zero, 8, 32),
                       ta.fused_temporal_attention_block(x, *w, 8, 32))
    for a, v in zip(ta.temporal_attention_bwd(x, g, *w, 8, 32, pos_bias=zero), ta.temporal_attention_bwd(x, g, *w, 8, 32)):
        assert torch.equal(a, v)


@pytest.mark.parametrize("shape", [(4, 1024, 10, 32), (1, 300, 128, 32)])
def test_dbias_and_table_gradient_are_deterministic(device, shape):
    """Two runs give bit-equal dbias (per-CTA partials summed in a fixed order, no atomics) and a bit-equal
    gradient of the relative-position table behind it; loss.backward() reaches all six tensors."""
    from video_diffusion_nnx_tpu_torch.models.attention import RelativePositionBias

    f = shape[2]
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, torch.float32)
    g = _rand(shape, 5, 0.1, device)
    bias = _rand((8, f, f), 6, 0.5, device)
    a = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32, pos_bias=bias)
    b = ta.temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, 8, 32, pos_bias=bias)
    assert all(torch.equal(u, v) for u, v in zip(a, b)) and a[5].abs().max().item() > 0
    table = RelativePositionBias(heads=8, max_distance=32).to(device)
    leaves = [t.requires_grad_() for t in (x, wqkv, bqkv, wo, bo)]
    runs = []
    for _ in range(2):
        for t in (*leaves, table.relative_attention_bias.weight):
            t.grad = None
        out = ta.fused_temporal_attention_block_biased(*leaves, table(f), 8, 32)
        assert out.grad_fn is not None
        out.square().mean().backward()
        torch.cuda.synchronize()
        runs.append([t.grad.clone() for t in (*leaves, table.relative_attention_bias.weight)])
    for name, u, v in zip((*GRADS6[:5], "table"), *runs):
        assert torch.equal(u, v), name
    assert all(bool(torch.isfinite(u).all()) and u.abs().max().item() > 0 for u in runs[0])


def test_fixed_math_unet_on_the_card(device):
    """A fixed-math Unet3D under the bf16 policy on the kernels: every fused op receives float32, the biased
    kernels launch once per temporal attention each way, and a live focus mask matches the module route."""
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    kw = dict(dim=8, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", reference_compat=False)
    fused = Unet3D(**kw, use_fused_attention=True, use_fused_spatial_attention=True).to(device)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    module = Unet3D(**kw).to(device)
    module.load_state_dict(fused.state_dict())
    x, t = _rand((2, 1, 10, 16, 16), 0, 1.0, device), torch.tensor([3, 7], device=device)
    mask = torch.tensor([True, False], device=device)
    ops.reset_launch_counts()
    out = fused(x, t, focus_present_mask=mask)
    out.square().mean().backward()
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"temporal_attention_biased_fwd": 6, "temporal_attention_biased_bwd": 6,
                      "temporal_attention_fwd": 1, "temporal_attention_bwd": 1,
                      "sla_context": 4, "sla_out": 4, "sla_bwd_q": 4, "sla_bwd_kv": 4}
    want = module(x, t, focus_present_mask=mask)
    want.square().mean().backward()
    assert (out - want).abs().max().item() <= 0.1 * want.abs().max().item()
    for (k, p), (_, q) in zip(fused.named_parameters(), module.named_parameters()):
        if q.grad is not None:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
    gk = fused.time_rel_pos_bias.relative_attention_bias.weight.grad
    gm = module.time_rel_pos_bias.relative_attention_bias.weight.grad
    assert ((gk - gm).norm() / gm.norm()).item() <= 0.1


# The sequence-parallel recipe's widest and narrowest (s, c) at f_l = 8 of f_g = 32, and a ragged f_g.
CROSS_SHAPES = [(2, 64, 8, 32, 256), (1, 96, 8, 32, 32), (1, 16, 4, 21, 64)]


def _cross_args(shape, device, dtype, heads=8, dim=32):
    b, s, fl, fg, c = shape
    hd = heads * dim
    return (_rand((b, s, fl, c), 0, 0.5, device, dtype), _rand((b, s, fg, hd), 1, 1.0, device, dtype),
            _rand((b, s, fg, hd), 2, 1.0, device, dtype), _rand((c, hd), 3, c ** -0.5, device),
            _rand((hd,), 4, 0.1, device), _rand((hd, c), 5, hd ** -0.5, device), _rand((c,), 6, 0.1, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_cross_kernels_match_plain(device, dtype, shape):
    from video_diffusion_nnx_tpu_torch.ops import cross_attention as xa

    x, k, v, wq, bq, wo, bo = _cross_args(shape, device, dtype)
    g = _rand(x.shape, 7, 0.1, device, dtype)
    ops.reset_launch_counts()
    got = xa.fused_cross_attention_block(x, k, v, wq, bq, wo, bo, 8, 32)
    grads = xa.cross_attention_bwd(x, g, k, v, wq, bq, wo, 8, 32)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.launch_counts().items() if c} == {"cross_attention_fwd": 1, "cross_attention_bwd": 1}
    # every shape here fits the staged kernels' plan, and the C entries report that they ran
    assert {n: c for n, c in ops.staged_launch_counts().items() if c} == {"cross_attention_fwd": 1,
                                                                          "cross_attention_bwd": 1}
    want = xa.cross_attention_plain(x, k, v, wq, bq, wo, bo, 8, 32)
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    for name, a, w in zip(("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo"), grads,
                          xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, 8, 32)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_first_design_where_the_plan_does_not_fit(device, dtype):
    """f_g = 300: one token's K|V panels exceed shared memory, so both kernels run their first design."""
    from video_diffusion_nnx_tpu_torch.ops import cross_attention as xa

    shape = (1, 8, 8, 300, 32)
    x, k, v, wq, bq, wo, bo = _cross_args(shape, device, dtype)
    g = _rand(x.shape, 7, 0.1, device, dtype)
    for backward in (False, True):
        assert xa.cross_plan(8, 8, 300, 32, 8, 32, dtype == torch.bfloat16, _sms(), backward)["route"] == "simt"
    ops.reset_launch_counts()
    got = xa.fused_cross_attention_block(x, k, v, wq, bq, wo, bo, 8, 32)
    grads = xa.cross_attention_bwd(x, g, k, v, wq, bq, wo, 8, 32)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.launch_counts().items() if c} == {"cross_attention_fwd": 1, "cross_attention_bwd": 1}
    assert not any(ops.staged_launch_counts().values())
    want = xa.cross_attention_plain(x, k, v, wq, bq, wo, bo, 8, 32)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    for name, a, w in zip(("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo"), grads,
                          xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, 8, 32)):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


def test_cross_gradients_flow_and_are_deterministic(device):
    from video_diffusion_nnx_tpu_torch.ops import cross_attention as xa

    args = _cross_args((2, 256, 8, 32, 64), device, torch.bfloat16)
    g = _rand(args[0].shape, 7, 0.1, device, torch.bfloat16)
    runs = [xa.cross_attention_bwd(args[0], g, *args[1:6], 8, 32) for _ in range(2)]
    assert all(torch.equal(u, w) for u, w in zip(*runs))
    leaves = [a.clone().requires_grad_() for a in args]
    xa.fused_cross_attention_block(*leaves, 8, 32).backward(g)
    for t in leaves:
        assert t.grad is not None and t.grad.dtype == t.dtype and t.grad.abs().max().item() > 0
    with pytest.raises(NotImplementedError, match="K and V in x's type"):
        xa.fused_cross_attention_block(args[0], args[1].float(), args[2], *args[3:], 8, 32)


def test_gloo_ranks_share_one_card(device, tmp_path):
    """Two gloo ranks on cuda:0: the frame gather and the sum, staged through host memory, and their backward."""
    import torch.multiprocessing as mp

    import torch_seq_workers

    mp.spawn(torch_seq_workers.card_rank_main, args=(2, f"file://{tmp_path / 'store'}", str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        res = torch.load(tmp_path / f"card{r}.pt")
        assert res["device"] == "cuda:0" and res["ok"], res


# The staged dense forward (`temporal_fwd_panel_kernel`) and the staged k/v backward (`sla_bwd_kv_panel_kernel`)
# at every shape the flagship, fixed and long-clip recipes give them (batch 8 for training, batch 2 for the
# sampler), the long clip's bottleneck, and ragged f, c and n (not multiples of 16).
STAGED_FWD_SHAPES = sorted({(8, 4096, 10, 32), (8, 1024, 10, 64), (8, 256, 10, 128), (8, 64, 10, 256),
                            (8, 10, 64, 256), (8, 64, 10, 128), (8, 256, 10, 64), (8, 1024, 10, 32),
                            (2, 4096, 10, 32), (2, 64, 10, 256), (2, 10, 64, 256), (1, 128, 64, 256),
                            (3, 5, 7, 48), (2, 37, 13, 40)})
STAGED_KV_SHAPES = [(8, 10, 64, 64, 32), (8, 10, 32, 32, 64), (8, 10, 16, 16, 128), (8, 10, 8, 8, 256),
                    (8, 10, 8, 8, 128), (8, 10, 16, 16, 64), (8, 10, 32, 32, 32),
                    (1, 128, 64, 64, 32), (1, 128, 32, 32, 64), (1, 128, 16, 16, 128), (1, 128, 8, 8, 256),
                    (1, 128, 8, 8, 128), (1, 128, 16, 16, 64), (1, 128, 32, 32, 32),
                    (1, 10, 64, 64, 128), (1, 2, 7, 5, 24), (2, 3, 9, 9, 40)]


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGED_FWD_SHAPES, ids=str)
def test_staged_temporal_fwd_matches_plain(device, shape, dtype, bias):
    """The dense forward against its plain version; every shape but f = 64, c = 256 in float32 takes the staged
    kernel; a zero bias reproduces the unbiased kernel bit for bit."""
    b, s, f, c = shape
    plan = ta.fwd_plan(b * s, f, c, 32, 8, dtype == torch.bfloat16, _sms())
    assert plan["route"] == ("simt" if dtype == torch.float32 and (f, c) == (64, 256) else "staged")
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    pos_bias = _rand((8, f, f), 6, 0.5, device) if bias else None
    ops.reset_launch_counts()
    got = ta._block(x, wqkv, bqkv, wo, bo, pos_bias, 8, 32)
    torch.cuda.synchronize()
    name = "temporal_attention_biased_fwd" if bias else "temporal_attention_fwd"
    assert {k: v for k, v in ops.launch_counts().items() if v} == {name: 1}
    assert ops.staged_launch_counts()[name] == (plan["route"] == "staged")  # the C launcher chose as the planner
    want = ta.temporal_attention_plain(x, wqkv, bqkv, wo, bo, 8, 32, pos_bias=pos_bias)
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if bias:
        zero = torch.zeros_like(pos_bias)
        assert torch.equal(ta.fused_temporal_attention_block_biased(x, wqkv, bqkv, wo, bo, zero, 8, 32),
                           ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, 8, 32))


def _kv_args(shape, device, dtype):
    """x, W_qkv, the contexts (float32 takes rho from them), a context cotangent, dx_q and the context
    kernel's softmax statistics for ``sla_bwd_kv``."""
    b, f, hh, ww, c = shape
    xt, wqkv, _ = _sla_args(shape, device, dtype)
    dctx = _rand((b * f, 8, 32, 32), 7, 0.5, device)
    dxq = _rand(xt.shape, 8, 0.1, device, dtype)
    ctx, stats = sla.sla_context(xt, wqkv, 8, 32)
    return xt, wqkv, ctx, dctx, dxq, stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGED_KV_SHAPES, ids=str)
def test_staged_sla_bwd_kv_matches_plain(device, shape, dtype):
    b, f, hh, ww, c = shape
    assert sla.kv_plan(b * f, hh * ww, c, 32, 8, dtype == torch.bfloat16, _sms())["route"] == "staged"
    args = _kv_args(shape, device, dtype)
    ops.reset_launch_counts()
    got = sla.sla_bwd_kv(*args, 8, 32)  # float32: rho from the contexts, one pass; bf16: two passes
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {"sla_bwd_kv": 1}
    assert ops.staged_launch_counts()["sla_bwd_kv"] == 1  # the C launcher chose as the planner
    want = sla.sla_bwd_kv_plain(*args[:5], 8, 32)
    for name, a, w in zip(("dx", "dwk", "dwv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_kernels_are_deterministic(device, dtype):
    """Two runs of each staged kernel at its flagship top-level shape are bit-equal."""
    x, wqkv, bqkv, wo, bo = _temporal_args((8, 4096, 10, 32), device, dtype)
    assert torch.equal(ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, 8, 32),
                       ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, 8, 32))
    args = _kv_args((8, 10, 64, 64, 32), device, dtype)
    a, b = sla.sla_bwd_kv(*args, 8, 32), sla.sla_bwd_kv(*args, 8, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# The staged spatial forward (`sla_context_panel_kernel`: two passes and the split reduction;
# `sla_out_panel_kernel`) at every shape of the flagship (batch 2 for the sampler, batch 8 for training), the
# long clip (128 frames), the wide frame and two ragged ones, in both types, at scale 1 and fixed math's 32 ** -0.5.
_SLA_FRAME = [(64, 64, 32), (32, 32, 64), (16, 16, 128), (8, 8, 256), (8, 8, 128), (16, 16, 64), (32, 32, 32)]
STAGED_SLA_FWD_SHAPES = ([(b, 10, *p) for b in (2, 8) for p in _SLA_FRAME] + [(1, 128, *p) for p in _SLA_FRAME]
                         + [(1, 10, 64, 64, 128), (1, 2, 7, 7, 24), (1, 3, 16, 16, 128)])
# The attention term y = out - x of sla_out is about one bf16 ulp of x at these inputs, so out = x + round(y)
# rounds most of y away; the relative check of y multiplies the contexts by this power of two (exact in either
# type, and y with them), so that y outweighs x.
CTX_GAIN = 2.0 ** 12


def _check_sla_fwd(xt, wqkv, wo, heads, dim, scale, routes):
    """Both forward stages against their plain versions (forward gates; relative to their largest value the
    contexts, y = out - x at contexts times CTX_GAIN, and the softmax statistics); each C entry reports the
    route its planner chose (``routes``: "staged" or "simt" per stage); two runs bit-equal."""
    dtype = xt.dtype
    ops.reset_launch_counts()
    ctx, stats = sla.sla_context(xt, wqkv, heads, dim)
    ctx_plain = sla.sla_context_plain(xt, wqkv, heads, dim)
    out = sla.sla_out(xt, wqkv, wo, ctx_plain, heads, dim, scale)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {"sla_context": 1, "sla_out": 1}
    staged = ops.staged_launch_counts()
    assert [staged[k] for k in ("sla_context", "sla_out")] == [r == "staged" for r in routes]
    assert (ctx - ctx_plain).abs().max().item() <= TOL[dtype]
    want = sla.sla_out_plain(xt, wqkv, wo, ctx_plain, heads, dim, scale)
    assert out.dtype == dtype and out.shape == xt.shape
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert _rel_err(ctx, ctx_plain) <= BWD_TOL[dtype], _rel_err(ctx, ctx_plain)
    y, y_plain = (fn(xt, wqkv, wo, ctx_plain * CTX_GAIN, heads, dim, scale).float() - xt.float()
                  for fn in (sla.sla_out, sla.sla_out_plain))
    assert _rel_err(y, y_plain) <= BWD_TOL[dtype], _rel_err(y, y_plain)
    for name, a, w in zip(("max", "sum"), stats, sla.sla_stats_plain(xt, wqkv, heads, dim)):
        assert _rel_err(a, w) <= BWD_TOL[dtype], (name, _rel_err(a, w))
    ctx2, stats2 = sla.sla_context(xt, wqkv, heads, dim)
    assert torch.equal(ctx, ctx2) and torch.equal(stats, stats2)
    assert torch.equal(out, sla.sla_out(xt, wqkv, wo, ctx_plain, heads, dim, scale))


def _fwd_routes(xt, c, heads, dim):
    frames, n, _ = xt.shape
    args = (frames, n, c, dim, heads, xt.dtype == torch.bfloat16, _sms())
    return sla.ctx_plan(*args)["route"], sla.out_plan(*args)["route"]


@pytest.mark.parametrize("scale", [1.0, 32 ** -0.5], ids=["scale1", "scale_fixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STAGED_SLA_FWD_SHAPES, ids=str)
def test_staged_sla_fwd_matches_plain(device, shape, dtype, scale):
    """Every configured shape takes both staged kernels, in either type."""
    xt, wqkv, wo = _sla_args(shape, device, dtype)
    routes = _fwd_routes(xt, shape[-1], 8, 32)
    assert routes == ("staged", "staged")
    _check_sla_fwd(xt, wqkv, wo, 8, 32, scale, routes)


@pytest.mark.parametrize("scale", [1.0, 32 ** -0.5], ids=["scale1", "scale_fixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 32, 64])
@pytest.mark.parametrize("c", [24, 40, 256])
def test_staged_sla_fwd_padding_edges_match_plain(device, c, dim, dtype, scale):
    """n = 35 tokens (a ragged last chunk; at c = 256 in float32 three splits of one chunk), c and D padded to
    16; the route is the planner's (float32 at D = 64, c = 256 keeps the CUDA-core kernels)."""
    xt, wqkv, wo = _sla_args((2, 3, 7, 5, c), device, dtype, dim=dim)
    _check_sla_fwd(xt, wqkv, wo, 8, dim, scale, _fwd_routes(xt, c, 8, dim))


def jax_point_context(xt, wqkv, heads, dim):
    """The contexts at the JAX context kernel's rounding points, in float64: k from x and W_k in x's type
    (not rounded), its softmax over all tokens, then s and v rounded to x's type (``_context_kernel``)."""
    frames, n, c = xt.shape
    hd, dt = heads * dim, xt.dtype
    x = xt.double()
    k = (x @ wqkv[:, hd:2 * hd].to(dt).double()).reshape(frames, n, heads, dim)
    v = (x @ wqkv[:, 2 * hd:].to(dt).double()).to(dt).double().reshape(frames, n, heads, dim)
    s = torch.softmax(k, dim=1).to(dt).double()
    return torch.einsum("bnhd,bnhe->bhde", s, v)


def unrounded_context(xt, wqkv, heads, dim):
    """``jax_point_context`` without the rounding of s: the point the CUDA-core kernel skipped before."""
    frames, n, c = xt.shape
    hd, dt = heads * dim, xt.dtype
    x = xt.double()
    k = (x @ wqkv[:, hd:2 * hd].to(dt).double()).reshape(frames, n, heads, dim)
    v = (x @ wqkv[:, 2 * hd:].to(dt).double()).to(dt).double().reshape(frames, n, heads, dim)
    return torch.einsum("bnhd,bnhe->bhde", torch.softmax(k, dim=1), v)


def _rounding_distances(ctx, xt, wqkv):
    """A context's distance, relative to the largest context, to the float64 model of the JAX rounding points
    and to the same model without the rounding of s."""
    ref, unr = jax_point_context(xt, wqkv, 8, 32), unrounded_context(xt, wqkv, 8, 32)
    scale = ref.abs().max().item()
    return (ctx.double() - ref).abs().max().item() / scale, (ctx.double() - unr).abs().max().item() / scale


@pytest.mark.parametrize("b", [2, 8])
def test_staged_context_keeps_the_jax_rounding_points(device, monkeypatch, b):
    """At the top level in bf16 both context kernels round s after its normalisation over all n tokens, where the
    JAX kernel rounds it: the staged kernel and the CUDA-core one (which a chunk that is not a multiple of 16
    selects, by the C launcher's fit rule; its pass 0 takes the statistics first) each lie closer to a float64
    model of those rounding points than to the same model without the rounding of s. Both stay within the
    forward gate of the plain version, which rounds k before its softmax and so is no yardstick for either."""
    xt, wqkv, _ = _sla_args((b, 10, 64, 64, 32), device, torch.bfloat16)
    plain = sla.sla_context_plain(xt, wqkv, 8, 32)
    ops.reset_launch_counts()
    staged, _ = sla.sla_context(xt, wqkv, 8, 32)
    assert ops.staged_launch_counts()["sla_context"] == 1
    monkeypatch.setattr(sla, "ctx_plan", lambda *a: {"route": "simt", "chunk": 60, "splits": 1, "groups": 1, "smem": 0})
    simt, stats = sla.sla_context(xt, wqkv, 8, 32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sla_context"] == 2 and ops.staged_launch_counts()["sla_context"] == 1
    for ctx in (staged, simt):
        err, err_unrounded = _rounding_distances(ctx, xt, wqkv)
        assert err < err_unrounded, (err, err_unrounded)
    assert max((t - plain).abs().max().item() for t in (staged, simt)) <= TOL[torch.bfloat16]
    for name, a, w in zip(("max", "sum"), stats, sla.sla_stats_plain(xt, wqkv, 8, 32)):
        assert _rel_err(a, w) <= BWD_TOL[torch.bfloat16], (name, _rel_err(a, w))


# The streaming kernels (the blockwise pair redesigned: panels staged in x's type, warp-owned query rows, the
# products on the tensor cores in bf16) at every length of the long-clip tests and every width of the long
# clip, both types, biased too. The route is the planner's (`blockwise_plan`: the first design only where the
# streaming plan does not fit), and the C launcher reports the one it ran; float32 is also held to the dense
# plain versions; runs are bit-equal, dbias included.
STREAM_F = [65, 72, 96, 128, 321]
STREAM_C = [32, 64, 128, 256]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", STREAM_C)
@pytest.mark.parametrize("f", STREAM_F)
def test_streaming_blockwise_kernels_match_plain(device, f, c, dtype, bias):
    shape = (1, 3, f, c)
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    g = _rand(shape, 5, 0.1, device, dtype)
    w = (wqkv, bqkv, wo, bo)
    pos_bias = _rand((8, f, f), 6, 0.5, device) if bias else None
    kw = {"pos_bias": pos_bias}
    tag = "_biased" if bias else ""
    routes = [ta.temporal_plan(3, f, c, 32, 8, dtype == torch.bfloat16, _sms(), bwd)["route"] for bwd in (False, True)]
    if f == 128:  # every width of the long clip takes the streaming kernels, in either type
        assert routes == ["staged", "staged"]
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, 8, 32)
    grads = ta.temporal_attention_bwd(x, g, *w, 8, 32, **kw)
    torch.cuda.synchronize()
    names = (f"temporal_blockwise{tag}_fwd", f"temporal_blockwise{tag}_bwd")
    assert {k: v for k, v in ops.launch_counts().items() if v} == {n: 1 for n in names}
    assert [ops.staged_launch_counts()[n] for n in names] == [r == "staged" for r in routes]
    want = ta.temporal_attention_blockwise_plain(x, *w, 8, 32, ta.KV_BLOCK, **kw)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    want_grads = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, 8, 32, ta.KV_BLOCK, **kw)
    for k, a, v in zip(GRADS6, grads, want_grads):
        assert a.shape == v.shape and a.dtype == v.dtype, k
        assert _rel_err(a, v) <= BWD_TOL[dtype], (k, _rel_err(a, v))
    if dtype == torch.float32:
        assert (got - ta.temporal_attention_plain(x, *w, 8, 32, **kw)).abs().max().item() <= TOL[dtype]
        for k, a, v in zip(GRADS6, grads, ta.temporal_attention_bwd_plain(x, g, *w, 8, 32, **kw)):
            assert _rel_err(a, v) <= BWD_TOL[dtype], (k, _rel_err(a, v))
    again = ta.temporal_attention_bwd(x, g, *w, 8, 32, **kw)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))
    assert torch.equal(ta._block(x, *w, pos_bias, 8, 32), got)


# The wide columns of C3: f = 64 at widths whose one-token dense tile does not fit (the bottleneck of a dim-128
# Unet3D attends 8x8 = 64 tokens at c = 1024). They take the streaming kernels in mode DENSE, never a plain
# version, with the dense kernels' rounding points. Each output is held to the gates and, in bf16, to the standard
# the staged dense kernels meet at c = 256 (the widest column they hold; checked here of them too): no element
# further from the dense plain version than one bf16 unit in the last place of the output's largest magnitude.
# (Errors are that granular: whether one element near the largest rounds the other way decides between half a unit
# and one, so an error of the wide kernels "no larger than the dense kernel's" would compare two coin flips.) In
# bf16 the float32 gradients show the rounding points: dW_o (which reads the forward's rounded o_h) and dW_qkv,
# db_qkv, dbias lie closer to the dense oracle than to the blockwise one.
def _one_ulp(got, want):
    top = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)


def _dense_errors(shape, device, dtype, bias):
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    g = _rand(shape, 5, 0.1, device, dtype)
    w = (wqkv, bqkv, wo, bo)
    f = shape[2]
    pos_bias = _rand((8, f, f), 6, 0.5, device) if bias else None
    kw = {"pos_bias": pos_bias}
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, 8, 32)
    grads = ta.temporal_attention_bwd(x, g, *w, 8, 32, **kw)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = ta.temporal_attention_plain(x, *w, 8, 32, **kw)
    want_g = ta.temporal_attention_bwd_plain(x, g, *w, 8, 32, **kw)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    for k, a, v in zip(GRADS6, grads, want_g):
        assert _rel_err(a, v) <= BWD_TOL[dtype], (k, _rel_err(a, v))
    if dtype == torch.bfloat16:
        assert _one_ulp(got, want) and all(_one_ulp(a, v) for a, v in zip(grads, want_g))
    return counts, (x, w, kw, g, grads, want_g)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [320, 512, 1024])
def test_wide_columns_take_the_dense_rounding_points(device, c, dtype, bias):
    tag = "_biased" if bias else ""
    counts, _ = _dense_errors((2, 10, 64, 256), device, dtype, bias)  # the dense kernels meet the standard
    assert counts == {f"temporal_attention{tag}_fwd": 1, f"temporal_attention{tag}_bwd": 1}
    counts, (x, w, kw, g, grads, want_g) = _dense_errors((2, 10, 64, c), device, dtype, bias)
    fwd = f"temporal_wide{tag}_fwd" if c >= 374 else f"temporal_attention{tag}_fwd"  # the dense forward holds c < 374
    assert counts == {fwd: 1, f"temporal_wide{tag}_bwd": 1}
    assert all(ops.staged_launch_counts()[k] == 1 for k in counts if "wide" in k)
    if dtype == torch.bfloat16:
        blk_g = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, 8, 32, ta.KV_BLOCK, **kw)
        for keys in (("dwo",), ("dwqkv", "dbqkv", "dbias")):
            idx = [GRADS6.index(k) for k in keys if GRADS6.index(k) < len(grads)]
            dense = max(_rel_err(grads[i], want_g[i]) for i in idx)
            blockwise = max(_rel_err(grads[i], blk_g[i]) for i in idx)
            assert dense < blockwise, (keys, dense, blockwise)
    again = ta.temporal_attention_bwd(x, g, *w, 8, 32, **kw)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


def test_wide_route_is_the_planners(device):
    """The op's family at the dim-128 bottleneck, forward and backward, as ``temporal_plan`` names it."""
    for bwd in (False, True):
        for bf16 in (True, False):
            plan = ta.temporal_plan(20, 64, 1024, 32, 8, bf16, _sms(), bwd)
            assert plan["family"] == "wide" and plan["route"] == "staged"


def test_cuda_core_context_rounds_s(device):
    """The CUDA-core context kernel at the dim-128 bottleneck (c = 1024, where ``ctx_plan`` takes it, bf16)
    rounds s after the softmax's division as the JAX kernel does: it lies closer to the float64 model of the
    JAX rounding points than to the same model without the rounding of s."""
    xt, wqkv, _ = _sla_args((2, 10, 8, 8, 1024), device, torch.bfloat16)
    assert sla.ctx_plan(20, 64, 1024, 32, 8, True, _sms())["route"] == "simt"
    ops.reset_launch_counts()
    ctx, _ = sla.sla_context(xt, wqkv, 8, 32)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sla_context"] == 1 and ops.staged_launch_counts()["sla_context"] == 0
    err, err_unrounded = _rounding_distances(ctx, xt, wqkv)
    assert err < err_unrounded, (err, err_unrounded)
    assert (ctx - sla.sla_context_plain(xt, wqkv, 8, 32)).abs().max().item() <= TOL[torch.bfloat16]
