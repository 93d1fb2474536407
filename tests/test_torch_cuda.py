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

import functools
import math

import numpy as np
import pytest
import torch

from video_diffusion_nnx_tpu_torch import ops
from video_diffusion_nnx_tpu_torch.ops import _build
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


def _fwd_kernel(tokens, f, c, dim, heads, bf16, bias=False):
    """The forward kernel's launch name as ``temporal_plan`` gives it on this card (a float32 forward the staged tile
    cannot hold may take the wide family, by the measured rule)."""
    plan = ta.temporal_plan(tokens, f, c, dim, heads, bf16, torch.cuda.get_device_properties(0).multi_processor_count,
                            False)
    family = "attention" if plan["family"] == "dense" else plan["family"]
    return f"temporal_{family}{'_biased' if bias else ''}_fwd"


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
    assert ops.launch_counts()[_fwd_kernel(b * s, f, c, dim, heads, dtype == torch.bfloat16)] == 1
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
    fwd = _fwd_kernel(shape[0] * shape[1], f, shape[3], 32, 8, dtype == torch.bfloat16, True)  # f32 (64, 256): wide
    assert {k: v for k, v in ops.launch_counts().items() if v} == {fwd: 1, f"temporal_{family}_biased_bwd": 1}
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


@pytest.mark.parametrize("sharding", ["tensor", "fsdp"])
def test_gloo_ranks_train_data_parallel_on_one_card(device, tmp_path, sharding):
    """Two gloo ranks on cuda:0, two data-parallel steps of a fused Unet3D from the loader, replicated ("tensor": no
    model axis) or under FSDP: every launch staged, the ranks' losses and gathered states bit-equal, FSDP's
    resident state half of each sharded tensor."""
    import torch.multiprocessing as mp

    import torch_mesh_workers

    data = tmp_path / "clips.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(10, 8, 32, 32), dtype=np.uint8))
    mp.spawn(torch_mesh_workers.card_train_main,
             args=(2, f"file://{tmp_path / 'store'}", str(data), str(tmp_path), sharding), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"{sharding}{r}.pt") for r in range(2)]
    for res in ranks:
        assert res["device"] == "cuda:0" and all(math.isfinite(v) for v in res["losses"])
        assert res["launches"] and res["staged"] == res["launches"], res["launches"]
        assert res["launches"]["temporal_attention_fwd"] == res["launches"]["temporal_attention_bwd"] > 0
    assert ranks[0]["losses"] == ranks[1]["losses"] and ranks[0]["launches"] == ranks[1]["launches"]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v) and torch.equal(ranks[1]["ema"][k], ranks[0]["ema"][k]), k
    if sharding == "fsdp":
        assert ranks[0]["resident"] and all(
            2 * math.prod(s["param"]) == ranks[0]["state"][k].numel() for k, s in ranks[0]["resident"].items())
    else:
        assert ranks[0]["resident"] == {}


@pytest.mark.parametrize("what", ["ddim", "distill"])
def test_gloo_ranks_sample_and_distill_on_one_card(device, tmp_path, what):
    """Two gloo ranks on cuda:0, two rows each of a batch of 4 of a fused bf16 Unet3D: DDIM-5, each rank replaying
    its own graph (each forward kernel twice at the one capture), the gathered batch bit-equal over the ranks and
    within the graph phase's 1e-3 on [0, 1] of one rank sampling each rank's rows from the same x_T (a kernel's bf16
    rounding depends on the rows it is given, so the whole batch on one rank is no reference); or two distillation
    steps (three forwards and a backward a step), the ranks' losses and parameters bit-equal. Every launch staged."""
    import torch.multiprocessing as mp

    import torch_mesh_workers
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    mp.spawn(torch_mesh_workers.card_dp_main, args=(2, f"file://{tmp_path / 'store'}", str(tmp_path), what),
             nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"{what}{r}.pt") for r in range(2)]
    unet = Unet3D(dim=32, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", use_fused_attention=True,
                  use_fused_spatial_attention=True)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    one = GaussianDiffusion(unet, image_size=32, num_frames=10, channels=1, timesteps=100, loss_type="l2",
                            prediction_type="v").to(device).eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        one.denoise_fn.forward_with_cond_scale(torch.zeros((2, 1, 10, 32, 32), device=device),
                                               torch.zeros(2, dtype=torch.long, device=device))
    per_forward = {k: v for k, v in ops.launch_counts().items() if v}
    if what == "ddim":
        want = {k: 2 * n for k, n in per_forward.items()}
    else:  # two steps of three forwards (two of the teacher, one of the student) and the student's backward
        want = {k: 2 * 3 * n for k, n in per_forward.items()}
        want.update({k[:-3] + "bwd": 2 * n for k, n in per_forward.items() if k.endswith("_fwd")})
        want.update({"sla_bwd_q": 2 * per_forward["sla_out"], "sla_bwd_kv": 2 * per_forward["sla_out"]})
    for res in ranks:
        assert res["device"] == "cuda:0" and res["launches"] == res["staged"] == want, (res["launches"], want)
    if what == "ddim":
        assert all(res["graph"] == {"captures": 1, "replays": 5} for res in ranks)
        assert torch.equal(ranks[0]["videos"], ranks[1]["videos"])
        x_T = torch.randn((4, 1, 10, 32, 32), generator=torch.Generator(device=device).manual_seed(1), device=device)
        solo = torch.cat([one.ddim_sample(batch_size=2, num_steps=5, init_noise=x_T[rows]) for rows in (slice(0, 2),
                                                                                                       slice(2, 4))])
        assert (ranks[0]["videos"] - solo.float().cpu()).abs().max().item() <= 1e-3
    else:
        assert all(math.isfinite(v) for v in ranks[0]["losses"]) and ranks[0]["losses"] == ranks[1]["losses"]
        assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))


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
    kernel (in float32 its products in 3xTF32), and that one the streaming kernel in mode DENSE by the measured
    rule (`_f32_fwd_takes_stream`); a zero bias reproduces the unbiased kernel bit for bit."""
    b, s, f, c = shape
    plan = ta.temporal_plan(b * s, f, c, 32, 8, dtype == torch.bfloat16, _sms(), False)
    staged = "staged" if dtype == torch.bfloat16 else ta.STAGED_3XTF32
    assert plan["route"] == staged
    assert plan["family"] == ("wide" if dtype == torch.float32 and (f, c) == (64, 256) else "dense")
    x, wqkv, bqkv, wo, bo = _temporal_args(shape, device, dtype)
    pos_bias = _rand((8, f, f), 6, 0.5, device) if bias else None
    ops.reset_launch_counts()
    got = ta._block(x, wqkv, bqkv, wo, bo, pos_bias, 8, 32)
    torch.cuda.synchronize()
    name = _fwd_kernel(b * s, f, c, 32, 8, dtype == torch.bfloat16, bias)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {name: 1}
    assert ops.staged_launch_counts()[name] == 1  # the C launcher chose as the planner
    assert ops.staged_tf32x3_launch_counts()[name] == (plan["route"] == ta.STAGED_3XTF32)
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
    if f == 128:  # every width of the long clip takes the streaming kernels, in either type, but the float32 backward
        # (its products and attention fragments in 3xTF32) only up to c = 32, the measured rule; wider, tf32x3
        f32_bwd = ta.STAGED_3XTF32 if c <= 32 else "tf32x3"
        assert routes == (["staged", "staged"] if dtype == torch.bfloat16 else [ta.STAGED_3XTF32, f32_bwd])
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, 8, 32)
    grads = ta.temporal_attention_bwd(x, g, *w, 8, 32, **kw)
    torch.cuda.synchronize()
    names = (f"temporal_blockwise{tag}_fwd", f"temporal_blockwise{tag}_bwd")
    assert {k: v for k, v in ops.launch_counts().items() if v} == {n: 1 for n in names}
    assert [ops.staged_launch_counts()[n] for n in names] == [r in ("staged", ta.STAGED_3XTF32) for r in routes]
    assert [ops.staged_tf32x3_launch_counts()[n] for n in names] == [r == ta.STAGED_3XTF32 for r in routes]
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
    bf16 = dtype == torch.bfloat16
    counts, _ = _dense_errors((2, 10, 64, 256), device, dtype, bias)  # the dense kernels meet the standard
    # (in float32 the forward takes the streaming kernel there too, by the measured rule)
    assert counts == {_fwd_kernel(20, 64, 256, 32, 8, bf16, bias): 1, f"temporal_attention{tag}_bwd": 1}
    counts, (x, w, kw, g, grads, want_g) = _dense_errors((2, 10, 64, c), device, dtype, bias)
    fwd = _fwd_kernel(20, 64, c, 32, 8, bf16, bias)  # the dense forward holds c < 374 in bf16
    assert fwd == f"temporal_{'wide' if c >= 374 or not bf16 else 'attention'}{tag}_fwd"
    assert counts == {fwd: 1, f"temporal_wide{tag}_bwd": 1}
    # the streaming kernels, but for the float32 backward: the tensor-core design of csrc/temporal_tf32x3.cu
    f32_bwd = f"temporal_wide{tag}_bwd" if dtype == torch.float32 else None
    assert all(ops.staged_launch_counts()[k] == (k != f32_bwd) for k in counts if "wide" in k)
    assert all(ops.tf32x3_launch_counts()[k] == (k == f32_bwd) for k in counts if "wide" in k)
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
            f32 = "tf32x3" if bwd else ta.STAGED_3XTF32
            assert plan["family"] == "wide" and plan["route"] == ("staged" if bf16 else f32)


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


def _graph_model(device, timesteps: int = 10, fused: bool = True, **unet_kwargs):
    """A small bf16 Unet3D on both kernels (the flagship's layout at dim 16), v-prediction; ``fused=False``
    runs the plain modules instead."""
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=16, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", use_fused_attention=fused,
                  use_fused_spatial_attention=fused, **unet_kwargs)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    return GaussianDiffusion(unet, image_size=16, num_frames=10, channels=1, timesteps=timesteps, loss_type="l2",
                             prediction_type="v").to(device).eval()


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("sampler", ["ddim3", "dpm3", "ddpm", "cond_ddim3", "interpolate"])
def test_graph_replay_equals_eager(device, sampler):
    """A replay runs the same kernels on the same inputs, and the sampler's draws stay eager: bit-equal."""
    model = _graph_model(device)
    known = torch.rand(2, 1, 10, 16, 16, device=device, generator=_gen(9))
    run = {
        "ddim3": lambda g, graph: model.ddim_sample(batch_size=2, num_steps=3, eta=0.5, generator=g, graph=graph),
        "dpm3": lambda g, graph: model.dpm_solver_sample(batch_size=2, num_steps=3, generator=g, graph=graph),
        "ddpm": lambda g, graph: model.sample(batch_size=2, generator=g, graph=graph),
        "cond_ddim3": lambda g, graph: model.sample_conditional_frames(known, [True] * 3 + [False] * 7, num_steps=3,
                                                                      generator=g, graph=graph),
        "interpolate": lambda g, graph: model.interpolate(known * 2 - 1, 1 - known * 2, t=4, generator=g,
                                                          graph=graph),
    }[sampler]
    ops.reset_launch_counts()
    graphed = run(_gen(1), True)
    torch.cuda.synchronize()
    captured = ops.launch_counts()
    steps = {"ddim3": 3, "dpm3": 3, "ddpm": 10, "cond_ddim3": 3, "interpolate": 4}[sampler]
    assert model.graphs.captures == 1 and model.graphs.replays() == steps
    # The wrappers run twice per capture (a warm-up forward, then the capture), never at a replay: a forward of
    # two levels launches 7 temporal (1 + 2 + 2 at the middle + 2) and 4 spatial kernels of each stage.
    assert captured["temporal_attention_fwd"] == 2 * 7 and captured["sla_context"] == 2 * 4
    eager = run(_gen(1), False)
    assert torch.equal(graphed, eager)


def test_graph_cache_is_bounded_and_evicts_the_oldest(device):
    from video_diffusion_nnx_tpu_torch.diffusion.graphs import MAX_GRAPHS

    model = _graph_model(device)
    for b in range(1, MAX_GRAPHS + 2):
        model.dpm_solver_sample(batch_size=b, num_steps=2, generator=_gen(b))
    assert len(model.graphs) == MAX_GRAPHS
    assert model.graphs.captures == MAX_GRAPHS + 1 and model.graphs.replays() == 2 * (MAX_GRAPHS + 1)
    assert [s[0] for s in model.graphs.shapes()] == list(range(2, MAX_GRAPHS + 2))
    model.dpm_solver_sample(batch_size=1, num_steps=2, generator=_gen(0))  # evicted: captured again
    assert model.graphs.captures == MAX_GRAPHS + 2 and model.graphs.shapes()[-1][0] == 1


def test_weight_reload_and_moves_drop_the_graphs(device):
    model = _graph_model(device)
    before = model.ddim_sample(batch_size=2, num_steps=2, generator=_gen(3))
    assert len(model.graphs) == 1
    state = {k: v * 0.5 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    assert len(model.graphs) == 0
    after = model.ddim_sample(batch_size=2, num_steps=2, generator=_gen(3))
    eager = model.ddim_sample(batch_size=2, num_steps=2, generator=_gen(3), graph=False)
    assert torch.equal(after, eager) and not torch.equal(after, before)
    model.to(device)
    assert len(model.graphs) == 0


@pytest.mark.parametrize("fused,compat", [(False, True), (False, False), (True, False)])
def test_graph_replay_equals_eager_in_both_maths_and_routes(device, fused, compat):
    """The plain modules and fixed math capture too (no host copy inside the forward): graphed equals eager."""
    model = _graph_model(device, fused=fused, reference_compat=compat)
    graphed = model.ddim_sample(batch_size=2, num_steps=3, generator=_gen(2))
    eager = model.ddim_sample(batch_size=2, num_steps=3, generator=_gen(2), graph=False)
    assert model.graphs.captures == 1 and model.graphs.replays() == 3
    assert torch.equal(graphed, eager)


def _cond_graph_model(device, fused: bool = True, **unet_kwargs):
    """``_graph_model`` conditioned on 768-wide text embeddings (the hashed captions of ``models/text.py``)."""
    return _graph_model(device, fused=fused, use_bert_text_cond=True, **unet_kwargs)


@pytest.fixture
def hashed_text(monkeypatch):
    from video_diffusion_nnx_tpu_torch.models import text

    monkeypatch.setattr(text, "_hf", False)  # the hashed embedding, never a HuggingFace cache


CAPTIONS = ["one digit", "three digits"]


@pytest.mark.parametrize("sampler", ["ddim3", "dpm3", "ddpm", "cond_ddim3"])
@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_conditioned_graph_replay_equals_eager(device, hashed_text, sampler, cond_scale):
    """A conditioned graph (the condition copied into its static buffer, the doubled batch and the guidance
    combination inside the capture) replays what the eager forward computes: bit-equal."""
    model = _cond_graph_model(device)
    known = torch.rand(2, 1, 10, 16, 16, device=device, generator=_gen(9))
    kw = {"cond": CAPTIONS, "cond_scale": cond_scale}
    run = {
        "ddim3": lambda g, graph: model.ddim_sample(num_steps=3, generator=g, graph=graph, **kw),
        "dpm3": lambda g, graph: model.dpm_solver_sample(num_steps=3, generator=g, graph=graph, **kw),
        "ddpm": lambda g, graph: model.sample(generator=g, graph=graph, **kw),
        "cond_ddim3": lambda g, graph: model.sample_conditional_frames(known, [True] * 3 + [False] * 7, num_steps=3,
                                                                      generator=g, graph=graph, **kw),
    }[sampler]
    ops.reset_launch_counts()
    graphed = run(_gen(1), True)
    torch.cuda.synchronize()
    captured = ops.launch_counts()
    steps = {"ddim3": 3, "dpm3": 3, "ddpm": 10, "cond_ddim3": 3}[sampler]
    assert model.graphs.captures == 1 and model.graphs.replays() == steps
    # Guidance doubles the rows of one forward, not the forwards: the wrappers still run twice per capture.
    assert captured["temporal_attention_fwd"] == 2 * 7 and captured["sla_context"] == 2 * 4
    eager = run(_gen(1), False)
    assert torch.equal(graphed, eager)
    assert tuple(graphed.shape) == (2, 1, 10, 16, 16) and bool(torch.isfinite(graphed).all())


def test_conditioned_graph_cache_keys_the_scale_and_the_condition(device, hashed_text):
    """cond_scale and whether a condition is present are part of a graph's key (as in the JAX package's program
    cache): each scale captures its own graph, a repeat replays it, and the guided output differs."""
    model = _cond_graph_model(device)
    outs = {}
    for cs in (1.0, 3.0, 1.0, 3.0, 5.0):
        outs[cs] = model.ddim_sample(num_steps=2, generator=_gen(4), cond=CAPTIONS, cond_scale=cs)
    assert model.graphs.captures == 3 and len(model.graphs) == 3 and model.graphs.replays() == 10
    assert not torch.equal(outs[1.0], outs[3.0]) and not torch.equal(outs[3.0], outs[5.0])
    unconditioned = _graph_model(device)
    unconditioned.ddim_sample(batch_size=2, num_steps=2, generator=_gen(4))
    unconditioned.ddim_sample(batch_size=2, num_steps=2, generator=_gen(4), cond=torch.zeros(2, 8, device=device))
    assert unconditioned.graphs.captures == 2  # with a condition (ignored by the model) is another graph


@pytest.mark.parametrize("fused", [True, False])
def test_batched_guidance_equals_two_forwards_on_the_card(device, fused):
    """forward_with_cond_scale's one forward of 2b rows against a conditioned and a null forward of b rows."""
    model = _cond_graph_model(device, fused=fused)
    unet = model.denoise_fn
    x = _rand((2, 1, 10, 16, 16), 1, 1.0, device)
    t = torch.tensor([3, 7], device=device)
    cond = _rand((2, 768), 2, 1.0, device)
    with torch.no_grad():
        guided = unet.forward_with_cond_scale(x, t, cond=cond, cond_scale=3.0)
        c = unet(x, t, cond=cond, null_cond_mask=torch.zeros(2, dtype=torch.bool, device=device))
        n = unet(x, t, cond=cond, null_cond_mask=torch.ones(2, dtype=torch.bool, device=device))
    want = n + (c - n) * 3.0
    assert guided.dtype == torch.float32
    assert (guided - want).abs().max().item() <= 0.02 * want.abs().max().item()


# The VideoDiT's attentions (models/dit.py: the fused route hands both ops float32, what the bf16 policy's float32
# modulation gives them). D1 is scripts/ab_dit_fused.py:35-39's DiT at 16 frames of 64x64 (dim 256, 8 heads of 32,
# patch 4: spatial attention over 256 patches, temporal over 16 frames), at batch 2; D2 is bench.py's do_dit shape
# (dim 384, 6 heads of 64, patch 8, 10 frames: spatial over 64 patches, temporal over 10 frames), at batch 4. Each
# shape launches the family and the route that ``temporal_plan`` gives it, and matches its plain versions.
DIT_SHAPES = {
    "d1_spatial": ((2, 16, 256, 256), 8, 32, "blockwise"),
    "d1_temporal": ((2, 256, 16, 256), 8, 32, "attention"),
    "d2_spatial": ((4, 10, 64, 384), 6, 64, "wide"),
    "d2_temporal": ((4, 64, 10, 384), 6, 64, "attention"),
}


@pytest.mark.parametrize("name", list(DIT_SHAPES))
def test_dit_attention_shapes_match_plain_in_float32(device, name):
    shape, heads, dim, family = DIT_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    g = _rand(shape, 5, 0.1, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    routes = [ta.temporal_plan(b * s, f, c, dim, heads, False, sms, bwd)["route"] for bwd in (False, True)]
    ops.reset_launch_counts()
    got = ta.fused_temporal_attention_block(x, *w, heads, dim)
    grads = ta.temporal_attention_bwd(x, g, *w, heads, dim)
    torch.cuda.synchronize()
    names = [f"temporal_{family}_fwd", f"temporal_{family}_bwd"]
    assert {k: v for k, v in ops.launch_counts().items() if v} == {n: 1 for n in names}
    assert [ops.staged_launch_counts()[n] for n in names] == [r in ("staged", ta.STAGED_3XTF32) for r in routes]
    # every backward takes the float32 tensor-core design of csrc/temporal_tf32x3.cu; D1's temporal one (whose
    # staged tile fits) by the measured rule (c = 256 > 64)
    assert routes[1] == "tf32x3"
    assert [ops.staged_tf32x3_launch_counts()[n] for n in names] == [r == ta.STAGED_3XTF32 for r in routes]
    assert [ops.tf32x3_launch_counts()[n] for n in names] == [r == "tf32x3" for r in routes]
    if family == "blockwise":
        want = ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK)
        want_g = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK)
    else:
        want = ta.temporal_attention_plain(x, *w, heads, dim)
        want_g = ta.temporal_attention_bwd_plain(x, g, *w, heads, dim)
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    for k, a, v in zip(GRADS6, grads, want_g):
        assert a.shape == v.shape and a.dtype == v.dtype, k
        assert _rel_err(a, v) <= BWD_TOL[torch.float32], (k, _rel_err(a, v))


def _dit_model(device, seed: int = 0, **kw):
    """A small VideoDiT (dim 64, 2 blocks, 2 heads of 32, patch 4, 6 frames of 16x16) with its adaLN drawn at std
    0.05, so that every attention reaches the output."""
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import VideoDiT

    dit = VideoDiT(dim=64, depth=2, channels=1, attn_heads=2, attn_dim_head=32, patch_size=4, **kw)
    dit.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for lin in [blk.ada for blk in dit.blocks] + [dit.final_ada, dit.final_proj]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.05)
    return GaussianDiffusion(dit, image_size=16, num_frames=6, channels=1, timesteps=10, loss_type="l2",
                             prediction_type="v").to(device).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_kernel_route_matches_the_cpu(device, dtype):
    """The fused route on the card (both attentions through the dense kernels, in float32 whatever the policy)
    against the same weights on the CPU (the plain versions): the forward and every parameter's gradient."""
    model = _dit_model(device, compute_dtype=dtype, use_fused_attention=True)
    cpu = _dit_model(torch.device("cpu"), compute_dtype=dtype, use_fused_attention=True)
    x = _rand((2, 1, 6, 16, 16), 1, 1.0, device)
    t = torch.tensor([2, 7], device=device)
    outs = {}
    for where, m in (("cuda", model), ("cpu", cpu)):
        m.zero_grad()
        ops.reset_launch_counts()
        y = m.denoise_fn(x.to(where), t.to(where))
        (y * x.to(where).permute(0, 2, 3, 4, 1)).sum().backward()
        outs[where] = (y.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()})
        if where == "cuda":
            assert {k: v for k, v in ops.launch_counts().items() if v} == {
                "temporal_attention_fwd": 4, "temporal_attention_bwd": 4}
    tol = 1e-4 if dtype == "float32" else 0.05
    scale = outs["cpu"][0].abs().max().item()
    assert (outs["cuda"][0] - outs["cpu"][0]).abs().max().item() <= tol * max(1.0, scale)
    for k, grad in outs["cpu"][1].items():
        top = max(1.0, grad.abs().max().item())
        assert (outs["cuda"][1][k] - grad).abs().max().item() <= (1e-3 if dtype == "float32" else 0.05) * top, k
    assert all(outs["cuda"][1][k].abs().max() > 0 for k in outs["cuda"][1] if ".attn_" in k and "weight" in k)


@pytest.mark.parametrize("sampler", ["ddim3", "dpm3"])
def test_dit_graph_replay_equals_eager(device, sampler):
    model = _dit_model(device, compute_dtype="bfloat16", use_fused_attention=True)
    run = {
        "ddim3": lambda g, graph: model.ddim_sample(batch_size=2, num_steps=3, generator=g, graph=graph),
        "dpm3": lambda g, graph: model.dpm_solver_sample(batch_size=2, num_steps=3, generator=g, graph=graph),
    }[sampler]
    ops.reset_launch_counts()
    graphed = run(_gen(1), True)
    torch.cuda.synchronize()
    assert model.graphs.captures == 1 and model.graphs.replays() == 3
    assert {k: v for k, v in ops.launch_counts().items() if v} == {"temporal_attention_fwd": 2 * 4}
    assert torch.equal(graphed, run(_gen(1), False))


def test_dit_guidance_runs_one_forward_of_2b_rows(device, hashed_text):
    model = _dit_model(device, compute_dtype="bfloat16", use_fused_attention=True, use_bert_text_cond=True)
    rows, launch = [], ta._launch

    def spy(x, *args, **kwargs):
        rows.append(x.shape[0])
        return launch(x, *args, **kwargs)

    ta._launch = spy
    try:
        with torch.no_grad():
            out = model.ddim_sample(num_steps=2, generator=_gen(3), cond=CAPTIONS, cond_scale=3.0, graph=False)
    finally:
        ta._launch = launch
    assert out.shape == (len(CAPTIONS), 1, 6, 16, 16) and bool(torch.isfinite(out).all())
    assert rows == [2 * len(CAPTIONS)] * (2 * 4)


# Distillation (training/distill.py, training/guidance.py): a progressive or guidance step on the card runs three
# denoiser forwards and one backward through the kernels (a two-level Unet3D: 7 temporal and 4 of each spatial
# kernel a forward, the same a backward), and matches the same step on the CPU from the same weights and draws
# (float32, TF32 off: the loss within 1e-4 of it, each gradient within 1e-3 of its largest value, as the DiT's route
# test); a guidance-distilled student samples with one forward of b rows a step, graphed equal to eager.
DISTILL_LAUNCHES = {"temporal_attention_fwd": 3 * 7, "sla_context": 3 * 4, "sla_out": 3 * 4,
                    "temporal_attention_bwd": 7, "sla_bwd_q": 4, "sla_bwd_kv": 4}


def _distill_model(device, seed: int = 0, **unet_kwargs):
    """A float32 two-level Unet3D on both kernels, v-prediction, T = 16, every weight and bias drawn."""
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=16, dim_mults=(1, 2), channels=1, use_fused_attention=True, use_fused_spatial_attention=True,
                  **unet_kwargs)
    unet.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith("bias") or "guidance_mlp.layers.3" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return GaussianDiffusion(unet, image_size=16, num_frames=10, channels=1, timesteps=16, loss_type="l2",
                             prediction_type="v").to(device).eval()


def _step_on(where, kind, device):
    """One distillation step of ``kind`` ("progressive", "stage2", "guidance") on ``where``, with fixed draws;
    returns (loss, gradients, launches)."""
    from video_diffusion_nnx_tpu_torch.training import distill, guidance

    dev = torch.device(where)
    x = torch.rand(2, 1, 10, 16, 16, generator=torch.Generator().manual_seed(3)).to(dev)
    eps = _rand((2, 1, 10, 16, 16), 4, 1.0, dev)
    cond = _rand((2, 768), 5, 1.0, dev)
    w = torch.tensor([1.5, 6.0], device=dev)
    if kind == "guidance":
        teacher = _distill_model(dev, use_bert_text_cond=True)
        student = _distill_model(dev, seed=7, use_bert_text_cond=True, guidance_embed=True)
        guidance.transfer_teacher_params(student, teacher)
        step = guidance.GuidanceStep(teacher, student)
        args = dict(t=torch.tensor([3, 12], device=dev), eps=eps, w=w)
    else:
        stage2 = kind == "stage2"
        teacher = _distill_model(dev, **({"use_bert_text_cond": True, "guidance_embed": True} if stage2 else {}))
        step = distill.DistillStep(teacher, 4, w_range=(1.0, 8.0) if stage2 else None)
        args = dict(i=torch.tensor([0, 3], device=dev), eps=eps, w=w if stage2 else None)
    ops.reset_launch_counts()
    loss = step(x, cond if kind != "progressive" else None, **args)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu() for k, p in step.student.named_parameters()}
    return loss.item(), grads, launches


@pytest.mark.parametrize("kind", ["progressive", "stage2", "guidance"])
def test_distillation_step_runs_the_kernels_and_matches_the_cpu(device, kind):
    loss, grads, launches = _step_on("cuda", kind, device)
    cpu_loss, cpu_grads, _ = _step_on("cpu", kind, device)
    assert launches == DISTILL_LAUNCHES
    assert abs(loss - cpu_loss) <= 1e-4 * max(1.0, abs(cpu_loss))
    for k, g in cpu_grads.items():
        assert (grads[k] - g).abs().max().item() <= 1e-3 * max(1.0, g.abs().max().item()), k
    assert all(grads[k].abs().max() > 0 for k in grads if "guidance_mlp" in k)


@pytest.mark.parametrize("conditioned", [True, False])
def test_guidance_student_samples_one_forward_of_b_rows(device, hashed_text, conditioned):
    """A guidance_embed student at cond_scale 3: each step one forward of b rows, graphed equal to eager, one graph
    per scale, with or without a condition (C7)."""
    model = _graph_model(device, guidance_embed=True, **({"use_bert_text_cond": True} if conditioned else {}))
    out_layer = model.denoise_fn.guidance_mlp.layers[3]  # drawn as training leaves it: at zero w changes nothing
    with torch.no_grad():
        out_layer.weight.copy_(_rand(tuple(out_layer.weight.shape), 8, 0.05, device))
    kw = {"cond": CAPTIONS} if conditioned else {"batch_size": 2}
    rows, launch = [], ta._launch

    def spy(x, *args, **kwargs):
        rows.append(x.shape[0])
        return launch(x, *args, **kwargs)

    graphed = model.ddim_sample(num_steps=3, generator=_gen(1), cond_scale=3.0, **kw)
    ta._launch = spy
    try:
        eager = model.ddim_sample(num_steps=3, generator=_gen(1), cond_scale=3.0, graph=False, **kw)
    finally:
        ta._launch = launch
    assert torch.equal(graphed, eager) and rows == [2] * (3 * 7)
    other = model.ddim_sample(num_steps=3, generator=_gen(1), cond_scale=1.0, **kw)
    assert model.graphs.captures == 2 and not torch.equal(other, graphed)


def test_zero_graft_is_bit_equal_to_the_teacher_on_the_card(device, hashed_text):
    teacher = _graph_model(device, use_bert_text_cond=True)
    student = _graph_model(device, use_bert_text_cond=True, guidance_embed=True)
    from video_diffusion_nnx_tpu_torch.training.guidance import transfer_teacher_params

    transfer_teacher_params(student, teacher)
    x = _rand((2, 1, 10, 16, 16), 1, 1.0, device)
    t = torch.tensor([3, 7], device=device)
    cond = _rand((2, 768), 2, 1.0, device)
    with torch.no_grad():
        want = teacher.denoise_fn.forward_with_cond_scale(x, t, cond=cond, cond_scale=1.0)
        for w in (1.0, 3.0, 8.0):
            assert torch.equal(student.denoise_fn.forward_with_cond_scale(x, t, cond=cond, cond_scale=w), want)


# The float32 tensor-core backward (csrc/temporal_tf32x3.cu: 3xTF32 GEMMs and a per-(token, head) attention
# core), which both families take in float32 where the staged dense tile or the streaming plan does not fit, or
# where the measured rule gives them the shape (c over 64 dense, over 32 streaming): at D1's, D2's and the fixed
# flagship's shapes, and at edges (f = 10, 17, 64, 145, 256, and 144 at c = 256, which the streaming plan holds;
# widths that are not multiples of 4 or of a tile; head dims 20, 32 and 64), biased too. Each
# output within the float32 gate of its plain version, the route and the launch counts the planner's, two runs
# bit-equal.
TF32X3_SHAPES = {
    "d1_spatial": ((8, 16, 256, 256), 8, 32), "d2_temporal": ((4, 64, 10, 384), 6, 64),
    "fixed_bottleneck": ((8, 10, 64, 256), 8, 32), "f10_d64": ((1, 3, 10, 384), 6, 64),
    "f16_d64": ((1, 4, 16, 320), 4, 64), "f17_c301": ((1, 3, 17, 301), 3, 32),
    "f33_c301_d20": ((1, 2, 33, 301), 3, 20), "f64_c258": ((2, 2, 64, 258), 2, 32),
    "f144_streaming": ((1, 2, 144, 256), 8, 32), "f145": ((1, 3, 145, 40), 2, 32), "f256": ((1, 2, 256, 72), 2, 32),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", list(TF32X3_SHAPES))
def test_tf32x3_backward_matches_plain(device, name, bias):
    shape, heads, dim = TF32X3_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    g = _rand(shape, 5, 0.1, device)
    pos_bias = _rand((heads, f, f), 6, 0.5, device) if bias else None
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), True)
    # f = 144 at c = 256 fits the streaming plan, and the measured rule gives it to this design (c > 32)
    assert plan["route"] == "tf32x3"
    kernel = f"temporal_{'attention' if f <= ta.MAX_FRAMES else 'blockwise'}{'_biased' if bias else ''}_bwd"
    ops.reset_launch_counts()
    grads = ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {kernel: 1}
    assert ops.tf32x3_launch_counts()[kernel] == (plan["route"] == "tf32x3")
    assert ops.staged_launch_counts()[kernel] == (plan["route"] == "staged")
    want = (ta.temporal_attention_bwd_plain(x, g, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert len(grads) == len(want)
    for k, a, v in zip(GRADS6, grads, want):
        assert a.shape == v.shape and a.dtype == v.dtype, k
        assert _rel_err(a, v) <= BWD_TOL[torch.float32], (k, _rel_err(a, v))
    again = ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


@pytest.mark.parametrize("dtype,shape,heads,dim", [(torch.float32, (1, 3, 128, 64), 4, 64),
                                                   (torch.bfloat16, (2, 16, 256, 256), 8, 32),
                                                   (torch.float32, (1, 4, 16, 512), 2, 128)])
def test_first_designs_still_take_their_shapes(device, dtype, shape, heads, dim):
    """The first-design backwards stay where the new design does not reach: blockwise head dims over 32, bf16
    beyond f = 192 at c >= 128, and dense head dims over 64 in float32."""
    b, s, f, c = shape
    assert ta.temporal_plan(b * s, f, c, dim, heads, dtype == torch.bfloat16, _sms(), True)["route"] == "simt"
    x, *w = _temporal_args(shape, device, dtype, heads, dim)
    g = _rand(shape, 5, 0.1, device, dtype)
    ops.reset_launch_counts()
    grads = ta.temporal_attention_bwd(x, g, *w, heads, dim)
    torch.cuda.synchronize()
    kernel = f"temporal_{'attention' if f <= ta.MAX_FRAMES else 'blockwise'}_bwd"
    assert ops.launch_counts()[kernel] == 1
    assert ops.staged_launch_counts()[kernel] == ops.tf32x3_launch_counts()[kernel] == 0
    want = (ta.temporal_attention_bwd_plain(x, g, *w, heads, dim) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK))
    for k, a, v in zip(GRADS6, grads, want):
        assert _rel_err(a, v) <= BWD_TOL[dtype], (k, _rel_err(a, v))


# The float32 staged dense backward and the float32 streaming backward, whose products (and the streaming kernel's
# attention fragments) run on the tensor cores in split-precision TF32 (route "staged-3xtf32", C route 3): D1's
# temporal backward, a fixed flagship level and the fixed long clip's top and bottleneck levels, and edges (f = 1,
# 10, 16, 17, 64 dense; 65, 128, 144, 160 streaming, the last the float32 plan's longest; widths that are not
# multiples of 16 or of the streaming chunk; head dims 16, 20 and 32), biased and not. Where the measured rule
# (`_f32_takes_tf32x3`: dense up to c = 64, streaming up to c = 32) gives the shape to tf32x3, the planner says so
# and the C entry refuses the kernel; a build with VDT_ANY_F32_ROUTE defined, a measurement's control, leaves that
# check out, and the kernel runs there all the same. Each output within the float32 gate of its plain version, dbias included; the launch
# counts the route's; two runs bit-equal.
STAGED3_SHAPES = {
    "d1_temporal": ((8, 256, 16, 256), 8, 32), "fixed_c256": ((8, 64, 10, 256), 8, 32),
    "long_top": ((1, 1024, 128, 32), 8, 32), "long_c256": ((1, 64, 128, 256), 8, 32),
    "f1": ((1, 5, 1, 40), 2, 16), "f10_c24": ((2, 3, 10, 24), 2, 16), "f16_c36": ((1, 4, 16, 36), 2, 32),
    "f17_c52_d20": ((1, 3, 17, 52), 3, 20), "f64_c40": ((1, 2, 64, 40), 2, 32), "f65_c48": ((1, 3, 65, 48), 2, 32),
    "f128_c72": ((1, 2, 128, 72), 2, 32), "f144_c100": ((1, 2, 144, 100), 2, 32), "f160_c40": ((1, 2, 160, 40), 2, 32),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", list(STAGED3_SHAPES))
def test_staged_3xtf32_backward_matches_plain(device, monkeypatch, name, bias):
    shape, heads, dim = STAGED3_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    g = _rand(shape, 5, 0.1, device)
    pos_bias = _rand((heads, f, f), 6, 0.5, device) if bias else None
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), True)
    off_rule = ta._f32_takes_tf32x3(f, c, dim)
    assert plan["route"] == ("tf32x3" if off_rule else ta.STAGED_3XTF32)
    kernel = f"temporal_{'attention' if f <= ta.MAX_FRAMES else 'blockwise'}{'_biased' if bias else ''}_bwd"
    if off_rule:  # the C entry holds the planner's rule
        monkeypatch.setattr(ta, "_f32_takes_tf32x3", lambda *_: False)
        with pytest.raises(RuntimeError, match="cudaError"):
            ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
        monkeypatch.setattr(_build, "library", functools.partial(_build.library, defines=("VDT_ANY_F32_ROUTE",)))
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), True)
    assert plan["route"] == ta.STAGED_3XTF32
    assert plan["family"] == ("dense" if f <= ta.MAX_FRAMES else "blockwise")
    ops.reset_launch_counts()
    grads = ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {kernel: 1}
    assert ops.staged_launch_counts()[kernel] == ops.staged_tf32x3_launch_counts()[kernel] == 1
    assert ops.tf32x3_launch_counts()[kernel] == 0
    want = (ta.temporal_attention_bwd_plain(x, g, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert len(grads) == len(want)
    for k, a, v in zip(GRADS6, grads, want):
        assert a.shape == v.shape and a.dtype == v.dtype, k
        assert _rel_err(a, v) <= BWD_TOL[torch.float32], (k, _rel_err(a, v))
    again = ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


# A NaN in the input or in the incoming gradient comes out of both 3xTF32 designs where it comes out of the plain
# version, in every output, dbias included: the split's low part keeps a NaN. The NaNs are the GPU's own
# (0x7fffffff, what 0 / 0 gives there, and its negation), whose high part the rounding's integer add carries into -0.
NAN_SHAPES = {
    "dense_staged": ((2, 3, 10, 24), 2, 16), "stream_staged": ((1, 3, 72, 32), 2, 16),
    "dense_tf32x3": ((2, 3, 10, 96), 2, 32), "stream_tf32x3": ((1, 2, 72, 48), 2, 32),
}


@pytest.mark.parametrize("where", ["x", "g"])
@pytest.mark.parametrize("name", list(NAN_SHAPES))
def test_3xtf32_backwards_keep_nan(device, name, where):
    shape, heads, dim = NAN_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    g = _rand(shape, 5, 0.1, device)
    pos_bias = _rand((heads, f, f), 6, 0.5, device)
    nan = torch.tensor(0x7FFFFFFF if where == "x" else -1, dtype=torch.int32, device=device).view(torch.float32)
    if where == "x":
        x[0, 1, 3, 5] = nan
    else:
        g[b - 1, s - 1, 2, 1] = nan
    route = ta.STAGED_3XTF32 if name.endswith("staged") else "tf32x3"
    assert ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), True)["route"] == route
    ops.reset_launch_counts()
    grads = ta.temporal_attention_bwd(x, g, *w, heads, dim, pos_bias=pos_bias)
    torch.cuda.synchronize()
    kernel = f"temporal_{'attention' if f <= ta.MAX_FRAMES else 'blockwise'}_biased_bwd"
    counts = ops.staged_tf32x3_launch_counts() if route == ta.STAGED_3XTF32 else ops.tf32x3_launch_counts()
    assert ops.launch_counts()[kernel] == counts[kernel] == 1
    want = (ta.temporal_attention_bwd_plain(x, g, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert torch.isnan(grads[0]).any() and torch.isnan(grads[1]).any()
    for k, a, v in zip(GRADS6, grads, want):
        assert torch.equal(torch.isnan(a), torch.isnan(v)), (k, int(torch.isnan(a).sum()), int(torch.isnan(v).sum()))
        keep = ~torch.isnan(v)
        if keep.any():
            assert _rel_err(a[keep], v[keep]) <= BWD_TOL[torch.float32], (k, _rel_err(a[keep], v[keep]))


# The float32 staged dense forward and the float32 streaming forward, whose products and attention fragments run on
# the tensor cores in split-precision TF32 (route "staged-3xtf32", C route 3): at the shapes of every recipe that
# hands them float32 (D1's temporal and spatial attention at batch 8, the fixed flagship's four f = 10 levels at
# batch 8 and its top level at batch 2, the fixed long clip's four f = 128 levels, D2's spatial attention in mode
# DENSE) and at edges (f = 7, 16, 64 dense; 65 and 288, the float32 plan's longest, streaming; head dims 20, 32, 64;
# widths that are not multiples of 16), biased and not. Each output within FWD3_TOL of its plain version (TF32 off
# there), a tenth of the float32 gate, which one TF32 product would miss at every target shape
# (tests/test_torch_fwd_3xtf32.py::test_one_tf32_product_would_miss_the_gate); a zero bias bit-equal to the unbiased
# kernel, two runs bit-equal, the launch counts the route's.
FWD3_TOL = 1e-5
FWD3_SHAPES = {
    "d1_temporal": ((8, 256, 16, 256), 8, 32), "d1_spatial": ((8, 16, 256, 256), 8, 32),
    "d2_spatial": ((4, 10, 64, 384), 6, 64), "fixed_c32": ((8, 4096, 10, 32), 8, 32),
    "fixed_c64": ((8, 1024, 10, 64), 8, 32), "fixed_c128": ((8, 256, 10, 128), 8, 32),
    "fixed_c256": ((8, 64, 10, 256), 8, 32), "fixed_b2_c32": ((2, 4096, 10, 32), 8, 32),
    "long_c32": ((1, 4096, 128, 32), 8, 32), "long_c64": ((1, 1024, 128, 64), 8, 32),
    "long_c128": ((1, 256, 128, 128), 8, 32), "long_c256": ((1, 64, 128, 256), 8, 32),
    "f7_c48_d20": ((3, 5, 7, 48), 3, 20), "f16_c36": ((1, 4, 16, 36), 2, 32), "f64_c40": ((1, 2, 64, 40), 2, 32),
    "f65_c48": ((1, 3, 65, 48), 2, 32), "f288_c40": ((1, 2, 288, 40), 2, 32),
    "fixed_bottleneck": ((8, 10, 64, 256), 8, 32), "long_bottleneck": ((1, 128, 64, 256), 8, 32),
}




@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", list(FWD3_SHAPES))
def test_staged_3xtf32_forward_matches_plain(device, name, bias):
    shape, heads, dim = FWD3_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    pos_bias = _rand((heads, f, f), 6, 0.5, device) if bias else None
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), False)
    assert plan["route"] == ta.STAGED_3XTF32
    kernel = _fwd_kernel(b * s, f, c, dim, heads, False, bias)
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, heads, dim)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {kernel: 1}
    assert ops.staged_launch_counts()[kernel] == ops.staged_tf32x3_launch_counts()[kernel] == 1
    want = (ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert (got - want).abs().max().item() <= FWD3_TOL
    assert torch.equal(ta._block(x, *w, pos_bias, heads, dim), got)
    if bias:
        assert torch.equal(ta._block(x, *w, torch.zeros_like(pos_bias), heads, dim), ta._block(x, *w, None, heads, dim))


# The staged float32 forward's per-token products over key windows at f = 7, 10, 16 and 64 (a 16-row block spans up
# to three tokens, is one token, or a quarter of one), biased: within FWD3_TOL, two runs bit-equal.
@pytest.mark.parametrize("shape", [(3, 5, 7, 48), (2, 64, 10, 32), (2, 16, 16, 256), (1, 3, 64, 40)], ids=str)
def test_staged_3xtf32_forward_key_windows(device, shape):
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, 4, 32)
    pos_bias = _rand((4, f, f), 6, 0.5, device)
    assert ta.temporal_plan(b * s, f, c, 32, 4, False, _sms(), False)["route"] == ta.STAGED_3XTF32
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, 4, 32)
    torch.cuda.synchronize()
    assert ops.staged_tf32x3_launch_counts()["temporal_attention_biased_fwd"] == 1
    want = ta.temporal_attention_plain(x, *w, 4, 32, pos_bias=pos_bias)
    assert (got - want).abs().max().item() <= FWD3_TOL
    assert torch.equal(ta._block(x, *w, pos_bias, 4, 32), got)


# A NaN in the input comes out of both 3xTF32 forwards where it comes out of the plain version (the whole token it
# lies in), and nowhere else: the split's low part keeps a NaN, and at f = 10 and 7, where a 16-row block spans
# tokens, the staged kernel's P V runs per token over that token's keys alone (the tile holds a V that is not
# finite). The GPU's own NaN (0x7fffffff).
@pytest.mark.parametrize("name", ["fixed_c32", "d1_temporal", "f7_c48_d20", "d2_spatial", "f65_c48"])
def test_3xtf32_forwards_keep_nan(device, name):
    shape, heads, dim = FWD3_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    pos_bias = _rand((heads, f, f), 6, 0.5, device)
    x[0, 1, f // 2, c // 3] = torch.tensor(0x7FFFFFFF, dtype=torch.int32, device=device).view(torch.float32)
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, heads, dim)
    torch.cuda.synchronize()
    kernel = _fwd_kernel(b * s, f, c, dim, heads, False, True)
    assert ops.launch_counts()[kernel] == ops.staged_tf32x3_launch_counts()[kernel] == 1
    want = (ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert torch.isnan(want[0, 1]).all() and not torch.isnan(want[0, 0]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert (got[keep] - want[keep]).abs().max().item() <= FWD3_TOL


# The same in bf16 on the staged kernel (route "staged"), whose P V runs per token of a 16-row block over that token's
# keys alone too where a V is not finite (`mma_keys`: the other tokens' V halves cleared in the ldmatrix fragments):
# at f = 10 (the compat flagship's sampler and trainer) and 7 a block spans tokens, at f = 16 it is one. Two runs
# bit-equal, NaN for NaN.
@pytest.mark.parametrize("name", ["fixed_c32", "fixed_c256", "f7_c48_d20", "d1_temporal"])
@pytest.mark.parametrize("bias", [False, True])
def test_bf16_staged_forward_keeps_nan(device, name, bias):
    shape, heads, dim = FWD3_SHAPES[name]
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.bfloat16, heads, dim)
    pos_bias = _rand((heads, f, f), 6, 0.5, device) if bias else None
    x[0, 1, f // 2, c // 3] = float("nan")
    assert ta.temporal_plan(b * s, f, c, dim, heads, True, _sms(), False)["route"] == "staged"
    ops.reset_launch_counts()
    got = ta._block(x, *w, pos_bias, heads, dim)
    torch.cuda.synchronize()
    kernel = _fwd_kernel(b * s, f, c, dim, heads, True, bias)
    assert ops.launch_counts()[kernel] == ops.staged_launch_counts()[kernel] == 1
    want = ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias)
    assert torch.isnan(want[0, 1]).all() and not torch.isnan(want[0, 0]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert (got[keep].float() - want[keep].float()).abs().max().item() <= TOL[torch.bfloat16]
    assert torch.equal(ta._block(x, *w, pos_bias, heads, dim).view(torch.int16), got.view(torch.int16))


# The float32 forwards the staged tile cannot hold: by the measured rule (`_f32_fwd_takes_stream`, f = 64) the fixed
# bottleneck takes the streaming kernel in mode DENSE, and D2's temporal attention (f = 10) keeps the CUDA-core kernel.
# The dense C entry refuses a shape the rule gives to the streaming kernel; a build with VDT_ANY_F32_ROUTE defined, a
# measurement's control, runs the CUDA-core kernel there all the same. Each within the float32 gate.
@pytest.mark.parametrize("shape,heads,dim", [((8, 10, 64, 256), 8, 32), ((4, 64, 10, 384), 6, 64)], ids=str)
def test_float32_forwards_beyond_the_staged_tile_take_the_measured_kernel(device, monkeypatch, shape, heads, dim):
    b, s, f, c = shape
    x, *w = _temporal_args(shape, device, torch.float32, heads, dim)
    want = ta.temporal_attention_plain(x, *w, heads, dim)
    stream = ta._f32_fwd_takes_stream(f, c, dim)
    assert stream == (f == 64)
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, _sms(), False)
    assert (plan["family"], plan["route"]) == (("wide", ta.STAGED_3XTF32) if stream else ("dense", "simt"))
    ops.reset_launch_counts()
    got = ta.fused_temporal_attention_block(x, *w, heads, dim)
    torch.cuda.synchronize()
    kernel = _fwd_kernel(b * s, f, c, dim, heads, False)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {kernel: 1}
    assert ops.staged_tf32x3_launch_counts()[kernel] == int(stream)
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    if stream:  # the dense C entry holds the rule; the control build runs the CUDA-core kernel
        dense = {"family": "dense", **ta.fwd_plan(b * s, f, c, dim, heads, False, _sms())}
        monkeypatch.setattr(ta, "temporal_plan", lambda *_: dense)
        with pytest.raises(RuntimeError, match="cudaError"):
            ta.fused_temporal_attention_block(x, *w, heads, dim)
        monkeypatch.setattr(_build, "library", functools.partial(_build.library, defines=("VDT_ANY_F32_ROUTE",)))
        ops.reset_launch_counts()
        ctrl = ta.fused_temporal_attention_block(x, *w, heads, dim)
        torch.cuda.synchronize()
        assert ops.launch_counts()["temporal_attention_fwd"] == 1 and ops.staged_launch_counts()["temporal_attention_fwd"] == 0
        assert (ctrl - want).abs().max().item() <= TOL[torch.float32]
