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
                       xt, torch.zeros(2, 2, 2, 32, device=device), 2, 32)


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
    want = xa.cross_attention_plain(x, k, v, wq, bq, wo, bo, 8, 32)
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    for name, a, w in zip(("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo"), grads,
                          xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, 8, 32)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
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
