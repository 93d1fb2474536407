"""Fused temporal-attention block (counterpart of the JAX package's ops/temporal_attention.py).

    out = x + out_proj(softmax(q(x) k(x)^T / sqrt(D)) v(x))   over the f axis of x (b, s, f, c)

The public op keeps the JAX layouts: ``wqkv`` (c, 3*H*D) packs the q|k|v
kernels, ``bqkv`` is (3*H*D,), ``wo`` is (H*D, c) and ``bo`` is (c,).

Two kernel families, chosen by the attended length alone (the JAX
``_route``): up to ``MAX_FRAMES`` frames the dense kernels of
``csrc/temporal_attention.cu`` hold a token's whole f x f panel; longer clips
take the blockwise (online-softmax) kernels of ``csrc/temporal_blockwise.cu``,
which walk K/V in blocks of ``KV_BLOCK`` frames.

Dispatch has no hidden fallback. A CPU tensor takes the family's plain
version, differentiated by autograd; a CUDA tensor goes through
``_TemporalAttention``, whose forward and backward are the hand-written
kernels, or raises ``NotImplementedError`` for a shape the kernels do not
take. ``temporal_attention_bwd_plain`` and
``temporal_attention_blockwise_bwd_plain`` are the backward kernels'
oracles, with their rounding points.
"""

from __future__ import annotations

import ctypes
import math

import torch

from video_diffusion_nnx_tpu_torch.ops import _build

# The dense kernels hold a token's whole f x f panel; longer clips take the blockwise kernels.
MAX_FRAMES = 64
KV_BLOCK = 32  # KV frames per block of the blockwise kernels, forward and backward alike
_SMEM_TARGET = 100 * 1024  # two CTAs per SM where a tile allows it
_SMEM_MAX = 227 * 1024
_WORKSPACE_MAX = 128 * 2**20  # bytes of per-CTA weight-gradient partials in one backward

launches = {"temporal_attention_fwd": 0, "temporal_attention_bwd": 0,
            "temporal_blockwise_fwd": 0, "temporal_blockwise_bwd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def temporal_attention_plain(x, wqkv, bqkv, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """Plain PyTorch version, with the rounding points of the JAX ``_composite_xla`` (:798-819)."""
    b, s, f, c = x.shape
    dt = x.dtype
    qkv = (x @ wqkv.to(dt)) + bqkv.to(dt)
    qkv = qkv.reshape(b, s, f, 3, heads, dim)
    scale = torch.tensor(1.0 / math.sqrt(dim), dtype=dt, device=x.device)
    q, k, v = qkv[..., 0, :, :] * scale, qkv[..., 1, :, :], qkv[..., 2, :, :]
    sim = torch.einsum("bsihd,bsjhd->bshij", q.float(), k.float())
    attn = torch.softmax(sim, dim=-1)
    o = torch.einsum("bshij,bsjhd->bsihd", attn.to(dt), v).reshape(b, s, f, heads * dim)
    y = (o @ wo.to(dt)) + bo.to(dt)
    return x + y


def temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int):
    """The backward of ``temporal_attention_plain`` by explicit formulas: ``(dx, dwqkv, dbqkv, dwo, dbo)``.

    Rounding points of the JAX ``_bwd_kernel`` (:189-286): q|k|v in x's
    type, the softmax and its VJP in float32, ``attn``, ``do``, ``ds`` and
    ``dqkv`` rounded to x's type before each product, db_qkv summed from the
    unrounded dqkv, float32 weight gradients.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    hd = heads * dim
    f32 = torch.float32
    scale = 1.0 / math.sqrt(dim)
    qkv = ((x.to(f32) @ wqkv.to(dt).to(f32)) + bqkv.to(f32)).to(dt).reshape(b, s, f, 3, heads, dim)
    q = qkv[..., 0, :, :] * torch.tensor(scale, dtype=dt, device=x.device)
    k, v = qkv[..., 1, :, :], qkv[..., 2, :, :]
    attn = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", q.float(), k.float()), dim=-1)
    attn_c = attn.to(dt).float()
    o = torch.einsum("bshij,bsjhd->bsihd", attn_c, v.float()).to(dt).float()
    gf = g.to(f32)
    gc = g.to(dt).float()
    dwo = torch.einsum("bsihd,bsic->hdc", o, gc).reshape(hd, c)
    do = torch.einsum("bsic,hdc->bsihd", gc, wo.to(dt).float().reshape(heads, dim, c)).to(dt).float()
    dattn = torch.einsum("bsihd,bsjhd->bshij", do, v.float())
    dv = torch.einsum("bshij,bsihd->bsjhd", attn_c, do)
    ds = (attn * (dattn - (dattn * attn).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bshij,bsjhd->bsihd", ds, k.float()) * scale
    dk = torch.einsum("bshij,bsihd->bsjhd", ds, q.float())
    dqkv = torch.stack([dq, dk, dv], dim=3).reshape(b, s, f, 3 * hd)
    dbqkv = dqkv.sum((0, 1, 2))
    dqkv_c = dqkv.to(dt).float()
    dwqkv = torch.einsum("bsfc,bsfk->ck", x.float(), dqkv_c)
    dx = (gf + dqkv_c @ wqkv.to(dt).float().t()).to(dt)
    return dx, dwqkv, dbqkv, dwo, gf.sum((0, 1, 2))


def _online_softmax_plain(x, wqkv, bqkv, heads: int, dim: int, kb: int):
    """The blockwise kernels' sweep over KV blocks of ``kb`` frames, in plain PyTorch.

    Returns ``(q, k, v, m, l, acc)``, all float32 and head-major (b, s, H, f, .):
    q|k|v hold values rounded to x's type (q scaled before its one rounding),
    ``m`` and ``l`` the running row maximum and sum of the unrounded
    ``p = exp(s - m)``, ``acc`` the sum of ``round(p) v`` (JAX
    ``_project_q`` :396-402 and ``_online_softmax_pass`` :343-393).
    """
    b, s, f, c = x.shape
    dt = x.dtype
    proj = (x.float() @ wqkv.to(dt).float()) + bqkv.float()
    q, k, v = proj.reshape(b, s, f, 3, heads, dim).permute(3, 0, 1, 4, 2, 5)  # each (b, s, H, f, D)
    q = (q * (1.0 / math.sqrt(dim))).to(dt).float()
    k, v = k.to(dt).float(), v.to(dt).float()
    m = torch.full((b, s, heads, f, 1), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j0 in range(0, f, kb):
        kj, vj = k[..., j0:j0 + kb, :], v[..., j0:j0 + kb, :]
        sim = q @ kj.transpose(-1, -2)
        m_new = torch.maximum(m, sim.amax(-1, keepdim=True))
        p = torch.exp(sim - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vj
        m = m_new
    return q, k, v, m, l, acc


def temporal_attention_blockwise_plain(x, wqkv, bqkv, wo, bo, heads: int, dim: int, kb: int) -> torch.Tensor:
    """Plain PyTorch version of the blockwise forward kernel (JAX ``_fwd_blockwise_kernel`` :405-429).

    The function of ``temporal_attention_plain``, with other rounding points:
    the probabilities round to x's type unnormalised, before the p v
    product, and the division by the row sum comes after it.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    _, _, _, _, l, acc = _online_softmax_plain(x, wqkv, bqkv, heads, dim, kb)
    oh = (acc / l).to(dt).float().transpose(2, 3).reshape(b, s, f, heads * dim)
    y = oh @ wo.to(dt).float() + bo.float()
    return x + y.to(dt)


def temporal_attention_blockwise_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int, kb: int):
    """The blockwise backward kernel's oracle: ``(dx, dwqkv, dbqkv, dwo, dbo)`` by explicit formulas.

    Rounding points of the JAX ``_bwd_blockwise_kernel`` (:432-584): the
    probabilities are rebuilt from ``lse = m + log l``; ``di = rowsum(do * o)``
    uses the unrounded ``do`` and ``o``; p, do, ds, dk|dv and dq round to x's
    type before each product; db_qkv sums the unrounded values; float32
    weight gradients.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    hd = heads * dim
    scale = 1.0 / math.sqrt(dim)
    w = wqkv.to(dt).float()
    q, k, v, m, l, acc = _online_softmax_plain(x, wqkv, bqkv, heads, dim, kb)
    lse = m + torch.log(l)
    oh = acc / l
    gf = g.float()
    gc = g.to(dt).float()
    dwo = torch.einsum("bshid,bsic->hdc", oh.to(dt).float(), gc).reshape(hd, c)
    do = torch.einsum("bsic,hdc->bshid", gc, wo.to(dt).float().reshape(heads, dim, c))
    di = (do * oh).sum(-1, keepdim=True)
    do_c = do.to(dt).float()
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j0 in range(0, f, kb):
        kj, vj = k[..., j0:j0 + kb, :], v[..., j0:j0 + kb, :]
        p = torch.exp(q @ kj.transpose(-1, -2) - lse)
        p_c = p.to(dt).float()
        ds_c = (p * (do_c @ vj.transpose(-1, -2) - di)).to(dt).float()
        dv[..., j0:j0 + kb, :] = p_c.transpose(-1, -2) @ do_c
        dk[..., j0:j0 + kb, :] = ds_c.transpose(-1, -2) @ q
        dq = dq + ds_c @ kj
    dqkv = torch.stack([dq * scale, dk, dv]).permute(1, 2, 4, 0, 3, 5).reshape(b, s, f, 3 * hd)
    dbqkv = dqkv.sum((0, 1, 2))
    dqkv_c = dqkv.to(dt).float()
    dwqkv = torch.einsum("bsfc,bsfk->ck", x.float(), dqkv_c)
    dx = (gf + dqkv_c @ w.t()).to(dt)
    return dx, dwqkv, dbqkv, dwo, gf.sum((0, 1, 2))


def _blockwise_floats(f: int, dim: int, kb: int, backward: bool) -> int:
    """Floats of shared memory of a blockwise kernel (``Dims`` in csrc/temporal_blockwise.cu)."""
    q, kv, p = f * (dim + 1), kb * (2 * dim + 1), f * (kb + 1)
    return 3 * q + 2 * kv + 2 * p + 3 * f if backward else 2 * q + kv + p + 2 * f


def _check_blockwise(f: int, dim: int) -> None:
    """Raises where the backward panels of one token column do not fit shared memory.

    The forward takes the same limit, so that no shape runs forward and then fails backward.
    """
    need = 4 * _blockwise_floats(f, dim, KV_BLOCK, backward=True)
    if need > _SMEM_MAX:
        raise NotImplementedError(
            f"blockwise temporal attention kernel: one token column's panels ({need} B at f={f}, "
            f"head dim {dim}) exceed shared memory"
        )


def _blockwise_grid(tokens: int, f: int, dim: int, backward: bool, device: torch.device) -> int:
    """CTAs of the persistent grid: as many as are resident at once, at most one per token."""
    smem = 4 * _blockwise_floats(f, dim, KV_BLOCK, backward)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tokens, sms * max(1, min(4, _SMEM_MAX // (smem + 1024)))))


def _tile(tokens: int, f: int, c: int, dim: int, device: torch.device, row_floats: int | None = None) -> int:
    """Tokens per CTA: as many as fit the shared-memory target, spread over the SMs."""
    row_bytes = 4 * (row_floats if row_floats is not None else 2 * c + 3 * dim + 1 + f + 1)
    token_bytes = f * row_bytes
    if token_bytes > _SMEM_MAX:
        raise NotImplementedError(
            f"temporal attention kernel: one token's panels ({token_bytes} B at f={f}, c={c}) "
            "exceed shared memory"
        )
    fit = max(1, _SMEM_TARGET // token_bytes)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    spread = max(1, -(-tokens // (2 * sms)))
    return max(1, min(fit, spread, 64))


def _check(x, wqkv, bqkv, wo, bo, heads: int, dim: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (b, s, f, c); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"temporal attention kernel takes float32 or bfloat16, not {x.dtype}")
    b, s, f, c = x.shape
    hd = heads * dim
    if tuple(wqkv.shape) != (c, 3 * hd) or tuple(bqkv.shape) != (3 * hd,):
        raise ValueError(f"wqkv/bqkv shapes {tuple(wqkv.shape)}/{tuple(bqkv.shape)} do not fit c={c}, H*D={hd}")
    if tuple(wo.shape) != (hd, c) or tuple(bo.shape) != (c,):
        raise ValueError(f"wo/bo shapes {tuple(wo.shape)}/{tuple(bo.shape)} do not fit c={c}, H*D={hd}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for t in (wqkv, bqkv, wo, bo):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")


def _launch(x, wqkv, bqkv, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """The forward kernel of x's family on CUDA tensors: dense up to ``MAX_FRAMES``, else blockwise."""
    _check(x, wqkv, bqkv, wo, bo, heads, dim)
    b, s, f, c = x.shape
    wqkv = wqkv.to(x.dtype).contiguous()
    wo = wo.to(x.dtype).contiguous()
    bqkv = bqkv.float().contiguous()
    bo = bo.float().contiguous()
    tokens = b * s
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(dim)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if f <= MAX_FRAMES:
        bt = _tile(tokens, f, c, dim, x.device)
        fn = _build.library("temporal_attention").temporal_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), out.data_ptr(), tokens, f, c, heads, dim, bt, scale, stream,
        )
        _build.check(err, "temporal_attention_fwd")
        launches["temporal_attention_fwd"] += 1
        return out
    _check_blockwise(f, dim)
    grid = _blockwise_grid(tokens, f, dim, False, x.device)
    scratch = torch.empty(grid, f, heads * dim, device=x.device, dtype=x.dtype)  # each CTA's rounded o_h
    fn = _build.library("temporal_blockwise").temporal_blockwise_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), out.data_ptr(), scratch.data_ptr(), tokens, f, c, heads, dim, KV_BLOCK, grid,
        scale, stream,
    )
    _build.check(err, "temporal_blockwise_fwd")
    launches["temporal_blockwise_fwd"] += 1
    return out


def temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int):
    """Backward of the block: the family's kernel on CUDA tensors, its plain formulas on CPU ones.

    Returns ``(dx, dwqkv, dbqkv, dwo, dbo)``: dx in x's type, the rest float32.
    """
    f = x.shape[-2]
    if not x.is_cuda:
        if f <= MAX_FRAMES:
            return temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads, dim)
        return temporal_attention_blockwise_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads, dim, KV_BLOCK)
    _check(x, wqkv, bqkv, wo, bo, heads, dim)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)} on x's device")
    b, s, f, c = x.shape
    hd = heads * dim
    g = g.to(x.dtype).contiguous()
    wqkv_c = wqkv.to(x.dtype).contiguous()
    wo_c = wo.to(x.dtype).contiguous()
    bqkv_f = bqkv.float().contiguous()
    tokens = b * s
    total = c * 3 * hd + 3 * hd + hd * c + c
    scale = 1.0 / math.sqrt(dim)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dx = torch.empty_like(x)
    grads = torch.empty(total, device=x.device, dtype=torch.float32)
    if f <= MAX_FRAMES:
        if dim % 4:
            raise NotImplementedError(f"the temporal backward kernel takes head dims divisible by 4, not {dim}")
        row_floats = 2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1
        bt = _tile(tokens, f, c, dim, x.device, row_floats)
        smem = 4 * bt * f * row_floats
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per_sm = 2 if 2 * (smem + 1024) <= 228 * 1024 else 1
        grid = max(1, min(-(-tokens // bt), sms * per_sm, _WORKSPACE_MAX // (4 * total)))
        partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
        fn = _build.library("temporal_attention").temporal_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), wqkv_c.data_ptr(), bqkv_f.data_ptr(),
            wo_c.data_ptr(), dx.data_ptr(), partial.data_ptr(), grads.data_ptr(), tokens, f, c,
            heads, dim, bt, grid, scale, stream,
        )
        _build.check(err, "temporal_attention_bwd")
        launches["temporal_attention_bwd"] += 1
    else:
        _check_blockwise(f, dim)
        grid = min(_blockwise_grid(tokens, f, dim, True, x.device), max(1, _WORKSPACE_MAX // (4 * total)))
        partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
        # Each CTA's rounded o_h (H*D per frame row) and dq|dk|dv (3*H*D) of its current token.
        scratch = torch.empty(grid, f, 4 * hd, device=x.device, dtype=x.dtype)
        wqkv_t = wqkv_c.t().contiguous()
        wo_t = wo_c.t().contiguous()
        fn = _build.library("temporal_blockwise").temporal_blockwise_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), wqkv_c.data_ptr(), wqkv_t.data_ptr(),
            bqkv_f.data_ptr(), wo_t.data_ptr(), dx.data_ptr(), partial.data_ptr(), grads.data_ptr(),
            scratch.data_ptr(), tokens, f, c, heads, dim, KV_BLOCK, grid, scale, stream,
        )
        _build.check(err, "temporal_blockwise_bwd")
        launches["temporal_blockwise_bwd"] += 1
    dwqkv, dbqkv, dwo, dbo = grads.split([c * 3 * hd, 3 * hd, hd * c, c])
    return dx, dwqkv.view(c, 3 * hd), dbqkv, dwo.view(hd, c), dbo


class _TemporalAttention(torch.autograd.Function):
    """The block on CUDA tensors: forward and backward are the hand-written kernels."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, heads: int, dim: int):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo)
        ctx.heads, ctx.dim = heads, dim
        return _launch(x, wqkv, bqkv, wo, bo, heads, dim)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, bo = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwo, dbo = temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, ctx.heads, ctx.dim)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype),
                None, None)


def fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """``x + MHA(x)`` over the second-to-last axis of ``x`` (b, s, f, c); differentiable."""
    if x.is_cuda:
        return _TemporalAttention.apply(x, wqkv, bqkv, wo, bo, heads, dim)
    f = x.shape[-2]
    if f <= MAX_FRAMES:
        return temporal_attention_plain(x, wqkv, bqkv, wo, bo, heads, dim)
    return temporal_attention_blockwise_plain(x, wqkv, bqkv, wo, bo, heads, dim, KV_BLOCK)


def pack_mha_weights(mha) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A MultiheadAttention module's weights in the op's layouts (JAX ``pack_mha_weights``)."""
    wqkv = torch.cat([mha.q.weight.t(), mha.k.weight.t(), mha.v.weight.t()], dim=-1)
    bqkv = torch.cat([mha.q.bias, mha.k.bias, mha.v.bias])
    return wqkv, bqkv, mha.out.weight.t(), mha.out.bias
