"""Fused cross-attention block (counterpart of the JAX package's ops/cross_attention.py).

    out = x + out_proj(softmax(q(x) K^T / sqrt(D)) V)   over the frame axis

with ``x`` (b, s, f_l, c) a rank's local frames and ``k``, ``v`` (b, s, f_g,
H*D) the keys and values of all f_g frames, packed as the frame gather of
``parallel/sequence.py`` makes them. ``wq`` is (c, H*D), ``bq`` (H*D,),
``wo`` (H*D, c) and ``bo`` (c,). With f_l = f_g and K|V projected from x by
an attention's weights, this is that attention's self-attention block.

Dispatch has no hidden fallback. ``fused_cross_attention_block`` is one
autograd function on both devices: on a CUDA tensor its forward and backward
are the hand-written kernels of ``csrc/cross_attention.cu`` (or it raises
for a shape they do not take); on a CPU tensor they are the plain versions,
``cross_attention_plain`` and ``cross_attention_bwd_plain``. The plain
versions keep the TPU kernels' rounding points (an online softmax over KV
blocks of ``KV_BLOCK`` frames, p rounded to x's type before the p V product),
not those of the JAX ``_composite``, so that they are the kernels' oracles.

The weight gradients cross CTAs as in the other backward kernels: per-CTA
float32 partials summed by ``reduce_partials_kernel`` in a fixed order, so
two runs are bit-equal.
"""

from __future__ import annotations

import ctypes
import math

import torch

from video_diffusion_nnx_tpu_torch.ops import _build

KV_BLOCK = 32  # KV frames per block, forward and backward alike
_SMEM_MAX = 227 * 1024
_WORKSPACE_MAX = 128 * 2**20  # bytes of per-CTA weight-gradient partials in one backward

launches = {"cross_attention_fwd": 0, "cross_attention_bwd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _online_plain(x, k, v, wq, bq, heads: int, dim: int, kb: int):
    """The kernels' sweep over KV blocks of ``kb`` frames, in plain PyTorch.

    Returns ``(q, k, v, m, l, acc)``, all float32 and head-major (b, s, H, f, .):
    q = round((x W_q + b_q) * scale) and K, V in x's type (JAX ``_project_q``
    :114-118), ``m`` and ``l`` the running row maximum and sum of the unrounded
    ``p = exp(s - m)``, ``acc`` the sum of ``round(p) v`` (``_stats_sweep`` :79-111).
    """
    b, s, fl, c = x.shape
    fg = k.shape[2]
    dt = x.dtype
    q = ((x.float() @ wq.to(dt).float()) + bq.float()) * (1.0 / math.sqrt(dim))
    q = q.to(dt).float().reshape(b, s, fl, heads, dim).transpose(2, 3)
    kh = k.to(dt).float().reshape(b, s, fg, heads, dim).transpose(2, 3)
    vh = v.to(dt).float().reshape(b, s, fg, heads, dim).transpose(2, 3)
    m = torch.full((b, s, heads, fl, 1), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j0 in range(0, fg, kb):
        sim = q @ kh[..., j0:j0 + kb, :].transpose(-1, -2)
        m_new = torch.maximum(m, sim.amax(-1, keepdim=True))
        p = torch.exp(sim - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vh[..., j0:j0 + kb, :]
        m = m_new
    return q, kh, vh, m, l, acc


def cross_attention_plain(x, k, v, wq, bq, wo, bo, heads: int, dim: int, kb: int = KV_BLOCK) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (JAX ``_fwd_kernel`` :121-148).

    o_h = round(acc / l); the output projection sums the heads in float32 and
    rounds once with b_o before the residual add.
    """
    b, s, fl, c = x.shape
    dt = x.dtype
    _, _, _, _, l, acc = _online_plain(x, k, v, wq, bq, heads, dim, kb)
    oh = (acc / l).to(dt).float().transpose(2, 3).reshape(b, s, fl, heads * dim)
    y = oh @ wo.to(dt).float() + bo.float()
    return x + y.to(dt)


def cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, heads: int, dim: int, kb: int = KV_BLOCK):
    """The backward kernel's oracle: ``(dx, dk, dv, dwq, dbq, dwo, dbo)`` by explicit formulas.

    Rounding points of the JAX ``_bwd_kernel`` (:151-267): p rebuilt from
    ``lse = m + log l``; ``di = rowsum(do * o)`` from the unrounded do and o;
    p, do, ds and dq rounded to x's type before each product; db_q summed from
    the unrounded dq; dk and dv rounded once, to k's and v's types; the weight
    gradients float32; dx in x's type.
    """
    b, s, fl, c = x.shape
    fg = k.shape[2]
    dt = x.dtype
    hd = heads * dim
    q, kh, vh, m, l, acc = _online_plain(x, k, v, wq, bq, heads, dim, kb)
    lse = m + torch.log(l)
    oh = acc / l
    gf = g.float()
    gc = g.to(dt).float()
    dwo = torch.einsum("bshid,bsic->hdc", oh.to(dt).float(), gc).reshape(hd, c)
    do = torch.einsum("bsic,hdc->bshid", gc, wo.to(dt).float().reshape(heads, dim, c))
    di = (do * oh).sum(-1, keepdim=True)
    do_c = do.to(dt).float()
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    for j0 in range(0, fg, kb):
        kj, vj = kh[..., j0:j0 + kb, :], vh[..., j0:j0 + kb, :]
        p = torch.exp(q @ kj.transpose(-1, -2) - lse)
        ds_c = (p * (do_c @ vj.transpose(-1, -2) - di)).to(dt).float()
        dv[..., j0:j0 + kb, :] = p.to(dt).float().transpose(-1, -2) @ do_c
        dk[..., j0:j0 + kb, :] = ds_c.transpose(-1, -2) @ q
        dq = dq + ds_c @ kj
    dq = (dq * (1.0 / math.sqrt(dim))).transpose(2, 3).reshape(b, s, fl, hd)
    dbq = dq.sum((0, 1, 2))
    dq_c = dq.to(dt).float()
    dwq = torch.einsum("bsfc,bsfk->ck", x.float(), dq_c)
    dx = (gf + dq_c @ wq.to(dt).float().t()).to(dt)
    dk = dk.transpose(2, 3).reshape(b, s, fg, hd).to(k.dtype)
    dv = dv.transpose(2, 3).reshape(b, s, fg, hd).to(v.dtype)
    return dx, dk, dv, dwq, dbq, dwo, gf.sum((0, 1, 2))


def _floats(fl: int, dim: int, kb: int, backward: bool) -> int:
    """Floats of shared memory of a kernel (``XDims`` in csrc/cross_attention.cu)."""
    q, kv, p = fl * (dim + 1), kb * (2 * dim + 1), fl * (kb + 1)
    return 3 * q + 2 * kv + 2 * p + 3 * fl if backward else 2 * q + kv + p + 2 * fl


def _check(x, k, v, wq, bq, wo, bo, heads: int, dim: int) -> None:
    if x.dim() != 4 or k.dim() != 4:
        raise ValueError(f"x must be (b, s, f_l, c) and k, v (b, s, f_g, H*D); got {tuple(x.shape)}, {tuple(k.shape)}")
    b, s, fl, c = x.shape
    hd = heads * dim
    if k.shape != v.shape or tuple(k.shape[:2]) != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k and v must be (b, s, f_g, H*D) = ({b}, {s}, f_g, {hd}); got {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(wq.shape) != (c, hd) or tuple(bq.shape) != (hd,):
        raise ValueError(f"wq/bq shapes {tuple(wq.shape)}/{tuple(bq.shape)} do not fit c={c}, H*D={hd}")
    if tuple(wo.shape) != (hd, c) or (bo is not None and tuple(bo.shape) != (c,)):
        raise ValueError(f"wo/bo shapes {tuple(wo.shape)}/{None if bo is None else tuple(bo.shape)} do not fit "
                         f"c={c}, H*D={hd}")
    for t in (k, v, wq, bq, wo, bo):
        if t is not None and t.device != x.device:
            raise ValueError("all operands must be on x's device")


def _check_kernel(x, k, v, heads: int, dim: int) -> None:
    """What the kernels take beyond the op's shapes; raises ``NotImplementedError`` otherwise."""
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"cross attention kernel takes float32 or bfloat16, not {x.dtype}")
    if k.dtype != x.dtype or v.dtype != x.dtype:
        raise NotImplementedError(f"cross attention kernel takes K and V in x's type ({x.dtype}); got {k.dtype}, {v.dtype}")
    need = 4 * _floats(x.shape[2], dim, KV_BLOCK, backward=True)
    if need > _SMEM_MAX:
        raise NotImplementedError(
            f"cross attention kernel: one token column's panels ({need} B at f_l={x.shape[2]}, head dim {dim}) "
            "exceed shared memory")


def _grid(tokens: int, fl: int, dim: int, backward: bool, device: torch.device) -> int:
    """CTAs of the persistent grid: as many as are resident at once, at most one per token."""
    smem = 4 * _floats(fl, dim, KV_BLOCK, backward)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tokens, sms * max(1, min(4, _SMEM_MAX // (smem + 1024)))))


def _launch(x, k, v, wq, bq, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """The forward kernel on CUDA tensors."""
    _check_kernel(x, k, v, heads, dim)
    b, s, fl, c = x.shape
    fg = k.shape[2]
    tokens = b * s
    x, k, v = x.contiguous(), k.contiguous(), v.contiguous()
    wq, wo = wq.to(x.dtype).contiguous(), wo.to(x.dtype).contiguous()
    bq, bo = bq.float().contiguous(), bo.float().contiguous()
    out = torch.empty_like(x)
    grid = _grid(tokens, fl, dim, False, x.device)
    scratch = torch.empty(grid, fl, heads * dim, device=x.device, dtype=x.dtype)  # each CTA's rounded o_h
    fn = _build.library("cross_attention").cross_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(), bq.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), out.data_ptr(), scratch.data_ptr(), tokens, fl, fg, c, heads, dim, KV_BLOCK, grid,
        1.0 / math.sqrt(dim), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cross_attention_fwd")
    launches["cross_attention_fwd"] += 1
    return out


def cross_attention_bwd(x, g, k, v, wq, bq, wo, heads: int, dim: int):
    """Backward of the block: the kernel on CUDA tensors, the plain formulas on CPU ones.

    Returns ``(dx, dk, dv, dwq, dbq, dwo, dbo)``: dx in x's type, dk and dv in
    k's and v's, the weight gradients float32.
    """
    _check(x, k, v, wq, bq, wo, None, heads, dim)
    if not x.is_cuda:
        return cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, heads, dim)
    _check_kernel(x, k, v, heads, dim)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)} on x's device")
    b, s, fl, c = x.shape
    fg = k.shape[2]
    hd = heads * dim
    tokens = b * s
    x, k, v, g = x.contiguous(), k.contiguous(), v.contiguous(), g.to(x.dtype).contiguous()
    wq_c = wq.to(x.dtype).contiguous()
    wq_t = wq_c.t().contiguous()
    wo_t = wo.to(x.dtype).t().contiguous()
    bq_f = bq.float().contiguous()
    total = 2 * c * hd + hd + c
    grid = min(_grid(tokens, fl, dim, True, x.device), max(1, _WORKSPACE_MAX // (4 * total)))
    partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
    grads = torch.empty(total, device=x.device, dtype=torch.float32)
    scratch = torch.empty(grid, fl, 2 * hd, device=x.device, dtype=x.dtype)  # each CTA's rounded o_h | dq
    dx, dk, dv = torch.empty_like(x), torch.empty_like(k), torch.empty_like(v)
    fn = _build.library("cross_attention").cross_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), k.data_ptr(), v.data_ptr(), wq_c.data_ptr(), wq_t.data_ptr(),
        bq_f.data_ptr(), wo_t.data_ptr(), dx.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), scratch.data_ptr(), tokens, fl, fg, c, heads, dim, KV_BLOCK, grid,
        1.0 / math.sqrt(dim), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cross_attention_bwd")
    launches["cross_attention_bwd"] += 1
    dwq, dbq, dwo, dbo = grads.split([c * hd, hd, hd * c, c])
    return dx, dk, dv, dwq.view(c, hd), dbq, dwo.view(hd, c), dbo


class _CrossAttention(torch.autograd.Function):
    """The block: the kernels on CUDA tensors, the plain versions on CPU ones, forward and backward."""

    @staticmethod
    def forward(ctx, x, k, v, wq, bq, wo, bo, heads: int, dim: int):
        ctx.save_for_backward(x, k, v, wq, bq, wo, bo)
        ctx.heads, ctx.dim = heads, dim
        if x.is_cuda:
            return _launch(x, k, v, wq, bq, wo, bo, heads, dim)
        return cross_attention_plain(x, k, v, wq, bq, wo, bo, heads, dim)

    @staticmethod
    def backward(ctx, g):
        x, k, v, wq, bq, wo, bo = ctx.saved_tensors
        dx, dk, dv, dwq, dbq, dwo, dbo = cross_attention_bwd(x, g, k, v, wq, bq, wo, ctx.heads, ctx.dim)
        return (dx, dk, dv, dwq.to(wq.dtype), dbq.to(bq.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype),
                None, None)


def fused_cross_attention_block(x, k, v, wq, bq, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """``x + out_proj(softmax(q(x) K^T / sqrt(D)) V)`` of local frames against global K/V; differentiable in all seven."""
    _check(x, k, v, wq, bq, wo, bo, heads, dim)
    return _CrossAttention.apply(x, k, v, wq, bq, wo, bo, heads, dim)
