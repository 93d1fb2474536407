"""Fused spatial linear-attention block (counterpart of the JAX package's ops/spatial_linear_attention.py).

    out = x + to_out(softmax_D(q(x)) * scale . (softmax_n(k(x))^T v(x)))   per frame of x (b, f, h, w, c)

``wqkv`` (c, 3*H*D) packs the bias-free q|k|v 1x1 kernels and ``wo`` is
(H*D, c); ``scale`` is 1.0 in reference-compat math (the dropped q scale).

The block is two stages, each with its hand-written kernel in
``csrc/spatial_linear_attention.cu`` and its plain version here:
``sla_context`` (per frame and head, ``softmax_n(k)^T v``, float32, and
the k softmax's max and sum, which the backward reads) and
``sla_out`` (the q softmax, ``q . ctx``, W_o and the residual). Together the
two plain stages equal the JAX ``_composite_xla`` (:343-368), rounding
points included. On the GPU every frame size takes the same two kernels:
the TPU's split between a one-pass and a two-pass forward follows its VMEM
budget, which does not apply here.

The backward is two more kernels, ``sla_bwd_q`` (the q and output
projections, and the contexts' cotangent) and ``sla_bwd_kv`` (the k and v
projections through the token-axis softmax), with plain versions
``sla_bwd_q_plain`` and ``sla_bwd_kv_plain`` that keep the rounding points
of the JAX ``_bwd_q_kernel`` and ``_bwd_kv_kernel``. Each runs its staged
kernel (``sla_bwd_q_panel_kernel``, ``sla_bwd_kv_panel_kernel``: panels in x's
type in shared memory, the products on the tensor cores in bf16) wherever a
16-token chunk fits, else the CUDA-core one; ``q_plan`` and ``kv_plan``
choose. On CUDA tensors the
public op is ``_SpatialLinearAttention``: its forward keeps the contexts and
the k softmax's statistics (from the context kernel), so the backward
recomputes nothing; at batch 8 of the flagship that is 2.6 MB per spatial
attention, 21 MB over the 8 of a step. In float32 the contexts also give the
k softmax VJP's rho, so ``sla_bwd_kv`` then runs its staged kernel's second
pass alone.

Dispatch has no hidden fallback: a CPU tensor takes the plain versions,
differentiated by autograd; a CUDA tensor launches the kernels or raises
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from video_diffusion_nnx_tpu_torch.ops import _build

_SMEM_TARGET = 100 * 1024
_SMEM_MAX = 227 * 1024
MAX_DIM = 64  # the context kernel keeps D*D / 256 accumulators per thread in registers
_WORKSPACE_MAX = 128 * 2**20  # bytes of per-CTA weight-gradient partials in one backward kernel
_TC_SMEM_TARGET = 113 * 1024  # two staged CTAs per SM where a chunk allows it
_THREADS = 256  # threads of every CTA (kThreads in csrc/common.cuh)

launches = {"sla_context": 0, "sla_out": 0, "sla_bwd_q": 0, "sla_bwd_kv": 0}
staged = {"sla_bwd_q": 0, "sla_bwd_kv": 0}  # launches that ran the staged kernel, as the C entry reports
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sla_context_plain(xt, wqkv, heads: int, dim: int) -> torch.Tensor:
    """Per-frame, per-head contexts ``softmax_n(k)^T v``: ``(frames, H, D, D)`` float32."""
    frames, n, c = xt.shape
    dt = xt.dtype
    hd = heads * dim
    kv = xt @ wqkv[:, hd:].to(dt)
    k = kv[..., :hd].reshape(frames, n, heads, dim)
    v = kv[..., hd:].reshape(frames, n, heads, dim)
    k = torch.softmax(k.float(), dim=1).to(dt)
    return torch.einsum("bnhd,bnhe->bhde", k.float(), v.float())


def sla_stats_plain(xt, wqkv, heads: int, dim: int) -> torch.Tensor:
    """The k softmax's per-feature max and sum over the tokens: ``(2, frames, H, D)`` float32.

    k in float32 from x and W_k in x's type, as the JAX ``_ctx_stats_kernel``
    (:246-278) and the backward's ``sla_bwd_kv_plain`` take it.
    """
    frames, n, c = xt.shape
    hd = heads * dim
    k = (xt.float() @ wqkv[:, hd:2 * hd].to(xt.dtype).float()).reshape(frames, n, heads, dim)
    m = k.amax(dim=1)
    return torch.stack([m, torch.exp(k - m[:, None]).sum(dim=1)])


def sla_out_plain(xt, wqkv, wo, ctx, heads: int, dim: int, scale: float) -> torch.Tensor:
    """``x + W_o(softmax_D(q) * scale . ctx)`` given the contexts; ``(frames, n, c)``."""
    frames, n, c = xt.shape
    dt = xt.dtype
    hd = heads * dim
    q = (xt @ wqkv[:, :hd].to(dt)).reshape(frames, n, heads, dim)
    q = torch.softmax(q.float(), dim=-1).to(dt)
    if scale != 1.0:
        q = q * torch.tensor(scale, dtype=dt, device=xt.device)
    o = torch.einsum("bnhd,bhde->bnhe", q, ctx.to(dt)).reshape(frames, n, hd)
    return xt + o @ wo.to(dt)


def sla_bwd_q_plain(xt, g, wqkv, wo, ctx, heads: int, dim: int, scale: float):
    """Backward of the q path given the contexts: ``(dx_q, dctx, dwq, dwo)``.

    ``dx_q = g + dq W_q^T`` in x's type; ``dctx`` (frames, H, D, D), ``dwq``
    (c, H*D) and ``dwo`` (H*D, c) float32. Rounding points of the JAX
    ``_bwd_q_kernel`` (:450-531): q and its softmax in float32, then
    ``p * scale``, o, do and dq rounded to x's type before their products.
    """
    frames, n, c = xt.shape
    dt = xt.dtype
    hd = heads * dim
    xf = xt.float()
    gc = g.to(dt).float()
    q = (xf @ wqkv[:, :hd].to(dt).float()).reshape(frames, n, heads, dim)
    p = torch.softmax(q, dim=-1)
    qs = (p * scale).to(dt).float()
    ctx_c = ctx.to(dt).float()
    o = torch.einsum("bnhd,bhde->bnhe", qs, ctx_c).to(dt).float()
    dwo = torch.einsum("bnhe,bnc->hec", o, gc).reshape(hd, c)
    do = torch.einsum("bnc,hec->bnhe", gc, wo.to(dt).float().reshape(heads, dim, c)).to(dt).float()
    dctx = torch.einsum("bnhd,bnhe->bhde", qs, do)
    dp = torch.einsum("bnhe,bhde->bnhd", do, ctx_c) * scale
    dq = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float().reshape(frames, n, hd)
    dwq = torch.einsum("bnc,bnk->ck", xf, dq)
    dxq = (g.float() + dq @ wqkv[:, :hd].to(dt).float().t()).to(dt)
    return dxq, dctx, dwq, dwo


def sla_bwd_kv_plain(xt, wqkv, ctx, dctx, dxq, heads: int, dim: int):
    """Backward of the k/v path from the contexts' cotangent: ``(dx, dwk, dwv)``.

    ``dx = dx_q + dk W_k^T + dv W_v^T`` in x's type; ``dwk`` and ``dwv``
    (c, H*D) float32. Rounding points of the JAX ``_bwd_kv_kernel``
    (:534-607): k and its token-axis softmax in float32, v, s, dctx, dk and
    dv rounded to x's type before their products. The softmax VJP needs
    ``rho = sum_n ds * s``; for float32 x, where rounding is the identity and
    so the forward's context is ``ctx = s^T v``, it is taken as
    ``sum_e dctx * ctx``, the same sum in another order (the kernel's one-pass
    route). In bf16 the forward's context multiplies round(s) while rho needs
    float32 s, so ``ctx`` is not used there.
    """
    frames, n, c = xt.shape
    dt = xt.dtype
    hd = heads * dim
    xf = xt.float()
    k = (xf @ wqkv[:, hd:2 * hd].to(dt).float()).reshape(frames, n, heads, dim)
    v = (xf @ wqkv[:, 2 * hd:].to(dt).float()).reshape(frames, n, heads, dim).to(dt).float()
    s = torch.softmax(k, dim=1)
    dctx_c = dctx.to(dt).float()
    ds = torch.einsum("bhde,bnhe->bnhd", dctx_c, v)
    dv = torch.einsum("bhde,bnhd->bnhe", dctx_c, s.to(dt).float()).to(dt).float().reshape(frames, n, hd)
    if dt == torch.float32:
        rho = (dctx_c * ctx.float()).sum(-1)[:, None]
    else:
        rho = (ds * s).sum(1, keepdim=True)
    dk = (s * (ds - rho)).to(dt).float().reshape(frames, n, hd)
    dwk = torch.einsum("bnc,bnk->ck", xf, dk)
    dwv = torch.einsum("bnc,bnk->ck", xf, dv)
    dx = (dxq.float() + dk @ wqkv[:, hd:2 * hd].to(dt).float().t()
          + dv @ wqkv[:, 2 * hd:].to(dt).float().t()).to(dt)
    return dx, dwk, dwv


def _check(xt, wqkv, heads: int, dim: int, *others) -> None:
    if xt.dim() != 3:
        raise ValueError(f"x must be (frames, n, c); got {tuple(xt.shape)}")
    if xt.dtype not in _DTYPES:
        raise NotImplementedError(f"spatial attention kernels take float32 or bfloat16, not {xt.dtype}")
    if dim > MAX_DIM:
        raise NotImplementedError(f"spatial attention kernels take head dims up to {MAX_DIM}, not {dim}")
    c = xt.shape[-1]
    if tuple(wqkv.shape) != (c, 3 * heads * dim):
        raise ValueError(f"wqkv shape {tuple(wqkv.shape)} does not fit c={c}, H*D={heads * dim}")
    if not xt.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(t.device != xt.device for t in (wqkv, *others)):
        raise ValueError("all operands must be on x's device")


def _chunk(per_token: int, fixed: int, n: int) -> int:
    """Tokens per chunk: a multiple of 4, at most 64, fitting the shared-memory target."""
    if fixed + 4 * per_token > _SMEM_MAX:
        raise NotImplementedError("spatial attention kernel: a 4-token chunk exceeds shared memory")
    fit = (_SMEM_TARGET - fixed) // per_token
    return max(4, min(64, fit - fit % 4, -(-n // 4) * 4))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(frames: int, n: int, chunk: int, partial_floats: int, sms: int) -> int:
    """CTAs per frame for the backward kernels: about two per SM over all frames, within the workspace."""
    want = -(-2 * sms // frames)
    cap = max(1, _WORKSPACE_MAX // (4 * partial_floats * frames))
    return max(1, min(want, -(-n // chunk), cap))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _sla_tc_bytes(chunk: int, c: int, dim: int, elt: int) -> int:
    """Shared memory of the staged ``sla_bwd_q`` at ``chunk`` tokens, ``elt``-byte panels (``sla_tc_plan``)."""
    cp, dp = _round16(c), _round16(dim)
    ldc, ldd = cp + 8, dp + 8
    panels = elt * (2 * chunk * ldc + 4 * chunk * ldd + dp * ldd) + 4 * chunk * (cp + 8) + 2 * 4 * chunk * (dp + 1)
    return -(-panels // 16) * 16 + 2 * elt * (cp * ldd + dp * ldc)


def q_plan(frames: int, n: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The launch of ``sla_bwd_q`` for ``sms`` SMs: route, tokens per chunk, CTAs per frame, shared memory.

    The staged kernel ("staged": panels in x's type, chunks of a multiple of 16 tokens, the
    products on the tensor cores in bf16) takes every shape whose 16-token chunk fits; the rest
    the CUDA-core kernel ("simt"). Raises where the CUDA-core kernel's 4-token chunk does not fit,
    as before. The C launcher makes the same choice (``sla_tc_fits``).
    """
    hd = heads * dim
    chunk = _chunk(4 * (3 * c + 4 * (dim + 1)), 4 * dim * (dim + 1), n)  # raises where 4 tokens do not fit
    smem = 4 * (3 * chunk * c + 4 * chunk * (dim + 1) + dim * (dim + 1))
    route, elt = "simt", 2 if bf16 else 4
    if _sla_tc_bytes(16, c, dim, elt) <= _SMEM_MAX:
        route = "staged"
        chunk = _staged_chunk(frames, n, sms, lambda k: _sla_tc_bytes(k, c, dim, elt))
        smem = _sla_tc_bytes(chunk, c, dim, elt)
    return {"route": route, "chunk": chunk, "splits": _splits(frames, n, chunk, 2 * c * hd, sms), "smem": smem}


def _sla_kv_bytes(chunk: int, c: int, dim: int, heads: int, elt: int) -> int:
    """Shared memory of the staged ``sla_bwd_kv`` at ``chunk`` tokens, ``elt``-byte panels (``sla_kv_plan``)."""
    cp, dp = _round16(c), _round16(dim)
    ldc, ldd, ldw = cp + 8, dp + 8, 2 * dp + 8
    groups = _THREADS // dp  # thread groups of pass 0's column sums
    panels = (elt * (chunk * ldc + 2 * chunk * ldd + chunk * ldw + dp * ldd) + 4 * chunk * (cp + 8)
              + 4 * chunk * (dp + 1) + 4 * heads * dp * (3 + groups))
    return -(-panels // 16) * 16 + 2 * elt * cp * ldw


def _staged_chunk(frames: int, n: int, sms: int, nbytes) -> int:
    """Tokens per staged chunk: a multiple of 16 up to 128 within two CTAs per SM, smaller where a
    frame would have too few chunks to spread over the SMs."""
    chunk = 16
    while chunk < min(128, _round16(n)) and nbytes(chunk + 16) <= _TC_SMEM_TARGET:
        chunk += 16
    want = -(-2 * sms // frames)
    while chunk > 16 and -(-n // chunk) < want:
        chunk -= 16
    return chunk


def kv_plan(frames: int, n: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The launch of ``sla_bwd_kv`` for ``sms`` SMs: route, tokens per chunk, CTAs per frame, shared memory.

    The staged kernel ("staged": the chunk and each head's W_k | W_v in x's type, chunks of a
    multiple of 16 tokens, the products on the tensor cores in bf16) takes every shape whose
    16-token chunk fits; the rest the CUDA-core kernel ("simt"). Raises where the CUDA-core
    kernel's 4-token chunk does not fit, as before. The C launcher makes the same choice
    (``sla_kv_fits``). Both passes run on the same grid.
    """
    hd = heads * dim
    fixed = dim * (dim + 1) + 2 * dim + hd
    chunk = _chunk(4 * (2 * c + 4 * (dim + 1)), 4 * fixed, n)  # raises where 4 tokens do not fit
    smem = 4 * (2 * chunk * c + 4 * chunk * (dim + 1) + fixed)
    route, elt = "simt", 2 if bf16 else 4
    if _sla_kv_bytes(16, c, dim, heads, elt) <= _SMEM_MAX:
        route = "staged"
        chunk = _staged_chunk(frames, n, sms, lambda k: _sla_kv_bytes(k, c, dim, heads, elt))
        smem = _sla_kv_bytes(chunk, c, dim, heads, elt)
    return {"route": route, "chunk": chunk, "splits": _splits(frames, n, chunk, 2 * c * hd, sms), "smem": smem}


def _fn(name: str, argtypes: list):
    fn = getattr(_build.library("spatial_linear_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def sla_context(xt, wqkv, heads: int, dim: int):
    """Stage 1: the context kernel on a CUDA tensor, the plain versions on a CPU one.

    Returns ``(ctx, stats)``: the contexts and the k softmax's per-feature
    max and sum, ``(2, frames, H, D)`` float32, which the backward kernel reads.
    """
    if not xt.is_cuda:
        return sla_context_plain(xt, wqkv, heads, dim), sla_stats_plain(xt, wqkv, heads, dim)
    _check(xt, wqkv, heads, dim)
    frames, n, c = xt.shape
    wqkv = wqkv.to(xt.dtype).contiguous()
    chunk = _chunk(4 * (c + 2 * (dim + 1)), 4 * 3 * dim, n)
    ctx = torch.empty(frames, heads, dim, dim, device=xt.device, dtype=torch.float32)
    stats = torch.empty(2, frames, heads, dim, device=xt.device, dtype=torch.float32)
    fn = _fn("sla_context_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), wqkv.data_ptr(), ctx.data_ptr(), stats.data_ptr(),
        frames, n, c, heads, dim, chunk, torch.cuda.current_stream(xt.device).cuda_stream,
    )
    _build.check(err, "sla_context_fwd")
    launches["sla_context"] += 1
    return ctx, stats


def sla_out(xt, wqkv, wo, ctx, heads: int, dim: int, scale: float) -> torch.Tensor:
    """Stage 2: the output kernel on a CUDA tensor, the plain version on a CPU one."""
    if not xt.is_cuda:
        return sla_out_plain(xt, wqkv, wo, ctx, heads, dim, scale)
    _check(xt, wqkv, heads, dim, wo, ctx)
    frames, n, c = xt.shape
    if tuple(wo.shape) != (heads * dim, c) or tuple(ctx.shape) != (frames, heads, dim, dim):
        raise ValueError(f"wo {tuple(wo.shape)} or ctx {tuple(ctx.shape)} does not fit x {tuple(xt.shape)}")
    wqkv = wqkv.to(xt.dtype).contiguous()
    wo = wo.to(xt.dtype).contiguous()
    ctx = ctx.float().contiguous()
    chunk = _chunk(4 * (2 * c + 2 * (dim + 1)), 4 * dim * (dim + 1), n)
    out = torch.empty_like(xt)
    fn = _fn("sla_out_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), ctx.data_ptr(),
        out.data_ptr(), frames, n, c, heads, dim, float(scale), chunk,
        torch.cuda.current_stream(xt.device).cuda_stream,
    )
    _build.check(err, "sla_out_fwd")
    launches["sla_out"] += 1
    return out


def sla_bwd_q(xt, g, wqkv, wo, ctx, heads: int, dim: int, scale: float):
    """Backward, q path: the kernel on CUDA tensors, the plain version on CPU ones.

    Returns ``(dx_q, dctx, dwq, dwo)`` as :func:`sla_bwd_q_plain` does.
    """
    if not xt.is_cuda:
        return sla_bwd_q_plain(xt, g, wqkv, wo, ctx, heads, dim, scale)
    _check(xt, wqkv, heads, dim, g, wo, ctx)
    frames, n, c = xt.shape
    hd = heads * dim
    if g.shape != xt.shape or tuple(wo.shape) != (hd, c) or tuple(ctx.shape) != (frames, heads, dim, dim):
        raise ValueError(f"g {tuple(g.shape)}, wo {tuple(wo.shape)} or ctx {tuple(ctx.shape)} "
                         f"does not fit x {tuple(xt.shape)}")
    g = g.to(xt.dtype).contiguous()
    wqkv = wqkv.to(xt.dtype).contiguous()
    wo = wo.to(xt.dtype).contiguous()
    ctx = ctx.float().contiguous()
    plan = q_plan(frames, n, c, dim, heads, xt.dtype == torch.bfloat16, _sms(xt.device))
    chunk, splits = plan["chunk"], plan["splits"]
    xt, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xt, g))  # copied in 8-byte chunks
    f32 = dict(device=xt.device, dtype=torch.float32)
    dxq = torch.empty_like(xt)
    dctx_part = torch.empty(splits, frames, heads, dim, dim, **f32)
    dctx = torch.empty(frames, heads, dim, dim, **f32)
    partial = torch.empty(frames * splits, 2 * c * hd, **f32)
    dwq, dwo = torch.empty(c, hd, **f32), torch.empty(hd, c, **f32)
    fn = _fn("sla_bwd_q", [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    route = ctypes.c_int(0)
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(),
        ctx.data_ptr(), dxq.data_ptr(), dctx_part.data_ptr(), dctx.data_ptr(), partial.data_ptr(),
        dwq.data_ptr(), dwo.data_ptr(), frames, splits, n, c, heads, dim, float(scale), chunk,
        torch.cuda.current_stream(xt.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "sla_bwd_q")
    launches["sla_bwd_q"] += 1
    staged["sla_bwd_q"] += route.value
    return dxq, dctx, dwq, dwo


def sla_bwd_kv(xt, wqkv, ctx, dctx, dxq, stats, heads: int, dim: int):
    """Backward, k/v path: the kernel on CUDA tensors, the plain version on CPU ones.

    ``ctx`` are the forward's contexts: float32 x takes rho from them, so the
    staged kernel runs its second pass alone (see :func:`sla_bwd_kv_plain`);
    bf16 x does not use them. ``stats`` are the context kernel's softmax
    statistics (CUDA only; the plain version recomputes the softmax).
    Returns ``(dx, dwk, dwv)``.
    """
    if not xt.is_cuda:
        return sla_bwd_kv_plain(xt, wqkv, ctx, dctx, dxq, heads, dim)
    _check(xt, wqkv, heads, dim, ctx, dctx, dxq, stats)
    frames, n, c = xt.shape
    hd = heads * dim
    if (tuple(ctx.shape) != (frames, heads, dim, dim) or tuple(dctx.shape) != (frames, heads, dim, dim)
            or dxq.shape != xt.shape or tuple(stats.shape) != (2, frames, heads, dim)):
        raise ValueError(f"ctx {tuple(ctx.shape)}, dctx {tuple(dctx.shape)}, dx_q {tuple(dxq.shape)} or stats "
                         f"{tuple(stats.shape)} does not fit x {tuple(xt.shape)}")
    ctx = ctx.float().contiguous()
    wqkv = wqkv.to(xt.dtype).contiguous()
    dctx = dctx.float().contiguous()
    dxq = dxq.to(xt.dtype).contiguous()
    stats = stats.float().contiguous()
    plan = kv_plan(frames, n, c, dim, heads, xt.dtype == torch.bfloat16, _sms(xt.device))
    chunk, splits = plan["chunk"], plan["splits"]
    xt = xt if xt.data_ptr() % 16 == 0 else xt.clone()  # copied in 8-byte chunks
    f32 = dict(device=xt.device, dtype=torch.float32)
    dx = torch.empty_like(xt)
    rho_part = torch.empty(splits, frames, hd, **f32)
    partial = torch.empty(frames * splits, 2 * c * hd, **f32)
    dwk, dwv = torch.empty(c, hd, **f32), torch.empty(c, hd, **f32)
    fn = _fn("sla_bwd_kv", [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    route = ctypes.c_int(0)
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), wqkv.data_ptr(), dctx.data_ptr(), dxq.data_ptr(),
        stats.data_ptr(), ctx.data_ptr(), dx.data_ptr(), rho_part.data_ptr(), partial.data_ptr(),
        dwk.data_ptr(), dwv.data_ptr(), frames, splits, n, c, heads, dim, chunk,
        torch.cuda.current_stream(xt.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "sla_bwd_kv")
    launches["sla_bwd_kv"] += 1
    staged["sla_bwd_kv"] += route.value
    return dx, dwk, dwv


class _SpatialLinearAttention(torch.autograd.Function):
    """The block on CUDA tensors: context and output kernels forward, two kernels backward."""

    @staticmethod
    def forward(ctx, x, wqkv, wo, heads: int, dim: int, scale: float):
        b, f, hh, ww, c = x.shape
        xt = x.reshape(b * f, hh * ww, c)
        context, stats = sla_context(xt, wqkv, heads, dim)
        ctx.save_for_backward(xt, wqkv, wo, context, stats)
        ctx.heads, ctx.dim, ctx.scale = heads, dim, scale
        return sla_out(xt, wqkv, wo, context, heads, dim, scale).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        xt, wqkv, wo, context, stats = ctx.saved_tensors
        gt = g.reshape(xt.shape)
        dxq, dctx, dwq, dwo = sla_bwd_q(xt, gt, wqkv, wo, context, ctx.heads, ctx.dim, ctx.scale)
        dx, dwk, dwv = sla_bwd_kv(xt, wqkv, context, dctx, dxq, stats, ctx.heads, ctx.dim)
        dwqkv = torch.cat([dwq, dwk, dwv], dim=1)
        return dx.reshape(g.shape), dwqkv.to(wqkv.dtype), dwo.to(wo.dtype), None, None, None


def fused_spatial_linear_attention_block(x, wqkv, wo, heads: int, dim: int, scale: float) -> torch.Tensor:
    """``x + SpatialLinearAttention(x)`` for x ``(b, f, h, w, c)``; differentiable."""
    if x.dim() != 5:
        raise ValueError(f"x must be (b, f, h, w, c); got {tuple(x.shape)}")
    if x.is_cuda:
        return _SpatialLinearAttention.apply(x, wqkv, wo, heads, dim, scale)
    b, f, hh, ww, c = x.shape
    xt = x.reshape(b * f, hh * ww, c)
    ctx = sla_context_plain(xt, wqkv, heads, dim)
    return sla_out_plain(xt, wqkv, wo, ctx, heads, dim, scale).reshape(x.shape)


def pack_sla_weights(sla) -> tuple[torch.Tensor, torch.Tensor]:
    """A SpatialLinearAttention module's weights in the op's layouts (JAX ``pack_sla_weights``)."""
    wqkv = torch.cat([sla.q.weight.t(), sla.k.weight.t(), sla.v.weight.t()], dim=-1)
    return wqkv, sla.to_out.weight.t()
