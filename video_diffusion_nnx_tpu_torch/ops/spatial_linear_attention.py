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
budget, which does not apply here. Each stage runs its staged kernel
(``sla_context_panel_kernel``: two passes over token chunks split across CTAs,
first the k softmax's statistics, then the contexts; ``sla_out_panel_kernel``)
wherever a 16-token chunk fits, else the CUDA-core one; ``ctx_plan`` and
``out_plan`` choose. The kernels keep the rounding points of the JAX Pallas
kernels, which differ from ``_composite_xla`` in one place: k stays float32
into its softmax (the plain version, as the composite, takes k from a product
in x's type). The staged kernel rounds s = softmax_n(k) to x's type after its
division by the sum over all n tokens, as ``_context_kernel`` (:193) does; the
CUDA-core context kernel never rounds s.

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
import functools

import torch

from video_diffusion_nnx_tpu_torch.ops import _build

_SMEM_TARGET = 100 * 1024
_SMEM_MAX = 227 * 1024
MAX_DIM = 64  # the kernels keep D*D / 256 context values per thread in registers
_WORKSPACE_MAX = 128 * 2**20  # bytes of per-CTA weight-gradient partials in one backward kernel
_TC_SMEM_TARGET = 113 * 1024  # two staged CTAs per SM where a chunk allows it
_CTX_WORKSPACE_MAX = 16 * 2**20  # bytes of per-CTA context partials in one forward
_THREADS = 256  # threads of every CTA (kThreads in csrc/common.cuh)

launches = {"sla_context": 0, "sla_out": 0, "sla_bwd_q": 0, "sla_bwd_kv": 0}
staged = {k: 0 for k in launches}  # launches that ran the staged kernel, as the C entry reports
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


@functools.lru_cache(maxsize=None)
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


def _longest_chunk(n: int, nbytes) -> int:
    """The longest staged chunk: a multiple of 16 up to 128 (and n) within two CTAs per SM."""
    chunk = 16
    while chunk < min(128, _round16(n)) and nbytes(chunk + 16) <= _TC_SMEM_TARGET:
        chunk += 16
    return chunk


def _staged_chunk(frames: int, n: int, sms: int, nbytes) -> int:
    """Tokens per staged chunk: the longest, shortened where a frame would have too few chunks to
    spread over the SMs."""
    chunk = _longest_chunk(n, nbytes)
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


def _sla_ctx_bytes(chunk: int, c: int, dim: int, hc: int, elt: int) -> int:
    """Shared memory of the staged ``sla_context`` at ``chunk`` tokens, ``hc`` heads per CTA and ``elt``-byte
    panels (``sla_ctx_plan``: the two passes' panels share two regions)."""
    cp, dp = _round16(c), _round16(dim)
    ldc, ldd, ldw = cp + 8, dp + 8, 2 * dp + 8
    groups = _THREADS // dp  # thread groups of the statistics pass
    panels = (elt * chunk * ldc + max(4 * chunk * (dp + 1), 2 * elt * chunk * ldd)
              + max(4 * 2 * hc * groups * dp, 4 * hc * dp * (dp + 4)) + 4 * 2 * hc * dp)
    return -(-panels // 16) * 16 + 2 * elt * cp * ldw


def _cover(n: int, chunk: int, splits: int) -> int:
    """The CTAs per frame that hold chunks when ``splits`` CTAs take contiguous ranges of them."""
    chunks = -(-n // chunk)
    return -(-chunks // -(-chunks // splits))


@functools.lru_cache(maxsize=256)  # the wrappers ask for every call; the caller must not change the plan
def ctx_plan(frames: int, n: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The launch of ``sla_context`` for ``sms`` SMs: route, tokens per chunk, CTAs per frame and head
    groups, shared memory.

    The staged kernel ("staged": the chunk and each head's W_k | W_v in x's type, chunks of a
    multiple of 16 tokens, the products on the tensor cores in bf16; two passes over a grid of
    frames x ``splits`` x ``groups`` CTAs) takes every shape whose 16-token chunk fits; the rest the
    CUDA-core kernel ("simt", one CTA per frame and head, ``splits`` and ``groups`` 1). Raises where
    the CUDA-core kernel's 4-token chunk does not fit, as before. The C launcher makes the same
    choice (``sla_ctx_fits``).

    Per head-group count (a divisor of ``heads``; a CTA keeps float32 contexts for each of its
    heads, so wide weights need more groups before two CTAs share an SM), chunks are as long as
    two CTAs per SM allow (up to 128 tokens), and ``splits`` CTAs take contiguous ranges of a
    frame's chunks. The plan takes the (splits, groups) with the fewest waves of CTAs times the
    steps of a CTA, then the fewest CTAs. A CTA's (chunk, head) steps run one after another, each
    waiting for its weights and two barriers; staging a chunk of x costs about one step more, and a
    CTA two (its launch, the first weights): at the top level that is about one wave of CTAs with
    all heads, at the narrow levels one chunk and a few heads per CTA.
    """
    chunk = _chunk(4 * (c + 2 * (dim + 1)), 4 * 3 * dim, n)  # raises where 4 tokens do not fit
    plan = {"route": "simt", "chunk": chunk, "splits": 1, "groups": 1,
            "smem": 4 * (chunk * c + 2 * chunk * (dim + 1) + 3 * dim)}
    elt = 2 if bf16 else 4
    if _sla_ctx_bytes(16, c, dim, 1, elt) > _SMEM_MAX:  # not even one head's 16-token chunk fits
        return plan
    cap = max(1, _CTX_WORKSPACE_MAX // (4 * heads * dim * dim * frames))
    best = None
    for groups in (g for g in range(1, heads + 1) if heads % g == 0):
        def nbytes(k: int) -> int:
            return _sla_ctx_bytes(k, c, dim, heads // groups, elt)

        if nbytes(16) > _SMEM_MAX:
            continue
        chunk = _longest_chunk(n, nbytes)
        slots = sms * (2 if 2 * (nbytes(chunk) + 1024) <= 228 * 1024 else 1)
        chunks = -(-n // chunk)
        for splits in sorted({_cover(n, chunk, k) for k in range(1, min(chunks, cap) + 1)}):
            ctas = frames * splits * groups
            cost = (-(-ctas // slots) * (-(-chunks // splits) * (heads // groups + 1) + 2), ctas)
            if best is None or cost < best[0]:
                best = (cost, {"route": "staged", "chunk": chunk, "splits": splits, "groups": groups,
                               "smem": nbytes(chunk)})
    return best[1]


def _sla_out_bytes(chunk: int, c: int, dim: int, elt: int) -> int:
    """Shared memory of the staged ``sla_out`` at ``chunk`` tokens, ``elt``-byte panels (``sla_out_plan``)."""
    cp, dp = _round16(c), _round16(dim)
    ldc, ldd = cp + 8, dp + 8
    q32 = 4 * chunk * (dp + 1) if elt == 4 else 0  # q in float32 (bf16 keeps it in registers)
    panels = elt * (chunk * ldc + 2 * chunk * ldd + dp * ldd) + 4 * chunk * (cp + 8) + q32
    return -(-panels // 16) * 16 + 2 * elt * (cp * ldd + dp * ldc)


@functools.lru_cache(maxsize=256)
def out_plan(frames: int, n: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The launch of ``sla_out`` for ``sms`` SMs: route, tokens per chunk, CTAs per frame, shared memory.

    One CTA per frame and chunk in either route, so ``splits`` is the chunks per frame. The staged
    kernel ("staged": the chunk and each head's W_q | W_o in x's type, chunks of a multiple of 16
    tokens, the products on the tensor cores in bf16) takes every shape whose 16-token chunk fits;
    the rest the CUDA-core kernel ("simt"). Raises where the CUDA-core kernel's 4-token chunk does
    not fit, as before. The C launcher makes the same choice (``sla_out_fits``).
    """
    chunk = _chunk(4 * (2 * c + 2 * (dim + 1)), 4 * dim * (dim + 1), n)  # raises where 4 tokens do not fit
    route, smem, elt = "simt", 4 * (2 * chunk * c + 2 * chunk * (dim + 1) + dim * (dim + 1)), 2 if bf16 else 4
    if _sla_out_bytes(16, c, dim, elt) <= _SMEM_MAX:
        route = "staged"
        chunk = _staged_chunk(frames, n, sms, lambda k: _sla_out_bytes(k, c, dim, elt))
        smem = _sla_out_bytes(chunk, c, dim, elt)
    return {"route": route, "chunk": chunk, "splits": -(-n // chunk), "smem": smem}


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
    plan = ctx_plan(frames, n, c, dim, heads, xt.dtype == torch.bfloat16, _sms(xt.device))
    chunk, splits = plan["chunk"], plan["splits"]
    xt = xt if xt.data_ptr() % 16 == 0 else xt.clone()  # copied in 8-byte chunks
    hd = heads * dim
    f32 = dict(device=xt.device, dtype=torch.float32)
    ctx = torch.empty(frames, heads, dim, dim, **f32)
    stats = torch.empty(2, frames, heads, dim, **f32)
    # the workspace: the statistics' partials (2, splits, frames, H, D), then the contexts' (splits, frames, H, D, D),
    # which the kernel writes straight into ctx where a frame is one split
    work = torch.empty(splits * frames * hd * (2 + (dim if splits > 1 else 0)), **f32)
    ctx_part = work.data_ptr() + 4 * 2 * splits * frames * hd if splits > 1 else ctx.data_ptr()
    fn = _fn("sla_context_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    route = ctypes.c_int(0)
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), wqkv.data_ptr(), ctx.data_ptr(), stats.data_ptr(),
        work.data_ptr(), ctx_part, frames, splits, plan["groups"], n, c, heads, dim, chunk,
        torch.cuda.current_stream(xt.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "sla_context_fwd")
    launches["sla_context"] += 1
    staged["sla_context"] += route.value
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
    chunk = out_plan(frames, n, c, dim, heads, xt.dtype == torch.bfloat16, _sms(xt.device))["chunk"]
    xt = xt if xt.data_ptr() % 16 == 0 else xt.clone()  # copied in 8-byte chunks
    out = torch.empty_like(xt)
    fn = _fn("sla_out_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    route = ctypes.c_int(0)
    err = fn(
        _DTYPES[xt.dtype], xt.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), ctx.data_ptr(),
        out.data_ptr(), frames, n, c, heads, dim, float(scale), chunk,
        torch.cuda.current_stream(xt.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "sla_out_fwd")
    launches["sla_out"] += 1
    staged["sla_out"] += route.value
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
