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

Each kernel has two designs. The staged kernels (tiles of tokens whose
rows, weights and K|V panels are staged in shared memory in x's type, one warp
per head, the products on the tensor cores in bf16) run wherever
``cross_plan`` fits; the first-design kernels (one token column per CTA on the
CUDA cores) run the rest. The C entry makes the same choice and reports it;
``staged`` counts the launches that ran the staged kernel.

The weight gradients cross CTAs as in the other backward kernels: per-CTA
float32 partials summed by ``reduce_partials_kernel`` in a fixed order, so
two runs are bit-equal.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from video_diffusion_nnx_tpu_torch.ops import _build

KV_BLOCK = 32  # KV frames per block, forward and backward alike
_SMEM_MAX = 227 * 1024
_WORKSPACE_MAX = 128 * 2**20  # bytes of per-CTA weight-gradient partials in one backward

_WARPS = 8  # of the staged kernels' 256 threads
_SCR_FLOATS = 16 * (32 + 4)  # a warp's float32 scratch for P (``kXScr``)

launches = {"cross_attention_fwd": 0, "cross_attention_bwd": 0}
# Launches that ran the staged kernel, as the C entry reports (the rest ran the first design).
staged = {name: 0 for name in launches}
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


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pad_ld(n: int) -> int:
    """A panel's leading dimension (``pad_ld`` in csrc/common.cuh): n rounded up to 16, plus 8."""
    return _round16(n) + 8


def cross_layout(tile: int, fl: int, fg: int, c: int, heads: int, dim: int, elt: int, backward: bool, ck: int,
                 part: bool, kv_slots: int, chunk_slots: int) -> dict:
    """``cross_layout`` in csrc/cross_attention.cu: the staged kernels' shared memory for one launch.

    Tiles of ``tile`` tokens, their rows padded to 16; ``kv_slots`` slots of one token's K|V (f_g rounded up
    to a KV block of 32). Where ``ck`` covers c, W_q and W_o^T stay resident and the tile's x (and g) rows
    take two slots; else ``chunk_slots`` slots each hold a ``ck``-column chunk of the tile's rows and the
    weights' rows. Then the q panel and, backward, do in float32, round(do), round(o), each warp's lse and
    di, db_q, db_o and, with ``part``, the float32 weight-gradient partials; in float32 each warp's scratch
    for P (round(do) and the chunked q sum then live in the float32 panels themselves).
    """
    hd = heads * dim
    rp, fq, cp = _round16(tile * fl), _round16(fl), _round16(c)
    rq = max(rp, (tile - 1) * fl + fq)
    fgk = -(-fg // 32) * 32
    nch = -(-cp // ck)
    resident = nch == 1
    ldx, ldh, ldkv, ldf, ldpo = _pad_ld(ck), _pad_ld(hd), _pad_ld(2 * hd), hd + 4, cp + 4
    lda = ldh if elt == 4 else ldf
    nrow = 2 if backward else 1
    part = part and backward
    xslot = nrow * rp * ldx
    wslot = (0 if resident else xslot) + nrow * ck * ldh
    at = _round16(2 * xslot * elt) if resident else 0
    at += _round16(kv_slots * fgk * ldkv * elt)
    at += _round16((2 * cp * ldh if resident else chunk_slots * wslot) * elt)
    at += _round16(rq * ldh * elt)
    if backward:
        at += _round16((rq if elt == 4 else rp) * lda * 4) + (_round16(rq * ldh * elt) if elt == 2 else 0)
        at += _round16(rp * ldh * elt)
    if not resident and elt == 2:
        at += _round16(rp * ldf * 4)
    if backward:
        at += _round16(_WARPS * 2 * fq * 4) + _round16(hd * 4) + _round16(cp * 4)
    if part:
        at += _round16((cp * ldf + hd * ldpo) * 4)
    if elt == 4:
        at += _round16(_WARPS * _SCR_FLOATS * 4)
    return {"tile": tile, "rows_padded": rp, "ck": ck, "chunks": nch, "resident": resident, "kv_slots": kv_slots,
            "chunk_slots": 0 if resident else chunk_slots, "partial_smem": part, "smem": at}


@functools.lru_cache(maxsize=None)
def _layout_fit(tile: int, fl: int, fg: int, c: int, heads: int, dim: int, elt: int, backward: bool) -> dict | None:
    """``cross_plan`` in csrc/cross_attention.cu: the first layout that fits 227 KB, searching tokens per tile
    from ``tile`` down to 1, then the c-chunk (c itself, then 128, 64, 32, 16), then (backward) the partials on
    chip before device memory, then two K|V slots before one, then two chunk slots before one. None where
    nothing fits or the head dim is not 32 or 64."""
    if dim not in (32, 64) or min(tile, fl, fg, c, heads) < 1:
        return None
    cp = _round16(c)
    for t in range(tile, 0, -1):
        for i, ck in enumerate((cp, 128, 64, 32, 16)):
            if i and ck >= cp:
                continue
            for part in ((True, False) if backward else (False,)):
                for kv_slots in (2, 1):
                    for chunk_slots in ((1,) if i == 0 else (2, 1)):
                        lay = cross_layout(t, fl, fg, c, heads, dim, elt, backward, ck, part, kv_slots, chunk_slots)
                        if lay["smem"] <= _SMEM_MAX:
                            return lay
    return None


@functools.lru_cache(maxsize=None)  # the wrappers plan every call; callers only read the dict
def cross_plan(tokens: int, fl: int, fg: int, c: int, heads: int, dim: int, bf16: bool, sms: int,
               backward: bool) -> dict:
    """The launch of a cross kernel for ``sms`` SMs: route, tokens per tile, shared memory and grid.

    The staged kernel (``route`` "staged") takes every shape whose layout fits; its tile starts from enough
    tokens to fill 16 rows (two at f_l = 8), fewer where the tokens would not cover the SMs (the 128 tokens of
    the recipe's s = 64 levels take one per tile), and the layout search may lower it further. The forward puts
    two CTAs on an SM where shared memory allows. The rest take the first design ("simt"), whose grid fills
    the SMs with as many resident CTAs as its panels allow. The backward's grid keeps its per-CTA partials
    within ``_WORKSPACE_MAX``. The C entry makes the same choice from ``tile``.
    """
    elt = 2 if bf16 else 4
    tile = max(1, min(max(1, 16 // fl), -(-tokens // sms)))
    lay = _layout_fit(tile, fl, fg, c, heads, dim, elt, backward)
    if lay is None:
        smem = 4 * _floats(fl, dim, KV_BLOCK, backward)
        grid = max(1, min(tokens, sms * max(1, min(4, _SMEM_MAX // (smem + 1024)))))
        plan = {"route": "simt", "tile": tile, "smem": smem}
    else:
        per_sm = 2 if not backward and 2 * (lay["smem"] + 1024) <= 228 * 1024 else 1
        grid = max(1, min(-(-tokens // lay["tile"]), sms * per_sm))
        plan = {"route": "staged", **lay}
    if backward:
        total = 2 * c * heads * dim + heads * dim + c
        grid = min(grid, max(1, _WORKSPACE_MAX // (4 * total)))
    return {**plan, "grid": grid}


def _check_kernel(x, k, v, heads: int, dim: int) -> None:
    """What the kernels take beyond the op's shapes; raises ``NotImplementedError`` otherwise."""
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"cross attention kernel takes float32 or bfloat16, not {x.dtype}")
    if k.dtype != x.dtype or v.dtype != x.dtype:
        raise NotImplementedError(f"cross attention kernel takes K and V in x's type ({x.dtype}); got {k.dtype}, {v.dtype}")
    fl, fg, c = x.shape[2], k.shape[2], x.shape[3]
    if not _fits(fl, fg, c, heads, dim, x.element_size()):
        raise NotImplementedError(
            f"cross attention kernel: one token's panels (f_l={fl}, f_g={fg}, c={c}, head dim {dim}) exceed shared "
            "memory in either design")


def _fits(fl: int, fg: int, c: int, heads: int, dim: int, elt: int) -> bool:
    """Some design holds the shape in both directions: the first design's panels (the same in both), or a
    staged backward layout (whose forward then fits too)."""
    return (4 * _floats(fl, dim, KV_BLOCK, backward=True) <= _SMEM_MAX
            or _layout_fit(1, fl, fg, c, heads, dim, elt, True) is not None)


def _sms(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry ``name`` of csrc/cross_attention.cu with its argument types, built and bound once."""
    fn = getattr(_build.library("cross_attention"), name)
    fn.restype = ctypes.c_int
    n_ptr = 10 if name == "cross_attention_fwd" else 14
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_size_t] + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, its data 16-byte aligned (the kernels copy rows in 8- and 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, k, v, wq, bq, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """The forward kernel on CUDA tensors: the staged design where ``cross_plan`` fits, else the first."""
    _check_kernel(x, k, v, heads, dim)
    b, s, fl, c = x.shape
    fg = k.shape[2]
    tokens = b * s
    x, k, v = _aligned(x), _aligned(k), _aligned(v)
    wq, wo = wq.to(x.dtype).contiguous(), wo.to(x.dtype).contiguous()
    wo_t = wo.t().contiguous()
    bq, bo = bq.float().contiguous(), bo.float().contiguous()
    out = torch.empty_like(x)
    plan = cross_plan(tokens, fl, fg, c, heads, dim, x.dtype == torch.bfloat16, _sms(x.device), False)
    grid = plan["grid"]
    scratch_size = 0 if plan["route"] == "staged" else grid * fl * heads * dim * x.element_size()
    scratch = torch.empty(max(scratch_size, 16), device=x.device, dtype=torch.uint8)  # the first design's rounded o_h
    route = ctypes.c_int(0)
    err = _entry("cross_attention_fwd")(
        _DTYPES[x.dtype], x.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(), bq.data_ptr(), wo.data_ptr(),
        wo_t.data_ptr(), bo.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), tokens, fl, fg, c,
        heads, dim, KV_BLOCK, plan["tile"], grid, 1.0 / math.sqrt(dim),
        torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "cross_attention_fwd")
    launches["cross_attention_fwd"] += 1
    staged["cross_attention_fwd"] += route.value
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
    x, k, v, g = _aligned(x), _aligned(k), _aligned(v), _aligned(g.to(x.dtype))
    wq_c = wq.to(x.dtype).contiguous()
    wo_t = wo.to(x.dtype).t().contiguous()
    bq_f = bq.float().contiguous()
    plan = cross_plan(tokens, fl, fg, c, heads, dim, x.dtype == torch.bfloat16, _sms(x.device), True)
    grid = plan["grid"]
    first = plan["route"] == "simt"
    wq_t = wq_c.t().contiguous() if first else None  # the first design's dx product reads along rows
    scratch_size = grid * fl * 2 * hd * x.element_size() if first else 0
    scratch = torch.empty(max(scratch_size, 16), device=x.device, dtype=torch.uint8)  # its rounded o_h | dq
    total = 2 * c * hd + hd + c
    partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
    grads = torch.empty(total, device=x.device, dtype=torch.float32)
    dx, dk, dv = torch.empty_like(x), torch.empty_like(k), torch.empty_like(v)
    route = ctypes.c_int(0)
    err = _entry("cross_attention_bwd")(
        _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), k.data_ptr(), v.data_ptr(), wq_c.data_ptr(),
        None if wq_t is None else wq_t.data_ptr(), bq_f.data_ptr(), wo_t.data_ptr(), dx.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), partial.data_ptr(), grads.data_ptr(), scratch.data_ptr(), scratch.numel(), tokens, fl, fg, c,
        heads, dim, KV_BLOCK, plan["tile"], grid, 1.0 / math.sqrt(dim),
        torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(route),
    )
    _build.check(err, "cross_attention_bwd")
    launches["cross_attention_bwd"] += 1
    staged["cross_attention_bwd"] += route.value
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
