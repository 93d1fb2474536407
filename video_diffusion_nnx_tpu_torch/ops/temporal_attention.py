"""Fused temporal-attention block (counterpart of the JAX package's ops/temporal_attention.py).

    out = x + out_proj(softmax(q(x) k(x)^T / sqrt(D) [+ pos_bias]) v(x))   over the f axis of x (b, s, f, c)

The public ops keep the JAX layouts: ``wqkv`` (c, 3*H*D) packs the q|k|v
kernels, ``bqkv`` is (3*H*D,), ``wo`` is (H*D, c) and ``bo`` is (c,).
``fused_temporal_attention_block_biased`` adds ``pos_bias`` (H, f, f) to the
float32 logits before the softmax (fixed math: the relative position bias)
and differentiates it: dbias sums the unrounded float32 logit gradient over
all tokens.

Three kernel families (``temporal_plan``). Up to ``MAX_FRAMES`` frames, as
the JAX ``_route`` has it, the dense kernels of ``csrc/temporal_attention.cu``
hold a token's whole f x f panel: the staged one (``temporal_bwd_panel_kernel``,
``temporal_fwd_panel_kernel``: panels in x's type in shared memory, the
width-scaling products on the tensor cores in bf16) wherever one token's tile
fits, else the CUDA-core one; ``bwd_plan`` and ``fwd_plan`` choose the route
and the tile for a given number of SMs. Where even the CUDA-core tile cannot
hold one token (``wide_needed``: at f = 64 and head dim 32, c >= 374 forward and
c >= 309 backward, as at the bottleneck of a dim-128 Unet3D) the "wide" family
takes over: the streaming kernels of ``csrc/temporal_blockwise.cu`` in mode
DENSE, with the dense kernels' rounding points (the JAX reference keeps these
shapes on its dense kernel). Longer clips take the blockwise (online-softmax)
family of ``csrc/temporal_blockwise.cu``, which walks K/V in blocks of
``KV_BLOCK`` frames: the streaming kernels wherever their plan fits
(``blockwise_plan``, ``stream_plan``: x, g and the weights staged in c-chunks,
a token's q|k|v in shared memory, the products on the tensor cores in bf16),
else the first design. In float32 the backward of either family takes a design
of its own where the staged dense tile or the streaming plan does not fit
(``tf32x3_plan``; ``csrc/temporal_tf32x3.cu``): the width-scaling products as
GEMMs and the attention core per (token, head), all on the tensor cores in
split-precision TF32 (three TF32 products per float32 product). Where they fit,
the staged and streaming kernels, forward and backward, take the same split
products in float32 (route "staged-3xtf32"); a float32 forward that the
staged tile cannot hold takes the streaming kernel in mode DENSE where
``_f32_fwd_takes_stream`` says so.

Dispatch has no hidden fallback. A CPU tensor takes the family's plain
version, differentiated by autograd; a CUDA tensor goes through
``_TemporalAttention``, whose forward and backward are the hand-written
kernels, or raises ``NotImplementedError`` for a shape the kernels do not
take. ``temporal_attention_bwd_plain`` and
``temporal_attention_blockwise_bwd_plain`` are the backward kernels'
oracles, with their rounding points; the wide family's are the dense ones.
Every plain version and every kernel takes the bias; a launch with it is
counted under a name of its own (``..._biased_fwd``, ``..._biased_bwd``),
``staged`` counts the launches that ran the staged or streaming kernel (of
them, ``staged_tf32x3`` those in float32, whose products run in 3xTF32) and
``tf32x3`` those that ran the float32 tensor-core backward of
``csrc/temporal_tf32x3.cu``.

dbias crosses CTAs like the weight gradients: each CTA of a backward kernel
adds into a float32 (H, f, f) partial of its own and ``reduce_partials_kernel``
sums the partials in a fixed order, so two runs are bit-equal. The partials
live in a workspace of their own (``_DBIAS_WORKSPACE_MAX``), apart from the
weight partials', so that the bias changes neither the weight workspace's
cap nor the grid of the unbiased kernels.
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
# The float32 staged and streaming backwards run one CTA per SM (their 3xTF32 products want the registers two
# CTAs would split); their partials may take twice the workspace, so that the partials' size never caps the grid
# under the SM count (262,400 floats a CTA at D1's temporal shape: 127 CTAs under the cap above).
_F32_WORKSPACE_MAX = 256 * 2**20
STAGED_3XTF32 = "staged-3xtf32"  # the route of the float32 staged and streaming kernels (C route 3)
_DBIAS_WORKSPACE_MAX = 256 * 2**20  # bytes of per-CTA dbias partials (H*f*f floats each) in one backward
_THREADS = 256  # threads of every CTA (kThreads in csrc/common.cuh)
_TC_SMEM_TARGET = 113 * 1024  # two staged CTAs per SM where a tile allows it

launches = {"temporal_attention_fwd": 0, "temporal_attention_bwd": 0,
            "temporal_blockwise_fwd": 0, "temporal_blockwise_bwd": 0,
            "temporal_attention_biased_fwd": 0, "temporal_attention_biased_bwd": 0,
            "temporal_blockwise_biased_fwd": 0, "temporal_blockwise_biased_bwd": 0,
            "temporal_wide_fwd": 0, "temporal_wide_bwd": 0,
            "temporal_wide_biased_fwd": 0, "temporal_wide_biased_bwd": 0}
# Launches that ran the staged (dense) or streaming (blockwise, wide) kernel, as the C entry reports (the rest ran
# the first design; the wide kernels have no other).
staged = {name: 0 for name in launches}
# Backward launches that ran the float32 design of csrc/temporal_tf32x3.cu (its C entry reports route 2).
tf32x3 = {name: 0 for name in launches}
# Launches, forward and backward, that ran the staged dense or the streaming kernel in float32, whose products run
# on the tensor cores in 3xTF32 (route 3; counted in ``staged`` too): the design "staged-3xtf32".
staged_tf32x3 = {name: 0 for name in launches}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def temporal_attention_plain(x, wqkv, bqkv, wo, bo, heads: int, dim: int, pos_bias=None) -> torch.Tensor:
    """Plain PyTorch version, with the rounding points of the JAX ``_composite_xla`` (:798-819).

    ``pos_bias`` (H, f, f) is added in float32 to the float32 logits.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    qkv = (x @ wqkv.to(dt)) + bqkv.to(dt)
    qkv = qkv.reshape(b, s, f, 3, heads, dim)
    scale = torch.tensor(1.0 / math.sqrt(dim), dtype=dt, device=x.device)
    q, k, v = qkv[..., 0, :, :] * scale, qkv[..., 1, :, :], qkv[..., 2, :, :]
    sim = torch.einsum("bsihd,bsjhd->bshij", q.float(), k.float())
    if pos_bias is not None:
        sim = sim + pos_bias.float()
    attn = torch.softmax(sim, dim=-1)
    o = torch.einsum("bshij,bsjhd->bsihd", attn.to(dt), v).reshape(b, s, f, heads * dim)
    y = (o @ wo.to(dt)) + bo.to(dt)
    return x + y


def temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int, pos_bias=None):
    """The backward of ``temporal_attention_plain`` by explicit formulas: ``(dx, dwqkv, dbqkv, dwo, dbo)``.

    Rounding points of the JAX ``_bwd_kernel`` (:189-286): q|k|v in x's
    type, the softmax and its VJP in float32, ``attn``, ``do``, ``ds`` and
    ``dqkv`` rounded to x's type before each product, db_qkv summed from the
    unrounded dqkv, float32 weight gradients. With ``pos_bias`` the result
    gains dbias (H, f, f) last: the unrounded float32 ds summed over the
    tokens, in ``pos_bias``'s type.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    hd = heads * dim
    f32 = torch.float32
    scale = 1.0 / math.sqrt(dim)
    qkv = ((x.to(f32) @ wqkv.to(dt).to(f32)) + bqkv.to(f32)).to(dt).reshape(b, s, f, 3, heads, dim)
    q = qkv[..., 0, :, :] * torch.tensor(scale, dtype=dt, device=x.device)
    k, v = qkv[..., 1, :, :], qkv[..., 2, :, :]
    sim = torch.einsum("bsihd,bsjhd->bshij", q.float(), k.float())
    if pos_bias is not None:
        sim = sim + pos_bias.float()
    attn = torch.softmax(sim, dim=-1)
    attn_c = attn.to(dt).float()
    o = torch.einsum("bshij,bsjhd->bsihd", attn_c, v.float()).to(dt).float()
    gf = g.to(f32)
    gc = g.to(dt).float()
    dwo = torch.einsum("bsihd,bsic->hdc", o, gc).reshape(hd, c)
    do = torch.einsum("bsic,hdc->bsihd", gc, wo.to(dt).float().reshape(heads, dim, c)).to(dt).float()
    dattn = torch.einsum("bsihd,bsjhd->bshij", do, v.float())
    dv = torch.einsum("bshij,bsihd->bsjhd", attn_c, do)
    ds_f = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    ds = ds_f.to(dt).float()
    dq = torch.einsum("bshij,bsjhd->bsihd", ds, k.float()) * scale
    dk = torch.einsum("bshij,bsihd->bsjhd", ds, q.float())
    dqkv = torch.stack([dq, dk, dv], dim=3).reshape(b, s, f, 3 * hd)
    dbqkv = dqkv.sum((0, 1, 2))
    dqkv_c = dqkv.to(dt).float()
    dwqkv = torch.einsum("bsfc,bsfk->ck", x.float(), dqkv_c)
    dx = (gf + dqkv_c @ wqkv.to(dt).float().t()).to(dt)
    grads = (dx, dwqkv, dbqkv, dwo, gf.sum((0, 1, 2)))
    if pos_bias is None:
        return grads
    return (*grads, ds_f.sum((0, 1)).to(pos_bias.dtype))


def _online_softmax_plain(x, wqkv, bqkv, heads: int, dim: int, kb: int, pos_bias=None):
    """The blockwise kernels' sweep over KV blocks of ``kb`` frames, in plain PyTorch.

    Returns ``(q, k, v, m, l, acc)``, all float32 and head-major (b, s, H, f, .):
    q|k|v hold values rounded to x's type (q scaled before its one rounding),
    ``m`` and ``l`` the running row maximum and sum of the unrounded
    ``p = exp(s - m)``, ``acc`` the sum of ``round(p) v`` (JAX
    ``_project_q`` :396-402 and ``_online_softmax_pass`` :343-393). ``pos_bias``
    (H, f, f) is added to each block's float32 logits before the row maximum.
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
        if pos_bias is not None:
            sim = sim + pos_bias.float()[..., j0:j0 + kb]
        m_new = torch.maximum(m, sim.amax(-1, keepdim=True))
        p = torch.exp(sim - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ vj
        m = m_new
    return q, k, v, m, l, acc


def temporal_attention_blockwise_plain(x, wqkv, bqkv, wo, bo, heads: int, dim: int, kb: int,
                                       pos_bias=None) -> torch.Tensor:
    """Plain PyTorch version of the blockwise forward kernel (JAX ``_fwd_blockwise_kernel`` :405-429).

    The function of ``temporal_attention_plain``, with other rounding points:
    the probabilities round to x's type unnormalised, before the p v
    product, and the division by the row sum comes after it.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    _, _, _, _, l, acc = _online_softmax_plain(x, wqkv, bqkv, heads, dim, kb, pos_bias)
    oh = (acc / l).to(dt).float().transpose(2, 3).reshape(b, s, f, heads * dim)
    y = oh @ wo.to(dt).float() + bo.float()
    return x + y.to(dt)


def temporal_attention_blockwise_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int, kb: int,
                                           pos_bias=None):
    """The blockwise backward kernel's oracle: ``(dx, dwqkv, dbqkv, dwo, dbo)`` by explicit formulas.

    Rounding points of the JAX ``_bwd_blockwise_kernel`` (:432-584): the
    probabilities are rebuilt from ``lse = m + log l``; ``di = rowsum(do * o)``
    uses the unrounded ``do`` and ``o``; p, do, ds, dk|dv and dq round to x's
    type before each product; db_qkv sums the unrounded values; float32
    weight gradients. With ``pos_bias`` the bias enters the logits of both
    sweeps and the result gains dbias (H, f, f) last: each block's unrounded
    ``ds`` summed over the tokens, in ``pos_bias``'s type.
    """
    b, s, f, c = x.shape
    dt = x.dtype
    hd = heads * dim
    scale = 1.0 / math.sqrt(dim)
    w = wqkv.to(dt).float()
    q, k, v, m, l, acc = _online_softmax_plain(x, wqkv, bqkv, heads, dim, kb, pos_bias)
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
    dbias = None if pos_bias is None else torch.empty(heads, f, f, dtype=torch.float32, device=x.device)
    for j0 in range(0, f, kb):
        kj, vj = k[..., j0:j0 + kb, :], v[..., j0:j0 + kb, :]
        sim = q @ kj.transpose(-1, -2)
        if pos_bias is not None:
            sim = sim + pos_bias.float()[..., j0:j0 + kb]
        p = torch.exp(sim - lse)
        p_c = p.to(dt).float()
        ds = p * (do_c @ vj.transpose(-1, -2) - di)
        if dbias is not None:
            dbias[..., j0:j0 + kb] = ds.sum((0, 1))
        ds_c = ds.to(dt).float()
        dv[..., j0:j0 + kb, :] = p_c.transpose(-1, -2) @ do_c
        dk[..., j0:j0 + kb, :] = ds_c.transpose(-1, -2) @ q
        dq = dq + ds_c @ kj
    dqkv = torch.stack([dq * scale, dk, dv]).permute(1, 2, 4, 0, 3, 5).reshape(b, s, f, 3 * hd)
    dbqkv = dqkv.sum((0, 1, 2))
    dqkv_c = dqkv.to(dt).float()
    dwqkv = torch.einsum("bsfc,bsfk->ck", x.float(), dqkv_c)
    dx = (gf + dqkv_c @ w.t()).to(dt)
    grads = (dx, dwqkv, dbqkv, dwo, gf.sum((0, 1, 2)))
    return grads if dbias is None else (*grads, dbias.to(pos_bias.dtype))


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


def _blockwise_grid(tokens: int, f: int, dim: int, backward: bool, sms: int) -> int:
    """CTAs of the first design's persistent grid: as many as are resident at once, at most one per token."""
    smem = 4 * _blockwise_floats(f, dim, KV_BLOCK, backward)
    return max(1, min(tokens, sms * max(1, min(4, _SMEM_MAX // (smem + 1024)))))


def _al16(n: int) -> int:
    return -(-n // 16) * 16


def _stream_layout(f: int, c: int, dim: int, elt: int, backward: bool, dense: bool, ck: int, ns: int,
                   acc_smem: bool) -> dict:
    """``sw_layout`` in csrc/temporal_blockwise.cu: the streaming kernels' shared memory for one launch.

    Rows pad to 16 (k|v to whole KV blocks of 32, or 64 in mode DENSE), head dims to 32 or 64, c to
    16; a ring of ``ns`` slots holds c-chunks of ``ck`` columns of x (and g), W_qkv,h and W_o,h.
    """
    fp, cp, dp = _round16(f), _round16(c), 32 if dim <= 32 else 64
    kb = 64 if dense else 32
    fk = -(-fp // kb) * kb
    nch = -(-cp // ck)
    ldq, ldd, ldx = _pad_ld(3 * dp), _pad_ld(dp), _pad_ld(ck)
    slot = fp * ldx * (2 if backward else 1) + ck * ldq + dp * ldx
    at = _al16(ns * slot * elt) + _al16(fk * ldq * elt) + _al16(fp * ldd * elt)
    if backward:  # do (x's type and float32), the row statistics, the warps' column sums
        at += _al16(fp * ldd * elt) + _al16(fp * (dp + 4) * 4) + _al16(3 * fp * 4) + _al16(8 * 3 * dp * 4)
    if nch > 1 and elt == 2:  # the q|k|v sums over the chunks (float32 panels sum in place)
        at += _al16(fp * (3 * dp + 4) * 4)
    if acc_smem:  # y (forward) or dx (backward), float32
        at += _al16(fp * (cp + 4) * 4)
    return {"ck": ck, "chunks": nch, "slots": ns, "acc_smem": acc_smem, "smem": at, "rows_padded": fp,
            "kv_rows": fk, "dim_padded": dp, "kv_block": kb, "acc_floats": fp * (cp + 4)}


def stream_plan(f: int, c: int, dim: int, elt: int, backward: bool, dense: bool) -> dict | None:
    """``sw_plan``: the streaming kernels' layout, or None where nothing fits 227 KB.

    The widest c-chunk first (c itself, then 256, 128, 64, 32), then the float32 accumulator in shared
    memory before device memory, then two ring slots before one. Head dims up to 64 in mode DENSE (f <= 64),
    up to 32 in mode BLOCKWISE. The C launcher makes the same choice from the shape.
    """
    if dim > 64 or (not dense and dim > 32) or (dense and f > MAX_FRAMES):
        return None
    cp = _round16(c)
    for i, ck in enumerate((cp, 256, 128, 64, 32)):
        if i and ck >= cp:
            continue
        for acc_smem in (True, False):
            for ns in (2, 1):
                plan = _stream_layout(f, c, dim, elt, backward, dense, ck, ns, acc_smem)
                if plan["smem"] <= _SMEM_MAX:
                    return plan
    return None


def _dense_row_floats(f: int, c: int, dim: int, backward: bool) -> int:
    """Floats of shared memory per tile row of the dense CUDA-core kernels (``_tile``'s sizing)."""
    return 2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1 if backward else 2 * c + 3 * dim + 1 + f + 1


def wide_needed(f: int, c: int, dim: int, backward: bool) -> bool:
    """f <= ``MAX_FRAMES`` and the dense kernels cannot hold one token: the CUDA-core tile's float32 row
    panels exceed shared memory (where ``fwd_plan`` / ``bwd_plan`` raise)."""
    return f <= MAX_FRAMES and 4 * f * _dense_row_floats(f, c, dim, backward) > _SMEM_MAX


def blockwise_plan(tokens: int, f: int, c: int, dim: int, heads: int, bf16: bool, sms: int, backward: bool,
                   dense: bool = False) -> dict:
    """The launch of a blockwise (or, with ``dense``, wide) kernel for ``sms`` SMs: route, grid, scratch.

    ``route`` "staged": the streaming kernel (panels staged in x's type, warp-owned query rows, the products
    on the tensor cores in bf16), with its ``stream_plan`` fields; "staged-3xtf32" in float32, whose products
    and attention fragments run on the tensor cores in 3xTF32 (the backward one CTA per SM whose partials
    take up to ``_F32_WORKSPACE_MAX``, up to c = 32: ``_f32_takes_tf32x3``; wider, "tf32x3"); where the
    streaming plan does not fit (mode BLOCKWISE only; a wide shape that does not fit raises), "tf32x3" for a
    float32 backward at head dims up to 32 (``tf32x3_plan``), else "simt", the first design. ``scratch`` is
    the bytes of device scratch the launch needs (the C entry checks it). The bf16 forward of mode BLOCKWISE puts
    two CTAs on an SM where shared memory allows; the rest take one. The backward's grid keeps its partials
    within ``_WORKSPACE_MAX`` (and ``_DBIAS_WORKSPACE_MAX``, which the caller applies with a bias).
    """
    elt = 2 if bf16 else 4
    if not dense:  # the first design's limit holds either way, so that no shape runs forward and then fails backward
        _check_blockwise(f, dim)
    plan = stream_plan(f, c, dim, elt, backward, dense)
    if (backward and not (bf16 or dense) and dim <= 32 and _tf32x3_fits(f, dim)
            and (plan is None or _f32_takes_tf32x3(f, c, dim))):
        return tf32x3_plan(tokens, f, c, dim, heads, sms)
    if plan is None:
        if dense:
            raise NotImplementedError(f"temporal attention kernel: one token's panels exceed shared memory at f={f}, "
                                      f"c={c}, head dim {dim}")
        grid = _blockwise_grid(tokens, f, dim, backward, sms)
        plan = {"route": "simt", "smem": 4 * _blockwise_floats(f, dim, KV_BLOCK, backward)}
    else:
        # two bf16 forward CTAs per SM where shared memory allows (the float32 kernels' 3xTF32 fragments want
        # the registers of one CTA an SM)
        per_sm = 2 if bf16 and not dense and not backward and 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
        grid = max(1, min(tokens, sms * per_sm))
        plan = {"route": "staged" if bf16 else STAGED_3XTF32, **plan}
    if backward:
        total = c * 3 * heads * dim + 3 * heads * dim + heads * dim * c + c
        cap = _F32_WORKSPACE_MAX if plan["route"] == STAGED_3XTF32 else _WORKSPACE_MAX
        grid = min(grid, max(1, cap // (4 * total)))
    return {**plan, "grid": grid, "scratch": _scratch_bytes(plan, grid, f, heads, dim, elt, backward)}


def _scratch_bytes(plan: dict, grid: int, f: int, heads: int, dim: int, elt: int, backward: bool) -> int:
    """``scratch_bytes``: the streaming kernels' float32 accumulator per CTA where it is not in shared memory,
    the first design's column of x's type per CTA."""
    if plan["route"] in ("staged", STAGED_3XTF32):
        return 0 if plan["acc_smem"] else 4 * grid * plan["acc_floats"]
    return grid * f * (4 if backward else 1) * heads * dim * elt


_TF_TILE, _TF_BK, _TF_COLSUM_ROWS = 128, 32, 256  # tf::BM = BN, BK and COLSUM_ROWS in csrc/temporal_tf32x3.cu


def _tf32x3_smem(f: int, dim: int) -> int:
    """``attn_smem``: the attention core's q, k, v and do panels (round32(f) rows, head dim padded to 32 or
    64, plus 4) and its row statistics, in bytes."""
    fk, dp = -(-f // 32) * 32, 32 if dim <= 32 else 64
    return 4 * (4 * fk * (dp + 4) + 2 * fk)


def _tf32x3_fits(f: int, dim: int) -> bool:
    """``tf32x3_fits``: head dims up to 64 and the attention core within 227 KB (f <= 384 at 32, 192 at 64)."""
    return 1 <= dim <= 64 and f >= 1 and _tf32x3_smem(f, dim) <= _SMEM_MAX


def _f32_takes_tf32x3(f: int, c: int, dim: int) -> bool:
    """``f32_takes_tf32x3`` in csrc/common.cuh: where a 3xTF32 staged dense (f <= 64) or streaming (f > 64) float32
    backward and the tf32x3 design both take a shape, the faster by measurement on the H100 (PERF.md, PR 22): the
    staged kernel up to c = 64, the streaming one up to c = 32, the tf32x3 chain above. Measured at the recipes'
    shapes alone: off them (few tokens at a small c) it may pick the slower design."""
    return _tf32x3_fits(f, dim) and c > (64 if f <= MAX_FRAMES else 32)


def _tf32x3_splits(tiles: int, k: int, sms: int) -> int:
    """``splits_for``: K splits of a weight-gradient GEMM of ``tiles`` output tiles, about two CTAs per SM."""
    kt = -(-k // _TF_BK)
    s = max(1, min(max(1, -(-2 * sms // tiles)), kt))
    per = -(-kt // s)
    return -(-kt // per)


def _al64(n: int) -> int:
    return -(-n // 64) * 64


def tf32x3_plan(tokens: int, f: int, c: int, dim: int, heads: int, sms: int) -> dict:
    """The float32 tensor-core backward's launch (``layout`` in csrc/temporal_tf32x3.cu): the attention
    core's grid (``grid`` tokens by ``heads``, ``smem`` bytes), the K splits of the two weight-gradient
    GEMMs and of the bias gradients' column sums, and the device scratch in bytes."""
    rows, hd = tokens * f, heads * dim
    t = _TF_TILE
    s_w = _tf32x3_splits(-(-c // t) * -(-3 * hd // t), rows, sms)
    s_o = _tf32x3_splits(-(-hd // t) * -(-c // t), rows, sms)
    s_b = -(-rows // _TF_COLSUM_ROWS)
    floats = (_al64(rows * 3 * hd) + _al64(rows * hd) + _al64(s_w * c * 3 * hd) + _al64(s_o * hd * c)
              + _al64(s_b * 3 * hd) + _al64(s_b * c))
    return {"route": "tf32x3", "grid": tokens, "heads": heads, "smem": _tf32x3_smem(f, dim),
            "splits": (s_w, s_o, s_b), "scratch": 4 * floats}


def temporal_plan(tokens: int, f: int, c: int, dim: int, heads: int, bf16: bool, sms: int,
                  backward: bool) -> dict:
    """The kernel a CUDA call of the op launches: ``family`` "dense" (``fwd_plan`` / ``bwd_plan``), "wide"
    (f <= 64 where the dense tile cannot hold one token, or a float32 forward that ``_f32_fwd_takes_stream`` gives
    it: the streaming kernel in mode DENSE, with the dense kernels' rounding points; the float32 backward takes
    ``tf32x3_plan``) or "blockwise" (f > 64), with that family's plan. Never a plain version."""
    if f > MAX_FRAMES:
        return {"family": "blockwise", **blockwise_plan(tokens, f, c, dim, heads, bf16, sms, backward)}
    f32_fwd_stream = not (backward or bf16) and _f32_fwd_takes_stream(f, c, dim)
    if wide_needed(f, c, dim, backward) or f32_fwd_stream:
        if backward and not bf16 and _tf32x3_fits(f, dim):  # float32: the tensor-core design, as dense shapes
            return {"family": "wide", **tf32x3_plan(tokens, f, c, dim, heads, sms)}
        return {"family": "wide", **blockwise_plan(tokens, f, c, dim, heads, bf16, sms, backward, dense=True)}
    planner = bwd_plan if backward else fwd_plan
    return {"family": "dense", **planner(tokens, f, c, dim, heads, bf16, sms)}


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tile(tokens: int, f: int, c: int, dim: int, sms: int, backward: bool) -> int:
    """Tokens per CTA of the CUDA-core kernels: as many as fit the shared-memory target, spread over the SMs."""
    token_bytes = 4 * f * _dense_row_floats(f, c, dim, backward)
    if token_bytes > _SMEM_MAX:
        raise NotImplementedError(
            f"temporal attention kernel: one token's panels ({token_bytes} B at f={f}, c={c}) "
            "exceed shared memory"
        )
    fit = max(1, _SMEM_TARGET // token_bytes)
    spread = max(1, -(-tokens // (2 * sms)))
    return max(1, min(fit, spread, 64))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pad_ld(n: int) -> int:
    """A bf16 panel's leading dimension (``pad_ld`` in csrc/common.cuh): n rounded up to 16, plus 8."""
    return _round16(n) + 8


def _tc_bwd_bytes(bt: int, f: int, c: int, dim: int, elt: int) -> int:
    """Shared memory of the staged backward at ``bt`` tokens per tile and ``elt``-byte panels (``tc_bwd_plan``)."""
    rp, cp, dp = _round16(bt * f), _round16(c), _round16(dim)
    ldc, ldd, ldq = _pad_ld(c), _pad_ld(dim), _pad_ld(3 * dp)
    ws = max(cp * ldd, dp * ldc)
    return (elt * (2 * rp * ldc + 2 * rp * ldq + 2 * rp * ldd + 2 * ws) + 4 * rp * (cp + 8) + 4 * rp * (f + 1)
            + 4 * 2 * _THREADS)


def _tc_bwd_fits(bt: int, f: int, c: int, dim: int, elt: int) -> bool:
    """``tc_bwd_fits``: the tile fits shared memory and every column-sum slot has a thread (head dims <= 128)."""
    return 2 * _round16(dim) <= _THREADS and _tc_bwd_bytes(bt, f, c, dim, elt) <= _SMEM_MAX


def _key_window(f: int) -> int:
    """The widest window of keys a 16-row block of query rows attends to, rounded to 16 (``key_window``)."""
    g = math.gcd(16, f)  # a block's first row lies at an offset into its token that is a multiple of g
    return _round16(f * (1 + (f - g + 15) // f))


def _tc_fwd_bytes(bt: int, f: int, c: int, dim: int, elt: int) -> int:
    """Shared memory of the staged forward at ``bt`` tokens per tile and ``elt``-byte panels (``tc_fwd_plan``).

    Tiles also hold the probabilities by key window and 16 zero rows past the q|k|v panel.
    """
    rp, cp, dp = _round16(bt * f), _round16(c), _round16(dim)
    ldc, ldd, ldq = _pad_ld(c), _pad_ld(dim), _pad_ld(3 * dp)
    ws = max(cp * ldd, dp * ldc)
    windows = rp * _pad_ld(_key_window(f)) + 16 * ldq
    return elt * (rp * ldc + rp * ldq + 2 * ws + windows) + 4 * rp * (cp + 8) + 4 * rp * (f + 1)


def _tc_fwd_fits(bt: int, f: int, c: int, dim: int, elt: int) -> bool:
    """``tc_fwd_fits``: the staged forward's tile of ``bt`` tokens fits shared memory."""
    return _tc_fwd_bytes(bt, f, c, dim, elt) <= _SMEM_MAX


def _f32_fwd_takes_stream(f: int, c: int, dim: int) -> bool:
    """``f32_fwd_takes_stream`` in csrc/temporal_attention.cu: a float32 forward whose staged tile holds no token
    takes the streaming kernel in mode DENSE (family "wide", 3xTF32) rather than the CUDA-core kernel where a token
    fills its one 64-key block (f = 64), head dims up to 64. Measured on the H100 (PERF.md §6): faster at f = 64 (the
    fixed bottleneck, c = 256, head dim 32; c = 128, head dim 64), slower at f = 10 (D2's temporal attention), 16,
    24, 32, 40 and 48; f = 49-63 is not measured and keeps the CUDA-core kernel."""
    return f == MAX_FRAMES and dim <= 64 and not _tc_fwd_fits(1, f, c, dim, 4)


def _staged_tile(tokens: int, f: int, sms: int, nbytes, per_sm: int = 2) -> int:
    """Tokens per staged tile: as many as fit two CTAs per SM (or one CTA, where that leaves fewer
    than 64 rows), spread over the SMs, in whole 16-row blocks where the tile allows it. With ``per_sm``
    1 (the float32 kernels, one CTA per SM): as many as fit one CTA, spread over one CTA per SM, in any
    number of rows (fewer, larger tiles measured faster than whole 16-row blocks, PERF.md, PR 22)."""
    def fit(target: int) -> int:
        n = 1
        while n < 64 and nbytes(n + 1) <= target:
            n += 1
        return n

    if per_sm == 1:
        return max(1, min(fit(_SMEM_MAX - 1024), -(-tokens // sms)))
    bt = fit(_TC_SMEM_TARGET)
    if bt * f < 64:  # two CTAs per SM would leave tiles of few rows: one CTA of a larger tile instead
        bt = fit(_SMEM_MAX - 1024)
    bt = max(1, min(bt, -(-tokens // (per_sm * sms))))
    unit = 16 // math.gcd(f, 16)
    return bt - bt % unit if bt >= unit else bt


def fwd_plan(tokens: int, f: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The dense forward's launch: route, tokens per tile, shared memory and grid, for ``sms`` SMs.

    The staged kernel (``route`` "staged": panels in x's type, the projections and the per-token
    products on the tensor cores in bf16; "staged-3xtf32" in float32, both in 3xTF32, one CTA per SM holding
    as many tokens as 227 KB does) takes every shape whose one-token tile fits; the rest the CUDA-core kernel
    ("simt"), in float32 where ``temporal_plan`` does not give them the streaming kernel instead.
    Raises where the CUDA-core kernel cannot hold one token, as it always did. The C launcher makes
    the same choice from ``bt`` (``tc_fwd_fits``). ``heads`` does not change the tile: each head
    runs over the same tile in turn.
    """
    bt = _tile(tokens, f, c, dim, sms, False)  # raises where one token does not fit
    smem = 4 * bt * f * _dense_row_floats(f, c, dim, False)
    route, elt = "simt", 2 if bf16 else 4
    if _tc_fwd_fits(1, f, c, dim, elt):
        route = "staged" if bf16 else STAGED_3XTF32
        bt = _staged_tile(tokens, f, sms, lambda n: _tc_fwd_bytes(n, f, c, dim, elt), 2 if bf16 else 1)
        smem = _tc_fwd_bytes(bt, f, c, dim, elt)
    return {"route": route, "bt": bt, "smem": smem, "grid": -(-tokens // bt), "rows": bt * f,
            "rows_padded": bt * f if route == "simt" else _round16(bt * f)}


def bwd_plan(tokens: int, f: int, c: int, dim: int, heads: int, bf16: bool, sms: int) -> dict:
    """The dense backward's launch: route, tokens per tile, shared memory and grid, for ``sms`` SMs.

    The staged kernel (``route`` "staged": panels in x's type, the products on the tensor cores in
    bf16; "staged-3xtf32" in float32, its width-scaling products on the tensor cores in 3xTF32, one
    CTA per SM whose partials take up to ``_F32_WORKSPACE_MAX``) takes every shape whose one-token
    tile fits, in float32 up to c = 64 (``_f32_takes_tf32x3``); in float32 the rest take the
    tensor-core design of ``tf32x3_plan`` ("tf32x3") up to head dim 64, and what is left the
    CUDA-core kernel ("simt"). Raises where the CUDA-core kernel cannot hold one token, which is
    where the staged one cannot either. The C launcher makes the same choice from ``bt``
    (``tc_bwd_fits``) and holds the same rule (``f32_takes_tf32x3``).
    """
    if dim % 4:
        raise NotImplementedError(f"the temporal backward kernel takes head dims divisible by 4, not {dim}")
    bt = _tile(tokens, f, c, dim, sms, True)  # raises where one token does not fit
    smem = 4 * bt * f * _dense_row_floats(f, c, dim, True)
    route, elt = "simt", 2 if bf16 else 4
    if not bf16 and _tc_bwd_fits(1, f, c, dim, elt) and _f32_takes_tf32x3(f, c, dim):
        return tf32x3_plan(tokens, f, c, dim, heads, sms)
    if _tc_bwd_fits(1, f, c, dim, elt):
        route = "staged" if bf16 else STAGED_3XTF32
        bt = _staged_tile(tokens, f, sms, lambda n: _tc_bwd_bytes(n, f, c, dim, elt), 2 if bf16 else 1)
        smem = _tc_bwd_bytes(bt, f, c, dim, elt)
    elif not bf16 and _tf32x3_fits(f, dim):
        return tf32x3_plan(tokens, f, c, dim, heads, sms)
    # two CTAs per SM where shared memory allows, except the float32 staged kernel, whose launch
    # bounds leave it more than the 128 registers a thread that two CTAs would
    per_sm = 2 if 2 * (smem + 1024) <= 228 * 1024 and (bf16 or route == "simt") else 1
    total = c * 3 * heads * dim + 3 * heads * dim + heads * dim * c + c
    cap = _F32_WORKSPACE_MAX if route == STAGED_3XTF32 else _WORKSPACE_MAX
    grid = max(1, min(-(-tokens // bt), sms * per_sm, cap // (4 * total)))
    return {"route": route, "bt": bt, "smem": smem, "grid": grid, "rows": bt * f,
            "rows_padded": bt * f if route == "simt" else _round16(bt * f)}


def _check(x, wqkv, bqkv, wo, bo, heads: int, dim: int, pos_bias=None) -> None:
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
    if pos_bias is not None and tuple(pos_bias.shape) != (heads, f, f):
        raise ValueError(f"pos_bias must be (heads, f, f) = {(heads, f, f)}; got {tuple(pos_bias.shape)}")
    for t in (wqkv, bqkv, wo, bo, pos_bias):
        if t is not None and t.device != x.device:
            raise ValueError("all operands must be on x's device")


def _launch(x, wqkv, bqkv, wo, bo, heads: int, dim: int, pos_bias=None) -> torch.Tensor:
    """The forward kernel of x's family on CUDA tensors (``temporal_plan``): dense up to ``MAX_FRAMES``
    (wide where the dense tile cannot hold one token), else blockwise.

    With ``pos_bias`` the kernel's biased instantiation runs, and is counted under its own name.
    """
    _check(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias)
    bias = None if pos_bias is None else pos_bias.float().contiguous()
    bias_ptr = None if bias is None else bias.data_ptr()
    tag = "" if bias is None else "_biased"
    b, s, f, c = x.shape
    wqkv = wqkv.to(x.dtype).contiguous()
    wo = wo.to(x.dtype).contiguous()
    bqkv = bqkv.float().contiguous()
    bo = bo.float().contiguous()
    tokens = b * s
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(dim)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = temporal_plan(tokens, f, c, dim, heads, x.dtype == torch.bfloat16, _sms(x.device), False)
    x = x if x.data_ptr() % 16 == 0 else x.clone()  # copied in 8-byte chunks
    route = ctypes.c_int(0)
    if plan["family"] == "dense":
        fn = _build.library("temporal_attention").temporal_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), bias_ptr, out.data_ptr(), tokens, f, c, heads, dim, plan["bt"], scale, stream,
            ctypes.byref(route),
        )
    else:
        scratch = torch.empty(max(plan["scratch"], 16), device=x.device, dtype=torch.uint8)
        fn = _build.library("temporal_blockwise").temporal_blockwise_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_size_t] + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        err = fn(
            _DTYPES[x.dtype], int(plan["family"] == "wide"), x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), bias_ptr, out.data_ptr(), scratch.data_ptr(), scratch.numel(), tokens,
            f, c, heads, dim, KV_BLOCK, plan["grid"], scale, stream, ctypes.byref(route),
        )
    name = f"temporal_{'attention' if plan['family'] == 'dense' else plan['family']}{tag}_fwd"
    _build.check(err, name)
    launches[name] += 1
    staged[name] += route.value in (1, 3)
    staged_tf32x3[name] += route.value == 3
    return out


def temporal_attention_bwd(x, g, wqkv, bqkv, wo, bo, heads: int, dim: int, pos_bias=None):
    """Backward of the block: the family's kernel on CUDA tensors, its plain formulas on CPU ones.

    Returns ``(dx, dwqkv, dbqkv, dwo, dbo)``: dx in x's type, the rest float32. With ``pos_bias``
    the biased instantiation runs and dbias (H, f, f), in ``pos_bias``'s type, comes last.
    """
    f = x.shape[-2]
    if not x.is_cuda:
        if f <= MAX_FRAMES:
            return temporal_attention_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads, dim, pos_bias)
        return temporal_attention_blockwise_bwd_plain(x, g, wqkv, bqkv, wo, bo, heads, dim, KV_BLOCK, pos_bias)
    _check(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias)
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
    tag = "" if pos_bias is None else "_biased"
    panel = heads * f * f  # floats of the bias and of each CTA's dbias partial

    def bias_buffers(grid: int):
        """The float32 bias, the CTAs' dbias partials and dbias, and their pointers (null without a bias)."""
        if pos_bias is None:
            return None, [None] * 3
        tensors = (pos_bias.float().contiguous(), torch.empty(grid, panel, device=x.device, dtype=torch.float32),
                   torch.empty(heads, f, f, device=x.device, dtype=torch.float32))
        return tensors, [t.data_ptr() for t in tensors]

    sms = _sms(x.device)
    plan = temporal_plan(tokens, f, c, dim, heads, x.dtype == torch.bfloat16, sms, True)
    grid = plan["grid"]
    if pos_bias is not None:  # binds only where the grid follows the tokens (the dense grid stays under it)
        grid = min(grid, max(1, _DBIAS_WORKSPACE_MAX // (4 * panel)))
    x, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, g))  # copied in 8-byte chunks
    bias_t, bias_ptrs = bias_buffers(grid)
    route = ctypes.c_int(0)
    if plan["route"] == "tf32x3":  # float32: the tensor-core GEMMs and attention core, 16-byte aligned operands
        wqkv_c, wo_c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (wqkv_c, wo_c))
        work = torch.empty(plan["scratch"], device=x.device, dtype=torch.uint8)
        fn = _build.library("temporal_tf32x3").temporal_tf32x3_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_size_t] + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        err = fn(
            x.data_ptr(), g.data_ptr(), wqkv_c.data_ptr(), bqkv_f.data_ptr(), wo_c.data_ptr(), *bias_ptrs,
            dx.data_ptr(), grads.data_ptr(), work.data_ptr(), work.numel(), tokens, f, c, heads, dim, sms, grid,
            scale, stream, ctypes.byref(route),
        )
    elif plan["family"] == "dense":
        partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
        fn = _build.library("temporal_attention").temporal_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), wqkv_c.data_ptr(), bqkv_f.data_ptr(),
            wo_c.data_ptr(), *bias_ptrs, dx.data_ptr(), partial.data_ptr(), grads.data_ptr(), tokens, f, c,
            heads, dim, plan["bt"], grid, scale, stream, ctypes.byref(route),
        )
    else:
        partial = torch.empty(grid, total, device=x.device, dtype=torch.float32)
        scratch_size = _scratch_bytes(plan, grid, f, heads, dim, x.element_size(), True)
        scratch = torch.empty(max(scratch_size, 16), device=x.device, dtype=torch.uint8)
        # the first design reads the weights transposed, so that its dx and dW_o products read along rows
        first = plan["route"] == "simt"
        wqkv_t = wqkv_c.t().contiguous() if first else None
        wo_t = wo_c.t().contiguous() if first else None
        fn = _build.library("temporal_blockwise").temporal_blockwise_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14 + [ctypes.c_size_t] + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        err = fn(
            _DTYPES[x.dtype], int(plan["family"] == "wide"), x.data_ptr(), g.data_ptr(), wqkv_c.data_ptr(),
            None if wqkv_t is None else wqkv_t.data_ptr(), bqkv_f.data_ptr(), wo_c.data_ptr(),
            None if wo_t is None else wo_t.data_ptr(), *bias_ptrs, dx.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), scratch.numel(), tokens, f, c, heads, dim, KV_BLOCK, grid,
            scale, stream, ctypes.byref(route),
        )
    name = f"temporal_{'attention' if plan['family'] == 'dense' else plan['family']}{tag}_bwd"
    _build.check(err, name)
    launches[name] += 1
    staged[name] += route.value in (1, 3)
    tf32x3[name] += route.value == 2
    staged_tf32x3[name] += route.value == 3
    dwqkv, dbqkv, dwo, dbo = grads.split([c * 3 * hd, 3 * hd, hd * c, c])
    out = (dx, dwqkv.view(c, 3 * hd), dbqkv, dwo.view(hd, c), dbo)
    return out if pos_bias is None else (*out, bias_t[2].to(pos_bias.dtype))


class _TemporalAttention(torch.autograd.Function):
    """The block on CUDA tensors: forward and backward are the hand-written kernels; ``pos_bias`` may be None."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, pos_bias, heads: int, dim: int):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, pos_bias)
        ctx.heads, ctx.dim = heads, dim
        return _launch(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wo, bo, pos_bias = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwo, dbo, *dbias = temporal_attention_bwd(
            x, g, wqkv, bqkv, wo, bo, ctx.heads, ctx.dim, pos_bias)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype),
                dbias[0] if dbias else None, None, None)


def _block(x, wqkv, bqkv, wo, bo, pos_bias, heads: int, dim: int) -> torch.Tensor:
    if x.is_cuda:
        return _TemporalAttention.apply(x, wqkv, bqkv, wo, bo, pos_bias, heads, dim)
    f = x.shape[-2]
    if f <= MAX_FRAMES:
        return temporal_attention_plain(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias)
    return temporal_attention_blockwise_plain(x, wqkv, bqkv, wo, bo, heads, dim, KV_BLOCK, pos_bias)


def fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, heads: int, dim: int) -> torch.Tensor:
    """``x + MHA(x)`` over the second-to-last axis of ``x`` (b, s, f, c); differentiable."""
    return _block(x, wqkv, bqkv, wo, bo, None, heads, dim)


def fused_temporal_attention_block_biased(x, wqkv, bqkv, wo, bo, pos_bias, heads: int, dim: int) -> torch.Tensor:
    """``x + MHA(x, pos_bias)`` with ``pos_bias`` (heads, f, f) added to the logits before the softmax.

    The fixed-math temporal attention (JAX ``fused_temporal_attention_block_biased``, :1038-1065);
    differentiable in all six tensors, so the relative-position table trains through it. The
    pre-norm runs outside: callers pass the normalized x and swap the residual
    (``out = x_orig + (this(xn, ...) - xn)``).
    """
    if pos_bias is None:
        raise ValueError("pos_bias is required; fused_temporal_attention_block is the unbiased op")
    return _block(x, wqkv, bqkv, wo, bo, pos_bias, heads, dim)


def pack_mha_weights(mha) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A MultiheadAttention module's weights in the op's layouts (JAX ``pack_mha_weights``)."""
    wqkv = torch.cat([mha.q.weight.t(), mha.k.weight.t(), mha.v.weight.t()], dim=-1)
    bqkv = torch.cat([mha.q.bias, mha.k.bias, mha.v.bias])
    return wqkv, bqkv, mha.out.weight.t(), mha.out.bias
