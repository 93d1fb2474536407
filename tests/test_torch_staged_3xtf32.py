"""The float32 staged dense and streaming temporal backwards in split-precision TF32 ("3xTF32"), on the CPU.

In float32 the staged dense backward (csrc/temporal_attention.cu, ``temporal_bwd_panel_kernel<float, BIAS>``) runs
its five width-scaling products (q|k|v, do, dW_o, dW_qkv, dx) and the streaming blockwise backward
(csrc/temporal_blockwise.cu, ``temporal_stream_bwd_kernel<float, ...>``) those products and its attention fragments
(S, P V, dP, dq, dk, dv) on the tensor cores: each operand split into a TF32 high and low part, three TF32 products
per 8-deep step summed apart and added to the float32 total (route "staged-3xtf32"). Here, without a card:

- the planner sends the fixed flagship's f = 10 levels up to c = 64 and the fixed long clip's f = 128 level at
  c = 32 to that route in float32, and wider columns (D1's temporal backward at c = 256 among them) to the tf32x3
  design, the faster there by measurement; the staged tiles fit 227 KB with grids not capped under the SM count by
  the weight-gradient partials; bf16 keeps its plans, value for value; the 3xTF32 primitives have one copy, in
  common.cuh;
- ``_staged3_bwd`` and ``_stream3_bwd`` repeat each kernel's order of operations with the split products (the
  dense kernel: tiles of tokens over a persistent grid, heads in turn, per-CTA partials summed in CTA order; the
  streaming kernel: one token column at a time, sweep 1 over KV blocks of 32, phase B over query rows, phase A over
  16-key rows and 16-query blocks) and are held against the plain backward oracles at 1e-5 of each output's largest
  value, dbias included, and against the JAX Pallas kernels in interpret mode.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import mm3, seeded, split
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024
GATE = 1e-5  # the float32 backward gate: max-abs error over each output's largest value
CSRC = Path(ta.__file__).resolve().parent.parent / "csrc"
HEADS, DIM = 8, 32

# (tokens, f, c) of the float32 backwards this route was made for: D1's temporal attention (batch 8 x 256 patches,
# 16 frames), the fixed flagship's four f = 10 levels at batch 8, the fixed long clip's four f = 128 levels.
D1_TEMPORAL = (2048, 16, 256)
FIXED = [(32768, 10, 32), (8192, 10, 64), (2048, 10, 128), (512, 10, 256)]
LONG = [(4096, 128, 32), (1024, 128, 64), (256, 128, 128), (64, 128, 256)]
# The parent's bf16 backward plans at the same shapes (route, bt or c-chunk, ring slots, shared memory, grid).
BF16_PLANS = {
    D1_TEMPORAL: ("staged", 4, None, 219392, 127), FIXED[0]: ("staged", 8, None, 82368, 264),
    FIXED[1]: ("staged", 8, None, 107968, 264), FIXED[2]: ("staged", 8, None, 159168, 132),
    FIXED[3]: ("staged", 2, None, 130432, 127), LONG[0]: ("staged", 32, 2, 147968, 132),
    LONG[1]: ("staged", 64, 2, 214528, 132), LONG[2]: ("staged", 128, 1, 175104, 132),
    LONG[3]: ("staged", 128, 1, 226304, 64),
}


# ---- the planner ----

@pytest.mark.parametrize("shape", [D1_TEMPORAL, *FIXED, *LONG], ids=str)
def test_targets_take_the_measured_route_and_fill_the_card(shape):
    """The measured rule (``_f32_takes_tf32x3``): the staged dense kernel in 3xTF32 up to c = 64 at f <= 64, the
    streaming one up to c = 32 at f > 64, the tf32x3 design above (D1's temporal backward at c = 256 among them)."""
    tokens, f, c = shape
    plan = ta.temporal_plan(tokens, f, c, DIM, HEADS, False, SMS, True)
    assert plan["family"] == ("dense" if f <= ta.MAX_FRAMES else "blockwise")
    staged = c <= (64 if f <= ta.MAX_FRAMES else 32)
    assert plan["route"] == (ta.STAGED_3XTF32 if staged else "tf32x3") and plan["smem"] <= SMEM_MAX
    if not staged:
        assert {k: v for k, v in plan.items() if k != "family"} == ta.tf32x3_plan(tokens, f, c, DIM, HEADS, SMS)
        assert tokens * HEADS >= SMS
        return
    total = c * 3 * HEADS * DIM + 3 * HEADS * DIM + HEADS * DIM * c + c
    assert plan["grid"] * 4 * total <= ta._F32_WORKSPACE_MAX
    if f <= ta.MAX_FRAMES:  # one CTA per SM, as many as there are tiles
        assert plan["smem"] == ta._tc_bwd_bytes(plan["bt"], f, c, DIM, 4)
        assert plan["rows_padded"] % 16 == 0 and plan["grid"] == min(SMS, -(-tokens // plan["bt"]))
        # as many 10-frame tokens as one CTA's shared memory holds (12 at c = 32, 9 at c = 64), not whole 16-row
        # blocks: fewer, larger tiles measured faster
        bt = plan["bt"]
        assert ta._tc_bwd_bytes(bt, f, c, DIM, 4) <= SMEM_MAX - 1024 < ta._tc_bwd_bytes(bt + 1, f, c, DIM, 4)
        assert (bt, plan["grid"]) == ({32: 12, 64: 9}[c], SMS)
    else:  # the streaming plan, scratch-free for P, one CTA per SM or per token
        assert plan == {**plan, **ta.stream_plan(f, c, DIM, 4, True, False)}
        assert plan["grid"] == min(SMS, tokens)
    # the forward takes the same route, in 3xTF32 too
    assert ta.temporal_plan(tokens, f, c, DIM, HEADS, False, SMS, False)["route"] == ta.STAGED_3XTF32


def test_the_rule_off_the_targets():
    """The rule's edges, and the staged dense tile's: at D1's temporal shape the staged kernel would hold two tokens
    (32 rows) on every SM, no longer 127 CTAs under the partials' cap, but the tf32x3 design was faster there."""
    assert ta._f32_takes_tf32x3(16, 256, DIM) and not ta._f32_takes_tf32x3(16, 64, DIM)
    assert ta._f32_takes_tf32x3(128, 33, DIM) and not ta._f32_takes_tf32x3(128, 32, DIM)
    assert not ta._f32_takes_tf32x3(16, 512, 128)  # head dims over 64: beyond the tf32x3 design
    tokens, f, c = D1_TEMPORAL
    bt = ta._staged_tile(tokens, f, SMS, lambda n: ta._tc_bwd_bytes(n, f, c, DIM, 4), 1)
    assert bt == 2 and ta._tc_bwd_bytes(bt, f, c, DIM, 4) <= SMEM_MAX < ta._tc_bwd_bytes(bt + 1, f, c, DIM, 4)
    total = c * 3 * HEADS * DIM + 3 * HEADS * DIM + HEADS * DIM * c + c
    assert SMS * 4 * total <= ta._F32_WORKSPACE_MAX and ta._WORKSPACE_MAX // (4 * total) == 127


@pytest.mark.parametrize("shape", list(BF16_PLANS), ids=str)
def test_bf16_keeps_its_plans(shape):
    tokens, f, c = shape
    plan = ta.temporal_plan(tokens, f, c, DIM, HEADS, True, SMS, True)
    got = (plan["route"], plan.get("bt", plan.get("ck")), plan.get("slots"), plan["smem"], plan["grid"])
    assert got == BF16_PLANS[shape]


def test_streaming_float32_backward_holds_no_p_scratch():
    """The float32 streaming backward keeps P and dS in registers, and so does the forward: neither layout holds
    a warp's scratch for P, in Python as in C (``sw_layout``); the backward's longest plan at head dim 32 is
    f = 160."""
    src = (CSRC / "temporal_blockwise.cu").read_text()
    assert "scr" not in src[src.index("struct SwPlan"):src.index("// The plan a launch takes")]
    for f in (72, 128, 160):
        bare = ta._stream_layout(f, 32, DIM, 4, False, False, 32, 1, True)  # the forward, without a scratch ...
        assert ta._stream_layout(f, 32, DIM, 2, False, False, 32, 1, True)["smem"] < bare["smem"]
        # ... and the backward's panels on top of it, without a scratch
        bwd = ta._stream_layout(f, 32, DIM, 4, True, False, 32, 1, True)["smem"]
        fp, ldd, ldx = ta._round16(f), ta._pad_ld(32), ta._pad_ld(32)
        extra = (4 * fp * ldx + ta._al16(fp * ldd * 4) + ta._al16(fp * 36 * 4) + ta._al16(3 * fp * 4)
                 + ta._al16(8 * 96 * 4))
        assert bwd == bare["smem"] + extra, (f, bwd, bare["smem"] + extra)
    assert ta.stream_plan(160, 256, DIM, 4, True, False) is not None
    assert ta.stream_plan(161, 256, DIM, 4, True, False) is None


# float32 bits -> the high part of their split (TF32 to nearest, ties away from zero; infinities kept), or None for a
# NaN, whose split must keep it (the GPU's own 0x7fffffff and its negation among them, whose high part the integer
# rounding carries into -0 / +0).
SPLIT_BITS = {
    "one": (0x3F800000, 0x3F800000), "tie_away": (0x3F801000, 0x3F802000), "under_tie": (0x3F800FFF, 0x3F800000),
    "neg_tie": (0xBF801000, 0xBF802000), "inf": (0x7F800000, 0x7F800000), "neg_inf": (0xFF800000, 0xFF800000),
    "gpu_nan": (0x7FFFFFFF, None), "neg_gpu_nan": (0xFFFFFFFF, None), "quiet_nan": (0x7FC00000, None),
    "low_bit_nan": (0x7F800001, None),
}


def _bits(u: int) -> torch.Tensor:
    return torch.tensor([u - (1 << 32) if u >= 1 << 31 else u], dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("name", list(SPLIT_BITS))
def test_split_keeps_nan(name):
    """``split`` (the helper and csrc/common.cuh alike): hi rounded to nearest, lo = v - hi left whole for the tensor
    cores to read; a NaN v gives a NaN lo, so a 3xTF32 product with a NaN operand is a NaN."""
    u, want = SPLIT_BITS[name]
    v = _bits(u)
    hi, lo = split(v)
    if want is None:
        assert torch.isnan(lo).all()
        assert torch.isnan(mm3(v.view(1, 1), torch.ones(1, 1))).all()
        assert torch.isnan(mm3(torch.ones(1, 1), v.view(1, 1))).all()
    else:
        assert torch.equal(hi.view(torch.int32), _bits(want).view(torch.int32))
        if math.isinf(v.item()):  # inf - inf: a product with an infinity is a NaN, as through cvt.rna
            assert torch.isnan(lo).all()
        else:
            assert abs(hi.item() + lo.item() - v.item()) <= 2 ** -21 * abs(v.item())
    common = (CSRC / "common.cuh").read_text()
    assert "hi = tf32(v);\n  lo = __float_as_uint(v - __uint_as_float(hi));" in common


def test_one_copy_of_the_3xtf32_primitives():
    """The split, the TF32 product and the warp fragments live in common.cuh; the three sources include them."""
    common = (CSRC / "common.cuh").read_text()
    for name in ("unsigned tf32(float v)", "void split(float v", "void mma_tf32(", "void mma3(", "void split4(",
                 "void frag_a(", "void nt3(", "void pv3(", "void tf3_mma(", "void tf3_mma_add("):
        assert common.count(name) == 1, name
    assert common.count("mma.sync.aligned.m16n8k8") == common.count("0x1000u) & 0xffffe000u") == 1
    for src in ("temporal_attention.cu", "temporal_blockwise.cu", "temporal_tf32x3.cu"):
        text = (CSRC / src).read_text()
        assert '#include "common.cuh"' in text, src
        assert "mma.sync.aligned.m16n8k8" not in text and "0xffffe000" not in text and "tf32.f32" not in text, src


# ---- the kernels' order of operations, with the split products ----

def _mm3k(a, b):
    """The split product in the kernels' order: each 8-deep step of the sum (three TF32 products) summed apart and
    added to the float32 total."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        out = out + mm3(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
    return out


def _head_cols(heads, dim, h):
    return [torch.arange(part * heads * dim + h * dim, part * heads * dim + (h + 1) * dim) for part in range(3)]


def _staged3_bwd(x, g, wqkv, bqkv, wo, heads, dim, pos_bias=None, bt=2, grid=2):
    """temporal_bwd_panel_kernel<float, BIAS>: tiles of ``bt`` tokens over ``grid`` persistent CTAs, the heads in
    turn; the five width-scaling products split, the per-token f x f products and the softmax in float32; weight,
    bias and dbias gradients in per-CTA partials summed in CTA order; dx = g + the heads' sum."""
    b, s, f, c = x.shape
    tok, hd, scale = b * s, heads * dim, 1.0 / math.sqrt(dim)
    xs, gs = x.reshape(tok, f, c), g.reshape(tok, f, c)
    pw, pb = torch.zeros(grid, c, 3 * hd), torch.zeros(grid, 3 * hd)
    po, pbo, pdb = torch.zeros(grid, hd, c), torch.zeros(grid, c), torch.zeros(grid, heads, f, f)
    dx = torch.empty_like(xs)
    for tile in range(-(-tok // bt)):
        cta, t0, t1 = tile % grid, tile * bt, min(tok, tile * bt + bt)
        nt, xt, gt = t1 - t0, xs[t0:t1].reshape(-1, c), gs[t0:t1].reshape(-1, c)
        dxs = torch.zeros_like(xt)
        for h in range(heads):
            cols = _head_cols(heads, dim, h)
            q, k, v = ((_mm3k(xt, wqkv[:, cl]) + bqkv[cl]).reshape(nt, f, dim) for cl in cols)
            q = q * scale
            do = _mm3k(gt, wo[h * dim:(h + 1) * dim].t()).reshape(nt, f, dim)
            sim = q @ k.transpose(-1, -2) + (0 if pos_bias is None else pos_bias[h])
            p = torch.softmax(sim, -1)
            o = p @ v
            dv = p.transpose(-1, -2) @ do
            po[cta, h * dim:(h + 1) * dim] += _mm3k(o.reshape(-1, dim).t(), gt)
            dattn = do @ v.transpose(-1, -2)
            ds = p * (dattn - (dattn * p).sum(-1, keepdim=True))
            pdb[cta, h] += ds.sum(0)
            dq, dk = ds @ k * scale, ds.transpose(-1, -2) @ q
            dqkv = torch.cat([dq, dk, dv], -1).reshape(-1, 3 * dim)
            allc = torch.cat(cols)
            pb[cta, allc] += dqkv.sum(0)
            pw[cta][:, allc] += _mm3k(xt.t(), dqkv)
            dxs = dxs + _mm3k(dqkv, wqkv[:, allc].t())
        pbo[cta] += gt.sum(0)
        dx[t0:t1] = (gt + dxs).reshape(nt, f, c)
    grads = (dx.reshape(x.shape), pw.sum(0), pb.sum(0), po.sum(0), pbo.sum(0))
    return grads if pos_bias is None else (*grads, pdb.sum(0))


def _stream3_bwd(x, g, wqkv, bqkv, wo, heads, dim, pos_bias=None, grid=2):
    """temporal_stream_bwd_kernel<float, false, DP>: one token column at a time over ``grid`` persistent CTAs, the
    heads in turn; every product split (projections, S, P V, dP, dq, dk, dv, the weight gradients, dx); sweep 1 and
    phase B over KV blocks of 32, phase A over 16-key rows and 16-query blocks."""
    b, s, f, c = x.shape
    tok, hd, scale, kb = b * s, heads * dim, 1.0 / math.sqrt(dim), ta.KV_BLOCK
    xs, gs = x.reshape(tok, f, c), g.reshape(tok, f, c)
    pw, pb = torch.zeros(grid, c, 3 * hd), torch.zeros(grid, 3 * hd)
    po, pbo, pdb = torch.zeros(grid, hd, c), torch.zeros(grid, c), torch.zeros(grid, heads, f, f)
    dx = torch.empty_like(xs)
    bias = torch.zeros(heads, f, f) if pos_bias is None else pos_bias
    for t in range(tok):
        cta, xt, gt = t % grid, xs[t], gs[t]
        dxa = torch.zeros(f, c)
        for h in range(heads):
            cols = _head_cols(heads, dim, h)
            q, k, v = (_mm3k(xt, wqkv[:, cl]) + bqkv[cl] for cl in cols)
            q = q * scale
            do = _mm3k(gt, wo[h * dim:(h + 1) * dim].t())
            # sweep 1: m, l, o over KV blocks of 32 (query rows in blocks of 16 are independent)
            m, l, acc = torch.full((f, 1), -1e30), torch.zeros(f, 1), torch.zeros(f, dim)
            for j0 in range(0, f, kb):
                sim = _mm3k(q, k[j0:j0 + kb].t()) + bias[h][:, j0:j0 + kb]
                mn = torch.maximum(m, sim.amax(-1, keepdim=True))
                p, alpha = torch.exp(sim - mn), torch.exp(m - mn)
                l, acc, m = l * alpha + p.sum(-1, keepdim=True), acc * alpha + _mm3k(p, v[j0:j0 + kb]), mn
            o = acc / l
            lse, di = m + torch.log(l), (do * o).sum(-1, keepdim=True)
            # phase B: query rows over KV blocks of 32
            dq = torch.zeros(f, dim)
            for j0 in range(0, f, kb):
                p = torch.exp(_mm3k(q, k[j0:j0 + kb].t()) + bias[h][:, j0:j0 + kb] - lse)
                ds = p * (_mm3k(do, v[j0:j0 + kb].t()) - di)
                pdb[cta, h][:, j0:j0 + kb] += ds
                dq = dq + _mm3k(ds, k[j0:j0 + kb])
            dq = dq * scale
            # phase A: 16 key rows at a time over query blocks of 16
            dk, dv = torch.zeros(f, dim), torch.zeros(f, dim)
            for k0 in range(0, f, 16):
                for i0 in range(0, f, 16):
                    st = _mm3k(k[k0:k0 + 16], q[i0:i0 + 16].t()) + bias[h][i0:i0 + 16, k0:k0 + 16].t()
                    pt = torch.exp(st - lse[i0:i0 + 16, 0])
                    dst = pt * (_mm3k(v[k0:k0 + 16], do[i0:i0 + 16].t()) - di[i0:i0 + 16, 0])
                    dv[k0:k0 + 16] += _mm3k(pt, do[i0:i0 + 16])
                    dk[k0:k0 + 16] += _mm3k(dst, q[i0:i0 + 16])
            dqkv, allc = torch.cat([dq, dk, dv], -1), torch.cat(cols)
            pb[cta, allc] += dqkv.sum(0)
            po[cta, h * dim:(h + 1) * dim] += _mm3k(o.t(), gt)
            pw[cta][:, allc] += _mm3k(xt.t(), dqkv)
            dxa = dxa + _mm3k(dqkv, wqkv[:, allc].t())
        pbo[cta] += gt.sum(0)
        dx[t] = gt + dxa
    grads = (dx.reshape(x.shape), pw.sum(0), pb.sum(0), po.sum(0), pbo.sum(0))
    return grads if pos_bias is None else (*grads, pdb.sum(0))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item()


def _operands(f, c, heads, dim, seed, bias, tokens=3):
    hd = heads * dim
    x = torch.from_numpy(seeded((1, tokens, f, c), seed, 0.5))
    g = torch.from_numpy(seeded((1, tokens, f, c), seed + 1, 0.1))
    w = tuple(torch.from_numpy(seeded(shape, seed + 2 + i, sc)) for i, (shape, sc) in enumerate(
        (((c, 3 * hd), c ** -0.5), ((3 * hd,), 0.1), ((hd, c), hd ** -0.5), ((c,), 0.1))))
    pos_bias = torch.from_numpy(seeded((heads, f, f), seed + 7, 0.5)) if bias else None
    return x, g, w, pos_bias


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("f,c", [(10, 40), (16, 24)])
def test_staged_order_matches_the_plain_oracles(f, c, bias):
    x, g, w, pos_bias = _operands(f, c, 2, 16, f * 100 + c, bias, tokens=5)
    got = _staged3_bwd(x, g, w[0], w[1], w[2], 2, 16, pos_bias)
    want = ta.temporal_attention_bwd_plain(x, g, *w, 2, 16, pos_bias=pos_bias)
    assert len(got) == len(want)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        assert a.shape == v.shape and _rel(a, v) <= GATE, (name, _rel(a, v))


@pytest.mark.parametrize("bias", [False, True])
def test_stream_order_matches_the_plain_oracles(bias):
    """f = 72: three KV blocks, the last partial, and query blocks across the KV_BLOCK boundary."""
    x, g, w, pos_bias = _operands(72, 32, 2, 16, 72, bias, tokens=2)
    got = _stream3_bwd(x, g, w[0], w[1], w[2], 2, 16, pos_bias)
    want = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, 2, 16, ta.KV_BLOCK, pos_bias=pos_bias)
    assert len(got) == len(want)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        assert a.shape == v.shape and _rel(a, v) <= GATE, (name, _rel(a, v))


@pytest.mark.parametrize("f,bias", [(10, False), (16, True), (72, True)])
def test_orders_match_the_pallas_kernels(monkeypatch, f, bias):
    """The gradients of sum(out^2) through the JAX op (its dense Pallas kernel at f = 10 and 16, the blockwise one
    at f = 72, in interpret mode) against each kernel's order given g = 2 out."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    heads, dim, c = 2, 8, 16
    x, _, w, pos_bias = _operands(f, c, heads, dim, 11, bias, tokens=2)
    jw = [jnp.asarray(t.numpy()) for t in w]
    dense = f <= ta.MAX_FRAMES
    if bias:
        def loss(x, *a):
            return jnp.sum(jta.fused_temporal_attention_block_biased(x, *a[:4], a[4], heads, dim) ** 2)

        want = jax.grad(loss, argnums=tuple(range(6)))(jnp.asarray(x.numpy()), *jw, jnp.asarray(pos_bias.numpy()))
    else:
        def loss(x, *a):
            return jnp.sum(jta.fused_temporal_attention_block(x, *a, heads, dim) ** 2)

        want = jax.grad(loss, argnums=tuple(range(5)))(jnp.asarray(x.numpy()), *jw)
    out = (ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias) if dense
           else ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    order = _staged3_bwd if dense else _stream3_bwd
    got = order(x, 2 * out, w[0], w[1], w[2], heads, dim, pos_bias)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(v), rtol=2e-4, atol=2e-4, err_msg=name)
