"""The float32 tensor-core backward of the temporal op (``csrc/temporal_tf32x3.cu``), on the CPU.

In float32 both temporal backward families take this design where the staged dense tile or the streaming
plan does not fit: q|k|v, do, the weight gradients and dx as GEMMs whose products are split-precision TF32
(each operand a = hi + lo, hi = tf32(a), lo = a - hi as the tensor cores read it, truncated to TF32, three TF32
products lo*hi + hi*lo + hi*hi with float32 sums), and the attention core per (token, head) in 16-row blocks. Here, without a card:

- the planner routes D1's spatial backward (8, 16, 256, 256), D2's temporal backward (4, 64, 10, 384), D2's
  spatial (wide) backward (4, 10, 64, 384) and the fixed flagship's bottleneck (8, 10, 64, 256) to it, within
  227 KB of shared memory and with grids that fill 132 SMs; bf16 keeps its routes; the boundaries of the fit
  rule; the planner's constants are the source's;
- ``_tf32`` rounds to TF32 by masking mantissa bits (to nearest, ties away, as ``cvt.rna.tf32.f32``), and the
  split product stays within the float32 gate against float64 at D1's and D2's reduction lengths (c = 256 and
  384, f = 256, and D1's 32768 rows), where a single TF32 product does not;
- ``_tf32x3_bwd`` repeats the chain in the kernels' order (query-row blocks with the online softmax and dq,
  then key-row blocks for dk, dv and dbias) with the split products, and is held against the plain backward
  oracles at 1e-5 of each output's largest value, biased too, and against the JAX Pallas kernels (interpret
  mode) at the long-clip tests' tolerance.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import mm3 as _mm3
from torch_port_helpers import seeded
from torch_port_helpers import tf32 as _tf32
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024
GATE = 1e-5  # the float32 backward gate: max-abs error over each output's largest value
SOURCE = Path(ta.__file__).resolve().parent.parent / "csrc" / "temporal_tf32x3.cu"

# (b, s, f, c), heads, head dim and family of the shapes the design was made for: D1's spatial attention (256
# patches), D2's temporal attention (10 frames at c = 384), the fixed flagship's bottleneck (64 positions at
# batch 8) and the fixed long clip's (batch 1, 128 frames as columns).
TARGETS = {
    "d1_spatial": ((8, 16, 256, 256), 8, 32, "blockwise"),
    "d2_temporal": ((4, 64, 10, 384), 6, 64, "dense"),
    "d2_spatial": ((4, 10, 64, 384), 6, 64, "wide"),
    "fixed_bottleneck": ((8, 10, 64, 256), 8, 32, "dense"),
    "long_fixed_bottleneck": ((1, 128, 64, 256), 8, 32, "dense"),
}


def _tf32x3_bwd(x, g, wqkv, bqkv, wo, heads, dim, pos_bias=None):
    """The chain of csrc/temporal_tf32x3.cu in float32 with its split products and block order."""
    b, s, f, c = x.shape
    tok, hd, scale, rows = b * s, heads * dim, 1.0 / math.sqrt(dim), b * s * f
    fk, fq = -(-f // 32) * 32, -(-f // 16) * 16
    xr, gr = x.reshape(rows, c), g.reshape(rows, c)
    proj, dor = _mm3(xr, wqkv) + bqkv, _mm3(gr, wo.t())

    def panel(t):  # (rows, hd) -> (tok, H, fk, D), rows past f zero
        return torch.nn.functional.pad(t.reshape(tok, f, heads, dim).permute(0, 2, 1, 3), (0, 0, 0, fk - f))

    def rows_of(t):  # the inverse
        return t[..., :f, :].permute(0, 2, 1, 3).reshape(rows, hd)

    q, k, v, do = panel(proj[:, :hd]) * scale, panel(proj[:, hd:2 * hd]), panel(proj[:, 2 * hd:]), panel(dor)
    bias = torch.zeros(heads, fk, fk)
    if pos_bias is not None:
        bias[:, :f, :f] = pos_bias
    past = torch.arange(fk) >= f  # keys past f
    lse, di = torch.full((tok, heads, fk, 1), math.inf), torch.zeros(tok, heads, fk, 1)
    o, dq = torch.zeros_like(q), torch.zeros_like(q)
    # Query-row blocks of 16: the online softmax over 32-key blocks (lse, o, di), then dq.
    for r0 in range(0, fq, 16):
        qi, doi = q[..., r0:r0 + 16, :], do[..., r0:r0 + 16, :]
        m, l, acc = torch.full((tok, heads, 16, 1), -math.inf), torch.zeros(tok, heads, 16, 1), torch.zeros_like(qi)
        for k0 in range(0, fk, 32):
            sim = _mm3(qi, k[..., k0:k0 + 32, :].transpose(-1, -2)) + bias[:, r0:r0 + 16, k0:k0 + 32]
            sim = sim.masked_fill(past[k0:k0 + 32], -math.inf)
            mn = torch.maximum(m, sim.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - mn), torch.exp(sim - mn)
            l, acc, m = l * alpha + p.sum(-1, keepdim=True), acc * alpha + _mm3(p, v[..., k0:k0 + 32, :]), mn
        oi = acc / l
        lse_i, di_i = m + torch.log(l), (doi * oi).sum(-1, keepdim=True)
        valid = (torch.arange(r0, r0 + 16) < f)[:, None]
        lse[..., r0:r0 + 16, :] = torch.where(valid, lse_i, math.inf)
        di[..., r0:r0 + 16, :] = torch.where(valid, di_i, 0.0)
        o[..., r0:r0 + 16, :] = oi
        dqi = torch.zeros_like(qi)
        for k0 in range(0, fk, 32):
            sim = _mm3(qi, k[..., k0:k0 + 32, :].transpose(-1, -2)) + bias[:, r0:r0 + 16, k0:k0 + 32]
            p = torch.exp(sim - lse_i).masked_fill(past[k0:k0 + 32], 0.0)
            ds = p * (_mm3(doi, v[..., k0:k0 + 32, :].transpose(-1, -2)) - di_i) if f > 1 else torch.zeros_like(p)
            dqi = dqi + _mm3(ds, k[..., k0:k0 + 32, :])
        dq[..., r0:r0 + 16, :] = dqi * scale
    # Key-row blocks of 16 over 32-query blocks: dk, dv and dbias (padded queries carry lse = inf, so p = 0).
    dk, dv, dbias = torch.zeros_like(k), torch.zeros_like(v), torch.zeros(heads, fk, fk)
    for k0 in range(0, fq, 16):
        kj, vj = k[..., k0:k0 + 16, :], v[..., k0:k0 + 16, :]
        for q0 in range(0, fk, 32):
            qb, dob = q[..., q0:q0 + 32, :], do[..., q0:q0 + 32, :]
            st = _mm3(kj, qb.transpose(-1, -2)) + bias[:, q0:q0 + 32, k0:k0 + 16].transpose(-1, -2)
            pt = torch.exp(st - lse[..., q0:q0 + 32, 0][..., None, :])
            dst = pt * (_mm3(vj, dob.transpose(-1, -2)) - di[..., q0:q0 + 32, 0][..., None, :]) if f > 1 else 0 * pt
            dbias[:, q0:q0 + 32, k0:k0 + 16] += dst.sum(0).transpose(-1, -2)
            dv[..., k0:k0 + 16, :] += _mm3(pt, dob)
            dk[..., k0:k0 + 16, :] += _mm3(dst, qb)
    dqkv = torch.cat([rows_of(dq), rows_of(dk), rows_of(dv)], -1)
    grads = (gr + _mm3(dqkv, wqkv.t()), _mm3(xr.t(), dqkv), dqkv.sum(0), _mm3(rows_of(o).t(), gr), gr.sum(0))
    grads = (grads[0].reshape(x.shape), *grads[1:])
    return grads if pos_bias is None else (*grads, dbias[:, :f, :f])


def _rel(a, b):
    """Max-abs error over the reference's largest magnitude (at least 1e-6, as the card tests: at f = 1 the softmax is
    constant and dq, dk and dbias are exactly zero)."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-6)).item()


def _operands(f, c, heads, dim, seed, bias):
    hd = heads * dim
    x, g = torch.from_numpy(seeded((1, 3, f, c), seed, 0.5)), torch.from_numpy(seeded((1, 3, f, c), seed + 1, 0.1))
    w = tuple(torch.from_numpy(seeded(shape, seed + 2 + i, sc)) for i, (shape, sc) in enumerate(
        (((c, 3 * hd), c ** -0.5), ((3 * hd,), 0.1), ((hd, c), hd ** -0.5), ((c,), 0.1))))
    pos_bias = torch.from_numpy(seeded((heads, f, f), seed + 7, 0.5)) if bias else None
    return x, g, w, pos_bias


# ---- the planner ----

@pytest.mark.parametrize("name", list(TARGETS))
def test_targets_take_the_tf32x3_route_and_fill_the_card(name):
    (b, s, f, c), heads, dim, family = TARGETS[name]
    tokens, hd = b * s, heads * dim
    plan = ta.temporal_plan(tokens, f, c, dim, heads, False, SMS, True)
    assert plan["family"] == family and plan["route"] == "tf32x3"
    assert plan["smem"] <= SMEM_MAX and plan["smem"] == ta._tf32x3_smem(f, dim)
    # the attention core: one CTA per (token, head); the GEMMs' output tiles times their K splits
    assert plan["grid"] == tokens and plan["heads"] == heads and tokens * heads >= SMS
    s_w, s_o, s_b = plan["splits"]
    tiles_w = -(-c // 128) * -(-3 * hd // 128)
    tiles_o = -(-hd // 128) * -(-c // 128)
    assert tiles_w * s_w >= SMS and tiles_o * s_o >= SMS and s_b == -(-tokens * f // 256)
    assert s_w * c * 3 * hd * 4 <= ta._WORKSPACE_MAX and s_o * hd * c * 4 <= ta._WORKSPACE_MAX
    # the forward keeps its route
    assert ta.temporal_plan(tokens, f, c, dim, heads, False, SMS, False)["route"] != "tf32x3"


@pytest.mark.parametrize("name", list(TARGETS))
def test_bf16_keeps_its_routes(name):
    """bf16 keeps the staged and streaming kernels, and the first design of the blockwise backward beyond
    f = 192 at c >= 128 (D1's spatial shape)."""
    (b, s, f, c), heads, dim, family = TARGETS[name]
    for backward in (False, True):
        plan = ta.temporal_plan(b * s, f, c, dim, heads, True, SMS, backward)
        first = backward and name == "d1_spatial"
        assert plan["family"] == family and plan["route"] == ("simt" if first else "staged")


@pytest.mark.parametrize("f,c,dim,route", [
    (144, 256, 32, "tf32x3"), (145, 256, 32, "tf32x3"), (160, 256, 32, "tf32x3"), (192, 256, 32, "tf32x3"),
    (321, 256, 32, "tf32x3"), (256, 32, 16, "tf32x3"), (128, 64, 64, "simt"), (150, 64, 48, "simt"),
    (64, 256, 32, "tf32x3"), (10, 384, 64, "tf32x3"), (10, 256, 64, "tf32x3"), (10, 160, 64, "tf32x3"),
    (16, 512, 128, "simt"), (144, 32, 32, "staged-3xtf32"), (160, 32, 32, "staged-3xtf32"),
    (161, 32, 32, "tf32x3"), (128, 33, 32, "tf32x3"), (10, 64, 64, "staged-3xtf32"), (10, 65, 64, "tf32x3"),
    (16, 64, 128, "staged-3xtf32")])
def test_route_boundaries(f, c, dim, route):
    """Blockwise head dims over 32 keep the first design; dense head dims over 64 keep the CUDA-core kernel. Where the
    staged dense (f <= 64) or the streaming (f > 64) float32 backward also fits, the measured rule decides: the staged
    kernel up to c = 64, the streaming one up to c = 32 (and f = 160, its longest plan); head dims over 64 stay
    staged, beyond this design's reach."""
    assert ta.temporal_plan(8, f, c, dim, 2, False, SMS, True)["route"] == route


def test_fit_rule():
    assert ta._tf32x3_fits(384, 32) and not ta._tf32x3_fits(385, 32)
    assert ta._tf32x3_fits(192, 64) and not ta._tf32x3_fits(193, 64)
    assert ta._tf32x3_fits(1, 1) and not ta._tf32x3_fits(16, 65)
    for f in (1, 10, 17, 64, 145, 256, 384):
        assert ta._tf32x3_smem(f, 32) <= SMEM_MAX


def test_planner_constants_are_the_sources():
    """Each constant where its source now holds it: the GEMM tiles and splits in temporal_tf32x3.cu; the attention
    core's shared memory, the fit rule and the measured rule in common.cuh, which all three float32 backward sources
    share."""
    src = SOURCE.read_text()
    common = (SOURCE.parent / "common.cuh").read_text()
    tiles = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+)", src)
    rows = re.search(r"constexpr int COLSUM_ROWS = (\d+);", src)
    assert tiles and rows
    assert (int(tiles[1]), int(tiles[2]), int(tiles[3]), int(rows[1])) == (ta._TF_TILE, ta._TF_TILE, ta._TF_BK,
                                                                          ta._TF_COLSUM_ROWS)
    assert "2 * round32(f)" in common and "4 * round32(f) * (dp + 4)" in common  # attn_smem, as _tf32x3_smem
    assert "(2 * sms + tiles - 1) / tiles" in src  # splits_for, as _tf32x3_splits
    assert "c > (f <= 64 ? 64 : 32)" in common  # f32_takes_tf32x3, as _f32_takes_tf32x3


# ---- the split product ----

def test_tf32_rounds_to_nearest_by_masking():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 3.0e-3])
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5].item() - 3.0e-3) <= 2 ** -11 * 3.0e-3


@pytest.mark.parametrize("what,m,k,n", [("c256", 64, 256, 96), ("c384", 64, 384, 96), ("f256_pv", 64, 256, 32),
                                        ("rows32768", 8, 32768, 8)])
def test_split_product_holds_the_float32_gate(what, m, k, n):
    """The products of the chain at D1's and D2's reduction lengths: widths c = 256 and 384 (projections, dx), the
    256 keys of P v (probabilities), D1's 32768 rows (weight gradients). One TF32 product misses the gate."""
    rng = np.random.default_rng(k + m)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    if what == "f256_pv":
        a = torch.softmax(torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)) * 2, -1)
    else:
        a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    ref = a.double() @ b.double()
    err3 = ((_mm3(a, b).double() - ref).abs().max() / ref.abs().max()).item()
    err1 = (((_tf32(a) @ _tf32(b)).double() - ref).abs().max() / ref.abs().max()).item()
    assert err3 <= GATE / 4, err3
    assert err1 > GATE, err1


# ---- the chain's order of operations ----

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("f,c,heads,dim", [(1, 24, 2, 8), (10, 40, 2, 8), (17, 24, 2, 16), (64, 48, 2, 8),
                                           (33, 20, 3, 20), (145, 24, 2, 8), (160, 16, 1, 16)])
def test_chain_matches_the_plain_oracles(f, c, heads, dim, bias):
    x, g, w, pos_bias = _operands(f, c, heads, dim, f * 100 + c, bias)
    got = _tf32x3_bwd(x, g, w[0], w[1], w[2], heads, dim, pos_bias)
    want = (ta.temporal_attention_bwd_plain(x, g, *w, heads, dim, pos_bias=pos_bias) if f <= ta.MAX_FRAMES
            else ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias))
    assert len(got) == len(want)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        assert a.shape == v.shape and _rel(a, v) <= GATE, (name, _rel(a, v))


@pytest.mark.parametrize("f,bias", [(10, False), (10, True), (145, False)])
def test_chain_matches_the_pallas_kernels(monkeypatch, f, bias):
    """The gradients of sum(out^2) through the JAX op (its dense Pallas kernel at f = 10, the blockwise one at
    f = 145, in interpret mode) against the chain given g = 2 out."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    heads, dim, c = 2, 8, 16
    x, _, w, pos_bias = _operands(f, c, heads, dim, 5, bias)
    jw = [jnp.asarray(t.numpy()) for t in w]
    import jax

    if bias:
        jb = jnp.asarray(pos_bias.numpy())

        def loss(x, *a):
            return jnp.sum(jta.fused_temporal_attention_block_biased(x, *a[:4], a[4], heads, dim) ** 2)

        want = jax.grad(loss, argnums=tuple(range(6)))(jnp.asarray(x.numpy()), *jw, jb)
        out = ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias)
    else:
        def loss(x, *a):
            return jnp.sum(jta.fused_temporal_attention_block(x, *a, heads, dim) ** 2)

        want = jax.grad(loss, argnums=tuple(range(5)))(jnp.asarray(x.numpy()), *jw)
        out = (ta.temporal_attention_plain(x, *w, heads, dim) if f <= ta.MAX_FRAMES
               else ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK))
    got = _tf32x3_bwd(x, 2 * out, w[0], w[1], w[2], heads, dim, pos_bias)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(v), rtol=2e-4, atol=2e-4, err_msg=name)
