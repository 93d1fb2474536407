"""The staged cross-attention kernels' planner and order of sums, on the CPU.

The redesigned cross pair (``csrc/cross_attention.cu``: tiles of tokens, one warp per head, K|V of a token
staged once for all heads) lays out shared memory with ``cross_plan`` (C: ``cross_plan``), searching the
tokens per tile, then the c-chunk (resident weights first), then the backward's weight-gradient partials on
chip before device memory, then two K|V slots before one, then two chunk slots before one. It takes no card,
so every shape ``chip_smoke.py`` and the card tests hand these kernels is checked here in both types and
directions: the plan fits 227 KB, it is the first that fits in that order, and the grid follows the rules
the C entry is given; the first design runs only where nothing fits. Then ``_cross_bwd`` repeats the staged
backward's order of sums in float32 (tiles of tokens walked by each CTA of a persistent grid; per token and
head the online sweep over KV blocks of 32, phase A over 16-key blocks and 16-row query blocks, phase B over
KV blocks of 32; the weight gradients and db_o per tile into the CTA's partial, db_q per token and head; the
partials summed in CTA order) and is held against the plain backward oracle at 1e-5 of each output's largest
value.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from video_diffusion_nnx_tpu_torch.ops import cross_attention as xa

SMS = 132  # H100 SXM
HEADS, DIM = 8, 32


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _smoke()
# (b, s, f_l, f_g, c): the sequence-parallel recipe's seven shapes, the smoke's ragged f_g and self-attention
# cases, and the card tests' shapes.
RECIPE = [(_CS.B, s, _CS.SEQ_FL, _CS.SEQ_FG, c) for _, (s, c) in _CS.SEQ_CROSS_SHAPES]
SHAPES = RECIPE + [(1, 64, 4, 21, 64), (_CS.B, 64, 32, 32, 64), (2, 64, 8, 32, 256), (1, 96, 8, 32, 32),
                   (1, 16, 4, 21, 64)]


def _first_fit(tile, fl, fg, c, elt, backward):
    """The order ``cross_plan`` searches, written out: tokens per tile down to 1, the chunk (c, then 128, 64,
    32, 16 below it), the partials' place, the K|V slots, the chunk slots."""
    cp = -(-c // 16) * 16
    for t in range(tile, 0, -1):
        for i, ck in enumerate((cp, 128, 64, 32, 16)):
            if i and ck >= cp:
                continue
            for part in ((True, False) if backward else (False,)):
                for nkv in (2, 1):
                    for nw in ((1,) if i == 0 else (2, 1)):
                        lay = xa.cross_layout(t, fl, fg, c, HEADS, DIM, elt, backward, ck, part, nkv, nw)
                        if lay["smem"] <= 227 * 1024:
                            return lay
    return None


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_recipe_and_card_shape_takes_the_staged_kernels(shape, bf16, backward):
    b, s, fl, fg, c = shape
    tokens, elt = b * s, 2 if bf16 else 4
    plan = xa.cross_plan(tokens, fl, fg, c, HEADS, DIM, bf16, SMS, backward)
    assert plan["route"] == "staged"
    assert plan["smem"] <= 227 * 1024 and plan["smem"] % 16 == 0
    tile = max(1, min(max(1, 16 // fl), -(-tokens // SMS)))
    assert plan == {**plan, **_first_fit(tile, fl, fg, c, elt, backward)}
    assert plan["rows_padded"] % 16 == 0 and plan["rows_padded"] >= plan["tile"] * fl
    assert plan["chunks"] == -(-(-(-c // 16) * 16) // plan["ck"]) and plan["resident"] == (plan["chunks"] == 1)
    assert plan["partial_smem"] <= backward
    per_sm = 2 if not backward and 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
    assert plan["grid"] <= min(-(-tokens // plan["tile"]), per_sm * SMS)
    if backward:
        assert plan["grid"] * 4 * (2 * c * HEADS * DIM + HEADS * DIM + c) <= xa._WORKSPACE_MAX


def test_the_widest_level_fills_the_card():
    """x (2, 4096, 8, 32) in bf16: two tokens (16 rows) per tile, resident weights and two K|V slots both ways;
    the forward two CTAs on every SM, the backward one with its weight-gradient partials on chip."""
    fwd = xa.cross_plan(8192, 8, 32, 32, HEADS, DIM, True, SMS, False)
    bwd = xa.cross_plan(8192, 8, 32, 32, HEADS, DIM, True, SMS, True)
    assert fwd["tile"] == bwd["tile"] == 2 and fwd["rows_padded"] == 16
    assert fwd["resident"] and bwd["resident"] and fwd["kv_slots"] == bwd["kv_slots"] == 2
    assert fwd["grid"] == 2 * SMS and bwd["grid"] == SMS and bwd["partial_smem"]


def test_the_narrow_levels_take_one_token_per_tile():
    """The 128 tokens of the s = 64 levels: one per tile, so 128 CTAs and no token's K|V read twice; c = 256
    streams its weights in chunks."""
    for c in (128, 256):
        for backward in (False, True):
            plan = xa.cross_plan(128, 8, 32, c, HEADS, DIM, True, SMS, backward)
            assert plan["tile"] == 1 and plan["grid"] == 128
    assert not xa.cross_plan(128, 8, 32, 256, HEADS, DIM, True, SMS, True)["resident"]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_first_design_only_where_no_plan_fits(bf16):
    """K|V of 300 frames exceed shared memory, and head dims other than 32 and 64 have no staged kernel: the
    first design runs there, with its own grid; where neither design holds a token the op raises."""
    elt = 2 if bf16 else 4
    for fg, dim in ((300, 32), (32, 16), (32, 128)):
        for backward in (False, True):
            plan = xa.cross_plan(64, 8, fg, 32, HEADS, dim, bf16, SMS, backward)
            assert plan["route"] == "simt"
            if dim == DIM:
                assert _first_fit(1, 8, fg, 32, elt, backward) is None
            assert plan["smem"] == 4 * xa._floats(8, dim, xa.KV_BLOCK, backward) and plan["grid"] <= 64
    x = torch.empty(1, 1, 2048, 256, dtype=torch.bfloat16 if bf16 else torch.float32)
    k = torch.empty(1, 1, 32, 256, dtype=x.dtype)
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        xa._check_kernel(x, k, k, HEADS, DIM)


# ---- the staged backward's order of sums, in float32 ----

def _cross_bwd(x, g, k, v, wq, bq, wo, heads, dim, tile, grid):
    """The staged backward's arithmetic in float32, in the kernel's order (rounding is the identity)."""
    b, s, fl, c = x.shape
    fg = k.shape[2]
    hd, scale, tokens = heads * dim, 1.0 / math.sqrt(dim), b * s
    xs, gs = x.reshape(tokens, fl, c), g.reshape(tokens, fl, c)
    ks, vs = k.reshape(tokens, fg, heads, dim), v.reshape(tokens, fg, heads, dim)
    dx, dk, dv = torch.empty_like(xs), torch.empty_like(ks), torch.empty_like(vs)
    partials = []
    ntiles = -(-tokens // tile)
    for cta in range(grid):
        dwq, dbq, dwo, dbo = torch.zeros(c, hd), torch.zeros(hd), torch.zeros(hd, c), torch.zeros(c)
        for t0 in range(cta, ntiles, grid):
            toks = range(t0 * tile, min(tokens, t0 * tile + tile))
            xr = xs[toks.start:toks.stop].reshape(-1, c)
            gr = gs[toks.start:toks.stop].reshape(-1, c)
            q = ((xr @ wq + bq) * scale).reshape(-1, fl, heads, dim)
            do = (gr @ wo.t()).reshape(-1, fl, heads, dim)
            o_t, dq_t = torch.empty_like(q), torch.empty_like(q)
            for i, tok in enumerate(toks):
                for h in range(heads):
                    qh, doh, kh, vh = q[i, :, h], do[i, :, h], ks[tok, :, h], vs[tok, :, h]
                    # the sweep: online over KV blocks of 32
                    m, l, acc = torch.full((fl, 1), -1e30), torch.zeros(fl, 1), torch.zeros(fl, dim)
                    for j0 in range(0, fg, 32):
                        sim = qh @ kh[j0:j0 + 32].t()
                        mn = torch.maximum(m, sim.amax(-1, keepdim=True))
                        p = torch.exp(sim - mn)
                        alpha = torch.exp(m - mn)
                        l, acc, m = l * alpha + p.sum(-1, keepdim=True), acc * alpha + p @ vh[j0:j0 + 32], mn
                    o = acc / l
                    lse, di = m + torch.log(l), (doh * o).sum(-1, keepdim=True)
                    o_t[i, :, h] = o
                    # phase A: key rows 16 at a time, query rows in blocks of 16
                    for k0 in range(0, fg, 16):
                        dkb, dvb = torch.zeros(min(16, fg - k0), dim), torch.zeros(min(16, fg - k0), dim)
                        for r0 in range(0, fl, 16):
                            pt = torch.exp(kh[k0:k0 + 16] @ qh[r0:r0 + 16].t() - lse[r0:r0 + 16].t())
                            dst = pt * (vh[k0:k0 + 16] @ doh[r0:r0 + 16].t() - di[r0:r0 + 16].t())
                            dvb = dvb + pt @ doh[r0:r0 + 16]
                            dkb = dkb + dst @ qh[r0:r0 + 16]
                        dk[tok, k0:k0 + 16, h], dv[tok, k0:k0 + 16, h] = dkb, dvb
                    # phase B: query rows, KV blocks of 32
                    dq = torch.zeros(fl, dim)
                    for j0 in range(0, fg, 32):
                        p = torch.exp(qh @ kh[j0:j0 + 32].t() - lse)
                        dq = dq + (p * (doh @ vh[j0:j0 + 32].t() - di)) @ kh[j0:j0 + 32]
                    dq = dq * scale
                    dbq[h * dim:(h + 1) * dim] += dq.sum(0)
                    dq_t[i, :, h] = dq
            o_r, dq_r = o_t.reshape(-1, hd), dq_t.reshape(-1, hd)
            dwo += o_r.t() @ gr
            dwq += xr.t() @ dq_r
            dbo += gr.sum(0)
            dx[toks.start:toks.stop] = (gr + dq_r @ wq.t()).reshape(-1, fl, c)
        partials.append((dwq, dbq, dwo, dbo))
    sums = [torch.zeros_like(t) for t in partials[0]]
    for part in partials:  # reduce_partials_kernel: CTA order
        sums = [a + p for a, p in zip(sums, part)]
    dwq, dbq, dwo, dbo = sums
    return (dx.reshape(b, s, fl, c), dk.reshape(b, s, fg, hd), dv.reshape(b, s, fg, hd), dwq, dbq, dwo, dbo)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("fl,fg,c,tile,grid", [(8, 32, 24, 2, 2), (4, 21, 40, 4, 3), (8, 40, 16, 2, 1),
                                               (20, 32, 24, 1, 2), (32, 32, 32, 1, 3)])
def test_staged_order_of_sums_matches_the_plain_oracle(fl, fg, c, tile, grid):
    heads, dim = 2, 16
    hd = heads * dim
    rng = np.random.default_rng(fl * 1000 + fg * 10 + c)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, g = r(1, 7, fl, c, scale=0.5), r(1, 7, fl, c, scale=0.1)
    k, v = r(1, 7, fg, hd), r(1, 7, fg, hd)
    wq, bq, wo = r(c, hd, scale=c ** -0.5), r(hd, scale=0.1), r(hd, c, scale=hd ** -0.5)
    got = _cross_bwd(x, g, k, v, wq, bq, wo, heads, dim, tile, grid)
    want = xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, heads, dim)
    for name, a, w in zip(("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo"), got, want):
        assert a.shape == w.shape, name
        assert _rel(a, w) <= 1e-5, (name, _rel(a, w))
