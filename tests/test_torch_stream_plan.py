"""The streaming temporal kernels' planner and block order, on the CPU.

The redesigned blockwise pair (and its mode DENSE, the wide columns of f <= 64) stage x, g and each
head's weights in c-chunks and keep one token's q|k|v panels in shared memory; ``stream_plan`` (C:
``sw_plan``) picks the widest chunk that fits 227 KB, then a float32 accumulator in shared memory before
device memory, then two ring slots before one. It takes no card, so every shape ``chip_smoke.py`` hands
these kernels is checked here in both types and directions: the plan fits, it is the first that fits in
that order, the grid and the device scratch follow the rules the C entry checks, and the first design
runs only where no streaming plan fits. Then ``_stream_bwd`` repeats the backward kernel's block order in
float32 (sweep 1 over KV blocks of 32, or all keys in mode DENSE; phase B over query rows and KV blocks of
32, with mode DENSE's first sweep for di; phase A over key rows and 16-query blocks; the weight gradients
and dx after the head) and is held against the plain backward oracles at 1e-5 of each output's largest
value, biased too.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

SMS = 132  # H100 SXM
HEADS, DIM = 8, 32


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _smoke()
LONG = sorted({sh for _, sh in _CS.LONG_TEMPORAL_SHAPES})
WIDE = [sh for _, sh in _CS.WIDE_SHAPES]


def _first_fit(f, c, dim, elt, backward, dense):
    """The order ``sw_plan`` searches: chunk (c, then 256, 128, 64, 32 below it), accumulator place, slots."""
    cp = ta._round16(c)
    for i, ck in enumerate((cp, 256, 128, 64, 32)):
        if i and ck >= cp:
            continue
        for acc in (True, False):
            for ns in (2, 1):
                lay = ta._stream_layout(f, c, dim, elt, backward, dense, ck, ns, acc)
                if lay["smem"] <= ta._SMEM_MAX:
                    return lay
    return None


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", LONG + WIDE, ids=str)
def test_every_long_clip_and_wide_shape_takes_the_streaming_kernel(shape, bf16, backward):
    b, s, f, c = shape
    tokens, elt = b * s, 2 if bf16 else 4
    plan = ta.temporal_plan(tokens, f, c, DIM, HEADS, bf16, SMS, backward)
    f32_fwd_stream = not (bf16 or backward) and ta._f32_fwd_takes_stream(f, c, DIM)  # float32: the measured rule
    if f <= 64 and not (ta.wide_needed(f, c, DIM, backward) or f32_fwd_stream):  # the dense forward holds c = 320
        assert plan["family"] == "dense" and not backward and c < 374
        return
    if f <= 64 and backward and not bf16:  # the float32 wide backward takes the tensor-core design
        assert plan == {"family": "wide", **ta.tf32x3_plan(tokens, f, c, DIM, HEADS, SMS)}
        return
    f32_bwd = backward and not bf16
    if f32_bwd and c > 32:  # the measured rule: the float32 streaming backward up to c = 32, tf32x3 above
        assert plan == {"family": "blockwise", **ta.tf32x3_plan(tokens, f, c, DIM, HEADS, SMS)}
        return
    assert plan["family"] == ("blockwise" if f > 64 else "wide")
    assert plan["route"] == ("staged" if bf16 else ta.STAGED_3XTF32)  # float32 in 3xTF32, both directions
    assert plan == {**plan, **_first_fit(f, c, DIM, elt, backward, f <= 64)}
    assert plan["smem"] <= ta._SMEM_MAX and plan["smem"] % 16 == 0
    assert plan["ck"] % 16 == 0 and plan["chunks"] == -(-ta._round16(c) // plan["ck"])
    assert plan["rows_padded"] % 16 == 0 and plan["kv_rows"] % plan["kv_block"] == 0
    assert plan["kv_block"] == (64 if f <= 64 else 32)
    per_sm = 2 if bf16 and f > 64 and not backward and 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
    assert plan["grid"] <= min(tokens, per_sm * SMS)
    if backward:
        total = c * 3 * HEADS * DIM + 3 * HEADS * DIM + HEADS * DIM * c + c
        assert plan["grid"] * 4 * total <= (ta._F32_WORKSPACE_MAX if f32_bwd else ta._WORKSPACE_MAX)
    fp, cp = ta._round16(f), ta._round16(c)
    assert plan["scratch"] == (0 if plan["acc_smem"] else 4 * plan["grid"] * fp * (cp + 4))


def test_the_long_clip_top_level_fills_the_card():
    """(1, 4096, 128, 32): two forward CTAs on every SM in bf16, one resident backward CTA per SM."""
    fwd = ta.temporal_plan(4096, 128, 32, DIM, HEADS, True, SMS, False)
    bwd = ta.temporal_plan(4096, 128, 32, DIM, HEADS, True, SMS, True)
    assert fwd["grid"] == 2 * SMS and bwd["grid"] == SMS
    assert fwd["chunks"] == bwd["chunks"] == 1 and fwd["acc_smem"] and bwd["acc_smem"]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("f", [65, 72, 96, 128, 192, 256, 300, 321])
def test_first_design_only_where_no_streaming_plan_fits(f, bf16):
    """Every c of the long clip at every f the card tests use: the first design runs exactly where the streaming
    plan does not fit (float32: the forward beyond f = 288; bf16: the backward beyond f = 192 at c >= 128), and
    never at f <= 128; the float32 backward beyond f = 160, and by the measured rule at c over 32, takes the
    tensor-core design of csrc/temporal_tf32x3.cu instead."""
    elt = 2 if bf16 else 4
    for c in (32, 64, 128, 256):
        for backward in (False, True):
            plan = ta.temporal_plan(3, f, c, DIM, HEADS, bf16, SMS, backward)
            fits = ta.stream_plan(f, c, DIM, elt, backward, False) is not None
            f32_bwd = backward and not bf16
            other = "tf32x3" if f32_bwd else "simt"
            tf = f32_bwd and (not fits or c > 32)
            assert plan["route"] == ("tf32x3" if tf else ("staged" if bf16 else ta.STAGED_3XTF32) if fits else other)
            assert fits or f > 128
            if not fits and other == "simt":
                assert plan["scratch"] == plan["grid"] * f * (4 if backward else 1) * HEADS * DIM * elt
            if tf:
                assert plan["family"] == "blockwise"
                assert {k: v for k, v in plan.items() if k != "family"} == ta.tf32x3_plan(3, f, c, DIM, HEADS, SMS)


def test_blockwise_head_dims_over_32_take_the_first_design():
    assert ta.stream_plan(128, 64, 64, 2, True, False) is None
    assert ta.temporal_plan(64, 128, 64, 64, 4, True, SMS, True)["route"] == "simt"


# ---- the backward kernel's block order, in float32 ----

def _stream_bwd(x, g, wqkv, bqkv, wo, heads, dim, pos_bias, dense):
    """The streaming backward's arithmetic in float32, in the kernel's block order (rounding is the identity)."""
    b, s, f, c = x.shape
    hd, scale = heads * dim, 1.0 / math.sqrt(dim)
    xs = x.reshape(b * s, f, c)
    gs = g.reshape(b * s, f, c)
    proj = (xs @ wqkv + bqkv).reshape(b * s, f, 3, heads, dim).permute(2, 0, 3, 1, 4)  # (3, tok, H, f, D)
    q, k, v = proj[0] * scale, proj[1], proj[2]
    bias = torch.zeros(heads, f, f) if pos_bias is None else pos_bias
    do = torch.einsum("tfc,hdc->thfd", gs, wo.reshape(heads, dim, c))
    # Sweep 1: m, l and o (online over blocks of 32 keys, or all keys at once in mode DENSE).
    kb = f if dense else 32
    m = torch.full((b * s, heads, f, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j0 in range(0, f, kb):
        sim = q @ k[..., j0:j0 + kb, :].transpose(-1, -2) + bias[:, :, j0:j0 + kb]
        mn = torch.maximum(m, sim.amax(-1, keepdim=True))
        p = torch.exp(sim - mn)
        alpha = torch.exp(m - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ v[..., j0:j0 + kb, :]
        m = mn
    o = acc / l
    lse = m + torch.log(l)

    def probs(j0, j1):
        sim = q @ k[..., j0:j1, :].transpose(-1, -2) + bias[:, :, j0:j1]
        return torch.exp(sim - m) / l if dense else torch.exp(sim - lse)

    if dense:  # di from a first sweep over blocks of 32 keys
        di = sum(((do @ v[..., j0:j0 + 32, :].transpose(-1, -2)) * probs(j0, j0 + 32)).sum(-1, keepdim=True)
                 for j0 in range(0, f, 32))
    else:
        di = (do * o).sum(-1, keepdim=True)
    # Phase B: query rows, KV blocks of 32.
    dq = torch.zeros_like(q)
    dbias = torch.zeros(heads, f, f)
    for j0 in range(0, f, 32):
        j1 = min(f, j0 + 32)
        p = probs(j0, j1)
        ds = p * (do @ v[..., j0:j1, :].transpose(-1, -2) - di)
        dbias[:, :, j0:j1] += ds.sum(0)
        dq = dq + ds @ k[..., j0:j1, :]
    dq = dq * scale
    # Phase A: key rows, 16-query blocks.
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i0 in range(0, f, 16):
        i1 = min(f, i0 + 16)
        sim_t = k @ q[..., i0:i1, :].transpose(-1, -2) + bias[:, i0:i1, :].transpose(-1, -2)
        pt = (torch.exp(sim_t - m[..., i0:i1, 0][..., None, :]) / l[..., i0:i1, 0][..., None, :] if dense
              else torch.exp(sim_t - lse[..., i0:i1, 0][..., None, :]))
        dst = pt * (v @ do[..., i0:i1, :].transpose(-1, -2) - di[..., i0:i1, 0][..., None, :])
        dv = dv + pt @ do[..., i0:i1, :]
        dk = dk + dst @ q[..., i0:i1, :]
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b * s, f, 3 * hd)
    ohs = o.permute(0, 2, 1, 3).reshape(b * s, f, hd)
    grads = (gs + dqkv @ wqkv.t(), torch.einsum("tfc,tfk->ck", xs, dqkv), dqkv.sum((0, 1)),
             torch.einsum("tfk,tfc->kc", ohs, gs), gs.sum((0, 1)))
    grads = (grads[0].reshape(b, s, f, c), *grads[1:])
    return grads if pos_bias is None else (*grads, dbias)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("f,c,dense", [(65, 48, False), (72, 32, False), (100, 64, False), (128, 32, False),
                                       (64, 320, True), (40, 96, True), (17, 24, True)])
def test_stream_block_order_matches_the_plain_oracles(f, c, dense, bias):
    heads, dim = 2, 16
    hd = heads * dim
    rng = np.random.default_rng(f * 1000 + c)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, g = r(1, 3, f, c, scale=0.5), r(1, 3, f, c, scale=0.1)
    w = (r(c, 3 * hd, scale=c ** -0.5), r(3 * hd, scale=0.1), r(hd, c, scale=hd ** -0.5), r(c, scale=0.1))
    pos_bias = r(heads, f, f, scale=0.5) if bias else None
    got = _stream_bwd(x, g, w[0], w[1], w[2], heads, dim, pos_bias, dense)
    if dense:
        want = ta.temporal_attention_bwd_plain(x, g, *w, heads, dim, pos_bias=pos_bias)
    else:
        want = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias)
    assert len(got) == len(want)
    for name, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"), got, want):
        assert _rel(a, v) <= 1e-5, (name, _rel(a, v))
