"""The float32 staged dense and streaming temporal forwards in split-precision TF32 ("3xTF32"), on the CPU.

In float32 the staged dense forward (csrc/temporal_attention.cu, ``temporal_fwd_panel_kernel<float, BIAS>``) runs its
width-scaling products (q|k|v, y += o_h W_o,h) and its per-token products over key windows (P V once per token of a
16-row block, over that token's keys alone), and the streaming forward
(csrc/temporal_blockwise.cu, ``temporal_stream_fwd_kernel<float, DENSE, DP>``)
those products and its attention fragments (S, P V), on the tensor cores: each operand split into a TF32 high and low
part, three TF32 products per 8-deep step summed apart and added to the float32 total (route "staged-3xtf32"). Here,
without a card:

- the planner sends the float32 forwards of D1 (temporal and spatial), the fixed flagship's f = 10 levels, the fixed
  long clip's f = 128 levels and D2's spatial attention (mode DENSE) to that route, each tile within 227 KB, one
  CTA an SM, and by a measured rule the fixed bottleneck (f = 64, c = 256, whose staged tile holds no token) to the
  streaming kernel in mode DENSE, while D2's temporal attention keeps the CUDA-core kernel; bf16 keeps its forward
  plans, value for value;
- ``_staged3_fwd`` and ``_stream3_fwd`` repeat each kernel's order of operations with the split products (the dense
  kernel: tiles of tokens, heads in turn, the per-token products over 16-row blocks' key windows; the streaming kernel: one token at a time, KV blocks of 32 with the online softmax in mode
  BLOCKWISE, one block of all keys normalised before P V in mode DENSE) and are held against the plain forwards
  and against the JAX Pallas forwards in interpret mode, at the float32 forward gate (1e-4 max-abs); at every target
  shape, on the card tests' own operands, the split stays within a tenth of that gate, where one TF32 product
  (a 1xTF32 control) misses the gate itself;
- neither forward kernel reaches the CUDA-core products (``simt_mma``, ``warp_nt`` / ``warp_pv``) in float32, and
  the 3xTF32 primitives keep one copy, in common.cuh;
- a NaN input stays a NaN through the emulated split, in the token it lies in and nowhere else.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sys

from torch_port_helpers import mm3, seeded, tf32
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024
GATE = 1e-4  # the float32 forward gate: max-abs error against the plain version
SPLIT_GATE = 1e-5  # the card tests' gate for the 3xTF32 forwards (tests/test_torch_cuda.py FWD3_TOL)
CSRC = Path(ta.__file__).resolve().parent.parent / "csrc"
HEADS, DIM = 8, 32

# (tokens, f, c, heads, head dim) of the float32 forwards this route was made for: D1's attentions at batch 8
# (temporal: 256 patches x 16 frames; spatial: 16 frames x 256 patches), D2's spatial attention at batch 4 (mode
# DENSE), the fixed flagship's four f = 10 levels at the training and the sampling batch, the fixed long clip's four
# f = 128 levels.
D1_TEMPORAL, D1_SPATIAL, D2_SPATIAL = (2048, 16, 256, 8, 32), (128, 256, 256, 8, 32), (40, 64, 384, 6, 64)
FIXED = [(t * b, 10, c, 8, 32) for b in (8, 2) for t, c in ((4096, 32), (1024, 64), (256, 128), (64, 256))]
LONG = [(t, 128, c, 8, 32) for t, c in ((4096, 32), (1024, 64), (256, 128), (64, 256))]
TARGETS = [D1_TEMPORAL, D1_SPATIAL, D2_SPATIAL, *FIXED, *LONG]
# The parent's bf16 forward plans at the same shapes and at the two float32 forwards still on the CUDA-core kernel
# (D2's temporal attention, the fixed bottleneck at batch 8): (route, bt or c-chunk, ring slots, shared memory, grid).
BF16_PLANS = {
    D1_TEMPORAL: ("staged", 6, None, 227456, 342), D1_SPATIAL: ("staged", 64, 1, 230912, 128),
    D2_SPATIAL: ("staged", 128, 1, 171008, 40), FIXED[0]: ("staged", 16, None, 99968, 2048),
    FIXED[1]: ("staged", 8, None, 74688, 1024), FIXED[2]: ("staged", 8, None, 115648, 256),
    FIXED[3]: ("staged", 2, None, 105600, 256), FIXED[4]: ("staged", 16, None, 99968, 512),
    FIXED[5]: ("staged", 8, None, 74688, 256), FIXED[6]: ("staged", 2, None, 60544, 256),
    FIXED[7]: ("staged", 1, None, 74944, 128), LONG[0]: ("staged", 32, 2, 94208, 264),
    LONG[1]: ("staged", 64, 2, 144384, 132), LONG[2]: ("staged", 128, 1, 174592, 132),
    LONG[3]: ("staged", 256, 1, 174592, 64), (256, 10, 384, 6, 64): ("staged", 1, None, 163008, 256),
    (80, 64, 256, 8, 32): ("staged", 1, None, 184832, 80),
}


# ---- the planner ----

@pytest.mark.parametrize("shape", TARGETS, ids=str)
def test_targets_take_the_3xtf32_forward(shape):
    """Every target's float32 forward takes the staged dense or the streaming kernel in 3xTF32, within 227 KB; the
    staged tile holds as many tokens as one CTA's shared memory does, spread over one CTA an SM, and the streaming
    grid one CTA an SM (or a token)."""
    tokens, f, c, heads, dim = shape
    plan = ta.temporal_plan(tokens, f, c, dim, heads, False, SMS, False)
    family = "blockwise" if f > ta.MAX_FRAMES else ("wide" if ta.wide_needed(f, c, dim, False) else "dense")
    assert plan["family"] == family and plan["route"] == ta.STAGED_3XTF32 and plan["smem"] <= SMEM_MAX
    if family == "dense":
        bt = plan["bt"]
        fit = max(n for n in range(1, 65) if ta._tc_fwd_bytes(n, f, c, dim, 4) <= SMEM_MAX - 1024)
        assert bt == min(fit, -(-tokens // SMS)) and plan["smem"] == ta._tc_fwd_bytes(bt, f, c, dim, 4)
        assert plan["grid"] == -(-tokens // bt)
    else:
        assert plan == {**plan, **ta.stream_plan(f, c, dim, 4, False, family == "wide")}
        assert plan["grid"] == min(SMS, tokens)  # one CTA an SM: two never fit beside the float32 panels here
        assert 2 * (plan["smem"] + 1024) > 228 * 1024 or tokens <= SMS


@pytest.mark.parametrize("shape", list(BF16_PLANS), ids=str)
def test_bf16_keeps_its_forward_plans(shape):
    tokens, f, c, heads, dim = shape
    plan = ta.temporal_plan(tokens, f, c, dim, heads, True, SMS, False)
    got = (plan["route"], plan.get("bt", plan.get("ck")), plan.get("slots"), plan["smem"], plan["grid"])
    assert got == BF16_PLANS[shape]


def test_the_float32_streaming_forward_reaches_further():
    """Without a warp's scratch for P the float32 streaming forward's plan reaches f = 288 at head dim 32 (256 with
    it), at every width; mode BLOCKWISE still takes no head dim over 32 (its kernels are instantiated at 32)."""
    for c in (32, 128, 256, 512):
        assert ta.stream_plan(288, c, DIM, 4, False, False) is not None
        assert ta.stream_plan(289, c, DIM, 4, False, False) is None
    assert ta.stream_plan(128, 64, 64, 4, False, False) is None
    scratch = 8 * 16 * (32 + 4) * 4  # what the layout held for it
    assert ta._stream_layout(288, 256, DIM, 4, False, False, 32, 1, False)["smem"] + scratch > SMEM_MAX


def test_every_tile_holds_the_key_windows():
    """The staged forward's tile holds the key windows and 16 zero rows past the q|k|v panel in both types: in float32
    (a float per element) x, y, q|k|v, the logits, the weight ring, the windows and the zero rows."""
    src = (CSRC / "temporal_attention.cu").read_text()
    assert "  p.LW = key_window(F);\n" in src and "(size_t)elt * (p.Rp + 16) * p.LDQ;" in src
    windows = 4 * (224 * ta._pad_ld(32) + 16 * ta._pad_ld(96))
    assert ta._tc_fwd_bytes(22, 10, 32, DIM, 4) == 4 * (224 * (40 + 40 + 104 + 11) + 2 * 32 * 40) + windows
    assert ta._tc_fwd_bytes(22, 10, 32, DIM, 2) == 2 * (224 * (40 + 104) + 2 * 32 * 40) + windows // 2 + 4 * 224 * (40 + 11)


# (tokens, f, c, heads, head dim) of the float32 forwards the staged tile cannot hold: the fixed bottleneck at the
# training and the sampling batch and the long clip's, D2's temporal attention, and the rule's ladder
# (scripts/torch_f32_fwd_routes.py, group "rule").
BOTTLENECKS = [(80, 64, 256, 8, 32), (20, 64, 256, 8, 32), (128, 64, 256, 8, 32)]
D2_TEMPORAL = (256, 10, 384, 6, 64)
LADDER = [(256, 16, 512, 8, 32), (256, 24, 384, 8, 32), (256, 32, 384, 8, 32), (256, 40, 256, 8, 32),
          (256, 48, 320, 8, 32), (256, 40, 192, 3, 64), (256, 64, 128, 2, 64)]


@pytest.mark.parametrize("shape", [*BOTTLENECKS, D2_TEMPORAL, *LADDER], ids=str)
def test_the_measured_rule_for_forwards_the_staged_tile_cannot_hold(shape):
    """``_f32_fwd_takes_stream``: the fixed bottleneck's float32 forward (f = 64) takes the streaming kernel in mode
    DENSE, family "wide", in 3xTF32; D2's temporal one (f = 10, head dim 64) and the rule's ladder below f = 64 keep
    the CUDA-core kernel; bf16 keeps the staged kernel at each. The C rule reads the same."""
    tokens, f, c, heads, dim = shape
    assert not ta._tc_fwd_fits(1, f, c, dim, 4) and ta._tc_fwd_fits(1, f, c, dim, 2)
    plan = ta.temporal_plan(tokens, f, c, dim, heads, False, SMS, False)
    if f == 64:
        assert plan == {"family": "wide", **ta.blockwise_plan(tokens, f, c, dim, heads, False, SMS, False, dense=True)}
        assert plan["route"] == ta.STAGED_3XTF32 and plan["grid"] == min(SMS, tokens)
    else:
        assert plan == {"family": "dense", **ta.fwd_plan(tokens, f, c, dim, heads, False, SMS)}
        assert plan["route"] == "simt"
    assert ta.temporal_plan(tokens, f, c, dim, heads, True, SMS, False)["route"] == "staged"
    assert not ta.wide_needed(f, c, dim, False)  # the CUDA-core tile would hold them
    src = (CSRC / "temporal_attention.cu").read_text()
    assert "  return F == 64 && D <= 64 && !tc_fwd_fits(1, F, C, D, 4);\n" in src
    assert "if (dtype == 0 && vdt::kF32RuleChecked && vdt::f32_fwd_takes_stream(f, c, dim))" in src


def test_the_rule_edges():
    assert ta._f32_fwd_takes_stream(64, 384, 32) and ta._f32_fwd_takes_stream(64, 128, 64)
    assert not any(ta._f32_fwd_takes_stream(f, 4096, 32) for f in range(1, 64))  # measured slower up to f = 48
    assert not ta._f32_fwd_takes_stream(64, 4096, 128)  # head dims over 64: no streaming plan
    assert not ta._f32_fwd_takes_stream(64, 160, 32)  # the staged tile holds one token
    assert ta._tc_fwd_fits(1, 64, 160, 32, 4)


# ---- the kernels' sources ----

def _body(src: str, start: str, end: str) -> str:
    i = src.index(start)
    return src[i:src.index(end, i)]


def test_forward_kernels_reach_no_cuda_core_products():
    """In float32 neither forward kernel calls ``simt_mma`` (through ``panel_mma``) for its projections or the
    CUDA-core warp fragments for its attention: the staged kernel's products go through ``tensor_mma`` /
    ``tensor_mma_add`` / ``tensor_block`` / ``tensor_keys``, the streaming kernel's through ``project_head`` and the
    3xTF32 fragments of ``sweep_rows``; no per-token branch on the CUDA cores is left."""
    src = (CSRC / "temporal_attention.cu").read_text()
    staged = _body(src, "temporal_fwd_panel_kernel(", "static int launch(")
    for name in ("panel_mma", "simt_mma", "warp_nt", "warp_pv", "dot_rows", "mma_block", "bdot", "fma4",
                 "sizeof(T) == 4)", "VDT_F32_FWD_WINDOWS"):
        assert name not in staged, name
    for name in ("tensor_mma<false, true>(xs", "tensor_mma_add<false, true>(qkv", "tensor_block<false>(qkv",
                 "tensor_block<true>(pw", "tensor_keys(pw", "!__syncthreads_or(vbad)"):
        assert name in staged, name
    blk = (CSRC / "temporal_blockwise.cu").read_text()
    stream = _body(blk, "temporal_stream_fwd_kernel(", "// Backward.")
    project = _body(blk, "__device__ void project_head(", "// Two CTAs per SM")
    for part in (stream, project):
        for name in ("panel_mma", "simt_mma", "warp_nt", "warp_pv"):
            assert name not in part, name
        assert not re.search(r"\bscr\b", part)  # no warp scratch for P
    assert "sweep_rows<T, DENSE, DP, true>(" in stream and "tensor_mma_add<false, true>(os" in stream
    assert "tensor_mma<false, true>(xs" in project
    assert "*staged = route == 1 && dtype == 0 ? 3 : route;" in blk
    assert "*staged_out = staged ? (sizeof(T) == 4 ? 3 : 1) : 0;" in src


def test_one_copy_of_the_3xtf32_primitives():
    """The split and the products live in common.cuh, each overload once; the two sources include it."""
    common = (CSRC / "common.cuh").read_text()
    for name, n in (("void split(float v", 1), ("void mma3(", 1), ("void nt3(", 1), ("void pv3(", 1),
                    ("void mma3_strip(", 1), ("void tf3_mma(", 1), ("void tf3_mma_add(", 1), ("void tensor_mma(", 2),
                    ("void tensor_mma_add(", 2), ("void tensor_block(", 2), ("void tensor_keys(", 2),
                    ("void mma_keys(", 1), ("void mma3_keys(", 1), ("void tensor_nt(", 2), ("void tensor_pv(", 2)):
        assert common.count(name) == n, name
    for src in ("temporal_attention.cu", "temporal_blockwise.cu"):
        text = (CSRC / src).read_text()
        assert '#include "common.cuh"' in text and "mma.sync.aligned.m16n8k8" not in text, src
        for name in ("void split(", "void nt3(", "void pv3(", "void tensor_mma("):
            assert name not in text, (src, name)


# ---- the kernels' order of operations, with the split products ----

def _mm3k(a, b):
    """The split product in the kernels' order: each 8-deep step of the sum (three TF32 products) summed apart and
    added to the float32 total, which starts at zero."""
    return _mm3_into(torch.zeros(*a.shape[:-1], b.shape[-1]), a, b)


def _mm3_into(acc, a, b):
    """acc += a b with each 8-deep step added to acc in turn (``pv3`` into a running accumulator)."""
    for k0 in range(0, a.shape[-1], 8):
        acc = acc + mm3(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
    return acc


def _head_cols(heads, dim, h):
    return [torch.arange(part * heads * dim + h * dim, part * heads * dim + (h + 1) * dim) for part in range(3)]


def _block_window(m0, rows, f):
    """``block_window``: the first key and the length of the whole tokens a 16-row block touches."""
    ks = (m0 // f) * f
    return ks, (min(m0 + 15, rows - 1) // f + 1) * f - ks


def _staged3_fwd(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias=None, bt=3, per_token=None):
    """temporal_fwd_panel_kernel<float, BIAS>: tiles of ``bt`` tokens, the heads in turn; q|k|v and y += o_h W_o,h
    split; the per-token products over each 16-row block's key window split (logits kept for the row's own token, P
    zero elsewhere in the window; P V in one pass over the window, or with ``per_token`` once per token of the block
    over that token's keys alone, the window's 8-deep steps that meet them, each row keeping its own token's pass).
    ``per_token`` None: as the kernel, per token where a V of the tile is not finite."""
    b, s, f, c = x.shape
    tok, scale = b * s, 1.0 / math.sqrt(dim)
    xs, out = x.reshape(tok, f, c), torch.empty(tok, f, c)
    bias = torch.zeros(heads, f, f) if pos_bias is None else pos_bias
    for t0 in range(0, tok, bt):
        nt = min(bt, tok - t0)
        rows = nt * f
        xt = xs[t0:t0 + nt].reshape(rows, c)
        y = torch.zeros(rows, c)
        for h in range(heads):
            q, k, v = (_mm3k(xt, wqkv[:, cl]) + bqkv[cl] for cl in _head_cols(heads, dim, h))
            q = q * scale
            o = torch.zeros(rows, dim)
            by_token = not bool(torch.isfinite(v).all()) if per_token is None else per_token
            for m0 in range(0, rows, 16):
                ks, n = _block_window(m0, rows, f)
                qb = q[m0:m0 + 16]
                sim = _mm3k(qb, k[ks:ks + n].t())
                r = torch.arange(m0, m0 + qb.shape[0])
                key = torch.arange(ks, ks + n)
                own = (key[None] // f) == (r[:, None] // f)
                logits = torch.where(own, sim + bias[h][r[:, None] % f, key[None] % f], -torch.inf)
                p = torch.softmax(logits, -1)
                if not by_token:
                    o[m0:m0 + 16] = _mm3k(p, v[ks:ks + n])
                    continue
                for tk in range(m0 // f, (r[-1].item()) // f + 1):
                    kb, ke = tk * f - ks, (tk + 1) * f - ks
                    k0, k1 = kb // 8 * 8, min(-(-ke // 8) * 8, n)
                    vt = torch.zeros(k1 - k0, dim)
                    vt[kb - k0:ke - k0] = v[ks + kb:ks + ke]  # the other tokens' keys read as zeros
                    mine = r // f == tk
                    o[r[mine]] = _mm3k(p[mine][:, k0:k1], vt)
            y = y + _mm3k(o, wo[h * dim:(h + 1) * dim])
        out[t0:t0 + nt] = (xt + (y + bo)).reshape(nt, f, c)
    return out.reshape(x.shape)


def _stream3_fwd(x, wqkv, bqkv, wo, bo, heads, dim, pos_bias=None, dense=False):
    """temporal_stream_fwd_kernel<float, DENSE, DP>: one token at a time, the heads in turn; every product split.
    BLOCKWISE: the online softmax over KV blocks of 32, P V added into the running accumulator step by step, o = acc
    / l. DENSE: one block of all keys, P normalised before P V."""
    b, s, f, c = x.shape
    tok, scale, kb = b * s, 1.0 / math.sqrt(dim), ta.KV_BLOCK
    xs, out = x.reshape(tok, f, c), torch.empty(tok, f, c)
    bias = torch.zeros(heads, f, f) if pos_bias is None else pos_bias
    for t in range(tok):
        xt, y = xs[t], torch.zeros(f, c)
        for h in range(heads):
            q, k, v = (_mm3k(xt, wqkv[:, cl]) + bqkv[cl] for cl in _head_cols(heads, dim, h))
            q = q * scale
            if dense:
                p = torch.softmax(_mm3k(q, k.t()) + bias[h], -1)
                o = _mm3k(p, v)
            else:
                m, l, acc = torch.full((f, 1), -1e30), torch.zeros(f, 1), torch.zeros(f, dim)
                for j0 in range(0, f, kb):
                    sim = _mm3k(q, k[j0:j0 + kb].t()) + bias[h][:, j0:j0 + kb]
                    mn = torch.maximum(m, sim.amax(-1, keepdim=True))
                    p, alpha = torch.exp(sim - mn), torch.exp(m - mn)
                    l, m = l * alpha + p.sum(-1, keepdim=True), mn
                    acc = _mm3_into(acc * alpha, p, v[j0:j0 + kb])
                o = acc / l
            y = y + _mm3k(o, wo[h * dim:(h + 1) * dim])
        out[t] = xt + (y + bo)
    return out.reshape(x.shape)


def _operands(f, c, heads, dim, seed, bias, tokens=4):
    hd = heads * dim
    x = torch.from_numpy(seeded((1, tokens, f, c), seed, 0.5))
    w = tuple(torch.from_numpy(seeded(shape, seed + 2 + i, sc)) for i, (shape, sc) in enumerate(
        (((c, 3 * hd), c ** -0.5), ((3 * hd,), 0.1), ((hd, c), hd ** -0.5), ((c,), 0.1))))
    pos_bias = torch.from_numpy(seeded((heads, f, f), seed + 7, 0.5)) if bias else None
    return x, w, pos_bias


def _err(a, b):
    return (a - b).abs().max().item()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("f,c", [(10, 40), (16, 24), (7, 36), (5, 20), (12, 24), (64, 16)])
def test_staged_order_matches_the_plain_forward(f, c, bias):
    """Three-token tiles: at f = 10, 7, 5 and 12 a 16-row block spans tokens (up to four at f = 5) and a tile ends
    inside a block; at f = 64 a token is four blocks."""
    x, w, pos_bias = _operands(f, c, 2, 16, f * 100 + c, bias, tokens=5)
    got = _staged3_fwd(x, *w, 2, 16, pos_bias)
    want = ta.temporal_attention_plain(x, *w, 2, 16, pos_bias=pos_bias)
    assert got.shape == want.shape and _err(got, want) <= GATE, _err(got, want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dense,f", [(False, 72), (True, 40)], ids=["blockwise", "dense"])
def test_stream_order_matches_the_plain_forward(dense, f, bias):
    """f = 72: three KV blocks, the last partial; mode DENSE at f = 40 against the dense plain version."""
    x, w, pos_bias = _operands(f, 32, 2, 16, f, bias, tokens=2)
    got = _stream3_fwd(x, *w, 2, 16, pos_bias, dense=dense)
    want = (ta.temporal_attention_plain(x, *w, 2, 16, pos_bias=pos_bias) if dense
            else ta.temporal_attention_blockwise_plain(x, *w, 2, 16, ta.KV_BLOCK, pos_bias=pos_bias))
    assert got.shape == want.shape and _err(got, want) <= GATE, _err(got, want)


@pytest.mark.parametrize("order,f,bias", [("windows", 10, True), ("windows", 7, False), ("windows", 16, False),
                                          ("windows", 16, True), ("stream", 72, True), ("stream_dense", 10, True)])
def test_orders_match_the_pallas_kernels(monkeypatch, order, f, bias):
    """The JAX op's forward (its dense Pallas kernel at f <= 64, the blockwise one at f = 72, in interpret mode)
    against each kernel's order; mode DENSE holds the dense kernel's rounding points, so it meets the dense one."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    heads, dim, c = 2, 8, 16
    x, w, pos_bias = _operands(f, c, heads, dim, 11, bias, tokens=3)
    jw = [jnp.asarray(t.numpy()) for t in w]
    jx = jnp.asarray(x.numpy())
    if bias:
        want = jta.fused_temporal_attention_block_biased(jx, *jw, jnp.asarray(pos_bias.numpy()), heads, dim)
    else:
        want = jta.fused_temporal_attention_block(jx, *jw, heads, dim)
    if order == "windows":
        got = _staged3_fwd(x, *w, heads, dim, pos_bias, bt=2)
    else:
        got = _stream3_fwd(x, *w, heads, dim, pos_bias, dense=order == "stream_dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GATE)


def test_one_window_pass_would_carry_a_nan_across_tokens():
    """Why P V runs per token at f = 10 where a V is not finite: one pass over a 16-row block's key window multiplies
    the other tokens' V rows by zero, and 0 x NaN is a NaN, so a NaN in one token would reach the rows of its
    neighbours in the block; the kernel's passes over each token's keys alone keep it in its token, as the plain
    version does. For finite inputs the two orders are the same sums (the skipped 8-deep steps add exact zeros), so
    finite tiles take the one pass."""
    x, w, pos_bias = _operands(10, 24, 2, 16, 5, True, tokens=3)
    one = _staged3_fwd(x, *w, 2, 16, pos_bias, per_token=False)
    assert torch.equal(_staged3_fwd(x, *w, 2, 16, pos_bias, per_token=True), one)
    assert torch.equal(_staged3_fwd(x, *w, 2, 16, pos_bias), one)
    x[0, 1, 5, 7] = float("nan")
    want = ta.temporal_attention_plain(x, *w, 2, 16, pos_bias=pos_bias)
    # token 0's ten rows share the first 16-row block with token 1's first six
    assert not torch.isnan(want[0, 0]).any()
    assert torch.isnan(_staged3_fwd(x, *w, 2, 16, pos_bias, per_token=False)[0, 0]).all()
    assert torch.equal(torch.isnan(_staged3_fwd(x, *w, 2, 16, pos_bias)), torch.isnan(want))


@pytest.mark.parametrize("order,f", [("windows", 7), ("windows", 10), ("windows", 16), ("stream", 72),
                                     ("stream_dense", 10)])
def test_emulated_forwards_keep_nan(order, f):
    """The GPU's NaN (0x7fffffff, whose split's high part the integer rounding carries into -0) in one element of x:
    the split's low part keeps it, so the token it lies in comes out NaN, as in the plain version, and no other."""
    x, w, pos_bias = _operands(f, 24, 2, 16, 5, True, tokens=3)
    x[0, 1, f // 2, 7] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    if order == "windows":
        got = _staged3_fwd(x, *w, 2, 16, pos_bias, bt=3)
    else:
        got = _stream3_fwd(x, *w, 2, 16, pos_bias, dense=order == "stream_dense")
    want = (ta.temporal_attention_blockwise_plain(x, *w, 2, 16, ta.KV_BLOCK, pos_bias=pos_bias) if order == "stream"
            else ta.temporal_attention_plain(x, *w, 2, 16, pos_bias=pos_bias))
    assert torch.isnan(want[0, 1]).all() and not torch.isnan(want[0, 0]).any() and not torch.isnan(want[0, 2]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert _err(got[keep], want[keep]) <= GATE


# ---- the gate tells 3xTF32 from one TF32 product ----

# (op shape (b, s, f, c), heads, head dim, biased) of the card tests at the target shapes (tests/test_torch_cuda.py
# FWD3_SHAPES): D1's temporal and spatial attention, D2's spatial one, the fixed flagship's f = 10 levels, the long
# clip's f = 128 levels, the fixed bottleneck.
CARD_TARGETS = {
    "d1_temporal": ((8, 256, 16, 256), 8, 32, False), "d1_spatial": ((8, 16, 256, 256), 8, 32, False),
    "d2_spatial": ((4, 10, 64, 384), 6, 64, False), "fixed_c32": ((8, 4096, 10, 32), 8, 32, True),
    "fixed_c64": ((8, 1024, 10, 64), 8, 32, True), "fixed_c128": ((8, 256, 10, 128), 8, 32, True),
    "fixed_c256": ((8, 64, 10, 256), 8, 32, True), "long_c32": ((1, 4096, 128, 32), 8, 32, True),
    "long_c64": ((1, 1024, 128, 64), 8, 32, True), "long_c128": ((1, 256, 128, 128), 8, 32, True),
    "long_c256": ((1, 64, 128, 256), 8, 32, True), "fixed_bottleneck": ((8, 10, 64, 256), 8, 32, False),
}


def _card_rand(shape, seed, scale, count=None):
    """The card tests' ``_rand`` (numpy's normal draws cast to float32, then scaled), its first ``count`` values."""
    n = int(np.prod(shape)) if count is None else count
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale)


def _mm1(a, b):
    """One TF32 product: both operands rounded to TF32, summed in float32 (the 1xTF32 control)."""
    return tf32(a) @ tf32(b)


@pytest.mark.parametrize("name", list(CARD_TARGETS))
def test_one_tf32_product_would_miss_the_gate(monkeypatch, name):
    """The first three tokens of each card test's operands (its draws are made in order, so they are the card's
    own): through the kernel's order with the split products within a tenth of the float32 gate, and with every
    product a single TF32 one over that gate, so that the card tests would catch a kernel that lost the split."""
    (b, s, f, c), heads, dim, bias = CARD_TARGETS[name]
    hd, tokens = heads * dim, 3
    x = _card_rand(None, 0, 0.5, tokens * f * c).reshape(1, tokens, f, c)
    w = (_card_rand((c, 3 * hd), 1, c ** -0.5).reshape(c, 3 * hd), _card_rand((3 * hd,), 2, 0.1),
         _card_rand((hd, c), 3, hd ** -0.5).reshape(hd, c), _card_rand((c,), 4, 0.1))
    pos_bias = _card_rand((heads, f, f), 6, 0.5).reshape(heads, f, f) if bias else None
    plan = ta.temporal_plan(b * s, f, c, dim, heads, False, SMS, False)
    if plan["family"] == "dense":
        run = lambda: _staged3_fwd(x, *w, heads, dim, pos_bias)  # noqa: E731
        want = ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias)
    elif plan["family"] == "wide":
        run = lambda: _stream3_fwd(x, *w, heads, dim, pos_bias, dense=True)  # noqa: E731
        want = ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=pos_bias)
    else:
        run = lambda: _stream3_fwd(x, *w, heads, dim, pos_bias)  # noqa: E731
        want = ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK, pos_bias=pos_bias)
    split3 = _err(run(), want)
    monkeypatch.setattr(sys.modules[__name__], "mm3", _mm1)
    one = _err(run(), want)
    assert split3 <= SPLIT_GATE < GATE < one, (split3, one)
