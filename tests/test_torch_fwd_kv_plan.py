"""The host-side planners of the staged dense forward and the staged k/v backward, on the CPU.

``temporal_attention.fwd_plan`` and ``spatial_linear_attention.kv_plan`` decide the route (the staged
kernel, whose width-scaling products run on the tensor cores in bf16, where its tile fits, else the
CUDA-core kernel), the rows per tile or tokens per chunk, the shared memory and the grid. They take the
number of SMs as an argument (132 on the H100), so every shape of the flagship, fixed and long-clip
recipes and the wide frame is checked here without a card: the tile fits the 227 KB a CTA may use, its
rows pad to whole 16-row blocks, the route is the one the C launchers choose (``tc_fwd_fits`` /
``sla_kv_fits``, mirrored by ``_tc_fwd_fits`` / ``_sla_kv_bytes``), and the planners raise exactly where
the CUDA-core kernels' own sizing raised before.
"""

import importlib.util
import math
from pathlib import Path

import pytest

from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as sla
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024
HEADS, DIM = 8, 32


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _smoke()
LONG_DENSE = (1, 128, 64, 256)  # the long clip's bottleneck spatial attention: 64 tokens attended
# Every dense temporal shape: the flagship's at the sampling batch (2) and the training batch (8), the fixed
# recipe's (the same shapes, biased), the long clip's bottleneck, and a ragged one.
FWD = sorted({sh for _, sh in _CS.TEMPORAL_SHAPES} | {(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.TEMPORAL_SHAPES}
             | {(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.BIASED_DENSE_SHAPES} | {LONG_DENSE, (3, 5, 7, 48)})
# Every spatial shape: the flagship's at the training batch, the long clip's (128 frames), the wide frame,
# and a ragged one.
KV = ([(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.SLA_SHAPES] + [(1, 128, *sh[2:]) for _, sh in _CS.SLA_SHAPES]
      + [_CS.WIDE_SLA_SHAPE, (1, 2, 7, 5, 24)])


def _old_fwd_tile_raises(f, c, dim):
    """The CUDA-core forward's own limit: one token's float32 panels over 227 KB."""
    return f * 4 * (2 * c + 3 * dim + 1 + f + 1) > SMEM_MAX


def _old_kv_chunk_raises(c, dim, heads):
    """The CUDA-core k/v kernel's own limit: a 4-token chunk over 227 KB."""
    return 4 * (dim * (dim + 1) + 2 * dim + heads * dim) + 4 * 4 * (2 * c + 4 * (dim + 1)) > SMEM_MAX


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", FWD, ids=str)
def test_fwd_plan_fits_and_pads(shape, bf16):
    b, s, f, c = shape
    tokens = b * s
    elt = 2 if bf16 else 4
    plan = ta.fwd_plan(tokens, f, c, DIM, HEADS, bf16, SMS)
    # every shape takes the tensor cores (float32 in 3xTF32); in float32 the f = 64, c = 256 column is too wide
    # for the staged tile (260 KB) and keeps the CUDA-core kernel
    staged = "staged" if bf16 else ta.STAGED_3XTF32
    assert plan["route"] == ("simt" if not bf16 and (f, c) == (64, 256) else staged)
    assert (plan["route"] != "simt") == ta._tc_fwd_fits(plan["bt"], f, c, DIM, elt)  # the C launcher's rule
    assert 1 <= plan["bt"] <= 64 and plan["smem"] <= SMEM_MAX
    assert plan["grid"] == -(-tokens // plan["bt"]) and plan["rows"] == plan["bt"] * f
    if plan["route"] != "simt":
        assert plan["rows_padded"] % 16 == 0 and 0 <= plan["rows_padded"] - plan["rows"] < 16
        assert plan["smem"] == ta._tc_fwd_bytes(plan["bt"], f, c, DIM, elt)
        if bf16:  # whole 16-row blocks wherever the tile holds a multiple of 16 // gcd(f, 16) tokens
            if plan["bt"] >= 16 // math.gcd(f, 16):
                assert plan["rows"] == plan["rows_padded"]
        else:  # one CTA an SM: as many tokens as fit it, spread over the SMs
            fit = max(n for n in range(1, 65) if n == 1 or ta._tc_fwd_bytes(n, f, c, DIM, elt) <= SMEM_MAX - 1024)
            assert plan["bt"] == max(1, min(fit, -(-tokens // SMS)))
    else:
        assert plan["smem"] == 4 * plan["bt"] * f * (2 * c + 3 * DIM + 1 + f + 1)


def test_fwd_plan_flagship_tiles():
    """The top level at the sampling and training batches: 16 tokens (160 rows, no padding) and two CTAs
    per SM in bf16; the bottleneck f = 64, c = 256 takes one token per tile at 185 KB."""
    for b in (2, 8):
        plan = ta.fwd_plan(b * 4096, 10, 32, DIM, HEADS, True, SMS)
        assert plan["rows"] == plan["rows_padded"] == 160 and 2 * (plan["smem"] + 1024) <= 228 * 1024
    plan = ta.fwd_plan(128, 64, 256, DIM, HEADS, True, SMS)
    assert plan["bt"] == 1 and plan["rows_padded"] == 64 and plan["smem"] == 184832


@pytest.mark.parametrize("f", range(1, 65))
def test_key_window_covers_every_block(f):
    """The bf16 forward's key window: the whole tokens that any 16-row block of query rows touches."""
    widest = max(((m0 + 15) // f - m0 // f + 1) * f for m0 in range(0, 16 * f, 16))
    assert ta._key_window(f) == ta._round16(widest)


@pytest.mark.parametrize("f,c,dim", [(64, 308, 32), (64, 309, 32), (10, 2786, 32), (10, 2787, 32),
                                     (64, 256, 64), (7, 48, 6), (16, 4096, 128), (64, 170, 32)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_fwd_plan_raises_where_the_old_tile_raised(f, c, dim, bf16):
    if _old_fwd_tile_raises(f, c, dim):
        with pytest.raises(NotImplementedError, match="exceed shared memory"):
            ta.fwd_plan(16, f, c, dim, 2, bf16, SMS)
        return
    plan = ta.fwd_plan(16, f, c, dim, 2, bf16, SMS)
    assert plan["smem"] <= SMEM_MAX
    assert (plan["route"] != "simt") == ta._tc_fwd_fits(1, f, c, dim, 2 if bf16 else 4)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", KV, ids=str)
def test_kv_plan_fits_and_pads(shape, bf16):
    b, f, hh, ww, c = shape
    frames, n = b * f, hh * ww
    elt = 2 if bf16 else 4
    plan = sla.kv_plan(frames, n, c, DIM, HEADS, bf16, SMS)
    assert plan["route"] == "staged" and plan["smem"] <= SMEM_MAX
    assert plan["chunk"] % 16 == 0 and 16 <= plan["chunk"] <= 128  # chunk rows pad to whole 16-row blocks
    assert plan["smem"] == sla._sla_kv_bytes(plan["chunk"], c, DIM, HEADS, elt)
    assert 1 <= plan["splits"] <= -(-n // plan["chunk"])
    assert frames * plan["splits"] * 4 * 2 * c * HEADS * DIM <= sla._WORKSPACE_MAX
    per_sm = 2 if 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
    assert per_sm == 2 or plan["chunk"] == 16  # only a 16-token chunk may take a whole SM


def test_kv_plan_shares_the_q_plans_grid():
    """At the flagship top level the k/v kernel takes 128-token chunks in bf16 and the q-path kernel's
    CTAs per frame, so both backward kernels of a spatial attention run on the same grid."""
    plan = sla.kv_plan(80, 4096, 32, DIM, HEADS, True, SMS)
    assert plan["chunk"] == 128 and plan["splits"] == sla.q_plan(80, 4096, 32, DIM, HEADS, True, SMS)["splits"]


@pytest.mark.parametrize("c,dim", [(32, 32), (400, 32), (512, 64), (1024, 32), (4096, 64), (6700, 64)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_kv_plan_raises_where_the_old_chunk_raised(c, dim, bf16):
    if _old_kv_chunk_raises(c, dim, 8):
        with pytest.raises(NotImplementedError, match="exceeds shared memory"):
            sla.kv_plan(20, 4096, c, dim, 8, bf16, SMS)
        return
    plan = sla.kv_plan(20, 4096, c, dim, 8, bf16, SMS)
    assert plan["smem"] <= SMEM_MAX
    staged = sla._sla_kv_bytes(16, c, dim, 8, 2 if bf16 else 4) <= SMEM_MAX
    assert (plan["route"] == "staged") == staged
    assert staged or plan["chunk"] % 16 or sla._sla_kv_bytes(plan["chunk"], c, dim, 8, 2 if bf16 else 4) > SMEM_MAX
