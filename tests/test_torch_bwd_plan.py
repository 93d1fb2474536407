"""The host-side planners of the two staged backward kernels, on the CPU.

``temporal_attention.bwd_plan`` and ``spatial_linear_attention.q_plan`` decide the route (the
staged kernel, whose products run on the tensor cores in bf16, where its tile fits, else the
CUDA-core kernel), the rows per tile, the shared memory and the grid. They take the number of SMs
as an argument (132 on the H100), so every shape that ``chip_smoke.py`` hands the two kernels is
checked here without a card: the tile fits the 227 KB a CTA may use, the staged tile is padded to
whole 16-row blocks and to widths that are multiples of the mma depth (16), the grid's partials
stay within the workspaces, and the planners raise exactly where the CUDA-core kernels' own sizing
raised before.
"""

import importlib.util
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
TEMPORAL = sorted({(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.TEMPORAL_SHAPES}
                  | {(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.BIASED_DENSE_SHAPES}
                  | {LONG_DENSE, (3, 5, 7, 48)})
SLA = [(_CS.B_TRAIN, *sh[1:]) for _, sh in _CS.SLA_SHAPES] + [_CS.WIDE_SLA_SHAPE, (1, 2, 7, 5, 24)]


def _old_tile_raises(f, c, dim):
    """The CUDA-core backward's own limit: one token's float32 panels over 227 KB."""
    return f * 4 * (2 * c + 2 * (3 * dim + 1) + f + 1 + dim + 1) > SMEM_MAX


def _old_chunk_raises(c, dim):
    """The CUDA-core q-path kernel's own limit: a 4-token chunk over 227 KB."""
    return 4 * dim * (dim + 1) + 4 * 4 * (3 * c + 4 * (dim + 1)) > SMEM_MAX


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", TEMPORAL, ids=str)
def test_temporal_plan_fits_and_pads(shape, bf16):
    b, s, f, c = shape
    tokens = b * s
    elt = 2 if bf16 else 4
    plan = ta.bwd_plan(tokens, f, c, DIM, HEADS, bf16, SMS)
    # every flagship and long-clip shape takes the tensor cores in bf16; in float32 the staged kernel (its products
    # in 3xTF32) up to c = 64, the measured rule, and wider columns (the f = 64, c = 256 one too wide for the staged
    # tile) the float32 tensor-core design of csrc/temporal_tf32x3.cu
    assert plan["route"] == ("staged" if bf16 else "tf32x3" if c > 64 else ta.STAGED_3XTF32)
    assert plan["smem"] <= SMEM_MAX
    if plan["route"] == "tf32x3":  # one (token, head) per CTA of the attention core; no tile of tokens
        assert plan == ta.tf32x3_plan(tokens, f, c, DIM, HEADS, SMS) and plan["grid"] == tokens
        return
    assert 1 <= plan["bt"] <= 64
    if plan["route"] in ("staged", ta.STAGED_3XTF32):
        assert plan["rows_padded"] % 16 == 0 and plan["rows_padded"] >= plan["rows"] == plan["bt"] * f
        assert plan["smem"] == ta._tc_bwd_bytes(plan["bt"], f, c, DIM, elt)
    total = c * 3 * HEADS * DIM + 3 * HEADS * DIM + HEADS * DIM * c + c
    cap = ta._F32_WORKSPACE_MAX if plan["route"] == ta.STAGED_3XTF32 else ta._WORKSPACE_MAX
    assert plan["grid"] * 4 * total <= cap
    assert plan["grid"] * 4 * HEADS * f * f <= ta._DBIAS_WORKSPACE_MAX
    assert plan["grid"] <= -(-tokens // plan["bt"]) and plan["grid"] <= 2 * SMS
    per_sm = 2 if 2 * (plan["smem"] + 1024) <= 228 * 1024 and (bf16 or plan["route"] == "simt") else 1
    assert plan["grid"] <= per_sm * SMS


@pytest.mark.parametrize("f,c,dim", [(64, 308, 32), (64, 309, 32), (10, 2786, 32), (10, 2787, 32),
                                     (1, 1024, 64), (64, 256, 64), (7, 48, 6), (16, 4096, 128)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_temporal_plan_raises_where_the_old_tile_raised(f, c, dim, bf16):
    if dim % 4:
        with pytest.raises(NotImplementedError, match="divisible by 4"):
            ta.bwd_plan(16, f, c, dim, 2, bf16, SMS)
        return
    if _old_tile_raises(f, c, dim):
        with pytest.raises(NotImplementedError, match="exceed shared memory"):
            ta.bwd_plan(16, f, c, dim, 2, bf16, SMS)
        return
    plan = ta.bwd_plan(16, f, c, dim, 2, bf16, SMS)
    assert plan["smem"] <= SMEM_MAX
    # the wide shapes keep the CUDA-core kernel in bf16 and take the float32 tensor-core design in float32
    # (head dims up to 64), which also takes float32 columns over 64 wide (the measured rule); the C launchers pick
    # the route by the same rules
    elt = 2 if bf16 else 4
    staged = ta._tc_bwd_fits(1, f, c, dim, elt)
    tf = not bf16 and ta._tf32x3_fits(f, dim) and (not staged or c > 64)
    assert plan["route"] == ("tf32x3" if tf else ("staged" if bf16 else ta.STAGED_3XTF32) if staged else "simt")
    if plan["route"] != "tf32x3":
        assert (plan["route"] != "simt") == ta._tc_bwd_fits(plan["bt"], f, c, dim, elt)


def test_temporal_plan_spreads_the_flagship_top_level():
    """(8, 4096, 10, 32) in bf16: whole 16-row blocks (8 tokens of 10 frames) and two CTAs on every SM."""
    plan = ta.bwd_plan(8 * 4096, 10, 32, DIM, HEADS, True, SMS)
    assert plan["rows"] == plan["rows_padded"] == 80 and plan["grid"] == 2 * SMS
    assert ta.bwd_plan(8 * 4096, 10, 32, DIM, HEADS, True, 66)["grid"] == 2 * 66


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SLA, ids=str)
def test_sla_q_plan_fits_and_pads(shape, bf16):
    b, f, hh, ww, c = shape
    frames, n = b * f, hh * ww
    plan = sla.q_plan(frames, n, c, DIM, HEADS, bf16, SMS)
    assert plan["route"] == "staged" and plan["smem"] <= SMEM_MAX
    assert plan["chunk"] % 16 == 0 and 16 <= plan["chunk"] <= 128
    assert plan["smem"] == sla._sla_tc_bytes(plan["chunk"], c, DIM, 2 if bf16 else 4)
    assert 1 <= plan["splits"] <= -(-n // plan["chunk"])
    assert frames * plan["splits"] * 4 * 2 * c * HEADS * DIM <= sla._WORKSPACE_MAX
    per_sm = 2 if 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
    assert per_sm == 2 or plan["chunk"] == 16  # only a 16-token chunk may take a whole SM


@pytest.mark.parametrize("c,dim", [(32, 32), (400, 32), (512, 64), (1024, 32), (4096, 64), (4400, 64)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_sla_q_plan_raises_where_the_old_chunk_raised(c, dim, bf16):
    if _old_chunk_raises(c, dim):
        with pytest.raises(NotImplementedError, match="exceeds shared memory"):
            sla.q_plan(20, 4096, c, dim, 8, bf16, SMS)
        return
    plan = sla.q_plan(20, 4096, c, dim, 8, bf16, SMS)
    assert plan["smem"] <= SMEM_MAX
    assert (plan["route"] == "staged") == (sla._sla_tc_bytes(16, c, dim, 2 if bf16 else 4) <= SMEM_MAX)


def test_padding_helpers_match_the_cuda_side():
    """``pad_ld`` keeps a bf16 panel's rows 16-byte aligned and an odd number of 16-byte units apart."""
    for n in (1, 16, 24, 32, 40, 96, 256, 300):
        ld = ta._pad_ld(n)
        assert ld >= n and ld % 8 == 0 and (ld // 8) % 2 == 1 and ld - n < 24
        assert ta._round16(n) % 16 == 0 and 0 <= ta._round16(n) - n < 16
