"""The host-side planners of the staged spatial forward, and the context kernel's statistics merge, on the CPU.

``spatial_linear_attention.ctx_plan`` and ``out_plan`` decide the route (the staged kernel, whose
products run on the tensor cores in bf16, where its 16-token chunk fits, else the CUDA-core kernel),
the tokens per chunk, the CTAs per frame (and, for the context kernel, the head groups) and the shared
memory. They take the number of SMs as an
argument (132 on the H100), so every shape of the flagship (sampling batch 2, training batch 8), the
long clip (128 frames), the wide frame and the card tests' edge shapes is checked here without a card,
in both types: the chunk pads to whole 16-row blocks, the shared memory fits the 227 KB a CTA may use,
the splits cover every token with no CTA left empty, and the planners raise exactly where the CUDA-core
kernels' own sizing (``_chunk``) raised before.

The staged context kernel's first pass keeps, per (head, feature), a running max and sum of
exp(k - max) for each of G thread groups (rows g, g + G, ... of each chunk), merges the groups in order
into its CTA's partial, and the second pass merges the splits in order. ``_merged_stats`` repeats that
arithmetic step by step in float32; it is held against ``sla_stats_plain`` at every (tokens, chunk,
splits) the planner picks.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as sla

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024
HEADS, DIM = 8, 32
THREADS = 256


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _smoke()
# Every spatial shape chip_smoke.py drives (the flagship's at the sampling and training batches, the long clip's,
# the wide frame), and the card tests' ragged ones.
SHAPES = ([(b, *sh[1:]) for b in (_CS.B, _CS.B_TRAIN) for _, sh in _CS.SLA_SHAPES]
          + [sh for _, sh in _CS.LONG_SLA_SHAPES] + [_CS.WIDE_SLA_SHAPE, (1, 2, 7, 7, 24), (1, 3, 16, 16, 128)])


def _old_chunk_raises(per_token: int, fixed: int) -> bool:
    """``_chunk``'s own limit: a 4-token chunk of the CUDA-core kernel over 227 KB."""
    return fixed + 4 * per_token > SMEM_MAX


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ctx_plan_fits_and_covers(shape, bf16):
    b, f, hh, ww, c = shape
    frames, n = b * f, hh * ww
    elt = 2 if bf16 else 4
    plan = sla.ctx_plan(frames, n, c, DIM, HEADS, bf16, SMS)
    groups = plan["groups"]
    assert plan["route"] == "staged" and plan["smem"] <= SMEM_MAX
    assert plan["chunk"] % 16 == 0 and 16 <= plan["chunk"] <= 128  # chunk rows pad to whole 16-row blocks
    assert HEADS % groups == 0 and plan["smem"] == sla._sla_ctx_bytes(plan["chunk"], c, DIM, HEADS // groups, elt)
    chunks = -(-n // plan["chunk"])
    per = -(-chunks // plan["splits"])  # chunks per CTA, as the kernel divides them
    assert plan["splits"] * per * plan["chunk"] >= n  # the splits cover every token
    assert (plan["splits"] - 1) * per < chunks  # and the last CTA of a frame holds a chunk
    assert plan["splits"] == 1 or frames * plan["splits"] * 4 * HEADS * DIM * DIM <= sla._CTX_WORKSPACE_MAX
    # two CTAs per SM wherever one head's 16-token chunk allows it (float32 at c = 256: its weights alone are 147 KB)
    assert 2 * (plan["smem"] + 1024) <= 228 * 1024 or sla._sla_ctx_bytes(16, c, DIM, 1, elt) > 113 * 1024


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_out_plan_fits_and_covers(shape, bf16):
    b, f, hh, ww, c = shape
    frames, n = b * f, hh * ww
    elt = 2 if bf16 else 4
    plan = sla.out_plan(frames, n, c, DIM, HEADS, bf16, SMS)
    assert plan["route"] == "staged" and plan["smem"] <= SMEM_MAX
    assert plan["chunk"] % 16 == 0 and 16 <= plan["chunk"] <= 128
    assert plan["smem"] == sla._sla_out_bytes(plan["chunk"], c, DIM, elt)
    assert plan["splits"] == -(-n // plan["chunk"])  # one CTA per frame and chunk
    per_sm = 2 if 2 * (plan["smem"] + 1024) <= 228 * 1024 else 1
    assert per_sm == 2 or plan["chunk"] == 16


def test_flagship_top_level_plans():
    """The 64x64 top level: 128-token chunks in bf16 and two CTAs per SM for both stages; the context
    kernel's splits put about two CTAs per SM over the sampler's 20 frames."""
    for frames in (20, 80):
        ctx = sla.ctx_plan(frames, 4096, 32, DIM, HEADS, True, SMS)
        out = sla.out_plan(frames, 4096, 32, DIM, HEADS, True, SMS)
        assert ctx["chunk"] == out["chunk"] == 128
        assert 2 * (max(ctx["smem"], out["smem"]) + 1024) <= 228 * 1024
    assert 20 * sla.ctx_plan(20, 4096, 32, DIM, HEADS, True, SMS)["splits"] <= 2 * SMS


@pytest.mark.parametrize("c,dim", [(32, 32), (400, 32), (512, 64), (1024, 32), (4096, 64), (6700, 64), (14000, 32)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_plans_raise_where_the_old_chunk_raised(c, dim, bf16):
    elt = 2 if bf16 else 4
    if _old_chunk_raises(4 * (c + 2 * (dim + 1)), 4 * 3 * dim):
        with pytest.raises(NotImplementedError, match="exceeds shared memory"):
            sla.ctx_plan(20, 4096, c, dim, 8, bf16, SMS)
    else:
        plan = sla.ctx_plan(20, 4096, c, dim, 8, bf16, SMS)
        staged = sla._sla_ctx_bytes(16, c, dim, 1, elt) <= SMEM_MAX  # one head per CTA at the least
        assert plan["route"] == ("staged" if staged else "simt") and plan["smem"] <= SMEM_MAX
        assert staged or (plan["splits"] == plan["groups"] == 1
                          and plan["smem"] == 4 * (plan["chunk"] * (c + 2 * (dim + 1)) + 3 * dim))
        # the C launcher's rule at the plan's heads per CTA: the CUDA-core route's chunk never fits it
        fits = sla._sla_ctx_bytes(plan["chunk"], c, dim, 8 // plan["groups"], elt) <= SMEM_MAX
        assert (plan["route"] == "staged") == (plan["chunk"] % 16 == 0 and fits)
    if _old_chunk_raises(4 * (2 * c + 2 * (dim + 1)), 4 * dim * (dim + 1)):
        with pytest.raises(NotImplementedError, match="exceeds shared memory"):
            sla.out_plan(20, 4096, c, dim, 8, bf16, SMS)
    else:
        plan = sla.out_plan(20, 4096, c, dim, 8, bf16, SMS)
        staged = sla._sla_out_bytes(16, c, dim, elt) <= SMEM_MAX
        assert plan["route"] == ("staged" if staged else "simt") and plan["smem"] <= SMEM_MAX
        # the CUDA-core route keeps the old chunk: a multiple of 4, never a multiple of 16 that would fit
        assert staged or plan["chunk"] % 16 or sla._sla_out_bytes(plan["chunk"], c, dim, elt) > SMEM_MAX


def _merged_stats(k: torch.Tensor, chunk: int, splits: int, groups: int) -> torch.Tensor:
    """The staged context kernel's statistics of k (frames, n, H*D) float32, in its order: per split (a
    contiguous range of chunks) and thread group g (rows g, g + G, ... of each chunk), a running max and
    sum of exp(k - max) updated chunk by chunk, one row after another; then the groups merged in order;
    then the splits merged in order. Returns ``(2, frames, H*D)``."""
    frames, n, hd = k.shape
    chunks = -(-n // chunk)
    per = -(-chunks // splits)
    ninf = torch.tensor(float("-inf"))
    m_sp, z_sp = [], []
    for sp in range(splits):
        m = torch.full((frames, groups, hd), float("-inf"))
        z = torch.zeros(frames, groups, hd)
        for n0 in range(sp * per * chunk, min(n, (sp + 1) * per * chunk), chunk):
            nc = min(chunk, n - n0)
            rows = -(-chunk // groups) * groups
            kc = torch.full((frames, rows, hd), float("-inf"))
            kc[:, :nc] = k[:, n0:n0 + nc]
            kc = kc.reshape(frames, rows // groups, groups, hd)  # row r = g + G i at (i, g)
            mc = kc.amax(1)
            has = mc > ninf
            mn = torch.where(has, torch.maximum(m, mc), m)
            acc = torch.where(m == ninf, torch.zeros(()), z * torch.exp(m - mn))
            for i in range(kc.shape[1]):
                live = kc[:, i] > ninf
                acc = acc + torch.where(live, torch.exp(kc[:, i] - mn), torch.zeros(()))
            z = torch.where(has, acc, z)
            m = mn
        mg = m.amax(1)  # the groups, merged in order
        zg = torch.zeros(frames, hd)
        for g in range(groups):
            zg = zg + torch.where(z[:, g] > 0, z[:, g] * torch.exp(m[:, g] - mg), torch.zeros(()))
        m_sp.append(mg)
        z_sp.append(zg)
    mf = torch.stack(m_sp).amax(0)  # the splits, merged in order
    zf = torch.zeros(frames, hd)
    for mg, zg in zip(m_sp, z_sp):
        zf = zf + torch.where(zg > 0, zg * torch.exp(mg - mf), torch.zeros(()))
    return torch.stack([mf, zf])


_PLANS = sorted({(p[2] * p[3], plan["chunk"], plan["splits"])
                 for p in SHAPES for bf16 in (True, False)
                 for plan in [sla.ctx_plan(p[0] * p[1], p[2] * p[3], p[4], DIM, HEADS, bf16, SMS)]})


@pytest.mark.parametrize("n,chunk,splits", _PLANS, ids=str)
def test_split_statistics_merge_matches_the_plain_statistics(n, chunk, splits):
    """At every (tokens, chunk, splits) the planner picks: the kernel's merge order gives the plain
    statistics, the max bit for bit and the sum within 1e-5 of its largest value (the card's float32
    gate on the statistics), for a k with a different scale per feature."""
    frames, c = 2, 24
    rng = np.random.default_rng(n + 7 * chunk + splits)
    x = torch.from_numpy(rng.standard_normal((frames, n, c)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((c, 3 * HEADS * DIM)).astype(np.float32))
    w[:, HEADS * DIM:2 * HEADS * DIM] *= torch.from_numpy(rng.uniform(0.05, 2.0, HEADS * DIM).astype(np.float32))
    want = sla.sla_stats_plain(x, w, HEADS, DIM).reshape(2, frames, HEADS * DIM)
    k = x @ w[:, HEADS * DIM:2 * HEADS * DIM]
    got = _merged_stats(k, chunk, splits, THREADS // DIM)
    assert torch.equal(got[0], want[0])
    assert ((got[1] - want[1]).abs().max() / want[1].abs().max()).item() <= 1e-5
