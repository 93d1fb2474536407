"""The port's cross-attention op against the JAX package's, on the CPU at small sizes.

The JAX op runs its Pallas kernels through the interpreter (``FORCE_INTERPRET``,
as tests/test_ops.py sets it), so the port's plain versions, which are the
CUDA kernels' oracles, are held to the TPU kernels' rounding points. Covered:
the forward and all seven gradients at f_l < f_g (8 of 32, 4 of 21 ragged)
in float32 and bf16; the self-attention case f_l = f_g with K/V projected
from x, against the port's temporal op; the block width of the plain
versions; the CPU dispatch and the shape checks. Tolerances: float32 forward
atol 5e-5, gradients 2e-4 of each gradient's largest magnitude; bf16 0.05
likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_helpers import seeded
from video_diffusion_nnx_tpu.models import MultiheadAttention
from video_diffusion_nnx_tpu.ops import cross_attention as jxa
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch import ops
from video_diffusion_nnx_tpu_torch.ops import cross_attention as pxa
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta

HEADS, DIM, C = 2, 8, 16
NAMES = ("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo")
TOL = {"float32": (5e-5, 2e-4), "bfloat16": (0.05, 0.05)}  # (forward atol, gradients relative to their largest)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jxa, "FORCE_INTERPRET", True)


def _inputs(fl: int, fg: int, b: int = 1, s: int = 4):
    x = seeded((b, s, fl, C), 1)
    k = seeded((b, s, fg, HEADS * DIM), 2)
    v = seeded((b, s, fg, HEADS * DIM), 3)
    wq = seeded((C, HEADS * DIM), 4, 0.2)
    bq = seeded((HEADS * DIM,), 5, 0.1)
    wo = seeded((HEADS * DIM, C), 6, 0.2)
    bo = seeded((C,), 7, 0.1)
    return x, k, v, wq, bq, wo, bo


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: error {err} of its largest value {scale}, over {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fl,fg", [(8, 32), (4, 21)])
def test_op_and_gradients_match_pallas_kernels(fl, fg, dtype):
    """Forward and all seven gradients of sum(out * g) against the JAX op's Pallas kernels."""
    x, k, v, *w = _inputs(fl, fg)
    g = seeded(x.shape, 8)
    jdt = jnp.dtype(dtype)
    jx, jk, jv = (jnp.asarray(a, jdt) for a in (x, k, v))
    jw = [jnp.asarray(a) for a in w]
    assert jxa._route(jx, jk) == "pallas"
    want, vjp = jax.vjp(lambda *a: jxa.fused_cross_attention_block(*a, HEADS, DIM), jx, jk, jv, *jw)
    want_grads = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dtype)
    leaves = [_t(a, tdt).requires_grad_() for a in (x, k, v)] + [_t(a).requires_grad_() for a in w]
    ops.reset_launch_counts()
    got = pxa.fused_cross_attention_block(*leaves, HEADS, DIM)
    assert got.dtype == tdt and got.shape == x.shape
    fwd_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=fwd_tol, rtol=0)
    got.backward(_t(g, tdt))
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors take the plain versions
    for name, leaf, wg in zip(NAMES, leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad.float().numpy(), wg, grad_tol, name)


def test_self_attention_equivalence_against_the_temporal_op():
    """f_l = f_g with K/V projected from x by an MHA's weights: the temporal op's block, forward and gradients
    (JAX tests/test_ops.py:328)."""
    mha = MultiheadAttention(in_features=C, dim=DIM, num_heads=HEADS, rngs=nnx.Rngs(0))
    wqkv, bqkv, wo, bo = (np.asarray(a) for a in jta.pack_mha_weights(mha))
    bqkv = bqkv + seeded(bqkv.shape, 3, 0.1)
    bo = bo + seeded(bo.shape, 4, 0.1)
    x = seeded((1, 4, 8, C), 1)
    hd = HEADS * DIM
    g = _t(seeded(x.shape, 9))

    def cross(x, wqkv, bqkv, wo, bo):
        kv = x @ wqkv[:, hd:] + bqkv[hd:]
        return pxa.fused_cross_attention_block(x, kv[..., :hd], kv[..., hd:], wqkv[:, :hd], bqkv[:hd], wo, bo,
                                               HEADS, DIM)

    outs = []
    for fn in (cross, lambda *a: pta.fused_temporal_attention_block(*a, HEADS, DIM)):
        leaves = [_t(a).requires_grad_() for a in (x, wqkv, bqkv, wo, bo)]
        out = fn(*leaves)
        outs.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    (got, got_grads), (want, want_grads) = outs
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=0)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got_grads, want_grads):
        _close(a.numpy(), b.numpy(), 2e-4, name)
    # The JAX op agrees with both.
    jx = jnp.asarray(x)
    kv = np.asarray(jx @ wqkv[:, hd:] + bqkv[hd:])
    jwant = jxa.fused_cross_attention_block(jx, jnp.asarray(kv[..., :hd]), jnp.asarray(kv[..., hd:]),
                                            jnp.asarray(wqkv[:, :hd]), jnp.asarray(bqkv[:hd]), jnp.asarray(wo),
                                            jnp.asarray(bo), HEADS, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=5e-5, rtol=0)


@pytest.mark.parametrize("kb", [4, 8, 21, 32])
def test_plain_versions_do_not_depend_on_the_block_width(kb):
    """In float32 any KV block width (dividing f_g or not) gives the same function: forward 2e-5, gradients 2e-4."""
    x, k, v, *w = map(_t, _inputs(4, 21))
    g = _t(seeded(x.shape, 8))
    want = pxa.cross_attention_plain(x, k, v, *w, HEADS, DIM, kb=21)
    got = pxa.cross_attention_plain(x, k, v, *w, HEADS, DIM, kb=kb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    wq, bq, wo, _ = w
    ref = pxa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, HEADS, DIM, kb=21)
    for name, a, b in zip(NAMES, pxa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, HEADS, DIM, kb=kb), ref):
        _close(a.numpy(), b.numpy(), 2e-4, name)


def test_shape_checks():
    x, k, v, wq, bq, wo, bo = map(_t, _inputs(8, 32))
    with pytest.raises(ValueError, match="k and v"):
        pxa.fused_cross_attention_block(x, k[..., :-1], v, wq, bq, wo, bo, HEADS, DIM)
    with pytest.raises(ValueError, match="k and v"):
        pxa.fused_cross_attention_block(x, k[:, :2], v[:, :2], wq, bq, wo, bo, HEADS, DIM)
    with pytest.raises(ValueError, match="wq/bq"):
        pxa.fused_cross_attention_block(x, k, v, wq[:-1], bq, wo, bo, HEADS, DIM)
    with pytest.raises(ValueError, match="wo/bo"):
        pxa.fused_cross_attention_block(x, k, v, wq, bq, wo, bo[:-1], HEADS, DIM)
    with pytest.raises(ValueError, match="x must be"):
        pxa.fused_cross_attention_block(x[0], k, v, wq, bq, wo, bo, HEADS, DIM)


def test_kernel_limits_follow_shared_memory():
    """What the card's kernels take: the shapes of the sequence-parallel recipe, and f_l up to the
    shared-memory bound (checked without a card)."""
    x = torch.empty(1, 1, 8, 256, dtype=torch.bfloat16)
    k = torch.empty(1, 1, 32, 256, dtype=torch.bfloat16)
    pxa._check_kernel(x, k, k, 8, 32)
    assert 4 * pxa._floats(8, 32, pxa.KV_BLOCK, backward=True) <= pxa._SMEM_MAX // 4  # four CTAs per SM
    with pytest.raises(NotImplementedError, match="K and V in x's type"):
        pxa._check_kernel(x, k.float(), k, 8, 32)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        pxa._check_kernel(x.half(), k.half(), k.half(), 8, 32)
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        pxa._check_kernel(torch.empty(1, 1, 2048, 256), k.float(), k.float(), 8, 32)
