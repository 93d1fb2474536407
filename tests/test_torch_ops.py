"""The port's fused-attention ops against the JAX package's Pallas kernels (interpret mode).

On the CPU each public op runs its plain PyTorch version; the JAX side runs
its Pallas kernel body through the interpreter, as tests/test_ops.py does.
Tolerance: float32 atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_helpers import flat_nnx_state, seeded
from video_diffusion_nnx_tpu.models import MultiheadAttention, SpatialLinearAttention
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch import ops
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.models import attention as patt
from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as psla
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta

ATOL = 2e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("f,s,c,heads,d", [(10, 6, 16, 4, 8), (64, 2, 32, 2, 16), (3, 4, 8, 2, 4)])
def test_temporal_op_matches_pallas_kernel(monkeypatch, f, s, c, heads, d):
    """f = 10 is ragged (the TPU pads it to 16 and masks); f = 64 is the dense kernel's limit."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    mha = MultiheadAttention(in_features=c, dim=d, num_heads=heads, rngs=nnx.Rngs(0))
    wqkv, bqkv, wo, bo = (np.asarray(a) for a in jta.pack_mha_weights(mha))
    bqkv = bqkv + seeded(bqkv.shape, 3, 0.1)  # non-zero biases
    bo = bo + seeded(bo.shape, 4, 0.1)
    x = seeded((2, s, f, c), 1)
    want = np.asarray(jta.fused_temporal_attention_block(
        jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wo), jnp.asarray(bo), heads, d))
    ops.reset_launch_counts()
    got = pta.fused_temporal_attention_block(_t(x), _t(wqkv), _t(bqkv), _t(wo), _t(bo), heads, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert ops.launch_counts()["temporal_attention_fwd"] == 0  # a CPU tensor takes the plain version


def test_temporal_plain_equals_jax_composite_in_bf16():
    """bf16 rounding points of the plain version follow _composite_xla (atol 0.05)."""
    heads, d, c = 4, 8, 16
    mha = MultiheadAttention(in_features=c, dim=d, num_heads=heads, rngs=nnx.Rngs(0))
    w = [np.asarray(a) for a in jta.pack_mha_weights(mha)]
    x = seeded((2, 4, 10, c), 1)
    want = np.asarray(jta._composite_xla(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w), heads, d), np.float32)
    got = pta.temporal_attention_plain(_t(x).bfloat16(), *map(_t, w), heads, d).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


def test_pack_mha_weights_matches():
    mha = MultiheadAttention(in_features=16, dim=8, num_heads=4, rngs=nnx.Rngs(0))
    port = patt.MultiheadAttention(16, 8, 4)
    _, state = nnx.split(mha)
    port.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), port))
    for w, p in zip(jta.pack_mha_weights(mha), pta.pack_mha_weights(port)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w))


def _sla(c, heads, d):
    sla = SpatialLinearAttention(c, heads=heads, D=d, rngs=nnx.Rngs(0))
    wqkv, wo = (np.asarray(a) for a in jsla.pack_sla_weights(sla))
    return sla, wqkv, wo


@pytest.mark.parametrize("scale", [1.0, 8 ** -0.5])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 16), (1, 2, 8, 8, 32)])
def test_sla_op_matches_one_pass_kernel(monkeypatch, shape, scale):
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    c = shape[-1]
    _, wqkv, wo = _sla(c, 4, 8)
    x = seeded(shape, 1)
    assert jsla._supported(jnp.asarray(x), 4, 8)
    want = np.asarray(jsla._forward(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo), 4, 8, scale))
    got = psla.fused_spatial_linear_attention_block(_t(x), _t(wqkv), _t(wo), 4, 8, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,heads,d", [((1, 2, 8, 8, 16), 4, 8), ((1, 1, 4, 4, 16), 2, 128)])
def test_sla_op_matches_two_pass_kernels(monkeypatch, shape, heads, d):
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    _, wqkv, wo = _sla(shape[-1], heads, d)
    x = seeded(shape, 2)
    want = np.asarray(jsla._forward_two_pass(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo), heads, d, 1.0))
    ops.reset_launch_counts()
    got = psla.fused_spatial_linear_attention_block(_t(x), _t(wqkv), _t(wo), heads, d, 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert set(ops.launch_counts().values()) == {0}


def test_sla_stages_compose_to_jax_composite_in_bf16():
    _, wqkv, wo = _sla(16, 4, 8)
    x = seeded((2, 3, 4, 4, 16), 1)
    want = np.asarray(jsla._composite_xla(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wqkv), jnp.asarray(wo), 4, 8, 1.0), np.float32)
    xt = _t(x).bfloat16().reshape(6, 16, 16)
    ctx = psla.sla_context_plain(xt, _t(wqkv), 4, 8)
    assert ctx.dtype == torch.float32 and tuple(ctx.shape) == (6, 4, 8, 8)
    got = psla.sla_out_plain(xt, _t(wqkv), _t(wo), ctx, 4, 8, 1.0).float().reshape(x.shape).numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


@pytest.mark.parametrize("shape,heads,d", [((6, 16, 16), 4, 8), ((2, 40, 32), 4, 64)])
def test_sla_context_stats_match_pallas_kernel(monkeypatch, shape, heads, d):
    """The context stage's CPU version gives the k softmax's max and sum, as _ctx_stats_kernel does."""
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    frames, _, c = shape
    _, wqkv, wo = _sla(c, heads, d)
    x = seeded(shape, 3)
    _, wk, wv, _, group, _ = jsla._group_views(jnp.asarray(wqkv), jnp.asarray(wo), heads, d, jnp.float32)
    _, m, z = jsla._ctx_stats_pallas(jnp.asarray(x), wk, wv, group, d)
    ops.reset_launch_counts()
    ctx, stats = psla.sla_context(_t(x), _t(wqkv), heads, d)
    assert tuple(stats.shape) == (2, frames, heads, d) and stats.dtype == torch.float32
    np.testing.assert_allclose(stats[0].numpy(), np.asarray(m).reshape(frames, heads, d), atol=ATOL, rtol=0)
    np.testing.assert_allclose(stats[1].numpy(), np.asarray(z).reshape(frames, heads, d), atol=0, rtol=1e-5)
    np.testing.assert_array_equal(ctx.numpy(), psla.sla_context_plain(_t(x), _t(wqkv), heads, d).numpy())
    assert ops.launch_counts()["sla_context"] == 0


@pytest.mark.parametrize("shape,heads,d", [((2, 64, 32), 8, 32), ((3, 49, 24), 4, 8)])
def test_jax_point_context_model_matches_pallas_kernel(monkeypatch, shape, heads, d):
    """In bf16, the float64 model of the JAX context kernel's rounding points that the card tests hold the staged
    kernel against (``test_torch_cuda.jax_point_context``: k in float32 from x and W_k in x's type, its softmax
    over all tokens, then s and v rounded to x's type) gives the contexts of ``_ctx_stats_kernel`` (interpret
    mode); ``sla_context_plain``, which rounds k before its softmax, lies further from them."""
    from test_torch_cuda import jax_point_context

    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    frames, _, c = shape
    _, wqkv, wo = _sla(c, heads, d)
    x = seeded(shape, 4, 0.5)
    _, wk, wv, _, group, n_groups = jsla._group_views(jnp.asarray(wqkv), jnp.asarray(wo), heads, d, jnp.bfloat16)
    ctx, _, _ = jsla._ctx_stats_pallas(jnp.asarray(x, jnp.bfloat16), wk, wv, group, d)
    blocks = np.asarray(ctx, np.float64).reshape(frames, n_groups, group, d, group, d)
    want = np.stack([blocks[:, :, h, :, h, :] for h in range(group)], 2).reshape(frames, heads, d, d)
    xt = _t(x).bfloat16()
    model = jax_point_context(xt, _t(wqkv), heads, d).numpy()
    plain = psla.sla_context_plain(xt, _t(wqkv), heads, d).double().numpy()
    err_model, err_plain = (np.abs(a - want).max() / np.abs(want).max() for a in (model, plain))
    assert err_model <= 1e-5 and err_model < err_plain, (err_model, err_plain)


def test_pack_sla_weights_matches():
    sla, _, _ = _sla(16, 4, 8)
    port = patt.SpatialLinearAttention(16, heads=4, D=8)
    _, state = nnx.split(sla)
    port.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), port))
    for w, p in zip(jsla.pack_sla_weights(sla), psla.pack_sla_weights(port)):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(w))
