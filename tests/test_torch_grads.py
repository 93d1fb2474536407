"""Gradients of the port's fused-attention ops against the JAX package's backward kernels.

On the CPU the port differentiates its plain forward with autograd; the JAX
side runs ``jax.grad`` through its op with ``FORCE_INTERPRET = True``, so its
custom VJP takes the Pallas backward kernels (``_bwd_kernel``,
``_bwd_q_kernel``, ``_bwd_kv_kernel``) in interpret mode. Tolerances are the
JAX suite's: float32 atol 1e-4 for dx, 2e-4 for weight gradients.

The plain backward oracles, which the CUDA kernels are held to on the card,
are checked against autograd of the plain forward (float32, atol 1e-5) and,
in bf16, against the JAX ``_composite_xla`` VJP (rtol 0.1, atol 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import seeded
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as psla
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta

ATOL_DX, ATOL_W = 1e-4, 2e-4


def _t(a, requires_grad=False) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(requires_grad)


def _temporal_inputs(b, s, f, c, heads, d):
    hd = heads * d
    return [seeded((b, s, f, c), 1, 0.5), seeded((c, 3 * hd), 2, c ** -0.5), seeded((3 * hd,), 3, 0.1),
            seeded((hd, c), 4, hd ** -0.5), seeded((c,), 5, 0.1)], seeded((b, s, f, c), 6, 0.5)


def _port_grads(fn, arrays, g):
    leaves = [_t(a, True) for a in arrays]
    (fn(*leaves) * _t(g)).sum().backward()
    return [t.grad.numpy() for t in leaves]


# f = 10 is ragged (the TPU pads it to 16 and masks), f = 64 the dense kernel's limit, and
# 80 tokens of f = 10 make five of the JAX kernel's token tiles.
@pytest.mark.parametrize("b,s,f,c,heads,d", [(2, 3, 10, 16, 4, 8), (1, 2, 64, 32, 2, 16), (2, 40, 10, 16, 2, 8)])
def test_temporal_grads_match_pallas_backward(monkeypatch, b, s, f, c, heads, d):
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    arrays, g = _temporal_inputs(b, s, f, c, heads, d)
    assert jta._route(jnp.asarray(arrays[0]), f) == "dense"

    def loss(*a):
        return jnp.sum(jta.fused_temporal_attention_block(*a, heads, d) * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    got = _port_grads(lambda *a: pta.fused_temporal_attention_block(*a, heads, d), arrays, g)
    for i, (gw, gg) in enumerate(zip(want, got)):
        np.testing.assert_allclose(gg, np.asarray(gw), atol=ATOL_DX if i == 0 else ATOL_W, rtol=0)


@pytest.mark.parametrize("shape,heads,d", [((2, 3, 4, 4, 16), 4, 8), ((1, 2, 8, 8, 32), 2, 16)])
def test_sla_grads_match_pallas_backward(monkeypatch, shape, heads, d):
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    c = shape[-1]
    hd = heads * d
    arrays = [seeded(shape, 1, 0.5), seeded((c, 3 * hd), 2, c ** -0.5), seeded((hd, c), 3, hd ** -0.5)]
    g = seeded(shape, 4, 0.5)
    x = jnp.asarray(arrays[0])
    assert jsla._two_pass_supported(x) and jsla._bwd_fits(x, heads, d)  # the _backward_pallas route

    def loss(*a):
        return jnp.sum(jsla.fused_spatial_linear_attention_block(*a, heads, d, 1.0) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    got = _port_grads(lambda *a: psla.fused_spatial_linear_attention_block(*a, heads, d, 1.0), arrays, g)
    for i, (gw, gg) in enumerate(zip(want, got)):
        np.testing.assert_allclose(gg, np.asarray(gw), atol=ATOL_DX if i == 0 else ATOL_W, rtol=0)


@pytest.mark.parametrize("f", [10, 64])
def test_temporal_bwd_oracle_equals_autograd(f):
    heads, d = 2, 8
    arrays, g = _temporal_inputs(2, 3, f, 16, heads, d)
    want = _port_grads(lambda *a: pta.temporal_attention_plain(*a, heads, d), arrays, g)
    got = pta.temporal_attention_bwd_plain(_t(arrays[0]), _t(g), *map(_t, arrays[1:]), heads, d)
    for gw, gg in zip(want, got):
        np.testing.assert_allclose(gg.numpy(), gw, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 8 ** -0.5])
def test_sla_bwd_oracles_equal_autograd(scale):
    heads, d, shape = 4, 8, (2, 3, 4, 4, 16)
    c, hd = shape[-1], heads * d
    arrays = [seeded(shape, 1, 0.5), seeded((c, 3 * hd), 2, c ** -0.5), seeded((hd, c), 3, hd ** -0.5)]
    g = seeded(shape, 4, 0.5)
    want = _port_grads(lambda *a: psla.fused_spatial_linear_attention_block(*a, heads, d, scale), arrays, g)
    xt, w, wo = _t(arrays[0]).reshape(6, 16, c), _t(arrays[1]), _t(arrays[2])
    ctx = psla.sla_context_plain(xt, w, heads, d)
    dxq, dctx, dwq, dwo = psla.sla_bwd_q_plain(xt, _t(g).reshape(6, 16, c), w, wo, ctx, heads, d, scale)
    dx, dwk, dwv = psla.sla_bwd_kv_plain(xt, w, ctx, dctx, dxq, heads, d)
    np.testing.assert_allclose(dx.reshape(shape).numpy(), want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(torch.cat([dwq, dwk, dwv], 1).numpy(), want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dwo.numpy(), want[2], atol=1e-5, rtol=0)


def _bf16(a) -> torch.Tensor:
    return _t(a).bfloat16()


def test_temporal_bwd_oracle_matches_jax_composite_in_bf16():
    heads, d = 4, 8
    arrays, g = _temporal_inputs(2, 4, 10, 16, heads, d)
    xj = jnp.asarray(arrays[0], jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jta._composite_xla(*a, heads, d), xj, *map(jnp.asarray, arrays[1:]))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    got = pta.temporal_attention_bwd_plain(_bf16(arrays[0]), _bf16(g), *map(_t, arrays[1:]), heads, d)
    for gw, gg in zip(want, got):
        np.testing.assert_allclose(gg.float().numpy(), np.asarray(gw, np.float32), rtol=0.1, atol=0.25)


def test_sla_bwd_oracles_match_jax_composite_in_bf16():
    heads, d, shape = 4, 8, (2, 3, 4, 4, 16)
    c, hd = shape[-1], heads * d
    arrays = [seeded(shape, 1, 0.5), seeded((c, 3 * hd), 2, c ** -0.5), seeded((hd, c), 3, hd ** -0.5)]
    g = seeded(shape, 4, 0.5)
    xj = jnp.asarray(arrays[0], jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jsla._composite_xla(*a, heads, d, 1.0), xj, *map(jnp.asarray, arrays[1:]))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    xt, w, wo = _bf16(arrays[0]).reshape(6, 16, c), _t(arrays[1]), _t(arrays[2])
    ctx = psla.sla_context_plain(xt, w, heads, d)
    dxq, dctx, dwq, dwo = psla.sla_bwd_q_plain(xt, _bf16(g).reshape(6, 16, c), w, wo, ctx, heads, d, 1.0)
    dx, dwk, dwv = psla.sla_bwd_kv_plain(xt, w, ctx, dctx, dxq, heads, d)
    for gw, gg in zip(want, (dx.reshape(shape), torch.cat([dwq, dwk, dwv], 1), dwo)):
        np.testing.assert_allclose(gg.float().numpy(), np.asarray(gw, np.float32), rtol=0.1, atol=0.25)


def test_cpu_ops_stay_plain_and_differentiable():
    """A CPU tensor never reaches a kernel: the forward is the plain version and autograd runs it."""
    from video_diffusion_nnx_tpu_torch import ops

    ops.reset_launch_counts()
    arrays, g = _temporal_inputs(1, 2, 10, 16, 2, 8)
    grads = _port_grads(lambda *a: pta.fused_temporal_attention_block(*a, 2, 8), arrays, g)
    assert all(np.abs(gr).max() > 0 for gr in grads)
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.staged_launch_counts().values()) == {0}


# The float32 k/v backward takes rho = sum_e dctx * ctx from the forward's contexts in place of sum_n ds * s
# (rounding is the identity in float32), as the staged kernel's one pass does. Against the JAX backward through
# the whole-frame `_bwd_kv_kernel` and the chunked `_bwd_kv_chunk1/2_kernel` pair in interpret mode, within the
# card's float32 backward gate (1e-5 of each output's largest value).
@pytest.mark.parametrize("shape,heads,d,route", [((2, 3, 4, 4, 16), 4, 8, "whole"), ((1, 2, 8, 8, 32), 2, 16, "whole"),
                                                 ((1, 2, 32, 32, 16), 2, 8, "chunked")])
def test_sla_bwd_kv_one_pass_matches_pallas_backward(monkeypatch, shape, heads, d, route):
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    b, f, hh, ww, c = shape
    hd = heads * d
    arrays = [seeded(shape, 1, 0.5), seeded((c, 3 * hd), 2, c ** -0.5), seeded((hd, c), 3, hd ** -0.5)]
    g = seeded(shape, 4, 0.5)
    backward = jsla._backward_pallas if route == "whole" else jsla._backward_pallas_chunked
    want_dx, want_dw, _ = (np.asarray(a) for a in backward(*map(jnp.asarray, (*arrays, g)), heads, d, 1.0))
    xt, w, wo = _t(arrays[0]).reshape(b * f, hh * ww, c), _t(arrays[1]), _t(arrays[2])
    ctx = psla.sla_context_plain(xt, w, heads, d)
    dxq, dctx, dwq, _ = psla.sla_bwd_q_plain(xt, _t(g).reshape(xt.shape), w, wo, ctx, heads, d, 1.0)
    one = psla.sla_bwd_kv(xt, w, ctx, dctx, dxq, None, heads, d)  # a CPU tensor: the plain version
    got = {"dx": one[0].reshape(shape).numpy(), "dwk": one[1].numpy(), "dwv": one[2].numpy()}
    want = {"dx": want_dx, "dwk": want_dw[:, hd:2 * hd], "dwv": want_dw[:, 2 * hd:]}
    for k, ref in want.items():
        assert np.abs(got[k] - ref).max() <= 1e-5 * np.abs(ref).max(), k
