"""The port's fixed-math path (``reference_compat=False``) against the JAX package, on the CPU at small sizes.

Fixed math applies every PreNorm's LayerNorm, adds the relative position bias
to the temporal logits before the softmax, applies the spatial q scale and
heeds a focus-present mask. On the CPU the port runs its plain versions; the
JAX side runs its biased Pallas kernels through the interpreter, as
tests/test_ops.py does. Covered: the biased op and all six gradients, dense
(f = 8, 10, 64) and blockwise (f = 65, 72, 128); ``PreNorm``,
``SpatialLinearAttention`` and ``MultiheadAttention`` (bias, mask, both,
all-masked; the compat quirks too); ``prob_mask_like``; the Unet3D by the
module route and the fused route, output and gradients, in float32 and under
the bf16 policy; a live focus mask; three trainer steps; the CLIs at a tiny
fixed recipe; the converted checkpoint fixture.

Tolerances: float32 op forward atol 5e-5, gradients 2e-4; bf16 forward atol
0.05, gradients rtol 0.1 / atol 0.25; modules 2e-5; the float32 Unet 1e-4 and
its gradients 2e-3; under the bf16 policy the Unet 0.05 and each gradient
tensor 0.1 of its norm (the frameworks round bf16 convs in different places).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

from torch_port_helpers import (
    CHANNELS, FIXTURE, FRAMES, IMAGE_SIZE, STEP, flat_nnx_state, jax_fixture_model, port_model, seeded,
)
from video_diffusion_nnx_tpu.models import attention as jatt
from video_diffusion_nnx_tpu.models import layers as jlayers
from video_diffusion_nnx_tpu.models import Unet3D as JaxUnet3D
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu.utils import functional as jfunctional
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from video_diffusion_nnx_tpu_torch import ops, sample, train
from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx, torch_key
from video_diffusion_nnx_tpu_torch.models import Unet3D
from video_diffusion_nnx_tpu_torch.models import attention as patt
from video_diffusion_nnx_tpu_torch.models import layers as players
from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as psla
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer
from video_diffusion_nnx_tpu_torch.utils.functional import prob_mask_like

HEADS, DIM, C = 2, 8, 16
GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")
UNUSED = {"final_conv.layers.0.norm_1.weight", "final_conv.layers.0.norm_1.bias"}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX side's fused ops run their Pallas kernels through the interpreter."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _op_inputs(f: int, b: int = 1, s: int = 3):
    hd = HEADS * DIM
    w = (seeded((C, 3 * hd), 2, C ** -0.5), seeded((3 * hd,), 3, 0.1), seeded((hd, C), 4, hd ** -0.5),
         seeded((C,), 5, 0.1))
    return seeded((b, s, f, C), 1), w, seeded((HEADS, f, f), 7, 0.5)


def _jax_op_grads(x, w, bias, dtype=jnp.float32):
    def loss(x, *rest):
        return jnp.sum(jta.fused_temporal_attention_block_biased(x, *rest, HEADS, DIM).astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=tuple(range(6)))(jnp.asarray(x, dtype), *map(jnp.asarray, (*w, bias)))


# ---- the biased op ----

@pytest.mark.parametrize("f", [8, 10, 64, 65, 72, 128])
def test_biased_op_matches_pallas_kernel(f):
    """f = 10 and 65 are ragged; up to 64 frames the JAX side takes its dense kernel, beyond it the blockwise one."""
    x, w, bias = _op_inputs(f)
    assert jta._route(jnp.asarray(x), f) == ("dense" if f <= 64 else "blockwise")
    want = np.asarray(jta.fused_temporal_attention_block_biased(
        jnp.asarray(x), *map(jnp.asarray, (*w, bias)), HEADS, DIM))
    ops.reset_launch_counts()
    got = pta.fused_temporal_attention_block_biased(_t(x), *map(_t, (*w, bias)), HEADS, DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    assert set(ops.launch_counts().values()) == {0}  # a CPU tensor takes the plain version
    unbiased = pta.fused_temporal_attention_block(_t(x), *map(_t, w), HEADS, DIM)
    assert (got - unbiased).abs().max().item() > 1e-3  # the bias is live
    zero = pta.fused_temporal_attention_block_biased(_t(x), *map(_t, w), torch.zeros(HEADS, f, f), HEADS, DIM)
    assert torch.equal(zero, unbiased)


@pytest.mark.parametrize("f,b,s", [(8, 1, 4), (10, 2, 3), (64, 1, 2), (65, 1, 2), (72, 2, 2), (128, 1, 2)])
def test_biased_op_gradients_match_pallas_kernel(f, b, s):
    """All six gradients of sum(out^2): autograd through the plain version, and the backward oracle's
    formulas, both against the JAX biased backward kernel (dbias included)."""
    x, w, bias = _op_inputs(f, b, s)
    want = [np.asarray(g) for g in _jax_op_grads(x, w, bias)]
    leaves = [_t(a).requires_grad_() for a in (x, *w, bias)]
    out = pta.fused_temporal_attention_block_biased(*leaves, HEADS, DIM)
    out.square().sum().backward()
    oracle = pta.temporal_attention_bwd(_t(x), 2 * out.detach(), *map(_t, w), HEADS, DIM, pos_bias=_t(bias))
    assert len(oracle) == 6 and tuple(oracle[5].shape) == (HEADS, f, f)
    assert np.abs(want[5]).max() > 1e-3
    for name, leaf, o, g in zip(GRAD_NAMES, leaves, oracle, want):
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"autograd {name}")
        np.testing.assert_allclose(o.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"oracle {name}")


@pytest.mark.parametrize("f", [10, 96])
def test_biased_op_in_bf16_matches_pallas_kernel(f):
    x, w, bias = _op_inputs(f)
    want = np.asarray(jta.fused_temporal_attention_block_biased(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (*w, bias)), HEADS, DIM), np.float32)
    xt = _t(x, torch.bfloat16)
    got = pta.fused_temporal_attention_block_biased(xt, *map(_t, (*w, bias)), HEADS, DIM)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0)
    grads = pta.temporal_attention_bwd(xt, 2 * got, *map(_t, w), HEADS, DIM, pos_bias=_t(bias))
    assert grads[5].dtype == torch.float32  # dbias comes in the bias's type
    for name, a, g in zip(GRAD_NAMES, grads, _jax_op_grads(x, w, bias, jnp.bfloat16)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(g, np.float32), rtol=0.1, atol=0.25, err_msg=name)


@pytest.mark.parametrize("f,kb", [(10, 4), (65, 16), (72, 32), (100, 48), (128, 32), (128, 128)])
def test_biased_plain_versions_agree(f, kb):
    """Both blockwise plain versions at any block width, and the dense backward oracle, give the dense
    plain version's function and autograd's gradients: forward 2e-5, gradients 2e-4."""
    x, w, bias = _op_inputs(f, 1, 3)
    leaves = [_t(a).requires_grad_() for a in (x, *w, bias)]
    want = pta.temporal_attention_plain(*leaves[:5], HEADS, DIM, pos_bias=leaves[5])
    g = _t(seeded(x.shape, 5))
    want_grads = torch.autograd.grad(want, leaves, g)
    xt, *wt, bt = (t.detach() for t in leaves)
    got = pta.temporal_attention_blockwise_plain(xt, *wt, HEADS, DIM, kb, pos_bias=bt)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=2e-5, rtol=0)
    for label, grads in (("blockwise", pta.temporal_attention_blockwise_bwd_plain(xt, g, *wt, HEADS, DIM, kb, pos_bias=bt)),
                         ("dense", pta.temporal_attention_bwd_plain(xt, g, *wt, HEADS, DIM, pos_bias=bt))):
        for name, a, b in zip(GRAD_NAMES, grads, want_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4, err_msg=f"{label} {name}")


def test_biased_op_checks_its_bias():
    x, w, bias = _op_inputs(10)
    with pytest.raises(ValueError, match="pos_bias is required"):
        pta.fused_temporal_attention_block_biased(_t(x), *map(_t, w), None, HEADS, DIM)
    assert len(pta.temporal_attention_bwd(_t(x), _t(x), *map(_t, w), HEADS, DIM)) == 5  # no bias, no dbias
    assert {"temporal_attention_biased_fwd", "temporal_attention_biased_bwd", "temporal_blockwise_biased_fwd",
            "temporal_blockwise_biased_bwd"} <= set(ops.launch_counts())


# ---- modules ----

def _load(port_module, jax_module):
    _, state = nnx.split(jax_module)
    port_module.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), port_module))
    return port_module


def test_prob_mask_like():
    for prob, value in ((0.0, False), (1.0, True), (0, False), (1, True)):
        m = prob_mask_like((5,), prob)
        assert m.dtype == torch.bool and tuple(m.shape) == (5,) and bool((m == value).all())
        assert np.array_equal(m.numpy(), np.asarray(jfunctional.prob_mask_like((5,), prob)))
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    prob_mask_like((4,), 0.0, g), prob_mask_like((4,), 1.0, g)
    assert torch.equal(g.get_state(), state)  # 0 and 1 draw nothing
    m = prob_mask_like((4000,), 0.5, g)
    assert m.dtype == torch.bool and tuple(m.shape) == (4000,) and 0.45 < m.float().mean().item() < 0.55
    assert not torch.equal(g.get_state(), state)
    again = prob_mask_like((4000,), 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(m, again)
    assert 0.2 < prob_mask_like((4000,), 0.25).float().mean().item() < 0.3  # torch's global generator


@pytest.mark.parametrize("compat", [True, False])
def test_prenorm_matches(compat):
    """Fixed: ``fn(norm(x), *args, **kwargs)``; compat: ``fn(x)``, everything else dropped."""
    class JFn(nnx.Module):
        def __call__(self, x, scale=1.0, shift=0.0):
            return x * scale + shift

    class PFn(torch.nn.Module):
        def forward(self, x, scale=1.0, shift=0.0):
            return x * scale + shift

    jm = jlayers.PreNorm(16, JFn(), rngs=nnx.Rngs(0), reference_compat=compat)
    jm.norm.scale[...] = jnp.linspace(0.5, 1.5, 16)
    jm.norm.bias[...] = jnp.linspace(-0.1, 0.1, 16)
    pm = players.PreNorm(16, PFn(), reference_compat=compat)
    with torch.no_grad():
        pm.norm.weight.copy_(torch.linspace(0.5, 1.5, 16))
        pm.norm.bias.copy_(torch.linspace(-0.1, 0.1, 16))
    x = seeded((3, 5, 16), 1) + 2.0
    want = np.asarray(jm(jnp.asarray(x), 2.0, shift=0.5))
    got = pm(torch.from_numpy(x), 2.0, shift=0.5).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert (np.abs(got - x).max() < 1e-6) == compat
    assert set(dict(pm.named_parameters())) == {"norm.weight", "norm.bias"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_spatial_linear_attention_module_matches(dtype):
    """Fixed SLA multiplies the softmaxed q by D ** -0.5 before the cast."""
    jdt, pdt, atol = {"float32": (None, None, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}[dtype]
    jm = jatt.SpatialLinearAttention(16, heads=4, D=8, rngs=nnx.Rngs(0), dtype=jdt, reference_compat=False)
    pm = _load(patt.SpatialLinearAttention(16, heads=4, D=8, dtype=pdt, reference_compat=False), jm)
    compat = _load(patt.SpatialLinearAttention(16, heads=4, D=8, dtype=pdt), jm)
    x = seeded((2, 3, 4, 4, 16), 1, 0.5)
    want = np.asarray(jm(jnp.asarray(x, jdt or jnp.float32)), np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(x).to(pdt or torch.float32)
        got, other = pm(xt).float().numpy(), compat(xt).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert pm.scale == 8 ** -0.5
    np.testing.assert_allclose(got, other * 8 ** -0.5, atol=atol, rtol=0)  # the scale is linear in the output


MASKS = {"none": None, "live": [True, False], "none_masked": [False, False], "all_masked": [True, True]}


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_multihead_attention_with_mask_and_bias_matches(compat, with_bias, mask):
    """Fixed: bias then mask on the logits; compat: both after the softmax (the reference's quirks,
    reachable only by a direct caller); all masked: the output projection of v."""
    jm = jatt.MultiheadAttention(in_features=16, dim=8, num_heads=4, rngs=nnx.Rngs(0), reference_compat=compat)
    pm = _load(patt.MultiheadAttention(16, 8, 4, reference_compat=compat), jm)
    x = seeded((2, 6, 10, 16), 1, 0.5)
    bias = seeded((4, 10, 10), 2, 0.5) if with_bias else None
    m = MASKS[mask]
    want = np.asarray(jm(jnp.asarray(x), focus_present_mask=None if m is None else jnp.asarray(m),
                         pos_bias=None if bias is None else jnp.asarray(bias)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), focus_present_mask=None if m is None else torch.tensor(m),
                 pos_bias=None if bias is None else torch.from_numpy(bias)).numpy()
    if compat and mask == "live":
        # The compat quirk leaves the masked sample's off-diagonal weights at the most negative float:
        # its output overflows on both sides. Compare the untouched sample.
        np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)
        assert not np.isfinite(got[0]).any() and not np.isfinite(want[0]).any()
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if mask == "all_masked":
        with torch.no_grad():
            v_only = pm.out(pm.v(torch.from_numpy(x))).numpy()
        np.testing.assert_array_equal(got, v_only)


def test_fixed_attention_with_a_masked_sample_equals_its_v_projection():
    """A masked sample's rows keep only their diagonal logit: its output is out(v), whatever the bias."""
    pm = patt.MultiheadAttention(16, 8, 4, reference_compat=False)
    for lin in (pm.q, pm.k, pm.v, pm.out):
        lin.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(seeded((2, 6, 10, 16), 1, 0.5))
    with torch.no_grad():
        got = pm(x, focus_present_mask=torch.tensor([True, False]), pos_bias=torch.from_numpy(seeded((4, 10, 10), 2)))
        np.testing.assert_allclose(got[0].numpy(), pm.out(pm.v(x[0])).numpy(), atol=2e-6, rtol=0)


# ---- the Unet3D ----

def _perturb(jax_module, seed: int = 3) -> None:
    """Every bias and norm scale drawn away from its 0 / 1 start, so that each is live in the comparison."""
    rng = np.random.default_rng(seed)
    for path, var in nnx.to_flat_state(nnx.state(jax_module, nnx.Param)):
        shape = var.get_value().shape
        if path[-1] == "bias":
            var.set_value(jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32))
        elif path[-1] == "scale":
            var.set_value(jnp.asarray(1.0 + rng.standard_normal(shape) * 0.1, jnp.float32))


def _unets(dim_mults=(1, 2), policy: str = "float32", **kw):
    """The JAX fixed-math Unet3D and the port's with its weights converted; ``policy`` is the compute type."""
    base = dict(dim=8, dim_mults=dim_mults, channels=1, attn_heads=HEADS, reference_compat=False)
    bf16 = policy == "bfloat16"
    jax_unet = JaxUnet3D(rngs=nnx.Rngs(0), compute_dtype=jnp.bfloat16 if bf16 else None, **base, **kw)
    _perturb(jax_unet)
    port = Unet3D(compute_dtype="bfloat16" if bf16 else None, **base, **kw)
    _, state = nnx.split(jax_unet)
    port.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), port))
    return jax_unet, port


FUSED = dict(use_fused_attention=True, use_fused_spatial_attention=True)


def _record_dtypes(monkeypatch, module, names, seen):
    for name in names:
        inner = getattr(module, name)

        def wrapped(x, *a, _inner=inner, _name=name, **k):
            seen.append((_name, str(x.dtype)))
            return _inner(x, *a, **k)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("frames", [4, 66])
def test_fixed_unet_forward_matches_jax(monkeypatch, fused, frames, policy):
    """Module route and fused route; 4 frames take the dense biased op, 66 the blockwise one. Under the
    bf16 policy every fused op receives float32 on both sides (the PreNorm's LayerNorm promotes)."""
    size = 8 if frames == 4 else 4
    jax_unet, port = _unets(policy=policy, **(FUSED if fused else {}))
    seen_p, seen_j = [], []
    names = ("fused_temporal_attention_block", "fused_temporal_attention_block_biased")
    _record_dtypes(monkeypatch, pta, names, seen_p)
    _record_dtypes(monkeypatch, psla, ("fused_spatial_linear_attention_block",), seen_p)
    _record_dtypes(monkeypatch, jta, names, seen_j)
    _record_dtypes(monkeypatch, jsla, ("fused_spatial_linear_attention_block",), seen_j)
    x = seeded((2, 1, frames, size, size), 2)
    t = np.array([3, 7], np.int32)
    want = np.asarray(jax_unet(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, frames, size, size, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 if policy == "float32" else 0.05, rtol=0)
    if fused:
        # init, two down levels, the middle, two up levels: six biased ops; the bottleneck's unbiased one; four spatial.
        assert sorted(n for n, _ in seen_p) == sorted(n for n, _ in seen_j)
        assert [n for n, _ in seen_p].count("fused_temporal_attention_block_biased") == 6
        assert [n for n, _ in seen_p].count("fused_temporal_attention_block") == 1
        assert [n for n, _ in seen_p].count("fused_spatial_linear_attention_block") == 4
        assert {d for _, d in seen_p} == {"torch.float32"} and {d for _, d in seen_j} == {"float32"}
    else:
        assert not seen_p and not seen_j


def _jax_unet_grads(jax_unet, x, t, **call):
    graphdef, state = nnx.split(jax_unet)
    return jax.value_and_grad(
        lambda st: jnp.sum(nnx.merge(graphdef, st)(jnp.asarray(x), jnp.asarray(t), **call) ** 2))(state)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_fixed_unet_gradients_match_jax(fused, policy):
    """sum(out^2) and every parameter's gradient; the bias table and every PreNorm norm are live."""
    f32 = policy == "float32"
    jax_unet, port = _unets(policy=policy, **(FUSED if fused else {}))
    x, t = seeded((2, 1, 4, 8, 8), 2), np.array([3, 7], np.int32)
    want, grads = _jax_unet_grads(jax_unet, x, t)
    loss = port(torch.from_numpy(x), torch.from_numpy(t).long()).square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5 if f32 else 0.02)
    want_grads = state_dict_from_nnx(flat_nnx_state(grads), port)
    live = {k: p.grad for k, p in port.named_parameters() if p.grad is not None}
    # Fixed math leaves one norm unused: the final block has no time embedding for its norm_1.
    assert set(dict(port.named_parameters())) - set(live) == UNUSED
    table = "time_rel_pos_bias.relative_attention_bias.weight"
    norms = [k for k in live if ".fn.norm." in k]
    assert len(norms) == 2 * 11 and all(live[k].abs().max() > 0 for k in [table, *norms])
    largest = max(g.abs().max().item() for g in want_grads.values())
    for k, g in live.items():
        w = want_grads[k]
        if f32:
            # 2e-3 of each tensor's largest gradient; a gradient that is zero by construction (a key bias
            # under a softmax) carries rounding noise, held to a thousandth of the largest gradient of all.
            tol = 2e-3 * max(1.0, w.abs().max().item(), 0.5 * largest)
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=2e-3, err_msg=k)
        else:
            denom = max(w.norm().item(), 0.02 * math.sqrt(sum(v.square().sum().item() for v in want_grads.values())))
            assert (g - w).norm().item() / denom <= 0.1, (k, (g - w).norm().item() / denom)


def test_fixed_unet_gradients_fused_route_matches_module_route():
    """Within the port: the fused route's gradients against the module route's, 2e-3 (tests/test_ops.py:417-446)."""
    _, fused = _unets(dim_mults=(1,), **FUSED)
    module = Unet3D(dim=8, dim_mults=(1,), channels=1, attn_heads=HEADS, reference_compat=False)
    module.load_state_dict(fused.state_dict())
    x, t = torch.from_numpy(seeded((1, 1, 4, 8, 8), 2)), torch.tensor([3])
    for net in (fused, module):
        net(x, t).square().sum().backward()
    for (k, a), (_, b) in zip(fused.named_parameters(), module.named_parameters()):
        if k in UNUSED:
            continue
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("frames", [4, 66])
def test_fixed_unet_live_focus_mask_matches_jax(fused, frames):
    """A mixed mask: the masked sample takes the v-projection select on the fused route, the masked
    logits on the module route; output and gradients against JAX with the same mask."""
    jax_unet, port = _unets(**(FUSED if fused else {}))
    size = 8 if frames == 4 else 4
    x, t = seeded((2, 1, frames, size, size), 2), np.array([3, 1], np.int32)
    mask = [True, False]
    want, grads = _jax_unet_grads(jax_unet, x, t, focus_present_mask=jnp.asarray(mask))
    out = port(torch.from_numpy(x), torch.from_numpy(t).long(), focus_present_mask=torch.tensor(mask))
    loss = out.square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)
    want_out = np.asarray(jax_unet(jnp.asarray(x), jnp.asarray(t), focus_present_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-4, rtol=0)
    with torch.no_grad():
        unmasked = port(torch.from_numpy(x), torch.from_numpy(t).long())
    assert (unmasked[0] - out[0]).abs().max().item() > 1e-3  # the mask changes its sample
    if frames == 4:  # over one attended axis the other sample is untouched; GroupNorm is per sample
        np.testing.assert_allclose(unmasked[1].numpy(), out[1].detach().numpy(), atol=1e-5, rtol=0)
    want_grads = state_dict_from_nnx(flat_nnx_state(grads), port)
    largest = max(g.abs().max().item() for g in want_grads.values())
    for k, p in port.named_parameters():
        if k in UNUSED:
            continue
        tol = 2e-3 * max(1.0, want_grads[k].abs().max().item(), 0.5 * largest)
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tol, rtol=2e-3, err_msg=k)


def test_focus_mask_options_of_the_unet():
    """An all-False mask and no mask agree; ``prob_focus_present`` draws its mask from the generator;
    the first temporal attention never sees the mask; compat math ignores mask and probability."""
    _, port = _unets(**FUSED)
    x, t = torch.from_numpy(seeded((2, 1, 4, 8, 8), 2)), torch.tensor([3, 1])
    with torch.no_grad():
        plain = port(x, t)
        torch.testing.assert_close(port(x, t, focus_present_mask=torch.tensor([False, False])), plain, rtol=0, atol=1e-6)
        torch.testing.assert_close(port(x, t, prob_focus_present=0.0), plain, rtol=0, atol=0)
        everything = port(x, t, prob_focus_present=1.0)
        torch.testing.assert_close(everything, port(x, t, focus_present_mask=torch.tensor([True, True])), rtol=0, atol=0)
        assert (everything - plain).abs().max().item() > 1e-3
        g = torch.Generator().manual_seed(5)
        drawn = prob_mask_like((2,), 0.5, torch.Generator().manual_seed(5))
        torch.testing.assert_close(port(x, t, prob_focus_present=0.5, generator=g),
                                   port(x, t, focus_present_mask=drawn), rtol=0, atol=0)
        seen = []
        inner = port._temporal
        port._temporal = lambda block, x, bias, mask: (seen.append(mask is None), inner(block, x, bias, mask))[1]
        port(x, t, focus_present_mask=torch.tensor([True, False]))
        assert seen == [True, False, False, False, False, False]
        compat = Unet3D(dim=8, dim_mults=(1, 2), channels=1, attn_heads=HEADS)
        compat.load_state_dict(port.state_dict())
        torch.testing.assert_close(compat(x, t, focus_present_mask=torch.tensor([True, False]), prob_focus_present=0.5),
                                   compat(x, t), rtol=0, atol=0)


def test_converted_fixture_in_fixed_math_matches_jax():
    """The committed Orbax fixture, read by the JAX loader into a fixed-math model and converted into the
    port's: the PreNorm norms and the bias table are live now, and both forwards agree (1e-4)."""
    results = {}
    for fused in (False, True):
        kw = dict(reference_compat=False, **(FUSED if fused else {}))
        jax_model, _ = jax_load_checkpoint(jax_fixture_model(seed=99, **kw), STEP, str(FIXTURE))
        port = port_model(jax_model, **kw)
        x = seeded((2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE), seed=1)
        t = np.array([2, 8], np.int32)
        want = np.asarray(jax_model.denoise_fn(jnp.asarray(x), jnp.asarray(t)))
        with torch.no_grad():
            got = port.denoise_fn(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        results[fused] = got
    np.testing.assert_allclose(results[True], results[False], atol=1e-4, rtol=0)
    compat = port_model(jax_model)
    with torch.no_grad():
        other = compat.denoise_fn(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert np.abs(other - results[False]).max() > 1e-3  # the same weights, another function


# ---- training ----

def test_three_fixed_math_train_steps_match_jax(tmp_path):
    """From identical converted weights, batches, t and noise: the JAX package's pieces (``p_losses``, frozen
    buffers, clip, ``optax.adam`` over the schedule, gated EMA) against the Trainer, in fixed math by the
    fused route. The bias table and every PreNorm norm get gradients and move on both sides."""
    lr, start, steps, coeff, max_norm, decay = 1e-4, 1, 2, 0.1, 1.0, 0.9
    kw = dict(prediction_type="v", reference_compat=False, **FUSED)
    jm = jax_fixture_model(**kw)
    _perturb(jm)
    pm = port_model(jm, **kw).train()
    init = {k: v.detach().clone().numpy() for k, v in pm.state_dict().items()}
    data = tmp_path / "seq.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(6, 10, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    tr = Trainer(pm, folder=str(tmp_path), dataset_path=str(data), train_batch_size=2,
                 results_folder=str(tmp_path / "results"), tensorboard_dir=str(tmp_path / "tb"),
                 profile_flush_step=0, freeze_schedule_buffers=True, train_num_steps=3, train_lr=lr,
                 lr_decay_start_step=start, lr_decay_steps=steps, lr_decay_coeff=coeff, max_grad_norm=max_norm,
                 step_start_ema=1, update_ema_every=1, ema_decay=decay)

    graphdef, params = nnx.split(jm)
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=lr, boundaries_and_scales={start: 1.0, start + steps: coeff}))
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)

    @jax.jit
    def loss_and_grads(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    shape = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
    rng = np.random.default_rng(7)
    table = "denoise_fn.time_rel_pos_bias.relative_attention_bias.weight"
    for step in range(3):
        x = rng.uniform(size=shape).astype(np.float32)
        t = rng.integers(0, 10, size=2).astype(np.int32)
        noise = seeded(shape, 20 + step)
        loss, grads = loss_and_grads(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
        grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
        j_grads = flat_nnx_state(g_params)
        grads, norm = jgrad.clip_grad_norm(grads, max_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        p_new, _ = nnx.split_state(new, nnx.Param, ...)
        _, rest_old = nnx.split_state(params, nnx.Param, ...)
        params = nnx.merge_state(p_new, rest_old)
        if step >= 1:
            ema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, ema, params)

        p_loss, p_norm = tr.train_step(torch.from_numpy(x), t=torch.from_numpy(t).long(),
                                       noise=torch.from_numpy(noise))
        tr.step += 1
        np.testing.assert_allclose(p_loss.item(), float(loss), atol=1e-4, rtol=0)
        np.testing.assert_allclose(p_norm.item(), float(norm), rtol=2e-4)
        if step == 0:
            moved = {k for k, p in pm.named_parameters() if p.grad is not None}
            assert table in moved and sum(".fn.norm." in k for k in moved) == 2 * 11
            assert set(dict(pm.named_parameters())) - moved == {f"denoise_fn.{k}" for k in UNUSED}

        # A gradient that is zero by construction (a key bias shifts a whole softmax row) carries rounding
        # noise, which Adam's normalisation turns into steps of up to lr: both sides stay within that.
        global_norm = np.sqrt(sum(np.square(g).sum() for g in j_grads.values()))
        noise_only = {torch_key(k) for k, g in j_grads.items() if 0 < np.sqrt(np.square(g).sum()) <= 1e-6 * global_norm}
        assert all(k.endswith(".bias") for k in noise_only)
        for name, tree, got in (("param", params, pm.state_dict()), ("ema", ema, tr.ema_state)):
            want = state_dict_from_nnx(flat_nnx_state(tree), pm)
            for k, w in want.items():
                g = got[k].detach().numpy()
                if k in noise_only:
                    bound = 4 * lr * (step + 1)
                    assert np.abs(g - init[k]).max() <= bound and np.abs(w.numpy() - init[k]).max() <= bound
                    continue
                tol = 1e-4 * max(np.abs(w.numpy()).max(), 1e-12)
                np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=0, err_msg=f"{name} {k} step {step}")
    for k in (table, "denoise_fn.downs.0.3.fn.norm.weight", "denoise_fn.downs.0.2.fn.norm.bias"):
        assert np.abs(pm.state_dict()[k].numpy() - init[k]).max() > 0.5 * lr, k
    assert len(tr.optimizer.state_dict()["state"]) == len(tr.params) - len(UNUSED)  # Adam moments for every live one


def _fixed_config(root, frames: int, **trainer):
    size = 8
    data = root / "clips.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(frames, 4, size, size), dtype=np.uint8))
    cfg = {
        "rng_seed": 0,
        "unet": {"dim": 8, "rngs_seed": 0, "dim_mults": [1, 2], "channels": 1, "attn_heads": HEADS,
                 "compute_dtype": "bfloat16", "use_fused_attention": True, "use_fused_spatial_attention": True,
                 "reference_compat": False, "remat_blocks": frames > 64},
        "diffusion": {"image_size": size, "num_frames": frames, "timesteps": 10, "loss_type": "l2", "channels": 1,
                      "prediction_type": "v"},
        "trainer": {"dataset_path": str(data), "train_batch_size": 2, "train_lr": 1e-3, "train_num_steps": 3,
                    "num_frames": frames, "step_start_ema": 1, "update_ema_every": 1, "max_grad_norm": 1.0,
                    "checkpoint_every_steps": 2, "results_folder": str(root / "results"),
                    "tensorboard_dir": str(root / "tb"), "max_to_keep": 10, "profile_flush_step": 0,
                    "dataset_normalize": True, "save_optimizer_state": True, "freeze_schedule_buffers": True,
                    **trainer},
    }
    path = root / "fixed.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("frames", [6, 66])
def test_fixed_recipe_trains_resumes_and_samples_through_the_clis(tmp_path, frames):
    """``unet.reference_compat: false`` through both CLIs at a tiny size, under the bf16 policy: three steps,
    a resume from step 2, then DDIM and DDPM from the trained file. 6 frames take the dense biased op,
    66 the blockwise one."""
    cfg = _fixed_config(tmp_path, frames)
    tr = train.main(["--config", str(cfg), "--device", "cpu"])
    assert not tr.model.denoise_fn.reference_compat
    losses = tr.loss_trace.tolist()
    assert len(losses) == 3 and all(np.isfinite(losses))
    table = tr.model.denoise_fn.time_rel_pos_bias.relative_attention_bias.weight
    fresh = Unet3D(dim=8, dim_mults=(1, 2), channels=1, attn_heads=HEADS, reference_compat=False)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert (table - fresh.time_rel_pos_bias.relative_attention_bias.weight).abs().max().item() > 1e-4  # it trains
    ckpts = tmp_path / "results" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_2.pt", "step_3.pt"]
    resumed = train.main(["--config", str(cfg), "--device", "cpu", "--resume_step", "2"])
    trace = resumed.loss_trace.tolist()
    assert all(math.isnan(v) for v in trace[:2]) and math.isfinite(trace[2]) and resumed.opt_count == 4
    for sampler, flags in (("ddim", ["--num-steps", "2"]), ("ddpm", [])):
        res = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpts / "step_3.pt"), "--output-path",
                           str(tmp_path / sampler), "--batch-size", "1", "--sampler", sampler, "--device", "cpu", *flags])
        assert tuple(res["videos"].shape) == (1, 1, frames, 8, 8) and bool(torch.isfinite(res["videos"]).all())
        img = Image.open(res["paths"][0])
        assert img.n_frames == frames and img.size == (8, 8)


def test_trainer_trains_with_a_focus_probability(tmp_path):
    """``Trainer.train(prob_focus_present=...)``: masks drawn from the trainer's generator change the losses
    of a fixed-math model and leave a compat model's as they are."""
    traces = {}
    for name, extra in (("fixed", {}), ("compat", {"reference_compat": True})):
        for prob in (0.0, 0.5):
            root = tmp_path / f"{name}_{prob}"
            root.mkdir()
            config = load_config(_fixed_config(root, 6, train_num_steps=2, checkpoint_every_steps=10))
            config["unet"].update(extra)
            _, _, tr = build_trainer(config, device="cpu")
            tr.train(prob_focus_present=prob)
            traces[name, prob] = tr.loss_trace.tolist()
            assert all(np.isfinite(traces[name, prob]))
    assert traces["compat", 0.0] == traces["compat", 0.5]
    assert traces["fixed", 0.0] != traces["fixed", 0.5]


def test_the_two_derived_recipes_build_trainers(tmp_path):
    """configs/config_bouncing_digits.yaml and configs/config_long_clip.yaml with ``unet.reference_compat:
    false`` added (and, for the long clip, the port's two trainer keys): full width and depth."""
    from pathlib import Path

    configs = Path(__file__).resolve().parent.parent / "configs"
    for name, frames, batch in (("config_bouncing_digits.yaml", 10, 8), ("config_long_clip.yaml", 128, 1)):
        config = load_config(configs / name)
        data = tmp_path / f"{frames}.npy"
        np.save(data, np.zeros((frames, 8, 64, 64), np.uint8))
        config["unet"]["reference_compat"] = False
        config["trainer"].update(dataset_path=str(data), results_folder=str(tmp_path / name),
                                 tensorboard_dir=str(tmp_path / name / "tb"), freeze_schedule_buffers=True)
        unet, diffusion, trainer = build_trainer(config, device="cpu")
        assert not unet.reference_compat and unet.use_fused_attention and unet.use_fused_spatial_attention
        assert unet.compute_dtype == torch.bfloat16 and diffusion.num_frames == frames and trainer.batch_size == batch
        prenorms = [m for m in unet.modules() if isinstance(m, players.PreNorm)]
        assert len(prenorms) == 19 and not any(m.reference_compat for m in prenorms)
        assert sum(isinstance(m, patt.MultiheadAttention) and not m.reference_compat for m in unet.modules()) == 11
        assert sum(isinstance(m, patt.SpatialLinearAttention) and not m.reference_compat for m in unet.modules()) == 8
