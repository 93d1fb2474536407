"""The port's VideoDiT against the JAX package's, on the CPU.

The recipe of tests/test_dit.py: dim 32, depth 2, 2 heads of 16, 1 channel, 3 frames of 8x8, patch 4 (4 patches a
frame), and one case at 36x36 (81 patches, so the spatial attention of the fused route takes the blockwise plain
version). JAX weights come across through ``convert.py``. The adaLN gates and the output projection start at zero,
so each comparison first draws ``ada``, ``final_ada`` and ``final_proj`` at std 0.05 from a numpy seed (as
tests/test_dit.py:243-253 does) on the JAX side, before the conversion. Tolerances (max-abs): forward float32 5e-5,
and 2e-4 between the routes where JAX's own fused and composite routes part by up to that; bf16 forward 0.05;
float32 gradients 2e-4 of max(1, each tensor's largest magnitude); bf16 gradients no further from JAX's float32
gradient than 1.5x JAX's own bf16 distance plus 1% of the norm, per tensor and over the whole gradient.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_helpers import flat_nnx_state, seeded
from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.config import build_models
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.models import VideoDiT, layers
from video_diffusion_nnx_tpu_torch.models.dit import PlainLayerNorm, sincos_1d

B, C, F, H, W = 2, 1, 3, 8, 8
SHAPE = (B, C, F, H, W)
ARCH = dict(dim=32, depth=2, channels=C, attn_heads=2, attn_dim_head=16, patch_size=4)
COND = 16
T = np.array([2, 6], np.int32)


def jax_dit(seed: int = 0, perturb: bool = True, **kw):
    jm = JaxVideoDiT(rngs=nnx.Rngs(seed), **ARCH, **kw)
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for lin in [blk.ada for blk in jm.blocks] + [jm.final_ada, jm.final_proj]:
            lin.kernel[...] = jnp.asarray(rng.standard_normal(lin.kernel[...].shape).astype(np.float32) * 0.05)
    return jm


def port_dit(jm, **kw) -> VideoDiT:
    pm = VideoDiT(**ARCH, **kw)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(nnx.state(jm)), pm))
    return pm


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _p(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() if np.asarray(a).dtype == np.int32 else torch.from_numpy(a)
            for a in arrays]


def _jax_out(jm, x, t=T, **kw):
    return np.asarray(jm(*_j(x, t), **{k: jnp.asarray(v) for k, v in kw.items()}))


def _port_out(pm, x, t=T, **kw):
    with torch.no_grad():
        return pm(*_p(x, t), **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}).numpy()


def test_sincos_table_matches_jax():
    from video_diffusion_nnx_tpu.models.dit import _sincos_1d

    for dim, n in [(32, 4), (33, 81), (2, 5), (3, 1), (384, 64)]:
        got = sincos_1d(dim, n).numpy()
        assert got.shape == (n, dim) and got.dtype == np.float32
        # angles reach n - 1 radians, where float32 holds about 4e-6: the two libraries' sin may part by an ulp
        np.testing.assert_allclose(got, np.asarray(_sincos_1d(dim, n)), atol=1e-5, rtol=0)


def test_plain_layernorm_keeps_the_input_type_and_holds_no_parameter():
    x = torch.from_numpy(seeded((2, 3, 32), 4) * 3 + 1)
    norm = PlainLayerNorm()
    assert not list(norm.parameters())
    want = np.asarray(nnx.LayerNorm(32, use_scale=False, use_bias=False, rngs=nnx.Rngs(0))(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(norm(x).numpy(), want, atol=2e-6, rtol=0)
    xb = x.to(torch.bfloat16)
    got = norm(xb)
    want = nnx.LayerNorm(32, use_scale=False, use_bias=False, rngs=nnx.Rngs(0))(jnp.asarray(x.numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_state_keys_are_the_jax_paths():
    """No parameter for the four kinds of norm, ``null_cond_emb`` without a leaf name, the ``layers`` of a
    Sequential: the converted state fills every key, and every key comes from a JAX path."""
    jm = jax_dit(cond_dim=COND, perturb=False)
    flat = flat_nnx_state(nnx.state(jm))
    pm = VideoDiT(**ARCH, cond_dim=COND)
    assert len(flat) == len(pm.state_dict()) and "null_cond_emb" in flat and "time_mlp/layers/1/kernel" in flat
    sd = state_dict_from_nnx(flat, pm)
    assert sd["blocks.0.attn_spatial.q.weight"].shape == (32, 32) and sd["blocks.1.mlp.layers.2.weight"].shape == (32, 128)
    np.testing.assert_array_equal(sd["blocks.0.attn_temporal.out.weight"].numpy(),
                                  flat["blocks/0/attn_temporal/out/kernel"].reshape(32, 32).T)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
@pytest.mark.parametrize("size", [8, 36])
def test_forward_float32_matches_jax(fused, size):
    """Each port route against JAX's same route at 5e-5, and against JAX's other route at 2e-4."""
    jm = {r: jax_dit(seed=1, use_fused_attention=r) for r in (False, True)}
    pm = port_dit(jm[fused], use_fused_attention=fused)
    x = seeded((B, C, F, size, size), 2)
    got = _port_out(pm, x)
    want = {r: _jax_out(m, x) for r, m in jm.items()}
    assert got.shape == (B, F, size, size, C) and got.dtype == np.float32 and np.abs(want[fused]).max() > 0.1
    np.testing.assert_allclose(got, want[fused], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got, want[not fused], atol=2e-4, rtol=0)


def test_fused_forward_matches_jax_pallas_interpret(monkeypatch):
    """The fused route against JAX's dense Pallas kernel run through the interpreter (both attentions, f = 4 and 3)."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    jm = jax_dit(seed=2, use_fused_attention=True)
    x = seeded(SHAPE, 3)
    np.testing.assert_allclose(_port_out(port_dit(jm, use_fused_attention=True), x), _jax_out(jm, x),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_forward_bf16_matches_jax(fused):
    jm = jax_dit(seed=3, compute_dtype="bfloat16", use_fused_attention=fused)
    pm = port_dit(jm, compute_dtype="bfloat16", use_fused_attention=fused)
    x = seeded(SHAPE, 4)
    got, want = _port_out(pm, x), _jax_out(jm, x)
    assert got.dtype == np.float32 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


def test_attention_sees_float32_under_bf16():
    """The float32 modulation promotes the norms' output: both attentions of every block receive float32, and
    block 0's first norm returns bf16 (flax's parameterless LayerNorm keeps its input's type)."""
    pm = VideoDiT(**ARCH, compute_dtype="bfloat16")
    pm.reset_parameters(torch.Generator().manual_seed(0))
    seen = []
    for blk in pm.blocks:
        for mod in (blk.attn_spatial, blk.attn_temporal, blk.norm_spatial):
            mod.register_forward_hook(lambda m, args, out: seen.append((type(m).__name__, args[0].dtype)))
    with torch.no_grad():
        pm(torch.from_numpy(seeded(SHAPE, 5)), torch.tensor([1, 2]))
    attn = [dt for name, dt in seen if name == "MultiheadAttention"]
    norms = [dt for name, dt in seen if name == "PlainLayerNorm"]
    assert len(attn) == 4 and set(attn) == {torch.float32}
    assert norms == [torch.bfloat16, torch.float32]


def _jax_grads(jm, x, g, **kw):
    graphdef, params = nnx.split(jm)

    def loss(p):
        return jnp.sum(nnx.merge(graphdef, p)(*_j(x, T), **kw) * g)

    return jax.grad(loss)(params)


def _port_grads(pm, x, g) -> dict[str, np.ndarray]:
    pm.zero_grad()
    (pm(*_p(x, T)) * torch.from_numpy(g)).sum().backward()
    return {k: p.grad.numpy() for k, p in pm.named_parameters()}


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
@pytest.mark.parametrize("size", [8, 36])
def test_gradients_float32_match_jax(fused, size):
    jm = jax_dit(seed=4, use_fused_attention=fused)
    pm = port_dit(jm, use_fused_attention=fused)
    x, g = seeded((B, C, F, size, size), 6), seeded((B, F, size, size, C), 7)
    want = state_dict_from_nnx(flat_nnx_state(_jax_grads(jm, jnp.asarray(x), jnp.asarray(g))), pm)
    got = _port_grads(pm, x, g)
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k], w, atol=2e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=k)
    attn = [k for k in got if ".attn_" in k and k.endswith("weight")]
    assert len(attn) == 16 and all(np.abs(got[k]).max() > 0 for k in attn)


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_gradients_bf16_match_jax(fused):
    j32 = jax_dit(seed=5, use_fused_attention=fused)
    j16 = jax_dit(seed=5, use_fused_attention=fused, compute_dtype="bfloat16")
    p16 = port_dit(j16, use_fused_attention=fused, compute_dtype="bfloat16")
    x, g = seeded(SHAPE, 8), seeded((B, F, H, W, C), 9)
    ref = {k: v.numpy() for k, v in
           state_dict_from_nnx(flat_nnx_state(_jax_grads(j32, jnp.asarray(x), jnp.asarray(g))), p16).items()}
    jax16 = {k: v.numpy() for k, v in
             state_dict_from_nnx(flat_nnx_state(_jax_grads(j16, jnp.asarray(x), jnp.asarray(g))), p16).items()}
    got = _port_grads(p16, x, g)
    norm = math.sqrt(sum(np.square(v).sum() for v in ref.values()))

    def dist(a, keys):
        return math.sqrt(sum(np.square(a[k] - ref[k]).sum() for k in keys))

    assert dist(got, ref) <= 1.5 * dist(jax16, ref) + 0.01 * norm
    for k in ref:
        assert dist(got, [k]) <= 1.5 * dist(jax16, [k]) + 0.01 * norm, k


def test_zero_output_at_init():
    """adaLN-Zero and the zero output projection: exactly 0 at init, for a converted and for a fresh model."""
    x = seeded(SHAPE, 10)
    jm = jax_dit(perturb=False)
    fresh = [VideoDiT(**ARCH), VideoDiT(**ARCH, compute_dtype="bfloat16", use_fused_attention=True)]
    for pm in fresh:
        pm.reset_parameters(torch.Generator().manual_seed(3))
    for model in (port_dit(jm), *fresh):
        out = _port_out(model, x)
        assert out.shape == (B, F, H, W, C)
        np.testing.assert_array_equal(out, 0.0)


@pytest.mark.parametrize("mask", [[False, False], [True, False], [True, True]])
@pytest.mark.parametrize("kind", [{"cond_dim": COND}, {"use_bert_text_cond": True}], ids=["cond16", "bert"])
def test_conditioned_forward_matches_jax(kind, mask):
    jm = jax_dit(seed=6, **kind)
    pm = port_dit(jm, **kind)
    x, c = seeded(SHAPE, 11), seeded((B, pm.cond_dim), 12)
    m = np.array(mask)
    np.testing.assert_allclose(_port_out(pm, x, cond=c, null_cond_mask=m),
                               _jax_out(jm, x, cond=c, null_cond_mask=m), atol=5e-5, rtol=0)
    if not any(mask):  # null_cond_prob 0 is no mask; 1 is all masked
        np.testing.assert_array_equal(_port_out(pm, x, cond=c), _port_out(pm, x, cond=c, null_cond_mask=m))
        with torch.no_grad():
            dropped = pm(*_p(x, T), cond=torch.from_numpy(c), null_cond_prob=1.0).numpy()
        np.testing.assert_array_equal(dropped, _port_out(pm, x, cond=c, null_cond_mask=np.ones(B, bool)))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_cfg_batched_equals_two_passes_and_jax(scale):
    jm = jax_dit(seed=7, cond_dim=COND)
    pm = port_dit(jm, cond_dim=COND)
    x, c = seeded(SHAPE, 13), seeded((B, COND), 14)
    with torch.no_grad():
        got = pm.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c), cond_scale=scale).numpy()
    want = np.asarray(jm.forward_with_cond_scale(*_j(x, T), cond=jnp.asarray(c), cond_scale=scale))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    c_out = _port_out(pm, x, cond=c, null_cond_mask=np.zeros(B, bool))
    n_out = _port_out(pm, x, cond=c, null_cond_mask=np.ones(B, bool))
    np.testing.assert_allclose(got, n_out + (c_out - n_out) * scale, atol=1e-5, rtol=0)


def test_cfg_default_scale_and_unconditioned():
    """The DiT's default guidance scale is 2 (JAX :204); an unconditioned model runs one plain forward."""
    jm = jax_dit(seed=8, cond_dim=COND)
    pm = port_dit(jm, cond_dim=COND)
    x, c = seeded(SHAPE, 15), seeded((B, COND), 16)
    with torch.no_grad():
        default = pm.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c))
        two = pm.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c), cond_scale=2.0)
    torch.testing.assert_close(default, two, rtol=0, atol=0)
    plain = port_dit(jax_dit(seed=8))
    with torch.no_grad():
        torch.testing.assert_close(plain.forward_with_cond_scale(*_p(x, T), cond_scale=3.0), plain(*_p(x, T)),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="cond must be passed"):
        pm(*_p(x, T))


def test_any_frame_count_and_size():
    """Positions are computed: one model serves any frame count and any size the patch divides."""
    jm = jax_dit(seed=9)
    pm = port_dit(jm)
    for f, hw in [(1, 8), (5, 16), (2, 12)]:
        x = seeded((1, C, f, hw, hw), f)
        got = _port_out(pm, x, t=np.array([3], np.int32))
        assert got.shape == (1, f, hw, hw, C)
        np.testing.assert_allclose(got, _jax_out(jm, x, t=np.array([3], np.int32)), atol=5e-5, rtol=0)


def test_patch_that_does_not_divide_raises():
    pm = VideoDiT(**ARCH)
    with pytest.raises(ValueError, match="must divide the patch size 4"):
        pm(torch.zeros(B, C, F, 10, 10), torch.zeros(B))


def test_focus_arguments_are_ignored():
    pm = port_dit(jax_dit(seed=10))
    x = seeded(SHAPE, 17)
    with torch.no_grad():
        a = pm(*_p(x, T))
        b = pm(*_p(x, T), focus_present_mask=torch.tensor([True, False]), prob_focus_present=0.5,
               generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_init_matches_flax_statistics():
    """Each drawn kernel's std within 0.8-1.25x of flax's lecun_normal at its fan-in (the ``out`` projection's is
    heads * head_dim), truncated at 2 / 0.8796; biases and the zero linears 0; ``null_cond_emb`` std 0.02."""
    pm = VideoDiT(dim=64, depth=2, channels=1, attn_heads=4, attn_dim_head=16, patch_size=4, cond_dim=64)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    jm = JaxVideoDiT(dim=64, rngs=nnx.Rngs(0), depth=2, channels=1, attn_heads=4, attn_dim_head=16, patch_size=4,
                     cond_dim=64)
    want = state_dict_from_nnx(flat_nnx_state(nnx.state(jm)), pm)
    bound = 2.0 / 0.87962566103423978
    zero = ("ada", "final_ada", "final_proj")
    drawn = 0
    for name, m in pm.named_modules():
        if not isinstance(m, layers.Linear):
            continue
        w, fan = m.weight.detach(), m.weight.shape[1]
        assert not m.bias.any(), name
        if name.split(".")[-1] in zero:
            assert not w.any() and not want[f"{name}.weight"].any(), name
            continue
        drawn += 1
        ratio = w.std().item() / want[f"{name}.weight"].std().item()
        assert 0.8 <= ratio <= 1.25, (name, ratio)
        assert w.abs().max().item() * math.sqrt(fan) <= bound * (1 + 1e-6), name
    assert drawn == 1 + 2 + 1 + 2 * 10  # patch_proj, the time MLP's two, cond_proj, per block 2 x (q k v out) + 2
    assert pm.blocks[0].attn_spatial.out.weight.shape[1] == 4 * 16
    assert 0.015 <= pm.null_cond_emb.std().item() <= 0.025
    again = VideoDiT(dim=64, depth=2, channels=1, attn_heads=4, attn_dim_head=16, patch_size=4, cond_dim=64)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(pm.state_dict().values(), again.state_dict().values()))


def test_build_models_arch_dit_and_bad_arch():
    config = {
        "unet": {"arch": "dit", "dim": 32, "depth": 2, "channels": 1, "attn_heads": 2, "attn_dim_head": 16,
                 "patch_size": 4, "reference_compat": False, "remat_blocks": True, "use_fused_spatial_attention": True},
        "diffusion": {"image_size": 8, "num_frames": 2, "channels": 1, "timesteps": 4},
    }
    unet, diffusion = build_models(config, device="cpu")
    assert isinstance(unet, VideoDiT) and diffusion.denoise_fn is unet and not unet.has_cond
    assert len(unet.blocks) == 2 and unet.blocks[0].attn_spatial.heads == 2 and unet.blocks[0].attn_spatial.dim == 16
    out = diffusion.ddim_sample(batch_size=1, num_steps=2, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 1, 2, 8, 8)
    again, _ = build_models(config, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(), again.state_dict().values()))
    with pytest.raises(ValueError, match="unet.arch must be"):
        build_models({"unet": {"arch": "mamba"}}, device="cpu")


def test_guidance_embed_builds_through_build_models():
    """``guidance_embed`` (ROADMAP A13, JAX :177-184) builds a zero-output ``guidance_mlp``, directly and through
    ``build_models``; JAX parity is in tests/test_torch_guidance_embed.py."""
    pm = VideoDiT(**ARCH, cond_dim=COND, guidance_embed=True)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    assert pm.has_guidance_embed and not pm.guidance_mlp.layers[3].weight.any()
    unet, _ = build_models({"unet": {"arch": "dit", "dim": 32, "depth": 1, "guidance_embed": True}}, device="cpu")
    assert isinstance(unet, VideoDiT) and unet.has_guidance_embed and unet.guidance_mlp.layers[1].weight.std() > 0
