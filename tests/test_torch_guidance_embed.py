"""``guidance_embed`` of the port's Unet3D and VideoDiT against the JAX package's, on the CPU, and the two repairs
that come with it: C6 (the Unet3D's default guidance scale is JAX's 2) and C7 (the samplers and the graph cache pass
and key the scale for a ``guidance_embed`` model, with or without a condition).

The Unet3D is the fixture recipe (tests/torch_port_helpers.py) with ``cond_dim`` 16 or unconditioned; the DiT is
tests/test_torch_dit.py's recipe. JAX weights come across through ``convert.py``, ``guidance_mlp`` among them with its
output layer drawn nonzero first (a trained embedding: at its zero init every w gives the same output). Tolerances
from tests/test_ops.py: float32 forward 5e-5 max-abs (the DiT's 2e-4 between routes is not needed: one route each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_helpers import FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
from video_diffusion_nnx_tpu_torch.config import build_models
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.diffusion.graphs import GraphCache
from video_diffusion_nnx_tpu_torch.models import Unet3D, VideoDiT
from video_diffusion_nnx_tpu_torch.models.layers import ZeroLinear

B, COND = 2, 16
T = np.array([1, 8], np.int32)
WS = (1.0, 3.0, 8.0)
DIT = dict(dim=32, depth=2, channels=1, attn_heads=2, attn_dim_head=16, patch_size=4)


def _train_embedding(jax_unet, seed: int) -> None:
    """Draw the JAX guidance embedding's zero output layer (and its bias) nonzero, as training would."""
    rng = np.random.default_rng(seed)
    out = jax_unet.guidance_mlp.layers[3]
    out.kernel[...] = jnp.asarray(rng.standard_normal(out.kernel[...].shape).astype(np.float32) * 0.05)
    out.bias[...] = jnp.asarray(rng.standard_normal(out.bias[...].shape).astype(np.float32) * 0.05)


def _unet_pair(cond: bool, trained: bool = True, seed: int = 7):
    kw = {"guidance_embed": True, **({"cond_dim": COND} if cond else {})}
    jm = jax_fixture_model(seed=seed, prediction_type="v", **kw)
    if trained:
        _train_embedding(jm.denoise_fn, seed)
    return jm, port_model(jm, prediction_type="v", **kw)


def _inputs(seed: int = 1):
    return seeded((B, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), seed), seeded((B, COND), seed + 1)


def _p(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() if np.asarray(a).dtype == np.int32 else torch.from_numpy(a)
            for a in arrays]


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond16"])
def test_unet_guidance_forward_matches_jax(cond):
    """The forward at several w, per sample and as a constant; ``forward_with_cond_scale`` equal to the forward
    with ``guidance_scale`` filled with the scale (one forward of b rows); no w means w = 1."""
    jm, pm = _unet_pair(cond)
    x, c = _inputs()
    ckw = {"cond": c} if cond else {}
    j = jm.denoise_fn
    with torch.no_grad():
        for w in ([1.0, 1.0], [2.5, 7.0], [8.0, 1.5]):
            w = np.asarray(w, np.float32)
            want = np.asarray(j(*map(jnp.asarray, (x, T)), guidance_scale=jnp.asarray(w),
                                **{k: jnp.asarray(v) for k, v in ckw.items()}))
            got = pm.denoise_fn(*_p(x, T), guidance_scale=torch.from_numpy(w),
                                **{k: torch.from_numpy(v) for k, v in ckw.items()}).numpy()
            np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
        outs = {}
        for scale in WS:
            got = pm.denoise_fn.forward_with_cond_scale(*_p(x, T), cond_scale=scale,
                                                        **{k: torch.from_numpy(v) for k, v in ckw.items()})
            want = np.asarray(j.forward_with_cond_scale(*map(jnp.asarray, (x, T)), cond_scale=scale,
                                                        **{k: jnp.asarray(v) for k, v in ckw.items()}))
            np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
            explicit = pm.denoise_fn(*_p(x, T), guidance_scale=torch.full((B,), scale),
                                     **{k: torch.from_numpy(v) for k, v in ckw.items()})
            torch.testing.assert_close(got, explicit, rtol=0, atol=0)
            outs[scale] = got
        default = pm.denoise_fn(*_p(x, T), **{k: torch.from_numpy(v) for k, v in ckw.items()})
    torch.testing.assert_close(default, outs[1.0], rtol=0, atol=0)
    assert not torch.equal(outs[1.0], outs[3.0]) and not torch.equal(outs[3.0], outs[8.0])


def test_unet_zero_graft_is_the_unguided_teacher():
    """With the output layer at zero (fresh), the grafted student at any w is bit-equal to the teacher's
    ``cond_scale`` 1 forward on the same weights."""
    jt = jax_fixture_model(prediction_type="v", cond_dim=COND)
    teacher = port_model(jt, prediction_type="v", cond_dim=COND)
    student = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=COND, guidance_embed=True)
    student.reset_parameters(torch.Generator().manual_seed(3))
    out_layer = student.guidance_mlp.layers[3]
    assert isinstance(out_layer, ZeroLinear) and not out_layer.weight.any() and not out_layer.bias.any()
    assert student.guidance_mlp.layers[1].weight.std() > 0
    missing = student.load_state_dict(teacher.denoise_fn.state_dict(), strict=False).missing_keys
    assert sorted(missing) == ["guidance_mlp.layers.1.bias", "guidance_mlp.layers.1.weight",
                               "guidance_mlp.layers.3.bias", "guidance_mlp.layers.3.weight"]
    x, c = _p(*_inputs(4))
    t = torch.from_numpy(T).long()
    with torch.no_grad():
        want = teacher.denoise_fn.forward_with_cond_scale(x, t, cond=c, cond_scale=1.0)
        for w in WS:
            torch.testing.assert_close(student.forward_with_cond_scale(x, t, cond=c, cond_scale=w), want,
                                       rtol=0, atol=0)


def test_unet_guidance_mlp_keys_convert_and_draw_last():
    """``guidance_mlp.layers.{1,3}`` take ``denoise_fn/guidance_mlp/layers/{1,3}/*`` with no special case; the
    embedding draws after every other weight, so the rest equals the model without it for one seed."""
    jm = jax_fixture_model(guidance_embed=True, cond_dim=COND)
    flat = flat_nnx_state(nnx.state(jm))
    assert {k for k in flat if "guidance_mlp" in k} == {f"denoise_fn/guidance_mlp/layers/{i}/{leaf}"
                                                        for i in (1, 3) for leaf in ("kernel", "bias")}
    pm = port_model(jm, guidance_embed=True, cond_dim=COND)
    np.testing.assert_array_equal(pm.denoise_fn.guidance_mlp.layers[1].weight.detach().numpy(),
                                  flat["denoise_fn/guidance_mlp/layers/1/kernel"].T)
    a = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=COND, guidance_embed=True)
    b = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=COND)
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(11))
    sb = b.state_dict()
    assert all(torch.equal(v, sb[k]) for k, v in a.state_dict().items() if not k.startswith("guidance_mlp."))
    assert a.guidance_mlp.layers[1].weight.dtype == torch.float32


def test_unet_default_cond_scale_is_two():
    """C6: the default scale is JAX's 2 (JAX ``unet3d.py:315``): a conditioned model's default is its scale-2
    guidance, held against JAX's ``forward_with_cond_scale(x, t, cond=c)`` on converted weights."""
    jm = jax_fixture_model(cond_dim=COND)
    pm = port_model(jm, cond_dim=COND)
    x, c = _inputs(5)
    want = np.asarray(jm.denoise_fn.forward_with_cond_scale(jnp.asarray(x), jnp.asarray(T), cond=jnp.asarray(c)))
    with torch.no_grad():
        got = pm.denoise_fn.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c))
        two = pm.denoise_fn.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c), cond_scale=2.0)
        one = pm.denoise_fn.forward_with_cond_scale(*_p(x, T), cond=torch.from_numpy(c), cond_scale=1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    torch.testing.assert_close(got, two, rtol=0, atol=0)
    assert not torch.equal(got, one)


def _jax_dit(seed: int, **kw):
    jm = JaxVideoDiT(rngs=nnx.Rngs(seed), **DIT, **kw)
    rng = np.random.default_rng(seed + 100)
    for lin in [blk.ada for blk in jm.blocks] + [jm.final_ada, jm.final_proj]:
        lin.kernel[...] = jnp.asarray(rng.standard_normal(lin.kernel[...].shape).astype(np.float32) * 0.05)
    return jm


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond16"])
def test_dit_guidance_forward_matches_jax(cond):
    kw = {"guidance_embed": True, **({"cond_dim": COND} if cond else {})}
    jm = _jax_dit(3, **kw)
    _train_embedding(jm, 3)
    pm = VideoDiT(**DIT, **kw)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(nnx.state(jm)), pm))
    x, c = seeded((B, 1, 3, 8, 8), 6), seeded((B, COND), 7)
    ckw = {"cond": c} if cond else {}
    with torch.no_grad():
        w = np.asarray([2.0, 6.5], np.float32)
        want = np.asarray(jm(jnp.asarray(x), jnp.asarray(T), guidance_scale=jnp.asarray(w),
                             **{k: jnp.asarray(v) for k, v in ckw.items()}))
        got = pm(*_p(x, T), guidance_scale=torch.from_numpy(w), **{k: torch.from_numpy(v) for k, v in ckw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
        for scale in WS:
            got = pm.forward_with_cond_scale(*_p(x, T), cond_scale=scale,
                                             **{k: torch.from_numpy(v) for k, v in ckw.items()})
            want = np.asarray(jm.forward_with_cond_scale(jnp.asarray(x), jnp.asarray(T), cond_scale=scale,
                                                         **{k: jnp.asarray(v) for k, v in ckw.items()}))
            np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
            torch.testing.assert_close(got, pm(*_p(x, T), guidance_scale=torch.full((B,), scale),
                                               **{k: torch.from_numpy(v) for k, v in ckw.items()}), rtol=0, atol=0)


def test_dit_zero_graft_is_the_unguided_teacher():
    jt = _jax_dit(4, cond_dim=COND)
    teacher = VideoDiT(**DIT, cond_dim=COND)
    teacher.load_state_dict(state_dict_from_nnx(flat_nnx_state(nnx.state(jt)), teacher))
    student = VideoDiT(**DIT, cond_dim=COND, guidance_embed=True)
    student.reset_parameters(torch.Generator().manual_seed(2))
    assert not student.guidance_mlp.layers[3].weight.any() and student.guidance_mlp.layers[1].weight.std() > 0
    student.load_state_dict(teacher.state_dict(), strict=False)
    x, c = _p(seeded((B, 1, 3, 8, 8), 8), seeded((B, COND), 9))
    t = torch.from_numpy(T).long()
    with torch.no_grad():
        want = teacher.forward_with_cond_scale(x, t, cond=c, cond_scale=1.0)
        for w in WS:
            torch.testing.assert_close(student.forward_with_cond_scale(x, t, cond=c, cond_scale=w), want,
                                       rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["unet3d", "dit"])
def test_build_models_builds_guidance_embed(arch):
    """``unet.guidance_embed: true`` builds either family (config.py passes it to both constructors)."""
    unet = {"arch": arch, "dim": 32 if arch == "dit" else 8, "dim_mults": [1, 2], "depth": 1, "attn_heads": 2,
            "attn_dim_head": 16, "guidance_embed": True, "cond_dim": COND}
    model, diffusion = build_models({"unet": unet, "diffusion": {"image_size": 8, "num_frames": 2, "channels": 1,
                                                                 "timesteps": 4}}, device="cpu")
    assert model.has_guidance_embed and isinstance(model, VideoDiT if arch == "dit" else Unet3D)
    assert not model.guidance_mlp.layers[3].weight.any()
    out = diffusion.ddim_sample(num_steps=2, generator=torch.Generator().manual_seed(0), cond=torch.zeros(1, COND),
                                cond_scale=3.0)
    assert out.shape == (1, 1, 2, 8, 8)


@pytest.mark.parametrize("cond", [False, True], ids=["uncond", "cond16"])
def test_samplers_pass_the_scale_to_a_guidance_model(cond):
    """C7: every sampler hands a ``guidance_embed`` denoiser its scale, with or without a condition, and matches
    JAX's ``ddim_sample`` and ``dpm_solver_sample`` from the same x_T (2e-4 on [0, 1], as
    tests/test_torch_diffusion.py); the scale changes the samples."""
    jm, pm = _unet_pair(cond, seed=9)
    x_T = seeded((B, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 12)
    c = seeded((B, COND), 13) if cond else None
    ckw_p = {"cond": torch.from_numpy(c)} if cond else {}
    ckw_j = {"cond": jnp.asarray(c)} if cond else {}
    outs = {}
    for scale in (1.0, 4.0):
        got = pm.ddim_sample(batch_size=B, num_steps=3, init_noise=torch.from_numpy(x_T), cond_scale=scale, **ckw_p)
        want = jm.ddim_sample(jax.random.PRNGKey(0), batch_size=B, num_steps=3, eta=0.0,
                              init_noise=jnp.asarray(x_T), cond_scale=scale, **ckw_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
        got = pm.dpm_solver_sample(batch_size=B, num_steps=3, init_noise=torch.from_numpy(x_T), cond_scale=scale,
                                   **ckw_p)
        want = jm.dpm_solver_sample(jax.random.PRNGKey(0), batch_size=B, num_steps=3, init_noise=jnp.asarray(x_T),
                                    cond_scale=scale, **ckw_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
        outs[scale] = got
    assert float((outs[1.0] - outs[4.0]).abs().max()) > 1e-3


def test_graph_cache_keys_the_scale_of_a_guidance_model(monkeypatch):
    """C7 in the graph cache: a ``guidance_embed`` denoiser's graphs are keyed by the scale and captured with it,
    with or without a condition; any other unconditioned denoiser keeps one graph for every scale, captured
    without one. (The capture itself needs a card; here it records its arguments.)"""
    made = []

    class Recorder:
        def __init__(self, denoise_fn, shape, dtype, device, cond_shape=None, cond_scale=None):
            made.append((cond_shape, cond_scale))
            self.replays, self.shape = 0, shape

    monkeypatch.setattr("video_diffusion_nnx_tpu_torch.diffusion.graphs.DenoiserGraph", Recorder)
    x = torch.zeros(B, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
    guided = Unet3D(dim=8, dim_mults=(1, 2), channels=1, guidance_embed=True)
    plain = Unet3D(dim=8, dim_mults=(1, 2), channels=1)
    cache = GraphCache()
    for scale in (1.0, 3.0, 3.0):
        cache.get(guided, x, None, scale)
        cache.get(plain, x, None, scale)
    assert made == [(None, 1.0), (None, None), (None, 3.0)] and cache.captures == 3
    cond_model = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=COND, guidance_embed=True)
    cache.get(cond_model, x, torch.zeros(B, COND), 2.0)
    assert made[-1] == ((B, COND), 2.0)
