"""The port's samplers with text and classifier-free guidance against the JAX package's, on the CPU.

The fixture recipe conditioned on 768-wide caption embeddings (``use_bert_text_cond``, the hashed
embedding on both sides), v-prediction, JAX weights converted. The captions go in as strings to
both packages (each embeds them itself), and the draws of the JAX key chain are injected into the
port: x_T (``init_noise``), DDPM's per-step noise (``key, step_key = split(key)``) and the pinned
frames' noise of ``sample_conditional_frames`` (tests/test_torch_cond_frames.py). Tolerance 2e-4
over the fixture's chains, ``2e-4 * (1 + w_r)`` with reconstruction guidance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cond_frames import MASK, _assert_pinned, _draws, _known
from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, TIMESTEPS, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu_torch.models import text

SHAPE = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
CAPTIONS = ["one digit", "three digits"]
TOL = 2e-4


@pytest.fixture(autouse=True)
def hashed(monkeypatch):
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)


@pytest.fixture(scope="module")
def models():
    kw = {"use_bert_text_cond": True}
    jm = jax_fixture_model(prediction_type="v", **kw)
    return jm, port_model(jm, prediction_type="v", **kw)


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_ddim_with_text_matches(models, cond_scale):
    jm, pm = models
    x_T = seeded(SHAPE, 5)
    want = jm.ddim_sample(jax.random.PRNGKey(0), cond=CAPTIONS, cond_scale=cond_scale, num_steps=3,
                          init_noise=jnp.asarray(x_T))
    got = pm.ddim_sample(num_steps=3, init_noise=torch.from_numpy(x_T), cond=CAPTIONS, cond_scale=cond_scale)
    assert tuple(got.shape) == SHAPE  # the batch size comes from the captions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_guidance_changes_the_samples(models):
    _, pm = models
    x_T = torch.from_numpy(seeded(SHAPE, 5))
    runs = [pm.ddim_sample(num_steps=3, init_noise=x_T, cond=CAPTIONS, cond_scale=s) for s in (1.0, 3.0)]
    assert not torch.equal(runs[0], runs[1])
    # Each row is a function of its own x_T and caption: swapping the captions of two rows with their x_T swaps them.
    swapped = pm.ddim_sample(num_steps=3, init_noise=x_T.flip(0), cond=CAPTIONS[::-1], cond_scale=3.0)
    torch.testing.assert_close(swapped, runs[1].flip(0), rtol=0, atol=1e-6)


def test_ddpm_with_text_matches(models):
    """``sample`` (the T-step chain): ``key, init_key = split(key)``, then per step ``key, step_key = split(key)``."""
    jm, pm = models
    key = jax.random.PRNGKey(4)
    want = jm.sample(key, cond=CAPTIONS, cond_scale=3.0)
    key, init_key = jax.random.split(key)
    init = torch.tensor(np.asarray(jax.random.normal(init_key, SHAPE)))
    steps = []
    for _ in range(TIMESTEPS):
        key, step_key = jax.random.split(key)
        steps.append(torch.tensor(np.asarray(jax.random.normal(step_key, SHAPE, jnp.float32))))
    got = pm.sample(cond=CAPTIONS, cond_scale=3.0, init_noise=init, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_dpm_with_text_matches(models):
    jm, pm = models
    x_T = seeded(SHAPE, 6)
    want = jm.dpm_solver_sample(jax.random.PRNGKey(0), cond=CAPTIONS, cond_scale=3.0, num_steps=4,
                                init_noise=jnp.asarray(x_T))
    got = pm.dpm_solver_sample(num_steps=4, init_noise=torch.from_numpy(x_T), cond=CAPTIONS, cond_scale=3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("wr", [0.0, 2.0])
def test_conditional_frames_with_text_match(models, wr):
    """DDIM replacement conditioning with text and guidance, with and without reconstruction guidance (its eager
    backward runs through the doubled batch)."""
    jm, pm = models
    known = _known()
    key = jax.random.PRNGKey(3)
    want = jm.sample_conditional_frames(key, jnp.asarray(known), jnp.asarray(MASK), cond=CAPTIONS, cond_scale=3.0,
                                        num_steps=3, recon_guidance_weight=wr)
    init, _, mix_noise = _draws(key, 3, ddpm=False)
    got = pm.sample_conditional_frames(torch.from_numpy(known), MASK, num_steps=3, recon_guidance_weight=wr,
                                       init_noise=init, mix_noise=mix_noise, cond=CAPTIONS, cond_scale=3.0).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL * (1 + wr), rtol=0)
    _assert_pinned(known, got)
    assert all(p.requires_grad for p in pm.denoise_fn.parameters())


def test_conditioned_samplers_need_the_condition(models):
    _, pm = models
    with pytest.raises(ValueError, match="cond must be passed"):
        pm.ddim_sample(batch_size=2, num_steps=2, generator=torch.Generator().manual_seed(0))
    out = pm.ddim_sample(num_steps=2, generator=torch.Generator().manual_seed(0),
                         cond=torch.from_numpy(text.embed_captions(CAPTIONS)), cond_scale=2.0)
    assert tuple(out.shape) == SHAPE and bool(torch.isfinite(out).all())
