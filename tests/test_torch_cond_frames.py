"""The port's frame-conditional sampling against the JAX package's ``sample_conditional_frames``.

Both paths (the T-step DDPM chain and DDIM on either grid), with the draws
of the JAX key chain injected into the port: ``key, init_key = split(key)``
for x_T, then per DDPM step ``key, step_key, mix_key = split(key, 3)`` and per
DDIM step ``key, mix_key = split(key)``. Tolerance: 2e-4 over the fixture's
chains (tests/test_torch_diffusion.py). Reconstruction guidance is in
tests/test_torch_recon_guidance.py (one file each keeps both near a minute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, TIMESTEPS, jax_fixture_model, port_model, seeded

SHAPE = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
MASK = np.array([True, False, False, True])  # pin the first and last frame, infill the middle
TOL = 2e-4


@pytest.fixture(scope="module", params=["noise", "v"])
def models(request):
    jax_model = jax_fixture_model(prediction_type=request.param)
    return jax_model, port_model(jax_model, prediction_type=request.param)


def _known():
    return np.clip(seeded(SHAPE, 21, 0.3) + 0.5, 0.0, 1.0)


def _draws(key, steps: int, ddpm: bool):
    """x_T, then each step's (step noise, mix noise) of the JAX key chain."""
    key, init_key = jax.random.split(key)
    init = np.asarray(jax.random.normal(init_key, SHAPE))
    step_noise, mix_noise = [], []
    for _ in range(steps):
        if ddpm:
            key, step_key, mix_key = jax.random.split(key, 3)
            step_noise.append(torch.tensor(np.asarray(jax.random.normal(step_key, SHAPE, jnp.float32))))
        else:
            key, mix_key = jax.random.split(key)
        mix_noise.append(torch.tensor(np.asarray(jax.random.normal(mix_key, SHAPE))))
    return torch.tensor(init), step_noise or None, mix_noise


def _run_both(jm, pm, num_steps=None, grid="linspace", wr=0.0, seed=3):
    known = _known()
    key = jax.random.PRNGKey(seed)
    want = jm.sample_conditional_frames(key, jnp.asarray(known), jnp.asarray(MASK), num_steps=num_steps,
                                        grid=grid, recon_guidance_weight=wr)
    init, step_noise, mix_noise = _draws(key, num_steps or TIMESTEPS, ddpm=num_steps is None)
    got = pm.sample_conditional_frames(torch.from_numpy(known), MASK, num_steps=num_steps, grid=grid,
                                       recon_guidance_weight=wr, init_noise=init, step_noise=step_noise,
                                       mix_noise=mix_noise)
    return known, got.numpy(), np.asarray(want)


def _assert_pinned(known: np.ndarray, got: np.ndarray) -> None:
    """The pinned frames come out as given: [0, 1] -> [-1, 1] -> [0, 1], bit for bit."""
    want = ((torch.from_numpy(known) * 2 - 1) + 1) * 0.5
    assert torch.equal(torch.from_numpy(got[:, :, MASK]), want[:, :, MASK])
    np.testing.assert_allclose(got[:, :, MASK], known[:, :, MASK], atol=1.2e-7, rtol=0)


def test_ddpm_path_matches(models):
    jm, pm = models
    known, got, want = _run_both(jm, pm)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    _assert_pinned(known, got)


@pytest.mark.parametrize("grid", ["linspace", "stride"])
def test_ddim_path_matches(models, grid):
    jm, pm = models
    known, got, want = _run_both(jm, pm, num_steps=3, grid=grid)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    _assert_pinned(known, got)


@pytest.mark.parametrize("kwargs,match", [
    ({"recon_guidance_weight": 1.0}, "needs the DDIM path"),
    ({"num_steps": 0}, r"num_steps must be in \[1, 10\]"),
    ({"num_steps": TIMESTEPS + 1}, r"num_steps must be in \[1, 10\]"),
])
def test_validation_errors_as_jax(models, kwargs, match):
    jm, pm = models
    known = _known()
    with pytest.raises(ValueError, match=match):
        jm.sample_conditional_frames(jax.random.PRNGKey(0), jnp.asarray(known), jnp.asarray(MASK), **kwargs)
    with pytest.raises(ValueError, match=match):
        pm.sample_conditional_frames(torch.from_numpy(known), MASK, **kwargs)


def test_known_must_carry_every_frame(models):
    _, pm = models
    with pytest.raises(ValueError, match="known must be"):
        pm.sample_conditional_frames(torch.zeros(2, CHANNELS, FRAMES - 1, IMAGE_SIZE, IMAGE_SIZE), MASK[:-1])


def test_generator_draws_pin_the_known_frames(models):
    _, pm = models
    known = _known()
    for num_steps in (None, 2):
        out = pm.sample_conditional_frames(torch.from_numpy(known), MASK, num_steps=num_steps,
                                           generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(out).all())
        _assert_pinned(known, out.numpy())
