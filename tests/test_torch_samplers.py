"""The port's DPM-Solver++(2M) and interpolation against the JAX package's, with injected draws.

The JAX side runs its compiled samplers from a key; the port is handed the
draws of that key chain (x_T, and for ``interpolate`` the forward-noising
pair and each step's noise), reproduced here with ``jax.random``.
Tolerance: 2e-4 after several steps (the Unet's float32 bound of 5e-5 per
forward, compounded over the chain, as in tests/test_torch_diffusion.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, TIMESTEPS, jax_fixture_model, port_model, seeded

SHAPE = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
TOL = 2e-4


@pytest.fixture(scope="module", params=["noise", "v"])
def models(request):
    jax_model = jax_fixture_model(prediction_type=request.param)
    return jax_model, port_model(jax_model, prediction_type=request.param)


@pytest.mark.parametrize("num_steps", [3, 5])
def test_dpm_with_injected_init_noise_matches(models, num_steps):
    jm, pm = models
    x_T = seeded(SHAPE, 5)
    want = jm.dpm_solver_sample(jax.random.PRNGKey(0), batch_size=2, num_steps=num_steps,
                                init_noise=jnp.asarray(x_T))
    got = pm.dpm_solver_sample(batch_size=2, num_steps=num_steps, init_noise=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_dpm_batch_coalescing_equals_solo_runs(models):
    """Each row is a function of its own x_T: the batched run equals the solo runs (JAX
    test_gaussian_diffusion.py:396), which the server's micro-batcher rests on."""
    _, pm = models
    x_T = torch.from_numpy(seeded((3, *SHAPE[1:]), 8))
    both = pm.dpm_solver_sample(batch_size=3, num_steps=5, init_noise=x_T)
    solo = torch.cat([pm.dpm_solver_sample(batch_size=1, num_steps=5, init_noise=x_T[i : i + 1]) for i in range(3)])
    np.testing.assert_allclose(both.numpy(), solo.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_steps", [2, TIMESTEPS])
def test_dpm_final_step_is_finite(models, num_steps):
    """At the last step a_next = 1, so lambda is inf in float32 and the second-order term is NaN: the
    first-order update must take that step (the result is then the clipped x0, inside [0, 1])."""
    _, pm = models
    out = pm.dpm_solver_sample(batch_size=2, num_steps=num_steps, generator=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


class _Oracle(nn.Module):
    """A denoiser that knows the clean target: its noise prediction puts every step exactly on x0."""

    def __init__(self, x0: torch.Tensor, acp: torch.Tensor):
        super().__init__()
        self.x0, self.acp = x0, acp

    def forward_with_cond_scale(self, x, t):
        a = self.acp[t].reshape(-1, 1, 1, 1, 1)
        eps = (x - torch.sqrt(a) * self.x0) / torch.sqrt(1.0 - a)
        return eps.permute(0, 2, 3, 4, 1)


def test_dpm_oracle_denoiser_recovers_x0():
    """Exact x0 predictions: the multistep integrator is exact at every step and lands on x0 (the
    exp(-h), sigma and alpha coefficients and the final sigma = 0 step; JAX test_gaussian_diffusion.py:428)."""
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.utils.image import unnormalize_img

    x0 = torch.tanh(torch.from_numpy(seeded(SHAPE, 4))) * 0.9
    model = GaussianDiffusion(nn.Identity(), image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
                              timesteps=TIMESTEPS, loss_type="l2")
    model.denoise_fn = _Oracle(x0, model.alphas_cumprod)
    for num_steps in (3, TIMESTEPS):
        out = model.dpm_solver_sample(batch_size=2, num_steps=num_steps, generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(out.numpy(), unnormalize_img(x0).numpy(), atol=1e-5, rtol=0)


def _interp_draws(key, t: int):
    """The JAX ``interpolate`` key chain: (key, k1, k2) = split(key, 3), then one split per step."""
    key, k1, k2 = jax.random.split(key, 3)
    q = [np.asarray(jax.random.normal(k, SHAPE)) for k in (k1, k2)]
    steps = []
    for _ in range(t):
        key, step_key = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(step_key, SHAPE, jnp.float32)))
    return q, steps


@pytest.fixture(scope="module")
def noise_models():
    jax_model = jax_fixture_model()
    return jax_model, port_model(jax_model)


@pytest.mark.parametrize("lam", [0.25, 0.75])
def test_interpolate_with_injected_draws_matches(noise_models, lam):
    jm, pm = noise_models
    t = 5
    x1, x2 = seeded(SHAPE, 11), seeded(SHAPE, 12)  # taken as they are, no normalize_img (a JAX quirk)
    key = jax.random.PRNGKey(7)
    want = jm.interpolate(jnp.asarray(x1), jnp.asarray(x2), key, t=t, lam=lam)
    q, steps = _interp_draws(key, t)
    got = pm.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), t=t, lam=lam,
                         q_noise=tuple(torch.tensor(a) for a in q), step_noise=[torch.tensor(a) for a in steps])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_interpolate_validation_as_jax(noise_models):
    _, pm = noise_models
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="same shape"):
        pm.interpolate(x, x[:1])
    with pytest.raises(ValueError, match=r"lambda must be in \[0, 1\]"):
        pm.interpolate(x, x, lam=1.5)
    with pytest.raises(ValueError, match="t must be in"):
        pm.interpolate(x, x, t=TIMESTEPS)


def test_sampler_init_noise_shape_validated(noise_models):
    _, pm = noise_models
    bad = torch.zeros((1, 1, 1, 1, 1))
    for run in (lambda: pm.dpm_solver_sample(batch_size=2, num_steps=3, init_noise=bad),
                lambda: pm.ddim_sample(batch_size=2, num_steps=3, init_noise=bad)):
        with pytest.raises(ValueError, match="init_noise"):
            run()


def test_samplers_draw_from_the_generator_alone(noise_models):
    """Without injections each sampler is a function of the generator's seed."""
    _, pm = noise_models
    x = torch.from_numpy(seeded(SHAPE, 2))
    runs = {
        "dpm": lambda g: pm.dpm_solver_sample(batch_size=2, num_steps=3, generator=g),
        "interpolate": lambda g: pm.interpolate(x, -x, t=3, generator=g),
    }
    for name, run in runs.items():
        a, b = run(torch.Generator().manual_seed(4)), run(torch.Generator().manual_seed(4))
        c = run(torch.Generator().manual_seed(5))
        assert torch.equal(a, b), name
        assert not torch.equal(a, c), name
