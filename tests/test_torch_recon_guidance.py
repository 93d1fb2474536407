"""Reconstruction-guided frame-conditional sampling (DDIM, w_r > 0) against the JAX package's.

The draws of the JAX key chain are injected into the port as in
tests/test_torch_cond_frames.py. Tolerance 2e-4 * (1 + w_r): the gradient's
float32 bound of 2e-4 enters the x0 update scaled by at most w_r.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_cond_frames import MASK, TOL, _assert_pinned, _draws, _run_both
from torch_port_helpers import jax_fixture_model, port_model


@pytest.fixture(scope="module", params=["noise", "v"])
def models(request):
    jax_model = jax_fixture_model(prediction_type=request.param)
    return jax_model, port_model(jax_model, prediction_type=request.param)


def test_reconstruction_guidance_matches(models):
    jm, pm = models
    wr = 2.0
    known, got, want = _run_both(jm, pm, num_steps=3, wr=wr)
    np.testing.assert_allclose(got, want, atol=TOL * (1 + wr), rtol=0)
    _assert_pinned(known, got)
    # The guidance moved the unpinned frames (against the same draws unguided), and left the weights as they were.
    init, _, mix_noise = _draws(jax.random.PRNGKey(3), 3, ddpm=False)
    unguided = pm.sample_conditional_frames(torch.from_numpy(known), MASK, num_steps=3, init_noise=init,
                                            mix_noise=mix_noise).numpy()
    assert np.abs(got - unguided)[:, :, ~MASK].max() > 1e-4
    assert all(p.requires_grad for p in pm.denoise_fn.parameters())
