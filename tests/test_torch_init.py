"""The port's fresh weights against flax's initializers, and the JAX package's test-only ``Linear``, on the CPU.

The flagship Unet3D (configs/config_bouncing_digits.yaml) drawn by ``build_models``: its 150 conv and dense
kernels from ``lecun_normal`` (flax's ``nnx.Linear`` / ``nnx.Conv`` default: a unit normal truncated to [-2, 2],
rescaled to variance 1/fan_in) and its position-bias table from ``nnx.Embed``'s untruncated
``variance_scaling(1, 'fan_in', 'normal')``. Each tensor's std lies within 0.8-1.25x of a draw of the JAX
initializer at the same fan-in and size; every kernel's largest |w| * sqrt(fan_in) is at most 2 / 0.8796 = 2.274.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from video_diffusion_nnx_tpu.models.layers import Linear as JaxLinear
from video_diffusion_nnx_tpu_torch.config import build_models, load_config
from video_diffusion_nnx_tpu_torch.models import layers
from video_diffusion_nnx_tpu_torch.models.layers import UniformLinear

FLAGSHIP = "configs/config_bouncing_digits.yaml"
BOUND = 2.0 / 0.87962566103423978


def _fan_in(m) -> int:
    w = m.weight
    if isinstance(m, layers.Linear):
        return w.shape[1]
    cin = w.shape[0] if isinstance(m, layers.PseudoConvTranspose3d) else w.shape[1]
    return cin * w.shape[2] * w.shape[3]


@pytest.fixture(scope="module")
def flagship():
    from pathlib import Path

    config = load_config(Path(__file__).resolve().parent.parent / FLAGSHIP)
    unet, _ = build_models(config, device="cpu")
    return config, unet


def test_flagship_init_matches_flax_statistics(flagship):
    config, unet = flagship
    kernels = [(name, m.weight.detach(), _fan_in(m)) for name, m in unet.named_modules()
               if isinstance(m, (layers.Linear, layers.PseudoConv3d))]
    tables = [(name, m.weight.detach()) for name, m in unet.named_modules() if isinstance(m, torch.nn.Embedding)]
    assert len(kernels) + len(tables) == 151
    lecun = jax.nn.initializers.lecun_normal()
    embed = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)
    for i, (name, w, fan) in enumerate(kernels):
        want = np.asarray(lecun(jax.random.PRNGKey(i), (fan, w.numel() // fan), jnp.float32))
        assert 0.8 <= w.std().item() / want.std() <= 1.25, name
        assert w.abs().max().item() * math.sqrt(fan) <= BOUND * (1 + 1e-6), name
    for name, w in tables:  # (num_buckets, heads): nnx.Embed's fan-in is the feature axis
        want = np.asarray(embed(jax.random.PRNGKey(0), tuple(w.shape), jnp.float32))
        assert 0.8 <= w.std().item() / want.std() <= 1.25, name
    largest = max(w.abs().max().item() * math.sqrt(fan) for _, w, fan in kernels)
    assert largest > 0.99 * BOUND  # truncated at the bound, not well inside it


def test_same_seed_same_weights(flagship):
    config, unet = flagship
    again, _ = build_models(config, device="cpu")
    other = {**config, "unet": {**config["unet"], "rngs_seed": config["unet"]["rngs_seed"] + 1}}
    third, _ = build_models(other, device="cpu")
    a, b, c = unet.state_dict(), again.state_dict(), third.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["init_conv.weight"], c["init_conv.weight"])


def test_truncated_draw_reads_only_its_generator():
    """The draw consumes the generator it is given and nothing of torch's global stream."""
    torch.manual_seed(0)
    before = torch.get_rng_state()
    w1, w2 = torch.empty(64, 32), torch.empty(64, 32)
    layers._lecun_normal_(w1, 32, torch.Generator().manual_seed(5))
    layers._lecun_normal_(w2, 32, torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), before) and torch.equal(w1, w2)
    z = w1 * math.sqrt(32)
    assert z.abs().max().item() < BOUND and abs(z.std().item() - 1.0) < 0.1


@pytest.mark.parametrize("din,dout", [(3, 5), (16, 4)])
def test_uniform_linear_matches_jax(din, dout):
    """JAX ``models/layers.py:221 Linear``: ``x @ w + b``, w uniform in [0, 1) of shape (din, dout), b zero."""
    jl = JaxLinear(din, dout, rngs=nnx.Rngs(0))
    pl = UniformLinear(din, dout)
    pl.reset_parameters(torch.Generator().manual_seed(0))
    assert tuple(pl.w.shape) == tuple(jl.w.get_value().shape) and not pl.b.any()
    assert 0 <= pl.w.min().item() and pl.w.max().item() < 1
    with torch.no_grad():
        pl.w.copy_(torch.from_numpy(np.asarray(jl.w.get_value())))
        pl.b.copy_(torch.from_numpy(np.asarray(jl.b.get_value())))
    x = np.random.default_rng(1).standard_normal((2, 7, din)).astype(np.float32)
    with torch.no_grad():
        got = pl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl(jnp.asarray(x))), atol=2e-5, rtol=0)
