"""The port's Unet3D against the JAX package's at the fixture recipe (seed 7, dim 8, (1, 2), 16x16, 4 frames).

Tolerance: float32 atol 5e-5 on the (b, f, h, w, c) output, for the module
route and for the fused route (the JAX fused route runs its Pallas kernels in
interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch.models import Unet3D


@pytest.mark.parametrize("fused", [False, True])
def test_unet_forward_matches_jax(monkeypatch, fused):
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    flags = dict(use_fused_attention=fused, use_fused_spatial_attention=fused)
    jax_model = jax_fixture_model(**flags)
    port = port_model(jax_model, **flags)
    x = seeded((2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE), seed=3)
    t = np.array([0, 9], np.int32)
    want = np.asarray(jax_model.denoise_fn(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port.denoise_fn(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, FRAMES, IMAGE_SIZE, IMAGE_SIZE, CHANNELS)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_unet_bf16_policy_runs_in_bf16_and_returns_f32():
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16",
                  use_fused_attention=True, use_fused_spatial_attention=True)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    x = torch.from_numpy(seeded((1, 1, 4, 16, 16)))
    with torch.no_grad():
        out = unet(x, torch.tensor([5]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kwargs,item", [
    ({"reference_compat": False}, "A5"),
    ({"cond_dim": 16}, "A10"),
    ({"use_bert_text_cond": True}, "A10"),
    ({"guidance_embed": True}, "A13"),
    ({"sequence_parallel_mesh": object()}, "A15"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        Unet3D(dim=8, dim_mults=(1, 2), channels=1, **kwargs)


def test_focus_mask_raises():
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1)
    x = torch.zeros(1, 1, 4, 16, 16)
    with pytest.raises(NotImplementedError, match="A5"):
        unet(x, torch.tensor([1]), prob_focus_present=0.5)


def test_module_names_follow_the_jax_tree():
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1)
    names = set(unet.state_dict())
    assert "init_temporal_attn.fn.fn.fn.q.weight" in names
    assert "downs.0.2.fn.fn.to_out.weight" in names
    assert "mid_spatial_attn.fn.fn.fn.out.bias" in names
    assert "time_mlp.layers.3.weight" in names
    assert "final_conv.layers.0.norm_1.weight" in names
    assert "ups.0.4.weight" in names and "downs.1.4.weight" not in names
