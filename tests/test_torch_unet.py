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
from video_diffusion_nnx_tpu_torch.models import ResnetBlock, Unet3D
from video_diffusion_nnx_tpu_torch.models.layers import GroupNorm
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup


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
    ({"guidance_embed": True}, "A13"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        Unet3D(dim=8, dim_mults=(1, 2), channels=1, **kwargs)


@pytest.mark.parametrize("kwargs,cond_dim", [({"cond_dim": 16}, 16), ({"use_bert_text_cond": True}, 768)])
def test_conditioning_options_build_a_conditioned_unet(kwargs, cond_dim):
    """``cond_dim`` and ``use_bert_text_cond`` build the conditioned Unet3D (JAX :185-203): a null embedding and every
    ResNet block's time MLP ``time_dim + cond_dim`` wide; it needs its condition, and the null mask selects it."""
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, **kwargs)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    assert unet.has_cond and unet.cond_dim == cond_dim and unet.null_cond_emb.shape == (1, cond_dim)
    blocks = [m for m in unet.modules() if isinstance(m, ResnetBlock) and m.mlp is not None]
    assert len(blocks) == 10 and all(b.mlp.layers[1].weight.shape[1] == 32 + cond_dim for b in blocks)
    x, t = torch.from_numpy(seeded((2, 1, 4, 16, 16))), torch.tensor([1, 5])
    with torch.no_grad(), pytest.raises(ValueError, match="cond must be passed"):
        unet(x, t)
    with torch.no_grad():
        out = unet(x, t, cond=torch.zeros(2, cond_dim), null_cond_mask=torch.tensor([True, False]))
        null = unet(x, t, cond=unet.null_cond_emb.expand(2, -1))
    assert out.shape == (2, 4, 16, 16, 1) and torch.equal(out[0], null[0]) and not torch.equal(out[1], null[1])


def test_sequence_parallel_mesh_is_a_group_in_compat_math_only():
    """A group reaches every GroupNorm; fixed math drops it (JAX ``__init__`` :136); anything else raises."""
    group = SequenceGroup(0, 4, "gloo", torch.device("cpu"))
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, sequence_parallel_mesh=group)
    norms = [m for m in unet.modules() if isinstance(m, GroupNorm)]
    assert unet.sequence_parallel_mesh is group and norms and all(m.sequence_group is group for m in norms)
    unet.sequence_parallel_mesh = None
    assert all(m.sequence_group is None for m in norms)
    fixed = Unet3D(dim=8, dim_mults=(1, 2), channels=1, reference_compat=False, sequence_parallel_mesh=group)
    assert fixed.sequence_parallel_mesh is None
    assert all(m.sequence_group is None for m in fixed.modules() if isinstance(m, GroupNorm))
    with pytest.raises(TypeError, match="SequenceGroup"):
        Unet3D(dim=8, dim_mults=(1, 2), channels=1, sequence_parallel_mesh=object())


def test_module_names_follow_the_jax_tree():
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1)
    names = set(unet.state_dict())
    assert "init_temporal_attn.fn.fn.fn.q.weight" in names
    assert "downs.0.2.fn.fn.to_out.weight" in names
    assert "mid_spatial_attn.fn.fn.fn.out.bias" in names
    assert "time_mlp.layers.3.weight" in names
    assert "final_conv.layers.0.norm_1.weight" in names
    assert "ups.0.4.weight" in names and "downs.1.4.weight" not in names
