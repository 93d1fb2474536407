"""Shared helpers for the tests that hold the PyTorch port against the JAX package."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

torch.set_num_threads(1)  # the suite runs 6 workers on 8 cores

FIXTURE = Path(__file__).parent / "golden" / "ckpt_fixture"
# The fixture recipe of scripts/make_checkpoint_fixture.py.
SEED, DIM, DIM_MULTS, CHANNELS = 7, 8, (1, 2), 1
IMAGE_SIZE, FRAMES, TIMESTEPS, STEP = 16, 4, 10, 1


def flat_nnx_state(state) -> dict[str, np.ndarray]:
    """An nnx.State as ``{"a/b/c": array}`` (the paths of tests/golden/state_tree_v2_2.txt)."""
    out = {}
    for path, v in nnx.to_flat_state(state):
        value = v.get_value() if hasattr(v, "get_value") else v.value
        out["/".join(str(p) for p in path)] = np.asarray(value)
    return out


def jax_fixture_model(seed: int = SEED, prediction_type: str = "noise", **unet_kwargs):
    """The JAX GaussianDiffusion of the fixture recipe."""
    from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu.models import Unet3D

    unet = Unet3D(dim=DIM, rngs=nnx.Rngs(seed), dim_mults=DIM_MULTS, channels=CHANNELS, **unet_kwargs)
    return GaussianDiffusion(
        unet, image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
        timesteps=TIMESTEPS, loss_type="l2", prediction_type=prediction_type,
    )


def port_model(jax_diffusion, prediction_type: str = "noise", **unet_kwargs):
    """The port's GaussianDiffusion of the same recipe, with the JAX model's weights converted."""
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=DIM, dim_mults=DIM_MULTS, channels=CHANNELS, **unet_kwargs)
    diffusion = GaussianDiffusion(
        unet, image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
        timesteps=TIMESTEPS, loss_type="l2", prediction_type=prediction_type,
    )
    _, state = nnx.split(jax_diffusion)
    diffusion.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), diffusion))
    return diffusion.eval()


def seeded(shape, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# Distillation (tests/test_torch_distill*.py, tests/test_torch_guidance.py): the teacher kinds, each a JAX
# GaussianDiffusion and the port's with the same weights. Every bias is drawn nonzero (Adam's first step moves each
# element by about lr whatever its gradient, so a zero tensor would be compared where rounding decides it), the
# DiT's adaLN and output weights at std 0.05 (zero at init, when no attention has a gradient), and the guidance
# embedding's output layer at std 0.05 (a trained embedding).
DISTILL_COND = 16
DIT_ARCH = dict(dim=32, depth=2, channels=CHANNELS, attn_heads=2, attn_dim_head=16, patch_size=4)
DIT_SIZE, DIT_FRAMES = 8, 3


def _draw(var, rng, scale: float = 0.1) -> None:
    var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * scale, jnp.float32))


def distill_models(kind: str, seed: int = 7, perturb_biases: bool = True):
    """``(jax_diffusion, port_diffusion)`` for a teacher ``kind``: "unet" (the fixture Unet3D, v-prediction),
    "dit" (tests/test_torch_dit.py's VideoDiT at 8x8, 3 frames, T = 10, v-prediction), "unet_w" / "dit_w" (each
    conditioned on ``DISTILL_COND``-wide vectors with ``guidance_embed``: stage 2) or "unet_cond" / "dit_cond"
    (conditioned, no embedding: a guidance teacher)."""
    from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxGD
    from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import VideoDiT

    arch, _, extra = kind.partition("_")
    kw = {}
    if extra:
        kw["cond_dim"] = DISTILL_COND
    if extra == "w":
        kw["guidance_embed"] = True
    if arch == "unet":
        jm = jax_fixture_model(seed=seed, prediction_type="v", **kw)
        pm = port_model(jm, prediction_type="v", **kw)
    else:
        unet = JaxVideoDiT(rngs=nnx.Rngs(seed), **DIT_ARCH, **kw)
        rng = np.random.default_rng(seed + 100)
        for lin in [blk.ada for blk in unet.blocks] + [unet.final_ada, unet.final_proj]:
            lin.kernel[...] = jnp.asarray(rng.standard_normal(lin.kernel[...].shape).astype(np.float32) * 0.05)
        dkw = dict(image_size=DIT_SIZE, num_frames=DIT_FRAMES, channels=CHANNELS, timesteps=TIMESTEPS,
                   loss_type="l2", prediction_type="v")
        jm = JaxGD(unet, **dkw)
        pm = GaussianDiffusion(VideoDiT(**DIT_ARCH, **kw), **dkw).eval()
    rng = np.random.default_rng(seed + 200)
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if "guidance_mlp" in path and path[-2] == 3:
            _draw(var, rng, 0.05)
        elif perturb_biases and path[-1] == "bias":
            _draw(var, rng)
    _, state = nnx.split(jm)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), pm))
    return jm, pm


def distill_shape(kind: str, batch: int = 2) -> tuple[int, ...]:
    if kind.startswith("dit"):
        return (batch, CHANNELS, DIT_FRAMES, DIT_SIZE, DIT_SIZE)
    return (batch, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
