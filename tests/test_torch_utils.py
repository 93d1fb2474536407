"""The port's host-side helpers against the JAX package: schedules, grids, pixels, GIFs, config."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_helpers  # noqa: F401  (caps torch threads)
from video_diffusion_nnx_tpu.diffusion.gaussian_diffusion import sampling_times as jax_times
from video_diffusion_nnx_tpu.utils import image as jax_image
from video_diffusion_nnx_tpu.utils.media import write_sample_gifs as jax_write_gifs
from video_diffusion_nnx_tpu.utils.schedule import ScheduleBuffers as JaxBuffers
from video_diffusion_nnx_tpu.utils.schedule import extract as jax_extract
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import sampling_times
from video_diffusion_nnx_tpu_torch.utils import functional, image
from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs
from video_diffusion_nnx_tpu_torch.utils.schedule import ScheduleBuffers, extract


@pytest.mark.parametrize("timesteps", [10, 17, 257, 1000])
def test_schedule_buffers_bit_equal(timesteps):
    """Every buffer equals the JAX package's bit for bit (tolerance: none)."""
    want = JaxBuffers.create(timesteps)
    got = ScheduleBuffers.create(timesteps)
    for field in dataclasses.fields(JaxBuffers):
        w = np.asarray(getattr(want, field.name))
        g = getattr(got, field.name).numpy()
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=field.name)


def test_extract_matches():
    a = np.linspace(0.0, 1.0, 10, dtype=np.float32)
    t = np.array([0, 9, 4], np.int32)
    want = np.asarray(jax_extract(jnp.asarray(a), jnp.asarray(t), (3, 1, 4, 8, 8)))
    got = extract(torch.from_numpy(a), torch.from_numpy(t).long(), (3, 1, 4, 8, 8)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", ["linspace", "stride"])
@pytest.mark.parametrize("timesteps,steps", [(10, 3), (10, 4), (1000, 50), (1000, 250), (1000, 7)])
def test_sampling_times_match(grid, timesteps, steps):
    want = np.asarray(jax_times(timesteps, steps, grid))
    got = sampling_times(timesteps, steps, grid).numpy()
    np.testing.assert_array_equal(got, want)


def test_functional_and_image_helpers():
    assert functional.exists(0) and not functional.exists(None)
    assert functional.default(None, lambda: 3) == 3 and functional.default(2, 3) == 2
    assert functional.is_odd(7) and not functional.is_odd(4)
    x = np.linspace(-1, 1, 7, dtype=np.float32)
    np.testing.assert_array_equal(image.normalize_img(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_image.normalize_img(jnp.asarray(x))))
    np.testing.assert_array_equal(image.unnormalize_img(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_image.unnormalize_img(jnp.asarray(x))))


def test_gifs_equal_jax_writer(tmp_path):
    """Same global min-max -> uint8 rule, names and frames as the JAX writer."""
    videos = np.random.default_rng(0).standard_normal((2, 1, 5, 8, 8)).astype(np.float32)
    want = jax_write_gifs(videos, tmp_path / "jax")
    got = write_sample_gifs(torch.from_numpy(videos), tmp_path / "port")
    assert [p.name for p in got] == [p.name for p in want] == ["sample_0.gif", "sample_1.gif"]
    for g, w in zip(got, want):
        gi, wi = Image.open(g), Image.open(w)
        assert gi.n_frames == wi.n_frames == 5
        for i in range(5):
            gi.seek(i)
            wi.seek(i)
            np.testing.assert_array_equal(np.asarray(gi.convert("L")), np.asarray(wi.convert("L")))


def test_load_config_matches_jax(tmp_path, caplog):
    from video_diffusion_nnx_tpu.config import load_config as jax_load
    from video_diffusion_nnx_tpu_torch.config import load_config

    path = tmp_path / "c.yaml"
    path.write_text("unet:\n  dim: 8\n  bogus: 1\ndiffusion:\n  timesteps: 10\ntrainer:\n  num_frames: 4\n")
    assert load_config(path) == jax_load(path)
    assert "bogus" in caplog.text


def test_build_models_refuses_dit_and_missing_card():
    from video_diffusion_nnx_tpu_torch.config import build_models

    # arch: dit builds, guidance_embed too (ROADMAP A13)
    unet, _ = build_models({"unet": {"arch": "dit", "dim": 32, "depth": 1, "guidance_embed": True}}, device="cpu")
    assert unet.has_guidance_embed
    if not torch.cuda.is_available():
        for unet in ({"dim": 8, "dim_mults": [1, 2]}, {"arch": "dit", "dim": 8, "depth": 1}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_models({"unet": unet})
