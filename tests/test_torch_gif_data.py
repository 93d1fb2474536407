"""GIF-folder datasets (counterpart of the JAX package's data/gif_dataset.py), on the CPU.

``configs/config_long_clip.yaml`` trains from a folder of GIFs. The port's ``GifVideoDataset`` and its
``utils.media.seek_all_images`` against the JAX package's on the same folders: bit-equal items for one
and three channels, frames padded and cut, frames resized. Then the trainer from a GIF folder: its
first batch bit-equal to the JAX trainer's data pipeline (the JAX ``DataLoader`` over the JAX dataset,
the same seed), and one train step from that batch against the JAX package's step (loss, gradient norm,
every parameter) from converted weights, with injected t and noise. Tolerances as
tests/test_torch_training.py: the loss atol 5e-5, the norm rtol 1e-4, parameters 1e-4 of each tensor's
largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from PIL import Image

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.data.gif_dataset import GifVideoDataset as JaxGifVideoDataset
from video_diffusion_nnx_tpu.data.loader import DataLoader as JaxDataLoader
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu.utils import media as jmedia
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer
from video_diffusion_nnx_tpu_torch.utils import media


def _write_gifs(folder, channels: int, lengths, size: int, seed: int = 0):
    """Seeded noisy clips as GIFs of ``lengths`` frames each, one in a subfolder (the dataset searches recursively)."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        shape = (n, size, size) + ((channels,) if channels > 1 else (1,))
        clip = rng.integers(0, 256, size=shape, dtype=np.uint8)
        target = folder / ("nested" if i == 0 else "") / f"clip_{i}.gif"
        target.parent.mkdir(parents=True, exist_ok=True)
        media.video_array_to_gif(clip, target, optimize=False)
    return folder


@pytest.fixture(scope="module")
def gray_folder(tmp_path_factory):
    return _write_gifs(tmp_path_factory.mktemp("gray"), 1, [FRAMES + 2, FRAMES, FRAMES - 1, FRAMES, FRAMES + 1], 20)


def test_seek_all_images_matches_jax(gray_folder):
    path = gray_folder / "nested" / "clip_0.gif"
    for channels in (1, 2, 3):
        got = [np.asarray(f) for f in media.seek_all_images(Image.open(path), channels=channels)]
        want = [np.asarray(f) for f in jmedia.seek_all_images(Image.open(path), channels=channels)]
        assert len(got) == len(want) == FRAMES + 2
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="channels 4 invalid"):
        next(media.seek_all_images(Image.open(path), channels=4))


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("channels", [1, 3])
def test_gif_items_match_jax(tmp_path, channels, force):
    """Frames resized from 20 to 16 pixels (bilinear), padded or cut to 4 frames unless ``force`` is off."""
    folder = _write_gifs(tmp_path, channels, [FRAMES + 2, FRAMES - 1, FRAMES], 20, seed=channels)
    kw = dict(image_size=IMAGE_SIZE, channels=channels, num_frames=FRAMES, force_num_frames=force)
    port, ref = GifVideoDataset(str(folder), **kw), JaxGifVideoDataset(str(folder), **kw)
    assert len(port) == len(ref) == 3 and [p.name for p in port.paths] == [p.name for p in ref.paths]
    for i in range(3):
        a, b = port[i], ref[i]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.shape[:1] == (channels,) and a.shape[2:] == (IMAGE_SIZE, IMAGE_SIZE)
        np.testing.assert_array_equal(a, b)
    if force:
        assert all(port[i].shape[1] == FRAMES for i in range(3))


def test_gif_dataset_refuses_what_is_not_ported(tmp_path):
    """An empty folder is refused, captioned or not; filename captions are ported (tests/test_torch_text.py)."""
    for captioned in (False, True):
        with pytest.raises(FileNotFoundError, match="no .gif files"):
            GifVideoDataset(str(tmp_path), image_size=IMAGE_SIZE, use_path_as_cond=captioned)


def test_a_train_step_from_a_gif_folder_matches_jax(gray_folder, tmp_path):
    lr, max_norm = 1e-4, 1.0
    jm = jax_fixture_model(prediction_type="v")
    pm = port_model(jm, prediction_type="v").train()
    tr = Trainer(pm, folder=str(tmp_path), dataset_path=str(gray_folder), train_batch_size=2,
                 results_folder=str(tmp_path / "results"), tensorboard_dir=str(tmp_path / "tb"),
                 profile_flush_step=0, freeze_schedule_buffers=True, train_num_steps=1, train_lr=lr,
                 max_grad_norm=max_norm, rng_seed=5)
    assert isinstance(tr.ds, GifVideoDataset) and len(tr.ds) == 5
    batch = next(tr.dl)
    ref_ds = JaxGifVideoDataset(str(gray_folder), image_size=IMAGE_SIZE, channels=CHANNELS, num_frames=FRAMES)
    np.testing.assert_array_equal(batch.numpy(), next(iter(JaxDataLoader(ref_ds, batch_size=2, seed=5))))

    graphdef, params = nnx.split(jm)
    tx = optax.adam(lr)
    t = np.array([3, 7], np.int32)
    noise = seeded(batch.shape, 21)

    def loss_fn(p):
        return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(jnp.asarray(batch.numpy())), jnp.asarray(t),
                                               jax.random.PRNGKey(0), noise=jnp.asarray(noise))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
    grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
    grads, norm = jgrad.clip_grad_norm(grads, max_norm)
    updates, _ = tx.update(grads, tx.init(params), params)
    p_new, _ = nnx.split_state(optax.apply_updates(params, updates), nnx.Param, ...)
    _, rest = nnx.split_state(params, nnx.Param, ...)
    want = state_dict_from_nnx(flat_nnx_state(nnx.merge_state(p_new, rest)), pm)

    init = {k: v.detach().clone() for k, v in pm.state_dict().items()}
    p_loss, p_norm = tr.train_step(batch, t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(p_loss.item(), float(loss), atol=5e-5, rtol=0)
    np.testing.assert_allclose(p_norm.item(), float(norm), rtol=1e-4)
    moved = 0
    for k, w in want.items():
        g = pm.state_dict()[k]
        # Adam's first step moves an element by about lr whatever its gradient: elements whose gradient is
        # rounding noise (a key bias, a conv bias under a one-channel GroupNorm) agree within that step.
        tol = max(1e-4 * w.abs().max().item(), 2 * lr if (w - init[k]).abs().max().item() <= 1.5 * lr else 0.0)
        assert (g - w).abs().max().item() <= tol, k
        moved += bool((g - init[k]).abs().max().item() > 0)
    assert moved > len(want) // 2
