"""The port's conditioned loss, trainer step and checkpoints against the JAX package's, on the CPU.

The fixture recipe (tests/torch_port_helpers.py) conditioned on 768-wide caption embeddings
(``use_bert_text_cond``, hashed on both sides: no HuggingFace cache is read) or on ``cond_dim`` 16,
with JAX weights converted. The dropout is 0 or 1, where neither package draws; the port's draw
at other rates is checked against its own generator. Tolerances: losses 5e-5; the trainer step as
tests/test_torch_gif_data.py holds the unconditioned one (the norm rtol 1e-4, parameters 1e-4 of
each tensor's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from torch_port_helpers import FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.data import loader as jloader
from video_diffusion_nnx_tpu.data.gif_dataset import GifVideoDataset as JaxGifVideoDataset
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch.convert import load_checkpoint, save_checkpoint, state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.models import text
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer
from video_diffusion_nnx_tpu_torch.utils import media

KINDS = {"cond16": {"cond_dim": 16}, "bert": {"use_bert_text_cond": True}}
CAPTIONS = ["one digit", "two digits"]


@pytest.fixture(autouse=True)
def hashed(monkeypatch):
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)


@pytest.mark.parametrize("null_cond_prob", [0.0, 1.0])
def test_p_losses_with_captions_matches_jax(null_cond_prob):
    kw = KINDS["bert"]
    jm = jax_fixture_model(prediction_type="v", **kw)
    pm = port_model(jm, prediction_type="v", **kw)
    x0, noise = seeded((2, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 1), seeded((2, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 2)
    t = np.array([2, 9], np.int32)
    want = jm.p_losses(jnp.asarray(x0), jnp.asarray(t), jax.random.PRNGKey(0), cond=CAPTIONS,
                       noise=jnp.asarray(noise), null_cond_prob=null_cond_prob)
    with torch.no_grad():
        got = pm.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
                          cond=CAPTIONS, null_cond_prob=null_cond_prob)
        embedded = pm.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
                               cond=torch.from_numpy(text.embed_captions(CAPTIONS)), null_cond_prob=null_cond_prob)
    np.testing.assert_allclose(got.item(), float(want), atol=5e-5, rtol=0)
    assert got.item() == embedded.item()


@pytest.fixture(scope="module")
def captioned_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("captioned")
    rng = np.random.default_rng(6)
    for name in ("one digit 0", "two digits 1", "three digits 2", "one digit 3", "two digits 4"):
        media.video_array_to_gif(rng.integers(0, 256, size=(FRAMES, 20, 20, 1), dtype=np.uint8),
                                 folder / f"{name}.gif", optimize=False)
    return folder


@pytest.mark.parametrize("null_cond_prob", [0.0, 1.0])
def test_a_captioned_train_step_matches_jax(captioned_folder, tmp_path, null_cond_prob):
    """A step of the trainer from a captioned GIF folder against the JAX pieces: the batch and its embeddings
    bit-equal to the JAX loader's, then the loss, the gradient norm and every parameter after Adam."""
    lr, max_norm = 1e-4, 1.0
    kw = KINDS["bert"]
    jm = jax_fixture_model(prediction_type="v", **kw)
    pm = port_model(jm, prediction_type="v", **kw).train()
    tr = Trainer(pm, folder=str(tmp_path), dataset_path=str(captioned_folder), train_batch_size=2,
                 results_folder=str(tmp_path / "results"), tensorboard_dir=str(tmp_path / "tb"),
                 profile_flush_step=0, freeze_schedule_buffers=True, train_num_steps=1, train_lr=lr,
                 max_grad_norm=max_norm, rng_seed=5, use_path_as_cond=True, null_cond_prob=null_cond_prob,
                 sample_text="two digits", cond_scale=3.0)
    assert tr.sample_text == "two digits" and tr.cond_scale == 3.0
    batch, cond = next(tr.dl)
    ref_ds = JaxGifVideoDataset(str(captioned_folder), image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES,
                                use_path_as_cond=True)
    want_batch, want_cond = next(iter(jloader.DataLoader(ref_ds, batch_size=2, seed=5,
                                                         collate_fn=jloader.collate_with_text_cond)))
    np.testing.assert_array_equal(batch.numpy(), want_batch)
    np.testing.assert_array_equal(cond.numpy(), want_cond)

    graphdef, params = nnx.split(jm)
    tx = optax.adam(lr)
    t = np.array([3, 7], np.int32)
    noise = seeded(batch.shape, 21)

    def loss_fn(p):
        return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(jnp.asarray(want_batch)), jnp.asarray(t),
                                               jax.random.PRNGKey(0), cond=jnp.asarray(want_cond),
                                               noise=jnp.asarray(noise), null_cond_prob=null_cond_prob)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
    grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
    grads, norm = jgrad.clip_grad_norm(grads, max_norm)
    updates, _ = tx.update(grads, tx.init(params), params)
    p_new, _ = nnx.split_state(optax.apply_updates(params, updates), nnx.Param, ...)
    _, rest = nnx.split_state(params, nnx.Param, ...)
    want = state_dict_from_nnx(flat_nnx_state(nnx.merge_state(p_new, rest)), pm)

    init = {k: v.detach().clone() for k, v in pm.state_dict().items()}
    p_loss, p_norm = tr.train_step((batch, cond), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(p_loss.item(), float(loss), atol=5e-5, rtol=0)
    np.testing.assert_allclose(p_norm.item(), float(norm), rtol=1e-4)
    for k, w in want.items():
        g = pm.state_dict()[k]
        tol = max(1e-4 * w.abs().max().item(), 2 * lr if (w - init[k]).abs().max().item() <= 1.5 * lr else 0.0)
        assert (g - w).abs().max().item() <= tol, k
    moved = (pm.denoise_fn.null_cond_emb - init["denoise_fn.null_cond_emb"]).abs().max().item()
    assert (moved > 0) == (null_cond_prob == 1.0)  # only dropped rows train the null embedding


def test_the_trainer_draws_the_dropout_from_its_generator(captioned_folder, tmp_path):
    """With t and noise injected, a step's one draw is the (b,) dropout uniform, from the trainer's generator."""
    kw = KINDS["cond16"]
    pm = port_model(jax_fixture_model(**kw), **kw).train()
    tr = Trainer(pm, folder=str(tmp_path), dataset_path=str(captioned_folder), train_batch_size=2,
                 results_folder=str(tmp_path / "results"), tensorboard_dir=str(tmp_path / "tb"),
                 profile_flush_step=0, freeze_schedule_buffers=True, train_num_steps=1, rng_seed=5,
                 use_path_as_cond=True, null_cond_prob=0.2)
    x = torch.from_numpy(seeded((2, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 1)).clamp(0, 1)
    replay = torch.Generator().manual_seed(5)
    torch.rand((2,), generator=replay)
    tr.train_step((x, torch.from_numpy(seeded((2, 16), 2))), t=torch.tensor([1, 2]), noise=torch.zeros_like(x))
    assert torch.equal(tr.generator.get_state(), replay.get_state())


def test_use_path_as_cond_needs_a_gif_folder(tmp_path):
    path = tmp_path / "seq.npy"
    np.save(path, np.zeros((6, 4, IMAGE_SIZE, IMAGE_SIZE), np.uint8))
    pm = port_model(jax_fixture_model(**KINDS["bert"]), **KINDS["bert"])
    with pytest.raises(ValueError, match="must be a folder of GIFs"):
        Trainer(pm, folder=str(tmp_path), dataset_path=str(path), train_batch_size=2, profile_flush_step=0,
                results_folder=str(tmp_path / "r"), tensorboard_dir=str(tmp_path / "tb"), use_path_as_cond=True)


def test_conditioned_checkpoint_round_trips_with_the_ema(tmp_path):
    """A conditioned JAX state converts, and the port's checkpoint file carries it with the EMA."""
    kw = KINDS["cond16"]
    pm = port_model(jax_fixture_model(**kw), **kw)
    ema = {k: v + 1 if v.is_floating_point() else v for k, v in pm.state_dict().items()}
    path = save_checkpoint(tmp_path / "step_1.pt", pm, ema, step=1)
    fresh = port_model(jax_fixture_model(seed=3, **kw), **kw)
    with torch.no_grad():
        fresh.denoise_fn.null_cond_emb.zero_()
    load_checkpoint(fresh, path)
    assert torch.equal(fresh.denoise_fn.null_cond_emb, pm.denoise_fn.null_cond_emb)
    load_checkpoint(fresh, path, load_ema_params=True)
    assert torch.equal(fresh.denoise_fn.null_cond_emb, pm.denoise_fn.null_cond_emb + 1)
