"""The port's training pieces against the JAX package's, on the CPU with injected randomness.

Covered: ``p_losses`` and ``forward`` (every target, l1/l2, min-SNR), the
learning-rate schedule, the gradient clip, ``cast_num_frames``, the dataset
and the loader, the options the port leaves out, the checks of a
sequence-parallel recipe, and three whole train steps (loss, gradient norm,
every parameter and EMA tensor) from converted weights, with the schedule
buffers frozen and with full-state Adam. Tolerances: losses float32 atol 5e-5 (the Unet's own bound); the
schedule atol 1e-9; train steps 1e-4 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.data.loader import DataLoader as JaxDataLoader
from video_diffusion_nnx_tpu.data.moving_mnist import MovingMNIST as JaxMovingMNIST
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx, torch_key
from video_diffusion_nnx_tpu_torch.data.loader import DataLoader
from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer, lr_schedule
from video_diffusion_nnx_tpu_torch.utils import grad as pgrad
from video_diffusion_nnx_tpu_torch.utils.image import cast_num_frames

SHAPE = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "seq.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, size=(6, 10, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    return str(path)


@pytest.fixture(scope="module", params=["noise", "v", "x0"])
def models(request):
    jm = jax_fixture_model(prediction_type=request.param)
    return jm, port_model(jm, prediction_type=request.param)


@pytest.mark.parametrize("loss_type,gamma", [("l2", None), ("l2", 5.0), ("l1", None), ("l1", 5.0)])
def test_p_losses_matches(models, loss_type, gamma):
    jm, pm = models
    jm.loss_type = pm.loss_type = loss_type
    jm.min_snr_gamma = pm.min_snr_gamma = gamma
    x0, noise = seeded(SHAPE, 1), seeded(SHAPE, 2)
    t = np.array([2, 9], np.int32)
    want = jm.p_losses(jnp.asarray(x0), jnp.asarray(t), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    with torch.no_grad():
        got = pm.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(want), atol=5e-5, rtol=0)


def test_forward_matches_call_with_jax_timesteps(models):
    """``forward`` normalizes [0, 1] input like ``__call__``; t is the one JAX draws from its key."""
    jm, pm = models
    x = np.random.default_rng(3).uniform(size=SHAPE).astype(np.float32)
    noise = seeded(SHAPE, 4)
    key = jax.random.PRNGKey(5)
    want = jm(jnp.asarray(x), key, noise=jnp.asarray(noise))
    _, t_key, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(t_key, (2,), 0, jm.num_timesteps, dtype=jnp.int32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(want), atol=5e-5, rtol=0)
    with pytest.raises(ValueError, match="shape"):
        pm(torch.zeros(2, CHANNELS, FRAMES + 1, IMAGE_SIZE, IMAGE_SIZE))


def test_v_target_is_detached():
    """The v target is supervision: the gradient reaches x_start through x_noisy only (JAX :966)."""
    pm = port_model(jax_fixture_model(prediction_type="v"), prediction_type="v")
    t, noise = torch.tensor([1, 5]), torch.from_numpy(seeded(SHAPE, 2))
    x0 = torch.from_numpy(seeded(SHAPE, 1)).requires_grad_()
    pm.p_losses(x0, t, noise=noise).backward()
    x1 = x0.detach().clone().requires_grad_()
    out = pm.denoise_fn(pm.q_sample(x1, t, noise), t).permute(0, 4, 1, 2, 3)
    ((out - pm.predict_v(x1.detach(), t, noise)) ** 2).mean().backward()
    torch.testing.assert_close(x0.grad, x1.grad, rtol=0, atol=0)


@pytest.mark.parametrize("settings", [(1e-4, 8000, 12000, 0.1), (1e-4, 0, 0, 1.0), (1e-3, 10, 10, 0.1)])
def test_lr_schedule_matches_optax(settings):
    lr, start, steps, coeff = settings
    want = optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=lr,
        boundaries_and_scales={start: 1.0, start + steps: coeff})
    got = lr_schedule(lr, start, steps, coeff)
    for count in sorted({0, max(start - 1, 0), start, start + steps // 2, start + steps, start + steps + 1}):
        assert abs(got(count) - float(want(jnp.asarray(count, jnp.int32)))) <= 1e-9, count


def test_grad_clip_matches():
    arrays = [seeded((3, 4), 1), seeded((5,), 2, 3.0)]
    for max_norm in (0.5, 100.0):
        clipped, norm = pgrad.clip_grad_norm([torch.from_numpy(a) for a in arrays], max_norm)
        j_clipped, j_norm = jgrad.clip_grad_norm([jnp.asarray(a) for a in arrays], max_norm)
        np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-6)
        for a, b in zip(clipped, j_clipped):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pgrad.global_l2_norm([torch.zeros(3)]).item(), 1e-3, rtol=1e-6)


@pytest.mark.parametrize("frames", [2, 4, 7])
def test_cast_num_frames_matches(frames):
    clip = seeded((1, 4, 3, 3), 1)
    want = jimage.cast_num_frames(clip, frames=frames)
    np.testing.assert_array_equal(cast_num_frames(clip, frames=frames), want)
    np.testing.assert_array_equal(cast_num_frames(torch.from_numpy(clip), frames=frames).numpy(), want)


@pytest.mark.parametrize("normalize", [False, True])
def test_dataset_items_match(npy_path, normalize):
    kw = dict(image_size=(IMAGE_SIZE, IMAGE_SIZE), num_frames=FRAMES, normalize=normalize)
    port, ref = MovingMNIST(npy_path, **kw), JaxMovingMNIST(npy_path, **kw)
    assert len(port) == len(ref) == 10 and port.channnels == ref.channnels == 1
    for i in (0, 9):
        np.testing.assert_array_equal(port[i], ref[i])
    assert port[0].max() > (1.0 if not normalize else 0.5) and port[0].max() <= (255 if not normalize else 1)


def test_loader_batches_match(npy_path):
    ds = MovingMNIST(npy_path, image_size=(IMAGE_SIZE, IMAGE_SIZE), num_frames=FRAMES)
    port, ref = DataLoader(ds, batch_size=3, seed=11), JaxDataLoader(ds, batch_size=3, seed=11)
    assert len(port) == len(ref) == 3
    for _ in range(2):  # two epochs, each reshuffled
        for a, b in zip(port, ref, strict=True):
            np.testing.assert_array_equal(a, b)


def test_prefetching_loader_yields_device_tensors(npy_path):
    from video_diffusion_nnx_tpu_torch.data.loader import endless_prefetching_loader

    ds = MovingMNIST(npy_path, image_size=(IMAGE_SIZE, IMAGE_SIZE), num_frames=FRAMES)
    stream = endless_prefetching_loader(ds, 4, torch.device("cpu"), seed=2)
    ref = iter(JaxDataLoader(ds, batch_size=4, seed=2))
    for _ in range(2):
        batch = next(stream)
        assert isinstance(batch, torch.Tensor) and batch.shape == (4, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
        np.testing.assert_array_equal(batch.numpy(), next(ref))


def _group(world: int = 4) -> SequenceGroup:
    """A rank's view of a group, without a process group behind it: the trainer checks it before any collective."""
    return SequenceGroup(0, world, "gloo", torch.device("cpu"))


def _trainer(model, npy_path, tmp_path, **kw):
    base = dict(dataset_path=npy_path, train_batch_size=2, results_folder=str(tmp_path / "results"),
                tensorboard_dir=str(tmp_path / "tb"), profile_flush_step=0, freeze_schedule_buffers=True,
                train_num_steps=3)
    return Trainer(model, folder=str(tmp_path), **{**base, **kw})


@pytest.mark.parametrize("option", ["use_path_as_cond", "null_cond_prob"])
def test_conditioning_options_of_the_trainer(npy_path, tmp_path, option):
    """Filename captions need a folder of GIFs (a ``.npy`` has no file names to read); condition dropout is stored and
    reaches the loss only with captions (JAX trainer.py:504-517), so an unconditioned recipe trains as before."""
    pm = port_model(jax_fixture_model())
    if option == "use_path_as_cond":
        with pytest.raises(ValueError, match="must be a folder of GIFs"):
            _trainer(pm, npy_path, tmp_path, use_path_as_cond=True)
        return
    tr = _trainer(pm, npy_path, tmp_path, null_cond_prob=0.1, sample_text="a digit", cond_scale=3.0)
    assert (tr.null_cond_prob, tr.sample_text, tr.cond_scale, tr.use_path_as_cond) == (0.1, "a digit", 3.0, False)
    batch = next(tr.dl)
    assert isinstance(batch, torch.Tensor)
    loss, _ = tr.train_step(batch)
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("kw,unet,error", [
    (dict(sequence_parallel_size=4), {}, "start them with the train CLI"),
    (dict(sequence_parallel_size=4, sequence_group=_group()), {"reference_compat": False}, "reference_compat"),
    (dict(sequence_parallel_size=3, sequence_group=_group(3)), {}, "must divide"),
])
def test_sequence_parallel_recipe_checks(npy_path, tmp_path, kw, unet, error):
    """A sequence-parallel trainer needs its group, compat math, and frames that divide (JAX :155-175)."""
    pm = port_model(jax_fixture_model(), **unet)
    with pytest.raises(ValueError, match=error):
        _trainer(pm, npy_path, tmp_path, **kw)
    assert pm.denoise_fn.sequence_parallel_mesh is None


def test_sequence_group_reaches_the_denoiser(npy_path, tmp_path):
    pm = port_model(jax_fixture_model())
    group = _group()
    tr = _trainer(pm, npy_path, tmp_path, sequence_parallel_size=4, sequence_group=group)
    assert pm.denoise_fn.sequence_parallel_mesh is group and pm.sequence_group is group
    assert tr.is_main
    other = _trainer(port_model(jax_fixture_model()), npy_path, tmp_path / "r1", sequence_parallel_size=4,
                     sequence_group=SequenceGroup(1, 4, "gloo", torch.device("cpu")))
    assert not other.is_main and other.save() is None  # rank 0 alone writes checkpoints


def test_three_train_steps_match_jax(npy_path, tmp_path):
    """From identical converted weights, batches, t and noise: the JAX package's pieces against the Trainer.

    The JAX step is assembled as ``trainer.py:548-599`` does it: ``p_losses``,
    the frozen buffers, ``clip_grad_norm``, ``optax.adam`` over the
    hold-then-cosine schedule, and the gated EMA.
    """
    _three_steps(npy_path, tmp_path, freeze=True)


def test_three_full_state_train_steps_match_jax(npy_path, tmp_path):
    """``freeze_schedule_buffers: false``: Adam over the whole state, the schedule buffers too (PARITY #11).

    The buffers on the loss's path drift with the JAX package's; ``alphas_cumprod`` has no gradient and
    stays bit-exact; the EMA covers the buffers.
    """
    _three_steps(npy_path, tmp_path, freeze=False)


def _three_steps(npy_path, tmp_path, freeze: bool):
    # The flagship's learning rate, and every bias drawn non-zero: Adam's first step moves each
    # element by about lr whatever its gradient, so a zero-initialised tensor would be compared at a
    # scale where an element with a gradient near Adam's eps decides the result.
    lr, start, steps, coeff, max_norm, decay = 1e-4, 1, 2, 0.1, 1.0, 0.9
    kw = dict(prediction_type="v", use_fused_attention=True, use_fused_spatial_attention=True)
    jm = jax_fixture_model(**kw)
    rng = np.random.default_rng(3)
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if path[-1] == "bias":
            var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * 0.1, jnp.float32))
    pm = port_model(jm, **kw).train()
    init = {k: v.detach().clone().numpy() for k, v in pm.state_dict().items()}
    tr = _trainer(pm, npy_path, tmp_path, train_lr=lr, lr_decay_start_step=start, lr_decay_steps=steps,
                  lr_decay_coeff=coeff, max_grad_norm=max_norm, step_start_ema=1, update_ema_every=1,
                  ema_decay=decay, freeze_schedule_buffers=freeze)

    graphdef, params = nnx.split(jm)
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=lr, boundaries_and_scales={start: 1.0, start + steps: coeff}))
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)

    @jax.jit
    def loss_and_grads(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    rng = np.random.default_rng(7)
    for step in range(3):
        x = rng.uniform(size=SHAPE).astype(np.float32)
        t = rng.integers(0, 10, size=2).astype(np.int32)
        noise = seeded(SHAPE, 20 + step)
        loss, grads = loss_and_grads(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        if freeze:
            g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
            grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
            j_grads = flat_nnx_state(g_params)
        else:
            j_grads = flat_nnx_state(grads)
        grads, norm = jgrad.clip_grad_norm(grads, max_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        if freeze:
            p_new, _ = nnx.split_state(new, nnx.Param, ...)
            _, rest_old = nnx.split_state(params, nnx.Param, ...)
            params = nnx.merge_state(p_new, rest_old)
        else:
            params = new
        if step >= 1:
            ema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, ema, params)

        p_loss, p_norm = tr.train_step(torch.from_numpy(x), t=torch.from_numpy(t).long(),
                                       noise=torch.from_numpy(noise))
        tr.step += 1
        np.testing.assert_allclose(p_loss.item(), float(loss), atol=5e-5, rtol=0)
        np.testing.assert_allclose(p_norm.item(), float(norm), rtol=1e-4)
        drift = {k: (pm.state_dict()[k] - torch.from_numpy(init[k])).abs().max().item() for k in BUFFER_NAMES}
        if freeze:
            assert set(drift.values()) == {0.0}
        else:
            assert drift["sqrt_alphas_cumprod"] > 0 and drift["sqrt_one_minus_alphas_cumprod"] > 0
            assert drift["alphas_cumprod"] == 0

        # Tensors whose gradient is zero by construction (a key bias shifts a whole softmax row;
        # a conv bias under a one-channel GroupNorm is subtracted back out) carry rounding noise,
        # which Adam's normalisation turns into steps of up to lr: both sides stay within that.
        global_norm = np.sqrt(sum(np.square(g).sum() for g in j_grads.values()))
        noise_only = {torch_key(k) for k, g in j_grads.items() if 0 < np.sqrt(np.square(g).sum()) <= 1e-6 * global_norm}
        assert noise_only and all(k.endswith(".bias") for k in noise_only)
        for name, tree, got in (("param", params, pm.state_dict()), ("ema", ema, tr.ema_state)):
            want = state_dict_from_nnx(flat_nnx_state(tree), pm)
            for k, w in want.items():
                g = got[k].detach().numpy()
                if k in noise_only:
                    bound = 4 * lr * (step + 1)
                    assert np.abs(g - init[k]).max() <= bound and np.abs(w.numpy() - init[k]).max() <= bound
                    continue
                tol = 1e-4 * max(np.abs(w.numpy()).max(), 1e-12)
                np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=0, err_msg=f"{name} {k} step {step}")
