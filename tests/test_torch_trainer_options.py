"""The trainer's gradient accumulation and flat optimizer against the JAX trainer's pieces, on the CPU.

From the same converted weights, batches, t and noise, as tests/test_torch_training.py's three steps: the JAX
step is assembled as ``training/trainer.py:521-599`` does it (microbatches of consecutive rows, the mean loss and
gradient, the frozen buffers, ``clip_grad_norm``, ``optax.adam`` or ``optax.flatten(optax.adam)`` over the
hold-then-cosine schedule, the gated EMA, flat with ``optax.flatten``). Tolerances: losses float32 atol 5e-5 (the
Unet's own bound); the gradient norm rtol 1e-4; parameters and EMA 1e-4 of each tensor's largest magnitude, within
the 2e-4 of the f32 gradient gates (tensors whose gradient is rounding noise within Adam's step bound, as there).
``flatten_optimizer`` against the run without it: every loss, norm, parameter, EMA tensor and Adam moment bit-equal
(the option runs the same elementwise step), and checkpoints that resume across the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.flatten_util import ravel_pytree

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint, state_dict_from_nnx, torch_key
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

BATCH = 2
SHAPE = (BATCH, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
LR, START, DECAY_STEPS, COEFF, MAX_NORM, EMA_DECAY = 1e-4, 1, 2, 0.1, 1.0, 0.9
MODEL = dict(prediction_type="v")


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "seq.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, size=(6, 10, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    return str(path)


@pytest.fixture(scope="module")
def jax_model():
    """The fixture model with every bias drawn non-zero (a zero-initialised tensor would be compared where Adam's
    first step of about lr decides the result; see tests/test_torch_training.py)."""
    jm = jax_fixture_model(**MODEL)
    rng = np.random.default_rng(3)
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if path[-1] == "bias":
            var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * 0.1, jnp.float32))
    return jm


@pytest.fixture(scope="module")
def loss_and_grads(jax_model):
    graphdef, _ = nnx.split(jax_model)

    @jax.jit
    def fn(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    return fn


def _inputs(steps: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        x = rng.uniform(size=SHAPE).astype(np.float32)
        t = rng.integers(0, 10, size=BATCH).astype(np.int32)
        out.append((x, t, seeded(SHAPE, 20 + step)))
    return out


def _trainer(jax_model, npy_path, root, **kw):
    pm = port_model(jax_model, **MODEL).train()
    base = dict(dataset_path=npy_path, train_batch_size=BATCH, results_folder=str(root / "results"),
                tensorboard_dir=str(root / "tb"), profile_flush_step=0, train_num_steps=3, train_lr=LR,
                lr_decay_start_step=START, lr_decay_steps=DECAY_STEPS, lr_decay_coeff=COEFF,
                max_grad_norm=MAX_NORM, step_start_ema=1, update_ema_every=1, ema_decay=EMA_DECAY)
    return Trainer(pm, folder=str(root), **{**base, **kw})


def _port_steps(tr, inputs):
    out = []
    for x, t, noise in inputs:
        loss, norm = tr.train_step(torch.from_numpy(x), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
        tr.step += 1
        out.append((loss.item(), norm.item()))
    return out


def _jax_steps(jax_model, loss_and_grads, inputs, freeze: bool, accumulate: int = 1, flat: bool = False):
    """The JAX trainer's step on injected inputs: ``(per-step (loss, norm, j_grads), params, ema)``."""
    _, params = nnx.split(jax_model)
    adam = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=LR, boundaries_and_scales={START: 1.0, START + DECAY_STEPS: COEFF}))
    tx = optax.flatten(adam) if flat else adam
    opt_state = tx.init(params)
    ema = ravel_pytree(params)[0] if flat else jax.tree_util.tree_map(jnp.copy, params)
    steps = []
    for step, (x, t, noise) in enumerate(inputs):
        rows = BATCH // accumulate
        loss, grads = 0.0, None
        for i in range(accumulate):
            sl = slice(i * rows, (i + 1) * rows)
            l_i, g_i = loss_and_grads(params, jnp.asarray(x[sl]), jnp.asarray(t[sl]), jnp.asarray(noise[sl]))
            loss = loss + l_i
            grads = g_i if grads is None else jax.tree_util.tree_map(jnp.add, grads, g_i)
        if accumulate > 1:
            loss = loss * (1.0 / accumulate)
            grads = jax.tree_util.tree_map(lambda g: g * (1.0 / accumulate), grads)
        if freeze:
            g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
            grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
            j_grads = flat_nnx_state(g_params)
        else:
            j_grads = flat_nnx_state(grads)
        grads, norm = jgrad.clip_grad_norm(grads, MAX_NORM)
        updates, opt_state = tx.update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        if freeze:
            p_new, _ = nnx.split_state(new, nnx.Param, ...)
            _, rest_old = nnx.split_state(params, nnx.Param, ...)
            params = nnx.merge_state(p_new, rest_old)
        else:
            params = new
        if step >= 1:
            if flat:
                ema = EMA_DECAY * ema + (1 - EMA_DECAY) * ravel_pytree(params)[0]
            else:
                ema = jax.tree_util.tree_map(lambda e, p: EMA_DECAY * e + (1 - EMA_DECAY) * p, ema, params)
        steps.append((float(loss), float(norm), j_grads))
    if flat:
        ema = ravel_pytree(params)[1](ema)
    return steps, params, ema


def _check_against_jax(tr, pm_init, port_steps, jax_steps, params, ema):
    """Losses, norms, and every parameter and EMA tensor after the last step, as tests/test_torch_training.py."""
    for (p_loss, p_norm), (j_loss, j_norm, _) in zip(port_steps, jax_steps):
        np.testing.assert_allclose(p_loss, j_loss, atol=5e-5, rtol=0)
        np.testing.assert_allclose(p_norm, j_norm, rtol=1e-4)
    j_grads = jax_steps[-1][2]
    global_norm = np.sqrt(sum(np.square(g).sum() for g in j_grads.values()))
    noise_only = {torch_key(k) for k, g in j_grads.items() if 0 < np.sqrt(np.square(g).sum()) <= 1e-6 * global_norm}
    for name, tree, got in (("param", params, tr.model.state_dict()), ("ema", ema, tr.ema_state)):
        want = state_dict_from_nnx(flat_nnx_state(tree), tr.model)
        for k, w in want.items():
            g = got[k].detach().numpy()
            if k in noise_only:
                bound = 4 * LR * len(port_steps)
                assert np.abs(g - pm_init[k]).max() <= bound and np.abs(w.numpy() - pm_init[k]).max() <= bound
                continue
            tol = 1e-4 * max(np.abs(w.numpy()).max(), 1e-12)
            np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=0, err_msg=f"{name} {k}")


def _state_of(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen_buffers", "full_state"])
def test_accumulated_steps_match_jax(jax_model, loss_and_grads, npy_path, tmp_path, freeze):
    """A = 2 over a batch of 2: two microbatches of one row, the mean loss and gradient, one Adam step and EMA."""
    inputs = _inputs(2)
    tr = _trainer(jax_model, npy_path, tmp_path, enable_gradient_accumulation=True, gradient_accumulate_every=2,
                  freeze_schedule_buffers=freeze)
    init = {k: v.numpy().copy() for k, v in _state_of(tr).items()}
    port = _port_steps(tr, inputs)
    steps, params, ema = _jax_steps(jax_model, loss_and_grads, inputs, freeze, accumulate=2)
    _check_against_jax(tr, init, port, steps, params, ema)
    # Against the unaccumulated step from the same state the loss is the same mean over rows (l2, equal rows).
    whole = _trainer(jax_model, npy_path, tmp_path / "whole", freeze_schedule_buffers=freeze)
    np.testing.assert_allclose(_port_steps(whole, inputs[:1])[0][0], port[0][0], atol=5e-5, rtol=0)


def test_accumulated_microbatches_draw_in_turn(jax_model, npy_path, tmp_path):
    """Without injection each microbatch draws t and noise from the trainer's generator in turn: the accumulated
    step equals the mean of two half-batch steps' losses drawn from the same generator; a batch that does not split
    raises, as JAX asserts."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=SHAPE).astype(np.float32))
    tr = _trainer(jax_model, npy_path, tmp_path, enable_gradient_accumulation=True, gradient_accumulate_every=2)
    loss, _ = tr.train_step(x)
    gen = torch.Generator().manual_seed(0)
    pm = port_model(jax_model, **MODEL)
    with torch.no_grad():
        want = sum(pm(x[i:i + 1], generator=gen).item() for i in range(2)) / 2
    np.testing.assert_allclose(loss.item(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="microbatches"):
        tr.train_step(torch.zeros(3, *SHAPE[1:]))
    with pytest.raises(ValueError, match="gradient_accumulate_every"):
        _trainer(jax_model, npy_path, tmp_path / "odd", enable_gradient_accumulation=True,
                 gradient_accumulate_every=3)


@pytest.mark.parametrize("freeze,accumulate", [(True, 1), (False, 1), (True, 2)],
                         ids=["frozen_buffers", "full_state", "accumulated"])
def test_flat_optimizer_matches_per_tensor_and_jax(jax_model, loss_and_grads, npy_path, tmp_path, freeze,
                                                  accumulate):
    """``flatten_optimizer``: bit-equal to the run without it at every step (Adam's moments too), and within the
    f32 tolerances of the JAX trainer's ``optax.flatten`` run with its flat EMA."""
    inputs = _inputs(3)
    kw = dict(freeze_schedule_buffers=freeze, enable_gradient_accumulation=accumulate > 1,
              gradient_accumulate_every=accumulate)
    ref = _trainer(jax_model, npy_path, tmp_path / "tensors", **kw)
    tr = _trainer(jax_model, npy_path, tmp_path / "flat", flatten_optimizer=True, **kw)
    init = {k: v.numpy().copy() for k, v in _state_of(tr).items()}
    port = []
    for x, t, noise in inputs:
        args = (torch.from_numpy(x),)
        kwargs = dict(t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
        got, want = tr.train_step(*args, **kwargs), ref.train_step(*args, **kwargs)
        tr.step += 1
        ref.step += 1
        port.append(tuple(v.item() for v in got))
        assert port[-1] == tuple(v.item() for v in want)
    for a, b in ((tr.model.state_dict(), ref.model.state_dict()), (tr.ema_state, ref.ema_state)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    _same_moments(tr, ref)
    steps, params, ema = _jax_steps(jax_model, loss_and_grads, inputs, freeze, accumulate=accumulate, flat=True)
    _check_against_jax(tr, init, port, steps, params, ema)


def _same_moments(a, b) -> None:
    """Adam's moments and step counts of two trainers, tensor by tensor, bit-equal (no gradient, no moments)."""
    assert a.opt_count == b.opt_count
    for p, q in zip(a.params, b.params):
        sa, sb = a.optimizer.state.get(p), b.optimizer.state.get(q)
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert all(torch.equal(sa[m], sb[m]) for m in ("exp_avg", "exp_avg_sq", "step"))


@pytest.mark.parametrize("saved_flat,resumed_flat", [(True, True), (True, False), (False, True)],
                         ids=["flat_to_flat", "flat_to_per_tensor", "per_tensor_to_flat"])
def test_flat_optimizer_resumes_across_settings(jax_model, npy_path, tmp_path, saved_flat, resumed_flat):
    """A checkpoint with the optimizer state keeps the per-tensor layout of parameters and EMA (no tensor shares a
    storage), with or without ``flatten_optimizer``; a run with either setting resumes from either: parameters, EMA
    and Adam's moments bit for bit, and the next step equal to the saving run's."""
    inputs = _inputs(3)
    kw = dict(save_optimizer_state=True, checkpoint_every_steps=2, freeze_schedule_buffers=False)
    tr = _trainer(jax_model, npy_path, tmp_path, flatten_optimizer=saved_flat, **kw)
    _port_steps(tr, inputs[:2])
    tr.save()
    payload = read_checkpoint(tr.checkpoint_path(2))
    for part in ("model", "ema_params"):
        for k, v in payload[part].items():
            assert v.untyped_storage().nbytes() == v.numel() * v.element_size(), (part, k)
    resumed = _trainer(jax_model, npy_path, tmp_path, resume_training_step=2, flatten_optimizer=resumed_flat, **kw)
    assert resumed.opt_count == 2
    for a, b in ((resumed.model.state_dict(), tr.model.state_dict()), (resumed.ema_state, tr.ema_state)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    _same_moments(resumed, tr)
    assert _port_steps(resumed, inputs[2:]) == _port_steps(tr, inputs[2:])
    assert all(torch.equal(a, b) for a, b in zip(resumed.params, tr.params))
