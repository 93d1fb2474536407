"""The port's guidance distillation (training/guidance.py) against the JAX package's, on the CPU.

Teachers: the conditioned fixture Unet3D and the conditioned DiT of tests/torch_port_helpers.py (``distill_models``,
"unet_cond" / "dit_cond"); students: the same recipes with ``guidance_embed`` (their embedding's output layer drawn
nonzero, so every weight has a gradient), the teacher's weights copied in by JAX ``transfer_teacher_params`` and the
result converted. The JAX draws (``t``, ``eps``, ``w`` from ``split(key, 3)``) are injected. Tolerances as
tests/test_torch_distill.py: loss float32 5e-5 of max(1, |loss|), gradients 2e-4 of max(1, each tensor's largest
magnitude), parameters after Adam steps 1e-4 of their largest magnitude except rounding-noise elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from torch_distill_checks import _grad, _t
from torch_port_helpers import DISTILL_COND, TIMESTEPS, distill_models, distill_shape, flat_nnx_state, seeded
from video_diffusion_nnx_tpu.training import distill as jd
from video_diffusion_nnx_tpu.training import guidance as jg
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.training import distill as pd
from video_diffusion_nnx_tpu_torch.training import guidance as pg

W_RANGE = (1.0, 8.0)


@pytest.fixture(scope="module", params=["unet", "dit"])
def pair(request):
    """(arch, JAX teacher, port teacher, JAX student state, port student) with the teacher's weights in the
    student."""
    arch = request.param
    jt, pt = distill_models(f"{arch}_cond")
    js, ps = distill_models(f"{arch}_w", seed=8)
    s_state = jg.transfer_teacher_params(js, nnx.split(jt)[1])
    ps.load_state_dict(state_dict_from_nnx(flat_nnx_state(s_state), ps))
    return arch, jt, pt, s_state, ps, js


def _inputs(arch, seed):
    shape = distill_shape(arch)
    return (np.random.default_rng(seed).uniform(size=shape).astype(np.float32),
            seeded((shape[0], DISTILL_COND), seed + 1))


def jax_draws(key, shape):
    """The draws of ``build_guidance_distill_step``'s loss for ``key`` (JAX guidance.py:94-98)."""
    t_key, eps_key, w_key = jax.random.split(key, 3)
    t = jax.random.randint(t_key, (shape[0],), 0, TIMESTEPS)
    w = jax.random.uniform(w_key, (shape[0],), minval=W_RANGE[0], maxval=W_RANGE[1])
    return t, jax.random.normal(eps_key, shape), w


def _jax_loss_and_grads(js, s_state, jt, x0, cond, t, eps, w):
    """JAX ``build_guidance_distill_step``'s loss (guidance.py:90-134), re-stated over the student's Param leaves."""
    s_graphdef = nnx.graphdef(js)
    s_params, s_rest = jd.split_trainable(s_state)

    def loss_fn(p):
        student = nnx.merge(s_graphdef, p, s_rest)
        a_t, s_t = jd._gather_acp(jt.alphas_cumprod[...], t, x0.ndim)
        x_t = a_t * x0 + s_t * eps
        cond_out = jt.denoise_fn(x_t, t, cond=cond, null_cond_prob=0.0)
        null_out = jt.denoise_fn(x_t, t, cond=cond, null_cond_prob=1.0)
        target = jax.lax.stop_gradient(null_out + (cond_out - null_out) * w.reshape(-1, 1, 1, 1, 1))
        target_x0, _ = jt._model_out_to_x0_eps(x_t, t, jnp.transpose(target, (0, 4, 1, 2, 3)))
        out = student.denoise_fn(x_t, t, cond=cond, null_cond_prob=0.0, guidance_scale=w)
        student_x0, _ = student._model_out_to_x0_eps(x_t, t, jnp.transpose(out, (0, 4, 1, 2, 3)))
        return jnp.mean(jnp.maximum(1.0, a_t**2 / s_t**2) * (student_x0 - target_x0) ** 2)

    return jax.value_and_grad(loss_fn)(s_params)


def test_guidance_loss_and_gradients_match_jax(pair):
    arch, jt, pt, s_state, ps, js = pair
    x, c = _inputs(arch, 3)
    t, eps, w = jax_draws(jax.random.PRNGKey(5), x.shape)
    loss, grads = _jax_loss_and_grads(js, s_state, jt, jnp.asarray(x * 2 - 1), jnp.asarray(c), t, eps, w)
    student = pd.copy_state(ps)
    got = pg.guidance_loss(student, pt, _t(x * 2 - 1), _t(c), _t(t), _t(eps), _t(w))
    np.testing.assert_allclose(got.item(), float(loss), atol=5e-5 * max(1.0, abs(float(loss))), rtol=0)
    got.backward()
    want = state_dict_from_nnx({**flat_nnx_state(s_state), **flat_nnx_state(grads)}, student)
    assert all(p.grad is None for p in pt.parameters())
    named = dict(student.named_parameters())
    assert all(np.abs(_grad(named[k])).max() > 0 for k in named if "guidance_mlp" in k)
    for k, p in named.items():
        g, wg = _grad(p), want[k].numpy()
        np.testing.assert_allclose(g, wg, atol=2e-4 * max(1.0, np.abs(wg).max()), rtol=0, err_msg=k)


def test_three_guidance_steps_match_jax(pair):
    """Three steps against JAX ``build_guidance_distill_step`` (optax Adam) with each step's key; the buffers stay
    bit-equal and the teacher unchanged."""
    arch, jt, pt, s_state, ps, js = pair
    lr = 1e-4
    tx = optax.adam(lr)
    t_graphdef, t_state = nnx.split(jt)
    step_fn = jg.build_guidance_distill_step(nnx.graphdef(js), t_graphdef, tx, TIMESTEPS, w_range=W_RANGE)
    state = jd.copy_state(s_state)
    opt_state = tx.init(jd.split_trainable(state)[0])
    student = pd.copy_state(ps)
    teacher_before = {k: v.clone() for k, v in pt.state_dict().items()}
    step = pg.GuidanceStep(pt, student, learning_rate=lr, w_range=W_RANGE)
    init = {k: v.detach().clone().numpy() for k, v in student.named_parameters()}
    noisy = {}
    for n in range(3):
        x, c = _inputs(arch, 10 + n)
        key = jax.random.PRNGKey(60 + n)
        state, opt_state, loss = step_fn(state, opt_state, t_state, jnp.asarray(x), jnp.asarray(c), key)
        t, eps, w = jax_draws(key, x.shape)
        got = step(_t(x), _t(c), t=_t(t), eps=_t(eps), w=_t(w))
        np.testing.assert_allclose(got.item(), float(loss), atol=5e-5 * max(1.0, abs(float(loss))), rtol=0)
        grads = {k: _grad(p) for k, p in student.named_parameters()}
        global_norm = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
        for k, g in grads.items():
            small = (np.abs(g) <= 1e-4 * np.abs(g).max() if np.sqrt(np.square(g).sum()) > 1e-6 * global_norm
                     else np.ones(g.shape, bool))
            noisy[k] = noisy.get(k, np.zeros(g.shape, bool)) | small
        want = state_dict_from_nnx(flat_nnx_state(state), student)
        for k, p in student.named_parameters():
            g, wv, m = p.detach().numpy(), want[k].numpy(), noisy[k]
            bound = 2 * lr * (n + 1)
            assert np.abs(g - init[k])[m].max(initial=0) <= bound
            assert np.abs(wv - init[k])[m].max(initial=0) <= bound
            np.testing.assert_allclose(g[~m], wv[~m], atol=1e-4 * max(np.abs(wv).max(), 1e-12), rtol=0,
                                       err_msg=f"{k} step {n}")
    assert sum(int(m.sum()) for m in noisy.values()) / sum(m.size for m in noisy.values()) < 0.05
    assert all(torch.equal(student.state_dict()[k], teacher_before[k]) for k in BUFFER_NAMES)
    assert all(torch.equal(v, teacher_before[k]) for k, v in pt.state_dict().items())
    assert len(step.losses) == 3 and len(step.step_starts) == 3


def test_transfer_teacher_params_key_rules():
    """Every teacher key lands in the student; the student's only extra keys are its guidance embedding, which
    keeps its own values; a missing teacher key, a student with other extra keys, or none, raise."""
    _, teacher = distill_models("unet_cond", perturb_biases=False)
    _, student = distill_models("unet_w", seed=3, perturb_biases=False)
    mlp = {k: v.clone() for k, v in student.state_dict().items() if ".guidance_mlp." in k}
    pg.transfer_teacher_params(student, teacher)
    s = student.state_dict()
    assert all(torch.equal(s[k], v) for k, v in teacher.state_dict().items())
    assert all(torch.equal(s[k], v) for k, v in mlp.items()) and len(mlp) == 4
    _, plain = distill_models("unet", perturb_biases=False)
    with pytest.raises(ValueError, match="missing from the student"):
        pg.transfer_teacher_params(plain, teacher)  # null_cond_emb and the wider time MLPs are not there
    with pytest.raises(ValueError, match="guidance embedding"):
        pg.transfer_teacher_params(teacher, plain)  # the extra keys are the condition's, not guidance_mlp
    with pytest.raises(ValueError, match="guidance embedding"):
        pg.transfer_teacher_params(teacher, teacher)


def test_guidance_distill_refuses_and_runs():
    """A student without ``guidance_embed`` or an unconditioned teacher raises; two steps from a data iterator
    copy the teacher in, train, and leave a student that guides with one forward of b rows a step."""
    _, teacher = distill_models("unet_cond", perturb_biases=False)
    _, student = distill_models("unet_w", seed=4, perturb_biases=False)
    _, plain = distill_models("unet", perturb_biases=False)
    with pytest.raises(ValueError, match="guidance_embed=True"):
        pg.guidance_distill(teacher, teacher, iter([]), num_train_steps=0)
    with pytest.raises(ValueError, match="conditioned teacher"):
        pg.guidance_distill(plain, student, iter([]), num_train_steps=0)

    shape = distill_shape("unet")
    rng = np.random.default_rng(9)

    def data():
        while True:
            yield (torch.from_numpy(rng.uniform(size=shape).astype(np.float32)),
                   torch.from_numpy(rng.standard_normal((shape[0], DISTILL_COND)).astype(np.float32)))

    done = []
    out = pg.guidance_distill(teacher, student, data(), num_train_steps=2, generator=torch.Generator().manual_seed(0),
                              learning_rate=1e-3, log_every=1, on_done=done.append)
    assert out is student and len(done[0].losses) == 2
    rows = []
    student.denoise_fn.register_forward_hook(lambda m, args, o: rows.append(args[0].shape[0]))
    videos = student.ddim_sample(num_steps=3, generator=torch.Generator().manual_seed(1),
                                 cond=torch.zeros(2, DISTILL_COND), cond_scale=4.0)
    assert rows == [2, 2, 2] and videos.shape == (2, *shape[1:]) and bool(torch.isfinite(videos).all())
