"""The checks of the port's progressive distillation against the JAX package's, per teacher kind
(tests/test_torch_distill.py, tests/test_torch_distill_dit.py; tolerances in the first's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import nnx

from torch_port_helpers import DISTILL_COND, TIMESTEPS, distill_shape, flat_nnx_state, seeded
from video_diffusion_nnx_tpu.training import distill as jd
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.training import distill as pd

N = 4  # the student's steps: T = 10 resolves the 8-step teacher grid
W_RANGE = (1.0, 8.0)


def jax_draws(key, shape, n: int = N, w_range=None):
    """The draws of ``build_distill_step``'s loss for ``key`` (JAX distill.py:208-221)."""
    i_key, eps_key, w_key = jax.random.split(key, 3)
    i = jax.random.randint(i_key, (shape[0],), 0, n)
    eps = jax.random.normal(eps_key, shape)
    w = None if w_range is None else jax.random.uniform(w_key, (shape[0],), minval=w_range[0], maxval=w_range[1])
    return i, eps, w


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _grad(p) -> np.ndarray:
    """A parameter's gradient; none where no path reaches it (compat math drops the PreNorm norms), as JAX's 0."""
    return np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()


def _stage2(kind):
    return kind.endswith("_w")


def _inputs(kind, seed):
    shape = distill_shape(kind)
    x = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    cond = seeded((shape[0], DISTILL_COND), seed + 1) if _stage2(kind) else None
    return x, cond


def check_targets(kind, jm, pm):
    """Two teacher DDIM steps solved for the student's x0, float32, at i = 0 (t_next = -1) and i = N - 1."""
    x, cond = _inputs(kind, 3)
    x0 = x * 2 - 1
    tN, t2N = jd.nested_grids(TIMESTEPS, N)
    i = jnp.array([0, N - 1])
    t, t_mid = tN[i], t2N[2 * i]
    t_next = jnp.where(i > 0, tN[jnp.maximum(i - 1, 0)], -1)
    eps = seeded(x.shape, 4)
    w = jnp.array([1.5, 6.0]) if _stage2(kind) else None
    a, _ = jd._gather_acp(jm.alphas_cumprod[...], t, 5)
    x_t = np.asarray(a * x0 + jnp.sqrt(1 - a**2) * eps)
    want = np.asarray(jd.distill_targets(jm, jnp.asarray(x_t), t, t_mid, t_next, True,
                                         cond=None if cond is None else jnp.asarray(cond), w=w))
    got = pd.distill_targets(pm, _t(x_t), _t(t), _t(t_mid), _t(t_next), True,
                             cond=None if cond is None else _t(cond), w=None if w is None else _t(w))
    assert not got.requires_grad and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * max(1.0, np.abs(want).max()), rtol=0)


def _jax_loss_and_grads(jm, x0, i, eps, cond, w):
    """The loss of JAX ``build_distill_step`` composed from its pieces, and its gradient over the Param leaves."""
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    tN, t2N = jd.nested_grids(jm.num_timesteps, N)

    def loss_fn(p):
        student = nnx.merge(graphdef, p, rest)
        teacher = nnx.merge(graphdef, params, rest)
        t, t_mid = tN[i], t2N[2 * i]
        t_next = jnp.where(i > 0, tN[jnp.maximum(i - 1, 0)], -1)
        a_t, s_t = jd._gather_acp(teacher.alphas_cumprod[...], t, x0.ndim)
        x_t = a_t * x0 + s_t * eps
        x_tilde = jd.distill_targets(teacher, x_t, t, t_mid, t_next, True, cond=cond, w=w)
        x0_hat = jd._model_x0(student, x_t, t, clip=False, cond=cond, w=w)
        return jnp.mean(jnp.maximum(1.0, a_t**2 / s_t**2) * (x0_hat - x_tilde) ** 2)

    return jax.value_and_grad(loss_fn)(params)


def check_loss_and_gradients(kind, jm, pm):
    x, cond = _inputs(kind, 5)
    i, eps, w = jax_draws(jax.random.PRNGKey(3), x.shape, w_range=W_RANGE if _stage2(kind) else None)
    jcond = None if cond is None else jnp.asarray(cond)
    loss, grads = _jax_loss_and_grads(jm, jnp.asarray(x * 2 - 1), i, eps, jcond, w)
    student = pd.copy_state(pm)
    grids = pd.nested_grids(TIMESTEPS, N)
    got = pd.distill_loss(student, pm, _t(x * 2 - 1), _t(i), _t(eps), grids, True,
                          None if cond is None else _t(cond), None if w is None else _t(w))
    np.testing.assert_allclose(got.item(), float(loss), atol=5e-5 * max(1.0, abs(float(loss))), rtol=0)
    got.backward()
    want = state_dict_from_nnx({**flat_nnx_state(nnx.state(jm)), **flat_nnx_state(grads)}, pm)
    params = dict(student.named_parameters())
    assert set(params) == {k for k, _ in pm.named_parameters()} and not any(p.grad is not None for p in pm.parameters())
    for k, p in params.items():
        g, wg = _grad(p), want[k].numpy()
        np.testing.assert_allclose(g, wg, atol=2e-4 * max(1.0, np.abs(wg).max()), rtol=0, err_msg=k)
    assert all(b.grad is None for b in student.buffers())


def check_three_steps(kind, jm, pm):
    """Three steps of a round, EMA 0.9 from step 0, against JAX ``build_distill_step`` (optax Adam, the fused EMA)
    with each step's key; the schedule buffers stay bit-equal and the teacher unchanged."""
    lr, decay = 1e-4, 0.9
    stage2 = _stage2(kind)
    w_range = W_RANGE if stage2 else None
    graphdef, t_state = nnx.split(jm)
    tx = optax.adam(lr)
    step_fn = jd.build_distill_step(graphdef, tx, TIMESTEPS, N, conditioned=stage2, w_range=w_range, ema_decay=decay)
    s_state = jd.copy_state(t_state)
    opt_state = tx.init(jd.split_trainable(s_state)[0])
    ema = jd.copy_state(jd.split_trainable(s_state)[0])
    teacher_before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = pd.DistillStep(pm, N, learning_rate=lr, w_range=w_range, ema_decay=decay)
    init = {k: v.detach().clone().numpy() for k, v in step.student.state_dict().items()}
    noisy = {}
    for n in range(3):
        x, cond = _inputs(kind, 10 + n)
        key = jax.random.PRNGKey(40 + n)
        batch = (jnp.asarray(x), jnp.asarray(cond)) if stage2 else jnp.asarray(x)
        s_state, opt_state, ema, loss = step_fn(s_state, opt_state, ema, t_state, batch, key)
        i, eps, w = jax_draws(key, x.shape, w_range=w_range)
        got = step(_t(x), None if cond is None else _t(cond), i=_t(i), eps=_t(eps), w=None if w is None else _t(w))
        np.testing.assert_allclose(got.item(), float(loss), atol=5e-5 * max(1.0, abs(float(loss))), rtol=0)

        # Elements whose gradient is rounding noise (a whole tensor below 1e-6 of the global norm, or an element
        # below 1e-4 of its tensor's largest) get Adam steps of up to lr on either side, sign included.
        grads = {k: _grad(p) for k, p in step.student.named_parameters()}
        global_norm = np.sqrt(sum(np.square(g).sum() for g in grads.values()))
        for k, g in grads.items():
            small = np.abs(g) <= 1e-4 * np.abs(g).max() if np.sqrt(np.square(g).sum()) > 1e-6 * global_norm \
                else np.ones(g.shape, bool)
            noisy[k] = noisy.get(k, np.zeros(g.shape, bool)) | small
        full = flat_nnx_state(s_state)
        for name, tree, got_state in (("param", s_state, dict(step.student.named_parameters())),
                                      ("ema", ema, dict(zip(grads, step.ema)))):
            want = state_dict_from_nnx({**full, **flat_nnx_state(tree)}, step.student)
            for k, v in got_state.items():
                g, wv, m = v.detach().numpy(), want[k].numpy(), noisy[k]
                bound = 2 * lr * (n + 1)
                assert np.abs(g - init[k])[m].max(initial=0) <= bound
                assert np.abs(wv - init[k])[m].max(initial=0) <= bound
                np.testing.assert_allclose(g[~m], wv[~m], atol=1e-4 * max(np.abs(wv).max(), 1e-12), rtol=0,
                                           err_msg=f"{name} {k} step {n}")
    exempt = sum(int(m.sum()) for m in noisy.values()) / sum(m.size for m in noisy.values())
    assert exempt < 0.05, exempt
    for k in BUFFER_NAMES:
        assert torch.equal(step.student.state_dict()[k], teacher_before[k])
    assert all(torch.equal(v, teacher_before[k]) for k, v in pm.state_dict().items())
    # The EMA follows its formula from the first step: e_3 = d^3 p_0 + (1 - d) (d^2 p_1 + d p_2 + p_3) held above
    # against JAX; here the round's result is the EMA.
    ema_state = {k: e.clone() for (k, _), e in zip(step.student.named_parameters(), step.ema)}
    result = step.result()
    assert all(torch.equal(p, ema_state[k]) for k, p in result.named_parameters())
