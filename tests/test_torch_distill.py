"""The port's progressive distillation (training/distill.py) against the JAX package's, on the CPU.

Teachers (tests/torch_port_helpers.py ``distill_models``): the fixture Unet3D ("unet"), the DiT of
tests/test_torch_dit.py ("dit"), and stage 2 of Meng et al., a conditioned ``guidance_embed`` Unet3D or DiT fed a
per-sample w ("unet_w", "dit_w"), each with the JAX weights converted. The JAX draws of a step (``i``, ``eps``, ``w``
from ``split(key, 3)``, as ``build_distill_step`` makes them) are injected into the port. Tolerances from
tests/test_ops.py and tests/test_torch_training.py: targets and losses float32 5e-5 of max(1, the largest magnitude);
gradients 2e-4 of max(1, each tensor's largest magnitude); after Adam steps every parameter and EMA tensor within
1e-4 of its largest magnitude, except elements whose gradient is rounding noise (a tensor below 1e-6 of the global
norm, or an element below 1e-4 of its tensor's largest), which Adam moves by up to lr a step on either side, sign
included; those are under 5% of the elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_distill_checks import N, W_RANGE, _inputs, _t, check_loss_and_gradients, check_targets, check_three_steps
from torch_port_helpers import TIMESTEPS, distill_models, distill_shape
from video_diffusion_nnx_tpu.training import distill as jd
from video_diffusion_nnx_tpu_torch.convert import torch_key
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.training import distill as pd


@pytest.fixture(scope="module")
def teacher():
    return distill_models("unet")


def test_distill_targets_match_jax(teacher):
    check_targets("unet", *teacher)


def test_loss_and_gradients_match_jax(teacher):
    check_loss_and_gradients("unet", *teacher)


def test_three_steps_with_ema_match_jax(teacher):
    check_three_steps("unet", *teacher)


@pytest.mark.parametrize("T,n", [(1000, 8), (16, 4), (10, 4), (200, 25), (1024, 32)])
def test_nested_grids_match_jax(T, n):
    tN, t2N = pd.nested_grids(T, n)
    jN, j2N = jd.nested_grids(T, n)
    np.testing.assert_array_equal(tN.numpy(), np.asarray(jN))
    np.testing.assert_array_equal(t2N.numpy(), np.asarray(j2N))
    np.testing.assert_array_equal(t2N[1::2].numpy(), tN.numpy())
    with pytest.raises(ValueError, match="needs timesteps >= "):
        pd.nested_grids(2 * n - 1, n)


def test_gather_acp_reads_clean_data_at_minus_one():
    """t = -1 is clean data (alpha 1, sigma 0), not acp[T - 1] as a torch index of -1 would read."""
    acp = np.linspace(0.999, 0.01, TIMESTEPS).astype(np.float32)
    t = np.array([-1, 0, 5, 9], np.int32)
    a, s = pd._gather_acp(torch.from_numpy(acp), _t(t), 5)
    ja, js = jd._gather_acp(jnp.asarray(acp), jnp.asarray(t), 5)
    assert a.shape == (4, 1, 1, 1, 1) and a[0].item() == 1.0 and s[0].item() == 0.0
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-7, rtol=0)


def test_progressive_rounds_halve_and_sample():
    """Two rounds 4 -> 2 on the Unet3D: ``on_round_end`` sees each student, each round's student is the next
    teacher, the buffers never move, the result samples on its stride grid; an odd count stops the halving."""
    _, pm = distill_models("unet", perturb_biases=False)
    shape = distill_shape("unet")
    rng = np.random.default_rng(0)

    def data():
        while True:
            yield torch.from_numpy(rng.uniform(size=shape).astype(np.float32))

    seen, done = [], []
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    student, steps = pd.progressive_distill(pm, data(), initial_steps=4, rounds=2, steps_per_round=2,
                                            generator=torch.Generator().manual_seed(1), learning_rate=1e-3,
                                            ema_decay=0.5, on_round_end=lambda n, m: seen.append((n, m)),
                                            on_done=done.append)
    assert [n for n, _ in seen] == [4, 2] and steps == 2 and seen[-1][1] is student
    assert [d.student_steps for d in done] == [4, 2] and done[1].teacher is seen[0][1]
    assert all(len(d.losses) == 2 and all(torch.isfinite(v) for v in d.losses) for d in done)
    assert all(torch.equal(v, before[k]) for k, v in pm.state_dict().items())
    assert all(torch.equal(student.state_dict()[k], before[k]) for k in BUFFER_NAMES)
    assert any(not torch.equal(p, before[k]) for k, p in student.named_parameters())
    out = student.ddim_sample(batch_size=1, num_steps=steps, grid="stride", generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, *shape[1:]) and bool(torch.isfinite(out).all())

    _, odd = pd.progressive_distill(pm, data(), initial_steps=3, rounds=3, steps_per_round=1,
                                    generator=torch.Generator().manual_seed(2))
    assert odd == 3


def test_teacher_grid_must_resolve():
    _, pm = distill_models("unet", perturb_biases=False)
    with pytest.raises(ValueError, match="needs timesteps >= 12"):
        pd.DistillStep(pm, 6)


def test_draws_come_from_the_generator_in_order():
    """Without injection a step draws i, eps, then w from its generator: the same seed gives the same loss, and
    injecting the same numbers gives it too."""
    _, pm = distill_models("unet_w", perturb_biases=False)
    x, cond = _inputs("unet_w", 20)
    losses = []
    for _ in range(2):
        step = pd.DistillStep(pm, N, w_range=W_RANGE, generator=torch.Generator().manual_seed(5))
        losses.append(step(_t(x), _t(cond)).item())
    g = torch.Generator().manual_seed(5)
    i = torch.randint(0, N, (x.shape[0],), generator=g)
    eps = torch.randn(x.shape, generator=g)
    w = W_RANGE[0] + (W_RANGE[1] - W_RANGE[0]) * torch.rand(x.shape[0], generator=g)
    injected = pd.DistillStep(pm, N, w_range=W_RANGE)(_t(x), _t(cond), i=i, eps=eps, w=w).item()
    assert losses[0] == losses[1] == injected
    assert {torch_key("denoise_fn/guidance_mlp/layers/1/kernel")} <= set(pm.state_dict())
