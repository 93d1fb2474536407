"""The port's progressive distillation of a VideoDiT teacher ("dit") and in stage 2 of Meng et al. (a conditioned
``guidance_embed`` Unet3D and DiT fed a per-sample w: "unet_w", "dit_w") against the JAX package's, on the CPU: the
checks and tolerances of tests/test_torch_distill.py (tests/torch_distill_checks.py)."""

import pytest

from torch_distill_checks import check_loss_and_gradients, check_targets, check_three_steps
from torch_port_helpers import distill_models

KINDS = ["dit", "unet_w", "dit_w"]


@pytest.fixture(scope="module", params=KINDS)
def teacher(request):
    return (request.param, *distill_models(request.param))


def test_distill_targets_match_jax(teacher):
    check_targets(*teacher)


def test_loss_and_gradients_match_jax(teacher):
    check_loss_and_gradients(*teacher)


def test_three_steps_with_ema_match_jax(teacher):
    check_three_steps(*teacher)
