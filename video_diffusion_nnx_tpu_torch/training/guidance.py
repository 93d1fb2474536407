"""Guidance distillation (Meng et al. 2023; counterpart of the JAX package's training/guidance.py:49-211).

Classifier-free guidance evaluates the denoiser on the condition and on the
null embedding and combines ``null + (cond - null) * w``: twice the work of
one forward. This module trains a student with a ``guidance_embed`` pathway
(the teacher's architecture plus ``guidance_mlp``, its output layer zero, so
the grafted student starts as the teacher's unguided forward) to give the
teacher's guided output in ONE forward, conditioned on a per-sample scale
``w ~ U[w_range]``. Every sampler then runs at any ``cond_scale`` with one
forward of b rows a step (``forward_with_cond_scale`` folds the scale in).

Each step draws ``t ~ U{0..T-1}``, ``eps ~ N(0, 1)`` and ``w`` from an
explicit ``torch.Generator``, in that order (each may be injected). The
teacher runs two forwards of b rows, the conditioned and the null one, as
JAX does, under ``no_grad``; the student runs with ``guidance_scale = w``.
Outputs are matched in x0 space under the truncated-SNR weight of
progressive distillation, ``max(1, alpha^2 / sigma^2)`` (JAX :117-134: an
output-space loss over-weights the low-noise steps for v and eps
parameterizations). The optimizer is ``distill.StudentOptimizer``'s Adam over
the student's parameters; stage 2, progressively distilling the
w-conditioned student, is ``distill.progressive_distill`` with ``w_range``.
Over a data group (JAX :149-160: the batch and condition sharded over
``'data'``) the step splits rows as ``distill.DistillStep`` does: the whole
batch's draws, this rank's rows of them, one all-reduce before Adam.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator

import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.training.distill import StudentOptimizer, _gather_acp, snr_weight
from video_diffusion_nnx_tpu_torch.utils.image import normalize_img

logger = logging.getLogger(__name__)

GUIDANCE_PREFIX = "denoise_fn.guidance_mlp."


def transfer_teacher_params(student: nn.Module, teacher: nn.Module) -> nn.Module:
    """Copy every tensor of the teacher's state into the student (JAX :50-70), in place; returns the student.

    A teacher key the student lacks raises, and the student's own keys beyond the teacher's must be exactly its
    guidance embedding (``denoise_fn.guidance_mlp.*``), which keeps its fresh init (output layer zero).
    """
    s_state, t_state = student.state_dict(), teacher.state_dict()
    missing = [k for k in t_state if k not in s_state]
    if missing:
        raise ValueError(f"teacher key(s) {missing[:5]} missing from the student")
    extra = [k for k in s_state if k not in t_state]
    if not extra or any(not k.startswith(GUIDANCE_PREFIX) for k in extra):
        raise ValueError(f"the student's keys beyond the teacher's must be its guidance embedding "
                         f"({GUIDANCE_PREFIX}*); got {extra[:5]}")
    with torch.no_grad():
        for k, v in t_state.items():
            s_state[k].copy_(v)
    student.graphs.clear()
    logger.info("transferred %d teacher tensors into the student (%d in all)", len(t_state), len(s_state))
    return student


def guidance_loss(student: nn.Module, teacher: nn.Module, x0: torch.Tensor, cond: torch.Tensor, t: torch.Tensor,
                  eps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The loss of one step (JAX ``loss_fn``, :90-134) on normalized data ``x0``, condition ``cond`` (b, cond_dim),
    timesteps ``t``, noise ``eps`` and guidance scales ``w`` (b,)."""
    a_t, s_t = _gather_acp(teacher.alphas_cumprod, t, x0.ndim)
    x_t = a_t * x0 + s_t * eps
    with torch.no_grad():
        cond_out = teacher.denoise_fn(x_t, t, cond=cond, null_cond_prob=0.0)
        null_out = teacher.denoise_fn(x_t, t, cond=cond, null_cond_prob=1.0)
        target = null_out + (cond_out - null_out) * w.reshape(-1, 1, 1, 1, 1)
        # The conversion is affine in the output: converting the combined target equals combining conversions.
        target_x0, _ = teacher._model_out_to_x0_eps(x_t, t, target.permute(0, 4, 1, 2, 3))
    student_out = student.denoise_fn(x_t, t, cond=cond, null_cond_prob=0.0, guidance_scale=w)
    student_x0, _ = student._model_out_to_x0_eps(x_t, t, student_out.permute(0, 4, 1, 2, 3))
    return torch.mean(snr_weight(a_t, s_t) * (student_x0 - target_x0) ** 2)


class GuidanceStep(StudentOptimizer):
    """One guidance-distillation step (JAX ``build_guidance_distill_step``, :73-158) of ``student`` (already
    holding the teacher's weights, ``transfer_teacher_params``) against ``teacher``."""

    def __init__(self, teacher: nn.Module, student: nn.Module, learning_rate: float = 1e-4,
                 w_range: tuple[float, float] = (1.0, 8.0), generator: torch.Generator | None = None, group=None):
        if not getattr(student.denoise_fn, "has_guidance_embed", False):
            raise ValueError("student must be built with guidance_embed=True")
        if not getattr(teacher.denoise_fn, "has_cond", False):
            raise ValueError("guidance distillation needs a conditioned teacher")
        super().__init__(student, learning_rate, group=group)
        self.teacher = teacher
        self.w_range = (float(w_range[0]), float(w_range[1]))
        self.generator = generator

    def __call__(self, batch: torch.Tensor, cond: torch.Tensor, t: torch.Tensor | None = None,
                 eps: torch.Tensor | None = None, w: torch.Tensor | None = None) -> torch.Tensor:
        """One step on raw data ``batch`` in [0, 1] with its condition (this rank's rows of both under a group);
        returns the batch's loss. ``t``, ``eps`` and ``w`` are the whole batch's, drawn from the generator, in that
        order, where not given."""
        self.step_starts.append(time.perf_counter())
        x0 = normalize_img(batch.float())
        dev = x0.device
        b, rows = self.draw_rows(x0.shape[0])
        if t is None:
            t = torch.randint(0, self.teacher.num_timesteps, (b,), generator=self.generator, device=dev)
        if eps is None:
            eps = torch.randn((b, *x0.shape[1:]), generator=self.generator, device=dev)
        if w is None:
            lo, hi = self.w_range
            w = lo + (hi - lo) * torch.rand(b, generator=self.generator, device=dev)
        if rows is not None:
            t, eps, w = t[rows], eps[rows], w[rows]
        loss = guidance_loss(self.student, self.teacher, x0, cond.float(), t.to(dev), eps, w)
        return self.update(self.share(loss))


def guidance_distill(teacher: nn.Module, student: nn.Module, data_iter: Iterator, *, num_train_steps: int,
                     generator: torch.Generator | None = None, learning_rate: float = 1e-4,
                     w_range: tuple[float, float] = (1.0, 8.0), log_every: int = 50,
                     on_done: Callable[[GuidanceStep], None] | None = None, group=None) -> nn.Module:
    """Distill the teacher's guidance into ``student`` (the teacher's recipe with ``guidance_embed``), in place
    (JAX :161-211): the teacher's weights are copied in first. ``data_iter`` yields ``(batch, cond)`` pairs (this
    rank's rows under ``group``). Returns the trained student; sample it at any ``cond_scale`` with one forward a
    step."""
    step = GuidanceStep(teacher, student, learning_rate, w_range, generator, group)
    transfer_teacher_params(student, teacher)
    for n in range(num_train_steps):
        batch, cond = next(data_iter)
        loss = step(batch, cond)
        if log_every and (n % log_every == 0 or n == num_train_steps - 1):
            logger.info("guidance distill step %d/%d loss %.5f", n + 1, num_train_steps, float(loss))
    step.finish()
    if on_done is not None:
        on_done(step)
    return student
