"""Progressive distillation (Salimans & Ho 2022; counterpart of the JAX package's training/distill.py:61-410).

Each round trains a student, a copy of the teacher, to take in ONE DDIM step
what the teacher takes in TWO, so the stride-grid sampler needs half the
steps per round: four rounds turn a 64-step DDIM sampler into a 4-step one.

Timestep grids are the nested stride family ``t_i = (i + 1) * T // N - 1``
(``sampling_times(..., "stride")``): the student's N-step grid is every
other point of the teacher's 2N-step grid, so a distilled model samples with
``ddim_sample(num_steps=N, grid="stride")``, the grid it was trained on.

Per sampled student step ``t -> t_next`` with midpoint ``t_mid`` (``alpha =
sqrt(acp)``, ``sigma = sqrt(1 - acp)``; ``t = -1`` is clean data, alpha 1
and sigma 0)::

    x_t     = alpha_t x0 + sigma_t eps
    x_mid   = DDIM(teacher, x_t, t -> t_mid)
    x_next  = DDIM(teacher, x_mid, t_mid -> t_next)
    x_tilde = (x_next - (sigma_next / sigma_t) x_t) / (alpha_next - (sigma_next / sigma_t) alpha_t)

and the loss is ``mean(max(1, alpha_t^2 / sigma_t^2) * (x0_student - x_tilde)^2)``
in float32. The teacher's x0 predictions are clipped to [-1, 1], the
student's are not; the targets carry no gradient. Only the student's
``parameters()`` reach the optimizer (``torch.optim.Adam`` with optax's
defaults, no clipping, no schedule), so the schedule buffers never change.
With ``ema_decay`` an average ``d * e + (1 - d) * p`` follows every step from
the first, and the round returns it.

Stage 2 of Meng et al. 2023 (``w_range``): teacher and student are
``guidance_embed`` models, and a per-sample guidance scale ``w ~ U[w_range]``
goes to both, so the student stays steerable while its step count halves.

Every step draws ``i ~ U{0..N-1}``, ``eps ~ N(0, 1)`` and, in stage 2, ``w``
from an explicit ``torch.Generator``, in that order; each can be injected
instead, which is how the tests feed both packages the same numbers. The
step runs the denoiser's own routes, so on the card every forward and the
backward go through the ported kernels.

Over a data group (JAX: the batch sharded over ``'data'``, :12-16) each rank
holds its rows of the batch and of the condition, draws ``i``, ``eps`` and
``w`` for the whole batch, as one rank would, and keeps its rows; the
teacher's jumps and the student's forward run on those rows alone. Its loss
is its share, the mean over its rows divided by the ranks, and one
all-reduce sums the shares and the gradients before Adam, so the update,
the EMA and the reported loss are one rank's, bit-equal over the ranks.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Iterator

import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import sampling_times
from video_diffusion_nnx_tpu_torch.utils.image import normalize_img

logger = logging.getLogger(__name__)


def copy_state(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` (the student starts as the teacher): its own tensors, no captured graphs, and no
    buffer that records a gradient (a trainer with full-state Adam leaves the schedule buffers recording)."""
    student = copy.deepcopy(model)
    for buf in student.buffers():
        buf.requires_grad_(False)
    return student


def _gather_acp(acp: torch.Tensor, t: torch.Tensor, ndim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, sigma) at per-sample timesteps ``t``, shaped to broadcast over ``ndim`` axes; ``t = -1`` means clean
    data (alpha 1, sigma 0). The index is clamped first, as JAX's ``where(t >= 0, acp[max(t, 0)], 1)``: a torch
    index of -1 would read ``acp[T - 1]``."""
    a = torch.where(t >= 0, acp[t.clamp(min=0)], torch.ones((), dtype=acp.dtype, device=acp.device))
    a = a.reshape(-1, *((1,) * (ndim - 1)))
    return torch.sqrt(a), torch.sqrt(torch.clamp(1.0 - a, min=0.0))


def _model_x0(model: nn.Module, x: torch.Tensor, t: torch.Tensor, clip: bool, cond: torch.Tensor | None = None,
              w: torch.Tensor | None = None) -> torch.Tensor:
    """The denoiser's x0 prediction under the model's ``prediction_type`` (JAX :91-121).

    With a per-sample guidance scale ``w`` (a ``guidance_embed`` model), one forward with ``guidance_scale=w`` and
    no condition dropout. Without it ``forward_with_cond_scale(..., cond_scale=1.0)``: the one plain (possibly
    conditioned) forward that ``ddim_sample`` evaluates at its default scale (the denoiser's default, 2, would
    distill a guided chain).
    """
    if w is not None:
        out = model.denoise_fn(x, t, cond=cond, null_cond_prob=0.0, guidance_scale=w)
    else:
        out = model.denoise_fn.forward_with_cond_scale(x, t, cond=cond, cond_scale=1.0)
    x0, _ = model._model_out_to_x0_eps(x, t, out.permute(0, 4, 1, 2, 3))
    return torch.clamp(x0, -1.0, 1.0) if clip else x0


def _ddim_jump(acp: torch.Tensor, x: torch.Tensor, x0: torch.Tensor, t: torch.Tensor,
               t_next: torch.Tensor) -> torch.Tensor:
    """The deterministic DDIM update ``t -> t_next`` given the x0 prediction (JAX :124-129)."""
    a_t, s_t = _gather_acp(acp, t, x.ndim)
    a_n, s_n = _gather_acp(acp, t_next, x.ndim)
    eps_hat = (x - a_t * x0) / s_t
    return a_n * x0 + s_n * eps_hat


@torch.no_grad()
def distill_targets(teacher: nn.Module, x_t: torch.Tensor, t: torch.Tensor, t_mid: torch.Tensor,
                    t_next: torch.Tensor, clip_denoised: bool = True, cond: torch.Tensor | None = None,
                    w: torch.Tensor | None = None) -> torch.Tensor:
    """Two teacher DDIM steps ``t -> t_mid -> t_next``, solved for the x0 one student step must predict
    (JAX :132-157). No gradient flows through the teacher."""
    acp = teacher.alphas_cumprod
    x_mid = _ddim_jump(acp, x_t, _model_x0(teacher, x_t, t, clip_denoised, cond, w), t, t_mid)
    x_next = _ddim_jump(acp, x_mid, _model_x0(teacher, x_mid, t_mid, clip_denoised, cond, w), t_mid, t_next)
    a_t, s_t = _gather_acp(acp, t, x_t.ndim)
    a_n, s_n = _gather_acp(acp, t_next, x_t.ndim)
    ratio = s_n / s_t
    return (x_next - ratio * x_t) / (a_n - ratio * a_t)


def nested_grids(num_timesteps: int, student_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(times_N, times_2N), ascending stride grids; the teacher's grid needs ``T >= 2N`` (JAX :160-169)."""
    if num_timesteps < 2 * student_steps:
        raise ValueError(f"student_steps={student_steps} needs timesteps >= {2 * student_steps}")
    return (sampling_times(num_timesteps, student_steps, "stride"),
            sampling_times(num_timesteps, 2 * student_steps, "stride"))


def snr_weight(a_t: torch.Tensor, s_t: torch.Tensor) -> torch.Tensor:
    """The truncated-SNR weight in x0 space, ``max(1, alpha^2 / sigma^2)``."""
    return torch.clamp(a_t**2 / s_t**2, min=1.0)


def distill_loss(student: nn.Module, teacher: nn.Module, x0: torch.Tensor, i: torch.Tensor, eps: torch.Tensor,
                 grids: tuple[torch.Tensor, torch.Tensor], clip_denoised: bool = True,
                 cond: torch.Tensor | None = None, w: torch.Tensor | None = None) -> torch.Tensor:
    """The loss of one step (JAX ``loss_fn``, :204-233) on normalized data ``x0`` at indices ``i`` (b,) of the
    student's grid, with noise ``eps`` (and stage 2's guidance scales ``w``); ``grids`` is ``nested_grids``' pair
    on x0's device."""
    tN, t2N = grids
    t = tN[i]
    t_mid = t2N[2 * i]
    t_next = torch.where(i > 0, tN[(i - 1).clamp(min=0)], torch.full_like(i, -1))
    a_t, s_t = _gather_acp(teacher.alphas_cumprod, t, x0.ndim)
    x_t = a_t * x0 + s_t * eps
    x_tilde = distill_targets(teacher, x_t, t, t_mid, t_next, clip_denoised, cond, w)
    x0_hat = _model_x0(student, x_t, t, clip=False, cond=cond, w=w)
    return torch.mean(snr_weight(a_t, s_t) * (x0_hat - x_tilde) ** 2)


class StudentOptimizer:
    """A student's Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8; no clipping, a constant rate) over its
    parameters only, and optionally the EMA ``d * e + (1 - d) * p`` after every step. Each step's loss stays on
    the device in ``losses``; ``step_starts`` holds the host clock at the start of each step, and ``end`` (set by
    :meth:`finish`) the host clock once the device has finished the last one. Under ``group`` (a
    ``parallel.SequenceGroup`` of data ranks) each step's loss is this rank's share, and :meth:`update` sums the
    shares and the gradients over the ranks."""

    def __init__(self, student: nn.Module, learning_rate: float, ema_decay: float | None = None, group=None):
        self.student = student
        self.group = group if group is not None and group.world_size > 1 else None
        # Parameters only (JAX ``split_trainable``, :71-80): the schedule buffers are constants of the noising process.
        self.params = [p for p in student.parameters() if p.requires_grad]
        device = self.params[0].device
        self.optimizer = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                          foreach=device.type == "cuda")
        self.ema_decay = ema_decay
        self.ema = None if ema_decay is None else [p.detach().clone() for p in self.params]
        self.losses: list[torch.Tensor] = []
        self.step_starts: list[float] = []
        self.end: float | None = None

    def draw_rows(self, rows: int) -> tuple[int, slice | None]:
        """The whole batch's size for this rank's ``rows``, and this rank's slice of it (None on one rank)."""
        if self.group is None:
            return rows, None
        n = rows * self.group.world_size
        return n, self.group.rows(n)

    def share(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of the batch's loss, its rows' mean over the ranks."""
        return loss if self.group is None else loss / self.group.world_size

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and the loss over the ranks in one all-reduce; returns the summed loss. The ranks
        reach the same parameters (no mask is drawn), so each sends the same list."""
        live = [p for p in self.params if p.grad is not None]
        flat = self.group.all_reduce(torch.cat([*(p.grad.reshape(-1) for p in live), loss.detach().reshape(1)]))
        for p, g in zip(live, flat[:-1].split([p.numel() for p in live])):
            p.grad = g.view_as(p)
        return flat[-1]

    def update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, the reduction over the ranks, one Adam update, the EMA; returns the detached loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.group is not None:
            loss = self._reduce(loss)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, self.ema_decay)
                torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)
        loss = loss.detach()
        self.losses.append(loss)
        return loss

    def finish(self) -> None:
        """Wait for the device to finish the queued steps and note the host clock (``end``)."""
        if self.params[0].is_cuda:
            torch.cuda.synchronize(self.params[0].device)
        self.end = time.perf_counter()

    def result(self) -> nn.Module:
        """The student, with the EMA in place of its parameters where there is one."""
        if self.ema is not None:
            with torch.no_grad():
                for p, e in zip(self.params, self.ema):
                    p.copy_(e)
        return self.student


class DistillStep(StudentOptimizer):
    """One halving round's step (JAX ``build_distill_step``, :172-292): a student copied from ``teacher`` whose
    ``student_steps``-step stride-grid DDIM learns the teacher's ``2 * student_steps``-step one."""

    def __init__(self, teacher: nn.Module, student_steps: int, learning_rate: float = 1e-4,
                 clip_denoised: bool = True, w_range: tuple[float, float] | None = None,
                 ema_decay: float | None = None, generator: torch.Generator | None = None, group=None):
        self.teacher = teacher
        super().__init__(copy_state(teacher), learning_rate, ema_decay, group)
        self.student_steps = student_steps
        self.grids = tuple(g.to(self.params[0].device) for g in nested_grids(teacher.num_timesteps, student_steps))
        self.clip_denoised = clip_denoised
        self.w_range = w_range
        self.generator = generator

    def __call__(self, batch: torch.Tensor, cond: torch.Tensor | None = None, i: torch.Tensor | None = None,
                 eps: torch.Tensor | None = None, w: torch.Tensor | None = None) -> torch.Tensor:
        """One step on raw data ``batch`` in [0, 1] (normalized here; this rank's rows under a group, ``cond``
        too); returns the batch's loss. ``i``, ``eps`` and ``w`` are the whole batch's, drawn from the generator,
        in that order, where not given."""
        self.step_starts.append(time.perf_counter())
        x0 = normalize_img(batch.float())
        dev = x0.device
        b, rows = self.draw_rows(x0.shape[0])
        if i is None:
            i = torch.randint(0, self.student_steps, (b,), generator=self.generator, device=dev)
        if eps is None:
            eps = torch.randn((b, *x0.shape[1:]), generator=self.generator, device=dev)
        if self.w_range is None:
            w = None
        elif w is None:
            lo, hi = (float(v) for v in self.w_range)
            w = lo + (hi - lo) * torch.rand(b, generator=self.generator, device=dev)
        if rows is not None:
            i, eps, w = i[rows], eps[rows], None if w is None else w[rows]
        loss = distill_loss(self.student, self.teacher, x0, i.to(dev), eps, self.grids, self.clip_denoised, cond, w)
        return self.update(self.share(loss))


def _split(batch, conditioned: bool):
    return batch if conditioned else (batch, None)


def distill_round(teacher: nn.Module, data_iter: Iterator, *, student_steps: int, num_train_steps: int,
                  generator: torch.Generator | None = None, learning_rate: float = 1e-4, clip_denoised: bool = True,
                  conditioned: bool = False, w_range: tuple[float, float] | None = None,
                  ema_decay: float | None = None, log_every: int = 50,
                  on_done: Callable[[DistillStep], None] | None = None, group=None) -> nn.Module:
    """One halving round (JAX :295-353): ``num_train_steps`` steps of a student copied from ``teacher``; returns
    the student with its EMA in place (or the raw student without ``ema_decay``). ``data_iter`` yields raw
    batches, or ``(batch, cond)`` pairs when ``conditioned`` (this rank's rows under ``group``). ``on_done`` sees
    the round's step after it."""
    step = DistillStep(teacher, student_steps, learning_rate, clip_denoised, w_range, ema_decay, generator, group)
    for n in range(num_train_steps):
        batch, cond = _split(next(data_iter), conditioned)
        loss = step(batch, cond)
        if log_every and (n % log_every == 0 or n == num_train_steps - 1):
            logger.info("distill N=%d step %d/%d loss %.5f", student_steps, n + 1, num_train_steps, float(loss))
    step.finish()
    if on_done is not None:
        on_done(step)
    return step.result()


def progressive_distill(teacher: nn.Module, data_iter: Iterator, *, initial_steps: int, rounds: int,
                        steps_per_round: int, generator: torch.Generator | None = None,
                        learning_rate: float = 1e-4, clip_denoised: bool = True, conditioned: bool = False,
                        w_range: tuple[float, float] | None = None, ema_decay: float | None = None,
                        on_round_end: Callable[[int, nn.Module], None] | None = None,
                        on_done: Callable[[DistillStep], None] | None = None, group=None) -> tuple[nn.Module, int]:
    """The whole schedule (JAX :356-410): students at ``initial_steps``, half that, ... for ``rounds`` halvings,
    each round's student the next round's teacher. ``on_round_end(student_steps, student)`` fires after each
    round; an odd step count stops the halving early. Under ``group`` every round splits its batches' rows over
    the data ranks. Returns ``(student, final_steps)``: sample it with ``ddim_sample(num_steps=final_steps,
    grid="stride")``."""
    steps, model = initial_steps, teacher
    for r in range(rounds):
        logger.info("progressive distillation round %d/%d: %d-step teacher -> %d-step student",
                    r + 1, rounds, 2 * steps, steps)
        model = distill_round(model, data_iter, student_steps=steps, num_train_steps=steps_per_round,
                              generator=generator, learning_rate=learning_rate, clip_denoised=clip_denoised,
                              conditioned=conditioned, w_range=w_range, ema_decay=ema_decay,
                              on_done=on_done, group=group)
        if on_round_end is not None:
            on_round_end(steps, model)
        if r + 1 < rounds:
            if steps % 2:
                logger.warning("stopping early: %d steps is odd, cannot halve", steps)
                break
            steps //= 2
    return model, steps
