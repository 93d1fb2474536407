"""Trainer: the training loop with Adam, EMA and checkpoints, on one device or one sequence group.

Counterpart of the JAX package's training/trainer.py (:84-475 construction,
:480-711 the step and the loop), unconditioned or text-conditioned, in
reference-compat or fixed math, on one device or, in compat math, over a
sequence-parallel group (``sequence_parallel_size > 1``). Semantics kept
from it:

* Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) under the
  hold-then-cosine learning rate of ``optax.piecewise_interpolate_schedule``
  (:180-187), evaluated at the optimizer's update count before the update;
* the gradient clipped to ``max_grad_norm`` when it is set, its norm logged
  either way;
* the EMA ``decay * ema + (1 - decay) * params`` on steps with
  ``step >= step_start_ema and step % update_ema_every == 0`` (:579-595);
* a checkpoint every ``checkpoint_every_steps`` and at the end, one file per
  step (``convert.save_checkpoint``: parameters, EMA and, with
  ``save_optimizer_state``, the optimizer), and resume from one; a missing or
  mismatched optimizer state means a fresh optimizer and a warning;
* the loss of a step is logged after the next step is queued, so the host
  never waits on the step it has just launched (:656-677).
* the clips come from a Moving-MNIST ``.npy`` or, where ``dataset_path`` is
  a folder, from the GIFs under it (``GifVideoDataset``, :334-345);
* with ``use_path_as_cond`` each GIF's file name is its caption, embedded on
  the host in the loader's thread (``collate_with_text_cond``), and each step
  passes the embeddings and ``null_cond_prob`` (classifier-free guidance's
  dropout, drawn from the trainer's generator) to the loss (:227-234,
  :493-510). ``sample_text`` and ``cond_scale`` are kept for sampling during
  training, which is not ported (ROADMAP A8).

Full-state Adam (``freeze_schedule_buffers: false``, the default): the ten
schedule buffers of the diffusion model take part in the loss's autograd
graph, the gradient clip, Adam (their moments in the optimizer state) and
the EMA, as every leaf of the JAX package's state does (:545-577, PARITY
#11). Those with a gradient path (``sqrt_alphas_cumprod`` and
``sqrt_one_minus_alphas_cumprod`` through ``q_sample``) drift; the others
get no gradient, so Adam leaves them bit-exact; the checkpoint carries the
drifted values. ``freeze_schedule_buffers: true`` keeps all ten out.

Sequence parallelism: the trainer runs on one rank of a ``SequenceGroup``
whose world size is ``sequence_parallel_size`` (data parallelism stays at
one; the train CLI starts the ranks). It attaches the group to the
denoiser, so each rank computes on its own frames and the loss is its
share. After the backward the gradients are summed over the ranks, before
the clip, so the norm, Adam and the EMA are bit-equal on every rank; the
logged loss is the sum of the shares. Rank 0 alone writes checkpoints,
metrics and logs; every rank reads the checkpoint on resume.

The options this port does not cover raise ``NotImplementedError`` naming
their ROADMAP item. The batch order comes from
``np.random.default_rng(rng_seed)`` as in the JAX package, the same on
every rank; timesteps and noise from a ``torch.Generator`` seeded with
``rng_seed`` (JAX's key chain cannot be reproduced).
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from video_diffusion_nnx_tpu_torch.convert import read_checkpoint, save_checkpoint
from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
from video_diffusion_nnx_tpu_torch.data.loader import collate_with_text_cond, endless_prefetching_loader
from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.training.metrics import create_summary_writer
from video_diffusion_nnx_tpu_torch.utils.grad import clip_grad_norm, global_l2_norm

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def lr_schedule(train_lr: float, lr_decay_start_step: int, lr_decay_steps: int,
                lr_decay_coeff: float) -> Callable[[int], float]:
    """``optax.piecewise_interpolate_schedule('cosine', train_lr, {start: 1, start + steps: coeff})``.

    Hold ``train_lr`` until ``lr_decay_start_step``, then cosine down to
    ``train_lr * lr_decay_coeff`` over ``lr_decay_steps``. A boundary interval
    of zero length never holds, as in optax (where its zero divide is masked out).
    """
    scales = dict(sorted({lr_decay_start_step: 1.0, lr_decay_start_step + lr_decay_steps: lr_decay_coeff}.items()))
    bounds = [0, *scales]
    values = np.cumprod([train_lr, *scales.values()]).tolist()

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return 0.0

    return schedule


class _NullWriter:
    """The metrics writer of a rank other than 0: writes nothing."""

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Training runtime for a ``GaussianDiffusion`` on one device or one rank of a sequence group."""

    def __init__(
        self,
        diffusion_model: torch.nn.Module,
        folder: str,
        *,
        rng_seed: int = 0,
        dataset_path: str,
        num_frames: int = 16,
        train_batch_size: int = 4,
        train_lr: float = 1e-4,
        train_num_steps: int = 100000,
        gradient_accumulate_every: int = 2,
        step_start_ema: int = 2000,
        update_ema_every: int = 10,
        save_and_sample_every: int = 100000,
        results_folder: str = "./results",
        num_sample_rows: int = 4,
        max_grad_norm: float | None = None,
        use_path_as_cond: bool = False,
        sample_text: str | None = None,
        cond_scale: float = 2.0,
        checkpoint_every_steps: int = 10,
        checkpoint_dir_path: str = "",
        add_loss_plot: bool = False,
        tensorboard_dir: str = "",
        resume_training_step: int = 0,
        ema_decay: float = 0.9999,
        max_to_keep: int | None = None,
        lr_decay_start_step: int = 0,
        lr_decay_steps: int = 0,
        lr_decay_coeff: float = 1.0,
        profile_flush_step: int = 100,
        num_model_shards: int = 1,
        enable_gradient_accumulation: bool = False,
        prefetch_depth: int = 2,
        dataset_normalize: bool = False,
        param_sharding: str = "tensor",
        fsdp_min_size_to_shard: int = 2**14,
        save_optimizer_state: bool = False,
        log_every_steps: int = 1,
        sequence_parallel_size: int = 1,
        async_checkpointing: bool = False,
        null_cond_prob: float = 0.0,
        freeze_schedule_buffers: bool = False,
        flatten_optimizer: bool = False,
        sequence_group=None,
    ):
        if enable_gradient_accumulation and gradient_accumulate_every > 1:
            raise _not_ported("gradient accumulation", "A7")
        if num_model_shards > 1 or param_sharding != "tensor":
            raise _not_ported("model sharding and FSDP", "A15")
        if flatten_optimizer:
            raise _not_ported("flatten_optimizer (a fused Adam and EMA)", "A7")
        if async_checkpointing:
            raise _not_ported("asynchronous checkpointing", "A8")
        # The loop's steps run from 0 to train_num_steps - 1, and a sample is due at a positive multiple
        # of save_and_sample_every (JAX trainer.py:687-693): the default, 100000 at 100000 steps, asks for none.
        if save_and_sample_every and 0 < save_and_sample_every < train_num_steps:
            raise _not_ported("sampling during training (save_and_sample_every)", "A8")
        if profile_flush_step > 0:
            logger.info("profile_flush_step=%d: the profiler trace is not ported (ROADMAP A8); "
                        "scripts/torch_profile_step.py profiles a step", profile_flush_step)

        self.model = diffusion_model
        self.device = diffusion_model.device
        self.sequence_group = sequence_group
        if sequence_parallel_size > 1 or sequence_group is not None:
            self._attach_sequence_group(sequence_parallel_size)
        self.is_main = sequence_group is None or sequence_group.rank == 0
        self.train_num_steps = train_num_steps
        self.batch_size = train_batch_size
        self.max_grad_norm = max_grad_norm
        self.use_path_as_cond = use_path_as_cond
        self.null_cond_prob = null_cond_prob
        self.sample_text = sample_text
        self.cond_scale = cond_scale
        self.step_start_ema = step_start_ema
        self.update_ema_every = update_ema_every
        self.ema_decay = ema_decay
        self.log_every_steps = max(1, log_every_steps)
        self.checkpoint_every_steps = checkpoint_every_steps
        self.max_to_keep = max_to_keep
        self.save_optimizer_state = save_optimizer_state
        self.add_loss_plot = add_loss_plot
        self.lr_schedule = lr_schedule(train_lr, lr_decay_start_step, lr_decay_steps, lr_decay_coeff)

        trained = [k for k, p in self.model.named_parameters() if p.requires_grad]
        if not freeze_schedule_buffers:  # full-state Adam: the schedule buffers train with the weights
            for name in BUFFER_NAMES:
                getattr(self.model, name).requires_grad_(True)
            trained += list(BUFFER_NAMES)
        state = self.model.state_dict(keep_vars=True)
        self.params = [state[k] for k in trained]
        self.optimizer = self._new_optimizer(train_lr)
        self.opt_count = 0  # optax's update count, which the learning rate is read at
        self.ema_state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._ema_params = [self.ema_state[k] for k in trained]
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)

        self.image_size = diffusion_model.image_size
        logger.info("Loading dataset from: %s", dataset_path)
        collate_fn = None
        if Path(dataset_path).is_dir():  # a folder of GIF clips, captioned by file name when asked (JAX :334-349)
            self.ds = GifVideoDataset(dataset_path, image_size=self.image_size, channels=diffusion_model.channels,
                                      num_frames=diffusion_model.num_frames, force_num_frames=True,
                                      use_path_as_cond=use_path_as_cond)
            if use_path_as_cond:
                collate_fn = collate_with_text_cond
        elif use_path_as_cond:
            raise ValueError(f"use_path_as_cond captions clips by their file names: dataset_path {dataset_path} "
                             "must be a folder of GIFs")
        else:
            self.ds = MovingMNIST(dataset_path, image_size=(self.image_size, self.image_size),
                                  num_frames=diffusion_model.num_frames, force_num_frames=True,
                                  normalize=dataset_normalize)
        logger.info("Found %d sequences in dataset.", len(self.ds))
        if len(self.ds) < self.batch_size:
            raise ValueError(f"dataset {dataset_path} has {len(self.ds)} clips, fewer than a batch")
        self.dl = endless_prefetching_loader(self.ds, self.batch_size, self.device, seed=rng_seed,
                                             depth=prefetch_depth, collate_fn=collate_fn)

        self.results_folder = Path(results_folder).resolve()
        self.results_folder.mkdir(exist_ok=True, parents=True)
        self.checkpoint_dir_path = (Path(checkpoint_dir_path).resolve() if checkpoint_dir_path
                                    else self.results_folder / "checkpoints")
        self.checkpoint_dir_path.mkdir(exist_ok=True, parents=True)
        self.tensorboard_dir = (Path(tensorboard_dir).resolve() if tensorboard_dir
                                else self.results_folder / "tensorboard")
        self.tensorboard_dir.mkdir(exist_ok=True, parents=True)
        self.writer = create_summary_writer(str(self.tensorboard_dir)) if self.is_main else _NullWriter()

        self.step = resume_training_step
        if self.step > 0:
            self._resume()
        self.step_starts: list[float] = []  # host clock at the start of each step of the loop
        self.save_seconds: dict[int, float] = {}  # host seconds of each checkpoint write inside the loop
        # Every step's loss, kept on the device (no host sync); NaN for steps not run here.
        self.loss_trace = torch.full((train_num_steps,), float("nan"), device=self.device)

    def _attach_sequence_group(self, size: int) -> None:
        """Check the group against the recipe and attach it to the denoiser (JAX :155-175)."""
        group = self.sequence_group
        if group is None:
            raise ValueError(f"sequence_parallel_size {size} runs over a group of {size} ranks: start them with "
                             "the train CLI, or pass each rank's sequence_group")
        if group.world_size != size:
            raise _not_ported(f"data parallelism (a group of {group.world_size} ranks for sequence_parallel_size "
                              f"{size})", "A15")
        denoiser = self.model.denoise_fn
        if not getattr(denoiser, "reference_compat", False):
            raise ValueError("sequence parallelism needs a reference_compat denoiser")
        if self.model.num_frames % size:
            raise ValueError(f"num_frames={self.model.num_frames} must divide by sequence_parallel_size={size}")
        if self.device != group.device:
            raise ValueError(f"the model is on {self.device}, the rank's device is {group.device}")
        denoiser.sequence_parallel_mesh = group

    # Steps.

    def _new_optimizer(self, lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                foreach=self.device.type == "cuda")

    def checkpoint_path(self, step: int) -> Path:
        return self.checkpoint_dir_path / f"step_{step}.pt"

    def train_step(self, batch, t=None, noise=None, prob_focus_present: float = 0.0,
                   focus_present_mask=None):
        """One step on ``batch`` ((b, c, f, h, w) in [0, 1], or with ``use_path_as_cond`` the pair of it and the
        (b, cond_dim) condition): loss, gradient, clip, Adam, EMA.

        ``t`` and ``noise`` may be injected; otherwise they come from the
        trainer's generator, as do the focus mask that ``prob_focus_present``
        asks for and the condition's dropout (``null_cond_prob``), in that
        order. Under a sequence group ``batch`` (and injected noise) is the
        whole clip, and the loss returned is summed over the ranks. Returns
        ``(loss, grad_norm)`` as device tensors.
        """
        cond_kw = {}
        if self.use_path_as_cond:
            batch, cond = batch
            cond_kw = {"cond": cond, "null_cond_prob": self.null_cond_prob}
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model(batch, generator=self.generator, t=t, noise=noise,
                          focus_present_mask=focus_present_mask, prob_focus_present=prob_focus_present, **cond_kw)
        loss.backward()
        with torch.no_grad():
            live = [p for p in self.params if p.grad is not None]
            grads = [p.grad for p in live]
            if self.sequence_group is not None:  # each rank holds its share of the gradient: sum them
                flat = self.sequence_group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
                grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
                for p, g in zip(live, grads):
                    p.grad = g
                loss = self.sequence_group.all_reduce(loss.detach())
            if self.max_grad_norm is not None:
                clipped, grad_norm = clip_grad_norm(grads, self.max_grad_norm)
                for p, g in zip(live, clipped):
                    p.grad = g
            else:
                grad_norm = global_l2_norm(grads)
            lr = self.lr_schedule(self.opt_count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.opt_count += 1
            if self.step >= self.step_start_ema and self.step % self.update_ema_every == 0:
                torch._foreach_mul_(self._ema_params, self.ema_decay)
                torch._foreach_add_(self._ema_params, self.params, alpha=1.0 - self.ema_decay)
        return loss.detach(), grad_norm

    def train(self, prob_focus_present: float = 0.0, log_fn: Callable = lambda _: None) -> None:
        """Run the loop from ``self.step`` to ``train_num_steps``, then save the final checkpoint.

        ``prob_focus_present`` (JAX ``train``, :625-635) masks each sample's temporal attentions
        with that probability in every step; only a fixed-math denoiser heeds it.
        """
        logger.info("Starting training loop from step %d...", self.step)
        self.model.train()
        pending = None
        last = time.time()
        while self.step < self.train_num_steps:
            self.step_starts.append(time.perf_counter())
            batch = next(self.dl)
            loss, grad_norm = self.train_step(batch, prob_focus_present=prob_focus_present)
            self.loss_trace[self.step] = loss
            now = time.time()
            self.writer.add_scalar("step_time", now - last, self.step)
            last = now
            if pending is not None:
                self._log(*pending, log_fn)
                pending = None
            if self.step % self.log_every_steps == 0:
                pending = (self.step, loss, grad_norm, self.lr_schedule(self.step))
            if self.step > 0 and self.step % self.checkpoint_every_steps == 0:
                logger.info("Step: %d | Saving checkpoint...", self.step)
                self._synchronize()  # the save waits on the queued step anyway; time the write alone
                t0 = time.perf_counter()
                self.save()
                self.save_seconds[self.step] = time.perf_counter() - t0
            self.step += 1
        if pending is not None:
            self._log(*pending, log_fn)
        self._synchronize()
        self.step_starts.append(time.perf_counter())
        logger.info("Training completed! Saving final checkpoint...")
        self.save()
        self._write_loss_plot()
        self.writer.close()

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, step: int, loss, grad_norm, lr: float, log_fn: Callable) -> None:
        if not self.is_main:
            return
        loss_v, norm_v = loss.item(), grad_norm.item()
        logger.info("Step: %d/%d | Loss: %.4f", step, self.train_num_steps, loss_v)
        log_fn({"loss": loss_v, "step": step})
        self.writer.add_scalar("loss/train", loss_v, step)
        self.writer.add_scalar("lr/train", lr, step)
        self.writer.add_scalar("grad_norm/train", norm_v, step)

    # Checkpoints.

    def save(self) -> Path | None:
        """Write this step's checkpoint file, unless it exists (a resumed step); keep ``max_to_keep``.

        Only rank 0 of a sequence group writes (the ranks' states are bit-equal).
        """
        if not self.is_main:
            return None
        path = self.checkpoint_path(self.step)
        if path.exists():
            logger.info("Checkpoint for step %d already exists; skipping save", self.step)
            return None
        optimizer = None
        if self.save_optimizer_state:
            optimizer = {"adam": self.optimizer.state_dict(), "count": self.opt_count}
        save_checkpoint(path, self.model, self.ema_state, optimizer=optimizer, step=self.step)
        if self.max_to_keep:
            kept = sorted(self.checkpoint_dir_path.glob("step_*.pt"), key=lambda p: int(p.stem[5:]))
            for old in kept[:-self.max_to_keep]:
                old.unlink()
        return path

    def _resume(self) -> None:
        path = self.checkpoint_path(self.step)
        logger.info("Attempting to resume training from step %d", self.step)
        if not path.is_file():
            logger.warning("Checkpoint for step %d not found at %s.", self.step, self.checkpoint_dir_path)
            self.step = 0
            return
        payload = read_checkpoint(path)
        self.model.load_state_dict(payload["model"], strict=True)
        if payload.get("ema_params") is not None:
            for k, v in payload["ema_params"].items():
                self.ema_state[k].copy_(v)
        opt = payload.get("optimizer")
        if opt is None:
            logger.warning("No optimizer state for step %d; starting a fresh optimizer", self.step)
            return
        try:
            self.optimizer.load_state_dict(opt["adam"])
            self.opt_count = int(opt["count"])
            logger.info("Restored optimizer state for step %d", self.step)
        except (KeyError, ValueError, RuntimeError) as e:
            logger.warning("Optimizer state for step %d does not fit this model (%s); "
                           "starting a fresh optimizer", self.step, e)
            self.optimizer = self._new_optimizer(self.lr_schedule(0))
            self.opt_count = 0
        logger.info("Successfully loaded checkpoint state for step %d", self.step)

    def _write_loss_plot(self) -> None:
        losses = self.loss_trace.tolist()
        steps = [i for i, v in enumerate(losses) if v == v]  # the steps run here (NaN elsewhere)
        if not (self.add_loss_plot and steps and self.is_main):
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 4.5))
            ax.plot(steps, [losses[i] for i in steps], linewidth=1)
            ax.set_xlabel("step")
            ax.set_ylabel("loss")
            ax.set_title(f"Training loss over {steps[-1] + 1} steps")
            fig.tight_layout()
            fig.savefig(self.results_folder / "loss_plot.png", dpi=120)
            plt.close(fig)
        except Exception as e:  # a plot never fails training
            logger.error("Error writing loss plot: %s", e)
