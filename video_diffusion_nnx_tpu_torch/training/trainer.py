"""Trainer: the training loop with Adam, EMA and checkpoints, on one device or one rank of a mesh.

Counterpart of the JAX package's training/trainer.py (:84-475 construction,
:480-711 the step and the loop, :748-828 checkpoints and samples),
unconditioned or text-conditioned, in reference-compat or fixed math, on one
device or over a mesh of ranks (below). Semantics kept from it:

* Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) under the
  hold-then-cosine learning rate of ``optax.piecewise_interpolate_schedule``
  (:180-187), evaluated at the optimizer's update count before the update;
* the gradient clipped to ``max_grad_norm`` when it is set, its norm logged
  either way;
* the EMA ``decay * ema + (1 - decay) * params`` on steps with
  ``step >= step_start_ema and step % update_ema_every == 0`` (:579-595);
* gradient accumulation (``enable_gradient_accumulation`` with
  ``gradient_accumulate_every`` A > 1, :521-543): the batch splits into A
  microbatches of consecutive rows (the condition and any injected t, noise
  or focus mask with them); each runs its forward and backward, drawing its
  own t, noise and masks from the trainer's generator in turn, and ``.grad``
  sums in place; the step then takes the mean loss and the mean gradient
  (the sum times 1/A) and clips, steps Adam and updates the EMA once;
* ``flatten_optimizer`` (``optax.flatten``, :204-221, :580-586) is accepted
  and runs the same step: it changes only how optax lays out Adam's state,
  and the clip (one global norm), Adam and the EMA are elementwise, so
  per-tensor ``foreach`` launches compute the flat run's numbers. Parameters,
  EMA and Adam's moments keep the per-tensor layout in checkpoints either
  way, so a run with the option resumes from one without it and back;
* a checkpoint every ``checkpoint_every_steps`` and at the end, one file per
  step (``convert.checkpoint_payload``: parameters, EMA and, with
  ``save_optimizer_state``, the optimizer, copied to host memory), and resume
  from one; a missing or mismatched optimizer state means a fresh optimizer
  and a warning. With ``async_checkpointing`` (:748-789) the loop takes the
  host copy and a background thread writes the file: one write in flight at
  a time, ``max_to_keep`` pruned after each write. A failed periodic save is
  logged and training goes on, with or without ``async_checkpointing``; the
  final save waits for every write and raises if it fails;
* with ``save_and_sample_every`` in (0, train_num_steps], on steps
  ``step > 0`` that it divides (:683-693, :795-828), ``num_sample_rows``
  DDPM samples of the EMA (the whole EMA state, the drifted schedule buffers
  too under full-state Adam; ``sample_text`` at ``cond_scale`` for a
  conditioned model) go to ``results/samples/step_{N}/sample_{i}.gif``. The
  sample draws from a generator of its own (seeded ``rng_seed + 1``), swaps
  the EMA tensors into the model by reference and back, and drops the CUDA
  graphs it captured, so the parameters, Adam's state, the trainer's
  generator and every later loss are what they would have been without it;
  a failed sample is logged;
* with ``profile_flush_step > 0`` (:643-654, :697-704) ``torch.profiler``
  traces the loop from its start until ``step == profile_flush_step`` (or the
  loop's end, or a sample, which captures CUDA graphs and is not traced),
  one ``train_step#N`` range around each step, and writes one Chrome trace per
  run under ``tensorboard_dir``; a profiler that cannot start logs a
  warning. ``jax.profiler.start_server(9999)`` needs no counterpart: a
  torch profiler attaches to nothing over the network;
* the loss of a step is logged after the next step is queued, so the host
  never waits on the step it has just launched (:656-677).
* the clips come from a Moving-MNIST ``.npy`` or, where ``dataset_path`` is
  a folder, from the GIFs under it (``GifVideoDataset``, :334-345);
* with ``use_path_as_cond`` each GIF's file name is its caption, embedded on
  the host in the loader's thread (``collate_with_text_cond``), and each step
  passes the embeddings and ``null_cond_prob`` (classifier-free guidance's
  dropout, drawn from the trainer's generator) to the loss (:227-234,
  :493-510).

Full-state Adam (``freeze_schedule_buffers: false``, the default): the ten
schedule buffers of the diffusion model take part in the loss's autograd
graph, the gradient clip, Adam (their moments in the optimizer state) and
the EMA, as every leaf of the JAX package's state does (:545-577, PARITY
#11). Those with a gradient path (``sqrt_alphas_cumprod`` and
``sqrt_one_minus_alphas_cumprod`` through ``q_sample``) drift; the others
get no gradient, so Adam leaves them bit-exact; the checkpoint carries the
drifted values. ``freeze_schedule_buffers: true`` keeps all ten out.

Over several ranks (the train CLI's ``--ranks``; ``sequence_group`` is the
rank's group of the whole world) the trainer builds a mesh by the JAX
trainer's rules (:154-175, :244-281): ``('data', 'seq')`` when
``sequence_parallel_size`` S > 1, which composes with data parallelism only
(the world must divide by S, the batch by the data size, the denoiser must
be compat math), else ``('data', 'model')`` of ``num_model_shards`` M (the
batch must divide by the world; a world smaller than M clamps M to
gcd(world, M) with JAX's warning, one that M does not divide raises).

The design, deliberately: JAX and its tests treat every mesh as a layout,
not a change of the maths, so the port computes data-parallel over rows
and stores state by JAX's PartitionSpecs. Each rank trains on its rows of
every batch (over the data axis under a seq axis, else over the whole
world: ``data/loader.py`` ``rank_rows``) and, under a seq axis, on its frames
of every clip, the seq axis attached to the denoiser. The diffusion model
draws t, the noise and the masks for the whole batch and keeps the rank's
part, and the loss is the rank's share. Where GSPMD splits a layer's
compute over a model axis is XLA's choice, not a declared part of the JAX
package: here a model axis shards storage, never a matmul, and no layer's
channels split the Megatron way.

State: under ``param_sharding: fsdp`` over a data axis larger than 1, or
under a model axis larger than 1 by the last-dim rule (``parallel/
sharding.py``; a seq mesh replicates, as in JAX), each trained tensor the
rule shards keeps its float32 parameter, both Adam moments and its EMA only
as this rank's shard between steps. A step all-gathers the parameters into
the module, runs every microbatch, then reduces once: the replicated
gradients summed over the world, the sharded ones reduce-scattered to
their owners along the shard axis (and summed over the other axis). The
clip takes the global norm, the replicated tensors' squares plus the
shards' squares all-reduced along the shard axis; Adam and the EMA update
the shards, and the gathered weights are released. Replicated state is
bit-equal on every rank; the logged loss is the sum of the shares.

Rank 0 alone writes checkpoints, metrics, logs, samples and the profiler
trace. A checkpoint is the file a one-rank run writes (the shards gathered,
Adam's moments too under ``save_optimizer_state``); every rank reads it and
takes its shards, so a file written at one world size resumes at any other,
as Orbax restores into any layout. Sampling during training runs on every
rank, each on its rows (and frames), and rank 0 gathers the videos.

The batch order comes from ``np.random.default_rng(rng_seed)`` as in the
JAX package, the same on every rank; timesteps and noise from a
``torch.Generator`` seeded with ``rng_seed`` (JAX's key chain cannot be
reproduced), the same stream on every rank.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from video_diffusion_nnx_tpu_torch.convert import checkpoint_payload, read_checkpoint, write_checkpoint
from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
from video_diffusion_nnx_tpu_torch.data.loader import collate_with_text_cond, endless_prefetching_loader, rank_rows
from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.parallel.mesh import make_mesh
from video_diffusion_nnx_tpu_torch.parallel.sharding import state_partition_specs
from video_diffusion_nnx_tpu_torch.training.metrics import create_summary_writer
from video_diffusion_nnx_tpu_torch.utils.grad import clip_grad_norm, global_l2_norm, sum_of_squares
from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

logger = logging.getLogger(__name__)


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


class CheckpointWriter:
    """Writes checkpoint files from host copies on a background thread, one write in flight at a time."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.path: Path | None = None  # the file being written, until ``wait`` returns

    def submit(self, path: Path, payload: dict, after: Callable[[], None]) -> None:
        """Wait for the write in flight, then write ``payload`` to ``path`` and call ``after`` on a thread.

        A failed write is logged (a periodic save never stops training, JAX trainer.py:786-789).
        """
        self.wait()

        def run():
            try:
                write_checkpoint(path, payload)
                after()
                logger.info("Wrote checkpoint %s", path)
            except Exception as e:
                logger.error("Error saving checkpoint %s: %s", path, e)

        self.path = path
        self._thread = threading.Thread(target=run, name=f"checkpoint-{path.stem}")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        self._thread, self.path = None, None


class Trainer:
    """Training runtime for a ``GaussianDiffusion`` on one device or one rank of a mesh."""

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
        flatten_optimizer: bool = False,  # the same step either way: see the module docstring
        sequence_group=None,  # this rank's group of the whole world (train.run_rank's), or None for one rank
    ):
        if param_sharding not in ("tensor", "fsdp"):
            raise ValueError(f"param_sharding must be 'tensor' or 'fsdp'; got {param_sharding!r}")
        if flatten_optimizer and (num_model_shards != 1 or param_sharding != "tensor"):  # JAX :206-209
            raise ValueError("flatten_optimizer supports replicated parameters only (num_model_shards=1, "
                             "param_sharding='tensor'); a flat moment buffer cannot carry per-tensor shardings")
        self.accumulate = gradient_accumulate_every if enable_gradient_accumulation else 1
        if self.accumulate > 1 and train_batch_size % self.accumulate:
            raise ValueError(f"train_batch_size {train_batch_size} must divide into gradient_accumulate_every "
                             f"{self.accumulate} microbatches")
        # A sample is due at each positive multiple of save_and_sample_every that the loop's steps, 0 to
        # train_num_steps - 1, reach (JAX trainer.py:687-693): the default, 100000 at 100000 steps, asks for none.
        self.save_and_sample_every = save_and_sample_every
        samples_due = bool(save_and_sample_every) and 0 < save_and_sample_every < train_num_steps

        self.model = diffusion_model
        self.device = diffusion_model.device
        self.group = sequence_group
        shape = self._mesh_shape(sequence_parallel_size, num_model_shards, train_batch_size)
        self.mesh = None if sequence_group is None else make_mesh(sequence_group, shape)
        self.is_main = sequence_group is None or sequence_group.rank == 0
        # The ranks a batch's rows split over: the data axis under a seq axis, else the whole world.
        seq = sequence_parallel_size > 1
        self.row_group = None
        if self.mesh is not None:
            self.row_group = self.mesh.axis("data") if seq else self.mesh.world
            if seq:
                self.model.denoise_fn.sequence_parallel_mesh = self.mesh.axis("seq")
            if self.row_group.world_size > 1:
                self.model.data_group = self.row_group
        logger.info("Created mesh with shape: %s", shape)
        self.train_num_steps = train_num_steps
        self.batch_size = train_batch_size
        self.max_grad_norm = max_grad_norm
        self.use_path_as_cond = use_path_as_cond
        self.null_cond_prob = null_cond_prob
        self.sample_text = sample_text
        self.cond_scale = cond_scale
        self.num_sample_rows = num_sample_rows
        self.samples_due = samples_due
        self.step_start_ema = step_start_ema
        self.update_ema_every = update_ema_every
        self.ema_decay = ema_decay
        self.log_every_steps = max(1, log_every_steps)
        self.checkpoint_every_steps = checkpoint_every_steps
        self.max_to_keep = max_to_keep
        self.save_optimizer_state = save_optimizer_state
        self.async_checkpointing = async_checkpointing
        self.profile_flush_step = profile_flush_step
        self.add_loss_plot = add_loss_plot
        self.lr_schedule = lr_schedule(train_lr, lr_decay_start_step, lr_decay_steps, lr_decay_coeff)

        trained = [k for k, p in self.model.named_parameters() if p.requires_grad]
        if not freeze_schedule_buffers:  # full-state Adam: the schedule buffers train with the weights
            for name in BUFFER_NAMES:
                getattr(self.model, name).requires_grad_(True)
            trained += list(BUFFER_NAMES)
        state = self.model.state_dict(keep_vars=True)
        self.live = {k: state[k] for k in trained}  # the module's trained tensors, in Adam's order
        self.ema_state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}

        # Sharded state (JAX :283-313): the shard axis, and each sharded trained tensor's port dim and whole shape.
        self.shard_axis, self.shard_dims, self.full_shapes = None, {}, {}
        if not seq and self.mesh is not None:
            if param_sharding == "fsdp" and shape["data"] > 1:
                self.shard_axis = "data"
            elif shape["model"] > 1:
                self.shard_axis = "model"
        if self.shard_axis is not None:
            rule = "fsdp" if self.shard_axis == "data" else "tensor"
            specs = state_partition_specs(self.model, rule, shape[self.shard_axis], fsdp_min_size_to_shard)
            self.shard_dims = {k: specs[k] for k in trained if specs[k] is not None}
        self.shards = {}  # key -> this rank's shard of the float32 parameter: what Adam updates
        for k, d in self.shard_dims.items():
            self.full_shapes[k] = tuple(state[k].shape)
            self.shards[k] = torch.nn.Parameter(self._shard_of(state[k].detach(), k).clone())
            self.ema_state[k] = self._shard_of(self.ema_state[k], k).clone()
        self._release()
        self.opt_params = [self.shards.get(k, p) for k, p in self.live.items()]
        self._ema_params = [self.ema_state[k] for k in trained]
        self.optimizer = self._new_optimizer(train_lr)
        self.opt_count = 0  # optax's update count, which the learning rate is read at
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        # Samples draw from their own stream, as JAX's sample_batch splits self.key and not the loop's key.
        self.sample_generator = torch.Generator(device=self.device).manual_seed(rng_seed + 1)

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
        rows = None
        if self.row_group is not None and self.row_group.world_size > 1:
            rows = rank_rows(self.batch_size, self.row_group.world_size, self.row_group.rank, self.accumulate)
        self.dl = endless_prefetching_loader(self.ds, self.batch_size, self.device, seed=rng_seed,
                                             depth=prefetch_depth, collate_fn=collate_fn, rows=rows)

        self.results_folder = Path(results_folder).resolve()
        self.results_folder.mkdir(exist_ok=True, parents=True)
        self.checkpoint_dir_path = (Path(checkpoint_dir_path).resolve() if checkpoint_dir_path
                                    else self.results_folder / "checkpoints")
        self.checkpoint_dir_path.mkdir(exist_ok=True, parents=True)
        self.tensorboard_dir = (Path(tensorboard_dir).resolve() if tensorboard_dir
                                else self.results_folder / "tensorboard")
        self.tensorboard_dir.mkdir(exist_ok=True, parents=True)
        self.writer = create_summary_writer(str(self.tensorboard_dir)) if self.is_main else _NullWriter()
        self.checkpoint_writer = CheckpointWriter()

        self.step = resume_training_step
        if self.step > 0:
            self._resume()
        self.step_starts: list[float] = []  # host clock at the start of each step of the loop
        self.save_seconds: dict[int, float] = {}  # host seconds the loop blocked on each checkpoint inside it
        self.sample_seconds: dict[int, float] = {}  # host seconds of each sample inside the loop
        self.sample_paths: dict[int, list[Path]] = {}
        self.profiler = None
        self.trace_path: Path | None = None  # the Chrome trace of the last run, once written
        self.traced_steps: tuple[int, int] | None = None  # [first, end) of the steps it covers
        self.trace_seconds = 0.0  # host seconds to stop the profiler and write the trace
        # Every step's loss, kept on the device (no host sync); NaN for steps not run here.
        self.loss_trace = torch.full((train_num_steps,), float("nan"), device=self.device)

    def _mesh_shape(self, seq: int, model_shards: int, batch: int) -> dict[str, int]:
        """The mesh's axes by the JAX trainer's rules (:154-175, :244-281), checked against the recipe."""
        group = self.group
        n = 1 if group is None else group.world_size
        if group is not None and self.device != group.device:
            raise ValueError(f"the model is on {self.device}, the rank's device is {group.device}")
        if seq > 1:
            if group is None:
                raise ValueError(f"sequence_parallel_size {seq} runs over a group of ranks: start them with the "
                                 "train CLI, or pass each rank's sequence_group")
            if model_shards != 1:
                raise ValueError("sequence parallelism composes with data parallelism only (num_model_shards 1)")
            if n % seq:
                raise ValueError(f"{n} ranks must divide by sequence_parallel_size={seq}")
            if not getattr(self.model.denoise_fn, "reference_compat", False):
                raise ValueError("sequence parallelism needs a reference_compat denoiser")
            if self.model.num_frames % seq:
                raise ValueError(f"num_frames={self.model.num_frames} must divide by sequence_parallel_size={seq}")
            if batch % (n // seq):
                raise ValueError(f"train_batch_size {batch} must be divisible by the data-parallel degree {n // seq}")
            return {"data": n // seq, "seq": seq}
        if batch % n:
            raise ValueError(f"train_batch_size {batch} must be divisible by the number of ranks {n}")
        if n < model_shards:  # a shipped recipe runs on fewer ranks than it shards over (JAX :261-271)
            feasible = math.gcd(n, model_shards)
            logger.warning("num_model_shards=%d exceeds the %d available rank(s); clamping to %d (single-host "
                           "portability fallback)", model_shards, n, feasible)
            model_shards = feasible
        elif n % model_shards:
            raise ValueError(f"num_model_shards={model_shards} does not divide {n} ranks; pick a divisor")
        return {"data": n // model_shards, "model": model_shards}

    @property
    def params(self) -> list[torch.Tensor]:
        """The module's trained tensors in Adam's order (a sharded one is empty between steps)."""
        return list(self.live.values())

    # Sharded state.

    def _shard_of(self, full: torch.Tensor, key: str) -> torch.Tensor:
        """This rank's shard of ``key``'s whole tensor: its chunk along the shard dim, by its place on the axis."""
        axis = self.mesh.axis(self.shard_axis)
        return full.chunk(axis.world_size, self.shard_dims[key])[axis.rank]

    def _gather(self, shards: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The whole tensors of ``shards`` (key -> this rank's shard), in one all-gather along the shard axis."""
        if not shards:
            return {}
        axis = self.mesh.axis(self.shard_axis)
        flat = torch.cat([v.detach().reshape(-1) for v in shards.values()])
        parts = axis.all_gather(flat, 0).view(axis.world_size, -1)
        out, offset = {}, 0
        for k, v in shards.items():
            pieces = parts[:, offset:offset + v.numel()].reshape(axis.world_size, *v.shape)
            out[k] = torch.cat(pieces.unbind(0), dim=self.shard_dims[k])
            offset += v.numel()
        return out

    def _gather_params(self) -> None:
        """Put the whole parameters into the module for a step (or a sample of the live weights)."""
        for k, full in self._gather(self.shards).items():
            self.live[k].data = full

    def _release(self) -> None:
        """Drop the module's whole copies of the sharded tensors (and their gradients) between steps."""
        for k in self.shard_dims:
            p = self.live[k]
            p.data, p.grad = torch.empty(0, dtype=p.dtype, device=p.device), None

    def _opt_moments(self) -> dict:
        """Adam's state as a one-rank run holds it: the sharded tensors' moments gathered (a collective)."""
        opt = self.optimizer.state_dict()
        if not self.shards:
            return opt
        index = {k: i for i, k in enumerate(self.live) if k in self.shards and i in opt["state"]}
        for name in ("exp_avg", "exp_avg_sq"):
            whole = self._gather({k: opt["state"][i][name] for k, i in index.items()})
            for k, i in index.items():
                opt["state"][i] = {**opt["state"][i], name: whole[k]}
        return opt

    def full_state(self) -> tuple[dict, dict]:
        """``(model_state, ema_state)`` as a one-rank run holds them, the shards gathered (a collective: every rank
        calls it)."""
        model = {**self.model.state_dict(), **self._gather(self.shards)}
        ema = {**self.ema_state, **self._gather({k: self.ema_state[k] for k in self.shards})}
        return model, ema

    def _reduce(self, loss: torch.Tensor) -> tuple[torch.Tensor, list[str]]:
        """Sum the replicated tensors' gradients and the loss over the world in one all-reduce, then reduce-scatter
        the sharded gradients; returns the summed loss and the sharded keys with a gradient.

        Where the ranks hold different rows (a data group of more than one rank), a tensor that one rank's rows
        leave unused (a fixed-math focus mask can leave q and k unused) has a zero share there: the buffer then
        carries every replicated tensor, zeros where this rank has no gradient, and a flag per trained tensor, so
        that a tensor no rank used keeps no gradient, as on one rank. Where every rank holds the same rows (a pure
        seq mesh) the ranks' gradients cover the same tensors, and the buffer carries those alone."""
        agree = self.row_group.world_size > 1
        items = list(self.live.items())
        rep = [(k, p) for k, p in items if k not in self.shards and (agree or p.grad is not None)]
        parts = [(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1) for _, p in rep]
        if agree:
            parts.append(torch.tensor([float(p.grad is not None) for _, p in items], device=self.device))
        flat = self.group.all_reduce(torch.cat([*parts, loss.reshape(1)]))
        n = sum(p.numel() for _, p in rep)
        if agree:
            used = {k for (k, _), u in zip(items, flat[n:n + len(items)].tolist()) if u}
        else:
            used = {k for k, p in items if p.grad is not None}
        for (k, p), g in zip(rep, flat[:n].split([p.numel() for _, p in rep])):
            p.grad = g.view_as(p) if k in used else None
        sharded = [k for k in self.shards if k in used]
        for k in sharded:
            if self.live[k].grad is None:
                self.live[k].grad = torch.zeros_like(self.live[k])
        if sharded:
            self._reduce_sharded(sharded)
        return flat[-1], sharded

    def _reduce_sharded(self, live: list[str]) -> None:
        """Reduce-scatter the sharded gradients of ``live`` keys to their owners' shards (summed over the world)."""
        axis = self.mesh.axis(self.shard_axis)
        k = axis.world_size
        send = torch.cat([torch.stack([c.reshape(-1) for c in self.live[key].grad.chunk(k, self.shard_dims[key])])
                          for key in live], dim=1)
        mine = axis.reduce_scatter(send, 0).reshape(-1)
        mine = self.mesh.axis("model" if self.shard_axis == "data" else "data").all_reduce(mine)
        for key, g in zip(live, mine.split([self.shards[key].numel() for key in live])):
            self.shards[key].grad = g.view_as(self.shards[key])

    # Steps.

    def _new_optimizer(self, lr: float) -> torch.optim.Adam:
        return torch.optim.Adam(self.opt_params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
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
        order, microbatch by microbatch under gradient accumulation. Over a
        mesh ``batch`` is this rank's rows (``rank_rows``) of whole clips, an
        injected ``t``, ``noise`` or focus mask the whole batch's, and the
        loss returned is summed over the ranks. Returns ``(loss, grad_norm)``
        as device tensors: the mean over the microbatches, and the norm of the
        mean gradient before the clip.
        """
        cond = None
        if self.use_path_as_cond:
            batch, cond = batch
        a = self.accumulate
        if batch.shape[0] % a:
            raise ValueError(f"a batch of {batch.shape[0]} rows does not split into {a} microbatches")
        self.optimizer.zero_grad(set_to_none=True)
        self._gather_params()
        loss_sum = None
        for i in range(a):
            def part(v):  # microbatch i of a batch-sized tensor: this rank's rows, or the whole batch's
                if v is None or a == 1:
                    return v
                rows = v.shape[0] // a
                return v[i * rows:(i + 1) * rows]

            cond_kw = {} if cond is None else {"cond": part(cond), "null_cond_prob": self.null_cond_prob}
            loss = self.model(part(batch), generator=self.generator, t=part(t), noise=part(noise),
                              focus_present_mask=part(focus_present_mask), prob_focus_present=prob_focus_present,
                              **cond_kw)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        with torch.no_grad():
            loss = loss_sum if a == 1 else loss_sum * (1.0 / a)
            if a > 1:
                torch._foreach_mul_([p.grad for p in self.live.values() if p.grad is not None], 1.0 / a)
            sharded = []
            if self.group is not None:  # each rank holds its share of the gradient and the loss: sum them, once
                loss, sharded = self._reduce(loss)
            live = [p for k, p in self.live.items() if k not in self.shards and p.grad is not None]
            self._release()
            owned = live + [self.shards[k] for k in sharded]  # every tensor Adam steps, as this rank holds it
            sum_sq = None
            if sharded:  # the global norm: the replicated squares once, the shards' summed along their axis
                axis = self.mesh.axis(self.shard_axis)
                shard_sq = axis.all_reduce(sum_of_squares([self.shards[k].grad for k in sharded]))
                sum_sq = (sum_of_squares([p.grad for p in live]) if live else 0.0) + shard_sq
            grads = [p.grad for p in owned]
            if self.max_grad_norm is not None:
                clipped, grad_norm = clip_grad_norm(grads, self.max_grad_norm, sum_sq=sum_sq)
                for p, g in zip(owned, clipped):
                    p.grad = g
            else:
                grad_norm = global_l2_norm(grads) if sum_sq is None else torch.sqrt(sum_sq + 1e-6)
            lr = self.lr_schedule(self.opt_count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.opt_count += 1
            if self.step >= self.step_start_ema and self.step % self.update_ema_every == 0:
                torch._foreach_mul_(self._ema_params, self.ema_decay)
                torch._foreach_add_(self._ema_params, self.opt_params, alpha=1.0 - self.ema_decay)
        return loss, grad_norm

    def train(self, prob_focus_present: float = 0.0, log_fn: Callable = lambda _: None) -> None:
        """Run the loop from ``self.step`` to ``train_num_steps``, then save the final checkpoint.

        ``prob_focus_present`` (JAX ``train``, :625-635) masks each sample's temporal attentions
        with that probability in every step; only a fixed-math denoiser heeds it.
        """
        logger.info("Starting training loop from step %d...", self.step)
        self.model.train()
        if self.profile_flush_step > 0 and self.is_main:
            self._start_profiler()
        pending = None
        last = time.time()
        while self.step < self.train_num_steps:
            self.step_starts.append(time.perf_counter())
            batch = next(self.dl)
            with (torch.profiler.record_function(f"train_step#{self.step}") if self.profiler is not None
                  else contextlib.nullcontext()):
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
                self._synchronize()  # the save waits on the queued step anyway; time the save alone
                t0 = time.perf_counter()
                try:
                    self.save(wait=not self.async_checkpointing)
                except Exception as e:  # a periodic save never stops training (JAX :786-789)
                    logger.error("Error saving checkpoint at step %d: %s", self.step, e)
                self.save_seconds[self.step] = time.perf_counter() - t0
            if self.samples_due and self.step > 0 and self.step % self.save_and_sample_every == 0:
                if self.profiler is not None:  # a sample captures CUDA graphs: end the trace first
                    self._stop_profiler()
                self._synchronize()
                t0 = time.perf_counter()
                self._sample_and_save()
                self.sample_seconds[self.step] = time.perf_counter() - t0
            self.step += 1
            if self.profiler is not None and self.step == self.profile_flush_step:
                self._stop_profiler()
        if pending is not None:
            self._log(*pending, log_fn)
        if self.profiler is not None:
            self._stop_profiler()
        self._synchronize()
        self.step_starts.append(time.perf_counter())
        logger.info("Training completed! Saving final checkpoint...")
        self.checkpoint_writer.wait()
        self.save()  # a failed final save raises
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

    # The profiler trace.

    def _start_profiler(self) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            profiler = profile(activities=activities)
            profiler.start()
        except Exception as e:  # tracing never stops training
            logger.warning("profiler trace not started: %s", e)
            return
        self.profiler, self._trace_from = profiler, self.step
        logger.info("Profiler trace started at step %d; flushing at step %d.", self.step, self.profile_flush_step)

    def _stop_profiler(self) -> None:
        profiler, self.profiler = self.profiler, None
        t0 = time.perf_counter()
        try:
            profiler.stop()
            path = self.tensorboard_dir / f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
            profiler.export_chrome_trace(str(path))
        except Exception as e:
            logger.warning("profiler trace not written: %s", e)
            return
        self.trace_seconds = time.perf_counter() - t0
        self.trace_path, self.traced_steps = path, (self._trace_from, self.step)
        logger.info("Profiler trace of steps %d-%d written to %s", self._trace_from, self.step - 1, path)

    # Samples.

    def sample_batch(self, batch_size: int, use_ema: bool = True, generator: torch.Generator | None = None):
        """DDPM samples, (b, c, f, h, w) in [0, 1], of the EMA state (``use_ema``) or the live one (JAX :809-828).

        Draws from ``generator``, else the trainer's own sample generator. The
        EMA tensors stand in for the live ones by reference (``.data``), and
        the live ones come back afterwards; the CUDA graphs captured meanwhile
        are dropped, so none outlives the sample or points at the EMA. Over a
        mesh every rank calls it: each samples its rows (and frames) with the
        sharded tensors gathered, and every rank returns the whole batch.
        """
        gen = self.sample_generator if generator is None else generator
        kw = {}
        if self.sample_text:
            kw = {"cond": [self.sample_text] * batch_size, "cond_scale": self.cond_scale}
        state = self.model.state_dict(keep_vars=True)
        swapped = []
        try:
            with torch.no_grad():
                if use_ema:
                    ema = {**self.ema_state, **self._gather({k: self.ema_state[k] for k in self.shards})}
                    for k, v in ema.items():
                        swapped.append((state[k], state[k].data))
                        state[k].data = v
                else:
                    self._gather_params()
                videos = self.model.sample(batch_size=batch_size, generator=gen, **kw)
                return self.model.gather_batch(videos, batch_size)
        finally:
            for live, data in swapped:
                live.data = data
            if not use_ema:
                self._release()
            self.model.graphs.clear()

    def _sample_and_save(self) -> None:
        """Write ``num_sample_rows`` EMA samples to ``results/samples/step_{N}/sample_{i}.gif``; a failure is
        logged (JAX ``_sample_and_save``, :795-807)."""
        try:
            videos = self.sample_batch(self.num_sample_rows)
            if not self.is_main:
                return
            out_dir = self.results_folder / "samples" / f"step_{self.step}"
            self.sample_paths[self.step] = write_sample_gifs(videos, out_dir)
            logger.info("Step: %d | Wrote %d sample GIFs to %s", self.step, self.num_sample_rows, out_dir)
        except Exception as e:
            logger.error("Error sampling at step %d: %s", self.step, e)

    # Checkpoints.

    def save(self, wait: bool = True) -> Path | None:
        """Save this step's checkpoint, unless its file exists or is being written (a resumed step).

        The state is copied to host memory here. With ``wait`` the file is
        written before this returns (after any write in flight); otherwise a
        background thread writes it. ``max_to_keep`` files are kept, counted
        after each write. Over a mesh every rank calls it: the shards are
        gathered (unless rank 0 skips the save, which it tells every rank),
        and rank 0 alone writes (the ranks' replicated states are bit-equal).
        """
        path = self.checkpoint_path(self.step)
        skip = self.is_main and (path.exists() or self.checkpoint_writer.path == path)
        gathered = ema = adam = None
        if self.shards:
            skip = bool(self.group.all_reduce(torch.tensor([float(skip)], device=self.device)).item())
            if not skip:  # every rank takes part in the gathers
                gathered, ema = self.full_state()
                if self.save_optimizer_state:
                    adam = self._opt_moments()
        if not self.is_main:
            return None
        if skip:
            logger.info("Checkpoint for step %d already exists; skipping save", self.step)
            return None
        optimizer = None
        if self.save_optimizer_state:
            optimizer = {"adam": adam or self.optimizer.state_dict(), "count": self.opt_count}
        payload = checkpoint_payload(self.model, ema or self.ema_state, optimizer=optimizer, step=self.step,
                                     gathered=gathered)
        if wait:
            self.checkpoint_writer.wait()
            write_checkpoint(path, payload)
            self._prune()
        else:
            self.checkpoint_writer.submit(path, payload, self._prune)
        return path

    def _prune(self) -> None:
        if self.max_to_keep:
            kept = sorted(self.checkpoint_dir_path.glob("step_*.pt"), key=lambda p: int(p.stem[5:]))
            for old in kept[:-self.max_to_keep]:
                old.unlink()

    def _resume(self) -> None:
        path = self.checkpoint_path(self.step)
        logger.info("Attempting to resume training from step %d", self.step)
        if not path.is_file():
            logger.warning("Checkpoint for step %d not found at %s.", self.step, self.checkpoint_dir_path)
            self.step = 0
            return
        payload = read_checkpoint(path)
        for k, shape in self.full_shapes.items():  # whole tensors to load into, then this rank's shards
            p = self.live[k]
            p.data = torch.empty(shape, dtype=p.dtype, device=p.device)
        self.model.load_state_dict(payload["model"], strict=True)
        for k in self.shards:
            self.shards[k].data.copy_(self._shard_of(self.live[k].detach(), k))
        self._release()
        if payload.get("ema_params") is not None:
            for k, v in payload["ema_params"].items():
                self.ema_state[k].copy_(self._shard_of(v, k) if k in self.shards else v)
        opt = payload.get("optimizer")
        if opt is None:
            logger.warning("No optimizer state for step %d; starting a fresh optimizer", self.step)
            return
        try:
            self.optimizer.load_state_dict(self._my_moments(opt["adam"]))
            self.opt_count = int(opt["count"])
            logger.info("Restored optimizer state for step %d", self.step)
        except (KeyError, ValueError, RuntimeError) as e:
            logger.warning("Optimizer state for step %d does not fit this model (%s); "
                           "starting a fresh optimizer", self.step, e)
            self.optimizer = self._new_optimizer(self.lr_schedule(0))
            self.opt_count = 0
        logger.info("Successfully loaded checkpoint state for step %d", self.step)

    def _my_moments(self, adam: dict) -> dict:
        """A one-rank run's Adam state with this rank's shards of the sharded tensors' moments."""
        if not self.shards:
            return adam
        state = dict(adam["state"])
        for i, k in enumerate(self.live):
            if k in self.shards and i in state:
                entry = dict(state[i])
                for name in ("exp_avg", "exp_avg_sq"):
                    if tuple(entry[name].shape) != self.full_shapes[k]:
                        raise ValueError(f"{k}: moment of shape {tuple(entry[name].shape)}, not {self.full_shapes[k]}")
                    entry[name] = self._shard_of(entry[name], k)
                state[i] = entry
        return {**adam, "state": state}

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
