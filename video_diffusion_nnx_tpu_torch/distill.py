"""Progressive-distillation CLI (counterpart of scripts/distill.py).

    python -m video_diffusion_nnx_tpu_torch.distill --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path results/bouncing_digits/checkpoints/step_20000.pt \\
        --initial-steps 32 --rounds 4 --steps-per-round 1000 --ema-decay 0.99 \\
        --output-path results/bouncing_digits/distilled

The teacher is a checkpoint file of this package (``convert.save_checkpoint``),
its EMA unless ``--no-ema``. Each round's student is written to
``<output-path>/step_<N>.pt``, N its sampler step count, with the model and the
EMA slots both set to the student, so the sampling CLI samples it on the grid
it was trained on:

    python -m video_diffusion_nnx_tpu_torch.sample --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path results/bouncing_digits/distilled/step_4.pt --sampler ddim --num-steps 4 --grid stride

The data is the config's ``trainer.dataset_path``: a Moving-MNIST ``.npy`` or
a folder of GIFs. A ``guidance_embed`` teacher (``distill_guidance``'s
student) is distilled in stage 2 of Meng et al.: conditioned on its GIFs'
captions, with a per-sample guidance scale drawn from ``[--w-min, --w-max]``,
so its students stay steerable. It runs on the GPU (``--device cuda``, the
default) and raises when there is none, unless ``--device cpu`` is given.

``--ranks N`` (``--dist-backend gloo`` for ranks that share a card) splits
each batch's rows over N data ranks, as the JAX CLI passes
``data_parallel_mesh()``: every rank reads the same seeded batches and keeps
its rows, draws the whole batch's noise and keeps its rows, and one
all-reduce a step sums the gradients (``training/distill.py``); rank 0
alone writes the students. A batch that does not divide runs whole on every
rank, with a warning (JAX's ``mesh=None``).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size

log = logging.getLogger("distill")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Progressively distill a checkpoint into few-step students")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, required=True, help="the teacher's checkpoint file")
    p.add_argument("--step", type=int, default=None, help="the teacher's step; when given, the file must hold it")
    p.add_argument("--no-ema", action="store_true", help="distill from the raw weights instead of the EMA")
    p.add_argument("--initial-steps", type=int, default=32,
                   help="the first student's sampler step count (the teacher's grid is twice this)")
    p.add_argument("--rounds", type=int, default=3, help="number of halvings")
    p.add_argument("--steps-per-round", type=int, default=2000, help="optimizer steps per halving round")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ema-decay", type=float, default=None,
                   help="keep an EMA of the student within each round and save it; default off")
    p.add_argument("--w-min", type=float, default=1.0,
                   help="guidance-scale range of stage 2, for a guidance_embed teacher (ignored otherwise)")
    p.add_argument("--w-max", type=float, default=8.0)
    p.add_argument("--batch-size", type=int, default=None, help="default: trainer.train_batch_size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-path", type=str, default=None, help="default: <checkpoint folder>/../distilled")
    p.add_argument("--device", type=str, default="cuda")
    add_rank_args(p)
    return p.parse_args(argv)


def load_teacher(config: dict, path: str, step: int | None, ema: bool, device):
    """``(diffusion, step)``: the config's model with a checkpoint file's weights (its EMA when ``ema``), in eval
    mode; a missing file, a missing EMA or another step than ``step`` exits with an error."""
    from video_diffusion_nnx_tpu_torch.config import build_models
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint

    _, teacher = build_models(config, device=device)
    try:
        payload = read_checkpoint(path)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    if step is not None and payload.get("step") != step:
        raise SystemExit(f"error: {path} holds step {payload.get('step')}, not {step}")
    state = payload["ema_params"] if ema else payload["model"]
    if state is None:
        raise SystemExit(f"error: {path} holds no EMA parameters; pass --no-ema")
    teacher.load_state_dict(state, strict=True)
    return teacher.eval(), payload.get("step")


def row_group(group, batch_size: int):
    """The group a distillation's rows split over: ``group`` where the batch divides over its ranks (JAX's CLIs
    pass ``data_parallel_mesh()`` then), else None, every rank running the whole batch, with a warning."""
    if group is None or group.world_size == 1:
        return None
    if batch_size % group.world_size:
        log.warning("distillation batch %d does not divide across %d data ranks; running unsharded on every rank. "
                    "Pad the batch to a multiple of %d to engage all ranks.", batch_size, group.world_size,
                    group.world_size)
        return None
    return group


def data_stream(config: dict, model, batch_size: int, seed: int, conditioned: bool, device, group=None):
    """The config's dataset as an endless shuffled stream of batches on ``device`` (``(clips, embeddings)`` pairs
    when ``conditioned``), as the JAX CLIs build it: a GIF folder, captioned by file name when conditioned, or a
    Moving-MNIST ``.npy``; under ``group`` this rank's rows of each batch (``rank_rows``). A conditioned run
    without a folder, or a dataset smaller than a batch, exits."""
    from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
    from video_diffusion_nnx_tpu_torch.data.loader import collate_with_text_cond, endless_prefetching_loader, rank_rows
    from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST

    tcfg = config["trainer"]
    path = tcfg.get("dataset_path")
    if path is None:
        raise SystemExit("error: config section 'trainer' needs a dataset_path")
    if Path(path).is_dir():
        ds = GifVideoDataset(path, image_size=model.image_size, channels=model.channels,
                             num_frames=model.num_frames, force_num_frames=True, use_path_as_cond=conditioned)
    elif conditioned:
        raise SystemExit(f"error: a conditioned distillation needs a caption-conditioned GIF folder dataset; {path} "
                         "is not a folder")
    else:
        ds = MovingMNIST(path, image_size=(model.image_size, model.image_size), num_frames=model.num_frames,
                         force_num_frames=True, normalize=tcfg["dataset_normalize"])
    if len(ds) < batch_size:
        raise SystemExit(f"error: dataset has {len(ds)} clips < batch size {batch_size} (drop-last loader would "
                         "yield nothing); lower --batch-size")
    log.info("dataset: %d clips, batch %d%s", len(ds), batch_size, " (captioned)" if conditioned else "")
    rows = None if group is None else rank_rows(batch_size, group.world_size, group.rank)
    return endless_prefetching_loader(ds, batch_size, device, seed=seed,
                                      collate_fn=collate_with_text_cond if conditioned else None, rows=rows)


def round_record(step) -> dict:
    """A finished round's (or guidance run's) losses and host seconds per step: from the start of the second step
    (the first builds the kernels and warms the caches) to the device's end of the last (``step.end``)."""
    starts = step.step_starts
    losses = [float(v) for v in step.losses]
    sps = (step.end - starts[1]) / (len(starts) - 1) if len(starts) > 1 and step.end is not None else None
    return {"losses": losses, "steps": len(losses), "seconds_per_step": sps}


def run(args: argparse.Namespace, group=None) -> dict:
    """Distill as the CLI asks, on one rank or as ``group``'s rank; returns the students' files by step count
    (rank 0's), the final step count and each round's record."""
    from video_diffusion_nnx_tpu_torch.config import load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import save_checkpoint
    from video_diffusion_nnx_tpu_torch.training.distill import progressive_distill

    device = resolve_device(args.device) if group is None else group.device
    config = load_config(args.config)
    teacher, _ = load_teacher(config, args.checkpoint_path, args.step, not args.no_ema, device)
    if teacher.prediction_type == "noise":
        log.warning("teacher is epsilon-parameterized; distillation works but 'v' (diffusion.prediction_type: v) "
                    "is the stable choice at low step counts (Salimans & Ho 2022, section 4)")
    # Stage 2 of Meng et al. 2023: a guidance_embed teacher is distilled conditioned, with a per-sample scale.
    conditioned = bool(getattr(teacher.denoise_fn, "has_guidance_embed", False))
    w_range = (args.w_min, args.w_max) if conditioned else None
    batch_size = args.batch_size or config["trainer"]["train_batch_size"]
    rows = row_group(group, batch_size)
    data = data_stream(config, teacher, batch_size, args.seed, conditioned, device, rows)

    out_dir = Path(args.output_path or Path(args.checkpoint_path).resolve().parent.parent / "distilled")
    paths, rounds = {}, []

    def save_round(n_steps: int, student) -> None:
        if group is not None and group.rank != 0:
            return
        # Both slots carry the student, so --load-ema-params and the default read the same weights.
        paths[n_steps] = save_checkpoint(out_dir / f"step_{n_steps}.pt", student, ema_state=student.state_dict(),
                                         step=n_steps)
        log.info("saved the %d-step student -> sample --checkpoint-path %s --sampler ddim --num-steps %d "
                 "--grid stride", n_steps, paths[n_steps], n_steps)

    student, final_steps = progressive_distill(
        teacher, data, initial_steps=args.initial_steps, rounds=args.rounds, steps_per_round=args.steps_per_round,
        generator=torch.Generator(device=device).manual_seed(args.seed), learning_rate=args.lr,
        conditioned=conditioned, w_range=w_range, ema_decay=args.ema_decay, on_round_end=save_round,
        on_done=lambda step: rounds.append({"student_steps": step.student_steps, **round_record(step)}), group=rows)
    if group is not None:
        group.barrier()  # rank 0's files are written before any rank leaves
    log.info("distillation done: the final student samples in %d steps", final_steps)
    return {"paths": paths, "final_steps": final_steps, "rounds": rounds, "conditioned": conditioned,
            "w_range": w_range}


def run_rank(rank: int, world: int, backend: str, init_method: str, argv=None) -> dict:
    """One rank of a multi-rank run (:func:`run` on the world's group)."""
    args = parse_args(argv)
    with joined(rank, world, backend, init_method, args.device.split(":")[0]) as group:
        return run(args, group)


def main(argv=None) -> dict:
    """Run the CLI; returns :func:`run`'s record (rank 0's over several ranks)."""
    args = parse_args(argv)
    from video_diffusion_nnx_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    world = world_size(args.ranks, device)
    if world > 1:
        return launch(run_rank, world, args.dist_backend, device, argv)
    return run(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s", force=True)
    main()
