"""Guidance-distillation CLI (counterpart of scripts/distill_guidance.py): distill a conditioned teacher's
classifier-free guidance into a w-conditioned student that samples at any ``cond_scale`` with one forward a step.

    python -m video_diffusion_nnx_tpu_torch.distill_guidance --config configs/config_bouncing_digits_cond.yaml \\
        --checkpoint-path results/bouncing_digits_cond/checkpoints/step_6000.pt \\
        --num-steps 2000 --output-path results/guidance_distilled

The config must describe a conditioned model (``unet.cond_dim`` or
``use_bert_text_cond``) over a caption-conditioned GIF folder; the teacher is
a checkpoint file of this package, its EMA unless ``--no-ema``. The student is
written to ``<output-path>/step_<N>.pt`` (N: ``--step``, else the teacher's
step), model and EMA slots both the student, beside ``config_guidance.yaml``:
the teacher's config plus ``unet.guidance_embed: true``. Sampling is the
stock CLI:

    python -m video_diffusion_nnx_tpu_torch.sample --config <output-path>/config_guidance.yaml \\
        --checkpoint-path <output-path>/step_<N>.pt --text "two digits" --cond-scale 4

and ``distill`` on that config and file runs stage 2 (a few-step,
still-steerable student). ``--ranks N`` splits each batch's rows over N data
ranks as ``distill`` does; rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import copy
import logging
from pathlib import Path

import torch

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size

log = logging.getLogger("distill_guidance")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Distill classifier-free guidance into a w-conditioned student")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, required=True, help="the teacher's checkpoint file")
    p.add_argument("--step", type=int, default=None,
                   help="the teacher's step; when given, the file must hold it (it also names the student's file)")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--num-steps", type=int, default=2000, help="optimizer steps")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--w-min", type=float, default=1.0)
    p.add_argument("--w-max", type=float, default=8.0)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-path", type=str, default=None,
                   help="default: <checkpoint folder>/../guidance_distilled")
    p.add_argument("--device", type=str, default="cuda")
    add_rank_args(p)
    return p.parse_args(argv)


def run(args: argparse.Namespace, group=None) -> dict:
    """Distill as the CLI asks, on one rank or as ``group``'s rank; returns the student's file, the derived config
    (rank 0's) and the run's record."""
    import yaml

    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import save_checkpoint
    from video_diffusion_nnx_tpu_torch.distill import data_stream, load_teacher, round_record, row_group
    from video_diffusion_nnx_tpu_torch.training.guidance import guidance_distill

    device = resolve_device(args.device) if group is None else group.device
    config = load_config(args.config)
    u = config["unet"]
    if u.get("cond_dim") is None and not u.get("use_bert_text_cond"):
        raise SystemExit("error: the config describes an unconditioned model; guidance distillation needs "
                         "cond_dim or use_bert_text_cond")
    teacher, step = load_teacher(config, args.checkpoint_path, args.step, not args.no_ema, device)
    student_config = copy.deepcopy(config)
    student_config["unet"]["guidance_embed"] = True
    _, student = build_models(student_config, device=device)

    batch_size = args.batch_size or config["trainer"]["train_batch_size"]
    rows = row_group(group, batch_size)
    data = data_stream(config, teacher, batch_size, args.seed, True, device, rows)
    record = {}
    guidance_distill(teacher, student, data, num_train_steps=args.num_steps,
                     generator=torch.Generator(device=device).manual_seed(args.seed), learning_rate=args.lr,
                     w_range=(args.w_min, args.w_max), on_done=lambda s: record.update(round_record(s)), group=rows)

    out = {"path": None, "config": None, **record}
    if group is None or group.rank == 0:
        out_dir = Path(args.output_path or Path(args.checkpoint_path).resolve().parent.parent / "guidance_distilled")
        n = step if step is not None else 0
        out["path"] = save_checkpoint(out_dir / f"step_{n}.pt", student, ema_state=student.state_dict(), step=n)
        out["config"] = out_dir / "config_guidance.yaml"
        out["config"].write_text(yaml.safe_dump(student_config))
        log.info("saved the w-conditioned student -> sample --config %s --checkpoint-path %s --text '...' "
                 "--cond-scale W", out["config"], out["path"])
    if group is not None:
        group.barrier()  # rank 0's files are written before any rank leaves
    return out


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
