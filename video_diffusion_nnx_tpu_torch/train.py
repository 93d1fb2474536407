"""Training CLI (counterpart of the JAX package's root train.py).

    python -m video_diffusion_nnx_tpu_torch.train --config configs/config_bouncing_digits.yaml \\
        [--resume_step N] [--rng_seed S] [--device cuda|cpu] [--ranks N] [--dist-backend nccl|gloo]

The flags of the JAX CLI plus ``--device`` (``cuda``, the default, raises
when there is no card), ``--ranks`` and ``--dist-backend``. Seed precedence:
``--rng_seed`` > config ``rng_seed`` > 0. Checkpoints are one file per
step, ``<results_folder>/checkpoints/step_<N>.pt``, which the sampling CLI
reads.

``--ranks`` is the counterpart of JAX's local device count: the number of
ranks the run spans, by default the number of cards (one on the CPU),
raised to ``trainer.sequence_parallel_size`` where that is larger. The
trainer lays its mesh over them by the JAX trainer's rules: (data, seq)
under ``sequence_parallel_size`` > 1, else (data, model) with
``num_model_shards`` (clamped with a warning on fewer ranks), parameters
stored by ``param_sharding``. With more than one rank the CLI starts the
ranks itself (``parallel.launch``, as every CLI of this package does);
:func:`run_rank` is one rank. Rank r computes on ``cuda:(r % device_count)``.
``nccl`` (the default) needs a card per rank; ranks that share a card need
``--dist-backend gloo``, and ``--device cpu`` runs them on the CPU with gloo.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train diffusion model")
    here = Path(__file__).resolve().parent.parent
    p.add_argument("--config", type=str, default=str(here / "configs" / "config.yaml"),
                   help="Path to the YAML config file")
    p.add_argument("--resume_step", type=int, default=0, help="Step to resume training from")
    p.add_argument("--rng_seed", type=int, default=None, help="RNG seed to use for training")
    p.add_argument("--device", type=str, default="cuda")
    add_rank_args(p)
    return p.parse_args(argv)


def run_rank(rank: int, world: int, backend: str, init_method: str, argv=None):
    """One rank of a multi-rank run: join the world, train, leave; returns the trainer."""
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config

    args = parse_args(argv)
    config = load_config(args.config)
    with joined(rank, world, backend, init_method, args.device.split(":")[0]) as group:
        _, _, trainer = build_trainer(config, resume_step=args.resume_step, rng_seed=args.rng_seed,
                                      sequence_group=group)
        trainer.train()
        group.barrier()  # rank 0's final checkpoint is written before any rank leaves
        return trainer


def _spawned_rank(*args) -> None:
    """The CLI's rank: its trainer stays in its process."""
    run_rank(*args)


def main(argv=None):
    """Run the CLI; returns the finished trainer (None for a multi-rank run, whose ranks keep theirs)."""
    args = parse_args(argv)
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config, resolve_device

    logging.info("Loading configuration from: %s", args.config)
    config = load_config(args.config)
    device = resolve_device(args.device)
    world = world_size(args.ranks, device, int(config["trainer"]["sequence_parallel_size"]))
    if world > 1:
        launch(_spawned_rank, world, args.dist_backend, device, argv)
        logging.info("Training finished.")
        return None
    _, _, trainer = build_trainer(config, device=args.device, resume_step=args.resume_step,
                                  rng_seed=args.rng_seed)
    logging.info("Starting training...")
    trainer.train()
    logging.info("Training finished.")
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s", force=True)
    main()
