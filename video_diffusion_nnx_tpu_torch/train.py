"""Training CLI (counterpart of the JAX package's root train.py).

    python -m video_diffusion_nnx_tpu_torch.train --config configs/config_bouncing_digits.yaml \\
        [--resume_step N] [--rng_seed S] [--device cuda|cpu] [--dist-backend nccl|gloo]

The flags of the JAX CLI plus ``--device`` (``cuda``, the default, raises
when there is no card) and ``--dist-backend``. Seed precedence:
``--rng_seed`` > config ``rng_seed`` > 0. Checkpoints are one file per
step, ``<results_folder>/checkpoints/step_<N>.pt``, which the sampling CLI
reads.

A recipe with ``trainer.sequence_parallel_size: N > 1``
(``configs/config_seq_parallel.yaml``) is the same one command: the CLI
builds the kernels, then starts N ranks itself (``torch.multiprocessing``,
spawn), which meet at a free ``tcp://localhost`` port; :func:`run_rank` is
one rank. Rank r computes on ``cuda:(r % device_count)``. ``nccl`` (the
default) needs a card per rank; ranks that share a card need
``--dist-backend gloo``, and ``--device cpu`` runs them on the CPU with gloo.
"""

from __future__ import annotations

import argparse
import logging
import socket
import sys
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train diffusion model")
    here = Path(__file__).resolve().parent.parent
    p.add_argument("--config", type=str, default=str(here / "configs" / "config.yaml"),
                   help="Path to the YAML config file")
    p.add_argument("--resume_step", type=int, default=0, help="Step to resume training from")
    p.add_argument("--rng_seed", type=int, default=None, help="RNG seed to use for training")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default="nccl",
                   help="collective backend of a sequence-parallel run; ranks sharing a card need gloo")
    return p.parse_args(argv)


def free_init_method() -> str:
    """A ``tcp://localhost`` address with a port that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def run_rank(rank: int, world_size: int, backend: str, init_method: str, argv=None):
    """One rank of a sequence-parallel run: join the group, train, leave; returns the trainer."""
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
    from video_diffusion_nnx_tpu_torch.parallel import destroy_sequence_group, init_sequence_group

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                            format=f"%(levelname)s:rank {rank}:%(name)s:%(message)s")
    args = parse_args(argv)
    config = load_config(args.config)
    group = init_sequence_group(rank, world_size, backend, init_method, device_type=args.device.split(":")[0])
    try:
        _, _, trainer = build_trainer(config, resume_step=args.resume_step, rng_seed=args.rng_seed,
                                      sequence_group=group)
        trainer.train()
        group.barrier()  # rank 0's final checkpoint is written before any rank leaves
        return trainer
    finally:
        destroy_sequence_group()


def main(argv=None):
    """Run the CLI; returns the finished trainer (None for a sequence-parallel run, whose ranks keep theirs)."""
    args = parse_args(argv)
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config, resolve_device

    logging.info("Loading configuration from: %s", args.config)
    config = load_config(args.config)
    world = int(config["trainer"]["sequence_parallel_size"])
    if world > 1:
        import torch.multiprocessing as mp

        if resolve_device(args.device).type == "cuda":
            from video_diffusion_nnx_tpu_torch.ops import _build

            _build.build_all()  # once, before the ranks load the libraries
        logging.info("Starting %d sequence-parallel ranks (%s)...", world, args.dist_backend)
        rank_argv = sys.argv[1:] if argv is None else list(argv)
        mp.spawn(run_rank, args=(world, args.dist_backend, free_init_method(), rank_argv), nprocs=world, join=True)
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
