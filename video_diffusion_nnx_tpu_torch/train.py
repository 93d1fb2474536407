"""Training CLI (counterpart of the JAX package's root train.py).

    python -m video_diffusion_nnx_tpu_torch.train --config configs/config_bouncing_digits.yaml \\
        [--resume_step N] [--rng_seed S] [--device cuda|cpu]

The flags of the JAX CLI plus ``--device`` (``cuda``, the default, raises
when there is no card). Seed precedence: ``--rng_seed`` > config
``rng_seed`` > 0. Checkpoints are one file per step,
``<results_folder>/checkpoints/step_<N>.pt``, which the sampling CLI reads.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train diffusion model")
    here = Path(__file__).resolve().parent.parent
    p.add_argument("--config", type=str, default=str(here / "configs" / "config.yaml"),
                   help="Path to the YAML config file")
    p.add_argument("--resume_step", type=int, default=0, help="Step to resume training from")
    p.add_argument("--rng_seed", type=int, default=None, help="RNG seed to use for training")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the finished trainer."""
    args = parse_args(argv)
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config

    logging.info("Loading configuration from: %s", args.config)
    config = load_config(args.config)
    _, _, trainer = build_trainer(config, device=args.device, resume_step=args.resume_step,
                                  rng_seed=args.rng_seed)
    logging.info("Starting training...")
    trainer.train()
    logging.info("Training finished.")
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s", force=True)
    main()
