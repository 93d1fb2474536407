"""Sampling CLI (counterpart of the JAX package's root sample.py).

    python -m video_diffusion_nnx_tpu_torch.sample --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path ckpt.pt --batch-size 2 --sampler ddim --num-steps 50

Config -> ``build_models`` -> checkpoint -> sampler -> ``sample_{i}.gif``.
Samplers: ``ddpm`` (the full chain), ``ddim`` and ``dpm`` (DPM-Solver++(2M)),
the last two over ``--num-steps``. On the GPU each step replays the
denoiser's CUDA graph (``diffusion/graphs.py``). A text-conditioned model
(``unet.use_bert_text_cond``) takes ``--text`` (repeat it for one prompt per
sample; a single prompt is repeated to ``--batch-size``) and
``--cond-scale``, the classifier-free guidance scale:

    python -m video_diffusion_nnx_tpu_torch.sample --config configs/config_bouncing_digits_cond.yaml \
        --checkpoint-path step_6000.pt --load-ema-params --sampler ddim --text "two digits" --cond-scale 3

The checkpoint is this package's file (``convert.save_checkpoint``). It runs
on the GPU (``--device cuda``, the default) and raises when there is none,
unless ``--device cpu`` is given.

``--ranks N`` samples over N data ranks (``parallel.launch``; by default the
cards), as the JAX package's samplers take every local device: each rank
builds the model, loads the checkpoint and samples its rows of the batch
(x_T drawn for the whole batch from the seed, each rank keeping its rows;
a batch that does not divide runs whole on every rank, with a warning),
replaying its own CUDA graphs; rank 0 gathers the batch and alone writes the
GIFs. Ranks that share a card need ``--dist-backend gloo``.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size

log = logging.getLogger("sample")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate video samples from a checkpoint")
    here = Path(__file__).resolve().parent.parent
    p.add_argument("--config", type=str, default=str(here / "configs" / "config.yaml"))
    p.add_argument("--output-path", type=str, default="outputs")
    p.add_argument("--checkpoint-path", type=str, required=True,
                   help="a checkpoint file written by video_diffusion_nnx_tpu_torch.convert")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--load-ema-params", action="store_true", default=False)
    p.add_argument("--sampler", choices=("ddpm", "ddim", "dpm"), default="ddpm")
    p.add_argument("--num-steps", type=int, default=50, help="DDIM / DPM step count (ignored for ddpm)")
    p.add_argument("--eta", type=float, default=0.0, help="DDIM stochasticity")
    p.add_argument("--grid", choices=("linspace", "stride"), default="linspace")
    p.add_argument("--text", type=str, action="append", default=None,
                   help="text condition; repeat for per-sample prompts (needs a conditioned model)")
    p.add_argument("--cond-scale", type=float, default=1.0, help="classifier-free guidance scale")
    p.add_argument("--device", type=str, default="cuda")
    add_rank_args(p)
    return p.parse_args(argv)


def text_condition(text: list[str] | None, batch_size: int, diffusion) -> list[str] | None:
    """The ``--text`` prompts, one per sample: a single prompt is repeated to ``batch_size`` (JAX root
    sample.py:98-100). A conditioned model needs them and an unconditioned one refuses them, as the server does."""
    has_cond = bool(getattr(diffusion.denoise_fn, "has_cond", False))
    if text is None:
        if has_cond:
            raise SystemExit("error: this model is conditioned; give --text")
        return None
    if not has_cond:
        raise SystemExit("error: this model is unconditional; remove --text")
    if len(text) == 1 and batch_size > 1:
        text = text * batch_size
    return text


def run(args: argparse.Namespace, group=None) -> dict:
    """Sample as the CLI asks, on one rank or as ``group``'s rank; returns the GIF paths (rank 0's), the whole batch
    (on the CPU), the steps, the seconds and the denoiser graphs' captures and replays."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    device = resolve_device(args.device) if group is None else group.device
    config = load_config(args.config)
    _, diffusion = build_models(config, device=device)
    try:
        load_checkpoint(diffusion, args.checkpoint_path, load_ema_params=args.load_ema_params)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    diffusion.eval()
    diffusion.data_group = group
    log.info("restored %s (ema=%s)", args.checkpoint_path, args.load_ema_params)
    cond = text_condition(args.text, args.batch_size, diffusion)
    batch_size = args.batch_size if cond is None else len(cond)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    if args.sampler == "ddim":
        log.info("DDIM sampling: %d steps, eta=%.2f", args.num_steps, args.eta)
        videos = diffusion.ddim_sample(
            batch_size=args.batch_size, num_steps=args.num_steps, eta=args.eta,
            grid=args.grid, generator=generator, cond=cond, cond_scale=args.cond_scale,
        )
        steps = args.num_steps
    elif args.sampler == "dpm":
        log.info("DPM-Solver++(2M) sampling: %d steps", args.num_steps)
        videos = diffusion.dpm_solver_sample(batch_size=args.batch_size, num_steps=args.num_steps,
                                             generator=generator, cond=cond, cond_scale=args.cond_scale)
        steps = args.num_steps
    else:
        videos = diffusion.sample(batch_size=args.batch_size, generator=generator, cond=cond,
                                  cond_scale=args.cond_scale)
        steps = diffusion.num_timesteps
    videos = diffusion.gather_batch(videos, batch_size)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - start
    log.info("generated %d clips in %.3f s", videos.shape[0], seconds)

    paths = []
    if group is None or group.rank == 0:
        paths = write_sample_gifs(videos, Path(args.output_path))
        for p in paths:
            log.info("wrote %s", p)
    return {"paths": paths, "videos": videos.cpu(), "steps": steps, "seconds": seconds,
            "graph": {"captures": diffusion.graphs.captures, "replays": diffusion.graphs.replays()}}


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
    logging.basicConfig(level=logging.INFO, force=True)
    main()
