"""Latent interpolation CLI: blend two dataset clips through the diffusion (counterpart of the JAX package's
scripts/interpolate.py).

    python -m video_diffusion_nnx_tpu_torch.interpolate --config C --checkpoint-path ckpt.pt \\
        --dataset D.npy --index-a 0 --index-b 1 --lam 0.25 --lam 0.75 --t 250

Both clips of the Moving-MNIST ``.npy`` (the ``(F, B, H, W)`` layout) are
scaled as the training config scales its data (``dataset_normalize``), mapped
to [-1, 1], diffused to step ``--t`` (default T - 1), blended and denoised
back (``GaussianDiffusion.interpolate``). Writes ``interp_{lam}.gif`` per blend
weight and the two endpoint clips, all on one min-max scale. The checkpoint
is this package's file; ``--device cuda`` is the default, and a missing card
raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

log = logging.getLogger("interpolate")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Interpolate two clips in diffusion latent space")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, required=True,
                   help="a checkpoint file written by video_diffusion_nnx_tpu_torch.convert")
    p.add_argument("--dataset", type=str, required=True, help=".npy in the Moving-MNIST (F, B, H, W) layout")
    p.add_argument("--index-a", type=int, default=0)
    p.add_argument("--index-b", type=int, default=1)
    p.add_argument("--lam", type=float, action="append", default=None,
                   help="blend weight(s) in [0, 1]; repeat for several (default 0.5)")
    p.add_argument("--t", type=int, default=None,
                   help="diffusion step to blend at (default T-1 = full re-generation)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-path", type=str, default="outputs")
    p.add_argument("--load-ema-params", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the GIF paths, their names and the clips written (on the CPU)."""
    args = parse_args(argv)

    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST
    from video_diffusion_nnx_tpu_torch.utils.image import normalize_img
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    device = resolve_device(args.device)
    config = load_config(args.config)
    _, model = build_models(config, device=device)
    try:
        load_checkpoint(model, args.checkpoint_path, load_ema_params=args.load_ema_params)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    model.eval()

    d = config["diffusion"]
    ds = MovingMNIST(args.dataset, image_size=d["image_size"], channels=d["channels"], num_frames=d["num_frames"],
                     normalize=config["trainer"]["dataset_normalize"])
    # The dataset yields (c, f, h, w); normalize_img mirrors the training input path, whatever the data's scale.
    x1 = normalize_img(torch.from_numpy(ds[args.index_a]).to(device)[None])
    x2 = normalize_img(torch.from_numpy(ds[args.index_b]).to(device)[None])

    generator = torch.Generator(device=device).manual_seed(args.seed)
    clips, names = [x1[0], x2[0]], ["endpoint_a", "endpoint_b"]
    for lam in args.lam or [0.5]:
        try:
            out = model.interpolate(x1, x2, t=args.t, lam=lam, generator=generator)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
        clips.append(out[0])
        names.append(f"interp_{lam:g}")
        log.info("interpolated lam=%g at t=%s", lam, args.t if args.t is not None else "T-1")
    batch = torch.stack(clips).float().cpu()
    paths = write_sample_gifs(batch, Path(args.output_path), names=names)
    for p in paths:
        log.info("wrote %s", p)
    return {"paths": paths, "names": names, "clips": batch}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
