"""Video extension and temporal infill CLI (counterpart of the JAX package's scripts/extend.py).

Pins frames of an input clip and generates the rest with
``GaussianDiffusion.sample_conditional_frames`` (replacement conditioning):

    # continue a clip: keep its first 4 frames, generate the rest
    python -m video_diffusion_nnx_tpu_torch.extend --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path ckpt.pt --input clip.gif --keep-frames 4 --num-steps 50

    # temporal infill: regenerate frames 3..6 of the clip
    python -m video_diffusion_nnx_tpu_torch.extend ... --input clip.gif --regen-frames 3:7

Input: an animated GIF (resized to the model's image size) or a ``.npy``
``(f, h, w)`` / ``(c, f, h, w)`` array in [0, 255]. Output: one GIF per batch
sample (``--batch-size`` continuations of the same input with different
noise). ``--num-steps`` runs DDIM on the ``--grid``; without it the full DDPM
chain runs. ``--recon-guidance`` w_r > 0 adds reconstruction guidance (DDIM
only). A text-conditioned model takes ``--text`` (one prompt, repeated to
``--batch-size``, or one per sample) and ``--cond-scale``. The checkpoint is
this package's file; ``--device cuda`` is the default, and a missing card
raises unless ``--device cpu`` is given. ``--ranks N`` (``--dist-backend gloo``
for ranks that share a card) splits the batch's rows over N data ranks as the
sampling CLI does: every rank samples its rows, rank 0 gathers them and alone
writes the GIFs.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size

log = logging.getLogger("extend")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Extend or infill a clip with the diffusion model")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, required=True,
                   help="a checkpoint file written by video_diffusion_nnx_tpu_torch.convert")
    p.add_argument("--load-ema-params", action="store_true", default=False)
    p.add_argument("--input", type=str, required=True, help="GIF or .npy clip")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--keep-frames", type=int, default=None,
                   help="pin the first N input frames, generate the rest (extension)")
    g.add_argument("--regen-frames", type=str, default=None,
                   help="A:B: regenerate frames [A, B), pin everything else (infill)")
    p.add_argument("--batch-size", type=int, default=2, help="independent continuations of the same input")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-steps", type=int, default=None,
                   help="DDIM conditional sampling with this many steps (default: the full DDPM chain)")
    p.add_argument("--grid", choices=("linspace", "stride"), default="linspace")
    p.add_argument("--recon-guidance", type=float, default=0.0,
                   help="reconstruction-guidance weight w_r (Ho et al. 2022; needs --num-steps; typical 1-10)")
    p.add_argument("--text", type=str, action="append", default=None,
                   help="text condition; repeat for per-sample prompts (needs a conditioned model)")
    p.add_argument("--cond-scale", type=float, default=1.0, help="classifier-free guidance scale")
    p.add_argument("--output-path", type=str, default="outputs/extended")
    p.add_argument("--device", type=str, default="cuda")
    add_rank_args(p)
    return p.parse_args(argv)


def load_clip(path: Path, image_size: int, channels: int, num_frames: int) -> tuple[np.ndarray, int]:
    """``((c, f, h, w) float32 in [0, 1] padded or cut to num_frames, the input's frame count before padding)``."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 3:
            arr = arr[None]  # (f, h, w) -> (1, f, h, w)
        if arr.ndim != 4:
            raise SystemExit(f"error: npy clip must be (f, h, w) or (c, f, h, w), got {arr.shape}")
    else:
        from PIL import Image

        from video_diffusion_nnx_tpu_torch.utils.media import seek_all_images

        # seek_all_images keeps the reference's off-by-one channel keys (3 -> RGBA): remap the true channel
        # count to the key that yields it, as GifVideoDataset does.
        try:
            mode_key = {1: 1, 3: 2, 4: 3}[channels]
        except KeyError:
            raise SystemExit(f"error: unsupported channel count {channels}") from None
        with Image.open(path) as img:
            frames = [np.asarray(f.resize((image_size, image_size)), np.float32)
                      for f in seek_all_images(img, channels=mode_key)]
        arr = np.stack(frames)  # (f, h, w[, c])
        arr = arr[..., None] if arr.ndim == 3 else arr
        arr = np.moveaxis(arr, -1, 0)  # -> (c, f, h, w)
    if arr.shape[0] != channels:
        raise SystemExit(f"error: input clip has {arr.shape[0]} channels; model expects {channels}")
    arr = arr / 255.0
    f = arr.shape[1]
    if f < num_frames:
        pad = np.zeros((arr.shape[0], num_frames - f, *arr.shape[2:]), np.float32)
        arr = np.concatenate([arr, pad], axis=1)
    return arr[:, :num_frames], min(f, num_frames)


def frame_mask(args: argparse.Namespace, num_frames: int, input_frames: int) -> np.ndarray:
    """The (f,) bool mask of pinned frames that ``--keep-frames`` or ``--regen-frames`` asks for."""
    f = num_frames
    if args.keep_frames is not None:
        if not 1 <= args.keep_frames < f:
            raise SystemExit(f"error: --keep-frames must be in [1, {f - 1}]")
        if args.keep_frames > input_frames:
            raise SystemExit(f"error: --keep-frames {args.keep_frames} exceeds the input's {input_frames} "
                             "frames (the padding is black, not context)")
        log.info("extension: pinning first %d of %d frames", args.keep_frames, f)
        return np.arange(f) < args.keep_frames
    try:
        a, b = map(int, args.regen_frames.split(":"))
    except ValueError:
        raise SystemExit("error: --regen-frames must be A:B") from None
    if not 0 <= a < b <= f:
        raise SystemExit(f"error: --regen-frames range must satisfy 0 <= A < B <= {f}")
    mask = ~((np.arange(f) >= a) & (np.arange(f) < b))
    if not mask.any():
        raise SystemExit("error: --regen-frames covers every frame, nothing is pinned "
                         "(use the sampling CLI for unconditional generation)")
    log.info("infill: regenerating frames [%d, %d) of %d", a, b, f)
    return mask


def run(args: argparse.Namespace, group=None) -> dict:
    """Extend as the CLI asks, on one rank or as ``group``'s rank; returns the GIF paths (rank 0's), the whole batch
    (on the CPU), the input clip, the mask, the steps, the seconds and the denoiser graphs' captures and replays."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.sample import text_condition
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    device = resolve_device(args.device) if group is None else group.device
    _, model = build_models(load_config(args.config), device=device)
    try:
        load_checkpoint(model, args.checkpoint_path, load_ema_params=args.load_ema_params)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    model.eval()
    model.data_group = group
    cond = text_condition(args.text, args.batch_size, model)
    if cond is not None and len(cond) != args.batch_size:
        raise SystemExit(f"error: --text given {len(args.text)} times but --batch-size is {args.batch_size}; "
                         "give one prompt or one per sample")

    clip, input_frames = load_clip(Path(args.input), model.image_size, model.channels, model.num_frames)
    mask = frame_mask(args, model.num_frames, input_frames)
    known = torch.from_numpy(clip).to(device)[None].expand(args.batch_size, *clip.shape)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    try:
        videos = model.sample_conditional_frames(
            known, mask, num_steps=args.num_steps, grid=args.grid,
            recon_guidance_weight=args.recon_guidance, generator=generator, cond=cond,
            cond_scale=args.cond_scale,
        )
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    videos = model.gather_batch(videos, args.batch_size)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - start
    steps = args.num_steps if args.num_steps is not None else model.num_timesteps
    log.info("generated %d clips in %.3f s (%d steps)", videos.shape[0], seconds, steps)
    paths = []
    if group is None or group.rank == 0:
        paths = write_sample_gifs(videos, Path(args.output_path))
        for p in paths:
            log.info("wrote %s", p)
    return {"paths": paths, "videos": videos.cpu(), "known": clip, "mask": mask, "steps": steps,
            "seconds": seconds, "graph": {"captures": model.graphs.captures, "replays": model.graphs.replays()}}


def run_rank(rank: int, world: int, backend: str, init_method: str, argv=None) -> dict:
    """One rank of a multi-rank run (:func:`run` on the world's group)."""
    args = parse_args(argv)
    with joined(rank, world, backend, init_method, args.device.split(":")[0]) as group:
        return run(args, group)


def main(argv=None) -> dict:
    """Run the CLI; returns :func:`run`'s record (rank 0's over several ranks)."""
    args = parse_args(argv)
    if args.num_steps is not None and args.num_steps < 1:
        raise SystemExit("error: --num-steps must be >= 1")
    from video_diffusion_nnx_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    world = world_size(args.ranks, device)
    if world > 1:
        return launch(run_rank, world, args.dist_backend, device, argv)
    return run(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s")
    main()
