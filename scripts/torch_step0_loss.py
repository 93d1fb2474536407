"""The untrained flagship's step-0 v-loss over initial seeds: how far the initial draw alone moves it.

    python scripts/torch_step0_loss.py [--seeds 0-7] [--device cuda] [--rows-per-forward 8] [--untruncated]
        [--out result.json]

Builds the Unet3D of configs/config_bouncing_digits.yaml (full width and depth) in float32 through the plain
modules (no fused op, TF32 off), once per ``unet.rngs_seed``, and evaluates its v-prediction loss on one batch of
8 bouncing-digit clips of 10 frames (the port's generator, numpy seed 0), at timesteps drawn by
``np.random.default_rng(1)`` and noise by ``np.random.default_rng(2)``: the inputs of
scripts/jax_step0_loss.py, which gives the JAX package's losses on the CPU. The batch goes through the model
``--rows-per-forward`` rows at a time (fewer bound the host memory on the CPU); the loss is the mean of the
equal-sized chunks' means. ``--untruncated`` draws each kernel from an untruncated normal of the same variance
instead of flax's truncated ``lecun_normal``, for comparison. Prints one JSON line, with the batch's and the
noise's sums.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from video_diffusion_nnx_tpu_torch.config import build_models, load_config  # noqa: E402
from video_diffusion_nnx_tpu_torch.data import bouncing_digits  # noqa: E402
from video_diffusion_nnx_tpu_torch.models import layers  # noqa: E402

CONFIG = REPO / "configs" / "config_bouncing_digits.yaml"


def _untruncated_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))


def seeds_arg(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def inputs(frames: int, size: int, timesteps: int, clips: int = 8):
    """``(x, t, noise)``: x (clips, 1, frames, size, size) in [0, 1] (the training loader's view of the generator's
    clips), t (clips,) and noise like x (float32), as numpy arrays."""
    glyphs = bouncing_digits._load_glyphs()
    raw = bouncing_digits.make_clips(glyphs, clips, frames, size, 2, np.random.default_rng(0))  # (F, B, H, W)
    x = raw.transpose(1, 0, 2, 3)[:, None].astype(np.float32) / 255.0
    t = np.random.default_rng(1).integers(0, timesteps, size=clips)
    noise = np.random.default_rng(2).standard_normal(x.shape, dtype=np.float32)
    return x, t, noise


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-7"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows-per-forward", type=int, default=8)
    ap.add_argument("--untruncated", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.untruncated:
        layers._lecun_normal_ = _untruncated_
    config = load_config(CONFIG)
    config["unet"].update(compute_dtype=None, use_fused_attention=False, use_fused_spatial_attention=False)
    d = config["diffusion"]
    x_np, t_np, noise_np = inputs(d["num_frames"], d["image_size"], d["timesteps"])
    x, noise = torch.from_numpy(x_np).to(args.device), torch.from_numpy(noise_np).to(args.device)
    t = torch.from_numpy(t_np).long().to(args.device)
    rows = args.rows_per_forward
    if x.shape[0] % rows:
        raise ValueError(f"--rows-per-forward {rows} must divide the batch of {x.shape[0]}")
    losses = {}
    for seed in args.seeds:
        config["unet"]["rngs_seed"] = seed
        _, diffusion = build_models(config, device=args.device)
        with torch.no_grad():
            parts = [diffusion(x[i:i + rows], t=t[i:i + rows], noise=noise[i:i + rows]).item()
                     for i in range(0, x.shape[0], rows)]
        losses[seed] = sum(parts) / len(parts)
        del diffusion
    values = list(losses.values())
    out = {"package": "port", "init": "untruncated normal" if args.untruncated else "truncated lecun_normal",
           "device": args.device,
           "losses": losses, "min": min(values), "median": statistics.median(values), "max": max(values),
           "batch": list(x.shape), "t": t.tolist(), "x_sum": float(x_np.sum(dtype=np.float64)),
           "noise_sum": float(noise_np.sum(dtype=np.float64))}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
