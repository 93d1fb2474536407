"""The untrained flagship's step-0 v-loss over initial seeds, in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_step0_loss.py [--seeds 0-3] [--rows-per-forward 1] [--out result.json]

The JAX side of scripts/torch_step0_loss.py, on the same inputs: the Unet3D of
configs/config_bouncing_digits.yaml (full width and depth) in float32 through the plain modules (no fused op),
built once per ``unet.rngs_seed`` (flax's initializers), and its v-prediction loss on one batch of 8 bouncing-digit
clips of 10 frames (scripts/make_bouncing_digits.py, numpy seed 0), at timesteps drawn by
``np.random.default_rng(1)`` and noise by ``np.random.default_rng(2)``. The batch goes through the model
``--rows-per-forward`` rows at a time, which bounds the host memory; the loss is the mean of the equal-sized
chunks' means. Prints one JSON line, with the batch's and the noise's sums to show the inputs are the port's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

CONFIG = REPO / "configs" / "config_bouncing_digits.yaml"
CLIPS = 8


def seeds_arg(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def inputs(frames: int, size: int, timesteps: int):
    """``(x, t, noise)``: x (8, 1, frames, size, size) in [0, 1], t (8,) int32, noise like x (float32)."""
    import make_bouncing_digits

    raw = make_bouncing_digits.make_clips(make_bouncing_digits._load_glyphs(), CLIPS, frames, size, 2,
                                          np.random.default_rng(0))  # (F, B, H, W)
    x = raw.transpose(1, 0, 2, 3)[:, None].astype(np.float32) / 255.0
    t = np.random.default_rng(1).integers(0, timesteps, size=CLIPS).astype(np.int32)
    noise = np.random.default_rng(2).standard_normal(x.shape, dtype=np.float32)
    return x, t, noise


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-3"))
    ap.add_argument("--rows-per-forward", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from flax import nnx

    from video_diffusion_nnx_tpu.config import build_models, load_config
    from video_diffusion_nnx_tpu.utils.image import normalize_img

    config = load_config(CONFIG)
    config["unet"].update(compute_dtype=None, use_fused_attention=False, use_fused_spatial_attention=False)
    d = config["diffusion"]
    x, t, noise = inputs(d["num_frames"], d["image_size"], d["timesteps"])
    rows = args.rows_per_forward
    if CLIPS % rows:
        raise ValueError(f"--rows-per-forward {rows} must divide the batch of {CLIPS}")
    losses = {}
    for seed in args.seeds:
        config["unet"]["rngs_seed"] = seed
        _, diffusion = build_models(config)
        graphdef, state = nnx.split(diffusion)

        @jax.jit
        def loss(state, x, t, noise):
            return nnx.merge(graphdef, state).p_losses(normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        parts = [float(loss(state, jnp.asarray(x[i:i + rows]), jnp.asarray(t[i:i + rows]),
                            jnp.asarray(noise[i:i + rows]))) for i in range(0, CLIPS, rows)]
        losses[seed] = sum(parts) / len(parts)
        del diffusion, state
    values = list(losses.values())
    out = {"package": "jax", "init": "flax lecun_normal", "device": jax.devices()[0].platform, "losses": losses,
           "min": min(values), "median": statistics.median(values), "max": max(values), "batch": list(x.shape),
           "t": t.tolist(), "x_sum": float(x.sum(dtype=np.float64)), "noise_sum": float(noise.sum(dtype=np.float64))}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
