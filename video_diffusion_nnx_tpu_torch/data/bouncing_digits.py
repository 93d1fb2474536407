"""Bouncing-digits video data from real handwritten digits (counterpart of scripts/make_bouncing_digits.py).

The flagship recipe (``configs/config_bouncing_digits.yaml``) trains on this
data: the 1,797 genuine 8x8 scans of the UCI ML hand-written digits corpus
(43 writers), upscaled 2x and bounced around a 64x64 canvas with MovingMNIST
dynamics (constant velocity, elastic wall reflection, two digits per clip,
pixel max-composition). The output is the Moving-MNIST layout that
``data/moving_mnist.py`` reads: uint8 ``(F, B, H, W)`` in 0..255.

    python -m video_diffusion_nnx_tpu_torch.data.bouncing_digits --out data/bouncing_digits.npy \\
        --clips 2000 --frames 16 --holdout-out data/bouncing_digits_val.npy

The glyphs live beside this module in ``digits_8x8.npy``: scikit-learn's
bundled copy of that corpus (``sklearn.datasets.load_digits().images``,
float64 with whole values 0..16) stored as uint8 (1797, 8, 8), so this
module needs numpy and PIL alone. Its output equals the script's bit for
bit: one ``default_rng(seed)`` draws the train clips, then the holdout, then
the captioned GIFs, and the holdout's digits come from the last 10% of the
corpus (writer blocks the train split never sees).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

GLYPHS = Path(__file__).with_name("digits_8x8.npy")


def _load_glyphs(upscale: int = 2) -> np.ndarray:
    """All 1,797 real digit scans as (N, 8*u, 8*u) float32 arrays in 0..255."""
    images = np.load(GLYPHS).astype(np.float64)  # (1797, 8, 8), values 0..16
    glyphs = (images / 16.0 * 255.0).astype(np.float32)
    if upscale > 1:
        glyphs = np.repeat(np.repeat(glyphs, upscale, axis=1), upscale, axis=2)
    return glyphs


def make_clips(
    glyphs: np.ndarray,
    n_clips: int,
    n_frames: int,
    canvas: int,
    digits_per_clip: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """(F, B, H, W) uint8 clips of bouncing digits (MovingMNIST dynamics)."""
    g = glyphs.shape[1]
    span = canvas - g  # positions live in [0, span]
    out = np.zeros((n_frames, n_clips, canvas, canvas), np.float32)
    for b in range(n_clips):
        idx = rng.integers(0, glyphs.shape[0], size=digits_per_clip)
        pos = rng.uniform(0, span, size=(digits_per_clip, 2))
        # Speed ~2-4 px/frame at a random angle, like the classic generator.
        angle = rng.uniform(0, 2 * np.pi, size=digits_per_clip)
        speed = rng.uniform(2.0, 4.0, size=digits_per_clip)
        vel = np.stack([np.cos(angle), np.sin(angle)], 1) * speed[:, None]
        for f in range(n_frames):
            frame = out[f, b]
            for d in range(digits_per_clip):
                y, x = int(round(pos[d, 0])), int(round(pos[d, 1]))  # Python's round: half to even
                patch = frame[y : y + g, x : x + g]
                np.maximum(patch, glyphs[idx[d]], out=patch)
            pos += vel
            # Elastic reflection off the walls (reflect position, flip v).
            for d in range(digits_per_clip):
                for ax in range(2):
                    if pos[d, ax] < 0:
                        pos[d, ax] = -pos[d, ax]
                        vel[d, ax] = -vel[d, ax]
                    elif pos[d, ax] > span:
                        pos[d, ax] = 2 * span - pos[d, ax]
                        vel[d, ax] = -vel[d, ax]
    return out.astype(np.uint8)


_COUNT_WORDS = {1: "one digit", 2: "two digits", 3: "three digits"}


def make_captioned_gifs(
    glyphs: np.ndarray,
    out_dir: Path,
    clips_per_class: int,
    n_frames: int,
    canvas: int,
    rng: np.random.Generator,
) -> None:
    """Caption-conditioned variant: GIF clips whose file name carries the digit count
    ("one digit {i}.gif" / "two digits ..." / "three digits ..."), for ``use_path_as_cond``
    training (the GIF dataset derives the caption from the stem)."""
    from PIL import Image

    out_dir.mkdir(parents=True, exist_ok=True)
    for count, word in _COUNT_WORDS.items():
        clips = make_clips(glyphs, clips_per_class, n_frames, canvas, count, rng)
        for b in range(clips_per_class):
            frames = [Image.fromarray(clips[f, b], mode="L") for f in range(n_frames)]
            frames[0].save(
                out_dir / f"{word} {b}.gif",
                save_all=True, append_images=frames[1:], duration=100, loop=0,
            )
        print(f"wrote {clips_per_class} '{word}' clips to {out_dir}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Generate a bouncing-digits video dataset from real handwritten digits")
    ap.add_argument("--out", type=str, default=None,
                    help="output .npy (F,B,H,W); optional when only --captioned-gifs is requested")
    ap.add_argument("--holdout-out", type=str, default=None)
    ap.add_argument("--clips", type=int, default=2000)
    ap.add_argument("--holdout-clips", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--canvas", type=int, default=64)
    ap.add_argument("--digits-per-clip", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--captioned-gifs", type=str, default=None,
                    help="also write a caption-conditioned GIF dataset (digit-count captions) to this directory")
    ap.add_argument("--captioned-clips-per-class", type=int, default=256)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not (args.out or args.captioned_gifs):
        raise SystemExit("error: nothing to generate (give --out or --captioned-gifs)")
    glyphs = _load_glyphs()
    # Writer-disjoint split: the corpus is ordered in writer blocks, so an
    # index split keeps train and holdout handwriting disjoint.
    n_train_glyphs = int(glyphs.shape[0] * 0.9)
    rng = np.random.default_rng(args.seed)

    if args.out:
        train = make_clips(
            glyphs[:n_train_glyphs], args.clips, args.frames, args.canvas,
            args.digits_per_clip, rng,
        )
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        np.save(args.out, train)
        print(f"wrote {args.out}: {train.shape} uint8 (F,B,H,W), "
              f"mean {train.mean():.1f}, max {train.max()}")

    if args.holdout_out:
        holdout = make_clips(
            glyphs[n_train_glyphs:], args.holdout_clips, args.frames,
            args.canvas, args.digits_per_clip, rng,
        )
        Path(args.holdout_out).parent.mkdir(parents=True, exist_ok=True)
        np.save(args.holdout_out, holdout)
        print(f"wrote {args.holdout_out}: {holdout.shape}")

    if args.captioned_gifs:
        make_captioned_gifs(
            glyphs[:n_train_glyphs], Path(args.captioned_gifs),
            args.captioned_clips_per_class, args.frames, args.canvas, rng,
        )


if __name__ == "__main__":
    main()
