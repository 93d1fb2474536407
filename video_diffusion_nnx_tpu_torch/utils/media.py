"""GIF input and output, PIL and numpy only (counterpart of the JAX package's utils/media.py:20-109).

The artifact format is the reference's: one ``sample_{i}.gif`` per clip,
scaled to uint8 by the batch-global min and max so clips stay comparable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
from PIL import Image

# The reference's keys (JAX utils/media.py:20-24): 2 -> RGB and 3 -> RGBA, one off from the channel count;
# `seek_all_images(img, channels=3)` yields RGBA frames, as there.
CHANNELS_TO_MODE = {1: "L", 2: "RGB", 3: "RGBA"}
_NUM_CHANNELS_TO_MODE = {1: "L", 3: "RGB", 4: "RGBA"}


def seek_all_images(img: Image.Image, channels: int = 3) -> Iterator[Image.Image]:
    """Yield every frame of a (possibly animated) PIL image, converted (JAX utils/media.py:29)."""
    if channels not in CHANNELS_TO_MODE:
        raise ValueError(f"channels {channels} invalid")
    mode = CHANNELS_TO_MODE[channels]
    i = 0
    while True:
        try:
            img.seek(i)
            yield img.convert(mode)
        except EOFError:
            break
        i += 1


def _frame_to_pil(frame: np.ndarray) -> Image.Image:
    """Convert one ``(h, w)`` or ``(h, w, c)`` uint8 frame to a PIL image."""
    if frame.ndim == 3 and frame.shape[-1] == 1:
        frame = frame[..., 0]
    if frame.ndim == 2:
        return Image.fromarray(frame, mode="L")
    mode = _NUM_CHANNELS_TO_MODE.get(frame.shape[-1])
    if mode is None:
        raise ValueError(f"unsupported channel count {frame.shape[-1]}")
    return Image.fromarray(frame, mode=mode)


def video_array_to_gif(
    arr: np.ndarray, path, duration: int = 120, loop: int = 0, optimize: bool = True
) -> list[Image.Image]:
    """Save a ``(frames, h, w, c)`` uint8 array as an animated GIF."""
    arr = np.asarray(arr)
    frames = [_frame_to_pil(f) for f in arr]
    first, *rest = frames
    first.save(
        path, save_all=True, append_images=rest, duration=duration, loop=loop, optimize=optimize
    )
    return frames


def write_sample_gifs(videos, out_dir, names=None) -> list[Path]:
    """Write a ``(b, c, f, h, w)`` batch (tensor or array) as one GIF per clip."""
    if hasattr(videos, "detach"):
        videos = videos.detach().float().cpu().numpy()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    arr = np.moveaxis(np.asarray(videos), 1, -1)  # b c f h w -> b f h w c
    lo, hi = arr.min(), arr.max()
    scaled = ((arr - lo) / max(float(hi - lo), 1e-12) * 255).astype(np.uint8)
    if names is None:
        names = [f"sample_{i}" for i in range(len(scaled))]
    paths = []
    for name, clip in zip(names, scaled):
        target = out_dir / f"{name}.gif"
        video_array_to_gif(clip, target)
        paths.append(target)
    return paths
