"""Pixel-range and frame-count helpers (counterpart of the JAX package's utils/image.py:13-42)."""

from __future__ import annotations

import numpy as np
import torch


def normalize_img(t):
    """Map ``[0, 1]`` pixels to ``[-1, 1]``."""
    return t * 2 - 1


def unnormalize_img(t):
    """Map ``[-1, 1]`` pixels back to ``[0, 1]``."""
    return (t + 1) * 0.5


def cast_num_frames(t, *, frames: int):
    """Pad with zero frames or truncate a ``(c, f, h, w)`` clip (numpy array or tensor) to ``frames``."""
    num_frames = t.shape[1]
    if num_frames == frames:
        return t
    if num_frames > frames:
        return t[:, :frames, ...]
    if isinstance(t, np.ndarray):
        return np.pad(t, ((0, 0), (0, frames - num_frames), (0, 0), (0, 0)))
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, frames - num_frames))
