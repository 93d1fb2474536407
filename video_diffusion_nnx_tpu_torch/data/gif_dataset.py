"""Folder-of-GIFs video dataset (counterpart of the JAX package's data/gif_dataset.py:26).

GIFs under ``folder/**/*.gif`` are decoded on the host with PIL, each frame
resized (bilinear) to ``image_size`` squared and scaled to [0, 1], and the
clip padded with zero frames or cut to ``num_frames``: an item is
``(channels, frames, h, w)`` float32, bit-equal to the JAX dataset's. With
``use_path_as_cond`` an item is ``(video, caption)``, the caption taken from
the file's name (``utils.functional.get_text_from_path``: "three_digits_42.gif"
gives "three digits 42"); ``data.loader.collate_with_text_cond`` batches those.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
from PIL import Image

from video_diffusion_nnx_tpu_torch.utils.functional import get_text_from_path
from video_diffusion_nnx_tpu_torch.utils.image import cast_num_frames
from video_diffusion_nnx_tpu_torch.utils.media import seek_all_images


class GifVideoDataset:
    """Videos from ``folder/**/*.gif`` as ``(channels, frames, h, w)`` float32.

    ``channels`` is 1 (L), 3 (RGB) or 4 (RGBA); ``num_frames`` is the pad/cut target when
    ``force_num_frames``; ``use_path_as_cond`` makes an item ``(video, caption)``.
    """

    def __init__(self, folder: str, image_size: int, channels: int = 3, num_frames: int = 16,
                 force_num_frames: bool = True, use_path_as_cond: bool = False):
        self.folder = Path(folder)
        self.image_size = image_size
        self.channels = channels
        self.use_path_as_cond = use_path_as_cond
        self.paths = sorted(self.folder.rglob("*.gif"))
        if not self.paths:
            raise FileNotFoundError(f"no .gif files under {folder}")
        self.cast_num_frames_fn = partial(cast_num_frames, frames=num_frames) if force_num_frames else (lambda t: t)
        self._mode_channels = {1: 1, 3: 2, 4: 3}[channels]  # seek_all_images keys its modes one off

    def __len__(self) -> int:
        return len(self.paths)

    def _decode(self, path: Path) -> np.ndarray:
        frames = []
        for frame in seek_all_images(Image.open(path), channels=self._mode_channels):
            frame = frame.resize((self.image_size, self.image_size), Image.BILINEAR)
            arr = np.asarray(frame, dtype=np.float32) / 255.0
            frames.append(arr[..., None] if arr.ndim == 2 else arr)
        return np.transpose(np.stack(frames, axis=0), (3, 0, 1, 2))  # (f, h, w, c) -> (c, f, h, w)

    def __getitem__(self, index: int):
        path = self.paths[index]
        video = self.cast_num_frames_fn(self._decode(path))
        if self.use_path_as_cond:
            return video, get_text_from_path(str(path))
        return video
