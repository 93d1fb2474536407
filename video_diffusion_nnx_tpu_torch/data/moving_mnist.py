"""Moving-MNIST ``.npy`` dataset (counterpart of the JAX package's data/moving_mnist.py:33-67).

The file is ``(frames, sequences, h, w)``; an item is ``(channels=1,
num_frames, h, w)`` float32, padded or cut to ``num_frames``. Two quirks of
the reference stay, as in the JAX package: values are raw (0..255 for a
``uint8`` file) unless ``normalize=True`` scales them to [0, 1], and
``image_size`` is stored but nothing is resized. The misspelled
``channnels`` attribute is kept beside ``channels``.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from video_diffusion_nnx_tpu_torch.utils.image import cast_num_frames


class MovingMNIST:
    def __init__(self, file_path: str, image_size, channels: int = 1, num_frames: int = 20,
                 horizontal_flip: bool = False, force_num_frames: bool = True, normalize: bool = False):
        self.file_path = file_path
        self.image_size = image_size
        self.channels = channels
        self.channnels = channels
        self.horizontal_flip = horizontal_flip
        arrays = np.transpose(np.load(file_path), (1, 0, 2, 3))[:, None, ...].astype(np.float32)
        if normalize:
            arrays = arrays / 255.0
        self.arrays = arrays
        self.cast_num_frames_fn = (
            partial(cast_num_frames, frames=num_frames) if force_num_frames else (lambda t: t)
        )

    def __len__(self) -> int:
        return self.arrays.shape[0]

    def __getitem__(self, index: int) -> np.ndarray:
        return self.cast_num_frames_fn(self.arrays[index])
