from video_diffusion_nnx_tpu_torch.models.attention import (
    MultiheadAttention,
    RelativePositionBias,
    SpatialLinearAttention,
)
from video_diffusion_nnx_tpu_torch.models.blocks import Block, ResnetBlock
from video_diffusion_nnx_tpu_torch.models.dit import VideoDiT
from video_diffusion_nnx_tpu_torch.models.unet3d import Unet3D

__all__ = [
    "Block",
    "MultiheadAttention",
    "RelativePositionBias",
    "ResnetBlock",
    "SpatialLinearAttention",
    "Unet3D",
    "VideoDiT",
]
