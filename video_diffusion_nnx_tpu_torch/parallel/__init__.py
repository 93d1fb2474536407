"""Sequence (frame-axis) parallelism: a group of ranks, each holding a share of a clip's frames."""

from video_diffusion_nnx_tpu_torch.parallel.mesh import SequenceGroup, destroy_sequence_group, init_sequence_group
from video_diffusion_nnx_tpu_torch.parallel.sequence import (
    all_reduce_sum,
    gather_frames,
    sequence_parallel_temporal_attention,
)

__all__ = [
    "SequenceGroup",
    "all_reduce_sum",
    "destroy_sequence_group",
    "gather_frames",
    "init_sequence_group",
    "sequence_parallel_temporal_attention",
]
