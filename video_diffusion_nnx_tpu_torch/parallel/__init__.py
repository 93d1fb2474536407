"""Groups of ranks and their meshes, the layout rules of sharded state, and sequence (frame-axis) parallelism."""

from video_diffusion_nnx_tpu_torch.parallel.mesh import (
    Mesh,
    SequenceGroup,
    add_rank_args,
    destroy_sequence_group,
    init_sequence_group,
    joined,
    launch,
    make_mesh,
    world_size,
)
from video_diffusion_nnx_tpu_torch.parallel.sequence import (
    all_reduce_sum,
    gather_frames,
    sequence_parallel_temporal_attention,
)

__all__ = [
    "Mesh",
    "SequenceGroup",
    "add_rank_args",
    "all_reduce_sum",
    "destroy_sequence_group",
    "gather_frames",
    "init_sequence_group",
    "joined",
    "launch",
    "make_mesh",
    "sequence_parallel_temporal_attention",
    "world_size",
]
