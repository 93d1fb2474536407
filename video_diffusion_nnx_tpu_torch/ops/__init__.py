"""Fused attention ops: plain PyTorch versions beside hand-written CUDA kernels for Hopper."""

from video_diffusion_nnx_tpu_torch.ops import cross_attention, spatial_linear_attention, temporal_attention

_COUNTERS = (temporal_attention.launches, spatial_linear_attention.launches, cross_attention.launches)
_STAGED = (temporal_attention.staged, spatial_linear_attention.staged, cross_attention.staged)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    out: dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def staged_launch_counts() -> dict[str, int]:
    """Of the launches since the last reset, those that ran a staged kernel (panels in shared memory, the
    tensor cores in bf16), by kernel name, for the kernels that also have a CUDA-core version."""
    out: dict[str, int] = {}
    for counter in _STAGED:
        out.update(counter)
    return out


def tf32x3_launch_counts() -> dict[str, int]:
    """Of the launches since the last reset, those of the temporal backward that ran its float32 tensor-core
    design (csrc/temporal_tf32x3.cu), by kernel name."""
    return dict(temporal_attention.tf32x3)


def staged_tf32x3_launch_counts() -> dict[str, int]:
    """Of the staged launches since the last reset, those of the temporal backward that ran the staged dense or
    the streaming kernel in float32, its products on the tensor cores in 3xTF32 (design "staged-3xtf32")."""
    return dict(temporal_attention.staged_tf32x3)


def reset_launch_counts() -> None:
    for counter in _COUNTERS + _STAGED + (temporal_attention.tf32x3, temporal_attention.staged_tf32x3):
        for name in counter:
            counter[name] = 0
