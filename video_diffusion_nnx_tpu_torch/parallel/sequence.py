"""Sequence (frame-axis) parallelism for temporal attention (counterpart of the JAX package's parallel/sequence.py:39-89).

Each rank holds f_l = f / world of a clip's frames. A temporal attention
projects K and V for its local frames (a plain product, outside the kernel,
as in JAX :65-68), gathers them along the frames from every rank, and attends
its local queries against all f frames through the cross-attention op
(``ops/cross_attention.py``). Outputs stay frame-sharded.

The two collectives are autograd functions whose backward is their
transpose, as JAX differentiates ``all_gather`` and ``psum``:

* :func:`gather_frames`: all-gather along a dimension; backward, the sum over
  ranks of the cotangents, of which each rank receives only its own slice
  (JAX's ``psum_scatter``; a reduce-scatter, here one all-to-all and a float32
  sum);
* :func:`all_reduce_sum`: a sum all-reduce; backward, a sum all-reduce.

Every rank must call them in the same order, forward and backward: the model
is the same on every rank and the autograd graph with it.
"""

from __future__ import annotations

import torch

from video_diffusion_nnx_tpu_torch.ops.cross_attention import fused_cross_attention_block
from video_diffusion_nnx_tpu_torch.parallel.mesh import SequenceGroup


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: SequenceGroup, dim: int):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: SequenceGroup):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


def gather_frames(x: torch.Tensor, group: SequenceGroup, dim: int = 2) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; differentiable."""
    return _GatherFrames.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group: SequenceGroup) -> torch.Tensor:
    """The sum of every rank's ``x``; differentiable (its backward sums the cotangents too)."""
    return _AllReduceSum.apply(x, group)


def sequence_parallel_temporal_attention(x_local, wqkv, bqkv, wo, bo, heads: int, dim: int,
                                         group: SequenceGroup) -> torch.Tensor:
    """``x + MHA(x)`` over frames, with frames sharded over ``group``.

    ``x_local``: (b, s, f_l, c), this rank's frames; returns the same shape.
    The weights are packed as ``ops.temporal_attention.pack_mha_weights``
    packs them; their gradients are this rank's share, which the trainer sums
    over the ranks.
    """
    hd = heads * dim
    dt = x_local.dtype
    kv = x_local @ wqkv[:, hd:].to(dt) + bqkv[hd:].to(dt)
    k = gather_frames(kv[..., :hd].contiguous(), group)
    v = gather_frames(kv[..., hd:].contiguous(), group)
    return fused_cross_attention_block(x_local, k, v, wqkv[:, :hd], bqkv[:hd], wo, bo, heads, dim)
