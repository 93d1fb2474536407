"""Global-norm gradient clipping (counterpart of the JAX package's utils/grad.py:16-31).

Epsilon 1e-6 sits in both places the JAX package puts it: under the square
root of the norm and beside the norm in the clip scale.
"""

from __future__ import annotations

from typing import Sequence

import torch


def sum_of_squares(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every element squared over a non-empty list of tensors (float32)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


def global_l2_norm(grads: Sequence[torch.Tensor], epsilon: float = 1e-6) -> torch.Tensor:
    """``sqrt(sum of every element squared + epsilon)`` over a list of tensors (float32)."""
    return torch.sqrt(sum_of_squares(grads) + epsilon)


def clip_grad_norm(grads: Sequence[torch.Tensor], max_grad_norm: float, epsilon: float = 1e-6,
                   sum_sq: torch.Tensor | None = None):
    """Scale ``grads`` so their global L2 norm is at most ``max_grad_norm``.

    ``sum_sq``, where given, is the global sum of squares to take the norm of
    in place of ``grads``' own (a sharded gradient's: the ranks' sums of their
    shards, all-reduced). Returns ``(clipped_grads, pre_clip_norm)``, the JAX
    package's contract.
    """
    norm = global_l2_norm(grads, epsilon) if sum_sq is None else torch.sqrt(sum_sq + epsilon)
    scale = torch.clamp(max_grad_norm / (norm + epsilon), max=1.0)
    return torch._foreach_mul(list(grads), scale), norm
