"""Attention modules (counterpart of the JAX package's models/attention.py:43-301).

These are the module route, taken when the fused flags are off. Each has the
``reference_compat`` switch of its JAX counterpart. Compat math: the spatial
linear attention drops its q scale, and the temporal attention applies a
focus mask and a position bias after the softmax (quirks that only a direct
caller sees: the compat PreNorm drops both before they get here). Fixed
math: the q scale is applied, and the bias and then the mask go onto the
logits before the softmax. Softmaxes and the attention products accumulate
in float32 under a bf16 policy, and round to it after.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.models.layers import Linear, PointwiseConv, compute_dtype


_NEG_INF = torch.finfo(torch.float32).min


def _to(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if dtype is not None else x


def _host_bool(x: torch.Tensor) -> bool | None:
    """A Python bool for a scalar already on the host, else None.

    The counterpart of the JAX ``_concrete_bool``, which gives None under
    ``jit``: reading a CUDA scalar would stall the step, so it is never read.
    """
    return None if x.is_cuda else bool(x)


class SpatialLinearAttention(nn.Module):
    """Linear attention over the ``h*w`` tokens of each frame; ``(b, f, h, w, c)`` in and out."""

    def __init__(self, dim: int, heads: int, D: int, dtype=None, reference_compat: bool = True):
        super().__init__()
        self.scale = D ** -0.5
        self.heads = heads
        self.dtype = dtype
        self.reference_compat = reference_compat
        hd = D * heads
        self.q = PointwiseConv(dim, hd, bias=False, dtype=dtype)
        self.k = PointwiseConv(dim, hd, bias=False, dtype=dtype)
        self.v = PointwiseConv(dim, hd, bias=False, dtype=dtype)
        self.to_out = PointwiseConv(hd, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        tokens = x.reshape(b * f, h * w, c)

        def split_heads(t: torch.Tensor) -> torch.Tensor:  # (bf, n, H*D) -> (bf, H, D, n)
            return t.reshape(b * f, h * w, self.heads, -1).permute(0, 2, 3, 1)

        q = split_heads(self.q(tokens))
        k = split_heads(self.k(tokens))
        v = split_heads(self.v(tokens))
        q = torch.softmax(q.float(), dim=-2)
        if not self.reference_compat:  # compat drops the q scale (reference quirk)
            q = q * self.scale
        q = _to(q, self.dtype)
        k = _to(torch.softmax(k.float(), dim=-1), self.dtype)
        context = _to(torch.einsum("bhdn,bhen->bhde", k.float(), v.float()), self.dtype)
        out = _to(torch.einsum("bhde,bhdn->bhen", context.float(), q.float()), self.dtype)
        out = out.permute(0, 3, 1, 2).reshape(b * f, h * w, -1)
        return self.to_out(out).reshape(b, f, h, w, c)


class MultiheadAttention(nn.Module):
    """Multi-head attention along the second-to-last axis; ``(..., f, c)`` in and out.

    ``q``, ``k``, ``v`` are ``Linear(c, heads*dim)`` and ``out`` is
    ``Linear(heads*dim, c)``; the JAX package holds the same weights as
    ``(c, heads, dim)`` and ``(heads, dim, c)`` kernels.

    ``focus_present_mask`` (b,) makes a sample attend only to itself and
    ``pos_bias`` (heads, f, f) biases the attention. With
    ``reference_compat=False`` the bias and then the mask are applied to the
    logits; with ``True`` both come after the softmax, as the reference has
    them (masked entries set to the most negative float, not renormalised).
    """

    def __init__(self, in_features: int, dim: int, num_heads: int,
                 reference_compat: bool = True, dtype=None):
        super().__init__()
        hd = num_heads * dim
        self.q = Linear(in_features, hd, dtype=dtype)
        self.k = Linear(in_features, hd, dtype=dtype)
        self.v = Linear(in_features, hd, dtype=dtype)
        self.out = Linear(hd, in_features, dtype=dtype)
        self.dim = dim
        self.heads = num_heads
        self.reference_compat = reference_compat
        self.dtype = dtype

    def forward(self, x: torch.Tensor, focus_present_mask: torch.Tensor | None = None,
                pos_bias: torch.Tensor | None = None) -> torch.Tensor:
        lead, f = x.shape[:-2], x.shape[-2]

        def split(t: torch.Tensor) -> torch.Tensor:  # (..., f, H*D) -> (..., f, H, D)
            return t.reshape(*lead, f, self.heads, self.dim)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))

        if focus_present_mask is not None:
            all_present = _host_bool(focus_present_mask.all())
            if all_present:
                # Every sample attends only to itself: attention is the identity, and the
                # block is the output projection of v.
                return self.out(v.reshape(*lead, f, self.heads * self.dim))
            if all_present is None and self.reference_compat:
                raise ValueError(
                    "reference_compat MultiheadAttention reads the focus_present_mask on the host; "
                    "pass a CPU mask or use reference_compat=False"
                )

        dt = compute_dtype(self.dtype, q)
        # A fill on q's device, not a copy from the host, so that a CUDA graph can capture it.
        q = q / torch.full((), math.sqrt(self.dim), dtype=dt, device=q.device)
        sim = torch.einsum("...ihd,...jhd->...hij", q.float(), k.float())

        if self.reference_compat:
            attn = torch.softmax(sim, dim=-1)
            if focus_present_mask is not None and _host_bool(focus_present_mask.any()):
                attn = torch.where(self._focus_mask(focus_present_mask, f, attn.dim()), attn, _NEG_INF)
            if pos_bias is not None:
                attn = attn + pos_bias
        else:
            if pos_bias is not None:
                sim = sim + pos_bias
            if focus_present_mask is not None:
                sim = torch.where(self._focus_mask(focus_present_mask, f, sim.dim()), sim, _NEG_INF)
            attn = torch.softmax(sim, dim=-1)

        attn = _to(attn, self.dtype)
        out = _to(torch.einsum("...hij,...jhd->...ihd", attn.float(), v.float()), self.dtype)
        return self.out(out.reshape(*lead, f, self.heads * self.dim))

    @staticmethod
    def _focus_mask(focus_present_mask: torch.Tensor, f: int, attn_ndim: int) -> torch.Tensor:
        """Per sample, attend to all frames or to itself; broadcasts the (b,) mask to the attention's rank."""
        device = focus_present_mask.device
        attend_all = torch.ones(f, f, dtype=torch.bool, device=device)
        attend_self = torch.eye(f, dtype=torch.bool, device=device)
        batch_shape = tuple(focus_present_mask.shape) + (1,) * (attn_ndim - 1)
        return torch.where(focus_present_mask.reshape(batch_shape), attend_self, attend_all)


class _BucketLookup(torch.autograd.Function):
    """``table[buckets]`` whose backward sums each bucket's gradients as one matrix product.

    ``nn.Embedding``'s own backward adds with atomics once the indices are many (16384 at 128
    frames), so two runs differ in the last bits; a product with the one-hot matrix of the
    buckets gives the same sums in a fixed order.
    """

    @staticmethod
    def forward(ctx, table: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(buckets)
        ctx.num_buckets = table.shape[0]
        return table[buckets]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (buckets,) = ctx.saved_tensors
        one_hot = torch.nn.functional.one_hot(buckets.reshape(-1), ctx.num_buckets).to(grad.dtype)
        return one_hot.t() @ grad.reshape(-1, grad.shape[-1]), None


class RelativePositionBias(nn.Module):
    """T5-style bucketed relative position bias, ``(heads, n, n)``.

    Its parameters are part of every checkpoint. In reference-compat math
    the bias never reaches the attention (the compat PreNorm drops it); in
    fixed math it is added to every temporal attention's logits and trains.
    """

    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    @staticmethod
    def _relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                                  max_distance: int = 128) -> torch.Tensor:
        n = -relative_position
        num_buckets //= 2
        ret = (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
        max_exact = num_buckets // 2
        is_small = n < max_exact
        val_if_large = max_exact + (
            torch.log(n.float() / max_exact)
            / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)
        ).to(torch.int32)
        val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
        return ret + torch.where(is_small, n, val_if_large)

    def forward(self, n: int) -> torch.Tensor:
        pos = torch.arange(n, dtype=torch.int32, device=self.relative_attention_bias.weight.device)
        buckets = self._relative_position_bucket(
            pos[:, None] - pos[None, :], self.num_buckets, self.max_distance
        )
        return _BucketLookup.apply(self.relative_attention_bias.weight, buckets.long()).permute(2, 0, 1)
