"""Core layers (counterpart of the JAX package's models/layers.py:35-195, and of its :221 ``Linear`` as ``UniformLinear``).

Activations are channels-last, ``(b, f, h, w, c)``, as in the JAX package.
Every layer keeps its parameters in float32 and computes in ``dtype`` when
one is given (the bf16 policy), else in the promoted type of its inputs.
A layer rounds where its JAX counterpart rounds: a conv or matmul result is
cast to the compute type before its bias is added.

Parameter names follow PyTorch (``weight``, ``bias``); their layouts are
PyTorch's (``convert.py`` maps the JAX package's layouts onto them):

* ``PseudoConv3d``: ``(cout, cin, kh, kw)``;
* ``PseudoConvTranspose3d``: ``(cin, cout, kh, kw)``, spatially flipped
  against the JAX kernel (``lax.conv_transpose`` does not flip it);
* ``PointwiseConv`` and ``Linear``: ``(cout, cin)``.

The JAX ``SAME`` padding becomes explicit padding: 7x7 -> 3, 3x3 -> 1,
the 4x4 stride-2 downsample -> 1, the 4x4 stride-2 transposed upsample -> 1.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from video_diffusion_nnx_tpu_torch.parallel.sequence import all_reduce_sum

NORM_EPS = 1e-6  # flax's LayerNorm and GroupNorm epsilon (torch's default is 1e-5)


def compute_dtype(dtype: torch.dtype | None, *tensors: torch.Tensor) -> torch.dtype:
    """``dtype`` when set, else the promoted type of ``tensors`` (flax's promote_dtype)."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


_TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated to [-2, 2]


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init (``jax.nn.initializers.lecun_normal``): a unit normal truncated to [-2, 2], scaled
    by ``sqrt(1 / fan_in) / 0.8796`` so the variance is ``1 / fan_in``.

    Drawn as ``jax.random.truncated_normal`` draws it: one uniform from ``generator`` per element, mapped through
    the inverse normal CDF between the bounds' CDFs, then clipped inside the bounds. The draw is float32 on the
    CPU, so a seed gives the same weights whatever the device and the torch version.
    """
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    bound = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0)).item()
    with torch.no_grad():
        p.copy_(z.clamp_(-bound, bound) * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


class Linear(nn.Module):
    """Dense layer ``x @ W^T + b`` with the compute-dtype policy (flax ``nnx.Linear``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ZeroLinear(Linear):
    """A ``Linear`` whose weight and bias start at zero, and stay zero through ``reset_parameters`` (JAX
    ``models/dit.py _zero_linear``, :44-48, and the zeroed ``w_out`` of ``models/unet3d.py``, :307-310)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class UniformLinear(nn.Module):
    """``x @ w + b`` with ``w`` of shape (din, dout) drawn uniform in [0, 1) and a zero bias (the JAX package's
    ``models/layers.py`` ``Linear``, kept there for API completeness and used only by tests). No compute-dtype
    policy: the promoted type of ``x`` and ``w``."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))
        self.din, self.dout = din, dout

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.w.copy_(torch.rand(self.w.shape, generator=generator))
        nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class PointwiseConv(Linear):
    """1x1 conv on channels-last input: one matmul over all tokens."""


class PseudoConv3d(nn.Module):
    """``(1, kh, kw)`` conv on ``(b, f, h, w, c)``: a 2-D conv with frames folded into batch."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.stride = stride
        # flax SAME: odd kernels pad (k-1)/2; the 4x4 stride-2 downsample pads 1.
        self.padding = (kernel_size - 1) // 2 if stride == 1 else (kernel_size - stride) // 2
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, cin * kh * kw, generator)
        nn.init.zeros_(self.bias)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, w, None, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        dt = compute_dtype(self.dtype, x, self.weight)
        xs = x.to(dt).reshape(b * f, h, w, c).permute(0, 3, 1, 2)
        y = self._conv(xs, self.weight.to(dt)).permute(0, 2, 3, 1)
        y = y + self.bias.to(dt)
        return y.reshape(b, f, *y.shape[1:])


class PseudoConvTranspose3d(PseudoConv3d):
    """``(1, 4, 4)`` stride-2 transposed conv with frames folded into batch."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 stride: int, dtype=None):
        super().__init__(in_features, out_features, kernel_size, stride, dtype)
        self.weight = nn.Parameter(torch.empty(in_features, out_features, kernel_size, kernel_size))
        self.padding = (kernel_size - stride) // 2

    def reset_parameters(self, generator: torch.Generator) -> None:
        cin, cout, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, cin * kh * kw, generator)
        nn.init.zeros_(self.bias)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, w, None, self.stride, self.padding)


def Upsample(dim: int, dtype=None) -> PseudoConvTranspose3d:
    """2x spatial upsample via a 4x4 stride-2 transposed conv."""
    return PseudoConvTranspose3d(dim, dim, 4, 2, dtype=dtype)


def Downsample(dim: int, dtype=None) -> PseudoConv3d:
    """2x spatial downsample via a 4x4 stride-2 conv."""
    return PseudoConv3d(dim, dim, 4, 2, dtype=dtype)


class LayerNorm(nn.Module):
    """flax ``nnx.LayerNorm``: float32 statistics E[x^2] - E[x]^2, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + NORM_EPS) * self.weight) + self.bias
        return y.to(compute_dtype(None, x, self.weight))


class GroupNorm(nn.Module):
    """flax ``nnx.GroupNorm`` with float32 compute on ``(b, ..., c)`` input.

    Statistics reduce over every axis but the batch, within each group of
    channels: over (f, h, w, group) per sample, never per frame. With a
    ``sequence_group`` the frames are sharded over its ranks, and the float32
    sums of x and x^2 are summed over the ranks (a differentiable all-reduce)
    before the fast variance E[x^2] - E[x]^2 is taken: what GSPMD does
    implicitly for the JAX package's sharded activations.
    """

    def __init__(self, dim: int, groups: int, sequence_group=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.sequence_group = sequence_group

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.float().reshape(b, -1, self.groups, c // self.groups)
        if self.sequence_group is None:
            mean = xg.mean((1, 3), keepdim=True)
            mean2 = (xg * xg).mean((1, 3), keepdim=True)
        else:
            count = xg.shape[1] * xg.shape[3] * self.sequence_group.world_size
            sums = torch.stack([xg.sum((1, 3), keepdim=True), (xg * xg).sum((1, 3), keepdim=True)])
            mean, mean2 = all_reduce_sum(sums, self.sequence_group) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        scale = self.weight.reshape(self.groups, c // self.groups)
        y = (xg - mean) * (torch.rsqrt(var + NORM_EPS) * scale) + self.bias.reshape(scale.shape)
        return y.reshape(x.shape)


class Identity(nn.Module):
    """Pass-through accepting and ignoring extra arguments."""

    def forward(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        return x


class Residual(nn.Module):
    """``fn(x) + x``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        return self.fn(x, *args, **kwargs) + x


class PreNorm(nn.Module):
    """LayerNorm-then-``fn`` with the reference-compat switch (JAX package models/layers.py:148-177).

    ``reference_compat=True`` keeps the reference's behaviour: ``fn`` runs on
    the un-normalized input and the extra arguments are dropped, so the norm
    is held (checkpoints carry its parameters) but never applied.
    ``False`` applies the norm and forwards ``*args, **kwargs`` to ``fn``.
    """

    def __init__(self, dim: int, fn: nn.Module, reference_compat: bool = True):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)
        self.reference_compat = reference_compat

    def forward(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        if self.reference_compat:
            return self.fn(x)
        return self.fn(self.norm(x), *args, **kwargs)


class SinusoidalPosEmb(nn.Module):
    """sin/cos timestep embedding: ``dim // 2`` geometric frequencies, base 10000."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        step = math.log(10000) / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, device=x.device, dtype=torch.float32) * -step)
        angles = x.float()[..., None] * freqs[None, :]
        return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class GELU(nn.Module):
    """``jax.nn.gelu``'s default: the tanh approximation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh")


class SiLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x)


class Sequential(nn.Module):
    """Layers applied in order, held as ``layers`` (the JAX ``nnx.Sequential`` path)."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class EinopsToAndFrom(nn.Module):
    """Rearrange -> fn -> rearrange back."""

    def __init__(self, from_einops: str, to_einops: str, fn: nn.Module):
        super().__init__()
        self.from_einops = from_einops
        self.to_einops = to_einops
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        axes = {
            name: size
            for name, size in zip(self.from_einops.split(" "), x.shape)
            if not name.startswith("(")
        }
        x = rearrange(x, f"{self.from_einops} -> {self.to_einops}")
        x = self.fn(x, **kwargs)
        return rearrange(x, f"{self.to_einops} -> {self.from_einops}", **axes)
