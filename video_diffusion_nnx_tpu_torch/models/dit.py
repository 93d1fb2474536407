"""VideoDiT, the transformer video denoiser family (counterpart of the JAX package's models/dit.py).

A factorized space/time transformer in the style of DiT: each frame is cut
into ``patch_size`` x ``patch_size`` patches, and every block attends over
the patches of a frame (spatial), then over the frames of a patch position
(temporal), then runs an MLP, each modulated by the timestep (and condition)
embedding through adaLN-Zero. Input ``(b, c, f, h, w)``, output
``(b, f, h, w, c)`` in float32, with ``forward_with_cond_scale`` for
classifier-free guidance: the Unet3D's calling convention, so
``GaussianDiffusion``, the trainer, every sampler, the CLIs and the server
drive it unchanged. Module names equal the JAX tree (``blocks.0.attn_spatial.q``,
``time_mlp.layers.1``), so ``convert.py`` maps a JAX state onto it.

Positions are computed sin/cos tables, not stored, so one model serves any
frame count and any size whose patches divide it. The adaLN gates, the final
modulation and the output projection start at zero, so the denoiser's output
is exactly 0 at init.

Under the bf16 policy the patch projection, the attentions and the MLP
compute in bf16; the parameterless LayerNorms return their input's type
(bf16 only in block 0's first norm), and the float32 modulation promotes
what they return, so every attention receives float32, as in the JAX
package. With ``use_fused_attention`` both attentions go through
``ops.temporal_attention`` (``x + MHA(x)`` over the second-to-last axis,
less ``x``): the dense, wide or blockwise kernels on the card, whichever
``temporal_plan`` picks for the shape, and their plain versions on the CPU.
``guidance_embed`` (JAX :177-184, :264-270) adds ``guidance_mlp(100 * w)``
to the time embedding, its output layer a ``ZeroLinear``, as the Unet3D's;
``forward_with_cond_scale`` then folds the scale into one forward of b rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from video_diffusion_nnx_tpu_torch.models.attention import MultiheadAttention
from video_diffusion_nnx_tpu_torch.models.layers import GELU, NORM_EPS, Linear, Sequential, SinusoidalPosEmb, ZeroLinear
from video_diffusion_nnx_tpu_torch.models.text import BERT_MODEL_DIM
from video_diffusion_nnx_tpu_torch.models.unet3d import _DTYPES
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta_ops
from video_diffusion_nnx_tpu_torch.utils.functional import prob_mask_like


def sincos_1d(dim: int, n: int, device=None) -> torch.Tensor:
    """(n, dim) float32 sin/cos table (JAX ``_sincos_1d``, :51-59): frequencies over ``max(half - 1, 1)``, an odd
    ``dim`` padded with a zero column."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=device, dtype=torch.float32) * (-math.log(10000.0) / max(half - 1, 1)))
    angles = torch.arange(n, device=device, dtype=torch.float32)[:, None] * freqs[None, :]
    return F.pad(torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1), (0, dim - 2 * half))


class PlainLayerNorm(nn.Module):
    """flax ``nnx.LayerNorm(use_scale=False, use_bias=False)``: float32 statistics E[x^2] - E[x]^2, eps 1e-6, no
    parameters, the result in the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + NORM_EPS)).to(x.dtype)


class DiTBlock(nn.Module):
    """Spatial attention, temporal attention and an MLP on ``(b, f, s, d)``, each gated by adaLN-Zero (JAX :62-126)."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_ratio: int, cond_dim: int, dtype=None,
                 use_fused_attention: bool = False):
        super().__init__()
        self.use_fused_attention = use_fused_attention
        self.norm_spatial = PlainLayerNorm()
        self.attn_spatial = MultiheadAttention(dim, head_dim, heads, reference_compat=False, dtype=dtype)
        self.norm_temporal = PlainLayerNorm()
        self.attn_temporal = MultiheadAttention(dim, head_dim, heads, reference_compat=False, dtype=dtype)
        self.norm_mlp = PlainLayerNorm()
        self.mlp = Sequential(Linear(dim, mlp_ratio * dim, dtype=dtype), GELU(), Linear(mlp_ratio * dim, dim, dtype=dtype))
        self.ada = ZeroLinear(cond_dim, 9 * dim)

    def _attn(self, mha: MultiheadAttention, h: torch.Tensor) -> torch.Tensor:
        """The attention term over axis -2 of ``h``: the fused op less its residual, or the module."""
        if not self.use_fused_attention:
            return mha(h)
        h = h.contiguous()
        return ta_ops.fused_temporal_attention_block(h, *ta_ops.pack_mha_weights(mha), mha.heads, mha.dim) - h

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x: (b, f, s, d); c: (b, cond_dim)."""
        m = self.ada(F.silu(c))[:, None, None, :]
        sh_s, sc_s, g_s, sh_t, sc_t, g_t, sh_m, sc_m, g_m = m.chunk(9, dim=-1)

        h = self.norm_spatial(x) * (1 + sc_s) + sh_s
        x = x + g_s * self._attn(self.attn_spatial, h)  # attends s

        h = self.norm_temporal(x) * (1 + sc_t) + sh_t
        h = self._attn(self.attn_temporal, h.transpose(1, 2))  # attends f
        x = x + g_t * h.transpose(1, 2)

        h = self.norm_mlp(x) * (1 + sc_m) + sh_m
        return x + g_m * self.mlp(h)


class VideoDiT(nn.Module):
    """DiT-style video denoiser with the Unet3D calling convention (JAX :129-292)."""

    def __init__(
        self,
        dim: int,
        depth: int = 8,
        channels: int = 3,
        attn_heads: int = 8,
        attn_dim_head: int = 64,
        patch_size: int = 4,
        mlp_ratio: int = 4,
        cond_dim: int | None = None,
        use_bert_text_cond: bool = False,
        compute_dtype=None,
        guidance_embed: bool = False,
        use_fused_attention: bool = False,
    ):
        super().__init__()
        if isinstance(compute_dtype, str) or compute_dtype is None:
            compute_dtype = _DTYPES[compute_dtype]
        self.channels = channels
        self.patch_size = p = int(patch_size)
        self.dim = dim
        self.compute_dtype = compute_dtype
        self.use_fused_attention = use_fused_attention

        self.patch_proj = Linear(channels * p * p, dim, dtype=compute_dtype)
        self.time_mlp = Sequential(SinusoidalPosEmb(dim), Linear(dim, dim), GELU(), Linear(dim, dim))

        self.has_cond = cond_dim is not None or use_bert_text_cond
        cond_in = BERT_MODEL_DIM if use_bert_text_cond else cond_dim
        self.cond_dim = cond_in if self.has_cond else None
        if self.has_cond:  # redrawn from the caller's generator by reset_parameters
            self.null_cond_emb = nn.Parameter(torch.zeros(1, cond_in))
            self.cond_proj = Linear(cond_in, dim)

        self.has_guidance_embed = guidance_embed
        if guidance_embed:  # where JAX builds it (:177-184), before the blocks
            self.guidance_mlp = Sequential(SinusoidalPosEmb(dim), Linear(dim, dim), GELU(), ZeroLinear(dim, dim))

        self.blocks = nn.ModuleList([
            DiTBlock(dim, attn_heads, attn_dim_head, mlp_ratio, dim, dtype=compute_dtype,
                     use_fused_attention=use_fused_attention)
            for _ in range(depth)
        ])
        self.final_norm = PlainLayerNorm()
        self.final_ada = ZeroLinear(dim, 2 * dim)
        self.final_proj = ZeroLinear(dim, channels * p * p, dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``: flax's truncated lecun_normal for the linears, biases 0, the adaLN
        and output linears 0, ``null_cond_emb`` normal x 0.02 (JAX :172-174)."""
        for module in self.modules():
            if isinstance(module, Linear):
                module.reset_parameters(generator)
        if self.has_cond:
            with torch.no_grad():
                self.null_cond_emb.copy_(torch.randn(self.null_cond_emb.shape, generator=generator) * 0.02)

    def forward_with_cond_scale(self, x, time, cond=None, cond_scale: float = 2.0, **kwargs) -> torch.Tensor:
        """Classifier-free guidance, ``null + (cond_out - null) * cond_scale`` (JAX :204-225).

        Without a condition, or at ``cond_scale == 1``, one forward; otherwise one forward of 2b rows, the second
        half given the null embedding (``null_cond_mask = arange(2b) >= b``), made on x's device so that the call
        can be captured in a CUDA graph. A ``guidance_embed`` model folds the scale into one forward of b rows
        (JAX :209-211).
        """
        if self.has_guidance_embed:
            w = torch.full((x.shape[0],), float(cond_scale), dtype=torch.float32, device=x.device)
            return self(x, time, cond=cond, null_cond_prob=0.0, guidance_scale=w, **kwargs)
        if cond_scale == 1 or not self.has_cond:
            return self(x, time, cond=cond, null_cond_prob=0.0, **kwargs)
        if cond is None:
            raise ValueError("cond must be passed in if cond_dim specified")
        b = x.shape[0]
        null_mask = torch.arange(2 * b, device=x.device) >= b
        out = self(torch.cat([x, x]), torch.cat([time, time]), cond=torch.cat([cond, cond]),
                   null_cond_mask=null_mask, **kwargs)
        cond_out, null = out[:b], out[b:]
        return null + (cond_out - null) * cond_scale

    def draw_masks(self, b: int, prob_focus_present: float, null_cond_prob: float, generator, device,
                   focus_present_mask: torch.Tensor | None = None,
                   null_cond_mask: torch.Tensor | None = None) -> tuple[None, torch.Tensor | None]:
        """``(None, null_cond_mask)`` for b samples (the DiT has no focus mask): the mask given, else drawn from
        ``generator`` where ``null_cond_prob`` lies strictly between 0 and 1; None for an unconditioned model.
        ``forward`` takes its mask from here, and so does the data-parallel loss."""
        del prob_focus_present, focus_present_mask
        if not self.has_cond:
            return None, None
        return None, null_cond_mask if null_cond_mask is not None else prob_mask_like((b,), null_cond_prob, generator,
                                                                                      device)

    def forward(self, x: torch.Tensor, time: torch.Tensor, cond: torch.Tensor | None = None,
                null_cond_prob: float = 0.0, focus_present_mask: torch.Tensor | None = None,
                prob_focus_present: float = 0.0, *, generator: torch.Generator | None = None,
                null_cond_mask: torch.Tensor | None = None, guidance_scale: torch.Tensor | None = None) -> torch.Tensor:
        """Denoise ``x`` of shape ``(b, c, f, h, w)``; returns ``(b, f, h, w, c)`` float32 (JAX :227-292).

        ``cond`` (b, cond_dim) is required when the model is conditioned; each sample's condition is swapped for
        ``null_cond_emb`` where ``null_cond_mask`` is True, else with probability ``null_cond_prob`` (drawn from
        ``generator`` where it lies strictly between 0 and 1). The focus arguments exist for the Unet3D's
        interface and are ignored, as in the JAX package. ``guidance_scale`` (b,) is the guidance embedding's w
        (ones when not given; ignored without the embedding).
        """
        del focus_present_mask, prob_focus_present
        if self.has_cond and cond is None:
            raise ValueError("cond must be passed in if cond_dim specified")
        b, _, f, h, w = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"spatial size {h}x{w} must divide the patch size {p}")

        tokens = self.patch_proj(rearrange(x, "b c f (hh p1) (ww p2) -> b f (hh ww) (p1 p2 c)", p1=p, p2=p))
        s = tokens.shape[2]
        pos = sincos_1d(self.dim, s, x.device)[None, None] + sincos_1d(self.dim, f, x.device)[None, :, None]
        tokens = tokens + pos.to(tokens.dtype)

        t_emb = self.time_mlp(time)
        if self.has_guidance_embed:
            w = guidance_scale if guidance_scale is not None else torch.ones(b, device=x.device)
            t_emb = t_emb + self.guidance_mlp(w.float() * 100.0)
        if self.has_cond:
            _, mask = self.draw_masks(b, 0.0, null_cond_prob, generator, x.device, null_cond_mask=null_cond_mask)
            t_emb = t_emb + self.cond_proj(torch.where(mask[:, None], self.null_cond_emb, cond.to(t_emb.dtype)))

        for block in self.blocks:
            tokens = block(tokens, t_emb)

        shift, scale = self.final_ada(F.silu(t_emb))[:, None, None, :].chunk(2, dim=-1)
        out = self.final_proj(self.final_norm(tokens) * (1 + scale) + shift)  # (b, f, s, p*p*c)
        out = rearrange(out, "b f (hh ww) (p1 p2 c) -> b f (hh p1) (ww p2) c", hh=h // p, p1=p, p2=p)
        return out.float()
