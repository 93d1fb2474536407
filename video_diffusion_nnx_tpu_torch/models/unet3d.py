"""Unet3D, the factorized (2+1)-D video denoiser (counterpart of the JAX package's models/unet3d.py).

Input ``(b, c, f, h, w)``, output ``(b, f, h, w, c)`` in float32, as in the
JAX package. Module names and nesting equal the JAX tree (``downs``/``ups``
as lists of five-element lists, ``Residual -> PreNorm -> ...`` wrappers), so
a JAX state path maps to one parameter here (``convert.py``).

Both maths are ported, unconditioned: reference-compat
(``reference_compat=True``: every PreNorm drops its norm, the position bias
and the focus mask) and fixed (``False``: pre-norms applied, the relative
position bias on the temporal logits, the spatial q scale, a focus-present
mask). The options outside raise ``NotImplementedError`` naming their
ROADMAP item.

``sequence_parallel_mesh`` (a ``parallel.SequenceGroup``, compat math only,
as in the JAX package; fixed math sets it to None) shards the frames over the
group's ranks: the input is a rank's own frames, every temporal attention
takes the sequence-parallel route first (K/V gathered, then the
cross-attention op), and every GroupNorm sums its statistics over the ranks.
It may be set after construction, as the trainer does.

The fused flags choose the route explicitly: with ``use_fused_attention``
every temporal attention and the bottleneck's spatial attention go through
``ops.temporal_attention``; with ``use_fused_spatial_attention`` every
spatial linear attention goes through ``ops.spatial_linear_attention``.
Otherwise the modules of ``models/attention.py`` run. In fixed math the
fused route normalizes in PyTorch, runs the op on the normalized input and
swaps the residual: ``x + (op(xn) - xn)``. ``LayerNorm`` returns float32
(its parameters' type), so under the bf16 policy the fused ops of fixed
math receive float32, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_diffusion_nnx_tpu_torch.models.attention import (
    MultiheadAttention,
    RelativePositionBias,
    SpatialLinearAttention,
)
from video_diffusion_nnx_tpu_torch.models.blocks import ResnetBlock
from video_diffusion_nnx_tpu_torch.models.layers import (
    GELU,
    Downsample,
    EinopsToAndFrom,
    GroupNorm,
    Identity,
    LayerNorm,
    Linear,
    PointwiseConv,
    PreNorm,
    PseudoConv3d,
    Residual,
    Sequential,
    SinusoidalPosEmb,
    Upsample,
)
from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as sla_ops
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta_ops
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup, sequence_parallel_temporal_attention
from video_diffusion_nnx_tpu_torch.utils.functional import default, is_odd, prob_mask_like

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class Unet3D(nn.Module):
    """3-D U-Net denoiser, unconditioned, in reference-compat or fixed math."""

    def __init__(
        self,
        dim: int,
        dim_mults=(1, 2, 4, 8),
        cond_dim: int | None = None,
        out_dim: int | None = None,
        channels: int = 3,
        attn_heads: int = 8,
        attn_dim_head: int = 32,
        use_bert_text_cond: bool = False,
        init_dim: int | None = None,
        init_kernel_size: int = 7,
        use_sparse_linear_attn: bool = True,
        block_type: str = "resnet",
        resnet_groups: int = 8,
        log_dims: bool = False,
        reference_compat: bool = True,
        compute_dtype=None,
        use_fused_attention: bool = False,
        use_fused_spatial_attention: bool = False,
        remat_blocks: bool = False,
        sequence_parallel_mesh=None,
        guidance_embed: bool = False,
    ):
        super().__init__()
        if cond_dim is not None or use_bert_text_cond:
            raise _not_ported("conditioning (cond_dim / use_bert_text_cond)", "A10")
        if guidance_embed:
            raise _not_ported("guidance_embed", "A13")
        if block_type != "resnet":
            raise ValueError(f"block_type must be 'resnet'; got {block_type!r}")
        if isinstance(compute_dtype, str) or compute_dtype is None:
            compute_dtype = _DTYPES[compute_dtype]
        self.channels = channels
        self.reference_compat = reference_compat
        self.compute_dtype = compute_dtype
        self.use_fused_attention = use_fused_attention
        self.use_fused_spatial_attention = use_fused_spatial_attention
        # Recompute each ResNet block's activations in the backward instead of keeping them; the
        # attention ops are not rematerialised, so their kernels launch once per step each way.
        self.remat_blocks = remat_blocks
        dt = compute_dtype

        def temporal_attn(d: int) -> EinopsToAndFrom:
            return EinopsToAndFrom(
                "b f h w c", "b (h w) f c",
                MultiheadAttention(d, attn_dim_head, attn_heads, reference_compat=reference_compat, dtype=dt),
            )

        def prenorm(d: int, fn: nn.Module) -> PreNorm:
            return PreNorm(d, fn, reference_compat=reference_compat)

        def spatial_attn(d: int) -> nn.Module:
            if not use_sparse_linear_attn:
                return Identity()
            return Residual(prenorm(d, SpatialLinearAttention(
                d, heads=attn_heads, D=32, dtype=dt, reference_compat=reference_compat)))

        self.time_rel_pos_bias = RelativePositionBias(heads=attn_heads, max_distance=32)
        init_dim = default(init_dim, dim)
        assert is_odd(init_kernel_size)
        self.init_conv = PseudoConv3d(channels, init_dim, init_kernel_size, dtype=dt)
        self.init_temporal_attn = Residual(prenorm(init_dim, temporal_attn(init_dim)))

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        self.time_mlp = Sequential(
            SinusoidalPosEmb(dim), Linear(dim, time_dim), GELU(), Linear(time_dim, time_dim)
        )

        def block(din: int, dout: int, time: bool = True) -> ResnetBlock:
            return ResnetBlock(
                din, dout, time_emb_dim=time_dim if time else None, groups=resnet_groups, dtype=dt
            )

        n_res = len(in_out)
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind >= n_res - 1
            self.downs.append(nn.ModuleList([
                block(dim_in, dim_out),
                block(dim_out, dim_out),
                spatial_attn(dim_out),
                Residual(prenorm(dim_out, temporal_attn(dim_out))),
                Downsample(dim_out, dtype=dt) if not last else Identity(),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = block(mid_dim, mid_dim)
        self.mid_spatial_attn = Residual(prenorm(mid_dim, EinopsToAndFrom(
            "b f h w c", "b f (h w) c",
            MultiheadAttention(mid_dim, attn_dim_head, attn_heads, reference_compat=reference_compat, dtype=dt),
        )))
        self.mid_temporal_attn = Residual(prenorm(mid_dim, temporal_attn(mid_dim)))
        self.mid_block2 = block(mid_dim, mid_dim)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            last = ind >= n_res - 1
            self.ups.append(nn.ModuleList([
                block(dim_out * 2, dim_in),
                block(dim_in, dim_in),
                spatial_attn(dim_in),
                Residual(prenorm(dim_in, temporal_attn(dim_in))),
                Upsample(dim_in, dtype=dt) if not last else Identity(),
            ]))

        self.final_conv = Sequential(
            block(dim * 2, dim, time=False),
            PointwiseConv(dim, default(out_dim, channels), dtype=dt),
        )
        self.sequence_parallel_mesh = sequence_parallel_mesh

    @property
    def sequence_parallel_mesh(self) -> SequenceGroup | None:
        """The sequence-parallel group, or None; setting it reaches every GroupNorm (JAX ``__init__`` :136)."""
        return self._sequence_group

    @sequence_parallel_mesh.setter
    def sequence_parallel_mesh(self, group: SequenceGroup | None) -> None:
        if group is not None and not isinstance(group, SequenceGroup):
            raise TypeError(f"sequence_parallel_mesh must be a parallel.SequenceGroup or None; got {type(group).__name__}")
        group = group if self.reference_compat else None
        self._sequence_group = group
        for module in self.modules():
            if isinstance(module, GroupNorm):
                module.sequence_group = group

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``: normal with variance 1/fan_in; biases 0, norms 1."""
        for module in self.modules():
            if isinstance(module, (Linear, PseudoConv3d, LayerNorm, GroupNorm)):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Embedding):
                with torch.no_grad():
                    w = module.weight
                    w.copy_(torch.randn(w.shape, generator=generator) / w.shape[1] ** 0.5)

    def forward_with_cond_scale(self, x, time, cond=None, cond_scale: float = 1.0):
        """The unconditioned branch of classifier-free guidance: one plain forward."""
        if cond is not None:
            raise _not_ported("conditioning", "A10")
        return self(x, time)

    def _resnet(self, block: ResnetBlock, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A ResNet block of the down, middle or up path (JAX ``_resnet``): checkpointed under ``remat_blocks``.

        Under ``no_grad`` (sampling) there is nothing to recompute and the block runs as it is.
        The blocks draw no random numbers, so no generator state is kept.
        """
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(block, x, t, use_reentrant=False, preserve_rng_state=False)
        return block(x, t)

    def _temporal(self, block: nn.Module, x: torch.Tensor, pos_bias: torch.Tensor,
                  focus_present_mask: torch.Tensor | None) -> torch.Tensor:
        """``x + MHA(x)`` over frames: the sequence-parallel route, the fused op, or the module chain (JAX
        ``_temporal``, :379-450).

        With a sequence group the sequence-parallel route comes first, before the fused flag (JAX :396-412).

        Compat math drops the bias and the mask (PreNorm), so the unbiased op is the whole block.
        Fixed math is ``x + MHA(LN(x), pos_bias, mask)``: the norm runs here, the bias rides the
        biased op, and the residual is swapped. A live focus mask needs nothing of the kernel: a
        masked sample's rows keep only their diagonal logit, the softmax becomes the identity and
        the block is ``x + v W_o + b_o``, two plain products selected per sample. ``None`` for the
        mask means that no sample can be masked, and skips the select.
        """
        if isinstance(block, Identity):
            return x
        group = self.sequence_parallel_mesh
        if group is not None:  # compat math only: the block is x + MHA(x)
            mha = block.fn.fn.fn
            b, f, h, w, c = x.shape
            x_r = x.reshape(b, f, h * w, c).transpose(1, 2).contiguous()  # (b, hw, f_l, c)
            wqkv, bqkv, wo, bo = ta_ops.pack_mha_weights(mha)
            y = sequence_parallel_temporal_attention(x_r, wqkv, bqkv, wo, bo, mha.heads, mha.dim, group)
            return y.transpose(1, 2).reshape(b, f, h, w, c)
        if not self.use_fused_attention:
            return block(x, pos_bias=pos_bias, focus_present_mask=focus_present_mask)
        mha = block.fn.fn.fn  # Residual -> PreNorm -> EinopsToAndFrom -> MHA
        b, f, h, w, c = x.shape
        x_r = x.reshape(b, f, h * w, c).transpose(1, 2).contiguous()  # (b, hw, f, c)
        wqkv, bqkv, wo, bo = ta_ops.pack_mha_weights(mha)
        if self.reference_compat:
            y = ta_ops.fused_temporal_attention_block(x_r, wqkv, bqkv, wo, bo, mha.heads, mha.dim)
        else:
            xn = block.fn.norm(x_r)
            z = ta_ops.fused_temporal_attention_block_biased(xn, wqkv, bqkv, wo, bo, pos_bias, mha.heads, mha.dim)
            y = x_r + (z - xn)  # the op folds in xn's residual; swap in x's
            if focus_present_mask is not None:
                hd = mha.heads * mha.dim
                v = xn @ wqkv[:, 2 * hd:] + bqkv[2 * hd:]
                y_self = x_r + v @ wo + bo
                y = torch.where(focus_present_mask.reshape(b, 1, 1, 1), y_self, y)
        return y.transpose(1, 2).reshape(b, f, h, w, c)

    def _mid_spatial(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Bottleneck full spatial attention: the temporal op with h*w as the attended axis; no bias, no mask."""
        if not self.use_fused_attention:
            return block(x)
        mha = block.fn.fn.fn
        b, f, h, w, c = x.shape
        x_r = x.reshape(b, f, h * w, c).contiguous()
        weights = ta_ops.pack_mha_weights(mha)
        if self.reference_compat:
            y = ta_ops.fused_temporal_attention_block(x_r, *weights, mha.heads, mha.dim)
        else:
            xn = block.fn.norm(x_r)
            y = x_r + (ta_ops.fused_temporal_attention_block(xn, *weights, mha.heads, mha.dim) - xn)
        return y.reshape(b, f, h, w, c)

    def _spatial(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``x + SLA(x)`` (compat: the q scale dropped) or ``x + SLA(LN(x))`` (fixed): the fused op, or the modules."""
        if not self.use_fused_spatial_attention or isinstance(block, Identity):
            return block(x)
        sla = block.fn.fn  # Residual -> PreNorm -> SpatialLinearAttention
        wqkv, wo = sla_ops.pack_sla_weights(sla)
        dim = wo.shape[0] // sla.heads
        if self.reference_compat:
            return sla_ops.fused_spatial_linear_attention_block(x.contiguous(), wqkv, wo, sla.heads, dim, 1.0)
        xn = block.fn.norm(x.contiguous())
        return x + (sla_ops.fused_spatial_linear_attention_block(xn, wqkv, wo, sla.heads, dim, sla.scale) - xn)

    def forward(self, x: torch.Tensor, time: torch.Tensor, focus_present_mask: torch.Tensor | None = None,
                prob_focus_present: float = 0.0, generator: torch.Generator | None = None) -> torch.Tensor:
        """Denoise ``x`` of shape ``(b, c, f, h, w)``; returns ``(b, f, h, w, c)`` float32.

        ``focus_present_mask`` (b,) bool makes a sample's temporal attentions attend only to their
        own frame; without it each sample is masked with probability ``prob_focus_present``, drawn
        from ``generator``. Compat math ignores both, as the reference does. The first temporal
        attention never sees the mask (JAX ``__call__``, :543-552).
        """
        if self.reference_compat:
            focus_present_mask = None  # every PreNorm would drop it; nothing is drawn
        elif focus_present_mask is None and prob_focus_present != 0.0:
            focus_present_mask = prob_mask_like((x.shape[0],), prob_focus_present, generator, x.device)
        pos_bias = self.time_rel_pos_bias(x.shape[2])

        x = x.permute(0, 2, 3, 4, 1)  # b c f h w -> b f h w c
        x = self.init_conv(x)
        x = self._temporal(self.init_temporal_attn, x, pos_bias, None)
        r = x
        t = self.time_mlp(time)

        hs = []
        for block1, block2, spatial_attn, temporal_attn, downsample in self.downs:
            x = self._resnet(block1, x, t)
            x = self._resnet(block2, x, t)
            x = self._spatial(spatial_attn, x)
            x = self._temporal(temporal_attn, x, pos_bias, focus_present_mask)
            hs.append(x)
            x = downsample(x)

        x = self._resnet(self.mid_block1, x, t)
        x = self._mid_spatial(self.mid_spatial_attn, x)
        x = self._temporal(self.mid_temporal_attn, x, pos_bias, focus_present_mask)
        x = self._resnet(self.mid_block2, x, t)

        for block1, block2, spatial_attn, temporal_attn, upsample in self.ups:
            x = torch.cat((x, hs.pop()), dim=-1)
            x = self._resnet(block1, x, t)
            x = self._resnet(block2, x, t)
            x = self._spatial(spatial_attn, x)
            x = self._temporal(temporal_attn, x, pos_bias, focus_present_mask)
            x = upsample(x)

        x = torch.cat((x, r), dim=-1)
        return self.final_conv(x).float()
