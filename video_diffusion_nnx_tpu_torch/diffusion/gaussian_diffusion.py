"""DDPM Gaussian diffusion: training loss and reverse sampling (counterpart of the JAX package's diffusion/gaussian_diffusion.py).

The schedule buffers carry the JAX package's names, so a converted
checkpoint loads them directly, and equal its values bit for bit
(``utils/schedule.py``). The JAX package runs the reverse process as one
``lax.scan`` program; here it is a Python loop over the steps whose denoiser
forward, on CUDA under ``no_grad``, replays a CUDA graph (``graphs.py``; each
sampler's ``graph=False`` runs it eagerly). Noise comes from an explicit
``torch.Generator``; the samplers also take injected noise, and ``forward``
(the training loss) takes injected t and noise, so that a test can feed both
packages the same numbers (the draws of the JAX key chain).

Text conditioning: every sampler and the loss take ``cond``, either a
``(b, cond_dim)`` array of condition vectors or a list of captions, which
are embedded on the host (``models/text.py``; the first token's vector under
``text_use_bert_cls``). A sampler then takes its batch size from the
condition. The samplers also take ``cond_scale``, the classifier-free
guidance scale (``Unet3D.forward_with_cond_scale``: one denoiser forward of
2b rows when it is not 1); the loss takes ``null_cond_prob``, the
condition's dropout rate. ``interpolate`` has no condition, as in JAX.

Over a group of ranks each rank holds a part of the batch: its rows, when
``data_group`` (set by the trainer) has more than one rank, and its frames,
under a sequence-parallel group (the denoiser's ``sequence_parallel_mesh``).
``forward`` draws t, the noise and the denoiser's focus and dropout masks
for the whole batch and clip, exactly as one rank would, and keeps this
rank's rows and frames of each; ``p_losses`` then returns this rank's share
of the loss, the mean over its elements divided by the number of parts.
The shares sum to the mean over the whole batch, and their gradients to its
gradient. The samplers ``sample``, ``ddim_sample``, ``dpm_solver_sample`` and
``sample_conditional_frames`` split a batch's rows over the data ranks as the JAX package's
``_sampler_batch_spec`` does (:87-101: the whole batch on every rank, with a
warning, when it does not divide) and the frames over the sequence ranks;
x_T and each step's noise (and the pinned frames' forward noise) are drawn
for the whole batch, and each rank keeps its part, so the parts are what one
rank would compute. Each rank returns
its part; :meth:`GaussianDiffusion.gather_batch` joins them. A sampler under
a sequence group runs its denoiser eagerly: a CUDA graph cannot capture a
collective that gloo stages through the host.
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.diffusion.graphs import GraphCache
from video_diffusion_nnx_tpu_torch.models.text import embed_captions
from video_diffusion_nnx_tpu_torch.utils.functional import is_list_str
from video_diffusion_nnx_tpu_torch.utils.image import normalize_img, unnormalize_img
from video_diffusion_nnx_tpu_torch.utils.schedule import ScheduleBuffers, extract

logger = logging.getLogger(__name__)

BUFFER_NAMES = (
    "alphas_cumprod",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
)


def sampling_times(num_timesteps: int, num_steps: int, grid: str = "linspace") -> torch.Tensor:
    """Ascending timestep subsequence for the strided samplers (int64, on the CPU)."""
    if grid == "linspace":
        return torch.linspace(0, num_timesteps - 1, num_steps, dtype=torch.float32).round().long()
    if grid == "stride":
        return (torch.arange(1, num_steps + 1) * num_timesteps) // num_steps - 1
    raise ValueError(f"grid must be 'linspace' or 'stride'; got {grid!r}")


def _normal(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _half_log_snr(a: torch.Tensor) -> torch.Tensor:
    """lambda = log(alpha / sigma) of ``alphas_cumprod`` ``a`` (JAX ``lam``, :584-586), on ``a`` clipped to
    [1e-12, 1 - 1e-12]; in float32 the upper bound rounds to 1, where lambda is inf."""
    a = torch.clamp(a, 1e-12, 1.0 - 1e-12)
    return 0.5 * (torch.log(a) - torch.log1p(-a))


class GaussianDiffusion(nn.Module):
    """DDPM wrapper around a denoiser with the Unet3D calling convention."""

    def __init__(
        self,
        denoise_fn: nn.Module,
        *,
        image_size: int,
        num_frames: int,
        text_use_bert_cls: bool = False,
        channels: int = 3,
        timesteps: int = 1000,
        loss_type: str = "l1",
        use_dynamic_thres: bool = False,
        dynamic_thres_percentile: float = 0.9,
        prediction_type: str = "noise",
        min_snr_gamma: float | None = None,
    ):
        super().__init__()
        if prediction_type not in ("noise", "v", "x0"):
            raise ValueError(
                f"prediction_type must be 'noise', 'v', or 'x0'; got {prediction_type!r}"
            )
        self.denoise_fn = denoise_fn
        self.image_size = image_size
        self.num_frames = num_frames
        self.channels = channels
        self.text_use_bert_cls = text_use_bert_cls
        self.loss_type = loss_type
        self.prediction_type = prediction_type
        self.min_snr_gamma = min_snr_gamma
        self.use_dynamic_thres = use_dynamic_thres
        self.dynamic_thres_percentile = dynamic_thres_percentile
        self.num_timesteps = int(timesteps)
        buf = ScheduleBuffers.create(self.num_timesteps)
        for name in BUFFER_NAMES:
            self.register_buffer(name, getattr(buf, name))
        # The captured denoiser forwards; dropped when weights are loaded or the module moves.
        self.graphs = GraphCache()
        self.data_group = None  # the ranks the batch's rows split over (a parallel.SequenceGroup), or None
        self.register_load_state_dict_post_hook(lambda module, _keys: module.graphs.clear())

    def _apply(self, fn, recurse: bool = True):
        self.graphs.clear()
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device

    @property
    def sequence_group(self):
        """The denoiser's sequence-parallel group, or None."""
        return getattr(self.denoise_fn, "sequence_parallel_mesh", None)

    def _split_rows(self, batch_size: int, warn: bool = False) -> slice | None:
        """This rank's rows of a batch of ``batch_size`` under a data group of more than one rank, else None (every
        row); a batch that does not divide runs whole on every rank, with a warning when ``warn``."""
        data = self.data_group
        if data is None or data.world_size == 1:
            return None
        if batch_size % data.world_size == 0:
            return data.rows(batch_size)
        if warn:
            logger.warning("sampling batch %d does not divide across %d data shards; running replicated (no data "
                           "parallelism). Pad the batch to a multiple of %d to engage all ranks.",
                           batch_size, data.world_size, data.world_size)
        return None

    def _mine(self, x: torch.Tensor | None, rows: slice | None, frames: bool = True) -> torch.Tensor | None:
        """This rank's part of ``x``, a whole batch's tensor: its ``rows``, and its frames (dim 2) when ``frames``
        under a sequence group."""
        if x is None:
            return None
        if rows is not None:
            x = x[rows]
        seq = self.sequence_group
        if frames and seq is not None:
            x = x[:, :, seq.frames(self.num_frames)]
        return x

    def gather_batch(self, x: torch.Tensor, batch_size: int) -> torch.Tensor:
        """Every rank's part of a sampler's output joined into the whole batch (a collective: every rank calls it)."""
        if self.sequence_group is not None:
            x = self.sequence_group.all_gather(x, 2)
        if self._split_rows(batch_size) is not None:
            x = self.data_group.all_gather(x, 0)
        return x

    def _graphable(self, graph: bool) -> bool:
        if graph and self.sequence_group is not None:
            logger.info("the sampler runs its denoiser eagerly: a CUDA graph cannot capture the sequence group's "
                        "collectives")
            return False
        return graph

    def _x(self, a: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return extract(a, t, x.shape)

    # Forward (q) process.

    def q_sample(self, x_start, t, noise):
        return self._x(self.sqrt_alphas_cumprod, t, x_start) * x_start + \
            self._x(self.sqrt_one_minus_alphas_cumprod, t, x_start) * noise

    def predict_start_from_noise(self, x_t, t, noise):
        return self._x(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t - \
            self._x(self.sqrt_recipm1_alphas_cumprod, t, x_t) * noise

    def predict_v(self, x_start, t, noise):
        return self._x(self.sqrt_alphas_cumprod, t, x_start) * noise - \
            self._x(self.sqrt_one_minus_alphas_cumprod, t, x_start) * x_start

    def predict_start_from_v(self, x_t, t, v):
        return self._x(self.sqrt_alphas_cumprod, t, x_t) * x_t - \
            self._x(self.sqrt_one_minus_alphas_cumprod, t, x_t) * v

    def _model_out_to_x0_eps(self, x_t, t, model_out):
        """``(x0, eps)`` from the denoiser's output under ``prediction_type``."""
        if self.prediction_type == "noise":
            return self.predict_start_from_noise(x_t, t, model_out), model_out
        if self.prediction_type == "v":
            x0 = self.predict_start_from_v(x_t, t, model_out)
            eps = self._x(self.sqrt_alphas_cumprod, t, x_t) * model_out + \
                self._x(self.sqrt_one_minus_alphas_cumprod, t, x_t) * x_t
            return x0, eps
        sigma = self._x(self.sqrt_one_minus_alphas_cumprod, t, x_t)
        alpha = self._x(self.sqrt_alphas_cumprod, t, x_t)
        return model_out, (x_t - alpha * model_out) / sigma

    def q_posterior(self, x_start, x_t, t):
        mean = self._x(self.posterior_mean_coef1, t, x_t) * x_start + \
            self._x(self.posterior_mean_coef2, t, x_t) * x_t
        return (
            mean,
            self._x(self.posterior_variance, t, x_t),
            self._x(self.posterior_log_variance_clipped, t, x_t),
        )

    def embed_cond(self, cond) -> torch.Tensor | None:
        """A condition as a float32 tensor on this model's device: captions (a list of str) embedded on the host
        (JAX ``is_list_str`` -> ``bert_embed(tokenize(...))``), an array or tensor as it is; None stays None."""
        if cond is None:
            return None
        if is_list_str(cond):
            cond = embed_captions(cond, return_cls_repr=self.text_use_bert_cls)
        return torch.as_tensor(cond, dtype=torch.float32).to(self.device)

    # Reverse (p) process.

    def _denoise(self, x: torch.Tensor, t: torch.Tensor, graph: bool = False, cond: torch.Tensor | None = None,
                 cond_scale: float = 1.0) -> torch.Tensor:
        """The denoiser's (guided) output as (b, c, f, h, w). With ``graph``, for a CUDA ``x`` under ``no_grad``, a
        replay of the cached graph of x's shape, condition and scale: a view of its static output, valid until
        the next replay. The scale reaches the denoiser wherever it is an input: with a condition, or for a
        ``guidance_embed`` denoiser, which folds it into its one forward even without one (JAX :322-324)."""
        if graph and x.is_cuda and not torch.is_grad_enabled():
            out = self.graphs.get(self.denoise_fn, x, cond, cond_scale)(x, t, cond)
        elif cond is None and not getattr(self.denoise_fn, "has_guidance_embed", False):
            out = self.denoise_fn.forward_with_cond_scale(x, t)  # (b, f, h, w, c)
        else:
            out = self.denoise_fn.forward_with_cond_scale(x, t, cond=cond, cond_scale=cond_scale)
        return out.permute(0, 4, 1, 2, 3)  # -> (b, c, f, h, w)

    def p_mean_variance(self, x, t, clip_denoised: bool = True, graph: bool = False, cond=None,
                        cond_scale: float = 1.0):
        x_recon, _ = self._model_out_to_x0_eps(x, t, self._denoise(x, t, graph, cond, cond_scale))
        if clip_denoised:
            s = 1.0
            if self.use_dynamic_thres:  # a quantile over each whole sample: its frames gathered first
                whole = x_recon if self.sequence_group is None else self.sequence_group.all_gather(x_recon, 2)
                flat = whole.reshape(whole.shape[0], -1).abs()
                s = torch.quantile(flat, self.dynamic_thres_percentile, dim=-1)
                s = torch.clamp(s, min=1.0).reshape(-1, 1, 1, 1, 1)
                x_recon = torch.maximum(torch.minimum(x_recon, s), -s) / s
            else:
                x_recon = torch.clamp(x_recon, -s, s) / s
        return self.q_posterior(x_start=x_recon, x_t=x, t=t)

    @torch.no_grad()
    def p_sample(self, x, t, noise=None, generator=None, clip_denoised: bool = True, graph: bool = False,
                 cond=None, cond_scale: float = 1.0):
        """One reverse step x_t -> x_{t-1}; ``noise`` is drawn from ``generator`` when not given."""
        mean, _, log_var = self.p_mean_variance(x, t, clip_denoised, graph, cond, cond_scale)
        if noise is None:
            noise = _normal(x.shape, generator, x.device)
        nonzero = (1.0 - (t == 0).float()).reshape(-1, 1, 1, 1, 1)
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _batch(self, batch_size: int, cond) -> tuple[int, torch.Tensor | None]:
        """The batch size and the embedded condition: a condition sets the batch size (JAX ``ddim_sample``)."""
        cond = self.embed_cond(cond)
        return (batch_size if cond is None else cond.shape[0]), cond

    def _shape(self, batch_size: int) -> tuple[int, ...]:
        return (batch_size, self.channels, self.num_frames, self.image_size, self.image_size)

    def _t(self, value: int, batch_size: int) -> torch.Tensor:
        return torch.full((batch_size,), value, dtype=torch.long, device=self.device)

    def _init(self, shape, generator, init_noise) -> torch.Tensor:
        """x_T: ``init_noise`` (checked against ``shape``), else the generator's first draw."""
        if init_noise is None:
            return _normal(shape, generator, self.device)
        if tuple(init_noise.shape) != tuple(shape):
            raise ValueError(f"init_noise must have shape {tuple(shape)}, got {tuple(init_noise.shape)}")
        return init_noise

    def _draw(self, injected: Sequence[torch.Tensor] | None, step: int, shape, generator) -> torch.Tensor:
        return injected[step] if injected is not None else _normal(shape, generator, self.device)

    def _ddim_step(self, img, x0, t: int, t_prev: int, eta: float = 0.0):
        """The DDIM update from step t to t_prev (-1: clean) given the clipped x0, eps re-derived from it
        (standard DDIM practice); returns x_{t_prev} without its noise, and the noise's scale sigma."""
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else torch.ones((), device=self.device)
        eps_hat = (img - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        sigma = eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t)) * torch.sqrt(1.0 - a_t / a_prev)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps_hat
        return torch.sqrt(a_prev) * x0 + dir_xt, sigma

    @torch.no_grad()
    def p_sample_loop(self, shape, generator=None, init_noise=None, graph: bool = True, cond=None,
                      cond_scale: float = 1.0, step_noise: Sequence[torch.Tensor] | None = None):
        """The full DDPM reverse chain, T steps; returns images in [0, 1] (this rank's part under a group).
        ``init_noise`` and ``step_noise`` (each step's noise, in the chain's order; whole-batch tensors) are drawn
        from ``generator`` where not given."""
        rows = self._split_rows(shape[0], warn=True)
        cond = self._mine(self.embed_cond(cond), rows, frames=False)
        graph = self._graphable(graph)
        img = self._mine(self._init(shape, generator, init_noise), rows)
        for step, i in enumerate(reversed(range(self.num_timesteps))):
            noise = step_noise[step] if step_noise is not None else _normal(shape, generator, self.device)
            img = self.p_sample(img, self._t(i, img.shape[0]), noise=self._mine(noise, rows), graph=graph, cond=cond,
                                cond_scale=cond_scale)
        return unnormalize_img(img)

    @torch.no_grad()
    def sample(self, batch_size: int = 16, generator=None, graph: bool = True, cond=None, cond_scale: float = 1.0,
               init_noise: torch.Tensor | None = None, step_noise: Sequence[torch.Tensor] | None = None):
        """DDPM samples of ``(batch_size, c, f, h, w)``, or of one per row of ``cond``."""
        batch_size, cond = self._batch(batch_size, cond)
        return self.p_sample_loop(self._shape(batch_size), generator=generator, init_noise=init_noise, graph=graph,
                                  cond=cond, cond_scale=cond_scale, step_noise=step_noise)

    @torch.no_grad()
    def ddim_sample(
        self,
        batch_size: int = 16,
        num_steps: int = 50,
        eta: float = 0.0,
        grid: str = "linspace",
        generator: torch.Generator | None = None,
        init_noise: torch.Tensor | None = None,
        step_noise: Sequence[torch.Tensor] | None = None,
        graph: bool = True,
        cond=None,
        cond_scale: float = 1.0,
    ) -> torch.Tensor:
        """DDIM sampling (Song et al. 2021) over a strided timestep grid; images in [0, 1].

        ``init_noise`` supplies x_T; ``step_noise`` supplies each step's noise
        (read only when ``eta > 0``). Otherwise both come from ``generator``.
        At ``eta = 0`` each output row is a function of its own x_T (and its
        own condition) alone.
        """
        batch_size, cond = self._batch(batch_size, cond)
        shape = self._shape(batch_size)
        rows = self._split_rows(batch_size, warn=True)
        cond = self._mine(cond, rows, frames=False)
        graph = self._graphable(graph)
        times = sampling_times(self.num_timesteps, num_steps, grid).flip(0).tolist()
        times_prev = times[1:] + [-1]
        img = self._mine(self._init(shape, generator, init_noise), rows)
        for step, (t, t_prev) in enumerate(zip(times, times_prev)):
            t_arr = self._t(t, img.shape[0])
            x0, _ = self._model_out_to_x0_eps(img, t_arr, self._denoise(img, t_arr, graph, cond, cond_scale))
            img, sigma = self._ddim_step(img, torch.clamp(x0, -1.0, 1.0), t, t_prev, eta)
            if eta > 0:
                img = img + sigma * self._mine(self._draw(step_noise, step, shape, generator), rows)
        return unnormalize_img(img)

    @torch.no_grad()
    def dpm_solver_sample(
        self,
        batch_size: int = 16,
        num_steps: int = 20,
        generator: torch.Generator | None = None,
        init_noise: torch.Tensor | None = None,
        graph: bool = True,
        cond=None,
        cond_scale: float = 1.0,
    ) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022; JAX ``dpm_solver_sample``, :521-650); images in [0, 1].

        A deterministic second-order multistep solver of the same ODE as DDIM at
        eta 0, from the same x_T (``init_noise``, else the generator's first
        draw), so each output row is a function of its own x_T alone. Each step
        evaluates the denoiser once and combines the current and previous
        clipped x0 with log-SNR spacing weights. The first step and the last
        (to sigma = 0, where lambda is infinite in float32, so h is inf, r is 0
        and the second-order term is NaN) take the first-order update; the step
        index is known on the host, so the second-order term is never formed there.
        """
        batch_size, cond = self._batch(batch_size, cond)
        shape = self._shape(batch_size)
        rows = self._split_rows(batch_size, warn=True)
        cond = self._mine(cond, rows, frames=False)
        graph = self._graphable(graph)
        times = sampling_times(self.num_timesteps, num_steps).flip(0).tolist()
        times_prev = times[1:] + [-1]
        acp = self.alphas_cumprod
        one = torch.ones((), device=self.device)
        img = self._mine(self._init(shape, generator, init_noise), rows)
        x0_prev, h_prev = None, one
        for step, (t, t_prev) in enumerate(zip(times, times_prev)):
            t_arr = self._t(t, img.shape[0])
            x0, _ = self._model_out_to_x0_eps(img, t_arr, self._denoise(img, t_arr, graph, cond, cond_scale))
            x0 = torch.clamp(x0, -1.0, 1.0)
            a_cur = acp[t]
            a_next = acp[t_prev] if t_prev >= 0 else one
            alpha_c, sigma_c = torch.sqrt(a_cur), torch.sqrt(1.0 - a_cur)
            alpha_n, sigma_n = torch.sqrt(a_next), torch.sqrt(torch.clamp(1.0 - a_next, min=0.0))
            exp_neg_h = (alpha_c * sigma_n) / (sigma_c * alpha_n)  # 0 at the last step
            h = _half_log_snr(a_next) - _half_log_snr(a_cur)
            if step == 0 or t_prev < 0:
                d = x0
            else:
                r = h_prev / h
                d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
            img = (sigma_n / sigma_c) * img + alpha_n * (1.0 - exp_neg_h) * d
            x0_prev, h_prev = x0, h
        return unnormalize_img(img)

    def _guided_x0(self, z, t, x0_known, mask, scale, cond=None, cond_scale: float = 1.0) -> torch.Tensor:
        """Reconstruction guidance (Ho et al. 2022; JAX :811-827): ``x0(z) - scale * grad_z 0.5 ||mask (x0(z) -
        known)||^2`` on the unknown frames. One backward through the denoiser, eager, with the weights held out
        of autograd: only the gradient with respect to z is formed."""
        params = [p for p in self.denoise_fn.parameters() if p.requires_grad]
        for p in params:
            p.requires_grad_(False)
        try:
            with torch.enable_grad():
                z = z.detach().requires_grad_(True)
                x0, _ = self._model_out_to_x0_eps(z, t, self._denoise(z, t, cond=cond, cond_scale=cond_scale))
                err = torch.where(mask, x0 - x0_known, 0.0)
                (g,) = torch.autograd.grad(0.5 * torch.sum(err**2), z)
        finally:
            for p in params:
                p.requires_grad_(True)
        return x0.detach() - scale * torch.where(mask, 0.0, g)

    @torch.no_grad()
    def sample_conditional_frames(
        self,
        known: torch.Tensor,
        frame_mask,
        num_steps: int | None = None,
        grid: str = "linspace",
        recon_guidance_weight: float = 0.0,
        generator: torch.Generator | None = None,
        init_noise: torch.Tensor | None = None,
        step_noise: Sequence[torch.Tensor] | None = None,
        mix_noise: Sequence[torch.Tensor] | None = None,
        graph: bool = True,
        cond=None,
        cond_scale: float = 1.0,
    ) -> torch.Tensor:
        """A clip whose frames at ``frame_mask`` are pinned to ``known`` (JAX ``sample_conditional_frames``,
        :681-861): video extension, temporal infill or frame prediction by replacement conditioning.

        After every reverse step the pinned frames are swapped for ``known``
        forward-noised to the new level (clean at the end), so the output carries
        them as given. ``known`` is (b, c, f, h, w) in [0, 1] (unpinned frames are
        ignored), ``frame_mask`` (f,) bool. ``num_steps`` None runs the T-step DDPM
        chain; an int a deterministic DDIM chain over that many ``grid`` steps,
        where ``recon_guidance_weight`` w_r > 0 adds reconstruction guidance
        (eager: a backward through the denoiser each step). Draws come from
        ``generator`` unless injected: ``init_noise``, then per step ``step_noise``
        (DDPM) and ``mix_noise`` (the pinned frames' forward noise; the last step
        reads none). ``cond`` (one row per clip) and ``cond_scale`` reach every
        denoiser forward, the guided ones too. Returns images in [0, 1] (this
        rank's rows under a data group, each row's guidance gradient its own).
        """
        cond = self.embed_cond(cond)
        shape = tuple(known.shape)
        if len(shape) != 5 or shape[1:] != self._shape(1)[1:]:
            raise ValueError(f"known must be (b, {', '.join(map(str, self._shape(1)[1:]))}); got {shape}")
        wr = float(recon_guidance_weight)
        if wr > 0.0 and num_steps is None:
            raise ValueError("recon_guidance_weight needs the DDIM path (num_steps)")
        if num_steps is not None and not 1 <= int(num_steps) <= self.num_timesteps:
            raise ValueError(f"num_steps must be in [1, {self.num_timesteps}]; got {num_steps}")
        rows = self._split_rows(shape[0], warn=True)
        cond = self._mine(cond, rows, frames=False)
        graph = self._graphable(graph)
        mask = self._mine(torch.as_tensor(frame_mask, dtype=torch.bool, device=self.device).reshape(1, 1, -1, 1, 1),
                          None)
        x0_known = self._mine(normalize_img(known), rows)
        img = self._mine(self._init(shape, generator, init_noise), rows)
        batch_size = img.shape[0]

        def replace_known(img, t_to: int, step: int):
            """Swap the pinned frames for their forward-noised values at level ``t_to`` (clean when < 0)."""
            known_t = x0_known
            if t_to >= 0:
                known_t = self.q_sample(x0_known, self._t(t_to, batch_size),
                                        self._mine(self._draw(mix_noise, step, shape, generator), rows))
            return torch.where(mask, known_t, img)

        if num_steps is None:
            for step, i in enumerate(reversed(range(self.num_timesteps))):
                noise = self._mine(self._draw(step_noise, step, shape, generator), rows)
                img = self.p_sample(img, self._t(i, batch_size), noise=noise, graph=graph, cond=cond,
                                    cond_scale=cond_scale)
                img = replace_known(img, i - 1, step)
            return unnormalize_img(img)

        times = sampling_times(self.num_timesteps, int(num_steps), grid).flip(0).tolist()
        times_prev = times[1:] + [-1]
        for step, (t, t_prev) in enumerate(zip(times, times_prev)):
            t_arr = self._t(t, batch_size)
            if wr > 0.0:
                x0 = self._guided_x0(img, t_arr, x0_known, mask, wr * torch.sqrt(self.alphas_cumprod[t]), cond,
                                     cond_scale)
            else:
                x0, _ = self._model_out_to_x0_eps(img, t_arr, self._denoise(img, t_arr, graph, cond, cond_scale))
            img, _ = self._ddim_step(img, torch.clamp(x0, -1.0, 1.0), t, t_prev)
            img = replace_known(img, t_prev, step)
        return unnormalize_img(img)

    @torch.no_grad()
    def interpolate(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        t: int | None = None,
        lam: float = 0.5,
        generator: torch.Generator | None = None,
        q_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
        step_noise: Sequence[torch.Tensor] | None = None,
        graph: bool = True,
    ) -> torch.Tensor:
        """Diffuse both clips to step ``t`` (default T - 1), blend, and denoise back (JAX ``interpolate``,
        :863-917), quirks kept: ``x1`` and ``x2`` are taken as they are (no ``normalize_img``), the chain runs
        from t - 1 down to 0, and the raw image comes back (no ``unnormalize_img``). ``q_noise`` is the pair of
        forward-noising draws, ``step_noise`` each step's; otherwise both come from ``generator``."""
        if x1.shape != x2.shape:
            raise ValueError("inputs must have the same shape")
        lam = float(lam)
        if not 0.0 <= lam <= 1.0:
            raise ValueError("lambda must be in [0, 1]")
        t = int(t) if t is not None else self.num_timesteps - 1
        if not 0 <= t < self.num_timesteps:
            raise ValueError(f"t must be in [0, {self.num_timesteps - 1}]; got {t}")
        batch_size = x1.shape[0]
        if q_noise is None:
            q_noise = (_normal(x1.shape, generator, self.device), _normal(x2.shape, generator, self.device))
        t_b = self._t(t, batch_size)
        img = (1 - lam) * self.q_sample(x1, t_b, q_noise[0]) + lam * self.q_sample(x2, t_b, q_noise[1])
        for step, i in enumerate(range(t - 1, -1, -1)):
            noise = None if step_noise is None else step_noise[step]
            img = self.p_sample(img, self._t(i, batch_size), noise=noise, generator=generator, graph=graph)
        return img

    # Training.

    def p_losses(self, x_start, t, noise=None, generator=None, focus_present_mask=None,
                 prob_focus_present: float = 0.0, cond=None, null_cond_prob: float = 0.0,
                 null_cond_mask=None) -> torch.Tensor:
        """Denoising loss at timesteps ``t`` (JAX ``p_losses``, :923-996); noise from ``generator`` when not given.

        ``focus_present_mask`` and ``prob_focus_present`` go to the denoiser, and so do ``cond``
        (captions are embedded here) and ``null_cond_prob``, its dropout rate; the denoiser draws
        its masks from ``generator`` after the noise, the focus mask first, unless ``null_cond_mask``
        gives the condition's. Over a group ``x_start`` and ``noise`` are this rank's rows and frames and
        the result is this rank's share of the loss.
        """
        if noise is None:
            noise = _normal(x_start.shape, generator, x_start.device)
        x_noisy = self.q_sample(x_start, t, noise)
        cond_kw = {}
        if cond is not None:
            cond_kw = {"cond": self.embed_cond(cond), "null_cond_prob": null_cond_prob}
            if null_cond_mask is not None:
                cond_kw["null_cond_mask"] = null_cond_mask
        model_out = self.denoise_fn(x_noisy, t, focus_present_mask=focus_present_mask,
                                    prob_focus_present=prob_focus_present, generator=generator, **cond_kw)
        model_out = model_out.permute(0, 4, 1, 2, 3)  # -> (b, c, f, h, w)
        if self.prediction_type == "noise":
            target = noise
        elif self.prediction_type == "v":
            target = self.predict_v(x_start, t, noise).detach()  # supervision, not a path to the buffers
        else:
            target = x_start
        if self.loss_type == "l1":
            err = (model_out - target).abs()
        elif self.loss_type == "l2":
            err = (model_out - target) ** 2
        else:
            raise ValueError(f"Unsupported loss type: {self.loss_type}")
        share = 1
        for group in (self.sequence_group, self.data_group):
            share *= 1 if group is None else group.world_size
        if self.min_snr_gamma is None:
            return err.mean() / share
        # Min-SNR-gamma weights in each parameterization's own loss space;
        # sqrt of them for l1, whose error is linear in the residual.
        acp_t = extract(self.alphas_cumprod, t, x_start.shape)
        snr = acp_t / (1.0 - acp_t)
        clamped = torch.clamp(snr, max=self.min_snr_gamma)
        if self.prediction_type == "noise":
            w = clamped / snr
        elif self.prediction_type == "v":
            w = clamped / (snr + 1.0)
        else:
            w = clamped
        if self.loss_type == "l1":
            w = torch.sqrt(w)
        return (w * err).mean() / share

    def forward(self, x, generator=None, t=None, noise=None, focus_present_mask=None,
                prob_focus_present: float = 0.0, cond=None, null_cond_prob: float = 0.0) -> torch.Tensor:
        """Training entry (JAX ``__call__``, :998-1016): draw t, normalize ``x`` from [0, 1], return the loss.

        Draws from ``generator`` in this order: t, the noise, then the denoiser's focus and
        condition-dropout masks (each only where its probability lies strictly between 0 and 1).

        ``x`` is the whole clip on every rank of a sequence group, and under a data group of D ranks
        this rank's rows of a batch of D times as many (``cond`` too); an injected ``t``, ``noise`` or
        ``focus_present_mask`` is the whole batch's. The loss is this rank's share, over its rows and frames.
        """
        want = (x.shape[0], self.channels, self.num_frames, self.image_size, self.image_size)
        if tuple(x.shape) != want:
            raise ValueError(f"x must have shape (b, c, f, h, w) = {want}; got {tuple(x.shape)}")
        data = self.data_group
        ranks = 1 if data is None else data.world_size
        b = x.shape[0] * ranks
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator, device=x.device)
        null_cond_mask = None
        if ranks > 1:  # every draw for the whole batch, as one rank would make it; this rank keeps its rows
            if noise is None:
                noise = _normal((b, *x.shape[1:]), generator, x.device)
            focus_present_mask, null_cond_mask = self.denoise_fn.draw_masks(
                b, prob_focus_present, null_cond_prob, generator, x.device, focus_present_mask)
            t, noise, focus_present_mask, null_cond_mask = (
                self._mine(v, data.rows(b), frames=False) for v in (t, noise, focus_present_mask, null_cond_mask))
        if self.sequence_group is not None:
            if noise is None:
                noise = _normal(x.shape, generator, x.device)
            frames = self.sequence_group.frames(self.num_frames)
            x, noise = x[:, :, frames], noise[:, :, frames]
        return self.p_losses(normalize_img(x), t, noise=noise, generator=generator,
                             focus_present_mask=focus_present_mask, prob_focus_present=prob_focus_present,
                             cond=cond, null_cond_prob=null_cond_prob, null_cond_mask=null_cond_mask)
