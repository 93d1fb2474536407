"""DDPM Gaussian diffusion: training loss and reverse sampling (counterpart of the JAX package's diffusion/gaussian_diffusion.py).

The schedule buffers carry the JAX package's names, so a converted
checkpoint loads them directly, and equal its values bit for bit
(``utils/schedule.py``). The JAX package runs the reverse process as one
``lax.scan`` program; here it is a Python loop over the steps. Noise comes
from an explicit ``torch.Generator``; ``p_sample`` and ``ddim_sample`` also
take injected noise, and ``forward`` (the training loss) takes injected t and
noise, so that a test can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.utils.image import normalize_img, unnormalize_img
from video_diffusion_nnx_tpu_torch.utils.schedule import ScheduleBuffers, extract

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
        self.loss_type = loss_type
        self.prediction_type = prediction_type
        self.min_snr_gamma = min_snr_gamma
        self.use_dynamic_thres = use_dynamic_thres
        self.dynamic_thres_percentile = dynamic_thres_percentile
        self.num_timesteps = int(timesteps)
        buf = ScheduleBuffers.create(self.num_timesteps)
        for name in BUFFER_NAMES:
            self.register_buffer(name, getattr(buf, name))

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device

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

    # Reverse (p) process.

    def _denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out = self.denoise_fn.forward_with_cond_scale(x, t)  # (b, f, h, w, c)
        return out.permute(0, 4, 1, 2, 3)  # -> (b, c, f, h, w)

    def p_mean_variance(self, x, t, clip_denoised: bool = True):
        x_recon, _ = self._model_out_to_x0_eps(x, t, self._denoise(x, t))
        if clip_denoised:
            s = 1.0
            if self.use_dynamic_thres:
                flat = x_recon.reshape(x_recon.shape[0], -1).abs()
                s = torch.quantile(flat, self.dynamic_thres_percentile, dim=-1)
                s = torch.clamp(s, min=1.0).reshape(-1, 1, 1, 1, 1)
                x_recon = torch.maximum(torch.minimum(x_recon, s), -s) / s
            else:
                x_recon = torch.clamp(x_recon, -s, s) / s
        return self.q_posterior(x_start=x_recon, x_t=x, t=t)

    @torch.no_grad()
    def p_sample(self, x, t, noise=None, generator=None, clip_denoised: bool = True):
        """One reverse step x_t -> x_{t-1}; ``noise`` is drawn from ``generator`` when not given."""
        mean, _, log_var = self.p_mean_variance(x, t, clip_denoised)
        if noise is None:
            noise = _normal(x.shape, generator, x.device)
        nonzero = (1.0 - (t == 0).float()).reshape(-1, 1, 1, 1, 1)
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _shape(self, batch_size: int) -> tuple[int, ...]:
        return (batch_size, self.channels, self.num_frames, self.image_size, self.image_size)

    @torch.no_grad()
    def p_sample_loop(self, shape, generator=None, init_noise=None):
        """The full DDPM reverse chain, T steps; returns images in [0, 1]."""
        img = _normal(shape, generator, self.device) if init_noise is None else init_noise
        for i in reversed(range(self.num_timesteps)):
            t = torch.full((shape[0],), i, dtype=torch.long, device=self.device)
            img = self.p_sample(img, t, generator=generator)
        return unnormalize_img(img)

    @torch.no_grad()
    def sample(self, batch_size: int = 16, generator=None):
        """Unconditioned DDPM samples of ``(batch_size, c, f, h, w)``."""
        return self.p_sample_loop(self._shape(batch_size), generator=generator)

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
    ) -> torch.Tensor:
        """DDIM sampling (Song et al. 2021) over a strided timestep grid; images in [0, 1].

        ``init_noise`` supplies x_T; ``step_noise`` supplies each step's noise
        (read only when ``eta > 0``). Otherwise both come from ``generator``.
        """
        shape = self._shape(batch_size)
        if init_noise is not None and tuple(init_noise.shape) != shape:
            raise ValueError(f"init_noise must have shape {shape}, got {tuple(init_noise.shape)}")
        times = sampling_times(self.num_timesteps, num_steps, grid).flip(0).tolist()
        times_prev = times[1:] + [-1]
        acp = self.alphas_cumprod
        one = torch.ones((), device=self.device)
        img = _normal(shape, generator, self.device) if init_noise is None else init_noise
        for step, (t, t_prev) in enumerate(zip(times, times_prev)):
            t_arr = torch.full((batch_size,), t, dtype=torch.long, device=self.device)
            x0, _ = self._model_out_to_x0_eps(img, t_arr, self._denoise(img, t_arr))
            x0 = torch.clamp(x0, -1.0, 1.0)
            a_t = acp[t]
            a_prev = acp[t_prev] if t_prev >= 0 else one
            eps_hat = (img - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
            sigma = eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t)) * torch.sqrt(1.0 - a_t / a_prev)
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps_hat
            img = torch.sqrt(a_prev) * x0 + dir_xt
            if eta > 0:
                noise = step_noise[step] if step_noise is not None else _normal(shape, generator, self.device)
                img = img + sigma * noise
        return unnormalize_img(img)

    # Training.

    def p_losses(self, x_start, t, noise=None, generator=None, focus_present_mask=None,
                 prob_focus_present: float = 0.0) -> torch.Tensor:
        """Denoising loss at timesteps ``t`` (JAX ``p_losses``, :923-996); noise from ``generator`` when not given.

        ``focus_present_mask`` and ``prob_focus_present`` go to the denoiser, which draws its
        mask from ``generator`` after the noise.
        """
        if noise is None:
            noise = _normal(x_start.shape, generator, x_start.device)
        x_noisy = self.q_sample(x_start, t, noise)
        model_out = self.denoise_fn(x_noisy, t, focus_present_mask=focus_present_mask,
                                    prob_focus_present=prob_focus_present, generator=generator)
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
        if self.min_snr_gamma is None:
            return err.mean()
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
        return (w * err).mean()

    def forward(self, x, generator=None, t=None, noise=None, focus_present_mask=None,
                prob_focus_present: float = 0.0) -> torch.Tensor:
        """Training entry (JAX ``__call__``, :998-1016): draw t, normalize ``x`` from [0, 1], return the loss."""
        want = (x.shape[0], self.channels, self.num_frames, self.image_size, self.image_size)
        if tuple(x.shape) != want:
            raise ValueError(f"x must have shape (b, c, f, h, w) = {want}; got {tuple(x.shape)}")
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x.shape[0],), generator=generator, device=x.device)
        return self.p_losses(normalize_img(x), t, noise=noise, generator=generator,
                             focus_present_mask=focus_present_mask, prob_focus_present=prob_focus_present)
