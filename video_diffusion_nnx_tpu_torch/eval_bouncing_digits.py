"""Quality evaluation of the bouncing-digits flagship run (counterpart of scripts/eval_bouncing_digits.py).

    python -m video_diffusion_nnx_tpu_torch.eval_bouncing_digits --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path results/bouncing_digits/checkpoints --step 20000 \\
        [--train data/bouncing_digits.npy] [--holdout data/bouncing_digits_val.npy] \\
        [--out examples/bouncing_digits_torch] [--eval-clips 32] [--skip-ddpm] [--device cuda|cpu]

The trained EMA model of ``<checkpoint-path>/step_<step>.pt`` (the train
CLI's file) and a freshly built untrained model of the same config give:

1. the loss curve of the run (``metrics.jsonl`` of the config's
   ``tensorboard_dir``, else its TensorBoard events), as ``loss_curve.csv``;
2. generalization: the training loss on held-out clips, whose digits come
   from writers never seen in training, against the same loss on training
   clips with the same t and noise draws;
3. reconstruction: held-out clips noised to t* = T/8, T/4, T/2 and brought
   back by a truncated DDIM chain; PSNR and SSIM against the originals,
   and the same PSNR of the untrained model (the floor) from the same noise;
4. sample statistics: spatial and temporal autocorrelation and the active
   pixel fraction of DDIM-50 samples against the held-out data;
5. GIFs: 4 DDIM-50 samples, 4 DDPM samples (unless ``--skip-ddpm``) and 2
   side-by-side [original | T/4 reconstruction] pairs.

``stats.json`` has the keys of the JAX run's ``examples/bouncing_digits/stats.json``.
The CLI then asserts the five claims of :func:`check`; no flag turns them off.
It runs on the GPU (``--device cuda``, the default) and raises when there is
none, unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("eval_bouncing_digits")

RECON_FRACTIONS = ((8, "T_8"), (4, "T_4"), (2, "T_2"))


def extract_loss_curve(tb_dir: Path) -> list[tuple[int, float]]:
    """Pull the loss scalar series from metrics.jsonl or TensorBoard event files."""
    jsonl = tb_dir / "metrics.jsonl"
    if jsonl.exists():
        rows = []
        for line in jsonl.read_text().splitlines():
            rec = json.loads(line)
            if rec.get("tag") in ("loss", "loss/train"):
                rows.append((int(rec["step"]), float(rec["value"])))
        if rows:
            return rows
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except Exception:
        return []
    rows = []
    # Newest event file only: the folder may hold earlier runs' files, whose series would interleave.
    ev_files = sorted(tb_dir.glob("events.out.tfevents.*"), key=lambda p: p.name)
    for ev_file in ev_files[-1:]:
        acc = EventAccumulator(str(ev_file))
        acc.Reload()
        tags = acc.Tags().get("scalars", [])
        tag = "loss/train" if "loss/train" in tags else ("loss" if "loss" in tags else None)
        if tag:
            rows.extend((int(s.step), float(s.value)) for s in acc.Scalars(tag))
    rows.sort()
    return rows


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB over [0, 1] videos."""
    mse = float(np.mean((a - b) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Global (non-windowed) SSIM over [0, 1] videos: a relative metric between runs on the same data."""
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )


def autocorr_stats(clips: np.ndarray) -> dict:
    """Mean spatial (1-px shift) and temporal (1-frame lag) autocorrelation of (B, F, H, W) [0, 1] clips,
    and the fraction of pixels above 0.2."""

    def corr(x, y):
        x = x - x.mean()
        y = y - y.mean()
        denom = np.sqrt((x**2).mean() * (y**2).mean())
        return float((x * y).mean() / max(denom, 1e-12))

    spatial = corr(clips[..., :-1], clips[..., 1:])
    temporal = corr(clips[:, :-1], clips[:, 1:])
    return {
        "spatial_autocorr": round(spatial, 4),
        "temporal_autocorr": round(temporal, 4),
        "active_pixel_frac": round(float((clips > 0.2).mean()), 4),
    }


def recon_times(t_start: int, n_steps: int = 25) -> list[int]:
    """The truncated DDIM's timesteps, descending: a linspace grid of ``n_steps`` points within [0, t_start]."""
    return np.unique(np.linspace(0, t_start, n_steps).astype(np.int32))[::-1].tolist()


@torch.no_grad()
def reconstruct(diffusion, x0: torch.Tensor, t_start: int, noise: torch.Tensor, n_steps: int = 25) -> torch.Tensor:
    """Noise ``x0`` ((b, c, f, h, w) in [0, 1]) to ``t_start`` with ``noise``, then run DDIM back down a
    linspace grid of ``n_steps`` points within [0, t_start]; returns the clips in [0, 1] (unclipped)."""
    from video_diffusion_nnx_tpu_torch.utils.image import normalize_img, unnormalize_img

    times = recon_times(t_start, n_steps)
    times_prev = times[1:] + [-1]
    b = x0.shape[0]
    acp = diffusion.alphas_cumprod
    one = torch.ones((), device=acp.device)
    img = diffusion.q_sample(normalize_img(x0), torch.full((b,), t_start, dtype=torch.long, device=x0.device), noise)
    for t, t_prev in zip(times, times_prev):
        t_arr = torch.full((b,), t, dtype=torch.long, device=x0.device)
        x0_hat, _ = diffusion._model_out_to_x0_eps(img, t_arr, diffusion._denoise(img, t_arr))
        x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else one
        eps_hat = (img - torch.sqrt(a_t) * x0_hat) / torch.sqrt(1.0 - a_t)
        img = torch.sqrt(a_prev) * x0_hat + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps_hat
    return unnormalize_img(img)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def evaluate(config_path: str, checkpoint_path: str, step: int, train: str, holdout: str, out: str,
             eval_clips: int = 32, skip_ddpm: bool = False, device: str = "cuda") -> dict:
    """The evaluation's steps in the script's order; writes the GIFs, ``loss_curve.csv`` and ``stats.json``
    to ``out`` and returns the stats (with ``seconds``, the evaluation's host time, which stays out of the file)."""
    from einops import rearrange

    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    start = time.perf_counter()
    device = resolve_device(device)
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    config = load_config(config_path)
    n_frames = config["diffusion"]["num_frames"]
    stats: dict = {"config": config_path, "step": step}

    # Loss curve.
    curve = extract_loss_curve(Path(config["trainer"]["tensorboard_dir"]))
    if curve:
        with open(out_dir / "loss_curve.csv", "w") as f:
            f.write("step,loss\n")
            for s, v in curve:
                f.write(f"{s},{v:.6f}\n")
        stats["loss_first"] = round(curve[0][1], 4)
        stats["loss_last"] = round(curve[-1][1], 4)
        log.info("loss curve: %s -> %s (%d points)", curve[0], curve[-1], len(curve))

    # Models: the trained EMA and the untrained floor.
    _, model = build_models(config, device=device)
    load_checkpoint(model, Path(checkpoint_path) / f"step_{step}.pt", load_ema_params=True)
    _, floor_model = build_models(config, device=device)  # fresh init = untrained floor
    model.eval()
    floor_model.eval()

    def load_clips(path, n):
        arr = np.load(path)  # (F, B, H, W) uint8
        arr = arr[:n_frames, :n].astype(np.float32) / 255.0
        return torch.from_numpy(np.ascontiguousarray(rearrange(arr, "f b h w -> b 1 f h w"))).to(device)

    train_clips = load_clips(train, eval_clips)
    hold_clips = load_clips(holdout, eval_clips)

    # Generalization: the training loss on train and holdout clips, same t and noise draws.
    with torch.no_grad():
        loss_train = float(model(train_clips, generator=_generator(device, 0)))
        loss_hold = float(model(hold_clips, generator=_generator(device, 0)))
    stats["eval_loss_train"] = round(loss_train, 5)
    stats["eval_loss_holdout"] = round(loss_hold, 5)
    stats["generalization_gap"] = round(loss_hold - loss_train, 5)
    log.info("loss train %.5f vs holdout %.5f (gap %+.5f)", loss_train, loss_hold, loss_hold - loss_train)

    # Reconstruction from partial noising (truncated DDIM); the floor from the same noise.
    T = model.num_timesteps
    noise = torch.randn(hold_clips.shape, generator=_generator(device, 1), device=device)
    hold_np = hold_clips.cpu().numpy()
    recon_videos = {}
    for frac, label in RECON_FRACTIONS:
        t_star = T // frac
        rec = np.clip(reconstruct(model, hold_clips, t_star, noise).float().cpu().numpy(), 0.0, 1.0)
        stats[f"recon_psnr_{label}"] = round(psnr(rec, hold_np), 2)
        stats[f"recon_ssim_{label}"] = round(ssim(rec, hold_np), 4)
        recon_videos[label] = rec
        rec_floor = np.clip(reconstruct(floor_model, hold_clips, t_star, noise).float().cpu().numpy(), 0, 1)
        stats[f"recon_psnr_{label}_untrained"] = round(psnr(rec_floor, hold_np), 2)
        log.info("recon t*=T/%d: PSNR %.2f dB (untrained floor %.2f), SSIM %.4f", frac,
                 stats[f"recon_psnr_{label}"], stats[f"recon_psnr_{label}_untrained"], stats[f"recon_ssim_{label}"])
    del floor_model

    # Generated-sample statistics against the data distribution.
    ddim = model.ddim_sample(batch_size=8, num_steps=50, generator=_generator(device, 2)).float().cpu()
    ddim_np = np.clip(ddim.numpy(), 0.0, 1.0)
    stats["samples_ddim50"] = autocorr_stats(ddim_np[:, 0])
    stats["data_holdout"] = autocorr_stats(hold_np[:, 0])
    log.info("sample stats %s vs data %s", stats["samples_ddim50"], stats["data_holdout"])

    # GIFs.
    paths = write_sample_gifs(ddim[:4], out_dir, names=[f"ddim50_sample_{i}" for i in range(4)])
    if not skip_ddpm:
        ddpm = model.sample(batch_size=4, generator=_generator(device, 3))
        paths += write_sample_gifs(ddpm, out_dir, names=[f"ddpm_sample_{i}" for i in range(4)])
    pair = np.concatenate([hold_np[:2], recon_videos["T_4"][:2]], axis=4)  # [original | recon at T/4] on width
    paths += write_sample_gifs(pair, out_dir, names=[f"recon_T4_pair_{i}" for i in range(2)])
    for p in paths:
        log.info("wrote %s", p)

    (out_dir / "stats.json").write_text(json.dumps(stats, indent=2) + "\n")
    log.info("%s", json.dumps(stats))
    return {**stats, "seconds": time.perf_counter() - start}


def check(stats: dict) -> None:
    """The five claims of the JAX script: loss fell 4x, a small generalization gap, reconstruction well above
    the untrained floor, and data-like DDIM samples (not noise-like, not over-bright). Raises AssertionError."""

    def claim(ok: bool, message: str) -> None:
        if not ok:
            raise AssertionError(message)

    if "loss_first" in stats:
        claim(stats["loss_last"] < 0.25 * stats["loss_first"], "training loss did not drop by 4x")
    claim(stats["generalization_gap"] < 0.5 * stats["eval_loss_train"] + 0.02,
          "holdout loss far above train loss — memorization or broken eval")
    claim(stats["recon_psnr_T_4"] > stats["recon_psnr_T_4_untrained"] + 3.0,
          "reconstruction no better than the untrained floor")
    # Free-running samples must look like data, not noise: drifted schedule buffers (PARITY.md #11) pass every
    # claim above while DDIM samples are white noise (spatial autocorr ~0.05 against the data's ~0.83).
    gen = stats["samples_ddim50"]
    claim(gen["spatial_autocorr"] > 0.5,
          f"generated samples are noise-like (spatial autocorr {gen['spatial_autocorr']}); schedule buffers drifted?")
    claim(gen["active_pixel_frac"] < 6 * stats["data_holdout"]["active_pixel_frac"] + 0.05,
          f"generated active-pixel fraction {gen['active_pixel_frac']} far "
          f"from data {stats['data_holdout']['active_pixel_frac']}")


def parse_args(argv=None) -> argparse.Namespace:
    here = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description="Evaluate a bouncing-digits checkpoint and assert its quality")
    ap.add_argument("--config", default=str(here / "configs/config_bouncing_digits.yaml"))
    ap.add_argument("--checkpoint-path", required=True, help="the train CLI's checkpoint folder")
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--train", default=str(here / "data/bouncing_digits.npy"))
    ap.add_argument("--holdout", default=str(here / "data/bouncing_digits_val.npy"))
    ap.add_argument("--out", default=str(here / "examples/bouncing_digits_torch"))
    ap.add_argument("--eval-clips", type=int, default=32)
    ap.add_argument("--skip-ddpm", action="store_true", help="skip the full-T DDPM sample GIFs")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI: evaluate, write the outputs, then assert the claims; returns the stats."""
    args = parse_args(argv)
    stats = evaluate(args.config, args.checkpoint_path, args.step, args.train, args.holdout, args.out,
                     eval_clips=args.eval_clips, skip_ddpm=args.skip_ddpm, device=args.device)
    check(stats)
    log.info("EVAL OK (%.1f s)", stats["seconds"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
