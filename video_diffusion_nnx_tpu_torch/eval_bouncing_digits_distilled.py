"""The distilled flagship's evidence (counterpart of scripts/eval_bouncing_digits_distilled.py).

Compares the trained bouncing-digits teacher against its progressively
distilled N-step student (``distill``) on the stride grid:

1. endpoint MSE at shared initial noise: DDIM at eta 0 is a deterministic
   ODE in x_T, so the teacher at 32 steps, the teacher at N steps (naive) and
   the student at N steps from the same x_T are directly comparable;
2. ``autocorr_stats`` (spatial and temporal autocorrelation, active-pixel
   fraction) of the student's samples, the teacher's and the held-out data;
3. side-by-side GIFs (teacher32 / naiveN / distilledN).

It writes ``stats.json`` with the JAX script's keys, then asserts that the
student lands closer than the naive N-step teacher and that its samples are
data-like (spatial autocorrelation above 0.5):

    python -m video_diffusion_nnx_tpu_torch.distill --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path results/bouncing_digits/checkpoints/step_20000.pt \\
        --initial-steps 32 --rounds 4 --steps-per-round 1000 --ema-decay 0.99 \\
        --output-path results/bouncing_digits/distilled
    python -m video_diffusion_nnx_tpu_torch.eval_bouncing_digits_distilled \\
        --teacher-path results/bouncing_digits/checkpoints --teacher-step 20000 \\
        --student-path results/bouncing_digits/distilled --student-step 4

Paths are folders of ``step_<N>.pt`` files, as the flagship eval takes them. It
runs on the GPU (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from video_diffusion_nnx_tpu_torch.eval_bouncing_digits import autocorr_stats

log = logging.getLogger("eval_bouncing_digits_distilled")

TEACHER_STEPS = 32
NOISE_SEED = 7


def evaluate(config_path: str, teacher_path: str, teacher_step: int, student_path: str, student_step: int,
             holdout: str, out: str, batch: int = 8, device: str = "cuda") -> dict:
    """The comparison; writes the GIFs and ``stats.json`` to ``out`` and returns the stats, with ``seconds`` (the
    evaluation's host time) beside them and not in the file."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    start = time.perf_counter()
    device = resolve_device(device)
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    config = load_config(config_path)
    n_frames = config["diffusion"]["num_frames"]
    models = {}
    for name, folder, step in (("teacher", teacher_path, teacher_step), ("student", student_path, student_step)):
        _, models[name] = build_models(config, device=device)
        load_checkpoint(models[name], Path(folder) / f"step_{step}.pt", load_ema_params=True)
        models[name].eval()

    # Endpoint MSE at shared initial noise (a deterministic ODE in x_T).
    m = models["teacher"]
    shape = (batch, m.channels, m.num_frames, m.image_size, m.image_size)
    x_T = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(NOISE_SEED), device=device)
    n = student_step

    def run(model, steps):
        return model.ddim_sample(batch_size=batch, num_steps=steps, grid="stride", init_noise=x_T).float().cpu().numpy()

    ref, naive, dist = run(models["teacher"], TEACHER_STEPS), run(models["teacher"], n), run(models["student"], n)
    mse_naive = float(np.mean((naive - ref) ** 2))
    mse_dist = float(np.mean((dist - ref) ** 2))

    # Realism of the student's samples against held-out data.
    hold = np.load(holdout)[:n_frames, :32].astype(np.float32) / 255.0
    hold = np.transpose(hold, (1, 0, 2, 3))  # (B, F, H, W)
    stats = {
        "config": config_path,
        "teacher_step": teacher_step,
        "student_sampler_steps": n,
        "mse_naive_vs_teacher32": round(mse_naive, 6),
        "mse_distilled_vs_teacher32": round(mse_dist, 6),
        "improvement": round(mse_naive / max(mse_dist, 1e-12), 2),
        "samples_distilled": autocorr_stats(np.clip(dist, 0.0, 1.0)[:, 0]),
        "samples_teacher32": autocorr_stats(np.clip(ref, 0, 1)[:, 0]),
        "data_holdout": autocorr_stats(hold),
    }
    (out_dir / "stats.json").write_text(json.dumps(stats, indent=2) + "\n")
    log.info("%s", json.dumps(stats))
    for arr, tag in ((ref, f"teacher{TEACHER_STEPS}"), (naive, f"naive{n}"), (dist, f"distilled{n}")):
        write_sample_gifs(np.clip(arr, 0, 1)[:2], out_dir, names=[f"{tag}_{i}" for i in range(2)])
    return {**stats, "seconds": time.perf_counter() - start}


def check(stats: dict) -> None:
    """The JAX script's two assertions: the student beats the naive N-step teacher against the 32-step reference,
    and its samples are data-like. Raises AssertionError."""
    n, mse_dist, mse_naive = stats["student_sampler_steps"], stats["mse_distilled_vs_teacher32"], \
        stats["mse_naive_vs_teacher32"]
    if not mse_dist < mse_naive:
        raise AssertionError(f"distilled {n}-step ({mse_dist:.5f}) must beat the naive {n}-step teacher "
                             f"({mse_naive:.5f}) against the {TEACHER_STEPS}-step reference")
    if not stats["samples_distilled"]["spatial_autocorr"] > 0.5:
        raise AssertionError(f"distilled samples are noise-like: {stats['samples_distilled']}")


def parse_args(argv=None) -> argparse.Namespace:
    here = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description="Evaluate a distilled bouncing-digits student against its teacher")
    ap.add_argument("--config", default=str(here / "configs/config_bouncing_digits.yaml"))
    ap.add_argument("--teacher-path", required=True, help="the folder of the teacher's step_<N>.pt")
    ap.add_argument("--teacher-step", type=int, required=True)
    ap.add_argument("--student-path", required=True, help="the distill CLI's output folder")
    ap.add_argument("--student-step", type=int, default=4, help="the student's file step = its sampler step count")
    ap.add_argument("--holdout", default=str(here / "data/bouncing_digits_val.npy"))
    ap.add_argument("--out", default=str(here / "examples/bouncing_digits_distilled_torch"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI: evaluate, write the outputs, then assert both claims; returns the stats."""
    args = parse_args(argv)
    stats = evaluate(args.config, args.teacher_path, args.teacher_step, args.student_path, args.student_step,
                     args.holdout, args.out, batch=args.batch, device=args.device)
    check(stats)
    log.info("EVAL OK: endpoint MSE naive %.5f -> distilled %.5f (%.1fx closer)", stats["mse_naive_vs_teacher32"],
             stats["mse_distilled_vs_teacher32"], stats["improvement"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
