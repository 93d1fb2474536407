#!/usr/bin/env python3
"""The two-stage distillation pipeline keeps classifier-free guidance's steering, through the PyTorch port, on one
CUDA card, in one process.

    python3 examples/distillation_torch/run_demo.py [--steps 1200] [--distill-steps 400] \\
        [--out examples/distillation_torch]

The recipe of scripts/demo_distillation.py (and of the stats in
examples/distillation/): GIF clips in two caption classes of opposite
brightness, "bright square {i}" (near white) and "dark square {i}" (near
black), 16 per class, 4 frames of 16x16 (this file's own copy of
scripts/demo_text_conditioning.py's generator); captions embedded by the
hashed bag of words (``models/text.py``; no BERT weights are read). The
measurable chain:

1. the TEACHER (a dim-16 Unet3D, mults (1, 2), 2 heads, float32, the modules'
   route as in the JAX script; v-prediction, T = 100, condition dropout 0.2,
   1200 steps at batch 8, lr 2e-3, EMA 0.99 from step 100 every 5) separates
   the classes' mean intensities under guidance at cond_scale 3 (two forwards
   a step, the full 100-step DDPM chain);
2. the GUIDANCE-DISTILLED student (400 steps, w ~ U[1, 4], lr 1e-3) keeps the
   separation with one forward a step;
3. the STAGE-2 student (two progressive rounds 8 -> 4 of 400 steps, w ~ U[1, 4])
   keeps it at four DDIM steps on the stride grid, still one forward a step.

Asserts, as the JAX script does: the teacher's separation above 0.2, the
guidance-distilled student's above 0.6x and stage 2's above 0.5x the
teacher's. ``--out`` gets ``stats.json`` (the JAX file's keys), per-stage
GIFs and ``run.json`` (seconds and peak memory of each stage, the card, the
JAX run's stats beside this one's). Exits non-zero when a claim fails, after
writing everything. Run it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SIZE, FRAMES, T = 16, 4, 100
JAX_STATS = REPO / "examples" / "distillation" / "stats.json"


def make_dataset(root: Path, n_per_class: int = 16) -> None:
    """GIF clips: a moving 4x4 square on a mid-gray background; 'bright' clips live near white, 'dark' clips near
    black (scripts/demo_text_conditioning.py:37-60)."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for cls, lo, hi in (("bright", 190, 255), ("dark", 0, 65)):
        for i in range(n_per_class):
            x0, y0 = rng.integers(0, SIZE - 6, size=2)
            dx, dy = rng.integers(1, 3, size=2)
            frames = []
            for f in range(FRAMES):
                img = np.full((SIZE, SIZE), (lo + hi) // 2, np.uint8)
                xx = int(np.clip(x0 + f * dx, 0, SIZE - 4))
                yy = int(np.clip(y0 + f * dy, 0, SIZE - 4))
                img[yy: yy + 4, xx: xx + 4] = hi if cls == "bright" else lo
                img = np.clip(img, lo, hi).astype(np.uint8)  # the whole clip in the class's band
                frames.append(Image.fromarray(img, mode="L"))
            frames[0].save(root / f"{cls} square {i}.gif", save_all=True, append_images=frames[1:], duration=100,
                           loop=0)


def build(torch, guidance_embed: bool):
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=16, dim_mults=(1, 2), channels=1, attn_heads=2, use_bert_text_cond=True,
                  guidance_embed=guidance_embed)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    return GaussianDiffusion(unet, image_size=SIZE, num_frames=FRAMES, channels=1, timesteps=T, loss_type="l2",
                             prediction_type="v").to("cuda")


def class_separation(torch, model, cond_scale: float, num_steps: int | None = None, b: int = 4):
    """The mean-intensity gap between the two caption classes' samples (each class from the same seed), the means
    and the samples; the full DDPM chain, or ``num_steps`` of DDIM on the stride grid."""
    means, videos = {}, {}
    for cls in ("bright", "dark"):
        g = torch.Generator(device="cuda").manual_seed(0)
        cond = [f"{cls} square"] * b
        if num_steps is None:
            v = model.sample(generator=g, cond=cond, cond_scale=cond_scale)
        else:
            v = model.ddim_sample(num_steps=num_steps, grid="stride", generator=g, cond=cond, cond_scale=cond_scale)
        videos[cls] = v.float().cpu().numpy()
        means[cls] = float(videos[cls].mean())
    return means["bright"] - means["dark"], means, videos


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Guidance distillation and stage 2 keep the steering, on the card")
    ap.add_argument("--steps", type=int, default=1200, help="teacher train steps")
    ap.add_argument("--distill-steps", type=int, default=400, help="per distillation stage and round")
    ap.add_argument("--out", default="examples/distillation_torch")
    ap.add_argument("--workdir", default="build/distill_demo")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s:%(name)s:%(message)s", force=True)
    sys.path.insert(0, str(REPO))
    import torch

    from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
    from video_diffusion_nnx_tpu_torch.data.loader import collate_with_text_cond, endless_prefetching_loader
    from video_diffusion_nnx_tpu_torch.models.text import embedding_name
    from video_diffusion_nnx_tpu_torch.training.distill import progressive_distill
    from video_diffusion_nnx_tpu_torch.training.guidance import guidance_distill
    from video_diffusion_nnx_tpu_torch.training.trainer import Trainer
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    out, work = Path(args.out), Path(args.workdir)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    run = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "embedding": embedding_name()}
    clips = work / "clips"
    make_dataset(clips)

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        run[name] = {"seconds": time.perf_counter() - t0, "peak_memory": torch.cuda.max_memory_allocated()}
        return result

    # 1. The teacher: v-prediction with condition dropout; its EMA is the teacher.
    teacher = build(torch, False)

    def train_teacher():
        tr = Trainer(teacher, str(work), dataset_path=str(clips), train_batch_size=8, train_lr=2e-3,
                     train_num_steps=args.steps, step_start_ema=100, update_ema_every=5, ema_decay=0.99,
                     checkpoint_every_steps=10**9, results_folder=str(work / "results"),
                     tensorboard_dir=str(work / "tb"), profile_flush_step=0, use_path_as_cond=True,
                     null_cond_prob=0.2, log_every_steps=100)
        tr.train()
        teacher.load_state_dict(tr.ema_state)
        teacher.eval()

    stage("teacher_train", train_teacher)
    stats = {"teacher_train_steps": args.steps, "distill_steps_per_stage": args.distill_steps}

    def record(key, result, forwards, steps, tag):
        sep, means, videos = result
        stats[key] = {"separation": round(sep, 4), **{k: round(v, 4) for k, v in means.items()},
                      "forwards_per_step": forwards, "steps": steps}
        for cls, arr in videos.items():
            write_sample_gifs(arr[:2], out, names=[f"{tag}_{cls}_{i}" for i in range(2)])
        return sep

    sep_t = record("teacher_cfg_cs3_full_grid", stage("teacher_sample", lambda: class_separation(torch, teacher, 3.0)),
                   2, T, "teacher")

    # 2. Guidance distillation: classifier-free guidance folded into one forward.
    ds = GifVideoDataset(str(clips), image_size=SIZE, channels=1, num_frames=FRAMES, force_num_frames=True,
                         use_path_as_cond=True)
    data = endless_prefetching_loader(ds, 8, "cuda", seed=0, collate_fn=collate_with_text_cond)
    student = build(torch, True)
    stage("guidance_distill", lambda: guidance_distill(
        teacher, student, data, num_train_steps=args.distill_steps,
        generator=torch.Generator(device="cuda").manual_seed(1), learning_rate=1e-3, w_range=(1.0, 4.0),
        log_every=100))
    student.eval()
    sep_g = record("guidance_distilled_cs3_full_grid",
                   stage("guidance_sample", lambda: class_separation(torch, student, 3.0)), 1, T, "gdistilled")

    # 3. Stage 2: progressive halving of the w-conditioned student, 8 -> 4 steps.
    final = stage("stage2_distill", lambda: progressive_distill(
        student, data, initial_steps=8, rounds=2, steps_per_round=args.distill_steps,
        generator=torch.Generator(device="cuda").manual_seed(2), learning_rate=1e-3, conditioned=True,
        w_range=(1.0, 4.0)))
    stage2, final_steps = final
    stage2.eval()
    sep_p = record(f"stage2_distilled_cs3_{final_steps}step",
                   stage("stage2_sample", lambda: class_separation(torch, stage2, 3.0, num_steps=final_steps)), 1,
                   final_steps, f"stage2_{final_steps}step")

    (out / "stats.json").write_text(json.dumps(stats, indent=2) + "\n")
    claims = [(sep_t > 0.2, f"teacher failed to steer (separation {sep_t:.3f})"),
              (sep_g > 0.6 * sep_t, f"guidance distillation lost the steering ({sep_g:.3f} vs teacher {sep_t:.3f})"),
              (sep_p > 0.5 * sep_t, f"stage-2 distillation lost the steering ({sep_p:.3f} vs teacher {sep_t:.3f})")]
    failed = [msg for ok, msg in claims if not ok]
    run.update(stats=stats, jax_stats=json.loads(JAX_STATS.read_text()) if JAX_STATS.is_file() else None,
               claims="all three hold" if not failed else f"failed: {failed}")
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
