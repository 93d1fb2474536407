#!/usr/bin/env python3
"""Progressive distillation at the flagship's width through the PyTorch port, on one CUDA card, in one process.

    python3 examples/distillation_production_torch/run_production.py [--teacher-steps 6000] [--distill-steps 1000] \\
        [--out examples/distillation_production_torch]

The recipe of scripts/demo_distillation_production.py (and of the stats in
examples/distillation_production/): the flagship-width Unet3D (dim 32,
mults (1, 2, 4, 8), 64x64, 10 frames, one channel, 8 heads) in bf16 with both
fused flags, T = 1024, v-prediction, l2; a teacher trained on 64 synthetic
moving-square clips (this file's own copy of the script's generator) at
batch 4, lr 1e-3, EMA 0.995 from step 200 every 5, frozen schedule buffers;
then its EMA progressively distilled 32 -> 16 -> 8 -> 4 at batch 4, lr 3e-4,
EMA 0.99. The claim: against the teacher's 32-step stride-grid DDIM from the
same x_T, the 4-step student lands closer than the teacher sampled naively at
4 steps (endpoint MSE on [0, 1]).

``--out`` gets ``stats.json`` (the JAX file's keys), the GIFs
(teacher32 / teacher4_naive / distilled4) and ``run.json``: the seconds of
each part, the teacher's and each round's host seconds per step, the peak
device memory of each part, the card (``nvidia-smi``) and the JAX run's
stats beside this one's. Exits non-zero when the claim fails, after writing
everything. Run it from the root of a checkout.
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
SIZE, FRAMES, T = 64, 10, 1024
WARMUP = 5
JAX_STATS = REPO / "examples" / "distillation_production" / "stats.json"


def make_dataset(path: Path, n: int = 64) -> None:
    """(F, B, H, W) uint8 .npy of moving bright squares on gray (scripts/demo_distillation_production.py:38-53)."""
    rng = np.random.default_rng(0)
    data = np.full((FRAMES, n, SIZE, SIZE), 96, np.uint8)
    for i in range(n):
        x0, y0 = rng.integers(0, SIZE - 16, size=2)
        dx, dy = rng.integers(-3, 4, size=2)
        side = int(rng.integers(8, 17))
        shade = int(rng.integers(200, 256))
        for f in range(FRAMES):
            xx = int(np.clip(x0 + f * dx, 0, SIZE - side))
            yy = int(np.clip(y0 + f * dy, 0, SIZE - side))
            data[f, i, yy:yy + side, xx:xx + side] = shade
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, data)


def build(torch):
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=32, dim_mults=(1, 2, 4, 8), channels=1, attn_heads=8, compute_dtype="bfloat16",
                  use_fused_attention=True, use_fused_spatial_attention=True)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    return GaussianDiffusion(unet, image_size=SIZE, num_frames=FRAMES, channels=1, timesteps=T, loss_type="l2",
                             prediction_type="v").to("cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Progressive distillation of the flagship-width Unet3D on the card")
    ap.add_argument("--teacher-steps", type=int, default=6000)
    ap.add_argument("--distill-steps", type=int, default=1000, help="per round")
    ap.add_argument("--out", default="examples/distillation_production_torch")
    ap.add_argument("--workdir", default="build/distill_prod")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s:%(name)s:%(message)s", force=True)
    sys.path.insert(0, str(REPO))
    import torch

    from video_diffusion_nnx_tpu_torch.data.loader import endless_prefetching_loader
    from video_diffusion_nnx_tpu_torch.data.moving_mnist import MovingMNIST
    from video_diffusion_nnx_tpu_torch.distill import round_record
    from video_diffusion_nnx_tpu_torch.training.distill import progressive_distill
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
           "cuda": torch.version.cuda, "teacher_steps": args.teacher_steps, "distill_steps": args.distill_steps}
    npy = work / "squares.npy"
    make_dataset(npy)

    # The teacher, trained as the JAX script trains it; its EMA is the teacher.
    teacher = build(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(teacher, str(work), dataset_path=str(npy), train_batch_size=4, train_lr=1e-3,
                 train_num_steps=args.teacher_steps, step_start_ema=200, update_ema_every=5, ema_decay=0.995,
                 checkpoint_every_steps=10**9, results_folder=str(work / "results"), tensorboard_dir=str(work / "tb"),
                 profile_flush_step=0, dataset_normalize=True, freeze_schedule_buffers=True, log_every_steps=250)
    tr.train()
    starts = tr.step_starts
    saves = sum(v for k, v in tr.save_seconds.items() if k >= WARMUP)
    run.update(teacher_seconds=time.perf_counter() - t0, teacher_peak_memory=torch.cuda.max_memory_allocated(),
               teacher_seconds_per_step=(starts[-1] - starts[WARMUP] - saves) / (len(starts) - 1 - WARMUP),
               teacher_loss_last=float(tr.loss_trace[-1]))
    teacher.load_state_dict(tr.ema_state)
    teacher.eval()
    del tr

    # Progressive distillation 32 -> 16 -> 8 -> 4 on the stride grids.
    ds = MovingMNIST(str(npy), image_size=(SIZE, SIZE), num_frames=FRAMES, force_num_frames=True, normalize=True)
    data = endless_prefetching_loader(ds, 4, "cuda", seed=0)
    rounds = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    student, final_steps = progressive_distill(
        teacher, data, initial_steps=32, rounds=4, steps_per_round=args.distill_steps,
        generator=torch.Generator(device="cuda").manual_seed(1), learning_rate=3e-4, ema_decay=0.99,
        on_done=lambda step: rounds.append({"student_steps": step.student_steps, **round_record(step)}))
    run.update(distill_seconds=time.perf_counter() - t0, distill_peak_memory=torch.cuda.max_memory_allocated(),
               rounds=[{"student_steps": r["student_steps"], "steps": r["steps"],
                        "seconds_per_step": r["seconds_per_step"], "loss_first": r["losses"][0],
                        "loss_last50_mean": float(np.mean(r["losses"][-50:]))} for r in rounds])

    # Endpoint MSE against the teacher's 32-step reference from the same x_T.
    t0 = time.perf_counter()
    b = 4
    x_T = torch.randn((b, 1, FRAMES, SIZE, SIZE), generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda")

    def ddim(model, steps):
        return model.ddim_sample(batch_size=b, num_steps=steps, grid="stride", init_noise=x_T).float().cpu().numpy()

    ref, naive4, dist4 = ddim(teacher, 32), ddim(teacher, 4), ddim(student, final_steps)
    mse_naive = float(np.mean((naive4 - ref) ** 2))
    mse_dist = float(np.mean((dist4 - ref) ** 2))
    stats = {
        "architecture": "dim 32, mults (1,2,4,8), 64x64, 10f, T=1024, v-pred",
        "teacher_train_steps": args.teacher_steps,
        "distill_steps_per_round": args.distill_steps,
        "rounds": "32 -> 16 -> 8 -> 4",
        "mse_teacher4_vs_teacher32": round(mse_naive, 6),
        "mse_distilled4_vs_teacher32": round(mse_dist, 6),
        "improvement": round(mse_naive / max(mse_dist, 1e-12), 2),
    }
    (out / "stats.json").write_text(json.dumps(stats, indent=2) + "\n")
    write_sample_gifs(ref[:2], out, names=["teacher32_0", "teacher32_1"])
    write_sample_gifs(naive4[:2], out, names=["teacher4_naive_0", "teacher4_naive_1"])
    write_sample_gifs(dist4[:2], out, names=["distilled4_0", "distilled4_1"])
    ok = mse_dist < mse_naive
    run.update(eval_seconds=time.perf_counter() - t0, stats=stats,
               jax_stats=json.loads(JAX_STATS.read_text()) if JAX_STATS.is_file() else None,
               claim="holds" if ok else f"failed: distilled 4-step {mse_dist:.6f} >= naive {mse_naive:.6f}")
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
