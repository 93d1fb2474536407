#!/usr/bin/env python3
"""The caption-conditioned bouncing-digits run through the PyTorch port, on one CUDA card, in one process.

    python3 examples/bouncing_digits_cond_torch/run_cond.py [--out examples/bouncing_digits_cond_torch]

Runs the three commands of the recipe (configs/config_bouncing_digits_cond.yaml)
through the same entry points, in order:

    python -m video_diffusion_nnx_tpu_torch.data.bouncing_digits \\
        --captioned-gifs data/bouncing_digits_cond_gifs --frames 10
    python -m video_diffusion_nnx_tpu_torch.train --config configs/config_bouncing_digits_cond.yaml
    python -m video_diffusion_nnx_tpu_torch.eval_bouncing_digits_cond \\
        --checkpoint-path results/bouncing_digits_cond/checkpoints --step 6000 --out <out>

The recipe trains as the file has it: 256 captioned clips per class of 10
frames, 6000 steps at batch 8 with condition dropout 0.2. One process keeps
the trainer, so the rate is read as ``chip_smoke.py`` reads it: host seconds
per step from ``Trainer.step_starts`` after a 5-step warm-up, less the
checkpoint writes in that window (``Trainer.save_seconds``), with the peak
device memory of the training. ``--out`` gets the eval's ``stats.json`` and
GIFs, ``loss_curve.csv`` (the logged losses, every 50 steps) and
``run.json``: the rate, the times, the peak memory, the caption embedding
that ran, the card (``nvidia-smi``) and whether the eval's three claims
held. Run it from the root of a checkout; the recipe's relative paths
(``data/``, ``results/``) are read from there. Exits non-zero when a claim
fails, after writing everything.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG = "configs/config_bouncing_digits_cond.yaml"
WARMUP = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train and evaluate the caption-conditioned recipe through the port")
    ap.add_argument("--out", default="examples/bouncing_digits_cond_torch")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s:%(name)s:%(message)s", force=True)
    sys.path.insert(0, str(REPO))
    import torch

    from video_diffusion_nnx_tpu_torch import eval_bouncing_digits_cond, train
    from video_diffusion_nnx_tpu_torch.config import load_config
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits
    from video_diffusion_nnx_tpu_torch.eval_bouncing_digits import extract_loss_curve
    from video_diffusion_nnx_tpu_torch.models.text import embedding_name

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    run = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "config": CONFIG, "embedding": embedding_name()}

    config = load_config(CONFIG)
    gifs = Path(config["trainer"]["dataset_path"])
    if gifs.is_dir():
        shutil.rmtree(gifs)  # the data is this run's alone
    t0 = time.perf_counter()
    bouncing_digits.main(["--captioned-gifs", str(gifs), "--frames", str(config["diffusion"]["num_frames"])])
    run["generate_seconds"] = time.perf_counter() - t0
    run["clips"] = len(list(gifs.glob("*.gif")))

    tb_dir = Path(config["trainer"]["tensorboard_dir"])
    for old in tb_dir.glob("*"):
        old.unlink()  # the loss curve is this run's alone
    ckpt_dir = Path(config["trainer"]["results_folder"]) / "checkpoints"
    for old in ckpt_dir.glob("step_*.pt"):
        old.unlink()  # a checkpoint of an earlier run would be skipped, not rewritten
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train.main(["--config", CONFIG])
    run["train_seconds"] = time.perf_counter() - t0
    starts = trainer.step_starts
    saves = sum(v for k, v in trainer.save_seconds.items() if k >= WARMUP)
    run.update(steps=trainer.step, warmup_steps=WARMUP, checkpoint_write_seconds=saves,
               seconds_per_step=(starts[-1] - starts[WARMUP] - saves) / (len(starts) - 1 - WARMUP),
               peak_memory=torch.cuda.max_memory_allocated())
    del trainer
    torch.cuda.empty_cache()
    curve = extract_loss_curve(tb_dir)
    with open(out / "loss_curve.csv", "w") as f:
        f.write("step,loss\n")
        f.writelines(f"{s},{v:.6f}\n" for s, v in curve)
    if curve:
        run.update(loss_first=curve[0][1], loss_last=curve[-1][1])

    torch.cuda.reset_peak_memory_stats()
    stats = eval_bouncing_digits_cond.evaluate(
        CONFIG, str(ckpt_dir), config["trainer"]["train_num_steps"], str(gifs), str(out), device="cuda")
    run.update(eval_seconds=stats.pop("seconds"), eval_peak_memory=torch.cuda.max_memory_allocated(),
               eval_graph=stats.pop("graph"))
    try:
        eval_bouncing_digits_cond.check(stats)  # what the eval CLI asserts after writing stats.json
        run["claims"] = "all three hold"
    except AssertionError as e:
        run["claims"] = f"failed: {e}"
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)
    return 0 if run["claims"] == "all three hold" else 1


if __name__ == "__main__":
    sys.exit(main())
