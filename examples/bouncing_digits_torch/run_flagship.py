#!/usr/bin/env python3
"""The flagship quality run through the PyTorch port, on one CUDA card, in one process.

    python3 examples/bouncing_digits_torch/run_flagship.py [--out examples/bouncing_digits_torch]

Runs the three commands of the recipe through the same entry points, in order:

    python -m video_diffusion_nnx_tpu_torch.data.bouncing_digits --out data/bouncing_digits.npy \\
        --clips 2000 --frames 16 --holdout-out data/bouncing_digits_val.npy
    python -m video_diffusion_nnx_tpu_torch.train --config configs/config_bouncing_digits.yaml
    python -m video_diffusion_nnx_tpu_torch.eval_bouncing_digits --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path results/bouncing_digits/checkpoints --step 20000 --out <out>

One process keeps the trainer, so the run's rate is read as ``chip_smoke.py``
reads it: host seconds per step from ``Trainer.step_starts`` after a 5-step
warm-up, less the checkpoint writes in that window (``Trainer.save_seconds``),
with the peak device memory of the training. The eval's stats and GIFs go to
``--out``, with the run's ``metrics.jsonl`` (or TensorBoard events), and ``run.json`` holds the rate,
the times, the card (``nvidia-smi``) and whether the eval's five claims held.
Run it from the root of a checkout; the recipe's relative paths (``data/``,
``results/``) are read from there. Exits non-zero when a claim fails, after
writing everything.
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
CONFIG = "configs/config_bouncing_digits.yaml"
WARMUP = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train and evaluate the flagship recipe through the port on one card")
    ap.add_argument("--out", default="examples/bouncing_digits_torch")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s:%(name)s:%(message)s", force=True)
    sys.path.insert(0, str(REPO))
    import torch

    from video_diffusion_nnx_tpu_torch import eval_bouncing_digits, train
    from video_diffusion_nnx_tpu_torch.config import load_config
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    run = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "config": CONFIG}

    t0 = time.perf_counter()
    data = ["data/bouncing_digits.npy", "data/bouncing_digits_val.npy"]
    bouncing_digits.main(["--out", data[0], "--clips", "2000", "--frames", "16", "--holdout-out", data[1]])
    run["generate_seconds"] = time.perf_counter() - t0

    config = load_config(CONFIG)
    for old in Path(config["trainer"]["tensorboard_dir"]).glob("*"):
        old.unlink()  # the loss curve is this run's alone
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
    for f in Path(config["trainer"]["tensorboard_dir"]).iterdir():  # metrics.jsonl, or TensorBoard's events
        shutil.copy(f, out / f.name)

    torch.cuda.reset_peak_memory_stats()
    ev_args = eval_bouncing_digits.parse_args([
        "--config", CONFIG, "--checkpoint-path", f"{config['trainer']['results_folder']}/checkpoints",
        "--step", str(config["trainer"]["train_num_steps"]), "--train", data[0], "--holdout", data[1],
        "--out", str(out)])
    stats = eval_bouncing_digits.evaluate(ev_args.config, ev_args.checkpoint_path, ev_args.step, ev_args.train,
                                          ev_args.holdout, ev_args.out, eval_clips=ev_args.eval_clips,
                                          skip_ddpm=ev_args.skip_ddpm, device=ev_args.device)
    run.update(eval_seconds=stats.pop("seconds"), eval_peak_memory=torch.cuda.max_memory_allocated())
    try:
        eval_bouncing_digits.check(stats)  # what the eval CLI asserts after writing stats.json
        run["claims"] = "all five hold"
    except AssertionError as e:
        run["claims"] = f"failed: {e}"
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)
    return 0 if run["claims"] == "all five hold" else 1


if __name__ == "__main__":
    sys.exit(main())
