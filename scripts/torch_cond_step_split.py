#!/usr/bin/env python3
"""Split the caption-conditioned training step of the PyTorch port into its data path and its condition, on one card.

    python3 scripts/torch_cond_step_split.py [--steps 40] [--clips-per-class 64] [--out chiprun_out/cond_step_split]

The recipe of configs/config_bouncing_digits_cond.yaml (only the data folder,
the output folders and the step count changed) trains through the port's
trainer at batch 8 in one process, in turn:

- ``cond_gif``: as shipped, captioned GIFs decoded on the loader's thread;
- ``cond_mem``: the same clips and captions decoded into memory first;
- ``uncond_gif`` / ``uncond_mem``: the same Unet3D without the condition
  (``use_bert_text_cond`` and ``use_path_as_cond`` off);
- ``cond_gif`` and ``cond_mem`` again, for the spread of one configuration.

Each prints its host seconds per step after a 5-step warm-up (the step
starts of ``Trainer.step_starts``; no checkpoint falls in the window). The
loader's own seconds per batch of 8 (decode and caption embedding, no
training) come first. The data are captioned GIFs of the port's generator
(``data/bouncing_digits.py --captioned-gifs``), written under ``build/``. The
JSON goes to ``--out``/step_split.json with the card's name and power limit.
It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WARMUP = 5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--clips-per-class", type=int, default=64)
    ap.add_argument("--out", default="chiprun_out/cond_step_split")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    import yaml

    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits
    from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
    from video_diffusion_nnx_tpu_torch.data.loader import (
        DataLoader,
        collate_with_text_cond,
        cycle,
        endless_prefetching_loader,
    )

    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device")
    root = REPO / "build" / "cond_step_split"
    gifs = root / "gifs"
    if not gifs.is_dir():
        bouncing_digits.main(["--captioned-gifs", str(gifs), "--frames", "10",
                              "--captioned-clips-per-class", str(args.clips_per_class)])
    raw = yaml.safe_load((REPO / "configs" / "config_bouncing_digits_cond.yaml").read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out: dict = {"nvidia_smi": smi, "steps": args.steps, "warmup": WARMUP}
    batch = raw["trainer"]["train_batch_size"]

    ds = GifVideoDataset(str(gifs), image_size=64, channels=1, num_frames=10, use_path_as_cond=True)
    batches = iter(cycle(DataLoader(ds, batch, seed=0, collate_fn=collate_with_text_cond)))
    next(batches)
    t0 = time.perf_counter()
    for _ in range(40):
        next(batches)
    out["loader_s_per_batch"] = (time.perf_counter() - t0) / 40
    print("loader", out["loader_s_per_batch"], flush=True)

    def run(name: str, cond: bool, in_memory: bool) -> None:
        cfg = json.loads(json.dumps(raw))
        cfg["unet"]["use_bert_text_cond"] = cond
        cfg["trainer"].update(dataset_path=str(gifs), results_folder=str(root / name),
                              tensorboard_dir=str(root / name / "tb"), train_num_steps=args.steps,
                              checkpoint_every_steps=10 * args.steps, use_path_as_cond=cond,
                              null_cond_prob=raw["trainer"]["null_cond_prob"] if cond else 0.0)
        path = root / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        _, _, trainer = build_trainer(load_config(path), device="cuda")
        if in_memory:
            items = [trainer.ds[i] for i in range(len(trainer.ds))]
            trainer.dl = endless_prefetching_loader(items, batch, trainer.device, seed=0,
                                                    collate_fn=collate_with_text_cond if cond else None)
        trainer.train()
        starts = trainer.step_starts
        out.setdefault(name, []).append((starts[-1] - starts[WARMUP]) / (len(starts) - 1 - WARMUP))
        print(name, out[name][-1], flush=True)
        del trainer
        torch.cuda.empty_cache()

    for name, cond, in_memory in (("cond_gif", True, False), ("cond_mem", True, True), ("uncond_gif", False, False),
                                  ("uncond_mem", False, True), ("cond_gif", True, False), ("cond_mem", True, True)):
        run(name, cond, in_memory)
    target = Path(args.out)
    target.mkdir(parents=True, exist_ok=True)
    (target / "step_split.json").write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
