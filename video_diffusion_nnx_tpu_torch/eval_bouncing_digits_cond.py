"""Steering evaluation of the caption-conditioned bouncing-digits run (counterpart of
scripts/eval_bouncing_digits_cond.py).

    python -m video_diffusion_nnx_tpu_torch.eval_bouncing_digits_cond \\
        --config configs/config_bouncing_digits_cond.yaml \\
        --checkpoint-path results/bouncing_digits_cond/checkpoints --step 6000 \\
        [--gif-data data/bouncing_digits_cond_gifs] [--out examples/bouncing_digits_cond_torch] \\
        [--batch 8] [--num-steps 50] [--device cuda|cpu]

The recipe trains on bouncing handwritten digits whose file names carry the
digit count ("one digit", "two digits", "three digits", from
``data/bouncing_digits.py --captioned-gifs``). Ink mass grows with the
count, so caption steering has a statistic that needs no classifier:

    separation(cs) = ink("three digits" samples) - ink("one digit" samples)

at cond_scale 1 (the condition alone) and 3 (classifier-free guidance).
In order:

1. the data's mean ink by class, from every ``len // 90``-th clip of the
   GIF folder (about 30 per class), grouped by the caption without its
   trailing clip index;
2. the EMA weights of ``<checkpoint-path>/step_<step>.pt``;
3. DDIM-50 at batch 8 from one fixed generator seed, for each class and
   cond_scale 1 and 3, the samples' mean ink in [0, 1];
4. two GIFs per cell (``<class>_cs<scale>_<i>.gif``);
5. ``stats.json`` with the keys of the JAX run's
   ``examples/bouncing_digits_cond/stats.json``, its ``embedding`` naming the
   caption embedding that ran (``models/text.py``).

The CLI then asserts the script's three claims (:func:`check`): the classes
separate at cond_scale 1, guidance widens the separation, and the class
inks are ordered one < two < three at cond_scale 1. It runs on the GPU
(``--device cuda``, the default) and raises when there is none, unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("eval_bouncing_digits_cond")

CLASSES = ("one digit", "two digits", "three digits")
COND_SCALES = (1.0, 3.0)


def data_ink_by_class(gif_dir: str | Path, image_size: int, num_frames: int) -> dict[str, float]:
    """Mean ink of about 30 clips per class of a captioned GIF folder, by class phrase."""
    from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset

    ds = GifVideoDataset(str(gif_dir), image_size=image_size, channels=1, num_frames=num_frames,
                         use_path_as_cond=True)
    sums: dict[str, list[float]] = {}
    for i in range(0, len(ds), max(1, len(ds) // 90)):
        video, caption = ds[i]
        # Captions are unique per clip ("three digits 42"): group by the phrase without the index.
        cls = caption.rsplit(" ", 1)[0] if caption.split()[-1].isdigit() else caption
        sums.setdefault(cls, []).append(float(np.mean(video)))
    return {k: round(float(np.mean(v)), 4) for k, v in sorted(sums.items())}


def evaluate(config_path: str, checkpoint_path: str, step: int, gif_data: str | None, out: str,
             batch: int = 8, num_steps: int = 50, device: str = "cuda") -> dict:
    """Run steps 1-5; returns the stats with the seconds taken and the denoiser graphs' captures and replays."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config, resolve_device
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint
    from video_diffusion_nnx_tpu_torch.models.text import embedding_name
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    start = time.perf_counter()
    device = resolve_device(device)
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    config = load_config(config_path)
    stats: dict = {"config": config_path, "step": step, "embedding": embedding_name()}

    if gif_data is not None and Path(gif_data).is_dir():
        d = config["diffusion"]
        stats["data_ink_by_class"] = data_ink_by_class(gif_data, d["image_size"], d["num_frames"])
        log.info("data ink by class: %s", stats["data_ink_by_class"])

    _, model = build_models(config, device=device)
    load_checkpoint(model, Path(checkpoint_path) / f"step_{step}.pt", load_ema_params=True)
    model.eval()

    stats["classes"] = {}
    for cs in COND_SCALES:
        for cls in CLASSES:
            g = torch.Generator(device=device).manual_seed(0)
            videos = model.ddim_sample(num_steps=num_steps, generator=g, cond=[cls] * batch, cond_scale=cs)
            arr = np.clip(videos.float().cpu().numpy(), 0.0, 1.0)
            ink = float(arr.mean())
            stats["classes"][f"{cls.split()[0]}_cs{cs:g}"] = round(ink, 4)
            log.info("cond=%r cond_scale=%g: ink %.4f", cls, cs, ink)
            write_sample_gifs(arr[:2], out_dir, names=[f"{cls.replace(' ', '_')}_cs{cs:g}_{i}" for i in range(2)])

    c = stats["classes"]
    stats["separation_cs1"] = round(c["three_cs1"] - c["one_cs1"], 4)
    stats["separation_cs3"] = round(c["three_cs3"] - c["one_cs3"], 4)
    stats["class_order_correct_cs1"] = bool(c["one_cs1"] < c["two_cs1"] < c["three_cs1"])
    (out_dir / "stats.json").write_text(json.dumps(stats, indent=2) + "\n")
    log.info("%s", json.dumps(stats))
    graph = {"captures": model.graphs.captures, "replays": model.graphs.replays()}
    return {**stats, "seconds": time.perf_counter() - start, "graph": graph}


def check(stats: dict) -> None:
    """The three claims of the JAX script (scripts/eval_bouncing_digits_cond.py:132-139). Raises AssertionError."""
    c = stats["classes"]
    sep1 = c["three_cs1"] - c["one_cs1"]
    sep3 = c["three_cs3"] - c["one_cs3"]
    if not sep1 > 0.005:
        raise AssertionError(f"conditioning failed to separate digit-count classes (cs=1 separation {sep1:.4f})")
    if not sep3 > sep1:
        raise AssertionError(f"CFG failed to widen the separation (cs=1 {sep1:.4f} -> cs=3 {sep3:.4f})")
    if not c["one_cs1"] < c["two_cs1"] < c["three_cs1"]:
        raise AssertionError(f"class ink order wrong at cs=1: {c}")


def parse_args(argv=None) -> argparse.Namespace:
    here = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description="Evaluate caption steering of a bouncing-digits-cond checkpoint")
    ap.add_argument("--config", default=str(here / "configs/config_bouncing_digits_cond.yaml"))
    ap.add_argument("--checkpoint-path", required=True, help="the train CLI's checkpoint folder")
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--gif-data", default=str(here / "data/bouncing_digits_cond_gifs"))
    ap.add_argument("--out", default=str(here / "examples/bouncing_digits_cond_torch"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI: evaluate, write the outputs, then assert the claims; returns the stats."""
    args = parse_args(argv)
    stats = evaluate(args.config, args.checkpoint_path, args.step, args.gif_data, args.out, batch=args.batch,
                     num_steps=args.num_steps, device=args.device)
    check(stats)
    log.info("EVAL OK: separation %.4f (cs=1) -> %.4f (cs=3)", stats["separation_cs1"], stats["separation_cs3"])
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
