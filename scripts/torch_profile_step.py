"""Where a sampler or a training step's time goes in the PyTorch port, on one CUDA card.

    python scripts/torch_profile_step.py [--steps 5] [--batch-size 2] [--train]
        [--config configs/config_bouncing_digits.yaml] [--fixed] [--dit D1|D2] [--trace]

Builds the recipe of ``--config`` (the flagship's by default) with seeded
random weights and traces ``--steps`` DDPM reverse steps, or with ``--train``
that many training steps (the loss on a random batch, its backward and an
Adam update; no gradient clip, no EMA; ``--fixed`` sets ``unet.reference_compat:
false``, the fixed-math recipe; ``--dit`` swaps in the VideoDiT recipe D1 or D2 of
``chip_smoke.py``, its adaLN drawn at std 0.05 as there), with ``torch.profiler`` (CPU and
CUDA activities) after a warm-up. Prints one JSON line: the host-clock time per step with and without the profiler, the
device time per step (the sum of every CUDA kernel's time; user-annotation ranges, such as the optimizer's
step, are device-side spans around kernels and are left out of it, and reported apart), the device's
busy share (device time over the unprofiled step, since tracing the host
slows it), and the fifteen kernels that take the most device time. Writes the
same JSON, and with ``--trace`` a Chrome trace, to
chiprun_out/torch_profile_step/, named by recipe, mode and batch. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out" / "torch_profile_step"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--train", action="store_true", help="trace training steps instead of sampler steps")
    p.add_argument("--config", type=str, default=str(REPO / "configs" / "config_bouncing_digits.yaml"))
    p.add_argument("--fixed", action="store_true", help="fixed math: unet.reference_compat false")
    p.add_argument("--dit", choices=("D1", "D2"), default=None, help="the VideoDiT recipe of chip_smoke.py")
    p.add_argument("--trace", action="store_true", help="also write the Chrome trace (tens of MB for a training step)")
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config

    if args.dit:
        import chip_smoke

        config = chip_smoke.dit_raw(args.dit)
    else:
        config = load_config(args.config)
    if args.fixed:
        config["unet"]["reference_compat"] = False
    _, diffusion = build_models(config, "cuda")
    if args.dit:
        chip_smoke._perturb_dit(torch, diffusion.denoise_fn)
    diffusion.train(args.train)
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (args.batch_size, diffusion.channels, diffusion.num_frames,
             diffusion.image_size, diffusion.image_size)
    img = torch.randn(shape, generator=g, device="cuda")
    clips = torch.rand(shape, generator=g, device="cuda")
    optimizer = torch.optim.Adam([p for p in diffusion.parameters() if p.requires_grad], lr=1e-4, foreach=True)

    def step(i: int):
        if args.train:
            optimizer.zero_grad(set_to_none=True)
            diffusion(clips, generator=g).backward()
            return optimizer.step()
        t = torch.full((args.batch_size,), diffusion.num_timesteps - 1 - i, dtype=torch.long, device="cuda")
        return diffusion.p_sample(img, t, generator=g)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        step(i)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    annotations = [e for e in cuda if getattr(e, "is_user_annotation", False)]
    events = [e for e in cuda if not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "config": f"dit {args.dit}" if args.dit else Path(args.config).name,
        "reference_compat": not args.fixed,
        "mode": "train" if args.train else "sample",
        "batch_size": args.batch_size,
        "steps": args.steps,
        "wall_ms_per_step": plain_wall * 1e3 / args.steps,
        "profiled_wall_ms_per_step": wall * 1e3 / args.steps,
        "device_ms_per_step": device_us / 1e3 / args.steps if events else None,
        "device_busy_share": device_us / 1e6 / plain_wall if events else None,
        "user_annotation_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / args.steps for e in annotations},
        "kernel_launches_per_step": sum(e.count for e in events) / args.steps,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / args.steps,
             "calls_per_step": e.count / args.steps}
            for e in top
        ],
    }
    OUT.mkdir(parents=True, exist_ok=True)
    stem = f"dit_{args.dit}" if args.dit else Path(args.config).stem
    tag = f"{stem}{'_fixed' if args.fixed else ''}_{result['mode']}_b{args.batch_size}"
    if args.trace:
        prof.export_chrome_trace(str(OUT / f"trace_{tag}.json"))
    (OUT / f"result_{tag}.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
