#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, through its kernels, and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card. It
imports nothing of JAX and nothing of the JAX package. Phases, each ending
in one summary line (``PHASE <name>: ...``):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel, compiled from csrc/ in parallel;
3. kernels: each kernel against its plain PyTorch version at every shape the
   flagship Unet3D gives it (batch 2), in bf16 and f32, TF32 off; CUDA-event
   times of the kernel and of the plain version;
4. unet: the flagship-width Unet3D (configs/config_bouncing_digits.yaml,
   seeded random weights) in bf16 with the kernels, against the same
   weights through the plain modules (fused flags off);
5. sample: ``video_diffusion_nnx_tpu_torch.sample.main`` with that config and
   a checkpoint file written by ``convert.py``: DDIM-50 at batch 4 and
   DDPM over the config's 1000 steps at batch 2; GIFs checked; every kernel
   launch counted over this phase alone;
6. backward: each backward kernel against its plain version at every shape
   the flagship training step (batch 8) gives it, and at one wide-frame
   shape, in bf16 and f32, TF32 off; CUDA-event times and per-step totals;
   at the same inputs the forward kernels and the context kernel's softmax
   statistics against their plain versions;
7. grads: one ``p_losses`` and ``backward`` of the flagship Unet3D in bf16
   (batch 8) with the kernels, against the plain modules, both against f32;
   controls: the same checks catch an attention backward that is off;
8. train: ``video_diffusion_nnx_tpu_torch.train.main`` on the flagship
   config with a seeded synthetic dataset, 30 steps at batch 8: the loss
   falls, checkpoints are written, a resume from the middle one continues,
   every kernel's launches per step are exact; seconds per step (checkpoint
   writes left out) and peak memory; the same steps through the plain
   modules (fused flags off), whose losses agree step by step; the trained
   checkpoint samples through the sampling CLI (DDIM-10);
9. blockwise: both blockwise (online-softmax) temporal kernels against their
   plain versions at every shape the long-clip Unet3D gives them (batch 1,
   128 frames), at the 256-long bottleneck shape of a 128x128 input and at
   two ragged lengths (65, 100), in bf16 and f32, TF32 off; in f32 also
   against the dense plain versions; CUDA-event times;
10. long unet: the configs/config_long_clip.yaml Unet3D (full width and
    depth, batch 1, 128 frames, bf16, seeded weights) forward with kernels
    against the plain modules;
11. long grads: one ``p_losses`` and ``backward`` of it with ``remat_blocks``
    on against off (same launch counts, gradients equal), against the plain
    modules and f32;
12. long train: ``train.main`` on the long-clip recipe with a seeded
    synthetic 128-frame dataset, 12 steps at batch 1: the loss falls, exact
    launches per step, seconds per step, peak memory with ``remat_blocks``
    on and off, the plain-modules control; then ``sample.main`` from the
    trained checkpoint, DDIM-50 at batch 1, a 128-frame GIF checked;
13. kernels line: one JSON object per kernel (launches over its train
    phase, error, times, bound).

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before it. Outputs go to chiprun_out/chip_smoke/ (small) and
build/chip_smoke/ (checkpoints and data).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "config_bouncing_digits.yaml"
OUT = REPO / "chiprun_out" / "chip_smoke"
SCRATCH = REPO / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and the bf16 tensor-core rate.
# Times and bounds are taken in bf16, the main path's type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

TOL = {"bfloat16": 0.05, "float32": 1e-4}
# Backward kernels against their plain versions: max-abs error over the largest magnitude of
# each output (sums run in another order; in bf16 an intermediate may round one ulp apart).
BWD_TOL = {"bfloat16": 0.02, "float32": 1e-5}
HEADS, DIM_HEAD = 8, 32
B = 2  # the kernel phase's batch
B_TRAIN = 8  # the flagship training batch
TRAIN_STEPS, CKPT_EVERY = 30, 10
# Unet gradients, relative norms: per tensor (kernels vs plain modules), the margin over 1.5x the plain
# route's distance to f32 (whole gradient), and the floor of a denominator (share of the whole norm).
GRAD_TOL, GRAD_MARGIN, GRAD_FLOOR = 0.03, 0.005, 1e-3
# Controls of those checks: the kernel route with the attention branches' share of dx off by each of
# these fractions. The largest must fail them.
CONTROL_FAULTS = (0.01, 0.03, 0.1)
LOSS_TOL = 0.02  # train phase: each step's loss, kernel route against plain modules, relative

# (per-forward count, (b, s, f, c)) of every temporal-attention call of the flagship Unet3D.
TEMPORAL_SHAPES = [
    (3, (B, 4096, 10, 32)),   # init block, down 0, up 3
    (1, (B, 1024, 10, 64)),   # down 1
    (1, (B, 256, 10, 128)),   # down 2
    (2, (B, 64, 10, 256)),    # down 3, mid temporal
    (1, (B, 10, 64, 256)),    # mid spatial: 8x8 = 64 tokens attended, frames folded into batch
    (1, (B, 64, 10, 128)),    # up 0
    (1, (B, 256, 10, 64)),    # up 1
    (1, (B, 1024, 10, 32)),   # up 2
]
# (per-forward count, (b, f, h, w, c)) of every spatial linear-attention call.
SLA_SHAPES = [
    (2, (B, 10, 64, 64, 32)),  # down 0, up 3 (the TPU's two-pass route)
    (1, (B, 10, 32, 32, 64)),  # down 1
    (1, (B, 10, 16, 16, 128)), # down 2
    (1, (B, 10, 8, 8, 256)),   # down 3
    (1, (B, 10, 8, 8, 128)),   # up 0
    (1, (B, 10, 16, 16, 64)),  # up 1
    (1, (B, 10, 32, 32, 32)),  # up 2
]
PER_FORWARD = {"temporal_attention_fwd": 11, "sla_context": 8, "sla_out": 8}
PER_STEP = {**PER_FORWARD, "temporal_attention_bwd": 11, "sla_bwd_q": 8, "sla_bwd_kv": 8}
WIDE_SLA_SHAPE = (1, 10, 64, 64, 128)  # a frame the TPU's whole-frame backward cannot hold
KERNELS = {
    "temporal_attention_fwd": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/temporal_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:111",
    },
    "sla_context": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/spatial_linear_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/spatial_linear_attention.py:166 (and :37)",
    },
    "sla_out": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/spatial_linear_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/spatial_linear_attention.py:203 (and :37)",
    },
    "temporal_attention_bwd": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/temporal_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:175",
    },
    "sla_bwd_q": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/spatial_linear_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/spatial_linear_attention.py:450",
    },
    "sla_bwd_kv": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/spatial_linear_attention.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/spatial_linear_attention.py:534 (and :246, :610, :670)",
    },
}
BWD_KERNELS = ("temporal_attention_bwd", "sla_bwd_q", "sla_bwd_kv")

# The long-clip recipe: 128 frames of 64x64 at batch 1. (per-forward count, (b, s, f, c)) of every
# temporal attention over the frames; the bottleneck's spatial attention, (1, 128, 64, 256), attends 64
# tokens and stays on the dense kernels.
LONG_CONFIG = REPO / "configs" / "config_long_clip.yaml"
LONG_TEMPORAL_SHAPES = [
    (3, (1, 4096, 128, 32)),   # init block, down 0, up 3
    (1, (1, 1024, 128, 64)),   # down 1
    (1, (1, 256, 128, 128)),   # down 2
    (2, (1, 64, 128, 256)),    # down 3, mid temporal
    (1, (1, 64, 128, 128)),    # up 0
    (1, (1, 256, 128, 64)),    # up 1
    (1, (1, 1024, 128, 32)),   # up 2
]
# Off the main path: the bottleneck spatial attention of a 128x128 input (16x16 = 256 tokens attended,
# 16 frames as columns) and two ragged lengths.
EXTRA_BLOCKWISE_SHAPES = [(0, (1, 16, 256, 256)), (0, (1, 64, 65, 64)), (0, (1, 64, 100, 32))]
LONG_PER_STEP = {"temporal_blockwise_fwd": 10, "temporal_blockwise_bwd": 10, "temporal_attention_fwd": 1,
                 "temporal_attention_bwd": 1, "sla_context": 8, "sla_out": 8, "sla_bwd_q": 8, "sla_bwd_kv": 8}
LONG_STEPS, LONG_CKPT_EVERY, LONG_CLIPS = 12, 6, 32
REMAT_TOL = 1e-3  # gradients with remat_blocks on against off, relative norm per tensor
KERNELS.update({
    "temporal_blockwise_fwd": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:405",
    },
    "temporal_blockwise_bwd": {
        "source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
        "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:432",
    },
})


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str, **fields) -> None:
    print(f"PHASE {title}: " + json.dumps(fields, default=str), flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``iters`` launches after a warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def new_totals(names) -> dict:
    """Per kernel: the largest error and the times summed over a forward or a step's launches."""
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
            for k in names}


def add_timing(row: dict, total: dict, count: int, err: float, ms: float, plain_ms: float, nbytes: float,
               flops: float) -> None:
    """Write a timed check's times and bound into its ``row`` and add ``count`` launches of it to ``total``."""
    b, by = bound_ms(nbytes, flops)
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, bytes=nbytes, flops=flops)
    if count:
        total["err"] = max(total["err"], err)
        total["ms"] += count * ms
        total["plain_ms"] += count * plain_ms
        total["bound_ms"] += count * b
        total["t_bytes"] += count * nbytes / PEAK_BYTES_PER_S * 1e3
        total["t_ops"] += count * flops / PEAK_BF16_FLOPS * 1e3


def rand(torch, shape, seed: int, scale: float, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def kernel_phase(torch, ta, sla) -> dict:
    """Every kernel against its plain version at every slice shape; times in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    rows, agg = [], new_totals(PER_FORWARD)

    def record(name, shape, dtype, err, count, ms=None, plain_ms=None, nbytes=0.0, flops=0.0):
        check(math.isfinite(err) and err <= TOL[dtype],
              f"{name} at {shape} in {dtype}: max-abs error {err} over tolerance {TOL[dtype]}")
        row = {"kernel": name, "shape": shape, "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype],
               "per_forward": count}
        if ms is not None:
            add_timing(row, agg[name], count, err, ms, plain_ms, nbytes, flops)
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        timed = dtype_name == "bfloat16"
        elt = 2 if timed else 4
        for count, shape in TEMPORAL_SHAPES:
            b, s, f, c = shape
            x = rand(torch, shape, 1, 0.5, dtype)
            wqkv = rand(torch, (c, 3 * hd), 2, c ** -0.5, dtype)
            bqkv = rand(torch, (3 * hd,), 3, 0.1, torch.float32)
            wo = rand(torch, (hd, c), 4, hd ** -0.5, dtype)
            bo = rand(torch, (c,), 5, 0.1, torch.float32)
            args = (x, wqkv, bqkv, wo, bo, HEADS, DIM_HEAD)
            got = ta.fused_temporal_attention_block(*args)
            want = ta.temporal_attention_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if timed:
                tokens = b * s
                nbytes = elt * (2 * tokens * f * c + 3 * c * hd + hd * c) + 4 * (3 * hd + c)
                flops = 2 * tokens * f * (c * 3 * hd + hd * c) + 4 * tokens * HEADS * f * f * DIM_HEAD
                ms = cuda_ms(torch, lambda: ta.fused_temporal_attention_block(*args), 20)
                plain = cuda_ms(torch, lambda: ta.temporal_attention_plain(*args), 10)
                record("temporal_attention_fwd", shape, dtype_name, err, count, ms, plain, nbytes, flops)
            else:
                record("temporal_attention_fwd", shape, dtype_name, err, count)

        for count, shape in SLA_SHAPES:
            b, f, hh, ww, c = shape
            frames, n = b * f, hh * ww
            x = rand(torch, (frames, n, c), 6, 0.5, dtype)
            wqkv = rand(torch, (c, 3 * hd), 7, c ** -0.5, dtype)
            wo = rand(torch, (hd, c), 8, hd ** -0.5, dtype)
            ctx, _ = sla.sla_context(x, wqkv, HEADS, DIM_HEAD)
            ctx_plain = sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD)
            out = sla.sla_out(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0)
            out_plain = sla.sla_out_plain(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0)
            block = sla.sla_out(x, wqkv, wo, ctx, HEADS, DIM_HEAD, 1.0)
            torch.cuda.synchronize()
            err_ctx = (ctx - ctx_plain).abs().max().item()
            err_out = (out.float() - out_plain.float()).abs().max().item()
            err_block = (block.float() - out_plain.float()).abs().max().item()
            check(err_block <= TOL[dtype_name],
                  f"spatial block (context + output kernels) at {shape} in {dtype_name}: {err_block}")
            if timed:
                ctx_bytes = elt * (frames * n * c + 2 * c * hd) + 4 * frames * HEADS * DIM_HEAD ** 2
                ctx_flops = 2 * frames * n * (2 * c * hd + HEADS * DIM_HEAD ** 2)
                out_bytes = elt * (2 * frames * n * c + 2 * c * hd) + 4 * frames * HEADS * DIM_HEAD ** 2
                out_flops = 2 * frames * n * (2 * c * hd + HEADS * DIM_HEAD ** 2)
                ms_c = cuda_ms(torch, lambda: sla.sla_context(x, wqkv, HEADS, DIM_HEAD), 20)
                pl_c = cuda_ms(torch, lambda: sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD), 10)
                ms_o = cuda_ms(torch, lambda: sla.sla_out(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0), 20)
                pl_o = cuda_ms(torch, lambda: sla.sla_out_plain(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0), 10)
                record("sla_context", shape, dtype_name, err_ctx, count, ms_c, pl_c, ctx_bytes, ctx_flops)
                record("sla_out", shape, dtype_name, err_out, count, ms_o, pl_o, out_bytes, out_flops)
            else:
                record("sla_context", shape, dtype_name, err_ctx, count)
                record("sla_out", shape, dtype_name, err_out, count)
    return {"rows": rows, "per_forward": agg}


def unet_phase(torch, load_config, build_models, config_path: Path = CONFIG, batch: int = B) -> dict:
    """A recipe's full-width Unet3D in bf16: kernels against the plain modules (and both against f32)."""
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    config = load_config(config_path)
    kernels, _ = build_models(config, device="cuda")
    u = {k: v for k, v in config["unet"].items()
         if k not in ("arch", "rngs_seed", "depth", "patch_size", "mlp_ratio")}
    u["dim_mults"] = tuple(u["dim_mults"])
    plain = Unet3D(**{**u, "use_fused_attention": False, "use_fused_spatial_attention": False}).cuda()
    plain.load_state_dict(kernels.state_dict())
    ref32 = Unet3D(**{**u, "compute_dtype": None, "use_fused_attention": False,
                      "use_fused_spatial_attention": False}).cuda()
    ref32.load_state_dict(kernels.state_dict())
    d = config["diffusion"]
    x = rand(torch, (batch, d["channels"], d["num_frames"], d["image_size"], d["image_size"]), 11, 1.0,
             torch.float32)
    t = torch.linspace(10, 500, batch, device="cuda").long()
    with torch.no_grad():
        y_k, y_p, y_32 = kernels(x, t), plain(x, t), ref32(x, t)
    torch.cuda.synchronize()
    check(tuple(y_k.shape) == (batch, d["num_frames"], d["image_size"], d["image_size"], d["channels"]),
          f"unet output shape {tuple(y_k.shape)}")
    check(y_k.dtype == torch.float32 and bool(torch.isfinite(y_k).all()), "unet output not finite f32")
    scale = y_32.abs().max().item()
    diff = (y_k - y_p).abs().max().item()
    err_k = (y_k - y_32).abs().max().item()
    err_p = (y_p - y_32).abs().max().item()
    # bf16 tolerance: the kernel route may differ from the plain-module route by at most 10% of
    # the output's range, and may sit no further from the f32 reference than 1.5x the plain
    # bf16 route's own distance plus 1% of the range (it adds no error beyond bf16's own).
    tol = 0.1 * scale
    check(diff <= tol, f"unet kernels vs plain modules (bf16): {diff} > {tol}")
    check(err_k <= 1.5 * err_p + 0.01 * scale,
          f"unet kernel route is {err_k} from f32, plain bf16 route {err_p}")
    with torch.no_grad():
        fwd_k = cuda_ms(torch, lambda: kernels(x, t), 5)
        fwd_p = cuda_ms(torch, lambda: plain(x, t), 5)
    return {"max_abs_diff": diff, "tol": tol, "max_abs_ref": scale, "kernels_vs_f32": err_k,
            "plain_vs_f32": err_p, "fwd_ms_kernels": fwd_k, "fwd_ms_plain": fwd_p}


def sample_phase(torch, ops, load_config, build_models, save_checkpoint, sample) -> dict:
    from PIL import Image

    config = load_config(CONFIG)
    _, diffusion = build_models(config, device="cuda")
    ckpt = save_checkpoint(SCRATCH / "ckpt.pt", diffusion)
    del diffusion
    frames, size = config["diffusion"]["num_frames"], config["diffusion"]["image_size"]
    runs = {}
    ops.reset_launch_counts()
    for name, batch, flags in (("ddim50_b4", 4, ["--sampler", "ddim", "--num-steps", "50"]),
                               ("ddpm1000_b2", 2, ["--sampler", "ddpm"])):
        out_dir = OUT / "gifs" / name
        torch.cuda.reset_peak_memory_stats()
        res = sample.main(["--config", str(CONFIG), "--checkpoint-path", str(ckpt),
                           "--output-path", str(out_dir), "--batch-size", str(batch),
                           "--seed", "0", "--device", "cuda", *flags])
        videos = res["videos"]
        check(tuple(videos.shape) == (batch, 1, frames, size, size), f"{name}: shape {tuple(videos.shape)}")
        check(bool(torch.isfinite(videos).all()), f"{name}: non-finite samples")
        check(len(res["paths"]) == batch, f"{name}: {len(res['paths'])} GIFs for batch {batch}")
        for p in res["paths"]:
            img = Image.open(p)
            check(img.n_frames == frames and img.size == (size, size),
                  f"{p.name}: {img.n_frames} frames of {img.size}")
        runs[name] = {"steps": res["steps"], "seconds": res["seconds"],
                      "seconds_per_step": res["seconds"] / res["steps"],
                      "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}
    counts = ops.launch_counts()
    forwards = sum(r["steps"] for r in runs.values())
    for name, per in PER_FORWARD.items():
        check(counts[name] > 0, f"kernel {name} was never launched on the main path")
        check(counts[name] == per * forwards,
              f"kernel {name}: {counts[name]} launches, expected {per} x {forwards} forwards")
    return {"runs": runs, "launches": counts, "forwards": forwards}


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-12)).item()


def _max_abs(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def backward_phase(torch, ta, sla) -> dict:
    """Every backward kernel against its plain version at every shape of the training step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    rows, agg = [], new_totals(BWD_KERNELS)
    fwd_err = {k: 0.0 for k in PER_FORWARD}  # the forward kernels at the training batch

    def record_fwd(name, shape, dtype, err, tol, what="max-abs"):
        check(math.isfinite(err) and err <= tol, f"{name} at {shape} in {dtype}: {what} error {err} over {tol}")
        if what == "max-abs":
            fwd_err[name] = max(fwd_err[name], err)
        row = {"kernel": name, "shape": shape, "dtype": dtype, "what": what, "err": err, "tol": tol}
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    def record(name, shape, dtype, outs, count, ms=None, plain_ms=None, nbytes=0.0, flops=0.0):
        rel = {k: _rel_err(a, w) for k, (a, w) in outs.items()}
        err = max(_max_abs(a, w) for a, w in outs.values())
        for k, r in rel.items():
            check(math.isfinite(r) and r <= BWD_TOL[dtype],
                  f"{name} {k} at {shape} in {dtype}: error {r} of its largest value, over {BWD_TOL[dtype]}")
        row = {"kernel": name, "shape": shape, "dtype": dtype, "rel_err": rel, "max_abs_err": err,
               "tol": BWD_TOL[dtype], "per_step": count}
        if ms is not None:
            add_timing(row, agg[name], count, err, ms, plain_ms, nbytes, flops)
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        timed = dtype_name == "bfloat16"
        elt = 2 if timed else 4
        for count, shape in TEMPORAL_SHAPES:
            b, s, f, c = (B_TRAIN, *shape[1:])
            x = rand(torch, (b, s, f, c), 1, 0.5, dtype)
            g = rand(torch, (b, s, f, c), 9, 0.1, dtype)
            wqkv = rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32)
            bqkv = rand(torch, (3 * hd,), 3, 0.1, torch.float32)
            wo = rand(torch, (hd, c), 4, hd ** -0.5, torch.float32)
            bo = rand(torch, (c,), 5, 0.1, torch.float32)
            fwd_args = (x, wqkv, bqkv, wo, bo, HEADS, DIM_HEAD)
            y = ta.fused_temporal_attention_block(*fwd_args)
            record_fwd("temporal_attention_fwd", (b, s, f, c), dtype_name,
                       _max_abs(y, ta.temporal_attention_plain(*fwd_args)), TOL[dtype_name])
            del y
            args = (x, g, wqkv, bqkv, wo, bo, HEADS, DIM_HEAD)
            got = ta.temporal_attention_bwd(*args)
            want = ta.temporal_attention_bwd_plain(*args)
            torch.cuda.synchronize()
            outs = dict(zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), zip(got, want)))
            if timed:
                rows_n = b * s * f
                nbytes = elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
                flops = rows_n * (22 * c * hd + 12 * f * hd)
                ms = cuda_ms(torch, lambda: ta.temporal_attention_bwd(*args), 5, 1)
                plain = cuda_ms(torch, lambda: ta.temporal_attention_bwd_plain(*args), 5, 1)
                record("temporal_attention_bwd", (b, s, f, c), dtype_name, outs, count, ms, plain, nbytes, flops)
            else:
                record("temporal_attention_bwd", (b, s, f, c), dtype_name, outs, count)
            del x, g, got, want, outs

        for count, shape in [*SLA_SHAPES, (0, WIDE_SLA_SHAPE)]:
            b, f, hh, ww, c = (B_TRAIN, *shape[1:]) if count else shape
            frames, n = b * f, hh * ww
            x = rand(torch, (frames, n, c), 6, 0.5, dtype)
            g = rand(torch, (frames, n, c), 10, 0.1, dtype)
            wqkv = rand(torch, (c, 3 * hd), 7, c ** -0.5, torch.float32)
            wo = rand(torch, (hd, c), 8, hd ** -0.5, torch.float32)
            ctx, stats = sla.sla_context(x, wqkv, HEADS, DIM_HEAD)
            shape_r = (b, f, hh, ww, c)
            record_fwd("sla_context", shape_r, dtype_name,
                       _max_abs(ctx, sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD)), TOL[dtype_name])
            for k, got_s, want_s in zip(("max", "sum"), stats, sla.sla_stats_plain(x, wqkv, HEADS, DIM_HEAD)):
                record_fwd("sla_context", shape_r, dtype_name, _rel_err(got_s, want_s), BWD_TOL[dtype_name],
                           f"softmax {k}, of its largest value")
            ctx_plain = sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD)
            record_fwd("sla_out", shape_r, dtype_name,
                       _max_abs(sla.sla_out(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0),
                                sla.sla_out_plain(x, wqkv, wo, ctx_plain, HEADS, DIM_HEAD, 1.0)), TOL[dtype_name])
            del ctx_plain
            q_args = (x, g, wqkv, wo, ctx, HEADS, DIM_HEAD, 1.0)
            got_q = sla.sla_bwd_q(*q_args)
            want_q = sla.sla_bwd_q_plain(*q_args)
            kv_args = (x, wqkv, got_q[1], got_q[0])
            got_kv = sla.sla_bwd_kv(*kv_args, stats, HEADS, DIM_HEAD)
            want_kv = sla.sla_bwd_kv_plain(*kv_args, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            outs_q = dict(zip(("dx_q", "dctx", "dwq", "dwo"), zip(got_q, want_q)))
            outs_kv = dict(zip(("dx", "dwk", "dwv"), zip(got_kv, want_kv)))
            if timed:
                rows_n = frames * n
                ctx_b = 4 * frames * HEADS * DIM_HEAD ** 2
                q_bytes = elt * (3 * rows_n * c + 2 * c * hd) + 2 * ctx_b + 4 * 2 * c * hd
                q_flops = rows_n * (10 * c * hd + 6 * DIM_HEAD * hd)
                kv_bytes = elt * (3 * rows_n * c + 2 * c * hd) + ctx_b + 4 * 2 * frames * hd + 4 * 2 * c * hd
                kv_flops = rows_n * (12 * c * hd + 4 * DIM_HEAD * hd)
                ms_q = cuda_ms(torch, lambda: sla.sla_bwd_q(*q_args), 5, 1)
                pl_q = cuda_ms(torch, lambda: sla.sla_bwd_q_plain(*q_args), 5, 1)
                ms_kv = cuda_ms(torch, lambda: sla.sla_bwd_kv(*kv_args, stats, HEADS, DIM_HEAD), 5, 1)
                pl_kv = cuda_ms(torch, lambda: sla.sla_bwd_kv_plain(*kv_args, HEADS, DIM_HEAD), 5, 1)
                record("sla_bwd_q", shape_r, dtype_name, outs_q, count, ms_q, pl_q, q_bytes, q_flops)
                record("sla_bwd_kv", shape_r, dtype_name, outs_kv, count, ms_kv, pl_kv, kv_bytes, kv_flops)
            else:
                record("sla_bwd_q", shape_r, dtype_name, outs_q, count)
                record("sla_bwd_kv", shape_r, dtype_name, outs_kv, count)
            del x, g, got_q, want_q, got_kv, want_kv, outs_q, outs_kv
    return {"rows": rows, "per_step": agg, "fwd_err": fwd_err}


def blockwise_phase(torch, ta) -> dict:
    """Both blockwise temporal kernels against their plain versions at every long-clip shape; times in bf16.

    In f32 each is also held to the dense plain version (forward) and the dense backward oracle, so
    that the blockwise plain versions cannot drift away from the function together with the kernels.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    names = ("temporal_blockwise_fwd", "temporal_blockwise_bwd")
    rows, agg = [], new_totals(names)
    grad_names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")

    def record(name, shape, dtype, count, row, err, ms=None, plain_ms=None, nbytes=0.0, flops=0.0):
        row = {"kernel": name, "shape": shape, "dtype": dtype, "per_step": count, **row}
        if ms is not None:
            add_timing(row, agg[name], count, err, ms, plain_ms, nbytes, flops)
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        timed = dtype_name == "bfloat16"
        elt = 2 if timed else 4
        for count, shape in [*LONG_TEMPORAL_SHAPES, *EXTRA_BLOCKWISE_SHAPES]:
            b, s, f, c = shape
            kb = ta.KV_BLOCK
            x = rand(torch, shape, 1, 0.5, dtype)
            g = rand(torch, shape, 9, 0.1, dtype)
            w = (rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32), rand(torch, (3 * hd,), 3, 0.1, torch.float32),
                 rand(torch, (hd, c), 4, hd ** -0.5, torch.float32), rand(torch, (c,), 5, 0.1, torch.float32))
            before = dict(ta.launches)
            got = ta.fused_temporal_attention_block(x, *w, HEADS, DIM_HEAD)
            grads = ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            check(all(ta.launches[k] == before[k] + 1 for k in names)
                  and ta.launches["temporal_attention_fwd"] == before["temporal_attention_fwd"],
                  f"f = {f} did not take the blockwise kernels: {ta.launches}")
            err = _max_abs(got, ta.temporal_attention_blockwise_plain(x, *w, HEADS, DIM_HEAD, kb))
            check(math.isfinite(err) and err <= TOL[dtype_name],
                  f"temporal_blockwise_fwd at {shape} in {dtype_name}: max-abs error {err} over {TOL[dtype_name]}")
            want = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, HEADS, DIM_HEAD, kb)
            rel = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want)}
            err_b = max(_max_abs(a, v) for a, v in zip(grads, want))
            for k, r in rel.items():
                check(math.isfinite(r) and r <= BWD_TOL[dtype_name],
                      f"temporal_blockwise_bwd {k} at {shape} in {dtype_name}: error {r} of its largest value, "
                      f"over {BWD_TOL[dtype_name]}")
            del want
            fwd_row = {"kv_block": kb, "max_abs_err": err, "tol": TOL[dtype_name]}
            bwd_row = {"kv_block": kb, "rel_err": rel, "max_abs_err": err_b, "tol": BWD_TOL[dtype_name]}
            if not timed:
                dense = _max_abs(got, ta.temporal_attention_plain(x, *w, HEADS, DIM_HEAD))
                check(dense <= TOL[dtype_name], f"temporal_blockwise_fwd at {shape} against the dense plain version: {dense}")
                want_d = ta.temporal_attention_bwd_plain(x, g, *w, HEADS, DIM_HEAD)
                rel_d = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want_d)}
                check(max(rel_d.values()) <= BWD_TOL[dtype_name],
                      f"temporal_blockwise_bwd at {shape} against the dense backward oracle: {rel_d}")
                del want_d
                fwd_row["vs_dense_plain"] = dense
                bwd_row["vs_dense_oracle"] = rel_d
                record(names[0], shape, dtype_name, count, fwd_row, err)
                record(names[1], shape, dtype_name, count, bwd_row, err_b)
            else:
                rows_n = b * s * f
                f_bytes = elt * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c)
                f_flops = rows_n * (8 * c * hd + 4 * f * hd)
                b_bytes = elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
                b_flops = rows_n * (22 * c * hd + 12 * f * hd)  # the function's count, as the dense backward's
                ms_f = cuda_ms(torch, lambda: ta.fused_temporal_attention_block(x, *w, HEADS, DIM_HEAD), 5, 1)
                pl_f = cuda_ms(torch, lambda: ta.temporal_attention_blockwise_plain(x, *w, HEADS, DIM_HEAD, kb), 3, 1)
                ms_b = cuda_ms(torch, lambda: ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD), 3, 1)
                pl_b = cuda_ms(torch, lambda: ta.temporal_attention_blockwise_bwd_plain(x, g, *w, HEADS, DIM_HEAD, kb), 3, 1)
                record(names[0], shape, dtype_name, count, fwd_row, err, ms_f, pl_f, f_bytes, f_flops)
                record(names[1], shape, dtype_name, count, bwd_row, err_b, ms_b, pl_b, b_bytes, b_flops)
            del x, g, got, grads
    return {"rows": rows, "per_step": agg}


PLAIN_MODULES = {"use_fused_attention": False, "use_fused_spatial_attention": False}
UNET_VARIANTS = {"plain": PLAIN_MODULES, "f32": {"compute_dtype": None, **PLAIN_MODULES}}


def _unet_variants(torch, config, kernels, variants: dict = UNET_VARIANTS):
    """``kernels``' diffusion model rebuilt with each variant's Unet3D options, on the same weights."""
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    u = {k: v for k, v in config["unet"].items()
         if k not in ("arch", "rngs_seed", "depth", "patch_size", "mlp_ratio")}
    u["dim_mults"] = tuple(u["dim_mults"])
    d = config["diffusion"]
    out = {}
    for name, extra in variants.items():
        net = Unet3D(**{**u, **extra})
        diff = GaussianDiffusion(net, **{k: d[k] for k in d}).to(kernels.device)
        diff.load_state_dict(kernels.state_dict())
        out[name] = diff
    return out


def _faulty_backward(ta, sla, eps: float):
    """Backward wrappers whose dx carries the attention branch's share ``dx - g`` off by ``eps``."""
    t_bwd, q_bwd = ta.temporal_attention_bwd, sla.sla_bwd_q

    def off(dx, g):
        return (dx.float() + eps * (dx.float() - g.float())).to(dx.dtype)

    def temporal(x, g, *rest):
        dx, *others = t_bwd(x, g, *rest)
        return (off(dx, g), *others)

    def spatial_q(xt, g, *rest):
        dxq, *others = q_bwd(xt, g, *rest)
        return (off(dxq, g), *others)

    return temporal, spatial_q


def grads_phase(torch, ops, ta, sla, load_config, build_models, config_path: Path = CONFIG,
                batch: int = B_TRAIN, long_clip: bool = False) -> dict:
    """A recipe's Unet3D gradients in bf16: kernels against plain modules, both against f32.

    The flagship run (batch 8) adds the controls; the long-clip run (batch 1, ``remat_blocks`` on
    in every variant) adds the same Unet with ``remat_blocks`` off, whose gradients and launch counts
    must equal the kernel route's.
    """
    config = load_config(config_path)
    _, kernels = build_models(config, device="cuda")
    variants = {**UNET_VARIANTS, **({"remat_off": {"remat_blocks": False}} if long_clip else {})}
    models = {"kernels": kernels, **_unet_variants(torch, config, kernels, variants)}
    d = config["diffusion"]
    shape = (batch, d["channels"], d["num_frames"], d["image_size"], d["image_size"])
    x = rand(torch, shape, 12, 1.0, torch.float32).sigmoid()
    noise = rand(torch, shape, 13, 1.0, torch.float32)
    t = (torch.linspace(0, d["timesteps"] - 1, batch, device="cuda").long() if batch > 1
         else torch.tensor([d["timesteps"] // 2], device="cuda"))
    grads, losses, ms, peak, launches = {}, {}, {}, {}, {}

    def run(m):
        m.zero_grad(set_to_none=True)
        loss = m(x, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.detach().float().clone() for k, p in m.named_parameters()
                             if p.grad is not None}

    for name, m in models.items():
        m.train()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses[name], grads[name] = run(m)
        peak[name], launches[name] = torch.cuda.max_memory_allocated(), ops.launch_counts()

        def step(m=m):
            m.zero_grad(set_to_none=True)
            m(x, t=t, noise=noise).backward()

        ms[name] = cuda_ms(torch, step, 3, 1)
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    check(set(grads["kernels"]) == set(grads["plain"]) == set(grads["f32"]),
          "the routes give gradients to different parameters")

    # Relative norms, with the denominator floored at GRAD_FLOOR of the whole gradient's norm: some
    # tensors' gradients are zero by construction (a key bias shifts every logit of a softmax row
    # alike), and what the routes give there is rounding noise, held to the global scale instead.
    floor = {name: GRAD_FLOOR * torch.sqrt(sum(g.square().sum() for g in grads[name].values())).item()
             for name in grads}

    def rel(a, b, ref):
        return ((a - b).norm() / max(b.norm().item(), floor[ref])).item()

    per = {k: {"k_vs_p": rel(grads["kernels"][k], grads["plain"][k], "plain"),
               "k_vs_f32": rel(grads["kernels"][k], grads["f32"][k], "f32"),
               "p_vs_f32": rel(grads["plain"][k], grads["f32"][k], "f32")} for k in grads["f32"]}
    # Per parameter tensor: the kernel route within GRAD_TOL of the plain bf16 route. Over the whole
    # gradient: the kernel route no further from f32 than 1.5x the plain route plus GRAD_MARGIN
    # (per tensor the two bf16 routes' distances to f32 scatter around each other).
    for k, r in per.items():
        check(r["k_vs_p"] <= GRAD_TOL, f"grad of {k}: kernels vs plain modules {r['k_vs_p']} > {GRAD_TOL}")

    def whole(name):
        num = sum((grads[name][k] - grads["f32"][k]).square().sum() for k in per)
        return torch.sqrt(num).item() / (floor["f32"] / GRAD_FLOOR)

    k_whole, p_whole = whole("kernels"), whole("plain")
    check(k_whole <= 1.5 * p_whole + GRAD_MARGIN,
          f"whole gradient: kernel route {k_whole} from f32, plain route {p_whole}")

    remat = {}
    if long_clip:
        # remat_blocks recomputes the ResNet blocks alone: the attention kernels launch once each way.
        check(launches["kernels"] == LONG_PER_STEP and launches["remat_off"] == LONG_PER_STEP,
              f"launches with remat_blocks on {launches['kernels']} and off {launches['remat_off']}, "
              f"expected {LONG_PER_STEP}")
        worst_r = max(per, key=lambda k: rel(grads["kernels"][k], grads["remat_off"][k], "kernels"))
        remat = {"max_rel": rel(grads["kernels"][worst_r], grads["remat_off"][worst_r], "kernels"),
                 "worst": worst_r, "tol": REMAT_TOL,
                 "bit_equal": all(torch.equal(grads["kernels"][k], grads["remat_off"][k]) for k in per),
                 "loss_on": losses["kernels"], "loss_off": losses["remat_off"]}
        check(remat["max_rel"] <= REMAT_TOL, f"gradients with remat_blocks on and off part: {remat}")

    # Controls: the same checks must catch a kernel route whose attention backward is slightly off.
    controls = {}
    saved = ta.temporal_attention_bwd, sla.sla_bwd_q
    try:
        for eps in (() if long_clip else CONTROL_FAULTS):
            ta.temporal_attention_bwd, sla.sla_bwd_q = _faulty_backward(ta, sla, eps)
            _, grads["control"] = run(models["kernels"])
            c_tensor = max(rel(grads["control"][k], grads["plain"][k], "plain") for k in per)
            c_whole = whole("control")
            controls[eps] = {"max_k_vs_p": c_tensor, "kernels_vs_f32": c_whole,
                             "caught": c_tensor > GRAD_TOL or c_whole > 1.5 * p_whole + GRAD_MARGIN}
    finally:
        ta.temporal_attention_bwd, sla.sla_bwd_q = saved
        grads.pop("control", None)
    check(long_clip or controls[max(CONTROL_FAULTS)]["caught"],
          f"the gradient checks miss the control faults: {controls}")
    worst = max(per, key=lambda k: per[k]["k_vs_p"])
    return {"losses": losses, "fwd_bwd_ms": ms, "peak_memory": peak, "remat": remat, "tensors": len(per),
            "worst": {worst: per[worst]},
            "limits": {"per_tensor": GRAD_TOL, "whole": 1.5 * p_whole + GRAD_MARGIN}, "controls": controls,
            "kernels_vs_f32": k_whole, "plain_vs_f32": p_whole,
            "max_k_vs_p": per[worst]["k_vs_p"], "max_k_vs_f32": max(r["k_vs_f32"] for r in per.values()),
            "max_p_vs_f32": max(r["p_vs_f32"] for r in per.values()), "per_tensor": per}


def bouncing_squares(path: Path, clips: int = 256, frames: int = 10, size: int = 64, seed: int = 0) -> Path:
    """A seeded uint8 dataset (frames, clips, size, size): one bright square bouncing per clip."""
    import numpy as np

    rng = np.random.default_rng(seed)
    side = rng.integers(size // 6, size // 3, clips)
    span = size - side
    p0 = rng.uniform(0, 1, (clips, 2)) * span[:, None]
    v = rng.uniform(2, 5, (clips, 2)) * rng.choice([-1, 1], (clips, 2))
    t = np.arange(frames)[:, None, None]
    raw = p0[None] + v[None] * t  # (frames, clips, 2), reflected into [0, span]
    period = 2 * span[None, :, None]
    pos = np.abs((raw % period + period) % period)
    pos = np.where(pos > span[None, :, None], period - pos, pos).astype(int)
    grid = np.arange(size)
    y0, x0 = pos[..., 0][..., None], pos[..., 1][..., None]
    s = side[None, :, None]
    rows = (grid >= y0) & (grid < y0 + s)
    cols = (grid >= x0) & (grid < x0 + s)
    data = (rows[..., :, None] & cols[..., None, :]).astype(np.uint8) * 255
    np.save(path, data)
    return path


def _train_config(yaml, config: dict, root: Path, data: Path, name: str, unet: dict | None = None,
                  steps: int = TRAIN_STEPS, ckpt_every: int = CKPT_EVERY, **trainer) -> Path:
    """The recipe with its dataset, output folders and length replaced, and the given overrides."""
    cfg = json.loads(json.dumps(config))
    out = root / name
    cfg["trainer"].update(dataset_path=str(data), folder=str(out), results_folder=str(out),
                          tensorboard_dir=str(out / "tensorboard"), train_num_steps=steps,
                          checkpoint_every_steps=ckpt_every, **trainer)
    cfg["unet"].update(unet or {})
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _seconds_per_step(trainer, warmup: int = 5) -> tuple[float, float]:
    """Host seconds per step after ``warmup`` steps, leaving out the checkpoint writes in that window.

    Returns the rate and the seconds of writes left out. A fresh run's loop starts at step 0.
    """
    starts = trainer.step_starts
    saves = sum(v for k, v in trainer.save_seconds.items() if k >= warmup)
    return (starts[-1] - starts[warmup] - saves) / (len(starts) - 1 - warmup), saves


def train_phase(torch, ops, train, sample) -> dict:
    import yaml
    from PIL import Image

    raw = yaml.safe_load(CONFIG.read_text())
    root = SCRATCH / "train"
    root.mkdir(parents=True, exist_ok=True)
    data = bouncing_squares(root / "bouncing_squares.npy")
    fused_cfg = _train_config(yaml, raw, root, data, "kernels")
    plain_cfg = _train_config(yaml, raw, root, data, "plain", unet=PLAIN_MODULES)
    for sub in ("kernels", "plain"):
        for old in (root / sub / "checkpoints").glob("step_*.pt"):
            old.unlink()

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr = train.main(["--config", str(fused_cfg), "--device", "cuda"])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = tr.loss_trace.tolist()
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses), f"losses {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"loss did not fall: first 5 steps {first}, last 5 {last}")
    for name, per in PER_STEP.items():
        check(counts[name] == per * TRAIN_STEPS,
              f"kernel {name}: {counts[name]} launches in {TRAIN_STEPS} steps, expected {per} per step")
    ckpts = sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt"))
    check(ckpts == list(range(CKPT_EVERY, TRAIN_STEPS + 1, CKPT_EVERY)), f"checkpoints at steps {ckpts}")
    sps, save_s = _seconds_per_step(tr)
    ckpt_dir = tr.checkpoint_dir_path
    del tr

    mid = CKPT_EVERY * ((TRAIN_STEPS // CKPT_EVERY + 1) // 2)  # the middle checkpoint
    resumed = train.main(["--config", str(fused_cfg), "--device", "cuda", "--resume_step", str(mid)])
    trace = resumed.loss_trace.tolist()
    r_losses = trace[mid:]
    check(all(math.isnan(v) for v in trace[:mid]), f"resume from {mid} reran earlier steps: {trace}")
    check(all(math.isfinite(v) for v in r_losses) and sum(r_losses) / len(r_losses) < first,
          f"resumed losses {r_losses} are not below the first steps' {first}")
    # The file of step N holds the state after step N's update, and a resume runs step N again
    # (as in the JAX trainer), so the restored optimizer ends one update ahead of the step count.
    check(resumed.opt_count == TRAIN_STEPS + 1, f"resumed optimizer count {resumed.opt_count}")
    del resumed

    torch.cuda.reset_peak_memory_stats()
    plain = train.main(["--config", str(plain_cfg), "--device", "cuda"])
    plain_peak = torch.cuda.max_memory_allocated()
    plain_losses = plain.loss_trace.tolist()
    check(all(math.isfinite(v) for v in plain_losses), f"plain-module losses {plain_losses}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    check(loss_gap <= LOSS_TOL, f"losses of the kernel route and the plain modules part by {loss_gap} "
                                f"(relative, over {LOSS_TOL}): {losses} against {plain_losses}")
    plain_sps, plain_save_s = _seconds_per_step(plain)
    del plain

    out_dir = OUT / "gifs" / "trained_ddim10_b2"
    res = sample.main(["--config", str(fused_cfg), "--checkpoint-path", str(ckpt_dir / f"step_{TRAIN_STEPS}.pt"),
                       "--output-path", str(out_dir), "--batch-size", "2", "--seed", "0", "--device", "cuda",
                       "--sampler", "ddim", "--num-steps", "10", "--load-ema-params"])
    d = raw["diffusion"]
    videos = res["videos"]
    check(tuple(videos.shape) == (2, 1, d["num_frames"], d["image_size"], d["image_size"]),
          f"trained samples: shape {tuple(videos.shape)}")
    check(bool(torch.isfinite(videos).all()), "trained samples: non-finite values")
    for p in res["paths"]:
        img = Image.open(p)
        check(img.n_frames == d["num_frames"] and img.size == (d["image_size"], d["image_size"]),
              f"{p.name}: {img.n_frames} frames of {img.size}")
    return {"steps": TRAIN_STEPS, "batch": B_TRAIN, "losses": losses, "first5": first, "last5": last,
            "launches": counts, "checkpoints": ckpts, "seconds_per_step": sps, "peak_memory": peak,
            "checkpoint_write_seconds": save_s, "plain_checkpoint_write_seconds": plain_save_s,
            "loss_gap_vs_plain": loss_gap,
            "resumed_from": mid, "resumed_losses": r_losses, "plain_losses": plain_losses,
            "plain_seconds_per_step": plain_sps, "plain_peak_memory": plain_peak,
            "sample_seconds": res["seconds"], "gifs": len(res["paths"])}


def long_train_phase(torch, ops, train, sample) -> dict:
    """The long-clip recipe through the CLIs: 12 steps at batch 1 on 128-frame clips, then DDIM-50."""
    import yaml
    from PIL import Image

    raw = yaml.safe_load(LONG_CONFIG.read_text())
    d = raw["diffusion"]
    root = SCRATCH / "long_train"
    root.mkdir(parents=True, exist_ok=True)
    data = bouncing_squares(root / "bouncing_squares_128.npy", clips=LONG_CLIPS, frames=d["num_frames"],
                            size=d["image_size"])
    # The recipe names a folder of GIFs and trains the schedule buffers with the weights; the port's
    # trainer reads .npy clips and keeps the buffers frozen, so the derived recipe says both.
    common = dict(steps=LONG_STEPS, ckpt_every=LONG_CKPT_EVERY, freeze_schedule_buffers=True, log_every_steps=1)
    cfgs = {"kernels": _train_config(yaml, raw, root, data, "kernels", **common),
            "remat_off": _train_config(yaml, raw, root, data, "remat_off", unet={"remat_blocks": False}, **common),
            "plain": _train_config(yaml, raw, root, data, "plain", unet=PLAIN_MODULES, **common)}
    for sub in cfgs:
        for old in (root / sub / "checkpoints").glob("step_*.pt"):
            old.unlink()

    runs = {}
    for name, cfg in cfgs.items():
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = train.main(["--config", str(cfg), "--device", "cuda"])
        counts = ops.launch_counts()
        losses = tr.loss_trace.tolist()
        check(len(losses) == LONG_STEPS and all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
        sps, save_s = _seconds_per_step(tr, warmup=3)
        runs[name] = {"losses": losses, "launches": counts, "seconds_per_step": sps,
                      "checkpoint_write_seconds": save_s, "peak_memory": torch.cuda.max_memory_allocated(),
                      "checkpoints": sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt"))}
        if name == "kernels":
            ckpt_dir = tr.checkpoint_dir_path
            check(tr.model.denoise_fn.remat_blocks and tr.max_grad_norm == raw["trainer"]["max_grad_norm"],
                  "the long-clip trainer lost remat_blocks or max_grad_norm")
        del tr
    k = runs["kernels"]
    first, last = sum(k["losses"][:4]) / 4, sum(k["losses"][-4:]) / 4
    check(last < first, f"long-clip loss did not fall: first 4 steps {first}, last 4 {last}")
    check(k["checkpoints"] == list(range(LONG_CKPT_EVERY, LONG_STEPS + 1, LONG_CKPT_EVERY)),
          f"long-clip checkpoints at steps {k['checkpoints']}")
    for name in ("kernels", "remat_off"):
        for kernel, per in LONG_PER_STEP.items():
            check(runs[name]["launches"][kernel] == per * LONG_STEPS,
                  f"{name}: kernel {kernel} launched {runs[name]['launches'][kernel]} times in {LONG_STEPS} "
                  f"steps, expected {per} per step")
    check(set(runs["plain"]["launches"].values()) == {0}, f"the plain modules launched kernels: {runs['plain']['launches']}")
    gaps = {name: max(abs(a - b) / abs(b) for a, b in zip(k["losses"], runs[name]["losses"]))
            for name in ("remat_off", "plain")}
    check(gaps["plain"] <= LOSS_TOL and gaps["remat_off"] <= LOSS_TOL,
          f"long-clip losses part from the kernel route's by {gaps} (relative, over {LOSS_TOL})")

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out_dir = OUT / "gifs" / "long_clip_ddim50_b1"
    res = sample.main(["--config", str(cfgs["kernels"]), "--checkpoint-path", str(ckpt_dir / f"step_{LONG_STEPS}.pt"),
                       "--output-path", str(out_dir), "--batch-size", "1", "--seed", "0", "--device", "cuda",
                       "--sampler", "ddim", "--num-steps", "50"])
    videos = res["videos"]
    check(tuple(videos.shape) == (1, 1, d["num_frames"], d["image_size"], d["image_size"]),
          f"long-clip samples: shape {tuple(videos.shape)}")
    check(bool(torch.isfinite(videos).all()), "long-clip samples: non-finite values")
    img = Image.open(res["paths"][0])
    check(img.n_frames == d["num_frames"] and img.size == (d["image_size"], d["image_size"]),
          f"{res['paths'][0].name}: {img.n_frames} frames of {img.size}")
    s_counts = ops.launch_counts()
    for kernel, per in LONG_PER_STEP.items():
        check(s_counts[kernel] == (per * res["steps"] if kernel in PER_FORWARD or kernel.endswith("_fwd") else 0),
              f"long-clip sampling: kernel {kernel} launched {s_counts[kernel]} times in {res['steps']} steps")
    return {"steps": LONG_STEPS, "batch": raw["trainer"]["train_batch_size"], "frames": d["num_frames"],
            "first4": first, "last4": last, "runs": runs, "loss_gaps_vs_kernels": gaps,
            "launches": k["launches"],
            "sample": {"steps": res["steps"], "seconds": res["seconds"],
                       "seconds_per_step": res["seconds"] / res["steps"], "launches": s_counts,
                       "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (REPO / "video_diffusion_nnx_tpu_torch" / "csrc").is_dir():
        print("FAIL: the port package is not beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from video_diffusion_nnx_tpu_torch import ops, sample, train
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import save_checkpoint
    from video_diffusion_nnx_tpu_torch.ops import _build
    from video_diffusion_nnx_tpu_torch.ops import spatial_linear_attention as sla
    from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

    OUT.mkdir(parents=True, exist_ok=True)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    phase("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)
    results = {"device": kind, "nvidia_smi": smi}

    def timed(title: str, fn, *args, show=lambda r: r, **kwargs):
        """Run one phase, print its summary line (``show`` picks the fields) and keep its full result."""
        t0 = time.perf_counter()
        results[title] = res = fn(*args, **kwargs)
        phase(title, seconds=time.perf_counter() - t0, **show(res))
        return res

    def per_step(res, key):
        return {key: {k: {m: v[m] for m in ("ms", "plain_ms", "bound_ms", "err")} for k, v in res[key].items()}}

    t0 = time.perf_counter()
    _build.build_all()
    results["build_seconds"] = time.perf_counter() - t0
    (OUT / "build_log.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in _build.build_logs.items()))
    phase("build", seconds=results["build_seconds"], sources=list(_build.SOURCES))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kern = timed("kernels", kernel_phase, torch, ta, sla,
                 show=lambda r: {"tf32": "off (matmul and cudnn)", "checks": len(r["rows"]), "tolerance": TOL})
    timed("unet", unet_phase, torch, load_config, build_models)
    timed("sample", sample_phase, torch, ops, load_config, build_models, save_checkpoint, sample)
    bwd = timed("backward", backward_phase, torch, ta, sla,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": BWD_TOL, **per_step(r, "per_step")})
    timed("grads", grads_phase, torch, ops, ta, sla, load_config, build_models,
          show=lambda r: {k: v for k, v in r.items() if k != "per_tensor"})
    trained = timed("train", train_phase, torch, ops, train, sample)
    blk = timed("blockwise", blockwise_phase, torch, ta,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                **per_step(r, "per_step")})
    timed("long unet", unet_phase, torch, load_config, build_models, config_path=LONG_CONFIG, batch=1)
    timed("long grads", grads_phase, torch, ops, ta, sla, load_config, build_models, config_path=LONG_CONFIG,
          batch=1, long_clip=True, show=lambda r: {k: v for k, v in r.items() if k != "per_tensor"})
    long_trained = timed("long train", long_train_phase, torch, ops, train, sample)

    # Every kernel with the launches of the training path that runs it: the flagship's for the six
    # dense and spatial kernels, the long-clip recipe's for the blockwise pair.
    aggregates, launches = {}, {}
    for name in PER_STEP:
        a = dict((kern["per_forward"] if name in PER_FORWARD else bwd["per_step"])[name])
        if name in PER_FORWARD:
            a["err"] = max(a["err"], bwd["fwd_err"][name])
        aggregates[name], launches[name] = a, trained["launches"][name]
    for name, a in blk["per_step"].items():
        aggregates[name], launches[name] = a, long_trained["launches"][name]
    kernels_line = [{
        "name": name, "route": "cuda", "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
        "launches": launches[name], "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"] else "operations",
        "library_ms": None,
    } for name, a in aggregates.items()]
    results["kernels_line"] = kernels_line
    (OUT / "results.json").write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
