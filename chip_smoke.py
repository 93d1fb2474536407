#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, through its kernels, and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one CUDA card. It
imports nothing of JAX and nothing of the JAX package. Phases, each ending
in one summary line (``PHASE <name>: ...``):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel, compiled from csrc/ in parallel;
3. kernels: each kernel against its plain PyTorch version at every shape the
   flagship Unet3D gives it (batch 2; the spatial pair also at the training
   batch 8), in bf16 and f32, TF32 off; the spatial pair also relative to
   each output's largest value (the contexts, and the attention term
   out - x at contexts scaled by ``CTX_GAIN``); CUDA-event times of the
   kernel and of the plain version (bf16; the spatial pair in f32 too, what
   fixed math hands it);
4. unet: the flagship-width Unet3D (configs/config_bouncing_digits.yaml,
   seeded random weights) in bf16 with the kernels, against the same
   weights through the plain modules (fused flags off);
5. sample: ``video_diffusion_nnx_tpu_torch.sample.main`` with that config and
   a checkpoint file written by ``convert.py``: DDIM-50 at batch 4 and
   DDPM over the config's 1000 steps at batch 2; GIFs checked; every kernel
   launch counted over this phase alone, and every launch of the spatial
   forward pair must have run its staged kernel (so in phases 8, 12 and 16);
6. backward: each backward kernel against its plain version at every shape
   the flagship training step (batch 8) gives it, and at one wide-frame
   shape, in bf16 and f32, TF32 off; CUDA-event times, each timed row's share
   of its bound (``bound_share``) and per-step totals (``sla_bwd_kv`` also in
   f32, what fixed math hands it); at the same inputs the forward kernels and
   the context kernel's softmax statistics against their plain versions, and
   the dense temporal forward's bf16 times per training step;
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
8b. digits: the flagship eval (``eval_bouncing_digits.evaluate``) on that
   run's step-30 checkpoint, with 64 train and 16 holdout clips of real
   handwritten digits from the port's generator (``data/bouncing_digits.py``)
   at the recipe's shape: 8 eval clips, reconstructions at T/8, T/4, T/2 for
   the trained and the untrained model, DDIM-50 at batch 8, no DDPM; every
   stat finite, the GIFs written, exact forward launches, all staged. The
   eval's quality claims need the full 20000-step run and are not applied;
9. blockwise: both blockwise (online-softmax) temporal kernels against their
   plain versions at every shape the long-clip Unet3D gives them (batch 1,
   128 frames), at the 256-long bottleneck shape of a 128x128 input and at
   two ragged lengths (65, 100), in bf16 and f32, TF32 off; in f32 also
   against the dense plain versions; every long-clip shape must run the
   streaming kernels (as the C entries report); CUDA-event times;
9b. long sla: both spatial kernels at the long clip's eight calls (batch 1, 128
    frames, bf16 and f32) against their plain versions, as in phase 3; the
    spatial forward's time per step in each type;
10. long unet: the configs/config_long_clip.yaml Unet3D (full width and
    depth, batch 1, 128 frames, bf16, seeded weights) forward with kernels
    against the plain modules;
11. long grads: one ``p_losses`` and ``backward`` of it with ``remat_blocks``
    on against off (same launch counts, gradients equal), against the plain
    modules and f32;
12. long train: ``train.main`` on configs/config_long_clip.yaml as the file
    has it (full-state Adam), reading a folder of 32 seeded synthetic
    128-frame GIFs written through the port's ``utils.media`` (only
    ``dataset_path``, the output folders and the step counts differ), 12
    steps at batch 1: the loss falls, exact launches per step, seconds per
    step, peak memory with ``remat_blocks`` on and off, the plain-modules
    control; then ``sample.main`` from the trained checkpoint, DDIM-50 at
    batch 1, a 128-frame GIF checked;
12b. wide: the wide temporal pair (f = 64 at c = 320, 512, 1024, batch 2,
    where the dense tile holds no token: the streaming kernels in mode
    DENSE) against the dense plain versions in bf16 and f32, biased too,
    held to the gates and, in bf16, to one bf16 unit of each output (the
    standard the staged dense kernels meet at c = 256, checked of them too);
    the float32 gradients closer to the dense oracle than to the blockwise
    one; CUDA-event times;
12c. ctx rounding: the CUDA-core context kernel (the dim-128 bottleneck's
    frames, c = 1024) and both context kernels at the flagship top level
    against a float64 model of the JAX kernel's rounding points: each closer
    to it than to the same model without the rounding of s;
12d. dim128 unet, dim128 grads: phases 4 and 7 for the Unet3D of
    configs/config_tpu_v2_3.yaml (dim 128, 10 frames of 64x64, bf16, both
    fused flags) at batch 2, with its controls: every launch counted, the
    bottleneck's attention through the wide pair;
13. biased: the four biased (fixed-math) temporal kernels against their plain
    versions, forward and backward with dbias: the dense pair at the ten
    flagship shapes (batch 2 forward, batch 8 backward) and at f = 64 with
    c = 256, the blockwise pair at the ten long-clip shapes, the 256-long
    shape and f = 65 and 100; bf16 and f32, TF32 off; a zero bias must
    reproduce the unbiased kernel bit for bit; in f32 the blockwise pair
    also against the dense plain versions; CUDA-event times in both types;
14. sla scale: the spatial output and q-path backward kernels at the fixed
    math's ``scale = 32 ** -0.5`` against their plain versions, and the q-path
    backward's times per shape in both types (float32 is what fixed math hands
    it);
15. fixed unet, fixed grads, long fixed unet, long fixed grads: phases 4, 7,
    10 and 11 for the two recipes with ``unet.reference_compat: false``
    (pre-norms applied, the position bias on the logits): every fused op
    gets float32 there; exact launches (10 biased + 1 unbiased temporal and
    8 of each spatial kernel each way); the bias table and every PreNorm
    norm have gradients; a live focus mask against the plain modules;
16. fixed train, long fixed train: phases 8 and 12 for those recipes (the
    kernel route and the plain modules), with DDIM-50 from each trained
    checkpoint;
17. cross: both cross-attention kernels of the sequence-parallel recipe
    (configs/config_seq_parallel.yaml: 32 frames over 4 ranks, batch 2)
    against their plain versions at the ten calls' shapes (x (2, s, 8, c),
    K/V (2, s, 32, 256)), forward and all seven gradients, in bf16 and f32,
    TF32 off; at a ragged f_g = 21; at f_l = f_g = 32 with K/V projected from
    x, against the dense temporal kernel (the self-attention equivalence);
    every launch must run the staged kernels (each row's ``design``, as the
    C entries report); CUDA-event times per call and per step against the
    bound;
18. seq train: the train CLI's rank function on that recipe (derived keys
    only: a seeded 32-frame dataset, 6 steps, a checkpoint every 3): 4 ranks
    sharing cuda:0 over gloo, named explicitly. First a 4-rank all-gather of a
    (2, 4096, 8, 256) bf16 panel through the group. Then exact launches per
    rank per step (10 + 10 cross kernels, nothing else, all staged), the ranks'
    parameters bit-equal, ``sqrt_alphas_cumprod`` drifted and
    ``alphas_cumprod`` bit-exact (full-state Adam), a resume from step 3; the
    per-step loss against a 1-rank run of the same recipe (temporal attention
    through the modules) within a gate derived from a control (the 1-rank
    run with the dense temporal kernels), which the 4-rank losses scaled by
    1.01 must fail; seconds per step, peak memory per rank, bytes and host
    seconds in the collectives;
19. seq sample: the sampling CLI on one rank from rank 0's checkpoint,
    DDIM-10 at batch 1 and 32 frames;
20. kernels line: one JSON object per kernel of a driven path (launches over
    its train phase, the wide pair's over the dim-128 step, error, times,
    bound, and ``design``: "staged" where every launch of that run ran its
    staged or streaming kernel (panels in shared memory, tensor cores in
    bf16), "cuda-core" where each ran the first version, both where the
    shapes split, as the C entries reported each launch). The biased wide
    pair, which no recipe reaches, is held in the wide phase and reported in
    results.json apart from the line.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before it. ``--only kernels,long sla`` runs the device check, the
build and the named phases alone, then stops without the kernels line and the
ok line (those two phases call only the ops' public wrappers, so a copy of
this file in another checkout times that checkout's kernels). Outputs go to
chiprun_out/chip_smoke/ (small) and build/chip_smoke/ (checkpoints and data).
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
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores: the bound of a kernel's f32 instantiation

TOL = {"bfloat16": 0.05, "float32": 1e-4}
# Backward kernels against their plain versions: max-abs error over the largest magnitude of
# each output (sums run in another order; in bf16 an intermediate may round one ulp apart).
BWD_TOL = {"bfloat16": 0.02, "float32": 1e-5}
# The spatial pair is also held relative to each output's largest value, at BWD_TOL: the contexts, and the
# attention term y = out - x of sla_out. At the inputs' scale y is about one bf16 ulp of x, so out = x + round(y)
# rounds most of y away; the contexts are multiplied by this power of two (exact in either type, and y with them)
# so that y outweighs x and out - x shows y to its own rounding.
CTX_GAIN = 2.0 ** 12
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
SLA_FWD = ("sla_context", "sla_out")  # every launch of these on the flagship paths must run the staged kernel
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
LONG_SLA_SHAPES = [(count, (1, 128, *shape[2:])) for count, shape in SLA_SHAPES]  # the long clip's 8 spatial calls
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


# Wide columns (f <= 64 at widths whose one-token dense tile does not fit: c >= 374 forward, c >= 309
# backward at head dim 32): the streaming kernels in mode DENSE, with the dense kernels' rounding points.
# The dim-128 recipe (configs/config_tpu_v2_3.yaml: Unet3D dim 128, mults (1,2,4,8), 10 frames of 64x64,
# bf16, both fused flags) attends its bottleneck's 8x8 = 64 tokens at c = 1024 there; it is driven at batch 2.
DIM128_CONFIG = REPO / "configs" / "config_tpu_v2_3.yaml"
DIM128_BATCH = 2
# (per-step count in the dim-128 recipe, (b, s, f, c)): c = 1024 is its bottleneck; 320 and 512 are off its path
WIDE_SHAPES = [(int(c == 1024), (DIM128_BATCH, 10, 64, c)) for c in (320, 512, 1024)]
WIDE_DENSE_REF = (DIM128_BATCH, 10, 64, 256)  # the widest column the staged dense kernels hold, for comparison
DIM128_PER_STEP = {"temporal_attention_fwd": 10, "temporal_wide_fwd": 1, "temporal_attention_bwd": 10,
                   "temporal_wide_bwd": 1, "sla_context": 8, "sla_out": 8, "sla_bwd_q": 8, "sla_bwd_kv": 8}
CTX_WIDE = (DIM128_BATCH * 10, 64, 1024)  # the dim-128 bottleneck's spatial frames: the CUDA-core context kernel
CTX_TOP = (B * 10, 4096, 32)  # the flagship top level, where the staged context kernel runs (and, forced, the other)
KERNELS.update({
    "temporal_wide_fwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
                          "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:111"},
    "temporal_wide_bwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
                          "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:175"},
    "temporal_wide_biased_fwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
                                 "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:111"},
    "temporal_wide_biased_bwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/temporal_blockwise.cu",
                                 "replaces": "video_diffusion_nnx_tpu/ops/temporal_attention.py:175"},
})
# No recipe reaches the biased wide instantiation (the position bias goes onto attention over frames, and no
# recipe has 64 frames or fewer at c >= 309): the wide phase and the card tests hold it against its plain
# version, and it stands apart from the kernels line, whose kernels each run on a driven path.
OFF_PATH = ("temporal_wide_biased_fwd", "temporal_wide_biased_bwd")

# Fixed math (unet.reference_compat: false): every temporal attention over the frames takes the biased
# kernels; the bottleneck's spatial attention stays unbiased; the spatial kernels get scale = 32 ** -0.5.
FIXED = {"reference_compat": False}
SLA_PER_STEP = {"sla_context": 8, "sla_out": 8, "sla_bwd_q": 8, "sla_bwd_kv": 8}
FIXED_PER_STEP = {"temporal_attention_biased_fwd": 10, "temporal_attention_biased_bwd": 10,
                  "temporal_attention_fwd": 1, "temporal_attention_bwd": 1, **SLA_PER_STEP}
FIXED_LONG_PER_STEP = {"temporal_blockwise_biased_fwd": 10, "temporal_blockwise_biased_bwd": 10,
                       "temporal_attention_fwd": 1, "temporal_attention_bwd": 1, **SLA_PER_STEP}
MID_SPATIAL = (B, 10, 64, 256)  # unbiased in both maths; as a biased shape it is the f = 64, wide-c check
BIASED_DENSE_SHAPES = [*((n, sh) for n, sh in TEMPORAL_SHAPES if sh != MID_SPATIAL), (0, MID_SPATIAL)]
BIASED_KERNELS = {
    "temporal_attention_biased_fwd": ("temporal_attention.cu", "111 (bias_ref, :151-152)"),
    "temporal_attention_biased_bwd": ("temporal_attention.cu", "175 (bias_ref and dbias_ref, :204-205, :245-248)"),
    "temporal_blockwise_biased_fwd": ("temporal_blockwise.cu", "405 (bias_ref, :372-373)"),
    "temporal_blockwise_biased_bwd": ("temporal_blockwise.cu", "432 (bias_ref and dbias_ref, :512-513, :530-535)"),
}
KERNELS.update({name: {"source": f"video_diffusion_nnx_tpu_torch/csrc/{src}",
                       "replaces": f"video_diffusion_nnx_tpu/ops/temporal_attention.py:{line}"}
                for name, (src, line) in BIASED_KERNELS.items()})
SLA_SCALE = DIM_HEAD ** -0.5

# The sequence-parallel recipe: 32 frames of 64x64 at batch 2 over 4 ranks (8 frames each) sharing one card.
# (per-forward count, (s, c)) of the cross-attention calls of one rank, x (2, s, 8, c), K/V (2, s, 32, 256).
SEQ_CONFIG = REPO / "configs" / "config_seq_parallel.yaml"
SEQ_WORLD, SEQ_FL, SEQ_FG = 4, 8, 32
SEQ_CROSS_SHAPES = [(3, (4096, 32)), (1, (1024, 64)), (1, (1024, 32)), (1, (256, 128)), (1, (256, 64)),
                    (2, (64, 256)), (1, (64, 128))]
SEQ_PER_STEP = {"cross_attention_fwd": 10, "cross_attention_bwd": 10}
SEQ_STEPS, SEQ_CKPT_EVERY, SEQ_CLIPS = 6, 3, 16
SEQ_GATHER_PANEL = (2, 4096, 8, 256)  # one rank's K panel at the widest level, bf16
SEQ_CONTROL_OFF = 0.01  # the 4-rank losses scaled by 1 + this must fail the loss gate
SEQ_GATE_MARGIN = 0.001  # added to 1.5x the control's relative loss gap
KERNELS.update({
    "cross_attention_fwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/cross_attention.cu",
                            "replaces": "video_diffusion_nnx_tpu/ops/cross_attention.py:121"},
    "cross_attention_bwd": {"source": "video_diffusion_nnx_tpu_torch/csrc/cross_attention.cu",
                            "replaces": "video_diffusion_nnx_tpu/ops/cross_attention.py:151"},
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


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def new_totals(names) -> dict:
    """Per kernel: the largest error and the times summed over a forward or a step's launches."""
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
            for k in names}


def add_timing(row: dict, total: dict, count: int, err: float, ms: float, plain_ms: float, nbytes: float,
               flops: float, peak: float = PEAK_BF16_FLOPS) -> None:
    """Write a timed check's times and bound into its ``row`` and add ``count`` launches of it to ``total``."""
    b, by = bound_ms(nbytes, flops, peak)
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, bytes=nbytes, flops=flops, bound_share=b / ms)
    if count:
        total["err"] = max(total["err"], err)
        total["ms"] += count * ms
        total["plain_ms"] += count * plain_ms
        total["bound_ms"] += count * b
        total["t_bytes"] += count * nbytes / PEAK_BYTES_PER_S * 1e3
        total["t_ops"] += count * flops / peak * 1e3


def route_counts(*mods) -> dict:
    """Per kernel of the op modules ``mods``: (launches, of them those that ran the staged kernel)."""
    return {k: (n, getattr(m, "staged", {}).get(k, 0)) for m in mods for k, n in m.launches.items()}


def design(launches: int, staged: int) -> str:
    """The kernel ``launches`` ran, from the route each launch's C entry reported: "staged" (panels in x's
    type, the products on the tensor cores in bf16), "cuda-core" (the first version), or both."""
    return "staged" if launches and staged == launches else "cuda-core" if staged == 0 else "staged/cuda-core"


def design_since(before: dict, now: dict, name: str) -> str:
    """The design of ``name``'s launches between two :func:`route_counts`."""
    return design(now[name][0] - before[name][0], now[name][1] - before[name][1])


def check_staged(counts: dict, staged: dict, where: str) -> None:
    """Every launch of the spatial forward pair ran its staged kernel, as the C entries reported."""
    for name in SLA_FWD:
        check(counts.get(name, 0) > 0 and staged.get(name, 0) == counts[name],
              f"{where}: {staged.get(name, 0)} of {counts.get(name, 0)} launches of {name} ran the staged kernel")


def rand(torch, shape, seed: int, scale: float, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def kernel_phase(torch, ta, sla) -> dict:
    """Every kernel against its plain version at every slice shape; times in bf16 (the spatial pair also in f32,
    and at the training batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    rows, agg = [], new_totals(PER_FORWARD)
    # the spatial pair per forward at each batch and type (float32 is what fixed math hands it)
    sla_agg = {f"b{b}_{t}": agg if (b, t) == (B, "bfloat16") else new_totals(SLA_FWD)
               for b in (B, B_TRAIN) for t in ("bfloat16", "float32")}

    def record(name, shape, dtype, err, count, timing=None, total=agg, **extra):
        check(math.isfinite(err) and err <= TOL[dtype],
              f"{name} at {shape} in {dtype}: max-abs error {err} over tolerance {TOL[dtype]}")
        row = {"kernel": name, "shape": shape, "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype],
               "per_forward": count, "design": design_since(before, route_counts(ta, sla), name), **extra}
        if timing is not None:
            add_timing(row, total[name], count, err, *timing,
                       PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS)
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
            before = route_counts(ta, sla)
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
                record("temporal_attention_fwd", shape, dtype_name, err, count, (ms, plain, nbytes, flops))
            else:
                record("temporal_attention_fwd", shape, dtype_name, err, count)

        for batch in (B, B_TRAIN):
            for count, shape in SLA_SHAPES:
                shape = (batch, *shape[1:])
                before = route_counts(ta, sla)
                checked, times = sla_pair(torch, sla, shape, dtype, dtype_name)
                for name in SLA_FWD:
                    err, rel = checked[name]
                    record(name, shape, dtype_name, err, count, times[name], sla_agg[f"b{batch}_{dtype_name}"],
                           rel_err=rel, rel_tol=BWD_TOL[dtype_name])
    return {"rows": rows, "per_forward": agg, "sla_per_forward": sla_agg, "rel_err": largest_rel(rows)}


def largest_rel(rows) -> dict:
    """Per spatial kernel and type, the largest relative error of the rows (``rel_err``) and its limit."""
    out = {}
    for r in rows:
        if "rel_err" in r:
            key = f"{r['kernel']}_{r['dtype']}"
            out[key] = {"rel_err": max(r["rel_err"], out.get(key, {}).get("rel_err", 0.0)), "tol": r["rel_tol"]}
    return out


def sla_pair(torch, sla, shape, dtype, dtype_name: str) -> tuple[dict, dict]:
    """Both spatial kernels at x (b*f, h*w, c) of ``shape`` (b, f, h, w, c) against their plain versions, and
    timed. Returns, per kernel, (max-abs error, relative error) and :func:`sla_timing`'s times. The relative
    errors: the contexts over the plain contexts' largest value; the attention term y = out - x of sla_out over
    the plain version's, both given the plain contexts times ``CTX_GAIN``. The two kernels together (the
    contexts of the one into the other) are held to the forward gate too."""
    b, f, hh, ww, c = shape
    hd = HEADS * DIM_HEAD
    x = rand(torch, (b * f, hh * ww, c), 6, 0.5, dtype)
    wqkv = rand(torch, (c, 3 * hd), 7, c ** -0.5, dtype)
    wo = rand(torch, (hd, c), 8, hd ** -0.5, dtype)

    def out(fn, ctx):
        return fn(x, wqkv, wo, ctx, HEADS, DIM_HEAD, 1.0)

    ctx, _ = sla.sla_context(x, wqkv, HEADS, DIM_HEAD)
    ctx_plain = sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD)
    out_plain = out(sla.sla_out_plain, ctx_plain)
    y, y_plain = (out(fn, ctx_plain * CTX_GAIN).float() - x.float() for fn in (sla.sla_out, sla.sla_out_plain))
    checked = {"sla_context": (_max_abs(ctx, ctx_plain), _rel_err(ctx, ctx_plain)),
               "sla_out": (_max_abs(out(sla.sla_out, ctx_plain), out_plain), _rel_err(y, y_plain))}
    err_block = _max_abs(out(sla.sla_out, ctx), out_plain)
    check(err_block <= TOL[dtype_name],
          f"spatial block (context + output kernels) at {shape} in {dtype_name}: {err_block}")
    for name, (_, rel) in checked.items():
        check(math.isfinite(rel) and rel <= BWD_TOL[dtype_name],
              f"{name} at {shape} in {dtype_name}: relative error {rel} over {BWD_TOL[dtype_name]}")
    return checked, sla_timing(torch, sla, x, wqkv, wo, ctx_plain)


def sla_timing(torch, sla, x, wqkv, wo, ctx, scale: float = 1.0) -> dict:
    """Per spatial kernel on x (frames, n, c): ``(ms, plain ms, bytes, flops)``, the CUDA-event times of the
    kernel and of its plain version, and the bytes and FLOPs of the function."""
    frames, n, c = x.shape
    hd, elt = HEADS * DIM_HEAD, x.element_size()
    ctx_b = 4 * frames * HEADS * DIM_HEAD ** 2
    flops = 2 * frames * n * (2 * c * hd + HEADS * DIM_HEAD ** 2)  # two projections and one D x D product per head
    fns = {"sla_context": (lambda: sla.sla_context(x, wqkv, HEADS, DIM_HEAD),
                           lambda: sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD),
                           elt * (frames * n * c + 2 * c * hd) + ctx_b + 4 * 2 * frames * hd),
           "sla_out": (lambda: sla.sla_out(x, wqkv, wo, ctx, HEADS, DIM_HEAD, scale),
                       lambda: sla.sla_out_plain(x, wqkv, wo, ctx, HEADS, DIM_HEAD, scale),
                       elt * (2 * frames * n * c + 2 * c * hd) + ctx_b)}
    return {name: (cuda_ms(torch, kernel, 20), cuda_ms(torch, plain, 10), nbytes, flops)
            for name, (kernel, plain, nbytes) in fns.items()}


def long_sla_phase(torch, sla) -> dict:
    """Both spatial kernels at the long-clip recipe's eight calls (batch 1, 128 frames) against their plain
    versions, as in the kernels phase, and the spatial forward's time per training step (each call runs once a
    step) in bf16 and in float32 (what the fixed long-clip recipe hands it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, agg = [], {dt: new_totals(SLA_FWD) for dt in TOL}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        peak = PEAK_F32_FLOPS if dtype_name == "float32" else PEAK_BF16_FLOPS
        for count, shape in LONG_SLA_SHAPES:
            before = route_counts(sla)
            checked, times = sla_pair(torch, sla, shape, dtype, dtype_name)
            now = route_counts(sla)
            for name in SLA_FWD:
                err, rel = checked[name]
                check(math.isfinite(err) and err <= TOL[dtype_name],
                      f"{name} at {shape} in {dtype_name}: max-abs error {err} over {TOL[dtype_name]}")
                row = {"kernel": name, "shape": shape, "dtype": dtype_name, "max_abs_err": err,
                       "tol": TOL[dtype_name], "rel_err": rel, "rel_tol": BWD_TOL[dtype_name], "per_step": count,
                       "design": design_since(before, now, name)}
                add_timing(row, agg[dtype_name][name], count, err, *times[name], peak)
                rows.append(row)
                print("  " + json.dumps(row), flush=True)
    return {"rows": rows, "per_step": agg, "rel_err": largest_rel(rows)}


def unet_phase(torch, load_config, build_models, config_path: Path = CONFIG, batch: int = B,
               unet: dict | None = None) -> dict:
    """A recipe's full-width Unet3D in bf16: kernels against the plain modules (and both against f32).

    ``unet`` overrides keys of the recipe's ``unet`` section (``FIXED`` derives the fixed-math recipe).
    """
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    config = load_config(config_path)
    config["unet"].update(unet or {})
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
    counts, staged = ops.launch_counts(), ops.staged_launch_counts()
    check_staged(counts, staged, "flagship sampling")
    forwards = sum(r["steps"] for r in runs.values())
    for name, per in PER_FORWARD.items():
        check(counts[name] > 0, f"kernel {name} was never launched on the main path")
        check(counts[name] == per * forwards,
              f"kernel {name}: {counts[name]} launches, expected {per} x {forwards} forwards")
    return {"runs": runs, "launches": counts, "staged_launches": staged, "forwards": forwards}


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
    fwd_step = new_totals(("temporal_attention_fwd",))  # the dense forward's bf16 times per training step
    kv_f32 = new_totals(("sla_bwd_kv",))  # sla_bwd_kv in float32, what the fixed recipe hands it (one pass)

    def record_fwd(name, shape, dtype, err, tol, what="max-abs"):
        check(math.isfinite(err) and err <= tol, f"{name} at {shape} in {dtype}: {what} error {err} over {tol}")
        if what == "max-abs":
            fwd_err[name] = max(fwd_err[name], err)
        row = {"kernel": name, "shape": shape, "dtype": dtype, "what": what, "err": err, "tol": tol}
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    def record(name, shape, dtype, outs, count, ms=None, plain_ms=None, nbytes=0.0, flops=0.0, total=None,
               peak=PEAK_BF16_FLOPS):
        rel = {k: _rel_err(a, w) for k, (a, w) in outs.items()}
        err = max(_max_abs(a, w) for a, w in outs.values())
        for k, r in rel.items():
            check(math.isfinite(r) and r <= BWD_TOL[dtype],
                  f"{name} {k} at {shape} in {dtype}: error {r} of its largest value, over {BWD_TOL[dtype]}")
        row = {"kernel": name, "shape": shape, "dtype": dtype, "rel_err": rel, "max_abs_err": err,
               "tol": BWD_TOL[dtype], "per_step": count, "design": design_since(before, route_counts(ta, sla), name)}
        if ms is not None:
            add_timing(row, agg[name] if total is None else total, count, err, ms, plain_ms, nbytes, flops, peak)
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
            before = route_counts(ta, sla)
            y = ta.fused_temporal_attention_block(*fwd_args)
            err_f = _max_abs(y, ta.temporal_attention_plain(*fwd_args))
            record_fwd("temporal_attention_fwd", (b, s, f, c), dtype_name, err_f, TOL[dtype_name])
            del y
            if timed:  # the forward at the training batch, as the step runs it
                row = {"kernel": "temporal_attention_fwd", "shape": (b, s, f, c), "dtype": dtype_name,
                       "per_step": count, "design": design_since(before, route_counts(ta, sla), "temporal_attention_fwd")}
                rows_n = b * s * f
                add_timing(row, fwd_step["temporal_attention_fwd"], count, err_f,
                           cuda_ms(torch, lambda: ta.fused_temporal_attention_block(*fwd_args), 10),
                           cuda_ms(torch, lambda: ta.temporal_attention_plain(*fwd_args), 5, 1),
                           elt * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c), rows_n * (8 * c * hd + 4 * f * hd))
                rows.append(row)
                print("  " + json.dumps(row), flush=True)
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
            before = route_counts(ta, sla)
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
            kv_args = (x, wqkv, ctx, got_q[1], got_q[0])
            got_kv = sla.sla_bwd_kv(*kv_args, stats, HEADS, DIM_HEAD)
            want_kv = sla.sla_bwd_kv_plain(*kv_args, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            outs_q = dict(zip(("dx_q", "dctx", "dwq", "dwo"), zip(got_q, want_q)))
            outs_kv = dict(zip(("dx", "dwk", "dwv"), zip(got_kv, want_kv)))
            rows_n = frames * n
            ctx_b = 4 * frames * HEADS * DIM_HEAD ** 2
            # float32 also reads the forward's contexts, which give it rho (one pass)
            kv_bytes = (elt * (3 * rows_n * c + 2 * c * hd) + ctx_b * (1 if timed else 2) + 4 * 2 * frames * hd
                        + 4 * 2 * c * hd)
            kv_flops = rows_n * (12 * c * hd + 4 * DIM_HEAD * hd)
            ms_kv = cuda_ms(torch, lambda: sla.sla_bwd_kv(*kv_args, stats, HEADS, DIM_HEAD), 5, 1)
            pl_kv = cuda_ms(torch, lambda: sla.sla_bwd_kv_plain(*kv_args, HEADS, DIM_HEAD), 5, 1)
            if timed:
                q_bytes = elt * (3 * rows_n * c + 2 * c * hd) + 2 * ctx_b + 4 * 2 * c * hd
                q_flops = rows_n * (10 * c * hd + 6 * DIM_HEAD * hd)
                ms_q = cuda_ms(torch, lambda: sla.sla_bwd_q(*q_args), 5, 1)
                pl_q = cuda_ms(torch, lambda: sla.sla_bwd_q_plain(*q_args), 5, 1)
                record("sla_bwd_q", shape_r, dtype_name, outs_q, count, ms_q, pl_q, q_bytes, q_flops)
                record("sla_bwd_kv", shape_r, dtype_name, outs_kv, count, ms_kv, pl_kv, kv_bytes, kv_flops)
            else:  # float32, what the fixed recipe hands sla_bwd_kv
                record("sla_bwd_q", shape_r, dtype_name, outs_q, count)
                record("sla_bwd_kv", shape_r, dtype_name, outs_kv, count, ms_kv, pl_kv, kv_bytes, kv_flops,
                       kv_f32["sla_bwd_kv"], PEAK_F32_FLOPS)
            del x, g, got_q, want_q, got_kv, want_kv, outs_q, outs_kv
    return {"rows": rows, "per_step": agg, "fwd_err": fwd_err, "fwd_per_step": fwd_step, "f32_per_step": kv_f32}


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
            before, routes = dict(ta.launches), route_counts(ta)
            got = ta.fused_temporal_attention_block(x, *w, HEADS, DIM_HEAD)
            grads = ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            check(all(ta.launches[k] == before[k] + 1 for k in names)
                  and ta.launches["temporal_attention_fwd"] == before["temporal_attention_fwd"],
                  f"f = {f} did not take the blockwise kernels: {ta.launches}")
            designs = {k: design_since(routes, route_counts(ta), k) for k in names}
            check(not count or set(designs.values()) == {"staged"},
                  f"the long clip's shape {shape} in {dtype_name} did not take the streaming kernels: {designs}")
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
            fwd_row = {"kv_block": kb, "max_abs_err": err, "tol": TOL[dtype_name], "design": designs[names[0]]}
            bwd_row = {"kv_block": kb, "rel_err": rel, "max_abs_err": err_b, "tol": BWD_TOL[dtype_name],
                       "design": designs[names[1]]}
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


def biased_phase(torch, ta) -> dict:
    """The four biased temporal kernels against their plain versions; times in both types.

    The fixed recipes hand these kernels float32 (the PreNorm's LayerNorm promotes the bf16
    activations), so the f32 instantiation is the main path's and its bound takes the float32 rate;
    the bf16 instantiation is part of the op and is held and timed too. Per shape: forward
    (the dense family at the sampling batch) and backward with dbias (at the training batch)
    against the family's plain versions, in f32 the blockwise pair also against the dense ones, and a zero
    bias against the unbiased kernel, bit for bit.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    grad_names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")
    rows = []
    agg = {dt: new_totals(BIASED_KERNELS) for dt in TOL}

    def weights(c):
        return (rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32), rand(torch, (3 * hd,), 3, 0.1, torch.float32),
                rand(torch, (hd, c), 4, hd ** -0.5, torch.float32), rand(torch, (c,), 5, 0.1, torch.float32))

    shapes = [("attention", n, sh, (B_TRAIN, *sh[1:])) for n, sh in BIASED_DENSE_SHAPES]
    shapes += [("blockwise", n, sh, sh) for n, sh in [*LONG_TEMPORAL_SHAPES, *EXTRA_BLOCKWISE_SHAPES]]
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        elt, peak = (4, PEAK_F32_FLOPS) if dtype_name == "float32" else (2, PEAK_BF16_FLOPS)
        for family, count, f_shape, b_shape in shapes:
            names = (f"temporal_{family}_biased_fwd", f"temporal_{family}_biased_bwd")
            dense = family == "attention"
            f, c = f_shape[2], f_shape[3]
            w = weights(c)
            bias = rand(torch, (HEADS, f, f), 14, 0.5, torch.float32)
            zero = torch.zeros_like(bias)
            kb = () if dense else (ta.KV_BLOCK,)
            plain_f = ta.temporal_attention_plain if dense else ta.temporal_attention_blockwise_plain
            plain_b = ta.temporal_attention_bwd_plain if dense else ta.temporal_attention_blockwise_bwd_plain
            panel = HEADS * f * f

            # Forward.
            x = rand(torch, f_shape, 1, 0.5, dtype)
            before, routes = dict(ta.launches), route_counts(ta)
            got = ta.fused_temporal_attention_block_biased(x, *w, bias, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            check(ta.launches[names[0]] == before[names[0]] + 1, f"f = {f} did not launch {names[0]}: {ta.launches}")
            err = _max_abs(got, plain_f(x, *w, HEADS, DIM_HEAD, *kb, pos_bias=bias))
            check(math.isfinite(err) and err <= TOL[dtype_name],
                  f"{names[0]} at {f_shape} in {dtype_name}: max-abs error {err} over {TOL[dtype_name]}")
            check(torch.equal(ta.fused_temporal_attention_block_biased(x, *w, zero, HEADS, DIM_HEAD),
                              ta.fused_temporal_attention_block(x, *w, HEADS, DIM_HEAD)),
                  f"{names[0]} at {f_shape} in {dtype_name}: a zero bias does not reproduce the unbiased kernel")
            row = {"kernel": names[0], "shape": f_shape, "dtype": dtype_name, "per_step": count, "max_abs_err": err,
                   "tol": TOL[dtype_name], "design": design_since(routes, route_counts(ta), names[0])}
            check(dense or not count or row["design"] == "staged",
                  f"{names[0]} at the long clip's {f_shape} in {dtype_name} ran the {row['design']} design")
            if not dense and dtype_name == "float32":
                row["vs_dense_plain"] = _max_abs(got, ta.temporal_attention_plain(x, *w, HEADS, DIM_HEAD, pos_bias=bias))
                check(row["vs_dense_plain"] <= TOL[dtype_name], f"{names[0]} at {f_shape} against the dense plain version: {row}")
            rows_n = f_shape[0] * f_shape[1] * f
            nbytes = elt * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * panel
            flops = rows_n * (8 * c * hd + 4 * f * hd + HEADS * f)  # the unbiased count and one add per logit
            ms = cuda_ms(torch, lambda: ta.fused_temporal_attention_block_biased(x, *w, bias, HEADS, DIM_HEAD), 5, 1)
            pl = cuda_ms(torch, lambda: plain_f(x, *w, HEADS, DIM_HEAD, *kb, pos_bias=bias), 3, 1)
            add_timing(row, agg[dtype_name][names[0]], count, err, ms, pl, nbytes, flops, peak)
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
            del got

            # Backward, with dbias.
            if b_shape != f_shape:
                x = rand(torch, b_shape, 1, 0.5, dtype)
            g = rand(torch, b_shape, 9, 0.1, dtype)
            before, routes = dict(ta.launches), route_counts(ta)
            grads = ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD, pos_bias=bias)
            torch.cuda.synchronize()
            check(ta.launches[names[1]] == before[names[1]] + 1, f"f = {f} did not launch {names[1]}: {ta.launches}")
            want = plain_b(x, g, *w, HEADS, DIM_HEAD, *kb, pos_bias=bias)
            rel = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want)}
            err_b = max(_max_abs(a, v) for a, v in zip(grads, want))
            for k, r in rel.items():
                check(math.isfinite(r) and r <= BWD_TOL[dtype_name],
                      f"{names[1]} {k} at {b_shape} in {dtype_name}: error {r} of its largest value, over {BWD_TOL[dtype_name]}")
            del want
            row = {"kernel": names[1], "shape": b_shape, "dtype": dtype_name, "per_step": count, "rel_err": rel,
                   "max_abs_err": err_b, "tol": BWD_TOL[dtype_name],
                   "design": design_since(routes, route_counts(ta), names[1])}
            check(dense or not count or row["design"] == "staged",
                  f"{names[1]} at the long clip's {b_shape} in {dtype_name} ran the {row['design']} design")
            if not dense and dtype_name == "float32":
                want_d = ta.temporal_attention_bwd_plain(x, g, *w, HEADS, DIM_HEAD, pos_bias=bias)
                row["vs_dense_oracle"] = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want_d)}
                check(max(row["vs_dense_oracle"].values()) <= BWD_TOL[dtype_name],
                      f"{names[1]} at {b_shape} against the dense backward oracle: {row['vs_dense_oracle']}")
                del want_d
            for a, v in zip(ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD, pos_bias=zero),
                            ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD)):
                check(torch.equal(a, v), f"{names[1]} at {b_shape} in {dtype_name}: a zero bias does not "
                                         "reproduce the unbiased kernel's gradients")
            rows_n = b_shape[0] * b_shape[1] * f
            nbytes = (elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
                      + 2 * 4 * panel)  # the bias read once and dbias written once
            flops = rows_n * (22 * c * hd + 12 * f * hd + 2 * HEADS * f)  # the bias add and the dbias sum
            ms = cuda_ms(torch, lambda: ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD, pos_bias=bias), 3, 1)
            pl = cuda_ms(torch, lambda: plain_b(x, g, *w, HEADS, DIM_HEAD, *kb, pos_bias=bias), 3, 1)
            add_timing(row, agg[dtype_name][names[1]], count, err_b, ms, pl, nbytes, flops, peak)
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
            del x, g, grads
    return {"rows": rows, "per_step": agg}


def _one_ulp(got, want) -> bool:
    """The bf16 standard the dense kernels meet: no element further from the reference than one bf16 unit in the last
    place of the reference's largest magnitude."""
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return _max_abs(got, want) <= ulp


def wide_phase(torch, ta) -> dict:
    """The wide pair (mode DENSE of the streaming kernels) against the dense plain versions at f = 64 and
    c of ``WIDE_SHAPES`` (batch 2), bf16 and f32, TF32 off, unbiased and biased (dbias held like the weight gradients).

    Each output is held to the gates of PERF.md section 2 and, in bf16, to the standard the staged dense kernels
    meet at c = 256 (``WIDE_DENSE_REF``, the widest column they hold), which this phase checks of them too: at most
    one bf16 unit in the last place of each output's largest magnitude. In bf16 the float32 gradients also show the
    rounding points: dW_o (which reads the rounded o_h of the forward) and dW_qkv, db_qkv, dbias (the rounded ds and
    di of the backward) lie closer to the dense oracle than to the blockwise one, whose points the wide kernels do
    not take. CUDA-event times at every shape; the dim-128 shape (c = 1024, unbiased bf16) is the kernels line's.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    grad_names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")
    names = ("temporal_wide_fwd", "temporal_wide_bwd", "temporal_wide_biased_fwd", "temporal_wide_biased_bwd")
    rows, agg = [], new_totals(names)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        elt, peak = (4, PEAK_F32_FLOPS) if dtype_name == "float32" else (2, PEAK_BF16_FLOPS)
        bf16 = dtype_name == "bfloat16"
        for count, shape in [(0, WIDE_DENSE_REF), *WIDE_SHAPES]:
            b, s, f, c = shape
            for biased in (False, True):
                tag = "_biased" if biased else ""
                family = "attention" if shape == WIDE_DENSE_REF else "wide"
                # the dense forward still holds c = 320 (its tile refuses c >= 374; the backward's c >= 309)
                f_family = "wide" if family == "wide" and ta.wide_needed(f, c, DIM_HEAD, False) else "attention"
                fwd, bwd = f"temporal_{f_family}{tag}_fwd", f"temporal_{family}{tag}_bwd"
                x = rand(torch, shape, 1, 0.5, dtype)
                g = rand(torch, shape, 9, 0.1, dtype)
                w = (rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32), rand(torch, (3 * hd,), 3, 0.1, torch.float32),
                     rand(torch, (hd, c), 4, hd ** -0.5, torch.float32), rand(torch, (c,), 5, 0.1, torch.float32))
                bias = rand(torch, (HEADS, f, f), 14, 0.5, torch.float32) if biased else None
                kw = {"pos_bias": bias}
                before, routes = dict(ta.launches), route_counts(ta)
                got = ta._block(x, *w, bias, HEADS, DIM_HEAD)
                grads = ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD, **kw)
                torch.cuda.synchronize()
                check(ta.launches[fwd] == before[fwd] + 1 and ta.launches[bwd] == before[bwd] + 1,
                      f"{shape} {dtype_name}: {fwd} / {bwd} were not launched: {nonzero(ta.launches)}")
                design = tuple(design_since(routes, route_counts(ta), k) for k in (fwd, bwd))
                check(family == "attention" or (design[1] == "staged" and (design[0] == "staged" or f_family == "attention")),
                      f"{shape} {dtype_name}: {fwd} / {bwd} ran {design}")
                want_f = ta.temporal_attention_plain(x, *w, HEADS, DIM_HEAD, **kw)
                want = ta.temporal_attention_bwd_plain(x, g, *w, HEADS, DIM_HEAD, **kw)
                err = _max_abs(got, want_f)
                rel = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want)}
                err_b = max(rel.values())
                row = {"shape": shape, "dtype": dtype_name, "bias": biased, "kernels": (fwd, bwd), "design": design,
                       "max_abs_err": err, "rel_err": rel, "per_step": count}
                check(math.isfinite(err) and err <= TOL[dtype_name],
                      f"{fwd} at {shape} in {dtype_name}: max-abs error {err} over {TOL[dtype_name]}")
                check(math.isfinite(err_b) and err_b <= BWD_TOL[dtype_name],
                      f"{bwd} at {shape} in {dtype_name}: {rel} over {BWD_TOL[dtype_name]}")
                if bf16:
                    row["one_ulp"] = _one_ulp(got, want_f) and all(_one_ulp(a, v) for a, v in zip(grads, want))
                    check(row["one_ulp"], f"{fwd} / {bwd} at {shape}: an output more than one bf16 unit from the plain "
                                          f"version (forward {err}, backward {rel})")
                del want_f
                if family == "attention":
                    rows.append(row)
                    print("  " + json.dumps(row), flush=True)
                    del x, g, got, grads, want
                    continue
                if bf16:  # the rounding points, through the float32 gradients
                    blk = ta.temporal_attention_blockwise_bwd_plain(x, g, *w, HEADS, DIM_HEAD, ta.KV_BLOCK, **kw)
                    probes = {"forward (dwo)": ("dwo",), "backward (dwqkv, dbqkv, dbias)": ("dwqkv", "dbqkv", "dbias")}
                    row["rounding_points"] = {}
                    for probe, keys in probes.items():
                        dense_d = max(rel[k] for k in keys if k in rel)
                        blk_d = max(_rel_err(grads[grad_names.index(k)], blk[grad_names.index(k)]) for k in keys if k in rel)
                        row["rounding_points"][probe] = {"vs_dense": dense_d, "vs_blockwise": blk_d}
                        check(dense_d < blk_d, f"{bwd} at {shape}: the {probe} gradients lie no closer to the dense "
                                               f"oracle ({dense_d}) than to the blockwise one ({blk_d})")
                    del blk
                del want
                rows_n = b * s * f
                f_bytes = elt * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + (4 * HEADS * f * f if biased else 0)
                f_flops = rows_n * (8 * c * hd + 4 * f * hd + (HEADS * f if biased else 0))
                b_bytes = (elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
                           + (2 * 4 * HEADS * f * f if biased else 0))
                b_flops = rows_n * (22 * c * hd + 12 * f * hd + (2 * HEADS * f if biased else 0))
                ms_f = cuda_ms(torch, lambda: ta._block(x, *w, bias, HEADS, DIM_HEAD), 5, 1)
                pl_f = cuda_ms(torch, lambda: ta.temporal_attention_plain(x, *w, HEADS, DIM_HEAD, **kw), 3, 1)
                ms_b = cuda_ms(torch, lambda: ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD, **kw), 3, 1)
                pl_b = cuda_ms(torch, lambda: ta.temporal_attention_bwd_plain(x, g, *w, HEADS, DIM_HEAD, **kw), 3, 1)
                main = bf16 and count  # the dim-128 recipe's call (and the biased pair's yardstick)
                fwd_row, bwd_row = dict(row, kernel=fwd), dict(row, kernel=bwd)
                add_timing(fwd_row, agg.get(fwd, {}), count if main else 0, err, ms_f, pl_f, f_bytes, f_flops, peak)
                add_timing(bwd_row, agg[bwd], count if main else 0, err_b, ms_b, pl_b, b_bytes, b_flops, peak)
                rows += [fwd_row, bwd_row]
                print("  " + json.dumps(fwd_row) + "\n  " + json.dumps(bwd_row), flush=True)
                del x, g, got, grads
    return {"rows": rows, "per_step": agg}


def _point_contexts(torch, xt, wqkv):
    """Float64 models of the contexts: at the JAX context kernel's rounding points (k from x and W_k in x's type,
    not rounded; its softmax over all tokens; then s and v rounded to x's type, ``_context_kernel``:177-193), and
    the same without the rounding of s."""
    frames, n, c = xt.shape
    hd, dt = HEADS * DIM_HEAD, xt.dtype
    x = xt.double()
    k = (x @ wqkv[:, hd:2 * hd].to(dt).double()).reshape(frames, n, HEADS, DIM_HEAD)
    v = (x @ wqkv[:, 2 * hd:].to(dt).double()).to(dt).double().reshape(frames, n, HEADS, DIM_HEAD)
    s = torch.softmax(k, dim=1)
    return (torch.einsum("bnhd,bnhe->bhde", s.to(dt).double(), v), torch.einsum("bnhd,bnhe->bhde", s, v))


def ctx_rounding_phase(torch, sla) -> dict:
    """The context kernels against the float64 model of the JAX kernel's rounding points, bf16, each distance
    relative to the model's largest context: at the dim-128 bottleneck's frames (c = 1024, where ``ctx_plan`` takes
    the CUDA-core kernel) and at the flagship's top level, where both kernels run (the CUDA-core one forced through
    a chunk the staged fit rule refuses, as the card tests do). Every kernel must lie closer to that model than to
    the same model without the rounding of s, which is where a kernel that skips the rounding lies."""
    hd = HEADS * DIM_HEAD
    out = {}

    def measure(ctx, ref, unrounded):
        scale = ref.abs().max().item()
        return {"rel_err": (ctx.double() - ref).abs().max().item() / scale,
                "rel_err_vs_unrounded": (ctx.double() - unrounded).abs().max().item() / scale,
                "models_differ": (ref - unrounded).abs().max().item() / scale}

    for name, shape in (("wide", CTX_WIDE), ("top", CTX_TOP)):
        frames, n, c = shape
        xt = rand(torch, shape, 6, 0.5, torch.bfloat16)
        wqkv = rand(torch, (c, 3 * hd), 7, c ** -0.5, torch.float32)
        ref, unrounded = _point_contexts(torch, xt, wqkv)
        before = sla.staged["sla_context"]
        got, _ = sla.sla_context(xt, wqkv, HEADS, DIM_HEAD)
        torch.cuda.synchronize()
        out[name] = {"shape": shape, "route": "staged" if sla.staged["sla_context"] > before else "simt",
                     **measure(got, ref, unrounded)}
        if name == "top":
            saved = sla.ctx_plan
            sla.ctx_plan = lambda *a: {"route": "simt", "chunk": 60, "splits": 1, "groups": 1, "smem": 0}
            try:
                simt, _ = sla.sla_context(xt, wqkv, HEADS, DIM_HEAD)
                torch.cuda.synchronize()
            finally:
                sla.ctx_plan = saved
            out["top_simt"] = {"shape": shape, "route": "simt", **measure(simt, ref, unrounded)}
    print("  " + json.dumps(out), flush=True)
    check(out["wide"]["route"] == "simt" and out["top"]["route"] == "staged",
          f"the context kernels ran other routes than the check needs: {out}")
    for name, r in out.items():
        check(r["rel_err"] < r["rel_err_vs_unrounded"],
              f"the {r['route']} context kernel at {r['shape']} does not round s where the JAX kernel does: {r}")
    return out


def sla_scale_phase(torch, sla) -> dict:
    """The two spatial kernels that take the q scale, at fixed math's 32 ** -0.5 and the training shapes.

    ``sla_bwd_q`` is timed here in both types: float32 is what the fixed recipes hand it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    rows = []
    agg = {dt: new_totals(("sla_bwd_q",)) for dt in TOL}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        elt, peak = (4, PEAK_F32_FLOPS) if dtype_name == "float32" else (2, PEAK_BF16_FLOPS)
        for count, shape in SLA_SHAPES:
            b, f, hh, ww, c = (B_TRAIN, *shape[1:])
            x = rand(torch, (b * f, hh * ww, c), 6, 0.5, dtype)
            g = rand(torch, (b * f, hh * ww, c), 10, 0.1, dtype)
            wqkv = rand(torch, (c, 3 * hd), 7, c ** -0.5, torch.float32)
            wo = rand(torch, (hd, c), 8, hd ** -0.5, torch.float32)
            ctx = sla.sla_context_plain(x, wqkv, HEADS, DIM_HEAD)
            err = _max_abs(sla.sla_out(x, wqkv, wo, ctx, HEADS, DIM_HEAD, SLA_SCALE),
                           sla.sla_out_plain(x, wqkv, wo, ctx, HEADS, DIM_HEAD, SLA_SCALE))
            check(math.isfinite(err) and err <= TOL[dtype_name],
                  f"sla_out with the q scale at {(b, f, hh, ww, c)} in {dtype_name}: {err} over {TOL[dtype_name]}")
            unscaled = _max_abs(sla.sla_out(x, wqkv, wo, ctx, HEADS, DIM_HEAD, SLA_SCALE),
                                sla.sla_out(x, wqkv, wo, ctx, HEADS, DIM_HEAD, 1.0))
            check(unscaled > 0, f"the q scale leaves sla_out unchanged at {shape}")
            q_args = (x, g, wqkv, wo, ctx, HEADS, DIM_HEAD, SLA_SCALE)
            rel = {k: _rel_err(a, v) for k, a, v in zip(("dx_q", "dctx", "dwq", "dwo"), sla.sla_bwd_q(*q_args),
                                                        sla.sla_bwd_q_plain(*q_args))}
            for k, r in rel.items():
                check(math.isfinite(r) and r <= BWD_TOL[dtype_name],
                      f"sla_bwd_q {k} with the q scale at {(b, f, hh, ww, c)} in {dtype_name}: {r} over {BWD_TOL[dtype_name]}")
            row = {"shape": (b, f, hh, ww, c), "dtype": dtype_name, "scale": SLA_SCALE, "sla_out_err": err,
                   "sla_out_vs_scale_1": unscaled, "sla_bwd_q_rel_err": rel, "per_step": count}
            rows_n = b * f * hh * ww
            nbytes = elt * (3 * rows_n * c + 2 * c * hd) + 2 * 4 * b * f * HEADS * DIM_HEAD ** 2 + 4 * 2 * c * hd
            flops = rows_n * (10 * c * hd + 6 * DIM_HEAD * hd)
            ms = cuda_ms(torch, lambda: sla.sla_bwd_q(*q_args), 5, 1)
            pl = cuda_ms(torch, lambda: sla.sla_bwd_q_plain(*q_args), 5, 1)
            add_timing(row, agg[dtype_name]["sla_bwd_q"], count, max(rel.values()), ms, pl, nbytes, flops, peak)
            rows.append(row)
            print("  " + json.dumps(rows[-1]), flush=True)
            del x, g, ctx
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

    def temporal(x, g, *rest, **kw):
        dx, *others = t_bwd(x, g, *rest, **kw)
        return (off(dx, g), *others)

    def spatial_q(xt, g, *rest):
        dxq, *others = q_bwd(xt, g, *rest)
        return (off(dxq, g), *others)

    return temporal, spatial_q


def grads_phase(torch, ops, ta, sla, load_config, build_models, config_path: Path = CONFIG,
                batch: int = B_TRAIN, long_clip: bool = False, unet: dict | None = None,
                per_step: dict | None = None) -> dict:
    """A recipe's Unet3D gradients in bf16: kernels against plain modules, both against f32.

    The flagship run (batch 8) adds the controls; the long-clip run (batch 1, ``remat_blocks`` on
    in every variant) adds the same Unet with ``remat_blocks`` off, whose gradients and launch counts
    must equal the kernel route's. ``unet`` overrides keys of the recipe's ``unet`` section and
    ``per_step`` is the exact launch count of one step. In fixed math the run also checks that
    the position-bias table and every PreNorm norm get a gradient and, at batch 8, a live focus mask.
    """
    config = load_config(config_path)
    config["unet"].update(unet or {})
    fixed = not config["unet"]["reference_compat"]
    per_step = per_step or (LONG_PER_STEP if long_clip else PER_STEP)
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

    def run(m, **kw):
        m.zero_grad(set_to_none=True)
        loss = m(x, t=t, noise=noise, **kw)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.detach().float().clone() for k, p in m.named_parameters()
                             if p.grad is not None}

    staged = {}
    for name, m in models.items():
        m.train()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses[name], grads[name] = run(m)
        peak[name], launches[name] = torch.cuda.max_memory_allocated(), ops.launch_counts()
        if name == "kernels":
            staged = nonzero(ops.staged_launch_counts())

        def step(m=m):
            m.zero_grad(set_to_none=True)
            m(x, t=t, noise=noise).backward()

        ms[name] = cuda_ms(torch, step, 3, 1)
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    check(nonzero(launches["kernels"]) == per_step and not nonzero(launches["plain"]),
          f"launches of one step: kernels {nonzero(launches['kernels'])}, expected {per_step}; "
          f"plain modules {nonzero(launches['plain'])}")
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
        check(nonzero(launches["remat_off"]) == per_step,
              f"launches with remat_blocks off {nonzero(launches['remat_off'])}, expected {per_step}")
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
    live = {}
    if fixed:
        # Fixed math trains what compat math leaves unused: the position-bias table and the PreNorm norms.
        named = [k for k in grads["kernels"] if ".fn.norm." in k or "time_rel_pos_bias" in k]
        check(len(named) == 2 * 19 + 1, f"{len(named)} PreNorm and bias-table tensors have gradients, expected 39")
        dead = [k for k in named if not grads["kernels"][k].abs().max().item() > 0]
        check(not dead, f"zero gradients in fixed math: {dead}")
        live = {"norm_and_table_tensors": len(named)}
    if fixed and batch > 1:
        # A live focus mask: masked samples take the v-projection select (no kernel sees the mask).
        mask = torch.arange(batch, device="cuda") % 2 == 0
        ops.reset_launch_counts()
        m_loss, m_grads = run(models["kernels"], focus_present_mask=mask)
        m_counts = nonzero(ops.launch_counts())
        p_loss, p_grads = run(models["plain"], focus_present_mask=mask)
        check(m_counts == per_step, f"launches under a focus mask {m_counts}, expected {per_step}")
        worst_m = max(rel(m_grads[k], p_grads[k], "plain") for k in per)
        check(worst_m <= GRAD_TOL, f"focus mask: gradient of a tensor parts by {worst_m} > {GRAD_TOL}")
        check(abs(m_loss - p_loss) <= LOSS_TOL * abs(p_loss) and abs(m_loss - losses["kernels"]) > 1e-6,
              f"focus mask: loss {m_loss} (kernels), {p_loss} (plain modules), {losses['kernels']} unmasked")
        live.update(focus_mask={"loss_kernels": m_loss, "loss_plain": p_loss, "max_k_vs_p": worst_m})
    worst = max(per, key=lambda k: per[k]["k_vs_p"])
    return {"losses": losses, "fwd_bwd_ms": ms, "peak_memory": peak, "remat": remat, "tensors": len(per),
            "launches": nonzero(launches["kernels"]), "staged_launches": staged, "fixed_math": live,
            "worst": {worst: per[worst]},
            "limits": {"per_tensor": GRAD_TOL, "whole": 1.5 * p_whole + GRAD_MARGIN}, "controls": controls,
            "kernels_vs_f32": k_whole, "plain_vs_f32": p_whole,
            "max_k_vs_p": per[worst]["k_vs_p"], "max_k_vs_f32": max(r["k_vs_f32"] for r in per.values()),
            "max_p_vs_f32": max(r["p_vs_f32"] for r in per.values()), "per_tensor": per}


def bouncing_squares(path: Path, clips: int = 256, frames: int = 10, size: int = 64, seed: int = 0) -> Path:
    """A seeded uint8 dataset (frames, clips, size, size) saved as ``.npy``: one bright square bouncing per clip."""
    import numpy as np

    np.save(path, _squares(clips, frames, size, seed))
    return path


def bouncing_square_gifs(folder: Path, clips: int, frames: int, size: int = 64, seed: int = 0) -> Path:
    """The same clips as one grayscale GIF each (``clip_NNN.gif``), written by the port's ``utils.media``."""
    from video_diffusion_nnx_tpu_torch.utils.media import video_array_to_gif

    folder.mkdir(parents=True, exist_ok=True)
    for old in folder.glob("*.gif"):
        old.unlink()
    data = _squares(clips, frames, size, seed)
    for i in range(clips):
        video_array_to_gif(data[:, i, :, :, None], folder / f"clip_{i:03d}.gif")
    return folder


def _squares(clips: int, frames: int, size: int, seed: int):
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
    return (rows[..., :, None] & cols[..., None, :]).astype(np.uint8) * 255


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


def train_phase(torch, ops, train, sample, name: str = "train", unet: dict | None = None,
                per_step: dict = PER_STEP, ddim_steps: int = 10) -> dict:
    """The flagship recipe (with ``unet`` overrides) through the CLIs: 30 steps at batch 8, a resume, the
    same steps through the plain modules, then DDIM from the trained checkpoint."""
    import yaml
    from PIL import Image

    raw = yaml.safe_load(CONFIG.read_text())
    root = SCRATCH / name
    root.mkdir(parents=True, exist_ok=True)
    data = bouncing_squares(root / "bouncing_squares.npy")
    fused_cfg = _train_config(yaml, raw, root, data, "kernels", unet=unet)
    plain_cfg = _train_config(yaml, raw, root, data, "plain", unet={**(unet or {}), **PLAIN_MODULES})
    for sub in ("kernels", "plain"):
        for old in (root / sub / "checkpoints").glob("step_*.pt"):
            old.unlink()

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr = train.main(["--config", str(fused_cfg), "--device", "cuda"])
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    check_staged(counts, staged, f"{name} phase")
    peak = torch.cuda.max_memory_allocated()
    losses = tr.loss_trace.tolist()
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses), f"losses {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"loss did not fall: first 5 steps {first}, last 5 {last}")
    check(counts == {k: per * TRAIN_STEPS for k, per in per_step.items()},
          f"launches in {TRAIN_STEPS} steps {counts}, expected per step {per_step}")
    check(tr.model.denoise_fn.reference_compat == (not unet or unet.get("reference_compat", True)),
          "the trainer's Unet3D lost the reference_compat key")
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

    out_dir = OUT / "gifs" / f"{name}ed_ddim{ddim_steps}_b2"
    ops.reset_launch_counts()
    res = sample.main(["--config", str(fused_cfg), "--checkpoint-path", str(ckpt_dir / f"step_{TRAIN_STEPS}.pt"),
                       "--output-path", str(out_dir), "--batch-size", "2", "--seed", "0", "--device", "cuda",
                       "--sampler", "ddim", "--num-steps", str(ddim_steps), "--load-ema-params"])
    s_counts = nonzero(ops.launch_counts())
    check_staged(s_counts, ops.staged_launch_counts(), f"sampling after the {name} phase")
    check(s_counts == {k: per * ddim_steps for k, per in per_step.items() if "bwd" not in k},
          f"sampling from the trained checkpoint: launches {s_counts} in {ddim_steps} steps")
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
            "launches": counts, "staged_launches": staged, "checkpoints": ckpts, "seconds_per_step": sps,
            "peak_memory": peak,
            "checkpoint_write_seconds": save_s, "plain_checkpoint_write_seconds": plain_save_s,
            "loss_gap_vs_plain": loss_gap,
            "resumed_from": mid, "resumed_losses": r_losses, "plain_losses": plain_losses,
            "plain_seconds_per_step": plain_sps, "plain_peak_memory": plain_peak,
            "sample_seconds": res["seconds"], "sample_steps": ddim_steps, "sample_launches": s_counts,
            "gifs": len(res["paths"])}


DIGITS_CLIPS, DIGITS_HOLDOUT, DIGITS_EVAL_CLIPS = 64, 16, 8


def digits_phase(torch, ops) -> dict:
    """The flagship eval on the train phase's step-30 checkpoint: data from the port's bouncing-digits
    generator at the recipe's shape (64 train, 16 holdout clips of 16 frames), ``evaluate`` with 8 clips and
    no DDPM, every stat finite, the GIFs written, every forward launch of its loss, reconstruction and DDIM-50
    counted and staged. The quality claims (``check``) need the full run and are not applied here."""
    import numpy as np
    from PIL import Image

    from video_diffusion_nnx_tpu_torch import eval_bouncing_digits as ev
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits

    root = SCRATCH / "digits"
    train_npy, hold_npy = root / "bouncing_digits.npy", root / "bouncing_digits_val.npy"
    t0 = time.perf_counter()
    bouncing_digits.main(["--out", str(train_npy), "--clips", str(DIGITS_CLIPS), "--frames", "16",
                          "--holdout-out", str(hold_npy), "--holdout-clips", str(DIGITS_HOLDOUT)])
    gen_seconds = time.perf_counter() - t0
    data = np.load(train_npy)
    check(data.shape == (16, DIGITS_CLIPS, 64, 64) and data.dtype == np.uint8 and data.max() > 0,
          f"generated data {data.shape} {data.dtype}")
    config = SCRATCH / "train" / "kernels.yaml"
    out = OUT / "digits"
    ops.reset_launch_counts()
    stats = ev.evaluate(str(config), str(SCRATCH / "train" / "kernels" / "checkpoints"), TRAIN_STEPS,
                        str(train_npy), str(hold_npy), str(out), eval_clips=DIGITS_EVAL_CLIPS, skip_ddpm=True,
                        device="cuda")
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    check_staged(counts, staged, "digits phase")
    recon = sum(len(ev.recon_times(1000 // frac)) for frac, _ in ev.RECON_FRACTIONS)  # the recipe's T = 1000
    forwards = 2 + 2 * recon + 50  # the two losses, trained and untrained reconstructions, DDIM-50
    check(counts == {k: per * forwards for k, per in PER_FORWARD.items()},
          f"digits phase: launches {counts}, expected {forwards} forwards of {PER_FORWARD}")
    flat = [v for v in stats.values() if isinstance(v, (int, float))]
    flat += [v for k in ("samples_ddim50", "data_holdout") for v in stats[k].values()]
    check(all(math.isfinite(v) for v in flat), f"digits phase: stats {stats}")
    gifs = {p.stem: Image.open(p) for p in out.glob("*.gif")}
    want = {**{f"ddim50_sample_{i}": (64, 64) for i in range(4)}, **{f"recon_T4_pair_{i}": (128, 64) for i in range(2)}}
    check(set(gifs) == set(want) and all(g.size == want[k] and g.n_frames == 10 for k, g in gifs.items()),
          f"digits phase: GIFs {[(k, g.size, g.n_frames) for k, g in gifs.items()]}")
    return {"clips": DIGITS_CLIPS, "holdout_clips": DIGITS_HOLDOUT, "eval_clips": DIGITS_EVAL_CLIPS,
            "generate_seconds": gen_seconds, "eval_seconds": stats.pop("seconds"), "forwards": forwards,
            "launches": counts, "staged_launches": staged, "stats": stats, "gifs": sorted(gifs)}


def long_train_phase(torch, ops, train, sample, name: str = "long_train", unet: dict | None = None,
                     per_step: dict = LONG_PER_STEP, variants=("kernels", "remat_off", "plain")) -> dict:
    """The long-clip recipe (with ``unet`` overrides) through the CLIs: 12 steps at batch 1 on 128-frame
    clips by each of ``variants``, then DDIM-50."""
    import yaml
    from PIL import Image

    from PIL import Image as _Image

    raw = yaml.safe_load(LONG_CONFIG.read_text())
    d = raw["diffusion"]
    root = SCRATCH / name
    root.mkdir(parents=True, exist_ok=True)
    # The recipe reads a folder of GIFs: seeded synthetic 128-frame clips, written through the port's media
    # helpers. Only dataset_path, the output folders and the step counts differ from the file.
    data = bouncing_square_gifs(root / "long_clips", clips=LONG_CLIPS, frames=d["num_frames"], size=d["image_size"])
    gif_frames = sorted({_Image.open(p).n_frames for p in data.glob("*.gif")})
    common = dict(steps=LONG_STEPS, ckpt_every=LONG_CKPT_EVERY)
    extra = {"kernels": {}, "remat_off": {"remat_blocks": False}, "plain": PLAIN_MODULES}
    cfgs = {v: _train_config(yaml, raw, root, data, v, unet={**(unet or {}), **extra[v]}, **common) for v in variants}
    for sub in cfgs:
        for old in (root / sub / "checkpoints").glob("step_*.pt"):
            old.unlink()

    runs = {}
    for variant, cfg in cfgs.items():
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = train.main(["--config", str(cfg), "--device", "cuda"])
        counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
        if variant != "plain":
            check_staged(counts, staged, f"{name} phase, {variant}")
        losses = tr.loss_trace.tolist()
        check(len(losses) == LONG_STEPS and all(math.isfinite(v) for v in losses), f"{variant}: losses {losses}")
        sps, save_s = _seconds_per_step(tr, warmup=3)
        runs[variant] = {"losses": losses, "launches": counts, "staged_launches": staged, "seconds_per_step": sps,
                         "checkpoint_write_seconds": save_s, "peak_memory": torch.cuda.max_memory_allocated(),
                         "checkpoints": sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt"))}
        if variant == "kernels":
            ckpt_dir = tr.checkpoint_dir_path
            check(tr.model.denoise_fn.remat_blocks and tr.max_grad_norm == raw["trainer"]["max_grad_norm"],
                  "the long-clip trainer lost remat_blocks or max_grad_norm")
        del tr
    k = runs["kernels"]
    first, last = sum(k["losses"][:4]) / 4, sum(k["losses"][-4:]) / 4
    check(last < first, f"long-clip loss did not fall: first 4 steps {first}, last 4 {last}")
    check(k["checkpoints"] == list(range(LONG_CKPT_EVERY, LONG_STEPS + 1, LONG_CKPT_EVERY)),
          f"long-clip checkpoints at steps {k['checkpoints']}")
    for variant in variants:
        want = {} if variant == "plain" else {kernel: per * LONG_STEPS for kernel, per in per_step.items()}
        check(runs[variant]["launches"] == want,
              f"{variant}: launches {runs[variant]['launches']} in {LONG_STEPS} steps, expected per step {per_step}")
    gaps = {variant: max(abs(a - b) / abs(b) for a, b in zip(k["losses"], runs[variant]["losses"]))
            for variant in variants if variant != "kernels"}
    check(max(gaps.values()) <= LOSS_TOL,
          f"long-clip losses part from the kernel route's by {gaps} (relative, over {LOSS_TOL})")

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out_dir = OUT / "gifs" / f"{name}_ddim50_b1"
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
    s_counts = nonzero(ops.launch_counts())
    check(s_counts == {kernel: per * res["steps"] for kernel, per in per_step.items() if "bwd" not in kernel},
          f"long-clip sampling: launches {s_counts} in {res['steps']} steps")
    return {"steps": LONG_STEPS, "batch": raw["trainer"]["train_batch_size"], "frames": d["num_frames"],
            "dataset": {"gif_folder": str(data), "clips": LONG_CLIPS, "frames_per_gif": gif_frames},
            "freeze_schedule_buffers": raw["trainer"].get("freeze_schedule_buffers", False),
            "first4": first, "last4": last, "runs": runs, "loss_gaps_vs_kernels": gaps,
            "launches": k["launches"], "staged_launches": k["staged_launches"],
            "sample": {"steps": res["steps"], "seconds": res["seconds"],
                       "seconds_per_step": res["seconds"] / res["steps"], "launches": s_counts,
                       "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}}


def cross_phase(torch, xa, ta) -> dict:
    """Both cross-attention kernels against their plain versions at the sequence-parallel recipe's shapes.

    Forward and all seven gradients at the ten calls' shapes and at a ragged f_g, in bf16 (timed) and
    f32; then the self-attention case f_l = f_g = 32 against the dense temporal kernel.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hd = HEADS * DIM_HEAD
    names = ("cross_attention_fwd", "cross_attention_bwd")
    grad_names = ("dx", "dk", "dv", "dwq", "dbq", "dwo", "dbo")
    rows, agg = [], new_totals(names)

    def operands(x_shape, fg, dtype):
        b, s, _, c = x_shape
        return (rand(torch, x_shape, 1, 0.5, dtype), rand(torch, (b, s, fg, hd), 2, 1.0, dtype),
                rand(torch, (b, s, fg, hd), 3, 1.0, dtype), rand(torch, (c, hd), 4, c ** -0.5, torch.float32),
                rand(torch, (hd,), 5, 0.1, torch.float32), rand(torch, (hd, c), 6, hd ** -0.5, torch.float32),
                rand(torch, (c,), 7, 0.1, torch.float32))

    def record(name, row, err=0.0, count=0, timing=None):
        if timing is not None:
            add_timing(row, agg[name], count, err, *timing)
        rows.append({"kernel": name, **row})
        print("  " + json.dumps(rows[-1]), flush=True)

    shapes = [(count, (B, s, SEQ_FL, c), SEQ_FG) for count, (s, c) in SEQ_CROSS_SHAPES]
    shapes += [(0, (1, 64, 4, 64), 21)]  # a ragged f_g: no padding, no mask, a short last KV block
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        timed = dtype_name == "bfloat16"
        for count, x_shape, fg in shapes:
            a = operands(x_shape, fg, dtype)
            x, k, v, wq, bq, wo, bo = a
            g = rand(torch, x_shape, 9, 0.1, dtype)
            before = route_counts(xa)
            out = xa.fused_cross_attention_block(*a, HEADS, DIM_HEAD)
            grads = xa.cross_attention_bwd(x, g, k, v, wq, bq, wo, HEADS, DIM_HEAD)
            torch.cuda.synchronize()
            now = route_counts(xa)
            check(all(now[n][0] == before[n][0] + 1 for n in names), f"{x_shape}: launches {xa.launches}")
            designs = {n: design_since(before, now, n) for n in names}
            check(all(d == "staged" for d in designs.values()),
                  f"{x_shape}, f_g {fg} in {dtype_name}: the cross kernels ran {designs}, not their staged design")
            err = _max_abs(out, xa.cross_attention_plain(*a, HEADS, DIM_HEAD))
            check(math.isfinite(err) and err <= TOL[dtype_name],
                  f"cross_attention_fwd at {x_shape}, f_g {fg} in {dtype_name}: max-abs error {err} over {TOL[dtype_name]}")
            want = xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, HEADS, DIM_HEAD)
            rel = {n: _rel_err(u, w) for n, u, w in zip(grad_names, grads, want)}
            err_b = max(_max_abs(u, w) for u, w in zip(grads, want))
            for n, r in rel.items():
                check(math.isfinite(r) and r <= BWD_TOL[dtype_name],
                      f"cross_attention_bwd {n} at {x_shape}, f_g {fg} in {dtype_name}: error {r} of its largest "
                      f"value, over {BWD_TOL[dtype_name]}")
            del want, grads, out
            common = {"shape": x_shape, "f_g": fg, "dtype": dtype_name, "per_step": count}
            fwd_row = {**common, "design": designs[names[0]], "max_abs_err": err, "tol": TOL[dtype_name]}
            bwd_row = {**common, "design": designs[names[1]], "rel_err": rel, "max_abs_err": err_b,
                       "tol": BWD_TOL[dtype_name]}
            if not timed:
                record(names[0], fwd_row)
                record(names[1], bwd_row)
                continue
            b, s, fl, c = x_shape
            rows_n, tokens = b * s * fl, b * s
            f_bytes = 2 * (2 * rows_n * c + 2 * tokens * fg * hd + 2 * c * hd) + 4 * (hd + c)
            f_flops = rows_n * (4 * c * hd + 4 * fg * hd)
            b_bytes = 2 * (3 * rows_n * c + 4 * tokens * fg * hd + 2 * c * hd) + 4 * hd + 4 * (2 * c * hd + hd + c)
            b_flops = rows_n * (8 * c * hd + 8 * fg * hd)
            ms_f = cuda_ms(torch, lambda: xa.fused_cross_attention_block(*a, HEADS, DIM_HEAD), 10, 2)
            pl_f = cuda_ms(torch, lambda: xa.cross_attention_plain(*a, HEADS, DIM_HEAD), 5, 1)
            ms_b = cuda_ms(torch, lambda: xa.cross_attention_bwd(x, g, k, v, wq, bq, wo, HEADS, DIM_HEAD), 5, 1)
            pl_b = cuda_ms(torch, lambda: xa.cross_attention_bwd_plain(x, g, k, v, wq, bq, wo, HEADS, DIM_HEAD), 3, 1)
            record(names[0], fwd_row, err, count, (ms_f, pl_f, f_bytes, f_flops))
            record(names[1], bwd_row, err_b, count, (ms_b, pl_b, b_bytes, b_flops))
            del a, x, k, v, g

    # f_l = f_g = 32 with K|V projected from x: the self-attention block of the dense temporal kernel
    # (JAX tests/test_ops.py:328). Forward in both types; in f32 also every gradient through autograd.
    equiv = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        c = 64
        leaves = [rand(torch, (B, 64, SEQ_FG, c), 1, 0.5, dtype), rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32),
                  rand(torch, (3 * hd,), 3, 0.1, torch.float32), rand(torch, (hd, c), 4, hd ** -0.5, torch.float32),
                  rand(torch, (c,), 5, 0.1, torch.float32)]
        g = rand(torch, leaves[0].shape, 9, 0.1, dtype)
        outs = {}
        for route in ("cross", "dense"):
            ls = [t.clone().requires_grad_() for t in leaves]
            x, wqkv, bqkv, wo, bo = ls
            if route == "cross":
                before = route_counts(xa)
                kv = x @ wqkv[:, hd:].to(dtype) + bqkv[hd:].to(dtype)
                y = xa.fused_cross_attention_block(x, kv[..., :hd].contiguous(), kv[..., hd:].contiguous(),
                                                   wqkv[:, :hd], bqkv[:hd], wo, bo, HEADS, DIM_HEAD)
                check(design_since(before, route_counts(xa), "cross_attention_fwd") == "staged",
                      "the self-attention case did not run the staged cross forward")
            else:
                before = ta.launches["temporal_attention_fwd"]
                y = ta.fused_temporal_attention_block(x, wqkv, bqkv, wo, bo, HEADS, DIM_HEAD)
                check(ta.launches["temporal_attention_fwd"] == before + 1, "the dense temporal kernel did not run")
            y.backward(g)
            outs[route] = (y.detach(), [t.grad for t in ls])
        err = _max_abs(outs["cross"][0], outs["dense"][0])
        check(err <= TOL[dtype_name], f"cross kernel at f_l = f_g = 32 against the dense kernel ({dtype_name}): {err}")
        row = {"max_abs_err": err, "tol": TOL[dtype_name]}
        if dtype_name == "float32":
            rel = {n: _rel_err(u, w) for n, u, w in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), outs["cross"][1],
                                                         outs["dense"][1])}
            check(max(rel.values()) <= TOL[dtype_name], f"self-attention equivalence, gradients: {rel}")
            row["grad_rel_err"] = rel
        equiv[dtype_name] = row
    print("  " + json.dumps({"self_attention_equivalence": equiv}), flush=True)
    return {"rows": rows, "per_step": agg, "self_attention_equivalence": equiv}


def seq_rank(rank: int, world: int, gather_init: str, runs: list, out_dir: str) -> None:
    """One rank of phase seq train, in a spawned process: the gather check, then each run of the train CLI's
    rank function (``train.run_rank``), with its launches, losses, times, memory, collectives and a digest of
    the state, written to ``seq_rank<r>.json``."""
    import hashlib

    import torch

    from video_diffusion_nnx_tpu_torch import ops, train
    from video_diffusion_nnx_tpu_torch.parallel import destroy_sequence_group, init_sequence_group
    from video_diffusion_nnx_tpu_torch.utils.schedule import ScheduleBuffers

    out = {"rank": rank}
    group = init_sequence_group(rank, world, "gloo", gather_init)
    try:
        panel = torch.full(SEQ_GATHER_PANEL, float(rank + 1), device=group.device, dtype=torch.bfloat16)
        group.all_gather(panel, 2)  # warm-up
        group.reset_stats()
        t0 = time.perf_counter()
        full = group.all_gather(panel, 2)
        torch.cuda.synchronize(group.device)
        seconds = time.perf_counter() - t0
        per = SEQ_GATHER_PANEL[2]
        correct = full.is_cuda and all(bool((full[:, :, r * per:(r + 1) * per] == r + 1).all()) for r in range(world))
        out["gather"] = {"seconds": seconds, "bytes_in": panel.numel() * 2, "bytes_out": full.numel() * 2,
                         "shape": list(full.shape), "correct": correct, "device": str(group.device)}
        del panel, full
    finally:
        destroy_sequence_group()
    for name, init_method, argv in runs:
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = train.run_rank(rank, world, "gloo", init_method, argv)
        state = tr.model.state_dict()
        digest = hashlib.sha256(b"".join(v.detach().cpu().contiguous().numpy().tobytes() for v in state.values()))
        fresh = ScheduleBuffers.create(tr.model.num_timesteps)
        out[name] = {
            "launches": nonzero(ops.launch_counts()), "staged_launches": nonzero(ops.staged_launch_counts()),
            "losses": tr.loss_trace.tolist(), "step_starts": tr.step_starts,
            "save_seconds": tr.save_seconds, "peak_memory": torch.cuda.max_memory_allocated(),
            "comm": dict(tr.sequence_group.stats), "digest": digest.hexdigest(), "device": str(tr.device),
            "opt_count": tr.opt_count, "is_main": tr.is_main,
            "buffer_drift": {k: (state[k].cpu() - getattr(fresh, k)).abs().max().item()
                             for k in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod")},
        }
        del tr, state
    (Path(out_dir) / f"seq_rank{rank}.json").write_text(json.dumps(out))


def seq_train_phase(torch, train) -> dict:
    """configs/config_seq_parallel.yaml through the train CLI's rank function: 4 ranks on cuda:0 over gloo."""
    import torch.multiprocessing as mp
    import yaml

    raw = yaml.safe_load(SEQ_CONFIG.read_text())
    d = raw["diffusion"]
    check(raw["trainer"]["sequence_parallel_size"] == SEQ_WORLD and d["num_frames"] == SEQ_WORLD * SEQ_FL,
          f"the recipe is not {SEQ_WORLD} ranks of {SEQ_FL} frames: {raw['trainer']}")
    root = SCRATCH / "seq_train"
    root.mkdir(parents=True, exist_ok=True)
    data = bouncing_squares(root / "bouncing_squares_32.npy", clips=SEQ_CLIPS, frames=d["num_frames"],
                            size=d["image_size"])
    common = dict(steps=SEQ_STEPS, ckpt_every=SEQ_CKPT_EVERY)
    cfgs = {"ranks4": _train_config(yaml, raw, root, data, "ranks4", **common),
            "rank1": _train_config(yaml, raw, root, data, "rank1", sequence_parallel_size=1, **common),
            "rank1_fused": _train_config(yaml, raw, root, data, "rank1_fused", unet={"use_fused_attention": True},
                                         sequence_parallel_size=1, **common)}
    for old in [*root.glob("*/checkpoints/step_*.pt"), *root.glob("store_*"), *root.glob("seq_rank*.json")]:
        old.unlink()
    argv = ["--config", str(cfgs["ranks4"]), "--device", "cuda", "--dist-backend", "gloo"]
    runs = [("run", f"file://{root / 'store_run'}", argv),
            ("resume", f"file://{root / 'store_resume'}", argv + ["--resume_step", str(SEQ_CKPT_EVERY)])]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(seq_rank, args=(SEQ_WORLD, f"file://{root / 'store_gather'}", runs, str(root)), nprocs=SEQ_WORLD,
             join=True)
    spawn_seconds = time.perf_counter() - t0
    ranks = [json.loads((root / f"seq_rank{r}.json").read_text()) for r in range(SEQ_WORLD)]

    for r in ranks:
        check(r["gather"]["correct"] and r["gather"]["device"] == "cuda:0", f"rank {r['rank']}: gather {r['gather']}")
        for name, steps in (("run", SEQ_STEPS), ("resume", SEQ_STEPS - SEQ_CKPT_EVERY)):
            want = {k: per * steps for k, per in SEQ_PER_STEP.items()}
            check(r[name]["launches"] == want and r[name]["device"] == "cuda:0",
                  f"rank {r['rank']} {name}: launches {r[name]['launches']} on {r[name]['device']}, expected {want}")
        for name in ("run", "resume"):
            check(r[name]["staged_launches"] == r[name]["launches"],
                  f"rank {r['rank']} {name}: staged launches {r[name]['staged_launches']} of {r[name]['launches']}")
    run0 = ranks[0]["run"]
    for name in ("run", "resume"):
        check(len({r[name]["digest"] for r in ranks}) == 1, f"{name}: the ranks' states differ")
        check(all(r[name]["losses"] == ranks[0][name]["losses"] for r in ranks), f"{name}: the ranks' losses differ")
    losses = run0["losses"]
    check(len(losses) == SEQ_STEPS and all(math.isfinite(v) for v in losses), f"4-rank losses {losses}")
    drift = run0["buffer_drift"]
    check(drift["alphas_cumprod"] == 0 and drift["sqrt_alphas_cumprod"] > 0 and drift["sqrt_one_minus_alphas_cumprod"] > 0,
          f"full-state Adam: buffer drift {drift}")
    ckpts = sorted(int(p.stem[5:]) for p in (root / "ranks4" / "checkpoints").glob("step_*.pt"))
    check(ckpts == [SEQ_CKPT_EVERY, SEQ_STEPS], f"checkpoints of the 4-rank run at steps {ckpts}")
    resumed = ranks[0]["resume"]["losses"]
    check(all(math.isnan(v) for v in resumed[:SEQ_CKPT_EVERY]) and all(math.isfinite(v) for v in resumed[SEQ_CKPT_EVERY:])
          and ranks[0]["resume"]["opt_count"] == SEQ_STEPS - SEQ_CKPT_EVERY, f"resumed losses {resumed}")

    # One rank of the same recipe (temporal attention through the modules), and the control: the same with the
    # dense temporal kernels, another valid bf16 route. The gate is 1.5x the control's largest relative per-step
    # gap plus a margin; the 4-rank losses must stay within it and the same losses 1% off must not.
    one = {}
    for name in ("rank1", "rank1_fused"):
        torch.cuda.reset_peak_memory_stats()
        tr = train.main(["--config", str(cfgs[name]), "--device", "cuda"])
        sps, _ = _seconds_per_step(tr, warmup=2)
        one[name] = {"losses": tr.loss_trace.tolist(), "seconds_per_step": sps,
                     "peak_memory": torch.cuda.max_memory_allocated()}
        del tr
    ref = one["rank1"]["losses"]

    def gap(ls):
        return max(abs(a - b) / abs(b) for a, b in zip(ls, ref))

    control = gap(one["rank1_fused"]["losses"])
    gate = 1.5 * control + SEQ_GATE_MARGIN
    gap4 = gap(losses)
    off = gap([(1 + SEQ_CONTROL_OFF) * v for v in losses])
    check(gap4 <= gate, f"4-rank losses part from the 1-rank run's by {gap4} (relative), over the gate {gate} "
                        f"(control {control}): {losses} against {ref}")
    check(off > gate, f"the loss gate {gate} misses losses {SEQ_CONTROL_OFF:.0%} off ({off})")

    starts, saves = run0["step_starts"], run0["save_seconds"]
    warm = 2
    sps4 = (starts[-1] - starts[warm] - sum(v for k, v in saves.items() if int(k) >= warm)) / (len(starts) - 1 - warm)
    steps = SEQ_STEPS
    return {"world": SEQ_WORLD, "backend": "gloo", "device": run0["device"], "steps": steps,
            "batch": raw["trainer"]["train_batch_size"], "frames": d["num_frames"], "losses": losses,
            "launches_per_rank": run0["launches"], "launches": {k: sum(r["run"]["launches"][k] for r in ranks)
                                                               for k in SEQ_PER_STEP},
            "staged_launches": {k: sum(r["run"]["staged_launches"].get(k, 0) for r in ranks) for k in SEQ_PER_STEP},
            "checkpoints": ckpts, "buffer_drift": drift, "resumed_losses": resumed, "seconds_per_step": sps4,
            "peak_memory_per_rank": [r["run"]["peak_memory"] for r in ranks],
            "collectives_per_rank_per_step": {k: v / steps for k, v in run0["comm"].items()},
            "gather_panel": ranks[0]["gather"], "spawn_seconds": spawn_seconds,
            "one_rank": one, "loss_gate": {"gap_4_ranks": gap4, "control_gap": control, "gate": gate,
                                          "control_1pct_off_gap": off}}


def seq_sample_phase(torch, ops, sample) -> dict:
    """The sampling CLI on one rank from the 4-rank run's final checkpoint: DDIM-10 at batch 1, 32 frames."""
    from PIL import Image

    root = SCRATCH / "seq_train"
    ckpt = root / "ranks4" / "checkpoints" / f"step_{SEQ_STEPS}.pt"
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = sample.main(["--config", str(root / "ranks4.yaml"), "--checkpoint-path", str(ckpt), "--output-path",
                       str(OUT / "gifs" / "seq_ddim10_b1"), "--batch-size", "1", "--seed", "0", "--device", "cuda",
                       "--sampler", "ddim", "--num-steps", "10"])
    videos = res["videos"]
    frames = SEQ_WORLD * SEQ_FL
    check(tuple(videos.shape) == (1, 1, frames, 64, 64), f"seq samples: shape {tuple(videos.shape)}")
    check(bool(torch.isfinite(videos).all()), "seq samples: non-finite values")
    img = Image.open(res["paths"][0])
    check(img.n_frames == frames and img.size == (64, 64), f"{res['paths'][0].name}: {img.n_frames} frames")
    counts = nonzero(ops.launch_counts())
    check(not counts, f"one rank of the recipe samples through the modules: launches {counts}")
    return {"steps": res["steps"], "sample_seconds": res["seconds"], "seconds_per_step": res["seconds"] / res["steps"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the PyTorch port's main path on one CUDA card and check it.")
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated phase names (e.g. 'kernels,long sla'): run these alone, then stop")
    only = ap.parse_args(argv).only

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
    from video_diffusion_nnx_tpu_torch.ops import cross_attention as xa
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
        if only is not None and title not in only:
            return None
        t0 = time.perf_counter()
        results[title] = res = fn(*args, **kwargs)
        phase(title, seconds=time.perf_counter() - t0, **show(res))
        return res

    def brief(res):
        return {k: v for k, v in res.items() if k != "per_tensor"}

    def per_step(res, key):
        return {key: {k: {m: v[m] for m in ("ms", "plain_ms", "bound_ms", "err")} for k, v in res[key].items()}}

    t0 = time.perf_counter()
    _build.build_all()
    results["build_seconds"] = time.perf_counter() - t0
    (OUT / "build_log.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in _build.build_logs.items()))
    phase("build", seconds=results["build_seconds"], sources=list(_build.SOURCES))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sla_totals(totals):
        return {k: {m: totals[k][m] for m in ("ms", "plain_ms", "bound_ms", "err")} for k in SLA_FWD}

    kern = timed("kernels", kernel_phase, torch, ta, sla,
                 show=lambda r: {"tf32": "off (matmul and cudnn)", "checks": len(r["rows"]), "tolerance": TOL,
                                 **per_step(r, "per_forward"), "relative": r["rel_err"],
                                 "sla_per_forward": {k: sla_totals(a) for k, a in r["sla_per_forward"].items()}})
    timed("unet", unet_phase, torch, load_config, build_models)
    timed("sample", sample_phase, torch, ops, load_config, build_models, save_checkpoint, sample)
    bwd = timed("backward", backward_phase, torch, ta, sla,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": BWD_TOL, **per_step(r, "per_step"),
                                "forward_per_step": per_step(r, "fwd_per_step")["fwd_per_step"],
                                "float32_per_step": per_step(r, "f32_per_step")["f32_per_step"]})
    timed("grads", grads_phase, torch, ops, ta, sla, load_config, build_models,
          show=brief)
    trained = timed("train", train_phase, torch, ops, train, sample)
    timed("digits", digits_phase, torch, ops)
    blk = timed("blockwise", blockwise_phase, torch, ta,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                **per_step(r, "per_step")})
    timed("long sla", long_sla_phase, torch, sla,
          show=lambda r: {"checks": len(r["rows"]), "tolerance": TOL, "relative": r["rel_err"],
                          "per_step": {dt: sla_totals(a) for dt, a in r["per_step"].items()}})
    timed("long unet", unet_phase, torch, load_config, build_models, config_path=LONG_CONFIG, batch=1)
    timed("long grads", grads_phase, torch, ops, ta, sla, load_config, build_models, config_path=LONG_CONFIG,
          batch=1, long_clip=True, show=brief)
    long_trained = timed("long train", long_train_phase, torch, ops, train, sample)

    # Wide columns (C3): the streaming kernels' mode DENSE, the CUDA-core context kernel's rounding points (C2),
    # then the dim-128 recipe's Unet3D forward and backward through the kernels.
    wide = timed("wide", wide_phase, torch, ta,
                 show=lambda r: {"checks": len(r["rows"]), **per_step(r, "per_step")})
    timed("ctx rounding", ctx_rounding_phase, torch, sla)
    timed("dim128 unet", unet_phase, torch, load_config, build_models, config_path=DIM128_CONFIG, batch=DIM128_BATCH)
    dim128 = timed("dim128 grads", grads_phase, torch, ops, ta, sla, load_config, build_models,
                   config_path=DIM128_CONFIG, batch=DIM128_BATCH, per_step=DIM128_PER_STEP, show=brief)

    # Fixed math: the biased kernels, the spatial kernels' q scale, then both recipes with reference_compat off.
    biased = timed("biased", biased_phase, torch, ta,
                   show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                   **{dt: per_step({"p": a}, "p")["p"] for dt, a in r["per_step"].items()}})
    timed("sla scale", sla_scale_phase, torch, sla, show=lambda r: {
        "checks": len(r["rows"]), "scale": SLA_SCALE, **{dt: per_step({"p": a}, "p")["p"] for dt, a in r["per_step"].items()}})
    timed("fixed unet", unet_phase, torch, load_config, build_models, unet=FIXED)
    timed("fixed grads", grads_phase, torch, ops, ta, sla, load_config, build_models, unet=FIXED,
          per_step=FIXED_PER_STEP, show=brief)
    fixed_trained = timed("fixed train", train_phase, torch, ops, train, sample, name="fixed_train", unet=FIXED,
                          per_step=FIXED_PER_STEP, ddim_steps=50)
    timed("long fixed unet", unet_phase, torch, load_config, build_models, config_path=LONG_CONFIG, batch=1,
          unet=FIXED)
    timed("long fixed grads", grads_phase, torch, ops, ta, sla, load_config, build_models, config_path=LONG_CONFIG,
          batch=1, long_clip=True, unet=FIXED, per_step=FIXED_LONG_PER_STEP, show=brief)
    long_fixed_trained = timed("long fixed train", long_train_phase, torch, ops, train, sample,
                               name="long_fixed_train", unet=FIXED, per_step=FIXED_LONG_PER_STEP,
                               variants=("kernels", "plain"))

    # The sequence-parallel recipe: its cross-attention kernels, then 4 ranks training on the one card.
    cross = timed("cross", cross_phase, torch, xa, ta,
                  show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                  "self_attention_equivalence": r["self_attention_equivalence"],
                                  **per_step(r, "per_step")})
    seq = timed("seq train", seq_train_phase, torch, train,
                show=lambda r: {k: v for k, v in r.items() if k != "resumed_losses"})
    timed("seq sample", seq_sample_phase, torch, ops, sample)
    if only is not None:
        (OUT / "results.json").write_text(json.dumps(results, indent=1, default=str))
        return 0

    # Every kernel with the launches of the training path that runs it: the flagship's for the six dense and
    # spatial kernels, the long-clip recipe's for the blockwise pair, the two fixed recipes' for the biased
    # kernels, the dim-128 recipe's step for the wide pair. Times are of the type that path hands the kernel:
    # bf16 in compat math, float32 in fixed math.
    # Each kernel's design is that of its launches in that run, as the C entries reported them.
    aggregates, launches, dtypes, designs = {}, {}, {}, {}

    def from_path(name, path):
        launches[name] = path["launches"][name]
        designs[name] = design(launches[name], path.get("staged_launches", {}).get(name, 0))

    for name in PER_STEP:
        a = dict((kern["per_forward"] if name in PER_FORWARD else bwd["per_step"])[name])
        if name in PER_FORWARD:
            a["err"] = max(a["err"], bwd["fwd_err"][name])
        aggregates[name] = a
        from_path(name, trained)
    for name, a in blk["per_step"].items():
        aggregates[name] = a
        from_path(name, long_trained)
    for name, a in biased["per_step"]["float32"].items():
        aggregates[name], dtypes[name] = a, "float32"
        from_path(name, fixed_trained if "attention" in name else long_fixed_trained)
    for name, a in cross["per_step"].items():  # launches summed over the four ranks of the seq train run
        aggregates[name] = a
        from_path(name, seq)
    for name in ("temporal_wide_fwd", "temporal_wide_bwd"):  # one fwd + bwd of the dim-128 recipe
        aggregates[name] = wide["per_step"][name]
        from_path(name, dim128)
    results["off_path_kernels"] = {name: {**wide["per_step"][name], "launches": 0, "source": KERNELS[name]["source"],
                                          "replaces": KERNELS[name]["replaces"]} for name in OFF_PATH}
    kernels_line = [{
        "name": name, "route": "cuda", "design": designs[name],
        "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
        "launches": launches[name], "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"] else "operations",
        "library_ms": None, "dtype": dtypes.get(name, "bfloat16"),
    } for name, a in aggregates.items()]
    check(all(k["launches"] > 0 for k in kernels_line) and len(kernels_line) == len(KERNELS) - len(OFF_PATH) == 16,
          f"a kernel of the main paths was never launched: {[(k['name'], k['launches']) for k in kernels_line]}")
    results["kernels_line"] = kernels_line
    (OUT / "results.json").write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
