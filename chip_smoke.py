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
   DDPM over the config's 1000 steps at batch 2; GIFs checked; every step a
   replay of the denoiser's CUDA graph (``diffusion/graphs.py``), so each
   forward kernel's wrapper launches twice per capture (a warm-up forward,
   then the capture) and never at a replay, counted over this phase alone
   (so in every sampler run of the phases below); every launch of the spatial
   forward pair must have run its staged kernel (so in phases 8, 12 and 16);
5b. dpm: the same CLI with ``--sampler dpm --num-steps 20`` at batch 4;
5c. graph: DDPM's first 100 steps at batch 2, DDIM-50 and DPM-20 at batch 4, each graphed
   and eager from the same generator seed: outputs bit-equal (else within
   1e-3 on [0, 1]), seconds per step eager, graphed with its capture and warm,
   exact launches, all staged; peak memory with one cached graph (batch 4)
   and with four (batches 1, 2, 4, 8);
5d. extend: ``video_diffusion_nnx_tpu_torch.extend.main`` on phase 5b's first
   clip, keeping 4 of 10 frames, DDIM-10 with reconstruction guidance 2 at
   batch 2: the kept frames exactly as given, a forward and a backward of
   each attention kernel per step (eager), all staged; seconds per step;
5e. serve: ``video_diffusion_nnx_tpu_torch.serve`` in-process on a free port
   around the recipe's seeded weights: /health, a solo DDIM-50 request
   against ``ddim_sample`` with its seed, 8 concurrent batch-1 DDIM-50
   requests coalesced and each held to its solo run (0.02 on [0, 1]), clips
   per second coalesced against --no-batching at 8 clients
   (``bench_serve.compare``), and an /extend request;
6. backward: each backward kernel against its plain version at every shape
   the flagship training step (batch 8) gives it, and at one wide-frame
   shape, in bf16 and f32, TF32 off; CUDA-event times, each timed row's share
   of its bound (``bound_share``) and per-step totals (``sla_bwd_kv`` also in
   f32, what fixed math hands it; the dense temporal backward in f32 where a
   3xTF32 design takes it, each row with its route (``design``) and its bound
   at 67 and at 495 / 3 TFLOP/s); at the same inputs the forward kernels and
   the context kernel's softmax statistics against their plain versions, and
   the dense temporal forward's bf16 times per training step;
7. grads: one ``p_losses`` and ``backward`` of the flagship Unet3D in bf16
   (batch 8) with the kernels, against the plain modules, both against f32;
   controls: the same checks catch an attention backward that is off;
8. train: ``video_diffusion_nnx_tpu_torch.train.main`` on the flagship
   config with a seeded synthetic dataset, 14 steps at batch 8: the loss
   falls, checkpoints are written, a resume from the middle one continues,
   every kernel's launches per step are exact; seconds per step (checkpoint
   writes left out) and peak memory; the same steps through the plain
   modules (fused flags off), whose losses agree step by step; the trained
   checkpoint samples through the sampling CLI (DDIM-10);
8b. digits: the flagship eval (``eval_bouncing_digits.evaluate``) on that
   run's step-14 checkpoint, with 64 train and 16 holdout clips of real
   handwritten digits from the port's generator (``data/bouncing_digits.py``)
   at the recipe's shape: 8 eval clips, reconstructions at T/8, T/4, T/2 for
   the trained and the untrained model, DDIM-50 at batch 8, no DDPM; every
   stat finite, the GIFs written, exact forward launches, all staged. The
   eval's quality claims need the full 20000-step run and are not applied;
8c. cond: the caption-conditioned recipe (configs/config_bouncing_digits_cond.yaml:
   768-wide text embeddings of the file names, condition dropout 0.2) through
   the train CLI on 8 captioned GIFs per class from the port's generator, 20
   steps at batch 8: exact launches, all staged; each step's loss within 2% of
   the plain modules' and a control (every condition swapped for the null
   embedding, the same draws) that must part by more; seconds per step, peak
   memory;
8d. cfg: classifier-free guidance from that run's checkpoint: DDIM-10 at batch
   4 and cond_scale 1 and 3, graphed against eager (bit-equal, else within
   1e-3) and graphed warm seconds per step at each scale (guidance doubles a
   forward's rows); the batched guidance forward against a conditioned and a
   null forward; DPM-20 and the first 100 steps of the recipe's DDPM chain with text; the sampling CLI
   with ``--text "two digits" --cond-scale 3``; the extension CLI with text and
   reconstruction guidance 2; the server: a conditioned /sample, two coalesced
   text requests each within 0.02 of its solo run, 400 without text;
8e. train options (run last, after phase 19): the trainer's options on the flagship recipe
   through the train CLI, 6-step runs on the train phase's kind of data with a checkpoint every 3
   steps and the EMA from step 0 (derived keys only): gradient accumulation (A = 2: one step with
   injected t and noise against the unaccumulated step, the loss within 2% and each gradient tensor
   within the grads phase's 0.03, exactly twice each kernel's launches, all staged; s/step and peak
   memory), ``flatten_optimizer`` (the same elementwise step: bit-equal losses, parameters and EMA
   against the run without it; host launches per step), asynchronous checkpoints (each present and
   loadable, byte-equal to the synchronous run's, the loop's blocking seconds per save), sampling during training (2 EMA clips
   at step 3, GIFs checked, losses bit-equal to the run without; also the caption-conditioned
   recipe with its text at cond_scale 3), the profiler (a Chrome trace of steps 0-1 alone, counted
   by its kernel events), then all five options together through the CLI with exact launches. The
   kernels line gives each flagship kernel's launches in one step with and without accumulation
   (``launches_per_step``, ``launches_per_step_accumulated``) beside the main path's ``launches``;
8f. dit kernels, dit d1, dit d2, dit train, dit cond (run before train options): the VideoDiT family at
   two recipes, derived in code: D1, configs/config_bouncing_digits.yaml with the DiT of
   scripts/ab_dit_fused.py:35-39 (dim 256, depth 6, 8 heads of 32, patch 4) at 16 frames, and D2,
   bench.py's do_dit shape (dim 384, depth 8, 6 heads of 64, patch 8, 10 frames, batch 4). Every
   attention of both hands the temporal op float32; each call's kernel and route are
   ``temporal_plan``'s for this card, and every launch is checked against them. dit kernels: the four
   attention shapes of each recipe (D1 at batch 8) in float32 against their plain versions, with times
   and bounds per step (every backward of both takes the float32 tensor-core design of
   csrc/temporal_tf32x3.cu, route "tf32x3", D1's temporal one by the measured rule; every forward but D2's
   temporal one the staged or streaming kernel in 3xTF32, route "staged-3xtf32"; both also bounded at 495 / 3
   TFLOP/s); dit d1 / d2: the recipe's
   forward and one loss with its backward through the
   kernels against the plain modules and float32 on one batch (the adaLN and output weights drawn at
   std 0.05 first: they start at zero, and then no attention has a gradient), the loss within 2%, the
   gradients to the grads phase's gates with its largest control fault caught, every attention weight's
   gradient nonzero; D2 also DDIM-10 at batch 4, graphed against eager; dit train: D1 through the train
   CLI (4 steps at batch 8 on 16-frame squares, checkpoints every 2, a resume), the sampling CLI's
   DDIM-50 and DPM-20 at batch 8 (graphed; DDIM-50 bit-equal to the eager sampler), and the server
   with 2 batch-1 DDIM-50 clients against their solo runs and against serial; dit cond: D1 on captions
   (hashed bag of words, dropout 0.2), 10 train CLI steps on 16-frame captioned clips, then the
   sampling CLI with ``--text`` at cond_scale 3, each kernel launch on 2b rows;
8g. distill, guidance distill, dit guidance (after dit cond): distillation (ROADMAP A13). distill: the
   train phase's step-14 weights as the teacher, two rounds (N = 8 -> 4) of 5 steps at batch 8 with EMA
   0.99 through the distill CLI: exact launches (three forwards and a backward a step), all staged; each
   step's loss within 2% of the same steps through the plain modules; the schedule buffers bit-unchanged,
   the students parted from the teacher; the EMA against its formula over two library steps; DDIM-4 on
   the stride grid from the round's file through the sampling CLI, graphed, bit-equal to eager; s/step
   and peak memory. guidance distill: the cond phase's weights as the teacher; the zero graft bit-equal
   to the teacher's cond_scale-1 forward at w = 1, 3, 8; 5 steps at batch 8 with w ~ U[1, 8] through the
   distill_guidance CLI against the plain modules (2%), exact launches; one stage-2 round through the
   distill CLI on its config_guidance.yaml; DDIM-10 at cond_scale 3 through the sampling CLI, one forward
   of b rows a step; warm s/step against the teacher's guided step; the server with 2 batch-1 clients at
   cond_scale 3 against their solo runs. dit guidance: the conditioned D1 (dit cond's weights): the zero
   graft, 3 guidance steps at batch 8 on the planner's kernels in float32, DDIM-10 at cond_scale 3 on 4
   rows a launch. The kernels line's ``distill`` field holds each kernel's launches in those runs;
9. blockwise: both blockwise (online-softmax) temporal kernels against their
   plain versions at every shape the long-clip Unet3D gives them (batch 1,
   128 frames), at the 256-long bottleneck shape of a 128x128 input and at
   two ragged lengths (65, 100), in bf16 and f32, TF32 off; in f32 also
   against the dense plain versions; every long-clip shape must run the
   streaming kernels (as the C entries report), but the f32 backward the
   planner's 3xTF32 design (the streaming kernel up to c = 32, the tf32x3
   chain above); CUDA-event times (the f32 backward's at the long clip's
   shapes, with its bound at 67 and at 495 / 3 TFLOP/s);
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
    ``dataset_path``, the output folders and the step counts differ), 6
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
    also against the dense plain versions; each backward on the design the
    planner gives it; CUDA-event times in both types, the f32 backward's
    also bounded at 495 / 3 TFLOP/s;
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
    checkpoint; every float32 temporal backward launch on the design the
    planner gives its shape (the staged dense kernel in 3xTF32 up to c = 64,
    the streaming one up to c = 32, the tf32x3 chain above: exact counts of
    each a step);
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
    only: a seeded 32-frame dataset, 2 steps, a checkpoint every 1): 4 ranks
    sharing cuda:0 over gloo, named explicitly. First a 4-rank all-gather of a
    (2, 4096, 8, 256) bf16 panel through the group. Then exact launches per
    rank per step (10 + 10 cross kernels, nothing else, all staged), the ranks'
    parameters bit-equal, ``sqrt_alphas_cumprod`` drifted and
    ``alphas_cumprod`` bit-exact (full-state Adam), a resume from step 1; the
    per-step loss against a 1-rank run of the same recipe (temporal attention
    through the modules) within a gate derived from a control (the 1-rank
    run with the dense temporal kernels), which the 4-rank losses scaled by
    1.01 must fail; seconds per step, peak memory per rank, bytes and host
    seconds in the collectives;
19. seq sample: the sampling CLI on one rank from rank 0's checkpoint,
    DDIM-10 at batch 1 and 32 frames;
19b. dp train, tp train, seq dp train: the trainer's multi-device paths. Seq
    train's spawn of 4 gloo ranks sharing cuda:0 runs, after its own runs,
    every multi-rank run through the train CLI's rank function (one process
    start for all), each in a world of its own: the flagship as
    shipped over 4 data ranks of 2 rows (4 steps, a checkpoint at step 2), a
    resume from that file at 2 ranks with an EMA sample of 4 rows at step 2
    (graph-replayed, its GIFs from rank 0 alone), the same 4 steps under
    ``param_sharding: fsdp``; configs/config_tpu_v2_3.yaml as shipped on
    (data 2 x model 2) (2 steps, Adam's state in an async checkpoint at step
    1, a resume from it); the seq recipe on (data 2 x seq 2) (2 steps), then
    at batch 4 under accumulation (A = 2, 2 steps). Per run: exact launches
    on every rank; the ranks' replicated state bit-equal (and the
    shards of ranks at one place on the shard axis); each sharded tensor's
    resident parameter, Adam moments and EMA 1/4 (FSDP) or 1/2 (model axis)
    of one rank's; peak memory, s/step and collectives per rank. Losses held
    against one rank's run of the same recipe (the flagship's and the
    dim-128's here, the dim-128 after JAX's clamp warning; the seq recipe's
    against seq train's 4-rank run) within 1.5x a control's largest relative
    gap (the same recipe through the plain modules; seq train's control)
    plus 0.001, which the losses scaled by 1.01 must fail; FSDP's final state
    from DP's within 1.5x DP's from one rank's plus 0.001 (distances over the
    update from the seeded weights); the dim-128 ranks on the routes one rank
    of the recipe takes (its widest columns on CUDA-core kernels), every other
    run all staged; the files from shards
    one-rank files (keys, shapes, whole moments), loadable into a one-rank
    model;
19c. dp sample, dp serve, dp distill (the last after phase 8g): data ranks
    outside the trainer, over the same spawn's 4 ranks of 2 rows, each CLI's
    ``run_rank``: the sample CLI's DDIM-50 and the extend CLI's (4 known
    frames) at batch 8 from the train phase's checkpoint, each rank replaying
    its own graph, rank 0 alone writing the GIFs, every gathered row within
    0.02 of the one-rank CLI's and the pinned frames equal; the server (rank
    0 serving HTTP, the others following its calls) with 8 concurrent
    batch-1 DDIM-50 clients, each row within 0.02 of one rank's
    ``ddim_sample`` of its seed, /health counting 4 devices, clips per second
    against the serve phase's one rank; both distillation CLIs, 3 steps at
    batch 8 (the train phase's weights, the cond phase's), the ranks' losses
    and students (parameters, EMA, Adam's moments) bit-equal, the files from
    rank 0 alone, the losses against the distillation phases' first 3 steps
    within 1.5x the plain-module run's gap plus 0.001 (the losses scaled by
    1.01 must fail). Exact launches on every rank, all staged;
20. kernels line: one JSON object per kernel of a driven path (launches over
    its train phase, the wide pair's over the dim-128 step, error, times,
    bound, and ``design``: "staged" where every launch of that run ran its
    staged or streaming kernel (panels in shared memory, tensor cores in
    bf16), "cuda-core" where each ran the first version, both where the
    shapes split, as the C entries reported each launch, "staged-3xtf32"
    where the staged or streaming kernel ran in float32 with its products in
    3xTF32, "3xtf32" where the tf32x3 chain ran; the temporal kernels add
    "float32: ..." and ``staged_tf32x3_launches`` / ``tf32x3_launches``, the
    driven paths where each float32 tensor-core design ran: the fixed
    recipes' biased forwards and backwards, their bottleneck, D1's and D2's attentions). The biased wide
    pair, which no recipe reaches, is held in the wide phase and reported in
    results.json apart from the line. Each entry's ``dit`` field holds its
    launches in the DiT runs (D1's training, the conditioned D1's, one D2
    step) and, for the kernels of the DiT path, its float32 times per step
    at each recipe's shapes; its ``multi_rank`` field, its launches summed
    over the ranks of each multi-rank phase's runs.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before it. ``--only kernels,long sla`` runs the device check, the
build and the named phases alone (extend and serve read the clip that dpm
writes, digits and distill the train phase's checkpoint, cfg and guidance distill the cond phase's, dit guidance
dit cond's), then stops without the kernels line and the
ok line (those two phases call only the ops' public wrappers, so a copy of
this file in another checkout times that checkout's kernels). Outputs go to
chiprun_out/chip_smoke/ (small) and build/chip_smoke/ (checkpoints and data).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
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
PEAK_TF32X3_FLOPS = 495e12 / 3  # float32 products as three TF32 tensor-core products (csrc/temporal_tf32x3.cu)

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
TRAIN_STEPS, CKPT_EVERY = 14, 7  # 20 and 10 before the data-rank phases needed the room
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
LONG_DENSE_SHAPE = (1, 128, 64, 256)  # the long clip's bottleneck spatial attention, unbiased in both maths
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
LONG_STEPS, LONG_CKPT_EVERY, LONG_CLIPS = 6, 3, 32  # 12 and 6 before the data-rank phases needed the room
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
# The unbiased bottleneck (f = 64, c = 256), float32 in fixed math, whose staged tile holds no token: its forward takes
# the streaming kernel in mode DENSE (``temporal_wide_fwd``) by the measured rule ``_f32_fwd_takes_stream``.
FIXED_PER_STEP = {"temporal_attention_biased_fwd": 10, "temporal_attention_biased_bwd": 10,
                  "temporal_wide_fwd": 1, "temporal_attention_bwd": 1, **SLA_PER_STEP}
FIXED_LONG_PER_STEP = {"temporal_blockwise_biased_fwd": 10, "temporal_blockwise_biased_bwd": 10,
                       "temporal_wide_fwd": 1, "temporal_attention_bwd": 1, **SLA_PER_STEP}
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
SEQ_STEPS, SEQ_CKPT_EVERY, SEQ_CLIPS = 2, 1, 16  # 2 steps (4 before the data-rank phases needed the room; a rank-step takes about 3 s on one card)
SEQ_GATHER_PANEL = (2, 4096, 8, 256)  # one rank's K panel at the widest level, bf16
SEQ_CONTROL_OFF = 0.01  # the 4-rank losses scaled by 1 + this must fail the loss gate
SEQ_GATE_MARGIN = 0.001  # added to 1.5x the control's relative loss gap
SEQ_WARM = 1  # steps before the timed one in the seq recipe's runs (2 at 4 steps)
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


class WarningRecords(logging.Handler):
    """The port's warning messages logged while the block runs (``with WarningRecords() as records``)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("video_diffusion_nnx_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("video_diffusion_nnx_tpu_torch").removeHandler(self)


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
    """Per kernel of the op modules ``mods``: (launches, of them those that ran the staged kernel, those that ran
    the float32 tensor-core backward of csrc/temporal_tf32x3.cu, those of the staged ones that ran the staged or
    streaming float32 backward in 3xTF32)."""
    return {k: (n, getattr(m, "staged", {}).get(k, 0), getattr(m, "tf32x3", {}).get(k, 0),
                getattr(m, "staged_tf32x3", {}).get(k, 0))
            for m in mods for k, n in m.launches.items()}


def design(launches: int, staged: int, tf32x3: int = 0, staged3: int = 0) -> str:
    """The kernel ``launches`` ran, from the route each launch's C entry reported: "staged" (panels in x's
    type, the products on the tensor cores in bf16), "staged-3xtf32" (the staged dense or streaming kernel in
    float32, forward or backward, its products on the tensor cores in split-precision TF32), "3xtf32" (the float32 backward of
    csrc/temporal_tf32x3.cu, in 3xTF32 too), "cuda-core" (the first version), or several of them."""
    parts = [n for n, k in (("staged", staged - staged3), ("staged-3xtf32", staged3), ("3xtf32", tf32x3),
                            ("cuda-core", launches - staged - tf32x3)) if k]
    return "/".join(parts) or "cuda-core"


# The design names of the planner's routes (``temporal_plan``), as ``design`` writes them.
ROUTE_DESIGN = {"staged": "staged", "staged-3xtf32": "staged-3xtf32", "tf32x3": "3xtf32", "simt": "cuda-core"}


def add_3xtf32_bound(row: dict, total: dict | None, count: int, nbytes: float, flops: float) -> None:
    """Beside a float32 kernel on the tensor cores (either 3xTF32 design), its bound at the 3xTF32 rate (495 / 3
    TFLOP/s) as well as at 67 TFLOP/s, so that no share reads over 1; summed into ``total`` per step."""
    b3, by3 = bound_ms(nbytes, flops, PEAK_TF32X3_FLOPS)
    row.update(bound_ms_3xtf32=b3, bound_by_3xtf32=by3, bound_share_3xtf32=b3 / row["ms"])
    if total is not None and count:
        total["bound_ms_3xtf32"] = total.get("bound_ms_3xtf32", 0.0) + count * b3


def f32_routes(ta, shapes, sms: int) -> tuple[dict, dict]:
    """Per step, of the float32 launches at ``shapes`` ((count, (b, s, f, c), biased) each, one forward and one
    backward), those the planner gives the tf32x3 design (backward) and those it gives the staged or streaming
    3xTF32 kernel (forward or backward), by kernel name."""
    tf, st = {}, {}
    for count, (b, s, f, c), biased in shapes:
        for way in ("fwd", "bwd"):
            plan = ta.temporal_plan(b * s, f, c, DIM_HEAD, HEADS, False, sms, way == "bwd")
            family = "attention" if plan["family"] == "dense" else plan["family"]
            name = f"temporal_{family}{'_biased' if biased else ''}_{way}"
            for want, route in ((tf, "tf32x3"), (st, ta.STAGED_3XTF32)):
                if plan["route"] == route:
                    want[name] = want.get(name, 0) + count
    return tf, st


def design_since(before: dict, now: dict, name: str) -> str:
    """The design of ``name``'s launches between two :func:`route_counts`."""
    return design(*(a - b for a, b in zip(now[name], before[name])))


def check_staged(counts: dict, staged: dict, where: str) -> None:
    """Every launch of the spatial forward pair ran its staged kernel, as the C entries reported."""
    for name in SLA_FWD:
        check(counts.get(name, 0) > 0 and staged.get(name, 0) == counts[name],
              f"{where}: {staged.get(name, 0)} of {counts.get(name, 0)} launches of {name} ran the staged kernel")


def check_graphed(counts: dict, graph: dict, steps: int, where: str, per: dict = PER_FORWARD,
                  captures: int = 1) -> None:
    """A sampler run through the denoiser's CUDA graph: each forward kernel launched by its wrapper twice per
    capture (the warm-up forward, then the capture) and never at a replay; every step a replay."""
    check(graph == {"captures": captures, "replays": steps},
          f"{where}: graphs {graph}, expected {captures} capture(s) and {steps} replays")
    want = {k: n * 2 * captures for k, n in per.items() if "bwd" not in k}
    check(counts == want, f"{where}: launches {counts}, expected {want} (per forward x 2 x captures)")


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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            plan = ta.temporal_plan(b * s, f, c, DIM_HEAD, HEADS, timed, sms, False)
            name = "temporal_attention_fwd" if plan["family"] == "dense" else f"temporal_{plan['family']}_fwd"
            ran = design_since(before, route_counts(ta, sla), name)
            check(ran == ROUTE_DESIGN[plan["route"]], f"{name} at {shape} in {dtype_name} ran {ran}, "
                                                      f"planned {plan['route']}")
            if timed:
                tokens = b * s
                nbytes = elt * (2 * tokens * f * c + 3 * c * hd + hd * c) + 4 * (3 * hd + c)
                flops = 2 * tokens * f * (c * 3 * hd + hd * c) + 4 * tokens * HEADS * f * f * DIM_HEAD
                ms = cuda_ms(torch, lambda: ta.fused_temporal_attention_block(*args), 20)
                plain = cuda_ms(torch, lambda: ta.temporal_attention_plain(*args), 10)
                record("temporal_attention_fwd", shape, dtype_name, err, count, (ms, plain, nbytes, flops))
            else:
                record(name, shape, dtype_name, err, count)

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


def flagship_checkpoint(torch, load_config, build_models, save_checkpoint) -> Path:
    """The flagship recipe's seeded weights as a checkpoint file (written once, read by the sampler phases)."""
    ckpt = SCRATCH / "ckpt.pt"
    if not ckpt.exists():
        _, diffusion = build_models(load_config(CONFIG), device="cuda")
        save_checkpoint(ckpt, diffusion)
    return ckpt


def sample_phase(torch, ops, load_config, build_models, save_checkpoint, sample, runs_spec=None) -> dict:
    """The sampling CLI at the flagship recipe from a checkpoint: GIFs checked, every step a replay of the
    denoiser's graph, exact wrapper launches, every spatial forward launch staged."""
    from PIL import Image

    config = load_config(CONFIG)
    ckpt = flagship_checkpoint(torch, load_config, build_models, save_checkpoint)
    frames, size = config["diffusion"]["num_frames"], config["diffusion"]["image_size"]
    runs = {}
    ops.reset_launch_counts()
    captures, forwards = 0, 0
    for name, batch, flags in runs_spec or (("ddim50_b4", 4, ["--sampler", "ddim", "--num-steps", "50"]),
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
        check(res["graph"] == {"captures": 1, "replays": res["steps"]}, f"{name}: graphs {res['graph']}")
        captures += 1
        forwards += res["steps"]
        for p in res["paths"]:
            img = Image.open(p)
            check(img.n_frames == frames and img.size == (size, size),
                  f"{p.name}: {img.n_frames} frames of {img.size}")
        runs[name] = {"steps": res["steps"], "seconds": res["seconds"],
                      "seconds_per_step": res["seconds"] / res["steps"],
                      "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"]),
                      "range": [float(videos.min()), float(videos.max())], "graph": res["graph"]}
        (SCRATCH / "clips").mkdir(exist_ok=True)
        torch.save(videos[0].clone(), SCRATCH / "clips" / f"{name}.pt")  # (c, f, h, w) in [0, 1], for the extend phase
    counts, staged = ops.launch_counts(), ops.staged_launch_counts()
    check_staged(counts, staged, "flagship sampling")
    check_graphed(nonzero(counts), {"captures": captures, "replays": forwards}, forwards, "flagship sampling",
                  captures=captures)
    return {"runs": runs, "launches": counts, "staged_launches": staged, "forwards": forwards,
            "captures": captures}


DPM_RUN = (("dpm20_b4", 4, ["--sampler", "dpm", "--num-steps", "20"]),)
# DDPM's chain is held graphed against eager over its first GRAPH_DDPM_STEPS steps (the whole 1000 until the
# multi-rank phases needed the room: some 30 s of eager steps at batch 2, then 8 s of graphed ones); the sample phase
# runs the whole graphed chain through the CLI.
GRAPH_DDPM_STEPS = 100
GRAPH_RUNS = (("ddpm100_b2", "ddpm", 2, GRAPH_DDPM_STEPS), ("ddim50_b4", "ddim", 4, 50), ("dpm20_b4", "dpm", 4, 20))
GRAPH_BATCHES = (1, 2, 4, 8)  # the serving batches (padded to powers of two up to max_batch_rows 8)
GRAPH_TOL = 1e-3  # on [0, 1], where graphed and eager are not bit-equal; never wider


def ddpm_prefix(torch, diffusion, generator, graph: bool, batch: int, steps: int, cond=None, cond_scale: float = 1.0):
    """The first ``steps`` steps of the DDPM chain from x_T (each step's noise drawn in the sampler's order), with an
    embedded condition at ``cond_scale`` where given; the raw image after them."""
    shape = (batch, diffusion.channels, diffusion.num_frames, diffusion.image_size, diffusion.image_size)
    img = torch.randn(shape, generator=generator, device="cuda")
    with torch.no_grad():
        for i in reversed(range(diffusion.num_timesteps - steps, diffusion.num_timesteps)):
            noise = torch.randn(shape, generator=generator, device="cuda")
            t = torch.full((batch,), i, dtype=torch.long, device="cuda")
            img = diffusion.p_sample(img, t, noise=noise, graph=graph, cond=cond, cond_scale=cond_scale)
    return img


def _sampler(diffusion, kind: str, batch: int, steps: int):
    if kind == "ddim":
        return lambda g, graph: diffusion.ddim_sample(batch_size=batch, num_steps=steps, generator=g, graph=graph)
    return lambda g, graph: diffusion.dpm_solver_sample(batch_size=batch, num_steps=steps, generator=g, graph=graph)


def graph_phase(torch, ops, load_config, build_models) -> dict:
    """Each sampler of the flagship recipe graphed and eager from the same generator seed, in this call: the
    outputs bit-equal, seconds per step (host clock ending in a synchronize) eager, graphed with its capture and
    graphed warm (DDPM once graphed: its capture is 1/100 of the run), exact wrapper launches (eager:
    per forward x steps; graphed: per forward x 2 at the capture, none at a replay), all staged; then peak
    memory with one cached graph and with four (batches 1, 2, 4, 8). DDPM's chain is its first
    ``GRAPH_DDPM_STEPS`` steps."""
    _, diffusion = build_models(load_config(CONFIG), device="cuda")
    diffusion.eval()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def timed_run(fn, seed, graph):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(gen(seed), graph)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, nonzero(ops.launch_counts()), ops.staged_launch_counts()

    runs = {}
    for seed, (name, kind, batch, steps) in enumerate(GRAPH_RUNS):
        fn = (functools.partial(ddpm_prefix, torch, diffusion, batch=batch, steps=steps) if kind == "ddpm"
              else _sampler(diffusion, kind, batch, steps))
        row = {}
        diffusion.graphs.clear()  # each run captures its own graph: its first run pays for the capture
        replays0, captures0 = diffusion.graphs.replays(), diffusion.graphs.captures
        graphed, sec, counts, staged = timed_run(fn, seed, True)
        check_staged(counts, staged, f"graph {name}")
        graph = {"captures": diffusion.graphs.captures - captures0, "replays": diffusion.graphs.replays() - replays0}
        check_graphed(counts, graph, steps, f"graph {name}")
        row.update(graphed_launches=counts, graphed_staged=nonzero(staged), **graph)
        row["graphed_first_s_per_step"] = sec / steps
        eager_steps = steps
        if kind != "ddpm":
            again, sec, counts, _ = timed_run(fn, seed, True)
            check(not counts and torch.equal(again, graphed), f"graph {name}: a warm replay run launched {counts}")
            row["graphed_warm_s_per_step"] = sec / steps
        eager, sec, counts, staged = timed_run(fn, seed, False)
        check_staged(counts, staged, f"eager {name}")
        check(counts == {k: n * eager_steps for k, n in PER_FORWARD.items()}, f"eager {name}: launches {counts}")
        row["eager_launches"], row["eager_s_per_step"], row["eager_steps"] = counts, sec / eager_steps, eager_steps
        row["max_abs_graphed_vs_eager"] = _max_abs(graphed, eager)
        row["bit_equal"] = bool(torch.equal(graphed, eager))
        check(row["bit_equal"] or row["max_abs_graphed_vs_eager"] <= GRAPH_TOL,
              f"graph {name}: graphed and eager part by {row['max_abs_graphed_vs_eager']} (gate {GRAPH_TOL})")
        check(bool(torch.isfinite(graphed).all()), f"graph {name}: non-finite samples")
        row["batch"], row["steps"] = batch, steps
        runs[name] = row

    # Peak memory: the weights alone, then one graph (batch 4), then the four serving batches.
    memory = {}
    diffusion.graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    memory["weights_allocated"] = torch.cuda.memory_allocated()
    for label, batches in (("one_graph_b4", (4,)), ("four_graphs_b1_2_4_8", GRAPH_BATCHES)):
        diffusion.graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            diffusion.dpm_solver_sample(batch_size=b, num_steps=2, generator=gen(b))
        torch.cuda.synchronize()
        check(len(diffusion.graphs) == len(batches), f"{label}: {len(diffusion.graphs)} cached graphs")
        memory[label] = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
                         "memory_allocated_after": torch.cuda.memory_allocated(),
                         "memory_reserved_after": torch.cuda.memory_reserved()}
    diffusion.graphs.clear()
    return {"runs": runs, "memory": memory, "tol_if_not_bit_equal": GRAPH_TOL}


def extend_phase(torch, ops, load_config, build_models, save_checkpoint) -> dict:
    """The extension CLI on the dpm phase's first clip: keep 4 of 10 frames, DDIM-10 with reconstruction
    guidance 2 at batch 2. The kept frames come out exactly as given (through [-1, 1] and back, on the card); a
    forward and a backward of each attention kernel per step, every launch staged; no graph (guided steps run
    eagerly); seconds per step."""
    import numpy as np

    from video_diffusion_nnx_tpu_torch import extend

    clip = torch.load(SCRATCH / "clips" / "dpm20_b4.pt")  # (1, 10, 64, 64) in [0, 1]
    npy = SCRATCH / "clips" / "dpm20_b4_255.npy"
    np.save(npy, (clip.float().numpy() * 255.0).astype(np.float32))
    ckpt = flagship_checkpoint(torch, load_config, build_models, save_checkpoint)
    steps, keep = 10, 4
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = extend.main(["--config", str(CONFIG), "--checkpoint-path", str(ckpt), "--input", str(npy),
                       "--keep-frames", str(keep), "--num-steps", str(steps), "--recon-guidance", "2",
                       "--batch-size", "2", "--seed", "0", "--output-path", str(OUT / "gifs" / "extend"),
                       "--device", "cuda"])
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    check(res["graph"] == {"captures": 0, "replays": 0}, f"extend: guided steps captured graphs {res['graph']}")
    check(counts == {k: n * steps for k, n in PER_STEP.items()}, f"extend: launches {counts}")
    check(all(staged.get(k, 0) == n for k, n in counts.items()), f"extend: staged {staged} of {counts}")
    videos, known = res["videos"], torch.from_numpy(res["known"]).cuda()
    pinned = ((known * 2 - 1) + 1) * 0.5  # normalize_img then unnormalize_img, as the sampler pins them
    check(tuple(videos.shape) == (2, 1, 10, 64, 64) and bool(torch.isfinite(videos).all()),
          f"extend: {tuple(videos.shape)} samples")
    check(torch.equal(videos[:, :, :keep], pinned[None, :, :keep].cpu().expand(2, -1, -1, -1, -1)),
          "extend: the kept frames are not the input's")
    return {"steps": steps, "keep_frames": keep, "recon_guidance": 2.0, "batch": 2, "sample_seconds": res["seconds"],
            "seconds_per_step": res["seconds"] / steps, "launches": counts, "staged_launches": staged,
            "kept_max_abs_vs_input": _max_abs(videos[:, :, :keep], known[None, :, :keep].cpu()),
            "generated_range": [float(videos[:, :, keep:].min()), float(videos[:, :, keep:].max())],
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}


SERVE_CLIENTS, SERVE_STEPS, SERVE_TOL = 8, 50, 0.02


def serve_phase(torch, ops, load_config, build_models) -> dict:
    """The port's sampling server in-process on a free port around the flagship recipe's seeded weights:
    /health; a solo DDIM-50 request against ``ddim_sample`` with its seed; 8 concurrent batch-1 DDIM-50 requests
    coalesced, each held to its solo run within 0.02 on [0, 1]; clips per second coalesced against
    --no-batching through ``bench_serve``; an /extend request over HTTP."""
    import base64
    import io
    import threading
    import urllib.request

    import numpy as np

    from video_diffusion_nnx_tpu_torch import bench_serve, serve

    _, model = build_models(load_config(CONFIG), device="cuda")
    model.eval()
    httpd = serve.create_server(model, host="127.0.0.1", port=0, batch_window_s=0.05)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        url = "http://%s:%d" % httpd.server_address[:2]
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["device"] == "cuda", f"/health: {health}")
        service = httpd.service

        def solo(seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return model.ddim_sample(batch_size=1, num_steps=SERVE_STEPS, generator=g).float().cpu().numpy()

        rows, seconds, extra = service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": 0})
        out["solo_request"] = {"seconds": seconds, **extra, "max_abs_vs_ddim_sample": float(np.abs(rows - solo(0)).max())}
        check(out["solo_request"]["max_abs_vs_ddim_sample"] <= SERVE_TOL, f"solo request: {out['solo_request']}")

        results = [None] * SERVE_CLIENTS

        def client(i):
            results[i] = service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": i})

        ops.reset_launch_counts()
        replays0 = model.graphs.replays()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(all(r is not None for r in results), "coalesced clients: a request did not return")
        replays, counts = model.graphs.replays() - replays0, nonzero(ops.launch_counts())
        groups = sorted({r[2]["coalesced"] for r in results}, reverse=True)
        errs = [float(np.abs(r[0] - solo(i)).max()) for i, r in enumerate(results)]
        out["coalesced"] = {"groups": groups, "seconds": [r[1] for r in results], "max_abs_vs_solo": errs,
                            "tol": SERVE_TOL, "replays": replays, "launches": counts}
        check(groups[0] >= 2, f"coalesced clients: groups {groups}")
        check(max(errs) <= SERVE_TOL, f"coalesced rows part from their solo runs by {max(errs)} (gate {SERVE_TOL})")

        clip = torch.load(SCRATCH / "clips" / "dpm20_b4.pt").float().numpy()
        buf = io.BytesIO()
        np.save(buf, clip)
        payload = {"known_npy_b64": base64.b64encode(buf.getvalue()).decode(), "frame_mask": [True] * 4 + [False] * 6,
                   "batch_size": 2, "num_steps": 10, "seed": 1}
        ext = bench_serve.post(url, payload, path="/extend")
        check(ext["shape"] == [2, 1, 10, 64, 64] and len(ext["gifs"]) == 2, f"/extend: {ext['shape']}")
        out["extend_request"] = {"time_s": ext["time_s"], "shape": ext["shape"]}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    out["throughput"] = bench_serve.compare(model, [SERVE_CLIENTS], SERVE_STEPS, 0.05)  # also at 2 clients before
    out["cached_graph_shapes"] = model.graphs.shapes()
    return out


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kv_f32 = new_totals(("sla_bwd_kv",))  # sla_bwd_kv in float32, what the fixed recipe hands it (one pass)
    # the dense backward in float32 where it takes a tensor-core design (3xTF32): the staged kernel up to c = 64,
    # the tf32x3 chain above (the fixed recipe's unbiased bottleneck among them)
    tf32x3_f32 = new_totals(("temporal_attention_bwd",))

    def record_fwd(name, shape, dtype, err, tol, what="max-abs"):
        check(math.isfinite(err) and err <= tol, f"{name} at {shape} in {dtype}: {what} error {err} over {tol}")
        if what == "max-abs" and name in fwd_err:
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
            family = ta.temporal_plan(b * s, f, c, DIM_HEAD, HEADS, timed, sms, False)["family"]  # f32 (64, 256): wide
            record_fwd(f"temporal_{'attention' if family == 'dense' else family}_fwd", (b, s, f, c), dtype_name, err_f,
                       TOL[dtype_name])
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
            rows_n = b * s * f
            nbytes = elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
            flops = rows_n * (22 * c * hd + 12 * f * hd)
            now = route_counts(ta)["temporal_attention_bwd"]
            tc3 = any(now[i] > before["temporal_attention_bwd"][i] for i in (2, 3))  # either 3xTF32 design
            if timed or tc3:
                ms = cuda_ms(torch, lambda: ta.temporal_attention_bwd(*args), 5, 1)
                plain = cuda_ms(torch, lambda: ta.temporal_attention_bwd_plain(*args), 5, 1)
                record("temporal_attention_bwd", (b, s, f, c), dtype_name, outs, count, ms, plain, nbytes, flops,
                       None if timed else tf32x3_f32["temporal_attention_bwd"], PEAK_BF16_FLOPS if timed else PEAK_F32_FLOPS)
                if tc3:  # also at the tensor cores' 3xTF32 rate
                    add_3xtf32_bound(rows[-1], tf32x3_f32["temporal_attention_bwd"], count, nbytes, flops)
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
    return {"rows": rows, "per_step": agg, "fwd_err": fwd_err, "fwd_per_step": fwd_step, "f32_per_step": kv_f32,
            "tf32x3_per_step": tf32x3_f32}


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
    agg_f32 = new_totals(names[1:])  # the float32 backward on the long clip's path shapes (3xTF32 designs)
    grad_names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

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
            # the streaming kernels (in float32 in 3xTF32), but for the float32 backward the planner's 3xTF32 design
            # (the streaming kernel up to c = 32, the tf32x3 chain above)
            want = tuple(ROUTE_DESIGN[ta.temporal_plan(b * s, f, c, DIM_HEAD, HEADS, timed, sms, bwd)["route"]]
                         for bwd in (False, True))
            check(designs == dict(zip(names, want)) and (not count or (
                      want[0] == ("staged" if timed else "staged-3xtf32")
                      and want[1] in ("staged", "staged-3xtf32", "3xtf32"))),
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
                if count:  # the path's shapes: the float32 backward's time, bound at 67 and 495 / 3 TFLOP/s
                    rows_n = b * s * f
                    b_bytes = elt * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
                    b_flops = rows_n * (22 * c * hd + 12 * f * hd)
                    ms_b = cuda_ms(torch, lambda: ta.temporal_attention_bwd(x, g, *w, HEADS, DIM_HEAD), 3, 1)
                    pl_b = cuda_ms(torch, lambda: ta.temporal_attention_blockwise_bwd_plain(x, g, *w, HEADS, DIM_HEAD,
                                                                                           kb), 3, 1)
                    bwd_row = {"kernel": names[1], "shape": shape, "dtype": dtype_name, "per_step": count, **bwd_row}
                    add_timing(bwd_row, agg_f32[names[1]], count, err_b, ms_b, pl_b, b_bytes, b_flops, PEAK_F32_FLOPS)
                    add_3xtf32_bound(bwd_row, agg_f32[names[1]], count, b_bytes, b_flops)
                    rows.append(bwd_row)
                    print("  " + json.dumps(bwd_row), flush=True)
                else:
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
    return {"rows": rows, "per_step": agg, "f32_per_step": agg_f32}


def biased_phase(torch, ta) -> dict:
    """The four biased temporal kernels against their plain versions; times in both types.

    The fixed recipes hand these kernels float32 (the PreNorm's LayerNorm promotes the bf16
    activations), so the f32 instantiation is the main path's and its bound takes the float32 rate;
    the bf16 instantiation is part of the op and is held and timed too. Per shape: forward
    (the dense family at the sampling batch) and backward with dbias (at the training batch)
    against the family's plain versions, in f32 the blockwise pair also against the dense ones, and a zero
    bias against the unbiased kernel, bit for bit. The float32 backward takes the planner's 3xTF32 design (the
    staged dense kernel up to c = 64, the streaming one up to c = 32, the tf32x3 chain above), also bounded at
    the 3xTF32 rate.
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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [("attention", n, sh, (B_TRAIN, *sh[1:])) for n, sh in BIASED_DENSE_SHAPES]
    shapes += [("blockwise", n, sh, sh) for n, sh in [*LONG_TEMPORAL_SHAPES, *EXTRA_BLOCKWISE_SHAPES]]
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        elt, peak = (4, PEAK_F32_FLOPS) if dtype_name == "float32" else (2, PEAK_BF16_FLOPS)
        for family, count, f_shape, b_shape in shapes:
            f_plan = ta.temporal_plan(f_shape[0] * f_shape[1], f_shape[2], f_shape[3], DIM_HEAD, HEADS,
                                      dtype_name == "bfloat16", sms, False)
            f_family = "attention" if f_plan["family"] == "dense" else f_plan["family"]  # f32 (64, 256): wide
            names = (f"temporal_{f_family}_biased_fwd", f"temporal_{family}_biased_bwd")
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
            planned = f_plan["route"]
            check(row["design"] == ROUTE_DESIGN[planned] and (not count or planned != "simt"),
                  f"{names[0]} at {f_shape} in {dtype_name} ran the {row['design']} design, planned {planned}")
            if not dense and dtype_name == "float32":
                row["vs_dense_plain"] = _max_abs(got, ta.temporal_attention_plain(x, *w, HEADS, DIM_HEAD, pos_bias=bias))
                check(row["vs_dense_plain"] <= TOL[dtype_name], f"{names[0]} at {f_shape} against the dense plain version: {row}")
            rows_n = f_shape[0] * f_shape[1] * f
            nbytes = elt * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * panel
            flops = rows_n * (8 * c * hd + 4 * f * hd + HEADS * f)  # the unbiased count and one add per logit
            ms = cuda_ms(torch, lambda: ta.fused_temporal_attention_block_biased(x, *w, bias, HEADS, DIM_HEAD), 5, 1)
            pl = cuda_ms(torch, lambda: plain_f(x, *w, HEADS, DIM_HEAD, *kb, pos_bias=bias), 3, 1)
            total = agg[dtype_name].get(names[0], new_totals(names[:1])[names[0]])  # off path: a total of its own
            add_timing(row, total, count, err, ms, pl, nbytes, flops, peak)
            if "3xtf32" in row["design"]:
                add_3xtf32_bound(row, total, count, nbytes, flops)
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
            planned = ta.temporal_plan(b_shape[0] * b_shape[1], f, c, DIM_HEAD, HEADS, dtype_name == "bfloat16", sms,
                                       True)["route"]
            check(row["design"] == ROUTE_DESIGN[planned] and (dense or not count or planned != "simt"),
                  f"{names[1]} at {b_shape} in {dtype_name} ran the {row['design']} design, planned {planned}")
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
            if "3xtf32" in row["design"]:
                add_3xtf32_bound(row, agg[dtype_name][names[1]], count, nbytes, flops)
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
    """The wide pair (mode DENSE of the streaming kernels; the float32 backward the tensor-core design of
    csrc/temporal_tf32x3.cu) against the dense plain versions at f = 64 and
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        elt, peak = (4, PEAK_F32_FLOPS) if dtype_name == "float32" else (2, PEAK_BF16_FLOPS)
        bf16 = dtype_name == "bfloat16"
        for count, shape in [(0, WIDE_DENSE_REF), *WIDE_SHAPES]:
            b, s, f, c = shape
            for biased in (False, True):
                tag = "_biased" if biased else ""
                family = "attention" if shape == WIDE_DENSE_REF else "wide"
                # the dense forward still holds c = 320 in bf16 (its tile refuses c >= 374; the backward's c >= 309); in
                # float32 the streaming kernel takes the forward at f = 64 from c = 256 (the measured rule)
                f_plan = ta.temporal_plan(b * s, f, c, DIM_HEAD, HEADS, bf16, sms, False)
                f_family = "attention" if f_plan["family"] == "dense" else "wide"
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
                # the streaming kernels (in float32 in 3xTF32), but for the float32 backward: the tensor-core design
                # (csrc/temporal_tf32x3.cu)
                want_fwd, want_bwd = ("staged", "staged") if bf16 else ("staged-3xtf32", "3xtf32")
                check(family == "attention" or (design[1] == want_bwd and (design[0] == want_fwd or f_family == "attention")),
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
                per_step: dict = PER_STEP, ddim_steps: int = 10, f32: tuple = ({}, {})) -> dict:
    """The flagship recipe (with ``unet`` overrides) through the CLIs: TRAIN_STEPS steps at batch 8, a resume, the
    same steps through the plain modules, then DDIM from the trained checkpoint. ``f32``: per step, the float32
    launches of the tf32x3 design and of the staged 3xTF32 kernels, forward and backward (``f32_routes``)."""
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
    tf32x3, staged3 = nonzero(ops.tf32x3_launch_counts()), nonzero(ops.staged_tf32x3_launch_counts())
    check_staged(counts, staged, f"{name} phase")
    # in fixed math every temporal attention is float32: each launch, forward and backward, took the design the
    # planner gave its shape
    for got, want, what in ((tf32x3, f32[0], "3xtf32"), (staged3, f32[1], "staged-3xtf32")):
        want = {k: n * TRAIN_STEPS for k, n in want.items()}
        check(got == want, f"{name} phase: {what} launches {got}, expected {want}")
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
    check_graphed(s_counts, res["graph"], ddim_steps, f"sampling after the {name} phase", per=per_step)
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
            "launches": counts, "staged_launches": staged, "tf32x3_launches": tf32x3,
            "staged_tf32x3_launches": staged3, "checkpoints": ckpts, "seconds_per_step": sps,
            "peak_memory": peak,
            "checkpoint_write_seconds": save_s, "plain_checkpoint_write_seconds": plain_save_s,
            "loss_gap_vs_plain": loss_gap,
            "resumed_from": mid, "resumed_losses": r_losses, "plain_losses": plain_losses,
            "plain_seconds_per_step": plain_sps, "plain_peak_memory": plain_peak,
            "sample_seconds": res["seconds"], "sample_steps": ddim_steps, "sample_launches": s_counts,
            "gifs": len(res["paths"])}


DIGITS_CLIPS, DIGITS_HOLDOUT, DIGITS_EVAL_CLIPS = 64, 16, 8


def digits_phase(torch, ops) -> dict:
    """The flagship eval on the train phase's last checkpoint: data from the port's bouncing-digits
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
    # The two losses and the trained and untrained reconstructions run eagerly; DDIM-50 replays its graph, whose
    # warm-up and capture ran the wrappers twice.
    forwards = 2 + 2 * recon + 2
    graph = stats.pop("graph")
    check(graph == {"captures": 1, "replays": 50}, f"digits phase: DDIM-50 graphs {graph}")
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
            "generate_seconds": gen_seconds, "eval_seconds": stats.pop("seconds"), "forwards": forwards, "graph": graph,
            "launches": counts, "staged_launches": staged, "stats": stats, "gifs": sorted(gifs)}


COND_CONFIG = REPO / "configs" / "config_bouncing_digits_cond.yaml"
COND_CLIPS_PER_CLASS, COND_STEPS, COND_CKPT_EVERY = 8, 20, 10
COND_PROMPTS = ["one digit", "two digits", "three digits", "two digits"]


def cond_phase(torch, ops, train) -> dict:
    """The caption-conditioned flagship (configs/config_bouncing_digits_cond.yaml: ``use_bert_text_cond``, condition
    dropout 0.2) through the train CLI on 8 captioned clips per class of the port's generator, 20 steps at batch 8:
    exact launches, all staged; each step's loss against the same steps through the plain modules within
    ``LOSS_TOL``; a control, the kernel route with every condition swapped for the null embedding (the generator's
    draws unchanged), must part from the plain modules by more than that; seconds per step and peak memory."""
    import shutil

    import yaml

    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits

    raw = yaml.safe_load(COND_CONFIG.read_text())
    root = SCRATCH / "cond"
    gifs = root / "gifs"
    if gifs.is_dir():
        shutil.rmtree(gifs)
    t0 = time.perf_counter()
    bouncing_digits.main(["--captioned-gifs", str(gifs), "--frames", str(raw["diffusion"]["num_frames"]),
                          "--captioned-clips-per-class", str(COND_CLIPS_PER_CLASS)])
    gen_seconds = time.perf_counter() - t0
    check(len(list(gifs.glob("*.gif"))) == 3 * COND_CLIPS_PER_CLASS, f"cond phase: GIFs in {gifs}")
    out = {"clips": 3 * COND_CLIPS_PER_CLASS, "generate_seconds": gen_seconds, "steps": COND_STEPS,
           "batch": raw["trainer"]["train_batch_size"], "null_cond_prob": raw["trainer"]["null_cond_prob"]}
    losses = {}
    for name, unet in (("kernels", None), ("plain", PLAIN_MODULES), ("null_control", None)):
        cfg = _train_config(yaml, raw, root, gifs, name, unet=unet, steps=COND_STEPS, ckpt_every=COND_CKPT_EVERY)
        for old in (root / name / "checkpoints").glob("step_*.pt"):
            old.unlink()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        if name == "null_control":
            _, _, tr = build_trainer(load_config(cfg), device="cuda")
            unet_mod = tr.model.denoise_fn

            def to_null(module, args, kwargs):
                kwargs["cond"] = module.null_cond_emb.detach().expand(args[0].shape[0], -1)
                return args, kwargs

            unet_mod.register_forward_pre_hook(to_null, with_kwargs=True)
            tr.train()
        else:
            tr = train.main(["--config", str(cfg), "--device", "cuda"])
        check(tr.use_path_as_cond and tr.model.denoise_fn.has_cond, f"cond phase {name}: the trainer is unconditioned")
        losses[name] = tr.loss_trace.tolist()
        check(len(losses[name]) == COND_STEPS and all(math.isfinite(v) for v in losses[name]),
              f"cond phase {name}: losses {losses[name]}")
        sps, save_s = _seconds_per_step(tr)
        row = {"losses": losses[name], "seconds_per_step": sps, "checkpoint_write_seconds": save_s,
               "peak_memory": torch.cuda.max_memory_allocated()}
        if name == "kernels":
            counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
            check_staged(counts, staged, "cond phase")
            check(counts == {k: per * COND_STEPS for k, per in PER_STEP.items()},
                  f"cond phase: launches in {COND_STEPS} steps {counts}, expected per step {PER_STEP}")
            check(all(staged.get(k, 0) == n for k, n in counts.items()), f"cond phase: staged {staged} of {counts}")
            row.update(launches=counts, staged_launches=nonzero(staged),
                       checkpoint=str(tr.checkpoint_path(COND_STEPS)), config=str(cfg))
        out[name] = row
        del tr
    plain = losses["plain"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], plain))
    control_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["null_control"], plain))
    out.update(loss_gap_vs_plain=gap, null_control_gap_vs_plain=control_gap, loss_tol=LOSS_TOL)
    check(gap <= LOSS_TOL, f"cond phase: losses of the kernel route and the plain modules part by {gap} "
                           f"(relative, over {LOSS_TOL})")
    check(control_gap > LOSS_TOL, f"cond phase: the null-condition control parts from the plain modules by only "
                                  f"{control_gap} (gate {LOSS_TOL}): the gate cannot see the condition")
    return out


def cfg_phase(torch, ops, sample, cond) -> dict:
    """Classifier-free guidance from the cond phase's step-20 checkpoint (its trained weights): DDIM-10 at batch 4
    and cond_scale 3 graphed against eager (bit-equal, else within ``GRAPH_TOL``); the batched guidance forward
    against a conditioned and a null forward (the flagship unet gate); DPM-20 and the first GRAPH_DDPM_STEPS steps
    of the recipe's DDPM chain with text; warm graphed seconds per step at cond_scale 1 and 3; the sampling CLI with ``--text "two digits"
    --cond-scale 3``; the extension CLI with text and reconstruction guidance 2; the server with text: a /sample,
    two coalesced requests each held to its solo run (``SERVE_TOL``), and 400 for a request without text."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    from PIL import Image

    from video_diffusion_nnx_tpu_torch import extend, serve
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint

    cfg_path, ckpt = cond["kernels"]["config"], cond["kernels"]["checkpoint"]
    config = load_config(cfg_path)
    _, model = build_models(config, device="cuda")
    load_checkpoint(model, ckpt)
    model.eval()
    d = config["diffusion"]
    frames, size = d["num_frames"], d["image_size"]
    b = len(COND_PROMPTS)
    out = {"prompts": COND_PROMPTS}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def run(fn, graph):
        ops.reset_launch_counts()
        captures0, replays0 = model.graphs.captures, model.graphs.replays()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        videos = fn(graph)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        graph_counts = {"captures": model.graphs.captures - captures0, "replays": model.graphs.replays() - replays0}
        return videos, sec, nonzero(ops.launch_counts()), ops.staged_launch_counts(), graph_counts

    # Graphed against eager, and the seconds per step at cond_scale 1 and 3 (graphed warm, and eager).
    steps = 10
    rows = {}
    for cs in (1.0, 3.0):
        def ddim(graph, cs=cs):
            return model.ddim_sample(num_steps=steps, generator=gen(0), graph=graph, cond=COND_PROMPTS, cond_scale=cs)

        graphed, _, counts, staged, graph = run(ddim, True)
        check_staged(counts, staged, f"cfg ddim{steps} cs{cs:g} graphed")
        check_graphed(counts, graph, steps, f"cfg ddim{steps} cs{cs:g}")
        warm, warm_s, counts, _, _ = run(ddim, True)
        check(not counts and torch.equal(warm, graphed), f"cfg cs{cs:g}: a warm replay run launched {counts}")
        eager, eager_s, counts, staged, graph = run(ddim, False)
        check(graph == {"captures": 0, "replays": 0}, f"cfg cs{cs:g} eager: graphs {graph}")
        check(counts == {k: n * steps for k, n in PER_FORWARD.items()}, f"cfg cs{cs:g} eager: launches {counts}")
        check_staged(counts, staged, f"cfg ddim{steps} cs{cs:g} eager")
        err = _max_abs(graphed, eager)
        rows[f"cs{cs:g}"] = {"graphed_warm_s_per_step": warm_s / steps, "eager_s_per_step": eager_s / steps,
                             "bit_equal": bool(torch.equal(graphed, eager)), "max_abs_graphed_vs_eager": err}
        check(rows[f"cs{cs:g}"]["bit_equal"] or err <= GRAPH_TOL,
              f"cfg cs{cs:g}: graphed and eager part by {err} (gate {GRAPH_TOL})")
        check(tuple(graphed.shape) == (b, 1, frames, size, size) and bool(torch.isfinite(graphed).all()),
              f"cfg cs{cs:g}: samples {tuple(graphed.shape)}")
        rows[f"cs{cs:g}"]["range"] = [float(graphed.min()), float(graphed.max())]
    out[f"ddim{steps}_b{b}"] = rows
    out["cs3_over_cs1_graphed_warm"] = rows["cs3"]["graphed_warm_s_per_step"] / rows["cs1"]["graphed_warm_s_per_step"]

    # The batched guidance forward against two forwards of b rows.
    unet = model.denoise_fn
    x = rand(torch, (b, 1, frames, size, size), 21, 1.0, torch.float32)
    t = torch.linspace(10, 900, b, device="cuda").long()
    emb = model.embed_cond(COND_PROMPTS)
    with torch.no_grad():
        guided = unet.forward_with_cond_scale(x, t, cond=emb, cond_scale=3.0)
        c = unet(x, t, cond=emb, null_cond_mask=torch.zeros(b, dtype=torch.bool, device="cuda"))
        n = unet(x, t, cond=emb, null_cond_mask=torch.ones(b, dtype=torch.bool, device="cuda"))
    want = n + (c - n) * 3.0
    scale = want.abs().max().item()
    diff = _max_abs(guided, want)
    out["batched_vs_two_forwards"] = {"max_abs": diff, "tol": 0.1 * scale, "max_abs_ref": scale,
                                      "bit_equal": bool(torch.equal(guided, want))}
    check(guided.dtype == torch.float32 and diff <= 0.1 * scale,
          f"cfg: the batched guidance forward parts from two forwards by {diff} (gate {0.1 * scale})")

    # DPM-20 and the first GRAPH_DDPM_STEPS steps of the recipe's DDPM chain with text, graphed, each capturing its
    # own graph (DPM-20 would otherwise replay the DDIM graph of its shape, condition and scale). The whole chain with
    # text at cond_scale 3 runs in train options (the conditioned run's sample during training).
    for name, fn, n_steps, batch in (
            ("dpm20_b4", lambda g: model.dpm_solver_sample(num_steps=20, generator=g, cond=COND_PROMPTS,
                                                           cond_scale=3.0), 20, b),
            (f"ddpm{GRAPH_DDPM_STEPS}_b2", lambda g: ddpm_prefix(torch, model, g, True, 2, GRAPH_DDPM_STEPS,
                                                                   cond=model.embed_cond(COND_PROMPTS[1:3]),
                                                                   cond_scale=3.0), GRAPH_DDPM_STEPS, 2)):
        model.graphs.clear()
        videos, sec, counts, staged, graph = run(lambda graph: fn(gen(1)), True)
        check_graphed(counts, graph, n_steps, f"cfg {name}")
        check_staged(counts, staged, f"cfg {name}")
        check(tuple(videos.shape) == (batch, 1, frames, size, size) and bool(torch.isfinite(videos).all()),
              f"cfg {name}: samples {tuple(videos.shape)}")
        out[name] = {"seconds": sec, "s_per_step_with_capture": sec / n_steps, "graph": graph,
                     "range": [float(videos.min()), float(videos.max())]}

    # The sampling CLI with text.
    ops.reset_launch_counts()
    res = sample.main(["--config", cfg_path, "--checkpoint-path", ckpt, "--output-path", str(OUT / "gifs" / "cfg_cli"),
                       "--batch-size", "4", "--seed", "0", "--device", "cuda", "--sampler", "ddim", "--num-steps",
                       "50", "--text", "two digits", "--cond-scale", "3"])
    counts = nonzero(ops.launch_counts())
    check_staged(counts, ops.staged_launch_counts(), "cfg sampling CLI")
    check_graphed(counts, res["graph"], 50, "cfg sampling CLI")
    check(tuple(res["videos"].shape) == (4, 1, frames, size, size) and bool(torch.isfinite(res["videos"]).all()),
          f"cfg sampling CLI: {tuple(res['videos'].shape)}")
    for p in res["paths"]:
        img = Image.open(p)
        check(img.n_frames == frames and img.size == (size, size), f"{p.name}: {img.n_frames} frames of {img.size}")
    out["sample_cli"] = {"seconds": res["seconds"], "s_per_step": res["seconds"] / 50, "graph": res["graph"],
                         "gifs": len(res["paths"])}

    # The extension CLI with text and reconstruction guidance (eager: a forward and a backward of 2b rows a step).
    clip = sorted((SCRATCH / "cond" / "gifs").glob("three digits *.gif"))[0]
    keep, ext_steps = 4, 10
    ops.reset_launch_counts()
    ext = extend.main(["--config", cfg_path, "--checkpoint-path", ckpt, "--input", str(clip), "--keep-frames",
                       str(keep), "--num-steps", str(ext_steps), "--recon-guidance", "2", "--batch-size", "2",
                       "--seed", "0", "--text", "three digits", "--cond-scale", "3",
                       "--output-path", str(OUT / "gifs" / "cfg_extend"), "--device", "cuda"])
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    check(ext["graph"] == {"captures": 0, "replays": 0}, f"cfg extend: guided steps captured graphs {ext['graph']}")
    check(counts == {k: n * ext_steps for k, n in PER_STEP.items()}, f"cfg extend: launches {counts}")
    check(all(staged.get(k, 0) == n for k, n in counts.items()), f"cfg extend: staged {staged} of {counts}")
    known = torch.from_numpy(ext["known"])
    pinned = ((known.cuda() * 2 - 1) + 1) * 0.5
    check(torch.equal(ext["videos"][:, :, :keep], pinned[None, :, :keep].cpu().expand(2, -1, -1, -1, -1)),
          "cfg extend: the kept frames are not the input's")
    out["extend_cli"] = {"seconds": ext["seconds"], "s_per_step": ext["seconds"] / ext_steps, "launches": counts}

    # The server with text.
    httpd = serve.create_server(model, host="127.0.0.1", port=0, batch_window_s=0.5)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://%s:%d" % httpd.server_address[:2]
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["model"]["has_cond"] is True and health["model"]["guidance_embed"] is False, f"/health: {health}")

        def post(payload):
            req = urllib.request.Request(url + "/sample", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, body = post({"text": ["two digits"], "cond_scale": 3.0, "num_steps": SERVE_STEPS, "seed": 3})
        check(code == 200 and body["shape"] == [1, 1, frames, size, size] and len(body["gifs"]) == 1,
              f"conditioned /sample: {code} {body.get('shape', body)}")
        out["http_sample"] = {"time_s": body["time_s"], "coalesced": body.get("coalesced")}
        code, body = post({"num_steps": SERVE_STEPS})
        check(code == 400 and "provide 'text'" in body["error"], f"/sample without text: {code} {body}")
        out["without_text"] = {"code": code, "error": body["error"]}

        service, prompts = httpd.service, ["one digit", "three digits"]
        results = [None] * len(prompts)

        def client(i):
            results[i] = service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": 10 + i,
                                              "text": [prompts[i]], "cond_scale": 3.0})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(all(r is not None for r in results), "coalesced text requests: a request did not return")
        errs = []
        for i, r in enumerate(results):
            solo = model.ddim_sample(num_steps=SERVE_STEPS, generator=gen(10 + i), cond=[prompts[i]], cond_scale=3.0)
            errs.append(float(np.abs(r[0] - solo.float().cpu().numpy()).max()))
        groups = [r[2]["coalesced"] for r in results]
        out["coalesced"] = {"groups": groups, "max_abs_vs_solo": errs, "tol": SERVE_TOL,
                            "seconds": [r[1] for r in results]}
        check(min(groups) == 2, f"coalesced text requests: groups {groups}")
        check(max(errs) <= SERVE_TOL, f"coalesced text rows part from their solo runs by {max(errs)} "
                                      f"(gate {SERVE_TOL})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    out["cached_graphs"] = len(model.graphs)
    return out


# 6 steps a run (15, then 10, until the multi-rank phases came, which the whole script's 600 s had to make room
# for): a checkpoint every 3, a sample at step 3 and a trace of steps 0-1 fit, and s/step from step 3.
OPT_STEPS, OPT_CKPT_EVERY, OPT_SAMPLE_AT, OPT_FLUSH, OPT_ACCUMULATE, OPT_WARM = 6, 3, 3, 2, 2, 3
# Derived keys of every train options run: a checkpoint every OPT_CKPT_EVERY steps, all kept, the EMA from step 0
# (so the flat run's EMA is exercised), and no sample or trace unless the run asks for one.
OPT_BASE = {"step_start_ema": 0, "update_ema_every": 1, "max_to_keep": 0, "save_and_sample_every": 100000,
            "profile_flush_step": 0}
TRACE_KERNEL = "temporal_fwd_panel_kernel"  # the staged dense temporal forward: 11 launches per flagship forward


def _host_launches(torch, tr, steps: int = 1) -> int:
    """CUDA kernel launches the host makes in ``steps`` training steps (the runtime's launch calls), after a warm
    step, counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    batches = [next(tr.dl) for _ in range(steps + 1)]
    tr.train_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            tr.train_step(b)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunchKernel"))


def train_options_phase(torch, ops, train) -> dict:
    """The trainer's options on the flagship recipe at full width (batch 8, bf16, both fused flags), on seeded
    synthetic data, through the train CLI: gradient accumulation (one step with injected t and noise against the
    unaccumulated step: the loss within ``LOSS_TOL``, each gradient tensor within ``GRAD_TOL``, exactly twice the
    launches, all staged; s/step and peak memory over OPT_STEPS steps), ``flatten_optimizer`` (OPT_STEPS steps
    bit-equal to the run without it: losses, parameters, EMA; host launches and s/step), asynchronous checkpoints
    (every OPT_CKPT_EVERY steps, each present and loadable, each byte-equal to the synchronous run's; the loop's
    blocking seconds per save), sampling during training (DDPM of 2 EMA clips at step OPT_SAMPLE_AT: GIFs of 10
    frames of 64x64, the losses bit-equal to the run without; the same for the caption-conditioned recipe at
    cond_scale 3), the profiler (a trace of the first OPT_FLUSH steps naming the staged temporal forward 11 times a
    step), and one run with all five options through the CLI."""
    import shutil

    import yaml
    from PIL import Image

    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits

    raw = yaml.safe_load(CONFIG.read_text())
    root = SCRATCH / "train_options"
    if root.is_dir():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    data = bouncing_squares(root / "bouncing_squares.npy")
    out = {"steps": OPT_STEPS, "batch": B_TRAIN, "checkpoint_every": OPT_CKPT_EVERY, "derived_keys": OPT_BASE}

    def config(name, recipe=raw, dataset=data, **trainer):
        return _train_config(yaml, recipe, root, dataset, name, steps=OPT_STEPS, ckpt_every=OPT_CKPT_EVERY,
                             **{**OPT_BASE, **trainer})

    def run(name, recipe=raw, dataset=data, **trainer):
        path = config(name, recipe, dataset, **trainer)
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the reference trainer kept for comparisons
        tr = train.main(["--config", str(path), "--device", "cuda"])
        counts, staged = nonzero(ops.launch_counts()), nonzero(ops.staged_launch_counts())
        losses = tr.loss_trace.tolist()
        check(len(losses) == OPT_STEPS and all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
        sps = (tr.step_starts[-1] - tr.step_starts[OPT_WARM]
               - sum(v for k, v in tr.save_seconds.items() if k >= OPT_WARM)
               - sum(v for k, v in tr.sample_seconds.items() if k >= OPT_WARM)
               - (tr.trace_seconds if tr.traced_steps and tr.traced_steps[1] > OPT_WARM else 0.0)) / (OPT_STEPS - OPT_WARM)
        starts = tr.step_starts
        step_seconds = [b - a - tr.save_seconds.get(i, 0.0) - tr.sample_seconds.get(i, 0.0)
                        for i, (a, b) in enumerate(zip(starts, starts[1:]))]
        info = {"losses": losses, "seconds_per_step": sps, "step_seconds": step_seconds,
                "peak_memory": torch.cuda.max_memory_allocated() - held, "memory_held_before": held,
                "launches": counts, "staged_launches": staged,
                "blocking_save_seconds": {k: v for k, v in tr.save_seconds.items()},
                "sample_seconds": dict(tr.sample_seconds)}
        return tr, info

    def same_state(a, b) -> bool:
        sa, sb = a.model.state_dict(), b.model.state_dict()
        return (torch.equal(a.loss_trace, b.loss_trace) and all(torch.equal(sa[k], sb[k]) for k in sa)
                and all(torch.equal(a.ema_state[k], b.ema_state[k]) for k in a.ema_state))

    def largest_gap(a, b) -> float:
        pairs = [(a.loss_trace, b.loss_trace)] + [(a.ema_state[k], b.ema_state[k]) for k in a.ema_state]
        return max(((x.float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-12)).item()
                   for x, y in pairs)

    # Gradient accumulation, one step: the same weights, batch, t and noise with and without it.
    steps1 = {}
    for name, extra in (("one_step", {}), ("one_step_accumulated", {"enable_gradient_accumulation": True,
                                                                   "gradient_accumulate_every": OPT_ACCUMULATE})):
        _, _, tr = build_trainer(load_config(config(name, **extra)), device="cuda")
        batch = next(tr.dl)
        gen = torch.Generator(device="cuda").manual_seed(5)
        t = torch.randint(0, tr.model.num_timesteps, (B_TRAIN,), generator=gen, device="cuda")
        noise = torch.randn(batch.shape, generator=gen, device="cuda")
        ops.reset_launch_counts()
        loss, norm = tr.train_step(batch, t=t, noise=noise)
        torch.cuda.synchronize()
        steps1[name] = {"loss": loss.item(), "grad_norm": norm.item(), "launches": nonzero(ops.launch_counts()),
                        "staged": nonzero(ops.staged_launch_counts()),
                        "grads": {k: p.grad.detach().float().clone() for k, p in tr.model.named_parameters()
                                  if p.grad is not None}}
        del tr
    one, acc = steps1["one_step"], steps1["one_step_accumulated"]
    floor = GRAD_FLOOR * torch.sqrt(sum(g.square().sum() for g in one["grads"].values())).item()
    rel = {k: ((acc["grads"][k] - g).norm() / max(g.norm().item(), floor)).item() for k, g in one["grads"].items()}
    loss_gap = abs(acc["loss"] - one["loss"]) / abs(one["loss"])
    worst = max(rel, key=rel.get)
    check(set(acc["grads"]) == set(one["grads"]), "accumulation: the routes give gradients to different tensors")
    check(loss_gap <= LOSS_TOL, f"accumulation: loss {acc['loss']} against {one['loss']} ({loss_gap} > {LOSS_TOL})")
    check(rel[worst] <= GRAD_TOL, f"accumulation: gradient of {worst} parts by {rel[worst]} > {GRAD_TOL}")
    check(one["launches"] == PER_STEP, f"unaccumulated step: launches {one['launches']}, expected {PER_STEP}")
    check(acc["launches"] == {k: OPT_ACCUMULATE * n for k, n in PER_STEP.items()},
          f"accumulated step: launches {acc['launches']}, expected {OPT_ACCUMULATE}x {PER_STEP}")
    for s in (one, acc):
        check_staged(s["launches"], s["staged"], "train options phase")
        check(all(s["staged"].get(k, 0) == n for k, n in s["launches"].items()),
              f"train options phase: staged {s['staged']} of {s['launches']}")
    out["accumulation_step"] = {"loss": one["loss"], "loss_accumulated": acc["loss"], "loss_gap": loss_gap,
                                "grad_norm": one["grad_norm"], "grad_norm_accumulated": acc["grad_norm"],
                                "largest_grad_gap": rel[worst], "largest_grad_gap_tensor": worst,
                                "launches": one["launches"], "launches_accumulated": acc["launches"]}
    del steps1, one, acc

    # OPT_STEPS-step runs: the per-tensor synchronous reference, then each option alone.
    base, out["per_tensor"] = run("per_tensor")
    accumulated, out["accumulated"] = run("accumulated", enable_gradient_accumulation=True,
                                          gradient_accumulate_every=OPT_ACCUMULATE)
    check(out["accumulated"]["launches"] == {k: OPT_ACCUMULATE * n * OPT_STEPS for k, n in PER_STEP.items()},
          f"accumulated run: launches {out['accumulated']['launches']}")
    check(out["accumulated"]["staged_launches"] == out["accumulated"]["launches"],
          f"accumulated run: staged {out['accumulated']['staged_launches']} of {out['accumulated']['launches']}")
    del accumulated

    flat, out["flat"] = run("flat", flatten_optimizer=True)
    out["flat"]["bit_equal"] = same_state(flat, base)
    out["flat"]["largest_relative_gap"] = largest_gap(flat, base)
    check(out["flat"]["bit_equal"], f"flat optimizer: losses, parameters or EMA differ from the per-tensor run "
                                    f"(largest relative gap {out['flat']['largest_relative_gap']})")
    out["flat"]["host_launches_per_step"] = _host_launches(torch, flat)  # one step: every step launches the same
    del flat
    out["per_tensor"]["host_launches_per_step"] = _host_launches(torch, base)

    asynchronous, out["async"] = run("async", async_checkpointing=True)
    ckpts = list(range(OPT_CKPT_EVERY, OPT_STEPS + 1, OPT_CKPT_EVERY))
    for tr in (base, asynchronous):
        check(sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt")) == ckpts,
              f"checkpoints of {tr.checkpoint_dir_path}")
    for step in ckpts:
        payload = read_checkpoint(asynchronous.checkpoint_path(step))
        check(payload["step"] == step, f"async checkpoint {step}: step {payload['step']}")
        base.model.load_state_dict(payload["model"])  # loadable into the recipe's model
    check(asynchronous.checkpoint_path(OPT_STEPS).read_bytes() == base.checkpoint_path(OPT_STEPS).read_bytes(),
          f"async step-{OPT_STEPS} checkpoint differs from the synchronous one")
    check(torch.equal(asynchronous.loss_trace, base.loss_trace), "async run: losses differ from the synchronous run")
    out["async"]["last_checkpoint_bit_equal"] = True
    out["async"]["checkpoint_bytes"] = asynchronous.checkpoint_path(OPT_STEPS).stat().st_size
    for name in ("per_tensor", "async"):
        saves = {k: v for k, v in out[name]["blocking_save_seconds"].items()}
        out[name]["mean_blocking_save_seconds"] = sum(saves.values()) / len(saves)
    del asynchronous

    sampled, out["sampled"] = run("sampled", save_and_sample_every=OPT_SAMPLE_AT, num_sample_rows=2)
    _check_samples(Image, sampled, raw, "sampled run")
    check(torch.equal(sampled.loss_trace, base.loss_trace), "sampled run: losses differ from the run without")
    out["sampled"]["peak_added_bytes"] = out["sampled"]["peak_memory"] - out["per_tensor"]["peak_memory"]
    del sampled

    traced, out["profiled"] = run("profiled", profile_flush_step=OPT_FLUSH)
    out["profiled"].update(_check_trace(traced, OPT_FLUSH, PER_FORWARD["temporal_attention_fwd"]))
    check(torch.equal(traced.loss_trace, base.loss_trace), "profiled run: losses differ from the run without")
    del traced, base

    # The caption-conditioned recipe, sampled with its text at cond_scale 3, against the same run without samples.
    cond_raw = yaml.safe_load(COND_CONFIG.read_text())
    gifs = root / "cond_gifs"
    bouncing_digits.main(["--captioned-gifs", str(gifs), "--frames", str(cond_raw["diffusion"]["num_frames"]),
                          "--captioned-clips-per-class", str(COND_CLIPS_PER_CLASS)])
    cond_plain, out["cond"] = run("cond", cond_raw, gifs)
    cond_sampled, out["cond_sampled"] = run("cond_sampled", cond_raw, gifs, save_and_sample_every=OPT_SAMPLE_AT,
                                            num_sample_rows=2, sample_text="two digits", cond_scale=3.0)
    check(cond_sampled.sample_text == "two digits" and cond_sampled.cond_scale == 3.0, "cond sampling keys")
    _check_samples(Image, cond_sampled, cond_raw, "conditioned sampled run")
    check(torch.equal(cond_sampled.loss_trace, cond_plain.loss_trace),
          "conditioned sampled run: losses differ from the run without")
    del cond_plain, cond_sampled

    # All five options at once, through the train CLI.
    cli, out["cli_all_options"] = run("all_options", enable_gradient_accumulation=True,
                                      gradient_accumulate_every=OPT_ACCUMULATE, flatten_optimizer=True,
                                      async_checkpointing=True, save_and_sample_every=OPT_SAMPLE_AT,
                                      num_sample_rows=2, profile_flush_step=OPT_FLUSH)
    check(sorted(int(p.stem[5:]) for p in cli.checkpoint_dir_path.glob("step_*.pt")) == ckpts,
          "all options: checkpoints")
    _check_samples(Image, cli, raw, "all options run")
    out["cli_all_options"].update(_check_trace(cli, OPT_FLUSH, OPT_ACCUMULATE * PER_FORWARD["temporal_attention_fwd"]))
    # Training launches, then one graph capture of the sample (its warm-up forward and the capture).
    want = {k: OPT_ACCUMULATE * n * OPT_STEPS + 2 * PER_FORWARD.get(k, 0) for k, n in PER_STEP.items()}
    check(out["cli_all_options"]["launches"] == want,
          f"all options: launches {out['cli_all_options']['launches']}, expected {want}")
    half = OPT_STEPS // 2
    check(sum(out["cli_all_options"]["losses"][-half:]) < sum(out["cli_all_options"]["losses"][:half]),
          f"all options: the loss did not fall: {out['cli_all_options']['losses']}")
    del cli
    return out


def _check_samples(Image, tr, recipe: dict, where: str) -> None:
    d = recipe["diffusion"]
    check(sorted(tr.sample_paths) == [OPT_SAMPLE_AT] and len(tr.sample_paths[OPT_SAMPLE_AT]) == 2,
          f"{where}: samples {tr.sample_paths}")
    for path in tr.sample_paths[OPT_SAMPLE_AT]:
        img = Image.open(path)
        check(img.n_frames == d["num_frames"] and img.size == (d["image_size"], d["image_size"]),
              f"{where}: {path.name} has {img.n_frames} frames of {img.size}")
    check(len(tr.model.graphs) == 0, f"{where}: a CUDA graph outlived the sample")


def _check_trace(tr, flush: int, per_step: int) -> dict:
    """The run's Chrome trace covers steps 0 to ``flush`` - 1 alone: ``per_step`` launches of the staged temporal
    forward per step, and a ``train_step#N`` range for each of those steps."""
    check(tr.trace_path is not None and tr.trace_path.is_file() and tr.traced_steps == (0, flush),
          f"trace {tr.trace_path}, steps {tr.traced_steps}")
    events = json.loads(tr.trace_path.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel" and TRACE_KERNEL in e.get("name", ""))
    ranges = sorted(e["name"] for e in events  # the host's ranges (the card's projections are gpu_user_annotation)
                    if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train_step#"))
    check(kernels == per_step * flush, f"trace: {kernels} launches of {TRACE_KERNEL}, expected {per_step * flush}")
    check(ranges == [f"train_step#{i}" for i in range(flush)], f"trace: step ranges {ranges}")
    return {"trace_bytes": tr.trace_path.stat().st_size, "trace_kernel_events": kernels, "traced_steps": flush,
            "trace_seconds": tr.trace_seconds}


def long_train_phase(torch, ops, train, sample, name: str = "long_train", unet: dict | None = None,
                     per_step: dict = LONG_PER_STEP, variants=("kernels", "remat_off", "plain"),
                     f32: tuple = ({}, {})) -> dict:
    """The long-clip recipe (with ``unet`` overrides) through the CLIs: 12 steps at batch 1 on 128-frame
    clips by each of ``variants``, then DDIM-50. ``f32`` as for ``train_phase``."""
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
        tf32x3, staged3 = nonzero(ops.tf32x3_launch_counts()), nonzero(ops.staged_tf32x3_launch_counts())
        if variant != "plain":
            check_staged(counts, staged, f"{name} phase, {variant}")
            for got, want, what in ((tf32x3, f32[0], "3xtf32"), (staged3, f32[1], "staged-3xtf32")):
                want = {k: n * LONG_STEPS for k, n in want.items()}
                check(got == want, f"{name} phase, {variant}: {what} launches {got}, expected {want}")
        losses = tr.loss_trace.tolist()
        check(len(losses) == LONG_STEPS and all(math.isfinite(v) for v in losses), f"{variant}: losses {losses}")
        sps, save_s = _seconds_per_step(tr, warmup=3)
        runs[variant] = {"losses": losses, "launches": counts, "staged_launches": staged, "tf32x3_launches": tf32x3,
                         "staged_tf32x3_launches": staged3, "seconds_per_step": sps,
                         "checkpoint_write_seconds": save_s, "peak_memory": torch.cuda.max_memory_allocated(),
                         "checkpoints": sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt"))}
        if variant == "kernels":
            ckpt_dir = tr.checkpoint_dir_path
            check(tr.model.denoise_fn.remat_blocks and tr.max_grad_norm == raw["trainer"]["max_grad_norm"],
                  "the long-clip trainer lost remat_blocks or max_grad_norm")
        del tr
    k = runs["kernels"]
    half = LONG_STEPS // 2
    first, last = sum(k["losses"][:half]) / half, sum(k["losses"][-half:]) / half
    check(last < first, f"long-clip loss did not fall: first {half} steps {first}, last {half} {last}")
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
    check_graphed(s_counts, res["graph"], res["steps"], "long-clip sampling", per=per_step)
    return {"steps": LONG_STEPS, "batch": raw["trainer"]["train_batch_size"], "frames": d["num_frames"],
            "dataset": {"gif_folder": str(data), "clips": LONG_CLIPS, "frames_per_gif": gif_frames},
            "freeze_schedule_buffers": raw["trainer"].get("freeze_schedule_buffers", False),
            "first4": first, "last4": last, "runs": runs, "loss_gaps_vs_kernels": gaps,
            "launches": k["launches"], "staged_launches": k["staged_launches"], "tf32x3_launches": k["tf32x3_launches"],
            "staged_tf32x3_launches": k["staged_tf32x3_launches"],
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
            "comm": dict(tr.group.stats), "digest": digest.hexdigest(), "device": str(tr.device),
            "opt_count": tr.opt_count, "is_main": tr.is_main,
            "buffer_drift": {k: (state[k].cpu() - getattr(fresh, k)).abs().max().item()
                             for k in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod")},
        }
        del tr, state
    (Path(out_dir) / f"seq_rank{rank}.json").write_text(json.dumps(out))


def seq_train_phase(torch, train, mesh_phases) -> dict:
    """configs/config_seq_parallel.yaml through the train CLI's rank function: 4 ranks on cuda:0 over gloo.

    The spawn then runs the runs of the multi-rank phases ``mesh_phases`` (one process start for all). Their seconds
    are taken out of this phase's (``spawn_share_seconds``) and counted in the phases that check them."""
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
    last = dict(steps=SEQ_STEPS, ckpt_every=SEQ_STEPS)  # a one-rank reference writes its final checkpoint alone
    cfgs = {"ranks4": _train_config(yaml, raw, root, data, "ranks4", **common),
            "rank1": _train_config(yaml, raw, root, data, "rank1", sequence_parallel_size=1, **last),
            "rank1_fused": _train_config(yaml, raw, root, data, "rank1_fused", unet={"use_fused_attention": True},
                                         sequence_parallel_size=1, **common)}
    for old in [*root.glob("*/checkpoints/step_*.pt"), *root.glob("store_*"), *root.glob("seq_rank*.json")]:
        old.unlink()
    argv = ["--config", str(cfgs["ranks4"]), "--device", "cuda", "--dist-backend", "gloo"]
    runs = [("run", f"file://{root / 'store_run'}", argv),
            ("resume", f"file://{root / 'store_resume'}", argv + ["--resume_step", str(SEQ_CKPT_EVERY)])]
    mesh = mesh_runs(yaml, data, mesh_phases)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from video_diffusion_nnx_tpu_torch.models import text

    mp.spawn(spawned_rank, args=((SEQ_WORLD, f"file://{root / 'store_gather'}", runs, str(root)),
                                 (mesh["runs"], mesh["root"], text._hf is False)), nprocs=SEQ_WORLD, join=True)
    ranks = [json.loads((root / f"seq_rank{r}.json").read_text()) for r in range(SEQ_WORLD)]
    mesh["ranks"] = [json.loads((Path(mesh["root"]) / f"mesh_rank{r}.json").read_text()) for r in range(MESH_WORLD)]
    mesh["seconds"] = mesh["ranks"][0]["seconds"]  # rank 0's clock over the mesh runs: the ranks meet in every run
    spawn_seconds = time.perf_counter() - t0 - mesh["seconds"]  # the process start, the gather and this recipe's runs

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
        sps, _ = _seconds_per_step(tr, warmup=SEQ_WARM)
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
    warm = SEQ_WARM
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
            "gather_panel": ranks[0]["gather"], "spawn_seconds": spawn_seconds, "mesh": mesh,
            "spawn_share_seconds": -mesh["seconds"],
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
    check(res["graph"] == {"captures": 1, "replays": res["steps"]}, f"seq sampling: graphs {res['graph']}")
    return {"steps": res["steps"], "sample_seconds": res["seconds"], "seconds_per_step": res["seconds"] / res["steps"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "gifs": len(res["paths"])}


# The trainer's multi-device paths (A15), three phases over seq train's spawn of 4 gloo ranks sharing cuda:0; each
# run forms its own world (file:// store) of MESH_WORLD or 2 ranks, and the ranks outside it sit it out.
# dp train: the flagship as shipped over 4 data ranks of 2 rows (batch 8), MESH_STEPS steps and a checkpoint at
# MESH_CKPT; a resume from that file at 2 ranks with one EMA sample of num_sample_rows (4: two rows a rank; on the 4
# ranks until the data-rank phases needed the room, where each DDPM step took four turns on the card); the same steps
# under param_sharding fsdp. tp train: configs/config_tpu_v2_3.yaml as shipped (dim 128, batch 4, num_model_shards
# 2, Adam's state in the files, async checkpoints) on (data 2 x model 2): TP_STEPS steps, a checkpoint at TP_CKPT
# and a resume from it; in the parent, the same recipe on one rank (the clamp). seq dp train: the seq recipe with
# sequence_parallel_size 2 on (data 2 x seq 2): SEQ_STEPS steps, then batch 4 under accumulation (A = 2).
MESH_WORLD, MESH_STEPS, MESH_CKPT = 4, 4, 2  # 6 and 3 before the data-rank phases needed the room
TP_STEPS, TP_CKPT = 2, 1  # 4 and 2 before: the resume runs one step
SEQ_DP_ACC_STEPS = 2
MESH_CONTROL_OFF = 0.01  # each multi-rank run's losses scaled by 1 + this must fail its gate
MESH_GATE_MARGIN = 0.001  # added to 1.5x the control's largest relative per-step loss gap
STATE_MARGIN = 1e-3  # FSDP's final update against DP's: within 1.5x DP's distance to one rank's, plus this


def _digest(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train_record(torch, ops, rank: int, world: int, init_method: str, argv: list) -> dict:
    """One run of the train CLI's rank function: launches, losses, times, memory, collectives, resident sharded state
    and digests of the replicated state and of the shards."""
    from video_diffusion_nnx_tpu_torch import train

    with WarningRecords() as records:
        tr = train.run_rank(rank, world, "gloo", init_method, argv)
    state = tr.model.state_dict()
    replicated = {k: v for k, v in state.items() if k not in tr.shards}
    replicated.update({f"ema.{k}": v for k, v in tr.ema_state.items() if k not in tr.shards})
    adam = tr.optimizer.state
    resident = {k: {"param": p.numel() * 4, "ema": tr.ema_state[k].numel() * 4,
                    "moments": sum(adam[p][m].numel() * 4 for m in ("exp_avg", "exp_avg_sq")) if p in adam else 0,
                    "full": math.prod(tr.full_shapes[k]) * 4, "adam": p in adam}  # float32 throughout
                for k, p in tr.shards.items()}
    axis = tr.mesh.axis(tr.shard_axis) if tr.shard_axis else None
    return {
        "world": world, "mesh": dict(tr.mesh.shape), "shard_axis": tr.shard_axis,
        "shard_coord": None if axis is None else axis.rank,
        "launches": nonzero(ops.launch_counts()), "staged_launches": nonzero(ops.staged_launch_counts()),
        "losses": tr.loss_trace.tolist(), "step_starts": tr.step_starts, "save_seconds": tr.save_seconds,
        "sample_seconds": tr.sample_seconds,
        "sample_paths": {k: [str(p) for p in v] for k, v in tr.sample_paths.items()},
        "graph": {"captures": tr.model.graphs.captures, "replays": tr.model.graphs.replays()},
        "peak_memory": torch.cuda.max_memory_allocated(), "comm": dict(tr.group.stats),
        "replicated_digest": _digest(replicated), "shard_digest": _digest({k: v for k, v in tr.shards.items()}),
        "resident": resident, "opt_count": tr.opt_count, "is_main": tr.is_main, "device": str(tr.device),
        "warnings": records.messages,
    }


@contextlib.contextmanager
def _student_digests(digests: list):
    """Within the block every finished distillation round (``StudentOptimizer.finish``) appends a digest of its
    student's parameters, EMA and Adam moments to ``digests``."""
    from video_diffusion_nnx_tpu_torch.training.distill import StudentOptimizer

    finish = StudentOptimizer.finish

    def recorded(self):
        finish(self)
        adam = self.optimizer.state
        digests.append(_digest({**{f"p{i}": p for i, p in enumerate(self.params)},
                                **{f"ema{i}": e for i, e in enumerate(self.ema or [])},
                                **{f"{m}{i}": adam[p][m] for i, p in enumerate(self.params) if p in adam
                                   for m in ("exp_avg", "exp_avg_sq")}}))

    StudentOptimizer.finish = recorded
    try:
        yield
    finally:
        StudentOptimizer.finish = finish


def _serve_record(torch, rank: int, world: int, init_method: str, argv: list, out_dir: str) -> dict:
    """The server over the world (``serve.run_rank``'s pieces): rank 0 serves HTTP around the model and drains
    SERVE_CLIENTS concurrent batch-1 DDIM-SERVE_STEPS requests, first as float rows (seeds 0.., saved for the phase's
    check), then through ``bench_serve.measure`` (best of two drains after warm-ups, as the serve phase measures one
    rank); the other ranks follow its calls until it shuts down."""
    import threading
    import urllib.request

    from video_diffusion_nnx_tpu_torch import bench_serve, serve
    from video_diffusion_nnx_tpu_torch.parallel import joined

    args = serve.parse_args(argv)
    with joined(rank, world, "gloo", init_method, args.device.split(":")[0]) as group:
        model = serve.load_model(args, group.device)
        if rank != 0:
            model.data_group = group
            serve.follow(model, group)
            return {"graph": {"captures": model.graphs.captures, "replays": model.graphs.replays()}}
        httpd = serve.create_server(model, host="127.0.0.1", port=0, batch_window_s=0.05, group=group)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            url = "http://%s:%d" % httpd.server_address[:2]
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
            results = [None] * SERVE_CLIENTS

            def client(i):
                results[i] = httpd.service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": i})

            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(all(r is not None for r in results), "dp serve: a request did not return")
            torch.save([torch.from_numpy(r[0]) for r in results], Path(out_dir) / "dp_serve_rows.pt")
            rec = {"health": health, "groups": [r[2]["coalesced"] for r in results],
                   "request_seconds": [r[1] for r in results],
                   "throughput": bench_serve.measure(url, "ranks", [SERVE_CLIENTS], SERVE_STEPS, batched=True)}
        finally:
            httpd.shutdown()
            httpd.server_close()  # releases the other ranks
            thread.join(timeout=60)
        rec["graph"] = {"captures": model.graphs.captures, "replays": model.graphs.replays()}
        return rec


def _cli_record(torch, rank: int, world: int, init_method: str, cli: str, argv: list, out_dir: str, name: str) -> dict:
    """One run of a sampling, extension or distillation CLI's ``run_rank`` (or the server's pieces)."""
    import importlib

    if cli == "serve":
        return _serve_record(torch, rank, world, init_method, argv, out_dir)
    module = importlib.import_module(f"video_diffusion_nnx_tpu_torch.{cli}")
    if cli in ("sample", "extend"):
        with WarningRecords() as records:
            res = module.run_rank(rank, world, "gloo", init_method, argv)
        if rank == 0:
            torch.save(res["videos"], Path(out_dir) / f"{name}_videos.pt")
        return {"videos_digest": _digest({"v": res["videos"]}), "sampler_seconds": res["seconds"], "graph": res["graph"],
                "paths": [str(p) for p in res["paths"]], "warnings": records.messages}
    digests = []
    with _student_digests(digests), WarningRecords() as records:
        res = module.run_rank(rank, world, "gloo", init_method, argv)
    rounds = res["rounds"] if cli == "distill" else [res]
    return {"losses": [v for r in rounds for v in r["losses"]], "seconds_per_step": [r["seconds_per_step"] for r in rounds],
            "student_digests": digests, "warnings": records.messages,
            "paths": sorted(str(p) for p in (res["paths"].values() if cli == "distill" else [res["path"]]) if p)}


def mesh_rank(rank: int, runs: list, out_dir: str, no_hf: bool = False) -> None:
    """One rank of the multi-rank phases, in a spawned process: each run (the train CLI's rank function, or a
    sampling, extension, distillation or serving CLI's) whose world holds this rank, with its launches, peak memory,
    seconds and the run's own record (``_train_record``, ``_cli_record``), written to ``mesh_rank<r>.json``. With
    ``no_hf`` (the parent process found no cached BERT), captions take the hashed bag of words without a try of
    their own (importing transformers to find none takes each process seconds)."""
    import torch

    from video_diffusion_nnx_tpu_torch import ops
    from video_diffusion_nnx_tpu_torch.models import text

    if no_hf:
        text._hf = False

    out = {"rank": rank}
    start = time.perf_counter()
    for name, world, init_method, argv, cli in runs:
        if rank >= world:
            continue
        ops.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cli == "train":
            out[name] = _train_record(torch, ops, rank, world, init_method, argv)
        else:
            rec = _cli_record(torch, rank, world, init_method, cli, argv, out_dir, name)
            torch.cuda.synchronize()
            out[name] = {**rec, "launches": nonzero(ops.launch_counts()),
                         "staged_launches": nonzero(ops.staged_launch_counts()),
                         "peak_memory": torch.cuda.max_memory_allocated(), "device": f"cuda:{torch.cuda.current_device()}"}
        out[name]["seconds"] = time.perf_counter() - t0  # the run with its digests: this rank's share of the spawn
    out["seconds"] = time.perf_counter() - start
    (Path(out_dir) / f"mesh_rank{rank}.json").write_text(json.dumps(out))


def _gap(ls: list, ref: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(ls, ref))


# The runs of seq train's spawn that each multi-rank phase checks.
DP_RUNS, TP_RUNS, SEQ_DP_RUNS = ("dp4", "dp_resume2", "fsdp4"), ("tp4", "tp_resume"), ("seqdp", "seqdp_acc")
DP_SAMPLE_RUNS, DP_DISTILL_RUNS, DP_SERVE_RUNS = ("dp_sample", "dp_extend"), ("dp_distill", "dp_guidance"), ("dp_serve",)
MESH_PHASES = {"dp train": DP_RUNS, "tp train": TP_RUNS, "seq dp train": SEQ_DP_RUNS, "dp sample": DP_SAMPLE_RUNS,
               "dp distill": DP_DISTILL_RUNS, "dp serve": DP_SERVE_RUNS}


def _spawn_share(ranks: list, names: tuple) -> float:
    """Rank 0's seconds in seq train's spawn on the runs ``names``: counted in the phase that checks them."""
    return sum(ranks[0][name]["seconds"] for name in names)


def _loss_gate(where: str, losses: list, ref: list, control: float) -> dict:
    """The multi-rank losses against the one-rank run's within 1.5x the control's gap plus a margin; the same
    losses 1% off must fall outside."""
    gate = 1.5 * control + MESH_GATE_MARGIN
    got = _gap(losses, ref)
    off = _gap([(1 + MESH_CONTROL_OFF) * v for v in losses], ref)
    check(all(math.isfinite(v) for v in losses) and len(losses) == len(ref), f"{where}: losses {losses}")
    check(got <= gate, f"{where}: losses part from the one-rank run's by {got} (relative), over the gate {gate} "
                       f"(control {control}): {losses} against {ref}")
    check(off > gate, f"{where}: the loss gate {gate} misses losses {MESH_CONTROL_OFF:.0%} off ({off})")
    return {"gap": got, "control_gap": control, "gate": gate, "control_1pct_off_gap": off}


def _check_run(ranks: list, name: str, per_step: dict, steps: int, extra: dict | None = None,
               staged_per_step: dict | None = None) -> dict:
    """Exact launches on every rank of run ``name`` on cuda:0, each staged (or ``staged_per_step`` of them a step:
    the routes one rank of the recipe takes); the ranks' replicated state bit-equal, and the shards of ranks at one
    place on the shard axis; returns rank 0's entry."""
    runs = [r[name] for r in ranks if name in r]
    want = {k: per * steps + (extra or {}).get(k, 0) for k, per in per_step.items()}
    want_staged = want if staged_per_step is None else {k: n * steps for k, n in staged_per_step.items() if n}
    for r, run in enumerate(runs):
        check(run["launches"] == want and run["device"] == "cuda:0",
              f"{name} rank {r}: launches {run['launches']} on {run['device']}, expected {want}")
        check(run["staged_launches"] == want_staged,
              f"{name} rank {r}: staged launches {run['staged_launches']} of {run['launches']}, expected {want_staged}")
    check(len({run["replicated_digest"] for run in runs}) == 1, f"{name}: the ranks' replicated states differ")
    by_coord = {}
    for run in runs:
        by_coord.setdefault(run["shard_coord"], set()).add(run["shard_digest"])
    check(all(len(d) == 1 for d in by_coord.values()), f"{name}: ranks holding one shard hold different values")
    check(all(run["losses"] == runs[0]["losses"] for run in runs), f"{name}: the ranks' losses differ")
    return runs[0]


def _resident_share(run: dict, size: int, where: str) -> dict:
    """Each sharded tensor's resident parameter, Adam moments and EMA: 1/size of one rank's, to within one tensor's
    rounding (the dims divide, so exactly)."""
    res = run["resident"]
    check(bool(res), f"{where}: no tensor is sharded")
    held = sum(v["param"] + v["ema"] + v["moments"] for v in res.values())
    whole = sum(v["full"] * (4 if v["adam"] else 2) for v in res.values())
    largest = max((v["full"] for v in res.values()), default=0)
    check(abs(held * size - whole) <= largest, f"{where}: resident {held} bytes of {whole} over {size} ranks")
    return {"tensors": len(res), "resident_bytes": held, "one_rank_bytes": whole, "share": held / max(whole, 1)}


def _sps(run: dict, warm: int = 2) -> float:
    """Rank 0's host seconds per step from step ``warm`` on, checkpoint writes and samples left out."""
    starts = run["step_starts"]
    skip = sum(v for k, v in {**run["save_seconds"], **run["sample_seconds"]}.items() if int(k) >= warm)
    return (starts[-1] - starts[warm] - skip) / (len(starts) - 1 - warm)


def _one_rank(torch, train, cfg: Path, extra: list | None = None) -> tuple[dict, list]:
    """The recipe on one rank through the train CLI in this process; its losses, s/step, peak and warnings."""
    from video_diffusion_nnx_tpu_torch import ops

    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with WarningRecords() as records:
        tr = train.main(["--config", str(cfg), "--device", "cuda", "--ranks", "1", *(extra or [])])
    warm = min(2, len(tr.step_starts) - 2)  # a 2-step run times its second step
    out = {"losses": tr.loss_trace.tolist(), "seconds_per_step": _seconds_per_step(tr, warmup=warm)[0],
           "peak_memory": torch.cuda.max_memory_allocated(), "mesh": tr.mesh, "shards": len(tr.shards),
           "launches": nonzero(ops.launch_counts()), "staged_launches": nonzero(ops.staged_launch_counts())}
    del tr
    return out, records.messages


def _update_distance(a: dict, b: dict, init: dict) -> float:
    """The distance of two checkpoints' parameters relative to ``b``'s update from ``init``, all tensors as one
    vector: what the runs' steps moved, not the weights they started from, sets the scale."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    den = sum(float((b[k].double() - init[k].double()).square().sum()) for k in b)
    return math.sqrt(num / den)


def spawned_rank(rank: int, seq_args: tuple, mesh_args: tuple) -> None:
    """One of the 4 spawned ranks: seq train's runs, then the multi-rank phases' runs (one process start for both)."""
    seq_rank(rank, *seq_args)
    mesh_rank(rank, *mesh_args)


def mesh_runs(yaml, seq_data: Path, phases) -> dict:
    """The configs of the multi-rank phases (and of their one-rank references) and the spawn's list of the runs of
    ``phases``: (name, world, init_method, argv, CLI)."""
    root = SCRATCH / "mesh"
    root.mkdir(parents=True, exist_ok=True)
    for old in [*root.glob("*/checkpoints/step_*.pt"), *root.glob("*/samples/*/*.gif"), *root.glob("store_*"),
                *root.glob("mesh_rank*.json"), *root.glob("dp_*.pt")]:
        old.unlink()
    flag = yaml.safe_load(CONFIG.read_text())
    check(flag["trainer"]["train_batch_size"] == B_TRAIN, f"the flagship batch is not {B_TRAIN}")
    flag_data = bouncing_squares(root / "bouncing_squares.npy")
    common = dict(steps=MESH_STEPS, ckpt_every=MESH_CKPT)
    cfgs = {"dp4": _train_config(yaml, flag, root, flag_data, "dp4", **common),
            "dp_resume2": _train_config(yaml, flag, root, flag_data, "dp_resume2", save_and_sample_every=MESH_CKPT,
                                        **common,
                                        checkpoint_dir_path=str(root / "dp4" / "checkpoints")),
            "fsdp4": _train_config(yaml, flag, root, flag_data, "fsdp4", param_sharding="fsdp", **common),
            "dp1": _train_config(yaml, flag, root, flag_data, "dp1", steps=MESH_STEPS, ckpt_every=MESH_STEPS),
            "dp1_plain": _train_config(yaml, flag, root, flag_data, "dp1_plain", unet=PLAIN_MODULES, steps=MESH_STEPS,
                                       ckpt_every=MESH_STEPS)}
    tp = yaml.safe_load(DIM128_CONFIG.read_text())
    check(tp["trainer"]["num_model_shards"] == 2 and tp["unet"]["dim"] == 128, f"the dim-128 recipe: {tp['trainer']}")
    tp_data = bouncing_squares(root / "bouncing_squares_tp.npy", clips=32)
    tp_common = dict(steps=TP_STEPS, ckpt_every=TP_CKPT)
    cfgs.update(tp4=_train_config(yaml, tp, root, tp_data, "tp4", **tp_common),
                tp1=_train_config(yaml, tp, root, tp_data, "tp1", steps=TP_STEPS, ckpt_every=TP_STEPS),
                tp1_plain=_train_config(yaml, tp, root, tp_data, "tp1_plain", unet=PLAIN_MODULES, steps=TP_STEPS,
                                        ckpt_every=TP_STEPS))
    seq = yaml.safe_load(SEQ_CONFIG.read_text())  # on seq train's clips: the same steps as its run
    acc = dict(train_batch_size=4, enable_gradient_accumulation=True, gradient_accumulate_every=2)
    cfgs.update(seqdp=_train_config(yaml, seq, root, seq_data, "seqdp", sequence_parallel_size=2, steps=SEQ_STEPS,
                                    ckpt_every=SEQ_CKPT_EVERY),
                seqdp_acc=_train_config(yaml, seq, root, seq_data, "seqdp_acc", sequence_parallel_size=2,
                                        steps=SEQ_DP_ACC_STEPS, ckpt_every=SEQ_CKPT_EVERY, **acc),
                seq1_acc=_train_config(yaml, seq, root, seq_data, "seq1_acc", sequence_parallel_size=1,
                                       steps=SEQ_DP_ACC_STEPS, ckpt_every=SEQ_CKPT_EVERY, **acc))

    def argv(name, *extra):
        return ["--config", str(cfgs[name]), "--device", "cuda", "--dist-backend", "gloo", *extra]

    runs = [("dp4", 4, argv("dp4"), "train"),
            ("dp_resume2", 2, argv("dp_resume2", "--resume_step", str(MESH_CKPT)), "train"),
            ("fsdp4", 4, argv("fsdp4"), "train"), ("tp4", 4, argv("tp4"), "train"),
            ("tp_resume", 4, argv("tp4", "--resume_step", str(TP_CKPT)), "train"),
            ("seqdp", 4, argv("seqdp"), "train"), ("seqdp_acc", 4, argv("seqdp_acc"), "train")]
    import numpy as np

    np.save(root / "extend_clip.npy", np.load(flag_data)[:, 0])  # one clip (f, h, w), as the extend CLI reads a .npy
    dp_argv = dp_cli_argv(root)
    runs += [(name, MESH_WORLD, dp_argv[name] + (["--output-path", str(root / name)] if cli != "serve" else []), cli)
             for name, cli in DP_CLIS.items()]
    check(sorted(r[0] for r in runs) == sorted(n for names in MESH_PHASES.values() for n in names),
          "every spawned run belongs to one phase")
    mine = {n for p in phases for n in MESH_PHASES[p]}
    runs = [(name, world, f"file://{root / ('store_' + name)}", a, cli) for name, world, a, cli in runs if name in mine]
    return {"root": str(root), "cfgs": {k: str(v) for k, v in cfgs.items()}, "runs": runs}


def dp_train_phase(torch, ops, train, seq: dict) -> dict:
    """The flagship's multi-rank runs from seq train's spawn, then its one-rank references and the checks."""
    import yaml
    from PIL import Image

    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint

    mesh = seq["mesh"]
    root, ranks, runs = Path(mesh["root"]), mesh["ranks"], mesh["runs"]
    cfgs = {k: Path(v) for k, v in mesh["cfgs"].items()}
    flag = yaml.safe_load(CONFIG.read_text())

    # The flagship over 4 data ranks: exact launches; a resume at 2 ranks with the EMA sample (the sample's capture:
    # each forward wrapper twice) graph-replayed over the chain's 1000 steps, its GIFs from rank 0 alone; FSDP.
    dp = _check_run(ranks, "dp4", PER_STEP, MESH_STEPS)
    ckpts = sorted(int(p.stem[5:]) for p in (root / "dp4" / "checkpoints").glob("step_*.pt"))
    check(ckpts == [MESH_CKPT, MESH_STEPS], f"dp4: checkpoints at {ckpts}")
    sample_launches = {k: 2 * n for k, n in PER_FORWARD.items()}
    resumed = _check_run(ranks, "dp_resume2", PER_STEP, MESH_STEPS - MESH_CKPT, sample_launches)
    steps_t = flag["diffusion"]["timesteps"]
    check(resumed["graph"] == {"captures": 1, "replays": steps_t}, f"dp_resume2: the sample's graphs {resumed['graph']}")
    rows = yaml.safe_load(cfgs["dp_resume2"].read_text())["trainer"].get("num_sample_rows", 4)
    check(all(not any("does not divide" in m for m in r["dp_resume2"]["warnings"]) for r in ranks if "dp_resume2" in r),
          f"dp_resume2: the sample of {rows} rows ran replicated")
    paths = {int(k): v for k, v in resumed["sample_paths"].items()}
    check(list(paths) == [MESH_CKPT] and len(paths[MESH_CKPT]) == rows
          and all(not r["dp_resume2"]["sample_paths"] for r in ranks[1:] if "dp_resume2" in r),
          f"dp_resume2: sample GIFs {resumed['sample_paths']}")
    gifs = sorted((root / "dp_resume2" / "samples" / f"step_{MESH_CKPT}").glob("*.gif"))
    check(len(gifs) == rows and all(Image.open(p).n_frames == flag["diffusion"]["num_frames"] for p in gifs),
          f"dp_resume2: {len(gifs)} GIFs written")
    r_losses = resumed["losses"]
    check(all(math.isnan(v) for v in r_losses[:MESH_CKPT]) and all(math.isfinite(v) for v in r_losses[MESH_CKPT:])
          and resumed["opt_count"] == MESH_STEPS + 1 and resumed["mesh"] == {"data": 2, "model": 1},
          f"dp resume at 2 ranks: losses {r_losses}, optimizer count {resumed['opt_count']}")
    fsdp = _check_run(ranks, "fsdp4", PER_STEP, MESH_STEPS)
    check(fsdp["shard_axis"] == "data" and fsdp["mesh"] == {"data": 4, "model": 1}, f"fsdp4: {fsdp['mesh']}")
    fsdp_share = _resident_share(fsdp, MESH_WORLD, "fsdp4")

    one, _ = _one_rank(torch, train, cfgs["dp1"])
    plain, _ = _one_rank(torch, train, cfgs["dp1_plain"])
    control = _gap(plain["losses"], one["losses"])
    gates = {"dp4": _loss_gate("dp4", dp["losses"], one["losses"], control),
             "fsdp4": _loss_gate("fsdp4", fsdp["losses"], one["losses"], control)}
    files = {n: read_checkpoint(root / n / "checkpoints" / f"step_{MESH_STEPS}.pt") for n in ("dp4", "fsdp4", "dp1")}
    _, fresh = build_models(load_config(str(cfgs["dp1"])), device="cuda")
    init = {k: v.cpu() for k, v in fresh.state_dict().items()}
    del fresh
    d_fsdp = _update_distance(files["fsdp4"]["model"], files["dp4"]["model"], init)
    d_dp = _update_distance(files["dp4"]["model"], files["dp1"]["model"], init)
    check(d_fsdp <= 1.5 * d_dp + STATE_MARGIN, f"FSDP's state is {d_fsdp} of the update from DP's, over 1.5x DP's "
                                               f"{d_dp} from one rank's + {STATE_MARGIN}")
    check(set(files["fsdp4"]["model"]) == set(files["dp1"]["model"]) and all(
        files["fsdp4"][part][k].shape == files["dp1"][part][k].shape for part in ("model", "ema_params")
        for k in files["dp1"][part]), "the FSDP file is not a one-rank file")
    adam = files["fsdp4"]["optimizer"]["adam"]["state"]
    check(all(adam[i]["exp_avg"].shape == files["dp1"]["optimizer"]["adam"]["state"][i]["exp_avg"].shape
              for i in adam), "FSDP's moments in the file are not whole")
    del files
    return {"spawn_share_seconds": _spawn_share(ranks, DP_RUNS), "ranks": ranks, "cfgs": mesh["cfgs"],
            "run_seconds": {name: ranks[0][name]["seconds"] for name, *_ in runs},
            "world": MESH_WORLD, "batch": B_TRAIN, "rows_per_rank": B_TRAIN // MESH_WORLD, "steps": MESH_STEPS,
            "losses": dp["losses"], "fsdp_losses": fsdp["losses"], "one_rank": one, "plain_one_rank": plain,
            "loss_gates": gates, "update_distance": {"fsdp_to_dp": d_fsdp, "dp_to_one_rank": d_dp},
            "launches_per_rank": dp["launches"], "fsdp_launches_per_rank": fsdp["launches"],
            "launches": {k: sum(r["dp4"]["launches"][k] for r in ranks) for k in dp["launches"]},
            "fsdp_launches": {k: sum(r["fsdp4"]["launches"][k] for r in ranks) for k in fsdp["launches"]},
            "seconds_per_step": _sps(dp), "fsdp_seconds_per_step": _sps(fsdp),
            "sample_seconds": resumed["sample_seconds"], "resumed_losses": r_losses, "fsdp_resident": fsdp_share,
            "peak_memory_per_rank": [r["dp4"]["peak_memory"] for r in ranks],
            "fsdp_peak_memory_per_rank": [r["fsdp4"]["peak_memory"] for r in ranks],
            "collectives_per_rank_per_step": {k: v / MESH_STEPS for k, v in dp["comm"].items()},
            "fsdp_collectives_per_rank_per_step": {k: v / MESH_STEPS for k, v in fsdp["comm"].items()}}


def tp_train_phase(torch, train, mesh: dict) -> dict:
    """The dim-128 recipe on (data 2 x model 2) from the spawn, then on one rank here (the clamp)."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint

    ranks, cfgs = mesh["ranks"], {k: Path(v) for k, v in mesh["cfgs"].items()}
    # One rank first: its clamp, and the routes the recipe's shapes take (the wider columns on the CUDA-core kernels).
    one, warnings = _one_rank(torch, train, cfgs["tp1"])
    check(any("num_model_shards=2 exceeds the 1 available rank(s); clamping to 1" in m for m in warnings)
          and one["mesh"] is None and one["shards"] == 0, f"tp on one rank: warnings {warnings}")
    check(one["launches"] == {k: n * TP_STEPS for k, n in DIM128_PER_STEP.items()},
          f"tp on one rank: launches {one['launches']}")
    staged = {k: one["staged_launches"].get(k, 0) // TP_STEPS for k in DIM128_PER_STEP}
    run = _check_run(ranks, "tp4", DIM128_PER_STEP, TP_STEPS, staged_per_step=staged)
    check(run["mesh"] == {"data": 2, "model": 2} and run["shard_axis"] == "model", f"tp4: mesh {run['mesh']}")
    share = _resident_share(run, 2, "tp4")
    root = cfgs["tp4"].parent
    ckpts = sorted(int(p.stem[5:]) for p in (root / "tp4" / "checkpoints").glob("step_*.pt"))
    check(ckpts == [TP_CKPT, TP_STEPS], f"tp4: checkpoints at {ckpts}")
    resumed = _check_run(ranks, "tp_resume", DIM128_PER_STEP, TP_STEPS - TP_CKPT, staged_per_step=staged)
    check(resumed["opt_count"] == TP_STEPS + 1 and not any("fresh optimizer" in m for m in resumed["warnings"])
          and all(math.isfinite(v) for v in resumed["losses"][TP_CKPT:]),
          f"tp resume: optimizer count {resumed['opt_count']}, warnings {resumed['warnings']}")
    payload = read_checkpoint(root / "tp4" / "checkpoints" / f"step_{TP_STEPS}.pt")
    _, model = build_models(load_config(str(cfgs["tp4"])), device="cuda")
    want = model.state_dict()
    check({k: tuple(v.shape) for k, v in payload["model"].items()} == {k: tuple(v.shape) for k, v in want.items()},
          "tp4: the file from shards has other keys or shapes than a one-rank model")
    model.load_state_dict(payload["model"], strict=True)
    del payload, model, want

    plain, _ = _one_rank(torch, train, cfgs["tp1_plain"])
    gate = _loss_gate("tp4", run["losses"], one["losses"], _gap(plain["losses"], one["losses"]))
    return {"spawn_share_seconds": _spawn_share(ranks, TP_RUNS),
            "world": MESH_WORLD, "mesh": run["mesh"], "batch": 4, "rows_per_rank": 1, "steps": TP_STEPS,
            "losses": run["losses"], "one_rank": one, "plain_one_rank": plain, "clamp_warning": True,
            "staged_per_step": staged,
            "loss_gate": gate, "resident": share, "launches_per_rank": run["launches"],
            "launches": {k: sum(r["tp4"]["launches"][k] for r in ranks) for k in run["launches"]},
            "seconds_per_step": _sps(run, warm=1), "resumed_losses": resumed["losses"],
            "save_seconds": run["save_seconds"], "peak_memory_per_rank": [r["tp4"]["peak_memory"] for r in ranks],
            "collectives_per_rank_per_step": {k: v / TP_STEPS for k, v in run["comm"].items()}}


def seq_dp_train_phase(torch, train, mesh: dict, seq: dict) -> dict:
    """The seq recipe on (data 2 x seq 2) from the spawn, held against seq train's 4-rank run (the same step) within
    seq train's gate; then under accumulation against one rank's accumulation."""
    ranks, cfgs = mesh["ranks"], {k: Path(v) for k, v in mesh["cfgs"].items()}
    run = _check_run(ranks, "seqdp", SEQ_PER_STEP, SEQ_STEPS)
    check(run["mesh"] == {"data": 2, "seq": 2}, f"seqdp: mesh {run['mesh']}")
    control = seq["loss_gate"]["control_gap"]
    gate = _loss_gate("seqdp", run["losses"], seq["losses"], control)
    acc = _check_run(ranks, "seqdp_acc", SEQ_PER_STEP, SEQ_DP_ACC_STEPS * 2)
    one, _ = _one_rank(torch, train, cfgs["seq1_acc"])
    acc_gate = _loss_gate("seqdp_acc", acc["losses"], one["losses"], control)
    return {"spawn_share_seconds": _spawn_share(ranks, SEQ_DP_RUNS),
            "world": MESH_WORLD, "mesh": run["mesh"], "batch": 2, "frames_per_rank": SEQ_FL * 2, "steps": SEQ_STEPS,
            "losses": run["losses"], "loss_gate": gate, "accumulation": {
                "batch": 4, "microbatches": 2, "steps": SEQ_DP_ACC_STEPS, "losses": acc["losses"],
                "one_rank_losses": one["losses"], "loss_gate": acc_gate, "launches_per_rank": acc["launches"]},
            "launches_per_rank": run["launches"],
            "launches": {k: sum(r["seqdp"]["launches"][k] for r in ranks) for k in run["launches"]},
            "seconds_per_step": _sps(run, warm=SEQ_WARM),
            "peak_memory_per_rank": [r["seqdp"]["peak_memory"] for r in ranks],
            "collectives_per_rank_per_step": {k: v / SEQ_STEPS for k, v in run["comm"].items()}}


# Data ranks outside the trainer (A15's last part), three phases over seq train's spawn: the sample and extend CLIs
# (DDIM-DP_SAMPLE_STEPS at batch DP_BATCH from the train phase's checkpoint, DP_KEEP known frames for extend), both
# distillation CLIs (DP_DISTILL_STEPS steps at batch 8: progressive from the train phase's weights, guidance from the
# cond phase's) and the server (SERVE_CLIENTS concurrent batch-1 DDIM-SERVE_STEPS clients), each over MESH_WORLD
# ranks of 2 rows. The one-rank references run here (sampling, serving) or are the distillation phases' first
# DP_DISTILL_STEPS steps (the same flags, seed and data), whose plain-module run is the loss gate's control.
DP_CLIS = {"dp_sample": "sample", "dp_extend": "extend", "dp_distill": "distill", "dp_guidance": "distill_guidance",
           "dp_serve": "serve"}
DP_BATCH, DP_SAMPLE_STEPS, DP_KEEP, DP_DISTILL_STEPS = B_TRAIN, 50, 4, 3


def dp_cli_argv(root: Path) -> dict:
    """Each data-rank CLI run's arguments (the spawned runs add ``--output-path``)."""
    flag, cond = SCRATCH / "train", SCRATCH / "cond"
    common = ["--config", str(flag / "kernels.yaml"), "--device", "cuda", "--checkpoint-path",
              str(flag / "kernels" / "checkpoints" / f"step_{TRAIN_STEPS}.pt")]
    sampling = [*common, "--batch-size", str(DP_BATCH), "--num-steps", str(DP_SAMPLE_STEPS)]
    return {"dp_sample": [*sampling, "--sampler", "ddim", "--seed", "0"],
            "dp_extend": [*sampling, "--input", str(root / "extend_clip.npy"), "--keep-frames", str(DP_KEEP),
                          "--seed", "1"],
            "dp_distill": [*common, "--no-ema", "--initial-steps", str(DISTILL_N), "--rounds", "1",
                           "--steps-per-round", str(DP_DISTILL_STEPS), "--batch-size", str(B_TRAIN)],
            "dp_guidance": ["--config", str(cond / "kernels.yaml"), "--device", "cuda", "--checkpoint-path",
                            str(cond / "kernels" / "checkpoints" / f"step_{COND_STEPS}.pt"), "--no-ema",
                            "--num-steps", str(DP_DISTILL_STEPS), "--batch-size", str(B_TRAIN), "--w-min", "1",
                            "--w-max", "8"],
            "dp_serve": common}


def _dp_runs(ranks: list, name: str, want: dict | None) -> list:
    """Run ``name`` on every rank: on cuda:0, exactly ``want`` launches (None: two per capture of each forward kernel,
    the run's own captures), all staged."""
    runs = [r[name] for r in ranks]
    for r, run in enumerate(runs):
        expect = want if want is not None else {k: 2 * n * run["graph"]["captures"] for k, n in PER_FORWARD.items()}
        check(run["launches"] == expect and run["staged_launches"] == expect and run["device"] == "cuda:0",
              f"{name} rank {r}: launches {run['launches']}, staged {run['staged_launches']} on {run['device']}, "
              f"expected {expect}")
    return runs


def _launch_sum(runs_by_name: dict) -> dict:
    out = {}
    for runs in runs_by_name.values():
        for run in runs:
            for k, v in run["launches"].items():
                out[k] = out.get(k, 0) + v
    return out


def dp_sample_phase(torch, sample, extend, seq: dict) -> dict:
    """The sample and extend CLIs over 4 ranks from seq train's spawn: exact launches per rank (one capture of the
    rows' shape each, the replays none), the gathered batch bit-equal over the ranks, GIFs from rank 0 alone, every
    row within ``SERVE_TOL`` of the one-rank CLI's (run here), the pinned frames equal; s per clip against one rank."""
    mesh = seq["mesh"]
    ranks, root = mesh["ranks"], Path(mesh["root"])
    argv = dp_cli_argv(root)
    out, runs = {"spawn_share_seconds": _spawn_share(ranks, DP_SAMPLE_RUNS), "world": MESH_WORLD, "batch": DP_BATCH,
                 "rows_per_rank": DP_BATCH // MESH_WORLD, "steps": DP_SAMPLE_STEPS}, {}
    for name, module in (("dp_sample", sample), ("dp_extend", extend)):
        runs[name] = _dp_runs(ranks, name, {k: 2 * n for k, n in PER_FORWARD.items()})
        for r, run in enumerate(runs[name]):
            check(run["graph"] == {"captures": 1, "replays": DP_SAMPLE_STEPS} and not run["warnings"],
                  f"{name} rank {r}: graphs {run['graph']}, warnings {run['warnings']}")
        check(len({run["videos_digest"] for run in runs[name]}) == 1, f"{name}: the ranks' gathered batches differ")
        check(len(runs[name][0]["paths"]) == DP_BATCH and not any(run["paths"] for run in runs[name][1:]),
              f"{name}: GIFs {[run['paths'] for run in runs[name]]}")
        got = torch.load(root / f"{name}_videos.pt")
        one = module.main(argv[name] + ["--output-path", str(root / f"{name}_one")])
        errs = [float((a - b).abs().max()) for a, b in zip(got, one["videos"])]
        check(tuple(got.shape) == tuple(one["videos"].shape) and max(errs) <= SERVE_TOL,
              f"{name}: rows part from the one-rank run's by {errs} (gate {SERVE_TOL})")
        if name == "dp_extend":
            check(torch.equal(got[:, :, :DP_KEEP], one["videos"][:, :, :DP_KEEP]), "dp_extend: the pinned frames")
        sampler = runs[name][0]["sampler_seconds"]
        out[name] = {"max_abs_vs_one_rank": errs, "run_seconds": runs[name][0]["seconds"], "sampler_seconds": sampler,
                     "one_rank_sampler_seconds": one["seconds"], "seconds_per_clip": sampler / DP_BATCH,
                     "one_rank_seconds_per_clip": one["seconds"] / DP_BATCH,
                     "peak_memory_per_rank": [run["peak_memory"] for run in runs[name]]}
    out["launches"] = _launch_sum(runs)
    out["launches_per_rank"] = runs["dp_sample"][0]["launches"]
    return out


def dp_distill_phase(torch, seq: dict, distilled: dict, guided: dict) -> dict:
    """Both distillation CLIs over 4 ranks from seq train's spawn: exact launches per rank (three forwards and a
    backward a step), all staged; the ranks' losses and students (parameters, EMA, Adam's moments) bit-equal; the
    files from rank 0 alone; the losses against the one-rank run's (the distillation phases' first steps) within
    1.5x the gap of its plain-module run plus 0.001, which the losses scaled by 1.01 must fail."""
    mesh = seq["mesh"]
    ranks = mesh["ranks"]
    out, runs = {"spawn_share_seconds": _spawn_share(ranks, DP_DISTILL_RUNS), "world": MESH_WORLD, "batch": B_TRAIN,
                 "rows_per_rank": B_TRAIN // MESH_WORLD, "steps": DP_DISTILL_STEPS}, {}
    for name, ref in (("dp_distill", distilled), ("dp_guidance", guided)):
        runs[name] = _dp_runs(ranks, name, {k: n * DP_DISTILL_STEPS for k, n in DISTILL_PER_STEP.items()})
        first = runs[name][0]
        check(all(run["losses"] == first["losses"] and run["student_digests"] == first["student_digests"]
                  and len(run["student_digests"]) == 1 for run in runs[name]),
              f"{name}: the ranks' losses or students differ")
        check(len(first["paths"]) == 1 and not any(run["paths"] for run in runs[name][1:]),
              f"{name}: files {[run['paths'] for run in runs[name]]}")
        one = ref["kernels"]["losses"][:DP_DISTILL_STEPS]
        control = _gap(ref["plain"]["losses"][:DP_DISTILL_STEPS], one)
        out[name] = {"losses": first["losses"], "one_rank_losses": one,
                     "loss_gate": _loss_gate(name, first["losses"], one, control),
                     "seconds_per_step": first["seconds_per_step"],
                     "one_rank_seconds_per_step": ref["kernels"]["seconds_per_step"],
                     "peak_memory_per_rank": [run["peak_memory"] for run in runs[name]]}
    out["launches"] = _launch_sum(runs)
    return out


def dp_serve_phase(torch, seq: dict, served: dict | None) -> dict:
    """The server over 4 ranks from seq train's spawn: /health counts the ranks; every rank's launches exact for its
    captures, all staged; each of SERVE_CLIENTS concurrent batch-1 DDIM-SERVE_STEPS rows within ``SERVE_TOL`` of one
    rank sampling the same seeds' x_T as one batch (here); clips per second against the serve phase's one rank."""
    from video_diffusion_nnx_tpu_torch import serve

    mesh = seq["mesh"]
    ranks, root = mesh["ranks"], Path(mesh["root"])
    runs = _dp_runs(ranks, "dp_serve", None)
    rec = runs[0]
    check(rec["health"]["devices"] == MESH_WORLD and rec["health"]["status"] == "ok", f"dp serve: /health {rec['health']}")
    rows = torch.load(root / "dp_serve_rows.pt")
    args = serve.parse_args(dp_cli_argv(root)["dp_serve"])
    model = serve.load_model(args, torch.device(args.device))
    shape = (1, model.channels, model.num_frames, model.image_size, model.image_size)
    x_T = torch.cat([torch.randn(shape, generator=torch.Generator(device=model.device).manual_seed(i),
                                 device=model.device) for i in range(len(rows))])  # each request's, as served
    want = model.ddim_sample(batch_size=len(rows), num_steps=SERVE_STEPS, init_noise=x_T).float().cpu()
    errs = [float((got - w).abs().max()) for got, w in zip(rows, want)]
    check(max(rec["groups"]) >= 2 and max(errs) <= SERVE_TOL,
          f"dp serve: groups {rec['groups']}, rows from one rank's {errs} (gate {SERVE_TOL})")
    tput = rec["throughput"]
    one = None if served is None else served["throughput"][f"batched_n{SERVE_CLIENTS}_clips_per_s"]
    return {"spawn_share_seconds": _spawn_share(ranks, DP_SERVE_RUNS), "world": MESH_WORLD, "clients": SERVE_CLIENTS,
            "steps": SERVE_STEPS, "groups": rec["groups"], "max_abs_vs_one_rank": errs, "throughput": tput,
            "clips_per_s": tput[f"ranks_n{SERVE_CLIENTS}_clips_per_s"], "one_rank_clips_per_s": one,
            "captures_per_rank": [run["graph"]["captures"] for run in runs],
            "launches": _launch_sum({"dp_serve": runs}), "peak_memory_per_rank": [run["peak_memory"] for run in runs]}


# The VideoDiT family (A11). D1 is configs/config_bouncing_digits.yaml with its unet block replaced by the DiT of
# scripts/ab_dit_fused.py:35-39 (dim 256, depth 6, 8 heads of 32, patch 4) and diffusion.num_frames and
# trainer.num_frames set to 16; D2 is bench.py's do_dit shape (bench.py:515-523 with :137's 1 channel, 64x64 and 250
# timesteps: dim 384, depth 8, 6 heads of 64, patch 8, 10 frames, l2, noise prediction, batch 4). Both attentions of
# every block take the temporal op in float32 (the bf16 policy's float32 modulation promotes what they are given):
# D1 spatial over 256 patches (blockwise), temporal over 16 frames (dense); D2 spatial over 64 patches at c = 384
# (wide), temporal over 10 frames at head dim 64 (dense, CUDA-core). Which kernel and route each call takes is
# ``temporal_plan``'s, for the card's SM count (``dit_plan``); every launch is checked against it.
DIT_D1_UNET = {"arch": "dit", "rngs_seed": 0, "dim": 256, "depth": 6, "channels": 1, "attn_heads": 8,
               "attn_dim_head": 32, "patch_size": 4, "compute_dtype": "bfloat16", "use_fused_attention": True}
DIT_D1_FRAMES = 16
DIT_D2_UNET = {**DIT_D1_UNET, "dim": 384, "depth": 8, "attn_heads": 6, "attn_dim_head": 64, "patch_size": 8}
DIT_D2_DIFFUSION = {"image_size": 64, "num_frames": 10, "timesteps": 250, "loss_type": "l2", "channels": 1,
                    "prediction_type": "noise"}
DIT_BATCH = {"D1": B_TRAIN, "D2": 4}
DIT_STEPS, DIT_CKPT_EVERY, DIT_CLIPS, DIT_COND_STEPS = 4, 2, 64, 10  # 8 and 4 before the data-rank phases
DIT_PERTURB = 0.05  # std of the adaLN and output weights drawn before a gradient check (all zero at init)


def dit_raw(recipe: str) -> dict:
    """The recipe as a config dict: D1 derived from the flagship YAML, D2 from bench.py's do_dit shape."""
    import yaml

    raw = yaml.safe_load(CONFIG.read_text())
    if recipe == "D1":
        raw["unet"] = dict(DIT_D1_UNET)
        raw["diffusion"]["num_frames"] = raw["trainer"]["num_frames"] = DIT_D1_FRAMES
    else:
        raw["unet"] = dict(DIT_D2_UNET)
        raw["diffusion"] = dict(DIT_D2_DIFFUSION)
        raw["trainer"]["num_frames"] = DIT_D2_DIFFUSION["num_frames"]
    return raw


def dit_plan(torch, ta, raw: dict, batch: int) -> dict:
    """Per attention of a DiT forward at ``batch`` rows: its op shape (b, s, f, c), and per direction the kernel
    and the route ``temporal_plan`` gives it on this card."""
    u, d = raw["unet"], raw["diffusion"]
    s, f, c = (d["image_size"] // u["patch_size"]) ** 2, d["num_frames"], u["dim"]
    heads, dim = u["attn_heads"], u["attn_dim_head"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = {}
    for att, shape in (("spatial", (batch, f, s, c)), ("temporal", (batch, s, f, c))):
        row = {"shape": shape, "heads": heads, "dim": dim, "depth": u["depth"]}
        for way in ("fwd", "bwd"):
            p = ta.temporal_plan(shape[0] * shape[1], shape[2], c, dim, heads, False, sms, way == "bwd")
            family = "attention" if p["family"] == "dense" else p["family"]
            row[way] = {"kernel": f"temporal_{family}_{way}", "route": p["route"], "grid": p["grid"]}
        plan[att] = row
    return plan


def dit_launches(plan: dict, times: int = 1, ways=("fwd", "bwd")) -> tuple[dict, dict, dict, dict]:
    """The launches ``times`` forwards (and backwards) of the plan's DiT make, and of them those of a staged or
    streaming route, those of the float32 tensor-core backward of csrc/temporal_tf32x3.cu, and those of the staged
    or streaming float32 backward in 3xTF32."""
    counts, staged, tf32x3, staged3 = {}, {}, {}, {}
    for row in plan.values():
        for way in ways:
            name, n, route = row[way]["kernel"], row["depth"] * times, row[way]["route"]
            counts[name] = counts.get(name, 0) + n
            staged[name] = staged.get(name, 0) + n * (route in ("staged", "staged-3xtf32"))
            tf32x3[name] = tf32x3.get(name, 0) + n * (route == "tf32x3")
            staged3[name] = staged3.get(name, 0) + n * (route == "staged-3xtf32")
    return counts, staged, tf32x3, staged3


def check_dit_launches(ops, plan: dict, where: str, times: int = 1, ways=("fwd", "bwd")) -> dict:
    """Since the last reset: exactly the plan's launches, each of the route the planner gave it."""
    counts, staged, tf32x3 = nonzero(ops.launch_counts()), ops.staged_launch_counts(), ops.tf32x3_launch_counts()
    staged3 = ops.staged_tf32x3_launch_counts()
    want, want_staged, want_tf32x3, want_staged3 = dit_launches(plan, times, ways)
    check(counts == want, f"{where}: launches {counts}, expected {want}")
    got_staged = {k: staged.get(k, 0) for k in want}
    check(got_staged == want_staged, f"{where}: staged launches {got_staged}, the planner's {want_staged}")
    got_tf32x3 = {k: tf32x3.get(k, 0) for k in want}
    check(got_tf32x3 == want_tf32x3, f"{where}: 3xtf32 launches {got_tf32x3}, the planner's {want_tf32x3}")
    got_staged3 = {k: staged3.get(k, 0) for k in want}
    check(got_staged3 == want_staged3, f"{where}: staged-3xtf32 launches {got_staged3}, the planner's {want_staged3}")
    return counts


def _perturb_dit(torch, dit, seed: int = 5) -> None:
    """Draw the adaLN, final modulation and output weights at ``DIT_PERTURB`` (they start at zero, and then no
    attention reaches the output or has a gradient)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin in [blk.ada for blk in dit.blocks] + [dit.final_ada, dit.final_proj]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * DIT_PERTURB)


def dit_kernel_phase(torch, ta) -> dict:
    """Each attention kernel of D1 (batch 8) and D2 (batch 4) at the DiT's own shapes, in float32 (what the DiT
    hands it), against its plain version: forward max-abs within ``TOL``, every gradient within ``BWD_TOL`` of its
    largest value; the kernel and route the planner gives; CUDA-event times of kernel and plain version, and the
    bound at the float32 peak, per step (``depth`` launches of each)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, per_step, grad_names = [], {}, ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
    for recipe in ("D1", "D2"):
        plan = dit_plan(torch, ta, dit_raw(recipe), DIT_BATCH[recipe])
        agg = per_step[recipe] = {}
        for att, p in plan.items():
            shape, heads, dim, count = p["shape"], p["heads"], p["dim"], p["depth"]
            b, s, f, c = shape
            hd = heads * dim
            x = rand(torch, shape, 1, 0.5, torch.float32)
            g = rand(torch, shape, 9, 0.1, torch.float32)
            w = (rand(torch, (c, 3 * hd), 2, c ** -0.5, torch.float32), rand(torch, (3 * hd,), 3, 0.1, torch.float32),
                 rand(torch, (hd, c), 4, hd ** -0.5, torch.float32), rand(torch, (c,), 5, 0.1, torch.float32))
            blockwise = p["fwd"]["kernel"].startswith("temporal_blockwise")
            plain_f = ((lambda: ta.temporal_attention_blockwise_plain(x, *w, heads, dim, ta.KV_BLOCK)) if blockwise
                       else (lambda: ta.temporal_attention_plain(x, *w, heads, dim)))
            plain_b = ((lambda: ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK))
                       if blockwise else (lambda: ta.temporal_attention_bwd_plain(x, g, *w, heads, dim)))
            before = route_counts(ta)
            got = ta.fused_temporal_attention_block(x, *w, heads, dim)
            grads = ta.temporal_attention_bwd(x, g, *w, heads, dim)
            torch.cuda.synchronize()
            now = route_counts(ta)
            for way in ("fwd", "bwd"):
                name = p[way]["kernel"]
                launched = {k: now[k][0] - before[k][0] for k in now if now[k][0] != before[k][0]}
                check(launched.get(name) == 1, f"DiT {recipe} {att} {way}: launched {launched}, planned {name}")
                check(now[name][1] - before[name][1] == (p[way]["route"] in ("staged", "staged-3xtf32"))
                      and now[name][2] - before[name][2] == (p[way]["route"] == "tf32x3")
                      and now[name][3] - before[name][3] == (p[way]["route"] == "staged-3xtf32"),
                      f"DiT {recipe} {att} {way}: the C entry's route is not the planner's {p[way]['route']}")
            err = _max_abs(got, plain_f())
            check(math.isfinite(err) and err <= TOL["float32"],
                  f"DiT {recipe} {att} fwd at {shape}: max-abs error {err} over {TOL['float32']}")
            want = plain_b()
            rel = {k: _rel_err(a, v) for k, a, v in zip(grad_names, grads, want)}
            err_b = max(_max_abs(a, v) for a, v in zip(grads, want))
            for k, r in rel.items():
                check(math.isfinite(r) and r <= BWD_TOL["float32"],
                      f"DiT {recipe} {att} bwd {k} at {shape}: error {r} of its largest value, over {BWD_TOL['float32']}")
            del want, got, grads
            rows_n = b * s * f
            f_bytes = 4 * (2 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c)
            f_flops = rows_n * (8 * c * hd + 4 * f * hd)
            b_bytes = 4 * (3 * rows_n * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
            b_flops = rows_n * (22 * c * hd + 12 * f * hd)
            timings = {
                "fwd": (err, cuda_ms(torch, lambda: ta.fused_temporal_attention_block(x, *w, heads, dim), 5, 1),
                        cuda_ms(torch, plain_f, 3, 1), f_bytes, f_flops),
                "bwd": (err_b, cuda_ms(torch, lambda: ta.temporal_attention_bwd(x, g, *w, heads, dim), 3, 1),
                        cuda_ms(torch, plain_b, 3, 1), b_bytes, b_flops),
            }
            for way, (e, ms, plain_ms, nbytes, flops) in timings.items():
                name = p[way]["kernel"]
                row = {"recipe": recipe, "attention": att, "kernel": name, "shape": shape, "heads": heads, "dim": dim,
                       "dtype": "float32", "route": p[way]["route"], "grid": p[way]["grid"], "per_step": count,
                       **({"max_abs_err": e, "tol": TOL["float32"]} if way == "fwd"
                          else {"rel_err": rel, "max_abs_err": e, "tol": BWD_TOL["float32"]})}
                add_timing(row, agg.setdefault(name, new_totals((name,))[name]), count, e, ms, plain_ms, nbytes,
                           flops, PEAK_F32_FLOPS)
                if p[way]["route"] in ("tf32x3", "staged-3xtf32"):  # also at the 3xTF32 rate
                    add_3xtf32_bound(row, agg[name], count, nbytes, flops)
                agg[name].update(route=p[way]["route"], shape=shape)
                rows.append(row)
                print("  " + json.dumps(row), flush=True)
            del x, g
    return {"rows": rows, "per_step": per_step}


def dit_model_phase(torch, ops, ta, sla, build_models, recipe: str) -> dict:
    """One recipe's VideoDiT at full width and depth with seeded weights, its adaLN drawn at ``DIT_PERTURB``: a
    forward and a loss with its backward through the kernels, against the plain modules (bf16) and float32, on
    the same batch. Gates: the forward as the unet phase's; the loss within ``LOSS_TOL``; each gradient tensor and
    the whole gradient as the grads phase's, with its largest control fault caught; every attention weight's
    gradient nonzero; exact launches on the planner's routes. D2 adds DDIM-10 at batch 4, graphed against eager."""
    raw, batch = dit_raw(recipe), DIT_BATCH[recipe]
    plan = dit_plan(torch, ta, raw, batch)
    _, kernels = build_models(raw, device="cuda")
    _perturb_dit(torch, kernels.denoise_fn)
    models = {"kernels": kernels}
    for name, extra in (("plain", {"use_fused_attention": False}),
                        ("f32", {"use_fused_attention": False, "compute_dtype": None})):
        _, models[name] = build_models({**raw, "unet": {**raw["unet"], **extra}}, device="cuda")
        models[name].load_state_dict(kernels.state_dict())
    d = raw["diffusion"]
    shape = (batch, d["channels"], d["num_frames"], d["image_size"], d["image_size"])
    x = rand(torch, shape, 12, 1.0, torch.float32).sigmoid()
    noise = rand(torch, shape, 13, 1.0, torch.float32)
    t = torch.linspace(0, d["timesteps"] - 1, batch, device="cuda").long()
    out = {"batch": batch, "plan": plan}

    # The forward, on the noised input the loss sees.
    x_t = rand(torch, shape, 11, 1.0, torch.float32)
    ys, fwd_ms = {}, {}
    with torch.no_grad():
        for name, m in models.items():
            ops.reset_launch_counts()
            ys[name] = m.denoise_fn(x_t, t)
            torch.cuda.synchronize()
            if name == "kernels":
                check_dit_launches(ops, plan, f"DiT {recipe} forward", ways=("fwd",))
            else:
                check(not nonzero(ops.launch_counts()), f"DiT {recipe} {name} forward launched {ops.launch_counts()}")
            fwd_ms[name] = cuda_ms(torch, lambda m=m: m.denoise_fn(x_t, t), 3, 1)
    y_k, y_p, y_32 = ys["kernels"], ys["plain"], ys["f32"]
    check(tuple(y_k.shape) == (batch, d["num_frames"], d["image_size"], d["image_size"], d["channels"])
          and y_k.dtype == torch.float32 and bool(torch.isfinite(y_k).all()), f"DiT {recipe}: forward {y_k.shape}")
    scale = y_32.abs().max().item()
    diff, err_k, err_p = _max_abs(y_k, y_p), _max_abs(y_k, y_32), _max_abs(y_p, y_32)
    check(diff <= 0.1 * scale, f"DiT {recipe} kernels vs plain modules: {diff} > {0.1 * scale}")
    check(err_k <= 1.5 * err_p + 0.01 * scale, f"DiT {recipe} kernel route {err_k} from f32, plain {err_p}")
    out["forward"] = {"max_abs_kernels_vs_plain": diff, "kernels_vs_f32": err_k, "plain_vs_f32": err_p,
                      "max_abs_ref": scale, "ms": fwd_ms}
    del ys, y_k, y_p, y_32

    grads, losses, step_ms, peak = {}, {}, {}, {}

    def run(m):
        m.zero_grad(set_to_none=True)
        loss = m(x, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.detach().float().clone() for k, p in m.named_parameters() if p.grad is not None}

    for name, m in models.items():
        m.train()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses[name], grads[name] = run(m)
        peak[name] = torch.cuda.max_memory_allocated()
        if name == "kernels":
            out["launches"] = check_dit_launches(ops, plan, f"DiT {recipe} step")

        def step(m=m):
            m.zero_grad(set_to_none=True)
            m(x, t=t, noise=noise).backward()

        step_ms[name] = cuda_ms(torch, step, 3, 1)
    gap = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    check(all(math.isfinite(v) for v in losses.values()) and gap <= LOSS_TOL,
          f"DiT {recipe} losses {losses}: kernels vs plain {gap} over {LOSS_TOL}")
    check(set(grads["kernels"]) == set(grads["plain"]) == set(grads["f32"]), f"DiT {recipe}: gradient sets differ")
    attn = [k for k in grads["kernels"] if ".attn_" in k and k.endswith("weight")]
    dead = [k for k in attn if not grads["kernels"][k].abs().max().item() > 0]
    check(len(attn) == 8 * raw["unet"]["depth"] and not dead, f"DiT {recipe}: zero attention gradients {dead}")
    floor = {n: GRAD_FLOOR * torch.sqrt(sum(g.square().sum() for g in grads[n].values())).item() for n in grads}

    def rel(a, b, ref):
        return ((a - b).norm() / max(b.norm().item(), floor[ref])).item()

    def whole(name):
        num = sum((grads[name][k] - grads["f32"][k]).square().sum() for k in grads["f32"])
        return torch.sqrt(num).item() / (floor["f32"] / GRAD_FLOOR)

    per = {k: rel(grads["kernels"][k], grads["plain"][k], "plain") for k in grads["f32"]}
    worst = max(per, key=per.get)
    check(per[worst] <= GRAD_TOL, f"DiT {recipe} grad of {worst}: kernels vs plain modules {per[worst]} > {GRAD_TOL}")
    k_whole, p_whole = whole("kernels"), whole("plain")
    check(k_whole <= 1.5 * p_whole + GRAD_MARGIN, f"DiT {recipe} whole gradient: kernels {k_whole}, plain {p_whole}")
    saved = ta.temporal_attention_bwd, sla.sla_bwd_q
    try:
        ta.temporal_attention_bwd, sla.sla_bwd_q = _faulty_backward(ta, sla, max(CONTROL_FAULTS))
        _, grads["control"] = run(kernels)
    finally:
        ta.temporal_attention_bwd, sla.sla_bwd_q = saved
    c_tensor = max(rel(grads["control"][k], grads["plain"][k], "plain") for k in per)
    c_whole = whole("control")
    caught = c_tensor > GRAD_TOL or c_whole > 1.5 * p_whole + GRAD_MARGIN
    check(caught, f"DiT {recipe}: the gradient checks miss the control fault ({c_tensor}, {c_whole})")
    out.update(losses=losses, loss_gap_vs_plain=gap, fwd_bwd_ms=step_ms, peak_memory=peak,
               attention_weight_tensors=len(attn), max_k_vs_p=per[worst], worst=worst, kernels_vs_f32=k_whole,
               plain_vs_f32=p_whole, limits={"per_tensor": GRAD_TOL, "whole": 1.5 * p_whole + GRAD_MARGIN},
               control={"fault": max(CONTROL_FAULTS), "max_k_vs_p": c_tensor, "kernels_vs_f32": c_whole})
    del grads, models

    if recipe == "D2":  # DDIM-10 at batch 4, graphed against eager from one seed
        kernels.eval()
        steps = 10
        ops.reset_launch_counts()
        graphed = kernels.ddim_sample(batch_size=batch, num_steps=steps, generator=torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        check(kernels.graphs.captures == 1 and kernels.graphs.replays() == steps,
              f"DiT D2 DDIM: graphs {kernels.graphs.captures} captures, {kernels.graphs.replays()} replays")
        check_dit_launches(ops, plan, "DiT D2 DDIM-10 (graphed: a warm-up and a capture)", times=2, ways=("fwd",))
        eager = kernels.ddim_sample(batch_size=batch, num_steps=steps, generator=torch.Generator("cuda").manual_seed(0),
                                    graph=False)
        check(tuple(graphed.shape) == shape and bool(torch.isfinite(graphed).all()), "DiT D2 DDIM: samples")
        out["ddim10"] = {"bit_equal": bool(torch.equal(graphed, eager)), "max_abs_graphed_vs_eager": _max_abs(graphed, eager)}
        check(out["ddim10"]["bit_equal"], f"DiT D2 DDIM: graphed and eager part by {out['ddim10']}")
    return out


def dit_train_phase(torch, ops, ta, train, sample, build_models) -> dict:
    """D1 through the CLIs: ``train.main`` for ``DIT_STEPS`` steps at batch 8 on 16-frame synthetic squares, a
    checkpoint every ``DIT_CKPT_EVERY``, a resume from the first; ``sample.main`` DDIM-50 at batch 8 (graphed, the
    result equal to the eager sampler bit for bit) and DPM-20 at batch 8 from the last checkpoint; then the server
    around those weights with 2 concurrent batch-1 DDIM-50 clients, each within ``SERVE_TOL`` of its solo run, and
    clips per second coalesced against serial."""
    import threading
    import urllib.request

    import numpy as np
    import yaml
    from PIL import Image

    from video_diffusion_nnx_tpu_torch import bench_serve, serve
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint

    raw = dit_raw("D1")
    d = raw["diffusion"]
    root = SCRATCH / "dit"
    root.mkdir(parents=True, exist_ok=True)
    data = bouncing_squares(root / "squares16.npy", clips=DIT_CLIPS, frames=DIT_D1_FRAMES)
    cfg = _train_config(yaml, raw, root, data, "kernels", steps=DIT_STEPS, ckpt_every=DIT_CKPT_EVERY)
    for old in (root / "kernels" / "checkpoints").glob("step_*.pt"):
        old.unlink()
    plan = dit_plan(torch, ta, raw, B_TRAIN)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr = train.main(["--config", str(cfg), "--device", "cuda"])
    counts = check_dit_launches(ops, plan, "DiT D1 train", times=DIT_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = tr.loss_trace.tolist()
    check(len(losses) == DIT_STEPS and all(math.isfinite(v) for v in losses), f"DiT D1 losses {losses}")
    ckpts = sorted(int(p.stem[5:]) for p in tr.checkpoint_dir_path.glob("step_*.pt"))
    check(ckpts == list(range(DIT_CKPT_EVERY, DIT_STEPS + 1, DIT_CKPT_EVERY)), f"DiT D1 checkpoints {ckpts}")
    sps, save_s = _seconds_per_step(tr, warmup=3)
    ckpt = tr.checkpoint_dir_path / f"step_{DIT_STEPS}.pt"
    del tr
    resumed = train.main(["--config", str(cfg), "--device", "cuda", "--resume_step", str(DIT_CKPT_EVERY)])
    trace = resumed.loss_trace.tolist()
    check(all(math.isnan(v) for v in trace[:DIT_CKPT_EVERY]) and all(math.isfinite(v) for v in trace[DIT_CKPT_EVERY:])
          and resumed.opt_count == DIT_STEPS + 1, f"DiT D1 resume from {DIT_CKPT_EVERY}: {trace}, {resumed.opt_count}")
    del resumed
    out = {"steps": DIT_STEPS, "batch": B_TRAIN, "losses": losses, "launches": counts, "plan": plan,
           "checkpoints": ckpts, "seconds_per_step": sps, "checkpoint_write_seconds": save_s, "peak_memory": peak,
           "resumed_losses": trace[DIT_CKPT_EVERY:]}

    for name, flags, steps in (("ddim50_b8", ["--sampler", "ddim", "--num-steps", "50"], 50),
                               ("dpm20_b8", ["--sampler", "dpm", "--num-steps", "20"], 20)):
        ops.reset_launch_counts()
        res = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path",
                           str(OUT / "gifs" / f"dit_{name}"), "--batch-size", str(B_TRAIN), "--seed", "0",
                           "--device", "cuda", *flags])
        check(res["graph"] == {"captures": 1, "replays": steps}, f"DiT {name}: graphs {res['graph']}")
        check_dit_launches(ops, plan, f"DiT {name} (a warm-up and a capture)", times=2, ways=("fwd",))
        videos = res["videos"]
        check(tuple(videos.shape) == (B_TRAIN, 1, DIT_D1_FRAMES, d["image_size"], d["image_size"])
              and bool(torch.isfinite(videos).all()), f"DiT {name}: samples {tuple(videos.shape)}")
        for p in res["paths"]:
            img = Image.open(p)
            check(img.n_frames == DIT_D1_FRAMES and img.size == (d["image_size"],) * 2, f"{p.name}: {img.n_frames}")
        out[name] = {"seconds": res["seconds"], "seconds_per_step": res["seconds"] / steps, "gifs": len(res["paths"])}
        if name == "ddim50_b8":
            cli_videos = videos

    # The same DDIM-50 from the same seed: graphed (its capture, then warm) and eager, against the CLI's.
    _, model = build_models(raw, device="cuda")
    load_checkpoint(model, ckpt)
    model.eval()
    runs = {}
    for label, graph in (("graphed", True), ("graphed_warm", True), ("eager", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = model.ddim_sample(batch_size=B_TRAIN, num_steps=50, generator=torch.Generator("cuda").manual_seed(0),
                                        graph=graph)
        torch.cuda.synchronize()
        out["ddim50_b8"][f"{label}_s_per_step"] = (time.perf_counter() - t0) / 50
    equal = {k: bool(torch.equal(v.cpu(), cli_videos)) for k, v in runs.items()}
    out["ddim50_b8"]["bit_equal_to_cli"] = equal
    check(all(equal.values()), f"DiT DDIM-50 b8: graphed, warm and eager against the CLI's samples: {equal}")
    del runs

    httpd = serve.create_server(model, host="127.0.0.1", port=0, batch_window_s=0.05)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen("http://%s:%d/health" % httpd.server_address[:2], timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["model"]["has_cond"] is False, f"DiT /health: {health}")
        service = httpd.service
        results = [None, None]

        def client(i):
            results[i] = service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": i})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(all(r is not None for r in results), "DiT server: a request did not return")
        errs = []
        for i, r in enumerate(results):
            solo = model.ddim_sample(batch_size=1, num_steps=SERVE_STEPS,
                                     generator=torch.Generator("cuda").manual_seed(i)).float().cpu().numpy()
            errs.append(float(np.abs(r[0] - solo).max()))
        groups = sorted({r[2]["coalesced"] for r in results}, reverse=True)
        check(max(errs) <= SERVE_TOL, f"DiT server: rows part from their solo runs by {max(errs)} (gate {SERVE_TOL})")
        out["serve"] = {"health": health, "groups": groups, "seconds": [r[1] for r in results],
                        "max_abs_vs_solo": errs, "tol": SERVE_TOL}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    out["serve"]["throughput"] = bench_serve.compare(model, [2], SERVE_STEPS, 0.05)
    return out


def dit_cond_phase(torch, ops, ta, train, sample) -> dict:
    """D1 conditioned on captions (``unet.use_bert_text_cond``, ``trainer.null_cond_prob`` 0.2 as
    configs/config_bouncing_digits_cond.yaml:52 sets it): ``DIT_COND_STEPS`` steps of the train CLI at batch 8 on
    16-frame captioned clips of the port's generator (8 per class), exact launches on the planner's routes; then the
    sampling CLI with ``--text "two digits" --cond-scale 3``, DDIM-10 at batch 4: each kernel launch runs 2b rows."""
    import shutil

    import yaml

    from video_diffusion_nnx_tpu_torch.data import bouncing_digits

    raw = dit_raw("D1")
    raw["unet"]["use_bert_text_cond"] = True
    raw["trainer"].update(use_path_as_cond=True, null_cond_prob=0.2)
    root = SCRATCH / "dit"
    gifs = root / "cond_gifs"
    if gifs.is_dir():
        shutil.rmtree(gifs)
    bouncing_digits.main(["--captioned-gifs", str(gifs), "--frames", str(DIT_D1_FRAMES),
                          "--captioned-clips-per-class", str(COND_CLIPS_PER_CLASS)])
    cfg = _train_config(yaml, raw, root, gifs, "cond", steps=DIT_COND_STEPS, ckpt_every=DIT_COND_STEPS)
    for old in (root / "cond" / "checkpoints").glob("step_*.pt"):
        old.unlink()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr = train.main(["--config", str(cfg), "--device", "cuda"])
    counts = check_dit_launches(ops, dit_plan(torch, ta, raw, B_TRAIN), "DiT D1 cond train", times=DIT_COND_STEPS)
    losses = tr.loss_trace.tolist()
    check(tr.use_path_as_cond and tr.model.denoise_fn.has_cond and all(math.isfinite(v) for v in losses),
          f"DiT cond: conditioned {tr.model.denoise_fn.has_cond}, losses {losses}")
    out = {"steps": DIT_COND_STEPS, "losses": losses, "launches": counts, "seconds_per_step": _seconds_per_step(tr, 3)[0],
           "peak_memory": torch.cuda.max_memory_allocated()}
    ckpt = tr.checkpoint_path(DIT_COND_STEPS)
    del tr

    batch, steps, rows, launch = 4, 10, [], ta._launch

    def spy(x, *args, **kwargs):
        rows.append(x.shape[0])
        return launch(x, *args, **kwargs)

    ops.reset_launch_counts()
    ta._launch = spy
    try:
        res = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path",
                           str(OUT / "gifs" / "dit_cond_ddim10_b4"), "--batch-size", str(batch), "--seed", "0",
                           "--device", "cuda", "--sampler", "ddim", "--num-steps", str(steps),
                           "--text", "two digits", "--cond-scale", "3"])
    finally:
        ta._launch = launch
    check(res["graph"] == {"captures": 1, "replays": steps}, f"DiT cond sample: graphs {res['graph']}")
    check_dit_launches(ops, dit_plan(torch, ta, raw, 2 * batch), "DiT cond sample", times=2, ways=("fwd",))
    check(rows and set(rows) == {2 * batch}, f"DiT cond sample: launches ran {sorted(set(rows))} rows, not 2b")
    check(tuple(res["videos"].shape) == (batch, 1, DIT_D1_FRAMES, 64, 64) and bool(torch.isfinite(res["videos"]).all()),
          f"DiT cond sample: {tuple(res['videos'].shape)}")
    out["sample"] = {"seconds": res["seconds"], "seconds_per_step": res["seconds"] / steps, "rows_per_launch": rows[0],
                     "gifs": len(res["paths"])}
    out.update(config=str(cfg), checkpoint=str(ckpt))
    return out


# Distillation (ROADMAP A13). Progressive: the train phase's last weights (the model, not the EMA, which starts at
# step 1000) as the teacher, two rounds 8 -> 4 of DISTILL_STEPS steps at batch 8 through the distill CLI, EMA 0.99.
# Guidance: the cond phase's step-20 weights as the teacher, GUIDANCE_STEPS steps through the distill_guidance CLI
# with w ~ U[1, 8], then one stage-2 round (4 steps, w ~ U[1, 8]) through the distill CLI. A step of either runs
# three denoiser forwards (two of the teacher, one of the student) and one backward.
DISTILL_N, DISTILL_STEPS, DISTILL_EMA = 8, 5, 0.99
GUIDANCE_STEPS, STAGE2_N, STAGE2_STEPS, DIT_GUIDANCE_STEPS = 5, 4, 3, 3
DISTILL_PER_STEP = {**{k: 3 * n for k, n in PER_FORWARD.items()},
                    **{k: n for k, n in PER_STEP.items() if k not in PER_FORWARD}}


def _distill_launches(ops, steps: int, where: str) -> dict:
    """Since the last reset: exactly ``steps`` distillation steps of the flagship's kernels, all staged."""
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    want = {k: n * steps for k, n in DISTILL_PER_STEP.items()}
    check(counts == want, f"{where}: launches {counts}, expected {want} ({steps} steps of {DISTILL_PER_STEP})")
    check(all(staged.get(k, 0) == n for k, n in counts.items()), f"{where}: staged {staged} of {counts}")
    return counts


def _flagship_batch(torch, path: Path, rows: int = B_TRAIN):
    """The first ``rows`` clips of a (F, B, H, W) uint8 .npy as a (rows, 1, F, H, W) batch in [0, 1] on the card."""
    import numpy as np

    arr = np.load(path)[:, :rows].astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(1, 0, 2, 3)[:, None])).cuda()


def _loaded(torch, config: dict, ckpt, ema: bool = False):
    from video_diffusion_nnx_tpu_torch.config import build_models
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint

    _, model = build_models(config, device="cuda")
    payload = read_checkpoint(ckpt)
    model.load_state_dict(payload["ema_params"] if ema else payload["model"])
    return model.eval()


def _gap(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def distill_phase(torch, ops, sample) -> dict:
    """Progressive distillation of the flagship (ROADMAP A13): the train phase's weights as the teacher, two rounds
    (N = 8 -> 4) of ``DISTILL_STEPS`` steps at batch 8 with EMA 0.99 through the distill CLI: exact launches (three
    forwards and a backward a step), all staged; each step's loss within ``LOSS_TOL`` of the same steps through the
    plain modules (same generator); the schedule buffers bit-unchanged and the students parted from the teacher;
    the EMA against its formula over two library steps; DDIM-4 on the stride grid from the last round's file
    through the sampling CLI, graphed, bit-equal to the eager sampler; seconds per step and peak memory."""
    from video_diffusion_nnx_tpu_torch import distill
    from video_diffusion_nnx_tpu_torch.config import load_config
    from video_diffusion_nnx_tpu_torch.convert import read_checkpoint
    from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
    from video_diffusion_nnx_tpu_torch.training.distill import DistillStep

    root = SCRATCH / "train"
    teacher_ckpt = root / "kernels" / "checkpoints" / f"step_{TRAIN_STEPS}.pt"
    check(teacher_ckpt.is_file(), f"distill: no teacher at {teacher_ckpt} (run the train phase first)")
    out, losses = {"teacher": str(teacher_ckpt), "rounds": f"{DISTILL_N} -> {DISTILL_N // 2}",
                   "steps_per_round": DISTILL_STEPS, "batch": B_TRAIN, "ema_decay": DISTILL_EMA}, {}
    for name in ("kernels", "plain"):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = distill.main(["--config", str(root / f"{name}.yaml"), "--checkpoint-path", str(teacher_ckpt),
                            "--no-ema", "--initial-steps", str(DISTILL_N), "--rounds", "2", "--steps-per-round",
                            str(DISTILL_STEPS), "--ema-decay", str(DISTILL_EMA), "--batch-size", str(B_TRAIN),
                            "--output-path", str(SCRATCH / "distill" / name), "--device", "cuda"])
        seconds = time.perf_counter() - t0
        losses[name] = [v for r in res["rounds"] for v in r["losses"]]
        check(res["final_steps"] == DISTILL_N // 2 and sorted(res["paths"]) == [DISTILL_N // 2, DISTILL_N]
              and all(math.isfinite(v) for v in losses[name]), f"distill {name}: {res}")
        row = {"seconds": seconds, "peak_memory": torch.cuda.max_memory_allocated(), "losses": losses[name],
               "seconds_per_step": [r["seconds_per_step"] for r in res["rounds"]]}
        if name == "kernels":
            row["launches"] = _distill_launches(ops, 2 * DISTILL_STEPS, "distill")
            paths = res["paths"]
        out[name] = row
    out["loss_gap_vs_plain"] = gap = _gap(losses["kernels"], losses["plain"])
    check(gap <= LOSS_TOL, f"distill: losses of the kernel route and the plain modules part by {gap} (relative, "
                           f"over {LOSS_TOL}): {losses['kernels']} against {losses['plain']}")

    teacher = read_checkpoint(teacher_ckpt)["model"]
    for n, path in paths.items():
        payload = read_checkpoint(path)
        check(payload["step"] == n and all(torch.equal(payload["model"][k], teacher[k]) for k in BUFFER_NAMES),
              f"distill: the {n}-step student's schedule buffers moved")
        moved = max((payload["model"][k].float() - v.float()).abs().max().item()
                    for k, v in teacher.items() if k not in BUFFER_NAMES)
        check(moved > 0 and all(torch.equal(payload["model"][k], v) for k, v in payload["ema_params"].items()),
              f"distill: the {n}-step student's file (largest change {moved})")
        out[f"student{n}_largest_change"] = moved

    # The EMA's formula, e <- d e + (1 - d) p after every step from the first, over two library steps.
    config = load_config(root / "kernels.yaml")
    step = DistillStep(_loaded(torch, config, teacher_ckpt), DISTILL_N // 2, ema_decay=DISTILL_EMA,
                       generator=torch.Generator(device="cuda").manual_seed(5))
    batch = _flagship_batch(torch, root / "bouncing_squares.npy")
    want = [p.detach().double() for p in step.params]
    for _ in range(2):
        step(batch)
        want = [e * DISTILL_EMA + p.detach().double() * (1 - DISTILL_EMA) for e, p in zip(want, step.params)]
    ema_err = max(((e.double() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                  for e, w in zip(step.ema, want))
    out["ema_formula_rel_err"] = ema_err
    check(ema_err <= 1e-6, f"distill: the EMA parts from d e + (1 - d) p by {ema_err} (relative)")
    del step

    # DDIM-4 on the stride grid from the last round's file: the sampling CLI (graphed) against the eager sampler.
    n = DISTILL_N // 2
    ops.reset_launch_counts()
    res = sample.main(["--config", str(root / "kernels.yaml"), "--checkpoint-path", str(paths[n]), "--output-path",
                       str(OUT / "gifs" / f"distilled{n}"), "--batch-size", "2", "--seed", "0", "--device", "cuda",
                       "--sampler", "ddim", "--num-steps", str(n), "--grid", "stride"])
    counts = nonzero(ops.launch_counts())
    check_staged(counts, ops.staged_launch_counts(), f"distilled DDIM-{n}")
    check_graphed(counts, res["graph"], n, f"distilled DDIM-{n}")
    student = _loaded(torch, config, paths[n])
    eager = student.ddim_sample(batch_size=2, num_steps=n, grid="stride",
                                generator=torch.Generator(device="cuda").manual_seed(0), graph=False)
    check(torch.equal(res["videos"], eager.cpu()) and bool(torch.isfinite(eager).all()),
          f"distilled DDIM-{n}: graphed and eager part by {_max_abs(res['videos'], eager.cpu())}")
    out[f"ddim{n}_stride"] = {"seconds": res["seconds"], "bit_equal_to_eager": True,
                               "range": [float(eager.min()), float(eager.max())]}
    return out


def guidance_distill_phase(torch, ops, ta, sample, cond) -> dict:
    """Guidance distillation of the conditioned flagship (the cond phase's step-20 weights): the grafted student
    (output layer zero) at w = 1, 3 and 8 bit-equal to the teacher's cond_scale-1 forward; ``GUIDANCE_STEPS`` steps
    at batch 8 with w ~ U[1, 8] through the distill_guidance CLI, exact launches, each loss within ``LOSS_TOL`` of
    the plain modules'; one stage-2 round through the distill CLI on its ``config_guidance.yaml``; DDIM-10 at
    cond_scale 3 through the sampling CLI on that config, one forward of b rows a step (rows checked at every
    launch); warm graphed seconds per step of the student at cond_scale 3 against the teacher's guided step; the
    server with 2 batch-1 clients at cond_scale 3, each coalesced row within ``SERVE_TOL`` of its solo run."""
    import copy
    import threading

    import numpy as np

    from video_diffusion_nnx_tpu_torch import distill, distill_guidance, serve
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.training.guidance import transfer_teacher_params

    cfg_k, ckpt = cond["kernels"]["config"], cond["kernels"]["checkpoint"]
    config = load_config(cfg_k)
    teacher = _loaded(torch, config, ckpt)
    student_config = copy.deepcopy(config)
    student_config["unet"]["guidance_embed"] = True
    _, graft = build_models(student_config, device="cuda")
    transfer_teacher_params(graft, teacher)
    d = config["diffusion"]
    frames, size = d["num_frames"], d["image_size"]
    x = rand(torch, (B_TRAIN, 1, frames, size, size), 31, 1.0, torch.float32)
    t = torch.linspace(10, 990, B_TRAIN, device="cuda").long()
    emb = teacher.embed_cond(COND_PROMPTS * 2)
    with torch.no_grad():
        want = teacher.denoise_fn.forward_with_cond_scale(x, t, cond=emb, cond_scale=1.0)
        graft_equal = {w: bool(torch.equal(graft.denoise_fn.forward_with_cond_scale(x, t, cond=emb, cond_scale=w),
                                           want)) for w in (1.0, 3.0, 8.0)}
    check(all(graft_equal.values()), f"guidance distill: the zero graft parts from the teacher at {graft_equal}")
    del graft
    out = {"teacher": ckpt, "zero_graft_bit_equal": graft_equal, "steps": GUIDANCE_STEPS, "batch": B_TRAIN,
           "w_range": [1.0, 8.0]}

    losses = {}
    for name, cfg in (("kernels", cfg_k), ("plain", str(SCRATCH / "cond" / "plain.yaml"))):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = distill_guidance.main(["--config", cfg, "--checkpoint-path", ckpt, "--no-ema", "--num-steps",
                                     str(GUIDANCE_STEPS), "--batch-size", str(B_TRAIN), "--w-min", "1", "--w-max",
                                     "8", "--output-path", str(SCRATCH / "guidance" / name), "--device", "cuda"])
        losses[name] = res["losses"]
        check(len(losses[name]) == GUIDANCE_STEPS and all(math.isfinite(v) for v in losses[name]),
              f"guidance distill {name}: losses {losses[name]}")
        row = {"seconds": time.perf_counter() - t0, "peak_memory": torch.cuda.max_memory_allocated(),
               "losses": losses[name], "seconds_per_step": res["seconds_per_step"]}
        if name == "kernels":
            row["launches"] = _distill_launches(ops, GUIDANCE_STEPS, "guidance distill")
            g_cfg, g_path = str(res["config"]), str(res["path"])
        out[name] = row
    out["loss_gap_vs_plain"] = gap = _gap(losses["kernels"], losses["plain"])
    check(gap <= LOSS_TOL, f"guidance distill: losses of the kernel route and the plain modules part by {gap} "
                           f"(relative, over {LOSS_TOL}): {losses['kernels']} against {losses['plain']}")

    # Stage 2: one round of the w-conditioned student through the distill CLI.
    ops.reset_launch_counts()
    res = distill.main(["--config", g_cfg, "--checkpoint-path", g_path, "--initial-steps", str(STAGE2_N), "--rounds",
                        "1", "--steps-per-round", str(STAGE2_STEPS), "--batch-size", str(B_TRAIN), "--output-path",
                        str(SCRATCH / "guidance" / "stage2"), "--device", "cuda"])
    check(res["conditioned"] and res["w_range"] == (1.0, 8.0) and sorted(res["paths"]) == [STAGE2_N],
          f"stage 2: {res}")
    out["stage2"] = {"losses": res["rounds"][0]["losses"], "seconds_per_step": res["rounds"][0]["seconds_per_step"],
                     "launches": _distill_launches(ops, STAGE2_STEPS, "stage 2")}

    # DDIM-10 at cond_scale 3 from the guidance-distilled file through the sampling CLI: one forward of b rows.
    steps, batch, rows, launch = 10, 4, [], ta._launch

    def spy(xx, *args, **kwargs):
        rows.append(xx.shape[0])
        return launch(xx, *args, **kwargs)

    ops.reset_launch_counts()
    ta._launch = spy
    try:
        res = sample.main(["--config", g_cfg, "--checkpoint-path", g_path, "--output-path",
                           str(OUT / "gifs" / "guidance_ddim10_b4"), "--batch-size", str(batch), "--seed", "0",
                           "--device", "cuda", "--sampler", "ddim", "--num-steps", str(steps), "--text", "two digits",
                           "--cond-scale", "3"])
    finally:
        ta._launch = launch
    counts = nonzero(ops.launch_counts())
    check_staged(counts, ops.staged_launch_counts(), "guidance-distilled DDIM-10")
    check_graphed(counts, res["graph"], steps, "guidance-distilled DDIM-10")
    check(set(rows) == {batch} and tuple(res["videos"].shape) == (batch, 1, frames, size, size)
          and bool(torch.isfinite(res["videos"]).all()), f"guidance-distilled DDIM-10: rows {sorted(set(rows))}")

    # Warm graphed seconds per step at cond_scale 3: the student's one forward of b rows against the teacher's 2b.
    student = _loaded(torch, student_config, g_path)
    prompts = COND_PROMPTS[:batch]

    def warm(model):
        model.ddim_sample(num_steps=steps, generator=torch.Generator(device="cuda").manual_seed(0), cond=prompts,
                          cond_scale=3.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = model.ddim_sample(num_steps=steps, generator=torch.Generator(device="cuda").manual_seed(0), cond=prompts,
                              cond_scale=3.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps, v

    s_sps, s_videos = warm(student)
    t_sps, _ = warm(teacher)
    out["ddim10_b4_cs3"] = {"rows_per_launch": batch, "student_graphed_warm_s_per_step": s_sps,
                            "teacher_cfg_graphed_warm_s_per_step": t_sps, "student_over_teacher": s_sps / t_sps,
                            "cli_seconds": res["seconds"]}
    del teacher

    # The server with two batch-1 clients at cond_scale 3, coalesced, each row against its solo run.
    httpd = serve.create_server(student, host="127.0.0.1", port=0, batch_window_s=0.5)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        service, clients = httpd.service, ["one digit", "three digits"]
        results = [None] * len(clients)

        def client(i):
            results[i] = service.sample_rows({"sampler": "ddim", "num_steps": SERVE_STEPS, "seed": 20 + i,
                                              "text": [clients[i]], "cond_scale": 3.0})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(clients))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(all(r is not None for r in results), "guidance-distilled server: a request did not return")
        errs = []
        for i, r in enumerate(results):
            gen = torch.Generator(device="cuda").manual_seed(20 + i)
            solo = student.ddim_sample(num_steps=SERVE_STEPS, generator=gen, cond=[clients[i]], cond_scale=3.0)
            errs.append(float(np.abs(r[0] - solo.float().cpu().numpy()).max()))
        groups = [r[2]["coalesced"] for r in results]
        out["server"] = {"groups": groups, "max_abs_vs_solo": errs, "tol": SERVE_TOL,
                         "seconds": [r[1] for r in results]}
        check(min(groups) == 2 and max(errs) <= SERVE_TOL,
              f"guidance-distilled server: groups {groups}, rows from solo {errs} (gate {SERVE_TOL})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return out


def dit_guidance_phase(torch, ops, ta, sample, dit_cond) -> dict:
    """Guidance distillation of the conditioned D1 (the dit cond phase's weights): the zero graft bit-equal to the
    teacher at w = 1, 3 and 8; ``DIT_GUIDANCE_STEPS`` steps at batch 8 through the distill_guidance CLI, every
    attention on the planner's kernels in float32 (three forwards and a backward a step); then DDIM-10 at
    cond_scale 3 through the sampling CLI on its ``config_guidance.yaml``, 4 rows a launch."""
    import copy

    from video_diffusion_nnx_tpu_torch import distill_guidance
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.training.guidance import transfer_teacher_params

    cfg, ckpt = dit_cond["config"], dit_cond["checkpoint"]
    config = load_config(cfg)
    teacher = _loaded(torch, config, ckpt)
    student_config = copy.deepcopy(config)
    student_config["unet"]["guidance_embed"] = True
    _, graft = build_models(student_config, device="cuda")
    transfer_teacher_params(graft, teacher)
    x = rand(torch, (2, 1, DIT_D1_FRAMES, 64, 64), 41, 1.0, torch.float32)
    t = torch.tensor([100, 800], device="cuda")
    emb = teacher.embed_cond(COND_PROMPTS[:2])
    with torch.no_grad():
        want = teacher.denoise_fn.forward_with_cond_scale(x, t, cond=emb, cond_scale=1.0)
        graft_equal = {w: bool(torch.equal(graft.denoise_fn.forward_with_cond_scale(x, t, cond=emb, cond_scale=w),
                                           want)) for w in (1.0, 3.0, 8.0)}
    check(all(graft_equal.values()), f"DiT guidance: the zero graft parts from the teacher at {graft_equal}")
    del graft, teacher

    raw = dit_raw("D1")
    raw["unet"]["use_bert_text_cond"] = True
    plan = dit_plan(torch, ta, raw, B_TRAIN)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = distill_guidance.main(["--config", cfg, "--checkpoint-path", ckpt, "--no-ema", "--num-steps",
                                 str(DIT_GUIDANCE_STEPS), "--batch-size", str(B_TRAIN), "--output-path",
                                 str(SCRATCH / "dit" / "guidance"), "--device", "cuda"])
    counts, staged = nonzero(ops.launch_counts()), ops.staged_launch_counts()
    tf32x3 = ops.tf32x3_launch_counts()
    fwd, fwd_staged, _, _ = dit_launches(plan, 3 * DIT_GUIDANCE_STEPS, ("fwd",))
    bwd, bwd_staged, bwd_tf32x3, _ = dit_launches(plan, DIT_GUIDANCE_STEPS, ("bwd",))
    check(counts == {**fwd, **bwd}, f"DiT guidance: launches {counts}, expected {fwd} and {bwd}")
    check({k: staged.get(k, 0) for k in counts} == {**fwd_staged, **bwd_staged},
          f"DiT guidance: staged launches {staged}, the planner's {fwd_staged} and {bwd_staged}")
    check({k: tf32x3.get(k, 0) for k in bwd} == bwd_tf32x3,
          f"DiT guidance: 3xtf32 launches {tf32x3}, the planner's {bwd_tf32x3}")
    check(len(res["losses"]) == DIT_GUIDANCE_STEPS and all(math.isfinite(v) for v in res["losses"]),
          f"DiT guidance: losses {res['losses']}")
    out = {"zero_graft_bit_equal": graft_equal, "steps": DIT_GUIDANCE_STEPS, "batch": B_TRAIN, "losses": res["losses"],
           "launches": counts, "seconds_per_step": res["seconds_per_step"],
           "peak_memory": torch.cuda.max_memory_allocated()}

    batch, steps, rows, launch = 4, 10, [], ta._launch

    def spy(xx, *args, **kwargs):
        rows.append(xx.shape[0])
        return launch(xx, *args, **kwargs)

    ops.reset_launch_counts()
    ta._launch = spy
    try:
        s = sample.main(["--config", str(res["config"]), "--checkpoint-path", str(res["path"]), "--output-path",
                         str(OUT / "gifs" / "dit_guidance_ddim10_b4"), "--batch-size", str(batch), "--seed", "0",
                         "--device", "cuda", "--sampler", "ddim", "--num-steps", str(steps), "--text", "two digits",
                         "--cond-scale", "3"])
    finally:
        ta._launch = launch
    check(s["graph"] == {"captures": 1, "replays": steps}, f"DiT guidance sample: graphs {s['graph']}")
    check_dit_launches(ops, dit_plan(torch, ta, raw, batch), "DiT guidance sample", times=2, ways=("fwd",))
    check(rows and set(rows) == {batch}, f"DiT guidance sample: launches ran {sorted(set(rows))} rows, not b")
    check(tuple(s["videos"].shape) == (batch, 1, DIT_D1_FRAMES, 64, 64) and bool(torch.isfinite(s["videos"]).all()),
          f"DiT guidance sample: {tuple(s['videos'].shape)}")
    out["sample"] = {"seconds": s["seconds"], "seconds_per_step": s["seconds"] / steps, "rows_per_launch": batch}
    return out


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
    from video_diffusion_nnx_tpu_torch import extend, ops, sample, train
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
        # A phase whose work ran in another phase's spawn, or whose spawn ran another's, says so: its seconds are its own.
        share = res.get("spawn_share_seconds", 0.0) if isinstance(res, dict) else 0.0
        phase(title, seconds=time.perf_counter() - t0 + share, **show(res))
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
    timed("dpm", sample_phase, torch, ops, load_config, build_models, save_checkpoint, sample, runs_spec=DPM_RUN)
    timed("graph", graph_phase, torch, ops, load_config, build_models)
    timed("extend", extend_phase, torch, ops, load_config, build_models, save_checkpoint)
    served = timed("serve", serve_phase, torch, ops, load_config, build_models)
    bwd = timed("backward", backward_phase, torch, ta, sla,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": BWD_TOL, **per_step(r, "per_step"),
                                "forward_per_step": per_step(r, "fwd_per_step")["fwd_per_step"],
                                "float32_per_step": per_step(r, "f32_per_step")["f32_per_step"],
                                "float32_3xtf32_per_step": per_step(r, "tf32x3_per_step")["tf32x3_per_step"]})
    timed("grads", grads_phase, torch, ops, ta, sla, load_config, build_models,
          show=brief)
    trained = timed("train", train_phase, torch, ops, train, sample)
    timed("digits", digits_phase, torch, ops)
    cond = timed("cond", cond_phase, torch, ops, train,
                 show=lambda r: {k: v for k, v in r.items() if k not in ("plain", "null_control")})
    if cond is not None:
        timed("cfg", cfg_phase, torch, ops, sample, cond)
    blk = timed("blockwise", blockwise_phase, torch, ta,
                show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                **per_step(r, "per_step"), "float32_per_step": per_step(r, "f32_per_step")["f32_per_step"]})
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
    # The fixed recipes' float32 temporal attentions a step: the biased ones over the frames and the unbiased
    # bottleneck, forward and backward.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fixed_f32 = f32_routes(ta, [*((n, (B_TRAIN, *sh[1:]), True) for n, sh in BIASED_DENSE_SHAPES if n),
                                (1, (B_TRAIN, *MID_SPATIAL[1:]), False)], sms)
    long_fixed_f32 = f32_routes(ta, [*((n, sh, True) for n, sh in LONG_TEMPORAL_SHAPES), (1, LONG_DENSE_SHAPE, False)],
                                sms)
    results["fixed_f32_routes"] = {"fixed": fixed_f32, "long_fixed": long_fixed_f32}
    fixed_trained = timed("fixed train", train_phase, torch, ops, train, sample, name="fixed_train", unet=FIXED,
                          per_step=FIXED_PER_STEP, ddim_steps=50, f32=fixed_f32)
    timed("long fixed unet", unet_phase, torch, load_config, build_models, config_path=LONG_CONFIG, batch=1,
          unet=FIXED)
    timed("long fixed grads", grads_phase, torch, ops, ta, sla, load_config, build_models, config_path=LONG_CONFIG,
          batch=1, long_clip=True, unet=FIXED, per_step=FIXED_LONG_PER_STEP, show=brief)
    long_fixed_trained = timed("long fixed train", long_train_phase, torch, ops, train, sample,
                               name="long_fixed_train", unet=FIXED, per_step=FIXED_LONG_PER_STEP,
                               variants=("kernels", "plain"), f32=long_fixed_f32)

    # The sequence-parallel recipe: its cross-attention kernels, then 4 ranks training on the one card.
    cross = timed("cross", cross_phase, torch, xa, ta,
                  show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL, "backward": BWD_TOL},
                                  "self_attention_equivalence": r["self_attention_equivalence"],
                                  **per_step(r, "per_step")})
    mesh_phases = {p for p in MESH_PHASES if only is None or p in only}
    seq = timed("seq train", seq_train_phase, torch, train, mesh_phases,
                show=lambda r: {k: v for k, v in r.items() if k not in ("resumed_losses", "mesh")})
    timed("seq sample", seq_sample_phase, torch, ops, sample)

    # The trainer's multi-device paths (A15): seq train's spawn of 4 gloo ranks on cuda:0 ran every multi-rank run
    # after its own; dp train holds the flagship's, tp train the dim-128 recipe's (data 2 x model 2), seq dp train the
    # seq recipe's (data 2 x seq 2) against seq train's run.
    def mesh_show(r):
        return {k: v for k, v in r.items() if k not in ("ranks", "cfgs", "one_rank", "plain_one_rank")}

    dp = timed("dp train", dp_train_phase, torch, ops, train, seq, show=mesh_show) if seq is not None else None
    tp = timed("tp train", tp_train_phase, torch, train, seq["mesh"], show=mesh_show) if seq is not None else None
    seq_dp = timed("seq dp train", seq_dp_train_phase, torch, train, seq["mesh"], seq, show=mesh_show) \
        if seq is not None else None
    # Data ranks outside the trainer: the sample and extend CLIs and the server over the spawn's 4 ranks.
    dp_sampled = timed("dp sample", dp_sample_phase, torch, sample, extend, seq) if seq is not None else None
    dp_served = timed("dp serve", dp_serve_phase, torch, seq, served) if seq is not None else None

    # The VideoDiT family: its attention kernels at D1's and D2's shapes, each recipe's forward and step against the
    # plain modules, D1 through the train and sample CLIs and the server, and the caption-conditioned D1.
    dit_kern = timed("dit kernels", dit_kernel_phase, torch, ta,
                     show=lambda r: {"checks": len(r["rows"]), "tolerance": {"forward": TOL["float32"],
                                     "backward": BWD_TOL["float32"]},
                                     **{recipe: {k: {m: v[m] for m in ("route", "ms", "plain_ms", "bound_ms",
                                                                       "bound_ms_3xtf32", "err") if m in v}
                                                 for k, v in a.items()} for recipe, a in r["per_step"].items()}})
    dit_d1 = timed("dit d1", dit_model_phase, torch, ops, ta, sla, build_models, "D1")
    dit_d2 = timed("dit d2", dit_model_phase, torch, ops, ta, sla, build_models, "D2")
    dit_train = timed("dit train", dit_train_phase, torch, ops, ta, train, sample, build_models,
                      show=lambda r: {k: v for k, v in r.items() if k != "plan"})
    dit_cond = timed("dit cond", dit_cond_phase, torch, ops, ta, train, sample)

    # Distillation (A13): progressive on the flagship, guidance on the conditioned flagship and on D1.
    distilled = timed("distill", distill_phase, torch, ops, sample,
                      show=lambda r: {k: v for k, v in r.items() if k not in ("kernels", "plain")})
    guided = timed("guidance distill", guidance_distill_phase, torch, ops, ta, sample, cond,
                   show=lambda r: {k: v for k, v in r.items() if k not in ("kernels", "plain")}) \
        if cond is not None else None
    dit_guided = timed("dit guidance", dit_guidance_phase, torch, ops, ta, sample, dit_cond) \
        if dit_cond is not None else None
    # Both distillation CLIs over the spawn's 4 ranks, against the distillation phases' first steps.
    dp_distilled = timed("dp distill", dp_distill_phase, torch, seq, distilled, guided) \
        if seq is not None and distilled is not None and guided is not None else None

    # The trainer's options (gradient accumulation, the flat optimizer, async checkpoints, sampling, the profiler).
    options = timed("train options", train_options_phase, torch, ops, train, show=lambda r: {
        "accumulation_step": r["accumulation_step"],
        **{k: {m: v for m, v in r[k].items() if m not in ("losses", "launches", "staged_launches", "step_seconds")}
           for k in r if isinstance(r[k], dict) and "seconds_per_step" in r[k]}})
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
        designs[name] = design(launches[name], *(path.get(k, {}).get(name, 0) for k in (
            "staged_launches", "tf32x3_launches", "staged_tf32x3_launches")))

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
    # Each kernel's DiT launches: D1's training run, the conditioned D1's, and one D2 step (forward and backward);
    # for the kernels of the DiT path also their float32 times at each recipe's shapes, per step.
    def dit_field(name):
        out = {"launches": {"d1_train": dit_train["launches"].get(name, 0),
                            "d1_cond_train": dit_cond["launches"].get(name, 0),
                            "d2_step": dit_d2["launches"].get(name, 0)},
               "launches_per_d1_step": dit_d1["launches"].get(name, 0)}
        for recipe, per in dit_kern["per_step"].items():
            if name in per:
                a = per[name]
                out[recipe] = {"shape": a["shape"], "route": a["route"], "dtype": "float32", "max_abs_err": a["err"],
                               "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                               "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"] else "operations"}
        return out

    # Where the float32 tensor-core backward (csrc/temporal_tf32x3.cu) ran on the driven paths: the fixed recipes'
    # bottleneck, D1's spatial and D2's attentions.
    tf32x3_paths = {"fixed_train": fixed_trained["tf32x3_launches"], "long_fixed_train": long_fixed_trained["tf32x3_launches"],
                    "d1_train": dit_launches(dit_train["plan"], DIT_STEPS)[2], "d2_step": dit_launches(dit_d2["plan"])[2]}

    def tf32x3_field(name):
        return {path: n[name] for path, n in tf32x3_paths.items() if n.get(name)}

    # Where the staged dense or streaming kernel ran in float32 in 3xTF32 (route "staged-3xtf32"): every float32
    # forward the staged tile or the streaming plan holds (the fixed recipes', D1's, D2's spatial), and the fixed
    # recipes' biased backwards at c = 32 (and the dense one at c = 64), as the measured rule gives them.
    staged3_paths = {"fixed_train": fixed_trained["staged_tf32x3_launches"],
                     "long_fixed_train": long_fixed_trained["staged_tf32x3_launches"],
                     "d1_train": dit_launches(dit_train["plan"], DIT_STEPS)[3], "d2_step": dit_launches(dit_d2["plan"])[3]}

    def staged3_field(name):
        return {path: n[name] for path, n in staged3_paths.items() if n.get(name)}

    for name in ("temporal_attention_bwd", "temporal_blockwise_bwd", "temporal_wide_bwd"):
        check(tf32x3_field(name), f"{name}: the float32 tensor-core backward never ran on a driven path")
    for name in ("temporal_attention_biased_fwd", "temporal_attention_biased_bwd", "temporal_blockwise_biased_fwd",
                 "temporal_blockwise_biased_bwd", "temporal_attention_fwd", "temporal_blockwise_fwd", "temporal_wide_fwd"):
        check(staged3_field(name), f"{name}: the staged float32 kernel in 3xTF32 never ran on a driven path")
    kernels_line = [{
        "name": name, "route": "cuda",
        "design": designs[name] + "".join(f"; float32: {d}" for d, field in (("staged-3xtf32", staged3_field),
                                                                           ("3xtf32", tf32x3_field)) if field(name)
                                          and d not in designs[name]),
        **({"staged_tf32x3_launches": staged3_field(name)} if staged3_field(name) else {}),
        **({"tf32x3_launches": tf32x3_field(name),
            "tf32x3_source": "video_diffusion_nnx_tpu_torch/csrc/temporal_tf32x3.cu"} if tf32x3_field(name) else {}),
        "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
        "launches": launches[name], "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"] else "operations",
        "library_ms": None, "dtype": dtypes.get(name, "bfloat16"),
        **({"launches_per_step": options["accumulation_step"]["launches"][name],
            "launches_per_step_accumulated": options["accumulation_step"]["launches_accumulated"][name]}
           if name in PER_STEP else {}),
        "dit": dit_field(name),
        "multi_rank": {"dp_train": dp["launches"].get(name, 0), "fsdp_train": dp["fsdp_launches"].get(name, 0),
                       "tp_train": tp["launches"].get(name, 0), "seq_dp_train": seq_dp["launches"].get(name, 0),
                       "dp_sample": dp_sampled["launches"].get(name, 0),
                       "dp_distill": dp_distilled["launches"].get(name, 0),
                       "dp_serve": dp_served["launches"].get(name, 0)},
        "distill": {"flagship_progressive": distilled["kernels"]["launches"].get(name, 0),
                    "flagship_guidance": guided["kernels"]["launches"].get(name, 0),
                    "flagship_stage2": guided["stage2"]["launches"].get(name, 0),
                    "d1_guidance": dit_guided["launches"].get(name, 0)},
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
