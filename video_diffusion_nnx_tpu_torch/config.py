"""YAML config loading, model and trainer construction (counterpart of the JAX package's config.py:29-221
and of ``build_from_config`` in its root train.py:17-71).

The YAML schema is the JAX package's: three sections (``unet:``,
``diffusion:``, ``trainer:``) merged over the defaults below, and an
unrecognized key is warned about, not silently dropped. The defaults are
this package's own copy.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch
import yaml

logger = logging.getLogger(__name__)

_TRAINER_DEFAULTS: dict[str, Any] = {
    "folder": "./results",
    "num_frames": 16,
    "train_batch_size": 4,
    "train_lr": 1e-4,
    "train_num_steps": 100000,
    "gradient_accumulate_every": 2,
    "step_start_ema": 2000,
    "update_ema_every": 10,
    "save_and_sample_every": 100000,
    "results_folder": "./results",
    "num_sample_rows": 4,
    "max_grad_norm": None,
    "use_path_as_cond": False,
    "sample_text": None,
    "cond_scale": 2.0,
    "checkpoint_every_steps": 10,
    "checkpoint_dir_path": "",
    "add_loss_plot": False,
    "tensorboard_dir": "",
    "max_to_keep": None,
    "lr_decay_start_step": 0,
    "lr_decay_steps": 0,
    "lr_decay_coeff": 1.0,
    "ema_decay": 0.9999,
    "profile_flush_step": 100,
    "num_model_shards": 1,
    "resume_training_step": 0,
    "enable_gradient_accumulation": False,
    "dataset_normalize": False,
    "param_sharding": "tensor",
    "save_optimizer_state": False,
    "log_every_steps": 1,
    "sequence_parallel_size": 1,
    "async_checkpointing": False,
    "compilation_cache_dir": "",
    "prefetch_depth": 2,
    "fsdp_min_size_to_shard": 2**14,
    "null_cond_prob": 0.0,
    "freeze_schedule_buffers": False,
    "flatten_optimizer": False,
}

_TRAINER_EXTRA_KEYS = {"dataset_path", "rng_seed"}

_UNET_DEFAULTS: dict[str, Any] = {
    "arch": "unet3d",
    "depth": 8,
    "patch_size": 4,
    "mlp_ratio": 4,
    "dim": 32,
    "rngs_seed": 0,
    "dim_mults": [1, 2, 4, 8],
    "cond_dim": None,
    "out_dim": None,
    "channels": 1,
    "attn_heads": 8,
    "attn_dim_head": 32,
    "use_bert_text_cond": False,
    "init_dim": None,
    "init_kernel_size": 7,
    "use_sparse_linear_attn": True,
    "block_type": "resnet",
    "resnet_groups": 8,
    "log_dims": False,
    "reference_compat": True,
    "compute_dtype": None,
    "use_fused_attention": False,
    "use_fused_spatial_attention": False,
    "remat_blocks": False,
    "guidance_embed": False,
}

_DIFFUSION_DEFAULTS: dict[str, Any] = {
    "image_size": 64,
    "num_frames": 16,
    "timesteps": 1000,
    "loss_type": "l1",
    "channels": 3,
    "text_use_bert_cls": False,
    "use_dynamic_thres": False,
    "dynamic_thres_percentile": 0.9,
    "prediction_type": "noise",
    "min_snr_gamma": None,
}


def _warn_unknown(section: str, given: dict[str, Any], known: set[str]) -> None:
    unknown = sorted(set(given) - known)
    if unknown:
        logger.warning(
            "config section '%s' has unrecognized key(s) %s — they are "
            "IGNORED. Known keys: %s",
            section, unknown, sorted(known),
        )


def load_config(path: str | Path) -> dict[str, Any]:
    """Load a config file and merge each section over its defaults."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    _warn_unknown("unet", raw.get("unet", {}), set(_UNET_DEFAULTS))
    _warn_unknown("diffusion", raw.get("diffusion", {}), set(_DIFFUSION_DEFAULTS))
    _warn_unknown(
        "trainer", raw.get("trainer", {}), set(_TRAINER_DEFAULTS) | _TRAINER_EXTRA_KEYS
    )
    _warn_unknown(
        "<top level>",
        {k: v for k, v in raw.items() if not isinstance(v, dict)},
        {"rng_seed"},
    )
    cfg = dict(raw)
    cfg["unet"] = {**_UNET_DEFAULTS, **raw.get("unet", {})}
    cfg["diffusion"] = {**_DIFFUSION_DEFAULTS, **raw.get("diffusion", {})}
    cfg["trainer"] = {**_TRAINER_DEFAULTS, **raw.get("trainer", {})}
    return cfg


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return device


def build_models(config: dict[str, Any], device: str | torch.device = "cuda"):
    """Instantiate ``(unet, diffusion)`` on ``device`` from a merged config.

    Weights are random, drawn from a ``torch.Generator`` seeded with
    ``unet.rngs_seed``; load a checkpoint over them with
    :func:`video_diffusion_nnx_tpu_torch.convert.load_checkpoint`.
    """
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    device = resolve_device(device)
    u = {**_UNET_DEFAULTS, **config.get("unet", {})}
    d = {**_DIFFUSION_DEFAULTS, **config.get("diffusion", {})}
    _warn_unknown("unet", u, set(_UNET_DEFAULTS))
    _warn_unknown("diffusion", d, set(_DIFFUSION_DEFAULTS))

    arch = u.get("arch", "unet3d")
    if arch == "dit":
        raise NotImplementedError("unet.arch 'dit' (VideoDiT) is not ported yet: ROADMAP A11")
    if arch != "unet3d":
        raise ValueError(f"unet.arch must be 'unet3d' or 'dit'; got {arch!r}")

    unet_kwargs = {
        k: u[k]
        for k in _UNET_DEFAULTS
        if k not in ("rngs_seed", "arch", "depth", "patch_size", "mlp_ratio")
    }
    unet_kwargs["dim_mults"] = tuple(u["dim_mults"])
    unet = Unet3D(**unet_kwargs)
    unet.reset_parameters(torch.Generator().manual_seed(int(u["rngs_seed"])))
    diffusion = GaussianDiffusion(unet, **{k: d[k] for k in _DIFFUSION_DEFAULTS})
    diffusion.to(device)
    return unet, diffusion


def build_trainer(config: dict[str, Any], device: str | torch.device = "cuda", resume_step: int = 0,
                  rng_seed: int | None = None, sequence_group=None):
    """``(unet, diffusion, trainer)`` from a merged config; seed: ``rng_seed`` > config ``rng_seed`` > 0.

    With a ``sequence_group`` (one rank of a sequence-parallel run) the models are built on the
    rank's device and the trainer runs over the group.
    """
    from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

    seed = rng_seed if rng_seed is not None else config.get("rng_seed", 0)
    if sequence_group is not None:
        device = sequence_group.device
    unet, diffusion = build_models(config, device=device)
    t = {**_TRAINER_DEFAULTS, **config.get("trainer", {})}
    if "dataset_path" not in t:
        raise KeyError("config section 'trainer' needs a dataset_path")
    kwargs = {k: t[k] for k in _TRAINER_DEFAULTS if k not in ("resume_training_step", "compilation_cache_dir")}
    trainer = Trainer(diffusion, dataset_path=t["dataset_path"], rng_seed=seed,
                      resume_training_step=resume_step, sequence_group=sequence_group, **kwargs)
    return unet, diffusion, trainer
