"""Weights and checkpoints (counterpart of the JAX package's utils/checkpoint.py).

Two jobs:

* :func:`state_dict_from_nnx` turns the JAX package's state, flattened to
  ``{"denoise_fn/downs/0/0/block_1/proj/kernel": array, ...}`` (the paths of
  ``tests/golden/state_tree_v2_2.txt``), into this package's ``state_dict``
  for a given ``GaussianDiffusion``. Reading an Orbax checkpoint needs JAX,
  so that part stays with the caller; this module takes plain arrays.
* :func:`save_checkpoint` / :func:`load_checkpoint` write and read this
  package's own checkpoint file (``torch.save`` of ``{"model": state_dict,
  "ema_params": state_dict or None, "optimizer": optimizer state or None,
  "step": int or None}``); the trainer writes one file per step.

Layout rules, from the JAX layouts to PyTorch's:

* ``Linear`` (``nnx.Linear``, ``nnx.LinearGeneral``, 1x1 convs): the kernel,
  read as ``(in, out)`` (``(c, H, D)`` q/k/v, ``(H, D, c)`` out,
  ``(1, c, H*D)`` spatial-attention 1x1), becomes ``(out, in)``;
* conv kernels ``(1, kh, kw, cin, cout)`` become ``(cout, cin, kh, kw)``;
* the transposed-conv kernel, applied unflipped by ``lax.conv_transpose``,
  becomes ``(cin, cout, kh, kw)`` flipped in both spatial axes;
* norm ``scale`` becomes ``weight``; ``embedding`` stays as it is.

A JAX path with no counterpart, a parameter the state does not cover, or a
shape that does not fit raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from video_diffusion_nnx_tpu_torch.models.layers import Linear, PseudoConv3d, PseudoConvTranspose3d

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def torch_key(nnx_path: str) -> str:
    """The ``state_dict`` key of a JAX state path."""
    parts = nnx_path.split("/")
    if parts[-1] in _LEAF:
        parts[-1] = _LEAF[parts[-1]]
    return ".".join(parts)


def _convert(module: nn.Module, leaf: str, value: np.ndarray, want: torch.Size) -> np.ndarray:
    if leaf == "kernel" and isinstance(module, PseudoConvTranspose3d):
        return np.ascontiguousarray(value[0][::-1, ::-1].transpose(2, 3, 0, 1))
    if leaf == "kernel" and isinstance(module, PseudoConv3d):
        return value[0].transpose(3, 2, 0, 1)
    if leaf == "kernel" and isinstance(module, Linear):
        out_f, in_f = want
        return value.reshape(in_f, out_f).T if value.size == out_f * in_f else value
    # Biases, norm scales, embeddings and schedule buffers keep their values.
    return value.reshape(want) if value.size == int(np.prod(want)) else value


def state_dict_from_nnx(flat: Mapping[str, np.ndarray], model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert a flat JAX state into ``model``'s ``state_dict`` (every key, no other)."""
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = torch_key(path)
        if key not in expected:
            raise KeyError(f"JAX state path {path!r} has no counterpart ({key!r})")
        if key in out:
            raise KeyError(f"two JAX state paths map to {key!r}")
        owner, _, leaf = key.rpartition(".")
        module = model.get_submodule(owner)
        want = expected[key].shape
        arr = _convert(module, path.rsplit("/", 1)[-1], np.asarray(value), want)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: shape {np.shape(value)} does not convert to {tuple(want)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX state lacks {len(missing)} parameter(s), e.g. {missing[:5]}")
    return out


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the CPU (never a view of the original)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def checkpoint_payload(model: nn.Module, ema_state: Mapping | None = None, optimizer: Mapping | None = None,
                       step: int | None = None, gathered: Mapping | None = None) -> dict:
    """The contents of a checkpoint file, copied to host memory: later updates of the live tensors leave it as it
    is, so a background thread may write it. ``gathered`` holds whole tensors that stand in for some of
    ``model``'s (a sharded trainer's parameters, which the module holds only during a step)."""
    state = model.state_dict()
    if gathered:
        state = {k: gathered.get(k, v) for k, v in state.items()}
    return {
        "model": _to_host(state),
        "ema_params": None if ema_state is None else _to_host(ema_state),
        "optimizer": _to_host(optimizer),
        "step": step,
    }


def write_checkpoint(path: str | Path, payload: Mapping) -> Path:
    """Write a :func:`checkpoint_payload` to ``path``: beside its final name first, then renamed, so a reader
    never sees half of it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(dict(payload), tmp)
    tmp.replace(path)
    return path


def save_checkpoint(path: str | Path, model: nn.Module, ema_state: Mapping | None = None,
                    optimizer: Mapping | None = None, step: int | None = None) -> Path:
    """Write ``model``'s state (and optional EMA and optimizer states) as this package's checkpoint file."""
    return write_checkpoint(path, checkpoint_payload(model, ema_state, optimizer, step))


def read_checkpoint(path: str | Path) -> dict:
    """The whole payload of a checkpoint file, on the CPU."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint file at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(model: nn.Module, path: str | Path, load_ema_params: bool = False) -> nn.Module:
    """Load a checkpoint file into ``model``: its ``model`` state, or its EMA state."""
    payload = read_checkpoint(path)
    state = payload["ema_params"] if load_ema_params else payload["model"]
    if state is None:
        raise KeyError(f"{path} holds no EMA parameters")
    model.load_state_dict(state, strict=True)
    return model
