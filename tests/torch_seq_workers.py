"""Rank functions of tests/test_torch_seq_parallel.py, run in spawned processes.

This module imports the port alone, never JAX: a spawned rank imports it to
find its target. The test process prepares the inputs (JAX weights converted
to the port's layout), saves them, spawns the ranks over a ``file://``
store, and compares what each rank saves against the JAX package and the
port's one-rank results.
"""

from __future__ import annotations

from pathlib import Path

import torch

from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import Unet3D
from video_diffusion_nnx_tpu_torch.models.layers import GroupNorm
from video_diffusion_nnx_tpu_torch.parallel import (
    all_reduce_sum,
    destroy_sequence_group,
    gather_frames,
    init_sequence_group,
)
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer


def collective_inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs of the collectives case (the test rebuilds them for every rank)."""
    gen = torch.Generator().manual_seed(rank)
    return {"x": torch.randn(2, 3, 2, 5, generator=gen), "g": torch.randn(2, 3, 8, 5, generator=gen),
            "y": torch.randn(2, 3, 2, 5, generator=gen), "gy": torch.randn(2, 3, 2, 5, generator=gen)}


def _collectives(group) -> dict:
    a = collective_inputs(group.rank)
    x = a["x"].clone().requires_grad_()
    gathered = gather_frames(x, group, dim=2)
    gathered.backward(a["g"])
    y = a["y"].clone().requires_grad_()
    summed = all_reduce_sum(y, group)
    summed.backward(a["gy"])
    return {"gathered": gathered.detach(), "dx": x.grad, "summed": summed.detach(), "dy": y.grad,
            "gathered_bf16": gather_frames(a["x"].bfloat16(), group, dim=2)}


def _groupnorm(group, x, g, weight, bias, groups: int) -> dict:
    frames = group.frames(x.shape[1])
    norm = GroupNorm(x.shape[-1], groups, sequence_group=group)
    norm.load_state_dict({"weight": weight, "bias": bias})
    xl = x[:, frames].clone().requires_grad_()
    y = norm(xl)
    y.backward(g[:, frames])
    return {"y": y.detach(), "dx": xl.grad, "dweight": norm.weight.grad, "dbias": norm.bias.grad}


def _unet(group, state, kwargs, x, t, g) -> dict:
    unet = Unet3D(**kwargs)
    unet.load_state_dict(state)
    unet.sequence_parallel_mesh = group
    frames = group.frames(x.shape[2])
    xl = x[:, :, frames].clone().requires_grad_()
    out = unet(xl, t)
    out.backward(g[:, frames])
    return {"out": out.detach(), "dx": xl.grad,
            "grads": {k: p.grad.clone() for k, p in unet.named_parameters() if p.grad is not None}}


def _train(group, state, unet_kwargs, diffusion_kwargs, trainer_kwargs, steps) -> list:
    diffusion = GaussianDiffusion(Unet3D(**unet_kwargs), **diffusion_kwargs)
    diffusion.load_state_dict(state)
    trainer = Trainer(diffusion, sequence_group=group, **trainer_kwargs)
    out = []
    for x, t, noise in steps:
        loss, norm = trainer.train_step(x, t=t, noise=noise)
        trainer.step += 1
        out.append({"loss": loss.item(), "norm": norm.item(),
                    "state": {k: v.detach().clone() for k, v in diffusion.state_dict().items()},
                    "ema": {k: v.clone() for k, v in trainer.ema_state.items()}})
    return out


def rank_main(rank: int, world_size: int, init_method: str, spec_path: str, out_dir: str) -> None:
    """One rank: join the gloo group on the CPU, run every case of the spec, save the results."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    group = init_sequence_group(rank, world_size, "gloo", init_method, device_type="cpu")
    try:
        results = {"collectives": _collectives(group), "groupnorm": _groupnorm(group, **spec["groupnorm"]),
                   "unet": _unet(group, **spec["unet"]), "train": _train(group, **spec["train"]),
                   "stats": dict(group.stats)}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        destroy_sequence_group()


def card_rank_main(rank: int, world_size: int, init_method: str, out_dir: str) -> None:
    """One gloo rank on cuda:0 (every rank shares the card): the collectives on CUDA tensors, checked here."""
    group = init_sequence_group(rank, world_size, "gloo", init_method, device_type="cuda")
    try:
        device = group.device
        x = torch.full((2, 8, 2, 16), float(rank + 1), device=device, dtype=torch.bfloat16).requires_grad_()
        gathered = gather_frames(x, group, dim=2)
        want = torch.cat([torch.full((2, 8, 2, 16), float(r + 1)) for r in range(world_size)], dim=2)
        gathered.float().sum().backward()
        summed = all_reduce_sum(torch.full((3,), float(rank), device=device), group)
        ok = (gathered.is_cuda and torch.equal(gathered.float().cpu(), want)
              and torch.equal(x.grad.float().cpu(), torch.full((2, 8, 2, 16), float(world_size)))
              and torch.equal(summed.cpu(), torch.full((3,), float(sum(range(world_size))))))
        torch.save({"device": str(device), "ok": bool(ok), "stats": dict(group.stats)},
                   Path(out_dir) / f"card{rank}.pt")
    finally:
        destroy_sequence_group()
