"""C5, block by block: the port's bf16 Unet3D blocks against the JAX package's, fed the same bf16 input.

The fixture recipe (seed 7, dim 8, (1, 2), 16x16, 4 frames) in the compat bf16 policy, by the modules and by the
fused ops (the JAX fused route runs its Pallas kernels in interpret mode). The unit is one bf16 unit in the last
place of the JAX block output's largest magnitude (the standard of chip_smoke.py's wide phase). The whole model is
held to JAX in tests/test_torch_unet.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta


def _block_calls(unet) -> list[tuple[str, str, tuple, torch.dtype]]:
    """Every block of one bf16 forward in order, as (how it is called, its name, its input's shape and type)."""
    names = {id(m): n for n, m in unet.named_modules()}
    calls, hooks = [], []
    for kind in ("_resnet", "_spatial", "_temporal", "_mid_spatial"):
        orig = getattr(unet, kind)

        def record(block, x, *args, _orig=orig, _kind=kind):
            calls.append((_kind, names[id(block)], tuple(x.shape), x.dtype))
            return _orig(block, x, *args)

        setattr(unet, kind, record)
    for name in ("init_conv", "time_mlp", "final_conv", "downs.0.4", "ups.0.4"):
        hooks.append(unet.get_submodule(name).register_forward_pre_hook(
            lambda mod, args, n=name: calls.append(("call", n, tuple(args[0].shape), args[0].dtype))))
    x = torch.from_numpy(seeded((3, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 4))
    with torch.no_grad():
        unet(x, torch.tensor([1, 5, 9]))
    for kind in ("_resnet", "_spatial", "_temporal", "_mid_spatial"):
        delattr(unet, kind)
    for h in hooks:
        h.remove()
    return calls


def _jax_block(unet, name: str):
    for part in name.split("."):
        unet = unet[int(part)] if part.isdigit() else getattr(unet, part)
    return unet


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused_ops"])
def test_unet_bf16_blocks_within_one_unit(monkeypatch, fused):
    """C5, block by block: each block of the bf16 Unet3D fed the same bf16 input on both sides (the time embedding
    JAX's) parts from JAX's block by at most one bf16 unit of the output's largest magnitude, and sits as far from
    the float32 block as JAX's does, within one unit. So the whole model's 0.07 (on a largest magnitude of 5.06)
    is sub-unit rounding-order differences carried through 26 blocks, not one block that rounds elsewhere.
    ``pytest -s`` prints each block's distances in units."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    flags = dict(use_fused_attention=fused, use_fused_spatial_attention=fused)
    jm, jm32 = jax_fixture_model(compute_dtype="bfloat16", **flags), jax_fixture_model(**flags)
    ju, j32 = jm.denoise_fn, jm32.denoise_fn
    pu = port_model(jm, compute_dtype="bfloat16", **flags).denoise_fn
    t = np.array([1, 5, 9], np.int32)
    temb, temb32 = ju.time_mlp(jnp.asarray(t)), j32.time_mlp(jnp.asarray(t))
    pos, ppos = ju.time_rel_pos_bias(FRAMES), pu.time_rel_pos_bias(FRAMES)
    calls = _block_calls(pu)
    assert len(calls) == 26
    rows = []
    for i, (kind, name, shape, dtype) in enumerate(calls):
        jb, jb32, pb = _jax_block(ju, name), _jax_block(j32, name), pu.get_submodule(name)
        if name == "time_mlp":
            p_in, j_in, j32_in = torch.from_numpy(t).long(), jnp.asarray(t), jnp.asarray(t)
        else:
            p_in = torch.from_numpy(seeded(shape, 100 + i)).to(dtype)
            j32_in = jnp.asarray(p_in.float().numpy())
            j_in = j32_in.astype(jnp.bfloat16) if dtype == torch.bfloat16 else j32_in
        with torch.no_grad():
            if kind == "call":
                want, ref, got = jb(j_in), jb32(j32_in), pb(p_in)
            elif kind == "_resnet":
                p_t = torch.from_numpy(np.array(temb, np.float32))
                want, ref, got = ju._resnet(jb, j_in, temb), j32._resnet(jb32, j32_in, temb32), pu._resnet(pb, p_in, p_t)
            elif kind == "_temporal":
                want, ref = ju._temporal(jb, j_in, pos, None), j32._temporal(jb32, j32_in, pos, None)
                got = pu._temporal(pb, p_in, ppos, None)
            else:
                want, ref, got = getattr(ju, kind)(jb, j_in), getattr(j32, kind)(jb32, j32_in), getattr(pu, kind)(pb, p_in)
        want, ref, got = np.asarray(want, np.float32), np.asarray(ref, np.float32), got.float().numpy()
        top = np.abs(want).max()
        unit = 2.0 ** (np.floor(np.log2(top)) - 7)
        rows.append((name, np.abs(got - want).max() / unit, np.abs(want - ref).max() / unit,
                     np.abs(got - ref).max() / unit))
    for name, to_jax, jax_f32, port_f32 in rows:
        print(f"{name:22s} port-jax {to_jax:5.2f}  jax-f32 {jax_f32:5.2f}  port-f32 {port_f32:5.2f} (bf16 units)")
        assert to_jax <= 1.0 and port_f32 <= jax_f32 + 1.0, name
