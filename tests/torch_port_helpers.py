"""Shared helpers for the tests that hold the PyTorch port against the JAX package."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

torch.set_num_threads(1)  # the suite runs 6 workers on 8 cores

FIXTURE = Path(__file__).parent / "golden" / "ckpt_fixture"
# The fixture recipe of scripts/make_checkpoint_fixture.py.
SEED, DIM, DIM_MULTS, CHANNELS = 7, 8, (1, 2), 1
IMAGE_SIZE, FRAMES, TIMESTEPS, STEP = 16, 4, 10, 1


def flat_nnx_state(state) -> dict[str, np.ndarray]:
    """An nnx.State as ``{"a/b/c": array}`` (the paths of tests/golden/state_tree_v2_2.txt)."""
    out = {}
    for path, v in nnx.to_flat_state(state):
        value = v.get_value() if hasattr(v, "get_value") else v.value
        out["/".join(str(p) for p in path)] = np.asarray(value)
    return out


def jax_fixture_model(seed: int = SEED, prediction_type: str = "noise", **unet_kwargs):
    """The JAX GaussianDiffusion of the fixture recipe."""
    from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu.models import Unet3D

    unet = Unet3D(dim=DIM, rngs=nnx.Rngs(seed), dim_mults=DIM_MULTS, channels=CHANNELS, **unet_kwargs)
    return GaussianDiffusion(
        unet, image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
        timesteps=TIMESTEPS, loss_type="l2", prediction_type=prediction_type,
    )


def port_model(jax_diffusion, prediction_type: str = "noise", **unet_kwargs):
    """The port's GaussianDiffusion of the same recipe, with the JAX model's weights converted."""
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    unet = Unet3D(dim=DIM, dim_mults=DIM_MULTS, channels=CHANNELS, **unet_kwargs)
    diffusion = GaussianDiffusion(
        unet, image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
        timesteps=TIMESTEPS, loss_type="l2", prediction_type=prediction_type,
    )
    _, state = nnx.split(jax_diffusion)
    diffusion.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), diffusion))
    return diffusion.eval()


def seeded(shape, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# The float32 temporal backwards' split-precision TF32 ("3xTF32") products, emulated on the CPU
# (tests/test_torch_tf32x3.py, tests/test_torch_staged_3xtf32.py).
def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, by masking the low 13 bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(t: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor cores read a TF32 operand: its top 19 bits (truncated toward zero; a NaN stays one)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split (``split`` in csrc/common.cuh): hi = tf32(t), lo = t - hi as the tensor cores read it."""
    hi = tf32(t)
    return hi, tf32_read(t - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' split product: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each term exact, summed in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


# Distillation (tests/test_torch_distill*.py, tests/test_torch_guidance.py): the teacher kinds, each a JAX
# GaussianDiffusion and the port's with the same weights. Every bias is drawn nonzero (Adam's first step moves each
# element by about lr whatever its gradient, so a zero tensor would be compared where rounding decides it), the
# DiT's adaLN and output weights at std 0.05 (zero at init, when no attention has a gradient), and the guidance
# embedding's output layer at std 0.05 (a trained embedding).
DISTILL_COND = 16
DIT_ARCH = dict(dim=32, depth=2, channels=CHANNELS, attn_heads=2, attn_dim_head=16, patch_size=4)
DIT_SIZE, DIT_FRAMES = 8, 3


def _draw(var, rng, scale: float = 0.1) -> None:
    var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * scale, jnp.float32))


def distill_models(kind: str, seed: int = 7, perturb_biases: bool = True):
    """``(jax_diffusion, port_diffusion)`` for a teacher ``kind``: "unet" (the fixture Unet3D, v-prediction),
    "dit" (tests/test_torch_dit.py's VideoDiT at 8x8, 3 frames, T = 10, v-prediction), "unet_w" / "dit_w" (each
    conditioned on ``DISTILL_COND``-wide vectors with ``guidance_embed``: stage 2) or "unet_cond" / "dit_cond"
    (conditioned, no embedding: a guidance teacher)."""
    from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxGD
    from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import VideoDiT

    arch, _, extra = kind.partition("_")
    kw = {}
    if extra:
        kw["cond_dim"] = DISTILL_COND
    if extra == "w":
        kw["guidance_embed"] = True
    if arch == "unet":
        jm = jax_fixture_model(seed=seed, prediction_type="v", **kw)
        pm = port_model(jm, prediction_type="v", **kw)
    else:
        unet = JaxVideoDiT(rngs=nnx.Rngs(seed), **DIT_ARCH, **kw)
        rng = np.random.default_rng(seed + 100)
        for lin in [blk.ada for blk in unet.blocks] + [unet.final_ada, unet.final_proj]:
            lin.kernel[...] = jnp.asarray(rng.standard_normal(lin.kernel[...].shape).astype(np.float32) * 0.05)
        dkw = dict(image_size=DIT_SIZE, num_frames=DIT_FRAMES, channels=CHANNELS, timesteps=TIMESTEPS,
                   loss_type="l2", prediction_type="v")
        jm = JaxGD(unet, **dkw)
        pm = GaussianDiffusion(VideoDiT(**DIT_ARCH, **kw), **dkw).eval()
    rng = np.random.default_rng(seed + 200)
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if "guidance_mlp" in path and path[-2] == 3:
            _draw(var, rng, 0.05)
        elif perturb_biases and path[-1] == "bias":
            _draw(var, rng)
    _, state = nnx.split(jm)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), pm))
    return jm, pm


def distill_shape(kind: str, batch: int = 2) -> tuple[int, ...]:
    if kind.startswith("dit"):
        return (batch, CHANNELS, DIT_FRAMES, DIT_SIZE, DIT_SIZE)
    return (batch, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)


# The multi-rank trainer tests (tests/test_torch_data_parallel.py, tests/test_torch_sharded_state.py): the fixture
# recipe's Unet3D drawn from a seed with every bias non-zero, 4 frames, batch 4, and the injected steps.
MESH_FRAMES, MESH_BATCH, MESH_LR, MESH_SAMPLE_ROWS = 4, 4, 1e-4, 4
MESH_SHAPE = (MESH_BATCH, CHANNELS, MESH_FRAMES, IMAGE_SIZE, IMAGE_SIZE)
MESH_UNET = dict(dim=DIM, dim_mults=DIM_MULTS, channels=CHANNELS)
MESH_DIFFUSION = dict(image_size=IMAGE_SIZE, num_frames=MESH_FRAMES, channels=CHANNELS, timesteps=TIMESTEPS,
                      loss_type="l2")


def mesh_recipe_spec(root) -> dict:
    """The fixture recipe's weights (biases non-zero), a dataset, and the injected batches, t and noise."""
    pm = mesh_model()
    pm.denoise_fn.reset_parameters(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(3)
    state = {k: (v + torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32))
                 if k.endswith(".bias") else v) for k, v in pm.state_dict().items()}
    data = root / "clips.npy"
    clips = np.random.default_rng(0).integers(0, 256, size=(MESH_FRAMES, 8, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8)
    np.save(data, clips)
    rng = np.random.default_rng(7)
    steps = [(torch.from_numpy(rng.uniform(size=MESH_SHAPE).astype(np.float32)),
              torch.from_numpy(rng.integers(0, TIMESTEPS, size=MESH_BATCH)).long(),
              torch.from_numpy(seeded(MESH_SHAPE, 20 + i))) for i in range(5)]
    trainer = dict(dataset_path=str(data), train_batch_size=MESH_BATCH, train_num_steps=10, profile_flush_step=0,
                   train_lr=MESH_LR, lr_decay_start_step=1, lr_decay_steps=2, lr_decay_coeff=0.1, max_grad_norm=1.0,
                   step_start_ema=0, update_ema_every=1, ema_decay=0.9, num_sample_rows=MESH_SAMPLE_ROWS)
    return {"root": str(root), "state": state, "unet": MESH_UNET, "diffusion": MESH_DIFFUSION, "trainer": trainer,
            "steps": steps}


def mesh_model(state: dict | None = None):
    from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu_torch.models import Unet3D

    m = GaussianDiffusion(Unet3D(**MESH_UNET), **MESH_DIFFUSION)
    if state is not None:
        m.load_state_dict(state)
    return m


def spawn_mesh_runs(root, spec: dict, runs: list) -> list:
    """Every run at its ranks in one spawn of four processes; each rank's results."""
    import torch.multiprocessing as mp

    import torch_mesh_workers

    spec_path = root / "spec.pt"
    torch.save({**spec, "runs": runs}, spec_path)
    mp.spawn(torch_mesh_workers.rank_main, args=(str(spec_path), str(root)), nprocs=4, join=True)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]


def close_state(got: dict, want: dict, init: dict, grads: dict, step: int, what: str) -> None:
    """Each tensor within 1e-4 of its largest value; a tensor whose gradient is rounding noise (at most 1e-6 of the
    global norm) moves by Adam's step alone on both sides, bounded instead (see tests/test_torch_training.py)."""
    assert set(got) == set(want), what
    global_norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        if k in grads and float(grads[k].norm()) <= 1e-6 * global_norm:
            bound = 4 * MESH_LR * (step + 1)
            assert float((g - init[k]).abs().max()) <= bound, (what, k)
            continue
        tol = 1e-4 * max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= tol, f"{what} {k} step {step}: {float((g - w).abs().max())} over {tol}"


def mesh_jax_model(state: dict):
    """The JAX GaussianDiffusion of the multi-rank recipe holding the port's ``state``: the converter's map inverted,
    each JAX element's place in the port's tensor found by converting an array of indices."""
    from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion
    from video_diffusion_nnx_tpu.models import Unet3D
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx, torch_key

    jm = GaussianDiffusion(Unet3D(rngs=nnx.Rngs(SEED), **MESH_UNET), **MESH_DIFFUSION)
    flat = nnx.to_flat_state(nnx.state(jm))
    shapes = {"/".join(str(p) for p in path): np.shape(var.get_value()) for path, var in flat}
    assert max(int(np.prod(v)) for v in shapes.values()) < 2**24  # indices exact in the converter's float32
    index = state_dict_from_nnx({k: np.arange(np.prod(v)).reshape(v) for k, v in shapes.items()}, mesh_model())
    for path, var in flat:
        key = "/".join(str(p) for p in path)
        value = np.empty(int(np.prod(shapes[key])), np.float32)
        value[index[torch_key(key)].numpy().astype(np.int64).ravel()] = state[torch_key(key)].numpy().ravel()
        var.set_value(jnp.asarray(value.reshape(shapes[key])))
    back = state_dict_from_nnx(flat_nnx_state(nnx.state(jm)), mesh_model())
    assert all(torch.equal(back[k], v) for k, v in state.items())
    return jm


def jax_mesh_steps(spec: dict, layout: str, steps: int = 3, fsdp_min_size: int = 256) -> dict:
    """The JAX package's step of the multi-rank recipe on a 4-device CPU mesh, on the spec's injected batches, t and
    noise: ``p_losses``, ``clip_grad_norm``, ``optax.adam`` over the hold-then-cosine schedule and the EMA, with the
    whole state trained (as tests/test_torch_seq_parallel.py assembles it), jitted with the shardings the JAX trainer
    gives a mesh (training/trainer.py:244-323): ``dp`` (data 4, model 1) with every tensor replicated, ``fsdp`` the
    same mesh with the parameters, Adam's moments and the EMA by ``fsdp_partition_specs``, ``dseq`` (data 2, seq 2)
    attached to the denoiser. The batch, t and noise are sharded over ``data``. Returns, as port state dicts, the
    first step's clipped gradient and every step's state and EMA, with the losses and gradient norms."""
    import jax
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from video_diffusion_nnx_tpu.parallel.mesh import data_model_mesh, make_mesh
    from video_diffusion_nnx_tpu.parallel.sharding import (fsdp_partition_specs, named_shardings,
                                                           optimizer_partition_specs)
    from video_diffusion_nnx_tpu.utils import grad as jgrad
    from video_diffusion_nnx_tpu.utils import image as jimage
    from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx

    kw = spec["trainer"]
    jm = mesh_jax_model(spec["state"])
    if layout == "dseq":
        mesh = make_mesh((2, 2), ("data", "seq"))
        jm.denoise_fn.sequence_parallel_mesh = mesh  # before the split, as the JAX trainer attaches it
    else:
        mesh = data_model_mesh(4, 1)
    graphdef, params = nnx.split(jm)
    start = kw["lr_decay_start_step"]
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=kw["train_lr"],
        boundaries_and_scales={start: 1.0, start + kw["lr_decay_steps"]: kw["lr_decay_coeff"]}))
    opt_state = tx.init(params)
    abstract = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
    if layout == "fsdp":
        param_specs = fsdp_partition_specs(abstract, "data", 4, min_size_to_shard=fsdp_min_size)
    else:
        param_specs = jax.tree_util.tree_map(lambda _: P(), abstract)
    abstract_opt = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype) if hasattr(x, "shape") else x, opt_state)
    p_sh = named_shardings(mesh, param_specs)
    o_sh = named_shardings(mesh, optimizer_partition_specs(param_specs, abstract_opt))
    rows, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    max_norm, decay = kw["max_grad_norm"], kw["ema_decay"]

    def step(params, opt_state, ema, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads, norm = jgrad.clip_grad_norm(grads, max_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, ema, params)
        return params, opt_state, ema, loss, norm, grads

    jitted = jax.jit(step, in_shardings=(p_sh, o_sh, p_sh, rows, rows, rows),
                     out_shardings=(p_sh, o_sh, p_sh, repl, repl, p_sh))
    params = jax.device_put(params, p_sh)
    opt_state = jax.device_put(opt_state, o_sh)
    ema = jax.device_put(jax.tree_util.tree_map(jnp.copy, params), p_sh)
    port = mesh_model()

    def port_state(tree):
        return state_dict_from_nnx(flat_nnx_state(jax.device_get(tree)), port)

    out = {"losses": [], "norms": [], "states": [], "emas": []}
    for i, (x, t, noise) in enumerate(spec["steps"][:steps]):
        x, t, noise = (jax.device_put(jnp.asarray(v.numpy()), rows) for v in (x, t.int(), noise))
        params, opt_state, ema, loss, norm, grads = jitted(params, opt_state, ema, x, t, noise)
        if i == 0:
            out["grads"] = port_state(grads)
            out["sharded"] = sum(any(a is not None for a in s.spec) for s in jax.tree_util.tree_leaves(
                p_sh, is_leaf=lambda v: isinstance(v, NamedSharding)))
        out["losses"].append(float(loss))
        out["norms"].append(float(norm))
        out["states"].append(port_state(params))
        out["emas"].append(port_state(ema))
    return out


def close_to_jax(got: dict, want: dict, init: dict, what: str) -> None:
    """Rank 0's record of a multi-rank run of the port against :func:`jax_mesh_steps` of its layout.

    The first step's clipped gradient: each tensor within 2e-4 of its largest value (the bound of
    tests/test_torch_seq_parallel.py), one whose JAX gradient is rounding noise (at most 1e-6 of the global norm)
    within 1e-5 of the global norm, and one the port leaves without a gradient (compat math's position bias, the
    schedule buffers off the loss's path) exactly zero in JAX. Every step's loss within atol 5e-5 and gradient norm
    within rtol 1e-4, the state and the EMA after every step by :func:`close_state` (tests/test_torch_training.py's
    bounds)."""
    grads = {k: torch.as_tensor(v) for k, v in want["grads"].items()}
    global_norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))
    for k, w in grads.items():
        if k not in got["grads"]:
            assert float(w.abs().max()) == 0, (what, k)
            continue
        g = got["grads"][k]
        if float(w.norm()) <= 1e-6 * global_norm:
            assert float(g.norm()) <= 1e-5 * global_norm, (what, k)
            continue
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
        assert err <= 2e-4, f"{what} {k}: gradient {err} of its largest value, over 2e-4"
    np.testing.assert_allclose(got["losses"], want["losses"], atol=5e-5, rtol=0, err_msg=what)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-4, err_msg=what)
    for step in range(len(want["losses"])):
        close_state(got["states"][step], want["states"][step], init, grads, step, what)
        close_state(got["emas"][step], want["emas"][step], init, grads, step, what + " ema")
