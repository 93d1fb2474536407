"""Sequence parallelism of the port against one rank and against the JAX package, on the CPU.

Four ranks run in spawned processes (``torch.multiprocessing``, gloo over a
``file://`` store); their target lives in ``torch_seq_workers``, which
imports no JAX. One spawn runs every case; this process prepares the inputs
and checks what each rank saved:

* the frame gather and the sum all-reduce, and their transposes;
* the frame-sharded GroupNorm against the unsharded one, forward and gradients;
* a compat Unet3D (dim 8, mults (1, 2), 8 frames of 16x16) at 4 ranks against
  1 rank and against the JAX Unet3D with a 4-device ``seq`` mesh, forward and
  gradients;
* three full-state-Adam trainer steps at 4 ranks with injected t and noise
  against a JAX step written as tests/test_torch_training.py writes it,
  without the buffer freeze and with the mesh attached: losses, gradient
  norms, parameters, schedule buffers and EMA; the ranks bit-equal.

The train CLI's own spawn of a 4-rank run is driven at the end. Tolerances,
float32: forward atol 5e-5, gradients 2e-4 of each tensor's largest
magnitude; trainer steps as in tests/test_torch_training.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
import yaml
from flax import nnx

import torch_seq_workers
from torch_port_helpers import CHANNELS, DIM, DIM_MULTS, IMAGE_SIZE, SEED, TIMESTEPS, flat_nnx_state, seeded
from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from video_diffusion_nnx_tpu.models import Unet3D as JaxUnet3D
from video_diffusion_nnx_tpu.parallel.mesh import make_mesh
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch import train
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint, state_dict_from_nnx, torch_key
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.models import Unet3D
from video_diffusion_nnx_tpu_torch.models.layers import GroupNorm
from video_diffusion_nnx_tpu_torch.parallel import init_sequence_group

WORLD, FRAMES, BATCH = 4, 8, 2
UNET = dict(dim=DIM, dim_mults=DIM_MULTS, channels=CHANNELS)
DIFFUSION = dict(image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS, timesteps=TIMESTEPS, loss_type="l2")
SHAPE = (BATCH, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
LR, DECAY_START, DECAY_STEPS, COEFF, MAX_NORM, EMA_DECAY = 1e-4, 1, 2, 0.1, 1.0, 0.9


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: error {err} of its largest value {scale}, over {tol}"


def _jax_diffusion():
    """The JAX model of the recipe, every bias drawn non-zero (see tests/test_torch_training.py:182)."""
    jm = JaxDiffusion(JaxUnet3D(rngs=nnx.Rngs(SEED), **UNET), **DIFFUSION)
    rng = np.random.default_rng(3)
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if path[-1] == "bias":
            var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * 0.1, jnp.float32))
    return jm


def _port_state(jm, model) -> dict:
    _, state = nnx.split(jm)
    return state_dict_from_nnx(flat_nnx_state(state), model)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Inputs of every case, the 4-rank results, and what the checks compare them with."""
    root = tmp_path_factory.mktemp("seq")
    jm = _jax_diffusion()
    port = GaussianDiffusion(Unet3D(**UNET), **DIFFUSION)
    state = _port_state(jm, port)
    port.load_state_dict(state)
    unet_state = {k[len("denoise_fn."):]: v for k, v in state.items() if k.startswith("denoise_fn.")}

    x_gn, g_gn = seeded((BATCH, FRAMES, 4, 4, 16), 1), seeded((BATCH, FRAMES, 4, 4, 16), 2)
    gn = {"x": _t(x_gn), "g": _t(g_gn), "weight": _t(seeded((16,), 3, 0.5) + 1), "bias": _t(seeded((16,), 4)),
          "groups": 4}
    x_u, g_u = seeded(SHAPE, 5), seeded((BATCH, FRAMES, IMAGE_SIZE, IMAGE_SIZE, CHANNELS), 6)
    t_u = np.array([1, 8], np.int32)
    data = root / "seq.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(FRAMES, 4, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    rng = np.random.default_rng(7)
    steps = [(rng.uniform(size=SHAPE).astype(np.float32), rng.integers(0, TIMESTEPS, size=BATCH).astype(np.int32),
              seeded(SHAPE, 20 + i)) for i in range(3)]
    trainer_kwargs = dict(
        folder=str(root), dataset_path=str(data), train_batch_size=BATCH, results_folder=str(root / "results"),
        tensorboard_dir=str(root / "tb"), profile_flush_step=0, train_num_steps=3, sequence_parallel_size=WORLD,
        train_lr=LR, lr_decay_start_step=DECAY_START, lr_decay_steps=DECAY_STEPS, lr_decay_coeff=COEFF,
        max_grad_norm=MAX_NORM, step_start_ema=1, update_ema_every=1, ema_decay=EMA_DECAY)
    spec = {
        "groupnorm": gn,
        "unet": {"state": unet_state, "kwargs": UNET, "x": _t(x_u), "t": torch.from_numpy(t_u).long(), "g": _t(g_u)},
        "train": {"state": state, "unet_kwargs": UNET, "diffusion_kwargs": DIFFUSION, "trainer_kwargs": trainer_kwargs,
                  "steps": [(_t(x), torch.from_numpy(t).long(), _t(n)) for x, t, n in steps]},
    }
    spec_path = root / "spec.pt"
    torch.save(spec, spec_path)
    mp.spawn(torch_seq_workers.rank_main, args=(WORLD, f"file://{root / 'store'}", str(spec_path), str(root)),
             nprocs=WORLD, join=True)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jm": jm, "port": port, "spec": spec, "steps": steps, "x_u": x_u, "t_u": t_u, "g_u": g_u,
            "ranks": ranks}


def test_collectives_and_their_transposes(case):
    ins = [torch_seq_workers.collective_inputs(r) for r in range(WORLD)]
    gathered = torch.cat([a["x"] for a in ins], dim=2)
    g_sum = sum(a["g"] for a in ins)
    summed = sum(a["y"] for a in ins)
    gy_sum = sum(a["gy"] for a in ins)
    for r, res in enumerate(case["ranks"]):
        c = res["collectives"]
        torch.testing.assert_close(c["gathered"], gathered, rtol=0, atol=0)
        torch.testing.assert_close(c["gathered_bf16"], gathered.bfloat16(), rtol=0, atol=0)
        # The gather's backward sums the cotangents over the ranks and keeps this rank's frames (psum_scatter).
        torch.testing.assert_close(c["dx"], g_sum[:, :, 2 * r:2 * r + 2], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(c["summed"], summed, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(c["dy"], gy_sum, rtol=1e-6, atol=1e-6)
    # Every rank holds the same bits of a sum; gloo copies CPU tensors without staging.
    assert all(torch.equal(res["collectives"]["summed"], case["ranks"][0]["collectives"]["summed"])
               for res in case["ranks"])
    assert all(res["stats"]["calls"] > 0 and res["stats"]["bytes"] > 0 for res in case["ranks"])


def test_sharded_groupnorm_matches_unsharded(case):
    gn = case["spec"]["groupnorm"]
    norm = GroupNorm(16, gn["groups"])
    norm.load_state_dict({"weight": gn["weight"], "bias": gn["bias"]})
    x = gn["x"].clone().requires_grad_()
    y = norm(x)
    y.backward(gn["g"])
    per = FRAMES // WORLD
    outs = [res["groupnorm"] for res in case["ranks"]]
    np.testing.assert_allclose(torch.cat([o["y"] for o in outs], 1).numpy(), y.detach().numpy(), atol=5e-5, rtol=0)
    _close(torch.cat([o["dx"] for o in outs], 1).numpy(), x.grad.numpy(), 2e-4, "dx")
    _close(sum(o["dweight"] for o in outs).numpy(), norm.weight.grad.numpy(), 2e-4, "dweight")
    _close(sum(o["dbias"] for o in outs).numpy(), norm.bias.grad.numpy(), 2e-4, "dbias")
    # A rank's statistics span every rank's frames: normalising its frames alone gives other values.
    alone = norm(gn["x"][:, :per]).detach()
    assert (alone - outs[0]["y"]).abs().max() > 1e-3


def _unet_one_rank(case):
    unet = case["port"].denoise_fn
    x = _t(case["x_u"]).requires_grad_()
    unet.zero_grad(set_to_none=True)
    out = unet(x, torch.from_numpy(case["t_u"]).long())
    out.backward(_t(case["g_u"]))
    return out.detach(), x.grad, {k: p.grad for k, p in unet.named_parameters() if p.grad is not None}


def test_four_rank_unet_matches_one_rank(case):
    out, dx, grads = _unet_one_rank(case)
    outs = [res["unet"] for res in case["ranks"]]
    np.testing.assert_allclose(torch.cat([o["out"] for o in outs], 1).numpy(), out.numpy(), atol=5e-5, rtol=0)
    _close(torch.cat([o["dx"] for o in outs], 2).numpy(), dx.numpy(), 2e-4, "dx")
    assert set(outs[0]["grads"]) == set(grads)
    global_norm = math.sqrt(sum(g.square().sum().item() for g in grads.values()))
    for k, want in grads.items():
        got = sum(o["grads"][k] for o in outs)  # each rank holds its share; the trainer sums them
        if want.norm().item() <= 1e-6 * global_norm:  # zero by construction: rounding noise on both sides
            assert got.norm().item() <= 1e-5 * global_norm, k
            continue
        _close(got.numpy(), want.numpy(), 2e-4, k)


def test_four_rank_unet_matches_jax_seq_mesh(case):
    """The JAX Unet3D with a 4-device ``seq`` mesh: its temporal attentions take parallel/sequence.py."""
    jm = case["jm"]
    junet = jm.denoise_fn
    junet.sequence_parallel_mesh = make_mesh((WORLD,), ("seq",))
    try:
        graphdef, state = nnx.split(junet)

        def fwd(state, x):
            return nnx.merge(graphdef, state)(x, jnp.asarray(case["t_u"]))

        want, vjp = jax.vjp(jax.jit(fwd), state, jnp.asarray(case["x_u"]))
        g_state, g_x = vjp(jnp.asarray(case["g_u"]))
    finally:
        junet.sequence_parallel_mesh = None
    outs = [res["unet"] for res in case["ranks"]]
    np.testing.assert_allclose(torch.cat([o["out"] for o in outs], 1).numpy(), np.asarray(want), atol=5e-5, rtol=0)
    _close(torch.cat([o["dx"] for o in outs], 2).numpy(), np.asarray(g_x), 2e-4, "dx")
    want_grads = state_dict_from_nnx(flat_nnx_state(g_state), case["port"].denoise_fn)
    global_norm = math.sqrt(sum(float(np.square(g.numpy()).sum()) for g in want_grads.values()))
    for k, w in want_grads.items():
        if k not in outs[0]["grads"]:  # compat math leaves the pre-norms and the position bias unused
            assert w.abs().max().item() == 0, k
            continue
        got = sum(o["grads"][k] for o in outs)
        if w.norm().item() <= 1e-6 * global_norm:
            assert got.norm().item() <= 1e-5 * global_norm, k
            continue
        _close(got.numpy(), w.numpy(), 2e-4, k)


def test_full_state_adam_steps_at_four_ranks_match_jax(case):
    """Three steps from identical weights, batches, t and noise: the JAX step (trainer.py:548-599 with the
    whole state trained, PARITY #11, and the mesh attached) against each rank's Trainer."""
    jm = _jax_diffusion()
    jm.denoise_fn.sequence_parallel_mesh = make_mesh((WORLD,), ("seq",))
    graphdef, params = nnx.split(jm)
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=LR,
        boundaries_and_scales={DECAY_START: 1.0, DECAY_START + DECAY_STEPS: COEFF}))
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    init = {k: v.numpy() for k, v in case["spec"]["train"]["state"].items()}
    port = case["port"]

    @jax.jit
    def loss_and_grads(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    ranks = [res["train"] for res in case["ranks"]]
    for step, (x, t, noise) in enumerate(case["steps"]):
        loss, grads = loss_and_grads(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        j_grads = flat_nnx_state(grads)
        grads, norm = jgrad.clip_grad_norm(grads, MAX_NORM)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if step >= 1:
            ema = jax.tree_util.tree_map(lambda e, p: EMA_DECAY * e + (1 - EMA_DECAY) * p, ema, params)

        got = ranks[0][step]
        for r in range(1, WORLD):  # the summed gradient makes every rank's update the same, bit for bit
            assert ranks[r][step]["loss"] == got["loss"] and ranks[r][step]["norm"] == got["norm"]
            for k in got["state"]:
                assert torch.equal(ranks[r][step]["state"][k], got["state"][k]), (r, k)
                assert torch.equal(ranks[r][step]["ema"][k], got["ema"][k]), (r, k)
        np.testing.assert_allclose(got["loss"], float(loss), atol=5e-5, rtol=0)
        np.testing.assert_allclose(got["norm"], float(norm), rtol=1e-4)

        # Full state: the two buffers on the loss's path drift, alphas_cumprod (no path) stays bit-exact.
        drift = {k: np.abs(got["state"][k].numpy() - init[k]).max() for k in BUFFER_NAMES}
        assert drift["sqrt_alphas_cumprod"] > 0 and drift["sqrt_one_minus_alphas_cumprod"] > 0
        assert drift["alphas_cumprod"] == 0 and drift["posterior_variance"] == 0
        global_norm = np.sqrt(sum(np.square(g).sum() for g in j_grads.values()))
        noise_only = {torch_key(k) for k, g in j_grads.items() if 0 < np.sqrt(np.square(g).sum()) <= 1e-6 * global_norm}
        for name, tree, state in (("param", params, got["state"]), ("ema", ema, got["ema"])):
            want = state_dict_from_nnx(flat_nnx_state(tree), port)
            for k, w in want.items():
                g = state[k].numpy()
                if k in noise_only:  # see tests/test_torch_training.py:235
                    bound = 4 * LR * (step + 1)
                    assert np.abs(g - init[k]).max() <= bound and np.abs(w.numpy() - init[k]).max() <= bound
                    continue
                tol = 1e-4 * max(np.abs(w.numpy()).max(), 1e-12)
                np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=0, err_msg=f"{name} {k} step {step}")


def test_train_cli_starts_the_ranks_itself(tmp_path):
    """``python -m ...train --config <seq recipe>`` spawns the ranks; rank 0 writes the checkpoints."""
    data = tmp_path / "seq.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(FRAMES, 4, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    cfg = {"rng_seed": 0,
           "unet": {"dim": DIM, "rngs_seed": SEED, "dim_mults": list(DIM_MULTS), "channels": CHANNELS},
           "diffusion": DIFFUSION,
           "trainer": {"dataset_path": str(data), "train_batch_size": BATCH, "train_num_steps": 3, "num_frames": FRAMES,
                       "checkpoint_every_steps": 2, "results_folder": str(tmp_path / "results"),
                       "tensorboard_dir": str(tmp_path / "tb"), "profile_flush_step": 0, "dataset_normalize": True,
                       "sequence_parallel_size": WORLD, "train_lr": 1e-3}}
    path = tmp_path / "seq.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train.main(["--config", str(path), "--device", "cpu", "--dist-backend", "gloo"]) is None
    ckpts = tmp_path / "results" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_2.pt", "step_3.pt"]
    payload = read_checkpoint(ckpts / "step_3.pt")
    fresh = GaussianDiffusion(Unet3D(**UNET), **DIFFUSION).state_dict()
    assert not torch.equal(payload["model"]["sqrt_alphas_cumprod"], fresh["sqrt_alphas_cumprod"])
    assert torch.equal(payload["model"]["alphas_cumprod"], fresh["alphas_cumprod"])


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nccl cannot put two ranks on one card.*gloo"):
        init_sequence_group(1, WORLD, "nccl", "file:///nonexistent", device_type="cuda")
    with pytest.raises(ValueError, match="need backend 'gloo'"):
        init_sequence_group(0, WORLD, "nccl", "file:///nonexistent", device_type="cpu")
    with pytest.raises(ValueError, match="backend must be"):
        init_sequence_group(0, WORLD, "mpi", "file:///nonexistent")
