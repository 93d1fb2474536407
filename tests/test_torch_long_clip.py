"""The port's long-clip path against the JAX package, on the CPU at small sizes.

Beyond 64 frames the temporal op takes the blockwise (online-softmax) route.
On the CPU the port runs its plain blockwise versions; the JAX side runs its
blockwise Pallas kernels through the interpreter, as tests/test_ops.py does.
Covered: the op's forward and all five gradients at f = 65, 72, 96 and 128,
the backward oracle against the Pallas backward kernel, both plain blockwise
versions against the dense plain version for several block widths, a 72-frame
Unet3D, ``remat_blocks``, and two trainer steps and the CLIs at a tiny
long-clip-shaped recipe. Tolerances: float32 forward atol 5e-5, gradients
2e-4; bf16 forward atol 0.05, gradients rtol 0.1 / atol 0.25; the Unet 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

from torch_port_helpers import flat_nnx_state, seeded
from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from video_diffusion_nnx_tpu.models import MultiheadAttention
from video_diffusion_nnx_tpu.models import Unet3D as JaxUnet3D
from video_diffusion_nnx_tpu.ops import spatial_linear_attention as jsla
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch import ops, sample, train
from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import Unet3D
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

HEADS, DIM, C = 2, 8, 16
FRAMES, SIZE = 72, 8  # the long-clip-shaped Unet of tests/test_ops.py: dim 8, mults (1,), heads 2
NOISE = 1e-5  # a gradient this far under the largest of all is float32 rounding noise


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _op_inputs(f: int, b: int = 1, s: int = 2):
    mha = MultiheadAttention(in_features=C, dim=DIM, num_heads=HEADS, rngs=nnx.Rngs(0))
    wqkv, bqkv, wo, bo = (np.asarray(a) for a in jta.pack_mha_weights(mha))
    bqkv = bqkv + seeded(bqkv.shape, 3, 0.1)  # non-zero biases
    bo = bo + seeded(bo.shape, 4, 0.1)
    return seeded((b, s, f, C), 1), (wqkv, bqkv, wo, bo)


def _jax_grads(x, w, dtype=jnp.float32):
    def loss(x, *w):
        return jnp.sum(jta.fused_temporal_attention_block(x, *w, HEADS, DIM).astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x, dtype), *map(jnp.asarray, w))


@pytest.mark.parametrize("f", [65, 72, 96, 128])
def test_blockwise_op_matches_pallas_kernel(monkeypatch, f):
    """f = 65 is ragged (the TPU pads it to 72 and masks); f = 128 is the long-clip recipe's length."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    x, w = _op_inputs(f)
    assert jta._route(jnp.asarray(x), f) == "blockwise"
    want = np.asarray(jta.fused_temporal_attention_block(jnp.asarray(x), *map(jnp.asarray, w), HEADS, DIM))
    ops.reset_launch_counts()
    got = pta.fused_temporal_attention_block(_t(x), *map(_t, w), HEADS, DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    assert set(ops.launch_counts().values()) == {0}  # a CPU tensor takes the plain version


@pytest.mark.parametrize("f,b,s", [(65, 1, 2), (72, 1, 2), (96, 2, 4), (128, 1, 2)])
def test_blockwise_op_gradients_match_pallas_kernel(monkeypatch, f, b, s):
    """All five gradients of sum(out^2): autograd through the plain blockwise version, and the
    backward oracle's formulas, both against the Pallas blockwise backward kernel."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    x, w = _op_inputs(f, b, s)
    want = [np.asarray(g) for g in _jax_grads(x, w)]
    leaves = [_t(a).requires_grad_() for a in (x, *w)]
    out = pta.fused_temporal_attention_block(*leaves, HEADS, DIM)
    out.square().sum().backward()
    oracle = pta.temporal_attention_bwd(_t(x), 2 * out.detach(), *map(_t, w), HEADS, DIM)
    for name, leaf, o, g in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), leaves, oracle, want):
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"autograd {name}")
        np.testing.assert_allclose(o.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"oracle {name}")


def test_blockwise_op_in_bf16_matches_pallas_kernel(monkeypatch):
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    f = 96
    x, w = _op_inputs(f)
    want = np.asarray(jta.fused_temporal_attention_block(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, w), HEADS, DIM), np.float32)
    xt = _t(x, torch.bfloat16)
    got = pta.fused_temporal_attention_block(xt, *map(_t, w), HEADS, DIM)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0)
    grads = pta.temporal_attention_bwd(xt, 2 * got, *map(_t, w), HEADS, DIM)
    for name, a, g in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), grads, _jax_grads(x, w, jnp.bfloat16)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(g, np.float32), rtol=0.1, atol=0.25, err_msg=name)


@pytest.mark.parametrize("f,kb", [(65, 16), (72, 8), (72, 32), (100, 48), (128, 32), (128, 128)])
def test_blockwise_plain_versions_equal_the_dense_plain_version(f, kb):
    """Any block width, dividing f or not, gives the dense function: forward 2e-5, gradients 2e-4."""
    x, w = _op_inputs(f, 1, 3)
    leaves = [_t(a).requires_grad_() for a in (x, *w)]
    want = pta.temporal_attention_plain(*leaves, HEADS, DIM)
    g = _t(seeded(x.shape, 5))
    want_grads = torch.autograd.grad(want, leaves, g)
    tensors = [t.detach() for t in leaves]
    got = pta.temporal_attention_blockwise_plain(*tensors, HEADS, DIM, kb)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=2e-5, rtol=0)
    grads = pta.temporal_attention_blockwise_bwd_plain(tensors[0], g, *tensors[1:], HEADS, DIM, kb)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4, err_msg=name)


def test_blockwise_support_follows_shared_memory():
    for f in (128, 256, 321):
        pta._check_blockwise(f, 32)
    assert 4 * pta._blockwise_floats(128, 32, pta.KV_BLOCK, backward=True) <= pta._SMEM_MAX // 2  # two CTAs per SM
    with pytest.raises(NotImplementedError, match="f=322"):
        pta._check_blockwise(322, 32)
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        pta._check_blockwise(4096, 32)
    # The limit is the card's: a CPU tensor of that length takes the plain version.
    x, w = _op_inputs(400, 1, 1)
    got = pta.fused_temporal_attention_block(_t(x), *map(_t, w), HEADS, DIM)
    want = pta.temporal_attention_plain(_t(x), *map(_t, w), HEADS, DIM)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def _unets(**kw):
    """The JAX long-clip-shaped Unet3D and the port's with its weights converted."""
    base = dict(dim=8, dim_mults=(1,), channels=1, attn_heads=HEADS)
    jax_unet = JaxUnet3D(rngs=nnx.Rngs(0), **base, **kw)
    port = Unet3D(**base, **kw)
    _, state = nnx.split(jax_unet)
    port.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), port))
    return jax_unet, port


def test_unet_72_frames_matches_jax(monkeypatch):
    """Every temporal attention of the 72-frame Unet3D takes the blockwise route on both sides."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    jax_unet, port = _unets(use_fused_attention=True, use_fused_spatial_attention=True)
    x = seeded((1, 1, FRAMES, SIZE, SIZE), 2)
    want = np.asarray(jax_unet(jnp.asarray(x), jnp.array([3.0])))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.tensor([3.0]))
    assert tuple(got.shape) == (1, FRAMES, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_remat_blocks_changes_neither_output_nor_gradients():
    _, plain = _unets(use_fused_attention=True)
    remat = Unet3D(dim=8, dim_mults=(1,), channels=1, attn_heads=HEADS, use_fused_attention=True,
                   remat_blocks=True)
    remat.load_state_dict(plain.state_dict())
    x, t = torch.from_numpy(seeded((1, 1, FRAMES, SIZE, SIZE), 2)), torch.tensor([3.0])
    outs = []
    for net in (plain, remat):
        xi = x.clone().requires_grad_()
        out = net(xi, t)
        out.square().sum().backward()
        outs.append((out.detach(), xi.grad, {k: p.grad for k, p in net.named_parameters()}))
    (y0, dx0, g0), (y1, dx1, g1) = outs
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(dx1, dx0, rtol=0, atol=0)
    live = {k for k, g in g0.items() if g is not None}  # compat math leaves the rel-pos bias unused
    assert len(live) > 30 and live == {k for k, g in g1.items() if g is not None}
    for k in live:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    with torch.no_grad():  # sampling: nothing is checkpointed, and the result is the same
        torch.testing.assert_close(remat(x, t), y0, rtol=0, atol=0)


def test_remat_blocks_matches_jax_remat(monkeypatch):
    """Loss and every parameter's gradient, both sides rematerialising their ResNet blocks."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    jax_unet, port = _unets(use_fused_attention=True, remat_blocks=True)
    assert port.remat_blocks and jax_unet.remat_blocks
    x = seeded((1, 1, FRAMES, SIZE, SIZE), 2)
    graphdef, state = nnx.split(jax_unet)
    want, grads = jax.value_and_grad(
        lambda st: jnp.sum(nnx.merge(graphdef, st)(jnp.asarray(x), jnp.array([3.0])) ** 2))(state)
    loss = port(torch.from_numpy(x), torch.tensor([3.0])).square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_grads = state_dict_from_nnx(flat_nnx_state(grads), port)
    live = {k: p.grad for k, p in port.named_parameters() if p.grad is not None}
    assert len(live) > 30
    # 2e-4 of each tensor's largest gradient; a tensor whose gradient is zero by construction (a conv
    # bias under a one-channel GroupNorm) carries rounding noise, held to 1% of the largest gradient of all.
    largest = max(want_grads[k].abs().max().item() for k in live)
    for k, g in live.items():
        tol = 2e-4 * max(1.0, want_grads[k].abs().max().item(), 0.01 * largest)
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), atol=tol, rtol=0, err_msg=k)


def _diffusions(**kw):
    jax_unet, port_unet = _unets(**kw)
    d = dict(image_size=SIZE, num_frames=FRAMES, channels=1, timesteps=10, loss_type="l2")
    jm = JaxDiffusion(jax_unet, **d)
    pm = GaussianDiffusion(port_unet, **d)
    _, state = nnx.split(jm)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(state), pm))
    return jm, pm


def test_two_long_clip_train_steps_match_jax(monkeypatch, tmp_path):
    """Batch 1, 72 frames, ``remat_blocks``, both fused flags and a live ``max_grad_norm``, as the
    long-clip recipe has them: the Trainer against the JAX package's pieces (loss, gradient norm,
    every parameter), from identical weights, clips, t and noise."""
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jsla, "FORCE_INTERPRET", True)
    lr, start, steps, coeff, max_norm = 1e-4, 1, 4, 0.1, 1.0
    jm, pm = _diffusions(use_fused_attention=True, use_fused_spatial_attention=True, remat_blocks=True)
    data = tmp_path / "clips.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(FRAMES, 2, SIZE, SIZE), dtype=np.uint8))
    tr = Trainer(pm.train(), folder=str(tmp_path), dataset_path=str(data), train_batch_size=1,
                 results_folder=str(tmp_path / "results"), tensorboard_dir=str(tmp_path / "tb"),
                 profile_flush_step=0, freeze_schedule_buffers=True, train_num_steps=2, train_lr=lr,
                 lr_decay_start_step=start, lr_decay_steps=steps, lr_decay_coeff=coeff, max_grad_norm=max_norm)

    graphdef, params = nnx.split(jm)
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=lr, boundaries_and_scales={start: 1.0, start + steps: coeff}))
    opt_state = tx.init(params)

    @jax.jit
    def loss_and_grads(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    shape = (1, 1, FRAMES, SIZE, SIZE)
    rng = np.random.default_rng(7)
    grad_max = {}  # each tensor's largest JAX gradient entry over the two steps, before the clip
    for step in range(2):
        x = rng.uniform(size=shape).astype(np.float32)
        t = rng.integers(0, 10, size=1).astype(np.int32)
        noise = seeded(shape, 20 + step)
        loss, grads = loss_and_grads(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
        grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
        for k, g in state_dict_from_nnx(flat_nnx_state(grads), pm).items():
            grad_max[k] = max(grad_max.get(k, 0.0), g.abs().max().item())
        grads, norm = jgrad.clip_grad_norm(grads, max_norm)
        assert float(norm) > max_norm  # the clip is live, as in the recipe
        updates, opt_state = tx.update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        p_new, _ = nnx.split_state(new, nnx.Param, ...)
        _, rest_old = nnx.split_state(params, nnx.Param, ...)
        params = nnx.merge_state(p_new, rest_old)

        p_loss, p_norm = tr.train_step(torch.from_numpy(x), t=torch.from_numpy(t).long(),
                                       noise=torch.from_numpy(noise))
        tr.step += 1
        np.testing.assert_allclose(p_loss.item(), float(loss), atol=5e-5, rtol=0)
        np.testing.assert_allclose(p_norm.item(), float(norm), rtol=2e-4)
    # Adam's normalised step is lr-sized whatever the gradient: hold the update, not the value.
    want = state_dict_from_nnx(flat_nnx_state(params), pm)
    moved = [k for k, p in pm.named_parameters() if p.grad is not None]
    assert moved
    # A tensor whose reference gradient is rounding noise (a key bias, which the softmax cancels; a conv
    # bias under a one-channel GroupNorm) takes lr-sized steps of either sign on both sides. Noise is a
    # largest entry under NOISE of the largest gradient entry of all; every other tensor, biases
    # included, agrees to half a step.
    floor = NOISE * max(grad_max.values())
    noisy = [k for k in moved if grad_max[k] < floor]
    assert len(noisy) < len(moved) // 4, noisy
    far = {k: (pm.state_dict()[k] - want[k]).abs().max().item() for k in moved if k not in noisy}
    far = {k: d for k, d in far.items() if d > 0.5 * lr * 2}
    assert not far, far


def _long_clip_config(root, **trainer):
    data = root / "clips.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(FRAMES, 3, SIZE, SIZE), dtype=np.uint8))
    cfg = {
        "rng_seed": 0,
        "unet": {"dim": 8, "rngs_seed": 0, "dim_mults": [1], "channels": 1, "attn_heads": HEADS,
                 "compute_dtype": "bfloat16", "use_fused_attention": True, "use_fused_spatial_attention": True,
                 "remat_blocks": True},
        "diffusion": {"image_size": SIZE, "num_frames": FRAMES, "timesteps": 10, "loss_type": "l2", "channels": 1},
        "trainer": {"dataset_path": str(data), "train_batch_size": 1, "train_lr": 1e-3, "train_num_steps": 3,
                    "lr_decay_start_step": 1, "lr_decay_steps": 2, "lr_decay_coeff": 0.1, "num_frames": FRAMES,
                    "step_start_ema": 1, "update_ema_every": 1, "max_grad_norm": 1.0, "checkpoint_every_steps": 2,
                    "results_folder": str(root / "results"), "tensorboard_dir": str(root / "tb"),
                    "max_to_keep": 10, "profile_flush_step": 0, "dataset_normalize": True,
                    "save_optimizer_state": True, "log_every_steps": 2, "freeze_schedule_buffers": True,
                    **trainer},
    }
    path = root / "long_clip.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_long_clip_shaped_recipe_trains_and_samples_through_the_clis(tmp_path):
    """The long-clip recipe's keys at a tiny size: train 3 steps in bf16, then sample a 72-frame GIF."""
    cfg = _long_clip_config(tmp_path)
    tr = train.main(["--config", str(cfg), "--device", "cpu"])
    losses = tr.loss_trace.tolist()
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert tr.model.denoise_fn.remat_blocks and tr.max_grad_norm == 1.0
    assert [tr.lr_schedule(c) for c in (0, 1)] == [1e-3, 1e-3] and abs(tr.lr_schedule(3) - 1e-4) < 1e-12
    ckpt = tmp_path / "results" / "checkpoints" / "step_3.pt"
    assert ckpt.is_file()
    res = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path", str(tmp_path / "out"),
                       "--batch-size", "1", "--sampler", "ddim", "--num-steps", "2", "--device", "cpu"])
    assert tuple(res["videos"].shape) == (1, 1, FRAMES, SIZE, SIZE) and bool(torch.isfinite(res["videos"]).all())
    img = Image.open(res["paths"][0])
    assert img.n_frames == FRAMES and img.size == (SIZE, SIZE)


def test_config_long_clip_builds_a_trainer(tmp_path):
    """configs/config_long_clip.yaml through ``load_config`` and ``build_trainer``: full width, 128 frames,
    ``remat_blocks`` and both fused flags on. Only the dataset, the output folders and the frozen
    schedule buffers (the one mode the port's trainer has) are set beside it."""
    from pathlib import Path

    config = load_config(Path(__file__).resolve().parent.parent / "configs" / "config_long_clip.yaml")
    assert config["unet"]["remat_blocks"] and config["diffusion"]["num_frames"] == 128
    data = tmp_path / "clips.npy"
    np.save(data, np.zeros((128, 2, 64, 64), np.uint8))
    config["trainer"].update(dataset_path=str(data), results_folder=str(tmp_path / "r"),
                             tensorboard_dir=str(tmp_path / "tb"), freeze_schedule_buffers=True)
    unet, diffusion, trainer = build_trainer(config, device="cpu")
    assert unet.remat_blocks and unet.use_fused_attention and unet.use_fused_spatial_attention
    assert diffusion.num_frames == 128 and trainer.batch_size == 1 and trainer.max_grad_norm == 1.0
    assert trainer.train_num_steps == 100000  # the recipe's default save_and_sample_every asks for no sample
    assert trainer.lr_schedule(20000) == 1e-4 and abs(trainer.lr_schedule(100000) - 1e-5) < 1e-12
    assert tuple(next(trainer.dl).shape) == (1, 1, 128, 64, 64)
