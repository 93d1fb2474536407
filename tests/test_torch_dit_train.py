"""The port's VideoDiT through the trainer, the samplers, the CLIs and the server, on the CPU.

The recipe of tests/test_torch_dit.py (dim 32, depth 2, 2 heads of 16, 3 frames of 8x8, patch 4) inside a
``GaussianDiffusion`` (10 steps, l2, v-prediction), JAX weights converted with the adaLN perturbed (std 0.05)
and every bias drawn non-zero (std 0.1). Tolerances: three trainer steps as tests/test_torch_training.py holds
the Unet3D's (loss 5e-5, gradient norm 1e-4 relative, parameters and EMA 1e-4 of each tensor's largest
magnitude); DDIM and DPM with injected x_T 2e-4 (the float32 forward's 5e-5 compounded over the chain).
"""

import json
import threading
import urllib.request

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
from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu.utils import grad as jgrad
from video_diffusion_nnx_tpu.utils import image as jimage
from video_diffusion_nnx_tpu_torch import sample, serve, train
from video_diffusion_nnx_tpu_torch.config import build_models, load_config
from video_diffusion_nnx_tpu_torch.convert import load_checkpoint, read_checkpoint, state_dict_from_nnx, torch_key
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import VideoDiT, text
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

B, C, F, S = 2, 1, 3, 8
SHAPE = (B, C, F, S, S)
ARCH = dict(dim=32, depth=2, channels=C, attn_heads=2, attn_dim_head=16, patch_size=4)
DIFF = dict(image_size=S, num_frames=F, channels=C, timesteps=10, loss_type="l2", prediction_type="v")


def _perturbed_jax(seed: int = 0, **kw) -> JaxGaussianDiffusion:
    dit = JaxVideoDiT(rngs=nnx.Rngs(seed), **ARCH, **kw)
    rng = np.random.default_rng(seed + 50)
    for lin in [blk.ada for blk in dit.blocks] + [dit.final_ada, dit.final_proj]:
        lin.kernel[...] = jnp.asarray(rng.standard_normal(lin.kernel[...].shape).astype(np.float32) * 0.05)
    for path, var in nnx.to_flat_state(nnx.state(dit, nnx.Param)):
        if path[-1] == "bias":
            var.set_value(jnp.asarray(rng.standard_normal(var.get_value().shape) * 0.1, jnp.float32))
    return JaxGaussianDiffusion(dit, **DIFF)


def _port(jm, **kw) -> GaussianDiffusion:
    pm = GaussianDiffusion(VideoDiT(**ARCH, **kw), **DIFF)
    pm.load_state_dict(state_dict_from_nnx(flat_nnx_state(nnx.split(jm)[1]), pm))
    return pm


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "seq.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, size=(6, 10, S, S), dtype=np.uint8))
    return str(path)


@pytest.fixture(scope="module", params=[False, True], ids=["modules", "fused"])
def models(request):
    jm = _perturbed_jax(seed=1, use_fused_attention=request.param)
    return jm, _port(jm, use_fused_attention=request.param).eval()


def _trainer(model, npy_path, tmp_path, **kw):
    base = dict(dataset_path=npy_path, train_batch_size=B, results_folder=str(tmp_path / "results"),
                tensorboard_dir=str(tmp_path / "tb"), profile_flush_step=0, freeze_schedule_buffers=True,
                train_num_steps=3, num_frames=F, dataset_normalize=True)
    return Trainer(model, folder=str(tmp_path), **{**base, **kw})


def test_three_train_steps_match_jax(npy_path, tmp_path):
    """From identical converted weights, batches, t and noise: the JAX package's pieces (``p_losses``, the frozen
    buffers, ``clip_grad_norm``, ``optax.adam`` over the hold-then-cosine schedule, the gated EMA) against the
    port's Trainer, through the fused route."""
    lr, start, steps, coeff, max_norm, decay = 1e-4, 1, 2, 0.1, 1.0, 0.9
    jm = _perturbed_jax(seed=2, use_fused_attention=True)
    pm = _port(jm, use_fused_attention=True).train()
    init = {k: v.detach().clone().numpy() for k, v in pm.state_dict().items()}
    tr = _trainer(pm, npy_path, tmp_path, train_lr=lr, lr_decay_start_step=start, lr_decay_steps=steps,
                  lr_decay_coeff=coeff, max_grad_norm=max_norm, step_start_ema=1, update_ema_every=1,
                  ema_decay=decay)

    graphdef, params = nnx.split(jm)
    tx = optax.adam(optax.piecewise_interpolate_schedule(
        interpolate_type="cosine", init_value=lr, boundaries_and_scales={start: 1.0, start + steps: coeff}))
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)

    @jax.jit
    def loss_and_grads(params, x, t, noise):
        def loss_fn(p):
            return nnx.merge(graphdef, p).p_losses(jimage.normalize_img(x), t, jax.random.PRNGKey(0), noise=noise)

        return jax.value_and_grad(loss_fn)(params)

    rng = np.random.default_rng(7)
    for step in range(3):
        x = rng.uniform(size=SHAPE).astype(np.float32)
        t = rng.integers(0, 10, size=B).astype(np.int32)
        noise = seeded(SHAPE, 20 + step)
        loss, grads = loss_and_grads(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        g_params, g_rest = nnx.split_state(grads, nnx.Param, ...)
        grads = nnx.merge_state(g_params, jax.tree_util.tree_map(jnp.zeros_like, g_rest))
        j_grads = flat_nnx_state(g_params)
        grads, norm = jgrad.clip_grad_norm(grads, max_norm)
        updates, opt_state = tx.update(grads, opt_state, params)
        p_new, _ = nnx.split_state(optax.apply_updates(params, updates), nnx.Param, ...)
        _, rest_old = nnx.split_state(params, nnx.Param, ...)
        params = nnx.merge_state(p_new, rest_old)
        if step >= 1:
            ema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, ema, params)

        p_loss, p_norm = tr.train_step(torch.from_numpy(x), t=torch.from_numpy(t).long(),
                                       noise=torch.from_numpy(noise))
        tr.step += 1
        np.testing.assert_allclose(p_loss.item(), float(loss), atol=5e-5, rtol=0)
        np.testing.assert_allclose(p_norm.item(), float(norm), rtol=1e-4)

        # A key bias shifts a whole softmax row, so its gradient is zero up to rounding noise, which Adam's
        # normalisation turns into steps of up to lr: both sides stay within that.
        global_norm = np.sqrt(sum(np.square(g).sum() for g in j_grads.values()))
        noise_only = {torch_key(k) for k, g in j_grads.items() if np.sqrt(np.square(g).sum()) <= 1e-6 * global_norm}
        assert noise_only and all(k.endswith(".k.bias") for k in noise_only), noise_only
        for name, tree, got in (("param", params, pm.state_dict()), ("ema", ema, tr.ema_state)):
            want = state_dict_from_nnx(flat_nnx_state(tree), pm)
            for k, w in want.items():
                g = got[k].detach().numpy()
                if k in noise_only:
                    bound = 4 * lr * (step + 1)
                    assert np.abs(g - init[k]).max() <= bound and np.abs(w.numpy() - init[k]).max() <= bound
                    continue
                tol = 1e-4 * max(np.abs(w.numpy()).max(), 1e-12)
                np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=0, err_msg=f"{name} {k} step {step}")


def test_loss_falls_and_checkpoints_round_trip(npy_path, tmp_path):
    """Ten steps at lr 1e-3 lower the loss; the step file holds the model and the EMA, each loading into a fresh
    model bit for bit."""
    pm = GaussianDiffusion(VideoDiT(**ARCH, use_fused_attention=True), **DIFF)
    pm.denoise_fn.reset_parameters(torch.Generator().manual_seed(0))
    tr = _trainer(pm, npy_path, tmp_path, train_lr=1e-3, train_num_steps=10, checkpoint_every_steps=5,
                  step_start_ema=0, update_ema_every=1, ema_decay=0.5)
    tr.train()
    losses = tr.loss_trace.tolist()
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    payload = read_checkpoint(tr.checkpoint_path(10))
    assert payload["step"] == 10 and payload["ema_params"] is not None
    for ema, state in ((False, pm.state_dict()), (True, tr.ema_state)):
        fresh = GaussianDiffusion(VideoDiT(**ARCH), **DIFF)
        load_checkpoint(fresh, tr.checkpoint_path(10), load_ema_params=ema)
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, state[k].detach(), rtol=0, atol=0, msg=k)
    assert not torch.equal(tr.ema_state["denoise_fn.final_proj.weight"], pm.state_dict()["denoise_fn.final_proj.weight"])


def test_sequence_parallelism_refuses_a_dit(npy_path, tmp_path):
    pm = GaussianDiffusion(VideoDiT(**ARCH), **DIFF)
    with pytest.raises(ValueError, match="needs a reference_compat denoiser"):
        _trainer(pm, npy_path, tmp_path, sequence_parallel_size=4,
                 sequence_group=SequenceGroup(0, 4, "gloo", torch.device("cpu")))


@pytest.mark.parametrize("num_steps", [3, 5])
def test_ddim_with_injected_noise_matches_jax(models, num_steps):
    jm, pm = models
    x_T = seeded(SHAPE, 5)
    want = jm.ddim_sample(jax.random.PRNGKey(0), batch_size=B, num_steps=num_steps, init_noise=jnp.asarray(x_T))
    got = pm.ddim_sample(batch_size=B, num_steps=num_steps, init_noise=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("num_steps", [3, 5])
def test_dpm_with_injected_noise_matches_jax(models, num_steps):
    jm, pm = models
    x_T = seeded(SHAPE, 6)
    want = jm.dpm_solver_sample(jax.random.PRNGKey(0), batch_size=B, num_steps=num_steps,
                                init_noise=jnp.asarray(x_T))
    got = pm.dpm_solver_sample(batch_size=B, num_steps=num_steps, init_noise=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_guided_ddim_with_text_matches_jax(monkeypatch):
    """A caption-conditioned DiT (hashed embeddings on both sides) sampled at cond_scale 3: one 2b-row forward a
    step on either side."""
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)
    jm = _perturbed_jax(seed=3, use_bert_text_cond=True)
    pm = _port(jm, use_bert_text_cond=True).eval()
    x_T, captions = seeded(SHAPE, 7), ["two digits", "one digit"]
    want = jm.ddim_sample(jax.random.PRNGKey(0), cond=captions, cond_scale=3.0, batch_size=B, num_steps=3,
                          init_noise=jnp.asarray(x_T))
    got = pm.ddim_sample(batch_size=B, num_steps=3, init_noise=torch.from_numpy(x_T), cond=captions, cond_scale=3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_conditional_frames_run():
    """Replacement conditioning with reconstruction guidance (a backward through the DiT) keeps the known frame."""
    pm = GaussianDiffusion(VideoDiT(**ARCH, use_fused_attention=True), **DIFF).eval()
    pm.denoise_fn.reset_parameters(torch.Generator().manual_seed(1))
    known = torch.full(SHAPE, 0.5)
    mask = torch.tensor([True, False, False])
    out = pm.sample_conditional_frames(known, mask, num_steps=3, recon_guidance_weight=2.0,
                                       generator=torch.Generator().manual_seed(2))
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[:, :, 0], known[:, :, 0], rtol=0, atol=1e-6)


CONFIG = {
    "unet": {"arch": "dit", **ARCH, "rngs_seed": 3, "use_fused_attention": True, "compute_dtype": "bfloat16"},
    "diffusion": {k: v for k, v in DIFF.items()},
    "trainer": {"train_batch_size": B, "train_num_steps": 4, "checkpoint_every_steps": 2, "step_start_ema": 0,
                "update_ema_every": 1, "profile_flush_step": 0, "num_frames": F, "train_lr": 1e-3,
                "dataset_normalize": True},
}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, npy_path):
    root = tmp_path_factory.mktemp("dit_cli")
    trainer_cfg = {**CONFIG["trainer"], "dataset_path": npy_path, "results_folder": str(root / "results"),
                   "tensorboard_dir": str(root / "tb")}
    cfg = root / "dit.yaml"
    cfg.write_text(yaml.safe_dump({**CONFIG, "trainer": trainer_cfg}))
    trainer = train.main(["--config", str(cfg), "--device", "cpu"])
    return root, cfg, trainer


def test_train_cli_trains_and_resumes(cli_run):
    root, cfg, trainer = cli_run
    assert isinstance(trainer.model.denoise_fn, VideoDiT) and trainer.step == 4
    assert [p.name for p in sorted(trainer.checkpoint_path(2).parent.glob("step_*.pt"))] == ["step_2.pt", "step_4.pt"]
    resumed = train.main(["--config", str(cfg), "--device", "cpu", "--resume_step", "2"])
    assert resumed.step == 4 and np.isfinite(resumed.loss_trace[2:].tolist()).all()


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_sample_cli_writes_gifs(cli_run, sampler):
    root, cfg, trainer = cli_run
    out = root / f"out_{sampler}"
    ckpt = trainer.checkpoint_path(4)
    result = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path", str(out),
                          "--batch-size", "2", "--sampler", sampler, "--num-steps", "3", "--device", "cpu",
                          "--load-ema-params", "--seed", "1"])
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
    img = Image.open(out / "sample_0.gif")
    assert img.n_frames == F and img.size == (S, S)
    if sampler == "ddim":
        _, diffusion = build_models(load_config(cfg), device="cpu")
        load_checkpoint(diffusion, ckpt, load_ema_params=True)
        want = diffusion.eval().ddim_sample(batch_size=2, num_steps=3, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(result["videos"], want, rtol=0, atol=0)


def test_server_reports_has_cond_and_serves(cli_run, monkeypatch):
    """/health of an unconditioned and a caption-conditioned DiT, and a DDIM request from each (text for the
    conditioned one)."""
    monkeypatch.setattr(text, "_hf", False)
    root, cfg, trainer = cli_run
    cond = GaussianDiffusion(VideoDiT(**ARCH, use_bert_text_cond=True), **DIFF).eval()
    cond.denoise_fn.reset_parameters(torch.Generator().manual_seed(4))
    for model, has_cond in ((trainer.model.eval(), False), (cond, True)):
        httpd = serve.create_server(model, host="127.0.0.1", port=0, batch_window_s=0.01)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://%s:%d" % httpd.server_address[:2]
        try:
            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                health = json.loads(r.read())["model"]
            assert health["has_cond"] is has_cond and health["guidance_embed"] is False
            body = {"batch_size": 1, "sampler": "ddim", "num_steps": 2, "seed": 3}
            if has_cond:
                body.update(text=["two digits"], cond_scale=3.0)
            req = urllib.request.Request(url + "/sample", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["shape"] == [1, C, F, S, S] and len(out["gifs"]) == 1
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)


def test_extend_cli_keeps_the_given_frame(cli_run):
    """The extension CLI with reconstruction guidance (a backward through the DiT a step) pins the kept frame."""
    from video_diffusion_nnx_tpu_torch import extend

    root, cfg, trainer = cli_run
    np.save(root / "clip.npy", np.random.default_rng(4).integers(0, 256, size=(F, S, S), dtype=np.uint8))
    out = root / "extended"
    result = extend.main(["--config", str(cfg), "--checkpoint-path", str(trainer.checkpoint_path(4)), "--input",
                          str(root / "clip.npy"), "--output-path", str(out), "--batch-size", "2", "--device", "cpu",
                          "--keep-frames", "1", "--num-steps", "2", "--recon-guidance", "2"])
    videos, known = result["videos"], torch.from_numpy(result["known"])
    assert tuple(videos.shape) == (2, C, F, S, S) and bool(torch.isfinite(videos).all())
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
    assert torch.equal(videos[:, :, :1], ((known * 2 - 1 + 1) * 0.5)[None, :, :1].expand(2, -1, -1, -1, -1))
