"""The port's flagship eval against scripts/eval_bouncing_digits.py and the JAX package.

The metrics and the loss-curve reader equal the script's functions exactly;
``reconstruct`` holds against a JAX re-statement of the script's ``make_recon``
loop at the fixture recipe (v-prediction, float32) with the same injected
noise at atol 5e-5, the Unet-level float32 tolerance; ``check`` passes the JAX
run's stats and raises each of its five messages; ``evaluate`` runs end to end
on the CPU at a tiny recipe.
"""

import copy
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, jax_fixture_model, port_model
from video_diffusion_nnx_tpu_torch import eval_bouncing_digits as ev

REPO = Path(__file__).resolve().parent.parent
JAX_STATS = REPO / "examples" / "bouncing_digits" / "stats.json"


def _script():
    spec = importlib.util.spec_from_file_location("eval_bouncing_digits", REPO / "scripts" / "eval_bouncing_digits.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_script(seed):
    script = _script()
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, 6, 16, 16)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    assert ev.psnr(a, b) == script.psnr(a, b)
    assert ev.ssim(a, b) == script.ssim(a, b)
    assert ev.autocorr_stats(a) == script.autocorr_stats(a)
    assert ev.autocorr_stats((a > 0.9).astype(np.float32)) == script.autocorr_stats((a > 0.9).astype(np.float32))


@pytest.mark.parametrize("tag", ["loss/train", "loss"])
def test_extract_loss_curve_equals_the_script(tmp_path, tag):
    from video_diffusion_nnx_tpu_torch.training.metrics import JsonlSummaryWriter

    w = JsonlSummaryWriter(str(tmp_path))
    for step in range(0, 200, 50):
        w.add_scalar("step_time", 0.1, step)
        w.add_scalar(tag, 1.0 / (step + 1), step)
        w.add_scalar("lr/train", 1e-4, step)
    w.close()
    got = ev.extract_loss_curve(tmp_path)
    assert got == _script().extract_loss_curve(tmp_path)
    assert got == [(s, 1.0 / (s + 1)) for s in range(0, 200, 50)]
    assert ev.extract_loss_curve(tmp_path / "missing") == []


def _jax_recon(model, x0, t_start, noise, n_steps=25):
    """The script's make_recon loop (scripts/eval_bouncing_digits.py:204-242) with q_sample's noise injected."""
    from einops import rearrange
    from flax import nnx

    from video_diffusion_nnx_tpu.utils.image import normalize_img, unnormalize_img

    graphdef, state = nnx.split(model)
    times = np.unique(np.linspace(0, t_start, n_steps).astype(np.int32))[::-1]
    times_prev = np.concatenate([times[1:], [-1]]).astype(np.int32)

    @jax.jit
    def recon(state, x0, noise):
        m = nnx.merge(graphdef, state)
        xn = normalize_img(x0)
        b = x0.shape[0]
        img = m.q_sample(xn, t=jnp.full((b,), t_start, jnp.int32), noise=noise)
        acp = m.alphas_cumprod[...]

        def body(img, tt):
            t, t_prev = tt
            t_arr = jnp.full((b,), t, jnp.int32)
            out = m.denoise_fn.forward_with_cond_scale(img, t_arr)
            out = rearrange(out, "b f h w c -> b c f h w")
            x0_hat, _ = m._model_out_to_x0_eps(img, t_arr, out)
            x0_hat = jnp.clip(x0_hat, -1.0, 1.0)
            a_t = acp[t]
            a_prev = jnp.where(t_prev >= 0, acp[jnp.maximum(t_prev, 0)], 1.0)
            eps_hat = (img - jnp.sqrt(a_t) * x0_hat) / jnp.sqrt(1.0 - a_t)
            img = jnp.sqrt(a_prev) * x0_hat + jnp.sqrt(jnp.maximum(1.0 - a_prev, 0.0)) * eps_hat
            return img, None

        img, _ = jax.lax.scan(body, img, (jnp.asarray(np.ascontiguousarray(times)),
                                          jnp.asarray(np.ascontiguousarray(times_prev))))
        return unnormalize_img(img)

    return np.asarray(recon(state, jnp.asarray(x0), jnp.asarray(noise)))


@pytest.fixture(scope="module")
def v_models():
    jm = jax_fixture_model(prediction_type="v")
    return jm, port_model(jm, prediction_type="v")


@pytest.mark.parametrize("t_start", [2, 5, 9])
def test_reconstruct_matches_jax_loop(v_models, t_start):
    jm, pm = v_models
    rng = np.random.default_rng(t_start)
    shape = (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
    x0 = rng.uniform(0, 1, shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    want = _jax_recon(jm, x0, t_start, noise)
    got = ev.reconstruct(pm, torch.from_numpy(x0), t_start, torch.from_numpy(noise))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    assert ev.recon_times(t_start) == list(range(t_start, -1, -1))  # T = 10: every step below t_start


def test_check_passes_the_jax_run():
    ev.check(json.loads(JAX_STATS.read_text()))


def _broken(stats: dict, which: str) -> dict:
    s = copy.deepcopy(stats)
    if which == "loss":
        s["loss_last"] = 0.3 * s["loss_first"]
    elif which == "gap":
        s["generalization_gap"] = 0.5 * s["eval_loss_train"] + 0.03
    elif which == "recon":
        s["recon_psnr_T_4"] = s["recon_psnr_T_4_untrained"] + 2.9
    elif which == "noise":
        s["samples_ddim50"]["spatial_autocorr"] = 0.05
    else:
        s["samples_ddim50"]["active_pixel_frac"] = 0.9997
    return s


@pytest.mark.parametrize("which, message", [
    ("loss", "training loss did not drop by 4x"),
    ("gap", "holdout loss far above train loss — memorization or broken eval"),
    ("recon", "reconstruction no better than the untrained floor"),
    ("noise", "generated samples are noise-like (spatial autocorr 0.05); schedule buffers drifted?"),
    ("bright", "generated active-pixel fraction 0.9997 far from data 0.0506"),
])
def test_check_raises_each_claim(which, message):
    with pytest.raises(AssertionError) as info:
        ev.check(_broken(json.loads(JAX_STATS.read_text()), which))
    assert str(info.value) == message


def _tiny_recipe(tmp_path: Path) -> tuple[Path, Path, Path, Path]:
    """A tiny v-prediction recipe at canvas 32 (two 16-wide attention heads, so DDIM-50 at batch 8 takes
    seconds), its data from the port's generator, a checkpoint of its seeded weights (as the EMA too) and a
    JSONL loss curve."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import save_checkpoint
    from video_diffusion_nnx_tpu_torch.data import bouncing_digits
    from video_diffusion_nnx_tpu_torch.training.metrics import JsonlSummaryWriter

    train, hold = tmp_path / "train.npy", tmp_path / "val.npy"
    bouncing_digits.main(["--out", str(train), "--holdout-out", str(hold), "--clips", "4", "--holdout-clips", "4",
                          "--frames", "6", "--canvas", "32"])
    cfg = {
        "unet": {"dim": 8, "dim_mults": [1, 2], "channels": 1, "attn_heads": 2, "attn_dim_head": 16},
        "diffusion": {"image_size": 32, "num_frames": 4, "timesteps": 100, "loss_type": "l2", "channels": 1,
                      "prediction_type": "v"},
        "trainer": {"dataset_path": str(train), "tensorboard_dir": str(tmp_path / "tb")},
    }
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(cfg))
    _, diffusion = build_models(load_config(config), device="cpu")
    save_checkpoint(tmp_path / "ckpt" / "step_3.pt", diffusion, ema_state=diffusion.state_dict(), step=3)
    w = JsonlSummaryWriter(str(tmp_path / "tb"))
    w.add_scalar("loss/train", 1.2, 0)
    w.add_scalar("loss/train", 0.2, 2)
    w.close()
    return config, tmp_path / "ckpt", train, hold


def test_evaluate_end_to_end_on_cpu(tmp_path):
    config, ckpt, train, hold = _tiny_recipe(tmp_path)
    out = tmp_path / "out"
    argv = ["--config", str(config), "--checkpoint-path", str(ckpt), "--step", "3", "--train", str(train),
            "--holdout", str(hold), "--out", str(out), "--eval-clips", "2", "--skip-ddpm", "--device", "cpu"]
    # The untrained floor has the checkpoint's own seeded weights, so the CLI's check fails on reconstruction,
    # after stats.json is written.
    with pytest.raises(AssertionError, match="reconstruction no better than the untrained floor"):
        ev.main(argv)
    stats = json.loads((out / "stats.json").read_text())
    want = json.loads(JAX_STATS.read_text())
    assert set(stats) == set(want)
    for key in ("samples_ddim50", "data_holdout"):
        assert set(stats[key]) == set(want[key])
    values = [v for k, v in stats.items() if k not in ("config", "samples_ddim50", "data_holdout")]
    values += [*stats["samples_ddim50"].values(), *stats["data_holdout"].values()]
    assert all(np.isfinite(v) for v in values)
    assert stats["recon_psnr_T_4"] == stats["recon_psnr_T_4_untrained"]
    assert (stats["loss_first"], stats["loss_last"]) == (1.2, 0.2)
    assert (out / "loss_curve.csv").read_text() == "step,loss\n0,1.200000\n2,0.200000\n"
    gifs = {p.stem: Image.open(p) for p in out.glob("*.gif")}
    sizes = {**{f"ddim50_sample_{i}": (32, 32) for i in range(4)}, **{f"recon_T4_pair_{i}": (64, 32) for i in range(2)}}
    assert set(gifs) == set(sizes)
    for name, img in gifs.items():
        assert img.size == sizes[name] and img.n_frames == 4, name


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.main(["--checkpoint-path", str(tmp_path), "--step", "1", "--out", str(tmp_path / "out")])
    assert ev.parse_args(["--checkpoint-path", "c", "--step", "1"]).out.endswith("examples/bouncing_digits_torch")
