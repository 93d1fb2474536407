"""The port's CLIs end to end on the CPU at a tiny config: sampling (DDPM, DDIM, DPM), extension and
infill, interpolation, and the sampling server with its throughput bench; then a text-conditioned
recipe trained from a captioned GIF folder, sampled and extended with ``--text`` and ``--cond-scale``."""

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_helpers  # noqa: F401  (caps torch threads)
from video_diffusion_nnx_tpu_torch import sample
from video_diffusion_nnx_tpu_torch.config import build_models, load_config
from video_diffusion_nnx_tpu_torch.convert import save_checkpoint

CONFIG = {
    "unet": {"dim": 8, "dim_mults": [1, 2], "channels": 1, "rngs_seed": 3,
             "use_fused_attention": True, "use_fused_spatial_attention": True},
    "diffusion": {"image_size": 16, "num_frames": 4, "timesteps": 6, "channels": 1,
                  "prediction_type": "v"},
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(CONFIG))
    _, diffusion = build_models(load_config(cfg), device="cpu")
    ckpt = save_checkpoint(root / "ckpt.pt", diffusion,
                           ema_state={k: v * 0.5 for k, v in diffusion.state_dict().items()})
    return root, cfg, ckpt


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_cli_writes_gifs(setup, sampler):
    root, cfg, ckpt = setup
    out = root / f"out_{sampler}"
    result = sample.main([
        "--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path", str(out),
        "--batch-size", "2", "--sampler", sampler, "--num-steps", "3", "--device", "cpu",
        "--load-ema-params", "--seed", "1",
    ])
    assert result["steps"] == (6 if sampler == "ddpm" else 3)
    assert result["graph"] == {"captures": 0, "replays": 0}  # graphs are for CUDA tensors
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
    img = Image.open(out / "sample_0.gif")
    assert img.n_frames == 4 and img.size == (16, 16)
    frames = []
    for i in range(4):
        img.seek(i)
        frames.append(np.asarray(img.convert("L")))
    assert np.ptp(np.stack(frames)) > 0


@pytest.mark.parametrize("flags,item", [(["--text", "a digit"], "unconditional; remove --text")])
def test_cli_refuses_unported_flags(setup, flags, item):
    root, cfg, ckpt = setup
    with pytest.raises(SystemExit, match=item):
        sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--device", "cpu", *flags])


def test_cli_missing_checkpoint_and_missing_card(setup):
    root, cfg, _ = setup
    with pytest.raises(SystemExit, match="no checkpoint file"):
        sample.main(["--config", str(cfg), "--checkpoint-path", str(root / "none.pt"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sample.main(["--config", str(cfg), "--checkpoint-path", str(root / "none.pt")])


def _write_clip(path, frames: int = 3):
    """A (f, h, w) uint8 clip in [0, 255], as scripts/extend.py reads a .npy."""
    clip = np.random.default_rng(4).integers(0, 256, size=(frames, 16, 16), dtype=np.uint8)
    np.save(path, clip)
    return clip


@pytest.mark.parametrize("flags", [["--keep-frames", "2", "--num-steps", "3", "--recon-guidance", "2"],
                                   ["--regen-frames", "1:3"],
                                   ["--keep-frames", "3", "--num-steps", "2", "--grid", "stride"]])
def test_extend_cli_pins_the_kept_frames(setup, flags):
    from video_diffusion_nnx_tpu_torch import extend

    root, cfg, ckpt = setup
    clip = _write_clip(root / "clip.npy")
    out = root / f"ext_{flags[1]}"
    result = extend.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--input", str(root / "clip.npy"),
                          "--output-path", str(out), "--batch-size", "2", "--device", "cpu", *flags])
    videos, mask = result["videos"], result["mask"]
    assert tuple(videos.shape) == (2, 1, 4, 16, 16)
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
    known = torch.from_numpy(result["known"])
    assert mask.sum() >= 1 and torch.equal(videos[:, :, mask], ((known * 2 - 1 + 1) * 0.5)[None, :, mask].expand(2, -1, -1, -1, -1))
    np.testing.assert_allclose(result["known"][0, :3], clip / 255.0, atol=1e-7)  # padded from 3 frames to 4


def test_extend_cli_gif_input_and_refusals(setup):
    from video_diffusion_nnx_tpu_torch import extend
    from video_diffusion_nnx_tpu_torch.utils.media import video_array_to_gif

    root, cfg, ckpt = setup
    video_array_to_gif(np.random.default_rng(5).integers(0, 256, size=(4, 32, 32, 1), dtype=np.uint8),
                       root / "clip.gif")
    clip, frames = extend.load_clip(root / "clip.gif", 16, 1, 4)
    assert clip.shape == (1, 4, 16, 16) and frames == 4 and 0.0 <= clip.min() and clip.max() <= 1.0
    base = ["--config", str(cfg), "--checkpoint-path", str(ckpt), "--input", str(root / "clip.gif"), "--device", "cpu"]
    for flags, match in ((["--keep-frames", "4"], "keep-frames must be"), (["--regen-frames", "0:4"], "covers every"),
                         (["--regen-frames", "x"], "A:B"), (["--keep-frames", "1", "--text", "a"], "unconditional; remove --text"),
                         (["--keep-frames", "1", "--recon-guidance", "1"], "needs the DDIM path")):
        with pytest.raises(SystemExit, match=match):
            extend.main([*base, *flags])


def test_interpolate_cli_writes_blends(setup):
    from video_diffusion_nnx_tpu_torch import interpolate

    root, cfg, ckpt = setup
    data = np.random.default_rng(6).integers(0, 256, size=(5, 3, 16, 16), dtype=np.uint8)  # (F, B, H, W)
    np.save(root / "mnist.npy", data)
    out = root / "interp"
    result = interpolate.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--dataset",
                               str(root / "mnist.npy"), "--index-b", "2", "--lam", "0.25", "--lam", "0.75",
                               "--t", "3", "--output-path", str(out), "--device", "cpu"])
    assert result["names"] == ["endpoint_a", "endpoint_b", "interp_0.25", "interp_0.75"]
    assert sorted(p.name for p in out.iterdir()) == sorted(f"{n}.gif" for n in result["names"])
    assert tuple(result["clips"].shape) == (4, 1, 4, 16, 16) and bool(torch.isfinite(result["clips"]).all())
    # The endpoints are the raw dataset clips mapped to [-1, 1] (the tiny config does not normalize).
    np.testing.assert_allclose(result["clips"][0, 0].numpy(), data[:4, 0] * 2.0 - 1.0)
    with pytest.raises(SystemExit, match="lambda"):
        interpolate.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--dataset",
                          str(root / "mnist.npy"), "--lam", "2", "--device", "cpu"])


def test_serve_cli_and_bench_drain(setup):
    """The server as the CLI builds it (checkpoint, --warmup, port 0), then the bench's drain against it."""
    import threading

    from video_diffusion_nnx_tpu_torch import bench_serve, serve

    root, cfg, ckpt = setup
    httpd = serve.build(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--load-ema-params",
                         "--port", "0", "--warmup", "--batch-window", "0.3", "--device", "cpu"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://%s:%d" % httpd.server_address[:2]
        wall, outs = bench_serve.drain(url, 3, num_steps=2)
        assert wall > 0 and len(outs) == 3
        assert max(o["coalesced"] for o in outs) >= 2
        assert all(o["shape"] == [1, 1, 4, 16, 16] for o in outs)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    with pytest.raises(SystemExit, match="no checkpoint file"):
        serve.build(["--config", str(cfg), "--checkpoint-path", str(root / "none.pt"), "--device", "cpu"])


def test_bench_serve_compares_in_process_servers(setup):
    from video_diffusion_nnx_tpu_torch import bench_serve

    _, cfg, _ = setup
    result = bench_serve.main(["--requests", "2", "--num-steps", "2", "--batch-window", "0.2",
                               "--config", str(cfg), "--device", "cpu"])
    assert result["batched_n2_max_group"] == 2 and result["serial_n2_max_group"] == 1
    assert result["speedup_n2"] > 0


@pytest.mark.parametrize("module", ["extend", "interpolate", "serve", "bench_serve"])
def test_new_entry_points_default_to_cuda(setup, module):
    import importlib

    root, cfg, ckpt = setup
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is usable")
    mod = importlib.import_module(f"video_diffusion_nnx_tpu_torch.{module}")
    argv = {"extend": ["--input", str(root / "clip.npy"), "--keep-frames", "1"],
            "interpolate": ["--dataset", str(root / "mnist.npy")], "serve": [], "bench_serve": []}[module]
    common = ["--config", str(cfg)] + ([] if module == "bench_serve" else ["--checkpoint-path", str(ckpt)])
    run = mod.build if module == "serve" else mod.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run([*common, *argv])


COND_CONFIG = {
    "unet": {"dim": 8, "dim_mults": [1, 2], "channels": 1, "rngs_seed": 3, "use_bert_text_cond": True,
             "use_fused_attention": True, "use_fused_spatial_attention": True},
    "diffusion": {"image_size": 16, "num_frames": 4, "timesteps": 6, "channels": 1, "prediction_type": "v"},
    "trainer": {"train_batch_size": 2, "train_num_steps": 2, "checkpoint_every_steps": 2, "step_start_ema": 0,
                "update_ema_every": 1, "profile_flush_step": 0, "use_path_as_cond": True, "null_cond_prob": 0.5,
                "freeze_schedule_buffers": True},
}


@pytest.fixture(scope="module")
def cond_setup(tmp_path_factory):
    """The conditioned recipe trained 2 steps by the train CLI from six captioned GIFs (the hashed embedding)."""
    from video_diffusion_nnx_tpu_torch import train
    from video_diffusion_nnx_tpu_torch.models import text
    from video_diffusion_nnx_tpu_torch.utils.media import video_array_to_gif

    patch = pytest.MonkeyPatch()
    patch.setattr(text, "_hf", False)
    root = tmp_path_factory.mktemp("cond_cli")
    (root / "gifs").mkdir()
    rng = np.random.default_rng(8)
    for i, caption in enumerate(["one digit", "two digits", "three digits"] * 2):
        video_array_to_gif(rng.integers(0, 256, size=(4, 16, 16, 1), dtype=np.uint8), root / "gifs" / f"{caption} {i}.gif")
    trainer = {**COND_CONFIG["trainer"], "dataset_path": str(root / "gifs"), "results_folder": str(root / "results"),
               "tensorboard_dir": str(root / "tb")}
    path = root / "cond.yaml"
    path.write_text(yaml.safe_dump({**COND_CONFIG, "trainer": trainer}))
    trainer = train.main(["--config", str(path), "--device", "cpu"])
    assert trainer.use_path_as_cond and trainer.model.denoise_fn.has_cond
    yield root, path, trainer.checkpoint_path(2)
    patch.undo()


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_text_cli_samples_each_sampler(cond_setup, sampler):
    """``--text`` (one prompt, repeated to the batch) and ``--cond-scale`` through each sampler; the DDIM CLI equals
    ``ddim_sample`` from the same seed and prompts."""
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint

    root, cfg, ckpt = cond_setup
    out = root / f"text_{sampler}"
    result = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path", str(out),
                          "--batch-size", "2", "--sampler", sampler, "--num-steps", "3", "--device", "cpu",
                          "--seed", "1", "--text", "two digits", "--cond-scale", "3", "--load-ema-params"])
    assert tuple(result["videos"].shape) == (2, 1, 4, 16, 16) and bool(torch.isfinite(result["videos"]).all())
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
    if sampler == "ddim":
        _, diffusion = build_models(load_config(cfg), device="cpu")
        load_checkpoint(diffusion, ckpt, load_ema_params=True)
        want = diffusion.eval().ddim_sample(num_steps=3, generator=torch.Generator().manual_seed(1),
                                            cond=["two digits"] * 2, cond_scale=3.0)
        torch.testing.assert_close(result["videos"], want, rtol=0, atol=0)
        other = sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--output-path", str(out),
                             "--batch-size", "2", "--sampler", "ddim", "--num-steps", "3", "--device", "cpu",
                             "--seed", "1", "--text", "one digit", "--text", "three digits", "--cond-scale", "3",
                             "--load-ema-params"])
        assert not torch.equal(other["videos"], result["videos"])


def test_text_cli_refusals(cond_setup):
    from video_diffusion_nnx_tpu_torch import extend

    root, cfg, ckpt = cond_setup
    with pytest.raises(SystemExit, match="this model is conditioned; give --text"):
        sample.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--device", "cpu", "--sampler", "ddim",
                     "--num-steps", "2"])
    np.save(root / "clip.npy", np.random.default_rng(4).integers(0, 256, size=(4, 16, 16), dtype=np.uint8))
    with pytest.raises(SystemExit, match="--text given 3 times but --batch-size is 2"):
        extend.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--input", str(root / "clip.npy"),
                     "--keep-frames", "2", "--num-steps", "2", "--batch-size", "2", "--device", "cpu",
                     "--text", "a", "--text", "b", "--text", "c"])


def test_extend_cli_with_text_and_guidance(cond_setup):
    from video_diffusion_nnx_tpu_torch import extend

    root, cfg, ckpt = cond_setup
    gif = sorted((root / "gifs").glob("three digits *.gif"))[0]
    out = root / "ext_text"
    result = extend.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--input", str(gif),
                          "--keep-frames", "2", "--num-steps", "3", "--recon-guidance", "2", "--batch-size", "2",
                          "--text", "three digits", "--cond-scale", "3", "--output-path", str(out), "--device", "cpu"])
    videos, known = result["videos"], torch.from_numpy(result["known"])
    assert tuple(videos.shape) == (2, 1, 4, 16, 16) and bool(torch.isfinite(videos).all())
    assert torch.equal(videos[:, :, :2], ((known * 2 - 1 + 1) * 0.5)[None, :, :2].expand(2, -1, -1, -1, -1))
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.gif", "sample_1.gif"]
