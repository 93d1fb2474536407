"""The distillation CLIs and the distilled eval end to end on the CPU at a tiny config (a dim-8 Unet3D, 4 frames of
16x16, T = 32, v-prediction, both fused flags: their plain versions here): ``distill`` over a Moving-MNIST ``.npy``,
each round's file sampled by the sampling CLI on the stride grid; ``distill_guidance`` over a captioned GIF folder
(hashed caption embeddings), its file sampled through ``config_guidance.yaml`` with one forward of b rows a step, then
stage 2 through ``distill``; the refusals of the JAX CLIs; and ``eval_bouncing_digits_distilled`` with its two
assertions."""

import json

import numpy as np
import pytest
import torch
import yaml

import torch_port_helpers  # noqa: F401  (caps torch threads)
from video_diffusion_nnx_tpu_torch import distill, distill_guidance, eval_bouncing_digits_distilled, sample
from video_diffusion_nnx_tpu_torch.config import build_models, load_config
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint, save_checkpoint
from video_diffusion_nnx_tpu_torch.models import Unet3D, text
from video_diffusion_nnx_tpu_torch.utils.media import video_array_to_gif

UNET = {"dim": 8, "dim_mults": [1, 2], "channels": 1, "rngs_seed": 3, "use_fused_attention": True,
        "use_fused_spatial_attention": True}
DIFFUSION = {"image_size": 16, "num_frames": 4, "timesteps": 32, "channels": 1, "prediction_type": "v",
             "loss_type": "l2"}


def _config(root, name, dataset, **unet):
    cfg = {"unet": {**UNET, **unet}, "diffusion": DIFFUSION,
           "trainer": {"dataset_path": str(dataset), "train_batch_size": 2, "dataset_normalize": True}}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _teacher(root, cfg, name, step=7):
    _, diffusion = build_models(load_config(cfg), device="cpu")
    return save_checkpoint(root / name / f"step_{step}.pt", diffusion,
                           ema_state={k: v * 0.9 for k, v in diffusion.state_dict().items()}, step=step)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill_cli")
    np.save(root / "clips.npy", np.random.default_rng(0).integers(0, 256, size=(4, 6, 16, 16), dtype=np.uint8))
    cfg = _config(root, "tiny", root / "clips.npy")
    return root, cfg, _teacher(root, cfg, "teacher")


@pytest.fixture
def hashed(monkeypatch):
    monkeypatch.setattr(text, "_hf", False)


def test_distill_cli_rounds_write_students_that_sample(setup):
    root, cfg, ckpt = setup
    out = root / "distilled"
    res = distill.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--step", "7", "--initial-steps", "4",
                        "--rounds", "2", "--steps-per-round", "3", "--ema-decay", "0.9", "--lr", "1e-3",
                        "--output-path", str(out), "--device", "cpu"])
    assert res["final_steps"] == 2 and sorted(res["paths"]) == [2, 4] and not res["conditioned"]
    assert [r["student_steps"] for r in res["rounds"]] == [4, 2]
    assert all(r["steps"] == 3 and all(np.isfinite(r["losses"])) for r in res["rounds"])
    teacher_ema = read_checkpoint(ckpt)["ema_params"]
    for n, path in res["paths"].items():
        payload = read_checkpoint(path)
        assert path == out / f"step_{n}.pt" and payload["step"] == n
        assert all(torch.equal(payload["model"][k], v) for k, v in payload["ema_params"].items())
        assert any(not torch.equal(payload["model"][k], v) for k, v in teacher_ema.items())
    s = sample.main(["--config", str(cfg), "--checkpoint-path", str(res["paths"][2]), "--output-path",
                     str(root / "out2"), "--batch-size", "2", "--sampler", "ddim", "--num-steps", "2", "--grid",
                     "stride", "--device", "cpu"])
    assert s["steps"] == 2 and tuple(s["videos"].shape) == (2, 1, 4, 16, 16) and bool(torch.isfinite(s["videos"]).all())


def test_distill_cli_refusals(setup):
    root, cfg, ckpt = setup
    base = ["--config", str(cfg), "--device", "cpu", "--initial-steps", "2", "--rounds", "1", "--steps-per-round", "1"]
    cases = [
        (["--checkpoint-path", str(root / "none.pt")], "no checkpoint file"),
        (["--checkpoint-path", str(ckpt), "--step", "8"], "holds step 7, not 8"),
        (["--checkpoint-path", str(ckpt), "--batch-size", "7"], "dataset has 6 clips < batch size 7"),
    ]
    no_ema = save_checkpoint(root / "raw" / "step_1.pt", build_models(load_config(cfg), device="cpu")[1], step=1)
    cases.append((["--checkpoint-path", str(no_ema)], "holds no EMA parameters; pass --no-ema"))
    for flags, match in cases:
        with pytest.raises(SystemExit, match=match):
            distill.main([*base, *flags])
    res = distill.main([*base, "--checkpoint-path", str(no_ema), "--no-ema", "--output-path", str(root / "raw_out")])
    assert sorted(res["paths"]) == [2]
    with pytest.raises(ValueError, match="needs timesteps >= 64"):
        distill.main([*base, "--checkpoint-path", str(ckpt), "--initial-steps", "32", "--output-path", str(root / "x")])


def _captioned_gifs(folder, per_class: int = 3):
    rng = np.random.default_rng(1)
    folder.mkdir(parents=True, exist_ok=True)
    for cls, level in (("bright square", 220), ("dark square", 30)):
        for i in range(per_class):
            clip = np.clip(level + rng.integers(-20, 20, size=(4, 16, 16, 1)), 0, 255).astype(np.uint8)
            video_array_to_gif(clip, folder / f"{cls} {i}.gif")
    return folder


@pytest.mark.usefixtures("hashed")
def test_guidance_cli_then_sample_and_stage2(setup):
    root = setup[0]
    gifs = _captioned_gifs(root / "gifs")
    cfg = _config(root, "cond", gifs, use_bert_text_cond=True)
    ckpt = _teacher(root, cfg, "cond_teacher", step=11)
    out = root / "guided"
    res = distill_guidance.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--num-steps", "3",
                                 "--w-min", "1", "--w-max", "4", "--lr", "1e-3", "--output-path", str(out),
                                 "--device", "cpu"])
    assert res["path"] == out / "step_11.pt" and res["steps"] == 3 and all(np.isfinite(res["losses"]))
    derived = yaml.safe_load(res["config"].read_text())
    assert derived["unet"]["guidance_embed"] is True
    assert {k: v for k, v in derived["unet"].items() if k != "guidance_embed"} == \
        {k: v for k, v in load_config(cfg)["unet"].items() if k != "guidance_embed"}
    payload = read_checkpoint(res["path"])
    assert any(k.startswith("denoise_fn.guidance_mlp.") for k in payload["model"])
    assert payload["model"]["denoise_fn.guidance_mlp.layers.3.weight"].abs().max() > 0  # trained off its zero init

    rows = []
    forward = Unet3D.forward

    def spy(self, x, *args, **kwargs):
        rows.append((x.shape[0], kwargs.get("guidance_scale") is not None))
        return forward(self, x, *args, **kwargs)

    Unet3D.forward = spy
    try:
        s = sample.main(["--config", str(res["config"]), "--checkpoint-path", str(res["path"]), "--output-path",
                         str(root / "out_g"), "--batch-size", "2", "--sampler", "ddim", "--num-steps", "3",
                         "--text", "bright square", "--cond-scale", "3", "--device", "cpu"])
    finally:
        Unet3D.forward = forward
    assert rows == [(2, True)] * 3 and tuple(s["videos"].shape) == (2, 1, 4, 16, 16)

    stage2 = distill.main(["--config", str(res["config"]), "--checkpoint-path", str(res["path"]), "--initial-steps",
                           "2", "--rounds", "1", "--steps-per-round", "2", "--w-min", "1", "--w-max", "4",
                           "--output-path", str(root / "stage2"), "--device", "cpu"])
    assert stage2["conditioned"] and stage2["w_range"] == (1.0, 4.0) and sorted(stage2["paths"]) == [2]
    s2 = sample.main(["--config", str(res["config"]), "--checkpoint-path", str(stage2["paths"][2]), "--output-path",
                      str(root / "out_s2"), "--batch-size", "2", "--sampler", "ddim", "--num-steps", "2", "--grid",
                      "stride", "--text", "dark square", "--cond-scale", "3", "--device", "cpu"])
    assert bool(torch.isfinite(s2["videos"]).all())


@pytest.mark.usefixtures("hashed")
def test_guidance_cli_refusals(setup):
    root, cfg, ckpt = setup
    with pytest.raises(SystemExit, match="unconditioned model"):
        distill_guidance.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--device", "cpu"])
    npy_cond = _config(root, "cond_npy", root / "clips.npy", use_bert_text_cond=True)
    ckpt2 = _teacher(root, npy_cond, "cond_npy_teacher")
    with pytest.raises(SystemExit, match="needs a caption-conditioned GIF folder"):
        distill_guidance.main(["--config", str(npy_cond), "--checkpoint-path", str(ckpt2), "--device", "cpu",
                               "--num-steps", "1"])
    # Stage 2 of a guidance_embed teacher over a .npy has no captions either.
    g_cfg = _config(root, "g_npy", root / "clips.npy", use_bert_text_cond=True, guidance_embed=True)
    with pytest.raises(SystemExit, match="needs a caption-conditioned GIF folder"):
        distill.main(["--config", str(g_cfg), "--checkpoint-path", str(_teacher(root, g_cfg, "g_teacher")),
                      "--device", "cpu", "--initial-steps", "2", "--rounds", "1", "--steps-per-round", "1"])


def test_eval_distilled_writes_the_jax_keys_and_asserts(setup, monkeypatch):
    """The eval at the tiny recipe: teacher-32, naive-4 and distilled-4 from the same x_T, the stats under the JAX
    file's keys, three pairs of GIFs; ``check`` passes and fails on the two claims, and the CLI always runs it."""
    root, cfg, ckpt = setup
    res = distill.main(["--config", str(cfg), "--checkpoint-path", str(ckpt), "--initial-steps", "4", "--rounds",
                        "1", "--steps-per-round", "2", "--output-path", str(root / "eval_student"), "--device", "cpu"])
    np.save(root / "holdout.npy", np.random.default_rng(2).integers(0, 256, size=(4, 5, 16, 16), dtype=np.uint8))
    out = root / "eval"
    stats = eval_bouncing_digits_distilled.evaluate(str(cfg), str(ckpt.parent), 7, str(root / "eval_student"), 4,
                                                    str(root / "holdout.npy"), str(out), batch=2, device="cpu")
    with open("examples/bouncing_digits_distilled/stats.json") as f:
        jax_keys = set(json.load(f))
    written = json.loads((out / "stats.json").read_text())
    assert set(written) == jax_keys and stats["seconds"] > 0 and res["paths"][4].is_file()
    tags = ("teacher32", "naive4", "distilled4")
    assert sorted(p.name for p in out.glob("*.gif")) == sorted(f"{tag}_{i}.gif" for tag in tags for i in (0, 1))
    good = {**written, "mse_naive_vs_teacher32": 0.2, "mse_distilled_vs_teacher32": 0.1,
            "samples_distilled": {**written["samples_distilled"], "spatial_autocorr": 0.8}}
    eval_bouncing_digits_distilled.check(good)
    with pytest.raises(AssertionError, match="must beat the naive 4-step teacher"):
        eval_bouncing_digits_distilled.check({**good, "mse_distilled_vs_teacher32": 0.3})
    with pytest.raises(AssertionError, match="noise-like"):
        eval_bouncing_digits_distilled.check({**good, "samples_distilled": {"spatial_autocorr": 0.1}})
    called = []
    monkeypatch.setattr(eval_bouncing_digits_distilled, "check", lambda s: called.append(s))
    eval_bouncing_digits_distilled.main(["--config", str(cfg), "--teacher-path", str(ckpt.parent), "--teacher-step",
                                         "7", "--student-path", str(root / "eval_student"), "--holdout",
                                         str(root / "holdout.npy"), "--out", str(root / "eval2"), "--batch", "2",
                                         "--device", "cpu"])
    assert len(called) == 1 and called[0]["mse_naive_vs_teacher32"] == stats["mse_naive_vs_teacher32"]
