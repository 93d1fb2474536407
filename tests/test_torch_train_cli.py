"""The port's training CLI end to end on the CPU at the fixture recipe, then its checkpoints.

Five steps with a checkpoint every two: files at steps 2, 4 and 5; a resume
from step 4 restores parameters, EMA and optimizer and continues; the
sampling CLI reads the step-5 file, with and without the EMA parameters.
"""

import logging
import math

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_helpers  # noqa: F401  (caps torch threads)
from torch_port_helpers import DIM, DIM_MULTS, FRAMES, IMAGE_SIZE, SEED, TIMESTEPS
from video_diffusion_nnx_tpu_torch import sample, train
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint


def _config(root, **trainer):
    data = root / "seq.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(6, 16, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    cfg = {
        "rng_seed": 0,
        "unet": {"dim": DIM, "rngs_seed": SEED, "dim_mults": list(DIM_MULTS), "channels": 1,
                 "use_fused_attention": True, "use_fused_spatial_attention": True},
        "diffusion": {"image_size": IMAGE_SIZE, "num_frames": FRAMES, "timesteps": TIMESTEPS,
                      "loss_type": "l2", "channels": 1, "prediction_type": "v"},
        "trainer": {"dataset_path": str(data), "train_batch_size": 4, "train_lr": 1e-3, "train_num_steps": 5,
                    "num_frames": FRAMES, "checkpoint_every_steps": 2, "results_folder": str(root / "results"),
                    "tensorboard_dir": str(root / "tb"), "profile_flush_step": 0, "dataset_normalize": True,
                    "freeze_schedule_buffers": True, "save_optimizer_state": True, "step_start_ema": 1,
                    "update_ema_every": 1, "ema_decay": 0.9, "add_loss_plot": True, **trainer},
    }
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    cfg = _config(root)
    return root, cfg, train.main(["--config", str(cfg), "--device", "cpu"])


def test_train_cli_writes_checkpoints_and_logs(run):
    root, _, tr = run
    assert sorted(p.name for p in (root / "results" / "checkpoints").iterdir()) == \
        ["step_2.pt", "step_4.pt", "step_5.pt"]
    losses = tr.loss_trace.tolist()
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    assert (root / "results" / "loss_plot.png").is_file()
    payload = read_checkpoint(root / "results" / "checkpoints" / "step_5.pt")
    assert payload["step"] == 5 and payload["optimizer"]["count"] == 5
    assert set(payload["ema_params"]) == set(payload["model"])
    assert any(not torch.equal(payload["ema_params"][k], payload["model"][k]) for k in payload["model"])
    assert (root / "tb").is_dir()
    # The checkpoint writes inside the loop are timed, so a step-time window can leave them out.
    assert sorted(tr.save_seconds) == [2, 4] and all(v >= 0 for v in tr.save_seconds.values())
    assert len(tr.step_starts) == 6


def test_resume_continues_from_a_checkpoint(run, caplog):
    root, cfg, _ = run
    saved = read_checkpoint(root / "results" / "checkpoints" / "step_4.pt")
    with caplog.at_level(logging.INFO):
        from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config

        _, diffusion, tr = build_trainer(load_config(cfg), device="cpu", resume_step=4)
    assert "Restored optimizer state for step 4" in caplog.text
    for k, v in saved["model"].items():
        assert torch.equal(diffusion.state_dict()[k], v), k
    for k, v in saved["ema_params"].items():
        assert torch.equal(tr.ema_state[k], v), k
    assert tr.step == 4 and tr.opt_count == 5
    tr.train()
    trace = tr.loss_trace.tolist()
    assert all(math.isnan(v) for v in trace[:4]) and math.isfinite(trace[4])
    assert tr.opt_count == 6


def test_resume_without_optimizer_state_or_checkpoint(tmp_path, caplog):
    cfg = _config(tmp_path, save_optimizer_state=False, train_num_steps=2)
    train.main(["--config", str(cfg), "--device", "cpu"])
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config

    with caplog.at_level(logging.WARNING):
        _, _, tr = build_trainer(load_config(cfg), device="cpu", resume_step=2)
    assert tr.step == 2 and tr.opt_count == 0 and "starting a fresh optimizer" in caplog.text
    with caplog.at_level(logging.WARNING):
        _, _, tr = build_trainer(load_config(cfg), device="cpu", resume_step=8)
    assert tr.step == 0 and "not found" in caplog.text


@pytest.mark.parametrize("ema", [False, True])
def test_sample_cli_reads_the_trained_checkpoint(run, ema):
    root, cfg, _ = run
    out = root / f"samples_{ema}"
    res = sample.main(["--config", str(cfg), "--checkpoint-path", str(root / "results" / "checkpoints" / "step_5.pt"),
                       "--output-path", str(out), "--batch-size", "2", "--sampler", "ddim", "--num-steps", "3",
                       "--device", "cpu", *(["--load-ema-params"] if ema else [])])
    assert tuple(res["videos"].shape) == (2, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
    img = Image.open(out / "sample_0.gif")
    assert img.n_frames == FRAMES and img.size == (IMAGE_SIZE, IMAGE_SIZE)


def test_train_cli_needs_a_card_unless_told_cpu(run):
    _, cfg, _ = run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", str(cfg)])
