"""The port's steering eval of the caption-conditioned recipe (``eval_bouncing_digits_cond``), on the CPU.

``check`` holds the three claims of scripts/eval_bouncing_digits_cond.py: it passes on the JAX
run's own ``examples/bouncing_digits_cond/stats.json`` and fails with the script's message on
copies altered to break each claim. ``evaluate`` runs end to end at a tiny conditioned recipe
(the hashed caption embedding) and writes ``stats.json`` with the JAX file's keys; its data-side
ink by class is held to the JAX dataset's items, grouped the JAX script's way.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import torch_port_helpers  # noqa: F401  (caps torch threads)
from video_diffusion_nnx_tpu.data.gif_dataset import GifVideoDataset as JaxGifVideoDataset
from video_diffusion_nnx_tpu_torch import eval_bouncing_digits_cond as ev
from video_diffusion_nnx_tpu_torch.config import build_models, load_config
from video_diffusion_nnx_tpu_torch.convert import save_checkpoint
from video_diffusion_nnx_tpu_torch.models import text
from video_diffusion_nnx_tpu_torch.utils.media import video_array_to_gif

JAX_STATS = Path(__file__).resolve().parents[1] / "examples" / "bouncing_digits_cond" / "stats.json"


def _altered(**classes) -> dict:
    stats = json.loads(JAX_STATS.read_text())
    stats["classes"].update(classes)
    return stats


def test_check_passes_on_the_jax_run():
    ev.check(json.loads(JAX_STATS.read_text()))


@pytest.mark.parametrize("classes,message", [
    ({"three_cs1": 0.0466}, r"conditioning failed to separate digit-count classes \(cs=1 separation 0\.0040\)"),
    ({"three_cs3": 0.0500}, r"CFG failed to widen the separation \(cs=1 0\.0199 -> cs=3 0\.0149\)"),
    ({"two_cs1": 0.0700}, "class ink order wrong at cs=1"),
    ({"two_cs1": 0.0400}, "class ink order wrong at cs=1"),
])
def test_check_fails_with_the_scripts_messages(classes, message):
    with pytest.raises(AssertionError, match=message):
        ev.check(_altered(**classes))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny conditioned recipe, its seeded weights saved as a step-1 checkpoint with an EMA, and a captioned GIF
    folder of the generator's naming ("<class> <index>.gif", 3 classes x 4 clips)."""
    patch = pytest.MonkeyPatch()
    patch.setattr(text, "_hf", False)
    root = tmp_path_factory.mktemp("eval_cond")
    gifs = root / "gifs"
    gifs.mkdir()
    rng = np.random.default_rng(2)
    for count, word in enumerate(("one digit", "two digits", "three digits"), start=1):
        for i in range(4):
            clip = (rng.random((4, 16, 16, 1)) < 0.1 * count).astype(np.uint8) * 255
            video_array_to_gif(clip, gifs / f"{word} {i}.gif")
    cfg = {"unet": {"dim": 8, "dim_mults": [1, 2], "channels": 1, "use_bert_text_cond": True},
           "diffusion": {"image_size": 16, "num_frames": 4, "timesteps": 6, "channels": 1, "prediction_type": "v"}}
    path = root / "cond.yaml"
    path.write_text(yaml.safe_dump(cfg))
    _, diffusion = build_models(load_config(path), device="cpu")
    save_checkpoint(root / "ckpt" / "step_1.pt", diffusion, diffusion.state_dict(), step=1)
    yield root, path, gifs
    patch.undo()


def test_data_ink_by_class_matches_the_jax_dataset(tiny_run):
    _, _, gifs = tiny_run
    got = ev.data_ink_by_class(gifs, 16, 4)
    ds = JaxGifVideoDataset(str(gifs), image_size=16, channels=1, num_frames=4, use_path_as_cond=True)
    sums = {}
    for i in range(len(ds)):  # 12 clips: every one is read (len // 90 == 0 -> a step of 1)
        video, caption = ds[i]
        sums.setdefault(caption.rsplit(" ", 1)[0], []).append(float(np.mean(video)))
    assert got == {k: round(float(np.mean(v)), 4) for k, v in sorted(sums.items())}
    assert got["one digit"] < got["two digits"] < got["three digits"]


def test_evaluate_end_to_end_on_cpu(tiny_run):
    root, cfg, gifs = tiny_run
    out = root / "out"
    stats = ev.evaluate(str(cfg), str(root / "ckpt"), 1, str(gifs), str(out), batch=2, num_steps=2, device="cpu")
    written = json.loads((out / "stats.json").read_text())
    assert set(written) == set(json.loads(JAX_STATS.read_text()))
    assert set(written["classes"]) == {f"{n}_cs{s}" for n in ("one", "two", "three") for s in (1, 3)}
    assert written["embedding"] == "hashed bag of words (no local BERT weights)"
    assert written["separation_cs1"] == round(written["classes"]["three_cs1"] - written["classes"]["one_cs1"], 4)
    assert sorted(p.name for p in out.glob("*.gif")) == sorted(
        f"{c}_cs{s}_{i}.gif" for c in ("one_digit", "two_digits", "three_digits") for s in (1, 3) for i in (0, 1))
    assert stats["graph"] == {"captures": 0, "replays": 0}  # graphs are for CUDA tensors
    # Every cell samples from one seed: the same caption and scale give the same ink.
    again = ev.evaluate(str(cfg), str(root / "ckpt"), 1, None, str(root / "again"), batch=2, num_steps=2,
                        device="cpu")
    assert again["classes"] == written["classes"] and "data_ink_by_class" not in again
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ev.main(["--config", str(cfg), "--checkpoint-path", str(root / "ckpt"), "--step", "1"])
