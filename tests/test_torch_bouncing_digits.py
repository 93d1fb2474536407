"""The port's bouncing-digits generator against scripts/make_bouncing_digits.py: bit-equal, without scikit-learn.

Exact equality throughout (the same float32 canvas, the same draws from one
``default_rng``); scikit-learn is needed only to read the script's glyphs.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from video_diffusion_nnx_tpu_torch.data import bouncing_digits as port

REPO = Path(__file__).resolve().parent.parent
N_GLYPHS, N_TRAIN_GLYPHS = 1797, int(1797 * 0.9)


def _script():
    spec = importlib.util.spec_from_file_location("make_bouncing_digits", REPO / "scripts" / "make_bouncing_digits.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gifs(folder: Path) -> dict[str, list[np.ndarray]]:
    out = {}
    for p in sorted(folder.glob("*.gif")):
        img = Image.open(p)
        frames = []
        for i in range(img.n_frames):
            img.seek(i)
            frames.append(np.asarray(img.convert("L")))
        out[p.name] = frames
    return out


def test_glyph_file_is_load_digits():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    images = sklearn_datasets.load_digits().images
    glyphs = np.load(port.GLYPHS)
    assert glyphs.dtype == np.uint8 and glyphs.shape == (N_GLYPHS, 8, 8)
    np.testing.assert_array_equal(glyphs.astype(np.float64), images)


@pytest.mark.parametrize("upscale", [1, 2])
def test_load_glyphs_bit_equal(upscale):
    pytest.importorskip("sklearn")
    want = _script()._load_glyphs(upscale)
    got = port._load_glyphs(upscale)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed, clips, frames, digits, canvas", [
    (0, 3, 5, 2, 64), (1, 4, 16, 1, 64), (7, 2, 12, 3, 64), (3, 5, 6, 2, 32),
])
def test_make_clips_bit_equal(seed, clips, frames, digits, canvas):
    glyphs = port._load_glyphs()
    want = _script().make_clips(glyphs, clips, frames, canvas, digits, np.random.default_rng(seed))
    got = port.make_clips(glyphs, clips, frames, canvas, digits, np.random.default_rng(seed))
    assert got.dtype == np.uint8 and got.shape == (frames, clips, canvas, canvas)
    assert got.tobytes() == want.tobytes()
    assert got.max() > 0


def test_main_bit_equal_to_script(tmp_path, monkeypatch):
    pytest.importorskip("sklearn")
    args = ["--clips", "8", "--holdout-clips", "4", "--frames", "6", "--captioned-clips-per-class", "2"]
    outs = {}
    for name in ("script", "port"):
        d = tmp_path / name
        argv = ["--out", str(d / "train.npy"), "--holdout-out", str(d / "val.npy"),
                "--captioned-gifs", str(d / "gifs"), *args]
        if name == "script":
            monkeypatch.setattr(sys, "argv", ["make_bouncing_digits.py", *argv])
            _script().main()
        else:
            port.main(argv)
        outs[name] = d
    for f, shape in (("train.npy", (6, 8, 64, 64)), ("val.npy", (6, 4, 64, 64))):
        want, got = np.load(outs["script"] / f), np.load(outs["port"] / f)
        assert got.shape == shape and got.dtype == np.uint8
        assert got.tobytes() == want.tobytes(), f
    want, got = _gifs(outs["script"] / "gifs"), _gifs(outs["port"] / "gifs")
    assert sorted(got) == sorted(f"{w} {i}.gif" for w in ("one digit", "two digits", "three digits") for i in range(2))
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]) == len(want[name]) == 6, name
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_holdout_draws_only_from_the_last_tenth(tmp_path, monkeypatch):
    calls = []
    make_clips = port.make_clips

    def recording(glyphs, *args):
        calls.append(glyphs)
        return make_clips(glyphs, *args)

    monkeypatch.setattr(port, "make_clips", recording)
    port.main(["--out", str(tmp_path / "t.npy"), "--holdout-out", str(tmp_path / "v.npy"),
               "--clips", "2", "--holdout-clips", "3", "--frames", "4"])
    glyphs = port._load_glyphs()
    assert len(calls) == 2
    assert calls[0].shape[0] == N_TRAIN_GLYPHS and calls[1].shape[0] == N_GLYPHS - N_TRAIN_GLYPHS
    np.testing.assert_array_equal(calls[0], glyphs[:N_TRAIN_GLYPHS])
    np.testing.assert_array_equal(calls[1], glyphs[N_TRAIN_GLYPHS:])
    # Each holdout clip's first frame is the max of its digits' glyphs, so every lit pixel comes from some
    # holdout glyph value: the brightest value of the frame is one the holdout glyphs hold.
    held = np.load(tmp_path / "v.npy")
    assert held.shape == (4, 3, 64, 64) and set(np.unique(held)) <= set(np.unique(glyphs[N_TRAIN_GLYPHS:].astype(np.uint8)))


def test_generates_without_sklearn(tmp_path):
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "from video_diffusion_nnx_tpu_torch.data import bouncing_digits as b\n"
        f"b.main(['--out', {str(tmp_path / 't.npy')!r}, '--holdout-out', {str(tmp_path / 'v.npy')!r}, "
        "'--clips', '3', '--holdout-clips', '2', '--frames', '5'])\n"
        "try:\n    import sklearn\nexcept ImportError:\n    print('no sklearn')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no sklearn" in proc.stdout
    train, val = np.load(tmp_path / "t.npy"), np.load(tmp_path / "v.npy")
    glyphs = port._load_glyphs()
    np.testing.assert_array_equal(train, port.make_clips(glyphs[:N_TRAIN_GLYPHS], 3, 5, 64, 2, np.random.default_rng(0)))
    assert val.shape == (5, 2, 64, 64) and val.dtype == np.uint8
