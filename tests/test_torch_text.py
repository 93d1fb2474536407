"""The port's text conditioning inputs against the JAX package's, on the CPU.

``models/text.py`` (``tokenize``, ``bert_embed`` by mean and by the first
token) bit-equal to the JAX module on the hashed bag-of-words path, which
both packages take where no local BERT weights exist; the path is pinned on
both sides here, so no HuggingFace cache is ever read. Then the caption of a
file name, the captioned ``GifVideoDataset`` and ``collate_with_text_cond``,
bit-equal to the JAX ones on the same folder.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import FRAMES, IMAGE_SIZE
from video_diffusion_nnx_tpu.data import loader as jloader
from video_diffusion_nnx_tpu.data.gif_dataset import GifVideoDataset as JaxGifVideoDataset
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu.utils import functional as jfunctional
from video_diffusion_nnx_tpu_torch.data import loader
from video_diffusion_nnx_tpu_torch.data.gif_dataset import GifVideoDataset
from video_diffusion_nnx_tpu_torch.models import text
from video_diffusion_nnx_tpu_torch.utils import functional, media

CAPTIONS = [
    "",
    "one digit",
    "Two Digits",
    "three three three digits",
    " ".join(f"w{i % 37}" for i in range(300)),  # cut at 256 tokens
    "MiXeD CaSe\tand  tabs",
]


@pytest.fixture(autouse=True)
def hashed(monkeypatch):
    """The hashed bag-of-words path on both sides (JAX caches its choice in ``_hf`` too)."""
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)


def test_constants_and_token_ids_match_jax():
    assert text.BERT_MODEL_DIM == jtext.BERT_MODEL_DIM == 768
    for word in ("one", "digit", "Digits", "", "ünï"):
        assert text._hash_token_id(word) == jtext._hash_token_id(word)
        assert 1 <= text._hash_token_id(word) <= 30000


@pytest.mark.parametrize("captions", [CAPTIONS, CAPTIONS[1:3], ["just one"], "a plain string"], ids=str)
def test_tokenize_matches_jax(captions):
    got, want = text.tokenize(captions), jtext.tokenize(captions)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_tokenize_pads_lowercases_and_cuts():
    ids = text.tokenize(CAPTIONS)
    assert ids.shape == (len(CAPTIONS), 256)
    assert not ids[0].any()  # the empty caption is all padding
    np.testing.assert_array_equal(text.tokenize(["two digits"])[0], ids[2, :2])  # case folded
    assert not ids[2, 2:].any()
    assert text.tokenize([""]).shape == (1, 1)


@pytest.mark.parametrize("cls", [False, True], ids=["mean", "cls"])
def test_bert_embed_is_bit_equal_to_jax(cls):
    ids = text.tokenize(CAPTIONS)
    got, want = text.bert_embed(ids, return_cls_repr=cls), jtext.bert_embed(ids, return_cls_repr=cls)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(CAPTIONS), 768)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()  # padding alone embeds to zeros
    np.testing.assert_array_equal(text.embed_captions(CAPTIONS, return_cls_repr=cls), want)


def test_embedding_of_a_row_ignores_its_batch():
    """A caption's embedding does not depend on the other captions of its batch (the padding is masked out), which
    is what lets the server coalesce text requests."""
    alone = text.embed_captions(["two digits"])
    batched = text.embed_captions(["two digits", "three three three digits and more"])
    np.testing.assert_array_equal(alone[0], batched[0])
    mean = np.mean([np.random.default_rng(text._hash_token_id(w)).standard_normal(768) for w in ("two", "digits")],
                   axis=0)
    np.testing.assert_array_equal(alone[0], mean.astype(np.float32))
    assert "hashed" in text.embedding_name()


@pytest.mark.parametrize("path", ["three digits 42.gif", "/data/gifs/one_digit-7.gif", "a.b.c", "no_ext",
                                  "dir.with.dots/two-digits_3.gif"])
def test_get_text_from_path_matches_jax(path):
    assert functional.get_text_from_path(path) == jfunctional.get_text_from_path(path)
    assert functional.get_text_from_path("x/three digits 42.gif") == "three digits 42"


@pytest.mark.parametrize("value", [["a", "b"], ("a",), [], ["a", 1], "ab", None, np.array(["a"])], ids=str)
def test_is_list_str_matches_jax(value):
    assert functional.is_list_str(value) == jfunctional.is_list_str(value)


@pytest.fixture(scope="module")
def captioned_folder(tmp_path_factory):
    """Five captioned grayscale GIFs of 3 to 6 frames, one in a subfolder."""
    folder = tmp_path_factory.mktemp("captioned")
    rng = np.random.default_rng(3)
    names = ["one digit 0", "two digits 1", "three digits 2", "two_digits-3", "nested/one digit 4"]
    for i, name in enumerate(names):
        target = folder / f"{name}.gif"
        target.parent.mkdir(parents=True, exist_ok=True)
        media.video_array_to_gif(rng.integers(0, 256, size=(3 + i % 4, 20, 20, 1), dtype=np.uint8), target,
                                 optimize=False)
    return folder


def test_captioned_gif_items_match_jax(captioned_folder):
    kw = dict(image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES, use_path_as_cond=True)
    port, ref = GifVideoDataset(str(captioned_folder), **kw), JaxGifVideoDataset(str(captioned_folder), **kw)
    assert len(port) == len(ref) == 5
    for i in range(5):
        (video, caption), (want_video, want_caption) = port[i], ref[i]
        assert caption == want_caption
        np.testing.assert_array_equal(video, want_video)
    assert sorted(port[i][1] for i in range(5)) == ["one digit 0", "one digit 4", "three digits 2", "two digits 1",
                                                    "two digits 3"]
    plain = GifVideoDataset(str(captioned_folder), image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES)
    np.testing.assert_array_equal(plain[0], port[0][0])  # without captions an item is the video alone


def test_collate_with_text_cond_matches_jax(captioned_folder):
    ds = GifVideoDataset(str(captioned_folder), image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES,
                         use_path_as_cond=True)
    items = [ds[i] for i in (3, 0, 2)]
    videos, cond = loader.collate_with_text_cond(items)
    want_videos, want_cond = jloader.collate_with_text_cond(items)
    assert videos.shape == (3, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE) and cond.shape == (3, 768)
    assert cond.dtype == want_cond.dtype == np.float32
    np.testing.assert_array_equal(videos, want_videos)
    np.testing.assert_array_equal(cond, want_cond)


def test_loader_batches_of_captions_reach_the_device_as_pairs(captioned_folder):
    """The prefetching feed carries both tensors of a captioned batch, in the JAX loader's order for one seed."""
    ds = GifVideoDataset(str(captioned_folder), image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES,
                         use_path_as_cond=True)
    feed = loader.endless_prefetching_loader(ds, 2, torch.device("cpu"), seed=4,
                                             collate_fn=loader.collate_with_text_cond)
    ref_ds = JaxGifVideoDataset(str(captioned_folder), image_size=IMAGE_SIZE, channels=1, num_frames=FRAMES,
                                use_path_as_cond=True)
    ref = iter(jloader.DataLoader(ref_ds, batch_size=2, seed=4, collate_fn=jloader.collate_with_text_cond))
    for _ in range(2):
        videos, cond = next(feed)
        want_videos, want_cond = next(ref)
        assert isinstance(videos, torch.Tensor) and cond.dtype == torch.float32
        np.testing.assert_array_equal(videos.numpy(), want_videos)
        np.testing.assert_array_equal(cond.numpy(), want_cond)
