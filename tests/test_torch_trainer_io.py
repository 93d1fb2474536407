"""The trainer's asynchronous checkpoints, sampling during training and profiler trace, on the CPU.

The JAX trainer's behaviour they follow (``training/trainer.py``): periodic saves that do not block the loop and
a final save that waits for them and raises on failure (:748-789, tests/test_trainer.py:172); EMA sample GIFs under
``results/samples/step_{N}/`` from a key of their own (:683-693, :795-828, tests/test_trainer.py:139); a trace
from the loop's start to ``profile_flush_step`` (:643-654, :697-704). A small port Unet3D with seeded weights;
every comparison here is exact (files byte for byte, tensors with ``torch.equal``).
"""

import json
import logging
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_helpers import CHANNELS, FRAMES, IMAGE_SIZE, TIMESTEPS
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import Unet3D, text
from video_diffusion_nnx_tpu_torch.training import trainer as trainer_mod
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "seq.npy"
    np.save(path, np.random.default_rng(0).integers(0, 256, size=(6, 10, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    return str(path)


def _model(seed: int = 0, **unet_kw) -> GaussianDiffusion:
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=CHANNELS, **unet_kw)
    unet.reset_parameters(torch.Generator().manual_seed(seed))
    return GaussianDiffusion(unet, image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS,
                             timesteps=TIMESTEPS, loss_type="l2")


def _trainer(npy_path, root, model=None, **kw) -> Trainer:
    base = dict(dataset_path=npy_path, train_batch_size=2, results_folder=str(root / "results"),
                tensorboard_dir=str(root / "tb"), profile_flush_step=0, train_num_steps=5, train_lr=1e-3,
                step_start_ema=0, update_ema_every=1, ema_decay=0.5, checkpoint_every_steps=2,
                save_optimizer_state=True, dataset_normalize=True)
    return Trainer(model if model is not None else _model(), folder=str(root), **{**base, **kw})


def _files(tr) -> dict[int, bytes]:
    return {int(p.stem[5:]): p.read_bytes() for p in tr.checkpoint_dir_path.glob("step_*.pt")}


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen_buffers", "full_state"])
def test_async_checkpoints_equal_synchronous_ones(npy_path, tmp_path, freeze):
    """Every async file, byte for byte, is the synchronous run's file of that step; the losses are the same; the
    loop's blocking seconds are recorded for each periodic save; each file loads."""
    runs = {}
    for mode in ("sync", "async"):
        tr = _trainer(npy_path, tmp_path / mode, async_checkpointing=mode == "async", freeze_schedule_buffers=freeze)
        tr.train()
        runs[mode] = tr
    sync, asy = runs["sync"], runs["async"]
    assert sorted(_files(asy)) == [2, 4, 5] and _files(asy) == _files(sync)
    assert torch.equal(asy.loss_trace, sync.loss_trace)
    assert sorted(asy.save_seconds) == [2, 4] and asy.checkpoint_writer.path is None
    for step in (2, 4, 5):
        payload = read_checkpoint(asy.checkpoint_path(step))
        assert payload["step"] == step and payload["optimizer"]["count"] == {2: 3, 4: 5, 5: 5}[step]
        _model().load_state_dict(payload["model"])


def test_async_snapshot_is_taken_before_the_next_step(npy_path, tmp_path, monkeypatch):
    """The write runs after later steps have changed the live tensors: the file still holds its own step's state."""
    release = threading.Event()
    real = trainer_mod.write_checkpoint
    written = []

    def slow_write(path, payload):
        release.wait(30)
        written.append(path.name)
        return real(path, payload)

    monkeypatch.setattr(trainer_mod, "write_checkpoint", slow_write)
    tr = _trainer(npy_path, tmp_path, async_checkpointing=True, train_num_steps=4)
    for _ in range(4):
        tr.train_step(next(tr.dl))
        if tr.step == 2:
            tr.save(wait=False)
            want = {k: v.clone() for k, v in tr.model.state_dict().items()}
            assert tr.save(wait=False) is None  # the same step, while its write is in flight: skipped
        tr.step += 1
    assert not tr.checkpoint_path(2).exists() and tr.checkpoint_writer.path == tr.checkpoint_path(2)
    release.set()
    tr.checkpoint_writer.wait()
    got = read_checkpoint(tr.checkpoint_path(2))["model"]
    assert written == ["step_2.pt"] and all(torch.equal(got[k], want[k]) for k in want)
    assert not all(torch.equal(v, want[k]) for k, v in tr.model.state_dict().items())


def test_max_to_keep_prunes_after_each_write(npy_path, tmp_path):
    tr = _trainer(npy_path, tmp_path, async_checkpointing=True, max_to_keep=2, train_num_steps=7)
    tr.train()
    assert sorted(_files(tr)) == [6, 7]


@pytest.mark.parametrize("asynchronous", [True, False], ids=["async", "sync"])
def test_failed_saves(npy_path, tmp_path, monkeypatch, caplog, asynchronous):
    """A failed periodic save is logged and training goes on (both modes, as JAX :786-789); a failed final save
    raises."""
    def fail(path, payload):
        raise OSError(f"disk full writing {path.name}")

    monkeypatch.setattr(trainer_mod, "write_checkpoint", fail)
    tr = _trainer(npy_path, tmp_path, async_checkpointing=asynchronous)
    with caplog.at_level(logging.ERROR, logger=trainer_mod.__name__), pytest.raises(OSError, match="step_5"):
        tr.train()
    assert tr.step == 5 and bool(torch.isfinite(tr.loss_trace).all())
    assert sum("step_2.pt" in r.getMessage() or "step 2" in r.getMessage() for r in caplog.records) == 1
    assert not _files(tr)


def _snapshot(tr):
    state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    adam = {id(p): {k: v.clone() for k, v in s.items()} for p, s in tr.optimizer.state.items()}
    return state, adam, tr.generator.get_state(), tr.opt_count


def _same(a, b) -> bool:
    (sa, aa, ga, ca), (sb, ab, gb, cb) = a, b
    return (sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa) and aa.keys() == ab.keys()
            and all(torch.equal(aa[i][k], ab[i][k]) for i in aa for k in aa[i]) and torch.equal(ga, gb) and ca == cb)


@pytest.mark.parametrize("flat", [False, True], ids=["per_tensor", "flat"])
def test_sample_batch_is_the_ema_models_sample_and_leaves_the_state(npy_path, tmp_path, flat):
    """``sample_batch`` from the EMA equals ``sample`` of a model loaded with the EMA state (the drifted buffers'
    EMA too, full-state Adam); the live tensors, Adam's state and the trainer's generator are bit-equal before and
    after, with and without ``flatten_optimizer``; ``use_ema=False`` samples the live weights."""
    tr = _trainer(npy_path, tmp_path, flatten_optimizer=flat, freeze_schedule_buffers=False)
    for _ in range(2):
        tr.train_step(next(tr.dl))
        tr.step += 1
    before = _snapshot(tr)
    got = tr.sample_batch(2, generator=torch.Generator().manual_seed(3))
    assert _same(before, _snapshot(tr)) and len(tr.model.graphs) == 0
    ema_model = _model(seed=9)
    ema_model.load_state_dict(tr.ema_state)
    assert not torch.equal(ema_model.sqrt_alphas_cumprod, _model().sqrt_alphas_cumprod)  # the drifted buffer
    want = ema_model.sample(batch_size=2, generator=torch.Generator().manual_seed(3))
    assert got.shape == (2, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE) and torch.equal(got, want)
    live = tr.sample_batch(2, use_ema=False, generator=torch.Generator().manual_seed(3))
    assert torch.equal(live, tr.model.sample(batch_size=2, generator=torch.Generator().manual_seed(3)))
    assert not torch.equal(live, got)


def test_conditioned_sample_batch_uses_the_sample_text(npy_path, tmp_path, monkeypatch):
    """A caption-conditioned model samples ``sample_text`` (embedded as the loader embeds captions) at
    ``cond_scale`` (JAX :824-828)."""
    monkeypatch.setattr(text, "_hf", False)
    tr = _trainer(npy_path, tmp_path, model=_model(use_bert_text_cond=True), sample_text="two digits", cond_scale=3.0)
    with torch.no_grad():
        for v in tr.ema_state.values():
            v.add_(0.01)
    got = tr.sample_batch(2, generator=torch.Generator().manual_seed(4))
    ema_model = _model(use_bert_text_cond=True)
    ema_model.load_state_dict(tr.ema_state)
    want = ema_model.sample(batch_size=2, generator=torch.Generator().manual_seed(4), cond=["two digits"] * 2,
                            cond_scale=3.0)
    assert torch.equal(got, want)
    assert not torch.equal(got, ema_model.sample(batch_size=2, generator=torch.Generator().manual_seed(4),
                                                 cond=["two digits"] * 2, cond_scale=1.0))


def test_sampling_during_training_writes_gifs_and_changes_no_loss(npy_path, tmp_path):
    """``save_and_sample_every`` 2 over 5 steps: GIFs of ``num_sample_rows`` clips at steps 2 and 4, and the same
    losses, parameters and EMA as the run without sampling."""
    plain = _trainer(npy_path, tmp_path / "plain")
    plain.train()
    tr = _trainer(npy_path, tmp_path / "sampled", save_and_sample_every=2, num_sample_rows=2)
    tr.train()
    assert sorted(tr.sample_paths) == [2, 4] and sorted(tr.sample_seconds) == [2, 4]
    for step in (2, 4):
        paths = sorted((tr.results_folder / "samples" / f"step_{step}").glob("*.gif"))
        assert [p.name for p in paths] == ["sample_0.gif", "sample_1.gif"]
        img = Image.open(paths[0])
        assert img.size == (IMAGE_SIZE, IMAGE_SIZE) and img.n_frames == FRAMES
    assert torch.equal(tr.loss_trace, plain.loss_trace)
    for a, b in ((tr.model.state_dict(), plain.model.state_dict()), (tr.ema_state, plain.ema_state)):
        assert all(torch.equal(a[k], b[k]) for k in a)



def test_failed_sample_is_logged(npy_path, tmp_path, monkeypatch, caplog):
    def fail(videos, out_dir):
        raise OSError("cannot write GIFs")

    monkeypatch.setattr(trainer_mod, "write_sample_gifs", fail)
    tr = _trainer(npy_path, tmp_path, save_and_sample_every=2, train_num_steps=3)
    with caplog.at_level(logging.ERROR, logger=trainer_mod.__name__):
        tr.train()
    assert tr.step == 3 and not tr.sample_paths and tr.checkpoint_path(3).exists()
    assert any("Error sampling at step 2" in r.getMessage() for r in caplog.records)


def test_no_sample_at_the_default_cadence(npy_path, tmp_path):
    """save_and_sample_every at train_num_steps or beyond asks for no sample (the loop ends at the step before)."""
    for every in (0, 5, 100000):
        tr = _trainer(npy_path, tmp_path / str(every), save_and_sample_every=every)
        assert not tr.samples_due


def _trace_events(path):
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("flush,steps,traced", [(2, 4, (0, 2)), (10, 3, (0, 3))], ids=["flush_step", "loop_end"])
def test_profiler_trace_written_and_stopped(npy_path, tmp_path, flush, steps, traced):
    """A Chrome trace under ``tensorboard_dir``, one ``train_step#N`` range per traced step: stopped when the step
    count reaches ``profile_flush_step``, else at the end of the loop; the profiler is off afterwards."""
    tr = _trainer(npy_path, tmp_path, profile_flush_step=flush, train_num_steps=steps, checkpoint_every_steps=100)
    tr.train()
    assert tr.profiler is None and tr.traced_steps == traced
    assert tr.trace_path.parent == tr.tensorboard_dir and tr.trace_path.suffix == ".json"
    events = _trace_events(tr.trace_path)
    names = [e.get("name", "") for e in events]
    steps = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("train_step#"))
    assert steps == [f"train_step#{i}" for i in range(*traced)]
    assert any(n.startswith("aten::") for n in names)


def test_profiler_stops_before_a_sample(npy_path, tmp_path):
    """A sample captures CUDA graphs on the card: the trace ends at the sample's step instead."""
    tr = _trainer(npy_path, tmp_path, profile_flush_step=4, save_and_sample_every=2, num_sample_rows=1,
                  checkpoint_every_steps=100)
    tr.train()
    assert tr.traced_steps == (0, 2) and sorted(tr.sample_paths) == [2, 4]


def test_profiler_that_cannot_start_is_logged(npy_path, tmp_path, monkeypatch, caplog):
    import torch.profiler

    def broken(*args, **kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    tr = _trainer(npy_path, tmp_path, profile_flush_step=2, train_num_steps=2, checkpoint_every_steps=100)
    with caplog.at_level(logging.WARNING, logger=trainer_mod.__name__):
        tr.train()
    assert tr.step == 2 and tr.trace_path is None
    assert any("profiler trace not started" in r.getMessage() for r in caplog.records)
