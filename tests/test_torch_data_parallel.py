"""Data parallelism of the port's trainer against one rank, on the CPU.

Four ranks run in spawned processes (gloo over ``file://`` stores; their
target lives in ``torch_mesh_workers``, which imports no JAX), one spawn for
every run: 2 and 4 data ranks, a (data 2 x seq 2) mesh, and gradient
accumulation (A = 2) over 2 data ranks and over (data 2 x seq 2). Each
run takes three steps (two under accumulation) of the fixture recipe (its
Unet3D drawn from a seed, every bias non-zero, batch 4, 4 frames of 16x16,
full-state Adam, a clip, EMA from step 0) on injected t and noise, then
draws EMA samples. The same functions run the recipe on one rank in this
process; that one rank is held against the JAX package's step by
tests/test_torch_training.py. Checked, as the JAX package's own tests hold
its meshes to each other (tests/test_trainer.py:231-262: rtol 2e-3):

* the first step's summed gradient, within 1e-5 of the one-rank gradient's
  largest value;
* every step's loss within rtol 2e-3, the state after each step as the
  one-rank state (each tensor within 1e-4 of its largest value), every
  rank's state bit-equal;
* the 4 data ranks and (data 2 x seq 2) against the JAX package's step on a
  4-device CPU mesh of the same layout, on the same weights, batches, t and
  noise (``jax_mesh_steps``): the first gradient (each tensor within 2e-4 of
  its largest value), every loss (atol 5e-5), gradient norm (rtol 1e-4),
  state and EMA (each tensor within 1e-4 of its largest value);
* rank 0's EMA samples as one rank's sampler from the same EMA (rank 0's)
  and generator (float32, atol 5e-5), the GIFs written by rank 0 alone; a
  batch of 3 over 2 data ranks runs replicated, with JAX's warning.
"""

import numpy as np
import pytest
import torch

import torch_mesh_workers
from torch_port_helpers import CHANNELS, IMAGE_SIZE, MESH_FRAMES, MESH_SAMPLE_ROWS, close_state, mesh_model, seeded
from torch_port_helpers import close_to_jax, jax_mesh_steps, mesh_recipe_spec, spawn_mesh_runs

FRAMES, SAMPLE_ROWS = MESH_FRAMES, MESH_SAMPLE_ROWS
SAMPLE_ATOL = 5e-5  # float32 on [0, 1] after 10 DDPM steps: tests/test_torch_seq_parallel.py's forward atol
RUNS = [
    dict(name="dp2", world=2, sample=(SAMPLE_ROWS, 3), gifs=True),
    dict(name="dp4", world=4),
    dict(name="dseq", world=4, sample=(SAMPLE_ROWS,), trainer={"sequence_parallel_size": 2}),
    dict(name="acc_dp2", world=2, steps=2,
         trainer={"enable_gradient_accumulation": True, "gradient_accumulate_every": 2}),
    dict(name="acc_dseq", world=4, steps=2,
         trainer={"enable_gradient_accumulation": True, "gradient_accumulate_every": 2, "sequence_parallel_size": 2}),
    dict(name="masks4", world=4, kind="loss"),
    dict(name="focus4", world=4, steps=2, unet={"reference_compat": False}, focus=0.5),
]
COND_DIM = 16


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    spec = mesh_recipe_spec(root)
    spec.update(cond_dim=COND_DIM, cond=torch.from_numpy(seeded((4, COND_DIM), 30)))
    one = torch_mesh_workers.run(None, spec, "one")
    one_masks = torch_mesh_workers.loss_case(None, spec, "one_masks")
    one_focus = torch_mesh_workers.run(None, spec, "one_focus", steps=2, unet={"reference_compat": False}, focus=0.5)
    one_acc = torch_mesh_workers.run(None, spec, "one_acc", steps=2, trainer=RUNS[3]["trainer"])
    ranks = spawn_mesh_runs(root, spec, RUNS)
    return {"spec": spec, "one": one, "one_acc": one_acc, "one_masks": one_masks, "one_focus": one_focus,
            "ranks": ranks}


@pytest.mark.parametrize("name", ["dp2", "dp4", "dseq"])
def test_first_gradient_matches_one_rank(case, name):
    want = case["one"]["grads"]
    scale = max(float(g.abs().max()) for g in want.values())
    for r in range(RUNS[[c["name"] for c in RUNS].index(name)]["world"]):
        got = case["ranks"][r][name]["grads"]
        assert set(got) == set(want)
        err = max(float((got[k] - w).abs().max()) for k, w in want.items())
        assert err <= 1e-5 * scale, f"rank {r}: gradient {err} off, over 1e-5 of {scale}"


@pytest.mark.parametrize("name,ref", [("dp2", "one"), ("dp4", "one"), ("dseq", "one"),
                                      ("acc_dp2", "one_acc"), ("acc_dseq", "one_acc"), ("focus4", "one_focus")])
def test_steps_match_one_rank(case, name, ref):
    """Losses within JAX's rtol 2e-3, the state after every step as one rank's, and the ranks' states bit-equal."""
    want = case[ref]
    world = RUNS[[c["name"] for c in RUNS].index(name)]["world"]
    got = case["ranks"][0][name]
    assert got["is_main"] and len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=2e-3)
    for step in range(len(want["losses"])):
        close_state(got["states"][step], want["states"][step], case["spec"]["state"], want["grads"], step, name)
        close_state(got["emas"][step], want["emas"][step], case["spec"]["state"], want["grads"], step, name + " ema")
    for r in range(1, world):
        other = case["ranks"][r][name]
        assert not other["is_main"] and other["losses"] == got["losses"]
        for k, v in got["states"][-1].items():
            assert torch.equal(other["states"][-1][k], v), (r, k)
            assert torch.equal(other["emas"][-1][k], got["emas"][-1][k]), (r, k)
    assert all(case["ranks"][r][name]["stats"]["calls"] > 0 for r in range(world))


@pytest.mark.parametrize("name,layout", [("dp4", "dp"), ("dseq", "dseq")])
def test_steps_match_the_jax_mesh_step(case, name, layout):
    """The JAX step on a 4-device CPU mesh laid out as the JAX trainer lays it, on the same weights, batches, t and
    noise: the first gradient, the losses, the gradient norms, the state and the EMA."""
    close_to_jax(case["ranks"][0][name], jax_mesh_steps(case["spec"], layout), case["spec"]["state"], name)


def test_masks_are_drawn_for_the_whole_batch(case):
    """Fixed math with a condition: 4 data ranks draw t, the noise, the focus mask and the condition's dropout for
    the whole batch and keep their rows, so the summed loss and gradients are one rank's."""
    want, got = case["one_masks"], case["ranks"][0]["masks4"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])  # every parameter's, zeros where it was left unused
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    err = max(float((got["grads"][k] - w).abs().max()) for k, w in want["grads"].items())
    assert err <= 1e-5 * scale, f"gradient {err} off, over 1e-5 of {scale}"


def one_rank_samples(ema: dict, rows: int) -> torch.Tensor:
    """One rank's DDPM samples from ``ema`` with the workers' sample generator."""
    return mesh_model(ema).sample(batch_size=rows, generator=torch.Generator().manual_seed(torch_mesh_workers.SAMPLE_SEED))


@pytest.mark.parametrize("name", ["dp2", "dseq"])
def test_sampling_over_a_group_matches_one_rank(case, name):
    got = case["ranks"][0][name]
    want = one_rank_samples(got["emas"][-1], SAMPLE_ROWS)
    assert got["samples"][0].shape == want.shape == (SAMPLE_ROWS, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
    world = RUNS[[c["name"] for c in RUNS].index(name)]["world"]
    for r in range(world):  # every rank returns the whole batch
        torch.testing.assert_close(case["ranks"][r][name]["samples"][0], want, rtol=0, atol=SAMPLE_ATOL)


def test_rank0_alone_writes_the_sample_gifs(case):
    for r in range(2):
        assert len(case["ranks"][r]["dp2"]["sample_paths"]) == (SAMPLE_ROWS if r == 0 else 0)


def test_a_sampler_batch_that_does_not_divide_runs_replicated(case):
    got = case["ranks"][0]["dp2"]
    torch.testing.assert_close(got["samples"][1], one_rank_samples(got["emas"][-1], 3), rtol=0, atol=SAMPLE_ATOL)
    assert any("sampling batch 3 does not divide across 2 data shards" in m for m in got["warnings"])
    assert not any("does not divide" in m for m in case["ranks"][0]["dp4"]["warnings"])


def test_train_cli_spawns_the_ranks_it_is_asked_for(tmp_path, monkeypatch):
    """``--ranks N`` spawns N ranks of ``run_rank`` through the launcher every CLI shares (tests/test_torch_seq_parallel.py
    drives a spawn of the CLI to its end); without the flag the CPU runs one rank, or ``sequence_parallel_size`` ranks."""
    import torch.multiprocessing as mp
    import yaml

    from video_diffusion_nnx_tpu_torch import train
    from video_diffusion_nnx_tpu_torch.parallel import mesh

    spec = mesh_recipe_spec(tmp_path)
    cfg = {"unet": {"dim": 8, "dim_mults": [1, 2], "channels": CHANNELS}, "diffusion": {**spec["diffusion"]},
           "trainer": {"dataset_path": spec["trainer"]["dataset_path"], "train_batch_size": 4}}
    path = tmp_path / "dp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    spawned = []
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join: spawned.append((fn, *args[:3], nprocs)))
    argv = ["--config", str(path), "--device", "cpu", "--ranks", "2", "--dist-backend", "gloo"]
    assert train.main(argv) is None
    assert spawned == [(mesh._spawned, train._spawned_rank, 2, "gloo", 2)]
    assert mesh.default_ranks(torch.device("cpu"), 1) == 1 and mesh.default_ranks(torch.device("cpu"), 4) == 4
    with pytest.raises(ValueError, match="--ranks must be at least 1"):
        train.main(["--config", str(path), "--device", "cpu", "--ranks", "0"])
