"""Sampling over data ranks, on the CPU: the port's samplers, the sample and extend CLIs and the server over four
gloo ranks against the JAX package's samplers on a 4-device CPU mesh and against one rank.

The JAX package runs every sampler over ``data_parallel_mesh()`` by default: the batch shards over ``'data'``
when it divides, else runs replicated with a warning (``_sampler_batch_spec``). Here four ranks run in one spawn
(gloo over ``file://`` stores; targets in ``torch_mesh_workers``, which imports no JAX), each on its rows of a
batch of 4 (a row a rank) of the fixture recipe (v-prediction, as the flagship; T = 10; the JAX model's weights
converted; under noise prediction a clip boundary makes these inputs so sensitive that JAX's own DDIM-3 on 4 devices
and on 1 part by 2.3e-4):

* DDIM-3 from an injected x_T and frame-conditional DDIM-3 (the first and last frames pinned), with and without
  reconstruction guidance, on the draws of the JAX key chain, against the JAX samplers with
  ``mesh=data_parallel_mesh(4)`` (samples atol 5e-5, the float32 forward atol of
  tests/test_torch_data_parallel.py);
* the frame-conditional DDPM chain from a generator, and a DDIM batch of 3 (it does not divide: replicated, with
  JAX's warning), against the same calls on one rank;
* the sample and extend CLIs (``--ranks`` through ``run_rank``) and the server (rank 0 serving HTTP, the others
  following its calls: four coalesced DDIM-3 requests, a DDPM request and an /extend request) against their
  one-rank runs, rank 0 alone writing the GIFs.
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_mesh_workers
from torch_port_helpers import (CHANNELS, DIM, DIM_MULTS, FRAMES, IMAGE_SIZE, TIMESTEPS, jax_fixture_model,
                                port_model, seeded, spawn_mesh_runs)
from video_diffusion_nnx_tpu.parallel.mesh import data_parallel_mesh
from video_diffusion_nnx_tpu_torch import extend, sample
from video_diffusion_nnx_tpu_torch.convert import save_checkpoint

ROWS, STEPS, WORLD = 4, 3, 4
SHAPE = (ROWS, CHANNELS, FRAMES, IMAGE_SIZE, IMAGE_SIZE)
MASK = np.array([True, False, False, True])
ATOL = 5e-5
GUIDANCE = 1.0
CONFIG = {"unet": {"dim": DIM, "dim_mults": list(DIM_MULTS), "channels": CHANNELS},
          "diffusion": {"image_size": IMAGE_SIZE, "num_frames": FRAMES, "timesteps": TIMESTEPS, "channels": CHANNELS,
                        "loss_type": "l2", "prediction_type": "v"}}
SERVE_REQUESTS = {"sample": [{"sampler": "ddim", "num_steps": STEPS, "seed": s} for s in (11, 12, 13, 14)]
                  + [{"sampler": "ddpm", "batch_size": ROWS, "seed": 5}],
                  "extend": [{"frame_mask": MASK.tolist(), "batch_size": ROWS, "num_steps": STEPS, "seed": 6}]}


def _draws(key, steps: int):
    """x_T, then each DDIM step's mix noise, of ``sample_conditional_frames``' key chain (JAX :773-775, :799)."""
    key, init_key = jax.random.split(key)
    init = torch.tensor(np.asarray(jax.random.normal(init_key, SHAPE)))
    mix = []
    for _ in range(steps):
        key, mix_key = jax.random.split(key)
        mix.append(torch.tensor(np.asarray(jax.random.normal(mix_key, SHAPE))))
    return init, mix


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_sampling")
    jm = jax_fixture_model(prediction_type="v")
    pm = port_model(jm, prediction_type="v")
    known = np.clip(seeded(SHAPE, 21, 0.3) + 0.5, 0.0, 1.0)
    x_T = torch.from_numpy(seeded(SHAPE, 30))
    cond_key = jax.random.PRNGKey(3)
    init, mix = _draws(cond_key, STEPS)
    mesh = data_parallel_mesh(WORLD)
    jax_out = {"ddim": jm.ddim_sample(jax.random.PRNGKey(0), batch_size=ROWS, num_steps=STEPS, mesh=mesh,
                                      init_noise=jnp.asarray(x_T.numpy()))}
    for name, wr in (("cond", 0.0), ("cond_guided", GUIDANCE)):
        jax_out[name] = jm.sample_conditional_frames(cond_key, jnp.asarray(known), jnp.asarray(MASK), mesh=mesh,
                                                     num_steps=STEPS, recon_guidance_weight=wr)
    cond_kw = {"num_steps": STEPS, "init_noise": init, "mix_noise": mix}

    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(CONFIG))
    ckpt = save_checkpoint(root / "ckpt.pt", pm)
    clip = root / "clip.npy"
    np.save(clip, np.random.default_rng(4).integers(0, 256, size=(FRAMES, IMAGE_SIZE, IMAGE_SIZE), dtype=np.uint8))
    common = ["--config", str(cfg), "--checkpoint-path", str(ckpt), "--device", "cpu", "--batch-size", str(ROWS),
              "--seed", "2", "--num-steps", str(STEPS)]
    argv = {"sample": common + ["--sampler", "ddim"],
            "extend": common + ["--input", str(clip), "--keep-frames", "2", "--recon-guidance", str(GUIDANCE)]}
    buf = io.BytesIO()
    np.save(buf, known[0])
    requests = {**SERVE_REQUESTS, "extend": [{**r, "known_npy_b64": base64.b64encode(buf.getvalue()).decode()}
                                             for r in SERVE_REQUESTS["extend"]]}
    runs = [dict(name="ddim", world=WORLD, kind="sampler", kwargs={"init_noise": x_T, "num_steps": STEPS}),
            dict(name="cond", world=WORLD, kind="sampler", call="cond", kwargs=cond_kw),
            dict(name="cond_guided", world=WORLD, kind="sampler", call="cond",
                 kwargs={**cond_kw, "recon_guidance_weight": GUIDANCE}),
            dict(name="cond_ddpm", world=WORLD, kind="sampler", call="cond", kwargs={"seed": 7}),
            dict(name="ddim3", world=WORLD, kind="sampler", rows=3, kwargs={"seed": 8, "num_steps": STEPS}),
            dict(name="serve", world=WORLD, kind="serve"),
            *(dict(name=f"{cli}_cli", world=WORLD, kind="cli", module=cli,
                   argv=argv[cli] + ["--output-path", str(root / f"{cli}_ranks")]) for cli in argv)]
    spec = {"state": pm.state_dict(), "unet": {**CONFIG["unet"], "dim_mults": DIM_MULTS},
            "diffusion": CONFIG["diffusion"], "known": torch.from_numpy(known), "mask": MASK, "requests": requests}
    ranks = spawn_mesh_runs(root, spec, runs)
    one = {name: torch_mesh_workers.sampler_case(None, spec, name, **{k: v for k, v in run.items()
                                                                     if k not in ("name", "world", "kind")})
           for name, run in ((r["name"], r) for r in runs if r.get("kind") == "sampler")}
    one["serve"] = torch_mesh_workers.serve_case(None, spec, "serve")
    for cli in argv:
        one[f"{cli}_cli"] = {"sample": sample, "extend": extend}[cli].main(
            argv[cli] + ["--output-path", str(root / f"{cli}_one")])
    return {"ranks": ranks, "one": one, "jax": {k: np.asarray(v) for k, v in jax_out.items()}, "root": root,
            "argv": argv}


@pytest.mark.parametrize("name", ["ddim", "cond", "cond_guided"])
def test_sampling_over_four_ranks_matches_the_jax_mesh(case, name):
    """Each rank samples one row; the gathered batch, on every rank, against JAX's sampler on a 4-device mesh."""
    want = case["jax"][name]
    for r in range(WORLD):
        got = case["ranks"][r][name]
        assert got["part"][0] == 1 and not got["warnings"], (r, got["part"], got["warnings"])
        np.testing.assert_allclose(got["out"].numpy(), want, atol=ATOL, rtol=0, err_msg=f"{name} rank {r}")
    np.testing.assert_allclose(case["one"][name]["out"].numpy(), want, atol=ATOL, rtol=0)


def test_frame_conditional_ddpm_draws_the_whole_batch(case):
    """The DDPM chain from a generator: each rank draws x_T, each step's noise and the pinned frames' noise for the
    whole batch and keeps its row, so the gathered batch is one rank's."""
    want = case["one"]["cond_ddpm"]["out"]
    for r in range(WORLD):
        torch.testing.assert_close(case["ranks"][r]["cond_ddpm"]["out"], want, rtol=0, atol=ATOL)


def test_a_batch_that_does_not_divide_runs_replicated(case):
    want = case["one"]["ddim3"]["out"]
    for r in range(WORLD):
        got = case["ranks"][r]["ddim3"]
        assert got["part"][0] == 3
        assert any("sampling batch 3 does not divide across 4 data shards" in m for m in got["warnings"])
        torch.testing.assert_close(got["out"], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cli", ["sample", "extend"])
def test_cli_over_four_ranks_matches_one_rank(case, cli):
    """``run_rank`` on four ranks: the gathered clips as the one-rank CLI's, GIFs from rank 0 alone."""
    one = case["one"][f"{cli}_cli"]
    for r in range(WORLD):
        got = case["ranks"][r][f"{cli}_cli"]
        torch.testing.assert_close(got["videos"], one["videos"], rtol=0, atol=ATOL)
        assert len(got["paths"]) == (ROWS if r == 0 else 0)
    assert sorted(p.name for p in (case["root"] / f"{cli}_ranks").iterdir()) == [f"sample_{i}.gif" for i in range(ROWS)]


def test_server_over_four_ranks_matches_one_rank(case):
    """/health counts the ranks; coalesced DDIM requests (one row a rank), a DDPM request and an /extend request
    over four ranks return one rank's rows."""
    got, one = case["ranks"][0]["serve"], case["one"]["serve"]
    assert got["health"]["devices"] == WORLD and one["health"]["devices"] == 1
    assert max(extra.get("coalesced", 1) for _, extra in got["sample"]) >= 2  # the window is 0.5 s
    for (rows, _), (want, _) in zip(got["sample"], one["sample"]):
        np.testing.assert_allclose(rows, want, atol=ATOL, rtol=0)
    for rows, want in zip(got["extend"], one["extend"]):
        np.testing.assert_allclose(rows, want, atol=ATOL, rtol=0)
    assert all(case["ranks"][r]["serve"] == {} for r in range(1, WORLD))


def test_the_cli_starts_its_ranks_and_returns_rank_0s_record(case):
    """``sample.main`` with ``--ranks 2`` spawns the ranks through the shared launcher and returns rank 0's record:
    the whole batch, as one rank samples it, and the GIFs it alone wrote."""
    out = case["root"] / "launched"
    got = sample.main(case["argv"]["sample"] + ["--ranks", "2", "--dist-backend", "gloo", "--output-path", str(out)])
    torch.testing.assert_close(got["videos"], case["one"]["sample_cli"]["videos"], rtol=0, atol=ATOL)
    assert sorted(p.name for p in got["paths"]) == sorted(p.name for p in out.iterdir()) == \
        [f"sample_{i}.gif" for i in range(ROWS)]
