"""Sharded training state of the port's trainer against one rank, on the CPU.

The JAX trainer stores its parameters, Adam's moments and the EMA by
PartitionSpecs (parallel/sharding.py:49-193); the port keeps each sharded
tensor's shard alone between steps, gathers the parameters for a step and
reduce-scatters the gradients (training/trainer.py). Four ranks run in one
spawn (gloo over ``file://`` stores; targets in ``torch_mesh_workers``,
which imports no JAX) at the fixture recipe of
tests/test_torch_data_parallel.py with ``fsdp_min_size_to_shard`` 256 (at
JAX's default 2**14 no tensor of the fixture shards): FSDP over 2 and 4 data
ranks, the last-dim rule over (data 2 x model 2), FSDP over 4 with a clip
that binds, and a 2-rank FSDP run resumed from a one-rank file. Checked
against the one-rank run of the same recipe, as the JAX package's tests
hold FSDP to DP (tests/test_trainer.py:392-409: rtol 2e-3):

* each rank's resident parameter, moments and EMA are its shard along the
  rule's dim, and the module holds none of them between steps;
* losses within rtol 2e-3 and the gathered state after every step as one
  rank's (each tensor within 1e-4 of its largest value);
* FSDP over 4 ranks against the JAX package's step on a 4-device CPU mesh
  with JAX's FSDP specs (``jax_mesh_steps``): the first gradient, losses,
  gradient norms, state and EMA, as tests/test_torch_data_parallel.py holds DP;
* a binding clip takes the global norm: the same step as one rank's;
* an EMA sample with the shards gathered: one rank's sampler from the same
  EMA (rank 0's) and generator (float32, atol 5e-5);
* a checkpoint written from shards has a one-rank file's keys and shapes,
  and its values (Adam's moments too) within 1e-4 of each tensor's largest;
* a run resumes 4 -> 1 and 1 -> 2 ranks, Adam's state included;
* one rank with ``num_model_shards`` 2 or 16 clamps with JAX's warning and
  trains, the shipped dim-128 recipes (``configs/config_tpu_v2_3.yaml``,
  ``configs/config_v2_3.yaml``) included at a cut width, which also build on
  (data 2 x model 2) through ``build_trainer``; a mesh the ranks or
  the batch do not fit, and ``flatten_optimizer`` with sharded state, raise.
"""

import logging

import numpy as np
import pytest
import torch
import yaml

import torch_mesh_workers
from torch_port_helpers import close_state, close_to_jax, jax_mesh_steps, mesh_model, mesh_recipe_spec, spawn_mesh_runs
from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint
from video_diffusion_nnx_tpu_torch.diffusion.gaussian_diffusion import BUFFER_NAMES
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup
from video_diffusion_nnx_tpu_torch.parallel.sharding import state_partition_specs
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

FSDP = {"param_sharding": "fsdp", "fsdp_min_size_to_shard": 256, "save_optimizer_state": True}
TP = {"num_model_shards": 2, "save_optimizer_state": True}
CLIP = 0.01
RUNS = [
    dict(name="fsdp2", world=2, trainer=FSDP, save=True, sample=(4,)),
    dict(name="fsdp4", world=4, trainer=FSDP, save=True),
    dict(name="dm22", world=4, trainer=TP, save=True),
    dict(name="clip4", world=4, trainer={**FSDP, "max_grad_norm": CLIP}),
    dict(name="resume12", world=2, first=3, steps=1, resume="one", trainer=FSDP),
]
LAYOUT = {"fsdp2": ("fsdp", 2, "data"), "fsdp4": ("fsdp", 4, "data"), "dm22": ("tensor", 2, "model")}


DIM128_RECIPES = ["configs/config_tpu_v2_3.yaml", "configs/config_v2_3.yaml"]


def cut_recipe(config: str, root, name: str) -> str:
    """A shipped dim-128 recipe (``num_model_shards: 2``) at a cut width: dim 8, mults (1, 2), 4 frames of 16x16, T = 10,
    on a seeded dataset of 8 clips."""
    cfg = load_config(config)
    cfg["unet"].update(dim=8, dim_mults=[1, 2])
    cfg["diffusion"].update(image_size=16, num_frames=4, timesteps=10)
    data = root / f"{name}.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, size=(4, 8, 16, 16), dtype=np.uint8))
    cfg["trainer"].update(dataset_path=str(data), num_frames=4, results_folder=str(root / name / "results"),
                          tensorboard_dir=str(root / name / "tb"), checkpoint_dir_path="", profile_flush_step=0)
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    spec = mesh_recipe_spec(root)
    runs = RUNS + [dict(name=f"recipe{i}", world=4, kind="build", config=cut_recipe(c, root, f"recipe{i}"))
                   for i, c in enumerate(DIM128_RECIPES)]
    one = torch_mesh_workers.run(None, spec, "one", trainer={"save_optimizer_state": True}, save=True)
    one_clip = torch_mesh_workers.run(None, spec, "one_clip", trainer={"max_grad_norm": CLIP})
    one_next = torch_mesh_workers.run(None, spec, "one_next", first=3, steps=1, resume="one",
                                      trainer={"save_optimizer_state": True})
    ranks = spawn_mesh_runs(root, spec, runs)
    four_to_one = torch_mesh_workers.run(None, spec, "r41", first=3, steps=1, resume="fsdp4",
                                         trainer={"save_optimizer_state": True})
    return {"root": root, "spec": spec, "one": one, "one_clip": one_clip, "one_next": one_next, "ranks": ranks,
            "four_to_one": four_to_one}


@pytest.mark.parametrize("name", list(LAYOUT))
def test_resident_shards_follow_the_rule(case, name):
    rule, size, axis = LAYOUT[name]
    model = mesh_model(case["spec"]["state"])
    specs = state_partition_specs(model, rule, size, FSDP["fsdp_min_size_to_shard"])
    full = model.state_dict()
    world = RUNS[[r["name"] for r in RUNS].index(name)]["world"]
    for r in range(world):
        got = case["ranks"][r][name]
        assert got["mesh"] == ({"data": size, "model": 1} if axis == "data" else {"data": 2, "model": 2})
        resident = got["resident_after"]
        assert set(resident) == {k for k, d in specs.items() if d is not None} and resident
        for k, shapes in resident.items():
            want = list(full[k].shape)
            want[specs[k]] //= size
            for what in ("param", "ema", "exp_avg", "exp_avg_sq"):
                unused = what.startswith("exp") and k not in case["one"]["grads"]  # compat math's position bias
                assert shapes[what] == (None if unused else tuple(want)), (r, k, what, shapes)
            assert shapes["module"] == (0,), (r, k)  # the gathered weights are released after the step
        resident_bytes = sum(np.prod(s["param"]) for s in resident.values())
        assert resident_bytes * size == sum(full[k].numel() for k in resident)


@pytest.mark.parametrize("name,ref", [("fsdp2", "one"), ("fsdp4", "one"), ("dm22", "one"), ("clip4", "one_clip")])
def test_sharded_steps_match_one_rank(case, name, ref):
    want, got = case[ref], case["ranks"][0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=2e-3)
    for step in range(len(want["losses"])):
        close_state(got["states"][step], want["states"][step], case["spec"]["state"], want["grads"], step, name)
        close_state(got["emas"][step], want["emas"][step], case["spec"]["state"], want["grads"], step, name + " ema")
    world = RUNS[[r["name"] for r in RUNS].index(name)]["world"]
    for r in range(1, world):  # every rank gathers the same state
        other = case["ranks"][r][name]
        assert other["losses"] == got["losses"]
        for k, v in got["states"][-1].items():
            assert torch.equal(other["states"][-1][k], v), (r, k)
    if name == "clip4":
        assert min(want["norms"]) > 10 * CLIP  # the clip binds at every step


def test_fsdp_steps_match_the_jax_fsdp_mesh_step(case):
    """FSDP over 4 ranks against the JAX step on a 4-device CPU mesh with JAX's FSDP specs (the same minimum size),
    on the same weights, batches, t and noise."""
    want = jax_mesh_steps(case["spec"], "fsdp", fsdp_min_size=FSDP["fsdp_min_size_to_shard"])
    assert want["sharded"] == len(case["ranks"][0]["fsdp4"]["resident"])  # the same tensors sharded on both sides
    close_to_jax(case["ranks"][0]["fsdp4"], want, case["spec"]["state"], "fsdp4")


def test_sampling_with_sharded_ema_matches_one_rank(case):
    for r in range(2):
        got = case["ranks"][r]["fsdp2"]
        want = mesh_model(got["emas"][-1]).sample(
            batch_size=4, generator=torch.Generator().manual_seed(torch_mesh_workers.SAMPLE_SEED))
        torch.testing.assert_close(got["samples"][0], want, rtol=0, atol=5e-5)


def _close_moments(got: dict, want: dict, noise: set, what: str) -> None:
    assert set(got["state"]) == set(want["state"]) and got["param_groups"] == want["param_groups"]
    for i, w in want["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            g, v = got["state"][i][name], w[name]
            assert g.shape == v.shape, (what, i, name)
            if i in noise:
                continue
            tol = 1e-4 * max(float(v.abs().max()), 1e-30)
            assert float((g - v).abs().max()) <= tol, (what, i, name)


@pytest.mark.parametrize("name", list(LAYOUT))
def test_checkpoint_from_shards_is_a_one_rank_file(case, name):
    root = case["root"]
    want = read_checkpoint(root / "one" / "checkpoints" / "step_3.pt")
    got = read_checkpoint(root / name / "checkpoints" / "step_3.pt")
    assert got["step"] == want["step"] == 3
    grads = case["one"]["grads"]
    for part in ("model", "ema_params"):
        assert {k: v.shape for k, v in got[part].items()} == {k: v.shape for k, v in want[part].items()}
        close_state(got[part], want[part], case["spec"]["state"], grads, 2, f"{name} {part}")
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 3
    model = mesh_model()  # Adam's state is indexed by the trainer's list: the parameters, then the schedule buffers
    trained = [k for k, _ in model.named_parameters()] + list(BUFFER_NAMES)
    global_norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    noise = {i for i, k in enumerate(trained) if k in grads and float(grads[k].norm()) <= 1e-6 * global_norm}
    assert set(want["optimizer"]["adam"]["state"]) == {i for i, k in enumerate(trained) if k in grads}
    _close_moments(got["optimizer"]["adam"], want["optimizer"]["adam"], noise, name)


def test_resume_across_world_sizes(case):
    """4 -> 1 (the FSDP run's file into one rank) and 1 -> 2 (the one-rank file into 2 FSDP ranks): step 4 as the
    one-rank run resumed from its own file, Adam's state included."""
    want = case["one_next"]
    for what, got in (("4 -> 1", case["four_to_one"]), ("1 -> 2", case["ranks"][0]["resume12"])):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3, err_msg=what)
        close_state(got["states"][0], want["states"][0], case["spec"]["state"], case["one"]["grads"], 3, what)
        assert not any("fresh optimizer" in m for m in got["warnings"]), (what, got["warnings"])


@pytest.mark.parametrize("shards", [2, 16])
def test_one_rank_clamps_the_model_shards(tmp_path, caplog, shards):
    spec = mesh_recipe_spec(tmp_path)
    with caplog.at_level(logging.WARNING):
        out = torch_mesh_workers.run(None, spec, "clamped", steps=1, trainer={"num_model_shards": shards})
    assert f"num_model_shards={shards} exceeds the 1 available rank(s); clamping to 1" in caplog.text
    assert out["mesh"] is None and out["resident"] == {} and np.isfinite(out["losses"][0])


@pytest.mark.parametrize("config", DIM128_RECIPES)
def test_the_dim128_recipes_build_and_train_on_one_rank(tmp_path, caplog, config):
    """The shipped recipes with ``num_model_shards: 2``, at a cut width (dim 8, 16x16, 4 frames) on the CPU."""
    path = cut_recipe(config, tmp_path, "recipe")
    assert load_config(path)["trainer"]["num_model_shards"] == 2
    with caplog.at_level(logging.WARNING):
        _, _, tr = build_trainer(load_config(path), device="cpu")
    assert "num_model_shards=2 exceeds the 1 available rank(s); clamping to 1" in caplog.text
    loss, _ = tr.train_step(next(tr.dl))
    assert tr.mesh is None and not tr.shards and bool(torch.isfinite(loss))


@pytest.mark.parametrize("index", range(len(DIM128_RECIPES)))
def test_the_dim128_recipes_build_on_data_2_by_model_2(case, index):
    """The same recipes through ``build_trainer`` on 4 ranks: (data 2 x model 2), every rank's kernels and biases in
    halves, one step from the loader (1 row a rank at batch 4)."""
    for r in range(4):
        got = case["ranks"][r][f"recipe{index}"]
        assert got["mesh"] == {"data": 2, "model": 2} and got["shards"] > 0 and np.isfinite(got["loss"])
        assert all(s["param"] == s["ema"] for s in got["resident"].values())
    assert len({case["ranks"][r][f"recipe{index}"]["loss"] for r in range(4)}) == 1


@pytest.mark.parametrize("kw,error", [
    (dict(num_model_shards=2, train_batch_size=3, sequence_group=SequenceGroup(0, 3, "gloo", torch.device("cpu"))),
     "num_model_shards=2 does not divide 3 ranks"),
    (dict(train_batch_size=3, sequence_group=SequenceGroup(0, 2, "gloo", torch.device("cpu"))),
     "must be divisible by the number of ranks 2"),
    (dict(flatten_optimizer=True, param_sharding="fsdp"), "flatten_optimizer supports replicated parameters only"),
    (dict(flatten_optimizer=True, num_model_shards=2), "flatten_optimizer supports replicated parameters only"),
    (dict(num_model_shards=2, sequence_parallel_size=2, sequence_group=SequenceGroup(0, 4, "gloo", torch.device("cpu"))),
     "composes with data parallelism only"),
    (dict(param_sharding="zero"), "param_sharding must be"),
])
def test_layouts_that_do_not_fit_raise(tmp_path, kw, error):
    spec = mesh_recipe_spec(tmp_path)
    base = {**spec["trainer"], "train_batch_size": 4, "results_folder": str(tmp_path / "results"),
            "tensorboard_dir": str(tmp_path / "tb")}
    with pytest.raises(ValueError, match=error):
        Trainer(mesh_model(spec["state"]), folder=str(tmp_path), **{**base, **kw})
