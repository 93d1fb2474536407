"""Distillation over data ranks, on the CPU: progressive distillation (stage 1, and stage 2 with a per-sample w)
and guidance distillation over four gloo ranks against the JAX package's steps on a 4-device ``'data'`` mesh.

JAX's steps shard the batch (and the condition) over ``'data'`` and all-reduce the gradient
(training/distill.py:12-16, 282-292; training/guidance.py:149-160). Here four ranks run in one spawn (gloo over
``file://`` stores; the target ``torch_mesh_workers.distill_case`` imports no JAX), each on one row of a batch
of 4 of the fixture recipe (v-prediction, T = 10, every bias drawn non-zero; tests/torch_port_helpers.py
``distill_models``), with the whole batch's draws of each step's JAX key injected (``i``, ``eps``, ``w`` or ``t``,
``eps``, ``w``). Three steps each, Adam at lr 1e-4, stage 1 with the EMA at 0.9. Checked: every loss within atol
5e-5 of JAX's, the state and the EMA after every step by ``close_state`` (each tensor within 1e-4 of its largest
value), and the student's parameters, EMA and Adam's moments bit-equal over the ranks.

The same spawn runs both distillation CLIs' ``run_rank`` over four ranks (the tiny recipe of
tests/test_torch_distill_cli.py at batch 4: every rank reads the same seeded batches and keeps its row) against their
one-rank runs: the losses (atol 5e-5) and the students rank 0 alone writes, the distance between the two runs'
parameters within 0.02 of the one-rank run's update from the initial student, all tensors as one vector (Adam moves
every element by about lr, so an element whose consecutive gradients nearly cancel takes the rounding of the
reduction order whole: at a zero-initialized guidance output layer that is more than 1e-4 of the tensor; a gradient
left unreduced moves every element by another lr); a batch that does not divide runs unsharded on every rank, with a
warning.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from test_torch_distill_cli import _captioned_gifs, _config
from torch_distill_checks import N, W_RANGE
from torch_distill_checks import jax_draws as progressive_draws
from torch_port_helpers import (CHANNELS, DIM, DIM_MULTS, DISTILL_COND, FRAMES, IMAGE_SIZE, MESH_LR, TIMESTEPS,
                                close_state, distill_models, distill_shape, flat_nnx_state, seeded, spawn_mesh_runs)
from video_diffusion_nnx_tpu.parallel.mesh import data_parallel_mesh
from video_diffusion_nnx_tpu.training import distill as jd
from video_diffusion_nnx_tpu.training import guidance as jg
from video_diffusion_nnx_tpu_torch import distill, distill_guidance
from video_diffusion_nnx_tpu_torch.convert import read_checkpoint, state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.models import text
from video_diffusion_nnx_tpu_torch.parallel import SequenceGroup

WORLD, ROWS, STEPS, EMA = 4, 4, 3, 0.9
UPDATE_TOL = 0.02  # the CLI runs' parameters apart, over the one-rank run's update
DIFFUSION = dict(image_size=IMAGE_SIZE, num_frames=FRAMES, channels=CHANNELS, timesteps=TIMESTEPS, loss_type="l2",
                 prediction_type="v")
UNET = dict(dim=DIM, dim_mults=DIM_MULTS, channels=CHANNELS)
W_UNET = dict(UNET, cond_dim=DISTILL_COND, guidance_embed=True)


def _t(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _batches(conditioned: bool, seed: int):
    shape = distill_shape("unet", ROWS)
    for n in range(STEPS):
        x = np.random.default_rng(seed + n).uniform(size=shape).astype(np.float32)
        yield x, seeded((ROWS, DISTILL_COND), seed + 10 + n) if conditioned else None, jax.random.PRNGKey(seed + 20 + n)


def _port_state(model, tree, full=None) -> dict:
    return state_dict_from_nnx({**(full or {}), **flat_nnx_state(tree)}, model)


def _progressive(kind: str):
    """JAX ``build_distill_step`` on the mesh, three steps; the run's spec and JAX's losses, states and EMAs."""
    jm, pm = distill_models(kind)
    stage2 = kind.endswith("_w")
    w_range = W_RANGE if stage2 else None
    graphdef, t_state = nnx.split(jm)
    tx = optax.adam(MESH_LR)
    step_fn = jd.build_distill_step(graphdef, tx, TIMESTEPS, N, mesh=data_parallel_mesh(WORLD), conditioned=stage2,
                                    w_range=w_range, ema_decay=EMA)
    s_state = jd.copy_state(t_state)
    opt_state = tx.init(jd.split_trainable(s_state)[0])
    ema = jd.copy_state(jd.split_trainable(s_state)[0])
    full = flat_nnx_state(t_state)
    steps, want = [], {"losses": [], "states": [], "emas": []}
    for x, cond, key in _batches(stage2, 40):
        batch = (jnp.asarray(x), jnp.asarray(cond)) if stage2 else jnp.asarray(x)
        s_state, opt_state, ema, loss = step_fn(s_state, opt_state, ema, t_state, batch, key)
        i, eps, w = progressive_draws(key, x.shape, w_range=w_range)
        draws = {"i": _t(i), "eps": _t(eps), **({"w": _t(w)} if stage2 else {})}
        steps.append((torch.from_numpy(x), None if cond is None else torch.from_numpy(cond), draws))
        want["losses"].append(float(loss))
        want["states"].append(_port_state(pm, s_state))
        want["emas"].append(_port_state(pm, ema, full))
    spec = {"unet": W_UNET if stage2 else UNET, "diffusion": DIFFUSION, "teacher": pm.state_dict(), "n": N,
            "lr": MESH_LR, "w_range": w_range, "ema_decay": EMA, "steps": steps}
    return spec, want


def _guidance():
    """JAX ``build_guidance_distill_step`` on the mesh, three steps (as tests/test_torch_guidance.py pairs them)."""
    jt, pt = distill_models("unet_cond")
    js, ps = distill_models("unet_w", seed=8)
    s_state = jg.transfer_teacher_params(js, nnx.split(jt)[1])
    ps.load_state_dict(state_dict_from_nnx(flat_nnx_state(s_state), ps))
    t_graphdef, t_state = nnx.split(jt)
    tx = optax.adam(MESH_LR)
    step_fn = jg.build_guidance_distill_step(nnx.graphdef(js), t_graphdef, tx, TIMESTEPS, w_range=W_RANGE,
                                             mesh=data_parallel_mesh(WORLD))
    state = jd.copy_state(s_state)
    opt_state = tx.init(jd.split_trainable(state)[0])
    steps, want = [], {"losses": [], "states": [], "emas": []}
    for x, cond, key in _batches(True, 60):
        state, opt_state, loss = step_fn(state, opt_state, t_state, jnp.asarray(x), jnp.asarray(cond), key)
        t_key, eps_key, w_key = jax.random.split(key, 3)
        draws = {"t": _t(jax.random.randint(t_key, (ROWS,), 0, TIMESTEPS)),
                 "eps": _t(jax.random.normal(eps_key, x.shape)),
                 "w": _t(jax.random.uniform(w_key, (ROWS,), minval=W_RANGE[0], maxval=W_RANGE[1]))}
        steps.append((torch.from_numpy(x), torch.from_numpy(cond), draws))
        want["losses"].append(float(loss))
        want["states"].append(_port_state(ps, state))
    spec = {"unet": dict(UNET, cond_dim=DISTILL_COND), "student_unet": W_UNET, "diffusion": DIFFUSION,
            "teacher": pt.state_dict(), "student": ps.state_dict(), "lr": MESH_LR, "w_range": W_RANGE, "steps": steps}
    return spec, want


RUNS = ("stage1", "stage2", "guidance")


def _teacher(root, cfg, name: str, step: int = 7):
    """A checkpoint of the config's model with every bias drawn non-zero (EMA 0.9 of the weights), as
    ``distill_models`` draws them: Adam moves each element by about lr whatever its gradient, so a zero tensor would
    be compared where rounding decides the sign."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import save_checkpoint

    _, diffusion = build_models(load_config(cfg), device="cpu")
    rng = np.random.default_rng(step)
    with torch.no_grad():
        for k, v in diffusion.named_parameters():
            if k.endswith(".bias"):
                v.add_(torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32)))
    return save_checkpoint(root / name / f"step_{step}.pt", diffusion,
                           ema_state={k: v * 0.9 for k, v in diffusion.state_dict().items()}, step=step)


def _cli_argv(root) -> dict:
    """Each distillation CLI's arguments at the tiny recipe, batch 4 (the run adds ``--output-path``)."""
    np.save(root / "clips.npy", np.random.default_rng(0).integers(0, 256, size=(4, 6, 16, 16), dtype=np.uint8))
    cfg = _config(root, "tiny", root / "clips.npy")
    cond_cfg = _config(root, "cond", _captioned_gifs(root / "gifs"), use_bert_text_cond=True)
    common = ["--device", "cpu", "--batch-size", str(ROWS), "--lr", str(MESH_LR), "--seed", "3"]
    return {"distill": ["--config", str(cfg), "--checkpoint-path", str(_teacher(root, cfg, "teacher")),
                        "--initial-steps", "4", "--rounds", "1", "--steps-per-round", "2", *common],
            "distill_guidance": ["--config", str(cond_cfg), "--checkpoint-path",
                                 str(_teacher(root, cond_cfg, "cond_teacher", step=11)), "--num-steps", "2",
                                 *common]}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_distill")
    specs, want = {}, {}
    for name, make in (("stage1", lambda: _progressive("unet")), ("stage2", lambda: _progressive("unet_w")),
                       ("guidance", _guidance)):
        specs[name], want[name] = make()
    argv = _cli_argv(root)
    runs = [*(dict(name=name, world=WORLD, kind="distill") for name in RUNS),
            *(dict(name=cli, world=WORLD, kind="cli", module=cli, argv=a + ["--output-path", str(root / f"{cli}_ranks")])
              for cli, a in argv.items())]
    ranks = spawn_mesh_runs(root, {"distill": specs}, runs)
    text_hf, text._hf = text._hf, False  # as the ranks embed the captions
    try:
        one = {cli: module.main(argv[cli] + ["--output-path", str(root / f"{cli}_one")])
               for cli, module in (("distill", distill), ("distill_guidance", distill_guidance))}
    finally:
        text._hf = text_hf
    return {"ranks": ranks, "jax": want, "specs": specs, "one": one, "argv": argv}


@pytest.mark.parametrize("name", RUNS)
def test_distillation_over_four_ranks_matches_the_jax_mesh(case, name):
    got, want = case["ranks"][0][name], case["jax"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=5e-5, rtol=0, err_msg=name)
    spec = case["specs"][name]
    init = spec.get("student", spec["teacher"])
    for step in range(STEPS):
        close_state(got["states"][step], {k: want["states"][step][k] for k in got["states"][step]}, init,
                    got["grads"], step, name)
        if want["emas"]:
            close_state(got["emas"][step], {k: want["emas"][step][k] for k in got["emas"][step]}, init,
                        got["grads"], step, name + " ema")


@pytest.mark.parametrize("name", RUNS)
def test_replicated_state_is_bit_equal_over_the_ranks(case, name):
    """One all-reduce a step leaves every rank the same losses, parameters, EMA and Adam moments, bit for bit."""
    first = case["ranks"][0][name]
    for r in range(1, WORLD):
        got = case["ranks"][r][name]
        assert got["losses"] == first["losses"]
        for part in ("states", "emas"):
            for k, v in (first[part][-1] if first[part] else {}).items():
                assert torch.equal(got[part][-1][k], v), (r, part, k)
        for k, moments in first["adam"].items():
            assert all(torch.equal(a, b) for a, b in zip(got["adam"][k], moments)), (r, k)


def _files(res: dict) -> list:
    return list(res["paths"].values()) if "paths" in res else [p for p in (res["path"],) if p is not None]


def _initial_student(cli: str, argv: list) -> dict:
    """The student's state before the CLI's first step: the teacher's (progressive), or the teacher's grafted into
    the ``guidance_embed`` student (guidance)."""
    import copy

    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.training.guidance import transfer_teacher_params

    module = {"distill": distill, "distill_guidance": distill_guidance}[cli]
    args = module.parse_args(argv)
    config = load_config(args.config)
    teacher, _ = distill.load_teacher(config, args.checkpoint_path, None, not args.no_ema, torch.device("cpu"))
    if cli == "distill":
        return teacher.state_dict()
    student_config = copy.deepcopy(config)
    student_config["unet"]["guidance_embed"] = True
    _, student = build_models(student_config, device="cpu")
    return transfer_teacher_params(student, teacher).state_dict()


@pytest.mark.parametrize("cli", ["distill", "distill_guidance"])
def test_distillation_cli_over_four_ranks_matches_one_rank(case, cli):
    """``run_rank`` on four ranks of a row each: the losses and the student file as the one-rank CLI's; rank 0
    alone writes it."""
    one = case["one"][cli]
    ranks = [case["ranks"][r][cli] for r in range(WORLD)]
    losses = [r["losses"] for r in (one["rounds"] if cli == "distill" else [one])]
    for r, got in enumerate(ranks):
        got_losses = [x["losses"] for x in (got["rounds"] if cli == "distill" else [got])]
        np.testing.assert_allclose(got_losses, losses, atol=5e-5, rtol=0, err_msg=f"{cli} rank {r}")
        assert len(_files(got)) == (1 if r == 0 else 0), (r, _files(got))
    (path,), (want_path,) = _files(ranks[0]), _files(one)
    got, want = read_checkpoint(path), read_checkpoint(want_path)
    init = _initial_student(cli, case["argv"][cli])
    for part in ("model", "ema_params"):
        assert set(got[part]) == set(want[part]) == set(init)
        num = sum(float((got[part][k].double() - w.double()).square().sum()) for k, w in want[part].items())
        den = sum(float((w.double() - init[k].double()).square().sum()) for k, w in want[part].items())
        assert den > 0 and (num / den) ** 0.5 <= UPDATE_TOL, (part, (num / den) ** 0.5)


def test_a_distillation_batch_that_does_not_divide_runs_unsharded(caplog):
    """JAX's CLIs pass no mesh where the batch does not divide the data axis: every rank runs it whole, warned."""
    group = SequenceGroup(rank=1, world_size=WORLD, backend="gloo", device=torch.device("cpu"))
    with caplog.at_level(logging.WARNING):
        assert distill.row_group(group, 3) is None
    assert "distillation batch 3 does not divide across 4 data ranks" in caplog.text
    assert distill.row_group(group, 8) is group and distill.row_group(None, 3) is None
