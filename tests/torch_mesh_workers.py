"""Rank functions of tests/test_torch_data_parallel.py, tests/test_torch_sharded_state.py,
tests/test_torch_dp_sampling.py and tests/test_torch_dp_distill.py, run in spawned processes.

This module imports the port alone, never JAX: a spawned rank imports it to
find its target. The test process saves a spec (the fixture recipe's
weights, a dataset, the injected batches and a list of runs), spawns four
ranks over ``file://`` stores, and compares what each rank saves with the
port's one-rank run of the same recipe, which :func:`run` also computes in
the test process (``group`` None). A run of fewer ranks than four leaves
the others idle; each run joins a world of its own and leaves it.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from video_diffusion_nnx_tpu_torch.data.loader import rank_rows
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import Unet3D
from video_diffusion_nnx_tpu_torch.parallel import destroy_sequence_group, init_sequence_group
from video_diffusion_nnx_tpu_torch.training import trainer as trainer_module
from video_diffusion_nnx_tpu_torch.training.metrics import JsonlSummaryWriter
from video_diffusion_nnx_tpu_torch.training.trainer import Trainer

SAMPLE_SEED = 11


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _grads(tr: Trainer) -> dict:
    """The reduced gradient of every trained tensor as a whole tensor (the shards' gathered: a collective)."""
    out = {k: p.grad.clone() for k, p in tr.live.items() if p.grad is not None and k not in tr.shards}
    shards = {k: v.grad for k, v in tr.shards.items() if v.grad is not None}
    out.update(tr._gather(shards) if shards else {})
    return out


def _resident(tr: Trainer) -> dict:
    """This rank's stored shapes of every sharded tensor: the parameter shard, Adam's moments and the EMA."""
    state = tr.optimizer.state
    return {k: {"param": tuple(v.shape), "ema": tuple(tr.ema_state[k].shape),
                "exp_avg": tuple(state[v]["exp_avg"].shape) if v in state else None,
                "exp_avg_sq": tuple(state[v]["exp_avg_sq"].shape) if v in state else None,
                "module": tuple(tr.model.state_dict()[k].shape)}
            for k, v in tr.shards.items()}


def run(group, spec: dict, name: str, world: int = 1, steps: int = 3, first: int = 0, sample: tuple = (),
        gifs: bool = False, save: bool = False, resume: str | None = None, trainer: dict | None = None,
        unet: dict | None = None, focus: float = 0.0) -> dict:
    """One run of the recipe: ``steps`` injected steps from step ``first`` (after resuming from run ``resume``'s
    checkpoint at ``first``), then EMA samples of ``sample`` rows each, the loop's sample GIFs when ``gifs``, then
    a checkpoint when ``save``. ``focus`` is each step's ``prob_focus_present``."""
    del world
    diffusion = GaussianDiffusion(Unet3D(**{**spec["unet"], **(unet or {})}), **spec["diffusion"])
    diffusion.load_state_dict(spec["state"])
    root = Path(spec["root"])
    kw = {**spec["trainer"], **(trainer or {})}
    ckpt_dir = root / (resume or name) / "checkpoints"
    records = _Records()
    logging.getLogger("video_diffusion_nnx_tpu_torch").addHandler(records)
    # Rank 0's metrics as JSONL: TensorBoard's writer imports TensorFlow where it is installed, some 15 s a process.
    writer, trainer_module.create_summary_writer = trainer_module.create_summary_writer, JsonlSummaryWriter
    try:
        tr = Trainer(diffusion, folder=str(root / name), results_folder=str(root / name / "results"),
                     tensorboard_dir=str(root / name / "tb"), checkpoint_dir_path=str(ckpt_dir),
                     resume_training_step=first, sequence_group=group, **kw)
        if save and resume is not None:  # write this run's own checkpoints beside the one it resumed from
            tr.checkpoint_dir_path = root / name / "checkpoints"
        rows = None
        if tr.row_group is not None and tr.row_group.world_size > 1:
            rows = rank_rows(kw["train_batch_size"], tr.row_group.world_size, tr.row_group.rank, tr.accumulate)
        out = {"losses": [], "norms": [], "states": [], "emas": [], "resident": _resident(tr),
               "is_main": tr.is_main, "mesh": None if tr.mesh is None else dict(tr.mesh.shape)}
        for x, t, noise in spec["steps"][first:first + steps]:
            loss, norm = tr.train_step(x if rows is None else x[rows], t=t, noise=noise, prob_focus_present=focus)
            if tr.step == first:
                out["grads"] = _grads(tr)
            tr.step += 1
            model, ema = tr.full_state()  # the live tensors where they are whole: copied, as Adam updates them in place
            out["losses"].append(loss.item())
            out["norms"].append(norm.item())
            out["states"].append({k: v.clone() for k, v in model.items()})
            out["emas"].append({k: v.clone() for k, v in ema.items()})
        out["resident_after"] = _resident(tr)
        out["samples"] = [tr.sample_batch(n, generator=torch.Generator().manual_seed(SAMPLE_SEED)) for n in sample]
        if gifs:
            tr._sample_and_save()
            out["sample_paths"] = [str(p) for p in tr.sample_paths.get(tr.step, [])]
        if save:
            tr.save()
        out["warnings"] = records.messages
        out["stats"] = dict(group.stats) if group is not None else None
        return out
    finally:
        trainer_module.create_summary_writer = writer
        logging.getLogger("video_diffusion_nnx_tpu_torch").removeHandler(records)


def loss_case(group, spec: dict, name: str, world: int = 1) -> dict:
    """One loss and backward of the recipe's Unet3D in fixed math, conditioned, with both masks drawn (the focus
    mask and the condition's dropout, each at probability 0.5) on this rank's rows; the loss and the gradients summed
    over the ranks."""
    del name, world
    unet = Unet3D(**spec["unet"], reference_compat=False, cond_dim=spec["cond_dim"])
    unet.reset_parameters(torch.Generator().manual_seed(3))
    diffusion = GaussianDiffusion(unet, **spec["diffusion"])
    x, cond = spec["steps"][0][0], spec["cond"]
    if group is not None:
        diffusion.data_group = group
        rows = group.rows(x.shape[0])
        x, cond = x[rows], cond[rows]
    loss = diffusion(x, generator=torch.Generator().manual_seed(9), cond=cond, null_cond_prob=0.5,
                     prob_focus_present=0.5)
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in diffusion.named_parameters()}
    if group is not None:
        loss = group.all_reduce(loss.detach())
        grads = {k: group.all_reduce(g) for k, g in grads.items()}
    return {"loss": loss.item(), "grads": grads}


def build_case(group, spec: dict, name: str, world: int = 1, config: str = "") -> dict:
    """``config.build_trainer`` of a recipe file on this rank's group, then one step from its loader."""
    del spec, name, world
    from video_diffusion_nnx_tpu_torch.config import build_trainer, load_config

    writer, trainer_module.create_summary_writer = trainer_module.create_summary_writer, JsonlSummaryWriter
    try:
        _, _, tr = build_trainer(load_config(config), device="cpu", sequence_group=group)
        loss, _ = tr.train_step(next(tr.dl))
        return {"mesh": dict(tr.mesh.shape), "shards": len(tr.shards), "loss": loss.item(),
                "resident": _resident(tr)}
    finally:
        trainer_module.create_summary_writer = writer


def sampler_model(spec: dict, group=None) -> GaussianDiffusion:
    """The sampling tests' model (the fixture recipe with the JAX model's weights) on ``group``'s rows."""
    m = GaussianDiffusion(Unet3D(**spec["unet"]), **spec["diffusion"])
    m.load_state_dict(spec["state"])
    m.eval().data_group = group
    return m


def sampler_case(group, spec: dict, name: str, world: int = 1, call: str = "ddim", rows: int = 4,
                 kwargs: dict | None = None) -> dict:
    """One sampler call of ``rows`` rows over ``group`` (``call``: "ddim", or "cond" on the spec's known frames),
    with ``kwargs`` (a generator seeded with ``seed`` where one is given); the gathered batch and the warnings."""
    del name, world
    kw = dict(kwargs or {})
    if "seed" in kw:
        kw["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
    m = sampler_model(spec, group)
    records = _Records()
    logging.getLogger("video_diffusion_nnx_tpu_torch").addHandler(records)
    try:
        if call == "ddim":
            out = m.ddim_sample(batch_size=rows, **kw)
        else:
            out = m.sample_conditional_frames(spec["known"][:rows], spec["mask"], **kw)
        return {"out": m.gather_batch(out, rows), "part": tuple(out.shape), "warnings": records.messages}
    finally:
        logging.getLogger("video_diffusion_nnx_tpu_torch").removeHandler(records)


def serve_case(group, spec: dict, name: str, world: int = 1) -> dict:
    """The server over ``group``: rank 0 serves HTTP around the model and runs ``spec["requests"]`` (a /sample
    request from each of several threads at once, then each /extend request), the other ranks follow its calls;
    rank 0 returns /health and each request's rows."""
    import json
    import threading
    import urllib.request

    from video_diffusion_nnx_tpu_torch import serve

    del name, world
    model = sampler_model(spec)
    if group is not None and group.rank != 0:
        model.data_group = group
        serve.follow(model, group)
        return {}
    httpd = serve.create_server(model, port=0, batch_window_s=0.5, group=group)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen("http://%s:%d/health" % httpd.server_address[:2], timeout=60) as r:
            health = json.loads(r.read())
        service, reqs = httpd.service, spec["requests"]
        rows = [None] * len(reqs["sample"])

        def client(i):
            rows[i] = service.sample_rows(dict(reqs["sample"][i]))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return {"health": health, "sample": [(r[0], r[2]) for r in rows],
                "extend": [service.extend_rows(dict(req))[0] for req in reqs["extend"]]}
    finally:
        httpd.shutdown()
        httpd.server_close()  # releases the other ranks
        thread.join(timeout=60)


def distill_case(group, spec: dict, name: str, world: int = 1) -> dict:
    """Three steps of a distillation run ``spec["distill"][name]`` (progressive, stage 2 with w, or guidance) over
    ``group``, each rank on its rows of the batch and the condition with the whole batch's injected draws: every
    step's loss, the student's parameters and EMA, the first step's summed gradients and Adam's moments."""
    from video_diffusion_nnx_tpu_torch.training.distill import DistillStep
    from video_diffusion_nnx_tpu_torch.training.guidance import GuidanceStep

    del world
    d = spec["distill"][name]
    teacher = GaussianDiffusion(Unet3D(**d["unet"]), **d["diffusion"])
    teacher.load_state_dict(d["teacher"])
    teacher.eval()
    if "student" in d:
        student = GaussianDiffusion(Unet3D(**d["student_unet"]), **d["diffusion"])
        student.load_state_dict(d["student"])
        step = GuidanceStep(teacher, student.eval(), learning_rate=d["lr"], w_range=d["w_range"], group=group)
    else:
        step = DistillStep(teacher, d["n"], learning_rate=d["lr"], w_range=d["w_range"], ema_decay=d["ema_decay"],
                           group=group)
    names = [k for k, p in step.student.named_parameters() if p.requires_grad]
    out = {"losses": [], "states": [], "emas": []}
    for n, (x, cond, draws) in enumerate(d["steps"]):
        rows = slice(None) if group is None else group.rows(x.shape[0])
        loss = step(x[rows], None if cond is None else cond[rows], **draws)
        if n == 0:
            out["grads"] = {k: p.grad.clone() for k, p in zip(names, step.params) if p.grad is not None}
        out["losses"].append(loss.item())
        out["states"].append({k: p.detach().clone() for k, p in zip(names, step.params)})
        if step.ema is not None:
            out["emas"].append({k: e.clone() for k, e in zip(names, step.ema)})
    adam = step.optimizer.state
    out["adam"] = {k: [adam[p][m].clone() for m in ("exp_avg", "exp_avg_sq")] for k, p in zip(names, step.params)
                   if p in adam}
    return out


def cli_case(rank: int, spec: dict, name: str, world: int, init_method: str, module: str, argv: list) -> dict:
    """A CLI's ``run_rank`` (it joins and leaves its world itself), captions embedded by the hashed bag of words."""
    del spec, name
    import importlib

    from video_diffusion_nnx_tpu_torch.models import text

    text._hf = False  # no cached BERT here: skip the transformers import each process would try
    return importlib.import_module(f"video_diffusion_nnx_tpu_torch.{module}").run_rank(rank, world, "gloo",
                                                                                       init_method, argv)


def rank_main(rank: int, spec_path: str, out_dir: str) -> None:
    """One of four ranks: join each run's world that holds this rank, run it, leave; save the results."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    results = {}
    for case in spec["runs"]:
        if rank >= case["world"]:
            continue
        case = dict(case)
        kind = case.pop("kind", "run")
        store = f"file://{Path(out_dir) / ('store_' + case['name'])}"
        if kind == "cli":
            results[case["name"]] = cli_case(rank, spec, init_method=store, **case)
            continue
        group = init_sequence_group(rank, case["world"], "gloo", store, device_type="cpu")
        try:
            fn = {"run": run, "loss": loss_case, "build": build_case, "sampler": sampler_case,
                  "serve": serve_case, "distill": distill_case}[kind]
            results[case["name"]] = fn(group, spec, **case)
        finally:
            destroy_sequence_group()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def card_train_main(rank: int, world: int, init_method: str, data: str, out_dir: str, sharding: str) -> None:
    """One gloo rank on cuda:0 (every rank shares the card): two steps of a fused bf16 Unet3D (dim 32, mults (1, 2),
    10 frames of 32x32, batch 4) from the loader, data-parallel with ``param_sharding`` ``sharding``; saves the
    kernels' launches, the losses, each rank's resident shards and the gathered state."""
    from video_diffusion_nnx_tpu_torch import ops

    group = init_sequence_group(rank, world, "gloo", init_method, device_type="cuda")
    writer, trainer_module.create_summary_writer = trainer_module.create_summary_writer, JsonlSummaryWriter
    try:
        unet = Unet3D(dim=32, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", use_fused_attention=True,
                      use_fused_spatial_attention=True)
        unet.reset_parameters(torch.Generator().manual_seed(0))
        diffusion = GaussianDiffusion(unet, image_size=32, num_frames=10, channels=1, timesteps=100,
                                      loss_type="l2").to(group.device)
        root = Path(out_dir) / sharding
        tr = Trainer(diffusion, folder=str(root), dataset_path=data, train_batch_size=4, train_num_steps=2,
                     results_folder=str(root / "results"), tensorboard_dir=str(root / "tb"), profile_flush_step=0,
                     step_start_ema=0, update_ema_every=1, param_sharding=sharding, fsdp_min_size_to_shard=4096,
                     dataset_normalize=True, sequence_group=group)
        ops.reset_launch_counts()
        losses = [tr.train_step(next(tr.dl))[0].item() for _ in range(2)]
        torch.cuda.synchronize(group.device)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        staged = {k: v for k, v in ops.staged_launch_counts().items() if v}
        model, ema = tr.full_state()
        torch.save({"device": str(group.device), "losses": losses, "launches": launches, "staged": staged,
                    "resident": _resident(tr), "state": {k: v.cpu() for k, v in model.items()},
                    "ema": {k: v.cpu() for k, v in ema.items()}}, Path(out_dir) / f"{sharding}{rank}.pt")
    finally:
        trainer_module.create_summary_writer = writer
        destroy_sequence_group()


def card_dp_main(rank: int, world: int, init_method: str, out_dir: str, what: str) -> None:
    """One gloo rank on cuda:0 (every rank shares the card), its rows of a batch of 4 of a fused bf16 Unet3D (dim 32,
    mults (1, 2), 10 frames of 32x32): DDIM-5 sampled (``what`` "ddim", each rank replaying its own graph, the batch
    gathered) or two progressive-distillation steps (``what`` "distill", the whole batch's draws from one generator,
    one all-reduce a step); saves the kernels' launches and the result."""
    from video_diffusion_nnx_tpu_torch import ops
    from video_diffusion_nnx_tpu_torch.training.distill import DistillStep

    group = init_sequence_group(rank, world, "gloo", init_method, device_type="cuda")
    try:
        unet = Unet3D(dim=32, dim_mults=(1, 2), channels=1, compute_dtype="bfloat16", use_fused_attention=True,
                      use_fused_spatial_attention=True)
        unet.reset_parameters(torch.Generator().manual_seed(0))
        model = GaussianDiffusion(unet, image_size=32, num_frames=10, channels=1, timesteps=100, loss_type="l2",
                                  prediction_type="v").to(group.device).eval()
        gen = torch.Generator(device=group.device).manual_seed(1)
        ops.reset_launch_counts()
        if what == "ddim":
            model.data_group = group
            out = {"videos": model.gather_batch(model.ddim_sample(batch_size=4, num_steps=5, generator=gen), 4).cpu(),
                   "graph": {"captures": model.graphs.captures, "replays": model.graphs.replays()}}
        else:
            step = DistillStep(model, 4, generator=gen, group=group)
            x = torch.rand((4, 1, 10, 32, 32), generator=torch.Generator().manual_seed(2)).to(group.device)
            losses = [step(x[group.rows(4)]).item() for _ in range(2)]
            out = {"losses": losses, "params": [p.detach().cpu() for p in step.params]}
        torch.cuda.synchronize(group.device)
        out.update(device=str(group.device), launches={k: v for k, v in ops.launch_counts().items() if v},
                   staged={k: v for k, v in ops.staged_launch_counts().items() if v})
        torch.save(out, Path(out_dir) / f"{what}{rank}.pt")
    finally:
        destroy_sequence_group()
