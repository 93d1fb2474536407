"""The float32 temporal forward's routes at the shapes its 3xTF32 designs were made for, on one CUDA card.

    python scripts/torch_f32_fwd_routes.py [--parent DIR] [--iters 10] [--only NAME,...]

Times with CUDA events, in one call, every float32 temporal forward that a recipe sends to the staged dense or the
streaming kernel (route "staged-3xtf32": the products, and the streaming kernel's attention fragments, on the tensor
cores in split-precision TF32):

- D1's attentions at batch 8 (``d1``): temporal (8, 256, 16, 256) on the staged dense kernel, spatial
  (8, 16, 256, 256) on the streaming kernel, 8 x 32, six launches each a forward;
- D2's spatial attention at batch 4 (``d2_spatial``): (4, 10, 64, 384), 6 x 64, the streaming kernel in mode DENSE,
  eight launches a forward;
- the fixed flagship's ten biased forwards at f = 10, at batch 2 (``fixed_b2``, a sampler's forward) and 8
  (``fixed_b8``, a training step's);
- the fixed long clip's ten biased forwards at f = 128 (``long_fixed``);
- the two float32 forwards whose staged tile holds no token (``cuda_core``): D2's temporal attention (4, 64, 10, 384)
  6 x 64 and the fixed bottleneck (8, 10, 64, 256);
- the measured rule's ladder (``rule``): float32 forwards at 256 tokens whose staged tile holds no token, at f = 16,
  24, 32, 40 and 48 (8 x 32) and at f = 40 and 64 (head dim 64, c / 64 heads), c near the least the tile refuses.

At each shape: the planned route in float32 and in bf16 (the bf16 instantiations' times) and the plain version;
where the staged tile holds no token, the other kernel too, as the control of the measured rule
(``_f32_fwd_takes_stream``): the planner patched to the "wide" family (the streaming kernel in mode DENSE), or to
the dense one (the CUDA-core kernel) beside a build with ``VDT_ANY_F32_ROUTE`` defined, which leaves out the dense C
entry's check of the rule. Each route's
output is held against the plain version (1e-4 max-abs in float32, 0.05 in bf16) and its two runs must be
bit-equal. With ``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive`` under ``build/``) the
parent's planned routes are timed at the same shapes in a process of their own before and after this tree's
(parent, change, parent), the parent's kernels built from DIR's sources. Bounds: the bytes the function must move
over 3.35 TB/s against its FLOPs over 67 TFLOP/s (float32 on the CUDA cores) and over 495 / 3 TFLOP/s (three TF32
products per float32 product), and in bf16 over 989 TFLOP/s. Per group the times are also summed per forward with
each shape's launches. ``--ddim`` adds D1's DDIM-50 at batch 8, graph-replayed (ms a sampler step, host clock).
Prints one JSON line and writes it to chiprun_out/torch_f32_fwd_routes/result.json. Exits non-zero without a card
or where a check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out" / "torch_f32_fwd_routes"
FIXED_LEVELS = [(3, 4096, 10, 32), (1, 1024, 10, 64), (1, 256, 10, 128), (2, 64, 10, 256), (1, 64, 10, 128),
                (1, 256, 10, 64), (1, 1024, 10, 32)]
# group: (biased, [(launches a forward, (b, s, f, c), heads, head dim), ...])
GROUPS = {
    "d1": (False, [(6, (8, 256, 16, 256), 8, 32), (6, (8, 16, 256, 256), 8, 32)]),
    "d2_spatial": (False, [(8, (4, 10, 64, 384), 6, 64)]),
    "fixed_b2": (True, [(n, (2, s, f, c), 8, 32) for n, s, f, c in FIXED_LEVELS]),
    "fixed_b8": (True, [(n, (8, s, f, c), 8, 32) for n, s, f, c in FIXED_LEVELS]),
    "long_fixed": (True, [(3, (1, 4096, 128, 32), 8, 32), (1, (1, 1024, 128, 64), 8, 32),
                          (1, (1, 256, 128, 128), 8, 32), (2, (1, 64, 128, 256), 8, 32),
                          (1, (1, 64, 128, 128), 8, 32), (1, (1, 256, 128, 64), 8, 32),
                          (1, (1, 1024, 128, 32), 8, 32)]),
    "cuda_core": (False, [(8, (4, 64, 10, 384), 6, 64), (1, (8, 10, 64, 256), 8, 32)]),
    "rule": (False, [(1, (4, 64, 16, 512), 8, 32), (1, (4, 64, 24, 384), 8, 32), (1, (4, 64, 32, 384), 8, 32),
                     (1, (4, 64, 40, 256), 8, 32), (1, (4, 64, 48, 320), 8, 32), (1, (4, 64, 40, 192), 3, 64),
                     (1, (4, 64, 64, 128), 2, 64)]),
}
GATE = {"float32": 1e-4, "bfloat16": 0.05}
PEAK_BYTES, PEAK_F32, PEAK_TF32X3, PEAK_BF16 = 3.35e12, 67e12, 495e12 / 3, 989e12


def measure(root: Path, groups: list, iters: int, controls: bool) -> dict:
    """Every group's shapes through the package under ``root``: the planned route in both types, and with
    ``controls`` the other kernel where the staged tile holds no token (the streaming kernel in mode DENSE or the
    CUDA-core kernel) and the plain version in float32."""
    import torch

    sys.path.insert(0, str(root))
    from video_diffusion_nnx_tpu_torch import ops
    from video_diffusion_nnx_tpu_torch.ops import _build
    from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rand(shape, seed, scale):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    real_plan, real_library = ta.temporal_plan, _build.library

    def wide():  # the streaming kernel in mode DENSE where the planner gives the CUDA-core kernel
        def plan(tokens, f, c, dim, heads, bf16, sms_, backward):
            return {"family": "wide", **ta.blockwise_plan(tokens, f, c, dim, heads, bf16, sms_, backward, dense=True)}
        ta.temporal_plan = plan

    def dense():  # the CUDA-core kernel where the measured rule gives the streaming kernel
        def plan(tokens, f, c, dim, heads, bf16, sms_, backward):
            return {"family": "dense", **ta.fwd_plan(tokens, f, c, dim, heads, bf16, sms_)}
        ta.temporal_plan = plan
        _build.library = functools.partial(real_library, defines=("VDT_ANY_F32_ROUTE",))

    out = {}
    for group in groups:
        biased, shapes = GROUPS[group]
        rows_out = []
        for count, (b, s, f, c), heads, dim in shapes:
            hd, rows = heads * dim, b * s * f
            row = {"shape": [b, s, f, c], "heads": heads, "dim": dim, "bias": biased, "per_forward": count}
            nbytes = 4 * (2 * rows * c + 4 * c * hd) + 4 * (3 * hd + c) + (4 * heads * f * f if biased else 0)
            flops = rows * (8 * c * hd + 4 * f * hd + (heads * f if biased else 0))
            row.update(bytes=nbytes, flops=flops,
                       bound_ms_67=max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
                       bound_ms_165=max(nbytes / PEAK_BYTES, flops / PEAK_TF32X3) * 1e3,
                       bound_ms_bf16=max((nbytes - 2 * rows * c * 2 - 8 * c * hd) / PEAK_BYTES,
                                         flops / PEAK_BF16) * 1e3)
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                x = rand((b, s, f, c), 1, 0.5).to(dtype)
                w = (rand((c, 3 * hd), 2, c ** -0.5), rand((3 * hd,), 3, 0.1), rand((hd, c), 4, hd ** -0.5),
                     rand((c,), 5, 0.1))
                bias = rand((heads, f, f), 6, 0.5) if biased else None
                if f <= ta.MAX_FRAMES:
                    plain = lambda: ta.temporal_attention_plain(x, *w, heads, dim, pos_bias=bias)  # noqa: E731
                else:
                    plain = lambda: ta.temporal_attention_blockwise_plain(  # noqa: E731
                        x, *w, heads, dim, ta.KV_BLOCK, pos_bias=bias)
                want = plain()
                res = {"routes": {}}
                routes = {"planned": None}
                if controls and dtype == torch.float32:
                    res["plain_ms"] = ms(plain)
                    planned = real_plan(b * s, f, c, dim, heads, False, sms, False)
                    if planned["route"] == "simt":
                        routes["stream_dense"] = wide
                    elif planned["family"] == "wide" and not ta.wide_needed(f, c, dim, False):
                        routes["cuda_core_kernel"] = dense
                for label, setup in routes.items():
                    if setup is not None:
                        setup()
                    try:
                        plan = ta.temporal_plan(b * s, f, c, dim, heads, dtype == torch.bfloat16, sms, False)
                        ops.reset_launch_counts()
                        got = ta._block(x, *w, bias, heads, dim)
                        torch.cuda.synchronize()
                        again = ta._block(x, *w, bias, heads, dim)
                        counts = getattr(ops, "staged_tf32x3_launch_counts", dict)()
                        r = {"family": plan["family"], "route": plan["route"], "bt": plan.get("bt"),
                             "grid": plan["grid"], "smem": plan["smem"],
                             "launches": {k: v for k, v in ops.launch_counts().items() if v},
                             "staged": {k: v for k, v in ops.staged_launch_counts().items() if v},
                             "staged_tf32x3": {k: v for k, v in counts.items() if v},
                             "max_abs_err": (got.float() - want.float()).abs().max().item(),
                             "bit_equal": torch.equal(got, again),
                             "ms": ms(lambda: ta._block(x, *w, bias, heads, dim))}
                    finally:
                        ta.temporal_plan, _build.library = real_plan, real_library
                    r["pass"] = r["max_abs_err"] <= GATE[dtype_name] and r["bit_equal"]
                    r["share_67"] = row["bound_ms_67"] / r["ms"]
                    r["share_165"] = row["bound_ms_165"] / r["ms"]
                    res["routes"][label] = r
                    del got, again
                row[dtype_name] = res
                del x, w, want
                torch.cuda.empty_cache()
            rows_out.append(row)
            print(json.dumps({group: row}), file=sys.stderr, flush=True)
        per_fwd = {dt: {"planned": sum(r["per_forward"] * r[dt]["routes"]["planned"]["ms"] for r in rows_out)}
                   for dt in ("float32", "bfloat16")}
        if controls:
            for label in ("stream_dense", "cuda_core_kernel"):
                # each control at every shape where it runs, else the planned route
                if any(label in r["float32"]["routes"] for r in rows_out):
                    per_fwd["float32"][label] = sum(
                        r["per_forward"] * r["float32"]["routes"].get(label, r["float32"]["routes"]["planned"])["ms"]
                        for r in rows_out)
            per_fwd["float32"]["plain"] = sum(r["per_forward"] * r["float32"]["plain_ms"] for r in rows_out)
        per_fwd["float32"].update({k: sum(r["per_forward"] * r[k] for r in rows_out)
                                   for k in ("bound_ms_67", "bound_ms_165")})
        per_fwd["bfloat16"]["bound_ms_bf16"] = sum(r["per_forward"] * r["bound_ms_bf16"] for r in rows_out)
        out[group] = {"shapes": rows_out, "per_forward": per_fwd}
    return out


def ddim_d1(root: Path, steps: int = 50, batch: int = 8) -> dict:
    """D1 (``chip_smoke.dit_raw``) with seeded weights, its adaLN drawn as there: DDIM-``steps`` at ``batch`` rows,
    graph-replayed; ms a sampler step on the host clock over a second run (the first captures the graph)."""
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke
    from video_diffusion_nnx_tpu_torch.config import build_models

    _, diffusion = build_models(chip_smoke.dit_raw("D1"), "cuda")
    chip_smoke._perturb_dit(torch, diffusion.denoise_fn)
    diffusion.eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = diffusion.ddim_sample(batch_size=batch, num_steps=steps, generator=g)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / steps)
    return {"batch": batch, "steps": steps, "ms_per_step": runs[1:], "first_run_ms_per_step": runs[0],
            "finite": bool(torch.isfinite(clip).all())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--parent", type=Path, default=None, help="a checkout of the parent commit to time beside this one")
    p.add_argument("--only", default=",".join(GROUPS), help="comma-separated groups")
    p.add_argument("--ddim", action="store_true", help="also D1's graphed DDIM-50 at batch 8")
    p.add_argument("--root", type=Path, default=REPO, help=argparse.SUPPRESS)  # the package to time (a subprocess)
    p.add_argument("--planned-only", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    groups = [g for g in args.only.split(",") if g]

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if args.planned_only:  # a parent's run: its planned routes only, one JSON line
        res = measure(args.root, groups, args.iters, controls=False)
        if args.ddim:
            res["ddim_d1"] = ddim_d1(args.root)
        print(json.dumps(res))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def parent_run():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--root", str(args.parent.resolve()), "--planned-only",
               "--iters", str(args.iters), "--only", ",".join(groups), *(["--ddim"] if args.ddim else [])]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
        if done.returncode:
            raise RuntimeError(f"the parent's run failed:\n{done.stderr[-4000:]}")
        return json.loads(done.stdout.strip().splitlines()[-1])

    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    parents = [parent_run()] if args.parent else []
    result["change"] = measure(args.root, groups, args.iters, controls=True)
    if args.ddim:
        result["change"]["ddim_d1"] = ddim_d1(args.root)
    if args.parent:
        parents.append(parent_run())
        result["parent"] = parents
    ok = True
    for run in [result["change"], *parents]:
        for group, res in run.items():
            if group == "ddim_d1":
                ok &= res["finite"]
                continue
            for row in res["shapes"]:
                for dtype_name in ("float32", "bfloat16"):
                    ok &= all(r["pass"] for r in row[dtype_name]["routes"].values())
    result["ok"] = ok
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps(result, indent=1))

    def summary(run):
        return {g: (r if g == "ddim_d1" else r["per_forward"]) for g, r in run.items()}

    print(json.dumps({"ok": ok, "device": result["device"], "nvidia_smi": smi, "per_forward": summary(result["change"]),
                      "parent_per_forward": [summary(run) for run in parents]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
