"""The float32 temporal backward's routes at the shapes its tensor-core designs were made for, on one CUDA card.

    python scripts/torch_f32_bwd_routes.py [--parent DIR] [--iters 5] [--only NAME,...]

Times with CUDA events, in one call, every float32 temporal backward that a recipe sends to a tensor-core design:

- the staged dense backward in 3xTF32 (route "staged-3xtf32", csrc/temporal_attention.cu): D1's temporal backward
  (8, 256, 16, 256) 8 x 32, and the fixed flagship's ten biased backwards a step at f = 10 (``fixed_flagship``);
- the streaming blockwise backward in 3xTF32 (the same route, csrc/temporal_blockwise.cu): the fixed long clip's
  ten biased backwards a step at f = 128 (``long_fixed``);
- the routes of csrc/temporal_tf32x3.cu (route "tf32x3"): D1's spatial backward, D2's temporal and spatial
  backwards and the fixed flagship's bottleneck (``tf32x3_routes``).

At each shape: the route the planner gives (``_f32_takes_tf32x3``: the staged dense kernel up to c = 64, the
streaming one up to c = 32, tf32x3 above), the other 3xTF32 design forced onto the shape (the tf32x3 design where
the planner gives a staged one: the routing-only control; the staged or streaming kernel where it gives tf32x3,
from a build with ``VDT_ANY_F32_ROUTE`` defined, which leaves out the C entries' check of the rule), the plain
version, and the same shapes in bf16 (the bf16 instantiations' times). Each route's gradients are held against
the plain version (1e-5 of each output's largest value, dbias included; bf16 at 0.02) and each route's two runs
must be bit-equal. With ``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive`` under ``build/``)
the parent's planned routes are timed at the same shapes in a process of their own before and after this tree's
(parent, change, parent), the parent's kernels built from DIR's sources. Bounds: the bytes the function must move
over 3.35 TB/s against its FLOPs over 67 TFLOP/s (float32 on the CUDA cores) and over 495 / 3 TFLOP/s (three TF32
tensor-core products per float32 product). Per group the times are also summed per step with each shape's launches
a step. Prints one JSON line and writes it to chiprun_out/torch_f32_bwd_routes/result.json. Exits non-zero without a card or where a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out" / "torch_f32_bwd_routes"
# group: (biased, [(launches a step, (b, s, f, c), heads, head dim), ...])
GROUPS = {
    "d1_temporal": (False, [(6, (8, 256, 16, 256), 8, 32)]),
    "fixed_flagship": (True, [(3, (8, 4096, 10, 32), 8, 32), (1, (8, 1024, 10, 64), 8, 32),
                              (1, (8, 256, 10, 128), 8, 32), (2, (8, 64, 10, 256), 8, 32),
                              (1, (8, 64, 10, 128), 8, 32), (1, (8, 256, 10, 64), 8, 32),
                              (1, (8, 1024, 10, 32), 8, 32)]),
    "long_fixed": (True, [(3, (1, 4096, 128, 32), 8, 32), (1, (1, 1024, 128, 64), 8, 32),
                          (1, (1, 256, 128, 128), 8, 32), (2, (1, 64, 128, 256), 8, 32),
                          (1, (1, 64, 128, 128), 8, 32), (1, (1, 256, 128, 64), 8, 32),
                          (1, (1, 1024, 128, 32), 8, 32)]),
    "tf32x3_routes": (False, [(6, (8, 16, 256, 256), 8, 32), (8, (4, 64, 10, 384), 6, 64),
                              (8, (4, 10, 64, 384), 6, 64), (1, (8, 10, 64, 256), 8, 32)]),
}
GATE = {"float32": 1e-5, "bfloat16": 0.02}
PEAK_BYTES, PEAK_F32, PEAK_TF32X3, PEAK_BF16 = 3.35e12, 67e12, 495e12 / 3, 989e12
NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")


def measure(root: Path, groups: list, iters: int, controls: bool) -> dict:
    """Every group's shapes through the package under ``root``: the planned route in both types, and with
    ``controls`` the other 3xTF32 design and the plain version in float32."""
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

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-6)).item()

    real_plan, real_rule, real_library = ta.temporal_plan, getattr(ta, "_f32_takes_tf32x3", None), _build.library

    def forced(tokens, f, c, dim, heads, bf16, sms_, backward):  # the routing-only control
        if not backward or bf16:
            return real_plan(tokens, f, c, dim, heads, bf16, sms_, backward)
        family = "blockwise" if f > ta.MAX_FRAMES else "dense"
        return {"family": family, **ta.tf32x3_plan(tokens, f, c, dim, heads, sms_)}

    def staged(*a):  # the staged dense or streaming kernel where the rule gives the shape to tf32x3
        ta._f32_takes_tf32x3 = lambda *_: False
        try:
            return real_plan(*a)
        finally:
            ta._f32_takes_tf32x3 = real_rule

    out = {}
    for group in groups:
        biased, shapes = GROUPS[group]
        rows_out = []
        for count, (b, s, f, c), heads, dim in shapes:
            hd, rows = heads * dim, b * s * f
            row = {"shape": [b, s, f, c], "heads": heads, "dim": dim, "bias": biased, "per_step": count}
            nbytes = 4 * (3 * rows * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
            nbytes += 4 * 2 * heads * f * f if biased else 0
            flops = rows * (22 * c * hd + 12 * f * hd)
            row.update(bytes=nbytes, flops=flops,
                       bound_ms_67=max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
                       bound_ms_165=max(nbytes / PEAK_BYTES, flops / PEAK_TF32X3) * 1e3,
                       bound_ms_bf16=max(nbytes / 2 / PEAK_BYTES, flops / PEAK_BF16) * 1e3)
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                x, g = rand((b, s, f, c), 1, 0.5).to(dtype), rand((b, s, f, c), 9, 0.1).to(dtype)
                w = (rand((c, 3 * hd), 2, c ** -0.5), rand((3 * hd,), 3, 0.1), rand((hd, c), 4, hd ** -0.5),
                     rand((c,), 5, 0.1))
                bias = rand((heads, f, f), 6, 0.5) if biased else None
                oracle = ta.temporal_attention_bwd_plain if f <= ta.MAX_FRAMES else (
                    lambda *a, **k: ta.temporal_attention_blockwise_bwd_plain(*a[:-2], a[-2], a[-1], ta.KV_BLOCK, **k))
                plain = lambda: oracle(x, g, *w, heads, dim, pos_bias=bias)  # noqa: E731
                want = plain()
                res = {"routes": {}}
                if controls and dtype == torch.float32:
                    res["plain_ms"] = ms(plain)
                routes = {"planned": real_plan}
                if controls and dtype == torch.float32:
                    planned = real_plan(b * s, f, c, dim, heads, False, sms, True)["route"]
                    if planned != "tf32x3":
                        routes["tf32x3"] = forced
                    elif staged(b * s, f, c, dim, heads, False, sms, True)["route"] == ta.STAGED_3XTF32:
                        routes[ta.STAGED_3XTF32] = staged
                for label, planner in routes.items():
                    ta.temporal_plan = planner
                    if planner is staged:  # the staged and streaming sources built without the C check of the rule
                        _build.library = lambda name: real_library(name, ("VDT_ANY_F32_ROUTE",))
                    try:
                        plan = planner(b * s, f, c, dim, heads, dtype == torch.bfloat16, sms, True)
                        ops.reset_launch_counts()
                        got = ta.temporal_attention_bwd(x, g, *w, heads, dim, bias)
                        torch.cuda.synchronize()
                        again = ta.temporal_attention_bwd(x, g, *w, heads, dim, bias)
                        counts = getattr(ops, "staged_tf32x3_launch_counts", dict)()
                        r = {"family": plan["family"], "route": plan["route"],
                             "launches": {k: v for k, v in ops.launch_counts().items() if v},
                             "staged": {k: v for k, v in ops.staged_launch_counts().items() if v},
                             "tf32x3": {k: v for k, v in ops.tf32x3_launch_counts().items() if v},
                             "staged_tf32x3": {k: v for k, v in counts.items() if v},
                             "rel_err": {n: rel(a, v) for n, a, v in zip(NAMES, got, want)},
                             "bit_equal": all(torch.equal(u, v) for u, v in zip(got, again)),
                             "ms": ms(lambda: ta.temporal_attention_bwd(x, g, *w, heads, dim, bias))}
                    finally:
                        ta.temporal_plan, _build.library = real_plan, real_library
                    r["pass"] = max(r["rel_err"].values()) <= GATE[dtype_name] and r["bit_equal"]
                    res["routes"][label] = r
                    del got, again
                row[dtype_name] = res
                del x, g, w, want
                torch.cuda.empty_cache()
            rows_out.append(row)
            print(json.dumps({group: row}), file=sys.stderr, flush=True)
        per_step = {}
        for dtype_name in ("float32", "bfloat16"):
            per_step[dtype_name] = {"planned": sum(r["per_step"] * r[dtype_name]["routes"]["planned"]["ms"]
                                                   for r in rows_out)}
        if controls:  # each design at every shape: the planned route where it is that design, else its control
            for design in ("tf32x3", ta.STAGED_3XTF32):
                per_step["float32"][design] = sum(
                    r["per_step"] * next(v["ms"] for v in r["float32"]["routes"].values() if v["route"] == design)
                    for r in rows_out if any(v["route"] == design for v in r["float32"]["routes"].values()))
        per_step["float32"].update({k: sum(r["per_step"] * r[k] for r in rows_out)
                                    for k in ("bound_ms_67", "bound_ms_165")})
        if controls:
            per_step["float32"]["plain"] = sum(r["per_step"] * r["float32"]["plain_ms"] for r in rows_out)
        out[group] = {"shapes": rows_out, "per_step": per_step}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--parent", type=Path, default=None, help="a checkout of the parent commit to time beside this one")
    p.add_argument("--only", default=",".join(GROUPS), help="comma-separated groups")
    p.add_argument("--root", type=Path, default=REPO, help=argparse.SUPPRESS)  # the package to time (a subprocess)
    p.add_argument("--planned-only", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    groups = [g for g in args.only.split(",") if g]

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if args.planned_only:  # a parent's run: its planned routes only, one JSON line
        print(json.dumps(measure(args.root, groups, args.iters, controls=False)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def parent_run():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--root", str(args.parent.resolve()), "--planned-only",
               "--iters", str(args.iters), "--only", ",".join(groups)]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
        if done.returncode:
            raise RuntimeError(f"the parent's run failed:\n{done.stderr[-4000:]}")
        return json.loads(done.stdout.strip().splitlines()[-1])

    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    parents = [parent_run()] if args.parent else []
    result["change"] = measure(args.root, groups, args.iters, controls=True)
    if args.parent:
        parents.append(parent_run())
        result["parent"] = parents
    ok = True
    for group, res in result["change"].items():
        for row in res["shapes"]:
            for dtype_name in ("float32", "bfloat16"):
                ok &= all(r["pass"] for r in row[dtype_name]["routes"].values())
    for run in parents:
        for res in run.values():
            for row in res["shapes"]:
                for dtype_name in ("float32", "bfloat16"):
                    ok &= all(r["pass"] for r in row[dtype_name]["routes"].values())
    result["ok"] = ok
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": ok, "device": result["device"], "nvidia_smi": smi,
                      "per_step": {g: r["per_step"] for g, r in result["change"].items()},
                      "parent_per_step": [{g: r["per_step"] for g, r in run.items()} for run in parents]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
