"""The float32 temporal backward's routes at the shapes the tensor-core design was made for, on one CUDA card.

    python scripts/torch_f32_bwd_routes.py [--iters 5]

At D1's spatial backward (8, 16, 256, 256) 8 x 32, D2's temporal backward (4, 64, 10, 384) 6 x 64, D2's
spatial backward (4, 10, 64, 384) 6 x 64 and the fixed flagship's bottleneck (8, 10, 64, 256) 8 x 32, all
float32, times with CUDA events, in one process: the route the planner gives (``tf32x3``,
csrc/temporal_tf32x3.cu), the route it replaces (the planner with the float32 tensor-core design's fit rule
off: the first-design blockwise kernel, the CUDA-core dense kernel, the streaming kernel in mode DENSE), at
D2's temporal shape also the float32 streaming kernel in mode DENSE (a route change alone), and the
plain version. Each route's gradients are held against the plain version (1e-5 of each output's largest
value) and each route's two runs must be bit-equal. Bounds: the bytes the function must move over 3.35 TB/s
against its FLOPs over 67 TFLOP/s (float32 on the CUDA cores) and over 495 / 3 TFLOP/s (three TF32
tensor-core products per float32 product). Prints one JSON line and writes it to
chiprun_out/torch_f32_bwd_routes/result.json. Exits non-zero without a card or where a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out" / "torch_f32_bwd_routes"
SHAPES = {"d1_spatial": ((8, 16, 256, 256), 8, 32), "d2_temporal": ((4, 64, 10, 384), 6, 64),
          "d2_spatial": ((4, 10, 64, 384), 6, 64), "fixed_bottleneck": ((8, 10, 64, 256), 8, 32)}
GATE = 1e-5
PEAK_BYTES, PEAK_F32, PEAK_TF32X3 = 3.35e12, 67e12, 495e12 / 3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from video_diffusion_nnx_tpu_torch import ops
    from video_diffusion_nnx_tpu_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rand(shape, seed, scale):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def ms(fn, iters):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    real_fits, real_plan = ta._tf32x3_fits, ta.temporal_plan

    def replaced(*a):  # the planner without the tensor-core design's fit rule: the route it replaces
        ta._tf32x3_fits = lambda *_: False
        try:
            return real_plan(*a)
        finally:
            ta._tf32x3_fits = real_fits

    def streaming(tokens, f, c, dim, heads, bf16, sms_, backward):  # the float32 streaming kernel, mode DENSE
        if not backward:
            return real_plan(tokens, f, c, dim, heads, bf16, sms_, backward)
        return {"family": "wide", **ta.blockwise_plan(tokens, f, c, dim, heads, bf16, sms_, True, dense=True)}

    result, ok = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sms": sms}, True
    for name, ((b, s, f, c), heads, dim) in SHAPES.items():
        hd, rows = heads * dim, b * s * f
        x, g = rand((b, s, f, c), 1, 0.5), rand((b, s, f, c), 9, 0.1)
        w = (rand((c, 3 * hd), 2, c ** -0.5), rand((3 * hd,), 3, 0.1), rand((hd, c), 4, hd ** -0.5), rand((c,), 5, 0.1))
        plain = ((lambda: ta.temporal_attention_bwd_plain(x, g, *w, heads, dim)) if f <= ta.MAX_FRAMES
                 else (lambda: ta.temporal_attention_blockwise_bwd_plain(x, g, *w, heads, dim, ta.KV_BLOCK)))
        want = plain()
        nbytes = 4 * (3 * rows * c + 4 * c * hd) + 4 * (3 * hd + c) + 4 * (4 * c * hd + 3 * hd + c)
        flops = rows * (22 * c * hd + 12 * f * hd)
        row = {"shape": (b, s, f, c), "heads": heads, "dim": dim, "bytes": nbytes, "flops": flops,
               "bound_ms_f32": max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
               "bound_ms_3xtf32": max(nbytes / PEAK_BYTES, flops / PEAK_TF32X3) * 1e3,
               "plain_ms": ms(plain, args.iters), "routes": {}}
        routes = {"planned": real_plan, "replaced": replaced}
        if name == "d2_temporal":
            routes["streaming_dense"] = streaming
        for label, planner in routes.items():
            ta.temporal_plan = planner
            try:
                plan = planner(b * s, f, c, dim, heads, False, sms, True)
                ops.reset_launch_counts()
                got = ta.temporal_attention_bwd(x, g, *w, heads, dim)
                torch.cuda.synchronize()
                again = ta.temporal_attention_bwd(x, g, *w, heads, dim)
                launched = {k: v for k, v in ops.launch_counts().items() if v}
                errs = {k: rel(a, v) for k, a, v in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got, want)}
                r = {"family": plan["family"], "route": plan["route"], "launches": launched,
                     "tf32x3_launches": {k: v for k, v in ops.tf32x3_launch_counts().items() if v},
                     "rel_err": errs, "bit_equal": all(torch.equal(u, v) for u, v in zip(got, again)),
                     "ms": ms(lambda: ta.temporal_attention_bwd(x, g, *w, heads, dim), args.iters)}
            finally:
                ta.temporal_plan = real_plan
            r["pass"] = max(errs.values()) <= GATE and r["bit_equal"]
            ok &= r["pass"]
            row["routes"][label] = r
            del got, again
        ok &= row["routes"]["planned"]["route"] == "tf32x3"
        result[name] = row
        del x, g, w, want
        torch.cuda.empty_cache()
    result["ok"] = ok
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
