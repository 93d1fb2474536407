"""Serving throughput under concurrent load, micro-batching on against off (counterpart of the JAX package's
scripts/bench_serve.py).

N concurrent single-clip DDIM requests, each with its own seed, are posted
to the sampling server and the wall clock to drain them all is measured:

  - batching on (a ``--batch-window`` of 0.25 s by default): the requests
    coalesce into one batched sampler call (padded to a power of two);
  - batching off (``serve --no-batching``): the device lock serializes N
    sampler calls.

By default both servers run in-process on ephemeral ports around one model:
the config's with a checkpoint, else the flagship recipe with seeded random
weights (timing does not depend on the weights). ``--batched-url`` and
``--serial-url`` measure servers already running instead. Prints one JSON
line with both throughputs and their ratio.

    python -m video_diffusion_nnx_tpu_torch.bench_serve [--requests 8] [--num-steps 50]
        [--config C [--checkpoint-path P]] [--device cuda]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

FLAGSHIP = Path(__file__).resolve().parent.parent / "configs" / "config_bouncing_digits.yaml"


def post(url: str, payload: dict, path: str = "/sample") -> dict:
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=1200) as r:
            return json.loads(r.read())
    except ConnectionResetError:
        # One retry: a connect burst can be dropped while a sampler call holds the server.
        with urllib.request.urlopen(req, timeout=1200) as r:
            return json.loads(r.read())


def drain(url: str, n: int, num_steps: int) -> tuple[float, list[dict]]:
    """Fire n concurrent 1-clip DDIM requests (seeds 0..n-1); return (wall seconds, responses)."""
    payloads = [{"sampler": "ddim", "num_steps": num_steps, "seed": s, "batch_size": 1} for s in range(n)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
        outs = list(ex.map(lambda p: post(url, p), payloads))
    return time.perf_counter() - t0, outs


def measure(url: str, tag: str, request_counts, num_steps: int, batched: bool) -> dict:
    """Best-of-2 drains of each client count against one server, after warm-up drains that capture the graphs
    the mode uses (the solo shape, and for batching the coalesced one)."""
    result = {}
    for n in request_counts:
        drain(url, 1, num_steps)
        if batched:
            drain(url, n, num_steps)
        wall, outs = drain(url, n, num_steps)
        wall2, outs2 = drain(url, n, num_steps)
        if wall2 < wall:
            wall, outs = wall2, outs2
        groups = sorted({o.get("coalesced", 1) for o in outs}, reverse=True)
        result[f"{tag}_n{n}_wall_s"] = wall
        result[f"{tag}_n{n}_clips_per_s"] = n / wall
        result[f"{tag}_n{n}_max_group"] = groups[0]
        print(f"[{tag} n={n}] {n} reqs in {wall:.3f}s ({n / wall:.3f} clips/s, groups {groups})", file=sys.stderr)
    return result


def compare(model, request_counts, num_steps: int, batch_window: float) -> dict:
    """Coalesced against serial, each on an in-process server around ``model``."""
    from video_diffusion_nnx_tpu_torch.serve import create_server

    result = {"requests": list(request_counts), "num_steps": num_steps, "batch_window_s": batch_window}
    for tag, window in (("batched", batch_window), ("serial", None)):
        httpd = create_server(model, host="127.0.0.1", port=0, batch_window_s=window)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            url = "http://%s:%d" % httpd.server_address[:2]
            result.update(measure(url, tag, request_counts, num_steps, batched=window is not None))
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    for n in request_counts:
        result[f"speedup_n{n}"] = result[f"serial_n{n}_wall_s"] / result[f"batched_n{n}_wall_s"]
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Serving throughput, micro-batching on against off")
    ap.add_argument("--requests", default="8", help="comma list of concurrent-client counts, e.g. 2,8,16")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--batch-window", type=float, default=0.25)
    ap.add_argument("--config", default=None, help="default: the flagship recipe, seeded random weights")
    ap.add_argument("--checkpoint-path", default=None)
    ap.add_argument("--batched-url", default=None, help="a running server with batching on")
    ap.add_argument("--serial-url", default=None, help="a running server with --no-batching")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    request_counts = [int(n) for n in str(args.requests).split(",")]

    if args.batched_url or args.serial_url:
        if not (args.batched_url and args.serial_url):
            raise SystemExit("error: give both --batched-url and --serial-url")
        result = {"requests": request_counts, "num_steps": args.num_steps}
        result.update(measure(args.batched_url, "batched", request_counts, args.num_steps, batched=True))
        result.update(measure(args.serial_url, "serial", request_counts, args.num_steps, batched=False))
        for n in request_counts:
            result[f"speedup_n{n}"] = result[f"serial_n{n}_wall_s"] / result[f"batched_n{n}_wall_s"]
    else:
        from video_diffusion_nnx_tpu_torch.config import build_models, load_config

        _, model = build_models(load_config(args.config or FLAGSHIP), device=args.device)
        if args.checkpoint_path:
            from video_diffusion_nnx_tpu_torch.convert import load_checkpoint

            load_checkpoint(model, args.checkpoint_path, load_ema_params=True)
        result = compare(model.eval(), request_counts, args.num_steps, args.batch_window)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
