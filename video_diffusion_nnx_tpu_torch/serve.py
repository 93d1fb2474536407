"""Sampling server (counterpart of the JAX package's scripts/serve.py).

Loads a checkpoint once, keeps the denoiser's CUDA graphs warm in the
sampler's bounded cache (``diffusion/graphs.py``), and serves video
generation, unconditioned or text-conditioned, over HTTP, standard library only:

    python -m video_diffusion_nnx_tpu_torch.serve --config configs/config_bouncing_digits.yaml \\
        --checkpoint-path ckpt.pt --load-ema-params --port 8080 [--warmup]

API
---
GET  /health  -> {"status": "ok", "device": "cuda", "devices": N (the ranks), "batching": {...}, "model": {...}}
POST /sample  (JSON body) ->
    {"batch_size": 2, "sampler": "ddim", "num_steps": 50, "eta": 0.0,
     "grid": "linspace", "seed": 0, "text": ["two digits"], "cond_scale": 3.0}
    -> {"gifs": [<base64 GIF per clip>], "time_s": ..., "shape": [...]}
    Default sampler: ddim (the path --warmup captures). "ddpm" runs the
    full T-step chain, "dpm" DPM-Solver++(2M); knobs a sampler would ignore
    are refused with 400.
POST /extend  (JSON body) -> frame-conditional generation:
    {"known_npy_b64": <base64 of a .npy (c, f, h, w) float array in [0, 1]>,
     "frame_mask": [true, ..., false], "batch_size": 2, "num_steps": 50,
     "grid": "linspace", "recon_guidance": 0.0, "seed": 0, "text": [...], "cond_scale": 1.0}
    -> the /sample response. num_steps defaults to DDIM-50; an explicit
    null runs the full T-step DDPM chain.

``text`` is a list of prompts: a conditioned model needs it and an
unconditioned one refuses it (400). One prompt is repeated to
``batch_size``; a list of several sets the batch size (at most 64), and one
that disagrees with an explicit ``batch_size`` is refused. Prompts are
embedded on the host. ``cond_scale`` is the classifier-free guidance scale.
Device work is serialized behind one lock (one card, one sampler at a time):
every device call (the draws of x_T, the samplers and their graph captures)
is a small description (:func:`execute`) run under it.

Micro-batching: concurrent /sample requests of a deterministic ODE sampler
(ddim at eta 0, dpm) are coalesced into one batched sampler call. Each
request's x_T is the first draw of a generator seeded with its seed, exactly
what a solo ``ddim_sample(generator=...)`` draws, and each output row is a
function of its own x_T and its own condition alone (a prompt's embedding
does not depend on the others in its batch), so coalescing changes no
request's result beyond the arithmetic of another batch size. Coalesced batches pad to the
next power of two (rows of the batch reused), so each request-shape group
captures at most log2(max_rows) + 1 graphs. Disable with --no-batching.

Over ranks (``--ranks N``; ``--dist-backend gloo`` for ranks sharing a card)
every device call runs on all of them, as the JAX server's samplers run over
``data_parallel_mesh()``: rank 0 alone serves HTTP, validates and coalesces,
and broadcasts each call's description (its kind, the rows' seeds, the
steps, eta, grid, cond_scale, the prompts and the known frames) to the other
ranks, which loop on :func:`follow` until rank 0 shuts down. Every rank makes
the whole batch's x_T from the seeds, samples its rows of the batch (a batch
that does not divide runs whole on every rank, with a warning) and the batch
is gathered; ``devices`` in /health is the number of ranks.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import math
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from video_diffusion_nnx_tpu_torch.parallel.mesh import add_rank_args, joined, launch, world_size

log = logging.getLogger("serve")

_ALLOWED_SAMPLERS = ("ddpm", "ddim", "dpm")


def _coerce(req: dict, key: str, cast, default):
    """Fetch-and-cast a request scalar; a malformed value (JSON null, a list, an object) is a ValueError, so 400."""
    val = req.get(key, default)
    try:
        return cast(val)
    except (TypeError, ValueError):
        raise ValueError(f"{key} must be a {cast.__name__}") from None


class _Pending:
    """One request's share of a (possibly coalesced) batch: its ``n`` rows, described by ``item``."""

    __slots__ = ("item", "n", "event", "rows", "group_size", "error", "t_enq", "wait_s")

    def __init__(self, item, n: int):
        self.item = item
        self.n = n
        self.event = threading.Event()
        self.rows = None
        self.group_size = 1
        self.error = None
        self.t_enq = time.monotonic()
        self.wait_s = 0.0


class MicroBatcher:
    """Coalesces concurrent, compatible sampler requests into one device call.

    Requests are bucketed by a group key (sampler, num_steps, grid,
    cond_scale, conditioned?); the dispatcher takes the bucket holding the
    oldest pending request, lingers up to ``window_s`` for same-key arrivals
    (or until ``max_rows`` samples are queued), then hands the whole bucket
    to ``run_batch`` in one call. Results are split back per request; a
    request larger than ``max_rows`` runs alone, and an error reaches every
    waiter of its batch.
    """

    def __init__(self, run_batch, max_rows: int = 8, window_s: float = 0.05):
        self._run_batch = run_batch
        self.max_rows = max_rows
        self.window_s = window_s
        self._buckets: dict = {}
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name="micro-batcher", daemon=True)
        self._thread.start()

    def submit(self, group_key, item, n: int):
        """Block until the ``n`` rows that ``item`` describes are sampled; returns ``(rows, group_size,
        queue_wait_s)``."""
        p = _Pending(item, n)
        with self._cv:
            self._buckets.setdefault(group_key, []).append(p)
            self._cv.notify_all()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.rows, p.group_size, p.wait_s

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _take_batch(self):
        """(Under the cv) pick the bucket with the oldest request, linger
        for the batching window, then pop up to max_rows samples from it."""
        key = min((k for k, b in self._buckets.items() if b), key=lambda k: self._buckets[k][0].t_enq)
        deadline = self._buckets[key][0].t_enq + self.window_s
        while not self._stop:
            rows = sum(p.n for p in self._buckets[key])
            now = time.monotonic()
            if rows >= self.max_rows or now >= deadline:
                break
            self._cv.wait(timeout=deadline - now)
        bucket = self._buckets[key]
        batch, taken = [], 0
        while bucket and taken + bucket[0].n <= self.max_rows:
            p = bucket.pop(0)
            batch.append(p)
            taken += p.n
        if not batch:  # single request larger than max_rows: run it alone
            batch.append(bucket.pop(0))
        if not bucket:
            del self._buckets[key]
        return key, batch

    def _loop(self):
        while True:
            with self._cv:
                while not self._stop and not any(self._buckets.values()):
                    self._cv.wait()
                if self._stop:
                    return
                key, batch = self._take_batch()
            t_run = time.monotonic()
            try:
                out = self._run_batch(key, batch)
                off = 0
                for p in batch:
                    p.rows = out[off : off + p.n]
                    p.group_size = len(batch)
                    p.wait_s = t_run - p.t_enq
                    off += p.n
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def execute(model, call: dict) -> np.ndarray:
    """One device call of the service, as every rank runs it; the whole batch's rows as float32 on the host.

    ``call["kind"]`` is ``"batch"`` (coalesced ODE requests: ``requests`` lists each one's seed, rows and prompts;
    its x_T is the first draw of a generator seeded with its seed, and the batch pads to the next power of two
    with its own rows, so that a group key needs at most log2(max_rows) + 1 graphs), ``"sample"`` (one request
    through its sampler, the draws from a generator seeded with its seed) or ``"extend"`` (frame-conditional
    sampling of the known frames). Under the model's data group each rank samples its rows and the batch is
    gathered."""
    m, kind = model, call["kind"]
    g = None if kind == "batch" else _generator(m.device, call["seed"])
    kw = {"cond": call["text"], "cond_scale": call["cond_scale"]}
    if kind == "batch":
        shape = (m.channels, m.num_frames, m.image_size, m.image_size)
        noise = torch.cat([torch.randn((n, *shape), generator=_generator(m.device, seed), device=m.device)
                           for seed, n, _ in call["requests"]])
        texts = [t for _, _, t in call["requests"]]
        cond = None if texts[0] is None else torch.cat([m.embed_cond(t) for t in texts])  # each request's alone
        n = noise.shape[0]
        batch = 1 << (n - 1).bit_length()
        if batch > n:
            reps = -(-(batch - n) // n) + 1
            noise = torch.cat([noise] * reps)[:batch]
            if cond is not None:
                cond = torch.cat([cond] * reps)[:batch]
        kw["cond"] = cond
        if call["sampler"] == "ddim":
            out = m.ddim_sample(batch_size=batch, num_steps=call["num_steps"], eta=0.0, grid=call["grid"],
                                init_noise=noise, **kw)
        else:  # dpm
            out = m.dpm_solver_sample(batch_size=batch, num_steps=call["num_steps"], init_noise=noise, **kw)
    elif kind == "sample":
        batch = n = call["batch_size"]
        if call["sampler"] == "ddim":
            out = m.ddim_sample(batch_size=batch, num_steps=call["num_steps"], eta=call["eta"], grid=call["grid"],
                                generator=g, **kw)
        elif call["sampler"] == "dpm":
            out = m.dpm_solver_sample(batch_size=batch, num_steps=call["num_steps"], generator=g, **kw)
        else:
            out = m.sample(batch_size=batch, generator=g, **kw)
    elif kind == "extend":
        known = torch.from_numpy(call["known"].astype(np.float32)).to(m.device)[None]
        batch = n = call["batch_size"]
        out = m.sample_conditional_frames(known.expand(batch, *known.shape[1:]), call["frame_mask"],
                                          num_steps=call["num_steps"], grid=call["grid"],
                                          recon_guidance_weight=call["recon_guidance"], generator=g, **kw)
    else:
        raise ValueError(f"unknown call kind {kind!r}")
    return m.gather_batch(out, batch)[:n].float().cpu().numpy()


def follow(model, group) -> None:
    """A rank other than 0 of a multi-rank server: run every call rank 0 broadcasts, until it sends None."""
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group.group)
        if box[0] is None:
            return
        execute(model, box[0])


class SamplingService:
    """Owns the model and serializes the device work; rank 0's service under a ``group`` of ranks, which
    broadcasts each device call to the others (:func:`follow`)."""

    def __init__(self, model, batch_window_s: float | None = 0.05, max_batch_rows: int = 8, group=None):
        self.model = model
        self.device = model.device
        self.group = group if group is not None and group.world_size > 1 else None
        model.data_group = self.group
        self.lock = threading.Lock()
        self.batcher = (
            MicroBatcher(self._run_batch, max_batch_rows, batch_window_s) if batch_window_s is not None else None
        )

    def _call(self, call: dict) -> np.ndarray:
        """Run one device call on every rank (this thread holds the lock across it); its rows."""
        with self.lock:
            if self.group is not None:
                dist.broadcast_object_list([call], src=0, group=self.group.group)
            return execute(self.model, call)

    def _run_batch(self, group_key, batch) -> np.ndarray:
        """Execute one coalesced sampler call (dispatcher thread); the rows as float32 on the host."""
        sampler, num_steps, grid, cond_scale, _ = group_key
        return self._call({"kind": "batch", "sampler": sampler, "num_steps": num_steps, "grid": grid,
                           "cond_scale": cond_scale, "text": None, "requests": [p.item for p in batch]})

    def info(self) -> dict:
        m = self.model
        return {
            "status": "ok",
            "device": self.device.type,
            "devices": 1 if self.group is None else self.group.world_size,
            "batching": (
                {"window_s": self.batcher.window_s, "max_rows": self.batcher.max_rows}
                if self.batcher is not None
                else None
            ),
            "model": {
                "image_size": m.image_size,
                "num_frames": m.num_frames,
                "channels": m.channels,
                "timesteps": m.num_timesteps,
                "prediction_type": m.prediction_type,
                "has_cond": self._has_cond,
                "guidance_embed": bool(getattr(m.denoise_fn, "has_guidance_embed", False)),
            },
        }

    @property
    def _has_cond(self) -> bool:
        return bool(getattr(self.model.denoise_fn, "has_cond", False))

    def _validate_text(self, req: dict, batch_size: int) -> tuple[list[str] | None, int]:
        """The request's prompts and its batch size (JAX ``_validate_text``, scripts/serve.py:270-300).

        A single prompt is broadcast; a prompt list sets the batch size unless the
        request pinned a conflicting one (the samplers take the batch from the
        condition, so an unchecked list would bypass the batch cap).
        """
        cond = req.get("text")
        if cond is None:
            if self._has_cond:
                raise ValueError("this model is conditioned; provide 'text'")
            return None, batch_size
        if not self._has_cond:
            raise ValueError("this model is unconditional; remove 'text'")
        if not isinstance(cond, list) or not all(isinstance(s, str) for s in cond):
            raise ValueError("text must be a list of strings")
        if len(cond) == 1 and batch_size > 1:
            cond = cond * batch_size
        if not 1 <= len(cond) <= 64:
            raise ValueError("text must have 1..64 entries")
        if len(cond) != batch_size:
            if "batch_size" in req:
                raise ValueError(
                    f"text has {len(cond)} entries but batch_size is {batch_size}; give one prompt, matching "
                    "prompts, or drop batch_size"
                )
            batch_size = len(cond)
        return cond, batch_size

    def _run(self, call: dict) -> tuple[np.ndarray, float]:
        """One solo device call; its rows and its seconds."""
        t0 = time.perf_counter()
        rows = self._call(call)
        return rows, time.perf_counter() - t0

    @staticmethod
    def _encode(rows: np.ndarray, seconds: float, **extra) -> dict:
        gifs = [base64.b64encode(g).decode("ascii") for g in _encode_gifs(rows)]
        return {"gifs": gifs, "time_s": round(seconds, 3), "shape": list(rows.shape), **extra}

    def sample_rows(self, req: dict) -> tuple[np.ndarray, float, dict]:
        """Validate and run a /sample request: its clips (b, c, f, h, w) in [0, 1] as float32, the seconds, and
        the coalescing fields (``coalesced``, ``queue_wait_s``) where it went through the micro-batcher."""
        # Default sampler is DDIM (the path --warmup captures); DDPM runs
        # the full T-step chain and must be asked for explicitly.
        sampler = req.get("sampler", "ddim")
        if sampler not in _ALLOWED_SAMPLERS:
            raise ValueError(f"sampler must be one of {_ALLOWED_SAMPLERS}")
        batch_size = _coerce(req, "batch_size", int, 1)
        if not 1 <= batch_size <= 64:
            raise ValueError("batch_size must be in [1, 64]")
        # Refuse knobs the chosen sampler would silently ignore.
        if sampler == "ddpm" and "num_steps" in req:
            raise ValueError("ddpm runs the full timestep chain; num_steps applies to ddim/dpm only")
        num_steps = _coerce(req, "num_steps", int, 50)
        if sampler != "ddpm" and not 1 <= num_steps <= self.model.num_timesteps:
            raise ValueError(f"num_steps must be in [1, {self.model.num_timesteps}]")
        if sampler != "ddim":
            for k in ("eta", "grid"):
                if k in req:
                    raise ValueError(f"{k} applies to the ddim sampler only")
        grid = req.get("grid", "linspace")
        if grid not in ("linspace", "stride"):
            raise ValueError("grid must be 'linspace' or 'stride'")
        eta = _coerce(req, "eta", float, 0.0)
        seed = _coerce(req, "seed", int, 0)
        cond, batch_size = self._validate_text(req, batch_size)
        cond_scale = _coerce(req, "cond_scale", float, 1.0)
        # json.loads accepts NaN, which never compares equal to a group key.
        if not (math.isfinite(eta) and math.isfinite(cond_scale)):
            raise ValueError("eta and cond_scale must be finite")

        # Deterministic-ODE requests go through the micro-batcher with x_T
        # drawn from the request's seed, as the solo path would draw it.
        if self.batcher is not None and sampler in ("ddim", "dpm") and eta == 0.0:
            t0 = time.perf_counter()
            group_key = (sampler, num_steps, grid, cond_scale, cond is not None)
            rows, group_size, wait_s = self.batcher.submit(group_key, (seed, batch_size, cond), batch_size)
            return rows, time.perf_counter() - t0, {"coalesced": group_size, "queue_wait_s": round(wait_s, 3)}

        rows, seconds = self._run({"kind": "sample", "sampler": sampler, "batch_size": batch_size,
                                   "num_steps": num_steps, "eta": eta, "grid": grid, "seed": seed, "text": cond,
                                   "cond_scale": cond_scale})
        return rows, seconds, {}

    def sample(self, req: dict) -> dict:
        rows, seconds, extra = self.sample_rows(req)
        return self._encode(rows, seconds, **extra)

    def extend_rows(self, req: dict) -> tuple[np.ndarray, float]:
        """Validate and run an /extend request (video extension or infill): its clips and the seconds."""
        m = self.model
        raw = req.get("known_npy_b64")
        if not isinstance(raw, str):
            raise ValueError("known_npy_b64 (base64 of a .npy array) is required")
        try:
            known = np.load(io.BytesIO(base64.b64decode(raw)), allow_pickle=False)
        except Exception as e:  # noqa: BLE001 — any undecodable payload is the client's 400
            raise ValueError(f"could not decode known_npy_b64 as .npy: {e}") from None
        expect = (m.channels, m.num_frames, m.image_size, m.image_size)
        if known.shape != expect:
            raise ValueError(f"known array must have shape {expect}, got {known.shape}")
        batch_size = _coerce(req, "batch_size", int, 1)
        if not 1 <= batch_size <= 16:
            raise ValueError("batch_size must be in [1, 16]")
        mask = req.get("frame_mask")
        if not isinstance(mask, list) or len(mask) != m.num_frames or not all(isinstance(v, bool) for v in mask):
            raise ValueError(f"frame_mask must be a list of {m.num_frames} booleans")
        if all(mask) or not any(mask):
            raise ValueError("frame_mask must pin some frames and leave some free")
        # Fast by default, like /sample: DDIM-50; an explicit null runs the DDPM chain.
        num_steps = req.get("num_steps", 50)
        if num_steps is not None:
            num_steps = _coerce(req, "num_steps", int, 50)
            if not 1 <= num_steps <= m.num_timesteps:
                raise ValueError(f"num_steps must be in [1, {m.num_timesteps}]")
        grid = req.get("grid", "linspace")
        if grid not in ("linspace", "stride"):
            raise ValueError("grid must be 'linspace' or 'stride'")
        if "grid" in req and num_steps is None:
            raise ValueError("grid applies to the DDIM path; give num_steps")
        wr = _coerce(req, "recon_guidance", float, 0.0)
        cond_scale = _coerce(req, "cond_scale", float, 1.0)
        if not (math.isfinite(wr) and math.isfinite(cond_scale)) or wr < 0:
            raise ValueError("recon_guidance and cond_scale must be finite (wr >= 0)")
        if wr > 0 and num_steps is None:
            raise ValueError("recon_guidance needs num_steps (the DDIM path)")
        seed = _coerce(req, "seed", int, 0)
        cond, batch_size = self._validate_text(req, batch_size)
        if batch_size > 16:
            raise ValueError("batch_size (incl. inferred from text) must be <= 16")

        return self._run({"kind": "extend", "known": known, "frame_mask": mask, "batch_size": batch_size,
                          "num_steps": num_steps, "grid": grid, "recon_guidance": wr, "seed": seed, "text": cond,
                          "cond_scale": cond_scale})

    def extend(self, req: dict) -> dict:
        return self._encode(*self.extend_rows(req))

    def close(self) -> None:
        """Stop the micro-batcher, then release the other ranks from :func:`follow`."""
        if self.batcher is not None:
            self.batcher.close()
        if self.group is not None:
            with self.lock:
                dist.broadcast_object_list([None], src=0, group=self.group.group)
            self.group = None


def _encode_gifs(videos) -> list[bytes]:
    """(b, c, f, h, w) float batch -> GIF bytes per clip (the CLI's batch-global min-max uint8 scaling)."""
    from video_diffusion_nnx_tpu_torch.utils.media import write_sample_gifs

    with tempfile.TemporaryDirectory() as td:
        return [Path(p).read_bytes() for p in write_sample_gifs(videos, td)]


def make_handler(service: SamplingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            log.info("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, service.info())
            else:
                self._reply(404, {"error": "unknown path; GET /health or POST /sample"})

        def do_POST(self):
            handlers = {"/sample": service.sample, "/extend": service.extend}
            handler = handlers.get(self.path)
            if handler is None:
                self._reply(404, {"error": "unknown path; POST /sample or /extend"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the request body must be a JSON object")
                self._reply(200, handler(req))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface it, don't crash the server
                log.exception("%s request failed", self.path)
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # The default listen backlog (5) resets connections under bursts of concurrent clients.
    request_queue_size = 128

    def server_close(self):
        super().server_close()
        service = getattr(self, "service", None)  # unset when the bind failed in __init__
        if service is not None:
            service.close()


def create_server(model, host: str = "127.0.0.1", port: int = 8080, batch_window_s: float | None = 0.05,
                  max_batch_rows: int = 8, group=None) -> ThreadingHTTPServer:
    """The HTTP server around a loaded diffusion model (apart from :func:`main` so that a test or a benchmark
    runs it in-process on an ephemeral port). ``batch_window_s=None`` disables request coalescing. Under ``group``
    (rank 0's world group) every device call runs on all the ranks, the others in :func:`follow`."""
    service = SamplingService(model, batch_window_s, max_batch_rows, group)
    httpd = _Server((host, port), make_handler(service))
    httpd.service = service  # for tests, benchmarks and shutdown
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Serve video samples from a checkpoint over HTTP")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--checkpoint-path", type=str, required=True,
                    help="a checkpoint file written by video_diffusion_nnx_tpu_torch.convert")
    ap.add_argument("--load-ema-params", action="store_true", default=False)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--warmup", action="store_true",
                    help="run DDIM-50 at batch 1 (capturing its graph; an empty prompt for a conditioned model) "
                         "before accepting traffic")
    ap.add_argument("--batch-window", type=float, default=0.05,
                    help="seconds to linger collecting coalescable requests (default 0.05)")
    ap.add_argument("--max-batch-rows", type=int, default=8, help="max samples per coalesced sampler call")
    ap.add_argument("--no-batching", action="store_true", help="disable request coalescing (every request solo)")
    ap.add_argument("--device", type=str, default="cuda")
    add_rank_args(ap)
    return ap.parse_args(argv)


def load_model(args: argparse.Namespace, device: torch.device):
    """The config's model with the checkpoint loaded, in eval mode, warmed up if asked."""
    from video_diffusion_nnx_tpu_torch.config import build_models, load_config
    from video_diffusion_nnx_tpu_torch.convert import load_checkpoint

    _, model = build_models(load_config(args.config), device=device)
    try:
        load_checkpoint(model, args.checkpoint_path, load_ema_params=args.load_ema_params)
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}") from None
    model.eval()
    if args.warmup:
        log.info("warm-up (ddim-50, batch 1)...")
        t0 = time.perf_counter()
        cond = [""] if getattr(model.denoise_fn, "has_cond", False) else None
        model.ddim_sample(batch_size=1, num_steps=50, generator=_generator(device, 0), cond=cond)
        log.info("warm-up done in %.1fs", time.perf_counter() - t0)
    return model


def build(argv=None, group=None) -> ThreadingHTTPServer:
    """The server the CLI runs (rank 0's under ``group``): the config's model with the checkpoint loaded, warmed
    up if asked, not yet serving."""
    from video_diffusion_nnx_tpu_torch.config import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device) if group is None else group.device
    return create_server(load_model(args, device), args.host, args.port,
                         batch_window_s=None if args.no_batching else args.batch_window,
                         max_batch_rows=args.max_batch_rows, group=group)


def serve(server: ThreadingHTTPServer) -> None:
    """Serve until interrupted, then close the server (and release the other ranks)."""
    host, port = server.server_address[:2]
    log.info("serving on http://%s:%d (GET /health, POST /sample, POST /extend)", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.info("shutting down")
    finally:
        server.server_close()


def run_rank(rank: int, world: int, backend: str, init_method: str, argv=None) -> None:
    """One rank of a multi-rank server: rank 0 serves HTTP, the others follow its device calls."""
    args = parse_args(argv)
    with joined(rank, world, backend, init_method, args.device.split(":")[0]) as group:
        if rank == 0:
            serve(build(argv, group))
        else:
            model = load_model(args, group.device)
            model.data_group = group
            follow(model, group)


def main(argv=None) -> None:
    from video_diffusion_nnx_tpu_torch.config import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    world = world_size(args.ranks, device)
    if world > 1:
        launch(run_rank, world, args.dist_backend, device, argv)
        return
    serve(build(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s")
    main()
