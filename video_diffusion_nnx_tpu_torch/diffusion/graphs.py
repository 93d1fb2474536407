"""The graph-captured denoiser: one forward in a CUDA graph, replayed at every sampler step.

The JAX package runs each sampler as one compiled ``lax.scan`` and keeps the
programs in a bounded LRU (``_build_sample_scan`` and ``_SAMPLE_SCAN_CACHE``
in its diffusion/gaussian_diffusion.py). Here a sampler step is a Python loop
whose denoiser forward launches some 1700 kernels at the flagship's width, so
the host, not the card, sets the pace. A :class:`DenoiserGraph` captures one
``denoise_fn.forward_with_cond_scale(x, t[, cond, cond_scale])`` on static
``x``, ``t`` (and, for a conditioned sampler, ``cond``: float32, one row per
sample) buffers of one shape; each step copies them in and replays. The
guidance scale is part of the graph: at a scale other than 1 the doubled
batch, the null mask and the combination run inside it, all made on the
device, so a cache entry is keyed by the scale and by whether a condition is
present, as the JAX package keys its programs. A ``guidance_embed`` denoiser
takes the scale as an input even without a condition (one forward of b
rows), so its graphs are keyed by the scale in either case. The
sampler's own arithmetic (a few elementwise launches a step) and its noise
draws stay eager around the replay, so no schedule coefficient is baked into
a graph and a graphed chain draws the same numbers as an eager one.

Capture runs the kernel wrappers' Python once: the host launch counters
(``ops.launch_counts``) tick at capture only. Each graph counts its replays
(``DenoiserGraph.replays``), so a run's launches are exact: the per-forward
kernels times the eager forwards and captures, and the replays apart.

A failed capture or replay raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

MAX_GRAPHS = 8  # as the JAX package's _SAMPLE_SCAN_CACHE_MAX


class DenoiserGraph:
    """One captured denoiser forward at one (batch, c, f, h, w) shape and dtype, unconditioned or with a
    condition of ``cond_shape``, at guidance scale ``cond_scale`` (None: the forward takes no scale).

    A forward runs once eagerly on a side stream first: it builds the kernel
    libraries, primes every lookup the wrappers cache (SM counts, plans) and
    sets each kernel's shared-memory attribute before the capture.
    """

    def __init__(self, denoise_fn: nn.Module, shape: tuple[int, ...], dtype: torch.dtype, device: torch.device,
                 cond_shape: tuple[int, ...] | None = None, cond_scale: float | None = None):
        self.shape, self.dtype = tuple(shape), dtype
        self.x = torch.zeros(self.shape, dtype=dtype, device=device)
        self.t = torch.zeros(self.shape[0], dtype=torch.long, device=device)
        self.cond = None if cond_shape is None else torch.zeros(cond_shape, dtype=torch.float32, device=device)
        kw = {} if self.cond is None else {"cond": self.cond}
        if cond_scale is not None:
            kw["cond_scale"] = cond_scale
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            denoise_fn.forward_with_cond_scale(self.x, self.t, **kw)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # Thread-local capture: other threads may use the device meanwhile (the trainer's prefetching loader pins
        # and copies batches while a sample during training captures, the server's request threads while another
        # request's shape is captured); none of them touches the capturing stream.
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = denoise_fn.forward_with_cond_scale(self.x, self.t, **kw)
        self.replays = 0

    def __call__(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        """The denoiser's output for ``(x, t[, cond])``: the static output, valid until the next replay."""
        self.x.copy_(x)
        self.t.copy_(t)
        if cond is not None:
            self.cond.copy_(cond)
        self.graph.replay()
        self.replays += 1
        return self.out


class GraphCache:
    """A bounded LRU of :class:`DenoiserGraph` s, keyed by shape, dtype, the condition's shape, the guidance
    scale, the module and its tensors' storage.

    Keying on every parameter's and buffer's storage drops a graph whose module
    had a tensor replaced; the owner calls :meth:`clear` when weights are
    loaded or the module moves (``GaussianDiffusion`` does both).
    """

    def __init__(self, max_graphs: int = MAX_GRAPHS):
        self.max_graphs = max_graphs
        self._graphs: OrderedDict = OrderedDict()
        self.captures = 0
        self.retired_replays = 0  # replays of graphs already evicted or dropped

    @staticmethod
    def _key(denoise_fn: nn.Module, x: torch.Tensor, cond_shape, cond_scale: float) -> tuple:
        storage = tuple(p.data_ptr() for p in denoise_fn.parameters()) + tuple(
            b.data_ptr() for b in denoise_fn.buffers())
        return (tuple(x.shape), x.dtype, x.device, cond_shape, cond_scale, id(denoise_fn), storage)

    def get(self, denoise_fn: nn.Module, x: torch.Tensor, cond: torch.Tensor | None = None,
            cond_scale: float = 1.0) -> DenoiserGraph:
        """The graph for ``x``'s shape, ``cond``'s shape (None: no condition) and ``cond_scale``, captured now if the
        cache lacks it (the oldest evicted past the bound)."""
        cond_shape = None if cond is None else tuple(cond.shape)
        # Without a condition the scale is unused, except by a guidance_embed denoiser.
        scaled = cond is not None or getattr(denoise_fn, "has_guidance_embed", False)
        scale = float(cond_scale) if scaled else None
        key = self._key(denoise_fn, x, cond_shape, 1.0 if scale is None else scale)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph
        graph = DenoiserGraph(denoise_fn, x.shape, x.dtype, x.device, cond_shape, scale)
        self.captures += 1
        self._graphs[key] = graph
        while len(self._graphs) > self.max_graphs:
            self.retired_replays += self._graphs.popitem(last=False)[1].replays
        return graph

    def __deepcopy__(self, memo) -> "GraphCache":
        """A copied model starts with no graphs: each graph is bound to the tensors of the module it captured."""
        return GraphCache(self.max_graphs)

    def replays(self) -> int:
        """Replays of every graph this cache has held."""
        return self.retired_replays + sum(g.replays for g in self._graphs.values())

    def shapes(self) -> list[tuple[int, ...]]:
        """The cached graphs' shapes, oldest first."""
        return [g.shape for g in self._graphs.values()]

    def clear(self) -> None:
        self.retired_replays = self.replays()
        self._graphs.clear()

    def __len__(self) -> int:
        return len(self._graphs)
