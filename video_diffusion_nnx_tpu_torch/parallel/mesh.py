"""Groups of ranks and meshes of named axes over them (counterpart of the JAX package's parallel/mesh.py:53-99).

The JAX package lays one program over a mesh of devices with named axes,
``('data', 'model')`` or ``('data', 'seq')``. Here each rank is a process of
its own, and two objects say what a rank knows of the others:

* a :class:`SequenceGroup` is a group of ranks: this rank's place in it, its
  size, the ``torch.distributed`` process group and the device the rank
  computes on, with the collectives over the group. A run's whole world is
  one; so is each axis of a mesh (the name stays from when the sequence axis
  was the only one: the models consume the ``'seq'`` axis through it);
* a :class:`Mesh` arranges the world's ranks in a grid of named axes, the
  first axis the slowest (``make_mesh``: rank ``r`` of a (data, seq) mesh sits
  at ``(r // seq, r % seq)``), and holds one :class:`SequenceGroup` per axis:
  the ranks that differ from this one along that axis alone.

The world is created from an explicit backend and an explicit
``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``); nothing is
read from the environment. Rank r computes on ``cuda:(r % device_count)``,
so several ranks may share one card. ``nccl`` cannot put two ranks on one
card: there the group raises, and ``gloo`` must be asked for by name.

``gloo`` takes CUDA tensors for only some collectives and types, so a group
stages every CUDA tensor of a ``gloo`` collective through pinned host memory
itself. ``stats`` counts the collectives, the bytes each rank hands them and
the host seconds they take, the staging copies included (a staged collective
first waits for the card's queued work, outside its seconds), so that the
cost of that route is measured, not hidden. The axes of a mesh share their
world's ``stats``. A group of one rank runs no collective and counts none.

Every CLI starts its ranks the same way (:func:`launch`): ``--ranks N``
(:func:`add_rank_args`; by default the cards, one on the CPU, as JAX's
``data_parallel_mesh`` takes every local device) spawns N processes, each
running the CLI's ``run_rank(rank, world_size, backend, init_method, argv)``,
which joins the world (:func:`joined`) at a free ``tcp://localhost`` port.
"""

from __future__ import annotations

import contextlib
import logging
import math
import socket
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass
class SequenceGroup:
    """One rank's view of a group of ranks: a run's world, or one axis of a :class:`Mesh`."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: dist.ProcessGroup | None = None
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    def part(self, n: int, what: str = "items") -> slice:
        """This rank's slice of ``n`` ``what`` (contiguous, ``n / world_size`` of them)."""
        if n % self.world_size:
            raise ValueError(f"{n} {what} do not divide over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def frames(self, n: int) -> slice:
        return self.part(n, "frames")

    def rows(self, n: int) -> slice:
        return self.part(n, "rows")

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _start(self, t: torch.Tensor) -> float:
        """The host clock at a collective's start; a staged one first waits for the work queued before it, so
        that its seconds are the copies' and the collective's own."""
        if self._staged(t):
            torch.cuda.current_stream(t.device).synchronize()
        return time.perf_counter()

    def _buffer(self, shape, t: torch.Tensor) -> torch.Tensor:
        """An empty buffer for a collective on ``t``: pinned host memory when ``t`` is staged."""
        staged = self._staged(t)
        return torch.empty(shape, dtype=t.dtype, device="cpu" if staged else t.device, pin_memory=staged)

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a collective takes it: a pinned host copy when staged, else contiguous."""
        if not self._staged(t):
            return t.contiguous()
        host = self._buffer(t.shape, t)
        host.copy_(t)
        return host

    def _account(self, t: torch.Tensor, t0: float) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["seconds"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (a new tensor on t's device)."""
        if self.world_size == 1:
            return t.clone()
        t0 = self._start(t)
        src = self._send(t)
        parts = self._buffer((self.world_size, *t.shape), t)
        dist.all_gather(list(parts.unbind(0)), src, group=self.group)
        out = torch.cat(parts.to(t.device).unbind(0), dim=dim)
        self._account(t, t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of every rank's ``t``, this rank's slice along ``dim`` (a new tensor on t's device).

        Each rank sends slice j of its ``t`` to rank j (one all-to-all) and sums what it receives in
        float32, in rank order, rounding once to t's type.
        """
        if t.shape[dim] % self.world_size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over {self.world_size} ranks")
        if self.world_size == 1:
            return t.clone()
        t0 = self._start(t)
        send = torch.stack(t.chunk(self.world_size, dim))
        recv = self._buffer(send.shape, t)
        dist.all_to_all_single(recv, self._send(send), group=self.group)
        out = recv.to(t.device).float().sum(0).to(t.dtype)
        self._account(t, t0)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor on t's device; every rank gets the same bits)."""
        if self.world_size == 1:
            return t.clone()
        t0 = self._start(t)
        buf = self._send(t) if self._staged(t) else t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out = buf.to(t.device)
        self._account(t, t0)
        return out

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier(group=self.group)

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, seconds=0.0)


def init_sequence_group(rank: int, world_size: int, backend: str, init_method: str,
                        device_type: str = "cuda") -> SequenceGroup:
    """Join the world as ``rank`` of ``world_size`` (JAX ``initialize_distributed``); returns the world's group.

    ``device_type`` ``"cuda"`` puts the rank on ``cuda:(rank % device_count)``;
    ``"cpu"`` on the CPU, where only ``gloo`` runs.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a group of {world_size}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        if backend == "nccl" and world_size > cards:
            raise ValueError(
                f"nccl cannot put two ranks on one card: {world_size} ranks would share {cards} card(s); "
                "ask for backend 'gloo' by name to run them there")
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        if backend != "gloo":
            raise ValueError(f"ranks on the CPU need backend 'gloo', not {backend!r}")
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return SequenceGroup(rank=rank, world_size=world_size, backend=backend, device=device,
                         group=dist.group.WORLD)


def destroy_sequence_group() -> None:
    """Leave the world and every group made in it (the process may join another world after)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(rank: int, world_size: int, backend: str, init_method: str, device_type: str = "cuda"):
    """This rank's world group (:func:`init_sequence_group`) for the body of a ``with``; the world is left after it.
    Logging is set up for a rank that has none: rank 0 at INFO, the others at WARNING."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                            format=f"%(levelname)s:rank {rank}:%(name)s:%(message)s")
    group = init_sequence_group(rank, world_size, backend, init_method, device_type=device_type)
    try:
        yield group
    finally:
        destroy_sequence_group()


def add_rank_args(parser) -> None:
    """A CLI's ``--ranks`` and ``--dist-backend``."""
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks to run over (default: the cards, one on the CPU)")
    parser.add_argument("--dist-backend", choices=BACKENDS, default="nccl",
                        help="collective backend of a multi-rank run; ranks sharing a card need gloo")


def free_init_method() -> str:
    """A ``tcp://localhost`` address with a port that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def default_ranks(device: torch.device, at_least: int = 1) -> int:
    """The cards of ``device``'s kind (one for the CPU: JAX's local device count), at least ``at_least``."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    return max(cards, at_least)


def world_size(ranks: int | None, device: torch.device, at_least: int = 1) -> int:
    """The ranks a CLI runs over: ``--ranks``, else :func:`default_ranks`."""
    world = default_ranks(device, at_least) if ranks is None else ranks
    if world < 1:
        raise ValueError(f"--ranks must be at least 1; got {world}")
    return world


def _spawned(rank: int, rank_fn, world: int, backend: str, init_method: str, argv: list, out: str) -> None:
    result = rank_fn(rank, world, backend, init_method, argv)
    if rank == 0 and result is not None:
        torch.save(result, out)


def launch(rank_fn, world: int, backend: str, device: torch.device, argv: list | None = None):
    """Run ``rank_fn(rank, world, backend, init_method, argv)`` in ``world`` spawned processes (``argv`` None: this
    process's arguments) and return what rank 0's call returned. On CUDA the kernels are built first, once, so that
    the ranks only load them."""
    import torch.multiprocessing as mp

    if device.type == "cuda":
        from video_diffusion_nnx_tpu_torch.ops import _build

        _build.build_all()
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.getLogger(__name__).info("starting %d ranks (%s)", world, backend)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.pt"
        mp.spawn(_spawned, args=(rank_fn, world, backend, free_init_method(), argv, str(out)), nprocs=world,
                 join=True)
        return torch.load(out, weights_only=False) if out.exists() else None


@dataclass
class Mesh:
    """One rank's view of a mesh of named axes over the ranks of a world (JAX ``jax.sharding.Mesh``)."""

    shape: dict[str, int]  # axis name -> size, in the mesh's order (the first axis the slowest)
    world: SequenceGroup
    axes: dict[str, SequenceGroup]  # the group through this rank of each axis of more than one rank

    def axis(self, name: str) -> SequenceGroup:
        """The group of axis ``name`` through this rank; a group of this rank alone for an axis the mesh lacks."""
        if name in self.axes:
            return self.axes[name]
        w = self.world
        return SequenceGroup(0, 1, w.backend, w.device, None, w.stats)


def make_mesh(world: SequenceGroup, shape: dict[str, int]) -> Mesh:
    """Arrange ``world``'s ranks in a mesh of ``shape`` (axis name -> size; JAX ``make_mesh``, whose
    ``data_parallel_mesh`` and ``data_model_mesh`` are the shapes ``{"data": n}`` and ``{"data": n / m, "model": m}``).

    An axis of one rank needs no process group, and an axis as large as the
    world is the world. Any other axis makes one ``dist.new_group`` for each
    of its slices: every rank makes every slice's group, in the same order, as
    ``new_group`` requires, and keeps the one it belongs to.
    """
    sizes = [int(v) for v in shape.values()]
    if math.prod(sizes) != world.world_size:
        raise ValueError(f"a mesh of {dict(shape)} needs {math.prod(sizes)} ranks; the world has {world.world_size}")
    grid = np.arange(world.world_size).reshape(sizes)
    place = np.argwhere(grid == world.rank)[0]
    axes = {}
    for i, (name, size) in enumerate(zip(shape, sizes)):
        if size == 1:  # ``Mesh.axis`` answers for it
            continue
        if size == world.world_size:
            axes[name] = world
            continue
        slices = np.moveaxis(grid, i, -1).reshape(-1, size)  # each row: the ranks along this axis, others fixed
        mine = None
        for ranks in slices.tolist():
            group = dist.new_group(ranks)
            if world.rank in ranks:
                mine = group
        axes[name] = SequenceGroup(int(place[i]), size, world.backend, world.device, mine, world.stats)
    return Mesh(shape=dict(zip(shape, sizes)), world=world, axes=axes)
