"""The sequence-parallel group (counterpart of the JAX package's parallel/mesh.py:24 and :53).

The JAX package shards the frame axis over a ``'seq'`` mesh axis of one
program. Here each rank is a process of its own, and a
:class:`SequenceGroup` is what a rank knows of the others: its rank, the world
size, the ``torch.distributed`` process group and the device it computes on.
Data parallelism stays at one: every rank of the group holds the same batch
and its own share of the frames.

The group is created from an explicit backend and an explicit
``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``); nothing is
read from the environment. Rank r computes on ``cuda:(r % device_count)``,
so several ranks may share one card. ``nccl`` cannot put two ranks on one
card: there the group raises, and ``gloo`` must be asked for by name.

``gloo`` takes CUDA tensors for only some collectives and types, so the group
stages every CUDA tensor of a ``gloo`` collective through pinned host memory
itself. ``stats`` counts the collectives, the bytes each rank hands them and
the host seconds they take, the staging copies included (a staged collective
first waits for the card's queued work, outside its seconds), so that the
cost of that route is measured, not hidden.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass
class SequenceGroup:
    """One rank's view of a sequence-parallel group."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    group: dist.ProcessGroup | None = None
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    def frames(self, n: int) -> slice:
        """This rank's slice of ``n`` frames (contiguous, ``n / world_size`` of them)."""
        if n % self.world_size:
            raise ValueError(f"{n} frames do not divide over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

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
        t0 = self._start(t)
        send = torch.stack(t.chunk(self.world_size, dim))
        recv = self._buffer(send.shape, t)
        dist.all_to_all_single(recv, self._send(send), group=self.group)
        out = recv.to(t.device).float().sum(0).to(t.dtype)
        self._account(t, t0)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor on t's device; every rank gets the same bits)."""
        t0 = self._start(t)
        buf = self._send(t) if self._staged(t) else t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out = buf.to(t.device)
        self._account(t, t0)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def reset_stats(self) -> None:
        self.stats.update(calls=0, bytes=0, seconds=0.0)


def init_sequence_group(rank: int, world_size: int, backend: str, init_method: str,
                        device_type: str = "cuda") -> SequenceGroup:
    """Join the group as ``rank`` of ``world_size`` (JAX ``initialize_distributed`` and ``make_mesh``).

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
    """Leave the group (the process may join another one after)."""
    if dist.is_initialized():
        dist.destroy_process_group()
