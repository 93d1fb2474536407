"""Shuffling batch loader and device prefetch (counterpart of the JAX package's data/loader.py:35-173).

:class:`DataLoader` draws each epoch's order from ``np.random.default_rng(seed)``
exactly as the JAX package does, so both packages yield the same batches
for one seed. A rank of a data-parallel run draws the same order and loads
only its own rows of each batch (``rows``, from :func:`rank_rows`).
:func:`device_prefetch` runs a background thread that pins
each batch (an array, or a tuple of arrays such as the videos and text
embeddings of :func:`collate_with_text_cond`) and copies it to the device
without blocking, ``depth`` batches ahead of the training step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch


class DataLoader:
    """Shuffling, drop-last batches over a dataset of numpy items; one iteration is one epoch."""

    def __init__(self, dataset: Sequence, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, collate_fn: Callable[[list], Any] | None = None, rows: Sequence[int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = None if rows is None else [int(r) for r in rows]  # the positions in each batch to load
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.collate_fn = collate_fn or (lambda items: np.stack(items, axis=0))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            batch = order[start:start + self.batch_size]
            if self.rows is not None:
                batch = batch[self.rows]
            yield self.collate_fn([self.dataset[int(i)] for i in batch])


def rank_rows(batch_size: int, ranks: int, rank: int, microbatches: int = 1) -> list[int]:
    """The positions in each batch that ``rank`` of ``ranks`` data-parallel ranks trains on.

    The batch splits into ``microbatches`` runs of consecutive rows (gradient
    accumulation's microbatches), and each run into ``ranks`` equal parts;
    the rank takes its part of every run, in order, so that its own
    microbatch i is its part of the whole batch's microbatch i.
    """
    if batch_size % (ranks * microbatches):
        raise ValueError(f"a batch of {batch_size} rows does not split into {microbatches} microbatch(es) over "
                         f"{ranks} data-parallel ranks")
    micro, per = batch_size // microbatches, batch_size // (microbatches * ranks)
    return [i * micro + rank * per + j for i in range(microbatches) for j in range(per)]


def collate_with_text_cond(items: list) -> tuple[np.ndarray, np.ndarray]:
    """``(video, caption)`` items as ``(videos, embeddings)``: the captions embedded on the host
    (``bert_embed(tokenize(captions))``, float32, ``(b, BERT_MODEL_DIM)``), in the prefetch thread."""
    from video_diffusion_nnx_tpu_torch.models.text import embed_captions

    videos = np.stack([v for v, _ in items], axis=0)
    cond = embed_captions([c for _, c in items]).astype(np.float32)
    return videos, cond


def cycle(iterable):
    """Re-iterate ``iterable`` forever (a shuffling loader reshuffles every epoch)."""
    while True:
        yield from iterable


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def device_prefetch(iterator, device: torch.device, depth: int = 2) -> Iterator[Any]:
    """Yield each numpy batch of ``iterator`` (an array or a tuple of arrays) as tensors on ``device``,
    ``depth`` batches ahead."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_one(array) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def put(batch):
        return tuple(put_one(a) for a in batch) if isinstance(batch, tuple) else put_one(batch)

    def run():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(put(item))
        except Exception as e:  # surfaced at the consumer
            q.put(_Error(e))

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        stop.set()


def endless_prefetching_loader(dataset: Sequence, batch_size: int, device, seed: int = 0, depth: int = 2,
                               collate_fn: Callable[[list], Any] | None = None,
                               rows: Sequence[int] | None = None) -> Iterator[Any]:
    """The trainer's feed: an endless shuffled stream of batches (or of a rank's ``rows`` of each) on ``device``."""
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=seed,
                        collate_fn=collate_fn, rows=rows)
    return device_prefetch(cycle(loader), device, depth)
