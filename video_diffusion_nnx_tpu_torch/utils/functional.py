"""Small helpers (counterpart of the JAX package's utils/functional.py:18-55, :79-83 and :86-108)."""

from __future__ import annotations

from typing import Any, Callable, TypeVar

import torch

T = TypeVar("T")


def exists(x: Any) -> bool:
    """True iff ``x`` is not None."""
    return x is not None


def default(val: T | None, d: T | Callable[[], T]) -> T:
    """Return ``val`` when set, otherwise ``d`` (called if callable)."""
    if val is not None:
        return val
    return d() if callable(d) else d


def is_odd(n: int) -> bool:
    """True iff ``n`` is odd."""
    return n % 2 == 1


def is_list_str(x: Any) -> bool:
    """True iff ``x`` is a list or tuple whose elements are all ``str``."""
    return isinstance(x, (list, tuple)) and all(type(el) is str for el in x)


def get_text_from_path(path: str) -> str:
    """A caption from a media file's path: its name up to the first dot, with ``-`` and ``_`` as spaces."""
    out = path.split("/")[-1]
    out = out.split(".")[0]
    return out.replace("-", " ").replace("_", " ")


def prob_mask_like(shape, prob: float, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Boolean mask whose elements are True with probability ``prob`` (JAX ``prob_mask_like``, :86-108).

    ``prob`` 0 and 1 draw nothing. Otherwise the uniforms come from
    ``generator`` (which takes the place of the JAX key and must live on
    ``device``), or from torch's global generator when none is given.
    """
    if prob == 1:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.rand(shape, generator=generator, device=device) < prob
