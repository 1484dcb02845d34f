"""Event-time window assignment — the port of ``ksql_tpu/ops/window.py``.

Columnar arithmetic over the timestamp tensor.  ``torch.remainder`` has
floor semantics (the sign of the divisor), like ``jnp.remainder``, so
negative timestamps land in the window that starts at or before them.  On
the card the tumbling start, the slice start and the k-fold hopping
expansion are computed inside the ``row_prologue`` kernel
(``ops/hash_store.py``); these functions are its plain arithmetic.

HOPPING windows take one of two routes.  The k-fold expansion assigns every
row to its ``k = ceil(size/advance)`` windows (``hopping_starts`` +
``expand``).  Stream slicing assigns each row to ONE slice of width
``gcd(size, advance)`` and combines the covering slices per window at
emission (``ops/slicing.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def tumbling_starts(ts: torch.Tensor, size_ms: int) -> torch.Tensor:
    return ts - torch.remainder(ts, size_ms)


def hopping_expansion(size_ms: int, advance_ms: int) -> int:
    return -(-size_ms // advance_ms)  # ceil


def slice_width(size_ms: int, advance_ms: int) -> int:
    """Width of one slice: the finest grid on which both window starts
    (advance-aligned) and window ends (start + size) land."""
    return math.gcd(size_ms, advance_ms)


def slices_per_window(size_ms: int, width_ms: int) -> int:
    """Covering slices per window (the width divides the size)."""
    return size_ms // width_ms


def slice_starts(ts: torch.Tensor, width_ms: int) -> torch.Tensor:
    """The one slice of width ``width_ms`` each record belongs to."""
    return ts - torch.remainder(ts, width_ms)


def hopping_starts(ts: torch.Tensor, size_ms: int,
                   advance_ms: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand n rows to k·n window assignments: ``(starts, in_window)``.
    Lane ``h·n + i`` is row ``i``'s hop ``h`` (hop-major, as ``jnp.tile``
    orders it); the caller tiles the row columns with :func:`expand`."""
    k = hopping_expansion(size_ms, advance_ms)
    n = ts.shape[0]
    first = ts - torch.remainder(ts, advance_ms)  # newest window start
    hops = torch.arange(k, dtype=ts.dtype, device=ts.device).repeat_interleave(n)
    starts = first.repeat(k) - hops * advance_ms
    ok = (starts >= 0) & (starts + size_ms > ts.repeat(k))
    return starts, ok


def expand(col: torch.Tensor, k: int) -> torch.Tensor:
    """Tile a row column to match :func:`hopping_starts`' lanes."""
    return col.repeat(k)
