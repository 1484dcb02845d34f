"""Event-time window assignment — the port of ``ksql_tpu/ops/window.py``.

Columnar arithmetic over the timestamp tensor.  ``torch.remainder`` has
floor semantics (the sign of the divisor), like ``jnp.remainder``, so
negative timestamps land in the window that starts at or before them.  On
the card the tumbling start is computed inside the ``row_prologue`` kernel
(``ops/hash_store.py``); these functions are its plain arithmetic.
"""

from __future__ import annotations

import torch


def tumbling_starts(ts: torch.Tensor, size_ms: int) -> torch.Tensor:
    return ts - torch.remainder(ts, size_ms)


def hopping_expansion(size_ms: int, advance_ms: int) -> int:
    return -(-size_ms // advance_ms)  # ceil


def slice_starts(ts: torch.Tensor, width_ms: int) -> torch.Tensor:
    """The one slice of width ``width_ms`` each record belongs to."""
    return ts - torch.remainder(ts, width_ms)
