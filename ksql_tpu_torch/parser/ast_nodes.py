"""The statement-AST nodes that the physical plan IR embeds.

Trimmed copy of ``ksql_tpu/parser/ast_nodes.py``: only the enum and node
types that ``execution/steps.py`` carries (window and join descriptors).
The names and the ``@node``/``register_enum`` registrations are kept, so
``plan_from_json`` decodes the JAX package's plan JSON unchanged.
"""

import enum
from typing import Optional

from ksql_tpu_torch.execution.expressions import node, register_enum


@register_enum
class JoinType(enum.Enum):
    INNER = "INNER"
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    OUTER = "OUTER"


@register_enum
class WindowType(enum.Enum):
    TUMBLING = "TUMBLING"
    HOPPING = "HOPPING"
    SESSION = "SESSION"


@node
class WindowExpression:
    """WINDOW TUMBLING (SIZE 1 HOUR[, RETENTION ..][, GRACE PERIOD ..]) etc.
    All durations normalized to ms at parse time."""

    window_type: WindowType
    size_ms: Optional[int] = None  # tumbling/hopping
    advance_ms: Optional[int] = None  # hopping
    gap_ms: Optional[int] = None  # session
    retention_ms: Optional[int] = None
    grace_ms: Optional[int] = None
