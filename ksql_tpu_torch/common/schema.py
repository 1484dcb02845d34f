"""Logical schemas: named, typed key/value columns.

Trimmed copy of ``ksql_tpu/common/schema.py`` (the reference's
LogicalSchema analog, with the ROWTIME/ROWPARTITION/ROWOFFSET
pseudocolumns); it carries the schemas the plan JSON embeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ksql_tpu_torch.common import types as T
from ksql_tpu_torch.common.types import SqlType

ROWTIME = "ROWTIME"
ROWPARTITION = "ROWPARTITION"
ROWOFFSET = "ROWOFFSET"

PSEUDOCOLUMNS = {
    ROWTIME: T.BIGINT,
    ROWPARTITION: T.INTEGER,
    ROWOFFSET: T.BIGINT,
}


class Namespace:
    KEY = "KEY"
    VALUE = "VALUE"
    HEADERS = "HEADERS"


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    type: SqlType
    namespace: str = Namespace.VALUE
    index: int = 0  # position within its namespace

    def to_json(self):
        return {
            "name": self.name,
            "type": self.type.to_json(),
            "namespace": self.namespace,
        }

    @staticmethod
    def from_json(obj, index=0):
        return Column(obj["name"], SqlType.from_json(obj["type"]), obj["namespace"], index)


@dataclasses.dataclass(frozen=True)
class LogicalSchema:
    """Ordered key columns + value columns.  Column names are unique within a
    namespace; key and value may intentionally overlap (e.g. after GROUP BY the
    grouping column appears in both, LogicalSchema.java withKeyColsOnly)."""

    key_columns: Tuple[Column, ...] = ()
    value_columns: Tuple[Column, ...] = ()


    # -------------------------------------------------------------- querying

    def columns(self) -> Tuple[Column, ...]:
        return self.key_columns + self.value_columns


    def find_column(self, name: str) -> Optional[Column]:
        for c in self.columns():
            if c.name == name:
                return c
        return None



    # ----------------------------------------------------------------- misc
    def __str__(self) -> str:
        parts = [f"`{c.name}` {c.type} KEY" for c in self.key_columns]
        parts += [f"`{c.name}` {c.type}" for c in self.value_columns]
        return ", ".join(parts)

    def to_json(self):
        return {
            "keyColumns": [c.to_json() for c in self.key_columns],
            "valueColumns": [c.to_json() for c in self.value_columns],
        }

    @staticmethod
    def from_json(obj) -> "LogicalSchema":
        return LogicalSchema(
            tuple(Column.from_json(c, i) for i, c in enumerate(obj["keyColumns"])),
            tuple(Column.from_json(c, i) for i, c in enumerate(obj["valueColumns"])),
        )
