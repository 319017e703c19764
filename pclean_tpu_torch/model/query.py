"""Query: dataset column <-> model vertex mapping.

Counterpart of the reference @query macro and Query struct
(PClean src/dsl/query.jl:1-45): each clause maps a CSV column to a
"clean" vertex (read back for output/scoring) and a "dirty" vertex (the
observation); the 2-clause form sets clean = dirty.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from .builder import resolve_path
from .ir import ClassID, Model, VertexID


@dataclass
class Query:
    model: Model
    class_id: ClassID
    cleanmap: dict[str, VertexID] = field(default_factory=dict)
    obsmap: dict[str, VertexID] = field(default_factory=dict)

    @staticmethod
    def build(model: Model, class_id: ClassID,
              clauses: Sequence[tuple]) -> "Query":
        """clauses: (column, clean_path) or (column, clean_path, dirty_path)."""
        q = Query(model, class_id)
        for clause in clauses:
            if len(clause) == 2:
                col, clean = clause
                dirty = clean
            else:
                col, clean, dirty = clause
            q.cleanmap[col] = resolve_path(model, class_id, clean)
            q.obsmap[col] = resolve_path(model, class_id, dirty)
        return q


@dataclass
class ObservedDataset:
    """(query, data) pair; data is a dict column -> list of values (None for
    missing) or a pandas DataFrame (reference query.jl:40-43)."""

    query: Query
    data: Any

    def columns(self) -> dict[str, list]:
        d = self.data
        if isinstance(d, dict):
            return d
        # pandas duck-typing
        out = {}
        for col in d.columns:
            vals = d[col].tolist()
            out[col] = vals
        return out
