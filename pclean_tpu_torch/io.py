"""CSV ingest with CSV.jl-like column type inference.

The port's own copy of pclean_tpu/io.py (read_csv, _infer,
remove_missing, unique_values, possibilities_from), kept here so that the
port imports nothing of the JAX package. The reference experiments rely
on Julia's CSV.File type inference (experiments/*/load_data.jl): a column
whose non-missing cells all parse as Int becomes Int, else Float64, else
String; empty cells are `missing`. We reproduce that so model
`possibilities` sets and accuracy comparison behave identically. Missing
is represented as None.
"""
from __future__ import annotations

import csv
from typing import Any, Optional


def _infer(col: list[Optional[str]]) -> list[Any]:
    vals = [v for v in col if v is not None]
    if vals:
        try:
            ints = [int(v) for v in vals]
            it = iter(ints)
            return [None if v is None else next(it) for v in col]
        except ValueError:
            pass
        try:
            fls = [float(v) for v in vals]
            it = iter(fls)
            return [None if v is None else next(it) for v in col]
        except ValueError:
            pass
    return col


def read_csv(path: str, typed: bool = True) -> dict[str, list]:
    """Read a CSV into {column: list}, None for empty cells."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols: list[list] = [[] for _ in header]
        for row in reader:
            for i in range(len(header)):
                v = row[i] if i < len(row) else ""
                cols[i].append(None if v == "" else v)
    if typed:
        cols = [_infer(c) for c in cols]
    return dict(zip(header, cols))


def remove_missing(values: list) -> list:
    """reference utils.jl:39-47."""
    return [v for v in values if v is not None]


def unique_values(values: list) -> list:
    """Order-preserving unique of non-missing values (Julia unique∘collect)."""
    seen = set()
    out = []
    for v in values:
        if v is None or v in seen:
            continue
        seen.add(v)
        out.append(v)
    return out


def possibilities_from(data: dict[str, list]) -> dict[str, list]:
    """possibilities[col] = unique non-missing observed values
    (reference experiments/hospital/load_data.jl:18-19)."""
    return {col: unique_values(vals) for col, vals in data.items()}
