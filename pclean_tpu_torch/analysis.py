"""Accuracy evaluation.

Counterpart of pclean_tpu/analysis.py (read_cell_values, evaluate_accuracy,
evaluate_accuracy_device): cell-level repair scoring of the reference's
analysis.jl:36-88. CSV export (save_results / save_tables) comes in a later
slice.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .domains import FLOAT
from .engine.compile import CompiledModel
from .engine.propose import row_value
from .model.ir import ForeignKeyNode, strip_subnodes
from .model.query import Query


def read_cell_values(cm: CompiledModel, arenas: dict, params: dict,
                     cid: str, vid: int) -> list:
    """Decode one queried vertex for every row of an observed class."""
    lay = cm.layouts[cid]
    vals = row_value(cm, arenas, params, cid, vid,
                     torch.arange(lay.capacity, device=cm.device)).cpu().numpy()
    if isinstance(strip_subnodes(cm.node(cid, vid)), ForeignKeyNode):
        return [int(v) for v in vals]
    dom = cm.domain(cid, vid)
    if dom is None or dom.kind == FLOAT:
        return [float(v) for v in vals]
    return [dom.vocab.decode(int(v)) if 0 <= int(v) < len(dom.vocab) else None
            for v in vals]


def _scores(errors, changed, cleaned, imputed, imputed_ok) -> dict:
    precision = (cleaned + imputed_ok) / max(changed + imputed, 1)
    recall = (cleaned + imputed_ok) / max(errors + imputed, 1)
    f1 = 0.0 if precision + recall == 0 else \
        2.0 / (1.0 / max(precision, 1e-12) + 1.0 / max(recall, 1e-12))
    return dict(f1=f1, errors=errors, changed=changed, cleaned=cleaned,
                precision=precision, recall=recall, imputed=imputed,
                correctly_imputed=imputed_ok)


def evaluate_accuracy(cm: CompiledModel, arenas: dict, params: dict,
                      dirty: dict[str, list], clean: dict[str, list],
                      query: Query, up_to: Optional[int] = None) -> dict:
    """Cell-level scoring on the host (analysis.jl:36-88; up_to ->
    90-143). dirty/clean: {column: values} with None for missing."""
    ours = {col: read_cell_values(cm, arenas, params, query.class_id, vid)
            for col, vid in query.cleanmap.items()}
    n_rows = len(next(iter(dirty.values())))
    errors = changed = cleaned = imputed = imputed_ok = 0
    for i in range(n_rows):
        if up_to is not None and i >= up_to:
            break
        for col in clean:
            if col not in dirty:
                continue
            d = dirty[col][i]
            c = clean[col][i]
            if d is None:
                if col in ours and c is not None:
                    imputed += 1
                    if _eq(ours[col][i], c):
                        imputed_ok += 1
                continue
            if not _eq(d, c):
                errors += 1
            if col in ours:
                o = ours[col][i]
                if not _eq(o, d):
                    changed += 1
                    if _eq(o, c):
                        cleaned += 1
    return _scores(errors, changed, cleaned, imputed, imputed_ok)


def evaluate_accuracy_device(cm: CompiledModel, arenas: dict, params: dict,
                             dirty: dict[str, list], clean: dict[str, list],
                             query: Query, up_to: Optional[int] = None) -> dict:
    """evaluate_accuracy with every cell comparison on the device: five
    counts per column cross to the host. Same counts as the host version."""
    n_rows = len(next(iter(dirty.values())))
    lay = cm.layouts[query.class_id]
    N = min(n_rows, lay.capacity)
    row_limit = N if up_to is None else min(up_to, N)
    dev = cm.device
    rows_mask = torch.arange(N, device=dev) < row_limit
    errors = changed = cleaned = imputed = imputed_ok = 0
    for col in clean:
        if col not in dirty:
            continue
        vid = query.cleanmap.get(col)
        dom = cm.domain(query.class_id, vid) if vid is not None else None
        is_float = dom is not None and dom.kind == FLOAT
        dvals, cvals = dirty[col][:N], clean[col][:N]
        dp = np.array([v is not None and v == v for v in dvals], dtype=bool)
        cp = np.array([v is not None and v == v for v in cvals], dtype=bool)
        if dom is None:
            # column not queried: only contributes error counts
            eq_dc = np.array([_eq(a, b) for a, b in zip(dvals, cvals)])
            lim = np.arange(N) < row_limit
            errors += int((lim & dp & ~(eq_dc & cp)).sum())
            continue
        if is_float:
            d = np.array([float(v) if p else 0.0 for v, p in zip(dvals, dp)],
                         dtype=np.float32)
            c = np.array([float(v) if p else 0.0 for v, p in zip(cvals, cp)],
                         dtype=np.float32)
        else:
            d = np.array([dom.vocab.get(v, -1) if p else -1
                          for v, p in zip(dvals, dp)], dtype=np.int32)
            c = np.array([dom.vocab.get(v, -2) if p else -2
                          for v, p in zip(cvals, cp)], dtype=np.int32)
        dj, cj, dpj, cpj = (torch.as_tensor(x, device=dev)
                            for x in (d, c, dp, cp))
        ours = row_value(cm, arenas, params, query.class_id, vid,
                         torch.arange(N, device=dev))
        if is_float:
            ours = ours.to(torch.float32)

            def eq(a, b):
                return torch.abs(a - b) <= 1e-6 * torch.clamp(torch.abs(b),
                                                              min=1.0)
        else:
            ours = ours.to(torch.int32)

            def eq(a, b):
                return a == b
        err = rows_mask & dpj & ~(eq(dj, cj) & cpj)
        chg = rows_mask & dpj & ~eq(ours, dj)
        cln = chg & eq(ours, cj) & cpj
        imp = rows_mask & ~dpj & cpj
        imp_ok = imp & eq(ours, cj)
        e, ch, cl, im, io = torch.stack(
            [x.sum() for x in (err, chg, cln, imp, imp_ok)]).cpu().tolist()
        errors += e
        changed += ch
        cleaned += cl
        imputed += im
        imputed_ok += io
    return _scores(errors, changed, cleaned, imputed, imputed_ok)


def _eq(a: Any, b: Any) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        try:
            return abs(float(a) - float(b)) <= 1e-9 * max(1.0, abs(float(b)))
        except (TypeError, ValueError):
            return False
    return a == b
