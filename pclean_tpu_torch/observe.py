"""Observability: phase timing, device traces, the latent database's size.

The port's counterpart of pclean_tpu/observe.py:

  * `Phases` — wall-clock per named phase with a one-line JSON summary (a
    copy of the JAX package's, which is pure Python);
  * `trace_to(dir)` — a torch.profiler context (the host and, where there
    is one, the card) that writes a Chrome trace into `dir`; a no-op for a
    falsy dir;
  * `effective_entity_counts` — live rows per latent class after the
    port's refresh.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Phases:
    timings: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: round(v, 4) for k, v in self.timings.items()}

    def report(self) -> str:
        return json.dumps({"phases": self.summary(), "counts": self.counts})


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """torch.profiler over the block (CPU activity, and CUDA where a card
    is present), its Chrome trace written to log_dir/trace.json on exit;
    yields the profiler (None, and no profiling, for a falsy log_dir)."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def effective_entity_counts(cm, arenas, obs_dev) -> dict[str, int]:
    """Live-row counts per latent class — the latent-database size the
    reference prints implicitly through its inferred_<Class>.csv exports."""
    from .engine.refresh import refresh

    rel = refresh(cm, arenas, obs_dev)
    return {cid: int(rel[cid]["alive"].sum())
            for cid in cm.model.class_order
            if not cm.layouts[cid].observed}
