"""The one-row loops' row step as one CUDA graph.

Counterpart of the scan bodies of pclean_tpu/engine/smc.py that XLA
compiles into one program each: scan_init (smc.py:1023-1083), scan_init_pg
(:1085-1149), the class sweeps scan_sweep_class and scan_sweep_class_pg
(:1151-1208, :1332-1447) and _replay_chunk (:817-917). The port runs those
loops one row at a time; eager, a row is about a thousand launches, each
issued by the host. Here a loop segment's row step, which never makes the
host wait for the card, is recorded once and replayed:

  * the segment's first row runs eagerly (the warm-up: libraries load,
    kernel arguments bind to the loop's carry, ops.RowCarry), on the
    stream the capture then uses;
  * before the second row the step is captured once with torch.cuda.graph,
    the loop's torch.Generator registered with the graph, so that each
    replay draws the Philox offsets the eager row would, in order with the
    eager draws between replays (resample_all);
  * every further row is one replay. The step reads its row's slot from a
    static buffer on the card and its last node advances that buffer, so a
    replay needs no host write;
  * at the segment's end the graph and its memory pool are freed.

A capture or replay that fails raises; nothing falls back to the eager
step. On the CPU, and where the caller asks for the eager step (graph=
False: the graph-against-eager checks on the card), the step is simply
called. The loops keep their counters on the host (slot bounds, the
resample every rejuv_frequency rows) and run resample_all eagerly between
replays: its K22 and K23 draws land in the segment's own parameter
leaves (resample_all's `out`), which the graph reads, and `copy_params`
writes the rest of its new tensors (the counts, a Mean's draw) into
them. Launch counts: a wrapper runs once, at the capture; the graph adds
the captured step's counts for each replay (ops.add_counts), so
ops.LAUNCHES counts launches on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import ops

# {loop kind: dict(segments, replayed, eager, captures, capture_s)} since
# the last reset_stats(): the loop segments (a replay chunk is one), and
# what they ran as replays and as eager rows
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def _stats(kind: str) -> dict:
    return STATS.setdefault(kind, dict(segments=0, replayed=0, eager=0,
                                       captures=0, capture_s=0.0))


def own_params(params: dict) -> dict:
    """A copy of every tensor leaf of params, taken once at a loop segment's
    entry: the segment's resample_all draws into it in place (out=) and
    copy_params writes the rest, and the caller's params come out
    unchanged."""
    if isinstance(params, dict):
        return {k: own_params(v) for k, v in params.items()}
    return params.clone() if torch.is_tensor(params) else params


def copy_params(dst: dict, src: dict) -> None:
    """Write every tensor leaf of src (resample_all's new params) into the
    same leaf of dst in place, so that a captured step goes on reading
    dst's storage. The two must have the same structure."""
    if dst.keys() != src.keys():
        raise ValueError(f"copy_params: keys {sorted(map(str, src))} do "
                         f"not match {sorted(map(str, dst))}")
    for k, v in src.items():
        d = dst[k]
        if isinstance(v, dict):
            copy_params(d, v)
        elif torch.is_tensor(v):
            if v is not d:
                if d.shape != v.shape or d.dtype != v.dtype:
                    raise ValueError(f"copy_params: leaf {k!r} {v.dtype} "
                                     f"{tuple(v.shape)} into {d.dtype} "
                                     f"{tuple(d.shape)}")
                d.copy_(v)
        elif v is not d and v != d:
            raise ValueError(f"copy_params: leaf {k!r} changed")


class RowGraph:
    """One loop segment's row step, replayed as a CUDA graph on the card.

    step(slot) runs one row of the loop, `slot` the static slot buffer (an
    int64 [1] tensor on the model's device) holding the row's slot. The
    rows run in the order of `base`, base + 1, ... or, with `table`, of
    the slots listed there. `kind` names the loop kind in STATS. `gen`:
    the loop's torch.Generator, registered with the graph. `graph`: the
    caller's choice (False: every row eager); the graph is used only on a
    CUDA device."""

    def __init__(self, step, device, kind: str, base: int = 0, table=None,
                 gen=None, graph: bool = True):
        device = torch.device(device)
        self._step = step
        self.gen = gen
        if table is None:
            self.table = None
            self.slot = torch.full((1,), int(base), dtype=torch.int64,
                                   device=device)
        else:
            t = np.asarray(table, np.int64)
            # the last slot once more, read by the last row's advance
            self.table = torch.as_tensor(np.append(t, t[-1:]), device=device)
            self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
            self.slot = self.table[:1].clone()
        self.graphed = bool(graph) and device.type == "cuda"
        self.graph = None
        self.stream = torch.cuda.Stream(device) if self.graphed else None
        self.rows = 0
        self.delta = None
        self._stats = _stats(kind)
        self._stats["segments"] += 1

    def _row(self) -> None:
        self._step(self.slot)
        if self.table is None:
            self.slot.add_(1)
        else:
            self.pos.add_(1)
            torch.index_select(self.table, 0, self.pos, out=self.slot)

    def row(self) -> None:
        """Run the segment's next row: eagerly (the first, or every row
        where the graph is off), else as a replay, capturing first."""
        self.rows += 1
        if not self.graphed:
            self._row()
            self._stats["eager"] += 1
            return
        cur = torch.cuda.current_stream(self.slot.device)
        if self.rows == 1:
            # the warm-up: eager, on the stream the capture uses
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self._row()
            cur.wait_stream(self.stream)
            self._stats["eager"] += 1
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        ops.add_counts(self.delta)
        self._stats["replayed"] += 1

    def _capture(self) -> None:
        t = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        if self.gen is not None:
            g.register_generator_state(self.gen)
        before = ops.snapshot()
        with torch.cuda.graph(g, stream=self.stream):
            self._row()
        # the wrappers counted once at the capture; replays count instead
        self.delta = ops.counts_since(before)
        ops.add_counts(self.delta, -1)
        self.graph = g
        self._stats["captures"] += 1
        self._stats["capture_s"] += time.perf_counter() - t

    def close(self) -> None:
        """Free the segment's graph and its memory pool."""
        if self.graph is not None:
            torch.cuda.current_stream(self.slot.device).synchronize()
            self.graph.reset()
            self.graph = None
