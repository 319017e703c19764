"""Minimal directed-graph utilities for the model IR.

Replaces the reference's LightGraphs usage (builder.jl, model.jl), which only
needs: vertex/edge insertion, out-neighbors, induced subgraphs, connected
components, and a topological order. Vertices are 0-based ints here
(reference is 1-based Julia).
"""
from __future__ import annotations

from typing import Iterable, Sequence


class DiGraph:
    def __init__(self):
        self.succ: list[set[int]] = []
        self.pred: list[set[int]] = []

    @property
    def num_vertices(self) -> int:
        return len(self.succ)

    def add_vertex(self) -> int:
        self.succ.append(set())
        self.pred.append(set())
        return len(self.succ) - 1

    def add_edge(self, u: int, v: int) -> None:
        self.succ[u].add(v)
        self.pred[v].add(u)

    def out_neighbors(self, u: int) -> Iterable[int]:
        return self.succ[u]

    def in_neighbors(self, u: int) -> Iterable[int]:
        return self.pred[u]

    def edges(self):
        for u, vs in enumerate(self.succ):
            for v in vs:
                yield (u, v)


def connected_components(graph: DiGraph, vertices: Sequence[int]) -> list[list[int]]:
    """Weakly connected components of the induced subgraph on `vertices`."""
    vset = set(vertices)
    seen: set[int] = set()
    comps: list[list[int]] = []
    for s in vertices:
        if s in seen:
            continue
        comp = []
        stack = [s]
        seen.add(s)
        while stack:
            u = stack.pop()
            comp.append(u)
            for w in graph.succ[u] | graph.pred[u]:
                if w in vset and w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(comp)
    return comps


def in_topological_order(graph: DiGraph, vertices: Sequence[int]) -> list[int]:
    """`vertices` sorted consistently with edge direction (induced subgraph).

    Vertex insertion order is already topological in the builder (like the
    reference, which uses block order directly); this is a safety net that
    performs a stable Kahn sort restricted to `vertices`.
    """
    vset = set(vertices)
    indeg = {v: sum(1 for p in graph.pred[v] if p in vset) for v in vertices}
    ready = sorted([v for v in vertices if indeg[v] == 0])
    out: list[int] = []
    import heapq

    heapq.heapify(ready)
    while ready:
        u = heapq.heappop(ready)
        out.append(u)
        for w in graph.succ[u]:
            if w in vset:
                indeg[w] -= 1
                if indeg[w] == 0:
                    heapq.heappush(ready, w)
    assert len(out) == len(vertices), "cycle in model graph"
    return out
