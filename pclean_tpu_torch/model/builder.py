"""Model construction: the Python DSL and relational graph assembly.

Mirrors the reference's imperative builder + macro DSL
(PClean src/dsl/builder.jl, syntax.jl) as idiomatic Python: a
`ModelBuilder` with class-handle context managers instead of `@model`
macroexpansion. The load-bearing semantics reproduced exactly:

  * block state machine (builder.jl:8-21): statements outside explicit
    `with cls.block():` groups extend the current open block;
  * foreign-key inlining (builder.jl:123-175): the entire (non-external)
    target class is copied into the source class as SubmodelNodes with
    shifted vertex ids, and the target's blocks merge into the current block
    structure;
  * reference processing (builder.jl:264-350): every path of reference slots
    registers `incoming_references` on the target class and grafts the
    referring class's downstream Compute/Choice nodes into the target's
    blocks as ExternalLikelihoodNodes, transitively;
  * plan construction (builder.jl:356-372): per block, a
    connected-component forest whose siblings are conditionally independent.

Example (hospital, cf. reference experiments/hospital/run.jl:5-56):

    b = ModelBuilder()
    with b.cls("County") as c:
        c.learned("state_proportions", Proportions())
        c.choice("state", ChooseProportionally(poss["State"],
                                               ParamRef("state_proportions")))
        c.choice("county", StringPrior(3, 30, poss["CountyName"]))
    ...
    model = b.finish()
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Optional, Sequence

from ..dists.base import ParamRef, PCleanDistribution, Ref
from ..dists.core import (
    AddNoise,
    AddTypos,
    ChooseProportionally,
    ChooseUniformly,
    MaybeSwap,
    StringPrior,
    TimePrior,
    TransformedGaussian,
)
from ..dists.params import ParamSpec
from .graph import DiGraph, connected_components, in_topological_order
from .ir import (
    ChoiceNode,
    ClassID,
    ComputeNode,
    ExternalLikelihoodNode,
    ForeignKeyNode,
    Model,
    Node,
    ParameterNode,
    ParamLookupNode,
    Path,
    PClass,
    Plan,
    SubmodelNode,
    Step,
    VertexID,
    VMap,
    shift_node,
    strip_subnodes,
)

# Which constructor attributes of each distribution are *model-value* slots
# (may hold Ref/ParamRef); order matters only for documentation.
DIST_SLOTS: dict[type, list[str]] = {
    ChooseProportionally: ["options", "probs"],
    ChooseUniformly: ["options"],
    StringPrior: ["atoms"],
    TimePrior: ["atoms"],
    AddTypos: ["word"],
    MaybeSwap: ["val", "options", "prob"],
    AddNoise: ["mean"],
    TransformedGaussian: ["mean", "transform"],
}


def resolve_path(model: Model, cid: ClassID, path: str) -> VertexID:
    """Resolve 'a.b.c' through reference-slot vmaps
    (reference resolve_dot_expression, builder.jl:63-77)."""
    c = model.classes[cid]
    head, _, rest = path.partition(".")
    if head not in c.names:
        raise KeyError(f"{cid} has no attribute {head!r}")
    if not rest:
        return c.names[head]
    fk = strip_subnodes(c.nodes[c.names[head]])
    if not isinstance(fk, ForeignKeyNode):
        raise KeyError(f"{cid}.{head} is not a reference slot")
    # Resolve the remainder in the target class's namespace, then map through
    # the vmap into this class's id space. A SubmodelNode-wrapped fk already
    # carries a vmap shifted into this class's ids (shift_node), so this
    # works at any slot-chain depth.
    target_id = resolve_path(model, fk.target_class, rest)
    return fk.vmap[target_id]


class ModelBuilder:
    def __init__(self):
        self.model = Model()
        self._block_open = False

    @contextmanager
    def cls(self, name: ClassID, py_strength: float = 1.0, py_discount: float = 0.0):
        assert name not in self.model.classes, f"duplicate class {name}"
        c = PClass(py_strength=py_strength, py_discount=py_discount)
        self.model.classes[name] = c
        self.model.class_order.append(name)
        self._block_open = False
        handle = ClassHandle(self, name)
        yield handle
        self._finish_class(name)

    def finish(self) -> Model:
        self._make_plans()
        return self.model

    # -- statement plumbing --------------------------------------------------

    def _class(self, cid: ClassID) -> PClass:
        return self.model.classes[cid]

    def _push_block_vertex(self, cid: ClassID, v: VertexID) -> None:
        c = self._class(cid)
        if self._block_open:
            c.blocks[-1].append(v)
        else:
            c.blocks.append([v])
            self._block_open = True

    def _begin_block(self, cid: ClassID) -> None:
        self._class(cid).blocks.append([])
        self._block_open = True

    def _end_block(self) -> None:
        self._block_open = False

    # -- name resolution (reference builder.jl:52-99) ------------------------

    def resolve(self, cid: ClassID, path: str) -> VertexID:
        return resolve_path(self.model, cid, path)

    def _resolve_arg(self, cid: ClassID, arg: Any) -> Optional[VertexID]:
        """Ref -> vertex id; anything else is static (returns None)."""
        if isinstance(arg, Ref):
            return self.resolve(cid, arg.path)
        if isinstance(arg, ParamRef):
            return self._class(cid).names[arg.name]
        return None

    # -- statements ----------------------------------------------------------

    def add_parameter(self, cid: ClassID, name: str, spec: ParamSpec, indexed: bool) -> VertexID:
        c = self._class(cid)
        v = c.graph.add_vertex()
        c.names[name] = v
        c.nodes.append(ParameterNode(name, spec, indexed))
        return v

    def add_choice(self, cid: ClassID, name: str, dist: PCleanDistribution) -> VertexID:
        c = self._class(cid)
        arg_ids: dict[str, VertexID] = {}
        slots = DIST_SLOTS.get(type(dist), [])
        for slot in slots:
            rid = self._resolve_arg(cid, getattr(dist, slot))
            if rid is not None:
                arg_ids[slot] = rid
        v = c.graph.add_vertex()
        c.names[name] = v
        for a in arg_ids.values():
            c.graph.add_edge(a, v)
        c.nodes.append(ChoiceNode(dist, arg_ids))
        self._push_block_vertex(cid, v)
        return v

    def add_compute(self, cid: ClassID, name: str, fn: Callable, args: Sequence[str],
                    kind: str = "table") -> VertexID:
        c = self._class(cid)
        arg_ids = [self.resolve(cid, a) for a in args]
        v = c.graph.add_vertex()
        c.names[name] = v
        for a in arg_ids:
            c.graph.add_edge(a, v)
        c.nodes.append(ComputeNode(fn, arg_ids, kind))
        self._push_block_vertex(cid, v)
        return v

    def add_param_lookup(self, cid: ClassID, name: str, param: str, key: str,
                         gate: Optional[str] = None,
                         gate_value: float = 0.0) -> VertexID:
        c = self._class(cid)
        pid = c.names[param]
        assert isinstance(c.nodes[pid], ParameterNode) and c.nodes[pid].indexed, \
            f"{param} is not an indexed learned parameter"
        kid = self.resolve(cid, key)
        gid = None if gate is None else self.resolve(cid, gate)
        v = c.graph.add_vertex()
        c.names[name] = v
        c.graph.add_edge(pid, v)
        c.graph.add_edge(kid, v)
        if gid is not None:
            c.graph.add_edge(gid, v)
        c.nodes.append(ParamLookupNode(pid, kid, gid, gate_value))
        self._push_block_vertex(cid, v)
        return v

    def add_guaranteed(self, cid: ClassID, name: str) -> None:
        self._class(cid).hash_keys.append(self.resolve(cid, name))

    def add_foreign_key(self, cid: ClassID, name: str, target_class: ClassID) -> VertexID:
        """Inline the target class (reference builder.jl:123-175)."""
        c = self._class(cid)
        t = self._class(target_class)

        v = c.graph.add_vertex()
        c.names[name] = v
        target_nodes = [n for n in t.nodes if not isinstance(n, ExternalLikelihoodNode)]
        limit_target = len(target_nodes)  # externals occupy a contiguous suffix
        vmap: VMap = {i: v + 1 + i for i in range(limit_target)}
        c.nodes.append(ForeignKeyNode(target_class, vmap))

        # CRP coupling edges: any other reference slot targeting the same
        # class (and its submodel nodes) precedes this one
        # (builder.jl:138-149).
        for i, n in enumerate(c.nodes[:-1]):
            if isinstance(n, ForeignKeyNode) and n.target_class == target_class:
                c.graph.add_edge(i, v)
                for sm in n.vmap.values():
                    c.graph.add_edge(sm, v)

        # Copy target nodes as SubmodelNodes. Internal references shift by
        # v+1: target vertex i lands at source vertex v+1+i (the reference's
        # 1-based `i + v`, builder.jl:115-120,152-156).
        for i, node in enumerate(target_nodes):
            w = c.graph.add_vertex()
            assert w == vmap[i]
            c.nodes.append(SubmodelNode(v, i, shift_node(node, v + 1)))
            c.graph.add_edge(v, w)

        # Copy target edges (within the non-external prefix).
        for (s, d) in t.graph.edges():
            if s < limit_target and d < limit_target:
                c.graph.add_edge(vmap[s], vmap[d])

        # Merge blocks: fk vertex + the target's blocks (builder.jl:166-174).
        sampled = [v]
        for block in t.blocks:
            sampled.extend(vmap[x] for x in block if x < limit_target)
        if self._block_open:
            c.blocks[-1].extend(sampled)
        else:
            c.blocks.append(sampled)
            self._block_open = True
        return v

    # -- reference processing (reference builder.jl:264-350) -----------------

    def _finish_class(self, cid: ClassID) -> None:
        c = self._class(cid)
        for v, node in enumerate(c.nodes):
            if isinstance(node, ForeignKeyNode):
                path: Path = ((cid, v),)
                self._process_reference(node.target_class, path, dict(node.vmap))
        self._block_open = False

    def _process_reference(self, target_class: ClassID, path: Path, vmap: VMap) -> None:
        source_class = path[-1][0]
        source = self._class(source_class)
        target = self._class(target_class)

        target.incoming_references[path] = dict(vmap)

        added: dict[VertexID, VertexID] = {}  # source id -> new target id
        for block_idx in reversed(range(len(target.blocks))):
            block = target.blocks[block_idx]
            pairs = [(i, vmap[i]) for i in block
                     if not isinstance(target.nodes[i], ExternalLikelihoodNode) and i in vmap]
            for (tnode, snode) in pairs:
                for nxt in sorted(source.graph.out_neighbors(snode)):
                    self._add_external(source.nodes[nxt], nxt, block_idx, path,
                                       target, source, added, from_=tnode)

        # Extend to paths of length + 1 through the target's own slots.
        for v, node in enumerate(target.nodes):
            if isinstance(node, ForeignKeyNode):
                new_path: Path = ((target_class, v),) + path
                new_vmap = {i: vmap[j] for i, j in node.vmap.items() if j in vmap}
                self._process_reference(node.target_class, new_path, new_vmap)

    def _add_external(self, snode: Node, sid: VertexID, block_idx: int, path: Path,
                      target: PClass, source: PClass, added: dict,
                      from_: Optional[VertexID]) -> None:
        # Only Compute/Choice/ParamLookup/ForeignKey nodes become externals
        # (builder.jl:353-356 asserts the rest are Parameter/Submodel).
        if not isinstance(snode, (ComputeNode, ChoiceNode, ParamLookupNode, ForeignKeyNode)):
            assert isinstance(snode, (ParameterNode, SubmodelNode)), type(snode)
            return
        if sid in added:
            if from_ is not None:
                target.graph.add_edge(from_, added[sid])
            return
        w = target.graph.add_vertex()
        added[sid] = w
        if from_ is not None:
            target.graph.add_edge(from_, w)
        target.blocks[block_idx].append(w)
        target.nodes.append(ExternalLikelihoodNode(path, sid, snode))
        # Deterministic nodes propagate further downstream (builder.jl:377-381).
        if isinstance(snode, (ComputeNode, ParamLookupNode)):
            for nxt in sorted(source.graph.out_neighbors(sid)):
                self._add_external(source.nodes[nxt], nxt, block_idx, path,
                                   target, source, added, from_=w)

    # -- plans (reference builder.jl:356-372) --------------------------------

    def _make_plans(self) -> None:
        for cid, c in self.model.classes.items():
            c.plans = [self._make_plan(c.graph, in_topological_order(c.graph, block))
                       for block in c.blocks]

    def _make_plan(self, graph: DiGraph, topo: list[VertexID]) -> Plan:
        if not topo:
            return Plan([])
        comps = connected_components(graph, topo)
        order = {v: i for i, v in enumerate(topo)}
        steps = []
        for comp in comps:
            comp_sorted = sorted(comp, key=order.__getitem__)
            steps.append(Step(comp_sorted[0], self._make_plan(graph, comp_sorted[1:])))
        steps.sort(key=lambda s: order[s.idx])
        return Plan(steps)


class ClassHandle:
    """Statement-level API for one class body (the `@class` analogue)."""

    def __init__(self, builder: ModelBuilder, cid: ClassID):
        self._b = builder
        self._cid = cid

    @contextmanager
    def block(self):
        """Explicit subproblem grouping (`begin ... end` in the reference,
        syntax.jl:121-124)."""
        self._b._begin_block(self._cid)
        yield self
        self._b._end_block()

    def learned(self, name: str, spec: ParamSpec, indexed: bool = False) -> ParamRef:
        self._b.add_parameter(self._cid, name, spec, indexed)
        return ParamRef(name)

    def choice(self, name: str, dist: PCleanDistribution) -> Ref:
        self._b.add_choice(self._cid, name, dist)
        return Ref(name)

    def fk(self, name: str, target_class: ClassID) -> Ref:
        self._b.add_foreign_key(self._cid, name, target_class)
        return Ref(name)

    def compute(self, name: str, fn: Callable, args: Sequence[str]) -> Ref:
        """Host function over discrete args -> dense lookup table."""
        self._b.add_compute(self._cid, name, fn, args, kind="table")
        return Ref(name)

    def compute_tensor(self, name: str, fn: Callable, args: Sequence[str]) -> Ref:
        """torch function over runtime tensors (floats/codes)."""
        self._b.add_compute(self._cid, name, fn, args, kind="tensor")
        return Ref(name)

    def compute_list(self, name: str, fn: Callable, args: Sequence[str]) -> Ref:
        """Host function returning an atom *list* (interned per arg tuple)."""
        self._b.add_compute(self._cid, name, fn, args, kind="list")
        return Ref(name)

    def param_lookup(self, name: str, param: str, key: str,
                     gate: Optional[str] = None, gate_value: float = 0.0) -> Ref:
        """value = param[key], or `gate_value` when the boolean `gate` vertex
        is true (the reference's conditional-parameter ternary,
        flights run.jl:28)."""
        self._b.add_param_lookup(self._cid, name, param, key, gate, gate_value)
        return Ref(name)

    def guaranteed(self, name: str) -> None:
        self._b.add_guaranteed(self._cid, name)
