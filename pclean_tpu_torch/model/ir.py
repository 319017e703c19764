"""Static model IR: classes, vertices, blocks, plans.

Mirrors the reference IR (PClean src/model/model.jl:1-188) with
these TPU-motivated differences:

  * vertices are 0-based;
  * the reference's JuliaNode splits into three compile-strategies
    (ComputeNode.kind): 'table' (host function over discrete values,
    materialized as a dense lookup table over the product of argument
    domains), 'tensor' (torch function over runtime tensors), and 'list'
    (host function returning an atom list, interned via ListRegistry);
  * indexed-parameter lookup (reference: a Dict getindex buried inside a
    JuliaNode closure, distributions.jl:45-55) is a first-class
    ParamLookupNode so it can compile to a device-side gather.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..dists.base import PCleanDistribution
from ..dists.params import ParamSpec
from .graph import DiGraph

ClassID = str
VertexID = int

# AbsVid / Path: see reference model.jl:18-35. path[0] is the nearest link;
# path[-1].class is the (transitively) referring class.
AbsVid = tuple[ClassID, VertexID]
Path = tuple[AbsVid, ...]
VMap = dict[VertexID, VertexID]


class Node:
    pass


@dataclass
class ComputeNode(Node):
    """Deterministic computation (reference JuliaNode, model.jl:136-139)."""

    fn: Callable
    arg_ids: list[VertexID]
    kind: str = "table"  # 'table' | 'tensor' | 'list'


@dataclass
class ChoiceNode(Node):
    """Random choice (reference RandomChoiceNode, model.jl:142-145).

    arg_ids maps distribution argument slot names (e.g. 'word', 'options',
    'probs') to vertex IDs; slots whose arguments were static stay absent and
    live in `dist` itself.
    """

    dist: PCleanDistribution
    arg_ids: dict[str, VertexID]


@dataclass
class ParameterNode(Node):
    """Learned parameter declaration (reference ParameterNode, model.jl:148).

    indexed=True is the reference IndexedParameter: `key_domain` is fixed at
    compile time from the key ComputeNode's domain.
    """

    name: str
    spec: ParamSpec
    indexed: bool = False


@dataclass
class ParamLookupNode(Node):
    """value = parameter[key] for an indexed parameter; float output.

    gate_id/gate_value model the reference's conditional-parameter idiom
    (flights run.jl:28: `error_prob = cond ? 1e-5 : error_probs[src.name]`):
    when the boolean gate vertex is true the value is the constant
    `gate_value` and the parameter is bypassed (no sufficient statistics
    accrue, matching incorporate_choice! dispatch on the arg type).
    """

    param_id: VertexID
    key_id: VertexID
    gate_id: Optional[VertexID] = None
    gate_value: float = 0.0


@dataclass
class ForeignKeyNode(Node):
    """Reference slot (model.jl:154-159). vmap: target-class vertex id ->
    this class's SubmodelNode vertex id."""

    target_class: ClassID
    vmap: VMap


@dataclass
class SubmodelNode(Node):
    """Inlined copy of a target-class node (model.jl:161-165)."""

    fk_id: VertexID
    sub_id: VertexID  # vertex id of this node inside the target class
    subnode: Node  # with arg ids shifted into THIS class's id space


@dataclass
class ExternalLikelihoodNode(Node):
    """A referring class's node grafted into this class's blocks so
    rejuvenation sees referrer likelihoods (model.jl:169-180)."""

    path: Path
    ext_id: VertexID  # id of this node in the referring class
    ext_node: Node  # ComputeNode | ChoiceNode (arg ids in referring class!)


@dataclass
class Plan:
    """Forest covering one block; sibling subtrees are conditionally
    independent given their common ancestors (model.jl:60-81)."""

    steps: list["Step"]


@dataclass
class Step:
    idx: VertexID
    rest: Plan


@dataclass
class PClass:
    graph: DiGraph = field(default_factory=DiGraph)
    nodes: list[Node] = field(default_factory=list)
    names: dict[str, VertexID] = field(default_factory=dict)
    hash_keys: list[VertexID] = field(default_factory=list)
    blocks: list[list[VertexID]] = field(default_factory=list)
    plans: list[Plan] = field(default_factory=list)
    incoming_references: dict[Path, VMap] = field(default_factory=dict)
    py_strength: float = 1.0  # PitmanYorParams defaults (builder.jl:39)
    py_discount: float = 0.0


@dataclass
class Model:
    classes: dict[ClassID, PClass] = field(default_factory=dict)
    class_order: list[ClassID] = field(default_factory=list)


def strip_subnodes(node: Node) -> Node:
    """Reference strip_subnodes (model.jl:185-188)."""
    while isinstance(node, SubmodelNode):
        node = node.subnode
    return node


def shift_node(node: Node, v: int) -> Node:
    """Copy a node with all vertex references shifted by v
    (reference copy_node, builder.jl:115-120)."""
    if isinstance(node, ComputeNode):
        return ComputeNode(node.fn, [a + v for a in node.arg_ids], node.kind)
    if isinstance(node, ChoiceNode):
        return ChoiceNode(node.dist, {k: a + v for k, a in node.arg_ids.items()})
    if isinstance(node, ParameterNode):
        return node
    if isinstance(node, ParamLookupNode):
        return ParamLookupNode(node.param_id + v, node.key_id + v,
                               None if node.gate_id is None else node.gate_id + v,
                               node.gate_value)
    if isinstance(node, ForeignKeyNode):
        return ForeignKeyNode(node.target_class, {i: j + v for i, j in node.vmap.items()})
    if isinstance(node, SubmodelNode):
        return SubmodelNode(node.fk_id + v, node.sub_id, shift_node(node.subnode, v))
    raise TypeError(f"cannot shift {type(node).__name__}")
