"""Model compilation: domains, interning, dense tables, runtime layout.

Counterpart of pclean_tpu/engine/compile.py (compile.py:135-732), the
replacement for the reference's runtime proposal compiler
(PClean src/inference/proposal_compiler.jl) plus the trace/observation
plumbing (inference.jl:3-35). Every model vertex resolves to an interned
Domain, the dense log-probability / lookup tables each distribution needs
are precomputed on the host, and the latent database gets a static
struct-of-arrays layout (arenas). The JAX package's engine/interned.py has
no counterpart: every large host table simply becomes one device tensor,
uploaded once and cached by `CompiledModel.use`.

Pipeline (order matters):
  1. assign Domains to all vertices (lazy recursion; shared Vocab objects
     realize the reference's value-passing between linked attributes);
  2. ingest observed datasets — intern data values (extends vocabs), build
     per-row observation arrays with a 3-state mask (unobserved / observed /
     explicitly-missing, reference inference.jl:20-33);
  3. freeze vocabs; evaluate ComputeNode tables and atom-list registries
     over argument-domain products;
  4. build per-choice DistKernels (dense tables + tensor closures);
  5. fix arena layout (storable vertices, capacities) and parameter shapes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..dists import params as P
from ..dists.core import (AddNoise, AddTypos, ChooseProportionally,
                          ChooseUniformly, MaybeSwap, StringPrior, TimePrior,
                          TransformedGaussian, Unmodeled)
from ..domains import CATEGORICAL, FLOAT, Domain, ListRegistry
from ..model.ir import (ChoiceNode, ClassID, ComputeNode,
                        ExternalLikelihoodNode, ForeignKeyNode, Model, Node,
                        ParameterNode, ParamLookupNode, PClass, SubmodelNode,
                        VertexID, strip_subnodes)
from ..model.query import ObservedDataset
from ..strings import CharBigramLM
from ..utils import resolve_device

INVALID = "__pclean_invalid__"  # table output for args outside a host fn's domain
MAX_TABLE_CELLS = 8_000_000


@dataclass
class ObsSpec:
    """Observation layout for one observed class (one dataset)."""

    class_id: ClassID
    num_rows: int
    # vertex -> (codes/floats [N], state i8 [N]); state: 0 unobs, 1 obs, 2 missing
    columns: dict[VertexID, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    colnames: dict[str, VertexID] = field(default_factory=dict)


@dataclass
class ClassLayout:
    class_id: ClassID
    capacity: int
    observed: bool
    # storable vertices -> dtype ('i' code / 'f' float); choices + fks
    store: dict[VertexID, str] = field(default_factory=dict)
    fk_vertices: list[VertexID] = field(default_factory=list)  # raw FK nodes (own slots)


class CompiledModel:
    def __init__(self, model: Model, device=torch.device("cpu")):
        self.model = model
        self.device = torch.device(device)
        self.domains: dict[tuple[ClassID, VertexID], Domain] = {}
        self.dummy_code: dict[tuple[ClassID, VertexID], int] = {}
        self.list_reg: dict[tuple[ClassID, VertexID], ListRegistry] = {}
        self.tables: dict[tuple[ClassID, VertexID], np.ndarray] = {}  # compute tables
        self.kernels: dict[tuple[ClassID, VertexID], Any] = {}  # DistKernels
        self.layouts: dict[ClassID, ClassLayout] = {}
        self.obs_specs: list[ObsSpec] = []
        self.param_meta: dict[tuple[ClassID, VertexID], dict] = {}
        # each parameter's prior constants as a host table (dists/params.py
        # prior_table), uploaded once by use() where resample_all draws
        self.priors: dict[tuple[ClassID, VertexID], np.ndarray] = {}
        self.lm: Optional[CharBigramLM] = None
        # id(host array) -> (host array, device tensor): each large host
        # table is uploaded once and reused by every step (`use`)
        self._dev: dict[int, tuple] = {}
        # set by _audit_exact_gibbs during compile_model
        self.exact_gibbs_ok: bool = True
        # (cid, vid) -> bool [V] host truth tables (truth_table)
        self._truth: dict = {}
        # (value, dtype) -> 0-d device constant (`const`)
        self._consts: dict = {}

    # -- helpers -------------------------------------------------------------

    def const(self, value, dtype=None) -> torch.Tensor:
        """The 0-d device tensor torch.tensor(value, dtype=dtype) of a host
        constant, made once per model: a row step reads it without copying
        from the host, which a CUDA graph's capture does not allow.
        Callers only read it."""
        key = (type(value), value, dtype)
        hit = self._consts.get(key)
        if hit is None:
            hit = torch.tensor(value, dtype=dtype, device=self.device)
            self._consts[key] = hit
        return hit

    def arange(self, n: int) -> torch.Tensor:
        """torch.arange(n) on the model's device (int64), made once per
        model: the values of an option or candidate axis, which a row step
        reads without a launch of its own. Callers only read it. Made
        outside a CUDA graph's capture (the eager row before it), so that
        it never lives in a graph's memory pool."""
        key = ("arange", int(n))
        hit = self._consts.get(key)
        if hit is None:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"arange({n}) first asked for inside a "
                                   f"CUDA graph's capture")
            hit = torch.arange(int(n), device=self.device)
            self._consts[key] = hit
        return hit

    def cls(self, cid: ClassID) -> PClass:
        return self.model.classes[cid]

    def canon(self, cid: ClassID, vid: VertexID) -> tuple[ClassID, VertexID]:
        """Resolve a vertex to the class where it is original (through
        SubmodelNode copies). External nodes resolve to the referring class."""
        node = self.cls(cid).nodes[vid]
        if isinstance(node, SubmodelNode):
            fknode = strip_subnodes(self.cls(cid).nodes[node.fk_id])
            return self.canon(fknode.target_class, node.sub_id)
        if isinstance(node, ExternalLikelihoodNode):
            return self.canon(node.path[-1][0], node.ext_id)
        return (cid, vid)

    def node(self, cid: ClassID, vid: VertexID) -> Node:
        return self.cls(cid).nodes[vid]

    def domain(self, cid: ClassID, vid: VertexID) -> Domain:
        return self.domains[self.canon(cid, vid)]

    def truth_table(self, cid: ClassID, vid: VertexID) -> np.ndarray:
        """bool [V] host table mapping a categorical vertex's *codes* to the
        Python truthiness of the underlying values (INVALID is false): gate
        codes are vocabulary indices, not booleans, so ParamLookup gates
        decode through it (`cm.use` hands out its device tensor)."""
        key = self.canon(cid, vid)
        hit = self._truth.get(key)
        if hit is None:
            dom = self.domains[key]
            assert dom is not None and dom.kind == CATEGORICAL
            hit = np.array([bool(v) and v != INVALID
                            for v in dom.vocab.values], dtype=bool)
            self._truth[key] = hit
        return hit

    def use(self, arr) -> torch.Tensor:
        """The device tensor of a host numpy table (uploaded once, cached by
        object identity; the cache keeps the array alive so ids stay
        valid)."""
        hit = self._dev.get(id(arr))
        if hit is None:
            hit = (arr, torch.as_tensor(np.asarray(arr), device=self.device))
            self._dev[id(arr)] = hit
        return hit[1]


def compile_model(model: Model, datasets: Sequence[ObservedDataset],
                  capacities: Optional[dict[ClassID, int]] = None,
                  lm: Optional[CharBigramLM] = None,
                  auto_capacities: bool = False,
                  device="cuda") -> CompiledModel:
    """auto_capacities: size latent arenas from the data instead of the
    1024 default — for each latent class, the largest distinct-value count
    over observed columns whose clean path lands on it, with slack (an
    upper bound on resolvable entities: distinct dirty values over-count
    entities by typo variants, never under-count). Explicit `capacities`
    entries always win. `device`: where the tables live ("cuda" unless the
    caller asks for "cpu"; raises when no card is present)."""
    cm = CompiledModel(model, resolve_device(device))
    _assign_domains(cm)
    _ingest(cm, datasets)
    _build_tables(cm)
    cm.lm = lm if lm is not None else CharBigramLM.default(_string_corpus(cm))
    _build_kernels(cm)
    caps = dict(capacities or {})
    if auto_capacities:
        for cid, cap in _auto_capacities(cm, datasets).items():
            caps.setdefault(cid, cap)
    _fix_layouts(cm, datasets, caps)
    _collect_param_meta(cm)
    cm.exact_gibbs_ok = _audit_exact_gibbs(cm)
    cm.ref_bounds = _referrer_bounds(cm)
    # composed AddTypos SA tensors are built at compile time, as in the JAX
    # package; lazy import avoids a compile<->propose cycle
    from .propose import precompute_sa_tables
    precompute_sa_tables(cm)
    return cm


def _auto_capacities(cm: CompiledModel, datasets) -> dict:
    """Latent-class arena capacities derived from the data.

    A latent class can resolve at most as many entities as the data has
    distinct *observable signatures* for it: the joint tuple of every
    observed column whose clean path passes through that class's reference
    hop (columns landing deeper still distinguish this class's rows — a
    hospital is identified by its name AND its county's state). Entities
    beyond observational equivalence cannot be split by any proposal
    (the enumeration scores candidates purely through these columns), so
    distinct-tuple count bounds live rows; typos only add variants, never
    reduce tuples. 50% + 16 slack covers typo-variant splits and transient
    births; round up to a multiple of 64 (as the JAX package does). Classes no
    clause touches keep the default.
    """
    from ..model.ir import SubmodelNode

    col_sets: dict[ClassID, dict] = {}  # cid -> {dataset idx -> [cols]}
    for di, ds in enumerate(datasets):
        q = ds.query
        for col, vid in q.cleanmap.items():
            cur_cid, cur_vid = q.class_id, vid
            while isinstance(cm.node(cur_cid, cur_vid), SubmodelNode):
                sub = cm.node(cur_cid, cur_vid)
                fk = cm.node(cur_cid, sub.fk_id)
                cur_cid, cur_vid = fk.target_class, sub.sub_id
                col_sets.setdefault(cur_cid, {}).setdefault(di, []).append(col)
    import os
    import warnings

    out: dict[ClassID, int] = {}
    for cid, per_ds in col_sets.items():
        n = 0
        vocab_cells = 0
        for di, cols in per_ds.items():
            data = datasets[di].columns()
            cols_u = sorted(set(cols))
            tuples = {t for t in zip(*(data[c] for c in cols_u))
                      if any(v is not None for v in t)}
            n += len(tuples)
            vocab_cells += sum(len({v for v in data[c] if v is not None})
                               for c in cols_u)
        cap = ((int(n * 1.5) + 16 + 63) // 64) * 64
        # device-memory budget cap: the engine hoists per-slot
        # referrer observation histograms of roughly [cap, V] floats per
        # observed column landing on this class (propose.referrer_
        # histograms), so an auto capacity of C slots costs ~4*C*sum(V)
        # bytes of loop-invariant device state. Cap the AUTO size so that
        # cost stays within a fixed budget (default 800 MB, the JAX
        # package's default, kept so both packages size arenas alike;
        # PCLEAN_AUTO_CAP_HBM overrides) and degrade LOUDLY. Explicit
        # `capacities` entries are never capped: a user stating their
        # scale wins.
        budget = float(os.environ.get("PCLEAN_AUTO_CAP_HBM", 8e8))
        if vocab_cells:
            cap_max = max(64, int(budget / (4 * vocab_cells)) // 64 * 64)
            if cap > cap_max:
                warnings.warn(
                    f"pclean_tpu_torch: auto capacity for latent class '{cid}' "
                    f"({cap} slots from {n} distinct joint signatures) "
                    f"exceeds the device-memory hoist budget ({budget / 1e9:.1f} GB "
                    f"at ~{4 * vocab_cells} B/slot); capping to {cap_max}. "
                    "Distinct-signature counts over-count entities when "
                    "typo variants multiply across columns — pass an "
                    "explicit capacities={...} with the true entity scale "
                    "(uncapped), or raise PCLEAN_AUTO_CAP_HBM.",
                    RuntimeWarning, stacklevel=3)
                cap = cap_max
        out[cid] = cap
    return out


def _referrer_bounds(cm: CompiledModel) -> dict:
    """{path: R} — static upper bounds on how many source rows can refer to
    ONE row of a hash-keyed latent class along `path`.

    Co-reference requires matching `guaranteed` hash keys (the proposal
    enumeration masks fk candidates by key equality and births adopt the
    proposing row's key), so a slot's referrer count is bounded by the
    largest key-tuple multiplicity in the observed data — a compile-time
    constant. The engine uses it to compact each slot's referrers into an
    [R]-length index list, shrinking every per-referrer external term from
    O(source capacity) to O(R) (rents County: 50,000 -> 1,664 per slot).

    Only single-hop paths from observed classes whose key copies are
    statically observed qualify; everything else keeps the dense masked
    path.
    """
    from collections import Counter

    out: dict = {}
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        if cm.layouts[cid].observed or not c.hash_keys:
            continue
        for path, vmap in c.incoming_references.items():
            if len(path) != 1:
                continue
            src = path[0][0]
            specs = [s for s in cm.obs_specs if s.class_id == src]
            if not specs or any(k not in vmap for k in c.hash_keys):
                continue
            key_svs = [vmap[k] for k in c.hash_keys]
            counts: Counter = Counter()
            ok = True
            for spec in specs:
                cols = []
                for sv in key_svs:
                    if sv not in spec.columns or not np.all(
                            np.asarray(spec.columns[sv][1]) == 1):
                        ok = False
                        break
                    cols.append(np.asarray(spec.columns[sv][0]))
                if not ok:
                    break
                counts.update(zip(*cols))
            if not ok or not counts:
                continue
            Cs = cm.layouts[src].capacity
            R = min(max(counts.values()) + 128, Cs)
            R += -R % 128  # lane-aligned
            if R * 4 >= Cs:
                continue  # no meaningful win over the dense path
            out[path] = int(R)
    return out


def _statically_observed(cm: CompiledModel, key: tuple) -> bool:
    """True iff every live row of key's class observes `key`, so the score
    pass never takes a prior draw for it (propose.py sample-first order):

      * observed class: the column is present with observedness 1 in every
        row of every dataset over that class;
      * latent class: a propagated observation from such a column reaches it
        along EVERY fk-inlined path by which an observed class can see it
        (refresh.propagated_obs_specs). Liveness roots are observed rows —
        a latent row is live only while (transitively) referenced by one —
        so every live row has at least one referring chain, every chain
        forces the value, and an unforced chain would be a liveness path
        with no observation, which fails the check.
    """
    tc, tv = key
    if cm.layouts[tc].observed:
        specs = [s for s in cm.obs_specs if s.class_id == tc]
        return bool(specs) and all(
            tv in s.columns and np.all(np.asarray(s.columns[tv][1]) == 1)
            for s in specs)
    found = False
    for spec in cm.obs_specs:
        c = cm.cls(spec.class_id)
        for vid in range(len(c.nodes)):
            if not isinstance(c.nodes[vid], SubmodelNode):
                continue
            if cm.canon(spec.class_id, vid) != key:
                continue
            if vid in spec.columns and \
                    np.all(np.asarray(spec.columns[vid][1]) == 1):
                found = True
            else:
                return False
    return found


def _audit_exact_gibbs(cm: CompiledModel) -> bool:
    """True iff the dense block proposals are exact Gibbs everywhere, i.e.
    acceptance ratio identically 1 (see InferenceConfig.exact_gibbs_accept).

    The block weight logZ is deterministic unless a non-enumerable choice's
    prior draw (taken when the node is unobserved — propose.py score pass,
    reference block_proposal.jl:56-66) can flow into a scored term. Scored
    terms are choice-node logdensities (own observations, equality
    constraints, external referrer likelihoods) and enumeration logits; the
    Pitman-Yor prior reads no attribute values. So: exactness fails iff some
    non-enumerable canonical choice X reaches another canonical choice node
    through the deterministic arg-flow graph (ComputeNode / ParamLookupNode
    chains and distribution arguments). Conservative for latent-class nodes
    (whose observedness is data-dependent), never unsound.
    """
    readers: dict[tuple, set] = {}
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        for w, node in enumerate(c.nodes):
            if (cid, w) != cm.canon(cid, w):
                continue  # submodel/external copies mirror the original's edges
            if isinstance(node, ComputeNode):
                args = list(node.arg_ids)
            elif isinstance(node, ChoiceNode):
                args = list(node.arg_ids.values())
            elif isinstance(node, ParamLookupNode):
                args = [node.key_id] + ([node.gate_id]
                                        if node.gate_id is not None else [])
            else:
                continue
            for a in args:
                readers.setdefault(cm.canon(cid, a), set()).add((cid, w))
    for start, kern in cm.kernels.items():
        if kern.enumerable:
            continue
        if _statically_observed(cm, start):
            # never takes a prior draw in any scored situation, so its value
            # is observation-forced identically in the proposal and retained
            # passes — exactness-neutral even though non-enumerable (the
            # rents County.countykey shape: Unmodeled key columns)
            continue
        # BFS from the non-enumerable choice through deterministic readers
        seen, frontier = {start}, [start]
        while frontier:
            v = frontier.pop()
            for r in readers.get(v, ()):
                if r in seen:
                    continue
                seen.add(r)
                if isinstance(cm.node(*r), ChoiceNode):
                    return False
                frontier.append(r)
    return True


# ---------------------------------------------------------------------------
# 1. Domain assignment
# ---------------------------------------------------------------------------

def _assign_domains(cm: CompiledModel) -> None:
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        for vid in range(len(c.nodes)):
            _domain_of(cm, cid, vid)


def _domain_of(cm: CompiledModel, cid: ClassID, vid: VertexID) -> Optional[Domain]:
    key = cm.canon(cid, vid)
    if key in cm.domains:
        return cm.domains[key]
    cid, vid = key
    node = cm.node(cid, vid)
    dom: Optional[Domain] = None
    if isinstance(node, ParameterNode):
        return None
    elif isinstance(node, ForeignKeyNode):
        return None  # slot-index valued; no Domain
    elif isinstance(node, ParamLookupNode):
        dom = Domain.floating()
    elif isinstance(node, ComputeNode):
        if node.kind == "tensor":
            dom = Domain.floating()
        elif node.kind == "table":
            dom = Domain.categorical([])  # filled during _build_tables
        else:  # list: element domain, shared with consuming choice nodes
            dom = Domain.categorical([])
            cm.list_reg[key] = ListRegistry(dom)
    elif isinstance(node, ChoiceNode):
        dom = _choice_domain(cm, cid, vid, node)
    else:
        raise TypeError(type(node))
    cm.domains[key] = dom
    return dom


def _arg_domain(cm: CompiledModel, cid: ClassID, node: ChoiceNode, slot: str,
                static_val: Any) -> Domain:
    """Domain of a distribution argument: via its vertex if dynamic, else a
    fresh categorical over the static list."""
    if slot in node.arg_ids:
        d = _domain_of(cm, cid, node.arg_ids[slot])
        assert d is not None, f"argument {slot} has no value domain"
        return d
    return Domain.categorical(static_val)


def _choice_domain(cm: CompiledModel, cid: ClassID, vid: VertexID,
                   node: ChoiceNode) -> Domain:
    d = node.dist
    if isinstance(d, (ChooseProportionally, ChooseUniformly)):
        return _arg_domain(cm, cid, node, "options", getattr(d, "options", None))
    if isinstance(d, (StringPrior, TimePrior)):
        dom = _arg_domain(cm, cid, node, "atoms", d.atoms)
        dummy = d.dummy_value()
        code = dom.vocab.encode_or_add(dummy)
        cm.dummy_code[(cid, vid)] = code
        return dom
    if isinstance(d, AddTypos):
        assert "word" in node.arg_ids, "AddTypos word must be a model attribute"
        return _domain_of(cm, cid, node.arg_ids["word"])
    if isinstance(d, MaybeSwap):
        assert "val" in node.arg_ids, "MaybeSwap val must be a model attribute"
        return _domain_of(cm, cid, node.arg_ids["val"])
    if isinstance(d, (AddNoise, TransformedGaussian)):
        return Domain.floating()
    if isinstance(d, Unmodeled):
        return Domain.categorical([])
    raise TypeError(f"distribution {type(d).__name__} is not ported yet")


# ---------------------------------------------------------------------------
# 2. Ingest
# ---------------------------------------------------------------------------

def _ingest(cm: CompiledModel, datasets: Sequence[ObservedDataset]) -> None:
    for ds in datasets:
        q = ds.query
        cols = ds.columns()
        n = len(next(iter(cols.values()))) if cols else 0
        spec = ObsSpec(q.class_id, n)
        for col, vid in q.obsmap.items():
            vals = cols[col]
            node = strip_subnodes(cm.node(q.class_id, vid))
            assert isinstance(node, ChoiceNode), \
                f"obs column {col} must map to a random choice"
            dom = cm.domain(q.class_id, vid)
            supports_missing = node.dist.supports_missing
            explicit_missing = supports_missing and q.cleanmap.get(col) != vid
            if dom.kind == FLOAT:
                codes = np.zeros(n, dtype=np.float32)
                state = np.zeros(n, dtype=np.int8)
                for i, v in enumerate(vals):
                    if v is None or (isinstance(v, float) and math.isnan(v)):
                        state[i] = 2 if explicit_missing else 0
                    else:
                        codes[i] = float(v)
                        state[i] = 1
            else:
                codes = np.zeros(n, dtype=np.int32)
                state = np.zeros(n, dtype=np.int8)
                for i, v in enumerate(vals):
                    if v is None or (isinstance(v, float) and math.isnan(v)):
                        state[i] = 2 if explicit_missing else 0
                    else:
                        codes[i] = dom.vocab.encode_or_add(v)
                        state[i] = 1
            spec.columns[vid] = (codes, state)
            spec.colnames[col] = vid
        cm.obs_specs.append(spec)


# ---------------------------------------------------------------------------
# 3. Compute tables and list registries
# ---------------------------------------------------------------------------

def _table_arg_values(cm: CompiledModel, cid: ClassID, arg: VertexID) -> list:
    dom = cm.domain(cid, arg)
    assert dom is not None and dom.kind == CATEGORICAL, \
        "host compute/table nodes require categorical arguments"
    return list(dom.vocab.values)


def _build_tables(cm: CompiledModel) -> None:
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        for vid, node in enumerate(c.nodes):
            if not isinstance(node, ComputeNode) or node.kind == "tensor":
                continue
            if (cid, vid) != cm.canon(cid, vid):
                continue  # submodel copies share the original's table
            arg_vals = [_table_arg_values(cm, cid, a) for a in node.arg_ids]
            shape = tuple(len(v) for v in arg_vals)
            cells = int(np.prod(shape)) if shape else 1
            assert cells <= MAX_TABLE_CELLS, \
                f"{cid}:{vid} table too large ({cells} cells)"
            out = np.zeros(shape, dtype=np.int32)
            if node.kind == "table":
                dom = cm.domains[(cid, vid)]
                it = np.ndindex(*shape) if shape else [()]
                for idx in it:
                    try:
                        v = node.fn(*(arg_vals[k][i] for k, i in enumerate(idx)))
                    except Exception:
                        v = INVALID
                    out[idx] = dom.vocab.encode_or_add(v)
            else:  # list
                reg = cm.list_reg[(cid, vid)]
                it = np.ndindex(*shape) if shape else [()]
                for idx in it:
                    try:
                        vs = node.fn(*(arg_vals[k][i] for k, i in enumerate(idx)))
                    except Exception:
                        vs = []
                    out[idx] = reg.intern(vs)
            cm.tables[(cid, vid)] = out


def _string_corpus(cm: CompiledModel) -> list[str]:
    corpus: list[str] = []
    for (cid, vid), dom in cm.domains.items():
        if dom is not None and dom.kind == CATEGORICAL:
            corpus.extend(v for v in dom.vocab.values
                          if isinstance(v, str) and "*" not in v)
    return corpus


# ---------------------------------------------------------------------------
# 4 & 5 implemented in kernels.py / layout below
# ---------------------------------------------------------------------------

def _build_kernels(cm: CompiledModel) -> None:
    from . import kernels  # local import to avoid cycle

    for cid in cm.model.class_order:
        c = cm.cls(cid)
        for vid, node in enumerate(c.nodes):
            if not isinstance(node, ChoiceNode):
                continue
            if (cid, vid) != cm.canon(cid, vid):
                continue
            cm.kernels[(cid, vid)] = kernels.build_kernel(cm, cid, vid, node)


def _fix_layouts(cm: CompiledModel, datasets: Sequence[ObservedDataset],
                 capacities: dict[ClassID, int]) -> None:
    observed = {ds.query.class_id: spec.num_rows
                for ds, spec in zip(datasets, cm.obs_specs)}
    default_latent = 1024
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        if cid in observed:
            cap = observed[cid]
        else:
            cap = capacities.get(cid, default_latent)
        lay = ClassLayout(cid, cap, cid in observed)
        for vid, node in enumerate(c.nodes):
            if isinstance(node, ForeignKeyNode):
                lay.store[vid] = "i"
                lay.fk_vertices.append(vid)
            elif isinstance(node, ChoiceNode):
                dom = cm.domain(cid, vid)
                lay.store[vid] = "f" if dom.kind == FLOAT else "i"
            elif isinstance(node, SubmodelNode):
                sub = strip_subnodes(node)
                if isinstance(sub, ForeignKeyNode):
                    # submodel fk slots are stored on the *target* row, not
                    # here; nothing to store
                    pass
        cm.layouts[cid] = lay


def _collect_param_meta(cm: CompiledModel) -> None:
    """Fix parameter array shapes now that vocabs are frozen."""
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        for vid, node in enumerate(c.nodes):
            if not isinstance(node, ParameterNode):
                continue
            meta: dict[str, Any] = {"spec": node.spec, "indexed": node.indexed}
            if node.indexed:
                # index domain = domain of the key vertex of some lookup node
                key_dom = None
                for w, n2 in enumerate(c.nodes):
                    if isinstance(n2, ParamLookupNode) and n2.param_id == vid:
                        key_dom = cm.domain(cid, n2.key_id)
                        break
                assert key_dom is not None, \
                    f"indexed parameter {node.name} has no lookup site"
                meta["num_indices"] = key_dom.size
            else:
                meta["num_indices"] = 1
            if isinstance(node.spec, P.Proportions):
                # option count of the (unique) choice node using this param —
                # the option codes form a prefix of that node's domain
                # (ingest may have appended observed-only values after them)
                nopt = None
                for w, n2 in enumerate(c.nodes):
                    if isinstance(n2, ChoiceNode) and n2.arg_ids.get("probs") == vid:
                        nopt = cm.kernels[(cid, w)].num_options
                        break
                assert nopt is not None, f"Proportions param {node.name} unused"
                meta["num_options"] = nopt
            elif isinstance(node.spec, P.Mean):
                # sites: AddNoise/TransformedGaussian choice nodes whose mean
                # flows (directly or via ParamLookup) from this parameter
                sites = []
                for w, n2 in enumerate(c.nodes):
                    if isinstance(n2, ChoiceNode) and \
                            isinstance(n2.dist, (AddNoise, TransformedGaussian)):
                        mid = n2.arg_ids.get("mean")
                        if mid is None:
                            continue
                        mnode = c.nodes[mid]
                        if mid == vid or (isinstance(mnode, ParamLookupNode)
                                          and mnode.param_id == vid):
                            sites.append((w, n2.dist.std))
                meta["sites"] = sites
            elif not isinstance(node.spec, P.Prob):
                raise TypeError(f"{type(node.spec).__name__} parameters are "
                                "not ported yet")
            cm.priors[(cid, vid)] = P.prior_table(node.spec, meta)
            cm.param_meta[(cid, vid)] = meta


# ---------------------------------------------------------------------------
# Initial runtime state
# ---------------------------------------------------------------------------

def init_state(cm: CompiledModel, key, device="cuda") -> tuple[dict, dict]:
    """(arenas, params) state dicts of device tensors.

    arenas[cid] = {'values': {vid: [C] tensor}, 'alive': bool [C]}
    params[cid] = {vid: family-specific state dict}
    (reference: initialize_trace's empty TableTraces + ParameterNode
    instantiation, inference.jl:8-11)

    key: an int seed or a torch.Generator on the model's device; the
    parameter priors are drawn from it. `device` must match the one the
    model was compiled for ("cuda" unless the caller asks for "cpu").
    """
    dev = resolve_device(device)
    if dev != cm.device:
        raise ValueError(f"init_state on {dev} for a model compiled for "
                         f"{cm.device}")
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    arenas: dict[ClassID, dict] = {}
    for cid, lay in cm.layouts.items():
        vals = {}
        for vid, dt in lay.store.items():
            vals[vid] = torch.zeros((lay.capacity,), device=dev,
                                    dtype=torch.int32 if dt == "i"
                                    else torch.float32)
        arenas[cid] = {"values": vals,
                       "alive": torch.zeros((lay.capacity,), dtype=torch.bool,
                                            device=dev)}
    params: dict[ClassID, dict] = {}
    for (cid, vid), meta in cm.param_meta.items():
        spec = meta["spec"]
        if isinstance(spec, P.Proportions):
            st = P.init_proportions_state(gen, spec, meta["num_options"],
                                          meta["num_indices"], device=dev)
        elif isinstance(spec, P.Prob):
            st = P.init_prob_state(gen, spec, meta["num_indices"], device=dev)
        else:
            st = P.init_mean_state(gen, spec, max(len(meta["sites"]), 1),
                                   meta["num_indices"], device=dev)
        params.setdefault(cid, {})[vid] = st
    # Pitman-Yor hyperparameters as state so they can be resampled
    # (reference PitmanYorParams, trace.jl:80-108)
    py = {}
    for cid, lay in cm.layouts.items():
        if lay.observed:
            continue
        c = cm.cls(cid)
        py[cid] = {"strength": torch.tensor(c.py_strength, dtype=torch.float32,
                                            device=dev),
                   "discount": torch.tensor(c.py_discount, dtype=torch.float32,
                                            device=dev)}
    if py:
        params["__py__"] = py
    return arenas, params
