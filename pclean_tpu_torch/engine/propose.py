"""Block-proposal tracer: dense enumerative block proposals over a batch.

Counterpart of pclean_tpu/engine/propose.py (propose.py:140-1445). The Plan
forest of a block is walked once in Python; every unobserved enumerable
choice becomes a dense option axis, every reference slot a candidate axis
(existing rows + one fresh-row branch), sibling subtrees add, and one
logsumexp per axis gives the block's log-normalizer logZ (reference
proposal_compiler.jl / block_proposal.jl). A second top-down pass samples
concrete values from the recorded per-node logits.

Where the JAX tracer runs one row under `vmap`, this tracer carries the
batch axis explicitly: `row_slot` is [B] and every value at enumeration
depth d has rank 1 + d — the batch axis first (size B, or 1 when the value
is the same for every row), then the d enumeration axes (size 1 where it
broadcasts). Eight hot spots go through the hand kernels of ops.py:

  * K1 enum_logsumexp: score_fk's record [.., K+1] + logZ, and
    score_choice's logZ;
  * K2 inv_cdf_sample: every categorical draw of the sample pass;
  * K3 obs_gather_sum: the statically observed AddTypos columns of one
    enumeration context, deferred and summed in one launch at the
    context's flush (the JAX package's _matmul_obs_term/_mm_flush frames,
    as a gather-accumulate instead of a one-hot contraction);
  * K4 gauss_suffstats: the per-segment sufficient statistics behind a
    closed-form Gaussian external (referrer_histograms);
  * K5 gauss_ext_term: that external's term for every row and option of a
    latent block (_ext_gauss_term);
  * K6 maybe_swap_ext: a MaybeSwap external whose `val` is the block's
    innermost enumerated value, summed over each row's referrers for every
    option (_ext_swap_term; the flights Flight time block);
  * K7 referrer_hist: the referrer-observation histograms of the AddTypos
    externals, hoisted once per segment over the swept class's slots
    (referrer_histograms) or per batch row where none is hoisted
    (_ext_hist_term);
  * K8 sa_ext_term: the composed AddTypos external (word = table[option,
    referrer value], the hospital model's stateavg) summed over each row's
    referrers (_ext_hist_term).

The sample pass draws its uniforms from a per-block pool [B, n]
(propose.py:897-904); callers may inject the pool, which is how the tests
feed the JAX package's uniforms to the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .. import ops
from ..domains import FLOAT
from ..model.ir import (ChoiceNode, ClassID, ComputeNode,
                        ExternalLikelihoodNode, ForeignKeyNode, Node,
                        ParameterNode, ParamLookupNode, Plan, Step,
                        SubmodelNode, VertexID, strip_subnodes)
from ..utils import NEG_INF, bgather, chase, take
from .compile import CompiledModel

NINF = float(NEG_INF)


def _static_obs(st) -> bool:
    """True when the obs state is the static Python int 1 (the column is
    observed in every dataset row), so unobserved branches drop."""
    return isinstance(st, int) and st == 1


@dataclass
class Birth:
    fk_vid: VertexID  # vertex (in the proposing class) whose fk birthed
    target_class: ClassID
    is_new: Any  # bool [B]
    slot: Any  # int [B]: allocated (or re-used retained) slot
    values: dict[VertexID, Any]  # target-class vertex -> [B] value
    depth: int = 0  # nesting inside enclosing fresh births (0 = direct)


@dataclass
class BlockResult:
    env: dict[VertexID, Any]
    weight: Any
    births: list[Birth]


def _tbl_get(tbl: torch.Tensor, args) -> torch.Tensor:
    """tbl[args...] with broadcast index tensors, clamped per axis."""
    idx = tuple(a.long().clamp(0, tbl.shape[i] - 1) for i, a in enumerate(args))
    return tbl[idx]


def _rtake(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """leaf[idx] for a shared [cap] leaf, or per row for a [B, cap] leaf
    (idx then has the batch axis, or 1, first)."""
    if leaf.dim() == 1:
        return take(leaf, idx)
    if idx.dim() == 0:
        idx = idx.reshape(1)
    return bgather(leaf, idx)


class _Ctx:
    """Argument resolution adapter handed to DistKernels; `remap` maps a
    kernel's canonical arg ids into the tracing class's id space."""

    def __init__(self, tracer, depth, resolver=None, remap=None):
        self.t = tracer
        self.depth = depth
        self.resolver = resolver
        self.remap = remap

    def value(self, vid: VertexID):
        if self.remap is not None:
            vid = self.remap.get(vid, vid)
        if self.resolver is not None:
            return self.resolver(vid)
        return self.t.aligned(vid, self.depth)

    def pstate(self, cid: ClassID, vid: VertexID):
        return self.t.params[cid][vid]


class BlockTracer:
    def __init__(self, cm: CompiledModel, cid: ClassID, arenas: dict,
                 rel: dict, params: dict, obs_arrays: dict, obs_row: dict,
                 env0: dict, row_slot, force_retained: bool = False,
                 ext_hists: Optional[dict] = None,
                 ref_comp: Optional[dict] = None,
                 cand: Optional[dict] = None):
        self.cm = cm
        self.cid = cid
        self.arenas = arenas
        self.rel = rel
        self.params = params
        self.obs_arrays = obs_arrays
        self.obs_row = obs_row  # vid -> (value [B], state int 1 or [B])
        self.row_slot = torch.as_tensor(row_slot, device=cm.device).long() \
            .reshape(-1)
        self.B = int(self.row_slot.shape[0])
        self.env: dict[VertexID, tuple[int, Any]] = {
            v: (0, val.reshape(self.B)) for v, val in env0.items()}
        self.env0 = env0
        # vids whose value depends on the row (observations, slot, prior
        # draws, earlier blocks): only untainted AddTypos terms defer to K3
        self.taint: set[VertexID] = set(env0.keys())
        self.axes: list[int] = []
        self.records: dict[tuple, Any] = {}
        self.force_retained = force_retained
        self.ext_hists = ext_hists or {}
        self.ref_comp = ref_comp or {}
        # {target class: (idx [Kc], inv [cap], nc)} compact candidate axes
        self.cand = cand or {}
        self._mm_frames: list[list] = []
        # vids enumerated by score_choice whose option axis is live: vid ->
        # the depth of their children (K6 reads the innermost one)
        self._enum_axis: dict[VertexID, int] = {}
        self._pool = None
        self._pool_i = 0
        self._gen = None

    def _unif(self):
        """Next uniform [B] from the per-block pool (sample pass only)."""
        assert self._pool is not None and self._pool_i < self._pool.shape[1], \
            "uniform pool exhausted: _draw_bound undercounted"
        u = self._pool[:, self._pool_i]
        self._pool_i += 1
        return u

    # ---------------------------------------------------------------- utils

    def _full(self, depth: int) -> tuple:
        return (self.B,) + tuple(self.axes[:depth])

    def _row(self, x, depth: int):
        """A per-row [B] value (or a scalar) as rank 1 + depth."""
        x = torch.as_tensor(x, device=self.cm.device)
        if x.dim() == 0:
            return x.reshape((1,) * (1 + depth))
        return x.reshape((x.shape[0],) + (1,) * depth)

    def _st(self, st, code: int, depth: int):
        """(state == code) aligned to rank 1 + depth; static ints fold."""
        if isinstance(st, int):
            return torch.tensor(st == code, device=self.cm.device) \
                .reshape((1,) * (1 + depth))
        return self._row(st == code, depth)

    def aligned(self, vid: VertexID, depth: int):
        d, val = self.env[vid]
        if val.dim() >= 1 + depth:
            return val
        return val.reshape(tuple(val.shape) + (1,) * (1 + depth - val.dim()))

    def node(self, vid: VertexID) -> Node:
        return self.cm.node(self.cid, vid)

    def kernel(self, cid: ClassID, vid: VertexID):
        return self.cm.kernels[self.cm.canon(cid, vid)]

    def obs_of(self, vid: VertexID):
        return self.obs_row.get(vid, (None, None))

    def row_value(self, cls: ClassID, vid: VertexID, slot):
        return row_value(self.cm, self.arenas, self.params, cls, vid, slot)

    def compute_value(self, vid: VertexID, node, value_of):
        """Value of a Compute/ParamLookup node given an arg resolver."""
        if isinstance(node, ParamLookupNode):
            return _lookup(self.cm, self.params, self.cid, node, value_of)
        assert isinstance(node, ComputeNode)
        if node.kind == "tensor":
            return node.fn(*[value_of(a) for a in node.arg_ids])
        tbl = self.cm.use(self.cm.tables[self.cm.canon(self.cid, vid)])
        return _tbl_get(tbl, [value_of(a) for a in node.arg_ids])

    def py_logprobs(self, tc: ClassID):
        """Pitman-Yor prior over candidate slots + fresh row
        (trace.jl:53-61, block_proposal.jl:86-96). With per-row rel leaves
        the results carry the batch axis: existing [B, cap], new [B]."""
        c = self.cm.cls(tc)
        r = self.rel[tc]
        py = self.params.get("__py__", {}).get(tc)
        if py is not None:
            s, d = py["strength"], py["discount"]
        else:
            s = torch.tensor(c.py_strength, device=self.cm.device)
            d = torch.tensor(c.py_discount, device=self.cm.device)
        total = r["total"].to(torch.float32)
        logden = torch.log(total + s)
        cnt = r["refcount"].to(torch.float32)
        live = r["alive"] & (r["refcount"] > 0)
        ld = logden[..., None] if logden.dim() else logden
        existing = torch.where(live, torch.log(torch.clamp(cnt - d, min=1e-30))
                               - ld, torch.full_like(cnt, NINF))
        new = torch.log(d * r["nrows"].to(torch.float32) + s) - logden
        return existing, new

    def _taint_from_args(self, vid: VertexID, node) -> None:
        if isinstance(node, ParamLookupNode):
            args = [node.key_id] + ([node.gate_id]
                                    if node.gate_id is not None else [])
        else:
            args = node.arg_ids
        if any(a in self.taint for a in args):
            self.taint.add(vid)

    def _args_untainted(self, vid: VertexID, node: ChoiceNode) -> bool:
        canon = self.cm.node(*self.cm.canon(self.cid, vid))
        remap = self._arg_remap(vid, node) or {}
        for a in canon.arg_ids.values():
            a2 = remap.get(a, a)
            if isinstance(self.node(a2), ParameterNode):
                continue
            if a2 in self.taint or a2 not in self.env:
                return False
        return True

    def _gather_obs_term(self, kern, node: ChoiceNode, vid: VertexID,
                         depth: int, ov):
        """Defer a statically observed AddTypos term M[obs[b], word[k]]
        whose word is the same for every row to the enclosing frame, where
        _mm_flush sums the frame's columns with one K3 launch. Returns None
        (score it directly) otherwise."""
        from .kernels import _AddTyposK

        if not isinstance(kern, _AddTyposK) or depth == 0 \
                or not self._mm_frames or not self._args_untainted(vid, node):
            return None
        ctx = _Ctx(self, depth, remap=self._arg_remap(vid, node))
        word = ctx.value(kern.node.arg_ids["word"])
        if word.shape[0] != 1:
            return None
        self._mm_frames[-1].append((depth, self.cm.use(kern.M), ov, word))
        return torch.zeros((1,) * (1 + depth), device=self.cm.device)

    def _mm_push(self):
        self._mm_frames.append([])

    def _mm_flush(self, total):
        """Add this frame's deferred observed-column terms to `total`: one
        K3 launch per frame depth over all its columns."""
        frame = self._mm_frames.pop()
        if not frame:
            return total
        by_depth: dict[int, list] = {}
        for ent in frame:
            by_depth.setdefault(ent[0], []).append(ent)
        for depth, ents in by_depth.items():
            axes = tuple(self.axes[:depth])
            K = int(np.prod(axes))
            mats = [e[1] for e in ents]
            obs = torch.stack([e[2].reshape(-1).expand(self.B)
                               for e in ents], dim=1).to(torch.int32)
            word = torch.stack([e[3].expand((1,) + axes).reshape(K)
                                for e in ents]).to(torch.int32)
            out = ops.obs_gather_sum(mats, obs.contiguous(), word.contiguous())
            total = total + out.reshape((self.B,) + axes)
        return total

    # ------------------------------------------------------------- scoring

    def score_plan(self, plan: Plan, depth: int, mode: dict, ctx_key: tuple):
        total = torch.zeros((1,) * (1 + depth), device=self.cm.device)
        for step in plan.steps:
            total = total + self.score_step(step, depth, mode, ctx_key)
        return total

    def score_step(self, step: Step, depth: int, mode: dict, ctx_key: tuple):
        vid = step.idx
        node = self.node(vid)
        if isinstance(node, ParameterNode):
            return self.score_plan(step.rest, depth, mode, ctx_key)
        if isinstance(node, ExternalLikelihoodNode):
            return self.score_external(step, depth, mode, ctx_key)
        if isinstance(node, (ComputeNode, ParamLookupNode)):
            self.env[vid] = (depth, self.compute_value(
                vid, node, lambda a: self.aligned(a, depth)))
            self._taint_from_args(vid, node)
            return self.score_plan(step.rest, depth, mode, ctx_key)
        if isinstance(node, ForeignKeyNode):
            return self.score_fk(step, vid, node, depth, mode, ctx_key)
        if isinstance(node, SubmodelNode):
            fmode = mode.get(node.fk_id)
            assert fmode in ("E", "N"), "submodel step outside its fk context"
            while fmode == "N" and isinstance(node.subnode, SubmodelNode):
                node = node.subnode
                fmode = mode.get(node.fk_id)
                assert fmode in ("E", "N"), \
                    "nested submodel step outside its fk context"
            if fmode == "N":
                sub = node.subnode
                if isinstance(sub, ForeignKeyNode):
                    return self.score_fk(step, vid, sub, depth, mode, ctx_key)
                if isinstance(sub, (ComputeNode, ParamLookupNode)):
                    self.env[vid] = (depth, self.compute_value(
                        vid, sub, lambda a: self.aligned(a, depth)))
                    self._taint_from_args(vid, sub)
                    return self.score_plan(step.rest, depth, mode, ctx_key)
                assert isinstance(sub, ChoiceNode)
                return self.score_choice(step, vid, sub, depth, mode, ctx_key)
            # copy mode: gather from the candidate rows; observed -> equality
            fknode = _fk(self.cm, self.cid, node.fk_id)
            slot = self.aligned(node.fk_id, depth)
            val = self.row_value(fknode.target_class, node.sub_id, slot)
            self.env[vid] = (depth, val)
            if node.fk_id in self.taint:
                self.taint.add(vid)
            term = torch.zeros((1,) * (1 + depth), device=self.cm.device)
            ov, st = self.obs_of(vid)
            if ov is not None:
                ova = self._row(ov, depth)
                dom = self.cm.domain(self.cid, vid)
                if dom is not None and dom.kind == FLOAT:
                    eq = torch.abs(val - ova) <= 1e-6 * torch.clamp(
                        torch.abs(ova), min=1.0)
                else:
                    eq = val == ova
                zero = torch.zeros((), device=self.cm.device)
                term = torch.where(self._st(st, 1, depth),
                                   torch.where(eq, zero, NINF), zero)
            return term + self.score_plan(step.rest, depth, mode, ctx_key)
        assert isinstance(node, ChoiceNode)
        return self.score_choice(step, vid, node, depth, mode, ctx_key)

    def _arg_remap(self, vid: VertexID, node: ChoiceNode):
        canon = self.cm.node(*self.cm.canon(self.cid, vid))
        if canon is node:
            return None
        return {canon.arg_ids[s]: node.arg_ids[s] for s in canon.arg_ids}

    def score_choice(self, step: Step, vid: VertexID, node: ChoiceNode,
                     depth: int, mode: dict, ctx_key: tuple):
        kern = self.kernel(self.cid, vid)
        ctx = _Ctx(self, depth, remap=self._arg_remap(vid, node))
        ov, st = self.obs_of(vid)
        full = self._full(depth)
        if _static_obs(st):
            # observed in every dataset row: the value IS ov
            term = self._gather_obs_term(kern, node, vid, depth, ov)
            if term is None:
                term = kern.obs_logdensity(ctx, self._row(ov, depth))
            val = self._row(ov, depth)
            self.records[("so", vid, ctx_key)] = val.expand(full)
            self.env[vid] = (depth, val)
            self.taint.add(vid)
            return term + self.score_plan(step.rest, depth, mode, ctx_key)
        if not kern.enumerable:
            # prior draw now, so observed descendants score against it
            # (block_proposal.jl:56-66); recorded for the sample pass
            if self.force_retained:
                drawn = self._row(self._forced(vid), depth)
            else:
                drawn = kern.sample_prior(ctx, self._gen if
                                          kern.prior_needs_key else None)
            zero = torch.zeros((), device=self.cm.device)
            if ov is not None:
                ova = self._row(ov, depth)
                miss = kern.missing_logdensity(ctx)
                term = torch.where(
                    self._st(st, 1, depth), kern.obs_logdensity(ctx, ova),
                    torch.where(self._st(st, 2, depth),
                                torch.as_tensor(miss, device=self.cm.device,
                                                dtype=torch.float32), zero))
                val = torch.where(self._st(st, 1, depth), ova.to(drawn.dtype)
                                  if torch.is_tensor(drawn) else ova, drawn)
            else:
                term = torch.zeros((1,) * (1 + depth), device=self.cm.device)
                val = drawn
            val = torch.as_tensor(val, device=self.cm.device)
            val = val.reshape(tuple(val.shape) + (1,) *
                              max(0, 1 + depth - val.dim()))
            self.records[("ne", vid, ctx_key)] = val.expand(full)
            self.env[vid] = (depth, val)
            self.taint.add(vid)
            return term + self.score_plan(step.rest, depth, mode, ctx_key)
        V = kern.V
        enum = torch.as_tensor(kern.enum_logits(ctx), dtype=torch.float32,
                               device=self.cm.device)
        if enum.dim() < 2 + depth:
            enum = enum.reshape((1,) * (2 + depth - enum.dim())
                                + tuple(enum.shape))
        if ov is not None:
            ova = self._row(ov, depth)
            obs_ld = kern.obs_logdensity(ctx, ova).to(torch.float32)
            obs_ld = obs_ld.reshape(tuple(obs_ld.shape) + (1,) *
                                    max(0, 1 + depth - obs_ld.dim()))
            ar = torch.arange(V, device=self.cm.device)
            delta = torch.where(ar == ova[..., None], obs_ld[..., None],
                                torch.tensor(NINF, device=self.cm.device))
            logits = torch.where(self._st(st, 1, depth)[..., None], delta,
                                 enum)
        else:
            logits = enum
        self.axes.append(V)
        self.env[vid] = (depth + 1, torch.arange(V, device=self.cm.device)
                         .reshape((1,) * (1 + depth) + (V,)))
        self._enum_axis[vid] = depth + 1
        self._mm_push()
        children = self._mm_flush(
            self.score_plan(step.rest, depth + 1, mode, ctx_key))
        del self._enum_axis[vid]
        self.axes.pop()
        total = (logits + children).expand(full + (V,))
        self.records[(vid, ctx_key)] = total
        _rec, logz = ops.enum_logsumexp(total.reshape(-1, V).contiguous())
        return logz.reshape(full)

    def score_fk(self, step: Step, vid: VertexID, fknode: ForeignKeyNode,
                 depth: int, mode: dict, ctx_key: tuple):
        tc = fknode.target_class
        cap = self.cm.layouts[tc].capacity
        comp = self.cand.get(tc)
        py_exist_full, py_new = self.py_logprobs(tc)
        dev = self.cm.device
        if comp is not None:
            idx, _invm, nc = comp
            K = int(idx.shape[0])
            pos = torch.arange(K, device=dev)
            # pad positions clamp their gathers to a real slot; the mask
            # makes them unselectable regardless of what they scored
            slot_ids = torch.clamp(idx, max=cap - 1)
            py_exist = torch.where(pos < nc, _rtake(py_exist_full,
                                                    slot_ids[None, :]),
                                   torch.tensor(NINF, device=dev))
        else:
            K = cap
            slot_ids = torch.arange(K, device=dev)
            py_exist = py_exist_full.reshape((-1, K))
        full = self._full(depth)
        py_exist = py_exist.reshape((py_exist.shape[0],) + (1,) * depth + (K,))

        self.axes.append(K)
        self.env[vid] = (depth + 1, slot_ids.reshape((1,) * (1 + depth) + (K,)))
        self._mm_push()
        ch_e = self._mm_flush(
            self.score_plan(step.rest, depth + 1, {**mode, vid: "E"},
                            ctx_key + ((vid, "E"),)))
        self.axes.pop()
        exist = py_exist + ch_e

        self.env[vid] = (depth, torch.zeros((1,) * (1 + depth),
                                            dtype=torch.long, device=dev))
        # the N branch scores at the caller's depth but its terms belong to
        # this fk's "new" logit only
        self._mm_push()
        ch_n = self._mm_flush(
            self.score_plan(step.rest, depth, {**mode, vid: "N"},
                            ctx_key + ((vid, "N"),)))
        new = self._row(py_new, depth) + ch_n

        rec, logz = ops.enum_logsumexp(
            exist.expand(full + (K,)).reshape(-1, K).contiguous(),
            new.expand(full).reshape(-1).contiguous())
        self.records[(vid, ctx_key)] = rec.reshape(full + (K + 1,))
        del self.env[vid]
        return logz.reshape(full)

    # -------------------------------------------------- external likelihoods

    def score_external(self, step: Step, depth: int, mode: dict,
                       ctx_key: tuple):
        """Referrer likelihoods of the swept row (block_proposal.jl:119-155,
        vectorized). The referrer axis comes last: the full source capacity
        [Cs] shared by every row, or a compacted per-row list [B, R]."""
        node: ExternalLikelihoodNode = self.node(step.idx)
        path = node.path
        src = path[-1][0]
        dev = self.cm.device
        comp = self.ref_comp.get(path)
        if comp is not None:
            idx_all, cnt = comp
            slots = take(idx_all, self.row_slot)                    # [B, R]
            cnt_rows = take(cnt, self.row_slot)
            mask = torch.arange(slots.shape[1], device=dev)[None, :] < \
                cnt_rows[:, None]
            refs = {"cnt": cnt_rows}
            slots_r = slots.reshape((self.B,) + (1,) * depth + (-1,))
        else:
            Cs = self.cm.layouts[src].capacity
            t = chase([self.arenas[c]["values"][f] for c, f in reversed(path)])
            alive = self.rel[src]["alive"]
            mask = alive & (t[None, :] == self.row_slot[:, None])  # [B, Cs]
            refs = {"t": t, "alive": alive, "slot": self.row_slot}
            slots = torch.arange(Cs, device=dev)
            slots_r = slots.reshape((1,) * (1 + depth) + (Cs,))

        vmap = self.cm.cls(self.cid).incoming_references[path]
        inv = {sv: tv for tv, sv in vmap.items()}
        cache: dict[VertexID, Any] = {}

        def ext_value(svid: VertexID):
            """A source-class vertex over the referrer axis (rank 2 + depth),
            with this block's in-flight values overlaid on mapped vertices
            (proposal_row_state.jl's overlay)."""
            if svid in cache:
                return cache[svid]
            if svid in inv and inv[svid] in self.env:
                v = self.aligned(inv[svid], depth)[..., None]
                cache[svid] = v
                return v
            snode = self.cm.node(src, svid)
            if isinstance(snode, ParamLookupNode):
                v = _lookup(self.cm, self.params, src, snode, ext_value)
            elif isinstance(snode, ComputeNode):
                if snode.kind == "tensor":
                    v = snode.fn(*[ext_value(a) for a in snode.arg_ids])
                else:
                    tbl = self.cm.use(self.cm.tables[self.cm.canon(src, svid)])
                    v = _tbl_get(tbl, [ext_value(a) for a in snode.arg_ids])
            else:
                v = self.row_value(src, svid, slots_r)
            cache[svid] = v
            return v

        mask_r = mask.reshape((self.B,) + (1,) * depth + (mask.shape[-1],))
        terms, presummed = self._ext_terms(step, src, ext_value, cache,
                                           depth, mask, inv, slots, refs)
        zero = torch.zeros((), device=dev)
        return torch.where(mask_r, terms, zero).sum(-1) + presummed

    def _ext_terms(self, step: Step, src: ClassID, ext_value, cache,
                   depth: int, mask, inv, slots, refs=None):
        """(per-referrer terms [.., Cs], pre-summed terms [..]). AddTypos
        externals whose word is the overlaid value collapse to a referrer
        histogram times the typo matrix (_ext_hist_term). `refs` names each
        row's referrers for K6: dict(t, alive, slot) over the full source
        axis, or dict(cnt) of the compacted per-row lists `slots`."""
        node: ExternalLikelihoodNode = self.node(step.idx)
        ext = node.ext_node
        dev = self.cm.device
        total = torch.zeros((1,) * (2 + depth), device=dev)
        presummed = torch.zeros((1,) * (1 + depth), device=dev)
        if isinstance(ext, (ComputeNode, ParamLookupNode)):
            cache.pop(node.ext_id, None)
            if isinstance(ext, ParamLookupNode):
                v = _lookup(self.cm, self.params, src, ext, ext_value)
            elif ext.kind == "tensor":
                v = ext.fn(*[ext_value(a) for a in ext.arg_ids])
            else:
                tbl = self.cm.use(self.cm.tables[self.cm.canon(src, node.ext_id)])
                v = _tbl_get(tbl, [ext_value(a) for a in ext.arg_ids])
            cache[node.ext_id] = v
        elif isinstance(ext, ChoiceNode):
            kern = self.cm.kernels[self.cm.canon(src, node.ext_id)]
            hist_term = self._ext_hist_term(kern, ext, src, node.ext_id,
                                            mask, inv, depth, ext_value,
                                            path=node.path, slots=slots)
            if hist_term is None:
                hist_term = self._ext_gauss_term(kern, src, node.ext_id, inv,
                                                 depth, path=node.path)
            if hist_term is None and refs is not None:
                hist_term = self._ext_swap_term(kern, ext, src, node.ext_id,
                                                inv, depth, ext_value, slots,
                                                refs)
            if hist_term is not None:
                presummed = presummed + hist_term
            else:
                ctx = _Ctx(self, depth, resolver=ext_value)
                ov, st = self._ext_obs(src, node.ext_id, slots)
                shape = ((ov.shape[0] if ov.dim() == 2 else 1,)
                         + (1,) * depth + (ov.shape[-1],))
                ov = ov.reshape(shape)
                obs_t = kern.obs_logdensity(ctx, ov)
                if st is None:
                    term = obs_t
                else:
                    st = st.reshape(shape)
                    miss_t = torch.as_tensor(kern.missing_logdensity(ctx),
                                             dtype=torch.float32, device=dev)
                    zero = torch.zeros((), device=dev)
                    term = torch.where(st == 1, obs_t,
                                       torch.where(st == 2, miss_t, zero))
                if all(n == 1 for n in term.shape[1:-1]):
                    # option-independent (no enumeration axis): sum over the
                    # referrers once instead of broadcasting into the
                    # [B, axes..., Cs] total (propose.py:692-699)
                    t2 = term.reshape(term.shape[0], term.shape[-1])
                    presummed = presummed + torch.where(
                        mask, t2, torch.zeros((), device=dev)).sum(-1) \
                        .reshape((-1,) + (1,) * depth)
                else:
                    total = total + term
        elif isinstance(ext, ForeignKeyNode):
            raise NotImplementedError(
                "external foreign-key likelihoods (DPMem-style) unsupported, "
                "as in the reference (proposal_compiler.jl:344-345)")
        for child in step.rest.steps:
            cn = self.node(child.idx)
            assert isinstance(cn, ExternalLikelihoodNode)
            t2, p2 = self._ext_terms(child, src, ext_value, cache, depth,
                                     mask, inv, slots, refs)
            total = total + t2
            presummed = presummed + p2
        return total, presummed

    _SA_MAX_CELLS = 16_000_000

    def _ext_hist_term(self, kern, ext: ChoiceNode, src: ClassID,
                       ext_id: VertexID, mask, inv, depth: int, ext_value,
                       path=None, slots=None):
        """Histogram path for AddTypos externals: sum_r M[obs_r, word_r]
        collapses to hist @ M when `word` is the overlaid latent value (the
        hoisted histogram, else K7's per-row form), or, when word =
        table[latent, one referrer value] (the composed case,
        propose.py:719-812), to the sum of SA[option, rv_r, obs_r] over the
        referrers (K8). None when inapplicable."""
        from .kernels import _AddTyposK

        if not isinstance(kern, _AddTyposK):
            return None
        word_sv = ext.arg_ids.get("word")
        if word_sv is None:
            return None
        val, st = self._ext_obs(src, ext_id, slots)
        w = mask if st is None else (mask & (st != 2))
        V = kern.V
        # the referrer axis as [1 or B, R] beside w [B, R]
        val = val.reshape(-1, val.shape[-1])

        if word_sv in inv and inv[word_sv] in self.env:
            pre = self.ext_hists.get((path, ext_id))
            if pre is not None:
                hist = take(pre, self.row_slot)                   # [B, V]
            else:
                hist = ops.referrer_hist(val, w, V)
            termvec = hist @ self.cm.use(kern.M)                  # [B, V]
            arg = self.aligned(inv[word_sv], depth)
            return bgather(termvec, arg)
        snode = self.cm.node(src, word_sv)
        if not (isinstance(snode, ComputeNode) and snode.kind == "table"):
            return None
        env_args, ref_args = [], []
        for a in snode.arg_ids:
            if a in inv and inv[a] in self.env:
                env_args.append(a)
            else:
                ref_args.append(a)
        if not env_args or len(ref_args) > 1:
            return None
        tbl = self.cm.tables.get(self.cm.canon(src, word_sv))
        if tbl is None or tbl.size * V > self._SA_MAX_CELLS:
            return None
        order = [snode.arg_ids.index(a) for a in env_args + ref_args]
        cache_key = ("sa", self.cm.canon(src, word_sv),
                     self.cm.canon(src, ext_id), tuple(order))
        sa_cache = self.cm.__dict__.setdefault("_ext_sa_cache", {})
        SA = sa_cache.get(cache_key)
        if SA is None:
            SA = np.ascontiguousarray(
                np.asarray(kern.M).T[np.transpose(tbl, order)])
            sa_cache[cache_key] = SA
        SAd = self.cm.use(SA)
        ne = len(env_args)
        env_shape = SA.shape[:ne]
        E = int(np.prod(env_shape))
        if ref_args:
            rv = ext_value(ref_args[0])
            if rv.shape[-1] != mask.shape[-1] or rv.dim() != 2 + depth \
                    or any(s != 1 for s in rv.shape[1:-1]):
                return None  # overlay-dependent: dense path
            rv = rv.reshape(rv.shape[0], rv.shape[-1])
            termvec = ops.sa_ext_term(SAd.reshape(E, -1, V), rv, val, w)
        else:
            termvec = ops.referrer_hist(val, w, V) @ SAd.reshape(-1, V).T
        termvec = termvec.reshape((self.B,) + tuple(env_shape))
        env_idx = [self.aligned(inv[a], depth) for a in env_args]
        bidx = torch.arange(self.B, device=self.cm.device).reshape(
            (self.B,) + (1,) * depth)
        return termvec[(bidx,) + tuple(
            e.long().clamp(0, env_shape[i] - 1) for i, e in enumerate(env_idx))]

    def _ext_gauss_term(self, kern, src: ClassID, ext_id: VertexID, inv,
                        depth: int, path=None):
        """Closed-form Gaussian external through per-segment sufficient
        statistics (propose.py:814-872), one K5 launch.

        A Gaussian external whose mean is an indexed-parameter lookup keyed
        by a table over (overlaid env axes..., one per-referrer categorical
        c) would otherwise build an [B, axes..., referrers] tensor. With
        (n_c, Sz_c, Szz_c) per referrer group of the swept slot (hoisted per
        segment by referrer_histograms, valid while the referrers are
        frozen) the whole external is
            -(Szz - 2 mu_c Sz_c + n_c mu_c^2) / (2 s^2) summed over c
        plus the mean-independent normalisation and Jacobian terms pre0.
        K5 gathers mu_c = value[tbl[env, c]] and reduces over c for every
        (row, option). None (dense path) unless the structure matches and
        the hoisted statistics are there."""
        pre = self.ext_hists.get((path, ext_id))
        if not (isinstance(pre, tuple) and pre[0] == "gauss"):
            return None
        _tag, n_g, sz_g, szz_g, pre0 = pre
        cm = self.cm
        mnode, knode = gauss_mean_lookup(cm, src, kern)
        env_args = [a for a in knode.arg_ids
                    if a in inv and inv[a] in self.env]
        ref_args = [a for a in knode.arg_ids if a not in env_args]
        if len(ref_args) != 1:
            return None
        order = tuple(knode.arg_ids.index(a) for a in env_args + ref_args)
        env_shape, tbl = gauss_key_table(cm, src, mnode.key_id, order)
        full = self._full(depth)
        # row-major position of the env tuple in tbl's leading axes
        idx = torch.zeros(full, dtype=torch.long, device=cm.device)
        for a, n in zip(env_args, env_shape):
            idx = idx * n + self.aligned(inv[a], depth).long().clamp(0, n - 1)
        pk = cm.canon(src, mnode.param_id)
        out = ops.gauss_ext_term(
            self.params[pk[0]][pk[1]]["value"], cm.use(tbl),
            idx.reshape(self.B, -1).to(torch.int32),
            self.row_slot.to(torch.int32), n_g, sz_g, szz_g, pre0,
            -0.5 * (1.0 / (kern.std * kern.std)))
        return out.reshape(full)

    def _ext_swap_term(self, kern, ext: ChoiceNode, src: ClassID,
                       ext_id: VertexID, inv, depth: int, ext_value, slots,
                       refs):
        """A MaybeSwap external whose `val` is this block's innermost
        enumerated value, one K6 launch (propose.py:683-701 and the masked
        referrer sum of :631-632): for every row b and option a,
            sum over referrers r of row b (`refs`: the full source axis
            masked by alive and the fk chain, or the row's compacted list) of
              st_r = 1: (obs_r == a) ? log1p(-p_r) : log p_r - log len_b
              st_r = 2: member[lc_b, a] ? 0 : -1000
        where options (the list lc_b, dynamic or static) and p_r (the
        referrer's prob: static, a Prob parameter, or a vertex such as the
        flights model's gated lookup, computed here by torch) carry no
        enumeration axis. None (dense path) otherwise."""
        from .kernels import _MaybeSwapK

        if not isinstance(kern, _MaybeSwapK) or depth == 0:
            return None
        tv = inv.get(ext.arg_ids.get("val"))
        if tv is None or self._enum_axis.get(tv) != depth \
                or self.axes[depth - 1] != kern.V:
            return None
        dev = self.cm.device
        B = self.B

        def rowwise(x):
            """x as [B or 1, last] when it carries no enumeration axis."""
            x = torch.as_tensor(x, device=dev)
            if x.dim() <= 1 + depth:
                x = x.reshape(tuple(x.shape) + (1,) * (2 + depth - x.dim()))
            if any(n != 1 for n in x.shape[1:-1]):
                return None
            return x.reshape(x.shape[0], x.shape[-1])

        if kern.dynamic_opts:
            ot = inv.get(ext.arg_ids["options"])
            if ot is None or ot not in self.env:
                return None
            lc = rowwise(self.aligned(ot, depth)[..., None])
            if lc is None:
                return None
            lc = lc[:, 0].expand(B)
            member, lens = self.cm.use(kern.mask), self.cm.use(kern.lens)
        else:
            lc = torch.zeros((B,), dtype=torch.int32, device=dev)
            member = self.cm.use(kern.mask)[None, :]
            lens = torch.full((1,), kern.n, dtype=torch.int32, device=dev)
        N = slots.shape[-1]
        if kern.prob_vid is not None:
            p = rowwise(ext_value(ext.arg_ids["prob"]))
            if p is None:
                return None
            p = p.expand(p.shape[0], N)
        else:
            p = kern._prob(_Ctx(self, depth)).reshape(1, 1).expand(1, N)
        obs, st = self._ext_obs(src, ext_id, slots)
        if st is None:
            st = torch.ones_like(obs, dtype=torch.int8)
        i32 = {k: v.to(torch.int32) if v.dtype != torch.bool else v
               for k, v in refs.items()}
        out = ops.maybe_swap_ext(
            obs.to(torch.int32).contiguous(), st.to(torch.int8).contiguous(),
            p.to(torch.float32).contiguous(), lc.to(torch.int32),
            lens.to(torch.int32), member, **i32)
        return out.reshape((B,) + (1,) * (depth - 1) + (kern.V,))

    def _ext_obs(self, src: ClassID, svid: VertexID, slots):
        """Observed (value, state) of a source-class vertex over `slots`,
        falling back to stored/derived row values
        (block_proposal.jl:139-152)."""
        oa = self.obs_arrays.get(src, {}).get(svid)
        if oa is not None:
            codes, state = oa
            c = take(codes, slots)
            s = take(state, slots)
            stored = self.row_value(src, svid, slots)
            return torch.where(s == 1, c, stored.to(c.dtype)), s
        return self.row_value(src, svid, slots), None

    # ------------------------------------------------------------- sampling

    def run(self, plan: Plan, gen: Optional[torch.Generator] = None,
            pool: Optional[torch.Tensor] = None):
        """Score then sample one block; returns (logZ [B], result). `pool`
        [B, n] injects the sample pass's uniforms (n = _draw_bound); without
        it they are drawn from `gen`."""
        self._root_plan = plan
        self._gen = gen
        self._mm_push()
        logZ = self._mm_flush(self.score_plan(plan, 0, {}, ()))
        assert not self._mm_frames, "unbalanced sibling-fusion frames"
        res = self.sample(pool)
        return logZ.expand(self.B), res

    def sample(self, pool=None) -> BlockResult:
        """Top-down pass: draw (or force) concrete values for every vertex
        of the block; returns env updates, extra weight and birth records."""
        n = _draw_bound(self.cm, self.cid, self._root_plan)
        if pool is None and n:
            pool = torch.rand((self.B, n), generator=self._gen,
                              device=self.cm.device)
        if pool is not None:
            pool = torch.as_tensor(pool, dtype=torch.float32,
                                   device=self.cm.device)
            assert pool.shape == (self.B, n), (pool.shape, (self.B, n))
        self._pool = pool
        self._pool_i = 0
        env2 = {v: val.reshape(self.B) for v, val in self.env0.items()}
        births: list[Birth] = []
        alive2 = {c: self.rel[c]["alive"] for c in self.cm.model.class_order}
        state = _SampleState(env2, births, alive2,
                             torch.zeros((self.B,), device=self.cm.device),
                             torch.ones((self.B,), dtype=torch.bool,
                                        device=self.cm.device))
        for step in self._root_plan.steps:
            self.sample_step(step, state, anc=(), mode={}, ctx_key=())
        return BlockResult(env2, state.extra_w, births)

    def _pick(self, rec, anc):
        """rec at each row's chosen ancestor positions: [B, ...rest]."""
        rec = rec.expand((self.B,) + tuple(rec.shape[1:]))
        if not anc:
            return rec
        bidx = torch.arange(self.B, device=self.cm.device)
        return rec[(bidx,) + tuple(a.long() for a in anc)]

    def _forced(self, vid: VertexID):
        """Retained value of a vertex: the stored row value, via fk chains."""
        return self.row_value(self.cid, vid, self.row_slot)

    def sample_step(self, step: Step, st: "_SampleState", anc: tuple,
                    mode: dict, ctx_key: tuple):
        vid = step.idx
        node = self.node(vid)
        if isinstance(node, (ParameterNode, ExternalLikelihoodNode)):
            return
        if isinstance(node, (ComputeNode, ParamLookupNode)):
            st.env2[vid] = self.compute_value(vid, node, lambda a: st.env2[a])
            for ch in step.rest.steps:
                self.sample_step(ch, st, anc, mode, ctx_key)
            return
        if isinstance(node, ForeignKeyNode):
            return self.sample_fk(step, vid, node, st, anc, mode, ctx_key)
        if isinstance(node, SubmodelNode):
            fmode = mode.get(node.fk_id)
            while fmode == "N" and isinstance(node.subnode, SubmodelNode):
                node = node.subnode
                fmode = mode.get(node.fk_id)
            if fmode == "N":
                sub = node.subnode
                if isinstance(sub, ForeignKeyNode):
                    return self.sample_fk(step, vid, sub, st, anc, mode, ctx_key)
                if isinstance(sub, (ComputeNode, ParamLookupNode)):
                    st.env2[vid] = self.compute_value(vid, sub,
                                                      lambda a: st.env2[a])
                    for ch in step.rest.steps:
                        self.sample_step(ch, st, anc, mode, ctx_key)
                    return
                assert isinstance(sub, ChoiceNode)
                return self.sample_choice(step, vid, sub, st, anc, mode, ctx_key)
            fknode = _fk(self.cm, self.cid, node.fk_id)
            st.env2[vid] = self.row_value(fknode.target_class, node.sub_id,
                                          st.env2[node.fk_id])
            for ch in step.rest.steps:
                self.sample_step(ch, st, anc, mode, ctx_key)
            return
        assert isinstance(node, ChoiceNode)
        return self.sample_choice(step, vid, node, st, anc, mode, ctx_key)

    def sample_choice(self, step: Step, vid: VertexID, node: ChoiceNode,
                      st: "_SampleState", anc: tuple, mode: dict,
                      ctx_key: tuple):
        kern = self.kernel(self.cid, vid)
        ov, state_flag = self.obs_of(vid)
        if _static_obs(state_flag) or not kern.enumerable:
            # observed everywhere, or a score-pass prior draw: reuse the
            # recorded value at the chosen ancestor branch
            tag = "so" if _static_obs(state_flag) else "ne"
            st.env2[vid] = self._pick(self.records[(tag, vid, ctx_key)], anc)
            for ch in step.rest.steps:
                self.sample_step(ch, st, anc, mode, ctx_key)
            return
        logits = self._pick(self.records[(vid, ctx_key)], anc)  # [B, V]
        if self.force_retained:
            rv = self._forced(vid).long()
            dummy = self.cm.dummy_code.get(self.cm.canon(self.cid, vid))
            if dummy is None:
                chosen = rv
            else:
                valid = bgather(logits, rv[:, None])[:, 0] > NINF / 2
                chosen = torch.where(valid, rv, torch.full_like(rv, dummy))
        else:
            chosen = ops.inv_cdf_sample(logits.contiguous(), self._unif())
        chosen = chosen.to(torch.int32)
        st.env2[vid] = chosen
        for ch in step.rest.steps:
            self.sample_step(ch, st, anc + (chosen,), mode, ctx_key)

    def sample_fk(self, step: Step, vid: VertexID, fknode: ForeignKeyNode,
                  st: "_SampleState", anc: tuple, mode: dict, ctx_key: tuple):
        tc = fknode.target_class
        cap = self.cm.layouts[tc].capacity
        comp = self.cand.get(tc)
        dev = self.cm.device
        logits = self._pick(self.records[(vid, ctx_key)], anc)  # [B, K+1]
        K = int(logits.shape[-1]) - 1
        retained_dead = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        if self.force_retained:
            rv = self._forced(vid).long()
            alive_rv = _rtake(self.rel[tc]["alive"], rv[:, None])[:, 0] & \
                (_rtake(self.rel[tc]["refcount"], rv[:, None])[:, 0] > 0)
            rpos = take(comp[1], rv).long() if comp is not None else rv
            chosen = torch.where(alive_rv, rpos, torch.full_like(rpos, K))
            retained_dead = ~alive_rv
        else:
            chosen = ops.inv_cdf_sample(logits.contiguous(),
                                        self._unif()).long()
        is_new = chosen == K
        # full-arena guard: with no free slot, fall back to the best-scoring
        # existing candidate instead of overwriting a live row
        a2 = st.alive2[tc]
        has_free = ~torch.all(a2, dim=-1)
        fallback = torch.argmax(logits[:, :K], dim=-1)
        chosen = torch.where(is_new & ~has_free, fallback, chosen)
        is_new = is_new & has_free
        effective_new = is_new & st.gate
        c_exist = torch.clamp(chosen, max=K - 1)  # compact POSITION
        c_exist_slot = torch.clamp(take(comp[0], c_exist), max=cap - 1) \
            if comp is not None else c_exist
        # fresh slot: first free slot of the row's working alive mask; a
        # retained-dead fk re-births in its old slot
        free = torch.argmin(a2.to(torch.int32), dim=-1).expand(self.B)
        slot = torch.where(retained_dead, rv, free) if self.force_retained \
            else free
        a2 = a2.expand(self.B, cap).clone()
        bidx = torch.arange(self.B, device=dev)
        a2[bidx, slot] = a2[bidx, slot] | effective_new
        st.alive2[tc] = a2
        final = torch.where(is_new, slot, c_exist_slot).to(torch.int32)
        st.env2[vid] = final

        # children: existing branch (copy mode at the chosen candidate),
        # then the fresh branch, and select per row
        env_keep = dict(st.env2)
        st.env2[vid] = c_exist_slot.to(torch.int32)
        for ch in step.rest.steps:
            self.sample_step(ch, st, anc + (c_exist,), {**mode, vid: "E"},
                             ctx_key + ((vid, "E"),))
        sub = self._subtree_vids(step)
        exist_vals = {w: st.env2[w] for w in sub if w in st.env2}
        for w in sub:
            if w in env_keep:
                st.env2[w] = env_keep[w]
            else:
                st.env2.pop(w, None)
        st.env2[vid] = final
        outer_gate = st.gate
        st.gate = st.gate & is_new
        st.fk_depth += 1
        for ch in step.rest.steps:
            self.sample_step(ch, st, anc, {**mode, vid: "N"},
                             ctx_key + ((vid, "N"),))
        st.fk_depth -= 1
        st.gate = outer_gate
        for w in sub:
            if w in exist_vals and w in st.env2:
                ev, nv = exist_vals[w], st.env2[w]
                st.env2[w] = torch.where(is_new, nv, ev.to(nv.dtype))
        st.env2[vid] = final

        raw = self.node(vid)
        vmap = raw.vmap if isinstance(raw, ForeignKeyNode) else \
            strip_subnodes(raw).vmap
        values = {}
        for tv, dt in self.cm.layouts[tc].store.items():
            sv = vmap.get(tv)
            if sv is not None and sv in st.env2:
                values[tv] = st.env2[sv]
        st.births.append(Birth(vid, tc, effective_new, slot.to(torch.int32),
                               values, depth=st.fk_depth))

    def _subtree_vids(self, step: Step) -> list[VertexID]:
        out = []

        def walk(p: Plan):
            for s in p.steps:
                out.append(s.idx)
                walk(s.rest)

        walk(step.rest)
        return out


def _draw_bound(cm: CompiledModel, cid: ClassID, plan: Plan) -> int:
    """Static upper bound on the inverse-CDF draws one block's sample pass
    can consume: every Choice/ForeignKey step may draw once, and a foreign
    key's subtree is walked through BOTH the existing and fresh branches.
    Sizes the per-block uniform pool, in the JAX package's order."""
    def walk_plan(p: Plan, mult: int) -> int:
        return sum(walk(s, mult) for s in p.steps)

    def walk(step: Step, mult: int) -> int:
        node = cm.node(cid, step.idx)
        if isinstance(node, (ParameterNode, ExternalLikelihoodNode)):
            return 0
        raw = strip_subnodes(node) if isinstance(node, SubmodelNode) else node
        n = 0 if isinstance(raw, (ComputeNode, ParamLookupNode)) else mult
        sub_mult = mult * 2 if isinstance(raw, ForeignKeyNode) else mult
        return n + walk_plan(step.rest, sub_mult)

    return walk_plan(plan, 1)


class _SampleState:
    def __init__(self, env2, births, alive2, extra_w, gate):
        self.env2 = env2
        self.births = births
        self.alive2 = alive2
        self.extra_w = extra_w
        self.gate = gate  # [B] conjunction of enclosing is_new flags
        self.fk_depth = 0  # nesting depth inside fresh-birth branches


def build_cand(cm: CompiledModel, rel: dict, kc: dict) -> dict:
    """{target class: (idx [Kc], inv [cap], nc)} compact candidate axes from
    the segment-entry snapshot: live slots first, ascending (stable sort),
    padded with `cap`; inv maps slot -> compact position (Kc if none)."""
    out = {}
    dev = cm.device
    for tc, Kc in kc.items():
        cap = cm.layouts[tc].capacity
        r = rel[tc]
        live = r["alive"] & (r["refcount"] > 0)
        order = torch.argsort((~live).to(torch.int32), stable=True)
        idx = order[:Kc]
        nc = torch.clamp(torch.sum(live.to(torch.int32)), max=Kc)
        ar = torch.arange(Kc, device=dev)
        idxm = torch.where(ar < nc, idx, torch.full_like(idx, cap))
        inv = torch.full((cap,), Kc, dtype=torch.int64, device=dev)
        ok = idxm < cap
        inv[idxm[ok]] = ar[ok]
        out[tc] = (idxm, inv, nc)
    return out


def precompute_sa_tables(cm: CompiledModel) -> None:
    """Build the composed-table AddTypos score tensors at compile time
    (SA[env..., ref?, o] = M[o, tbl[env..., ref?]]), mirroring
    _ext_hist_term's composed case: same cache key, same axis order."""
    from .kernels import _AddTyposK

    sa_cache = cm.__dict__.setdefault("_ext_sa_cache", {})
    for cid in cm.model.class_order:
        c = cm.cls(cid)

        def collect(step, cid=cid, c=c):
            node = cm.node(cid, step.idx)
            if isinstance(node, ExternalLikelihoodNode) and \
                    isinstance(node.ext_node, ChoiceNode):
                src = node.path[-1][0]
                kern = cm.kernels[cm.canon(src, node.ext_id)]
                word_sv = node.ext_node.arg_ids.get("word")
                inv = {sv for sv in c.incoming_references[node.path].values()}
                if isinstance(kern, _AddTyposK) and word_sv is not None \
                        and word_sv not in inv:
                    snode = cm.node(src, word_sv)
                    if isinstance(snode, ComputeNode) and snode.kind == "table":
                        env_args = [a for a in snode.arg_ids if a in inv]
                        ref_args = [a for a in snode.arg_ids if a not in inv]
                        tbl = cm.tables.get(cm.canon(src, word_sv))
                        if env_args and len(ref_args) <= 1 and tbl is not None \
                                and tbl.size * kern.V <= BlockTracer._SA_MAX_CELLS:
                            order = [snode.arg_ids.index(a)
                                     for a in env_args + ref_args]
                            ck = ("sa", cm.canon(src, word_sv),
                                  cm.canon(src, node.ext_id), tuple(order))
                            if ck not in sa_cache:
                                sa_cache[ck] = np.ascontiguousarray(
                                    np.asarray(kern.M).T[np.transpose(tbl, order)])
            for child in step.rest.steps:
                collect(child)

        for plan in c.plans:
            for step in plan.steps:
                collect(step)


def gauss_mean_lookup(cm: CompiledModel, src: ClassID, kern):
    """(ParamLookupNode, its key's table ComputeNode) of a Gaussian kernel
    of class src whose mean is an ungated lookup keyed by a table, the
    shape the closed-form external takes; None otherwise."""
    from .kernels import _GaussianK

    if not isinstance(kern, _GaussianK) or kern.mean_vid is None:
        return None
    mnode = cm.node(src, kern.mean_vid)
    if not isinstance(mnode, ParamLookupNode) or mnode.gate_id is not None:
        return None
    knode = cm.node(src, mnode.key_id)
    if not (isinstance(knode, ComputeNode) and knode.kind == "table"):
        return None
    return mnode, knode


def gauss_key_table(cm: CompiledModel, src: ClassID, key_vid: VertexID,
                    order: tuple):
    """(env_shape, tbl [E, C] int32): the key table of a Gaussian mean's
    ParamLookup with its axes put in `order` (env axes..., the referrer
    group axis) and the env axes flattened row-major, as K5 reads it;
    cached on the model."""
    ck = ("gauss_tbl", cm.canon(src, key_vid), order)
    tcache = cm.__dict__.setdefault("_gauss_tbl_cache", {})
    if ck not in tcache:
        t = np.transpose(cm.tables[cm.canon(src, key_vid)], order)
        tcache[ck] = (t.shape[:-1], np.ascontiguousarray(
            t.reshape(-1, t.shape[-1]), dtype=np.int32))
    return tcache[ck]


class _RowCtx:
    """Kernel ctx resolving every argument by row_value over `slots`."""

    def __init__(self, cm, arenas, params, cls, slots):
        self.cm, self.arenas, self.params = cm, arenas, params
        self.cls, self.slots = cls, slots

    def value(self, vid):
        return row_value(self.cm, self.arenas, self.params, self.cls, vid,
                         self.slots)

    def pstate(self, cid, vid):
        return self.params[cid][vid]


def gauss_stats_inputs(cm: CompiledModel, arenas: dict, params: dict,
                       rel: dict, obs_arrays: dict, cap: int, node, kern,
                       inv):
    """K4's arguments for the Gaussian external `node` of a class of
    capacity `cap` (propose.py:1300-1347): dict(t, rv, w, z, ld, const,
    cap, C) over every source row, with z = backward(value) and ld =
    log|deriv| from the model's Transformation callables; None where
    _ext_gauss_term cannot use the statistics."""
    src = node.path[-1][0]
    lookup = gauss_mean_lookup(cm, src, kern)
    if lookup is None:
        return None
    knode = lookup[1]
    ref_args = [a for a in knode.arg_ids if a not in inv]
    if len(ref_args) != 1:
        return None
    rdom = cm.domain(src, ref_args[0])
    oa = obs_arrays.get(src, {}).get(node.ext_id)
    if rdom is None or rdom.kind == FLOAT or oa is None:
        return None
    slots = torch.arange(cm.layouts[src].capacity, device=cm.device)
    codes, state = oa
    stored = row_value(cm, arenas, params, src, node.ext_id, slots)
    val = torch.where(state == 1, codes, stored.to(codes.dtype))
    w = rel[src]["alive"] & (state == 1)
    t = chase([arenas[c]["values"][f] for c, f in reversed(node.path)])
    rctx = _RowCtx(cm, arenas, params, src, slots)
    z = kern.backward(rctx, val.to(torch.float32))
    ld = kern._log_abs_deriv(rctx, z) + torch.zeros_like(z)
    rv = row_value(cm, arenas, params, src, ref_args[0], slots)
    const = -math.log(kern.std) - 0.5 * math.log(2.0 * math.pi)
    return dict(t=t.to(torch.int32), rv=rv.to(torch.int32), w=w, z=z, ld=ld,
                const=const, cap=cap, C=rdom.size)


def referrer_histograms(cm: CompiledModel, cid: ClassID, arenas: dict,
                        params: dict, rel: dict, obs_arrays: dict) -> dict:
    """{(path, ext_id): [cap, V] float32 or a ("gauss", ...) tuple}: the
    referrer-observation histograms behind every hoistable AddTypos
    external of class `cid`, and the Gaussian sufficient statistics behind
    every closed-form Gaussian external (gauss_stats_inputs), for all swept
    slots at once (loop-invariant during cid's own sweep: its referrers are
    frozen). Same size gate as the JAX package (cap * V <= 32M); above it
    the tracer builds per-row histograms instead."""
    from .kernels import _AddTyposK, _GaussianK

    out: dict = {}
    cap = cm.layouts[cid].capacity

    def collect(step):
        node = cm.node(cid, step.idx)
        if isinstance(node, ExternalLikelihoodNode):
            src = node.path[-1][0]
            ext = node.ext_node
            if isinstance(ext, ChoiceNode):
                kern = cm.kernels[cm.canon(src, node.ext_id)]
                word_sv = ext.arg_ids.get("word")
                vmap = cm.cls(cid).incoming_references[node.path]
                inv = {sv: tv for tv, sv in vmap.items()}
                key = (node.path, node.ext_id)
                if isinstance(kern, _GaussianK) and key not in out:
                    # per (swept slot, referrer group) sufficient statistics
                    # and the mean-independent presum, one K4 launch
                    g = gauss_stats_inputs(cm, arenas, params, rel,
                                           obs_arrays, cap, node, kern, inv)
                    if g is not None:
                        out[key] = ("gauss",) + ops.gauss_suffstats(**g)
                if isinstance(kern, _AddTyposK) and word_sv in inv \
                        and key not in out and cap * kern.V <= 32_000_000:
                    # the fk chain from each source row to the swept slot
                    # and the scatter-add, one K7 launch
                    hops = [arenas[hop_cid]["values"][hop_fk]
                            for (hop_cid, hop_fk) in reversed(node.path)]
                    Cs = cm.layouts[src].capacity
                    slots = torch.arange(Cs, device=cm.device)
                    oa = obs_arrays.get(src, {}).get(node.ext_id)
                    stored = row_value(cm, arenas, params, src, node.ext_id,
                                       slots)
                    if oa is not None:
                        codes, state = oa
                        val = torch.where(state == 1, codes,
                                          stored.to(codes.dtype))
                        w = rel[src]["alive"] & (state != 2)
                    else:
                        val, w = stored, rel[src]["alive"]
                    out[key] = ops.referrer_hist(val, w, kern.V, cap=cap,
                                                 hops=hops)
        for child in step.rest.steps:
            collect(child)

    for plan in cm.cls(cid).plans:
        for step in plan.steps:
            collect(step)
    return out


def row_value(cm: CompiledModel, arenas: dict, params: dict, cls: ClassID,
              vid: VertexID, slot):
    """Value of vertex `vid` of class `cls` at row(s) `slot` (any shape):
    gathers through submodel fk chains and recomputes deterministic nodes
    (dependency_tracking.jl:239-258 re-derived through the indirection)."""
    node = cm.node(cls, vid)
    slot = torch.as_tensor(slot, device=cm.device)
    if isinstance(node, SubmodelNode):
        fknode = cm.node(cls, node.fk_id)
        assert isinstance(fknode, ForeignKeyNode), \
            "row_value must start from a class whose fks are raw"
        t = take(arenas[cls]["values"][node.fk_id], slot)
        return row_value(cm, arenas, params, fknode.target_class,
                         node.sub_id, t)
    if isinstance(node, (ChoiceNode, ForeignKeyNode)):
        return take(arenas[cls]["values"][vid], slot)
    if isinstance(node, ComputeNode):
        if node.kind == "tensor":
            return node.fn(*[row_value(cm, arenas, params, cls, a, slot)
                             for a in node.arg_ids])
        tbl = cm.use(cm.tables[cm.canon(cls, vid)])
        return _tbl_get(tbl, [row_value(cm, arenas, params, cls, a, slot)
                              for a in node.arg_ids])
    if isinstance(node, ParamLookupNode):
        return _lookup(cm, params, cls, node, lambda a: row_value(
            cm, arenas, params, cls, a, slot))
    raise TypeError(type(node))


def _lookup(cm: CompiledModel, params: dict, cid: ClassID,
            node: ParamLookupNode, value_of):
    """param.value[key] of a ParamLookupNode of class cid, or its
    gate_value where the gate vertex's value is true (decoded through
    cm.truth_table: gate codes are vocabulary indices). Indices clamp like
    the JAX gathers."""
    pc, pv = cm.canon(cid, node.param_id)
    val = take(params[pc][pv]["value"], value_of(node.key_id))
    if node.gate_id is None:
        return val
    truth = cm.use(cm.truth_table(cid, node.gate_id))
    gate = take(truth, value_of(node.gate_id))
    return torch.where(gate, torch.tensor(node.gate_value, dtype=val.dtype,
                                          device=val.device), val)


def _fk(cm: CompiledModel, cid: ClassID, vid: VertexID) -> ForeignKeyNode:
    n = strip_subnodes(cm.node(cid, vid))
    assert isinstance(n, ForeignKeyNode)
    return n
