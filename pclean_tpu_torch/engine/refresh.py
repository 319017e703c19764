"""Relational state refresh: recompute-don't-track.

Counterpart of pclean_tpu/engine/refresh.py (refresh.py:74-483). The
reference maintains reference counts, row liveness and propagated
observations incrementally (PClean src/model/dependency_tracking.jl); here
the same invariants are recomputed as dense reductions over the arenas
(`refresh`) or carried by exact point deltas (`row_delta`,
`latent_row_delta` with `hop_move`, `batch_obs_delta`,
`batch_latent_delta`):

  * a latent row is alive iff its recomputed reference count is > 0 —
    classes are processed in reverse declaration order, so transitive GC
    falls out (dependency_tracking.jl:184-201);
  * Pitman-Yor bookkeeping (total references, live rows; trace.jl:24-44)
    falls out of the same counts;
  * observations implied by reference slots (dependency_tracking.jl:102-158)
    are re-propagated down slot chains with chained gathers + scatter-max.

rel[cid] = {'alive', 'refcount', 'total', 'nrows', 'prop': {vid: (code,
count)}}. Leaves are shared [cap] tensors, except after a per-row delta
(`dense=True`, the batched self-exclusion of mh_row_step) where the touched
leaves carry the batch axis first: [B, cap] and [B].

`obs_arrays` maps observed class -> {vid: (codes [N], state [N])} device
tensors (Engine.obs_dev).

`refresh`, `hop_histograms`, the batched deltas and `_cascade` scatter
through K14 (ops.rel_scatter, ops.rel_cascade) into buffers each call
owns (fresh zeros, or a copy of the leaf it updates), with JAX's
mode="drop" rule inside the kernel, so none of them waits for the card;
their plain versions run on the CPU. The one-row deltas (`_fk_delta`
with dense=False, `row_delta`, `latent_row_delta`, `hop_move`) are K10's
plain versions and keep utils' drop helpers.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import ops
from ..model.ir import ClassID, ForeignKeyNode, SubmodelNode, VertexID
from ..ops import scatter_side
from ..utils import scatter_add_drop, scatter_max_drop, take
from .compile import CompiledModel


def direct_references(cm: CompiledModel) -> dict[ClassID, list[tuple[ClassID, VertexID]]]:
    """target class -> [(source class, raw fk vertex in source)]."""
    out: dict[ClassID, list] = {cid: [] for cid in cm.model.class_order}
    for cid in cm.model.class_order:
        for vid in cm.layouts[cid].fk_vertices:
            node = cm.node(cid, vid)
            out[node.target_class].append((cid, vid))
    return out


def hop_chain(cm: CompiledModel, cid: ClassID, vid: VertexID):
    """For a submodel vertex, the chain of raw fk hops from `cid` down to the
    vertex's original class: ([(class, fk_vid), ...], (orig_class, orig_vid))."""
    node = cm.node(cid, vid)
    chain = []
    while isinstance(node, SubmodelNode):
        fk = cm.node(cid, node.fk_id)
        assert isinstance(fk, ForeignKeyNode)
        chain.append((cid, node.fk_id))
        cid, vid = fk.target_class, node.sub_id
        node = cm.node(cid, vid)
    return chain, (cid, vid)


def propagated_obs_specs(cm: CompiledModel):
    """[(source class, obs vertex, hop chain, (target class, target vid))]
    for every observed column that lands on a submodel vertex."""
    specs = []
    for spec in cm.obs_specs:
        for ov in spec.columns:
            node = cm.node(spec.class_id, ov)
            if isinstance(node, SubmodelNode):
                chain, (tc, tv) = hop_chain(cm, spec.class_id, ov)
                specs.append((spec.class_id, ov, chain, (tc, tv)))
    return specs


def _copy_rel(rel: dict) -> dict:
    return {c: {**v, "prop": dict(v["prop"])} for c, v in rel.items()}


def _at(leaf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """leaf[t] with clamping, per row when the leaf carries the batch axis
    ([B, cap] with t [B])."""
    if leaf.dim() == 2 and t.dim() == 1:
        idx = t.long().clamp(0, leaf.shape[1] - 1)
        return torch.gather(leaf, 1, idx[:, None])[:, 0]
    return take(leaf, t)


def _fk_delta(cm: CompiledModel, rel: dict, arenas: dict, cid: ClassID,
              slot, sign: int, m, dense: bool = False) -> None:
    """In place on the already-copied rel dict: ± row `slot` of class `cid`'s
    foreign-key reference counts, cascading aliveness flips down the fk
    chain (the reference's recursive birth/GC, dependency_tracking.jl:
    184-236). `m` gates on the row contributing at all.

    dense=False: `slot` is one row (0-dim) and each bump is a one-index
    scatter into the shared leaves. dense=True: `slot` is a batch [B] and
    every row gets its OWN copy of each touched leaf (the JAX package's
    vmapped one-hot form, with the batch axis written out): refcount and
    alive become [B, cap], total and nrows [B]."""

    def bump(tc, t, dd):
        r = rel[tc]
        cap = cm.layouts[tc].capacity
        inb = (t >= 0) & (t < cap)
        dd = torch.where(inb, dd, torch.zeros_like(dd))
        if dense:
            hit = torch.arange(cap, device=t.device)[None, :] == t[:, None]
            rc_t = _at(r["refcount"], t) + dd
            rc = r["refcount"] + dd[:, None] * hit.to(torch.int32)
            was = _at(r["alive"], t)
            now = rc_t > 0
            alive = torch.where(hit, now[:, None], r["alive"])
        else:
            rc = scatter_add_drop(r["refcount"], t.reshape(1), dd.reshape(1))
            was = _at(r["alive"], t)
            now = _at(rc, t) > 0
            idx = t.long().clamp(0, cap - 1)
            alive = r["alive"].clone()
            alive[idx] = torch.where(inb, now, alive[idx])
        flip = now.to(torch.int32) - was.to(torch.int32)
        rel[tc] = {**r,
                   "refcount": rc,
                   "alive": alive,
                   "total": r["total"] + dd,
                   "nrows": r["nrows"] + flip}
        for fkv2 in cm.layouts[tc].fk_vertices:
            t2 = take(arenas[tc]["values"][fkv2], t)
            bump(cm.node(tc, fkv2).target_class, t2, flip)

    d0 = int(sign) * m.to(torch.int32)
    for fkv in cm.layouts[cid].fk_vertices:
        t = take(arenas[cid]["values"][fkv], slot)
        bump(cm.node(cid, fkv).target_class, t, d0)


def _slot_tensor(cm, slot) -> torch.Tensor:
    """A slot tensor stays on its device; anything else goes to the
    model's."""
    if torch.is_tensor(slot):
        return slot.long()
    return torch.as_tensor(slot, device=cm.device).long()


def latent_row_delta(cm: CompiledModel, rel: dict, arenas: dict,
                     cid: ClassID, slot, sign: int,
                     dense: bool = False) -> dict:
    """rel ± latent row `slot`'s outgoing REFERENCE-COUNT contributions
    (refresh's exclude semantics for a latent class: only the row's
    targets' reference counts move; propagated observations are sourced
    from observed classes and stay)."""
    assert not cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slot = _slot_tensor(cm, slot)
    cap0 = cm.layouts[cid].capacity
    m = take(rel[cid]["alive"], slot) & (slot >= 0) & (slot < cap0)
    _fk_delta(cm, rel, arenas, cid, slot, sign, m, dense=dense)
    return rel


def hop_histograms(cm: CompiledModel, cid: ClassID, arenas: dict,
                   obs_arrays: dict):
    """Per propagated-obs chain hop leaving latent class `cid`: the
    ([cap_cid] count, [cap_cid] code) histogram of observed-source rows
    whose chain prefix lands on each cid row (loop-invariant during cid's
    own sweep). Returns [((fk_vid, suffix_chain, (tc, tv)), (gcnt, gcode)),
    ...]."""
    out = []
    cap = cm.layouts[cid].capacity
    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        for k, (hop_cid, fkv) in enumerate(chain):
            if hop_cid != cid:
                continue
            codes, state = obs_arrays[src][ov]
            gcnt = torch.zeros((cap,), dtype=torch.int32, device=cm.device)
            gcode = torch.zeros((cap,), dtype=codes.dtype, device=cm.device)
            ops.rel_scatter("prop", gcnt, gcode, [scatter_side(
                [arenas[hc]["values"][fv] for (hc, fv) in chain[:k]],
                alive=arenas[src]["alive"], state=state, code=codes)],
                cm.layouts[src].capacity)
            out.append(((fkv, chain[k + 1:], (tc, tv)), (gcnt, gcode)))
    return out


def hop_move(cm: CompiledModel, rel: dict, arenas: dict, cid: ClassID,
             slot, old_fks: dict, hop_hists) -> dict:
    """After latent row `slot`'s fk columns were (possibly) rewritten: move
    its whole referrer group's propagated observations from the old chain
    targets to the new ones with the per-segment hop_histograms (refresh.py:
    177-206). `old_fks` holds the pre-rewrite fk values; unchanged fks
    cancel exactly. Code removal relies on the same observed-equality
    agreement invariant as row_delta."""
    if not hop_hists:
        return rel
    rel = _copy_rel(rel)
    slot = _slot_tensor(cm, slot).reshape(1)
    for (fkv, suffix, (tc, tv)), (gcnt, gcode) in hop_hists:
        g = take(gcnt, slot)
        gc = take(gcode, slot)
        of = torch.as_tensor(old_fks[fkv], device=slot.device).reshape(1)
        nf = take(arenas[cid]["values"][fkv], slot)
        for (hc, fv) in suffix:
            of = take(arenas[hc]["values"][fv], of)
            nf = take(arenas[hc]["values"][fv], nf)
        code, cnt = rel[tc]["prop"][tv]
        zero = torch.zeros((), dtype=code.dtype, device=code.device)
        cnt = scatter_add_drop(cnt, of, -g)
        # code.at[of].set(where(cnt[of] > 0, code[of], 0)), mode="drop"
        inb = (of >= 0) & (of < code.shape[0])
        idx = of.long().clamp(0, code.shape[0] - 1)
        keep = torch.where(_at(cnt, of) > 0, _at(code, of), zero)
        code = code.clone()
        code[idx] = torch.where(inb, keep, code[idx])
        cnt = scatter_add_drop(cnt, nf, g)
        code = scatter_max_drop(code, nf, torch.where(g > 0, gc, zero))
        rel[tc]["prop"][tv] = (code, cnt)
    return rel


def row_delta(cm: CompiledModel, rel: dict, arenas: dict, obs_arrays: dict,
              cid: ClassID, slot, sign: int, dense: bool = False,
              props: bool = True) -> dict:
    """rel ± one observed-class row's outgoing relational contributions:
    the exact point delta of adding (sign=+1) or removing (sign=-1) row
    `slot` (the reference's incorporate_row!/unincorporate_row!,
    dependency_tracking.jl:26-41,71-84). From rel == refresh(arenas),
    row_delta(-1) == refresh(arenas, exclude_cid=cid, exclude_slot=slot).

    dense=True takes a batch of slots [B] and returns per-row leaves (see
    _fk_delta). props=False skips the propagated-observation updates; the
    batched MH step passes it because nothing it runs reads them (the
    tracer reads only the swept class's own `prop`, which its own delta
    never touches) — the JAX package gets the same saving from XLA
    dead-code elimination."""
    assert cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slot = _slot_tensor(cm, slot)
    cap0 = cm.layouts[cid].capacity
    # out-of-range slots are a no-op (refresh's arange != slot matches
    # nothing); without the gate the gather would clamp to the last row
    m = take(arenas[cid]["alive"], slot) & (slot >= 0) & (slot < cap0)
    _fk_delta(cm, rel, arenas, cid, slot, sign, m, dense=dense)
    if not props:
        return rel

    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        if src != cid:
            continue
        codes, state = obs_arrays[cid][ov]
        sm = m & (take(state, slot) == 1)
        t = slot
        for (hop_cid, fkv) in chain:
            t = take(arenas[hop_cid]["values"][fkv], t)
        code, cnt = rel[tc]["prop"][tv]
        dd = int(sign) * sm.to(torch.int32)
        cval = take(codes, slot).to(code.dtype)
        zero = torch.zeros((), dtype=code.dtype, device=code.device)
        if dense:
            cap_t = cm.layouts[tc].capacity
            inb = (t >= 0) & (t < cap_t)
            dd = torch.where(inb, dd, torch.zeros_like(dd))
            hit = torch.arange(cap_t, device=t.device)[None, :] == t[:, None]
            cnt2 = cnt + dd[:, None] * hit.to(torch.int32)
            cnt2_t = _at(cnt, t) + dd
            if sign > 0:
                code2 = torch.where(
                    hit, torch.maximum(code, torch.where(sm, cval, zero)[:, None]),
                    code)
            else:
                code2 = torch.where(hit & ~(cnt2_t > 0)[:, None], zero, code)
        else:
            cnt2 = scatter_add_drop(cnt, t.reshape(1), dd.reshape(1))
            if sign > 0:
                code2 = scatter_max_drop(code, t.reshape(1),
                                         torch.where(sm, cval, zero).reshape(1))
            else:
                keep = torch.where(_at(cnt2, t) > 0, _at(code, t), zero)
                idx = t.long().clamp(0, code.shape[0] - 1)
                inb = (t >= 0) & (t < code.shape[0])
                code2 = code.clone()
                code2[idx] = torch.where(inb, keep, code2[idx])
        rel[tc]["prop"][tv] = (code2, cnt2)
    return rel


def _cascade(cm: CompiledModel, rel: dict, arenas: dict, pend: dict) -> None:
    """Apply pending refcount deltas per latent class and cascade the
    aliveness flips down the fk graph (in place on the copied rel).

    `pend` maps latent class -> [cap] int32 refcount delta, a buffer the
    caller owns. Classes are processed in reverse declaration order: a
    class's fk targets are always earlier-declared, so every delta a class
    receives is accumulated before that class is visited — the batched
    twin of _fk_delta's recursion. One K14 cascade launch a class
    (ops.rel_cascade), in that order: its flips land in place in the
    pending deltas of its fk targets, which later launches read."""
    for tc in reversed(cm.model.class_order):
        d = pend.get(tc)
        if d is None or cm.layouts[tc].observed:
            continue  # refresh keeps observed-class refcounts at zero
        r = rel[tc]
        fks = [(arenas[tc]["values"][fkv2],
                _pend(cm, pend, cm.node(tc, fkv2).target_class))
               for fkv2 in cm.layouts[tc].fk_vertices]
        rc, alive, acc = ops.rel_cascade(d, r["refcount"], r["alive"], fks,
                                         cls=tc)
        rel[tc] = {**r,
                   "refcount": rc,
                   "alive": alive,
                   "total": r["total"] + acc[0],
                   "nrows": r["nrows"] + acc[1]}


def _pend(cm: CompiledModel, pend: dict, tc: ClassID) -> torch.Tensor:
    """tc's pending refcount delta, a zeroed buffer at first use."""
    if tc not in pend:
        pend[tc] = torch.zeros((cm.layouts[tc].capacity,), dtype=torch.int32,
                               device=cm.device)
    return pend[tc]


def _move(cnt, code, old: dict, new: dict, n: int, slots, src_len: int):
    """A propagated observation's batched move (JAX's cnt1 =
    cnt.at[old].add(-w_old); code1 = where(cnt1 > 0, code, 0); cnt2 =
    cnt1.at[new].add(w_new); code2 = code1.at[new].max(where(w_new > 0,
    code, 0))): two K14 launches around the where, which must see every
    subtract and precede every add. `old`, `new`: scatter_side keywords.
    Returns (code2, cnt2), new tensors."""
    cnt = cnt.clone()
    ops.rel_scatter("delta", cnt, None, [scatter_side(**old, sign=-1)], n,
                    slots, src_len=src_len)
    code = torch.where(cnt > 0, code,
                       torch.zeros((), dtype=code.dtype, device=code.device))
    ops.rel_scatter("delta", cnt, code, [scatter_side(**new, sign=1)], n,
                    slots, src_len=src_len)
    return code, cnt


def batch_obs_delta(cm: CompiledModel, rel: dict, old_arenas: dict,
                    arenas: dict, obs_arrays: dict, cid: ClassID,
                    slots) -> dict:
    """rel updated for the rewrite of observed-class rows `slots` from
    `old_arenas` to `arenas` (no other arena entries may differ): the
    batched twin of row_delta(-1 on old) + row_delta(+1 on new), O(B + caps)
    per step. Per-row weights are the old/new aliveness, so an unchanged row
    cancels exactly and a fresh row purely adds. Exact for refcounts,
    aliveness and counts; propagated codes rely on the observed-equality
    agreement invariant (cnt == 0 <=> code == 0). Each fk's old and new
    sides are one K14 launch into the target's pending delta; each
    propagated chain two (_move)."""
    assert cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slots = _slot_tensor(cm, slots)
    n, cap = int(slots.shape[0]), cm.layouts[cid].capacity
    old_a, new_a = old_arenas[cid]["alive"], arenas[cid]["alive"]
    pend: dict = {}
    for fkv in cm.layouts[cid].fk_vertices:
        tc = cm.node(cid, fkv).target_class
        ops.rel_scatter("delta", _pend(cm, pend, tc), None, [
            scatter_side([arenas[cid]["values"][fkv]], alive=new_a),
            scatter_side([old_arenas[cid]["values"][fkv]], alive=old_a,
                         sign=-1)], n, slots, src_len=cap)
    _cascade(cm, rel, arenas, pend)

    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        if src != cid:
            continue
        codes, state = obs_arrays[cid][ov]
        # agreement invariant: cnt == 0 <=> code == 0, so the global reset
        # only touches targets this batch emptied
        old_hops = [(old_arenas if hc == cid else arenas)[hc]["values"][fv]
                    for (hc, fv) in chain]
        new_hops = [arenas[hc]["values"][fv] for (hc, fv) in chain]
        code, cnt = rel[tc]["prop"][tv]
        rel[tc]["prop"][tv] = _move(
            cnt, code,
            dict(hops=old_hops, alive=old_a, state=state),
            dict(hops=new_hops, alive=new_a, state=state, code=codes),
            n, slots, cap)
    return rel


def batch_latent_delta(cm: CompiledModel, rel: dict, old_arenas: dict,
                       arenas: dict, cid: ClassID, slots, hop_hists) -> dict:
    """Batched twin of latent_row_delta + hop_move for latent-class rows
    whose fk columns were (possibly) rewritten: reference-count deltas with
    cascaded aliveness flips, plus the referrer groups' propagated
    observations moved from old to new chain targets via the per-segment
    hop_histograms, through K14 as batch_obs_delta."""
    assert not cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slots = _slot_tensor(cm, slots)
    n, cap = int(slots.shape[0]), cm.layouts[cid].capacity
    # a latent row's own rewrite never changes its own aliveness (driven by
    # referrers), so old/new weight are both its current liveness
    w = rel[cid]["alive"]
    pend: dict = {}
    for fkv in cm.layouts[cid].fk_vertices:
        tc = cm.node(cid, fkv).target_class
        ops.rel_scatter("delta", _pend(cm, pend, tc), None, [
            scatter_side([arenas[cid]["values"][fkv]], alive=w),
            scatter_side([old_arenas[cid]["values"][fkv]], alive=w,
                         sign=-1)], n, slots, src_len=cap)
    _cascade(cm, rel, arenas, pend)

    for (fkv, suffix, (tc, tv)), (gcnt, gcode) in hop_hists:
        tail = [arenas[hc]["values"][fv] for (hc, fv) in suffix]
        code, cnt = rel[tc]["prop"][tv]
        rel[tc]["prop"][tv] = _move(
            cnt, code,
            dict(hops=[old_arenas[cid]["values"][fkv]] + tail, weight=gcnt),
            dict(hops=[arenas[cid]["values"][fkv]] + tail, weight=gcnt,
                 code=gcode),
            n, slots, cap)
    return rel


def refresh(cm: CompiledModel, arenas: dict, obs_arrays: dict,
            exclude_cid: Optional[ClassID] = None,
            exclude_slot=None) -> dict:
    """Recompute relational state from the arenas (see module docstring).
    `exclude_slot` (with exclude_cid): an int, or an int64 [1] tensor on
    the model's device, which K14 reads on the card (so a captured row
    step can exclude its own row). Each direct reference's counts and each
    propagated chain are one K14 launch into buffers of this call."""
    rel: dict = {}
    drefs = direct_references(cm)
    dev = cm.device

    def live(cid):
        return rel[cid]["alive"] if cid in rel else arenas[cid]["alive"]

    excl = exclude_slot if exclude_cid is not None else None

    for cid in reversed(cm.model.class_order):
        lay = cm.layouts[cid]
        C = lay.capacity
        if lay.observed:
            alive = arenas[cid]["alive"]
            rel[cid] = {"alive": alive,
                        "refcount": torch.zeros((C,), dtype=torch.int32,
                                                device=dev),
                        "total": torch.zeros((), dtype=torch.int32,
                                             device=dev),
                        "nrows": torch.sum(alive.to(torch.int32)),
                        "prop": {}}
            continue
        refcount = torch.zeros((C,), dtype=torch.int32, device=dev)
        for (src, fkv) in drefs[cid]:
            ops.rel_scatter("refcount", refcount, None, [scatter_side(
                [arenas[src]["values"][fkv]], alive=live(src),
                exclude=src == exclude_cid)], cm.layouts[src].capacity,
                exclude=excl)
        alive = refcount > 0
        rel[cid] = {"alive": alive,
                    "refcount": refcount,
                    "total": torch.sum(refcount),
                    "nrows": torch.sum(alive.to(torch.int32)),
                    "prop": {}}

    # Propagated observations (multi-hop gathers, scatter into target
    # class): a target vertex reached by several chains accumulates them
    # all in its own buffers (the codes are >= 0, so the max over them is
    # JAX's maximum of the per-chain maxima)
    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        codes, state = obs_arrays[src][ov]
        cap_t = cm.layouts[tc].capacity
        prev = rel[tc]["prop"].get(tv)
        if prev is None:
            prev = (torch.zeros((cap_t,), dtype=codes.dtype, device=dev),
                    torch.zeros((cap_t,), dtype=torch.int32, device=dev))
        code, cnt = prev
        ops.rel_scatter("prop", cnt, code, [scatter_side(
            [arenas[hc]["values"][fv] for (hc, fv) in chain],
            alive=live(src), state=state, code=codes,
            exclude=src == exclude_cid)], cm.layouts[src].capacity,
            exclude=excl)
        rel[tc]["prop"][tv] = (code, cnt)
    return rel
