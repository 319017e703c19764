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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..model.ir import ClassID, ForeignKeyNode, SubmodelNode, VertexID
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
            mask = arenas[src]["alive"] & (state == 1)
            t = torch.arange(cm.layouts[src].capacity, device=cm.device)
            for (hc, fv) in chain[:k]:
                t = take(arenas[hc]["values"][fv], t)
            gcnt = scatter_add_drop(
                torch.zeros((cap,), dtype=torch.int32, device=cm.device), t,
                mask.to(torch.int32))
            gcode = scatter_max_drop(
                torch.zeros((cap,), dtype=codes.dtype, device=cm.device), t,
                torch.where(mask, codes, torch.zeros_like(codes)))
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
        of = torch.as_tensor(old_fks[fkv], device=cm.device).reshape(1)
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

    `pend` maps latent class -> [cap] int32 refcount delta. Classes are
    processed in reverse declaration order: a class's fk targets are always
    earlier-declared, so every delta a class receives is accumulated before
    that class is visited — the batched twin of _fk_delta's recursion."""
    for tc in reversed(cm.model.class_order):
        d = pend.get(tc)
        if d is None or cm.layouts[tc].observed:
            continue  # refresh keeps observed-class refcounts at zero
        r = rel[tc]
        rc = r["refcount"] + d
        alive = rc > 0
        flip = alive.to(torch.int32) - r["alive"].to(torch.int32)
        rel[tc] = {**r,
                   "refcount": rc,
                   "alive": alive,
                   "total": r["total"] + torch.sum(d),
                   "nrows": r["nrows"] + torch.sum(flip)}
        for fkv2 in cm.layouts[tc].fk_vertices:
            tc2 = cm.node(tc, fkv2).target_class
            t2 = arenas[tc]["values"][fkv2]
            zero = torch.zeros((cm.layouts[tc2].capacity,), dtype=torch.int32,
                               device=cm.device)
            d2 = scatter_add_drop(zero, t2, flip)
            pend[tc2] = pend.get(tc2, zero) + d2


def batch_obs_delta(cm: CompiledModel, rel: dict, old_arenas: dict,
                    arenas: dict, obs_arrays: dict, cid: ClassID,
                    slots) -> dict:
    """rel updated for the rewrite of observed-class rows `slots` from
    `old_arenas` to `arenas` (no other arena entries may differ): the
    batched twin of row_delta(-1 on old) + row_delta(+1 on new), O(B + caps)
    per step. Per-row weights are the old/new aliveness, so an unchanged row
    cancels exactly and a fresh row purely adds. Exact for refcounts,
    aliveness and counts; propagated codes rely on the observed-equality
    agreement invariant (cnt == 0 <=> code == 0)."""
    assert cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slots = _slot_tensor(cm, slots)
    w_old = take(old_arenas[cid]["alive"], slots)
    w_new = take(arenas[cid]["alive"], slots)
    pend: dict = {}
    for fkv in cm.layouts[cid].fk_vertices:
        tc = cm.node(cid, fkv).target_class
        cap_tc = cm.layouts[tc].capacity
        t_old = take(old_arenas[cid]["values"][fkv], slots)
        t_new = take(arenas[cid]["values"][fkv], slots)
        zero = torch.zeros((cap_tc,), dtype=torch.int32, device=cm.device)
        d = scatter_add_drop(zero, t_new, w_new.to(torch.int32))
        d = scatter_add_drop(d, t_old, -w_old.to(torch.int32))
        pend[tc] = pend.get(tc, zero) + d
    _cascade(cm, rel, arenas, pend)

    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        if src != cid:
            continue
        codes, state = obs_arrays[cid][ov]
        st = take(state, slots) == 1
        sm_old = (w_old & st).to(torch.int32)
        sm_new = (w_new & st).to(torch.int32)
        t_old, t_new = slots, slots
        for (hop_cid, fkv) in chain:
            src_o = old_arenas if hop_cid == cid else arenas
            t_old = take(src_o[hop_cid]["values"][fkv], t_old)
            t_new = take(arenas[hop_cid]["values"][fkv], t_new)
        code, cnt = rel[tc]["prop"][tv]
        cval = take(codes, slots).to(code.dtype)
        zero = torch.zeros((), dtype=code.dtype, device=code.device)
        cnt1 = scatter_add_drop(cnt, t_old, -sm_old)
        # agreement invariant: cnt == 0 <=> code == 0, so the global reset
        # only touches targets this batch emptied
        code1 = torch.where(cnt1 > 0, code, zero)
        cnt2 = scatter_add_drop(cnt1, t_new, sm_new)
        code2 = scatter_max_drop(code1, t_new,
                                 torch.where(sm_new > 0, cval, zero))
        rel[tc]["prop"][tv] = (code2, cnt2)
    return rel


def batch_latent_delta(cm: CompiledModel, rel: dict, old_arenas: dict,
                       arenas: dict, cid: ClassID, slots, hop_hists) -> dict:
    """Batched twin of latent_row_delta + hop_move for latent-class rows
    whose fk columns were (possibly) rewritten: reference-count deltas with
    cascaded aliveness flips, plus the referrer groups' propagated
    observations moved from old to new chain targets via the per-segment
    hop_histograms."""
    assert not cm.layouts[cid].observed
    rel = _copy_rel(rel)
    slots = _slot_tensor(cm, slots)
    # a latent row's own rewrite never changes its own aliveness (driven by
    # referrers), so old/new weight are both its current liveness
    w = take(rel[cid]["alive"], slots).to(torch.int32)
    pend: dict = {}
    for fkv in cm.layouts[cid].fk_vertices:
        tc = cm.node(cid, fkv).target_class
        cap_tc = cm.layouts[tc].capacity
        t_old = take(old_arenas[cid]["values"][fkv], slots)
        t_new = take(arenas[cid]["values"][fkv], slots)
        zero = torch.zeros((cap_tc,), dtype=torch.int32, device=cm.device)
        d = scatter_add_drop(zero, t_new, w)
        d = scatter_add_drop(d, t_old, -w)
        pend[tc] = pend.get(tc, zero) + d
    _cascade(cm, rel, arenas, pend)

    for (fkv, suffix, (tc, tv)), (gcnt, gcode) in hop_hists:
        g = take(gcnt, slots)
        gc = take(gcode, slots)
        of = take(old_arenas[cid]["values"][fkv], slots)
        nf = take(arenas[cid]["values"][fkv], slots)
        for (hc, fv) in suffix:
            of = take(arenas[hc]["values"][fv], of)
            nf = take(arenas[hc]["values"][fv], nf)
        code, cnt = rel[tc]["prop"][tv]
        zero = torch.zeros((), dtype=code.dtype, device=code.device)
        cnt1 = scatter_add_drop(cnt, of, -g)
        code1 = torch.where(cnt1 > 0, code, zero)
        cnt2 = scatter_add_drop(cnt1, nf, g)
        code2 = scatter_max_drop(code1, nf, torch.where(g > 0, gc, zero))
        rel[tc]["prop"][tv] = (code2, cnt2)
    return rel


def refresh(cm: CompiledModel, arenas: dict, obs_arrays: dict,
            exclude_cid: Optional[ClassID] = None,
            exclude_slot=None) -> dict:
    """Recompute relational state from the arenas (see module docstring)."""
    rel: dict = {}
    drefs = direct_references(cm)
    dev = cm.device

    def live_mask(cid):
        alive = rel[cid]["alive"] if cid in rel else arenas[cid]["alive"]
        if exclude_cid == cid and exclude_slot is not None:
            alive = alive & (torch.arange(alive.shape[0], device=dev)
                             != exclude_slot)
        return alive

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
            src_alive = live_mask(src)
            fk_col = arenas[src]["values"][fkv]
            refcount = scatter_add_drop(refcount, fk_col,
                                        src_alive.to(torch.int32))
        alive = refcount > 0
        rel[cid] = {"alive": alive,
                    "refcount": refcount,
                    "total": torch.sum(refcount),
                    "nrows": torch.sum(alive.to(torch.int32)),
                    "prop": {}}

    # Propagated observations (multi-hop gathers, scatter into target class).
    for (src, ov, chain, (tc, tv)) in propagated_obs_specs(cm):
        codes, state = obs_arrays[src][ov]
        mask = live_mask(src) & (state == 1)
        target = torch.arange(cm.layouts[src].capacity, device=dev)
        for (hop_cid, fkv) in chain:
            target = take(arenas[hop_cid]["values"][fkv], target)
        cap_t = cm.layouts[tc].capacity
        cnt = scatter_add_drop(torch.zeros((cap_t,), dtype=torch.int32,
                                           device=dev),
                               target, mask.to(torch.int32))
        code = scatter_max_drop(torch.zeros((cap_t,), dtype=codes.dtype,
                                            device=dev),
                                target, torch.where(mask, codes,
                                                    torch.zeros_like(codes)))
        prev = rel[tc]["prop"].get(tv)
        if prev is not None:
            code = torch.maximum(code, prev[0])
            cnt = cnt + prev[1]
        rel[tc]["prop"][tv] = (code, cnt)
    return rel
