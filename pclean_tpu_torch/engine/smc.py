"""Inference driver: SMC initialization + MH blocked-Gibbs sweeps.

Counterpart of pclean_tpu/engine/smc.py (smc.py:44-405 and the Engine
drivers of its MH paths), itself the counterpart of the reference's
inference.jl / row_inference.jl. With batch_rows > 1 (the batched path):

  * `Engine.initialize` streams the dataset rows in: a sequential ramp
    (`scan_init`), then B-row batches proposed against a frozen relational
    snapshot (`scan_init_batched`); rows that would birth latent entities
    are deferred, allocated in batches (`replay_rows_alloc` /
    `_alloc_births`) and, for chained or overflowing births, replayed one
    by one (`replay_rows`);
  * `Engine.sweep` rejuvenates every class in declaration order with the
    Metropolis-within-Gibbs rule, B rows at a time
    (`_sweep_batched_segmented` -> `scan_sweep_class_batched` ->
    `mh_row_step`), with parameter + Pitman-Yor resampling interleaved
    (`resample_all`).

With batch_rows = 1 (the reference-exact sequential path, smc.py:1023-1083
and 1332-1447): `initialize` runs `scan_init` over every row, and `sweep`
runs `scan_sweep_class` (`_sweep_segment`) for each class in declaration
order, one row slot at a time, with `resample_all` every rejuv_frequency
slots. The JAX package's `scan_sweep_all` fuses those per-class segments
into one XLA dispatch with the same semantics; eager torch has no dispatch
to save, so it has no twin here.

JAX's `vmap` over rows becomes the explicit batch axis of the BlockTracer,
and its `lax.scan` bodies become Python loops over batches or rows. The
particle-Gibbs drivers and sharding are not ported yet: `sweep` and
`initialize` raise for configs that need them. Randomness comes from one
torch.Generator per call (`key`), so runs are reproducible per seed but do
not reproduce the JAX package's key streams.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..model.ir import ClassID
from ..utils import (index_set_drop, resolve_device, scatter_add_drop, take)
from .compile import CompiledModel
from .gibbs_params import resample_all
from .propose import BlockTracer, _rtake, build_cand, referrer_histograms
from .refresh import (batch_latent_delta, batch_obs_delta, hop_histograms,
                      hop_move, latent_row_delta, refresh, row_delta)


@dataclass
class InferenceConfig:
    """reference infer_config.jl:1-16, plus the batching knobs of
    pclean_tpu.engine.smc.InferenceConfig that the batched MH path reads
    (same names and defaults; see there for each knob's rationale). The
    JAX package's other knobs select paths the port does not have: it
    always self-excludes rows from the batch snapshot, carries the
    relational state by point deltas, and allocates births in batches."""

    num_iters: int = 1
    num_particles: int = 2
    use_mh_instead_of_pg: bool = True
    rejuv_frequency: int = 50
    reporting_frequency: int = 100
    batch_rows: int = 1
    scan_segment: int = 512  # sequential ramp segment (scan_init)
    batch_segment_rows: int = 16384
    exact_gibbs_accept: bool = True


def _obs_device(cm: CompiledModel):
    """{observed class: {vid: (codes [N], state [N])}} device tensors."""
    out = {}
    for spec in cm.obs_specs:
        out[spec.class_id] = {vid: (cm.use(codes), cm.use(state))
                              for vid, (codes, state) in spec.columns.items()}
    return out


def _slots(cm, s) -> torch.Tensor:
    return torch.as_tensor(s, device=cm.device).long().reshape(-1)


def apply_row(cm: CompiledModel, cid: ClassID, arenas: dict, slot, env2: dict,
              births, accept, mark_alive: bool) -> dict:
    """Write one accepted proposal (values [1]) into the arenas (masked
    scatters; row_inference.jl:169-185). Births of deeper classes are
    applied in list order, as sampled."""
    slot = _slots(cm, slot)
    accept = torch.as_tensor(accept, device=cm.device).reshape(-1)
    lay = cm.layouts[cid]
    vals = dict(arenas[cid]["values"])
    for vid in lay.store:
        if vid not in env2:
            continue
        cur = vals[vid]
        new = env2[vid].reshape(-1).to(cur.dtype)
        vals[vid] = index_set_drop(cur, slot,
                                   torch.where(accept, new, take(cur, slot)))
    alive = arenas[cid]["alive"]
    if mark_alive:
        alive = index_set_drop(alive, slot, True)
    out = dict(arenas)
    out[cid] = {"values": vals, "alive": alive}
    for b in births:
        bvals = dict(out[b.target_class]["values"])
        ok = accept & b.is_new.reshape(-1)
        bslot = b.slot.reshape(-1)
        for tv, val in b.values.items():
            if tv not in bvals:
                continue
            cur = bvals[tv]
            nv = val.reshape(-1).to(cur.dtype)
            bvals[tv] = index_set_drop(cur, bslot,
                                       torch.where(ok, nv, take(cur, bslot)))
        out[b.target_class] = {"values": bvals,
                               "alive": out[b.target_class]["alive"]}
    return out


def _apply_batch(cm: CompiledModel, cid: ClassID, arenas: dict, slots,
                 env2: dict, ok, mark_alive: bool) -> dict:
    """Scatter a batch of accepted row proposals (env2 values [B]); `ok`
    masks rows deferred to replay. Out-of-range slots drop."""
    slots = _slots(cm, slots)
    lay = cm.layouts[cid]
    vals = dict(arenas[cid]["values"])
    for vid in lay.store:
        if vid not in env2:
            continue
        cur = vals[vid]
        new = env2[vid].to(cur.dtype)
        vals[vid] = index_set_drop(cur, slots,
                                   torch.where(ok, new, take(cur, slots)))
    alive = arenas[cid]["alive"]
    if mark_alive:
        alive = index_set_drop(alive, slots, ok | take(alive, slots))
    out = dict(arenas)
    out[cid] = {"values": vals, "alive": alive}
    return out


def _birthy(births, B, device):
    out = torch.zeros((B,), dtype=torch.bool, device=device)
    for b in births:
        out = out | b.is_new
    return out


def mh_row_step(eng, cid: ClassID, arenas: dict, rel: dict, params: dict,
                slots, gen, valid, ext_hists=None, ref_comp=None, cand=None,
                pools=None):
    """A batch of rows' MH rejuvenation decisions against a frozen
    relational snapshot (smc.py:230-278): each row is excluded from its own
    copy of the snapshot by an exact point delta (the batch axis written
    out: per-row leaves), then proposed fresh; accepted by the MH rule
    (exact-Gibbs models accept every live row).

    Returns (env_p, accept & ~birthy, birthy & alive & valid)."""
    cm = eng.cm
    slots = _slots(cm, slots)
    B = int(slots.shape[0])
    if cm.layouts[cid].observed:
        rel = row_delta(cm, rel, arenas, eng.obs_dev, cid, slots, -1,
                        dense=True, props=False)
    elif cm.layouts[cid].fk_vertices:
        rel = latent_row_delta(cm, rel, arenas, cid, slots, -1, dense=True)
    env_p, births, w_p = eng._propose(cid, arenas, rel, params, slots, gen,
                                      False, ext_hists=ext_hists,
                                      ref_comp=ref_comp, cand=cand,
                                      pools=pools)
    if cm.layouts[cid].observed:
        alive = take(arenas[cid]["alive"], slots)
    else:
        alive = _rtake(rel[cid]["alive"], slots[:, None])[:, 0]
    alive = alive & valid
    birthy = _birthy(births, B, cm.device)
    if eng.exact_accept:
        accept = alive
    else:
        _er, _br, w_r = eng._propose(cid, arenas, rel, params, slots, gen,
                                     True, ext_hists=ext_hists,
                                     ref_comp=ref_comp, cand=cand)
        u = torch.rand((B,), generator=gen, device=cm.device)
        accept = (torch.log(u) < (w_p - w_r)) & alive
    return env_p, accept & ~birthy, birthy & alive


def init_row_step(eng, cid: ClassID, arenas: dict, rel: dict, params: dict,
                  slots, gen, valid, ext_hists=None, cand=None, pools=None):
    """A batch of fresh rows' SMC-init proposals against a frozen snapshot;
    rows that would birth latent entities are deferred (flagged).

    Returns (env2, ok, birthy, w)."""
    env2, births, w = eng._propose(cid, arenas, rel, params, slots, gen,
                                   False, cand=cand, pools=pools)
    birthy = _birthy(births, int(valid.shape[0]), eng.cm.device) & valid
    return env2, valid & ~birthy, birthy, w


def init_row_step_alloc(eng, cid: ClassID, arenas: dict, rel: dict,
                        params: dict, slots, gen, valid, statics: list,
                        cand=None, pools=None):
    """init_row_step for the in-batch birth allocator: also returns the
    births so _alloc_births can place depth-0 ones; `statics` receives the
    static (fk_vid, target_class, depth) of each birth site.

    Returns (env2, birthy, chained, births, w)."""
    env2, births, w = eng._propose(cid, arenas, rel, params, slots, gen,
                                   False, cand=cand, pools=pools)
    if not statics:
        statics.extend((b.fk_vid, b.target_class, b.depth) for b in births)
    B = int(valid.shape[0])
    birthy = torch.zeros((B,), dtype=torch.bool, device=eng.cm.device)
    chained = torch.zeros_like(birthy)
    for b in births:
        birthy = birthy | b.is_new
        if b.depth > 0:
            # this row's fresh rows reference each other's placeholder
            # slots, so it must replay sequentially
            chained = chained | b.is_new
    traced = [{"is_new": b.is_new, "values": b.values} for b in births]
    return env2, birthy & valid, chained & valid, traced, w


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _alloc_births(cm: CompiledModel, arenas: dict, rel: dict, env2: dict,
                  births: list, statics: list, alloc_rows):
    """In-batch allocation of depth-0 fresh births (smc.py:328-405), bit for
    bit: rows are grouped by the same double 32-bit FNV-style hash of the
    birth's sampled values, sorted (stably) on h1 >> 1 with non-birth rows
    last, group leaders take free slots dead-first, member rows' fk values
    are rewritten to the leader slot and leader values are scattered into
    the target arenas. Like the reference it sorts on h1 >> 1 alone, so an
    equal-(h1, h2) group can be split. Rows whose group overflows the free
    pool are returned for sequential replay.

    Returns (arenas, env2, overflow[B])."""
    B = int(alloc_rows.shape[0])
    dev = cm.device
    out = dict(arenas)
    env2 = dict(env2)
    overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    alive_work: dict = {}
    ar = torch.arange(B, device=dev)
    for (fk_vid, tc, depth), d in zip(statics, births):
        if depth > 0:
            continue
        lay = cm.layouts[tc]
        cap = lay.capacity
        if tc not in alive_work:
            alive_work[tc] = rel[tc]["alive"]
        m = d["is_new"] & alloc_rows
        h1 = torch.full((B,), 2166136261, dtype=torch.int64, device=dev)
        h2 = torch.full((B,), 0x9E3779B9, dtype=torch.int64, device=dev)
        for tv in sorted(d["values"]):
            v = d["values"][tv]
            if v.is_floating_point():
                iv = v.to(torch.float32).view(torch.int32).to(torch.int64) \
                    & _M32
            else:
                iv = v.to(torch.int64) & _M32
            h1 = _mul32(h1 ^ iv, 16777619)
            h2 = _mul32(((h2 + iv) & _M32) ^ (h2 >> 13), 0x85EBCA6B)
        key1 = torch.where(m, h1 >> 1, (1 << 31) | ar)
        order = torch.argsort(key1, stable=True)
        k1s, k2s, ms = key1[order], h2[order], m[order]
        newgrp = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])])
        grank = torch.cumsum(newgrp.to(torch.int64), 0) - 1
        free_order = torch.argsort(alive_work[tc].to(torch.int32), stable=True)
        nfree = torch.sum((~alive_work[tc]).to(torch.int64))
        ok_grp = (grank < nfree) & ms
        slot_sorted = free_order[torch.clamp(grank, max=cap - 1)]
        slot_row = torch.empty_like(slot_sorted)
        slot_row[order] = slot_sorted
        ok_row = torch.empty_like(ok_grp)
        ok_row[order] = ok_grp
        leader_row = torch.empty_like(ok_grp)
        leader_row[order] = newgrp & ok_grp
        overflow = overflow | (m & ~ok_row)
        wslot = torch.where(leader_row, slot_row, torch.full_like(slot_row, cap))
        vals = dict(out[tc]["values"])
        for tv in lay.store:
            if tv not in d["values"]:
                continue
            cur = vals[tv]
            vals[tv] = index_set_drop(cur, wslot, d["values"][tv].to(cur.dtype))
        out[tc] = {"values": vals, "alive": out[tc]["alive"]}
        if fk_vid in env2:
            env2[fk_vid] = torch.where(m & ok_row, slot_row.to(torch.int32),
                                       env2[fk_vid].to(torch.int32))
        # consume the slots so later sites (and the free list) don't reuse
        alive_work[tc] = index_set_drop(alive_work[tc], wslot, True)
    return out, env2, overflow


class Engine:
    def __init__(self, cm: CompiledModel, config: InferenceConfig,
                 device="cuda"):
        dev = resolve_device(device)
        if dev != cm.device:
            raise ValueError(f"Engine on {dev} for a model compiled for "
                             f"{cm.device}")
        self.cm = cm
        self.config = config
        self.device = dev
        self.obs_dev = _obs_device(cm)
        self._static_obs = {
            spec.class_id: {vid: bool(np.all(state == 1))
                            for vid, (_c, state) in spec.columns.items()}
            for spec in cm.obs_specs}
        self._kc_state = None  # [kc dict, replayed births since fetch]
        # exact-Gibbs acceptance only when the compile-time audit passes
        self.exact_accept = config.exact_gibbs_accept and \
            getattr(cm, "exact_gibbs_ok", True)
        # wall seconds per phase of the last initialize() (by class) and
        # sweep ("sweep:<class>")
        self.phase_times: dict = {}

    def _gen(self, key) -> torch.Generator:
        if isinstance(key, torch.Generator):
            return key
        g = torch.Generator(device=self.device)
        g.manual_seed(int(key))
        return g

    def _check_supported(self):
        cfg = self.config
        if not cfg.use_mh_instead_of_pg and cfg.num_particles > 1:
            raise NotImplementedError(
                "particle Gibbs is not ported yet (use_mh_instead_of_pg)")
        if not self.exact_accept and cfg.num_particles > 1:
            raise NotImplementedError(
                "two-particle MH init for models failing the exact-Gibbs "
                "audit is not ported yet")

    def arena_occupancy(self, arenas) -> dict:
        """{latent class: (live rows, capacity)}."""
        rel = refresh(self.cm, arenas, self.obs_dev)
        return {c: (int(rel[c]["alive"].sum()), self.cm.layouts[c].capacity)
                for c in self.cm.model.class_order
                if not self.cm.layouts[c].observed}

    def _check_arena_pressure(self, arenas):
        """Warn when a latent arena is (nearly) full: sample_fk then
        redirects fresh-entity proposals to the best existing candidate."""
        for c, (n, cap) in self.arena_occupancy(arenas).items():
            if n >= cap:
                warnings.warn(
                    f"pclean_tpu_torch: latent arena for class '{c}' is FULL "
                    f"({n}/{cap}): fresh-entity proposals are being "
                    "redirected to the best existing candidate.",
                    RuntimeWarning, stacklevel=3)
            elif n >= 0.9 * cap:
                warnings.warn(
                    f"pclean_tpu_torch: latent arena for class '{c}' is at "
                    f"{n}/{cap} (>90%); consider a larger capacity.",
                    RuntimeWarning, stacklevel=3)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ext_hists(self, cid, arenas, params, rel=None):
        """Loop-invariant referrer histograms for class cid's sweep."""
        if rel is None:
            rel = refresh(self.cm, arenas, self.obs_dev)
        return referrer_histograms(self.cm, cid, arenas, params, rel,
                                   self.obs_dev)

    def _ref_comp(self, cid, arenas, rel):
        """{path: (idx [cap, R], cnt [cap])}: per-slot referrer index lists
        for class cid's hash-key-bounded referring paths
        (compile._referrer_bounds); unused entries hold the source
        capacity."""
        cm = self.cm
        out = {}
        dev = cm.device
        for path, R in getattr(cm, "ref_bounds", {}).items():
            src, fkv = path[0]
            node = cm.node(src, fkv)
            if getattr(node, "target_class", None) != cid:
                continue
            cap = cm.layouts[cid].capacity
            Cs = cm.layouts[src].capacity
            t = arenas[src]["values"][fkv].long()
            alive = rel[src]["alive"]
            tm = torch.where(alive, t, torch.full_like(t, cap))
            order = torch.argsort(tm, stable=True)
            st_ = tm[order]
            newgrp = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                                st_[1:] != st_[:-1]])
            ar = torch.arange(Cs, device=dev)
            gstart = torch.where(newgrp, ar, torch.zeros_like(ar))
            start = torch.cummax(gstart, 0).values
            rank = ar - start
            idx = torch.full((cap, R), Cs, dtype=torch.int64, device=dev)
            ok = (st_ < cap) & (rank < R)
            idx[st_[ok], rank[ok]] = order[ok]
            cnt = scatter_add_drop(
                torch.zeros((cap,), dtype=torch.int32, device=dev), tm,
                alive.to(torch.int32))
            out[path] = (idx, cnt)
        return out

    def _kc(self, arenas) -> dict:
        """{latent class: Kc} for candidate-axis compaction this segment:
        live counts rounded up to a multiple of 64 with +32 headroom, kept
        until enough births were replayed to threaten the headroom (the live
        set only shrinks within a segment). Classes whose compact axis
        would not shrink meaningfully (Kc >= cap/2) or are tiny (cap < 256)
        keep the full axis."""
        st = self._kc_state
        if st is not None and st[1] <= 24:
            return st[0]
        latents = [c for c in self.cm.model.class_order
                   if not self.cm.layouts[c].observed]
        out = {}
        if latents:
            rel = refresh(self.cm, arenas, self.obs_dev)
            lives = torch.stack([rel[c]["alive"].to(torch.int32).sum()
                                 for c in latents]).cpu().numpy()
            for c, live in zip(latents, lives):
                cap = self.cm.layouts[c].capacity
                if cap < 256:
                    continue
                Kc = ((int(live) + 32 + 63) // 64) * 64
                if Kc < cap // 2:
                    out[c] = Kc
        self._kc_state = [out, 0]
        return out

    def _kc_note(self, n_births: int) -> None:
        if self._kc_state is not None:
            self._kc_state[1] += int(n_births)

    def _leaf_latent(self, cid) -> bool:
        """Latent class with no outgoing fks: its relational snapshot is
        loop-invariant during its own sweep."""
        lay = self.cm.layouts[cid]
        return not lay.observed and not lay.fk_vertices

    # ------------------------------------------------------------ row steps

    def _obs_row_slices(self, cid: ClassID, slots, rel):
        """The rows' observations: dataset columns for observed classes (a
        column observed in every row gets the static state 1), propagated
        observations for latent ones (trace.jl:33-37)."""
        out = {}
        cols = self.obs_dev.get(cid)
        if cols is not None:
            for vid, (codes, state) in cols.items():
                st = 1 if self._static_obs[cid][vid] else take(state, slots)
                out[vid] = (take(codes, slots), st)
        for vid, (code, cnt) in rel[cid]["prop"].items():
            out[vid] = (take(code, slots), (take(cnt, slots) > 0)
                        .to(torch.int8))
        return out

    def _propose(self, cid, arenas, rel, params, slots, gen, force_retained,
                 ext_hists=None, ref_comp=None, cand=None, pools=None):
        """Every block of class cid for the rows `slots` [B]: returns
        (env2 {vid: [B]}, births, w [B]). `pools`: optional per-block
        injected uniform pools [B, n_block]."""
        cm = self.cm
        c = cm.cls(cid)
        slots = _slots(cm, slots)
        obs_row = self._obs_row_slices(cid, slots, rel)
        env2: dict = {}
        births = []
        w = torch.zeros((slots.shape[0],), device=cm.device)
        for i, plan in enumerate(c.plans):
            tr = BlockTracer(cm, cid, arenas, rel, params, self.obs_dev,
                             obs_row, env2, slots,
                             force_retained=force_retained,
                             ext_hists=ext_hists, ref_comp=ref_comp,
                             cand=cand)
            logZ, res = tr.run(plan, gen,
                               pool=None if pools is None else pools[i])
            env2 = res.env
            births.extend(res.births)
            w = w + logZ + res.weight
        return env2, births, w

    # ------------------------------------------------ sequential replay

    def _replay_chunk(self, cid: ClassID, arenas, params, idx, gen,
                      rejuv: bool):
        """Incorporate the rows `idx` one at a time (smc.py:817-917): each
        row proposes against the relational state carried by exact point
        deltas (observed classes) or a fresh exclude-refresh (latent
        classes)."""
        cm = self.cm
        # observed classes carry rel by exact point deltas; latent-class
        # replays are rare and recompute with the row excluded
        incr = cm.layouts[cid].observed
        rel = refresh(cm, arenas, self.obs_dev) if incr else None
        for s in idx:
            s = int(s)
            if rejuv:
                relx = row_delta(cm, rel, arenas, self.obs_dev, cid, s, -1) \
                    if incr else refresh(cm, arenas, self.obs_dev,
                                         exclude_cid=cid, exclude_slot=s)
                st = torch.tensor([s], device=cm.device)
                alive = take(arenas[cid]["alive"], st) \
                    if cm.layouts[cid].observed else take(relx[cid]["alive"],
                                                          st)
                env_p, births_p, w_p = self._propose(cid, arenas, relx,
                                                     params, st, gen, False)
                if self.exact_accept:
                    accept = alive
                else:
                    _e, _b, w_r = self._propose(cid, arenas, relx, params,
                                                st, gen, True)
                    u = torch.rand((1,), generator=gen, device=cm.device)
                    accept = (torch.log(u) < (w_p - w_r)) & alive
                arenas = apply_row(cm, cid, arenas, s, env_p, births_p,
                                   accept=accept, mark_alive=False)
                if incr:
                    rel = row_delta(cm, relx, arenas, self.obs_dev, cid, s, +1)
            else:
                relx = rel if incr else refresh(cm, arenas, self.obs_dev)
                env2, births, _w = self._propose(cid, arenas, relx, params,
                                                 [s], gen, False)
                arenas = apply_row(cm, cid, arenas, s, env2, births,
                                   accept=True, mark_alive=True)
                if incr:
                    rel = row_delta(cm, relx, arenas, self.obs_dev, cid, s, +1)
        return arenas

    def replay_rows(self, cid: ClassID, arenas, params, idx, gen,
                    rejuv: bool):
        """Sequentially replay the flagged (entity-birthing) rows."""
        if len(idx) == 0:
            return arenas
        return self._replay_chunk(cid, arenas, params, idx, gen, rejuv)

    def _replay_alloc_step(self, cid: ClassID, arenas, params, slots, gen):
        """ONE batched init pass over deferred rows with in-batch birth
        allocation (smc.py:919-958): full candidate axis over the entry
        refresh, value-identical births dedupe onto one slot; chained
        births and free-pool overflow stay for the sequential replay.

        Returns (arenas, still [R])."""
        cm = self.cm
        cap = cm.layouts[cid].capacity
        slots = _slots(cm, slots)
        rel = refresh(cm, arenas, self.obs_dev)
        valid = slots < cap
        statics: list = []
        env2, birthy, chained, tb, _w = init_row_step_alloc(
            self, cid, arenas, rel, params, slots, gen, valid, statics)
        arenas2, env2, overflow = _alloc_births(
            cm, arenas, rel, env2, tb, statics, birthy & ~chained)
        still = chained | overflow
        ok = valid & ~still
        arenas = _apply_batch(cm, cid, arenas2, slots, env2, ok,
                              mark_alive=True)
        return arenas, still

    def replay_rows_alloc(self, cid: ClassID, arenas, params, idx, gen,
                          chunk: int = 1024):
        """Batched-allocation replay of deferred init rows in chunks of
        `chunk`; returns (arenas, remaining_idx) with the chained/overflow
        rows left for the exact sequential replay."""
        n = len(idx)
        if n == 0:
            return arenas, idx
        remaining = []
        for i in range(0, n, chunk):
            part = np.asarray(idx[i:i + chunk], np.int64)
            arenas, still = self._replay_alloc_step(cid, arenas, params,
                                                    part, gen)
            st = still.cpu().numpy()
            remaining.extend(int(s) for s in part[st])
        return arenas, np.asarray(remaining, np.int64)

    # ------------------------------------------------------ scan drivers

    def scan_init(self, cid: ClassID, num_rows: int):
        """The sequential init program (smc.py:1023-1083) as a Python loop:
        run(arenas, params, base, gen) incorporates `seg` rows from `base`,
        carrying rel by exact point deltas and resampling parameters every
        rejuv_frequency rows. Returns (run, seg)."""
        seg = min(self.config.scan_segment, num_rows)
        cm = self.cm
        R = self.config.rejuv_frequency

        def run(arenas, params, base, gen):
            rel = refresh(cm, arenas, self.obs_dev)
            for off in range(seg):
                slot = base + off
                if slot >= num_rows:
                    break
                env2, births, _w = self._propose(cid, arenas, rel, params,
                                                 [slot], gen, False)
                arenas = apply_row(cm, cid, arenas, slot, env2, births,
                                   accept=True, mark_alive=True)
                rel = row_delta(cm, rel, arenas, self.obs_dev, cid, slot, +1)
                if (slot + 1) % R == 0:
                    arenas, params = resample_all(cm, arenas, params,
                                                  self.obs_dev, gen, rel=rel)
            return arenas, params

        return run, seg

    def _sweep_segment(self, cid: ClassID, arenas, params, base: int, gen,
                       seg: int, pools=None):
        """One class's MH rejuvenation over `seg` row slots from `base`, one
        row at a time (smc.py:1332-1429), with the relational state carried
        by class kind:
          * observed: row_delta point deltas excluding and re-adding the row;
          * non-leaf latent: latent_row_delta for reference counts, and
            hop_move with per-segment hop_histograms for the referrer
            group's propagated observations;
          * leaf latent: the segment-entry snapshot (loop-invariant).
        Dead slots propose and are rejected by the accept mask; the explicit
        MH comparison runs where exact_accept is False; resample_all runs
        every rejuv_frequency slots. `pools`: optional per-row lists of
        per-block injected uniform pools [1, n]."""
        cm = self.cm
        cap = cm.layouts[cid].capacity
        R = self.config.rejuv_frequency
        leaf = self._leaf_latent(cid)
        observed = cm.layouts[cid].observed
        relc = refresh(cm, arenas, self.obs_dev)
        hists = self._ext_hists(cid, arenas, params, rel=relc)
        comp = self._ref_comp(cid, arenas, relc)
        hops = [] if (observed or leaf) else \
            hop_histograms(cm, cid, arenas, self.obs_dev)
        fkvs = cm.layouts[cid].fk_vertices
        relcar = relc
        for off in range(seg):
            slot = base + off
            if slot >= cap:
                break
            st = torch.tensor([slot], device=cm.device)
            if observed:
                rel = row_delta(cm, relcar, arenas, self.obs_dev, cid, slot,
                                -1)
            elif leaf:
                rel = relc
            else:
                rel = latent_row_delta(cm, relcar, arenas, cid, slot, -1)
            env_p, births_p, w_p = self._propose(
                cid, arenas, rel, params, st, gen, False, ext_hists=hists,
                ref_comp=comp, pools=None if pools is None else pools[off])
            alive = take(arenas[cid]["alive"] if observed
                         else rel[cid]["alive"], st)
            if self.exact_accept:
                accept = alive
            else:
                _e, _b, w_r = self._propose(cid, arenas, rel, params, st, gen,
                                            True, ext_hists=hists,
                                            ref_comp=comp)
                u = torch.rand((1,), generator=gen, device=cm.device)
                accept = (torch.log(u) < (w_p - w_r)) & alive
            if hops:
                old_fks = {fkv: take(arenas[cid]["values"][fkv], st)
                           for fkv in fkvs}
            arenas = apply_row(cm, cid, arenas, slot, env_p, births_p,
                               accept=accept, mark_alive=False)
            if observed:
                # re-add the row's (possibly rewritten) contributions
                relcar = row_delta(cm, rel, arenas, self.obs_dev, cid, slot,
                                   +1)
            elif not leaf:
                relcar = latent_row_delta(cm, rel, arenas, cid, slot, +1)
                if hops:
                    relcar = hop_move(cm, relcar, arenas, cid, slot,
                                      old_fks, hops)
            if (slot + 1) % R == 0:
                arenas, params = resample_all(cm, arenas, params,
                                              self.obs_dev, gen, rel=relcar)
        return arenas, params

    def scan_sweep_class(self, cid: ClassID):
        """A segment of one class's sequential rejuvenation sweep
        (smc.py:1431-1447): run(arenas, params, base, gen) sweeps `seg` row
        slots from `base`. Returns (run, seg)."""
        seg = min(self.config.scan_segment, self.cm.layouts[cid].capacity)

        def run(arenas, params, base, gen):
            return self._sweep_segment(cid, arenas, params, base, gen, seg)

        return run, seg

    def scan_init_batched(self, cid: ClassID, num_rows: int, B: int,
                          kc: Optional[dict] = None):
        """Batched init segment (smc.py:1210-1330): run(arenas, params,
        base, gen) proposes seg_b batches of B rows, each against the
        carried snapshot, defers birthing rows (flags), carries rel by
        batched point deltas and resamples every max(1, rejuv_frequency//B)
        batches. Returns (run, nb, seg_b)."""
        nb = (num_rows + B - 1) // B
        seg_b = max(1, min(self.config.batch_segment_rows, num_rows) // B)
        seg_b = min(seg_b, nb)
        cm = self.cm
        R = max(1, self.config.rejuv_frequency // B)

        def run(arenas, params, base, gen):
            rel = refresh(cm, arenas, self.obs_dev)
            cand = build_cand(cm, rel, kc) if kc else None
            flags = []
            for i in range(seg_b):
                bi = base + i
                slots = bi * B + torch.arange(B, device=cm.device)
                if bi < nb:
                    env2, ok, birthy, _w = init_row_step(
                        self, cid, arenas, rel, params, slots, gen,
                        slots < num_rows, cand=cand)
                    old = arenas
                    arenas = _apply_batch(cm, cid, arenas, slots, env2, ok,
                                          mark_alive=True)
                    rel = batch_obs_delta(cm, rel, old, arenas, self.obs_dev,
                                          cid, slots)
                else:
                    birthy = torch.zeros((B,), dtype=torch.bool,
                                         device=cm.device)
                flags.append(birthy)
                if ((bi + 1) % R) == 0:
                    arenas, params = resample_all(cm, arenas, params,
                                                  self.obs_dev, gen, rel=rel)
            return arenas, params, torch.cat(flags)

        return run, nb, seg_b

    def scan_sweep_class_batched(self, cid: ClassID, B: int,
                                 kc: Optional[dict] = None):
        """One class's batched blocked-Gibbs sweep segment (smc.py:
        1566-1671): run(arenas, params, base, gen) sweeps seg_b batches of B
        slots with mh_row_step, carrying rel by batched point deltas
        (leaf latent classes keep the segment-entry snapshot), with the
        referrer histograms, referrer lists and candidate axes built once
        per segment. Returns (run, nb, seg_b)."""
        cap = self.cm.layouts[cid].capacity
        nb = (cap + B - 1) // B
        seg_b = max(1, min(self.config.batch_segment_rows, cap) // B)
        seg_b = min(seg_b, nb)
        cm = self.cm
        R = max(1, self.config.rejuv_frequency // B)
        leaf = self._leaf_latent(cid)
        observed = cm.layouts[cid].observed
        incr = not leaf

        def run(arenas, params, base, gen):
            relc = refresh(cm, arenas, self.obs_dev)
            cand = build_cand(cm, relc, kc) if kc else None
            hists = self._ext_hists(cid, arenas, params, rel=relc)
            comp = self._ref_comp(cid, arenas, relc)
            hops = hop_histograms(cm, cid, arenas, self.obs_dev) \
                if (incr and not observed) else []
            rel = relc
            flags = []
            for i in range(seg_b):
                bi = base + i
                slots = bi * B + torch.arange(B, device=cm.device)
                if bi < nb:
                    env2, accept, birthy = mh_row_step(
                        self, cid, arenas, rel, params, slots, gen,
                        slots < cap, ext_hists=hists, ref_comp=comp,
                        cand=cand)
                    old = arenas
                    arenas = _apply_batch(cm, cid, arenas, slots, env2,
                                          accept, mark_alive=False)
                    if incr:
                        rel = batch_obs_delta(cm, rel, old, arenas,
                                              self.obs_dev, cid, slots) \
                            if observed else \
                            batch_latent_delta(cm, rel, old, arenas, cid,
                                               slots, hops)
                else:
                    birthy = torch.zeros((B,), dtype=torch.bool,
                                         device=cm.device)
                flags.append(birthy)
                if ((bi + 1) % R) == 0:
                    arenas, params = resample_all(cm, arenas, params,
                                                  self.obs_dev, gen, rel=rel)
            return arenas, params, torch.cat(flags)

        return run, nb, seg_b

    # -------------------------------------------------------------- drivers

    def _progress(self, progress):
        if progress is True:
            return self.config.reporting_frequency
        return progress

    def _init_batched(self, cid, spec, gen, arenas, params, progress):
        """One observed class's batched initialization (smc.py:1682-1825):
        sequential ramp, batched segments with per-segment compact
        candidate axes, per-segment replay of deferred rows (batched
        allocation first, then sequential). Wall seconds per phase land in
        self.phase_times."""
        cfg = self.config
        B = cfg.batch_rows
        _run, nb, seg_b = self.scan_init_batched(cid, spec.num_rows, B)
        ramp = ((max(B, 512) + B - 1) // B) * B
        ramp = ramp if spec.num_rows >= 2 * ramp else 0
        t = {"ramp": 0.0, "batched": 0.0, "replay_alloc": 0.0,
             "replay_seq": 0.0, "replayed_alloc_rows": 0,
             "replayed_seq_rows": 0}
        t0 = time.time()
        if ramp:
            rrun, rseg = self.scan_init(cid, spec.num_rows)
            lcm = math.lcm(B, rseg)
            ramp = ((ramp + lcm - 1) // lcm) * lcm
            done0 = 0
            while done0 < ramp:
                arenas, params = rrun(arenas, params, done0, gen)
                done0 += rseg
            self._sync()
        t["ramp"] = time.time() - t0
        n_replayed = 0
        for base in range(ramp // B, nb, seg_b):
            kc = self._kc(arenas)
            run, _nb, _sb = self.scan_init_batched(cid, spec.num_rows, B,
                                                   kc=kc)
            tb = time.time()
            arenas, params, fl = run(arenas, params, base, gen)
            lo = base * B
            hi = min((base + seg_b) * B, spec.num_rows)
            idx = np.flatnonzero(fl.cpu().numpy()[: hi - lo]) + lo
            t["batched"] += time.time() - tb
            if idx.size:
                n_total = idx.size
                tr = time.time()
                t["replayed_alloc_rows"] += int(idx.size)
                arenas, idx = self.replay_rows_alloc(cid, arenas, params,
                                                     idx, gen)
                self._sync()
                t["replay_alloc"] += time.time() - tr
                tr = time.time()
                if len(idx):
                    t["replayed_seq_rows"] += int(len(idx))
                    arenas = self.replay_rows(cid, arenas, params, idx, gen,
                                              rejuv=False)
                    self._sync()
                t["replay_seq"] += time.time() - tr
                self._kc_note(n_total)
                n_replayed += n_total
            if progress and (hi // progress) != (lo // progress):
                print(f"Initialized ~{hi} of {spec.num_rows} rows for {cid}")
        if progress:
            print(f"Initialized {spec.num_rows} rows for {cid} "
                  f"(batched B={B}, {n_replayed} replayed)")
        self.phase_times[cid] = t
        return arenas, params

    def _init_sequential(self, cid, spec, gen, arenas, params, progress):
        """One observed class's sequential initialization at batch_rows=1
        (smc.py:1891-1909): scan_init over every row in segments; wall
        seconds in self.phase_times[cid]."""
        run, seg = self.scan_init(cid, spec.num_rows)
        t0 = time.time()
        done = 0
        while done < spec.num_rows:
            arenas, params = run(arenas, params, done, gen)
            done += seg
            if progress and (done // progress) != ((done - seg) // progress):
                print(f"Initialized ~{min(done, spec.num_rows)} of "
                      f"{spec.num_rows} rows for {cid}")
        self._sync()
        self.phase_times[cid] = {"sequential": time.time() - t0,
                                 "rows": spec.num_rows}
        return arenas, params

    def initialize(self, key, arenas, params, progress: Optional[int] = None):
        """initialize_trace (inference.jl:3-57): the sequential scan_init at
        batch_rows=1, else the batched MH path. `key`: a torch.Generator or
        an int seed. Returns (arenas, params, generator)."""
        self._check_supported()
        gen = self._gen(key)
        progress = self._progress(progress)
        init = self._init_sequential if self.config.batch_rows <= 1 \
            else self._init_batched
        for spec in self.cm.obs_specs:
            arenas, params = init(spec.class_id, spec, gen, arenas, params,
                                  progress)
        self._check_arena_pressure(arenas)
        return arenas, params, gen

    def sweep(self, key, arenas, params, progress: Optional[int] = None):
        """pgibbs_sweep! (inference.jl:60-81): at batch_rows=1 every class's
        sequential sweep in declaration order (smc.py:1997-2010), else
        per-class segmented batched MH sweeps (the JAX package's
        _sweep_batched_segmented branch)."""
        self._check_supported()
        gen = self._gen(key)
        progress = self._progress(progress)
        if self.config.batch_rows <= 1:
            return self._sweep_sequential(gen, arenas, params, progress)
        return self._sweep_batched_segmented(gen, arenas, params, progress)

    def _sweep_sequential(self, gen, arenas, params, progress):
        """Every class's scan_sweep_class segments over all its row slots,
        in declaration order; wall seconds in self.phase_times."""
        for cid in self.cm.model.class_order:
            run, seg = self.scan_sweep_class(cid)
            cap = self.cm.layouts[cid].capacity
            t0 = time.time()
            for base in range(0, cap, seg):
                arenas, params = run(arenas, params, base, gen)
            self._sync()
            self.phase_times[f"sweep:{cid}"] = {"sequential": time.time() - t0,
                                                "rows": cap}
            if progress:
                print(f"{cid}: sweep done")
        return arenas, params, gen

    def _sweep_batched_segmented(self, gen, arenas, params, progress):
        """Per-class segmented batched rejuvenation sweep; deferred entity-
        birthing rows replay sequentially with the same semantics."""
        B = self.config.batch_rows
        for cid in self.cm.model.class_order:
            _run, nb, seg_b = self.scan_sweep_class_batched(cid, B)
            cap = self.cm.layouts[cid].capacity
            parts = []
            t = {"batched": 0.0, "replay_seq": 0.0, "replayed_seq_rows": 0}
            tb = time.time()
            for base in range(0, nb, seg_b):
                kc = self._kc(arenas)
                run, _nb, _sb = self.scan_sweep_class_batched(cid, B, kc=kc)
                arenas, params, fl = run(arenas, params, base, gen)
                parts.append(fl.cpu().numpy())
            t["batched"] = time.time() - tb
            idx = np.flatnonzero(np.concatenate(parts)[:cap])
            if idx.size:
                tr = time.time()
                arenas = self.replay_rows(cid, arenas, params, idx, gen,
                                          rejuv=True)
                self._kc_note(idx.size)
                self._sync()
                t["replay_seq"] = time.time() - tr
                t["replayed_seq_rows"] = int(idx.size)
            self.phase_times[f"sweep:{cid}"] = t
            if progress:
                print(f"{cid}: sweep done (batched, segmented)")
        return arenas, params, gen

    def run(self, key, arenas, params, progress: Optional[int] = None):
        """run_inference! (inference.jl:83-88)."""
        gen = self._gen(key)
        for it in range(self.config.num_iters):
            if progress:
                print(f"Iteration {it + 1}/{self.config.num_iters}")
            arenas, params, gen = self.sweep(gen, arenas, params, progress)
        self._check_arena_pressure(arenas)
        return arenas, params, gen
