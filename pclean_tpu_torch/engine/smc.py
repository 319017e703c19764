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
    (`resample_all`); where the classes' capacities sum to at most
    fused_dispatch_rows, in the JAX package's fused order
    (`_sweep_batched_fused`: every class's batches, then every class's
    deferred rows).

With batch_rows = 1 (the reference-exact sequential path, smc.py:1023-1083
and 1332-1447): `initialize` runs `scan_init` over every row, and `sweep`
runs `scan_sweep_class` (`_sweep_segment`) for each class in declaration
order, one row slot at a time, with `resample_all` every rejuv_frequency
slots. The JAX package's `scan_sweep_all` fuses those per-class segments
into one XLA dispatch with the same semantics; eager torch has no dispatch
to save, so it has no twin here.

Every one-row loop (scan_init's segments, _sweep_segment, _replay_chunk
and the PG one-row steps they call) copies the leaves it writes once at
its segment's entry (`own_carry`) and updates them in place through the
hand kernels K10 (`ops.row_delta`, the row's relational delta) and K11
(`ops.row_write`, its values and births), whose arguments are bound to
that carry once a segment (`ops.RowCarry`), the row's slot a view of a
per-segment `arange` on the device, so neither waits for the card; the
out-of-place `apply_row` and refresh's point deltas stay for the batched
path and as those kernels' plain versions. On the card each segment's
row step is one CUDA graph (row_graph.RowGraph): the first row eager, the
rest replays, the slot a buffer on the card that the step advances, the
parameters a copy owned by the segment (row_graph.own_params) into which
resample_all draws in place (its K22 and K23 outputs) and whose other
leaves copy_params writes. A latent class's replay row
refreshes the carry (K14), its own row excluded by the slot buffer on the
card, as JAX's non-incremental replay body does. The batched steps write
their rows through K15 (`_apply_batch`) and carry rel by K14's scatters
(refresh.batch_obs_delta, batch_latent_delta), so neither compacts on the
host.

Particle Gibbs (use_mh_instead_of_pg=False, num_particles = P > 1) rides
the same drivers with engine/particles.py's row bodies: `pg_row_step` in
the batched segments, `pg_init_step` / `pg_rejuv_step` in the sequential
loops and the replays; `Engine.log_ml` accumulates each observed class's
init log-ML, each row once, and restarts at the next class. MH-mode init on a model that fails the exact-Gibbs audit runs
the reference's two fresh particles the same way (P = 2, not collapsed).

JAX's `vmap` over rows becomes the explicit batch axis of the BlockTracer,
and its `lax.scan` bodies become Python loops over batches or rows.
Sharding is not ported yet. Randomness comes from one torch.Generator per
call (`key`), so runs are reproducible per seed but do not reproduce the
JAX package's key streams.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import ops
from ..model.ir import ClassID
from ..utils import (index_set_drop, index_set_where, resolve_device,
                     scatter_add_drop, take)
from .compile import CompiledModel
from .gibbs_params import resample_all
from .propose import BlockTracer, _rtake, build_cand, referrer_histograms
from .refresh import (batch_latent_delta, batch_obs_delta, hop_histograms,
                      latent_row_delta, refresh, row_delta)
from .row_graph import RowGraph, copy_params, own_params


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
    # an MH sweep at batch_rows > 1 whose classes' capacities sum to at
    # most this takes the fused order (Engine._sweep_batched_fused): every
    # class's batches, then every class's deferred rows
    fused_dispatch_rows: int = 8192
    exact_gibbs_accept: bool = True
    # PG on an audit-passing model collapses to one exact draw a row
    # (engine/particles.py); False forces the written-out particle path
    collapse_exact_pg: bool = True


def _obs_device(cm: CompiledModel):
    """{observed class: {vid: (codes [N], state [N])}} device tensors."""
    out = {}
    for spec in cm.obs_specs:
        out[spec.class_id] = {vid: (cm.use(codes), cm.use(state))
                              for vid, (codes, state) in spec.columns.items()}
    return out


def _slots(cm, s) -> torch.Tensor:
    """Row slots as an int64 vector: a tensor stays where it is (the plain
    versions of K10 and K11 run on a CPU copy of a card's state), anything
    else goes to the model's device."""
    if torch.is_tensor(s):
        return s.long().reshape(-1)
    return torch.as_tensor(s, device=cm.device).long().reshape(-1)


def apply_row(cm: CompiledModel, cid: ClassID, arenas: dict, slot, env2: dict,
              births, accept, mark_alive: bool) -> dict:
    """Write one accepted proposal (values [1]) into the arenas (masked
    scatters with mode="drop"; row_inference.jl:169-185). Births of deeper
    classes are applied in list order, as sampled."""
    slot = _slots(cm, slot)
    accept = torch.as_tensor(accept, device=slot.device).reshape(-1)
    lay = cm.layouts[cid]
    vals = dict(arenas[cid]["values"])
    for vid in lay.store:
        if vid not in env2:
            continue
        cur = vals[vid]
        vals[vid] = index_set_where(cur, slot,
                                    env2[vid].reshape(-1).to(cur.dtype),
                                    accept)
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
            bvals[tv] = index_set_where(cur, bslot,
                                        val.reshape(-1).to(cur.dtype), ok)
        out[b.target_class] = {"values": bvals,
                               "alive": out[b.target_class]["alive"]}
    return out


def own_carry(cm: CompiledModel, cid: ClassID, arenas: dict, rel=None):
    """The leaves a one-row loop of class cid writes in place (K10 and K11,
    ops.row_delta and ops.row_write), copied once at its segment's entry,
    so that the caller's arenas and every snapshot taken from them come
    out of the segment unchanged: the value columns and alive bits of cid
    and of every class its fks reach (where its births land), and of `rel`
    every latent class's refcount, alive, total and nrows and every prop
    pair. Every other leaf stays shared. A rel that refresh() has just
    built for the loop is its own already: pass only a snapshot that
    something else holds. Returns (arenas, rel)."""
    reach = [cid]
    for c in reach:
        for fkv in cm.layouts[c].fk_vertices:
            tc = cm.node(c, fkv).target_class
            if tc not in reach:
                reach.append(tc)
    out = dict(arenas)
    for c in reach:
        out[c] = {"values": {v: x.clone()
                             for v, x in arenas[c]["values"].items()},
                  "alive": arenas[c]["alive"].clone()}
    if rel is not None:
        rel = {c: {**r, "prop": dict(r["prop"])} if cm.layouts[c].observed
               else {"alive": r["alive"].clone(),
                     "refcount": r["refcount"].clone(),
                     "total": r["total"].clone(), "nrows": r["nrows"].clone(),
                     "prop": {tv: (code.clone(), cnt.clone())
                              for tv, (code, cnt) in r["prop"].items()}}
               for c, r in rel.items()}
    return out, rel


def _apply_batch(cm: CompiledModel, cid: ClassID, arenas: dict, slots,
                 env2: dict, ok, mark_alive: bool) -> dict:
    """Scatter a batch of accepted row proposals (env2 values [B]); `ok`
    masks rows deferred to replay. Slots follow mode="drop". Out of place,
    as in JAX: the columns it writes are copied, then written by K15
    (ops.batch_write) in one launch; the caller's arenas stay as they
    were (the batched deltas read them as the old state)."""
    slots = _slots(cm, slots)
    lay = cm.layouts[cid]
    vals = dict(arenas[cid]["values"])
    vids = [vid for vid in lay.store if vid in env2]
    for vid in vids:
        vals[vid] = vals[vid].clone()
    alive = arenas[cid]["alive"]
    if mark_alive:
        alive = alive.clone()
    ops.batch_write([vals[v] for v in vids], [env2[v] for v in vids], slots,
                    ok, alive if mark_alive else None, cls=cid)
    out = dict(arenas)
    out[cid] = {"values": vals, "alive": alive}
    return out


def _birthy(births, B, device):
    out = torch.zeros((B,), dtype=torch.bool, device=device)
    for b in births:
        out = out | b.is_new
    return out


def exclude_rows(eng, cid: ClassID, arenas: dict, rel: dict, slots, valid):
    """Each of the rows `slots` [B] excluded from its own copy of the frozen
    snapshot by an exact point delta (the batch axis written out: per-row
    leaves), and which of them are live and valid. Returns (rel, alive
    [B])."""
    cm = eng.cm
    if cm.layouts[cid].observed:
        rel = row_delta(cm, rel, arenas, eng.obs_dev, cid, slots, -1,
                        dense=True, props=False)
        return rel, take(arenas[cid]["alive"], slots) & valid
    if cm.layouts[cid].fk_vertices:
        rel = latent_row_delta(cm, rel, arenas, cid, slots, -1, dense=True)
    return rel, _rtake(rel[cid]["alive"], slots[:, None])[:, 0] & valid


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
    rel, alive = exclude_rows(eng, cid, arenas, rel, slots, valid)
    env_p, births, w_p = eng._propose(cid, arenas, rel, params, slots, gen,
                                      False, ext_hists=ext_hists,
                                      ref_comp=ref_comp, cand=cand,
                                      pools=pools)
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
        # the last PG (or two-particle MH) initialize()'s log-ML estimate
        self.log_ml = torch.zeros((), device=dev)

    def _gen(self, key) -> torch.Generator:
        if isinstance(key, torch.Generator):
            return key
        g = torch.Generator(device=self.device)
        g.manual_seed(int(key))
        return g

    @property
    def _collapsed(self) -> bool:
        """PG collapses to one exact draw a row (particles.py)."""
        return self.exact_accept and self.config.collapse_exact_pg

    def _pg_seg(self, P: int) -> int:
        """Rows a sequential PG segment (smc.py:1103-1106): the collapsed
        form costs one enumeration a row whatever P; the written-out one
        P, so its segment shrinks with P."""
        seg = self.config.scan_segment
        if self._collapsed:
            return min(seg, 512)
        return max(1, min(seg, seg * 8 // max(1, P)))

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

    def _init_row(self, car, rel, params, st, gen, pools=None) -> None:
        """One fresh row of the carry's class proposed against `rel` and
        written into the carry, marked alive (K11). `pools`: a test's
        injected uniform pools."""
        env2, births, _w = self._propose(car.cid, car.arenas, rel, params, st,
                                         gen, False, pools=pools)
        ops.row_write(car, st, env2, births, mark_alive=True)

    def _mh_row(self, car, rel, params, st, gen, alive, **kw) -> None:
        """One row's MH rejuvenation against `rel` (the row excluded): the
        proposal, the explicit MH comparison where exact_accept is False
        (the retained values scored, one uniform), and the write into the
        carry (K11). `kw`: _propose's hoisted inputs (and a test's
        injected pools, which the retained scoring does not draw from)."""
        cid, arenas = car.cid, car.arenas
        env_p, births_p, w_p = self._propose(cid, arenas, rel, params, st,
                                             gen, False, **kw)
        if self.exact_accept:
            accept = alive
        else:
            kw.pop("pools", None)
            _e, _b, w_r = self._propose(cid, arenas, rel, params, st, gen,
                                        True, **kw)
            u = torch.rand((1,), generator=gen, device=self.cm.device)
            accept = (torch.log(u) < (w_p - w_r)) & alive
        ops.row_write(car, st, env_p, births_p, accept)

    # ------------------------------------------------ sequential replay

    def _replay_chunk(self, cid: ClassID, arenas, params, idx, gen,
                      rejuv: bool, pg_P: Optional[int] = None,
                      graph: bool = True, pools=None):
        """Incorporate the rows `idx` one at a time (smc.py:817-917): each
        row proposes against the relational state carried by exact point
        deltas (observed classes) or, as JAX's non-incremental body, a
        refresh of the carry (latent classes; with the row excluded where
        it rejuvenates, the slot read on the card). pg_P replays each row
        as a P-particle SMC (pg_init_step, pg_rejuv_step). The rows run as
        replays of one captured row step on the card (row_graph.RowGraph;
        graph=False: eagerly). `pools`: per-row lists of per-block
        injected uniform pools [1, n] of the MH proposal (tests; the rows
        then run eagerly). Returns (arenas, the init rows' summed
        log-ML)."""
        from .particles import pg_init_step, pg_rejuv_step

        cm = self.cm
        obs = self.obs_dev
        observed = cm.layouts[cid].observed
        lml = torch.zeros((), device=cm.device)
        arenas, _r = own_carry(cm, cid, arenas)
        # observed classes carry rel by exact point deltas; latent ones
        # refresh from the carry each row
        car = ops.RowCarry(cm, cid, arenas,
                           refresh(cm, arenas, obs) if observed else None,
                           obs)
        pool_i = [0]

        def step(st):
            if observed:
                rel = car.rel
                if rejuv:
                    ops.row_delta(car, st, -1)
            elif rejuv:
                rel = refresh(cm, arenas, obs, exclude_cid=cid,
                              exclude_slot=st)
            else:
                rel = refresh(cm, arenas, obs)
            if rejuv:
                if pg_P:
                    pg_rejuv_step(self, car, rel, params, st, gen, pg_P)
                else:
                    self._mh_row(car, rel, params, st, gen,
                                 take((arenas if observed else rel)[cid]
                                      ["alive"], st),
                                 pools=None if pools is None
                                 else pools[pool_i[0]])
            elif pg_P:
                lml.add_(pg_init_step(self, car, rel, params, st, gen,
                                      pg_P).sum())
            else:
                self._init_row(car, rel, params, st, gen,
                               pools=None if pools is None
                               else pools[pool_i[0]])
            if observed:
                ops.row_delta(car, st, +1)

        # injected uniform pools are a host input of each row: eager
        rg = RowGraph(step, cm.device,
                      self._loop_kind("replay", cid, pg_P, rejuv),
                      table=idx, gen=gen, graph=graph and pools is None)
        for i in range(len(idx)):
            pool_i[0] = i
            rg.row()
        rg.close()
        return arenas, lml

    def _loop_kind(self, loop: str, cid: ClassID, pg_P, rejuv=True) -> str:
        """A one-row loop's kind, as row_graph.STATS names it: the loop,
        the class kind (obs, latent, leaf; init for rows incorporated),
        then "pg" (collapsed) or "pg written", or "mh" where the explicit
        MH comparison runs."""
        lay = self.cm.layouts[cid]
        if not rejuv:
            ck = "init"
        elif lay.observed:
            ck = "obs"
        else:
            ck = "latent" if lay.fk_vertices else "leaf"
        if pg_P:
            tail = " pg" if self._collapsed else " pg written"
        else:
            tail = "" if (self.exact_accept or not rejuv) else " mh"
        return f"{loop}{tail}" if loop == "ramp" else f"{loop} {ck}{tail}"

    def replay_rows(self, cid: ClassID, arenas, params, idx, gen,
                    rejuv: bool, pg_P: Optional[int] = None):
        """Sequentially replay the flagged (entity-birthing) rows; with
        pg_P as P-particle SMC, the init rows' log-ML added to
        Engine.log_ml (rejuvenation rows add none)."""
        if len(idx) == 0:
            return arenas
        arenas, lml = self._replay_chunk(cid, arenas, params, idx, gen,
                                         rejuv, pg_P)
        if pg_P and not rejuv:
            self.log_ml = self.log_ml + lml
        return arenas

    def _replay_alloc_step(self, cid: ClassID, arenas, params, slots, gen):
        """ONE batched init pass over deferred rows with in-batch birth
        allocation (smc.py:919-958): full candidate axis over the entry
        refresh, value-identical births dedupe onto one slot; chained
        births and free-pool overflow stay for the sequential replay.

        Returns (arenas, still [R], the applied rows' summed proposal
        weight: their collapsed-PG log-ML)."""
        cm = self.cm
        cap = cm.layouts[cid].capacity
        slots = _slots(cm, slots)
        rel = refresh(cm, arenas, self.obs_dev)
        valid = slots < cap
        statics: list = []
        env2, birthy, chained, tb, w = init_row_step_alloc(
            self, cid, arenas, rel, params, slots, gen, valid, statics)
        arenas2, env2, overflow = _alloc_births(
            cm, arenas, rel, env2, tb, statics, birthy & ~chained)
        still = chained | overflow
        ok = valid & ~still
        arenas = _apply_batch(cm, cid, arenas2, slots, env2, ok,
                              mark_alive=True)
        return arenas, still, torch.where(ok, w, torch.zeros_like(w)).sum()

    def replay_rows_alloc(self, cid: ClassID, arenas, params, idx, gen,
                          chunk: int = 1024, pg: bool = False):
        """Batched-allocation replay of deferred init rows in chunks of
        `chunk`; returns (arenas, remaining_idx) with the chained/overflow
        rows left for the exact sequential replay. With pg the applied
        rows' log-ML is added to Engine.log_ml (collapsed-PG init)."""
        n = len(idx)
        if n == 0:
            return arenas, idx
        remaining = []
        for i in range(0, n, chunk):
            part = np.asarray(idx[i:i + chunk], np.int64)
            arenas, still, lml = self._replay_alloc_step(cid, arenas, params,
                                                         part, gen)
            if pg:
                self.log_ml = self.log_ml + lml
            st = still.cpu().numpy()
            remaining.extend(int(s) for s in part[st])
        return arenas, np.asarray(remaining, np.int64)

    # ------------------------------------------------------ scan drivers

    def scan_init(self, cid: ClassID, num_rows: int,
                  pg_P: Optional[int] = None):
        """The sequential init program (smc.py:1023-1083) as a Python loop:
        run(arenas, params, base, gen) incorporates `seg` rows from `base`,
        carrying rel by exact point deltas and resampling parameters every
        rejuv_frequency rows; returns (arenas, params, the rows' summed
        log-ML). pg_P makes it scan_init_pg (smc.py:1085-1149): each row a
        P-particle SMC (pg_init_step), in segments of _pg_seg(P) rows.
        The rows after a segment's first are replays of its captured row
        step on the card (row_graph.RowGraph; run(..., graph=False): every
        row eager). Returns (run, seg)."""
        seg = min(self._pg_seg(pg_P) if pg_P else self.config.scan_segment,
                  num_rows)
        cm = self.cm
        R = self.config.rejuv_frequency
        from .particles import pg_init_step

        def run(arenas, params, base, gen, graph=True):
            arenas, _r = own_carry(cm, cid, arenas)
            params = own_params(params)
            rel = refresh(cm, arenas, self.obs_dev)
            car = ops.RowCarry(cm, cid, arenas, rel, self.obs_dev)
            lml = torch.zeros((), device=cm.device)

            def step(st):
                if pg_P:
                    lml.add_(pg_init_step(self, car, rel, params, st, gen,
                                          pg_P).sum())
                else:
                    self._init_row(car, rel, params, st, gen)
                ops.row_delta(car, st, +1)

            rg = RowGraph(step, cm.device,
                          self._loop_kind("ramp", cid, pg_P, False),
                          base=base, gen=gen, graph=graph)
            for off in range(seg):
                slot = base + off
                if slot >= num_rows:
                    break
                rg.row()
                if (slot + 1) % R == 0:
                    _a, new = resample_all(cm, arenas, params, self.obs_dev,
                                           gen, rel=rel, out=params)
                    copy_params(params, new)
            rg.close()
            return arenas, params, lml

        return run, seg

    def _sweep_segment(self, cid: ClassID, arenas, params, base: int, gen,
                       seg: int, pools=None, pg_P: Optional[int] = None,
                       graph: bool = True):
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
        per-block injected uniform pools [1, n]. pg_P rejuvenates each row
        by P-particle conditional SMC instead (pg_rejuv_step), as
        scan_sweep_class_pg does (smc.py:1151-1208). On the card the rows
        after the segment's first are replays of its captured row step
        (row_graph.RowGraph), unless `pools` are injected or graph=False."""
        from .particles import pg_rejuv_step

        cm = self.cm
        cap = cm.layouts[cid].capacity
        R = self.config.rejuv_frequency
        leaf = self._leaf_latent(cid)
        observed = cm.layouts[cid].observed
        obs = self.obs_dev
        relc = refresh(cm, arenas, obs)
        hists = self._ext_hists(cid, arenas, params, rel=relc)
        comp = self._ref_comp(cid, arenas, relc)
        hops = [] if (observed or leaf) else \
            hop_histograms(cm, cid, arenas, obs)
        # the segment's own copies of what K10 and K11 write; the snapshots
        # above keep the caller's
        arenas, rel = own_carry(cm, cid, arenas, None if leaf else relc)
        if leaf:
            rel = relc
        car = ops.RowCarry(cm, cid, arenas, rel, obs, hops)
        params = own_params(params)
        mode = "obs" if observed else "latent"
        old_fk = torch.empty((len(cm.layouts[cid].fk_vertices),),
                             dtype=torch.int64, device=cm.device) \
            if hops else None
        pool_i = [0]

        def step(st):
            if not leaf:   # the row excluded from the carried state
                ops.row_delta(car, st, -1, mode, save_fk=old_fk)
            if pg_P:
                pg_rejuv_step(self, car, rel, params, st, gen, pg_P,
                              ext_hists=hists, ref_comp=comp)
            else:
                self._mh_row(car, rel, params, st, gen,
                             take(arenas[cid]["alive"] if observed
                                  else rel[cid]["alive"], st),
                             ext_hists=hists, ref_comp=comp,
                             pools=None if pools is None
                             else pools[pool_i[0]])
            if not leaf:
                # re-add the row's (possibly rewritten) contributions; a
                # latent row also moves its referrers' propagated
                # observations from its old fk targets (hop_move)
                ops.row_delta(car, st, +1, mode, old_fk=old_fk)

        # injected uniform pools are a host input of each row: eager
        rg = RowGraph(step, cm.device, self._loop_kind("sweep", cid, pg_P),
                      base=base, gen=gen, graph=graph and pools is None)
        for off in range(seg):
            slot = base + off
            if slot >= cap:
                break
            pool_i[0] = off
            rg.row()
            if (slot + 1) % R == 0:
                _a, new = resample_all(cm, arenas, params, obs, gen, rel=rel,
                                       out=params)
                copy_params(params, new)
        rg.close()
        return arenas, params

    def scan_sweep_class(self, cid: ClassID, pg_P: Optional[int] = None):
        """A segment of one class's sequential rejuvenation sweep
        (smc.py:1431-1447): run(arenas, params, base, gen) sweeps `seg` row
        slots from `base`. pg_P makes it scan_sweep_class_pg (smc.py:
        1151-1208): P-particle CSMC a row, in segments of _pg_seg(P) rows.
        Returns (run, seg)."""
        seg = min(self._pg_seg(pg_P) if pg_P else self.config.scan_segment,
                  self.cm.layouts[cid].capacity)

        def run(arenas, params, base, gen, graph=True):
            return self._sweep_segment(cid, arenas, params, base, gen, seg,
                                       pg_P=pg_P, graph=graph)

        return run, seg

    def scan_init_batched(self, cid: ClassID, num_rows: int, B: int,
                          kc: Optional[dict] = None,
                          pg_P: Optional[int] = None):
        """Batched init segment (smc.py:1210-1330): run(arenas, params,
        base, gen) proposes seg_b batches of B rows, each against the
        carried snapshot, defers birthing rows (flags), carries rel by
        batched point deltas and resamples every max(1, rejuv_frequency//B)
        batches; returns (arenas, params, flags, log_ml). pg_P runs each
        row as a P-particle SMC: collapsed, init_row_step's proposal with
        its weight as the row's log-ML; written out, pg_row_step. log_ml
        sums the applied (not deferred) rows'. Returns (run, nb, seg_b)."""
        from .particles import pg_row_step

        nb = (num_rows + B - 1) // B
        seg_b = max(1, min(self.config.batch_segment_rows, num_rows) // B)
        vmapped = bool(pg_P) and not self._collapsed
        if vmapped:
            # B x P particle-rows a batch: the segment shrinks by 8 / P as
            # in the JAX package (smc.py:1243), unclamped, so for P < 8 it
            # grows instead
            seg_b = max(1, seg_b * 8 // pg_P)
        seg_b = min(seg_b, nb)
        cm = self.cm
        R = max(1, self.config.rejuv_frequency // B)

        def run(arenas, params, base, gen):
            rel = refresh(cm, arenas, self.obs_dev)
            cand = build_cand(cm, rel, kc) if kc else None
            flags = []
            lml = torch.zeros((), device=cm.device)
            for i in range(seg_b):
                bi = base + i
                slots = bi * B + torch.arange(B, device=cm.device)
                if bi < nb:
                    if vmapped:
                        env2, ok, birthy, w = pg_row_step(
                            self, cid, arenas, rel, params, slots, gen,
                            slots < num_rows, pg_P, False, cand=cand)
                    else:
                        env2, ok, birthy, w = init_row_step(
                            self, cid, arenas, rel, params, slots, gen,
                            slots < num_rows, cand=cand)
                    if pg_P:
                        lml = lml + torch.where(ok, w,
                                                torch.zeros_like(w)).sum()
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
            return arenas, params, torch.cat(flags), lml

        return run, nb, seg_b

    def scan_sweep_class_batched(self, cid: ClassID, B: int,
                                 kc: Optional[dict] = None,
                                 pg_P: Optional[int] = None,
                                 whole: bool = False):
        """One class's batched blocked-Gibbs sweep segment (smc.py:
        1566-1671): run(arenas, params, base, gen) sweeps seg_b batches of B
        slots with mh_row_step, or with pg_P P-particle CSMC (pg_row_step,
        retained), carrying rel by batched point deltas (leaf latent
        classes keep the segment-entry snapshot), with the referrer
        histograms, referrer lists and candidate axes built once per
        segment. `whole`: one segment of all the class's batches (the
        fused order's class pass, smc.py:1496-1546). Returns (run, nb,
        seg_b)."""
        from .particles import pg_row_step

        cap = self.cm.layouts[cid].capacity
        nb = (cap + B - 1) // B
        seg_b = max(1, min(self.config.batch_segment_rows, cap) // B)
        if pg_P and not self._collapsed:
            # the written-out particle path: as in scan_init_batched
            # (smc.py:1588), unclamped for P < 8
            seg_b = max(1, seg_b * 8 // pg_P)
        seg_b = nb if whole else min(seg_b, nb)
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
                    if pg_P:
                        env2, accept, birthy, _lml = pg_row_step(
                            self, cid, arenas, rel, params, slots, gen,
                            slots < cap, pg_P, True, ext_hists=hists,
                            ref_comp=comp, cand=cand)
                    else:
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

    def _init_batched(self, cid, spec, gen, arenas, params, progress,
                      pg_P: Optional[int] = None):
        """One observed class's batched initialization (smc.py:1682-1825):
        sequential ramp, batched segments with per-segment compact
        candidate axes, per-segment replay of deferred rows (batched
        allocation first, then sequential). pg_P runs every stage as a
        P-particle SMC and adds each row's log-ML to self.log_ml once.
        Wall seconds per phase land in self.phase_times."""
        cfg = self.config
        B = cfg.batch_rows
        _run, nb, seg_b = self.scan_init_batched(cid, spec.num_rows, B,
                                                 pg_P=pg_P)
        # the batched birth allocator replays the written-out PG path's
        # deferred rows as exact sequential SMC instead, which the longer
        # ramp keeps few (smc.py:1726-1730)
        alloc = not pg_P or self._collapsed
        base_ramp = 512 if alloc else 2048
        ramp = ((max(B, base_ramp) + B - 1) // B) * B
        ramp = ramp if spec.num_rows >= 2 * ramp else 0
        t = {"ramp": 0.0, "batched": 0.0, "replay_alloc": 0.0,
             "replay_seq": 0.0, "replayed_alloc_rows": 0,
             "replayed_seq_rows": 0}
        t0 = time.time()
        if ramp:
            rrun, rseg = self.scan_init(cid, spec.num_rows, pg_P=pg_P)
            lcm = math.lcm(B, rseg)
            ramp = ((ramp + lcm - 1) // lcm) * lcm
            done0 = 0
            while done0 < ramp:
                arenas, params, lml = rrun(arenas, params, done0, gen)
                if pg_P:
                    self.log_ml = self.log_ml + lml
                done0 += rseg
            self._sync()
        t["ramp"] = time.time() - t0
        n_replayed = 0
        for base in range(ramp // B, nb, seg_b):
            kc = self._kc(arenas)
            run, _nb, _sb = self.scan_init_batched(cid, spec.num_rows, B,
                                                   kc=kc, pg_P=pg_P)
            tb = time.time()
            arenas, params, fl, lml = run(arenas, params, base, gen)
            if pg_P:
                self.log_ml = self.log_ml + lml
            lo = base * B
            hi = min((base + seg_b) * B, spec.num_rows)
            idx = np.flatnonzero(fl.cpu().numpy()[: hi - lo]) + lo
            t["batched"] += time.time() - tb
            if idx.size:
                n_total = idx.size
                tr = time.time()
                if alloc:
                    t["replayed_alloc_rows"] += int(idx.size)
                    arenas, idx = self.replay_rows_alloc(
                        cid, arenas, params, idx, gen, pg=bool(pg_P))
                    self._sync()
                t["replay_alloc"] += time.time() - tr
                tr = time.time()
                if len(idx):
                    t["replayed_seq_rows"] += int(len(idx))
                    arenas = self.replay_rows(cid, arenas, params, idx, gen,
                                              rejuv=False, pg_P=pg_P)
                    self._sync()
                t["replay_seq"] += time.time() - tr
                self._kc_note(n_total)
                n_replayed += n_total
            if progress and (hi // progress) != (lo // progress):
                print(f"Initialized ~{hi} of {spec.num_rows} rows for {cid}")
        if progress:
            print(f"Initialized {spec.num_rows} rows for {cid} "
                  f"(batched B={B}, {n_replayed} replayed"
                  + (f", PG P={pg_P}" if pg_P else "") + ")")
        self.phase_times[cid] = t
        return arenas, params

    def _init_sequential(self, cid, spec, gen, arenas, params, progress,
                         pg_P: Optional[int] = None):
        """One observed class's sequential initialization at batch_rows=1
        (smc.py:1891-1909): scan_init over every row in segments (with
        pg_P, scan_init_pg's P-particle rows, smc.py:1862-1877); wall
        seconds in self.phase_times[cid]."""
        run, seg = self.scan_init(cid, spec.num_rows, pg_P=pg_P)
        t0 = time.time()
        done = 0
        while done < spec.num_rows:
            arenas, params, lml = run(arenas, params, done, gen)
            if pg_P:
                self.log_ml = self.log_ml + lml
            done += seg
            if progress and (done // progress) != ((done - seg) // progress):
                print(f"Initialized ~{min(done, spec.num_rows)} of "
                      f"{spec.num_rows} rows for {cid}")
        self._sync()
        self.phase_times[cid] = {"sequential": time.time() - t0,
                                 "rows": spec.num_rows}
        return arenas, params

    def _pg_P(self, init: bool) -> Optional[int]:
        """Particles a row in PG mode (use_mh_instead_of_pg False and
        num_particles > 1), else None; at init also 2 for MH mode on a model
        that fails the exact-Gibbs audit, which runs the reference's two
        fresh particles (smc.py:1834-1845, infer_config.jl:11-13)."""
        cfg = self.config
        if cfg.num_particles <= 1:
            return None
        if not cfg.use_mh_instead_of_pg:
            return cfg.num_particles
        return 2 if init and not self.exact_accept else None

    def initialize(self, key, arenas, params, progress: Optional[int] = None):
        """initialize_trace (inference.jl:3-57): the sequential scan_init at
        batch_rows=1, else the batched path; P-particle SMC rows where
        _pg_P says so, with self.log_ml restarted at each observed class,
        as the JAX package does (smc.py:1855-1881): it ends as the last
        class's log-ML. `key`: a torch.Generator or an int seed. Returns
        (arenas, params, generator)."""
        gen = self._gen(key)
        progress = self._progress(progress)
        pg_P = self._pg_P(init=True)
        init = self._init_sequential if self.config.batch_rows <= 1 \
            else self._init_batched
        for spec in self.cm.obs_specs:
            if pg_P:
                self.log_ml = torch.zeros((), device=self.device)
            arenas, params = init(spec.class_id, spec, gen, arenas, params,
                                  progress, pg_P=pg_P)
        self._check_arena_pressure(arenas)
        return arenas, params, gen

    def sweep(self, key, arenas, params, progress: Optional[int] = None):
        """pgibbs_sweep! (inference.jl:60-81): at batch_rows=1 every class's
        sequential sweep in declaration order (smc.py:1997-2010); else, for
        an MH sweep whose classes' capacities sum to at most
        fused_dispatch_rows, the fused order (_sweep_batched_fused,
        smc.py:2011-2036), and otherwise per-class segmented batched sweeps
        (the JAX package's _sweep_batched_segmented branch); MH rows, or
        P-particle CSMC rows in PG mode."""
        gen = self._gen(key)
        progress = self._progress(progress)
        pg_P = self._pg_P(init=False)
        if self.config.batch_rows <= 1:
            return self._sweep_sequential(gen, arenas, params, progress,
                                          pg_P)
        total_cap = sum(self.cm.layouts[c].capacity
                        for c in self.cm.model.class_order)
        if not pg_P and total_cap <= self.config.fused_dispatch_rows:
            return self._sweep_batched_fused(gen, arenas, params, progress)
        return self._sweep_batched_segmented(gen, arenas, params, progress,
                                             pg_P)

    def _sweep_sequential(self, gen, arenas, params, progress, pg_P=None):
        """Every class's scan_sweep_class segments over all its row slots,
        in declaration order; wall seconds in self.phase_times."""
        for cid in self.cm.model.class_order:
            run, seg = self.scan_sweep_class(cid, pg_P=pg_P)
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

    def _sweep_batched_fused(self, gen, arenas, params, progress):
        """The fused order of a small batched MH sweep (scan_sweep_all_batched
        and its dispatch, smc.py:1481-1564, 2011-2036): every class in
        declaration order sweeps all its batches as one segment on the full
        candidate axis, and only then are every class's deferred
        (entity-birthing) rows replayed, class by class. Wall seconds in
        self.phase_times["sweep:<class>"], with "order": "fused"."""
        B = self.config.batch_rows
        flags = {}
        for cid in self.cm.model.class_order:
            run, _nb, _sb = self.scan_sweep_class_batched(cid, B, whole=True)
            tb = time.time()
            arenas, params, fl = run(arenas, params, 0, gen)
            flags[cid] = fl
            self.phase_times[f"sweep:{cid}"] = {
                "order": "fused", "batched": time.time() - tb,
                "replay_seq": 0.0, "replayed_seq_rows": 0}
        for cid in self.cm.model.class_order:
            cap = self.cm.layouts[cid].capacity
            idx = np.flatnonzero(flags[cid].cpu().numpy()[:cap])
            if idx.size:
                tr = time.time()
                arenas = self.replay_rows(cid, arenas, params, idx, gen,
                                          rejuv=True)
                self._kc_note(idx.size)
                self._sync()
                t = self.phase_times[f"sweep:{cid}"]
                t["replay_seq"] = time.time() - tr
                t["replayed_seq_rows"] = int(idx.size)
        if progress:
            print("sweep done (fused, batched)")
        return arenas, params, gen

    def _sweep_batched_segmented(self, gen, arenas, params, progress,
                                 pg_P=None):
        """Per-class segmented batched rejuvenation sweep (MH rows, or
        P-particle CSMC with pg_P); deferred entity-birthing rows replay
        sequentially with the same semantics."""
        B = self.config.batch_rows
        for cid in self.cm.model.class_order:
            _run, nb, seg_b = self.scan_sweep_class_batched(cid, B,
                                                            pg_P=pg_P)
            cap = self.cm.layouts[cid].capacity
            parts = []
            t = {"batched": 0.0, "replay_seq": 0.0, "replayed_seq_rows": 0}
            tb = time.time()
            for base in range(0, nb, seg_b):
                kc = self._kc(arenas)
                run, _nb, _sb = self.scan_sweep_class_batched(cid, B, kc=kc,
                                                              pg_P=pg_P)
                arenas, params, fl = run(arenas, params, base, gen)
                parts.append(fl.cpu().numpy())
            t["batched"] = time.time() - tb
            idx = np.flatnonzero(np.concatenate(parts)[:cap])
            if idx.size:
                tr = time.time()
                arenas = self.replay_rows(cid, arenas, params, idx, gen,
                                          rejuv=True, pg_P=pg_P)
                self._kc_note(idx.size)
                self._sync()
                t["replay_seq"] = time.time() - tr
                t["replayed_seq_rows"] = int(idx.size)
            self.phase_times[f"sweep:{cid}"] = t
            if progress:
                print(f"{cid}: sweep done (batched, segmented"
                      + (f", PG P={pg_P}" if pg_P else "") + ")")
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
