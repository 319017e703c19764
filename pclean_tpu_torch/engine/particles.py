"""Particle Gibbs: a P-particle SMC over each row's blocks.

Counterpart of pclean_tpu/engine/particles.py, itself the counterpart of
the reference's particle machinery (row_inference.jl): SMC particles,
ESS-adaptive multinomial resampling with retain-first for conditional SMC
(87-105, 152-155) and the final categorical selection (159-165).

Two forms, chosen as the JAX package chooses them:

  * collapsed: where the compile-time exact-Gibbs audit passes (and
    collapse_exact_pg is on), every particle weight inside a block equals
    the block's logZ, so the P-particle SMC is one exact posterior draw,
    kept over the retained particle with probability (P - 1) / P, with the
    summed block logZs as its log-ML: one enumeration a row, whatever P;
  * written out: JAX's `vmap` over particles becomes the tracer's row axis,
    R rows times P particles (row-major, particle p of row r at r P + p,
    each row's slot repeated P times). With `retained`, particle 0 of every
    row is traced in one call with force_retained and the other P - 1 in a
    second call, and the two are joined along the particle axis, as the
    JAX package does. Between blocks K9 (ops.pg_resample) resamples each
    row where its ESS falls below P / 2, and after the last block draws
    the row's particle; envs and births are gathered by its indices.

The draws use uniforms from the caller's torch.Generator, not JAX's Gumbel
noise, so the two packages agree in distribution.
"""
from __future__ import annotations

import torch

from .. import ops
from ..model.ir import ClassID
from ..utils import take
from .propose import Birth, BlockTracer
from .smc import _birthy, _slots, exclude_rows


def _rel_rows(rel: dict, rows: torch.Tensor) -> dict:
    """rel with every per-row leaf (the batch axis first, after a dense
    self-exclusion delta: [B, cap], or [B] for total and nrows) gathered at
    `rows`; shared leaves ([cap], or 0-d) stay as they are."""
    def g(x, shared_dim):
        return x[rows] if x.dim() > shared_dim else x

    return {c: {"alive": g(r["alive"], 1), "refcount": g(r["refcount"], 1),
                "total": g(r["total"], 0), "nrows": g(r["nrows"], 0),
                "prop": {v: (g(code, 1), g(cnt, 1))
                         for v, (code, cnt) in r["prop"].items()}}
            for c, r in rel.items()}


def _join(r: torch.Tensor, f: torch.Tensor, R: int, P: int) -> torch.Tensor:
    """The retained particles r [R, ...] and the fresh ones f [R (P - 1),
    ...] as one particle axis [R P, ...] (particle 0 of each row
    retained)."""
    rest = tuple(f.shape[1:])
    return torch.cat([r.reshape((R, 1) + rest),
                      f.to(r.dtype).reshape((R, P - 1) + rest)],
                     1).reshape((R * P,) + rest)


def _gather_birth(b: Birth, idx: torch.Tensor) -> Birth:
    return Birth(b.fk_vid, b.target_class, b.is_new[idx], b.slot[idx],
                 {tv: v[idx] for tv, v in b.values.items()}, depth=b.depth)


def propose_row_pg(eng, cid: ClassID, arenas: dict, rel: dict, params: dict,
                   slots, gen, P: int, retained: bool, ext_hists=None,
                   ref_comp=None, cand=None, pools=None):
    """The P-particle SMC of the rows `slots` [R] (particles.py:33-159).

    Returns (env {vid: [R]}, births, log_ml [R], accept [R]). With
    retained=True particle 0 of each row is the CSMC retained particle,
    forced to the stored row (row_inference.jl:143-145); `accept` is False
    only where the collapsed form keeps the retained particle (one uniform
    a row, u < 1 / P), and callers then keep the stored row. `pools`:
    optional per-block injected uniform pools [R, n] of the collapsed
    form's one proposal (tests)."""
    cm = eng.cm
    dev = cm.device
    slots = _slots(cm, slots)
    R = int(slots.shape[0])
    if P > 1 and eng.exact_accept and eng.config.collapse_exact_pg:
        env, births, w = eng._propose(cid, arenas, rel, params, slots, gen,
                                      False, ext_hists=ext_hists,
                                      ref_comp=ref_comp, cand=cand,
                                      pools=pools)
        if retained:
            # uniform selection over P equally weighted particles: the
            # retained one (index 0) survives with probability 1 / P
            u = torch.rand((R,), generator=gen, device=dev)
            accept = u >= 1.0 / P
        else:
            accept = torch.ones((R,), dtype=torch.bool, device=dev)
        return env, births, w, accept
    envs, births, ws, log_ml = smc_particles(
        eng, cid, arenas, rel, params, slots, gen, P, retained,
        ext_hists=ext_hists, ref_comp=ref_comp, cand=cand)
    u = torch.rand((R,), generator=gen, device=dev)
    j, inc = ops.pg_resample(ws, u, "final")
    env = {v: x[j] for v, x in envs.items()}
    births = [_gather_birth(b, j) for b in births]
    return env, births, log_ml + inc, torch.ones((R,), dtype=torch.bool,
                                                 device=dev)


def smc_particles(eng, cid: ClassID, arenas: dict, rel: dict, params: dict,
                  slots: torch.Tensor, gen, P: int, retained: bool,
                  ext_hists=None, ref_comp=None, cand=None):
    """The written-out form's P particles of the rows `slots` [R] through
    every block, up to the final selection (particles.py:78-146). Returns
    (envs {vid: [R P]}, births on the same particle axis, ws [R, P] the
    final weights, log_ml [R] the resampling steps' increments)."""
    cm = eng.cm
    dev = cm.device
    R = int(slots.shape[0])

    def block(plan, rows_slots, rows_rel, obs_row, env0, force):
        tr = BlockTracer(cm, cid, arenas, rows_rel, params, eng.obs_dev,
                         obs_row, env0, rows_slots, force_retained=force,
                         ext_hists=ext_hists, ref_comp=ref_comp, cand=cand)
        logZ, res = tr.run(plan, gen)
        return res.env, logZ + res.weight, res.births

    ar = torch.arange(R, device=dev)
    n_fresh = P - 1 if retained else P
    # each row's index n_fresh times (an expand: repeat_interleave would
    # ask the card for the output's length)
    rows_f = ar[:, None].expand(R, n_fresh).reshape(-1)
    slots_f, rel_f = slots[rows_f], _rel_rows(rel, rows_f)
    obs_f = eng._obs_row_slices(cid, slots_f, rel_f)
    obs_r = eng._obs_row_slices(cid, slots, rel) if retained else None
    envs: dict = {}
    births: list = []
    ws = torch.zeros((R, P), device=dev)
    log_ml = torch.zeros((R,), device=dev)
    plans = cm.cls(cid).plans
    for bi, plan in enumerate(plans):
        if not retained:
            envs, dws, blk = block(plan, slots_f, rel_f, obs_f, envs, False)
        else:
            env_r = {v: x.reshape(R, P)[:, 0] for v, x in envs.items()}
            env_r, w_r, b_r = block(plan, slots, rel, obs_r, env_r, True)
            if P == 1:
                envs, dws, blk = env_r, w_r, b_r
            else:
                env_f = {v: x.reshape(R, P)[:, 1:].reshape(-1)
                         for v, x in envs.items()}
                env_f, w_f, b_f = block(plan, slots_f, rel_f, obs_f, env_f,
                                        False)
                envs = {v: _join(env_r[v], env_f[v], R, P) for v in env_r}
                dws = _join(w_r, w_f, R, P)
                blk = [Birth(r.fk_vid, r.target_class,
                             _join(r.is_new, f.is_new, R, P),
                             _join(r.slot, f.slot, R, P),
                             {tv: _join(r.values[tv], f.values[tv], R, P)
                              for tv in r.values}, depth=r.depth)
                       for r, f in zip(b_r, b_f)]
        births.extend(blk)
        ws = ws + dws.reshape(R, P)
        if bi < len(plans) - 1 and P > 1:
            # adaptive multinomial resampling (row_inference.jl:87-105)
            u = torch.rand((R, P), generator=gen, device=dev)
            sel, ws, inc = ops.pg_resample(ws, u, "resample", retained)
            log_ml = log_ml + inc
            sel = sel.reshape(-1)
            envs = {v: x[sel] for v, x in envs.items()}
            births = [_gather_birth(b, sel) for b in births]
    return envs, births, ws, log_ml


def pg_row_step(eng, cid: ClassID, arenas: dict, rel: dict, params: dict,
                slots, gen, valid, P: int, retained: bool, ext_hists=None,
                ref_comp=None, cand=None, pools=None):
    """A batch of rows' P-particle SMC decisions against a frozen relational
    snapshot (particles.py:162-196), the PG twin of smc.mh_row_step:
    retained=True runs CSMC with each row excluded from its own copy of the
    snapshot by an exact point delta; False is fresh-row SMC init. Rows
    whose chosen particle births a latent entity are deferred (flagged).

    Returns (env, accept & alive & ~birthy, birthy & alive, log_ml [B])."""
    cm = eng.cm
    slots = _slots(cm, slots)
    alive = valid
    if retained:
        rel, alive = exclude_rows(eng, cid, arenas, rel, slots, valid)
    env, births, lml, acc = propose_row_pg(
        eng, cid, arenas, rel, params, slots, gen, P, retained,
        ext_hists=ext_hists, ref_comp=ref_comp, cand=cand, pools=pools)
    birthy = _birthy(births, int(slots.shape[0]), cm.device)
    return env, acc & alive & ~birthy, birthy & alive, lml


def pg_init_step(eng, car, rel: dict, params: dict, slot, gen, P: int):
    """Incorporate one fresh row `slot` (a one-element index tensor) of
    the carry's class by P-particle SMC against `rel`, the current
    relational state (particles.py:199-216), written into the carry's
    arenas in place (K11, ops.row_write). Returns log_ml [1]."""
    st = _slots(eng.cm, slot)
    env, births, lml, _acc = propose_row_pg(eng, car.cid, car.arenas, rel,
                                            params, st, gen, P, False)
    ops.row_write(car, st, env, births, mark_alive=True)
    return lml


def pg_rejuv_step(eng, car, rel: dict, params: dict, slot, gen, P: int,
                  ext_hists=None, ref_comp=None) -> None:
    """CSMC rejuvenation of one row `slot` (a one-element index tensor) of
    the carry's class with P particles, particle 0 retained, against `rel`
    with the row excluded (particles.py:219-237); the final selection is
    by weight (row_inference.jl:164). Written into the carry's arenas in
    place (K11, ops.row_write)."""
    cm, cid, arenas = eng.cm, car.cid, car.arenas
    st = _slots(cm, slot)
    env, births, _lml, acc = propose_row_pg(
        eng, cid, arenas, rel, params, st, gen, P, True, ext_hists=ext_hists,
        ref_comp=ref_comp)
    alive = take(arenas[cid]["alive"] if cm.layouts[cid].observed
                 else rel[cid]["alive"], st)
    ops.row_write(car, st, env, births, alive & acc)
