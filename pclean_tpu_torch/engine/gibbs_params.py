"""Parameter + Pitman-Yor hyperparameter rejuvenation.

Counterpart of pclean_tpu/engine/gibbs_params.py (gibbs_params.py:54-224):
the conjugate resample_value! of the reference (choose_proportionally.jl:
70-74, add_noise.jl:74-82) and resample_py_params! (trace.jl:80-108).
Sufficient statistics are recomputed from the arenas as dense masked
reductions in plain torch ops right before each resample. The port learns
Proportions and Mean; Prob comes with MaybeSwap in a later slice. Every
draw takes an explicit torch.Generator.
"""
from __future__ import annotations

import torch

from ..dists import params as P
from ..model.ir import ChoiceNode, ClassID, ParamLookupNode, VertexID
from ..utils import sample_gamma, scatter_add_drop
from .compile import CompiledModel
from .propose import _RowCtx, row_value
from .refresh import refresh


def mean_suffstats(cm: CompiledModel, cid: ClassID, vid: VertexID,
                   arenas: dict, params: dict, alive) -> dict:
    """{"counts" int32, "sums" f32} [I, S] of a Mean parameter: for each
    site s (an AddNoise/TransformedGaussian node whose mean is the parameter
    or a lookup of it) and each live row, one count and backward(value) at
    the row's index (gibbs_params.py:123-146; out-of-range keys drop)."""
    meta = cm.param_meta[(cid, vid)]
    c = cm.cls(cid)
    cap = cm.layouts[cid].capacity
    I, sites = meta["num_indices"], meta["sites"]
    S = max(len(sites), 1)
    slots = torch.arange(cap, device=cm.device)
    ctx = _RowCtx(cm, arenas, params, cid, slots)
    counts = torch.zeros((I * S,), dtype=torch.int32, device=cm.device)
    sums = torch.zeros((I * S,), dtype=torch.float32, device=cm.device)
    for si, (w, _std) in enumerate(sites):
        kern = cm.kernels[cm.canon(cid, w)]
        z = kern.backward(ctx, arenas[cid]["values"][w].to(torch.float32))
        mv = c.nodes[w].arg_ids.get("mean")
        if mv == vid:
            keyv = torch.zeros((cap,), dtype=torch.long, device=cm.device)
        else:
            pl = c.nodes[mv]
            assert isinstance(pl, ParamLookupNode) and pl.param_id == vid
            keyv = row_value(cm, arenas, params, cid, pl.key_id, slots).long()
        # keys out of [0, I) drop, as the JAX scatter's mode="drop" does
        cell = torch.where((keyv >= 0) & (keyv < I), keyv * S + si,
                           torch.full_like(keyv, I * S))
        counts = scatter_add_drop(counts, cell, alive.to(torch.int32))
        sums = scatter_add_drop(sums, cell, torch.where(
            alive, z, torch.zeros((), device=cm.device)))
    return {"counts": counts.reshape(I, S), "sums": sums.reshape(I, S)}


def recompute_and_resample(cm: CompiledModel, cid: ClassID, vid: VertexID,
                           arenas: dict, rel: dict, params: dict,
                           obs_dev: dict, gen: torch.Generator) -> dict:
    """Resample one parameter from its conjugate posterior, with sufficient
    statistics freshly reduced from the arenas."""
    meta = cm.param_meta[(cid, vid)]
    spec = meta["spec"]
    c = cm.cls(cid)
    lay = cm.layouts[cid]
    alive = arenas[cid]["alive"] if lay.observed else rel[cid]["alive"]
    state = params[cid][vid]
    if isinstance(spec, P.Mean):
        state = {**state, **mean_suffstats(cm, cid, vid, arenas, params,
                                           alive)}
        stds = [s for (_w, s) in meta["sites"]] or [1.0]
        return P.resample_mean(gen, state, spec, stds)
    if not isinstance(spec, P.Proportions):
        raise TypeError(f"{type(spec).__name__} is not ported yet")
    # the unique choice node drawing from these proportions
    w = next(w for w, n in enumerate(c.nodes)
             if isinstance(n, ChoiceNode) and n.arg_ids.get("probs") == vid)
    vals = arenas[cid]["values"][w]
    nopt = meta["num_options"]
    ok = alive & (vals >= 0) & (vals < nopt)
    counts = scatter_add_drop(
        torch.zeros((nopt,), dtype=torch.int32, device=cm.device), vals,
        ok.to(torch.int32))[None, :]
    return P.resample_proportions(gen, {**state, "counts": counts}, spec)


def pitman_yor_score(strength, discount, sizes, alive):
    """Exchangeable-partition score (trace.jl:65-78), vectorized: the
    per-cluster inner sums close via lgamma; any slot order gives the
    reference's value."""
    s, d = strength, discount
    sizes_f = torch.where(alive, sizes.to(torch.float32),
                          torch.zeros((), device=sizes.device))
    n_before = torch.cumsum(sizes_f, 0) - sizes_f
    j = torch.cumsum(alive.to(torch.float32), 0)  # 1-based cluster index
    term_new = torch.log(torch.clamp(j * d + s, min=1e-30)) - \
        torch.log(n_before + s)
    inner = (torch.lgamma(torch.clamp(sizes_f - d, min=1e-30))
             - torch.lgamma(1.0 - d)
             - (torch.lgamma(n_before + sizes_f + s)
                - torch.lgamma(n_before + 1.0 + s)))
    zero = torch.zeros((), device=sizes.device)
    inner = torch.where(sizes_f > 1, inner, zero)
    return torch.sum(torch.where(alive, term_new + inner, zero))


def resample_py(cm: CompiledModel, cid: ClassID, rel: dict, py_state: dict,
                gen: torch.Generator):
    """MH over (strength, discount) (trace.jl:80-108): strength proposed
    from Gamma(1,1) (an independence proposal whose density cancels against
    the implicit Gamma(1,1) prior), discount from Uniform(0,1)."""
    sizes = rel[cid]["refcount"]
    alive = rel[cid]["alive"] & (sizes > 0)
    s0 = py_state["strength"]
    d0 = py_state["discount"]
    dev = sizes.device
    old = pitman_yor_score(s0, d0, sizes, alive)
    s_prop = sample_gamma(gen, torch.ones((), device=dev))
    new = pitman_yor_score(s_prop, d0, sizes, alive)
    alpha = new + (-s0) - old - (-s_prop)
    u = torch.rand((3,), generator=gen, device=dev)
    acc = torch.log(u[0]) < alpha
    s1 = torch.where(acc, s_prop, s0)
    cur = torch.where(acc, new, old)
    d_prop = u[1]
    new2 = pitman_yor_score(s1, d_prop, sizes, alive)
    acc2 = torch.log(u[2]) < (new2 - cur)
    d1 = torch.where(acc2, d_prop, d0)
    return {"strength": s1, "discount": d1}


def resample_all(cm: CompiledModel, arenas: dict, params: dict, obs_dev: dict,
                 gen: torch.Generator, rel=None):
    """Resample every learned parameter and the per-class Pitman-Yor
    hyperparameters (inference.jl:40-47). `rel`: the caller's carried
    relational state, which skips a full refresh."""
    if rel is None:
        rel = refresh(cm, arenas, obs_dev)
    new_params = {c: dict(v) for c, v in params.items()}
    for (cid, vid) in cm.param_meta:
        new_params[cid][vid] = recompute_and_resample(
            cm, cid, vid, arenas, rel, new_params, obs_dev, gen)
    py = dict(new_params.get("__py__", {}))
    for cid in cm.model.class_order:
        if cm.layouts[cid].observed or cid not in py:
            continue
        py[cid] = resample_py(cm, cid, rel, py[cid], gen)
    if py:
        new_params["__py__"] = py
    return arenas, new_params
