"""Parameter + Pitman-Yor hyperparameter rejuvenation.

Counterpart of pclean_tpu/engine/gibbs_params.py (gibbs_params.py:54-224):
the conjugate resample_value! of the reference (choose_proportionally.jl:
70-74, add_noise.jl:74-82) and resample_py_params! (trace.jl:80-108).
Sufficient statistics are recomputed from the arenas as dense masked
reductions in plain torch ops right before each resample, for the three
families: Proportions, Prob (MaybeSwap sites, with the gated-lookup mask)
and Mean. resample_all draws one seed from its torch.Generator (on the
card, so nothing waits for the host) and makes every Proportions and
Prob draw of the call in one K22 launch (ops.gamma_draw) and every latent
class's Pitman-Yor MH in one K23 launch (ops.py_resample), both on the
counter-based stream of that seed; Mean draws stay torch.randn. The
priors' constants are the compiled model's tables (CompiledModel.priors,
uploaded once by CompiledModel.use).

The order rule: JAX resamples the parameters one after another, each
parameter's statistics reduced from the values drawn before it. A K22
launch draws after all of its parameters' statistics are reduced, so
where a parameter's statistics read a learned parameter (stats_reads)
that the pending launch would draw, that launch goes first and a new one
starts (draw_stages): the statistics see the same values as in JAX's
loop, and a model without such a read takes one launch.
"""
from __future__ import annotations

import torch

from .. import ops
from ..dists import params as P
from ..dists.core import MaybeSwap
from ..model.ir import (ChoiceNode, ClassID, ComputeNode, ParameterNode,
                        ParamLookupNode, VertexID)
from ..utils import scatter_add_drop, take
from .compile import CompiledModel
from .propose import _row_chain, _RowCtx, row_value
from .refresh import refresh


def mean_suffstats(cm: CompiledModel, cid: ClassID, vid: VertexID,
                   arenas: dict, params: dict, alive) -> dict:
    """{"counts" int32, "sums" f32} [I, S] of a Mean parameter: for each
    site s (an AddNoise/TransformedGaussian node whose mean is the parameter
    or a lookup of it) and each live row, one count and backward(value) at
    the row's index (gibbs_params.py:123-146; keys follow mode="drop":
    [-I, -1] wraps, the rest out of [0, I) drops)."""
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
        # JAX's counts.at[keyv, si] with mode="drop": keys in [-I, -1]
        # wrap to keyv + I, the rest out of [0, I) drop
        keyv = torch.where(keyv < 0, keyv + I, keyv)
        cell = torch.where((keyv >= 0) & (keyv < I), keyv * S + si,
                           torch.full_like(keyv, I * S))
        counts = scatter_add_drop(counts, cell, alive.to(torch.int32))
        sums = scatter_add_drop(sums, cell, torch.where(
            alive, z, torch.zeros((), device=cm.device)))
    return {"counts": counts.reshape(I, S), "sums": sums.reshape(I, S)}


def prob_suffstats(cm: CompiledModel, cid: ClassID, vid: VertexID,
                   arenas: dict, params: dict, obs_dev: dict, alive) -> dict:
    """{"heads", "tails"} int32 [I] of a Prob parameter over its MaybeSwap
    sites (gibbs_params.py:79-121): a live row whose observation is present
    counts a head where it differs from val (a swap) and a tail where it
    equals it, at the row's index; missing observations and rows whose
    lookup gate is true (the parameter is bypassed) count nothing; keys
    follow mode="drop" (utils.drop_index)."""
    c = cm.cls(cid)
    cap = cm.layouts[cid].capacity
    I = cm.param_meta[(cid, vid)]["num_indices"]
    slots = torch.arange(cap, device=cm.device)
    heads = torch.zeros((I,), dtype=torch.int32, device=cm.device)
    tails = torch.zeros((I,), dtype=torch.int32, device=cm.device)
    for w, n in enumerate(c.nodes):
        if not (isinstance(n, ChoiceNode) and isinstance(n.dist, MaybeSwap)):
            continue
        pv = n.arg_ids.get("prob")
        gate = None
        if pv == vid:
            keyv = torch.zeros((cap,), dtype=torch.long, device=cm.device)
        elif pv is not None and isinstance(c.nodes[pv], ParamLookupNode) \
                and c.nodes[pv].param_id == vid:
            pl = c.nodes[pv]
            keyv = row_value(cm, arenas, params, cid, pl.key_id, slots).long()
            if pl.gate_id is not None:
                truth = cm.use(cm.truth_table(cid, pl.gate_id))
                gate = take(truth, row_value(cm, arenas, params, cid,
                                             pl.gate_id, slots))
        else:
            continue
        valv = row_value(cm, arenas, params, cid, n.arg_ids["val"], slots)
        oa = obs_dev.get(cid, {}).get(w)
        if oa is not None:
            obsv, observed = oa[0], oa[1] == 1
        else:
            obsv = arenas[cid]["values"][w]
            observed = torch.ones((cap,), dtype=torch.bool, device=cm.device)
        mask = alive & observed
        if gate is not None:
            mask = mask & ~gate
        same = obsv == valv
        heads = scatter_add_drop(heads, keyv, (mask & ~same).to(torch.int32))
        tails = scatter_add_drop(tails, keyv, (mask & same).to(torch.int32))
    return {"heads": heads, "tails": tails}


def suffstats(cm: CompiledModel, cid: ClassID, vid: VertexID, arenas: dict,
              rel: dict, params: dict, obs_dev: dict) -> dict:
    """One parameter's sufficient statistics, freshly reduced from the
    arenas: {"counts"} [1, V] of a Proportions, {"heads", "tails"} of a
    Prob, {"counts", "sums"} of a Mean."""
    meta = cm.param_meta[(cid, vid)]
    spec = meta["spec"]
    c = cm.cls(cid)
    lay = cm.layouts[cid]
    alive = arenas[cid]["alive"] if lay.observed else rel[cid]["alive"]
    if isinstance(spec, P.Mean):
        return mean_suffstats(cm, cid, vid, arenas, params, alive)
    if isinstance(spec, P.Prob):
        return prob_suffstats(cm, cid, vid, arenas, params, obs_dev, alive)
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
    return {"counts": counts}


def _vertex_params(cm: CompiledModel, cls: ClassID, vid: VertexID) -> set:
    """The learned parameters (canonical (class, vertex)) that row_value of
    vertex `vid` of class `cls` reads: a ParamLookup's parameter, through
    Compute nodes' arguments and lookups' keys and gates."""
    _hops, lc, lv, node = _row_chain(cm, cls, vid)
    if isinstance(node, ParameterNode):
        return {cm.canon(lc, lv)}
    if isinstance(node, ComputeNode):
        args = list(node.arg_ids)
        out = set()
    elif isinstance(node, ParamLookupNode):
        args = [a for a in (node.key_id, node.gate_id) if a is not None]
        out = {cm.canon(lc, node.param_id)}
    else:
        return set()
    for a in args:
        out |= _vertex_params(cm, lc, a)
    return out


def stats_reads(cm: CompiledModel, cid: ClassID, vid: VertexID) -> set:
    """The learned parameters that a parameter's statistics read: through
    every argument of its sites (the MaybeSwap or Gaussian nodes that use
    it) but the parameter itself, and its lookups' keys and gates. A
    Proportions' counts read only its choice's stored values."""
    spec = cm.param_meta[(cid, vid)]["spec"]
    if not isinstance(spec, (P.Prob, P.Mean)):
        return set()
    c = cm.cls(cid)
    slot = "prob" if isinstance(spec, P.Prob) else "mean"
    out = set()
    for n in c.nodes:
        if not isinstance(n, ChoiceNode):
            continue
        pv = n.arg_ids.get(slot)
        if pv is None:
            continue
        pl = c.nodes[pv]
        if pv == vid:
            args = []
        elif isinstance(pl, ParamLookupNode) and pl.param_id == vid:
            args = [a for a in (pl.key_id, pl.gate_id) if a is not None]
        else:
            continue
        args += [a for k, a in n.arg_ids.items() if k != slot]
        for a in args:
            out |= _vertex_params(cm, cid, a)
    return out


def draw_stages(cm: CompiledModel) -> list:
    """resample_all's parameters in cm.param_meta's order (JAX's loop
    order), cut into stages: one K22 launch draws a stage's Proportions
    and Prob values after the stage's statistics are reduced, so a stage
    ends before a parameter whose statistics read a value that launch
    draws. Each statistic then sees the values drawn before it, as in
    JAX's loop. A Mean is drawn at once and ends no stage. Built once a
    model."""
    cache = cm.__dict__.get("_draw_stages")
    if cache is None:
        cache, pending = [[]], set()
        for key, meta in cm.param_meta.items():
            if stats_reads(cm, *key) & pending:
                cache.append([])
                pending = set()
            cache[-1].append(key)
            if not isinstance(meta["spec"], P.Mean):
                pending.add(cm.canon(*key))
        cm.__dict__["_draw_stages"] = cache
    return cache


def param_draw(cm: CompiledModel, cid: ClassID, vid: VertexID, state: dict,
               gen: torch.Generator) -> tuple:
    """One parameter's conjugate posterior draw from `state` (its leaves
    with fresh statistics): (leaf, value) of a Mean, drawn here
    (torch.randn), or (leaf, K22 descriptor) of a Proportions or Prob,
    whose value a gamma_draw launch makes."""
    meta = cm.param_meta[(cid, vid)]
    spec = meta["spec"]
    prior = cm.use(cm.priors[(cid, vid)])
    if isinstance(spec, P.Mean):
        stds = [s for (_w, s) in meta["sites"]] or [1.0]
        return "value", P.resample_mean(gen, state, spec, stds,
                                        prior)["value"]
    if isinstance(spec, P.Prob):
        return "value", P.prob_desc(prior, state["heads"], state["tails"])
    return "log_value", P.proportions_desc(prior, state["counts"].shape[0],
                                           state["counts"])


def recompute_and_resample(cm: CompiledModel, cid: ClassID, vid: VertexID,
                           arenas: dict, rel: dict, params: dict,
                           obs_dev: dict, gen: torch.Generator) -> dict:
    """Resample one parameter from its conjugate posterior, with sufficient
    statistics freshly reduced from the arenas: resample_all's draw
    (param_draw) for one parameter, a Proportions or Prob in a K22 launch
    of its own."""
    state = {**params[cid][vid],
             **suffstats(cm, cid, vid, arenas, rel, params, obs_dev)}
    leaf, x = param_draw(cm, cid, vid, state, gen)
    if not torch.is_tensor(x):
        (x,) = ops.gamma_draw([x], ops.draw_seed(gen, cm.device))
    return {**state, leaf: x}


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


def resample_all(cm: CompiledModel, arenas: dict, params: dict, obs_dev: dict,
                 gen: torch.Generator, rel=None, out=None):
    """Resample every learned parameter and the per-class Pitman-Yor
    hyperparameters (inference.jl:40-47), with no host sync: for each
    stage of draw_stages (one for every model the port ships), one seed
    from `gen`, each parameter's statistics by its scatters and its draw
    (param_draw), one K22 launch for the stage's Proportions and Prob
    draws; then one K23 launch for every latent class's (strength,
    discount) MH (gibbs_params.py:174-197) on the last seed. `rel`: the
    caller's carried relational state, which skips a full refresh.
    `out`: parameters whose leaves K22 and K23 draw into in place (a
    one-row loop's own copy, row_graph.own_params, which its captured
    graph reads); else they draw into new tensors."""
    if rel is None:
        rel = refresh(cm, arenas, obs_dev)
    new_params = {c: dict(v) for c, v in params.items()}
    for stage in draw_stages(cm):
        seed = ops.draw_seed(gen, cm.device)
        descs, outs, dests = [], [], []
        for cid, vid in stage:
            state = {**new_params[cid][vid], **suffstats(
                cm, cid, vid, arenas, rel, new_params, obs_dev)}
            leaf, x = param_draw(cm, cid, vid, state, gen)
            if torch.is_tensor(x):
                new_params[cid][vid] = {**state, leaf: x}
                continue
            descs.append(x)
            outs.append(None if out is None else out[cid][vid][leaf])
            dests.append((cid, vid, leaf, state))
        for (cid, vid, leaf, state), v in zip(
                dests, ops.gamma_draw(descs, seed, outs)):
            new_params[cid][vid] = {**state, leaf: v}
    py = dict(new_params.get("__py__", {}))
    cids = [cid for cid in cm.model.class_order
            if not cm.layouts[cid].observed and cid in py]
    classes = [ops.py_class(rel[cid]["refcount"], rel[cid]["alive"],
                            py[cid]["strength"], py[cid]["discount"])
               for cid in cids]
    sd = ops.py_resample(classes, seed, None if out is None else [
        (out["__py__"][cid]["strength"], out["__py__"][cid]["discount"])
        for cid in cids])
    for cid, (s1, d1) in zip(cids, sd):
        py[cid] = {"strength": s1, "discount": d1}
    if py:
        new_params["__py__"] = py
    return arenas, new_params
