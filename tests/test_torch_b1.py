"""Parity of the port's batch_rows=1 sequential drivers with pclean_tpu.

On experiments/scaled.py's CPU config (scaled.py:19-22), whose classes
cover the three relational-state strategies of the sequential sweep
(Record observed, Hospital a non-leaf latent class with an fk to County,
County a leaf latent class), and on tests/test_incremental.py's chain
model, whose Record column observed two hops down (hosp.loc.state) gives
the Hospital sweep propagated observations to move:

  * hop_move after rewriting a chain Hospital's county: the propagated
    observations bit-equal to the JAX package's and to a fresh refresh;
  * _sweep_segment over 20 consecutive row slots of each class (row_delta,
    latent_row_delta + hop_move, the leaf snapshot) whose stored values
    were rolled by one row, each row fed the JAX package's uniform pools:
    the arenas bit-equal to the JAX package's, and changed;
  * the sequential init (scan_init over every row) and one sequential
    sweep: F1 over 3 seeds within the JAX package's own 3-seed range
    +- 0.02, with the per-phase wall times recorded;
  * _sweep_segment with the explicit MH comparison (exact_gibbs_accept
    off) on the scaled model, which passes the exact-Gibbs audit: the
    same arenas as the exact path under the same uniform pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.analysis import evaluate_accuracy_device as j_eval
from pclean_tpu.engine import compile as jcompile
from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine import smc as jsmc
from pclean_tpu_torch.analysis import evaluate_accuracy_device
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.compile import init_state
from test_torch_host import (JNS, TNS, assert_rel_equal, chain, port_state,
                             scaled_pair, to_jax)
from test_torch_propose import _plan_subkeys, _pool_key

SEG = 20
NO_RESAMPLE = 10 ** 6   # rejuv_frequency past every slot of the segment


def _pair(which):
    if which == "scaled":
        (cm_j, _cj, _qj), (cm_t, cfg_t, _qt), _d, _c = scaled_pair()
    else:
        (cm_j, _qj), (cm_t, _qt) = chain(JNS), chain(TNS)
        cfg_t = tsmc.InferenceConfig(batch_rows=4, rejuv_frequency=16)
    arenas, params = port_state(cm_t, cfg_t)
    return dict(cm_j=cm_j, cm_t=cm_t, arenas=arenas, params=params)


@pytest.fixture(scope="module")
def pairs():
    return {w: _pair(w) for w in ("scaled", "chain")}


def test_hop_move_matches_jax(pairs):
    pair = pairs["chain"]
    cm_j, cm_t = pair["cm_j"], pair["cm_t"]
    eng_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(batch_rows=1))
    eng_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(batch_rows=1),
                        device="cpu")
    aj, at = to_jax(pair["arenas"]), to_torch(pair["arenas"], "cpu")
    hj = jrefresh.hop_histograms(cm_j, "Hospital", aj, eng_j.obs_dev)
    ht = trefresh.hop_histograms(cm_t, "Hospital", at, eng_t.obs_dev)
    assert len(hj) == len(ht) > 0
    fk = cm_t.layouts["Hospital"].fk_vertices[0]
    rel_t = trefresh.refresh(cm_t, at, eng_t.obs_dev)
    live = np.flatnonzero(rel_t["Hospital"]["alive"].numpy())
    counties = np.flatnonzero(rel_t["County"]["alive"].numpy())
    for slot in live[:4]:
        old = int(pair["arenas"]["Hospital"]["values"][fk][slot])
        new = int(counties[(np.searchsorted(counties, old) + 1)
                           % len(counties)])
        rj = jrefresh.refresh(cm_j, aj, eng_j.obs_dev)
        rt = trefresh.refresh(cm_t, at, eng_t.obs_dev)
        aj2 = {**aj, "Hospital": {**aj["Hospital"], "values": {
            **aj["Hospital"]["values"],
            fk: aj["Hospital"]["values"][fk].at[slot].set(new)}}}
        vt = at["Hospital"]["values"][fk].clone()
        vt[slot] = new
        at2 = {**at, "Hospital": {**at["Hospital"], "values": {
            **at["Hospital"]["values"], fk: vt}}}
        mj = jrefresh.hop_move(cm_j, rj, aj2, "Hospital", slot,
                               {fk: jnp.int32(old)}, hj)
        mt = trefresh.hop_move(cm_t, rt, at2, "Hospital", int(slot),
                               {fk: torch.tensor(old)}, ht)
        assert_rel_equal(mj, mt, f"hop_move slot {slot}")
        # the moved observations are those of a fresh refresh (the
        # reference counts are latent_row_delta's business)
        fresh = trefresh.refresh(cm_t, at2, eng_t.obs_dev)
        for v, (code, cnt) in fresh["County"]["prop"].items():
            assert torch.equal(mt["County"]["prop"][v][1], cnt)
            assert torch.equal(mt["County"]["prop"][v][0], code)


def _rolled(pair, cid, base):
    """The pair's numpy arenas with the segment's stored values (and fks)
    rolled by one row, so a sweep over it has something to repair."""
    arenas = {c: {"alive": a["alive"], "values": dict(a["values"])}
              for c, a in pair["arenas"].items()}
    for v in pair["cm_t"].layouts[cid].store:
        col = arenas[cid]["values"][v].copy()
        col[base:base + SEG] = np.roll(col[base:base + SEG], 1)
        arenas[cid]["values"][v] = col
    return arenas


@pytest.mark.parametrize("which,cid,base", [
    ("scaled", "Record", 100), ("scaled", "Hospital", 0),
    ("scaled", "County", 0), ("chain", "Hospital", 0)])
def test_sweep_segment_rows_match_jax(pairs, which, cid, base):
    pair = pairs[which]
    cm_j, cm_t = pair["cm_j"], pair["cm_t"]
    eng_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(
        batch_rows=1, rejuv_frequency=NO_RESAMPLE))
    eng_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(
        batch_rows=1, rejuv_frequency=NO_RESAMPLE), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(17), SEG)
    cap = cm_j.layouts[cid].capacity
    arenas = _rolled(pair, cid, base)
    aj, _pj = jax.jit(lambda a, p, k: eng_j._sweep_segment(
        cid, a, p, base, k, cap))(to_jax(arenas), to_jax(pair["params"]),
                                  keys)
    plans = cm_j.cls(cid).plans
    from pclean_tpu.engine import propose as jprop
    pools = []
    for k in keys:
        kp = jax.random.split(k, 4)[0]
        subs = _plan_subkeys(kp, len(plans))
        pools.append([torch.as_tensor(np.asarray(jax.random.uniform(
            _pool_key(sub), (jprop._draw_bound(cm_j, cid, plan),))))[None]
            for sub, plan in zip(subs, plans)])
    at, _pt = eng_t._sweep_segment(cid, to_torch(arenas, "cpu"),
                                   to_torch(pair["params"], "cpu"), base,
                                   None, SEG, pools=pools)
    changed = 0
    for c in aj:
        np.testing.assert_array_equal(np.asarray(aj[c]["alive"]),
                                      at[c]["alive"].numpy())
        for v in aj[c]["values"]:
            np.testing.assert_array_equal(np.asarray(aj[c]["values"][v]),
                                          at[c]["values"][v].numpy(),
                                          err_msg=f"{cid}: {c}.{v}")
            changed += int((at[c]["values"][v].numpy() !=
                            arenas[c]["values"][v]).sum())
    assert changed > 0, "the segment moved nothing"


def test_sequential_init_and_sweep_f1_within_jax_seed_spread():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = scaled_pair(
        batch=1)
    f_j, f_t = [], []
    for seed in range(3):
        a, p = jcompile.init_state(cm_j, jax.random.PRNGKey(seed))
        eng = jsmc.Engine(cm_j, cfg_j)
        a, p, k = eng.initialize(jax.random.PRNGKey(seed + 1), a, p)
        a, p, k = eng.run(k, a, p)
        f_j.append(j_eval(cm_j, a, p, dirty, clean, q_j)["f1"])

        a, p = init_state(cm_t, seed, device="cpu")
        eng_t = tsmc.Engine(cm_t, cfg_t, device="cpu")
        a, p, g = eng_t.initialize(seed + 1, a, p)
        a, p, g = eng_t.run(g, a, p)
        f_t.append(evaluate_accuracy_device(cm_t, a, p, dirty, clean,
                                            q_t)["f1"])
        assert eng_t.phase_times["Record"]["rows"] == 512
        assert set(eng_t.phase_times) == {"Record", "sweep:County",
                                          "sweep:Hospital", "sweep:Record"}
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


@pytest.mark.parametrize("cid,base", [("Record", 100), ("Hospital", 0)])
def test_sweep_segment_explicit_mh_accepts_exact_gibbs_moves(pairs, cid,
                                                             base):
    """With exact_gibbs_accept off, _sweep_segment scores the retained
    values too and runs the MH comparison; a blocked-Gibbs move of a model
    that passes the exact-Gibbs audit has weight ratio 1, so every live row
    accepts and the arenas equal the exact path's under the same uniform
    pools."""
    pair = pairs["scaled"]
    cm_t = pair["cm_t"]
    assert cm_t.exact_gibbs_ok
    plans = cm_t.cls(cid).plans
    from pclean_tpu_torch.engine.propose import _draw_bound
    rng = np.random.default_rng(5)
    pools = [[torch.as_tensor(rng.random((1, _draw_bound(cm_t, cid, p)))
                              .astype(np.float32)) for p in plans]
             for _ in range(SEG)]
    arenas = _rolled(pair, cid, base)
    out = []
    for exact in (True, False):
        eng = tsmc.Engine(cm_t, tsmc.InferenceConfig(
            batch_rows=1, rejuv_frequency=NO_RESAMPLE,
            exact_gibbs_accept=exact), device="cpu")
        assert eng.exact_accept is exact
        out.append(eng._sweep_segment(
            cid, to_torch(arenas, "cpu"), to_torch(pair["params"], "cpu"),
            base,
            torch.Generator().manual_seed(3), SEG, pools=pools)[0])
    changed = 0
    for c in out[0]:
        assert torch.equal(out[0][c]["alive"], out[1][c]["alive"])
        for v in out[0][c]["values"]:
            assert torch.equal(out[0][c]["values"][v],
                               out[1][c]["values"][v]), (c, v)
            changed += int((out[0][c]["values"][v].numpy() !=
                            arenas[c]["values"][v]).sum())
    assert changed > 0, "the segment moved nothing"
