"""Parity of the port's block tracer and batched MH step with pclean_tpu.

On the same arenas, relational state and parameters, the JAX tracer (one
row under vmap) and the port's batched tracer must give the same block
log-normalizers logZ and recorded logits (float32 summed in another order:
rtol 1e-5, atol 1e-5), and — fed the JAX package's own uniform pool
(propose.py:897-904) — the same sampled values and births, exactly. One
batched MH step (per-row self-exclusion, proposal, accept, scatter) must
leave the same arenas. The in-batch birth allocator must place births bit
for bit like pclean_tpu.engine.smc._alloc_births.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.engine import propose as jprop
from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine import smc as jsmc
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.engine import propose as tprop
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from test_torch_host import (JNS, TNS, chain, composed, port_state,
                             scaled_pair, tiny, to_jax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool_key(sub):
    """The key BlockTracer.run -> sample draws its uniform pool from."""
    _k_score, k_sample = jax.random.split(sub)
    k_pool, _k_rest = jax.random.split(k_sample)
    return k_pool


def _plan_subkeys(k, n_plans):
    """Engine._propose's per-plan key chain."""
    subs = []
    for _ in range(n_plans):
        k, sub = jax.random.split(k)
        subs.append(sub)
    return subs


class Pair:
    """One model through both packages, on one shared reachable state."""

    def __init__(self, cm_j, cfg_j, cm_t, cfg_t, seed=0, sweep=False):
        self.cm_j, self.cm_t = cm_j, cm_t
        self.eng_j = jsmc.Engine(cm_j, cfg_j)
        self.eng_t = tsmc.Engine(cm_t, cfg_t, device="cpu")
        arenas, params = port_state(cm_t, cfg_t, seed=seed, sweep=sweep)
        self.aj, self.pj = to_jax(arenas), to_jax(params)
        self.at, self.pt = to_torch(arenas, "cpu"), to_torch(params, "cpu")
        self.rj = jrefresh.refresh(cm_j, self.aj, self.eng_j.obs_dev)
        self.rt = trefresh.refresh(cm_t, self.at, self.eng_t.obs_dev)

    def block(self, cid, plan_idx, slots, keys, cand=None, hists=False):
        cm_j, cm_t = self.cm_j, self.cm_t
        plan_j = cm_j.cls(cid).plans[plan_idx]
        plan_t = cm_t.cls(cid).plans[plan_idx]
        eh_j = eh_t = None
        if hists:
            eh_j = jprop.referrer_histograms(cm_j, cid, self.aj, self.pj,
                                             self.rj, self.eng_j.obs_dev)
            eh_t = tprop.referrer_histograms(cm_t, cid, self.at, self.pt,
                                             self.rt, self.eng_t.obs_dev)
            assert set(eh_j) == set(eh_t) and eh_j
            for k in eh_j:
                np.testing.assert_array_equal(np.asarray(eh_j[k]),
                                              eh_t[k].numpy())
        cj = ct = None
        if cand:
            cj = jprop.build_cand(cm_j, self.rj, cand)
            ct = tprop.build_cand(cm_t, self.rt, cand)
            for tc in cand:
                for i in range(3):
                    np.testing.assert_array_equal(np.asarray(cj[tc][i]),
                                                  ct[tc][i].numpy())
        order = []

        def one(s, k):
            obs_row = self.eng_j._obs_row_slices(cid, s, self.rj)
            tr = jprop.BlockTracer(cm_j, cid, self.aj, self.rj, self.pj,
                                   self.eng_j.obs_dev, obs_row, {}, s,
                                   ext_hists=eh_j, cand=cj)
            logZ, res = tr.run(plan_j, k)
            order[:] = list(tr.records)
            return (logZ, [tr.records[r] for r in tr.records], res.env,
                    [(b.is_new, b.slot, b.values) for b in res.births])

        js = jnp.asarray(slots, jnp.int32)
        logZ_j, recs_j, env_j, births_j = jax.jit(jax.vmap(one))(js, keys)
        n = jprop._draw_bound(cm_j, cid, plan_j)
        assert n == tprop._draw_bound(cm_t, cid, plan_t)
        pool = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(_pool_key(k), (n,)))(keys)) \
            if n else None
        obs_row_t = self.eng_t._obs_row_slices(
            cid, torch.as_tensor(slots).long(), self.rt)
        tr = tprop.BlockTracer(cm_t, cid, self.at, self.rt, self.pt,
                               self.eng_t.obs_dev, obs_row_t, {},
                               torch.as_tensor(slots),
                               ext_hists=eh_t, cand=ct)
        logZ_t, res_t = tr.run(plan_t, pool=None if pool is None
                               else torch.as_tensor(pool))
        np.testing.assert_allclose(np.asarray(logZ_j), logZ_t.numpy(), **TOL)
        assert order == list(tr.records)
        for key, rj in zip(order, recs_j):
            np.testing.assert_allclose(np.asarray(rj),
                                       tr.records[key].numpy(),
                                       err_msg=str(key), **TOL)
        assert set(env_j) == set(res_t.env)
        for v in env_j:
            np.testing.assert_array_equal(np.asarray(env_j[v]),
                                          res_t.env[v].numpy(), err_msg=v)
        assert len(births_j) == len(res_t.births)
        for (nj, sj, vj), bt in zip(births_j, res_t.births):
            np.testing.assert_array_equal(np.asarray(nj), bt.is_new.numpy())
            np.testing.assert_array_equal(np.asarray(sj), bt.slot.numpy())
            assert set(vj) == set(bt.values)
            for v in vj:
                np.testing.assert_array_equal(np.asarray(vj[v]),
                                              bt.values[v].numpy())
        return np.asarray(logZ_j)


@pytest.fixture(scope="module")
def scaled():
    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = scaled_pair()
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


def _rows(n, hi, seed):
    return np.sort(np.random.default_rng(seed).choice(hi, n, replace=False))


@pytest.mark.parametrize("cand", [None, {"Hospital": 64, "County": 64}])
def test_record_block_score_and_sample(scaled, cand):
    slots = _rows(24, 512, 1)
    keys = jax.random.split(jax.random.PRNGKey(5), len(slots))
    scaled.block("Record", 0, slots, keys, cand=cand)


@pytest.mark.parametrize("cid,hists", [("Hospital", True),
                                       ("Hospital", False),
                                       ("County", True)])
def test_latent_block_score_and_sample(scaled, cid, hists):
    cap = scaled.cm_t.layouts[cid].capacity
    live = np.flatnonzero(scaled.rt[cid]["alive"].numpy())
    slots = np.concatenate([live[:12], [cap - 1, cap - 2]])
    keys = jax.random.split(jax.random.PRNGKey(9), len(slots))
    for p in range(len(scaled.cm_t.cls(cid).plans)):
        scaled.block(cid, p, slots, keys, hists=hists)


@pytest.mark.parametrize("which", ["tiny", "chain", "composed"])
def test_toy_model_blocks(which):
    fn = {"tiny": tiny, "chain": chain, "composed": composed}[which]
    cm_j, _ = fn(JNS)
    cm_t, _ = fn(TNS)
    pair = Pair(cm_j, jsmc.InferenceConfig(batch_rows=4, rejuv_frequency=16),
                cm_t, tsmc.InferenceConfig(batch_rows=4, rejuv_frequency=16))
    for cid in cm_t.model.class_order:
        cap = cm_t.layouts[cid].capacity
        slots = np.arange(min(cap, 8))
        keys = jax.random.split(jax.random.PRNGKey(2), len(slots))
        for p in range(len(cm_t.cls(cid).plans)):
            pair.block(cid, p, slots, keys, hists=False)


def test_batched_mh_step_arenas_match(scaled):
    cm_j, cm_t = scaled.cm_j, scaled.cm_t
    for cid, slots in (("Record", np.arange(32, 48)),
                       ("Hospital", np.arange(0, 16))):
        keys = jax.random.split(jax.random.PRNGKey(11), len(slots))
        hj = jprop.referrer_histograms(cm_j, cid, scaled.aj, scaled.pj,
                                       scaled.rj, scaled.eng_j.obs_dev)
        ht = tprop.referrer_histograms(cm_t, cid, scaled.at, scaled.pt,
                                       scaled.rt, scaled.eng_t.obs_dev)
        js = jnp.asarray(slots, jnp.int32)
        env_j, acc_j, bir_j = jax.jit(jax.vmap(
            lambda s, k: jsmc.mh_row_step(scaled.eng_j, cid, scaled.aj,
                                          scaled.rj, scaled.pj, s, k,
                                          s < cm_j.layouts[cid].capacity,
                                          ext_hists=hj)))(js, keys)
        plans = cm_t.cls(cid).plans
        pools = []
        for i, plan in enumerate(cm_j.cls(cid).plans):
            n = jprop._draw_bound(cm_j, cid, plan)

            def pool_row(k, i=i, n=n):
                kp = jax.random.split(k, 3)[0]
                sub = _plan_subkeys(kp, len(plans))[i]
                return jax.random.uniform(_pool_key(sub), (n,))

            pools.append(torch.as_tensor(np.asarray(jax.vmap(pool_row)(keys))))
        ts = torch.as_tensor(slots)
        env_t, acc_t, bir_t = tsmc.mh_row_step(
            scaled.eng_t, cid, scaled.at, scaled.rt, scaled.pt, ts, None,
            ts < cm_t.layouts[cid].capacity, ext_hists=ht, pools=pools)
        np.testing.assert_array_equal(np.asarray(acc_j), acc_t.numpy())
        np.testing.assert_array_equal(np.asarray(bir_j), bir_t.numpy())
        for v in env_j:
            np.testing.assert_array_equal(np.asarray(env_j[v]),
                                          env_t[v].numpy())
        aj2 = jsmc._apply_batch(cm_j, cid, scaled.aj, js, env_j, acc_j,
                                mark_alive=False)
        at2 = tsmc._apply_batch(cm_t, cid, scaled.at, ts, env_t, acc_t,
                                mark_alive=False)
        for c in aj2:
            np.testing.assert_array_equal(np.asarray(aj2[c]["alive"]),
                                          at2[c]["alive"].numpy())
            for v in aj2[c]["values"]:
                np.testing.assert_array_equal(
                    np.asarray(aj2[c]["values"][v]),
                    at2[c]["values"][v].numpy())


def test_alloc_births_bit_for_bit(scaled):
    cm_j, cm_t = scaled.cm_j, scaled.cm_t
    rng = np.random.default_rng(4)
    B = 64
    fk = cm_t.layouts["Record"].fk_vertices[0]
    statics = [(fk, "Hospital", 0)]
    lay = cm_t.layouts["Hospital"]
    # few distinct value tuples, so many births share a group
    base = {tv: rng.integers(0, 5, size=8).astype(np.int32)
            for tv in lay.store}
    pick = rng.integers(0, 8, size=B)
    values = {tv: base[tv][pick] for tv in lay.store}
    is_new = rng.random(B) < 0.7
    alloc = rng.random(B) < 0.9
    env2 = {fk: rng.integers(0, lay.capacity, size=B).astype(np.int32)}
    aj, env_j, of_j = jsmc._alloc_births(
        cm_j, scaled.aj, scaled.rj, {k: jnp.asarray(v) for k, v in env2.items()},
        [{"is_new": jnp.asarray(is_new),
          "values": {k: jnp.asarray(v) for k, v in values.items()}}],
        statics, jnp.asarray(alloc))
    at, env_t, of_t = tsmc._alloc_births(
        cm_t, scaled.at, scaled.rt, to_torch(env2, "cpu"),
        [{"is_new": torch.as_tensor(is_new),
          "values": to_torch(values, "cpu")}],
        statics, torch.as_tensor(alloc))
    np.testing.assert_array_equal(np.asarray(of_j), of_t.numpy())
    np.testing.assert_array_equal(np.asarray(env_j[fk]), env_t[fk].numpy())
    for v in aj["Hospital"]["values"]:
        np.testing.assert_array_equal(np.asarray(aj["Hospital"]["values"][v]),
                                      at["Hospital"]["values"][v].numpy())
