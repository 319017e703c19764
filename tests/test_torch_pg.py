"""Particle Gibbs in the port (pclean_tpu_torch/engine/particles.py, K9
pg_resample) against pclean_tpu.

The port draws with a torch.Generator where the JAX package folds keys, so
the two agree draw for draw only where the port is fed JAX's uniforms (the
collapsed row step, whose one proposal takes an injected pool), and in
distribution elsewhere. The cases:

  (a) the collapsed batched row step is the MH row step: the same env,
      births and deferrals as the port's mh_row_step and as JAX's collapsed
      pg_row_step on the same pool, and MH's accept & (u >= 1/P);
  (b) Engine.log_ml equals the analytic marginal, and JAX's, on a
      latent-free enumerable model on every driver path (collapsed and
      written out, B = 1 and B > 1), and with two observed classes it is
      the last class's, as in JAX; on a two-block model whose particle
      weights differ (K9 resamples between blocks) exp(log_ml) is unbiased;
      on the hospital model each row's log-ML equals JAX's on one state;
  (c) referential integrity, totals and F1 > 0.5 after PG init and sweep
      on the toy model, on every driver path;
  (d) on an audit-passing model every particle weight of a single-block
      class, the retained one included, equals the block's logZ;
  (e) MH mode on a model that fails the exact-Gibbs audit runs the
      two-particle init, and the sweeps' posterior stays within
      tests/test_deferred.py's TV bound;
  (f) K9's plain version against a numpy reference of particles.py:
      131-158, and its launch plan;
  (g) K9 on the card against its plain version: in
      tests/test_torch_kernels.py (`cuda`), which imports no JAX at module
      level and so runs on a card with no JAX installed.
"""
import math

import jax
import numpy as np
import pytest
import torch

from pclean_tpu.engine import particles as jpart
from pclean_tpu.engine import propose as jprop
from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine import smc as jsmc
from pclean_tpu.engine.compile import init_state as j_init
from pclean_tpu_torch import ops
from pclean_tpu_torch.analysis import evaluate_accuracy_device
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.engine import particles as tpart
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.compile import init_state
from test_deferred import brute_posterior
from test_particles import _VALS, _brute_log_pz
from test_torch_host import (CLEAN, DIRTY, JNS, TNS, chain, port_state,
                             tiny, to_jax)
from test_torch_propose import _plan_subkeys, _pool_key

OBS = ["aa", "ab", "bb", "ab", "aa", "bb", "ab", "aa"]
# (batch_rows, collapse_exact_pg, particles): every PG driver path
PATHS = [(1, True, 64), (1, False, 4), (4, True, 64), (4, False, 4)]


def enumerable(ns, obs):
    """tests/test_pg_batched.py's latent-free enumerable model."""
    b = ns.B()
    with b.cls("Row") as c:
        c.choice("x", ns.d.ChooseUniformly(_VALS))
        c.choice("z", ns.d.AddTypos(ns.d.Ref("x")))
    model = b.finish()
    q = ns.Q.build(model, "Row", [("z", "x", "z")])
    return ns.compile(model, [ns.DS(q, {"z": obs})], **ns.kw), q


def two_observed(ns, obs1, obs2):
    """The enumerable model twice over, as two observed classes."""
    b = ns.B()
    for cls in ("Row", "Row2"):
        with b.cls(cls) as c:
            c.choice("x", ns.d.ChooseUniformly(_VALS))
            c.choice("z", ns.d.AddTypos(ns.d.Ref("x")))
    model = b.finish()
    return ns.compile(model, [
        ns.DS(ns.Q.build(model, cls, [("z", "x", "z")]), {"z": obs})
        for cls, obs in (("Row", obs1), ("Row2", obs2))], **ns.kw)


def class_log_pz(cm, cls, obs):
    """log p(z = obs) of one class of two_observed, by enumeration."""
    z_vid = cm.cls(cls).names["z"]
    M = np.asarray(cm.kernels[(cls, z_vid)].M)
    voc = cm.domain(cls, z_vid).vocab
    return float(np.log(sum(
        math.exp(M[voc.encode(obs), voc.encode(v)]) / len(_VALS)
        for v in _VALS)))


def two_block(ns, prob, o1, o2):
    """tests/test_particles.py's two-block model with deferred MaybeSwap
    draws: particle weights differ, so the written-out path resamples."""
    b = ns.B()
    with b.cls("Row") as c:
        for i in ("1", "2"):
            with c.block():
                c.choice("x" + i, ns.d.ChooseUniformly(_VALS))
                c.choice("y" + i, ns.d.MaybeSwap(ns.d.Ref("x" + i), _VALS,
                                                 prob))
                c.choice("z" + i, ns.d.AddTypos(ns.d.Ref("y" + i)))
    model = b.finish()
    q = ns.Q.build(model, "Row", [("z1", "x1", "z1"), ("z2", "x2", "z2")])
    return ns.compile(model, [ns.DS(q, {"z1": [o1], "z2": [o2]})], **ns.kw)


def deferred(ns, prob, obs):
    """tests/test_deferred.py's audit-failing model."""
    b = ns.B()
    with b.cls("Row") as c:
        c.choice("x", ns.d.ChooseUniformly(_VALS))
        c.choice("y", ns.d.MaybeSwap(ns.d.Ref("x"), _VALS, prob))
        c.choice("z", ns.d.AddTypos(ns.d.Ref("y")))
    model = b.finish()
    q = ns.Q.build(model, "Row", [("z", "x", "z")])
    return ns.compile(model, [ns.DS(q, {"z": [obs]})], **ns.kw)


def pg_config(mod, P, batch, collapse, **kw):
    kw.setdefault("rejuv_frequency", 1000)
    return mod.InferenceConfig(num_iters=1, use_mh_instead_of_pg=False,
                               num_particles=P, batch_rows=batch,
                               collapse_exact_pg=collapse, **kw)


def run_port(cm, cfg, seed=1, sweeps=1):
    eng = tsmc.Engine(cm, cfg, device="cpu")
    a, p = init_state(cm, 0, device="cpu")
    a, p, g = eng.initialize(seed, a, p)
    lml = float(eng.log_ml)
    for _ in range(sweeps):
        a, p, g = eng.sweep(g, a, p)
    return eng, a, p, lml


# ---------------------------------------------------------------- (a)


def test_collapsed_row_step_is_the_mh_row_step():
    cm_j, _ = tiny(JNS)
    cm_t, _ = tiny(TNS)
    cfg_t = pg_config(tsmc, 8, 4, True)
    cfg_j = pg_config(jsmc, 8, 4, True, use_scan=True)
    arenas, params = port_state(cm_t, tsmc.InferenceConfig(batch_rows=4))
    at, pt = to_torch(arenas, "cpu"), to_torch(params, "cpu")
    aj, pj = to_jax(arenas), to_jax(params)
    eng_t = tsmc.Engine(cm_t, cfg_t, device="cpu")
    eng_j = jsmc.Engine(cm_j, cfg_j)
    assert eng_t.exact_accept and eng_j.exact_accept
    rt = trefresh.refresh(cm_t, at, eng_t.obs_dev)
    rj = jrefresh.refresh(cm_j, aj, eng_j.obs_dev)
    slots = np.arange(8)
    keys = jax.random.split(jax.random.PRNGKey(3), len(slots))
    P = cfg_t.num_particles
    env_j, acc_j, bir_j, _l = jax.jit(jax.vmap(
        lambda s, k: jpart.pg_row_step(eng_j, "Row", aj, rj, pj, s, k,
                                       s < 8, P, True)))(
        jax.numpy.asarray(slots, jax.numpy.int32), keys)
    plans = cm_j.cls("Row").plans
    pools = []
    for i, plan in enumerate(plans):
        n = jprop._draw_bound(cm_j, "Row", plan)

        def pool_row(k, i=i, n=n):
            # the collapsed step proposes with the second particle key
            sub = _plan_subkeys(jax.random.split(k, P)[1], len(plans))[i]
            return jax.random.uniform(_pool_key(sub), (n,))

        pools.append(torch.as_tensor(np.array(jax.vmap(pool_row)(keys))))
    ts = torch.as_tensor(slots)
    valid = ts < 8
    g = torch.Generator().manual_seed(11)
    env_t, acc_t, bir_t, lml_t = tpart.pg_row_step(
        eng_t, "Row", at, rt, pt, ts, g, valid, P, True, pools=pools)
    u = torch.rand((8,), generator=torch.Generator().manual_seed(11))
    env_m, acc_m, bir_m = tsmc.mh_row_step(eng_t, "Row", at, rt, pt, ts,
                                           None, valid, pools=pools)
    for v in env_m:
        np.testing.assert_array_equal(env_t[v].numpy(), env_m[v].numpy())
        np.testing.assert_array_equal(env_t[v].numpy(),
                                      np.asarray(env_j[v]))
    np.testing.assert_array_equal(bir_t.numpy(), bir_m.numpy())
    np.testing.assert_array_equal(bir_t.numpy(), np.asarray(bir_j))
    np.testing.assert_array_equal(acc_t.numpy(),
                                  (acc_m & (u >= 1.0 / P)).numpy())
    # the proposal weight is the row's log-ML, the sum of block logZs
    _e, _b, w = eng_t._propose("Row", at, trefresh.row_delta(
        cm_t, rt, at, eng_t.obs_dev, "Row", ts, -1, dense=True), pt, ts,
        None, False, pools=pools)
    np.testing.assert_allclose(lml_t.numpy(), w.numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------- (b)


@pytest.fixture(scope="module")
def jax_log_ml():
    """pclean_tpu's log-ML on the enumerable model, by driver path."""
    cm, _q = enumerable(JNS, OBS)
    out = {}
    for batch, collapse, P in PATHS:
        eng = jsmc.Engine(cm, pg_config(jsmc, P, batch, collapse,
                                        rejuv_frequency=10 ** 9,
                                        use_scan=True))
        a, p = j_init(cm, jax.random.PRNGKey(0))
        eng.initialize(jax.random.PRNGKey(1), a, p)
        out[(batch, collapse, P)] = float(eng.log_ml)
    return out, sum(_brute_log_pz(cm, "z", False, 0.0, o) for o in OBS)


@pytest.mark.parametrize("batch,collapse,P", PATHS)
def test_log_ml_is_analytic_on_every_driver_path(jax_log_ml, batch,
                                                 collapse, P):
    want_j, want = jax_log_ml
    cm, _q = enumerable(TNS, OBS)
    eng, _a, _p, lml = run_port(cm, pg_config(
        tsmc, P, batch, collapse, rejuv_frequency=10 ** 9), sweeps=0)
    assert eng.exact_accept
    np.testing.assert_allclose(lml, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lml, want_j[(batch, collapse, P)], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("batch,collapse,P", PATHS)
def test_log_ml_restarts_at_each_observed_class(batch, collapse, P):
    """With two observed classes Engine.log_ml ends as the last class's
    log-ML, as in pclean_tpu (smc.py:1855-1881): the analytic marginal of
    Row2's rows alone, and JAX's value on the same driver path."""
    obs2 = ["bb", "ab", "bb"]
    cm_j = two_observed(JNS, OBS, obs2)
    eng_j = jsmc.Engine(cm_j, pg_config(jsmc, P, batch, collapse,
                                        rejuv_frequency=10 ** 9,
                                        use_scan=True))
    a, p = j_init(cm_j, jax.random.PRNGKey(0))
    eng_j.initialize(jax.random.PRNGKey(1), a, p)
    want = sum(class_log_pz(cm_j, "Row2", o) for o in obs2)
    cm = two_observed(TNS, OBS, obs2)
    assert [s.class_id for s in cm.obs_specs] == ["Row", "Row2"]
    eng, _a, _p, lml = run_port(cm, pg_config(
        tsmc, P, batch, collapse, rejuv_frequency=10 ** 9), sweeps=0)
    assert eng.exact_accept
    np.testing.assert_allclose(lml, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lml, float(eng_j.log_ml), rtol=0, atol=1e-4)


def test_log_ml_unbiased_on_two_block_model():
    """Weights differ across particles (deferred MaybeSwap draws), so the
    written-out path runs K9 between the blocks and at the end: the mean of
    exp(log_ml - log p(z)) over seeds is 1 within Monte-Carlo error, as
    tests/test_particles.py holds the JAX package to."""
    prob = 0.9
    cm_j = two_block(JNS, prob, "aa", "bb")
    want = _brute_log_pz(cm_j, "z1", True, prob, "aa") \
        + _brute_log_pz(cm_j, "z2", True, prob, "bb")
    cm = two_block(TNS, prob, "aa", "bb")
    assert len(cm.cls("Row").plans) == 2 and not cm.exact_gibbs_ok
    eng = tsmc.Engine(cm, pg_config(tsmc, 8, 1, True,
                                    rejuv_frequency=10 ** 9), device="cpu")
    ests = []
    ops.reset_counts()
    for seed in range(48):
        a, p = init_state(cm, 0, device="cpu")
        eng.initialize(1000 + seed, a, p)
        ests.append(float(eng.log_ml))
    r = np.exp(np.asarray(ests) - want)
    se = r.std() / np.sqrt(len(r))
    assert abs(r.mean() - 1.0) < max(3.5 * se, 0.15), (r.mean(), se)


@pytest.mark.parametrize("collapse", [True, False])
def test_hospital_row_log_ml_matches_jax(collapse):
    """The hospital model (two Record blocks, the composed stateavg term):
    on one shared state, 16 Record rows each excluded from the snapshot
    and proposed fresh with 8 particles give the same log-ML in both
    packages, collapsed and written out. The posteriors there are
    concentrated, so the estimate is the same number whatever the draws
    (checked over two of each package's draws)."""
    import dataclasses

    from test_torch_hospital import hospital_pair
    from test_torch_propose import Pair

    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = hospital_pair()
    pair = Pair(cm_j, cfg_j, cm_t, cfg_t)
    slots = np.arange(0, 240, 15)
    ts = torch.as_tensor(slots)
    eng_t = tsmc.Engine(cm_t, dataclasses.replace(
        cfg_t, use_mh_instead_of_pg=False, num_particles=8,
        collapse_exact_pg=collapse), device="cpu")
    eng_j = jsmc.Engine(cm_j, dataclasses.replace(
        cfg_j, use_mh_instead_of_pg=False, num_particles=8,
        collapse_exact_pg=collapse))
    relx = trefresh.row_delta(cm_t, pair.rt, pair.at, eng_t.obs_dev,
                              "Record", ts, -1, dense=True)

    def one(s, k):
        rx = jrefresh.row_delta(cm_j, pair.rj, pair.aj, eng_j.obs_dev,
                                "Record", s, -1, dense=True)
        return jpart.propose_row_pg(eng_j, "Record", pair.aj, rx, pair.pj,
                                    s, jax.random.split(k, 8),
                                    retained=False, matmul_obs=True)[2]

    fj = jax.jit(jax.vmap(one))
    for seed in range(2):
        lml_t = tpart.propose_row_pg(
            eng_t, "Record", pair.at, relx, pair.pt, ts,
            torch.Generator().manual_seed(seed), 8, False)[2]
        lml_j = fj(jax.numpy.asarray(slots, jax.numpy.int32),
                   jax.random.split(jax.random.PRNGKey(seed), len(slots)))
        np.testing.assert_allclose(lml_t.numpy(), np.asarray(lml_j),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("batch,collapse,P", PATHS)
def test_invariants_and_f1_after_pg_init_and_sweep(batch, collapse, P):
    cm, q = tiny(TNS)
    eng, a, p, lml = run_port(cm, pg_config(tsmc, P, batch, collapse))
    assert math.isfinite(lml) and lml < 0
    rel = trefresh.refresh(cm, a, eng.obs_dev)
    assert int(rel["Obj"]["total"]) == len(DIRTY)
    fk = cm.layouts["Row"].fk_vertices[0]
    t = a["Row"]["values"][fk].long()
    assert bool(rel["Obj"]["alive"][t].all())
    assert int(rel["Obj"]["nrows"]) == len(set(t.tolist()))
    f1 = evaluate_accuracy_device(cm, a, p, {"name": DIRTY},
                                  {"name": CLEAN}, q)["f1"]
    assert f1 > 0.5, f1


def test_chain_model_pg_sweep_keeps_the_relational_state():
    """Three classes with slot chains (Record -> Hospital -> County): after
    a written-out PG init and sweep, refresh's totals match the arenas."""
    cm, _q = chain(TNS)
    eng, a, _p, lml = run_port(cm, pg_config(tsmc, 4, 4, False))
    assert math.isfinite(lml)
    rel = trefresh.refresh(cm, a, eng.obs_dev)
    n = cm.layouts["Record"].capacity
    assert int(rel["Hospital"]["total"]) == n
    assert int(rel["County"]["total"]) == int(rel["Hospital"]["nrows"])


# ---------------------------------------------------------------- (d)


@pytest.mark.parametrize("which,cid", [("tiny", "Row"), ("chain", "County")])
def test_every_particle_weight_is_the_block_logz(which, cid):
    """VERDICT.md:132-147: on an audit-passing model the proposal is the
    block's conditional posterior, so after a single-block class's block
    every particle's weight, the retained particle's too, is its logZ."""
    cm, _q = {"tiny": tiny, "chain": chain}[which](TNS)
    assert len(cm.cls(cid).plans) == 1 and cm.exact_gibbs_ok
    cfg = pg_config(tsmc, 16, 4, False)
    arenas, params = port_state(cm, tsmc.InferenceConfig(batch_rows=4))
    a, p = to_torch(arenas, "cpu"), to_torch(params, "cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    rel = trefresh.refresh(cm, a, eng.obs_dev)
    ts = torch.arange(min(8, cm.layouts[cid].capacity))
    g = torch.Generator().manual_seed(2)
    # the rows excluded from the snapshot as pg_row_step excludes them
    relx, _alive = tsmc.exclude_rows(eng, cid, a, rel, ts, ts >= 0)
    _envs, _births, ws, _lml = tpart.smc_particles(eng, cid, a, relx, p, ts,
                                                   g, 16, True)
    _e, _b, logz = eng._propose(cid, a, relx, p, ts, g, False)
    np.testing.assert_allclose(ws.numpy(),
                               logz[:, None].expand_as(ws).numpy(),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------- (e)


def test_two_particle_mh_init_on_an_audit_failing_model():
    prob, obs = 0.3, "ab"
    cm_j = deferred(JNS, prob, obs)
    want = brute_posterior(cm_j, prob, obs)
    cm = deferred(TNS, prob, obs)
    eng = tsmc.Engine(cm, tsmc.InferenceConfig(num_iters=1,
                                               rejuv_frequency=10 ** 9),
                      device="cpu")
    assert not eng.exact_accept and eng.config.num_particles == 2
    ops.reset_counts()
    a, p = init_state(cm, 5, device="cpu")
    a, p, g = eng.initialize(6, a, p)
    # the two fresh particles went through K9's final selection (the plain
    # version here) and gave a finite log-ML
    assert math.isfinite(float(eng.log_ml)) and float(eng.log_ml) < 0
    x_vid = cm.cls("Row").names["x"]
    codes = [cm.domain("Row", x_vid).vocab.encode(v) for v in _VALS]
    counts = np.zeros(len(_VALS))
    for _ in range(800):
        a, p, g = eng.sweep(g, a, p)
        counts[codes.index(int(a["Row"]["values"][x_vid][0]))] += 1
    got = counts / counts.sum()
    tv = 0.5 * np.abs(got - want).sum()
    assert tv < 0.12, (got, want, tv)


# ---------------------------------------------------------------- (f)


def _np_resample(ws, u, retained):
    """particles.py:131-144 in numpy (float64), with the uniforms' inverse
    CDF in place of jax.random.categorical; also returns each pick's
    distance from the nearest CDF boundary."""
    R, P = ws.shape
    m = ws.max(-1, keepdims=True)
    e = np.exp(ws - m)
    lse = np.log(e.sum(-1)) + m[:, 0]
    lw = ws - lse[:, None]
    ess = np.exp(-np.log(np.exp(2 * lw).sum(-1)))
    c = np.cumsum(e, -1)
    ub = (1.0 - u) * c[:, -1:]
    idx = np.stack([np.searchsorted(c[r], ub[r]) for r in range(R)])
    idx = np.minimum(idx, P - 1)
    gap = np.min(np.abs(c[:, None, :] - ub[:, :, None]), -1) / c[:, -1:]
    if retained:
        idx[:, 0] = 0
        gap[:, 0] = 1.0
    do = ess < P / 2.0
    sel = np.where(do[:, None], idx, np.arange(P)[None]) \
        + np.arange(R)[:, None] * P
    return (sel, np.where(do[:, None], 0.0, ws),
            np.where(do, lse - np.log(P), 0.0), ess, gap)


@pytest.mark.parametrize("P", [2, 16, 1024])
@pytest.mark.parametrize("retained", [False, True])
def test_k9_plain_matches_numpy_particles(P, retained):
    rng = np.random.default_rng(P + retained)
    R = 64 if P < 1024 else 8
    # half the rows spread (ESS < P / 2: resample), half flat (keep)
    scale = np.where(np.arange(R) % 2 == 0, 6.0, 0.05)[:, None]
    ws = (rng.normal(size=(R, P)) * scale - 30.0).astype(np.float32)
    u = rng.random((R, P)).astype(np.float32)
    sel, ws_out, lml = ops.pg_resample(torch.as_tensor(ws),
                                       torch.as_tensor(u), "resample",
                                       retained)
    s_np, w_np, l_np, ess, gap = _np_resample(ws.astype(np.float64),
                                              u.astype(np.float64), retained)
    near = np.abs(ess - P / 2.0) <= 1e-6 * P
    do = ~near & (ess < P / 2.0)
    # ESS >= 1, so two particles never resample (ESS < P / 2 = 1)
    assert do.any() == (P > 2) and (~do & ~near).any()
    rows = ~near
    ok = (gap >= 1e-6) & rows[:, None]
    np.testing.assert_array_equal(sel.numpy()[ok], s_np[ok])
    assert (sel.numpy()[rows] // P == np.arange(R)[rows, None]).all()
    if retained:
        np.testing.assert_array_equal(sel.numpy()[:, 0], np.arange(R) * P)
    tol = 1e-6 * np.maximum(1.0, np.abs(ws).max(-1))
    assert (np.abs(ws_out.numpy() - w_np)[rows] <= tol[rows, None]).all()
    assert (np.abs(lml.numpy() - l_np)[rows] <= tol[rows]).all()
    # final mode: one draw per row over the flattened axis
    uf = rng.random(R).astype(np.float32)
    j, lf = ops.pg_resample(torch.as_tensor(ws), torch.as_tensor(uf),
                            "final")
    m = ws.astype(np.float64).max(-1, keepdims=True)
    e = np.exp(ws - m)
    c = np.cumsum(e, -1)
    ub = (1.0 - uf[:, None]) * c[:, -1:]
    jj = np.array([np.searchsorted(c[r], ub[r, 0]) for r in range(R)])
    far = np.min(np.abs(c - ub), -1) / c[:, -1] >= 1e-6
    np.testing.assert_array_equal(j.numpy()[far],
                                  (np.arange(R) * P + jj)[far])
    lse = np.log(e.sum(-1)) + m[:, 0]
    assert (np.abs(lf.numpy() - (lse - np.log(P))) <= tol).all()


def test_k9_plan_geometry():
    assert ops.pg_resample_plan(64, 16) == dict(threads=256, smem=0,
                                                grid=4, group=16)
    assert ops.pg_resample_plan(1, 1024) == dict(threads=256, smem=12288,
                                                 grid=1, group=0)
    assert ops.pg_resample_plan(4096, 2) == dict(threads=256, smem=0,
                                                 grid=32, group=2)
    assert ops.pg_resample_plan(1, 16384)["smem"] == 196608
    for bad in ((1, 0), (1, 16385), (-1, 4)):
        with pytest.raises(ValueError):
            ops.pg_resample_plan(*bad)
    with pytest.raises(ValueError):
        ops.pg_resample(torch.zeros(2, 4), torch.zeros(2, 4), "sum")
