"""Parity of the port's rents path with pclean_tpu.

Both packages build experiments/rents.py's model (the JAX side through that
file's build_model, the port through pclean_tpu_torch/workloads/rents.py)
from the same pclean_tpu_torch.workloads.rents.synth tables at a small size
(1,000 rows, 12 states, 40 counties, B = 16) and are held equal:

  * compile: node lists, plans, layouts and capacities, param meta (the
    indexed Mean's sites and index count), the exact-Gibbs audit and the
    referrer bounds;
  * _GaussianK.obs_logdensity under both units: rtol 1e-6;
  * the Gaussian sufficient statistics (K4's plain version) against JAX's
    referrer_histograms tuple on the same arenas: n exact, the sums rtol
    1e-5;
  * County-block logZ and records through the closed form (K5's plain
    version): rtol 1e-5 and, per row, atol |sum_c szz| * 2^-22 / (2 *
    150^2) + 1e-5 (the closed form subtracts sums of order n * z^2 in f32,
    summed in another order); the port's closed form against its own dense
    per-referrer path at the same tolerance;
  * Obs- and County-block sampled values fed the JAX package's uniform
    pool: bit-equal;
  * the Mean recompute: counts equal, sums rtol 1e-6, and the posterior
    mean and variance such that JAX's draw is mean + sqrt(var) * its own
    normal: rtol 1e-6;
  * a toy model with AddNoise on a plain and on an indexed Mean and a
    TransformedGaussian with a static mean and transform: param meta,
    Obs- and County-block logZ, records and samples (the County block sums
    its option-independent Gaussian external over the referrers once), and
    both Means' recompute;
  * the whole slice: F1 over 3 seeds within the JAX package's own 3-seed
    range +- 0.02, at 2,000 rows (at 1,000 one seed's F1 spreads over
    0.86-0.92 in both packages, so a 3-seed range test flips on noise).

The JAX side takes the segmented batched drivers (fused_dispatch_rows=0),
the only ones the port has. The port alone also runs rents with 5% missing
rents (which pclean_tpu's tracer cannot sample, see synth).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.analysis import evaluate_accuracy_device as j_eval
from pclean_tpu.engine import compile as jcompile
from pclean_tpu.engine import gibbs_params as jgp
from pclean_tpu.engine import propose as jprop
from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine import smc as jsmc
from pclean_tpu.model.query import ObservedDataset as JDS
from pclean_tpu.model.query import Query as JQuery
from pclean_tpu_torch import ops
from pclean_tpu_torch.analysis import (evaluate_accuracy,
                                       evaluate_accuracy_device)
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.engine import gibbs_params as tgp
from pclean_tpu_torch.engine import propose as tprop
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.compile import init_state
from pclean_tpu_torch.workloads import rents as trents
from test_torch_host import _node_sig, _plan_sig, port_state, to_jax
from test_torch_propose import _pool_key

# experiments/rents.py, on sys.path through test_torch_host
import rents as jrents  # noqa: E402

SMALL = dict(rows=1000, states=12, counties=40)
B = 16
STD = 150.0
F1_ROWS = 2000


def rents_pair(rows=SMALL["rows"], missing=0.0):
    """The rents model through both packages on the same synth tables."""
    kw = dict(SMALL, rows=rows)
    dirty, clean = trents.synth(**kw, missing=missing)
    model = jrents.build_model(*trents.model_inputs(dirty))
    q_j = JQuery.build(model, "Obs", jrents.QUERY_CLAUSES)
    cm_j = jcompile.compile_model(model, [JDS(q_j, dirty)],
                                  capacities=jrents.CAPACITIES)
    cfg_j = jsmc.InferenceConfig(num_iters=1, batch_rows=B,
                                 rejuv_frequency=500,
                                 use_mh_instead_of_pg=True,
                                 fused_dispatch_rows=0)
    cm_t, cfg_t, dirty_t, clean_t, q_t, _ = trents.setup(
        **kw, missing=missing, batch=B, device="cpu")
    assert dirty == dirty_t and clean == clean_t
    return (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean


class RentsState:
    """Both compiled models on one reachable state (the port's init)."""

    def __init__(self, sweep=False):
        (self.cm_j, self.cfg_j, self.q_j), (self.cm_t, self.cfg_t,
                                            self.q_t), \
            self.dirty, self.clean = rents_pair()
        self.eng_j = jsmc.Engine(self.cm_j, self.cfg_j)
        self.eng_t = tsmc.Engine(self.cm_t, self.cfg_t, device="cpu")
        arenas, params = port_state(self.cm_t, self.cfg_t, sweep=sweep)
        self.aj, self.pj = to_jax(arenas), to_jax(params)
        self.at, self.pt = to_torch(arenas, "cpu"), to_torch(params, "cpu")
        self.rj = jrefresh.refresh(self.cm_j, self.aj, self.eng_j.obs_dev)
        self.rt = trefresh.refresh(self.cm_t, self.at, self.eng_t.obs_dev)

    def hists(self, cid):
        hj = jprop.referrer_histograms(self.cm_j, cid, self.aj, self.pj,
                                       self.rj, self.eng_j.obs_dev)
        ht = tprop.referrer_histograms(self.cm_t, cid, self.at, self.pt,
                                       self.rt, self.eng_t.obs_dev)
        return hj, ht

    def port_block(self, cid, slots, pool, hists):
        tr = tprop.BlockTracer(
            self.cm_t, cid, self.at, self.rt, self.pt, self.eng_t.obs_dev,
            self.eng_t._obs_row_slices(cid, torch.as_tensor(slots).long(),
                                       self.rt),
            {}, torch.as_tensor(slots), ext_hists=hists)
        logZ, res = tr.run(self.cm_t.cls(cid).plans[0], pool=pool)
        return logZ, res, tr

    def jax_block(self, cid, slots, keys, hists):
        plan = self.cm_j.cls(cid).plans[0]
        order = []

        def one(s, k):
            obs_row = self.eng_j._obs_row_slices(cid, s, self.rj)
            tr = jprop.BlockTracer(self.cm_j, cid, self.aj, self.rj, self.pj,
                                   self.eng_j.obs_dev, obs_row, {}, s,
                                   ext_hists=hists)
            logZ, res = tr.run(plan, k)
            order[:] = list(tr.records)
            return logZ, [tr.records[r] for r in tr.records], res.env

        logZ, recs, env = jax.jit(jax.vmap(one))(
            jnp.asarray(slots, jnp.int32), keys)
        n = jprop._draw_bound(self.cm_j, cid, plan)
        pool = torch.as_tensor(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(_pool_key(k), (n,)))(keys))) \
            if n else None
        return np.asarray(logZ), dict(zip(order, recs)), env, pool


@pytest.fixture(scope="module")
def st():
    return RentsState()


def _atol_rows(gauss, slots):
    """Per-row atol of the closed form: |sum_c szz[slot]| * 2^-22 /
    (2 std^2) + 1e-5."""
    szz = np.asarray(gauss[3])[np.minimum(slots, len(gauss[3]) - 1)]
    return np.abs(szz.sum(-1)) * 2.0 ** -22 / (2 * STD * STD) + 1e-5


def _close(a, b, atol_rows, what):
    a, b = np.asarray(a), np.asarray(b)
    atol = atol_rows.reshape((-1,) + (1,) * (a.ndim - 1))
    with np.errstate(invalid="ignore"):
        bad = (a != b) & ~(np.abs(a - b) <= atol + 1e-5 * np.abs(b))
    assert not bad.any(), (what, np.abs(a - b)[bad][:5], atol.ravel()[:3])


def _gauss_key(h):
    (k, v), = [(k, v) for k, v in h.items() if isinstance(v, tuple)]
    return k, v


# ----------------------------------------------------------------- compile


@pytest.mark.parametrize("rows", [1000, 4000])
def test_rents_compile_parity(rows):
    (cm_j, _cj, q_j), (cm_t, _ct, q_t), _d, _c = rents_pair(rows=rows)
    assert cm_j.model.class_order == cm_t.model.class_order
    for cid in cm_j.model.class_order:
        cj, ct = cm_j.cls(cid), cm_t.cls(cid)
        assert [_node_sig(n) for n in cj.nodes] == \
            [_node_sig(n) for n in ct.nodes], cid
        assert cj.blocks == ct.blocks and cj.hash_keys == ct.hash_keys
        assert [_plan_sig(p) for p in cj.plans] == \
            [_plan_sig(p) for p in ct.plans]
        assert cj.incoming_references == ct.incoming_references
        lj, lt = cm_j.layouts[cid], cm_t.layouts[cid]
        assert (lj.capacity, lj.observed, lj.store, lj.fk_vertices) == \
            (lt.capacity, lt.observed, lt.store, lt.fk_vertices)
    assert (q_j.cleanmap, q_j.obsmap) == (q_t.cleanmap, q_t.obsmap)
    assert set(cm_j.domains) == set(cm_t.domains)
    for k, dj in cm_j.domains.items():
        dt = cm_t.domains[k]
        assert (dj is None) == (dt is None)
        if dj is not None:
            assert dj.kind == dt.kind
            vj = dj.vocab.values if dj.vocab else None
            vt = dt.vocab.values if dt.vocab else None
            # the unit vocabulary holds each package's Transformation objects
            assert [type(v).__name__ if callable(getattr(v, "deriv", None))
                    else v for v in vj or []] == \
                [type(v).__name__ if callable(getattr(v, "deriv", None))
                 else v for v in vt or []], k
    for k, kj in cm_j.kernels.items():
        kt = cm_t.kernels[k]
        assert type(kj).__name__ == type(kt).__name__
        assert (kj.V, kj.enumerable) == (kt.V, kt.enumerable)
    for k, mj in cm_j.param_meta.items():
        mt = cm_t.param_meta[k]
        assert type(mj["spec"]).__name__ == type(mt["spec"]).__name__
        assert vars(mj["spec"]) == vars(mt["spec"])
        assert {x: y for x, y in mj.items() if x != "spec"} == \
            {x: y for x, y in mt.items() if x != "spec"}
    mean_meta = cm_t.param_meta[("Obs", 0)]
    assert mean_meta["sites"] and mean_meta["num_indices"] > 1
    assert cm_j.exact_gibbs_ok is True and cm_t.exact_gibbs_ok is True
    assert cm_j.ref_bounds == cm_t.ref_bounds
    if rows >= 4000:
        assert cm_t.ref_bounds, "expected a referrer bound on the rents shape"
    for sj, stt in zip(cm_j.obs_specs, cm_t.obs_specs):
        for vid in sj.columns:
            for i in range(2):
                assert np.array_equal(sj.columns[vid][i], stt.columns[vid][i])


# ----------------------------------------------------------------- kernels


def test_gaussian_obs_logdensity_both_units(st):
    rent = st.cm_t.cls("Obs").names["rent"]
    kj, kt = st.cm_j.kernels[("Obs", rent)], st.cm_t.kernels[("Obs", rent)]
    rng = np.random.default_rng(0)
    n = 64
    obs = np.concatenate([rng.uniform(300, 3200, n // 2),
                          rng.uniform(0.3, 3.2, n // 2)]).astype(np.float32)
    mean = rng.uniform(500, 3000, n).astype(np.float32)
    for unit in (0, 1):
        units = np.full(n, unit, np.int32)
        vals = {kt.mean_vid: mean, kt.transform_vid: units}

        class JCtx:
            def value(self, v):
                return jnp.asarray(vals[v])

        class TCtx:
            def value(self, v):
                return torch.as_tensor(vals[v])

        lj = np.asarray(kj.obs_logdensity(JCtx(), jnp.asarray(obs)))
        lt = kt.obs_logdensity(TCtx(), torch.as_tensor(obs)).numpy()
        np.testing.assert_allclose(lt, lj, rtol=1e-6)


def test_gauss_stats_match_jax(st):
    hj, ht = st.hists("County")
    kj, gj = _gauss_key(hj)
    kt, gt = _gauss_key(ht)
    assert kj == kt and gj[0] == gt[0] == "gauss"
    np.testing.assert_array_equal(np.asarray(gj[1]), gt[1].numpy())
    for i in (2, 3, 4):
        np.testing.assert_allclose(gt[i].numpy(), np.asarray(gj[i]),
                                   rtol=1e-5, atol=1e-6)
    assert float(gt[1].sum()) > 0
    for k in hj:
        if k != kj:
            np.testing.assert_array_equal(np.asarray(hj[k]), ht[k].numpy())


def _county_slots(st):
    cap = st.cm_t.layouts["County"].capacity
    live = np.flatnonzero(st.rt["County"]["alive"].numpy())
    return np.concatenate([live[:B - 2], [cap - 1, cap - 2]])


def test_county_block_closed_form_matches_jax(st):
    slots = _county_slots(st)
    keys = jax.random.split(jax.random.PRNGKey(9), len(slots))
    hj, ht = st.hists("County")
    _k, gauss = _gauss_key(ht)
    atol = _atol_rows(gauss, slots)
    logZ_j, recs_j, env_j, pool = st.jax_block("County", slots, keys, hj)
    launches = ops.LAUNCHES["gauss_ext_term"]
    logZ_t, res, tr = st.port_block("County", slots, pool, ht)
    assert ops.LAUNCHES["gauss_ext_term"] == launches  # CPU: plain version
    _close(logZ_t.numpy(), logZ_j, atol, "logZ")
    assert list(recs_j) == list(tr.records)
    for key, rj in recs_j.items():
        _close(tr.records[key].numpy(), rj, atol, key)
    assert set(env_j) == set(res.env)
    for v in env_j:
        np.testing.assert_array_equal(np.asarray(env_j[v]),
                                      res.env[v].numpy(), err_msg=str(v))


def test_county_closed_form_matches_dense_path(st):
    slots = _county_slots(st)
    _hj, ht = st.hists("County")
    _k, gauss = _gauss_key(ht)
    pool = torch.rand((len(slots), 8), generator=torch.Generator()
                      .manual_seed(3))
    n = tprop._draw_bound(st.cm_t, "County", st.cm_t.cls("County").plans[0])
    pool = pool[:, :n]
    with mock.patch.object(ops, "gauss_ext_term_plain",
                           wraps=ops.gauss_ext_term_plain) as spy:
        closed, res_c, _t = st.port_block("County", slots, pool, ht)
        assert spy.call_count == 1   # the closed form: K5's plain version
        dense_h = {k: v for k, v in ht.items() if not isinstance(v, tuple)}
        dense, res_d, _t = st.port_block("County", slots, pool, dense_h)
        assert spy.call_count == 1   # the dense per-referrer path
    _close(closed.numpy(), dense.numpy(), _atol_rows(gauss, slots),
           "closed vs dense")
    for v in res_c.env:
        assert torch.equal(res_c.env[v], res_d.env[v]), v


def test_obs_block_matches_jax(st):
    slots = np.sort(np.random.default_rng(1).choice(1000, B, replace=False))
    keys = jax.random.split(jax.random.PRNGKey(5), len(slots))
    logZ_j, recs_j, env_j, pool = st.jax_block("Obs", slots, keys, None)
    logZ_t, res, tr = st.port_block("Obs", slots, pool, None)
    np.testing.assert_allclose(logZ_t.numpy(), logZ_j, rtol=1e-5, atol=1e-5)
    assert list(recs_j) == list(tr.records)
    for key, rj in recs_j.items():
        np.testing.assert_allclose(tr.records[key].numpy(), np.asarray(rj),
                                   rtol=1e-5, atol=1e-5, err_msg=str(key))
    assert set(env_j) == set(res.env)
    for v in env_j:
        np.testing.assert_array_equal(np.asarray(env_j[v]),
                                      res.env[v].numpy(), err_msg=str(v))


def test_mean_recompute_matches_jax(st):
    key = jax.random.PRNGKey(4)
    sj = jgp.recompute_and_resample(st.cm_j, "Obs", 0, st.aj, st.rj, st.pj,
                                    st.eng_j.obs_dev, key)
    stt = tgp.recompute_and_resample(st.cm_t, "Obs", 0, st.at, st.rt, st.pt,
                                     st.eng_t.obs_dev,
                                     torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.asarray(sj["counts"]),
                                  stt["counts"].numpy())
    np.testing.assert_allclose(stt["sums"].numpy(), np.asarray(sj["sums"]),
                               rtol=1e-6, atol=1e-3)
    assert int(stt["counts"].sum()) == int(st.at["Obs"]["alive"].sum())
    from pclean_tpu_torch.dists.params import mean_posterior

    meta = st.cm_t.param_meta[("Obs", 0)]
    mean, var = mean_posterior(stt, meta["spec"], [s for _w, s in
                                                   meta["sites"]])
    eps = np.asarray(jax.random.normal(key, mean.shape))
    want = mean.numpy() + np.sqrt(var.numpy()) * eps
    np.testing.assert_allclose(want, np.asarray(sj["value"]), rtol=1e-6,
                               atol=1e-3)


def test_gauss_kernel_plain_versions_on_edges():
    """K4's and K5's plain versions on the edges the card tests also take:
    dead referrers, out-of-range slots and groups, C = 1, an empty group,
    one crowded slot; K5 at B = 1."""
    g = torch.Generator().manual_seed(0)
    R, cap, C = 500, 16, 3
    t = torch.randint(-2, cap + 2, (R,), generator=g, dtype=torch.int32)
    rv = torch.randint(-1, C + 1, (R,), generator=g, dtype=torch.int32)
    w = torch.rand((R,), generator=g) < 0.7
    z = torch.randn((R,), generator=g) * 500 + 1500
    ld = torch.randn((R,), generator=g)
    n, sz, szz, pre0 = ops.gauss_suffstats(t, rv, w, z, ld, -5.0, cap, C)
    for s in range(cap):
        m = w & (t == s)
        assert abs(float(pre0[s]) - float((-5.0 - ld[m]).sum())) < 1e-3
        for c in range(C):
            mc = m & (rv == c)
            assert int(n[s, c]) == int(mc.sum())
            assert abs(float(sz[s, c]) - float(z[mc].sum())) < 1e-2
    n0, *_ = ops.gauss_suffstats(t, rv, torch.zeros_like(w), z, ld, 0.0,
                                 cap, C)
    assert float(n0.abs().sum()) == 0.0
    values = torch.randn((40,), generator=g) * 1000 + 1500
    tbl = torch.randint(0, 40, (9, C), generator=g, dtype=torch.int32)
    idx = torch.randint(0, 9, (1, 7), generator=g, dtype=torch.int32)
    slot = torch.tensor([3], dtype=torch.int32)
    out = ops.gauss_ext_term(values, tbl, idx, slot, n, sz, szz, pre0, -0.1)
    mu = values[tbl[idx[0].long()].long()]                        # [7, C]
    want = -0.1 * (szz[3].sum() - 2 * (mu * sz[3]).sum(-1)
                   + (mu * mu * n[3]).sum(-1)) + pre0[3]
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------- end to end


def test_accuracy_scores_float_column_as_jax(st):
    """On the same state both packages score every column alike, the float
    Monthly Rent (corrected against the observed rent) included."""
    want = j_eval(st.cm_j, st.aj, st.pj, st.dirty, st.clean, st.q_j)
    got = evaluate_accuracy_device(st.cm_t, st.at, st.pt, st.dirty, st.clean,
                                   st.q_t)
    assert got == want
    rent_only = {"Monthly Rent": st.clean["Monthly Rent"]}
    assert evaluate_accuracy_device(st.cm_t, st.at, st.pt, st.dirty,
                                    rent_only, st.q_t) == \
        j_eval(st.cm_j, st.aj, st.pj, st.dirty, rent_only, st.q_j)


def test_rents_f1_within_jax_seed_spread():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = rents_pair(
        rows=F1_ROWS)
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
        rel = trefresh.refresh(cm_t, a, eng_t.obs_dev)
        assert int(rel["County"]["total"]) == F1_ROWS
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


def test_rents_with_missing_rents_end_to_end():
    """5% missing rents: prior draws of the unobserved TransformedGaussian
    under the enumerated unit, imputed cells scored; device and host
    evaluation agree."""
    cm, cfg, dirty, clean, q, _ = trents.setup(**SMALL, missing=0.05,
                                               batch=B, device="cpu")
    a, p = init_state(cm, 0, device="cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    a, p, g = eng.initialize(1, a, p)
    a, p, g = eng.run(g, a, p)
    dev = evaluate_accuracy_device(cm, a, p, dirty, clean, q)
    assert dev == evaluate_accuracy(cm, a, p, dirty, clean, q)
    assert dev["imputed"] == sum(v is None for v in dirty["Monthly Rent"])
    rent = a["Obs"]["values"][cm.cls("Obs").names["rent"]]
    assert bool(torch.isfinite(rent).all())
    assert dev["f1"] > 0.5, dev


def _gauss_toy(ns):
    """AddNoise on a plain Mean and on an indexed Mean looked up by the
    county's Unmodeled key alone (no group argument: the County block scores
    that external densely, with no enumeration axis, so it is presummed over
    the referrers), and a TransformedGaussian with a static mean and a static
    Transformation."""
    rng = np.random.default_rng(3)
    n = 60
    keys = [f"k{i % 6}" for i in range(n)]
    data = {"key": keys, "state": [["al", "ak"][i % 6 % 2] for i in range(n)],
            "x": [float(10 * (i % 6) + rng.normal()) for i in range(n)],
            "y": [float(5 + 2 * rng.normal()) for _ in range(n)],
            "w": [float(10 * (3 + 1.5 * rng.normal())) for _ in range(n)]}
    tenths = ns.d.Transformation(lambda v: v / 10.0, lambda v: v * 10.0,
                                 lambda v: 0.1)
    b = ns.B()
    with b.cls("County") as c:
        c.choice("key", ns.d.Unmodeled())
        c.guaranteed("key")
        c.choice("state", ns.d.ChooseUniformly(["al", "ak"]))
    with b.cls("Obs") as c:
        c.learned("mu", ns.d.Mean(20.0, 20.0), indexed=True)
        c.learned("mu0", ns.d.Mean(5.0, 2.0))
        c.fk("county", "County")
        c.param_lookup("x_mean", "mu", key="county.key")
        c.choice("x", ns.d.AddNoise(ns.d.Ref("x_mean"), 1.0))
        c.choice("y", ns.d.AddNoise(ns.d.ParamRef("mu0"), 2.0))
        c.choice("w", ns.d.TransformedGaussian(3.0, 1.5, tenths))
    model = b.finish()
    q = ns.Q.build(model, "Obs", [("key", "county.key"),
                                  ("state", "county.state"), ("x", "x"),
                                  ("y", "y"), ("w", "w")])
    return ns.compile(model, [ns.DS(q, data)], capacities={"County": 16},
                      **ns.kw)


def test_gaussian_means_transforms_and_presum_match_jax():
    from test_torch_host import JNS, TNS
    from test_torch_propose import Pair

    cm_j, cm_t = _gauss_toy(JNS), _gauss_toy(TNS)
    for k, mj in cm_j.param_meta.items():
        assert {x: y for x, y in mj.items() if x != "spec"} == \
            {x: y for x, y in cm_t.param_meta[k].items() if x != "spec"}
    cfg = dict(batch_rows=4, rejuv_frequency=16)
    pair = Pair(cm_j, jsmc.InferenceConfig(**cfg, fused_dispatch_rows=0),
                cm_t, tsmc.InferenceConfig(**cfg))
    for cid, slots in (("Obs", np.arange(0, 60, 5)), ("County", np.arange(8))):
        keys = jax.random.split(jax.random.PRNGKey(6), len(slots))
        pair.block(cid, 0, slots, keys)
    obs_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(**cfg)).obs_dev
    obs_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(**cfg),
                        device="cpu").obs_dev
    for vid in (0, 1):   # the indexed Mean, then the plain one
        sj = jgp.recompute_and_resample(cm_j, "Obs", vid, pair.aj, pair.rj,
                                        pair.pj, obs_j, jax.random.PRNGKey(1))
        stt = tgp.recompute_and_resample(cm_t, "Obs", vid, pair.at, pair.rt,
                                         pair.pt, obs_t,
                                         torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(np.asarray(sj["counts"]),
                                      stt["counts"].numpy())
        np.testing.assert_allclose(stt["sums"].numpy(),
                                   np.asarray(sj["sums"]), rtol=1e-6)
