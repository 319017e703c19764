"""Parity of the port's flights path with pclean_tpu.

Both packages build experiments/flights.py's model (the JAX side through
that file's build_model, the port through pclean_tpu_torch/workloads/
flights.py) from the same pclean_tpu_torch.workloads.flights.synth tables
at a small size (300 rows, 12 flights, 8 websites, 3% missing time cells,
capacities Flight and TrackingWebsite 16) and are held to these
tolerances:

  * compile, bit-equal: node lists, plans, layouts, domains, the
    self_report table, the atom-list registries, the gate's truth table,
    each TimePrior's enum_mat and each MaybeSwap's mask and lens, param
    meta, no referrer bound and the exact-Gibbs audit passing in both; and
    init_state's shapes and dtypes;
  * the gated lookup read by row_value: equal (1e-5 where a website is the
    flight's airline);
  * whole-row proposals (Engine._propose, every block, fed the JAX
    package's uniform pools) of Flight slots (the flight-id block and the
    time block, whose MaybeSwap externals go through K6's plain version)
    and Obs rows (gated and ungated referrers): block weights rtol 1e-5,
    and the sampled values equal, except Obs time cells whose observation
    is missing: their prior draws come from each package's own generator,
    so they are held to their support (val or one of the options);
  * Flight time-block logZ and records through K6's plain version against
    pclean_tpu's dense path (one block, env0 the stored flight id): rtol
    1e-5;
  * the port's K6 path against its own dense path: rtol 1e-5, same samples;
    and K6's referrer-list form (a referrer bound forced on the port)
    against pclean_tpu's dense path: rtol 1e-5, same samples;
  * Prob heads and tails: exactly equal on the same arenas; resample_prob
    draws: mean and variance within 4 standard errors of Beta(a + heads,
    b + tails);
  * accuracy on the same state: the same counts;
  * whole runs at batch_rows 1: F1 over 3 seeds within pclean_tpu's own
    3-seed range +- 0.02;
  * a toy model's MaybeSwap externals with static options and a static
    prob, and with a learned unindexed Prob: the latent block through K6's
    plain version against pclean_tpu's dense path (rtol 1e-5, same
    samples), and the Prob's heads and tails exactly equal.
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
from pclean_tpu_torch.analysis import evaluate_accuracy_device
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.dists import params as tparams
from pclean_tpu_torch.engine import gibbs_params as tgp
from pclean_tpu_torch.engine import propose as tprop
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.compile import init_state
from pclean_tpu_torch.workloads import flights as tflights
from test_torch_host import _node_sig, _plan_sig, port_state, to_jax
from test_torch_propose import _plan_subkeys, _pool_key

# experiments/flights.py, on sys.path through test_torch_host
import flights as jflights  # noqa: E402

SMALL = dict(rows=300, flights=12, websites=8)
CAPS = {"Flight": 16, "TrackingWebsite": 16}
TOL = dict(rtol=1e-5, atol=1e-5)


def flights_pair(rows=SMALL["rows"], sweeps=1):
    """The flights model through both packages on the same synth tables,
    at batch_rows 1."""
    kw = dict(SMALL, rows=rows)
    dirty, clean = tflights.synth(**kw)
    model = jflights.build_model(*tflights.model_inputs(dirty))
    q_j = JQuery.build(model, "Obs", jflights.QUERY_CLAUSES)
    cm_j = jcompile.compile_model(model, [JDS(q_j, dirty)], capacities=CAPS)
    cfg_j = jsmc.InferenceConfig(num_iters=sweeps, batch_rows=1,
                                 use_mh_instead_of_pg=True)
    cm_t, cfg_t, dirty_t, clean_t, q_t, _ = tflights.setup(
        **kw, sweeps=sweeps, capacities=CAPS, device="cpu")
    assert dirty == dirty_t and clean == clean_t
    return (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean


class FlightsState:
    """Both compiled models on one reachable state (the port's init and
    one sweep)."""

    def __init__(self):
        (self.cm_j, self.cfg_j, self.q_j), (self.cm_t, self.cfg_t,
                                            self.q_t), \
            self.dirty, self.clean = flights_pair()
        self.eng_j = jsmc.Engine(self.cm_j, self.cfg_j)
        self.eng_t = tsmc.Engine(self.cm_t, self.cfg_t, device="cpu")
        arenas, params = port_state(self.cm_t, self.cfg_t, sweep=True)
        self.aj, self.pj = to_jax(arenas), to_jax(params)
        self.at, self.pt = to_torch(arenas, "cpu"), to_torch(params, "cpu")
        self.rj = jrefresh.refresh(self.cm_j, self.aj, self.eng_j.obs_dev)
        self.rt = trefresh.refresh(self.cm_t, self.at, self.eng_t.obs_dev)

    def vid(self, cid, name):
        return self.cm_t.cls(cid).names[name]

    def propose(self, cid, slots, keys):
        """Engine._propose of every block in both packages, the port fed
        the JAX package's per-block uniform pools: (JAX (env, w), port
        (env, w))."""
        plans = self.cm_j.cls(cid).plans

        def one(s, k):
            env, _b, w = self.eng_j._propose(cid, self.aj, self.rj, self.pj,
                                             s, k, False, matmul_obs=False)
            return env, w

        env_j, w_j = jax.jit(jax.vmap(one))(jnp.asarray(slots, jnp.int32),
                                           keys)
        pools = []
        for i, plan in enumerate(plans):
            n = jprop._draw_bound(self.cm_j, cid, plan)
            assert n == tprop._draw_bound(self.cm_t, cid,
                                          self.cm_t.cls(cid).plans[i])
            pools.append(torch.as_tensor(np.asarray(jax.vmap(
                lambda k, i=i, n=n: jax.random.uniform(
                    _pool_key(_plan_subkeys(k, len(plans))[i]), (n,)))(
                        keys))))
        env_t, _b, w_t = self.eng_t._propose(
            cid, self.at, self.rt, self.pt, torch.as_tensor(slots),
            torch.Generator().manual_seed(0), False, pools=pools)
        return (env_j, np.asarray(w_j)), (env_t, w_t.numpy())


@pytest.fixture(scope="module")
def st():
    return FlightsState()


# ----------------------------------------------------------------- compile


def test_flights_compile_parity(st):
    cm_j, cm_t = st.cm_j, st.cm_t
    assert cm_j.model.class_order == cm_t.model.class_order
    for cid in cm_j.model.class_order:
        cj, ct = cm_j.cls(cid), cm_t.cls(cid)
        assert [_node_sig(n) for n in cj.nodes] == \
            [_node_sig(n) for n in ct.nodes], cid
        assert cj.blocks == ct.blocks and cj.hash_keys == ct.hash_keys
        assert [_plan_sig(p) for p in cj.plans] == \
            [_plan_sig(p) for p in ct.plans]
        lj, lt = cm_j.layouts[cid], cm_t.layouts[cid]
        assert (lj.capacity, lj.observed, lj.store, lj.fk_vertices) == \
            (lt.capacity, lt.observed, lt.store, lt.fk_vertices)
    assert set(cm_j.domains) == set(cm_t.domains)
    for k, dj in cm_j.domains.items():
        dt = cm_t.domains[k]
        assert (dj is None) == (dt is None)
        if dj is not None:
            assert dj.kind == dt.kind, k
            assert (list(dj.vocab.values) if dj.vocab else None) == \
                (list(dt.vocab.values) if dt.vocab else None), k
    assert cm_j.dummy_code == cm_t.dummy_code
    assert set(cm_j.tables) == set(cm_t.tables)
    for k in cm_j.tables:      # self_report and the four atom-list tables
        np.testing.assert_array_equal(cm_j.tables[k], cm_t.tables[k])
    assert set(cm_j.list_reg) == set(cm_t.list_reg)
    for k in cm_j.list_reg:
        rj, rt = cm_j.list_reg[k], cm_t.list_reg[k]
        np.testing.assert_array_equal(rj.mask_matrix(), rt.mask_matrix())
        np.testing.assert_array_equal(rj.lengths(), rt.lengths())
    gate = st.vid("Obs", "self_report")
    np.testing.assert_array_equal(np.asarray(cm_j.truth_table("Obs", gate)),
                                  cm_t.truth_table("Obs", gate))
    assert cm_t.truth_table("Obs", gate).any()
    for k, kj in cm_j.kernels.items():
        kt = cm_t.kernels[k]
        assert type(kj).__name__ == type(kt).__name__
        assert (kj.V, kj.enumerable) == (kt.V, kt.enumerable)
        for attr in ("enum_mat", "enum_vec", "score_vec", "mask", "lens"):
            if hasattr(kj, attr):
                np.testing.assert_array_equal(np.asarray(getattr(kj, attr)),
                                              getattr(kt, attr))
    assert {type(k).__name__ for k in cm_t.kernels.values()} >= \
        {"_TimePriorK", "_MaybeSwapK"}
    for k, mj in cm_j.param_meta.items():
        mt = cm_t.param_meta[k]
        assert vars(mj["spec"]) == vars(mt["spec"])
        assert {x: y for x, y in mj.items() if x != "spec"} == \
            {x: y for x, y in mt.items() if x != "spec"}
    assert cm_j.ref_bounds == cm_t.ref_bounds == {}
    assert cm_j.exact_gibbs_ok is True and cm_t.exact_gibbs_ok is True
    for sj, stt in zip(cm_j.obs_specs, cm_t.obs_specs):
        for vid in sj.columns:
            for i in range(2):
                np.testing.assert_array_equal(sj.columns[vid][i],
                                              stt.columns[vid][i])
    aj, pj = jcompile.init_state(cm_j, jax.random.PRNGKey(0))
    at, pt = init_state(cm_t, 0, device="cpu")
    sig = lambda t: sorted(  # noqa: E731
        (jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype).split(".")[-1])
        for p, x in jax.tree_util.tree_flatten_with_path(t)[0])
    assert sig(aj) == sig(at) and sig(pj) == sig(pt)


def test_gated_lookup_matches_jax(st):
    ep = st.vid("Obs", "error_prob")
    cap = st.cm_t.layouts["Obs"].capacity
    vj = jax.jit(lambda a, p: jprop.row_value(st.cm_j, a, p, "Obs", ep,
                                              jnp.arange(cap)))(st.aj, st.pj)
    vt = tprop.row_value(st.cm_t, st.at, st.pt, "Obs", ep, torch.arange(cap))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    gated = np.array([s == f[:2].lower() for s, f in
                      zip(st.dirty["src"], st.dirty["flight"])])
    assert gated.any() and np.all(vt.numpy()[gated] == np.float32(1e-5))


# ----------------------------------------------------------------- blocks


def _flight_slots(st):
    cap = st.cm_t.layouts["Flight"].capacity
    live = np.flatnonzero(st.rt["Flight"]["alive"].numpy())
    return np.concatenate([live[:8], [cap - 1]])


def test_flight_rows_match_jax(st):
    slots = _flight_slots(st)
    keys = jax.random.split(jax.random.PRNGKey(9), len(slots))
    with mock.patch.object(ops, "maybe_swap_ext_plain",
                           wraps=ops.maybe_swap_ext_plain) as spy:
        (env_j, w_j), (env_t, w_t) = st.propose("Flight", slots, keys)
    assert spy.call_count == 4      # one K6 call per time field
    np.testing.assert_allclose(w_t, w_j, **TOL)
    assert set(env_j) == set(env_t)
    for v in env_j:
        np.testing.assert_array_equal(np.asarray(env_j[v]), env_t[v].numpy(),
                                      err_msg=str(v))


def test_obs_rows_match_jax_missing_cells_in_support(st):
    spec = st.cm_t.obs_specs[0]
    times = [st.vid("Obs", s) for s in tflights.SHORT]
    miss = np.any([spec.columns[v][1] == 2 for v in times], 0)
    gated = np.array([s == f[:2].lower() for s, f in
                      zip(st.dirty["src"], st.dirty["flight"])])
    slots = np.sort(np.concatenate([np.flatnonzero(miss)[:6],
                                    np.flatnonzero(gated)[:4],
                                    np.flatnonzero(~miss & ~gated)[:6]]))
    keys = jax.random.split(jax.random.PRNGKey(5), len(slots))
    (env_j, w_j), (env_t, w_t) = st.propose("Obs", slots, keys)
    np.testing.assert_allclose(w_t, w_j, **TOL)
    assert set(env_j) == set(env_t)
    for v in env_j:
        a, b = np.asarray(env_j[v]), env_t[v].numpy()
        if v not in times:
            np.testing.assert_array_equal(a, b, err_msg=str(v))
            continue
        m = spec.columns[v][1][slots] == 2
        np.testing.assert_array_equal(a[~m], b[~m], err_msg=str(v))
        kern = st.cm_t.kernels[("Obs", v)]
        val = env_t[st.cm_t.cls("Obs").nodes[v].arg_ids["val"]].numpy()
        lc = env_t[st.cm_t.cls("Obs").nodes[v].arg_ids["options"]].numpy()
        for i in np.flatnonzero(m):
            assert b[i] == val[i] or kern.mask[lc[i], b[i]], (v, i)


def _time_block(st, slots, keys, ref_comp=None):
    """The Flight time block alone in both packages, env0 the stored
    flight id (the port's referrers as `ref_comp`'s per-slot lists where
    given): (JAX logZ, records, env), (port logZ, records, env)."""
    fid = st.vid("Flight", "flight_id")
    plan_j = st.cm_j.cls("Flight").plans[1]
    order = []

    def one(s, k):
        tr = jprop.BlockTracer(st.cm_j, "Flight", st.aj, st.rj, st.pj,
                               st.eng_j.obs_dev, {},
                               {fid: st.aj["Flight"]["values"][fid][s]}, s,
                               ext_hists={})
        logZ, res = tr.run(plan_j, k)
        order[:] = list(tr.records)
        return logZ, [tr.records[r] for r in tr.records], res.env

    logZ_j, recs_j, env_j = jax.jit(jax.vmap(one))(
        jnp.asarray(slots, jnp.int32), keys)
    n = jprop._draw_bound(st.cm_j, "Flight", plan_j)
    pool = torch.as_tensor(np.asarray(jax.vmap(
        lambda k: jax.random.uniform(_pool_key(k), (n,)))(keys)))
    ts = torch.as_tensor(slots)
    tr = tprop.BlockTracer(st.cm_t, "Flight", st.at, st.rt, st.pt,
                           st.eng_t.obs_dev, {},
                           {fid: st.at["Flight"]["values"][fid][ts]}, ts,
                           ext_hists={}, ref_comp=ref_comp)
    logZ_t, res = tr.run(st.cm_t.cls("Flight").plans[1], pool=pool)
    return (np.asarray(logZ_j), dict(zip(order, recs_j)), env_j), \
        (logZ_t, tr.records, res.env)


def test_flight_time_block_matches_jax_dense_path(st):
    slots = _flight_slots(st)
    keys = jax.random.split(jax.random.PRNGKey(3), len(slots))
    (lj, rj, ej), (lt, rt, et) = _time_block(st, slots, keys)
    np.testing.assert_allclose(lt.numpy(), lj, **TOL)
    assert list(rj) == list(rt)
    for key, r in rj.items():
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(r),
                                   err_msg=str(key), **TOL)
    for v in ej:
        np.testing.assert_array_equal(np.asarray(ej[v]), et[v].numpy())


def test_k6_path_matches_port_dense_path(st):
    slots = _flight_slots(st)
    keys = jax.random.split(jax.random.PRNGKey(3), len(slots))
    _j, (l6, r6, e6) = _time_block(st, slots, keys)
    with mock.patch.object(tprop.BlockTracer, "_ext_swap_term",
                           return_value=None):
        _j, (ld, rd, ed) = _time_block(st, slots, keys)
    np.testing.assert_allclose(l6.numpy(), ld.numpy(), **TOL)
    for key in rd:
        np.testing.assert_allclose(r6[key].numpy(), rd[key].numpy(), **TOL)
    for v in ed:
        assert torch.equal(e6[v], ed[v]), v


def test_k6_list_form_matches_jax_dense_path(st, monkeypatch):
    """The referrer-list form K6 takes where the model has a referrer
    bound (the flights path at 2,376 rows: 256 of 2,376 Obs rows), here
    forced with a bound of 128 that every Flight slot's referrers fit in."""
    path = ((("Obs", st.vid("Obs", "flight")),))
    monkeypatch.setattr(st.cm_t, "ref_bounds", {path: 128})
    comp = st.eng_t._ref_comp("Flight", st.at, st.rt)
    assert 0 < int(comp[path][1].max()) <= 128
    slots = _flight_slots(st)
    keys = jax.random.split(jax.random.PRNGKey(3), len(slots))
    with mock.patch.object(ops, "maybe_swap_ext_plain",
                           wraps=ops.maybe_swap_ext_plain) as spy:
        (lj, rj, ej), (lt, rt, et) = _time_block(st, slots, keys, comp)
    assert spy.call_count == 4
    assert all(c.kwargs.get("cnt") is not None for c in spy.call_args_list)
    np.testing.assert_allclose(lt.numpy(), lj, **TOL)
    for key, r in rj.items():
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(r),
                                   err_msg=str(key), **TOL)
    for v in ej:
        np.testing.assert_array_equal(np.asarray(ej[v]), et[v].numpy())


# ----------------------------------------------------------------- params


def test_prob_heads_tails_match_jax(st):
    pv = st.vid("Obs", "error_probs")
    sj = jgp.recompute_and_resample(st.cm_j, "Obs", pv, st.aj, st.rj, st.pj,
                                    st.eng_j.obs_dev, jax.random.PRNGKey(1))
    stt = tgp.recompute_and_resample(st.cm_t, "Obs", pv, st.at, st.rt, st.pt,
                                     st.eng_t.obs_dev,
                                     torch.Generator().manual_seed(0))
    for k in ("heads", "tails"):
        np.testing.assert_array_equal(np.asarray(sj[k]), stt[k].numpy())
    # every live row's observed, ungated time cells count once
    assert int(stt["heads"].sum() + stt["tails"].sum()) > 0
    assert int(stt["heads"].sum()) > 0
    assert stt["value"].shape == st.pt["Obs"][pv]["value"].shape


def test_resample_prob_moments():
    spec = tparams.Prob(10.0, 50.0)
    n = 20_000
    heads = torch.tensor([0, 3, 40, 200] * (n // 4), dtype=torch.int32)
    tails = torch.tensor([0, 100, 10, 900] * (n // 4), dtype=torch.int32)
    state = dict(tparams.init_prob_state(torch.Generator().manual_seed(1),
                                         spec, n, device="cpu"),
                 heads=heads, tails=tails)
    v = tparams.resample_prob(torch.Generator().manual_seed(2), state,
                              spec)["value"].double()
    for i in range(4):
        a = spec.a + float(heads[i])
        b = spec.b + float(tails[i])
        x = v[i::4]
        mean = a / (a + b)
        var = a * b / ((a + b) ** 2 * (a + b + 1))
        m = len(x)
        assert abs(float(x.mean()) - mean) <= 4 * (var / m) ** 0.5
        # the sample variance's standard error, from the fourth moment
        mu4 = float(((x - mean) ** 4).mean())
        se_var = ((mu4 - var * var) / m) ** 0.5
        assert abs(float(x.var()) - var) <= 4 * se_var


# ------------------------------------------------------------- end to end


def test_accuracy_scores_flights_as_jax(st):
    want = j_eval(st.cm_j, st.aj, st.pj, st.dirty, st.clean, st.q_j)
    got = evaluate_accuracy_device(st.cm_t, st.at, st.pt, st.dirty,
                                   st.clean, st.q_t)
    assert got == want and got["imputed"] > 0


def test_flights_f1_within_jax_seed_spread():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = flights_pair(
        rows=200, sweeps=2)
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
        assert set(eng_t.phase_times) == {"Obs", "sweep:TrackingWebsite",
                                          "sweep:Flight", "sweep:Obs"}
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


# ------------------------------------------------- the other MaybeSwap forms


def _swap_toy(ns):
    """MaybeSwap externals of a latent enumerated value in the forms the
    flights model does not use: static options with a static prob, and all
    options with a learned (unindexed) Prob; 48 rows over 8 entities, 20%
    of reports swapped and a tenth missing."""
    import random

    opts = ["x1", "x2", "x3", "x4", "x5"]
    rng = random.Random(4)
    ents = [rng.choice(opts) for _ in range(8)]

    def report(v):
        if rng.random() < 0.1:
            return None
        return rng.choice(opts) if rng.random() < 0.2 else v

    data = {"a": [report(ents[i % 8]) for i in range(48)],
            "b": [report(ents[i % 8]) for i in range(48)]}
    b = ns.B()
    with b.cls("T") as c:
        c.choice("t", ns.d.ChooseUniformly(opts))
    with b.cls("Obs") as c:
        c.learned("err", ns.d.Prob(2.0, 8.0))
        c.fk("tt", "T")
        c.choice("a", ns.d.MaybeSwap(ns.d.Ref("tt.t"), opts[:4], 0.1))
        c.choice("b", ns.d.MaybeSwap(ns.d.Ref("tt.t"), opts,
                                     ns.d.ParamRef("err")))
    model = b.finish()
    q = ns.Q.build(model, "Obs", [("a", "a"), ("b", "b")])
    return ns.compile(model, [ns.DS(q, data)], capacities={"T": 16}, **ns.kw)


def test_k6_static_options_and_prob_parameter_match_jax():
    from test_torch_host import JNS, TNS
    from test_torch_propose import Pair

    cm_j, cm_t = _swap_toy(JNS), _swap_toy(TNS)
    cfg = dict(batch_rows=4, rejuv_frequency=16)
    pair = Pair(cm_j, jsmc.InferenceConfig(**cfg, fused_dispatch_rows=0),
                cm_t, tsmc.InferenceConfig(**cfg))
    slots = np.arange(16)
    with mock.patch.object(ops, "maybe_swap_ext_plain",
                           wraps=ops.maybe_swap_ext_plain) as spy:
        pair.block("T", 0, slots, jax.random.split(jax.random.PRNGKey(2),
                                                    len(slots)))
    assert spy.call_count == 2      # both externals through K6
    pv = cm_t.cls("Obs").names["err"]
    obs_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(**cfg)).obs_dev
    obs_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(**cfg),
                        device="cpu").obs_dev
    sj = jgp.recompute_and_resample(cm_j, "Obs", pv, pair.aj, pair.rj,
                                    pair.pj, obs_j, jax.random.PRNGKey(1))
    stt = tgp.recompute_and_resample(cm_t, "Obs", pv, pair.at, pair.rt,
                                     pair.pt, obs_t,
                                     torch.Generator().manual_seed(0))
    for k in ("heads", "tails"):
        np.testing.assert_array_equal(np.asarray(sj[k]), stt[k].numpy())
    assert int(stt["heads"].sum()) > 0 and int(stt["tails"].sum()) > 0
