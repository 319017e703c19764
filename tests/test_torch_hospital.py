"""Parity of the port's hospital path with pclean_tpu.

Both packages build experiments/hospital.py's model (the JAX side through
that file's build_model, QUERY_CLAUSES and CAPACITIES, the port through
pclean_tpu_torch/workloads/hospital.py) from the same
pclean_tpu_torch.workloads.hospital.synth tables at a small size (240
rows: both Record blocks, the Hospital and Measure fk enumerations, and
the composed stateavg term of the County and Measure blocks) and are held
equal:

  * compile: node lists, plans, layouts, domains, kernels (the AddTypos
    matrices bit-equal), every compute table (the stateavg table among
    them) and every composed score tensor SA (precompute_sa_tables) bit
    for bit;
  * referrer_histograms of every latent class (K7's plain version, hoisted
    through fk chains up to three deep) bit-equal on one state carried
    across by convert.to_torch;
  * the score pass of both Record blocks and of the County and Measure
    blocks (the latter two through the composed term, K8's plain version):
    logZ and recorded logits rtol 1e-5, atol 1e-5;
  * the sample pass under the JAX package's exported uniforms: sampled
    values and births equal.

The JAX side is compiled once for the module; its engine is not run here
(tests/test_torch_hospital_run.py runs both engines once). F1 over three
seeds is scripts/hospital_jax_floor.py's, not tier-1's.
"""
import jax
import numpy as np
import pytest
import torch

from pclean_tpu.engine import compile as jcompile
from pclean_tpu.engine import smc as jsmc
from pclean_tpu.io import possibilities_from
from pclean_tpu.model.query import ObservedDataset as JDS
from pclean_tpu.model.query import Query as JQuery
from pclean_tpu_torch import io as tio
from pclean_tpu_torch import ops
from pclean_tpu_torch.engine import propose as tprop
from pclean_tpu_torch.utils import chase
from pclean_tpu_torch.workloads import hospital as thospital
from test_torch_host import assert_compiled_equal
from test_torch_propose import Pair

# experiments/hospital.py, on sys.path through test_torch_host
import hospital as jhospital  # noqa: E402

ROWS = 240
B = 16


def hospital_pair(rows=ROWS, batch=B):
    """The hospital model through both packages on the same synth tables
    (both on the segmented batched drivers, fused_dispatch_rows=0)."""
    dirty, clean = thospital.synth(rows)
    assert possibilities_from(dirty) == tio.possibilities_from(dirty)
    model = jhospital.build_model(possibilities_from(dirty))
    q_j = JQuery.build(model, "Record", jhospital.QUERY_CLAUSES)
    cm_j = jcompile.compile_model(model, [JDS(q_j, dirty)],
                                  capacities=jhospital.CAPACITIES)
    cfg_j = jsmc.InferenceConfig(num_iters=1, batch_rows=batch,
                                 use_mh_instead_of_pg=True,
                                 fused_dispatch_rows=0)
    cm_t, cfg_t, dirty_t, clean_t, q_t, _ = thospital.setup(
        rows=rows, batch=batch, device="cpu", fused_dispatch_rows=0)
    assert dirty == dirty_t and clean == clean_t
    return (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean


@pytest.fixture(scope="module")
def pair():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), _d, _c = hospital_pair()
    p = Pair(cm_j, cfg_j, cm_t, cfg_t)
    p.q_j, p.q_t = q_j, q_t
    return p


def test_synth_draws_entities_far_apart():
    dirty, clean = thospital.synth(1000)
    assert list(dirty) == thospital.COLUMNS == list(clean)
    assert all(len(v) == 1000 for v in dirty.values())
    errors = sum(d != c for col in dirty for d, c in zip(dirty[col],
                                                         clean[col]))
    assert 0.03 < errors / (1000 * len(dirty)) < 0.07
    for col in ("HospitalName", "Address1", "PhoneNumber", "ProviderNumber",
                "ZipCode", "MeasureCode", "MeasureName", "City"):
        vals = sorted(set(clean[col]))
        assert min(thospital._edit_distance(a, b) for i, a in enumerate(vals)
                   for b in vals[i + 1:]) >= 3, col
    assert all(s == f"{st}_{c}" for s, st, c in zip(
        clean["Stateavg"], clean["State"], clean["MeasureCode"]))
    assert len(set(clean["HospitalName"])) == 55
    assert thospital.synth(1000) == (dirty, clean)
    tiled = thospital.tile(dirty, 3)
    assert tiled["State"] == dirty["State"] * 3


def test_hospital_compile_parity(pair):
    cm_j, cm_t = pair.cm_j, pair.cm_t
    assert_compiled_equal(cm_j, cm_t, pair.q_j, pair.q_t)
    assert set(cm_j.tables) == set(cm_t.tables) and cm_t.tables
    for k, tj in cm_j.tables.items():
        assert np.array_equal(np.asarray(tj), np.asarray(cm_t.tables[k])), k
    sa_j = cm_j.__dict__["_ext_sa_cache"]
    sa_t = cm_t.__dict__["_ext_sa_cache"]
    # stateavg seen from County (and Hospital, the same axis order) and from
    # Measure
    assert set(sa_j) == set(sa_t) and len(sa_t) == 2
    for k, s in sa_j.items():
        assert s.dtype == sa_t[k].dtype and np.array_equal(s, sa_t[k]), k


def test_referrer_histograms_of_every_class(pair):
    """K7's plain version through fk chains of one to three hops (County's
    state and name through Record.hosp -> Hospital.loc -> Place.county)."""
    from pclean_tpu.engine import propose as jprop

    hops = set()
    for cid in pair.cm_t.model.class_order:
        if pair.cm_t.layouts[cid].observed:
            continue
        hj = jprop.referrer_histograms(pair.cm_j, cid, pair.aj, pair.pj,
                                       pair.rj, pair.eng_j.obs_dev)
        ht = tprop.referrer_histograms(pair.cm_t, cid, pair.at, pair.pt,
                                       pair.rt, pair.eng_t.obs_dev)
        assert set(hj) == set(ht) and ht, cid
        for k, h in hj.items():
            np.testing.assert_array_equal(np.asarray(h), ht[k].numpy(),
                                          err_msg=f"{cid} {k}")
            assert float(ht[k].sum()) > 0, (cid, k)
            hops.add(len(k[0]))
    assert hops == {1, 2, 3}


def _live(pair, cid, n):
    cap = pair.cm_t.layouts[cid].capacity
    live = np.flatnonzero(pair.rt[cid]["alive"].numpy())
    return np.concatenate([live[:n - 2], [cap - 1, cap - 2]])


def _chain(pair, cid, slots, keys):
    """Every block of class cid in plan order, each fed the env the one
    before it sampled (Engine._propose's chain; the Record's second block
    reads the first's Hospital for stateavg): per block logZ and records
    rtol/atol 1e-5, then sampled values and births equal, the port fed the
    JAX package's uniform pool of each block."""
    from pclean_tpu.engine import propose as jprop
    from test_torch_propose import TOL, _plan_subkeys, _pool_key

    cm_j, cm_t = pair.cm_j, pair.cm_t
    plans_j, plans_t = cm_j.cls(cid).plans, cm_t.cls(cid).plans
    orders = [[] for _ in plans_j]

    def one(s, k):
        obs_row = pair.eng_j._obs_row_slices(cid, s, pair.rj)
        env, out = {}, []
        for i, (plan, sub) in enumerate(zip(plans_j,
                                            _plan_subkeys(k, len(plans_j)))):
            tr = jprop.BlockTracer(cm_j, cid, pair.aj, pair.rj, pair.pj,
                                   pair.eng_j.obs_dev, obs_row, env, s)
            logZ, res = tr.run(plan, sub)
            orders[i][:] = list(tr.records)
            env = res.env
            out.append((logZ, [tr.records[r] for r in tr.records],
                        [(b.is_new, b.slot, b.values) for b in res.births]))
        return out, env

    js = jax.numpy.asarray(slots, jax.numpy.int32)
    blocks_j, env_j = jax.jit(jax.vmap(one))(js, keys)
    st = torch.as_tensor(slots)
    obs_row_t = pair.eng_t._obs_row_slices(cid, st.long(), pair.rt)
    env = {}
    for i, plan in enumerate(plans_t):
        n = jprop._draw_bound(cm_j, cid, plans_j[i])
        assert n == tprop._draw_bound(cm_t, cid, plan)
        pool = torch.as_tensor(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(
                _pool_key(_plan_subkeys(k, len(plans_j))[i]), (n,)))(keys)))
        tr = tprop.BlockTracer(cm_t, cid, pair.at, pair.rt, pair.pt,
                               pair.eng_t.obs_dev, obs_row_t, env, st)
        logZ, res = tr.run(plan, pool=pool)
        env = res.env
        logZ_j, recs_j, births_j = blocks_j[i]
        np.testing.assert_allclose(np.asarray(logZ_j), logZ.numpy(), **TOL)
        assert orders[i] == list(tr.records)
        for key, rj in zip(orders[i], recs_j):
            np.testing.assert_allclose(np.asarray(rj),
                                       tr.records[key].numpy(),
                                       err_msg=f"block {i} {key}", **TOL)
        assert len(births_j) == len(res.births)
        for (nj, sj, vj), bt in zip(births_j, res.births):
            np.testing.assert_array_equal(np.asarray(nj), bt.is_new.numpy())
            np.testing.assert_array_equal(np.asarray(sj), bt.slot.numpy())
            for v in vj:
                np.testing.assert_array_equal(np.asarray(vj[v]),
                                              bt.values[v].numpy())
    assert set(env_j) == set(env)
    for v in env_j:
        np.testing.assert_array_equal(np.asarray(env_j[v]), env[v].numpy(),
                                      err_msg=str(v))


@pytest.mark.parametrize("seed", [0, 1])
def test_record_blocks_score_and_sample(pair, seed):
    slots = np.sort(np.random.default_rng(seed).choice(ROWS, B,
                                                       replace=False))
    keys = jax.random.split(jax.random.PRNGKey(5 + seed), len(slots))
    _chain(pair, "Record", slots, keys)


@pytest.mark.parametrize("cid", ["County", "Measure"])
def test_composed_stateavg_blocks_score_and_sample(pair, cid):
    """The County and Measure blocks score the stateavg observations
    through the composed SA term: K8's plain version (the pair histogram
    times SA) on the CPU, launched once a block here."""
    slots = _live(pair, cid, B)
    keys = jax.random.split(jax.random.PRNGKey(9), len(slots))
    before = ops.LAUNCHES["sa_ext_term"]
    calls = []
    orig = ops.sa_ext_term_plain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    ops.sa_ext_term_plain = spy
    try:
        for p in range(len(pair.cm_t.cls(cid).plans)):
            pair.block(cid, p, slots, keys, hists=True)
    finally:
        ops.sa_ext_term_plain = orig
    assert ops.LAUNCHES["sa_ext_term"] == before   # CPU: the plain version
    assert calls, "the composed term did not run"


def test_k7_k8_plain_on_the_hospital_state(pair):
    """On this state: the per-row form of K7 at a row's dense referrers
    equals the hoisted histogram's row, and K8's plain version equals a
    loop over the referrers."""
    ht = tprop.referrer_histograms(pair.cm_t, "Hospital", pair.at, pair.pt,
                                   pair.rt, pair.eng_t.obs_dev)
    (path, ext_id), hoisted = next(iter(ht.items()))
    src = path[-1][0]
    codes, state = pair.eng_t.obs_dev[src][ext_id]
    t = chase([pair.at[c]["values"][f] for c, f in reversed(path)])
    alive = pair.rt[src]["alive"]
    slots = torch.as_tensor(_live(pair, "Hospital", 6))
    w = alive[None, :] & (t[None, :] == slots[:, None]) & (state != 2)
    rows = ops.referrer_hist(codes.reshape(1, -1), w, hoisted.shape[1])
    assert torch.equal(rows, hoisted[slots.clamp(max=hoisted.shape[0] - 1)]
                       * (slots < hoisted.shape[0])[:, None])
    sa = next(iter(pair.cm_t.__dict__["_ext_sa_cache"].values()))
    SA = torch.as_tensor(sa).reshape(sa.shape[0], -1, sa.shape[-1])
    rng = np.random.default_rng(0)
    rv = torch.as_tensor(rng.integers(-1, SA.shape[1] + 1, (1, ROWS)))
    val = torch.as_tensor(rng.integers(0, SA.shape[2], (1, ROWS)))
    got = ops.sa_ext_term(SA, rv, val, w)
    want = torch.zeros_like(got, dtype=torch.float64)
    for b in range(w.shape[0]):
        for r in torch.nonzero(w[b])[:, 0].tolist():
            c, o = int(rv[0, r]), int(val[0, r])
            if 0 <= c < SA.shape[1]:
                want[b] += SA[:, c, o].double()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-3)
