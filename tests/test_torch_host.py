"""Parity of the PyTorch port's host layer, compile and refresh with pclean_tpu.

The same models are built through both packages from the same seeded data:
node lists, plans, query maps, domains, kernel tables, capacities and arena
layouts must be equal, the AddTypos matrices bit-equal, and the integer
relational state (refresh and its point deltas) bit-equal on the same
arenas. Also: the port imports neither jax nor pclean_tpu, and its entry
points refuse to fall back to the CPU unasked.

Helpers here (both-package model builders, state conversion) are shared by
the other tests/test_torch_*.py files.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pclean_tpu.dists as jd
import pclean_tpu_torch.dists as td
from pclean_tpu import strings as jstrings
from pclean_tpu.engine import compile as jcompile
from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine.smc import _obs_device as j_obs_device
from pclean_tpu.model.builder import ModelBuilder as JBuilder
from pclean_tpu.model.query import ObservedDataset as JDS
from pclean_tpu.model.query import Query as JQuery
from pclean_tpu_torch import strings as tstrings
from pclean_tpu_torch.convert import to_numpy, to_torch
from pclean_tpu_torch.engine import compile as tcompile
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine.smc import Engine as TEngine
from pclean_tpu_torch.engine.smc import InferenceConfig as TConfig
from pclean_tpu_torch.model.builder import ModelBuilder as TBuilder
from pclean_tpu_torch.model.query import ObservedDataset as TDS
from pclean_tpu_torch.model.query import Query as TQuery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))
import scaled as jscaled  # noqa: E402
from pclean_tpu_torch.workloads import scaled as tscaled  # noqa: E402

# experiments/scaled.py's CPU correctness config (scaled.py:19-22)
SMALL = dict(rows=512, hospitals=48, counties=12, names=24, zips=32)

JNS = SimpleNamespace(d=jd, B=JBuilder, Q=JQuery, DS=JDS,
                      compile=jcompile.compile_model, kw={})
TNS = SimpleNamespace(d=td, B=TBuilder, Q=TQuery, DS=TDS,
                      compile=tcompile.compile_model, kw={"device": "cpu"})

# tests/test_engine_smoke.py's toy model
NAMES = ["alice", "bob", "carol"]
DIRTY = ["alice", "alicx", "bob", "bob", "carol", "caroll", "alice", "bpb"]
CLEAN = ["alice", "alice", "bob", "bob", "carol", "carol", "alice", "bob"]


def tiny(ns, capacity=8):
    b = ns.B()
    with b.cls("Obj") as c:
        c.choice("name", ns.d.StringPrior(1, 10, NAMES))
    with b.cls("Row") as c:
        c.fk("obj", "Obj")
        c.choice("name_obs", ns.d.AddTypos(ns.d.Ref("obj.name")))
    model = b.finish()
    q = ns.Q.build(model, "Row", [("name", "obj.name", "name_obs")])
    ds = ns.DS(q, {"name": list(DIRTY)})
    return ns.compile(model, [ds], capacities={"Obj": capacity}, **ns.kw), q


def chain(ns, n_rows=24, cap=12):
    """tests/test_incremental.py's chain_cm: Record -> Hospital -> County
    with a typo-observed column and a 2-arg column observed on a 2-hop
    slot-chain vertex, so propagated observations flow down the chain."""
    states = ["al", "ak", "az"]
    names = ["memorial hospital", "st vincent", "county general", "mercy"]
    rows_name = [names[i % len(names)] for i in range(n_rows)]
    rows_name[1] = "memorial hospitel"
    rows_state = [states[i % len(states)] for i in range(n_rows)]
    b = ns.B()
    with b.cls("County") as c:
        c.learned("props", ns.d.Proportions())
        c.choice("state", ns.d.ChooseProportionally(states,
                                                    ns.d.ParamRef("props")))
    with b.cls("Hospital") as c:
        c.fk("loc", "County")
        c.choice("name", ns.d.StringPrior(3, 30, names))
    with b.cls("Record") as c:
        c.fk("hosp", "Hospital")
        c.choice("name_obs", ns.d.AddTypos(ns.d.Ref("hosp.name")))
    model = b.finish()
    q = ns.Q.build(model, "Record", [("name", "hosp.name", "name_obs"),
                                     ("state", "hosp.loc.state")])
    ds = ns.DS(q, {"name": rows_name, "state": rows_state})
    return ns.compile(model, [ds], capacities={"County": cap, "Hospital": cap},
                      **ns.kw), q


def composed(ns, n_rows=30):
    """A compute-table word: avg_obs ~ AddTypos(table[county.state, code]),
    the shape of the hospital model's stateavg column. County's block then
    scores it through the composed SA tensor (propose.py:767-812), and the
    Record block gathers the table per candidate."""
    states = ["al", "ak", "az", "ca"]
    codes = ["m1", "m2", "m3"]
    rows_state = [states[(i * 7) % 4] for i in range(n_rows)]
    rows_code = [codes[i % 3] for i in range(n_rows)]
    rows_avg = [f"{s}-{c}" for s, c in zip(rows_state, rows_code)]
    rows_avg[2] = rows_avg[2][:-1] + "x"
    rows_avg[5] = "a" + rows_avg[5]
    b = ns.B()
    with b.cls("County") as c:
        c.choice("state", ns.d.ChooseUniformly(states))
    with b.cls("Record") as c:
        c.fk("county", "County")
        c.choice("code", ns.d.ChooseUniformly(codes))
        c.compute("avgc", lambda s, m: f"{s}-{m}", ["county.state", "code"])
        c.choice("avg_obs", ns.d.AddTypos(ns.d.Ref("avgc"), 2))
    model = b.finish()
    q = ns.Q.build(model, "Record", [("state", "county.state"),
                                     ("code", "code"),
                                     ("avg", "avgc", "avg_obs")])
    ds = ns.DS(q, {"state": rows_state, "code": rows_code, "avg": rows_avg})
    return ns.compile(model, [ds], capacities={"County": 8}, **ns.kw), q


def scaled_pair(batch=8, size=SMALL, **cfg):
    """The scaled CPU config (or the entity counts `size`) through both
    packages (JAX side forced onto the segmented batched drivers, the only
    ones the port has)."""
    cm_j, cfg_j, dirty, clean, q_j, _ = jscaled.setup(
        **size, batch=batch, fused_dispatch_rows=0, **cfg)
    cm_t, cfg_t, dirty_t, clean_t, q_t, _ = tscaled.setup(
        **size, batch=batch, device="cpu", **cfg)
    assert dirty == dirty_t and clean == clean_t
    return (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean


def port_state(cm_t, cfg_t, seed=0, sweep=False):
    """A reachable state from the port's own init (and sweep), as numpy."""
    arenas, params = tcompile.init_state(cm_t, seed, device="cpu")
    eng = TEngine(cm_t, cfg_t, device="cpu")
    arenas, params, gen = eng.initialize(seed + 1, arenas, params)
    if sweep:
        arenas, params, gen = eng.run(gen, arenas, params)
    return to_numpy(arenas), to_numpy(params)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_rel_equal(rj, rt, what=""):
    assert set(rj) == set(rt)
    for c in rj:
        for k in ("alive", "refcount", "total", "nrows"):
            np.testing.assert_array_equal(np.asarray(rj[c][k]),
                                          rt[c][k].cpu().numpy(),
                                          err_msg=f"{what} {c}.{k}")
        assert set(rj[c]["prop"]) == set(rt[c]["prop"])
        for v in rj[c]["prop"]:
            for i in range(2):
                np.testing.assert_array_equal(
                    np.asarray(rj[c]["prop"][v][i]),
                    rt[c]["prop"][v][i].cpu().numpy(),
                    err_msg=f"{what} {c}.prop[{v}][{i}]")


# ------------------------------------------------------------- isolation


def test_port_imports_neither_jax_nor_pclean_tpu():
    code = ("import sys; import pclean_tpu_torch, pclean_tpu_torch.ops, "
            "pclean_tpu_torch.engine.smc, pclean_tpu_torch.analysis, "
            "pclean_tpu_torch.convert, pclean_tpu_torch.workloads.scaled, "
            "pclean_tpu_torch.workloads.rents, "
            "pclean_tpu_torch.workloads.flights, "
            "pclean_tpu_torch.workloads.hospital, "
            "pclean_tpu_torch.kernel_bench; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pclean_tpu' or "
            "m.startswith('pclean_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_no_jax():
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    assert mods and not any(m.split(".")[0] in ("jax", "pclean_tpu")
                            for m in mods), mods


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    b = TBuilder()
    with b.cls("Obj") as c:
        c.choice("name", td.StringPrior(1, 10, NAMES))
    with b.cls("Row") as c:
        c.fk("obj", "Obj")
        c.choice("name_obs", td.AddTypos(td.Ref("obj.name")))
    model = b.finish()
    q = TQuery.build(model, "Row", [("name", "obj.name", "name_obs")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompile.compile_model(model, [TDS(q, {"name": DIRTY})])
    cm, _ = tiny(TNS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompile.init_state(cm, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(cm, TConfig(batch_rows=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch({"x": np.zeros(3)})


def test_param_state_builders_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from pclean_tpu_torch.dists import params as tparams

    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.init_proportions_state(gen, td.Proportions(), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.init_mean_state(gen, td.Mean(1500.0, 1000.0), 1, 4)
    st = tparams.init_mean_state(gen, td.Mean(1500.0, 1000.0), 1, 4,
                                 device="cpu")
    assert st["value"].shape == (4,) and st["counts"].shape == (4, 1)


# ------------------------------------------------------- host + compile


def test_typo_matrix_bit_equal():
    words = NAMES + ["alicx", "caroll", "bpb", "", "memorial hospital",
                     "st vincent", "a", "12345", "12354"]
    for mt in (None, 2):
        a = jstrings.typos_logdensity_matrix(words, words, mt)
        b = tstrings.typos_logdensity_matrix(words, words, mt)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _plan_sig(plan):
    return [(s.idx, _plan_sig(s.rest)) for s in plan.steps]


def _node_sig(n):
    sig = [type(n).__name__]
    for attr in ("arg_ids", "target_class", "vmap", "fk_id", "sub_id",
                 "path", "ext_id", "name", "indexed", "param_id", "key_id"):
        if hasattr(n, attr):
            sig.append((attr, getattr(n, attr)))
    if hasattr(n, "dist"):
        sig.append(type(n.dist).__name__)
    for attr in ("subnode", "ext_node"):
        if hasattr(n, attr):
            sig.append(_node_sig(getattr(n, attr)))
    return sig


def assert_compiled_equal(cm_j, cm_t, q_j, q_t):
    mj, mt = cm_j.model, cm_t.model
    assert mj.class_order == mt.class_order
    for cid in mj.class_order:
        cj, ct = mj.classes[cid], mt.classes[cid]
        assert [_node_sig(n) for n in cj.nodes] == \
            [_node_sig(n) for n in ct.nodes], cid
        assert cj.names == ct.names and cj.blocks == ct.blocks
        assert cj.hash_keys == ct.hash_keys
        assert [_plan_sig(p) for p in cj.plans] == \
            [_plan_sig(p) for p in ct.plans]
        assert cj.incoming_references == ct.incoming_references
        lj, lt = cm_j.layouts[cid], cm_t.layouts[cid]
        assert (lj.capacity, lj.observed, lj.store, lj.fk_vertices) == \
            (lt.capacity, lt.observed, lt.store, lt.fk_vertices)
    assert (q_j.class_id, q_j.cleanmap, q_j.obsmap) == \
        (q_t.class_id, q_t.cleanmap, q_t.obsmap)
    assert set(cm_j.domains) == set(cm_t.domains)
    for k, dj in cm_j.domains.items():
        dt = cm_t.domains[k]
        if dj is None:
            assert dt is None
        else:
            assert dj.kind == dt.kind
            assert (dj.vocab.values if dj.vocab else None) == \
                (dt.vocab.values if dt.vocab else None), k
    assert cm_j.dummy_code == cm_t.dummy_code
    assert cm_j.exact_gibbs_ok == cm_t.exact_gibbs_ok
    assert cm_j.ref_bounds == cm_t.ref_bounds
    for sj, st in zip(cm_j.obs_specs, cm_t.obs_specs):
        assert sj.class_id == st.class_id and sj.num_rows == st.num_rows
        assert sj.colnames == st.colnames
        for vid in sj.columns:
            for i in range(2):
                assert np.array_equal(sj.columns[vid][i], st.columns[vid][i])
    assert set(cm_j.kernels) == set(cm_t.kernels)
    for k, kj in cm_j.kernels.items():
        kt = cm_t.kernels[k]
        assert type(kj).__name__ == type(kt).__name__
        assert (kj.V, kj.dummy_code, kj.enumerable) == \
            (kt.V, kt.dummy_code, kt.enumerable)
        for attr in ("static_logw", "enum_vec", "score_vec", "M", "mask",
                     "num_options", "n_raw"):
            if hasattr(kj, attr):
                a, b = getattr(kj, attr), getattr(kt, attr)
                assert np.array_equal(np.asarray(a), np.asarray(b)), (k, attr)
    assert set(cm_j.param_meta) == set(cm_t.param_meta)
    for k, mjm in cm_j.param_meta.items():
        assert mjm == cm_t.param_meta[k] or (
            type(mjm["spec"]).__name__ == type(cm_t.param_meta[k]["spec"])
            .__name__ and {x: y for x, y in mjm.items() if x != "spec"} ==
            {x: y for x, y in cm_t.param_meta[k].items() if x != "spec"})
    # arena dtypes and shapes
    aj, pj = jcompile.init_state(cm_j, jax.random.PRNGKey(0))
    at, pt = tcompile.init_state(cm_t, 0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(aj)[0]
    tl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(to_numpy(at))[0]}
    for p, v in jl:
        t = tl[jax.tree_util.keystr(p)]
        assert t.shape == v.shape and t.dtype == np.asarray(v).dtype, p
    assert jax.tree_util.tree_structure(pj) == \
        jax.tree_util.tree_structure(to_numpy(pt))


@pytest.mark.parametrize("which", ["tiny", "chain", "composed"])
def test_compile_parity_toy_models(which):
    fn = {"tiny": tiny, "chain": chain, "composed": composed}[which]
    cm_j, q_j = fn(JNS)
    cm_t, q_t = fn(TNS)
    assert_compiled_equal(cm_j, cm_t, q_j, q_t)


def test_compile_parity_scaled():
    (cm_j, _cj, q_j), (cm_t, _ct, q_t), _d, _c = scaled_pair()
    assert_compiled_equal(cm_j, cm_t, q_j, q_t)


# ---------------------------------------------------------------- refresh


def _chain_state():
    cm_j, _ = chain(JNS)
    cm_t, _ = chain(TNS)
    arenas, params = port_state(cm_t, TConfig(batch_rows=4,
                                              rejuv_frequency=16))
    return cm_j, cm_t, arenas, params


def test_refresh_parity_and_point_deltas():
    cm_j, cm_t, arenas, _params = _chain_state()
    obs_j = j_obs_device(cm_j)
    obs_t = TEngine(cm_t, TConfig(batch_rows=4), device="cpu").obs_dev
    aj, at = to_jax(arenas), to_torch(arenas, "cpu")
    rj = jrefresh.refresh(cm_j, aj, obs_j)
    rt = trefresh.refresh(cm_t, at, obs_t)
    assert_rel_equal(rj, rt, "refresh")
    for slot in (0, 5, 23):
        ej = jrefresh.refresh(cm_j, aj, obs_j, exclude_cid="Record",
                              exclude_slot=slot)
        et = trefresh.refresh(cm_t, at, obs_t, exclude_cid="Record",
                              exclude_slot=slot)
        assert_rel_equal(ej, et, f"exclude {slot}")
        dj = jrefresh.row_delta(cm_j, rj, aj, obs_j, "Record", slot, -1)
        dt = trefresh.row_delta(cm_t, rt, at, obs_t, "Record", slot, -1)
        assert_rel_equal(dj, dt, f"row_delta {slot}")
        assert_rel_equal(ej, dt, f"row_delta == exclude {slot}")
    for slot in (0, 3):
        lj = jrefresh.latent_row_delta(cm_j, rj, aj, "Hospital", slot, -1)
        lt = trefresh.latent_row_delta(cm_t, rt, at, "Hospital", slot, -1)
        assert_rel_equal(lj, lt, f"latent_row_delta {slot}")


def test_dense_per_row_delta_matches_jax_vmap():
    cm_j, cm_t, arenas, _params = _chain_state()
    obs_j = j_obs_device(cm_j)
    obs_t = TEngine(cm_t, TConfig(batch_rows=4), device="cpu").obs_dev
    aj, at = to_jax(arenas), to_torch(arenas, "cpu")
    rj = jrefresh.refresh(cm_j, aj, obs_j)
    rt = trefresh.refresh(cm_t, at, obs_t)
    slots =np.array([0, 1, 7, 23, 30], np.int32)  # 30: out of range
    dj = jax.vmap(lambda s: jrefresh.row_delta(cm_j, rj, aj, obs_j, "Record",
                                               s, -1, dense=True))(
        jnp.asarray(slots))
    dt = trefresh.row_delta(cm_t, rt, at, obs_t, "Record",
                            torch.as_tensor(slots), -1, dense=True)
    for c in ("Hospital", "County"):
        for k in ("alive", "refcount", "total", "nrows"):
            np.testing.assert_array_equal(np.asarray(dj[c][k]),
                                          dt[c][k].numpy(), err_msg=c + k)
        for v in dj[c]["prop"]:
            for i in range(2):
                np.testing.assert_array_equal(
                    np.asarray(dj[c]["prop"][v][i]),
                    np.broadcast_to(dt[c]["prop"][v][i].numpy(),
                                    np.asarray(dj[c]["prop"][v][i]).shape))


def test_batch_deltas_and_hops_parity():
    cm_j, cm_t, arenas, _params = _chain_state()
    obs_j = j_obs_device(cm_j)
    obs_t = TEngine(cm_t, TConfig(batch_rows=4), device="cpu").obs_dev
    rng = np.random.default_rng(3)
    new = {c: {"values": {v: x.copy() for v, x in a["values"].items()},
               "alive": a["alive"].copy()} for c, a in arenas.items()}
    slots = np.array([2, 4, 9, 11], np.int32)
    hv = cm_t.layouts["Record"].fk_vertices[0]
    new["Record"]["values"][hv][slots] = rng.integers(0, 12, size=4)
    aj0, at0, aj1, at1 = (to_jax(arenas), to_torch(arenas, "cpu"),
                          to_jax(new), to_torch(new, "cpu"))
    rj = jrefresh.refresh(cm_j, aj0, obs_j)
    rt = trefresh.refresh(cm_t, at0, obs_t)
    bj = jrefresh.batch_obs_delta(cm_j, rj, aj0, aj1, obs_j, "Record",
                                  jnp.asarray(slots))
    bt = trefresh.batch_obs_delta(cm_t, rt, at0, at1, obs_t, "Record",
                                  torch.as_tensor(slots))
    assert_rel_equal(bj, bt, "batch_obs_delta")
    hj = jrefresh.hop_histograms(cm_j, "Hospital", aj0, obs_j)
    ht = trefresh.hop_histograms(cm_t, "Hospital", at0, obs_t)
    assert len(hj) == len(ht)
    for (kj, (gj, cj)), (kt, (gt, ct)) in zip(hj, ht):
        assert kj == kt
        np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    new2 = {c: {"values": {v: x.copy() for v, x in a["values"].items()},
                "alive": a["alive"].copy()} for c, a in arenas.items()}
    lv = cm_t.layouts["Hospital"].fk_vertices[0]
    hs = np.array([0, 1, 2], np.int32)
    new2["Hospital"]["values"][lv][hs] = rng.integers(0, 12, size=3)
    lj = jrefresh.batch_latent_delta(cm_j, rj, aj0, to_jax(new2), "Hospital",
                                     jnp.asarray(hs), hj)
    lt = trefresh.batch_latent_delta(cm_t, rt, at0, to_torch(new2, "cpu"),
                                     "Hospital", torch.as_tensor(hs), ht)
    assert_rel_equal(lj, lt, "batch_latent_delta")
