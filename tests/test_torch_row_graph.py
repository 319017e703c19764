"""The one-row loops driven through engine/row_graph.py.

CPU (the graph is for the card; here every row runs the step eagerly):
  * _sweep_segment over 20 row slots with resample_all inside the segment
    (rejuv_frequency 5), on the scaled CPU config's Record sweep and the
    chain model's Hospital sweep (hop moves), against pclean_tpu's
    _sweep_segment program fed the same uniform pools: arenas and params
    bit-equal, the loop parity tests' tolerance for a segment. Both
    packages' resample_all is replaced by the same deterministic update
    (each class's Pitman-Yor strength from its carried live-row count),
    since the two packages draw their parameters from different random
    streams; the update reads the carried relational state and changes
    what the following rows' K12 launches read;
  * the same seed twice gives bit-equal arenas, params and log-ML through
    the sequential init (scan_init), a sweep and a replay chunk, MH on a
    small scaled config and collapsed PG on the chain model, with
    resample_all (the real one) inside every segment;
  * every params leaf the row step reads keeps its storage across the
    loop's resample_all (the leaves a captured graph reads), and the
    caller's params are left unchanged;
  * RowGraph walks a slot table in order; the launch-count snapshots add
    and take back a captured step's counts.

Card (`cuda` marker; `python -m pytest -m cuda tests/test_torch_row_graph.py`
on the H100): every loop kind (kernel_bench.graph_against_eager: the MH
ramp, the collapsed and written-out PG ramps, observed, latent-with-hops
and leaf sweeps, the explicit MH comparison, replay chunks) from the same
state and generator state, once eager and once as replays: every leaf,
the log-ML, the generator's state and the launch counts bit-equal. The
JAX package is imported inside the CPU tests only, so the module also
loads on the card's machine, which has no JAX.
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.convert import to_torch
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import row_graph
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.compile import init_state
from test_torch_kernels import _chain_model

R_FREQ = 5


def _fake_jax(cm, arenas, params, obs_dev, key, rel=None):
    import jax.numpy as jnp
    from pclean_tpu.engine import refresh as jrefresh

    if rel is None:
        rel = jrefresh.refresh(cm, arenas, obs_dev)
    py = {c: {"strength": v["strength"] * 0.5
              + rel[c]["nrows"].astype(jnp.float32) * 0.25,
              "discount": v["discount"]}
          for c, v in params["__py__"].items()}
    return arenas, {**params, "__py__": py}


def _fake_torch(cm, arenas, params, obs_dev, gen, rel=None, out=None):
    if rel is None:
        rel = trefresh.refresh(cm, arenas, obs_dev)
    py = {c: {"strength": v["strength"] * 0.5
              + rel[c]["nrows"].to(torch.float32) * 0.25,
              "discount": v["discount"]}
          for c, v in params["__py__"].items()}
    return arenas, {**params, "__py__": py}


@pytest.mark.parametrize("which,cid,base", [("scaled", "Record", 100),
                                            ("chain", "Hospital", 0)])
def test_sweep_segment_with_resample_matches_jax(monkeypatch, which, cid,
                                                 base):
    import jax
    from pclean_tpu.engine import gibbs_params as jgibbs
    from pclean_tpu.engine import propose as jprop
    from pclean_tpu.engine import smc as jsmc
    from test_torch_b1 import SEG, _pair, _rolled
    from test_torch_host import to_jax
    from test_torch_propose import _plan_subkeys, _pool_key

    monkeypatch.setattr(jgibbs, "resample_all", _fake_jax)
    monkeypatch.setattr(tsmc, "resample_all", _fake_torch)
    pair = _pair(which)
    cm_j, cm_t = pair["cm_j"], pair["cm_t"]
    eng_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(
        batch_rows=1, rejuv_frequency=R_FREQ))
    eng_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(
        batch_rows=1, rejuv_frequency=R_FREQ), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(23), SEG)
    cap = cm_j.layouts[cid].capacity
    arenas = _rolled(pair, cid, base)
    aj, pj = jax.jit(lambda a, p, k: eng_j._sweep_segment(
        cid, a, p, base, k, cap))(to_jax(arenas), to_jax(pair["params"]),
                                  keys)
    plans = cm_j.cls(cid).plans
    pools = []
    for k in keys:
        subs = _plan_subkeys(jax.random.split(k, 4)[0], len(plans))
        pools.append([torch.as_tensor(np.asarray(jax.random.uniform(
            _pool_key(sub), (jprop._draw_bound(cm_j, cid, plan),))))[None]
            for sub, plan in zip(subs, plans)])
    p_in = to_torch(pair["params"], "cpu")
    at, pt = eng_t._sweep_segment(cid, to_torch(arenas, "cpu"), p_in, base,
                                  None, SEG, pools=pools)
    for c in aj:
        np.testing.assert_array_equal(np.asarray(aj[c]["alive"]),
                                      at[c]["alive"].numpy())
        for v in aj[c]["values"]:
            np.testing.assert_array_equal(np.asarray(aj[c]["values"][v]),
                                          at[c]["values"][v].numpy(),
                                          err_msg=f"{cid}: {c}.{v}")
    moved = 0
    for c, v in pj["__py__"].items():
        for k in v:
            np.testing.assert_array_equal(np.asarray(v[k]),
                                          pt["__py__"][c][k].numpy())
            moved += int(not torch.equal(pt["__py__"][c][k],
                                         p_in["__py__"][c][k]))
    assert moved > 0, "resample_all changed no Pitman-Yor parameter"


def _small_scaled():
    from pclean_tpu_torch.workloads import scaled

    cm, cfg = scaled.setup(rows=96, hospitals=12, counties=4, names=8,
                           zips=8, batch=1, device="cpu")[:2]
    cfg.rejuv_frequency = 7
    cfg.scan_segment = 40
    return cm, cfg


def _chain_pg():
    cm = _chain_model("cpu")
    cfg = tsmc.InferenceConfig(batch_rows=1, rejuv_frequency=5,
                               scan_segment=10, num_particles=3,
                               use_mh_instead_of_pg=False)
    return cm, cfg


def _loops(cm, cfg, seed):
    """init (scan_init over every row), one sweep, and a replay chunk of
    three observed rows, from one seed."""
    arenas, params = init_state(cm, seed, device="cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    arenas, params, gen = eng.initialize(seed + 1, arenas, params)
    arenas, params, gen = eng.run(gen, arenas, params)
    cid = cm.obs_specs[0].class_id
    arenas, lml = eng._replay_chunk(cid, arenas, params,
                                    np.array([3, 17, 11]), gen, True,
                                    eng._pg_P(False))
    return arenas, params, eng.log_ml, lml


@pytest.mark.parametrize("which", ["scaled", "chain pg"])
def test_same_seed_twice_is_bit_equal(which):
    cm, cfg = _small_scaled() if which == "scaled" else _chain_pg()
    row_graph.reset_stats()
    a = _loops(cm, cfg, 3)
    b = _loops(cm, cfg, 3)
    from pclean_tpu_torch.kernel_bench import _leaves

    assert [n for n, x, y in _leaves(a, b, "run")
            if not torch.equal(x, y)] == []
    # on the CPU every row is eager: nothing captured, nothing replayed
    assert row_graph.STATS and all(
        s["replayed"] == 0 and s["captures"] == 0 and s["eager"] > 0
        for s in row_graph.STATS.values())


@pytest.mark.parametrize("loop", ["ramp", "sweep"])
def test_params_leaves_keep_their_storage(monkeypatch, loop):
    """resample_all runs inside the segment (rejuv_frequency 7), draws
    into the leaves the step reads (out=) and hands back new tensors for
    the rest; the loop copies those into the leaves, whose storage stays
    the same, and returns them, leaving the caller's params as they
    were."""
    cm, cfg = _small_scaled()
    arenas, params = init_state(cm, 0, device="cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    if loop == "sweep":
        arenas, params, gen = eng.initialize(1, arenas, params)
    seen = []
    real = tsmc.resample_all

    def spy(cm_, arenas_, params_, obs, gen_, rel=None, out=None):
        seen.append({k: t.data_ptr() for k, t in _flat(params_)})
        return real(cm_, arenas_, params_, obs, gen_, rel=rel, out=out)

    monkeypatch.setattr(tsmc, "resample_all", spy)
    before = {k: t.clone() for k, t in _flat(params)}
    gen = torch.Generator().manual_seed(5)
    if loop == "ramp":
        run, _seg = eng.scan_init(cm.obs_specs[0].class_id, 40)
        _a, out, _l = run(arenas, params, 0, gen)
    else:
        _a, out = eng._sweep_segment("Record", arenas, params, 0, gen, 20)
    assert len(seen) >= 2
    assert all(s == seen[0] for s in seen)
    assert {k: t.data_ptr() for k, t in _flat(out)} == seen[0]
    assert any(not torch.equal(t, before[k]) for k, t in _flat(out))
    for k, t in _flat(params):
        assert torch.equal(t, before[k]), k


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], f"{path}/{k}")]
    return [(path, tree)] if torch.is_tensor(tree) else []


def test_row_graph_walks_its_slot_table():
    seen = []
    rg = row_graph.RowGraph(lambda s: seen.append(int(s)), "cpu", "t",
                            table=[5, 2, 9, 9, 0])
    for _ in range(5):
        rg.row()
    rg.close()
    assert seen == [5, 2, 9, 9, 0]
    seen.clear()
    rg = row_graph.RowGraph(lambda s: seen.append(int(s)), "cpu", "t",
                            base=7)
    for _ in range(3):
        rg.row()
    assert seen == [7, 8, 9]


def test_launch_count_snapshots_add_and_take_back():
    ops.reset_counts()
    base = ops.snapshot()
    ops._count("fk_score", 1, 40, "Hospital 1")
    ops._count("row_delta", 1, 3, "Record obs -1")
    delta = ops.counts_since(base)
    ops.add_counts(delta, -1)
    assert ops.snapshot() == base
    ops.add_counts(delta, 3)
    assert ops.LAUNCHES["fk_score"] == 3 and \
        ops.LAUNCH_CENSUS["fk_score"][("Hospital 1", "r1", 40)] == 3
    assert ops.LAUNCHES_BY_SHAPE["row_delta"]["r1"] == 3
    ops.reset_counts()


def test_copy_params_refuses_a_new_structure():
    a = {"__py__": {"C": {"strength": torch.ones(())}}}
    with pytest.raises(ValueError):
        row_graph.copy_params(a, {"__py__": {}})
    with pytest.raises(ValueError):
        row_graph.copy_params(a, {"__py__": {"C": {
            "strength": torch.ones((2,))}}})


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


def _card_model(which, dev, **cfg_kw):
    from pclean_tpu_torch.workloads import flights, hospital

    if which == "hospital":
        cm, cfg = hospital.setup(rows=240, batch=16, device=dev)[:2]
    elif which == "flights":
        cm, cfg = flights.setup(rows=300, flights=12, websites=8,
                                capacities={"Flight": 16,
                                            "TrackingWebsite": 16},
                                device=dev)[:2]
    else:
        cm, cfg = _chain_model(dev), tsmc.InferenceConfig(batch_rows=4)
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    cfg.rejuv_frequency = 16
    arenas, params = init_state(cm, 0, device=dev)
    eng = tsmc.Engine(cm, cfg, device=dev)
    fresh = (arenas, params)
    arenas, params, _g = eng.initialize(1, arenas, params)
    return eng, fresh, (arenas, params)


def _kinds(eng):
    cm = eng.cm
    obs = cm.obs_specs[0].class_id
    out = [("replay", obs, True), ("replay", obs, False)]
    for cid in cm.model.class_order:
        out.append(("sweep", cid, True))
    return obs, out


@pytest.mark.cuda
@pytest.mark.parametrize("which,pg", [("hospital", None), ("hospital", 16),
                                      ("hospital", "written"),
                                      ("flights", None), ("chain", None)])
def test_graph_replays_bit_equal_to_eager(card, which, pg):
    from pclean_tpu_torch.kernel_bench import graph_against_eager

    kw = {}
    if pg is not None:
        kw = dict(num_particles=16 if pg == 16 else 4,
                  use_mh_instead_of_pg=False,
                  collapse_exact_pg=pg == 16)
    eng, fresh, state = _card_model(which, card, **kw)
    P = eng._pg_P(False)
    obs, kinds = _kinds(eng)
    res = [graph_against_eager(eng, *fresh, "ramp", obs, 40,
                               pg_P=eng._pg_P(True))]
    for loop, cid, rejuv in kinds:
        rows = min(40, eng.cm.layouts[cid].capacity)
        res.append(graph_against_eager(eng, *state, loop, cid, rows,
                                       pg_P=P, rejuv=rejuv))
    for r in res:
        assert r["mismatches"] == [], r
        assert r["stats"]["captures"] == 1, r
        assert r["stats"]["replayed"] == r["rows"] - 1, r


@pytest.mark.cuda
def test_explicit_mh_comparison_graphs(card):
    from pclean_tpu_torch.kernel_bench import graph_against_eager

    eng, _fresh, state = _card_model("hospital", card,
                                     exact_gibbs_accept=False)
    assert not eng.exact_accept
    for cid in ("Record", "Hospital"):
        r = graph_against_eager(eng, *state, "sweep", cid, 40)
        assert r["mismatches"] == [] and r["kind"].endswith(" mh"), r
