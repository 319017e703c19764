"""K10 (ops.row_delta) and K11 (ops.row_write) on the CPU: their plain
versions, the kernels' plans and the one-row loops that own their carry.

  * parity: K10's plain version, in place on a copy of the relational
    state, bit-equal to pclean_tpu's refresh.row_delta (+1 and -1, chained
    over rows and out-of-range slots; and the port's out-of-place
    refresh.row_delta without props, which the batched path takes, where
    the propagated observations stay as they were), latent_row_delta (+1 and
    -1, with the row's fks rewritten between the two, with and without
    hop_move from the fk values the -1 call saved); K11's plain version, in
    place on a copy of the arenas, bit-equal to pclean_tpu's
    smc.apply_row (accept and reject, mark_alive on and off, births new
    and not, one at slot -1 under ok = False). On kernel_bench.row_state's
    numpy-seeded states (fk columns with out-of-range values) of the
    hospital model (240-row synth), the flights model (300-row synth) and
    tests/test_incremental.py's chain model. Ints bit-equal (no
    tolerance); floats copied, so equal too.
  * plan: K10's plan lists the fk tree in _fk_delta's recursion order on a
    model where one class is reached by two fk paths, and the hospital
    model's plans fit one launch's parameters (by value, <= 32,764 bytes)
    with its Record row's writes within K11's.
  * ownership: after _sweep_segment (an observed, a non-leaf latent and a
    leaf latent class), a scan_init segment and _replay_chunk (init and
    rejuvenation), the segment-entry snapshots (the refresh, referrer
    histograms, referrer lists and hop histograms taken at entry) and the
    caller's input arenas are unchanged, while the returned arenas moved;
    scan_init and the replays carry the refresh they build at entry,
    which is theirs to write and moved.

The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, -m cuda) and in chip_smoke.py's shadow runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu.engine import smc as jsmc
from pclean_tpu.engine.propose import Birth as JBirth
from pclean_tpu.engine.smc import _obs_device as j_obs_device
from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops
from pclean_tpu_torch.convert import to_numpy
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.propose import Birth as TBirth
from test_torch_flights import flights_pair
from test_torch_hospital import hospital_pair
from test_torch_host import (JNS, TNS, assert_rel_equal, chain, port_state,
                             to_jax)

MODELS = ("hospital", "flights", "chain")


class Model:
    def __init__(self, which):
        if which == "hospital":
            (self.cm_j, _c, _q), (self.cm_t, _ct, _qt), _d, _cl = \
                hospital_pair()
        elif which == "flights":
            (self.cm_j, _c, _q), (self.cm_t, _ct, _qt), _d, _cl = \
                flights_pair()
        else:
            (self.cm_j, _qj), (self.cm_t, _qt) = chain(JNS), chain(TNS)
        self.obs_j = j_obs_device(self.cm_j)
        self.obs_t = tsmc.Engine(self.cm_t, tsmc.InferenceConfig(),
                                 device="cpu").obs_dev
        self.obs_cid = self.cm_t.obs_specs[0].class_id

    def state(self, seed):
        at = kb.row_state(self.cm_t, seed, device="cpu")
        return at, to_jax(to_numpy(at))

    def latents(self):
        return [c for c in self.cm_t.model.class_order
                if not self.cm_t.layouts[c].observed
                and self.cm_t.layouts[c].fk_vertices]


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(which):
        if which not in built:
            built[which] = Model(which)
        return built[which]

    return get


def _slots(cap):
    """(slot, sign) in the order applied: adds and removals chained over
    live and dead rows, the last slot and one past it."""
    return [(0, -1), (0, 1), (3, -1), (cap - 1, -1), (cap, -1), (5, 1),
            (3, 1), (cap, 1), (7, -1)]


@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("which", MODELS)
def test_k10_plain_obs_mode_matches_jax_row_delta(models, which, props):
    m = models(which)
    at, aj = m.state(1)
    cid = m.obs_cid
    rj = jrefresh.refresh(m.cm_j, aj, m.obs_j)
    rt = trefresh.refresh(m.cm_t, at, m.obs_t)
    car = ops.RowCarry(m.cm_t, cid, at, rt, m.obs_t)
    for slot, sign in _slots(m.cm_t.layouts[cid].capacity):
        rj = jrefresh.row_delta(m.cm_j, rj, aj, m.obs_j, cid, slot, sign)
        what = f"{which} {cid} slot {slot} sign {sign}"
        if props:
            ops.row_delta(car, torch.tensor([slot]), sign, "obs")
            assert_rel_equal(rj, rt, what)
            continue
        r0 = rt
        rt = trefresh.row_delta(m.cm_t, rt, at, m.obs_t, cid, slot, sign,
                                props=False)
        for c in rj:
            for k in ("alive", "refcount", "total", "nrows"):
                np.testing.assert_array_equal(np.asarray(rj[c][k]),
                                              rt[c][k].numpy(),
                                              err_msg=f"{what} {c}.{k}")
            for v, pair in r0[c]["prop"].items():
                for x, y in zip(pair, rt[c]["prop"][v]):
                    assert torch.equal(x, y), f"{what} {c}.prop[{v}] moved"


@pytest.mark.parametrize("hops", [True, False])
@pytest.mark.parametrize("which", ["hospital", "chain"])
def test_k10_plain_latent_mode_matches_jax(models, which, hops):
    """(The flights model's latent classes have no fks: its sweeps run K10
    in obs mode only.)"""
    m = models(which)
    at, aj = m.state(2)
    rng = np.random.default_rng(2)
    n_checked = 0
    for cid in m.latents():
        fkvs = m.cm_t.layouts[cid].fk_vertices
        cap = m.cm_t.layouts[cid].capacity
        rj = jrefresh.refresh(m.cm_j, aj, m.obs_j)
        rt = trefresh.refresh(m.cm_t, at, m.obs_t)
        hj = jrefresh.hop_histograms(m.cm_j, cid, aj, m.obs_j)
        ht = trefresh.hop_histograms(m.cm_t, cid, at, m.obs_t)
        assert len(hj) == len(ht)
        a_own, r_own = tsmc.own_carry(m.cm_t, cid, at, rt)
        car = ops.RowCarry(m.cm_t, cid, a_own, r_own, m.obs_t,
                           ht if hops else None)
        aj2 = aj
        saved = torch.zeros((len(fkvs),), dtype=torch.int64)
        for slot in (0, 2, cap - 1, cap):
            st = torch.tensor([slot])
            what = f"{which} {cid} slot {slot}"
            rj = jrefresh.latent_row_delta(m.cm_j, rj, aj2, cid, slot, -1)
            ops.row_delta(car, st, -1, "latent", save_fk=saved)
            assert_rel_equal(rj, r_own, what + " -1")
            old_j = {v: aj2[cid]["values"][v][min(slot, cap - 1)]
                     for v in fkvs}
            assert saved.tolist() == [int(old_j[v]) for v in fkvs]
            if slot < cap:   # rewrite the row's fks (some out of range)
                vals = dict(aj2[cid]["values"])
                for v in fkvs:
                    tcap = m.cm_t.layouts[m.cm_t.node(cid, v)
                                          .target_class].capacity
                    new = int(rng.integers(0, tcap + 1))
                    vals[v] = vals[v].at[slot].set(new)
                    a_own[cid]["values"][v][slot] = new
                aj2 = {**aj2, cid: {**aj2[cid], "values": vals}}
            rj = jrefresh.latent_row_delta(m.cm_j, rj, aj2, cid, slot, +1)
            if hops:
                rj = jrefresh.hop_move(m.cm_j, rj, aj2, cid, slot, old_j, hj)
            ops.row_delta(car, st, +1, "latent", old_fk=saved)
            assert_rel_equal(rj, r_own, what + " +1")
            n_checked += 1
    assert n_checked


def _row(m, cid, rng, slot, new_births):
    """One row's env2 (every stored vertex of cid) and births (one a fk
    of cid, with two stored vertices of its class, new or not as
    `new_births` says, the last at slot -1 and not new) for both
    packages."""
    cm = m.cm_t
    lay = cm.layouts[cid]
    env_t, env_j = {}, {}
    for v, dt in lay.store.items():
        if v in lay.fk_vertices:
            hi = cm.layouts[cm.node(cid, v).target_class].capacity
        else:
            hi = 4
        x = rng.integers(0, hi) if dt == "i" else rng.random()
        env_t[v] = torch.tensor([x], dtype=torch.int64 if dt == "i"
                                else torch.float32)
        env_j[v] = jnp.asarray(x, jnp.int32 if dt == "i" else jnp.float32)
    b_t, b_j = [], []
    for i, fkv in enumerate(lay.fk_vertices):
        tc = cm.node(cid, fkv).target_class
        tl = cm.layouts[tc]
        last = i == len(lay.fk_vertices) - 1
        bslot = -1 if last else int(rng.integers(0, tl.capacity))
        new = bool(new_births) and not last
        vals = {}
        for v, dt in list(tl.store.items())[:2]:
            vals[v] = rng.integers(0, 4) if dt == "i" else rng.random()
        b_t.append(TBirth(fkv, tc, torch.tensor([new]),
                          torch.tensor([bslot]),
                          {v: torch.tensor([x]) for v, x in vals.items()}))
        b_j.append(JBirth(fkv, tc, jnp.asarray(new), jnp.asarray(bslot),
                          {v: jnp.asarray(x) for v, x in vals.items()}))
    return (env_t, b_t), (env_j, b_j)


@pytest.mark.parametrize("mark_alive", [True, False])
@pytest.mark.parametrize("accept", [True, False])
@pytest.mark.parametrize("which", MODELS)
def test_k11_plain_matches_jax_apply_row(models, which, accept, mark_alive):
    m = models(which)
    at, aj = m.state(3)
    rng = np.random.default_rng(4)
    for cid in [m.obs_cid] + m.latents():
        a_own, _r = tsmc.own_carry(m.cm_t, cid, at)
        car = ops.RowCarry(m.cm_t, cid, a_own)
        aj2 = aj
        cap = m.cm_t.layouts[cid].capacity
        for k, slot in enumerate((1, cap - 1, 4)):
            (env_t, b_t), (env_j, b_j) = _row(m, cid, rng, slot, k % 2 == 0)
            aj2 = jsmc.apply_row(m.cm_j, cid, aj2, slot, env_j, b_j,
                                 jnp.asarray(accept), mark_alive)
            ops.row_write(car, torch.tensor([slot]), env_t, b_t,
                          torch.tensor([accept]), mark_alive)
            for c in aj2:
                for v, x in aj2[c]["values"].items():
                    np.testing.assert_array_equal(
                        np.asarray(x), a_own[c]["values"][v].numpy(),
                        err_msg=f"{which} {cid} slot {slot}: {c}.{v}")
                np.testing.assert_array_equal(
                    np.asarray(aj2[c]["alive"]), a_own[c]["alive"].numpy(),
                    err_msg=f"{which} {cid} slot {slot}: {c}.alive")


def diamond(ns):
    """A Row whose two fks reach class C by two paths (Row.a -> A -> C and
    Row.b -> B2 -> C), C's value observed through the second."""
    b = ns.B()
    with b.cls("C") as c:
        c.choice("x", ns.d.ChooseUniformly(["p", "q", "r"]))
    with b.cls("A") as c:
        c.fk("c", "C")
        c.choice("y", ns.d.ChooseUniformly(["u", "v"]))
    with b.cls("B2") as c:
        c.fk("c", "C")
        c.choice("z", ns.d.ChooseUniformly(["s", "t"]))
    with b.cls("Row") as c:
        c.fk("a", "A")
        c.fk("b", "B2")
    model = b.finish()
    q = ns.Q.build(model, "Row", [("y", "a.y"), ("x", "b.c.x")])
    ds = ns.DS(q, {"y": ["u", "v", "u", "u"], "x": ["p", "q", "p", "r"]})
    return ns.compile(model, [ds], capacities={"A": 4, "B2": 4, "C": 4},
                      **ns.kw)


class _Order(dict):
    """A rel dict that records the classes _fk_delta writes, in order."""

    def __init__(self, *a):
        super().__init__(*a)
        self.order = []

    def __setitem__(self, k, v):
        self.order.append(k)
        super().__setitem__(k, v)


def test_k10_plan_is_fk_delta_recursion_order_on_two_paths():
    cm_j, cm_t = diamond(JNS), diamond(TNS)
    plan = ops.row_delta_plan(cm_t, "Row", "obs")
    tcs = [n["tc"] for n in plan["nodes"]]
    assert tcs == ["A", "C", "B2", "C"]
    assert [n["parent"] for n in plan["nodes"]] == [-1, 0, -1, 2]
    assert [n["root"] for n in plan["nodes"]] == [0, -1, 1, -1]
    assert [n["col"] for n in plan["nodes"]] == [
        ("Row", cm_t.layouts["Row"].fk_vertices[0]),
        ("A", cm_t.layouts["A"].fk_vertices[0]),
        ("Row", cm_t.layouts["Row"].fk_vertices[1]),
        ("B2", cm_t.layouts["B2"].fk_vertices[0])]
    arenas = to_jax(to_numpy(kb.row_state(cm_t, 5, device="cpu")))
    rel = _Order(jrefresh.refresh(cm_j, arenas, j_obs_device(cm_j)))
    jrefresh._fk_delta(cm_j, rel, arenas, "Row", 0, 1, jnp.asarray(True))
    assert rel.order == tcs
    # both observed columns land on submodel vertices: a.y one hop down,
    # b.c.x two; their targets differ, so they take lanes of their own
    assert [(len(e["chain"]), e["target"][0], e["lane"])
            for e in plan["props"]] == [(1, "A", 0), (2, "C", 1)]


def test_hospital_plans_fit_one_launch(models):
    m = models("hospital")
    cm = m.cm_t
    assert ops.K10_PARAM_BYTES <= ops.PARAM_MAX
    assert ops.K11_PARAM_BYTES <= ops.PARAM_MAX
    for cid in [m.obs_cid] + m.latents():
        mode = "obs" if cid == m.obs_cid else "latent"
        for hop in ((False,) if mode == "obs" else (False, True)):
            plan = ops.row_delta_plan(cm, cid, mode, hop)
            assert len(plan["words"]) <= ops.K10_WORDS
    assert len(ops.row_delta_plan(cm, "Record", "obs")["nodes"]) == 6
    arenas, params = port_state_cpu(cm)
    eng = tsmc.Engine(cm, tsmc.InferenceConfig(), device="cpu")
    rel = trefresh.refresh(cm, arenas, eng.obs_dev)
    st = torch.tensor([0])
    env2, births, _w = eng._propose("Record", arenas, rel, params, st,
                                    torch.Generator().manual_seed(0), False)
    writes = ops.row_write_writes(ops.RowCarry(cm, "Record", arenas), st,
                                  env2, births, None, True)
    assert 0 < len(writes) <= ops.K11_MAX_WRITES


def port_state_cpu(cm):
    from pclean_tpu_torch.engine.compile import init_state
    return init_state(cm, 0, device="cpu")


# ----------------------------------------------------------- ownership


def _snap(x):
    return [t.clone() for t in _flat(x)]


def _flat(x):
    if isinstance(x, dict):
        return [t for k in sorted(x, key=str) for t in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x] if torch.is_tensor(x) else []


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def chain_state():
    (cm, _q) = chain(TNS)
    cfg = tsmc.InferenceConfig(batch_rows=1, rejuv_frequency=7)
    arenas, params = port_state(cm, cfg)
    return cm, cfg, arenas, params


@pytest.mark.parametrize("loop", ["sweep Record", "sweep Hospital",
                                  "sweep County", "scan_init",
                                  "replay init", "replay rejuv"])
def test_loops_leave_snapshots_and_inputs_unchanged(chain_state, loop,
                                                     monkeypatch):
    from pclean_tpu_torch.convert import to_torch

    cm, cfg, arenas_np, params_np = chain_state
    arenas, params = to_torch(arenas_np, "cpu"), to_torch(params_np, "cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    taken = []   # (what, its tensors, their copies) of every snapshot

    def spy(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            taken.append((name, _flat(out), _snap(out)))
            return out
        return wrapped

    monkeypatch.setattr(tsmc, "refresh", spy("refresh", tsmc.refresh))
    monkeypatch.setattr(tsmc, "hop_histograms",
                        spy("hop_histograms", tsmc.hop_histograms))
    monkeypatch.setattr(eng, "_ext_hists", spy("hists", eng._ext_hists))
    monkeypatch.setattr(eng, "_ref_comp", spy("comp", eng._ref_comp))
    # the swept class's stored values rolled by one row, so that the loop
    # rewrites them
    cid = loop.split()[1] if loop.startswith("sweep") else "Record"
    vals = arenas[cid]["values"]
    for v in vals:
        vals[v] = torch.roll(vals[v], 1)
    before = _snap(arenas)
    gen = torch.Generator().manual_seed(0)
    if loop.startswith("sweep"):
        out, _p = eng._sweep_segment(cid, arenas, params, 0, gen, 12)
    elif loop == "scan_init":
        cfg.scan_segment = 12
        run, _seg = eng.scan_init("Record", 24)
        out, _p, _l = run(arenas, params, 4, gen)
    else:
        out, _l = eng._replay_chunk("Record", arenas, params,
                                    np.arange(2, 14), gen,
                                    rejuv=loop == "replay rejuv")
    assert taken and _same(_flat(arenas), before), "the input arenas moved"
    if loop == "scan_init" or loop.startswith("replay"):
        name, ts, copies = taken.pop(0)
        assert name == "refresh" and not _same(ts, copies), \
            "the loop did not carry its entry refresh"
    for name, ts, copies in taken:
        assert _same(ts, copies), f"the segment wrote into {name}"
    assert not _same(_flat(out), before), "the loop wrote nothing"
