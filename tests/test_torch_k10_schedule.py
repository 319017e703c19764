"""K10's plan (ops.row_delta_plan) read as csrc/row_delta.cu reads it, on
the CPU.

`run_k10` is the kernel written out in Python over the plan's words, bound
to CPU tensors (ops._k10_words with card=False), reading and writing
through the words' addresses as the kernel does: warp 0 a lane a node,
phase A level by level, phase B in the plan's rounds, phase C's last
writers and counters; warp 1 a lane a chain target, its entries linked
from the header's lane table. A value written in a
level or a round is seen only after it (a __syncwarp), so a schedule that
reads too early reads the value from before. Held bit for bit to K10's
plain version (ops.row_delta_plain) and to pclean_tpu's row_delta,
latent_row_delta and hop_move, in obs, latent and hop mode, both signs,
over live, dead and out-of-range slots of seeded states (fk values out of
range among them) of the hospital, flights, chain and a two-path model,
and to the plain version on the limits model, whose classes are reached
by many paths (S and T eight times each). The tier of every class's plan
on the six paths' models and the limits model.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.engine import refresh as jrefresh
from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops
from pclean_tpu_torch.convert import to_numpy
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc
from test_torch_host import JNS, TNS, assert_rel_equal, to_jax
from test_torch_row_kernels import Model, _slots, diamond

_CT = {0: ctypes.c_uint8, 1: ctypes.c_int8, 2: ctypes.c_uint8,
       3: ctypes.c_int16, 4: ctypes.c_int32, 5: ctypes.c_int64,
       6: ctypes.c_float, 7: ctypes.c_double}
I32, U8, I64 = 4, 2, 5


def ld(p, dt, i):
    """row_words.cuh's pclean_ld_i: p[i] as an integer, a float truncated
    toward zero."""
    c = _CT[dt]
    v = c.from_address(p + i * ctypes.sizeof(c)).value
    return int(v) if dt < 6 else int(np.trunc(v))


def st(p, dt, i, v):
    """pclean_st_i: p[i] = v narrowed as a C cast, a bool v != 0."""
    c = _CT[dt]
    if dt == 0:
        v = int(v != 0)
    elif dt < 6:
        bits = 8 * ctypes.sizeof(c)
        v &= (1 << bits) - 1
        if dt != 2 and v >= 1 << (bits - 1):
            v -= 1 << bits
    c.from_address(p + i * ctypes.sizeof(c)).value = v


def clamp(i, n):
    return 0 if i < 0 else (n - 1 if i >= n else i)


def ld_col(p, lendt, i):
    return ld(p, lendt & 15, clamp(i, lendt >> 4))


def run_k10(words, slot, sign, save_fk=None, old_fk=None):
    """csrc/row_delta.cu's kernel over the bound words (a ctypes array):
    slot an int64 CPU tensor of one element, save_fk / old_fk int64 CPU
    tensors or None."""
    w = list(words)
    NODES, HOPS, _P = ops.K10_TIERS[w[7]]
    NPL = (NODES + 31) // 32
    mode, n_nodes, n_props = w[0], w[1], w[2]
    s = ld(slot.data_ptr(), I64, 0)
    m = 0 <= s < w[3] and ld_col(w[4], w[5], s) != 0
    nodes = [w[ops.K10_HEAD + ops.K10_NODE * i:][:ops.K10_NODE]
             for i in range(n_nodes)]
    f = lambda nd, k: (nd[5] >> (8 * k)) & 255  # noqa: E731
    cb = ops.K10_HEAD + ops.K10_NODE * NODES
    cnts = [w[cb + ops.K10_COUNTER * c:][:ops.K10_COUNTER]
            for c in range(w[6])]
    mine = lambda lane: [i for k in range(NPL)  # noqa: E731
                         for i in [lane + 32 * k] if i < n_nodes]
    # the counters, loaded first
    tot = [ld(q[0], q[2] & 15, 0) for q in cnts]
    nr = [ld(q[1], (q[2] >> 4) & 15, 0) for q in cnts]
    # A: level by level; a level's t is seen after its __syncwarp
    sh_t, t = {}, {}
    for level in range(1, w[8] + 1):
        new = {}
        for lane in range(32):
            for i in mine(lane):
                nd = nodes[i]
                if f(nd, 0) != level:
                    continue
                parent, root = f(nd, 2) - 1, f(nd, 3)
                ti = ld_col(nd[0], nd[1], s if parent < 0 else sh_t[parent])
                t[i] = new[i] = ti
                if root > 0 and save_fk is not None:
                    st(save_fk.data_ptr(), I64, root - 1, ti)
        sh_t.update(new)
    rc0 = {i: ld(nd[2], I32, clamp(t[i], nd[4])) for i, nd in
           enumerate(nodes)}
    al0 = {i: int(ld(nd[3], U8, clamp(t[i], nd[4])) != 0) for i, nd in
           enumerate(nodes)}
    # B: the plan's rounds; a round's values are seen after its __syncwarp
    d0 = sign * int(m)
    sh = {}
    for r in range(1, w[9] + 1):
        new = {}
        for lane in range(32):
            for i in mine(lane):
                nd = nodes[i]
                if f(nd, 1) != r:
                    continue
                parent, cap = f(nd, 2) - 1, nd[4]
                inb = 0 <= t[i] < cap
                tc = clamp(t[i], cap)
                dd = (d0 if parent < 0 else sh[parent][2]) if inb else 0
                rc, al = rc0[i], al0[i]
                j = f(nd, 4) - 1
                while j >= 0:
                    if sh_t[j] == tc:
                        rc, al = sh[j][0], sh[j][1]
                        break
                    j = f(nodes[j], 4) - 1
                rc = ctypes.c_int32(rc + dd).value
                now = int(rc > 0)
                new[i] = (rc, now if inb else al, now - al, dd)
        sh.update(new)
    # C: the last writer of each index; each counter once
    for i, nd in enumerate(nodes):
        if not 0 <= t[i] < nd[4]:
            continue
        j, last = f(nd, 5) - 1, True
        while j >= 0:
            if sh_t[j] == t[i]:
                last = False
                break
            j = f(nodes[j], 5) - 1
        if last:
            st(nd[2], I32, t[i], sh[i][0])
            st(nd[3], U8, t[i], sh[i][1])
    for c, q in enumerate(cnts):
        mask = q[3] & (1 << 64) - 1
        idx = [i for i in range(64) if mask >> i & 1]
        st(q[0], q[2] & 15, 0, tot[c] + sum(sh[i][3] for i in idx))
        st(q[1], (q[2] >> 4) & 15, 0, nr[c] + sum(sh[i][2] for i in idx))
    # warp 1: a lane a chain target, its entries in order
    pb = cb + ops.K10_COUNTER * NODES
    pw = 10 + 2 * HOPS
    seen = []
    for lane in range(32):
        j = ((w[ops.K10_LANES + lane // 8] >> (8 * (lane % 8))) & 255) - 1
        while j >= 0:
            pr = w[pb + pw * j:][:pw]
            pk = pr[3]
            assert (pk >> 8) & 255 == lane and j < n_props
            seen.append(j)
            j = ((pk >> 32) & 255) - 1
            code, cnt, cap_t = pr[0], pr[1], pr[2]
            cdt, ndt, nh = pk & 15, (pk >> 4) & 15, (pk >> 24) & 255
            if mode == 0:
                cv = ld_col(pr[4], pr[5], s)
                sm = m and ld_col(pr[6], pr[7], s) == 1
                tt = ld_col(pr[10], pr[11], s) if nh else s
                for h in range(1, nh):
                    tt = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], tt)
                if not 0 <= tt < cap_t:
                    continue
                cur = ld(code, cdt, tt)
                c = ld(cnt, ndt, tt) + sign * int(sm)
                st(cnt, ndt, tt, c)
                if sign > 0:
                    v = cv if sm else 0
                    st(code, cdt, tt, max(v, cur))
                elif c <= 0:
                    st(code, cdt, tt, 0)
                continue
            g, gc = ld_col(pr[4], pr[5], s), ld_col(pr[6], pr[7], s)
            of = ld(old_fk.data_ptr(), I64, (pk >> 16) & 255)
            nf = ld_col(pr[8], pr[9], s)
            for h in range(nh):
                of = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], of)
                nf = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], nf)
            oin, nin = 0 <= of < cap_t, 0 <= nf < cap_t
            oc, nc = clamp(of, cap_t), clamp(nf, cap_t)
            c_of, k_of = ld(cnt, ndt, oc), ld(code, cdt, oc)
            c_nf, k_nf = ld(cnt, ndt, nc), ld(code, cdt, nc)
            if oin:
                c = c_of - g
                st(cnt, ndt, of, c)
                if c <= 0:
                    st(code, cdt, of, 0)
                if nf == of:
                    c_nf, k_nf = c, 0 if c <= 0 else k_of
            if nin:
                st(cnt, ndt, nf, c_nf + g)
                v = gc if g > 0 else 0
                st(code, cdt, nf, max(v, k_nf))
    assert sorted(seen) == list(range(n_props))   # each entry on one lane


def run(car, slot, sign, mode, save_fk=None, old_fk=None):
    """ops.row_delta's launch, with run_k10 in the kernel's place."""
    hop = mode == "latent" and sign == 1 and bool(car.hops)
    plan = ops.row_delta_plan(car.cm, car.cid, mode, hop)
    run_k10(ops._k10_words(plan, car, card=False), slot, sign,
            save_fk, old_fk if hop else None)


def _copy(x):
    return kb._tree_map(x, lambda t: t.clone())


def _assert_same(a, b, what):
    for name, x, y in kb._leaves(a, b, what):
        assert torch.equal(x, y), name


class Diamond(Model):
    """The two-path model of test_torch_row_kernels (Row.a -> A -> C and
    Row.b -> B2 -> C) in Model's form."""

    def __init__(self):
        self.cm_j, self.cm_t = diamond(JNS), diamond(TNS)
        from pclean_tpu.engine.smc import _obs_device
        self.obs_j = _obs_device(self.cm_j)
        self.obs_t = tsmc.Engine(self.cm_t, tsmc.InferenceConfig(),
                                 device="cpu").obs_dev
        self.obs_cid = self.cm_t.obs_specs[0].class_id


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(which):
        if which not in built:
            built[which] = Diamond() if which == "diamond" else Model(which)
        return built[which]

    return get


@pytest.mark.parametrize("which", ["hospital", "flights", "chain",
                                   "diamond"])
def test_k10_schedule_obs_mode_matches_plain_and_jax(models, which):
    m = models(which)
    at, aj = m.state(11)
    cid = m.obs_cid
    rj = jrefresh.refresh(m.cm_j, aj, m.obs_j)
    rt = trefresh.refresh(m.cm_t, at, m.obs_t)
    rp = _copy(rt)
    car = ops.RowCarry(m.cm_t, cid, at, rt, m.obs_t)
    carp = ops.RowCarry(m.cm_t, cid, at, rp, m.obs_t)
    for slot, sign in _slots(m.cm_t.layouts[cid].capacity):
        what = f"{which} {cid} slot {slot} sign {sign}"
        rj = jrefresh.row_delta(m.cm_j, rj, aj, m.obs_j, cid, slot, sign)
        run(car, torch.tensor([slot]), sign, "obs")
        ops.row_delta_plain(carp, torch.tensor([slot]), sign, "obs")
        assert_rel_equal(rj, rt, what)
        _assert_same(rt, rp, what)


@pytest.mark.parametrize("hops", [True, False])
@pytest.mark.parametrize("which", ["hospital", "chain", "diamond"])
def test_k10_schedule_latent_mode_matches_plain_and_jax(models, which,
                                                        hops):
    m = models(which)
    at, aj = m.state(12)
    rng = np.random.default_rng(12)
    n = 0
    for cid in m.latents():
        fkvs = m.cm_t.layouts[cid].fk_vertices
        cap = m.cm_t.layouts[cid].capacity
        rj = jrefresh.refresh(m.cm_j, aj, m.obs_j)
        rt = trefresh.refresh(m.cm_t, at, m.obs_t)
        hj = jrefresh.hop_histograms(m.cm_j, cid, aj, m.obs_j)
        ht = trefresh.hop_histograms(m.cm_t, cid, at, m.obs_t)
        a_own, r_own = tsmc.own_carry(m.cm_t, cid, at, rt)
        r_p = _copy(r_own)
        car = ops.RowCarry(m.cm_t, cid, a_own, r_own, m.obs_t,
                           ht if hops else None)
        carp = ops.RowCarry(m.cm_t, cid, a_own, r_p, m.obs_t,
                            ht if hops else None)
        aj2 = aj
        saved = torch.zeros((len(fkvs),), dtype=torch.int64)
        saved_p = saved.clone()
        for slot in (0, 2, cap - 1, cap):
            st_ = torch.tensor([slot])
            what = f"{which} {cid} slot {slot}"
            rj = jrefresh.latent_row_delta(m.cm_j, rj, aj2, cid, slot, -1)
            run(car, st_, -1, "latent", save_fk=saved)
            ops.row_delta_plain(carp, st_, -1, "latent", save_fk=saved_p)
            assert_rel_equal(rj, r_own, what + " -1")
            assert torch.equal(saved, saved_p)
            old_j = {v: aj2[cid]["values"][v][min(slot, cap - 1)]
                     for v in fkvs}
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
            run(car, st_, +1, "latent", old_fk=saved)
            ops.row_delta_plain(carp, st_, +1, "latent", old_fk=saved_p)
            assert_rel_equal(rj, r_own, what + " +1")
            _assert_same(r_own, r_p, what + " +1")
            n += 1
    assert n


@pytest.fixture(scope="module")
def limits_model():
    from pclean_tpu_torch.workloads import limits

    cm = limits.setup(device="cpu")[0]
    eng = tsmc.Engine(cm, tsmc.InferenceConfig(), device="cpu")
    return cm, eng


@pytest.mark.parametrize("kind", ["obs", "latent"])
def test_k10_schedule_matches_plain_on_many_paths(limits_model, kind):
    """The limits model: Record's tree reaches S and T eight times each
    (rounds and the class links do the ordering), 29 nodes in the largest
    block, chains of up to 9 hops; latent classes with hop entries."""
    cm, eng = limits_model
    arenas = kb.row_state(cm, 21, oob=0.2, device="cpu")
    rel = trefresh.refresh(cm, arenas, eng.obs_dev)
    cids = [c for c in cm.model.class_order if cm.layouts[c].fk_vertices
            and cm.layouts[c].observed == (kind == "obs")]
    assert cids
    rng = np.random.default_rng(21)
    for cid in cids:
        lay = cm.layouts[cid]
        hops = [] if kind == "obs" else \
            trefresh.hop_histograms(cm, cid, arenas, eng.obs_dev)
        a, r = tsmc.own_carry(cm, cid, arenas, rel)
        rp = _copy(r)
        car = ops.RowCarry(cm, cid, a, r, eng.obs_dev, hops)
        carp = ops.RowCarry(cm, cid, a, rp, eng.obs_dev, hops)
        fk = torch.zeros((len(lay.fk_vertices),), dtype=torch.int64)
        fkp = fk.clone()
        for s in rng.integers(-1, lay.capacity + 1, 12):
            st_ = torch.tensor([int(s)])
            run(car, st_, -1, kind, save_fk=fk)
            ops.row_delta_plain(carp, st_, -1, kind, save_fk=fkp)
            run(car, st_, +1, kind, old_fk=fk)
            ops.row_delta_plain(carp, st_, +1, kind, old_fk=fkp)
            _assert_same(r, rp, f"limits {cid} slot {s}")
            assert torch.equal(fk, fkp)


def test_k10_schedule_orders_a_class_reached_twice():
    """The two-path model's plan: C reached under A and under B2 takes
    one lane each, linked in DFS order, the second node's round after the
    first's."""
    plan = ops.row_delta_plan(diamond(TNS), "Row", "obs")
    nodes = plan["nodes"]
    assert [n["tc"] for n in nodes] == ["A", "C", "B2", "C"]
    assert [n["depth"] for n in nodes] == [1, 2, 1, 2]
    assert [(n["prev"], n["next"]) for n in nodes] == [
        (-1, -1), (-1, 3), (-1, -1), (1, -1)]
    assert [n["round"] for n in nodes] == [1, 2, 1, 3]
    assert dict(plan["counters"]) == {"A": 1, "C": 0b1010, "B2": 4}


def test_k10_classes_sharing_counters_take_one_record(models):
    """Where two classes' total and nrows are the same two tensors, their
    nodes' sums go to one counter record; one tensor shared alone
    raises."""
    m = models("diamond")
    at, _aj = m.state(3)
    rt = trefresh.refresh(m.cm_t, at, m.obs_t)
    plan = ops.row_delta_plan(m.cm_t, "Row", "obs")
    words = ops._k10_words(plan, ops.RowCarry(m.cm_t, "Row", at, rt,
                                              m.obs_t), card=False)
    assert words[6] == 3
    rt["B2"]["total"], rt["B2"]["nrows"] = rt["A"]["total"], rt["A"]["nrows"]
    words = ops._k10_words(plan, ops.RowCarry(m.cm_t, "Row", at, rt,
                                              m.obs_t), card=False)
    base = ops.K10_HEAD + ops.K10_NODE * ops.K10_TIERS[plan["tier"]][0]
    assert words[6] == 2 and words[base + 3] == 0b0101
    rt["B2"]["nrows"] = rt["C"]["nrows"]
    with pytest.raises(ValueError):
        ops._k10_words(plan, ops.RowCarry(m.cm_t, "Row", at, rt, m.obs_t),
                       card=False)


def _tiers(cm):
    out = {}
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        for mode, hop in ([("obs", False)] if lay.observed else
                          [("latent", False), ("latent", True)]):
            plan = ops.row_delta_plan(cm, cid, mode, hop)
            assert len(plan["words"]) <= ops.k10_words(plan["tier"])
            if plan["nodes"] or plan["props"]:
                out[(cid, mode, hop)] = plan["tier"]
    return out


def test_k10_tiers_of_every_class():
    """The six paths sweep row by row in tier 0; the limits model fills
    tiers 0 and 1 (its Record and C0 past 24 nodes); a plan past tier 0's
    nodes, chains or hops takes tier 1."""
    from pclean_tpu_torch.workloads import (flights, hospital, limits, rents,
                                            scaled)

    assert ops.k10_words(0) < ops.k10_words(1)
    assert 8 * ops.k10_words(1) + 32 == ops.K10_PARAM_BYTES <= ops.PARAM_MAX
    got = {}
    for name, cm in (
            ("hospital", hospital.setup(rows=60, device="cpu")[0]),
            ("flights", flights.setup(rows=60, flights=6, websites=4,
                                      device="cpu")[0]),
            ("scaled", scaled.setup(rows=400, counties=20, hospitals=40,
                                    names=30, zips=10, device="cpu")[0]),
            ("rents", rents.setup(rows=200, states=51, counties=40,
                                  device="cpu")[0]),
            ("limits", limits.setup(device="cpu")[0])):
        got.update({(name,) + k: v for k, v in _tiers(cm).items()})
    census = [("hospital", "Record", "obs", False),
              ("flights", "Obs", "obs", False),
              ("scaled", "Record", "obs", False),
              ("rents", "Obs", "obs", False)]
    assert all(k in got for k in census)
    for k, tier in got.items():
        if k[0] != "limits":
            assert tier == 0, k
    assert {k[1]: v for k, v in got.items()
            if k[0] == "limits" and not k[3]} == {
        "S": 0, "C8": 0, "C7": 0, "C6": 0, "C5": 0, "C4": 0, "C3": 0,
        "C2": 0, "C1": 0, "C0": 1, "Record": 1}
    assert ops.k10_tier(24, 32, 6) == 0 and ops.k10_tier(25, 0, 0) == 1
    assert ops.k10_tier(1, 33, 0) == 1 and ops.k10_tier(2, 1, 7) == 1


def test_k10_dep_loads_bound_the_schedule(models):
    """kernel_bench.k10_dep_loads (the rounds the function needs) is at
    most the kernel's schedule's rounds for every class's plan, in every
    mode, on the six paths' models, the limits model, the chain model and
    the two-path model; at the census shapes the schedule takes no more
    rounds than the function needs."""
    from pclean_tpu_torch.workloads import (flights, hospital, limits, rents,
                                            scaled)

    got = {}
    for name, cm in (
            ("hospital", hospital.setup(rows=60, device="cpu")[0]),
            ("flights", flights.setup(rows=60, flights=6, websites=4,
                                      device="cpu")[0]),
            ("scaled", scaled.setup(rows=400, counties=20, hospitals=40,
                                    names=30, zips=10, device="cpu")[0]),
            ("rents", rents.setup(rows=200, states=51, counties=40,
                                  device="cpu")[0]),
            ("limits", limits.setup(device="cpu")[0]),
            ("chain", models("chain").cm_t),
            ("diamond", models("diamond").cm_t)):
        for cid in cm.model.class_order:
            lay = cm.layouts[cid]
            for mode, hop in ([("obs", False)] if lay.observed else
                              [("latent", False), ("latent", True)]):
                plan = ops.row_delta_plan(cm, cid, mode, hop)
                got[(name, cid, mode, hop)] = (
                    kb.k10_dep_loads(plan), kb.k10_schedule_rounds(plan))
    for k, (dep, rounds) in got.items():
        assert 1 <= dep <= rounds, k
    assert {k: got[k] for k in (("hospital", "Record", "obs", False),
                                ("flights", "Obs", "obs", False),
                                ("scaled", "Record", "obs", False),
                                ("rents", "Obs", "obs", False))} == {
        ("hospital", "Record", "obs", False): (5, 5),
        ("flights", "Obs", "obs", False): (3, 3),
        ("scaled", "Record", "obs", False): (4, 4),
        ("rents", "Obs", "obs", False): (3, 3)}
