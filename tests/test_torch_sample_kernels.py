"""The block proposal's sample pass and row lookups through K16-K19.

K16 fk_sample, K17 choice_sample, K18 row_gather and K19 branch_select
carry BlockTracer.sample's foreign-key and choice steps, its record picks,
row_value's fk-chain gathers and a foreign key's branch select. On the CPU
their plain versions run; fed pclean_tpu's own uniform pool
(propose.py:897-904), they must give pclean_tpu's sampled values, births
and working alive masks exactly: the drawn and the retained form, a
retained-dead slot, a retained value outside the enumerated support (the
dummy code), a full arena (the argmax fallback) and two foreign keys of
one block into one class, on the scaled CPU model, the hospital model's
240-row tables, the flights model and a two-key toy model. row_value (K18's
plain version) against pclean_tpu's on every vertex of every hospital
class at slot tensors of rank 0-2. The `cuda` tests hold each kernel to
its plain version on the card and skip without one.
"""
import ctypes

import numpy as np
import pytest
import torch

from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops
from pclean_tpu_torch.convert import to_numpy, to_torch
from pclean_tpu_torch.engine import propose as tprop

# the CPU tests import jax and pclean_tpu inside: the card has neither
NINF = -1e30


def twofk(ns, cap=6):
    """Two foreign keys of one block into one class: Pair -> Person
    twice, each with a typo-observed name; Person's StringPrior name has a
    dummy code."""
    names = ["ann", "ben", "cat", "dan"]
    b = ns.B()
    with b.cls("Person") as c:
        c.choice("name", ns.d.StringPrior(1, 10, names))
    with b.cls("Pair") as c:
        c.fk("a", "Person")
        c.fk("b", "Person")
        c.choice("a_obs", ns.d.AddTypos(ns.d.Ref("a.name")))
        c.choice("b_obs", ns.d.AddTypos(ns.d.Ref("b.name")))
    model = b.finish()
    q = ns.Q.build(model, "Pair", [("a", "a.name", "a_obs"),
                                   ("b", "b.name", "b_obs")])
    a = ["ann", "anm", "ben", "cat", "dan", "ann", "ben", "cat"] * 2
    bn = ["ben", "cat", "cat", "dan", "ann", "bem", "ann", "dan"] * 2
    ds = ns.DS(q, {"a": a, "b": bn})
    return ns.compile(model, [ds], capacities={"Person": cap}, **ns.kw), q


def _capture(monkeypatch, mod):
    """Every _SampleState the module's tracer makes, in order."""
    made = []
    base = mod._SampleState

    class Kept(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(mod, "_SampleState", Kept)
    return made


def _edit_rel(rt, edit):
    """A copy of the port's relational state with `edit` applied, and the
    same state for pclean_tpu."""
    rt = {c: {k: (v.clone() if torch.is_tensor(v) else
                  {t: tuple(x.clone() for x in p) for t, p in v.items()})
              for k, v in r.items()} for c, r in rt.items()}
    if edit is not None:
        edit(rt)
    from test_torch_host import to_jax
    return to_jax(to_numpy(rt)), rt


def _poison(records, vid, rv, jax_side: bool):
    """records[(vid, ())] with each row's retained value rv set to NEG_INF:
    the value lies outside the enumerated support."""
    key = (vid, ())
    rec = records[key]
    if jax_side:
        records[key] = rec.at[rv].set(NINF)
    else:
        rec = rec.clone()
        rec[torch.arange(rec.shape[0]), rv.long()] = NINF
        records[key] = rec


def run_block(pair, cid, plan_idx, slots, keys, monkeypatch, retained=False,
              rel_edit=None, dummy_vid=None, cand=None):
    """One block through both tracers from one state (`rel_edit` applied to
    both relational states), the port fed pclean_tpu's uniform pool:
    sampled values, births and every class's working alive mask equal.
    With `dummy_vid`, each row's retained value of that choice is made
    NEG_INF in its record between the passes. Returns (births, the port's
    working masks)."""
    import jax
    import jax.numpy as jnp
    from pclean_tpu.engine import propose as jprop
    from test_torch_propose import _pool_key

    cm_j, cm_t = pair.cm_j, pair.cm_t
    plan_j = cm_j.cls(cid).plans[plan_idx]
    plan_t = cm_t.cls(cid).plans[plan_idx]
    rj, rt = _edit_rel(pair.rt, rel_edit)
    cj = jprop.build_cand(cm_j, rj, cand) if cand else None
    ct = tprop.build_cand(cm_t, rt, cand) if cand else None
    states_j = _capture(monkeypatch, jprop)
    states_t = _capture(monkeypatch, tprop)

    def one(s, k):
        obs_row = pair.eng_j._obs_row_slices(cid, s, rj)
        tr = jprop.BlockTracer(cm_j, cid, pair.aj, rj, pair.pj,
                               pair.eng_j.obs_dev, obs_row, {}, s,
                               force_retained=retained, cand=cj)
        tr._root_plan = plan_j
        k_score, k_sample = jax.random.split(k)
        tr._score_keys = jprop._KeyStream(k_score)
        tr._mm_push()
        tr._mm_flush(tr.score_plan(plan_j, 0, {}, ()))
        if dummy_vid is not None:
            _poison(tr.records, dummy_vid, tr._forced(dummy_vid), True)
        res = tr.sample(k_sample)
        return (res.env, [(b.is_new, b.slot, b.values) for b in res.births],
                states_j[-1].alive2)

    env_j, births_j, alive_j = jax.jit(jax.vmap(one))(
        jnp.asarray(slots, jnp.int32), keys)
    n = jprop._draw_bound(cm_j, cid, plan_j)
    pool = torch.as_tensor(np.asarray(jax.vmap(
        lambda k: jax.random.uniform(_pool_key(k), (n,)))(keys))) \
        if n else None
    st = torch.as_tensor(slots)
    tr = tprop.BlockTracer(cm_t, cid, pair.at, rt, pair.pt,
                           pair.eng_t.obs_dev,
                           pair.eng_t._obs_row_slices(cid, st.long(), rt),
                           {}, st, force_retained=retained, cand=ct)
    tr._root_plan = plan_t
    tr._gen = None
    tr._level_sum(0, lambda: tr.score_plan(plan_t, 0, {}, ()))
    if dummy_vid is not None:
        _poison(tr.records, dummy_vid, tr._forced(dummy_vid), False)
    res = tr.sample(pool)
    assert set(env_j) == set(res.env)
    for v in env_j:
        np.testing.assert_array_equal(np.asarray(env_j[v]),
                                      res.env[v].numpy(), err_msg=str(v))
    assert len(births_j) == len(res.births)
    for (nj, sj, vj), bt in zip(births_j, res.births):
        np.testing.assert_array_equal(np.asarray(nj), bt.is_new.numpy())
        np.testing.assert_array_equal(np.asarray(sj), bt.slot.numpy())
        assert bt.slot.dtype == torch.int32 and bt.is_new.dtype == torch.bool
        assert set(vj) == set(bt.values)
        for v in vj:
            np.testing.assert_array_equal(np.asarray(vj[v]),
                                          bt.values[v].numpy())
    masks = states_t[-1].alive2
    for c, m in alive_j.items():
        want = np.broadcast_to(np.asarray(m), (len(slots),) + m.shape[1:])
        got = masks[c].numpy() if c in masks else np.broadcast_to(
            rt[c]["alive"].numpy(), want.shape)
        np.testing.assert_array_equal(want, got, err_msg=f"alive {c}")
    return res.births, masks


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def scaled():
    from test_torch_host import scaled_pair
    from test_torch_propose import Pair
    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = scaled_pair()
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


@pytest.fixture(scope="module")
def hospital():
    from test_torch_hospital import hospital_pair
    from test_torch_propose import Pair
    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = hospital_pair()
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


def _toy_pair(build):
    from pclean_tpu.engine import smc as jsmc
    from pclean_tpu_torch.engine import smc as tsmc
    from test_torch_host import JNS, TNS
    from test_torch_propose import Pair
    (cm_j, _qj), (cm_t, _qt) = build(JNS), build(TNS)
    return Pair(cm_j, jsmc.InferenceConfig(batch_rows=4),
                cm_t, tsmc.InferenceConfig(batch_rows=4))


@pytest.fixture(scope="module")
def two():
    return _toy_pair(twofk)


def _keys(seed, n):
    import jax
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _kill_targets(pair, cid, fk_name, slots, every=3):
    """A rel edit: the stored target of every `every`-th row's fk
    `fk_name` loses its references (refcount 0), so the retained form finds
    it dead and re-births it in its old slot."""
    cm = pair.cm_t
    vid = cm.cls(cid).names[fk_name]
    tc = cm.node(cid, vid).target_class
    tgt = pair.at[cid]["values"][vid][torch.as_tensor(slots)].long()

    def edit(rt):
        rt[tc]["refcount"][tgt[::every]] = 0
    return edit


@pytest.mark.parametrize("form", ["drawn", "retained", "drawn_comp",
                                  "retained_comp"])
def test_scaled_record_block(scaled, monkeypatch, form):
    slots = np.sort(np.random.default_rng(3).choice(512, 24, replace=False))
    retained = form.startswith("retained")
    edit = _kill_targets(scaled, "Record", "hosp", slots) if retained \
        else None
    cand = {"Hospital": 64, "County": 64} if form.endswith("comp") else None
    births, _m = run_block(scaled, "Record", 0, slots, _keys(5, len(slots)),
                           monkeypatch, retained=retained, rel_edit=edit,
                           cand=cand)
    if retained:   # the dead targets re-birth in their old slots
        assert any(bool(b.is_new.any()) for b in births
                   if b.target_class == "Hospital")


@pytest.mark.parametrize("retained", [False, True])
def test_hospital_record_block(hospital, monkeypatch, retained):
    slots = np.sort(np.random.default_rng(4).choice(240, 16, replace=False))
    edit = _kill_targets(hospital, "Record", "hosp", slots) if retained \
        else None
    run_block(hospital, "Record", 0, slots, _keys(7, len(slots)),
              monkeypatch, retained=retained, rel_edit=edit)


def test_flights_obs_block(monkeypatch):
    from test_torch_flights import FlightsState
    st = FlightsState()
    slots = np.arange(0, 300, 19)
    run_block(st, "Obs", 0, slots, _keys(11, len(slots)), monkeypatch)


def test_two_fks_into_one_class(two, monkeypatch):
    """Both of Pair's keys target Person: the later fk's free slot and
    mask see the earlier one's birth (half the arena free, then an empty
    arena where every key is drawn fresh)."""
    cap = two.cm_t.layouts["Person"].capacity

    def free_half(rt):   # half the arena free, the rest live
        rt["Person"]["alive"][:] = torch.arange(cap) < cap // 2
        rt["Person"]["refcount"][:] = (torch.arange(cap) < cap // 2).int()

    def empty(rt):   # no live candidate: every key is drawn fresh
        rt["Person"]["alive"][:] = False
        rt["Person"]["refcount"][:] = 0

    fresh = 0
    for seed, edit in enumerate((free_half, empty)):
        births, masks = run_block(two, "Pair", 0, np.arange(16),
                                  _keys(21 + seed, 16), monkeypatch,
                                  rel_edit=edit)
        # b is sampled in both of a's branches, then a
        assert [b.target_class for b in births] == ["Person"] * 3
        for i, x in enumerate(births):
            for y in births[i + 1:]:
                both = x.is_new & y.is_new
                fresh += int(both.sum())
                # two fresh births of one row take two different slots
                assert not bool((both & (x.slot == y.slot)).any())
        assert masks["Person"].shape == (16, cap)
    assert fresh > 0


def test_full_arena_takes_the_best_existing(two, monkeypatch):
    """Retained form on a full arena whose stored targets lost their
    references: each such fk asks for a re-birth, finds no free slot and
    falls back to the best-scoring existing candidate (argmax)."""
    cap = two.cm_t.layouts["Person"].capacity

    def full(rt):
        rt["Person"]["alive"][:] = True
        rt["Person"]["refcount"][:] = torch.arange(cap) % 2

    births, masks = run_block(two, "Pair", 0, np.arange(16), _keys(31, 16),
                              monkeypatch, retained=True, rel_edit=full)
    assert not any(bool(b.is_new.any()) for b in births)
    assert bool(masks["Person"].all())


def test_retained_value_outside_the_support(monkeypatch):
    """The toy model's Obj block, retained, each row's stored name at
    NEG_INF in its record: the dummy code, a StringPrior's."""
    from test_torch_host import tiny
    pair = _toy_pair(tiny)
    cm_t = pair.cm_t
    vid = cm_t.cls("Obj").names["name"]
    dummy = cm_t.dummy_code[("Obj", vid)]
    cap = cm_t.layouts["Obj"].capacity
    _b, _m = run_block(pair, "Obj", 0, np.arange(cap), _keys(41, cap),
                       monkeypatch, retained=True, dummy_vid=vid)
    assert _b == [] and dummy is not None   # Obj has no fk


# ------------------------------------------------------------ row_value


def test_row_value_every_hospital_vertex(hospital):
    """row_value through K18's plain version against pclean_tpu's on every
    vertex of every class of the hospital model, at slots of rank 0-2 (some
    past the capacity: clamped)."""
    import jax.numpy as jnp
    from pclean_tpu.engine import propose as jprop
    from pclean_tpu_torch.model.ir import (ExternalLikelihoodNode,
                                           ParameterNode)
    cm = hospital.cm_t
    n = 0
    for cid in cm.model.class_order:
        cap = cm.layouts[cid].capacity
        shapes = [np.int64(cap // 3), np.array([0, 1, cap - 1, cap + 3]),
                  np.arange(6).reshape(2, 3) * max(1, cap // 6)]
        for vid in range(len(cm.cls(cid).nodes)):
            # (a submodel chain may end at a parameter: no row value)
            if isinstance(tprop._row_chain(cm, cid, vid)[3],
                          (ParameterNode, ExternalLikelihoodNode)):
                continue
            for s in shapes:
                want = jprop.row_value(hospital.cm_j, hospital.aj,
                                       hospital.pj, cid, vid, jnp.asarray(s))
                got = tprop.row_value(cm, hospital.at, hospital.pt, cid, vid,
                                      torch.as_tensor(s))
                assert tuple(got.shape) == tuple(np.shape(want))
                np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                              err_msg=f"{cid} {vid}")
                n += 1
    assert n > 50


def test_row_gather_plain_is_the_chain():
    """K18's plain version: each hop's index clamped into its column."""
    hop = torch.tensor([2, 0, 9, 1], dtype=torch.int32)
    leaf = torch.tensor([10, 11, 12], dtype=torch.int16)
    slot = torch.tensor([[0, 2], [7, -1]])
    got = ops.row_gather_plain(slot, [hop], leaf)
    assert got.dtype == torch.int16
    assert got.tolist() == [[12, 12], [11, 12]]


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


def k16(form, mask, B, cap, d, comp=False):
    """K16's census fields (ops.CENSUS_FIELDS)."""
    return dict(form=form, mask=mask, B=B, cap=cap, comp=comp, d=d)


def k17(form, dtype, B, d):
    return dict(form=form, dtype=dtype, B=B, d=d)


I8, I16, I32, I64 = torch.int8, torch.int16, torch.int32, torch.int64
F32 = torch.float32
CARD_CASES = {   # (kernel, census fields, K)
    "k16 drawn full": ("fk_sample", k16("drawn", "shared", 4096, 11264, 0),
                       11265),
    "k16 drawn full in place": ("fk_sample",
                                k16("drawn", "inplace", 4096, 11264, 0),
                                11265),
    "k16 drawn comp d2": ("fk_sample",
                          k16("drawn", "inplace", 66, 1472, 2, comp=True),
                          257),
    "k16 retained one row": ("fk_sample",
                             k16("retained", "shared", 1, 160, 1), 161),
    "k16 retained comp": ("fk_sample",
                          k16("retained", "inplace", 512, 64, 0, comp=True),
                          33),
    "k16 own mask": ("fk_sample", k16("drawn", "own", 256, 500, 1), 501),
    "k17 draw": ("choice_sample", k17("draw", F32, 4096, 1), 5125),
    "k17 draw one row d3": ("choice_sample", k17("draw", F32, 1, 3), 23),
    "k17 retained": ("choice_sample", k17("retained", F32, 300, 2), 9),
    "k17 pick i16": ("choice_sample", k17("pick", I16, 4096, 1), 1),
    "k17 pick f32 d3": ("choice_sample", k17("pick", F32, 7, 3), 1),
    "k18 leaf": ("row_gather", dict(cols=[(I32, 11264)]), 1),
    "k18 two hops": ("row_gather",
                     dict(cols=[(I32, 1_000_000), (I32, 11264), (I8, 1472)]),
                     1_000_000),
    "k18 three hops f32": ("row_gather", dict(cols=[
        (I32, 4096), (I16, 300), (I32, 70), (F32, 33)]), 4096),
    "k19 mixed": ("branch_select", dict(B=4096, pairs=[
        (I32, I32), (F32, I32), (I8, I64), (torch.bool, F32)]), 4),
    "k19 one row": ("branch_select", dict(B=1, pairs=[(I32, I32)]), 1),
}


_DTS = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
        torch.int64, torch.float32, torch.float64)
_CT = (ctypes.c_uint8, ctypes.c_int8, ctypes.c_uint8, ctypes.c_int16,
       ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_double)


def k19_pairs(n: int, B: int, seed: int = 0):
    """is_new [B] and n pairs of every (new, existing) dtype combination
    in turn (a float existing into an integer new truncates, into a bool
    tests != 0), values in [0, 100); every third existing value one
    element, every fifth new one broadcast by expand, every seventh
    existing a strided view (copied by the wrapper)."""
    rng = np.random.default_rng(seed)

    def val(dt, k, j):
        x = torch.as_tensor(rng.random(k) * 100).to(dt) if \
            dt.is_floating_point else torch.as_tensor(
                rng.integers(0, 100, k)).to(dt)
        if j % 7 == 6 and k == B > 1:
            x = torch.as_tensor(rng.integers(0, 100, 2 * B)).to(dt)[::2]
        return x

    pairs = []
    for j in range(n):
        nd, ed = _DTS[j % 8], _DTS[(j * 3 + 1) % 8]
        nv = val(nd, 1, j).expand(B) if j % 5 == 4 else val(nd, B, j)
        ev = val(ed, 1 if j % 3 == 2 else B, j)
        pairs.append((nv, ev))
    return torch.as_tensor(rng.random(B) < 0.5), pairs


def _read_k19(words):
    """csrc/branch_select.cu over bound words, through the CPU addresses
    they hold: a thread a (pair, row), is_new, the new and the existing
    value read, then the select converted to new's dtype."""
    n, B, ip = words[0], words[1], words[2]
    for j in range(n):
        q = words[ops.K19_HEAD + ops.K19_PAIR * j:][:ops.K19_PAIR]
        nd, ed = q[3] & 15, (q[3] >> 4) & 15
        for b in range(B):
            fresh = ctypes.c_uint8.from_address(ip + b).value
            i = 0 if (q[3] >> (8 if fresh else 9)) & 1 else b
            p, dt = (q[0], nd) if fresh else (q[1], ed)
            c = _CT[dt]
            v = c.from_address(p + i * ctypes.sizeof(c)).value
            if nd == 0:
                v = int(v != 0)
            elif nd < 6:
                bits = 8 * ctypes.sizeof(_CT[nd])
                v = int(np.trunc(v)) & (1 << bits) - 1
                if nd != 2 and v >= 1 << (bits - 1):
                    v -= 1 << bits
            else:
                v = float(np.float32(v)) if nd == 6 else float(v)
            c = _CT[nd]
            c.from_address(q[2] + b * ctypes.sizeof(c)).value = v


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("n", [1, 16, 17, 64, 65])
def test_k19_plan_blocks_cache_and_views(n, B):
    """K19's plan at 1-65 pairs: a launch of up to 64 pairs (65 pairs: 64
    and 1), its words sized to its pairs; a second call of the same structure
    takes the same cached plan; the outputs are views of one allocation,
    each aligned to its dtype, none overlapping; the words, read as the
    kernel reads them, give the plain version bit for bit."""
    is_new, pairs = k19_pairs(n, B)
    ent = ops._k19_plan(is_new, pairs)
    launches = ent[6]
    sizes = [min(ops.K19_MAX_PAIRS, n - j0)
             for j0 in range(0, n, ops.K19_MAX_PAIRS)]
    assert [w[0] for w, *_ in launches] == sizes
    assert [len(w) for w, *_ in launches] == [
        ops.K19_HEAD + ops.K19_PAIR * k for k in sizes]
    again = k19_pairs(n, B, seed=1)
    assert ops._k19_plan(*again) is ent
    outs, _vals = ops._k19_bind(ent, is_new, pairs)
    want = ops.branch_select_plain(is_new, pairs)
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1
    spans = sorted((o.data_ptr(), o.data_ptr() + B * o.element_size())
                   for o in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and o.shape == (B,) and \
            o.data_ptr() % o.element_size() == 0
    for words, *_ in launches:
        _read_k19(list(words))
    for j, (o, w) in enumerate(zip(outs, want)):
        assert torch.equal(o, w), (j, o, w)


@pytest.mark.parametrize("mask", ["shared", "own", "inplace"])
def test_k16_inputs_take_the_census_mask_form(mask):
    """kernel_bench's K16 inputs in each form of the working mask the
    census names (shared: the class's [cap] mask and a buffer of the
    tracer's; inplace: that buffer itself), the in-place form kept one
    tensor through the copies a check makes; the plain version writes the
    form's buffer."""
    inp = kb.k16_inputs("cpu", k16("drawn", mask, 6, 40, 1), 41)
    _rec, _anc, gate, mi, mo = inp["args"]
    assert tuple(mi.shape) == ((40,) if mask == "shared" else (6, 40))
    assert (mi is mo) == (mask == "inplace")
    c = kb._clone_inputs(inp)
    assert (c["args"][3] is c["args"][4]) == (mask == "inplace")
    before = c["args"][3].clone()
    ints, flags, out = kb._sample_call(ops, c, plain=True)
    assert tuple(ints.shape) == (4, 6) and tuple(flags.shape) == (2, 6)
    born = torch.zeros_like(out)
    born[torch.arange(6), ints[3].long()] = flags[1]
    assert torch.equal(out, before.expand(6, 40) | born)


@pytest.mark.parametrize("d", [0, 1, 3])
def test_k17_pick_library_call_is_the_pick(d):
    """K17's library call in pick mode (kernel_bench.sample_library:
    torch.take at the clamped ancestor positions) gives the plain pick,
    on a per-row record and on a shared [1, ...] one."""
    inp = kb.k17_inputs("cpu", k17("pick", I16, 7, d), 1)
    rec, anc, B = inp["args"]
    anc = tuple(a * 2 - 1 for a in anc)   # -1 and 3 clamp into [0, 3)
    for r in (rec, rec[:1]):
        x = dict(inp, args=(r, anc, B))
        assert torch.equal(kb.sample_library(x)(),
                           ops.choice_sample_plain(r, anc, B, mode="pick"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_sample_kernels_match_plain_on_card(card, case):
    kernel, fields, K = CARD_CASES[case]
    inp = kb.sample_inputs(card, kernel, fields, K)
    kb.check_sample(ops, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 4096])
@pytest.mark.parametrize("n", [1, 4, 5, 16, 17, 64, 65])
def test_k19_every_block_matches_plain_on_card(card, n, B):
    """K19 at 1-64 pairs in one launch (and 65 pairs in two), every
    dtype pair, broadcast and strided values and float-to-int and
    float-to-bool conversions, bit-equal to the plain version."""
    is_new, pairs = k19_pairs(n, B, seed=n + B)
    is_new = is_new.to(card)
    pairs = [(nv.to(card) if nv.stride(0) != 0 or B == 1 else
              nv[:1].to(card).expand(B), ev.to(card)) for nv, ev in pairs]
    got = ops.branch_select(is_new, pairs)
    again = ops.branch_select(is_new, pairs)
    want = ops.branch_select_plain(is_new, pairs)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.cuda
def test_k16_in_place_and_k18_strided_on_card(card):
    """K16 on the tracer's own mask (in place, a second fk of a class)
    and K18 on an expanded, non-contiguous slot tensor."""
    inp = kb.k16_inputs(card, k16("drawn", "own", 256, 500, 1), 501)
    rec, anc, gate, mi, _mo = inp["args"]
    a, b = mi.clone(), mi.clone()
    got = ops.fk_sample(rec, anc, gate, a, a, **inp["kwargs"])
    want = ops.fk_sample_plain(rec, anc, gate, b, b, draw=ops.inv_cdf_sample,
                               **inp["kwargs"])
    torch.cuda.synchronize()
    for g, w in zip(list(got) + [a], list(want) + [b]):
        assert torch.equal(g, w)
    leaf = torch.arange(50, dtype=torch.int32, device=card) * 3
    hop = torch.randint(0, 60, (40,), dtype=torch.int32, device=card)
    slot = torch.randint(0, 45, (5, 1, 7), device=card).expand(5, 4, 7) \
        .transpose(0, 2)
    assert not slot.is_contiguous()
    assert torch.equal(ops.row_gather(slot, [hop], leaf),
                       ops.row_gather_plain(slot, [hop], leaf))


@pytest.mark.cuda
def test_sample_kernels_refuse_what_they_do_not_take(card):
    inp = kb.k16_inputs(card, k16("drawn", "own", 8, 64, 0), 65)
    rec, anc, gate, mi, mo = inp["args"]
    with pytest.raises(ValueError):
        ops.fk_sample(rec, anc, gate, mi, mo[:, :32], **inp["kwargs"])
    with pytest.raises(ValueError):
        ops.fk_sample(rec.double(), anc, gate, mi, mo, **inp["kwargs"])
    with pytest.raises(ValueError):
        ops.choice_sample(rec, (gate,), 8, u=inp["kwargs"]["u"])
    leaf = torch.zeros(4, device=card)
    with pytest.raises(ValueError):
        ops.row_gather(torch.zeros(3, device=card), [], leaf)
    with pytest.raises(ValueError):
        ops.branch_select(gate, [(torch.zeros(3, device=card),
                                  torch.zeros(3, device=card))])


@pytest.mark.cuda
def test_tracer_on_card_matches_cpu_without_syncs(card):
    """The hospital model's Record block, one row and 16 rows, drawn and
    retained: the tracer on the card (K16-K19) against its CPU path, same
    state and uniforms, sampled values and births equal; the one-row step
    under torch.cuda.set_sync_debug_mode("error")."""
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.workloads import hospital as th

    res = {}
    for d in ("cpu", "cuda"):
        cm, cfg, *_r = th.setup(rows=240, batch=16, device=d)
        res[d] = (cm, cfg)
    a, p = init_state(res["cpu"][0], 0, device="cpu")
    a, p, _g = Engine(*res["cpu"], device="cpu").initialize(1, a, p)
    arenas, params = to_numpy(a), to_numpy(p)
    for rows in (np.array([17]), np.arange(0, 240, 15)):
        for retained in (False, True):
            out = {}
            for d in ("cpu", "cuda"):
                cm, cfg = res[d]
                eng = Engine(cm, cfg, device=d)
                at, pt = to_torch(arenas, d), to_torch(params, d)
                rel = refresh(cm, at, eng.obs_dev)
                st = torch.as_tensor(rows, device=d)
                plan = cm.cls("Record").plans[0]
                pool = torch.as_tensor(np.random.default_rng(2).random(
                    (len(rows), tprop._draw_bound(cm, "Record", plan)))
                    .astype(np.float32), device=d)
                def tracer():
                    return tprop.BlockTracer(
                        cm, "Record", at, rel, pt, eng.obs_dev,
                        eng._obs_row_slices("Record", st, rel), {}, st,
                        force_retained=retained)

                tracer().run(plan, pool=pool)   # uploads the model's tables
                tr = tracer()
                if d == "cuda" and len(rows) == 1:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    _z, r = tr.run(plan, pool=pool)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                out[d] = r
            for v, x in out["cpu"].env.items():
                assert torch.equal(x, out["cuda"].env[v].cpu()), v
            for bc, bg in zip(out["cpu"].births, out["cuda"].births):
                assert torch.equal(bc.slot, bg.slot.cpu())
                assert torch.equal(bc.is_new, bg.is_new.cpu())
