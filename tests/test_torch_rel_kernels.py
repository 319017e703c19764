"""K14 rel_scatter and K15 batch_write: the batched relational scatters and
row writes, and the latent-class replay rows they make capturable.

CPU (the JAX package imported inside the tests only):
  * the drop rule: utils.scatter_add_drop, scatter_max_drop,
    index_set_drop and index_set_where on crafted indices (in range, out
    of range, in [-C, -1] and below -C) against jnp's
    .at[...](mode="drop"): equal;
  * K14's and K15's plain versions as refresh (with the excluded row an
    int and a tensor), hop_histograms, batch_obs_delta,
    batch_latent_delta, _cascade and _apply_batch use them, against
    pclean_tpu's functions on the same arenas: kernel_bench.row_state's
    numpy-seeded states (fk columns with out-of-range values) of the
    scaled CPU model and the 240-row hospital model; integer state and
    written columns exactly equal;
  * a latent class's replay chunk (Engine._replay_chunk through
    RowGraph, eager on the CPU): init and MH rejuvenation rows fed the
    JAX package's uniform pools, bit-equal to pclean_tpu's _replay_chunk
    on the scaled CPU model and the chain model; collapsed and
    written-out PG rows bit-equal to the rows run one by one against a
    refresh that excludes the row by a host int (the form the chunk had
    before it could be captured);
  * no workload's CPU run (scaled, rents, flights, hospital at small
    sizes, init and one sweep) hands a negative index to a dropping
    scatter or to take(), so neither JAX's wrap of a negative scatter
    index nor its wrap of a negative gather index (take clamps) can move
    a result unseen.
Card (`cuda` marker; `python -m pytest -m cuda tests/test_torch_rel_kernels.py`
on the H100): K14 and K15 against their plain versions at the paths'
shape kinds and the edges (no hops, four hops, int64 columns, float and
int64 codes, the excluded slot an int and a tensor, slots out of range and
wrapping, cascade mode), bit-equal; K14's histogram route at 1,000,000
sources into 11,264, int64 fk columns, C just under and over a block's
shared memory, the exclusion an int and a tensor, every source into one
target, none alive, all dropped, each forced into every route and block
count that takes it; the wrappers refuse what the kernels do not take;
refresh, the batched deltas and _apply_batch on the card equal to the
CPU under torch.cuda.set_sync_debug_mode("error"); a latent
replay chunk's graph replays bit-equal to its eager rows.
"""
import ctypes

import numpy as np
import pytest
import torch

from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops
from pclean_tpu_torch import utils as tutils
from pclean_tpu_torch.convert import to_numpy, to_torch
from pclean_tpu_torch.engine import refresh as trefresh
from pclean_tpu_torch.engine import smc as tsmc

C = 4


@pytest.mark.parametrize("op", ["add", "max", "set", "set_where"])
def test_drop_rule_matches_jax(op):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    base = rng.integers(-3, 9, C).astype(np.int32)
    # index_set_drop's indices are distinct after the wrap, as its callers'
    idx = np.array([-6, -1, 1, 4, 9] if op.startswith("set")
                   else [-6, -4, -1, 0, 2, 3, 4, 9], np.int64)
    vals = rng.integers(-5, 20, len(idx)).astype(np.int32)
    j, ji, jv = jnp.asarray(base), jnp.asarray(idx), jnp.asarray(vals)
    t, ti, tv = (torch.as_tensor(x) for x in (base, idx, vals))
    if op == "add":
        want, got = j.at[ji].add(jv, mode="drop"), \
            tutils.scatter_add_drop(t, ti, tv)
    elif op == "max":
        want, got = j.at[ji].max(jv, mode="drop"), \
            tutils.scatter_max_drop(t, ti, tv)
    elif op == "set":
        want, got = j.at[ji].set(jv, mode="drop"), \
            tutils.index_set_drop(t, ti, tv)
    else:   # a masked write keeps the value read where the rule wraps
        ok = np.array([True, False, False, True, False])
        want = j.at[ji].set(jnp.where(jnp.asarray(ok), jv, j[ji]),
                            mode="drop")
        got = tutils.index_set_where(t, ti, tv, torch.as_tensor(ok))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ------------------------------------------------------ models and states


def _models():
    from test_torch_hospital import hospital_pair
    from test_torch_host import scaled_pair

    out = {}
    (cm_j, _c, _q), (cm_t, _ct, _qt), _d, _cl = scaled_pair()
    out["scaled"] = (cm_j, cm_t)
    (cm_j, _c, _q), (cm_t, _ct, _qt), _d, _cl = hospital_pair()
    out["hospital"] = (cm_j, cm_t)
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


def _state(cm_t, seed):
    from test_torch_host import to_jax
    at = kb.row_state(cm_t, seed, device="cpu")
    return at, to_jax(to_numpy(at))


def _obs(cm_j, cm_t):
    from pclean_tpu.engine.smc import _obs_device as j_obs_device
    return j_obs_device(cm_j), tsmc._obs_device(cm_t)


def _latents(cm, fks=True):
    return [c for c in cm.model.class_order if not cm.layouts[c].observed
            and (bool(cm.layouts[c].fk_vertices) or not fks)]


@pytest.mark.parametrize("which", ["scaled", "hospital"])
@pytest.mark.parametrize("excl", [None, "int", "tensor"])
def test_refresh_through_k14_plain_matches_jax(models, which, excl):
    from pclean_tpu.engine import refresh as jrefresh
    from test_torch_host import assert_rel_equal

    cm_j, cm_t = models[which]
    obs_j, obs_t = _obs(cm_j, cm_t)
    at, aj = _state(cm_t, 1)
    if excl is None:
        assert_rel_equal(jrefresh.refresh(cm_j, aj, obs_j),
                         trefresh.refresh(cm_t, at, obs_t), which)
        return
    for cid in [cm_t.obs_specs[0].class_id] + _latents(cm_t)[:1]:
        for slot in (0, 7, cm_t.layouts[cid].capacity - 1):
            s_t = slot if excl == "int" else torch.tensor([slot])
            rt = trefresh.refresh(cm_t, at, obs_t, exclude_cid=cid,
                                  exclude_slot=s_t)
            rj = jrefresh.refresh(cm_j, aj, obs_j, exclude_cid=cid,
                                  exclude_slot=slot)
            assert_rel_equal(rj, rt, f"{which} exclude {cid} {slot}")
            if excl == "tensor":   # the tensor form is the int form
                assert_rel_equal(rj, trefresh.refresh(
                    cm_t, at, obs_t, exclude_cid=cid, exclude_slot=slot))


def _rewritten(cm_t, at, cid, slots, rng, alive=True):
    """A copy of the arenas with class cid's rows `slots` rewritten: every
    fk drawn over its target (5% out of range) and, with `alive`, the
    alive bits flipped at random."""
    new = {c: {"values": {v: x.clone() for v, x in a["values"].items()},
               "alive": a["alive"].clone()} for c, a in at.items()}
    s = torch.as_tensor(slots)
    for fkv in cm_t.layouts[cid].fk_vertices:
        tcap = cm_t.layouts[cm_t.node(cid, fkv).target_class].capacity
        v = rng.integers(0, tcap + 1, len(slots))
        new[cid]["values"][fkv][s] = torch.as_tensor(v).to(torch.int32)
    if alive:
        new[cid]["alive"][s] = torch.as_tensor(rng.random(len(slots)) < 0.7)
    return new


@pytest.mark.parametrize("which", ["scaled", "hospital"])
def test_batch_deltas_through_k14_plain_match_jax(models, which):
    import jax.numpy as jnp
    from pclean_tpu.engine import refresh as jrefresh
    from test_torch_host import assert_rel_equal, to_jax

    cm_j, cm_t = models[which]
    obs_j, obs_t = _obs(cm_j, cm_t)
    rng = np.random.default_rng(5)
    at, aj = _state(cm_t, 2)
    rt, rj = trefresh.refresh(cm_t, at, obs_t), jrefresh.refresh(cm_j, aj,
                                                                 obs_j)
    cid = cm_t.obs_specs[0].class_id
    cap = cm_t.layouts[cid].capacity
    slots = np.concatenate([rng.choice(cap, 15, replace=False), [cap + 2]])
    new = _rewritten(cm_t, at, cid, slots[:-1], rng)
    assert_rel_equal(
        jrefresh.batch_obs_delta(cm_j, rj, aj, to_jax(to_numpy(new)), obs_j,
                                 cid, jnp.asarray(slots)),
        trefresh.batch_obs_delta(cm_t, rt, at, new, obs_t, cid,
                                 torch.as_tensor(slots)),
        f"{which} batch_obs_delta")
    for lc in _latents(cm_t):
        hj = jrefresh.hop_histograms(cm_j, lc, aj, obs_j)
        ht = trefresh.hop_histograms(cm_t, lc, at, obs_t)
        assert len(hj) == len(ht)
        for (kj, (gj, cj)), (kt, (gt, ct)) in zip(hj, ht):
            assert kj == kt
            np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
            np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        lcap = cm_t.layouts[lc].capacity
        ls = rng.choice(lcap, min(12, lcap), replace=False)
        new = _rewritten(cm_t, at, lc, ls, rng, alive=False)
        assert_rel_equal(
            jrefresh.batch_latent_delta(cm_j, rj, aj, to_jax(to_numpy(new)),
                                        lc, jnp.asarray(ls), hj),
            trefresh.batch_latent_delta(cm_t, rt, at, new, lc,
                                        torch.as_tensor(ls), ht),
            f"{which} batch_latent_delta {lc}")


@pytest.mark.parametrize("which", ["scaled", "hospital"])
def test_cascade_through_k14_plain_matches_jax(models, which):
    import jax.numpy as jnp
    from pclean_tpu.engine import refresh as jrefresh
    from test_torch_host import assert_rel_equal

    cm_j, cm_t = models[which]
    obs_j, obs_t = _obs(cm_j, cm_t)
    rng = np.random.default_rng(6)
    at, aj = _state(cm_t, 3)
    rt, rj = trefresh.refresh(cm_t, at, obs_t), jrefresh.refresh(cm_j, aj,
                                                                 obs_j)
    pend = {c: rng.integers(-2, 3, cm_t.layouts[c].capacity).astype(np.int32)
            for c in _latents(cm_t, fks=False)}
    rj = {c: {**v, "prop": dict(v["prop"])} for c, v in rj.items()}
    jrefresh._cascade(cm_j, rj, aj, {c: jnp.asarray(d)
                                     for c, d in pend.items()})
    rt = trefresh._copy_rel(rt)
    trefresh._cascade(cm_t, rt, at, {c: torch.as_tensor(d)
                                     for c, d in pend.items()})
    assert_rel_equal(rj, rt, f"{which} _cascade")


@pytest.mark.parametrize("which", ["scaled", "hospital"])
@pytest.mark.parametrize("mark_alive", [True, False])
def test_apply_batch_through_k15_plain_matches_jax(models, which,
                                                   mark_alive):
    import jax.numpy as jnp
    from pclean_tpu.engine import smc as jsmc

    cm_j, cm_t = models[which]
    rng = np.random.default_rng(7)
    at, aj = _state(cm_t, 4)
    for cid in [cm_t.obs_specs[0].class_id] + _latents(cm_t, fks=False):
        lay = cm_t.layouts[cid]
        cap = lay.capacity
        # distinct slots: one past the end (dropped), one -1 (wraps to the
        # last slot, which no other slot names)
        v = rng.choice(cap - 1, min(20, cap - 1), replace=False)
        slots = np.concatenate([[-1], v, [cap + 3]]).astype(np.int64)
        B = len(slots)
        env = {vid: (rng.integers(0, 6, B).astype(np.int64) if dt == "i"
                     else rng.random(B).astype(np.float32))
               for vid, dt in lay.store.items()}
        ok = rng.random(B) < 0.7
        got = tsmc._apply_batch(cm_t, cid, at, torch.as_tensor(slots),
                                {k: torch.as_tensor(x) for k, x in
                                 env.items()}, torch.as_tensor(ok),
                                mark_alive)
        want = jsmc._apply_batch(cm_j, cid, aj, jnp.asarray(slots),
                                 {k: jnp.asarray(x) for k, x in env.items()},
                                 jnp.asarray(ok), mark_alive)
        for vid in lay.store:
            np.testing.assert_array_equal(
                np.asarray(want[cid]["values"][vid]),
                got[cid]["values"][vid].numpy(), err_msg=f"{cid}.{vid}")
        np.testing.assert_array_equal(np.asarray(want[cid]["alive"]),
                                      got[cid]["alive"].numpy())
        # out of place: the input arenas stay
        assert torch.equal(at[cid]["alive"],
                           kb.row_state(cm_t, 4, device="cpu")[cid]["alive"])


# -------------------------------------------------- latent replay chunks

REPLAY_ROWS = 6


def _replay_pair(which):
    from test_torch_host import JNS, TNS, chain, port_state, scaled_pair

    if which == "scaled":
        (cm_j, _cj, _qj), (cm_t, cfg_t, _qt), _d, _c = scaled_pair()
    else:
        (cm_j, _qj), (cm_t, _qt) = chain(JNS), chain(TNS)
        cfg_t = tsmc.InferenceConfig(batch_rows=4, rejuv_frequency=16)
    arenas, params = port_state(cm_t, cfg_t)
    return cm_j, cm_t, arenas, params


@pytest.fixture(scope="module")
def replay_pairs():
    return {w: _replay_pair(w) for w in ("scaled", "chain")}


@pytest.mark.parametrize("which", ["scaled", "chain"])
@pytest.mark.parametrize("rejuv", [True, False])
def test_latent_replay_chunk_matches_jax(replay_pairs, which, rejuv):
    import jax
    from pclean_tpu.engine import propose as jprop
    from pclean_tpu.engine import smc as jsmc
    from test_torch_host import to_jax
    from test_torch_propose import _plan_subkeys, _pool_key

    cm_j, cm_t, arenas, params = replay_pairs[which]
    cid = "Hospital"
    cap = cm_t.layouts[cid].capacity
    slots = np.array([0, 3, 1, 5, 2, 4][:REPLAY_ROWS], np.int64) % cap
    keys = jax.random.split(jax.random.PRNGKey(23), cap)
    eng_j = jsmc.Engine(cm_j, jsmc.InferenceConfig(batch_rows=1))
    run = eng_j._replay_chunk(cid, REPLAY_ROWS, rejuv)
    aj = run(to_jax(arenas), to_jax(params), jax.numpy.asarray(slots), keys)
    plans = cm_j.cls(cid).plans
    pools = []
    for s in slots:
        kp = jax.random.split(keys[s], 3)[0] if rejuv else keys[s]
        pools.append([torch.as_tensor(np.asarray(jax.random.uniform(
            _pool_key(sub), (jprop._draw_bound(cm_j, cid, plan),))))[None]
            for sub, plan in zip(_plan_subkeys(kp, len(plans)), plans)])
    eng_t = tsmc.Engine(cm_t, tsmc.InferenceConfig(batch_rows=1),
                        device="cpu")
    at, _lml = eng_t._replay_chunk(cid, to_torch(arenas, "cpu"),
                                   to_torch(params, "cpu"), slots, None,
                                   rejuv, pools=pools)
    for c in aj:
        np.testing.assert_array_equal(np.asarray(aj[c]["alive"]),
                                      at[c]["alive"].numpy())
        for v in aj[c]["values"]:
            np.testing.assert_array_equal(
                np.asarray(aj[c]["values"][v]), at[c]["values"][v].numpy(),
                err_msg=f"{which} {cid} rejuv={rejuv}: {c}.{v}")


@pytest.mark.parametrize("form", ["collapsed", "written_out"])
@pytest.mark.parametrize("rejuv", [True, False])
def test_latent_replay_pg_rows_match_host_excluded_rows(replay_pairs, form,
                                                        rejuv):
    from pclean_tpu_torch.engine.particles import pg_init_step, pg_rejuv_step

    _cm_j, cm_t, arenas, params = replay_pairs["chain"]
    cfg = tsmc.InferenceConfig(batch_rows=4, use_mh_instead_of_pg=False,
                               num_particles=4,
                               collapse_exact_pg=form == "collapsed")
    eng = tsmc.Engine(cm_t, cfg, device="cpu")
    cid, P = "Hospital", 4
    idx = np.array([1, 0, 4, 2], np.int64)
    out = []
    for chunk in (True, False):
        gen = torch.Generator().manual_seed(3)
        a, p = to_torch(arenas, "cpu"), to_torch(params, "cpu")
        if chunk:
            a, lml = eng._replay_chunk(cid, a, p, idx, gen, rejuv, pg_P=P)
        else:
            a, _r = tsmc.own_carry(cm_t, cid, a)
            car = ops.RowCarry(cm_t, cid, a, None, eng.obs_dev)
            lml = torch.zeros(())
            for s in idx:
                st = torch.tensor([s])
                if rejuv:
                    relx = trefresh.refresh(cm_t, a, eng.obs_dev,
                                            exclude_cid=cid,
                                            exclude_slot=int(s))
                    pg_rejuv_step(eng, car, relx, p, st, gen, P)
                else:
                    relx = trefresh.refresh(cm_t, a, eng.obs_dev)
                    lml = lml + pg_init_step(eng, car, relx, p, st, gen,
                                             P).sum()
        out.append((a, lml, gen.get_state()))
    (a0, l0, g0), (a1, l1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    for c in a0:
        assert torch.equal(a0[c]["alive"], a1[c]["alive"])
        for v in a0[c]["values"]:
            assert torch.equal(a0[c]["values"][v], a1[c]["values"][v]), \
                f"{form} {c}.{v}"


# ------------------------------------------------------ negative indices

SMALL_RUNS = {
    "scaled": dict(rows=512, hospitals=48, counties=12, names=24, zips=32,
                   batch=8),
    "rents": dict(rows=1000, states=12, counties=40, batch=16),
    "flights": dict(rows=300, flights=12, websites=8, sweeps=1,
                    capacities={"Flight": 16, "TrackingWebsite": 16}),
    "hospital": dict(rows=240, batch=16),
}


@pytest.mark.parametrize("workload", sorted(SMALL_RUNS))
def test_no_negative_index_reaches_a_scatter(monkeypatch, workload):
    import importlib

    from pclean_tpu_torch.engine.compile import init_state

    seen = {"scatter": [], "gather": []}

    def spy(kind, fn):
        def wrapped(idx, n):
            if idx.numel():
                seen[kind].append(int(idx.min()))
            return fn(idx, n)
        return wrapped

    drop = spy("scatter", tutils.drop_index)
    gather = spy("gather", tutils.gather_index)
    monkeypatch.setattr(tutils, "drop_index", drop)
    monkeypatch.setattr(tutils, "gather_index", gather)
    wl = importlib.import_module(f"pclean_tpu_torch.workloads.{workload}")
    cm, cfg, *_rest = wl.setup(**SMALL_RUNS[workload], device="cpu")
    arenas, params = init_state(cm, 0, device="cpu")
    eng = tsmc.Engine(cm, cfg, device="cpu")
    arenas, params, gen = eng.initialize(1, arenas, params)
    eng.run(gen, arenas, params)
    assert seen["scatter"] and seen["gather"]
    assert min(seen["scatter"]) >= 0, f"{workload}: a scatter index < 0"
    assert min(seen["gather"]) >= 0, f"{workload}: a gather index < 0"


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels)")
    ops.build_kernels()
    return torch.device("cuda")


K14_CASES = [
    ("refcount n=1000 src=1000 +1ax:1000 -", 64),
    ("prop n=5000 src=5000 +1asc:5000,700 i32", 300),
    ("prop n=5000 src=5000 +1asxc:5000,700,90 f32", 90),
    ("prop n=3000 src=3000 +1asc:3000q,200q,50,20 i64", 20),
    ("prop n=2000 src=2000 +1asc: i32", 2000),
    ("prop n=1000000 src=1000000 +1asc:1000000,11264 i32", 11264),
    ("delta n=256 src=4000 +1a:4000/-1a:4000 - idx", 500),
    ("delta n=4096 src=100000 -1as:100000,1000 - idx", 1000),
    ("delta n=4096 src=100000 +1asc:100000,1000 i32 idx", 1000),
    ("delta n=64 src=11264 -1w:11264,1472 - idx", 1472),
    ("delta n=64 src=11264 +1wc:11264,1472 i32 idx", 1472),
    ("cascade County fks=0", 1472),
    ("cascade Hospital fks=2", 11264),
]
# the histogram route's edges (ops.rel_scatter_plan): scaled's refcount,
# the exclusion (a tensor; an int below), an int64 fk column, C just under
# and just over a block's shared memory (the latter on the thread route),
# specs it does not take (codes of each dtype, two sides)
_CL = ops.K14_SMEM_MAX // 4
K14_HIST_CASES = [
    ("refcount n=1000000 src=1000000 +1a:1000000 -", 11264),
    ("refcount n=100000 src=100000 +1ax:100000 -", 1472),
    ("refcount n=500000 src=500000 +1a:500000q -", 5000),
    (f"refcount n={32 * _CL} src={32 * _CL} +1a:{32 * _CL} -", _CL),
    (f"refcount n={32 * _CL + 128} src={32 * _CL + 128} "
     f"+1a:{32 * _CL + 128} -", _CL + 1),
    ("prop n=1000000 src=1000000 +1asc:1000000,11264 i32", 11264),
    ("prop n=500000 src=500000 +1asxc:500000,11264 i64", 11264),
    ("prop n=500000 src=500000 +1asc:500000,3000 f32", 3000),
    ("delta n=200000 src=200000 -1a:200000/+1awc:200000 i32", 4000),
]
# (route, blocks) each histogram case is also forced into where it can be
K14_FORCED = [("thread", None), ("local", None), ("local", 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,C", K14_CASES + K14_HIST_CASES)
def test_k14_cuda_matches_plain(card, mode, C):
    for seed in (0, 1):
        kb.check_k14(ops, kb.k14_inputs(card, mode, C, seed=seed))
    if (mode, C) not in K14_HIST_CASES:
        return
    inp = kb.k14_inputs(card, mode, C, seed=2)
    _k, cnt, code, sides, n, slots = inp["args"][:6]
    local = ops._k14_hist_spec(sides, code, slots) and \
        4 * C <= ops.K14_SMEM_MAX
    for route, bl in K14_FORCED:
        if route == "thread" or local:   # where the kernel takes the route
            kb.check_k14(ops, inp, route=route, blocks=bl)


@pytest.mark.cuda
@pytest.mark.parametrize("edit", ["one target", "none alive", "dropped"])
def test_k14_cuda_histogram_edges_match_plain(card, edit):
    inp = kb.k14_inputs(card, "refcount n=400000 src=400000 +1a:400000 -",
                        5000, seed=3)
    sd = inp["args"][3][0]
    if edit == "one target":
        sd["hops"][0].fill_(-2)   # wraps to C - 2
    elif edit == "none alive":
        sd["alive"].zero_()
    else:
        sd["hops"][0].fill_(5000)
    assert kb.k14_plan(ops, inp)["route"] == "local"
    for route, bl in K14_FORCED:
        kb.check_k14(ops, inp, route=route, blocks=bl)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prop n=5000 src=5000 +1asxc:5000,700 i32",
                                  "refcount n=500000 src=500000 "
                                  "+1ax:500000 -"])
def test_k14_cuda_exclude_int_matches_plain(card, mode):
    inp = kb.k14_inputs(card, mode, 300)
    args = list(inp["args"])
    args[6] = kb.k14_parse(mode)["n"] // 2   # the excluded slot as an int
    inp["args"] = tuple(args)
    kb.check_k14(ops, inp)
    assert kb.k14_plan(ops, inp)["route"] == \
        ("local" if mode.startswith("refcount") else "thread")


K15_CASES = [
    ("Record cap=1000 i32<i64,f32<f32,b<b,alive", 256),
    ("Record cap=100 i32<i32", 4096),
    ("Hospital cap=5000 i16<f32,i64<i32,f64<f32,i8<i64", 64),
    ("County cap=64 alive", 64),
]


_NP = {0: np.uint8, 1: np.int8, 2: np.uint8, 3: np.int16, 4: np.int32,
       5: np.int64, 6: np.float32, 7: np.float64}


def _at(ptr: int, n: int, dt: int) -> np.ndarray:
    """The n elements of dtype code dt at address ptr, as a numpy view."""
    t = np.dtype(_NP[dt])
    if n == 0:   # an empty tensor's pointer may be 0
        return np.zeros(0, t)
    buf = (ctypes.c_uint8 * (n * t.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=t)


def run_k15(words) -> tuple:
    """csrc/batch_write.cu's kernel written out over one launch's words,
    bound to CPU tensors (ops.batch_write_words), reading and writing
    through the words' addresses: cluster q of ceil(total / share) owns
    bytes [q share, (q + 1) share) of the columns laid end to end, its
    block j the j-th share / n of them and the j-th ceil(B / n) rows (n
    blocks a cluster, header word 6; share / n and ceil(B / n) words 7
    and 8; solo, word 9, held to one cluster starting at column 0); each
    block copies its 16-byte units,
    each in the column of the last offset at or below it (the kernel's
    walk), up to the column's end; then, after the cluster's barrier,
    writes each of its rows whose element lies in the cluster's share into
    the columns the share touches (the plan's block table, the same word
    for every block of a cluster, held to the columns the share overlaps),
    a column at a time, the slots [tlo, thi)
    (converted as the kernel converts: an integer by a C cast, a float
    through a double). Returns, a list a column, how many times each byte
    was copied, the block that copied each element and the block that
    wrote each element (-1: none)."""
    cols, B, slots_p, ok_p, share, total, n, part, per, w_rows = words[:10]
    recs = [words[ops.K15_HEAD + ops.K15_COL * c:
                  ops.K15_HEAD + ops.K15_COL * (c + 1)] for c in range(cols)]
    size = [np.dtype(_NP[r[2]]).itemsize for r in recs]
    offs = np.array([r[6] for r in recs], np.int64)
    ends = [r[6] + r[3] * sz for r, sz in zip(recs, size)]
    slots = _at(slots_p, B, 5).copy()
    ok = _at(ok_p, B, 0) != 0
    copied = [np.zeros(r[3] * sz, np.int64) for r, sz in zip(recs, size)]
    owner = [np.full(r[3], -1) for r in recs]
    wrote = [np.full(r[3], -1) for r in recs]
    clusters = 1 if total == 0 else -(-total // share)
    assert share % (16 * n) == 0
    assert len(words) == ops.K15_HEAD + ops.K15_COL * cols + clusters * n
    assert part == share // n and per == -(-B // n)
    assert w_rows == (2 if per <= 2 * ops.K15_THREADS else 8)
    for q in range(clusters):
        lo, hi = q * share, min(q * share + share, total)
        for j in range(n):   # the copy: block q n + j's part
            plo = min(hi, lo + j * part)
            units = np.arange(plo // 16, min(hi, plo + part) // 16,
                              dtype=np.int64)
            col_of = np.searchsorted(offs, units * 16, side="right") - 1
            for c in np.unique(col_of):
                r, sz = recs[c], size[c]
                nb = r[3] * sz
                b = units[col_of == c] * 16 - r[6]
                idx = (b[:, None] + np.arange(16)).ravel()
                idx = idx[idx < nb]
                _at(r[1], nb, 2)[idx] = _at(r[0], nb, 2)[idx]
                copied[c][idx] += 1
                owner[c][idx // sz] = q * n + j
        # the block table's words, against the columns the share touches
        table = ops.K15_HEAD + ops.K15_COL * cols + q * n
        assert len(set(words[table:table + n])) == 1
        cw = words[table]
        ca, cb = cw & 0xffffffff, (cw >> 32) - 1
        assert ca == next((c for c in range(cols) if ends[c] > lo), cols)
        assert cb == max((c for c in range(cols) if recs[c][6] < hi and
                          ends[c] > recs[c][6]), default=-1)
        for j in range(n):   # the writes: block q n + j's rows
            rows = np.zeros(B, bool)
            rows[min(B, j * per):min(B, j * per + per)] = True
            for c in range(ca, cb + 1):   # slots [tlo, thi)
                r, sz = recs[c], size[c]
                assert (lo - r[6]) % sz == 0 and (hi - r[6]) % sz == 0
                tlo = min(r[3], max(0, (lo - r[6]) // sz))
                thi = min(r[3], max(0, (hi - r[6]) // sz))
                t = np.where(slots < 0, slots + r[3], slots)
                keep = rows & ok & (t >= tlo) & (t < thi)
                dst = _at(r[1], r[3], r[2])
                if r[4] == 0:   # the alive bit
                    dst[t[keep]] = 1
                else:
                    v = _at(r[4], B, r[5])[keep]
                    if r[2] == 0:
                        v = v != 0
                    elif r[2] < 6 or r[5] < 6:
                        v = v.astype(np.int64)
                    dst[t[keep]] = v.astype(_NP[r[2]])
                assert (wrote[c][t[keep]] == -1).all(), "written twice"
                wrote[c][t[keep]] = q * n + j
    return copied, owner, wrote


def _k15_plan_check(cols, vals, slots, ok, alive, sms, dsts=None):
    """K15's launches over CPU tensors through run_k15, against the plain
    version: the new columns bit-equal, the caller's unchanged, every byte
    of every column copied by exactly one block and every kept slot
    written by exactly one block, of the cluster that copied it. `dsts`:
    the new columns to write (torch.empty_like by default)."""
    srcs = list(cols) + ([alive] if alive is not None else [])
    vs = [v.reshape(-1).contiguous() for v in vals] + \
        ([None] if alive is not None else [])
    before = [x.clone() for x in srcs]
    dsts = dsts or [torch.empty_like(x) for x in srcs]
    want = ops.batch_write_plain(cols, vals, slots, ok, alive)
    want = want[0] + ([want[1]] if alive is not None else [])
    launches = ops.batch_write_words(srcs, dsts, vs, slots, ok, sms)
    assert [(lo, hi) for lo, hi, _w, _p in launches] == \
        ops.batch_write_chunks(len(srcs))
    for lo, hi, words, plan in launches:
        n, B = hi - lo, slots.shape[0]
        cl = plan["cluster"]
        assert plan["blocks"] == plan["clusters"] * cl <= sms
        assert 1 <= cl <= ops.K15_CLUSTER and plan["share"] % (16 * cl) == 0
        per = cl * ops.K15_THREADS * ops.K15_UNROLL_W
        assert plan["clusters"] == 1 or \
            plan["share"] >= cl * ops.K15_MIN_SHARE or \
            plan["clusters"] <= n * -(-B // per)
        copied, owner, wrote = run_k15(words)
        for c in range(hi - lo):
            x = srcs[lo + c]
            assert (copied[c] == 1).all(), f"column {lo + c}: bytes copied " \
                f"{np.unique(copied[c])} times"
            cap = x.shape[0]
            s = slots.numpy()
            s = np.where(s < 0, s + cap, s)
            kept = np.zeros(cap, bool)
            kept[s[ok.numpy() & (s >= 0) & (s < cap)]] = True
            np.testing.assert_array_equal(wrote[c] >= 0, kept)
            # written by a block of the cluster that copied the element,
            # after the cluster's barrier
            np.testing.assert_array_equal(wrote[c][kept] // cl,
                                          owner[c][kept] // cl)
    for i, (d, w, b, x) in enumerate(zip(dsts, want, before, srcs)):
        assert torch.equal(d, w), f"column {i}"
        assert torch.equal(x, b), f"the caller's column {i} was written"


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("mode,B", K15_CASES + [
    ("Record cap=100000 i32<i64,i32<i64,f32<f32,alive", 4096),
    ("Hospital cap=512 i32<i64,i32<i32,i16<i64,u8<b,f64<f32,i8<i32,b<b",
     4096)])
def test_k15_plan_read_as_the_kernel_reads_it(mode, B, sms):
    for seed in (0, 1):
        inp = kb.k15_inputs("cpu", mode, B, seed=seed)
        _k15_plan_check(*inp["args"], sms=sms)


def test_k15_plan_at_ragged_sizes_and_alignments():
    """Columns of 0, 1, 15, 17 and 4,099 elements, of every dtype, views
    whose pointers are not 16-byte aligned (the byte path) beside aligned
    ones, new columns unaligned too, 9,000 rows (three of the kernel's
    rounds of staged rows; the model reads them at once), slots wrapping,
    dropping and past every length."""
    rng = np.random.default_rng(3)
    dts = [torch.int32, torch.int8, torch.float64, torch.int16, torch.bool,
           torch.float32, torch.int64, torch.uint8]
    for lens, B in (([17, 15, 1, 0, 4099], 40), ([4099] * 3, 9000),
                    ([1], 3), ([0, 0], 5)):
        cols, vals, dsts = [], [], []
        for i, n in enumerate(lens):
            dt = dts[i % len(dts)]
            shift = i % 3   # 0: aligned; else an offset view
            base = torch.as_tensor(rng.integers(0, 100, n + shift)).to(dt)
            cols.append(base[shift:])
            vals.append(torch.as_tensor(rng.random(B) * 120).to(
                dts[(i + 3) % len(dts)]))
            dsts.append(torch.empty(n + 1, dtype=dt)[1:] if i % 2
                        else torch.empty(n, dtype=dt))
        cap = max(lens)
        s = rng.permutation(cap + 7)[:B] if B <= cap + 7 else \
            rng.integers(-cap, cap + 7, B)
        if B > cap + 7:   # distinct slots as the callers give them
            s = np.concatenate([rng.permutation(cap + 7),
                                np.full(B - cap - 7, cap + 50)])
        # the last slot named by -1 (its wrap), the slots still distinct
        s[np.flatnonzero(s == cap - 1)[:1] if (s == cap - 1).any()
          else 0] = -1
        slots = torch.as_tensor(s, dtype=torch.int64)
        ok = torch.as_tensor(rng.random(B) < 0.8)
        alive = torch.as_tensor(rng.random(cap) < 0.5)
        if len(set(lens)) == 1:   # alive has the columns' length
            _k15_plan_check(cols, vals, slots, ok, alive, 132,
                            dsts + [torch.empty_like(alive)])
        for sms in (1, 7):
            _k15_plan_check(cols, vals, slots, ok, None, sms, list(dsts))


def test_k15_plain_leaves_the_callers_columns():
    inp = kb.k15_inputs("cpu", K15_CASES[0][0], K15_CASES[0][1])
    before = [x.clone() for x in inp["args"][0] + [inp["args"][4]]]
    new, alive = ops.batch_write_plain(*inp["args"])
    after = inp["args"][0] + [inp["args"][4]]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(new + [alive], after))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,B", K15_CASES)
def test_k15_cuda_matches_plain(card, mode, B):
    for seed in (0, 1):
        kb.check_k15(ops, kb.k15_inputs(card, mode, B, seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("lens,B", [([17, 15, 1, 0, 4099], 40),
                                    ([4099] * 3, 9000),
                                    ([1_000_000] * 4, 4096)])
def test_k15_cuda_ragged_and_unaligned_match_plain(card, lens, B):
    """Columns of every dtype, views on the card whose pointers are not
    16-byte aligned (the kernel's byte copy: their words' aligned flag is
    0) beside aligned ones, empty columns, more rows than one round of
    staged rows, and scaled's shape: bit-equal to the plain version, the
    caller's columns unchanged, one launch."""
    rng = np.random.default_rng(5)
    dts = [torch.int32, torch.int8, torch.float64, torch.int16, torch.bool,
           torch.float32, torch.int64, torch.uint8]
    cols, vals = [], []
    for i, n in enumerate(lens):
        shift = i % 3
        base = torch.as_tensor(rng.integers(0, 100, n + shift)).to(
            dts[i % len(dts)])
        cols.append(base.to(card)[shift:])
        vals.append(torch.as_tensor(rng.random(B) * 120).to(
            dts[(i + 3) % len(dts)]).to(card))
    cap = max(lens)
    s = np.concatenate([rng.permutation(cap + 7), np.full(B, cap + 50)])[:B]
    # the last slot named by its wrap, the slots still distinct
    s[np.flatnonzero(s == cap - 1)[:1] if (s == cap - 1).any() else 0] = -1
    slots = torch.as_tensor(s, dtype=torch.int64, device=card)
    ok = torch.as_tensor(rng.random(B) < 0.8, device=card)
    alive = torch.as_tensor(rng.random(cap) < 0.5, device=card) \
        if len(set(lens)) == 1 else None
    before = ops.LAUNCHES["batch_write"]
    kb.check_k15(ops, dict(mode=f"lens {lens}", B=B,
                           args=(cols, vals, slots, ok, alive)))
    assert ops.LAUNCHES["batch_write"] - before == 1
    # the words of that launch (its call's pointers): some column unaligned
    srcs = cols + ([alive] if alive is not None else [])
    vs = vals + ([None] if alive is not None else [])
    (_lo, hi, words, _plan), = ops._k15_plan(srcs, vs, slots, ok, None)[4]
    flags = [words[ops.K15_HEAD + ops.K15_COL * c + 7] for c in range(hi)]
    assert 0 in flags and 1 in flags, flags


@pytest.mark.cuda
def test_k14_k15_refuse_what_they_do_not_take(card):
    cnt = torch.zeros(8, dtype=torch.int64, device=card)
    col = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ops.rel_scatter("prop", cnt, None, [ops.scatter_side([col])], 8)
    cnt = cnt.to(torch.int32)
    with pytest.raises(ValueError):
        ops.rel_scatter("prop", cnt, None, [ops.scatter_side([col])] * 3, 8)
    # a side past K14_MAX_HOPS hops is no longer refused: its chain is
    # folded by K18 first (ops.fold_chain), equal to the plain version
    want = cnt.cpu()
    ops.rel_scatter_plain("prop", want, None,
                          [ops.scatter_side([col.cpu()] * 5)], 8)
    ops.rel_scatter("prop", cnt, None, [ops.scatter_side([col] * 5)], 8)
    torch.cuda.synchronize()
    assert torch.equal(cnt.cpu(), want)
    with pytest.raises(ValueError):
        ops.rel_scatter("prop", cnt, None, [ops.scatter_side(
            [col], exclude=True)], 8, exclude=torch.zeros(
                2, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        ops.batch_write([col], [col], torch.zeros(8, dtype=torch.int32,
                                                  device=card),
                        torch.ones(8, dtype=torch.bool, device=card))
    # the kernel refuses words that force the histogram route where its
    # bins do not fit or onto a spec it does not take, or an unknown route
    big = torch.zeros(ops.K14_SMEM_MAX // 4 + 1, dtype=torch.int32,
                      device=card)
    for c_, code, sd, route in (
            (big, None, ops.scatter_side([col]), 1),
            (cnt, col, ops.scatter_side([col], code=col), 1),
            (cnt, None, ops.scatter_side([col]), 2)):
        words = ops.k14_words("prop", c_, code, [sd], 8, None, None, 8)[0]
        words[13], words[15] = route, 1
        arr = (ctypes.c_int64 * len(words))(*words)
        assert ops._fn("rel_scatter")(arr, len(arr), ops._stream(c_)) != 0


def _card_model(dev):
    from pclean_tpu_torch.workloads import scaled
    cm, cfg, *_r = scaled.setup(**SMALL_RUNS["scaled"], device=dev)
    return cm, cfg


@pytest.mark.cuda
def test_batched_steps_on_card_match_cpu(card):
    torch.cuda.synchronize()
    cms = {d: _card_model(d) for d in ("cpu", "cuda")}
    res = {}
    for d, (cm, cfg) in cms.items():
        eng = tsmc.Engine(cm, cfg, device=d)
        at = kb.row_state(cm, 9, device=d)
        rng = np.random.default_rng(11)
        cid = cm.obs_specs[0].class_id
        slots = rng.choice(cm.layouts[cid].capacity, 64, replace=False)
        new = _rewritten(cm, {c: {"values": {v: x.cpu() for v, x in
                                             a["values"].items()},
                                  "alive": a["alive"].cpu()}
                              for c, a in at.items()}, cid, slots, rng)
        new = to_torch(to_numpy(new), d)
        st = torch.as_tensor(slots, device=d)
        env = {v: new[cid]["values"][v][st] for v in cm.layouts[cid].store}
        ok = torch.as_tensor(rng.random(64) < 0.7, device=d)
        if d == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            rel = trefresh.refresh(cm, at, eng.obs_dev, exclude_cid=cid,
                                   exclude_slot=st[:1])
            rel2 = trefresh.batch_obs_delta(cm, rel, at, new, eng.obs_dev,
                                            cid, st)
            a2 = tsmc._apply_batch(cm, cid, at, st, env, ok, True)
            lat = _latents(cm)[0]
            hops = trefresh.hop_histograms(cm, lat, at, eng.obs_dev)
            rel3 = trefresh.batch_latent_delta(cm, rel, at, new, lat,
                                               st[:8] % cm.layouts[lat]
                                               .capacity, hops)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        res[d] = dict(rel=rel, rel2=rel2, a2=a2, hops=hops, rel3=rel3)
    for name, x, y in kb._leaves(res["cuda"], res["cpu"], "out"):
        assert torch.equal(x.cpu(), y), name


@pytest.mark.cuda
@pytest.mark.parametrize("rejuv", [True, False])
def test_latent_replay_graphs_bit_equal(card, rejuv):
    from pclean_tpu_torch.engine.compile import init_state

    cm, cfg = _card_model("cuda")
    eng = tsmc.Engine(cm, cfg, device="cuda")
    a, p = init_state(cm, 0, device="cuda")
    a, p, _g = eng.initialize(1, a, p)
    r = kb.graph_against_eager(eng, a, p, "replay", "Hospital", 16,
                               rejuv=rejuv)
    assert not r["mismatches"], r["mismatches"]
    assert r["stats"]["replayed"] == 15 and r["stats"]["captures"] == 1
