"""K16's and K17's draw geometries (ops.draw_plan) and K17's group mode.

CPU: draw_plan's geometry at the six paths' census shapes of K16 and K17
and at its edges (1-3, 31-33 logits, the warp limit and the cluster
threshold +-1, rows past shared memory); draw_groups on the scaled,
hospital, flights, rents and limits models' plans (members and pool
columns equal to those BlockTracer._unif hands the same choices when
the walk draws each in its own launch); every class's proposal with the
group launch bit-equal to the one without it (plain versions); the
group's launch plan (group_chunks past K17_GROUP_MAX, the words read as
csrc/choice_sample.cu reads them, through the CPU tensors' addresses);
hospital's Place and Hospital blocks and scaled's Hospital block against
pclean_tpu's sample under its uniform pool, grouped and not.

Card (`cuda` marker; `python -m pytest -m cuda
tests/test_torch_draw_plan.py` on the H100): every geometry of K16 and
K17 and every group shape bit-equal to the plain versions drawing with
K2 (ops.inv_cdf_sample, whose draw_row is K2's own) at the census shapes
and on edge rows: NEG_INF entries, ties, u = 0 and u = 1 - 2^-24, one-hot
mass, record rows at every 16-byte phase, masks whose cap is not a
multiple of 16; a group past K17_GROUP_MAX in two launches.
"""
import ctypes

import numpy as np
import pytest
import torch

from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops
from pclean_tpu_torch.engine import propose as tprop

# the CPU tests import jax and pclean_tpu inside: the card has neither
F32 = torch.float32
SMEM_ROW = (ops.SMEM_MAX - ops._K2_STATIC_SMEM) // 4 - 4   # fits a block


# ------------------------------------------------------------- draw_plan

CENSUS_PLANS = [   # (B, K, mask, geometry): the census shapes
    (1, 14, 0, "block"), (1, 111, 0, "block"), (1, 241, 0, "block"),
    (1, 2, 0, "block"), (1, 1766, 0, "block"), (1, 1914, 0, "block"),
    (1, 7735, 0, "block"), (4096, 138, 0, "warp"),
    (4096, 1914, 0, "warp"), (4096, 7735, 0, "block"),
    (256, 1766, 0, "block"), (256, 2, 0, "warp"), (16, 111, 0, "warp"),
    (1, 65, 64, "warp"), (1, 161, 160, "warp"), (1, 1473, 1472, "block"),
    (1, 4097, 4096, "block"), (1, 11265, 11264, "block"),
    (256, 4097, 4096, "block"), (4096, 11265, 11264, "block"),
    (4096, 129, 1472, "warp"), (256, 513, 4096, "block"),
    (1, 9, 8, "warp"), (1, 9, 0, "block"), (2, 9, 0, "warp"),
]


@pytest.mark.parametrize("B,K,mask,geometry", CENSUS_PLANS)
def test_draw_plan_at_the_census_shapes(B, K, mask, geometry):
    p = ops.draw_plan(B, K, mask)
    assert p["geometry"] == geometry
    if geometry == "warp":
        assert p["threads"] == 32 * min(16, -(-B // 264)) and p["smem"] == 0
        assert p["blocks"] * p["rows"] >= B
    elif geometry == "cluster":
        assert 2 <= p["cluster"] <= ops.DRAW_MAX_CLUSTER
        assert p["blocks"] == B * p["cluster"]
        assert p["smem"] == (ops.cluster_slice(K, p["cluster"]) + 4) * 4
    else:
        assert p["threads"] == 512 and p["smem"] == (K + 4) * 4


S, R, W = ops.DRAW_WARP_SHORT, ops.DRAW_WARP_ROWS, ops.DRAW_WARP_MAX
C = ops.DRAW_CLUSTER_MIN
EDGES = [   # (B, K, mask, geometry)
    (1, 1, 0, "block"), (2, 2, 0, "warp"), (1, 3, 4, "warp"),
    (4096, 31, 0, "warp"), (4096, 32, 0, "warp"), (4096, 33, 0, "warp"),
    (2, S - 1, 0, "warp"), (2, S, 0, "warp"), (2, S + 1, 0, "block"),
    (1, S, 0, "block"), (1, S, 4, "warp"), (1, S + 1, 4, "block"),
    (R - 1, S + 1, 0, "block"), (R, S + 1, 0, "warp"),
    (R, W - 1, 0, "warp"), (R, W, 0, "warp"), (R, W + 1, 0, "block"),
    (1, C, 0, "block"), (1, C + 1, 0, "cluster"), (2, C + 1, 0, "block"),
    (1, 2, 4 * S, "warp"), (1, 2, 4 * S + 4, "block"),
    (R, 2, 4 * W + 4, "block"),
    (1, SMEM_ROW, 0, "cluster"), (2, SMEM_ROW, 0, "block"),
    (2, SMEM_ROW + 1, 0, "stream"), (1, 70_001, 0, "cluster"),
    (1, 0, 11264, "block"), (1, 0, 4 * C + 4, "cluster"),
    (4096, 0, 11264, "block"),
]


@pytest.mark.parametrize("B,K,mask,geometry", EDGES)
def test_draw_plan_edges(B, K, mask, geometry):
    p = ops.draw_plan(B, K, mask)
    assert p["geometry"] == geometry, p
    if geometry == "stream":
        assert p["tile"] == 16384 and p["tile"] < K


@pytest.mark.parametrize("g", ops.DRAW_GEOMETRIES)
def test_draw_plan_forced(g):
    """Every geometry can be forced where the row takes it: a stream's
    tile the largest multiple of 4 below K, a block's row in shared
    memory."""
    p = ops.draw_plan(3, 9, 0, g)
    assert p["geometry"] == g
    if g == "stream":
        assert p["tile"] == 8 and p["smem"] == 12 * 4
        with pytest.raises(ValueError):
            ops.draw_plan(3, 4, 0, g)
    if g == "block":
        with pytest.raises(ValueError):
            ops.draw_plan(3, SMEM_ROW + 1, 0, g)
    with pytest.raises(ValueError):
        ops.draw_plan(3, 9, 0, "lanes")


def test_cluster_slice_keeps_the_phase():
    for K in (1, 5, 4097, 7735, 11265, 70_001):
        for c in range(2, 9):
            L = ops.cluster_slice(K, c)
            assert L % 4 == 0 and L * c >= K and (L - 4) * c < K


# ----------------------------------------------------------- draw_groups


def _workloads():
    from pclean_tpu_torch.workloads import (flights, hospital, limits,
                                            rents, scaled)
    return {"scaled": (scaled, dict(rows=600, batch=16)),
            "hospital": (hospital, dict(rows=240, batch=16)),
            "flights": (flights, dict(rows=120)),
            "rents": (rents, dict(rows=400)),
            "limits": (limits, dict(rows=32, batch=8))}


@pytest.fixture(scope="module")
def models():
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    out = {}
    for name, (mod, kw) in _workloads().items():
        cm, cfg = mod.setup(device="cpu", **kw)[:2]
        eng = Engine(cm, cfg, device="cpu")
        arenas, params = init_state(cm, 0, device="cpu")
        out[name] = (cm, eng, arenas, params)
    return out


_REAL = (tprop.BlockTracer.sample, ops.choice_sample)
_GROUPS = tprop.draw_groups


def _ungrouped(monkeypatch, grouped: bool) -> None:
    """The tracer with its group launch, or drawing each choice in its own
    launch (no block has a group)."""
    monkeypatch.setattr(tprop, "draw_groups", _GROUPS if grouped
                        else lambda *a, **k: ())


def _propose(cm, eng, arenas, params, cid, grouped, monkeypatch, seed=0):
    """Every block of class cid for 5 rows, from one generator state,
    with the group launch or without it; returns (env2, births, w, the
    draws each block's pass made: [(plan, [(vid, ancestors, pool
    column)])])."""
    from pclean_tpu_torch.engine.refresh import refresh

    _ungrouped(monkeypatch, grouped)
    draws = []
    real_sample, real_choice = _REAL

    def sample(self, pool=None):
        draws.append((self._root_plan, []))
        return real_sample(self, pool)

    def choice_sample(rec, anc, B, u=None, **kw):
        if u is not None:
            draws[-1][1].append((int(kw["label"].split(".")[-1]), len(anc),
                                 u.storage_offset() -
                                 u._base.storage_offset()))
        return real_choice(rec, anc, B, u=u, **kw)

    monkeypatch.setattr(tprop.BlockTracer, "sample", sample)
    monkeypatch.setattr(ops, "choice_sample", choice_sample)
    rel = refresh(cm, arenas, eng.obs_dev)
    cap = cm.layouts[cid].capacity
    slots = torch.arange(min(5, cap))
    gen = torch.Generator().manual_seed(seed)
    env2, births, w = eng._propose(cid, arenas, rel, params, slots, gen,
                                   False)
    return env2, births, w, draws


@pytest.mark.parametrize("name", list(_workloads()))
def test_draw_groups_are_the_walks_columns(models, monkeypatch, name):
    """Every class's blocks drawn each in its own launch: the
    ancestor-free draws are exactly draw_groups' members, at the pool
    columns _unif handed them."""
    cm, eng, arenas, params = models[name]
    n = 0
    for cid in cm.model.class_order:
        *_x, draws = _propose(cm, eng, arenas, params, cid, False,
                              monkeypatch)
        static = frozenset(v for v, s in eng._static_obs.get(cid, {})
                           .items() if s)
        for plan, made in draws:
            members = _GROUPS(cm, cid, plan, static)
            assert [(v, c) for v, d, c in made if d == 0] == \
                [(v, c) for v, _ctx, c in members]
            n += len(members)
    assert n > 0


@pytest.mark.parametrize("name", list(_workloads()))
def test_grouped_pass_equals_ungrouped(models, monkeypatch, name):
    """Every class's proposal with the group launch bit-equal to the one
    drawing each choice in its own launch (same generator state)."""
    cm, eng, arenas, params = models[name]
    for cid in cm.model.class_order:
        a = _propose(cm, eng, arenas, params, cid, True, monkeypatch, 3)
        b = _propose(cm, eng, arenas, params, cid, False, monkeypatch, 3)
        assert set(a[0]) == set(b[0])
        for v in a[0]:
            assert torch.equal(a[0][v], b[0][v]), (cid, v)
        assert torch.equal(a[2], b[2])
        assert len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            assert torch.equal(x.slot, y.slot)
            assert torch.equal(x.is_new, y.is_new)
        if any(_GROUPS(cm, cid, p, frozenset(
                v for v, s in eng._static_obs.get(cid, {}).items() if s))
               for p, _m in a[3]):
            # the grouped pass drew its members without a launch each
            assert sum(d == 0 for _p, m in a[3] for _v, d, _c in m) == 0


def test_draw_groups_cached_by_plan_and_static(models):
    cm = models["hospital"][0]
    plan = cm.cls("Record").plans[0]
    a = tprop.draw_groups(cm, "Record", plan)
    assert tprop.draw_groups(cm, "Record", plan) is a
    # a choice observed in every row is a pick: no member, no column
    v = a[0][0]
    b = tprop.draw_groups(cm, "Record", plan, frozenset([v]))
    assert v not in [m[0] for m in b]
    assert [c for _v, _x, c in b] == [c - 1 if c > a[0][2] else c
                                      for _v, _x, c in a[1:]]


# --------------------------------------------------------- group words


@pytest.mark.parametrize("n,launches", [(1, 1), (64, 1), (65, 2), (66, 2),
                                        (129, 3)])
def test_group_chunks(n, launches):
    ch = ops.group_chunks(n)
    assert len(ch) == launches and ch[0][0] == 0 and ch[-1][1] == n
    assert all(0 < hi - lo <= ops.K17_GROUP_MAX for lo, hi in ch)
    assert all(a[1] == b[0] for a, b in zip(ch, ch[1:]))


def _f32_at(addr: int, i: int) -> float:
    return ctypes.c_float.from_address(addr + 4 * i).value


@pytest.mark.parametrize("B", [1, 5])
def test_group_words_read_as_the_kernel_reads_them(B):
    """A group of 70 members past K17_GROUP_MAX (two launches), records of
    one row and of B rows, one strided: each launch's words read through
    the CPU tensors' addresses as choice_group_kernel reads them (member
    m's row b at rec + b stride, its uniform at pool + b s0 + col s1, its
    output row at out + m B), drawn with K2's plain draw, equal to the
    group's plain version."""
    rng = np.random.default_rng(B)
    Vs = [int(v) for v in rng.integers(1, 300, 70)]
    big = torch.as_tensor(rng.normal(size=(B, 400)).astype(np.float32))
    recs = []
    for i, V in enumerate(Vs):
        if i % 3 == 0:
            recs.append(big[:, 7:7 + V])   # a row stride of 400
        else:
            x = rng.normal(size=(1 if i % 3 == 1 else B, V))
            x[rng.random(x.shape) < 0.3] = -1e30
            recs.append(torch.as_tensor(x.astype(np.float32)))
    pool_t = torch.as_tensor(rng.random((80, B)).astype(np.float32))
    pool = pool_t.t()   # strides (1, B)
    cols = [int(c) for c in rng.permutation(80)[:70]]
    out = torch.full((70, B), -1, dtype=torch.int32)
    launches = ops.choice_sample_group_words(recs, pool, cols, out)
    assert [(lo, hi) for lo, hi, _w, _k in launches] == [(0, 35), (35, 70)]
    want = ops.choice_sample_group_plain(recs, pool, cols)
    H, M = ops.K17_GROUP_HEAD, ops.K17_GROUP_MEMBER
    for lo, hi, w, _kept in launches:
        n, Bw, pp, s0, s1, op = w[:H]
        assert (n, Bw) == (hi - lo, B)
        for m in range(n):
            rp, rs, V, col, g, tile, cl = w[H + M * m:H + M * (m + 1)]
            assert V == Vs[lo + m] and col == cols[lo + m]
            assert ops.DRAW_GEOMETRIES[g] == ops.draw_plan(B, V)["geometry"]
            for b in range(B):
                x = torch.tensor([_f32_at(rp, b * rs + i) for i in range(V)])
                u = torch.tensor([_f32_at(pp, b * s0 + col * s1)])
                got = ops.inv_cdf_sample_plain(x[None], u)[0]
                assert int(got) == int(want[lo + m, b])
            assert op + (m * B) * 4 == out[lo + m].data_ptr()


# ------------------------------------------- against pclean_tpu's sample


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("block", ["hospital Place 0", "scaled Hospital 0",
                                   "hospital Hospital 0"])
def test_block_against_pclean_tpu(monkeypatch, grouped, block):
    """Latent classes' blocks, against pclean_tpu's
    sample under its uniform pool (test_torch_sample_kernels.run_block),
    with the group launch and without it."""
    from test_torch_sample_kernels import _keys, run_block
    model, cid, plan = block.split()
    if model == "hospital":
        from test_torch_hospital import hospital_pair as pair_of
        n_rows = 240
    else:
        from test_torch_host import scaled_pair as pair_of
        n_rows = 64
    from test_torch_propose import Pair
    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = pair_of()
    pair = Pair(cm_j, cfg_j, cm_t, cfg_t)
    _ungrouped(monkeypatch, grouped)
    cap = cm_t.layouts[cid].capacity
    slots = np.sort(np.random.default_rng(6).choice(min(cap, n_rows), 12,
                                                    replace=False))
    run_block(pair, cid, int(plan), slots, _keys(13, len(slots)),
              monkeypatch)


def test_kernel_bench_group_inputs_on_cpu():
    """kernel_bench's seeded group: records of their census rows, a pool
    with spare columns, each member's plain draw; its bytes and the
    geometries a group takes."""
    f = kb._groupf(3, (14, 7735, 2), rows=(1, 3, 3))
    inp = kb.sample_inputs("cpu", "choice_sample", f, None)
    recs, pool, cols = inp["args"]
    assert [tuple(r.shape) for r in recs] == [(1, 14), (3, 7735), (3, 2)]
    assert tuple(pool.shape) == (3, 6) and len(set(cols)) == 3
    got = kb._sample_call(ops, inp, plain=True)[0]
    assert torch.equal(got, ops.choice_sample_group_plain(recs, pool, cols))
    assert kb.sample_bytes(inp) == sum(r.numel() * 4 + 3 * 8 for r in recs)
    assert kb.draw_geometries(ops, inp) == ["warp", "block", "cluster"]


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


K17_SHAPES = [(1, 14, 0), (1, 241, 0), (1, 1766, 0), (1, 1914, 0),
              (1, 7735, 0), (1, 2, 1), (4096, 138, 0), (4096, 1914, 0),
              (4096, 7735, 0), (256, 1766, 0), (3, 1, 0), (3, 33, 2),
              (5, ops.DRAW_WARP_MAX + 1, 0), (2, 70_001, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,V,d", K17_SHAPES)
def test_k17_every_geometry_is_k2(card, B, V, d):
    inp = kb.k17_inputs(card, kb._k17f(B, d), V, seed=V)
    for g in kb.draw_geometries(ops, inp):
        kb.check_sample(ops, inp, geometry=g)


K16_SHAPES = [("shared", 1, 64, 65), ("shared", 1, 160, 161),
              ("shared", 1, 1472, 1473), ("shared", 1, 11264, 11265),
              ("own", 256, 4096, 4097), ("shared", 4096, 11264, 11265),
              ("own", 4096, 11264, 11265), ("inplace", 66, 1000, 257),
              ("shared", 7, 37, 38), ("own", 9, 1001, 1002),
              ("shared", 3, 5, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["drawn", "retained"])
@pytest.mark.parametrize("mask,B,cap,K1", K16_SHAPES)
def test_k16_every_geometry_is_k2(card, form, mask, B, cap, K1):
    for comp in (False, True):
        f = dict(form=form, mask=mask, B=B, cap=cap, comp=comp, d=B % 2)
        inp = kb.k16_inputs(card, f, K1, seed=cap)
        for g in kb.draw_geometries(ops, inp):
            kb.check_sample(ops, inp, geometry=g)


def _edge_rows(dev, B: int, V: int, phase: int):
    """K17 draw inputs on edge rows: one-hot mass, every entry equal
    (ties), mostly NEG_INF, normal; uniforms 0, 1 - 2^-24 and seeded; the
    record a view whose rows start at 16-byte phase `phase` (floats)."""
    rng = np.random.default_rng(V + phase)
    x = rng.normal(size=(B, V)).astype(np.float32)
    for b in range(B):
        kind = b % 4
        if kind == 0:
            x[b] = -1e30
            x[b, rng.integers(V)] = 0.5
        elif kind == 1:
            x[b] = 1.25
        elif kind == 2:
            x[b, rng.random(V) < 0.9] = -1e30
            x[b, rng.integers(V)] = 3.0
    big = np.zeros((B, V + 5), np.float32)
    big[:, phase:phase + V] = x
    rec = torch.as_tensor(big, device=dev)[:, phase:phase + V]
    u = rng.random(B).astype(np.float32)
    u[0::3] = 0.0
    u[1::3] = np.float32(1 - 2 ** -24)
    return dict(mode="edges", kernel="choice_sample",
                args=(rec, (), B), kwargs=dict(mode="draw",
                                               u=torch.as_tensor(u,
                                                                 device=dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("B,V", [(1, 3), (12, 33), (12, 2047), (2, 11265),
                                 (1, 7735)])
def test_k17_edge_rows_every_geometry(card, phase, B, V):
    inp = _edge_rows(card, B, V, phase)
    for g in kb.draw_geometries(ops, inp):
        kb.check_sample(ops, inp, geometry=g)


GROUPS = [kb._groupf(1, (14, 50, 75, 13, 99, 94, 102, 111, 23, 88, 8)),
          kb._groupf(1, (222, 238, 236, 241)),
          kb._groupf(1, (138, 7735, 1914)),
          kb._groupf(4096, (138, 7735, 1914)),
          kb._groupf(16, (14, 50, 75, 13), rows=(16, 1, 16, 1)),
          kb._groupf(1, (2, 11265, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(GROUPS)))
def test_k17_groups_every_geometry(card, i):
    """Each group shape in its planned geometries (a launch mixing warp,
    block and cluster members) and with every member forced to each."""
    inp = kb.sample_inputs(card, "choice_sample", GROUPS[i], None, seed=i)
    before = ops.LAUNCHES["choice_sample"]
    kb.check_sample(ops, inp)
    assert ops.LAUNCHES["choice_sample"] == before + 1
    for g in kb.draw_geometries(ops, inp):
        kb.check_sample(ops, inp, geometry=g)


@pytest.mark.cuda
def test_k17_group_past_the_limit_splits(card):
    f = kb._groupf(3, [2 + i % 27 for i in range(70)])
    inp = kb.sample_inputs(card, "choice_sample", f, None, seed=4)
    ops.SPLITS.pop("choice_sample_group", None)
    before = ops.LAUNCHES["choice_sample"]
    kb.check_sample(ops, inp)
    assert ops.LAUNCHES["choice_sample"] == before + 2
    assert ops.SPLITS["choice_sample_group"] == 1
