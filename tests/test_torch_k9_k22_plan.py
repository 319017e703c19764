"""K9 pg_resample's and K22 gamma_draw's launch plans, and plain models of
the orders their kernels add and pick in (no JAX, no card):

  * ops.gamma_draw_plan at every K22 census shape (rents' one Dirichlet
    row of 51, scaled's of 50, hospital's rows of 23, 14 and 8 in one
    call, flights' 39 Beta pairs) and at the card tests' `wide` and
    `many` cases: a block a row of the launch's widest P threads (32 to
    K22_THREADS, P / K22_THREADS elements a thread past that), the row
    table, the launches;
  * run_k22, csrc/gamma_draw.cu's dispatch written out: the plan's words
    (header, descriptors, row table) read through the CPU tensors'
    addresses as the kernel reads them, each block's row drawn by the
    plain gamma at the counters the words give and summed in the kernel's
    order, bit-equal to ops.gamma_draw_plain; a descriptor cut across
    launches where the row table fills;
  * k22_tree_model, the kernel's row sum (a thread's stack in bit-reversed
    order, the shared-memory levels, the last five by shuffles, +0.0 past
    the row), bit-equal to ops.tree_sum_plain at widths 1-1,024;
  * ops.pg_resample_plan at P = 1, 2, 16, 32, 33, 1,024 and 16,384: the
    group path (a group of _pow2(P) lanes a row, several rows a warp) up
    to 32 particles, the block path past that;
  * k9_group_model against k9_block_model, the group path's butterflies
    (max, s1, s2) over offsets G / 2, ..., 1 against the block path's
    32-lane butterfly and second stage on a warp with empty lanes, bit for
    bit on seeded weights at P = 2, 16 and 32, NEG_INF weights included;
  * the group path's pick, the count of prefix sums below the threshold
    capped at P - 1, against the block path's binary search, thresholds
    on the prefix sums themselves included;
  * kernel_bench.k9_chain and k22_chain, the latency bounds' chains:
    branches that run side by side count once, by the longest.
The plain versions are held against pclean_tpu in
test_torch_pg.py::test_k9_plain_matches_numpy_particles and
test_torch_param_kernels.py::test_dirichlet_and_beta_match_jax_in_distribution.
"""
import ctypes

import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops

F32 = np.float32

# K22's census shapes and the card tests' wide and many cases: (label,
# descriptors (mode, rows, width))
K22_PLAN_CASES = {
    "rents": [("dirichlet_log", 1, 51)],
    "scaled": [("dirichlet_log", 1, 50)],
    "hospital": [("dirichlet_log", 1, 23), ("dirichlet_log", 1, 14),
                 ("dirichlet_log", 1, 8)],
    "flights": [("beta", 39, 2)],
    "wide": [("gamma", 3, 700), ("dirichlet_log", 2, 1000),
             ("dirichlet_log", 5, 1), ("beta", 1, 2)],
    "many": [("dirichlet_log", 1, 3)] * 70,
}


@pytest.mark.parametrize("case", list(K22_PLAN_CASES))
def test_gamma_draw_plan_census(case):
    shapes = K22_PLAN_CASES[case]
    plan = ops.gamma_draw_plan(shapes)
    assert len(plan) == -(-len(shapes) // ops.K22_MAX_DESC)
    seen = {}
    for L in plan:
        assert 1 <= len(L["parts"]) <= ops.K22_MAX_DESC
        assert len(L["rows"]) <= ops.K22_MAX_ROWS
        widest = max([32] + [ops._pow2(shapes[p[0]][2]) for p in L["parts"]])
        assert L["threads"] == min(ops.K22_THREADS, widest)
        for p, (k, r0, rows, E) in enumerate(L["parts"]):
            mode, R, W = shapes[k]
            assert E == max(1, ops._pow2(W) // L["threads"])
            seen.setdefault(k, []).append((r0, rows))
            assert [i for q, i in L["rows"] if q == p] == list(range(rows))
    for k, (mode, R, W) in enumerate(shapes):   # every row exactly once
        cover = sorted(seen.get(k, []))
        assert sum(n for _r, n in cover) == R
        assert all(a[0] + a[1] == b[0] for a, b in zip(cover, cover[1:]))
    if case in ("rents", "scaled"):   # a block of 64, an element a thread
        assert plan[0]["parts"] == [(0, 0, 1, 1)]
        assert plan[0]["rows"] == [(0, 0)] and plan[0]["threads"] == 64
    if case == "hospital":   # three blocks of 32, one a descriptor
        assert plan[0]["rows"] == [(0, 0), (1, 0), (2, 0)]
        assert plan[0]["threads"] == 32
    if case == "flights":   # 39 blocks of 32, a Beta pair each
        assert plan[0]["rows"] == [(0, i) for i in range(39)]
        assert plan[0]["threads"] == 32
    if case == "wide":   # rows of 700 and 1,000 on blocks of 256
        assert len(plan[0]["rows"]) == 11 and plan[0]["threads"] == 256
        assert [p[3] for p in plan[0]["parts"]] == [4, 4, 1, 1]


def test_gamma_draw_plan_cuts_a_descriptor_where_the_rows_fill():
    rows = 2 * ops.K22_MAX_ROWS + 5   # Beta pairs, a block each
    plan = ops.gamma_draw_plan([("dirichlet_log", 2, 9), ("beta", rows, 2)])
    assert [len(L["rows"]) for L in plan] == [ops.K22_MAX_ROWS] * 2 + [7]
    assert [p[:3] for L in plan for p in L["parts"]] == [
        (0, 0, 2), (1, 0, ops.K22_MAX_ROWS - 2),
        (1, ops.K22_MAX_ROWS - 2, ops.K22_MAX_ROWS),
        (1, 2 * ops.K22_MAX_ROWS - 2, 7)]
    # every launch's threads its own widest P
    assert [L["threads"] for L in plan] == [32, 32, 32]
    assert ops.gamma_draw_plan([("gamma", 1, 257)])[0]["parts"] == [
        (0, 0, 1, 2)]
    assert ops.gamma_draw_plan([("gamma", 1, 33)])[0]["threads"] == 64
    with pytest.raises(ValueError):
        ops.gamma_draw_plan([("beta", 1, 3)])


# ------------------------------------------------------ K22's row sum


def _f32_add(a, b):
    return (np.asarray(a, F32) + np.asarray(b, F32)).astype(F32)


def k22_tree_model(x, threads=None):
    """csrc/gamma_draw.cu's sum of one row x (float32 [W]) on a block of
    `threads` threads (the plan's for a launch of this one row by
    default)."""
    W = x.shape[0]
    P = ops._pow2(W)
    if threads is None:
        threads = ops.gamma_draw_plan([("gamma", 1, W)])[0]["threads"]
    xs = np.zeros(max(P, threads), F32)
    xs[:W] = x
    T = threads
    E = max(1, P // T)
    lg = E.bit_length() - 1
    acc = np.zeros(T, F32)
    for t in range(T):   # each thread's stack in bit-reversed order of e
        st = []
        for i in range(E):
            e = int(format(i, f"0{lg}b")[::-1], 2) if lg else 0
            j = t + T * e
            st.append(xs[j] if j < W else F32(0.0))
            c = i + 1
            while c % 2 == 0:
                b, a = st.pop(), st.pop()
                st.append(_f32_add(a, b)[()])
                c //= 2
        assert len(st) == 1
        acc[t] = st[0]
    n = min(P, T)
    sh = acc.copy()
    h2 = n // 2
    while h2 >= 32:
        sh[:h2] = _f32_add(sh[:h2], sh[h2:2 * h2])
        h2 //= 2
    m = min(n, 32)
    v = np.where(np.arange(32) < m, sh[:32], F32(0.0)).astype(F32)
    o = 16
    while o >= 1:
        if o < m:
            v = _f32_add(v, np.concatenate([v[o:], v[32 - o:]]))
        o //= 2
    return v[0]


@pytest.mark.parametrize("chunk", range(8))
def test_k22_tree_model_is_tree_sum_plain(chunk):
    rng = np.random.default_rng(chunk)
    for W in range(1 + 128 * chunk, 129 + 128 * chunk):
        x = rng.gamma(rng.uniform(0.05, 3.0), size=W).astype(F32)
        want = ops.tree_sum_plain(torch.from_numpy(x)).numpy()
        assert k22_tree_model(x).tobytes() == want.tobytes(), W
        if W <= 256 and W % 7 in (0, 1):   # beside a row of 256
            assert k22_tree_model(x, 256).tobytes() == want.tobytes(), W


# ------------------------------------------------- K22's words, run on the CPU


def _view(addr, ctype, n):
    return np.ctypeslib.as_array((ctype * max(n, 1)).from_address(addr))


def run_k22(launches, alphas, draws):
    """csrc/gamma_draw.cu's dispatch over filled launches (ops._k22_fill):
    every block of each launch's words, its descriptor and row read from
    the row table, its elements' alphas through the tensors' addresses
    (held bit-equal to `alphas`, the call's alphas by counter), its draws
    `draws` at the words' counters (torch's CPU functions may round a
    value by its place in a batch, the card's do not), summed by
    k22_tree_model on the launch's threads and written through the output
    pointer as the kernel writes them."""
    for words, _addr, n, *_rest in launches:
        w = np.frombuffer(words, dtype=np.int64)[:n]
        nd, seed_p, n_rows, T = (int(x) for x in w[:4])
        assert 1 <= nd <= ops.K22_MAX_DESC and 32 <= T <= ops.K22_THREADS
        assert seed_p != 0 and not any(w[4:ops.K22_HEAD])
        table = w[ops.K22_ROWS_AT:].view(np.int32)
        for u in range(n_rows):   # block u
            e = int(table[u])
            k, r = e & 63, e >> 6
            assert k < nd
            d = [int(x) for x in w[ops.K22_HEAD + ops.K22_DESC * k:][:14]]
            mode, R, W, P, E, base, bs, cnt, dt, rs, cs, out, ors, el = d
            assert r < R and P == ops._pow2(W)
            assert E == max(1, P // T)
            b = _view(base, ctypes.c_float, (W - 1) * bs + 1)
            j = np.arange(W)
            alpha = torch.from_numpy(b[j * bs].copy())
            if cnt:
                c = _view(cnt, ctypes.c_int64 if dt == 5 else
                          ctypes.c_int32, r * rs + (W - 1) * cs + 1)
                alpha = alpha + torch.from_numpy(
                    c[r * rs + j * cs].astype(np.int64)).float()
            at = slice(el + r * W, el + (r + 1) * W)
            assert torch.equal(alpha, alphas[at])
            g = draws[at]
            o = _view(out, ctypes.c_float, (r + 1) * ors)
            if mode == 0:
                o[r * ors + j] = g.numpy()
                continue
            S = torch.tensor(k22_tree_model(g.numpy(), T))
            if mode == 1:
                o[r * ors + j] = torch.log(g / S).numpy()
            else:
                o[r * ors] = (g[0] / S).numpy()


def _descs(rng, shapes, dtype=torch.int32):
    out = []
    for mode, rows, width, counts in shapes:
        base = torch.tensor(rng.gamma(1.0, size=width).astype(F32) + F32(0.05))
        if mode == "beta":
            base = torch.tensor([10.0, 50.0])
        cnt = torch.tensor(rng.integers(0, 40, (rows, width)),
                           dtype=dtype) if counts else None
        out.append(ops.gamma_desc(mode, base, rows, width, cnt))
    return out


@pytest.mark.parametrize("case", ["census", "wide", "many", "strided",
                                  "beside_wide", "cut"])
def test_k22_words_read_as_the_kernel_reads_them(case):
    rng = np.random.default_rng(7)
    seed = torch.tensor([987654321987], dtype=torch.int64)
    shapes = {
        "census": [("dirichlet_log", 1, 51, True), ("dirichlet_log", 1, 23,
                                                     True),
                   ("dirichlet_log", 1, 14, True), ("beta", 39, 2, True),
                   ("gamma", 2, 5, False), ("dirichlet_log", 1, 1, True)],
        "wide": [("gamma", 3, 700, False), ("dirichlet_log", 2, 1000, True),
                 ("dirichlet_log", 5, 1, False), ("beta", 1, 2, False)],
        "many": [("dirichlet_log", 2, 3, True)] * 70,
        "strided": [("dirichlet_log", 4, 6, True), ("beta", 5, 2, True)],
        # short rows and Beta pairs on the blocks of 256 of a wide row
        "beside_wide": [("dirichlet_log", 3, 51, True), ("gamma", 1, 40,
                                                         False),
                        ("beta", 4, 2, True), ("dirichlet_log", 2, 9, True),
                        ("dirichlet_log", 1, 300, True)],
        "cut": [("dirichlet_log", 1, 9, True),
                ("beta", ops.K22_MAX_ROWS + 5, 2, True)],
    }[case]
    descs = _descs(rng, shapes, torch.int64 if case == "wide" else
                   torch.int32)
    if case == "strided":   # counts through a transposed view
        for d in descs:
            d["counts"] = d["counts"].t().contiguous().t()
    outs = None
    if case == "census":   # two outputs the caller passes, in place
        outs = [None] * len(descs)
        outs[1] = torch.full((1, 23), 7.0)
        outs[3] = torch.full((39,), 7.0)
    want = ops.gamma_draw_plain(descs, seed)
    alphas = [ops._desc_alpha(d).reshape(-1) for d in descs]
    draws, e0 = [], 0   # each descriptor's draws as the plain version's
    for a in alphas:
        draws.append(ops.gamma_plain(a, torch.arange(e0, e0 + a.numel()),
                                     seed))
        e0 += a.numel()
    ent = ops._k22_entry(descs, outs)
    res, launches = ops._k22_fill(descs, seed, outs, ent)
    if case == "cut":
        assert len(launches) == 2
    for r in res:
        r.fill_(float("nan"))
    run_k22(launches, torch.cat(alphas), torch.cat(draws))
    for k, (g, w) in enumerate(zip(res, want)):
        assert torch.equal(g, w), k
        if outs is not None and outs[k] is not None:
            assert g is outs[k]


# -------------------------------------------------------------- K9


@pytest.mark.parametrize("P", [1, 2, 16, 32, 33, 1024, 16384])
def test_pg_resample_plan(P):
    for R in (1, 2, 3, 64, 4096):
        plan = ops.pg_resample_plan(R, P)
        if P <= ops.K9_GROUP_MAX:
            G = ops._pow2(P)
            assert plan["group"] == G and plan["smem"] == 0
            warps = plan["threads"] // 32
            assert 1 <= warps <= ops.K9_GROUP_WARPS
            rows = warps * (32 // G)   # a block's rows
            assert plan["grid"] * rows >= R > (plan["grid"] - 1) * rows
            assert warps == min(ops.K9_GROUP_WARPS, -(-R // (32 // G)))
        else:
            assert plan == dict(threads=min(256, 32 * -(-P // 32)),
                                smem=12 * P, grid=R, group=0)
    if P == 16:   # pg16: two rows a warp
        assert ops.pg_resample_plan(1, 16) == dict(threads=32, smem=0,
                                                   grid=1, group=16)
        assert ops.pg_resample_plan(64, 16) == dict(threads=256, smem=0,
                                                    grid=4, group=16)


def _butterfly(v, offsets, op):
    """Every lane's value after xor-shuffle levels at `offsets`."""
    lanes = np.arange(v.shape[-1])
    for o in offsets:
        v = op(v, v[..., lanes ^ o])
    return v


def _fmax(a, b):   # CUDA's fmaxf: the other operand where one is NaN
    return np.where(np.isnan(a), b, np.where(np.isnan(b), a,
                                             np.maximum(a, b))).astype(F32)


def k9_block_model(w, P):
    """The block path's m, s1, s2 and q of one row (one warp of 32 threads
    at P <= 32, a thread a particle, lanes past P empty): m by fmaxf from
    -inf, then pclean_block_max (the warp's butterfly, then warp 0's over
    the warps' maxima padded with -inf); s1, s2 by pclean_block_sum (the
    same with 0.0f)."""
    lanes = np.full(32, -np.inf, F32)
    lanes[:P] = _fmax(np.full(P, -np.inf, F32), w)
    m = _butterfly(lanes, (16, 8, 4, 2, 1), _fmax)
    second = np.full(32, -np.inf, F32)
    second[0] = m[0]
    m = _fmax(_butterfly(second, (16, 8, 4, 2, 1), _fmax)[0],
              F32(ops.NEG_INF))
    p = np.zeros(32, F32)
    p[:P] = np.exp((w - m).astype(F32)).astype(F32)
    out = [m]
    for v in (p, (p * p).astype(F32)):
        v = _butterfly(v, (16, 8, 4, 2, 1), _f32_add)
        second = np.zeros(32, F32)
        second[0] = v[0]
        out.append(_butterfly(second, (16, 8, 4, 2, 1), _f32_add)[0])
    return out, p[:P]


def k9_group_model(w, P):
    """The group path's m, s1, s2 of one row: a group of G = _pow2(P)
    lanes, butterflies over offsets G / 2, ..., 1 (every lane of the
    group ends with the same value, the one lane 0 returns)."""
    G = ops._pow2(P)
    offs = [G >> k for k in range(1, G.bit_length())]
    lanes = np.full(G, -np.inf, F32)
    lanes[:P] = _fmax(np.full(P, -np.inf, F32), w)
    m = _butterfly(lanes, offs, _fmax)
    assert (m == m[0]).all() or np.isnan(m).all()
    m = _fmax(m[0], F32(ops.NEG_INF))
    p = np.zeros(G, F32)
    p[:P] = np.exp((w - m).astype(F32)).astype(F32)
    out = [m]
    for v in (p, (p * p).astype(F32)):
        v = _butterfly(v, offs, _f32_add)
        assert (v.view(np.int32) == v.view(np.int32)[0]).all()
        out.append(v[0])
    return out, p[:P]


@pytest.mark.parametrize("P", [2, 16, 32, 1, 5, 31])
def test_k9_group_butterflies_are_the_block_sums(P):
    rng = np.random.default_rng(P)
    for row in range(400):
        sd = (0.05, 6.0, 40.0)[row % 3]
        w = (rng.normal(size=P) * sd - 30.0).astype(F32)
        if row % 5 == 0:   # NEG_INF particles, some rows all but one
            dead = rng.random(P) < (0.95 if row % 10 == 0 else 0.4)
            dead[rng.integers(P)] = False
            w[dead] = F32(ops.NEG_INF)
        if row % 37 == 0:
            w[:] = F32(ops.NEG_INF)
        (bm, bs1, bs2), bp = k9_block_model(w, P)
        (gm, gs1, gs2), gp = k9_group_model(w, P)
        for a, b in ((bm, gm), (bs1, gs1), (bs2, gs2)):
            assert np.asarray(a, F32).tobytes() == np.asarray(b, F32).tobytes()
        assert bp.tobytes() == gp.tobytes()


def _binary_pick(pre, P, ub):
    """pg_resample.cu's pick: the first i with pre[i] >= ub (P - 1 if
    none), 0 where ub <= 0."""
    if not ub > 0.0:
        return 0
    lo, hi = 0, P - 1
    while lo < hi:
        mid = (lo + hi) >> 1
        if float(pre[mid]) >= ub:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _count_pick(pre, P, ub):
    """The group path's pick: the prefix sums below ub, capped at P - 1,
    0 where ub <= 0."""
    if not ub > 0.0:
        return 0
    return min(P - 1, sum(1 for k in range(P) if float(pre[k]) < ub))


@pytest.mark.parametrize("P", [1, 2, 16, 32])
def test_k9_count_pick_is_the_binary_search(P):
    rng = np.random.default_rng(100 + P)
    for row in range(300):
        p = rng.random(P).astype(F32) ** 4
        p[rng.random(P) < 0.3] = 0.0   # zero-mass particles
        q = np.array([int(np.rint(np.float64(x) * 2.0 ** 32)) for x in p],
                     dtype=np.uint64)
        pre = np.cumsum(q).astype(np.uint64)
        tot = float(pre[-1])
        ubs = [float(np.float32(1.0) - np.float32(u)) * tot
               for u in rng.random(8).astype(F32)]
        ubs += [float(x) for x in pre] + [0.0, tot, tot * 2, -1.0,
                                          float("nan")]
        ubs += [np.nextafter(float(x), np.inf) for x in pre]
        for ub in ubs:
            assert _count_pick(pre, P, ub) == _binary_pick(pre, P, ub)


# ------------------------------------------- K9's and K22's latency chains

# instruction counts of the library functions (k23_sass's keys), made up
# so that each branch of the chains can be the longest
_SASS = dict(philox=40, logf=27, sqrt=10, cosf=30, expf=10, fdiv=11)


@pytest.mark.parametrize("kernel", ["k9", "k22"])
def test_latency_chains_take_the_longest_branch(kernel):
    """The chains count branches that run side by side once, by the
    longest of them, not their sum."""
    from pclean_tpu_torch import kernel_bench as kb

    s = dict(_SASS)
    if kernel == "k9":
        # P = 16: the max's 4 levels and exp, then max(s1's levels and
        # log, the scan and the pick, s2's levels and the ESS)
        lse, pick, ess = 8 + 27, 4 * kb.K9_SCAN_LEVEL + 4 + 2, 8 + 2 + 11
        want = 8 + 10 + max(lse, pick, ess) + kb.K9_GLUE
        assert kb.k9_chain(s, 16, "resample") == want
        assert kb.k9_chain(s, 16, "final") == want   # lse the longest
        s["fdiv"] = 100   # now the ESS branch is the longest
        assert kb.k9_chain(s, 16, "resample") == \
            8 + 10 + 8 + 2 + 100 + kb.K9_GLUE
        assert kb.k9_chain(s, 16, "final") == want
        return
    descs = [dict(mode="dirichlet_log", width=51, rows=1),
             dict(mode="beta", width=2, rows=39)]
    # a draw: Philox, max(log + sqrt, cos), the log of v
    draw = 40 + max(27 + 10, 30) + 27 + kb.K22_GLUE
    assert kb.k22_chain(s, descs[:1]) == draw + 2 * 6 + 11 + 27
    assert kb.k22_chain(s, descs[1:]) == draw + 2 * 1 + 11
    assert kb.k22_chain(s, descs) == draw + 2 * 6 + 11 + 27
    s["cosf"] = 60   # the cos branch now the longer
    assert kb.k22_chain(s, [dict(mode="gamma", width=5, rows=1)]) == \
        40 + 60 + 27 + kb.K22_GLUE
