"""The port's hand kernels: plain versions against their JAX
counterparts (CPU), and CUDA kernels against the plain versions (card only).

  K1 enum_logsumexp — pclean_tpu.utils.logsumexp over concat([exist, new])
     (propose.py score_fk / score_choice): rtol 1e-5, atol 1e-6, the
     score pass's tolerance (the same f32 formula summed in another order
     by two libraries; rtol 1e-6 failed once at 4.9e-6); the finite
     NEG_INF rules exactly.
  K2 inv_cdf_sample — pclean_tpu.engine.propose._inv_cdf_from_u fed the same
     uniforms: equal indices, dead (NEG_INF) entries never drawn.
  K3 obs_gather_sum — sum of AddTypos gathers M_c[obs_c, word_c], and the
     one-hot contraction of _matmul_obs_term/_mm_flush: rtol 1e-5.
  K4 gauss_suffstats and K5 gauss_ext_term — the rents path's Gaussian
     statistics and closed-form external; their plain versions are held to
     the JAX package in tests/test_torch_rents.py, and here on the card the
     kernels to the plain versions (kernel_bench.check_k4 / check_k5) at
     the rents shapes and the edges: all referrers dead, none at all, a
     group with no referrers, slots and groups out of range, C = 1, one
     slot taking 20,000 referrers, 65,536 slots, 300,000 referrers; K5
     from the env coordinates at one row, A = 1, 4,096 rows, C = 1, 5, 8
     and 17 (the generic loop), coordinates out of range on each axis,
     int64 coordinates and slots, three coordinates over a rank-4 output,
     the by-shape route's folded index, two launches bit-equal, and the
     inputs it refuses. On the CPU, K5's coordinate fold against the
     caller's old index build (bit-equal), the by-shape route and the
     plan's geometry.
  K7 referrer_hist and K8 sa_ext_term — the hospital path's referrer
     histograms and composed stateavg term: their plain versions against
     Python loops over the referrers (numpy) here, and on the card the
     kernels against the plain versions at the hospital path's shapes (K7
     hoisted over 100,000 Records through one and three hops, per row at
     one row; K8 at the County and Measure sweeps' 4,096 x 100,000), at
     scaled's un-hoisted Hospital sweep (K7 per row, 4,096 x 100,000, V =
     5,125) and the edges: R = 0 and 1, slots and values out of range,
     all-dead referrers, compacted lists against the dense form, a V wider
     than one tile, and 20,000 referrers on one row for K8; K7 also on its
     sparse route at scaled's and rents' hoisted shapes and one row of V =
     5,125, on rows of a length that is no multiple of 16 and on inputs
     that start at an odd offset.

  K9 pg_resample — particle Gibbs's resampling; its plain version is held
     to a numpy reference of pclean_tpu.engine.particles in
     tests/test_torch_pg.py, and here on the card the kernel to the plain
     version (kernel_bench.check_k9) in both modes, with and without the
     retained particle, at the written-out path's shapes and the edges:
     P = 2, 1,000 (no multiple of 32), 1,024 and 16,384 (dynamic shared
     memory past 48 KB), 4,096 rows, all-equal and NEG_INF weights.

The launch plans of K1-K9 (path or route, geometry, tile sizes and
splits, a function of the shapes alone) are checked here for legal
geometry on the H100, and K1's, K6's, K7's and K8's plans for the path,
route or split they give each shape the main path launches them at.
K6 is checked on the card on the route of each form (warp for lists,
block for the dense form) at the flights path's lists of 0 to 256
referrers, counts past the list, the dense form, V from 1 to 4,097,
shared and per-row p, 1,000 referrers in one slot and 64 rows; K8 at one
row of 100,000 with 0% to 100% kept, R = 100,001, masks at odd byte
addresses, pairs out of range, [1, R] beside [B, R], 4,096 rows, the
split counts the plan gives 1 to 396 rows, and two launches giving the
same bits.

The CUDA tests carry the `cuda` marker and skip where no card is present;
run them on the card with `python -m pytest -m cuda tests/test_torch_kernels.py`.
They cover every path of K1 (warp, block, split) and both paths of K2 and
K3 at the main path's shapes and at the edge shapes (one row, ragged
tiles, every 16-byte phase, all-dead rows, rows too long for shared
memory, more than 8 columns, threshold edges).
The JAX package is imported inside the CPU tests only, so the module also
loads where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.utils import NEG_INF


def _logits(rng, R, K, dead=0.3):
    x = rng.normal(0.0, 3.0, size=(R, K)).astype(np.float32)
    x[rng.random((R, K)) < dead] = NEG_INF
    x[0, :] = NEG_INF  # an all-dead row
    return x


def test_k1_plain_matches_jax_logsumexp():
    import jax.numpy as jnp
    from pclean_tpu.utils import logsumexp as jlogsumexp

    rng = np.random.default_rng(0)
    ex = _logits(rng, 64, 257)
    new = rng.normal(size=64).astype(np.float32)
    new[0] = NEG_INF
    rec, lz = ops.enum_logsumexp_plain(torch.as_tensor(ex),
                                       torch.as_tensor(new))
    cat = jnp.concatenate([jnp.asarray(ex), jnp.asarray(new)[:, None]], -1)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(cat))
    np.testing.assert_allclose(lz.numpy(), np.asarray(jlogsumexp(cat, -1)),
                               rtol=1e-5, atol=1e-6)
    rec2, lz2 = ops.enum_logsumexp_plain(torch.as_tensor(ex))
    assert rec2.data_ptr() == torch.as_tensor(ex).data_ptr() or \
        np.array_equal(rec2.numpy(), ex)
    np.testing.assert_allclose(lz2.numpy(),
                               np.asarray(jlogsumexp(jnp.asarray(ex), -1)),
                               rtol=1e-5, atol=1e-6)


def test_k2_plain_matches_jax_inv_cdf():
    import jax
    import jax.numpy as jnp
    from pclean_tpu.engine.propose import _inv_cdf_from_u

    rng = np.random.default_rng(1)
    lg = _logits(rng, 256, 130)
    lg[0, 5] = 0.0  # row 0: one live entry
    lg[:, 0] = NEG_INF  # a dead leading slot
    u = np.array(jax.random.uniform(jax.random.PRNGKey(3), (256,)))
    u[1] = 0.0  # the threshold edge: must not draw dead index 0
    got = ops.inv_cdf_sample_plain(torch.as_tensor(lg), torch.as_tensor(u))
    want = np.asarray(jax.vmap(_inv_cdf_from_u)(jnp.asarray(u),
                                                 jnp.asarray(lg)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 5 and (got != 0).all()
    assert (lg[np.arange(256), got.numpy()] > NEG_INF / 2).all()


def test_k3_plain_matches_jax_gather_and_onehot():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    Vs = [40, 17, 9]
    mats = [rng.normal(size=(v, v)).astype(np.float32) for v in Vs]
    B, K = 32, 50
    obs = np.stack([rng.integers(0, v, size=B) for v in Vs], 1).astype(np.int32)
    word = np.stack([rng.integers(0, v, size=K) for v in Vs]).astype(np.int32)
    got = ops.obs_gather_sum_plain([torch.as_tensor(m) for m in mats],
                                   torch.as_tensor(obs), torch.as_tensor(word))
    # the JAX eager gather path: one M[obs, word] term per column
    gather = sum(jnp.asarray(m)[jnp.asarray(obs[:, c])[:, None],
                                jnp.asarray(word[c])[None, :]]
                 for c, m in enumerate(mats))
    np.testing.assert_allclose(got.numpy(), np.asarray(gather), rtol=1e-5,
                               atol=1e-5)
    # the _mm_flush form: concat(onehot(obs)) @ concat(T_c[o, k])
    oh = jnp.concatenate([jax.nn.one_hot(obs[:, c], v) for c, v in
                          enumerate(Vs)], -1)
    T = jnp.concatenate([jnp.asarray(m)[:, word[c]] for c, m in
                         enumerate(mats)], 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oh @ T), rtol=1e-5,
                               atol=1e-4)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    ops.reset_counts()
    x = torch.zeros((2, 3))
    ops.enum_logsumexp(x, torch.zeros(2))
    ops.inv_cdf_sample(x, torch.zeros(2))
    ops.obs_gather_sum([torch.zeros((3, 3))], torch.zeros((2, 1), dtype=torch.int32),
                       torch.zeros((1, 3), dtype=torch.int32))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert all(v == {"r1": 0, "rn": 0} for v in ops.LAUNCHES_BY_SHAPE.values())
    assert not any(ops.LAUNCH_CENSUS.values())


def test_gauss_wrappers_take_plain_version_on_cpu_without_counting():
    ops.reset_counts()
    z = torch.ones(4)
    t = torch.tensor([0, 1, 1, 9], dtype=torch.int32)
    n, sz, szz, pre0 = ops.gauss_suffstats(t, torch.zeros(4, dtype=torch.int32),
                                           torch.ones(4, dtype=torch.bool), z,
                                           torch.zeros(4), 1.0, 2, 1)
    assert n[:, 0].tolist() == [1.0, 2.0] and pre0.tolist() == [1.0, 2.0]
    out = ops.gauss_ext_term(torch.ones(3), torch.zeros((2, 1),
                                                        dtype=torch.int32),
                             (torch.zeros((1, 2), dtype=torch.int32),), (2,),
                             torch.zeros(1, dtype=torch.int32), n, sz, szz,
                             pre0, -0.5)
    # -0.5 * (1 - 2 * 1 + 1) + 1 for slot 0's single referrer at z = mu = 1
    assert out.tolist() == [[1.0, 1.0]]
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("R,B,A", [(50_000, 256, 51), (1, 1, 1),
                                   (0, 1, 51), (2 ** 24, 4096, 51)])
def test_gauss_plans_cover_their_work(R, B, A):
    p4 = ops.gauss_suffstats_plan(R)
    assert p4["threads"] == 256 and p4["grid"] * 256 >= R >= (p4["grid"] - 1) * 256
    p5 = ops.gauss_ext_term_plan(B, A, 5)
    per = p5["threads"] // 32
    assert p5["chunks"] * 32 >= A > (p5["chunks"] - 1) * 32
    assert p5["grid"] * per >= B * p5["chunks"] > (p5["grid"] - 1) * per


def _parent_index(coords, env_shape, full):
    """The row index as the caller built it before K5 took the env
    coordinates (torch.zeros, then idx * n_i + clamp(e_i) for each axis)."""
    idx = torch.zeros(full, dtype=torch.long)
    for e, n in zip(coords, env_shape):
        idx = idx * n + e.long().clamp(0, n - 1)
    return idx


def _k5_case(dev, B, A, C, case, seed=12, cap=4096, keys=180):
    """K5 inputs of the rents County block's form: the state axis [1, A]
    int64 and a county key [B, 1] int32 (env_shape (A, keys)), int32
    slots, the statistics of 50,000 seeded referrers. `case` varies it:
    "out_of_range" (coordinates out of range on both axes, a slot and a
    table entry too), "int64" (int64 key and slots), "rank4" (three
    coordinates over an output [B, 3, A, 2] whose last axis no coordinate
    varies along), "index" (the by-shape route's one coordinate over the
    table's rows)."""
    rng = np.random.default_rng(seed)
    E, I = A * keys, A * keys * C
    k4 = _k4_inputs(dev, rng, 50_000, cap, C)
    n, sz, szz, pre0 = ops.gauss_suffstats_plain(**k4)
    values = torch.as_tensor(rng.normal(1500, 1000, I).astype(np.float32),
                             device=dev)
    tbl = torch.as_tensor(rng.integers(0, I, (E, C)).astype(np.int32),
                          device=dev)
    state = torch.arange(A, device=dev)[None, :]
    key = torch.as_tensor(rng.integers(0, keys, (B, 1)).astype(np.int32),
                          device=dev)
    slot = torch.as_tensor(rng.choice(cap, B, replace=B > cap)
                           .astype(np.int32), device=dev)
    coords, env_shape, full = (state, key), (A, keys), (B, A)
    if case == "out_of_range":   # gathers clamp like the JAX package's
        key[0, 0] = keys + 5
        key[-1, 0] = -3
        state = state.clone()
        state[0, -1] = A + 2
        state[0, 0] = -1
        coords = (state, key)
        slot[-1] = cap + 1
        tbl[0, 0] = -4
    elif case == "int64":
        coords, slot = (state, key.long()), slot.long()
    elif case == "rank4":
        third = torch.as_tensor(rng.integers(0, 3, (B, 3, 1, 1)),
                                device=dev)
        coords = (third, state[:, None, :, None], key[:, :, None, None])
        env_shape, full = (3, A, keys // 3), (B, 3, A, 2)
        key.clamp_(max=keys // 3 - 1)
        tbl = tbl[:3 * A * (keys // 3)].contiguous()
    elif case == "index":
        idx = _parent_index([c.cpu() for c in coords], env_shape, full)
        coords, env_shape = (idx.reshape(B, -1).to(dev, torch.int32),), (E,)
    return dict(values=values, tbl=tbl, coords=coords, env_shape=env_shape,
                slot=slot, n=n, sz=sz, szz=szz, pre0=pre0,
                coef=-0.5 / 150.0 ** 2, full=full,
                route="index" if case == "index" else "coords")


@pytest.mark.parametrize("case", ["rents", "out_of_range", "int64",
                                  "rank4"])
def test_k5_fold_matches_the_parent_index_build(case):
    """The key-table row of every output (gauss_key_rows, the sum the
    kernel computes) equals the caller's old torch.zeros / multiply / add
    build bit for bit, on coordinates out of range on each axis, broadcast
    axes, int32 and int64 coordinates and int64 slots; and the plain
    version on the coordinates equals it on that index as one coordinate
    over the table's rows, bit for bit."""
    B = 16
    k5 = _k5_case(torch.device("cpu"), B, 51, 5, case)
    rows = ops.gauss_key_rows(k5["coords"], k5["env_shape"], k5["full"])
    want = _parent_index(k5["coords"], k5["env_shape"], k5["full"])
    assert rows.dtype == torch.long and torch.equal(rows, want)
    if case == "out_of_range":
        assert int(rows.min()) >= 0
        assert int(rows.max()) < k5["tbl"].shape[0]
    got = ops.gauss_ext_term_plain(**k5)
    idx = dict(k5, coords=(want.reshape(B, -1).to(torch.int32),),
               env_shape=(k5["tbl"].shape[0],), full=None)
    assert torch.equal(got.reshape(B, -1), ops.gauss_ext_term_plain(**idx))
    assert tuple(got.shape) == tuple(k5["full"])
    # and the plain version is the closed form of the old formula
    s = k5["slot"].long().clamp(0, k5["n"].shape[0] - 1)
    mu = k5["values"][k5["tbl"][want].long().clamp(
        0, k5["values"].shape[0] - 1)]
    shape = (B,) + (1,) * (len(k5["full"]) - 1) + (-1,)
    ref = k5["coef"] * (k5["szz"][s].sum(-1).reshape(shape[:-1])
                        - 2 * (mu * k5["sz"][s].reshape(shape)).sum(-1)
                        + (mu * mu * k5["n"][s].reshape(shape)).sum(-1)) \
        + k5["pre0"][s].reshape(shape[:-1])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("axes,rank", [(5, 2), (6, 3), (2, 5)])
def test_k5_by_shape_route_folds_what_the_kernel_does_not_take(axes, rank):
    """More than K5_MAX_AXES env axes, or an output of rank above
    K5_MAX_RANK: gauss_ext_term_inputs folds the coordinates into one over
    the table's E rows and the output [B, A] (route "index"), and the
    plain version gives the same terms as on the coordinates themselves;
    within the kernel's reach the coordinates pass as given."""
    g = torch.Generator().manual_seed(axes * 10 + rank)
    B, C = 6, 3
    full = (B,) + (2,) * (rank - 1)
    env_shape = tuple(range(2, 2 + axes))
    E = int(np.prod(env_shape))
    coords = []
    for i, n in enumerate(env_shape):   # axis i varies along i % rank
        shape = [1] * rank
        shape[i % rank] = full[i % rank]
        coords.append(torch.randint(-1, n + 1, tuple(shape), generator=g,
                                    dtype=torch.int32 if i % 2 else
                                    torch.int64))
    k = ops.gauss_ext_term_inputs(coords, env_shape, full)
    assert k["route"] == "index" and len(k["coords"]) == 1
    assert k["env_shape"] == (E,) and k["full"] == (B, int(np.prod(full[1:])))
    assert torch.equal(k["coords"][0].reshape(full),
                       _parent_index(coords, env_shape, full))
    rest = dict(values=torch.randn(E * C, generator=g),
                tbl=torch.randint(0, E * C, (E, C), generator=g,
                                  dtype=torch.int32),
                slot=torch.arange(B), n=torch.rand((8, C), generator=g),
                sz=torch.randn((8, C), generator=g),
                szz=torch.rand((8, C), generator=g),
                pre0=torch.randn(8, generator=g), coef=-0.3)
    want = ops.gauss_ext_term_plain(coords=coords, env_shape=env_shape,
                                    full=full, **rest)
    got = ops.gauss_ext_term(**k, **rest)     # the CPU: plain version
    assert torch.equal(got.reshape(full), want)
    if rank <= ops.K5_MAX_RANK:
        within = ops.gauss_ext_term_inputs(coords[:4], env_shape[:4], full)
        assert within["route"] == "coords" and within["full"] == full
        assert all(a is b for a, b in zip(within["coords"], coords[:4]))


@pytest.mark.parametrize("C", [1, 5, 17])
@pytest.mark.parametrize("B,A", [(256, 51), (1, 51), (1, 1), (4096, 51)])
def test_k5_plan_geometry(B, A, C):
    """A warp a row and 32 options, ceil(A / 32) warps a row, whole warps
    in blocks of at most 256 threads that cover the launch's warps with
    less than a block over, C a template parameter up to 8; the rents
    County batch [256, 51] gives the card at least a block an SM."""
    p = ops.gauss_ext_term_plan(B, A, C)
    per = p["threads"] // 32
    assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 256
    assert p["chunks"] == -(-A // 32)
    warps = B * p["chunks"]
    assert p["grid"] * per >= warps > (p["grid"] - 1) * per
    assert p["fixed_c"] == (C if C <= 8 else 0)
    if (B, A) == (256, 51):
        assert p["grid"] >= ops.N_SMS
    if warps < ops._K5_WARPS:
        assert per == warps      # no idle warp in a one-row launch


def test_census_counts_launches_by_mode_rows_and_length():
    ops.reset_counts()
    try:
        for rows, K, mode in [(1, 11264, "fk"), (1, 138, "choice"),
                              (1, 138, "choice"), (4096, 138, "choice")]:
            ops._count("enum_logsumexp", rows, K, mode)
        ops._count("inv_cdf_sample", 1, 11265)
        ops._count("obs_gather_sum", 1, 11264, "5125,1832,138")
        ops._count("gauss_suffstats", 1)
        ops._count("sa_ext_term", 4096, 100_000, "14x78x1133")
        rows = ops.census()
        assert [(r["kernel"], r["mode"], r["rows"], r["K"], r["launches"])
                for r in rows] == [
            ("enum_logsumexp", "choice", "r1", 138, 2),
            ("enum_logsumexp", "fk", "r1", 11264, 1),
            ("enum_logsumexp", "choice", "rn", 138, 1),
            ("inv_cdf_sample", None, "r1", 11265, 1),
            ("obs_gather_sum", "5125,1832,138", "r1", 11264, 1),
            ("sa_ext_term", "14x78x1133", "rn", 100_000, 1)]
        assert rows[0]["share"] == 0.5 and rows[-1]["share"] == 1.0
        assert ops.LAUNCHES_BY_SHAPE["enum_logsumexp"] == {"r1": 3, "rn": 1}
    finally:
        ops.reset_counts()


MAIN_V = [5125, 1832, 138]  # the scaled workload's Record AddTypos columns
MAIN_K = 11264              # its Hospital capacity


@pytest.mark.parametrize("B,K,Vs,path", [
    (4096, MAIN_K, MAIN_V, "staged"),   # the batch shape
    (1, MAIN_K, MAIN_V, "direct"),      # the sequential loops' one row
    (4097, MAIN_K, MAIN_V, "staged"),   # B not a multiple of 4 (direct rows)
    (200, MAIN_K, MAIN_V, "staged"),    # few rows: K cut into tiles
    (66, MAIN_K, MAIN_V, "staged"),     # the fewest rows staged
    (65, MAIN_K, MAIN_V, "direct"),     # too few rows for staging to pay
    (4096, MAIN_K, [7300] * 8, "direct"),  # a staged row > 227 KB
    (4096, 16, [5125], "direct"),       # K too short for staging to pay
    (4096, 1001, [300, 120, 40], "staged"),  # K not a multiple of 4
    (4097, 1001, [300, 120, 40], "staged"),  # nor B of anything
])
def test_k3_plan_is_legal(B, K, Vs, path):
    plan = ops.obs_gather_plan(B, K, Vs)
    assert plan["path"] == path
    gx, gy = plan["grid"]
    assert plan["smem"] <= ops.SMEM_MAX == 232448
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535
    # the grid covers every row and candidate, with no block left empty
    if path == "staged":
        rows, cands, per_block = gx, gy, 1
        assert plan["kt"] % 4 == 0 and plan["smem"] == 4 * sum(Vs)
    else:
        rows, cands, per_block = gy, gx, 4
        assert (plan["kt"], plan["smem"]) == (256, 0)
    assert rows * per_block >= B > (rows - 1) * per_block
    assert cands * plan["kt"] >= K > (cands - 1) * plan["kt"]


def test_k3_plan_refuses_a_grid_out_of_range():
    # direct rows go on grid.y: at most 65,535 groups of 4 rows
    with pytest.raises(ValueError):
        ops.obs_gather_plan(4 * 65535 + 1, MAIN_K, [7300] * 8)


def test_k3_plan_main_shape():
    # one staged row of 28,380 B a block (four blocks an SM), one candidate
    # tile, one block a row
    plan = ops.obs_gather_plan(4096, MAIN_K, MAIN_V)
    assert plan == dict(path="staged", kt=MAIN_K, smem=28380,
                        grid=(4096, 1))


def test_k3_plan_cuts_the_candidate_axis_for_few_rows():
    plan = ops.obs_gather_plan(200, MAIN_K, MAIN_V)
    assert plan["grid"] == (200, 2) and plan["kt"] == 5632


def test_k3_plan_long_rows_take_one_row_a_block():
    # 80,000 B rows still stage (two blocks an SM); one float more than a
    # block holds does not
    plan = ops.obs_gather_plan(4096, MAIN_K, [20000])
    assert (plan["path"], plan["smem"]) == ("staged", 80000)
    assert ops.obs_gather_plan(4096, MAIN_K, [58112])["path"] == "staged"
    assert ops.obs_gather_plan(4096, MAIN_K, [58113])["path"] == "direct"


@pytest.mark.parametrize("K,path", [
    (MAIN_K + 1, "smem"),  # the batch and sequential shapes: [R, K+1]
    (1473, "smem"),        # County's axis, not a multiple of 4
    (57852, "smem"),       # the longest row that still fits
    (57853, "stream"),     # one entry more
    (70001, "stream"),     # longer than shared memory holds
])
def test_k2_plan_is_legal(K, path):
    plan = ops.inv_cdf_plan(K)
    assert plan["path"] == path
    assert plan["smem"] <= ops.SMEM_MAX - 1024  # static shared memory too
    if path == "smem":
        assert plan["tile"] == K and plan["smem"] == (K + 4) * 4
    else:
        assert plan["tile"] < K and plan["tile"] % 4 == 0
        assert plan["smem"] == (plan["tile"] + 4) * 4


def test_k2_plan_rejects_rows_past_exact_totals():
    with pytest.raises(ValueError):
        ops.inv_cdf_plan((1 << 21) + 1)


CENSUS_K1 = [  # (R, K, mode) of the main path's K1 launches
    (1, MAIN_K, "fk"), (1, 1472, "fk"), (1, 5125, "choice"),
    (1, 1832, "choice"), (1, 138, "choice"),
    (4096, MAIN_K, "fk"), (4096, 1472, "fk"), (4096, 5125, "choice"),
    (4096, 1832, "choice"), (4096, 138, "choice")]
K1_PATH = {  # the path the plan gives each of them (the fastest measured)
    (1, MAIN_K, "fk"): "split", (1, 1472, "fk"): "block",
    (1, 5125, "choice"): "block", (1, 1832, "choice"): "block",
    (1, 138, "choice"): "warp",
    (4096, MAIN_K, "fk"): "block", (4096, 1472, "fk"): "warp",
    (4096, 5125, "choice"): "block", (4096, 1832, "choice"): "warp",
    (4096, 138, "choice"): "warp"}


@pytest.mark.parametrize("R,K,mode", CENSUS_K1)
def test_k1_plan_routes_the_main_path_shapes(R, K, mode):
    assert ops.enum_logsumexp_plan(R, K, mode)["path"] == K1_PATH[(R, K, mode)]


@pytest.mark.parametrize("path", [None, "warp", "block", "split"])
@pytest.mark.parametrize("R,K", [(0, 138), (1, 1), (1, 3), (1, 138),
                                 (1, 1472), (1, 5125), (1, MAIN_K),
                                 (3, 70001), (9, 2000), (4096, 138),
                                 (4096, MAIN_K), (65535, 5)])
def test_k1_plan_is_legal(R, K, path):
    for mode in ("fk", "choice"):
        plan = ops.enum_logsumexp_plan(R, K, mode, path=path)
        assert plan["path"] in ops.K1_PATHS
        assert path is None or plan["path"] == path
        gx, gy = plan["grid"]
        assert 32 <= plan["threads"] <= 512 and plan["threads"] % 32 == 0
        assert 1 <= plan["cluster"] <= 8 and gx % plan["cluster"] == 0
        assert 0 <= gx < 2 ** 31 and 0 <= gy <= 65535
        # one row a warp, a block or a cluster; every row covered once
        if plan["path"] == "warp":
            assert plan["threads"] == 32 * plan["rows"] and gy == 1
            assert gx * plan["rows"] >= R > (gx - 1) * plan["rows"]
            assert plan["cluster"] == 1
        elif plan["path"] == "block":
            assert (plan["rows"], plan["cluster"], gx, gy) == (1, 1, R, 1)
        else:
            assert (plan["rows"], gx, gy) == (1, plan["cluster"], R)


def test_k1_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError):
        ops.enum_logsumexp_plan(65536, 2000, "fk", path="split")
    with pytest.raises(ValueError):
        ops.enum_logsumexp_plan(1, 2000, "sum")
    with pytest.raises(ValueError):
        ops.enum_logsumexp_plan(1, 2000, "fk", path="grid")
    with pytest.raises(ValueError):  # row-local indices are 32-bit
        ops.enum_logsumexp_plan(1, (1 << 30) + 1, "choice")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_cuda_matches_plain(card):
    rng = np.random.default_rng(5)
    ex = torch.as_tensor(_logits(rng, 300, 11265), device=card)
    new = torch.as_tensor(rng.normal(size=300).astype(np.float32), device=card)
    r0, z0 = ops.enum_logsumexp_plain(ex, new)
    r1, z1 = ops.enum_logsumexp(ex, new)
    torch.cuda.synchronize()
    assert torch.equal(r0, r1)
    torch.testing.assert_close(z1, z0, rtol=1e-6, atol=0)
    _r, z2 = ops.enum_logsumexp(ex)
    torch.testing.assert_close(z2, ops.enum_logsumexp_plain(ex)[1], rtol=1e-6,
                               atol=0)


def _k1_check(ex, new, path):
    from pclean_tpu_torch.kernel_bench import check_k1

    check_k1(ops, ex, new, path=path)
    check_k1(ops, ex, None, path=path)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "block", "split"])
@pytest.mark.parametrize("R,K", [
    (1, 1), (1, 3), (1, 138), (1, 1472), (1, 5125), (1, MAIN_K),  # one row
    (3, 70001),         # long rows
    (4096, 138),        # the batched choice shape
    (4096, MAIN_K),     # the batch shape
])
def test_k1_cuda_paths_match_plain(card, R, K, path):
    rng = np.random.default_rng(9)
    ex = torch.as_tensor(_logits(rng, R, K), device=card)
    if R == 1:
        ex[0] = torch.as_tensor(rng.normal(0, 3, K), dtype=torch.float32)
    new = torch.as_tensor(rng.normal(size=R).astype(np.float32), device=card)
    _k1_check(ex, new, path)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "block", "split"])
@pytest.mark.parametrize("K", [1001, 1473, 1474, 1475, 5])
def test_k1_cuda_every_phase(card, K, path):
    """Rows of K floats with K not a multiple of 4 start at every 16-byte
    phase, in exist and (stride K + 1) in the record; the exist tensor also
    starts at each 4-byte offset of a 16-byte boundary."""
    rng = np.random.default_rng(10)
    R = 8
    for off in range(4):
        flat = torch.empty(R * K + 4, device=card)
        ex = flat[off: off + R * K].view(R, K)
        ex.copy_(torch.as_tensor(_logits(rng, R, K, dead=0.1)))
        new = torch.as_tensor(rng.normal(size=R).astype(np.float32),
                              device=card)
        _k1_check(ex, new, path)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["warp", "block", "split"])
@pytest.mark.parametrize("K", [1, 138, 1472, MAIN_K])
def test_k1_cuda_dead_rows(card, K, path):
    """An all-NEG_INF row gives NEG_INF (never NaN), in both modes; a row
    live only in `new` gives new's value exactly."""
    ex = torch.full((3, K), NEG_INF, device=card)
    new = torch.tensor([NEG_INF, 0.37, -2.5], device=card)
    rec, z = ops.enum_logsumexp(ex, new, path=path)
    _r, zc = ops.enum_logsumexp(ex, path=path)
    torch.cuda.synchronize()
    assert torch.equal(rec, torch.cat([ex, new[:, None]], 1))
    assert z[0].item() == np.float32(NEG_INF)
    assert z[1].item() == np.float32(0.37) and z[2].item() == np.float32(-2.5)
    assert bool((zc == np.float32(NEG_INF)).all())
    _k1_check(ex, new, path)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_k2_plan_reads_rows_shorter_than_a_tile_whole(K):
    # the rents model's unit choice draws from 2 options; the entry takes
    # tiles of >= 4 floats and holds min(tile, K) of them
    plan = ops.inv_cdf_plan(K)
    assert (plan["path"], plan["tile"], plan["smem"]) == ("smem", 4,
                                                          (K + 4) * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [
    (256, 2),            # the rents unit choice, batched
    (1, 2),              # and at one row
    (4096, 1473),        # County's axis: K not a multiple of any tile
    (4096, MAIN_K + 1),  # the batch shape
    (1, MAIN_K + 1),     # the sequential shape
    (64, 70001),         # longer than shared memory holds: streamed
])
def test_k2_cuda_matches_plain(card, R, K):
    from pclean_tpu_torch.kernel_bench import check_k2

    rng = np.random.default_rng(6)
    lg = torch.as_tensor(_logits(rng, R, K), device=card)
    if R == 1:
        lg[0, : K // 2] = NEG_INF  # a live row for the one-row case
        lg[0, K // 2:] = torch.as_tensor(rng.normal(0, 3, K - K // 2),
                                         dtype=torch.float32)
    u = torch.as_tensor(rng.random(R).astype(np.float32), device=card)
    check_k2(ops, lg, u)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1473, MAIN_K + 1, 70001])
def test_k2_cuda_edges(card, K):
    """All mass on the last entry; one live slot among dead ones; the
    uniform's extremes 0 and 1 - 2^-24 on a row whose first and last
    entries are dead. Each pick is exact and never a zero-mass entry."""
    from pclean_tpu_torch.kernel_bench import check_k2

    rng = np.random.default_rng(8)
    n = 8
    lg = np.full((n, K), NEG_INF, dtype=np.float32)
    lg[0, -1] = 0.0                      # all mass on the last entry
    lg[1, K // 3] = 5.0                  # dead slots but one
    lg[2:, 1:-1] = rng.normal(0, 2, (n - 2, K - 2))  # dead first and last
    u = np.array([0.3, 0.7, 0.0, 1 - 2 ** -24, 0.0, 1 - 2 ** -24, 0.5, 0.5],
                 dtype=np.float32)
    lg_t = torch.as_tensor(lg, device=card)
    u_t = torch.as_tensor(u, device=card)
    check_k2(ops, lg_t, u_t)
    got = ops.inv_cdf_sample(lg_t, u_t).cpu().numpy()
    assert got[0] == K - 1 and got[1] == K // 3
    assert (got[2:] >= 1).all() and (got[2:] <= K - 2).all()
    # u = 0: the threshold is the total, so the last live entry
    assert got[2] == K - 2 and got[4] == K - 2
    # u = 1 - 2^-24: the threshold is 2^-24 of the total, so an early entry
    assert got[3] < K // 2 and got[5] < K // 2


def _k3_inputs(card, rng, B, K, Vs):
    mats = [torch.as_tensor(rng.normal(size=(v, v)).astype(np.float32),
                            device=card) for v in Vs]
    obs = torch.as_tensor(np.stack([rng.integers(0, v, B) for v in Vs], 1)
                          .astype(np.int32), device=card)
    word = torch.as_tensor(np.stack([rng.integers(0, v, K) for v in Vs])
                           .astype(np.int32), device=card)
    return mats, obs, word


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,Vs", [
    (1, MAIN_K, MAIN_V),         # the sequential shape: direct
    (4096, MAIN_K, MAIN_V),      # the batch shape: staged
    (4097, MAIN_K, MAIN_V),      # B not a multiple of the direct row group
    (200, MAIN_K, MAIN_V),       # candidate axis cut into tiles
    (66, MAIN_K, MAIN_V),        # the fewest rows staged
    (65, MAIN_K, MAIN_V),        # the most rows gathered directly
    (256, 1000, [7300] * 8),     # a row too long to stage: direct
    (4096, 1000, [138]),         # C = 1
    (4096, MAIN_K, [20000]),     # an 80,000 B staged row: raised limit
    (4096, 1001, [300, 120, 40]),  # K not a multiple of 4: scalar stores
    (4096, 1000, [90, 80, 70, 60, 50, 40, 30, 20, 10]),  # C = 9: two groups
    (5, 1000, [90, 80, 70, 60, 50, 40, 30, 20, 10]),     # the same, direct
    # C = 17: three groups, each adding into the output in column order
    (4096, 1000, list(range(10, 180, 10))),
    (5, 1000, list(range(10, 180, 10))),
])
def test_k3_cuda_bit_equal(card, B, K, Vs):
    from pclean_tpu_torch.kernel_bench import check_k3

    rng = np.random.default_rng(7)
    mats, obs, word = _k3_inputs(card, rng, B, K, Vs)
    obs[0, 0] = -3      # codes out of range clamp like the JAX gathers
    word[-1, 0] = Vs[-1] + 5
    check_k3(ops, mats, obs, word)


def _k4_inputs(card, rng, R, cap, C, dead=0.2):
    return dict(
        t=torch.as_tensor(rng.integers(0, cap, R).astype(np.int32),
                          device=card),
        rv=torch.as_tensor(rng.integers(0, C, R).astype(np.int32),
                           device=card),
        w=torch.as_tensor(rng.random(R) >= dead, device=card),
        z=torch.as_tensor(rng.normal(1500, 700, R).astype(np.float32),
                          device=card),
        ld=torch.as_tensor(np.where(rng.random(R) < 0.1, np.log(1000.0), 0.0)
                           .astype(np.float32), device=card),
        const=-5.9295738, cap=cap, C=C)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rents", "all_dead", "empty_group",
                                  "out_of_range", "C1", "crowded",
                                  "wide", "many", "R0"])
def test_k4_cuda_matches_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k4

    rng = np.random.default_rng(11)
    R, cap, C = 50_000, 4096, 5   # the rents path: Obs rows into County
    if case == "C1":
        C = 1
    elif case == "wide":     # 65,536 slots
        cap = 65_536
    elif case == "many":     # 300,000 referrers
        R = 300_000
    elif case == "R0":
        R = 0
    k4 = _k4_inputs(card, rng, R, cap, C)
    if case == "all_dead":
        k4["w"] = torch.zeros_like(k4["w"])
    elif case == "empty_group":
        k4["rv"] = torch.where(k4["rv"] == 2, torch.ones_like(k4["rv"]),
                               k4["rv"])
    elif case == "out_of_range":
        k4["t"][::7] = cap + 3
        k4["t"][1::11] = -1
        k4["rv"][2::5] = C
    elif case == "crowded":
        k4["t"][:20_000] = 17     # one slot takes 20,000 referrers
    check_k4(ops, k4)
    n, _sz, _szz, pre0 = ops.gauss_suffstats(**k4)
    if case in ("all_dead", "R0"):
        assert float(n.abs().sum()) == 0 and float(pre0.abs().sum()) == 0
    if case == "empty_group":
        assert float(n[:, 2].sum()) == 0
    if case == "crowded":
        assert int(n[17].sum()) == int(k4["w"][:20_000].sum()) + int(
            (k4["w"][20_000:] & (k4["t"][20_000:] == 17)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,C,case", [
    (256, 51, 5, "rents"),   # a County batch over the states
    (1, 51, 5, "rents"),     # one row
    (256, 51, 1, "rents"),   # C = 1
    (256, 51, 5, "out_of_range"),
    (256, 51, 17, "rents"),  # the generic loop
    (256, 1, 5, "rents"),    # A = 1
    (1, 1, 5, "rents"),
    (4096, 51, 5, "rents"),  # 4,096 rows
    (256, 51, 8, "int64"),   # the largest template C; int64 key and slots
    (64, 51, 5, "rank4"),    # three coordinates over [B, 3, A, 2]
    (256, 51, 5, "index"),   # the by-shape route's one coordinate
])
def test_k5_cuda_matches_plain(card, B, A, C, case):
    """K5 from the env coordinates against its plain version within
    check_k5's tolerance, two launches bit-equal (check_k5), one launch a
    call, counted in the census under its route, output and C."""
    from pclean_tpu_torch.kernel_bench import check_k5

    k5 = _k5_case(card, B, A, C, case)
    ops.reset_counts()
    check_k5(ops, k5)
    A_out = int(np.prod(k5["full"][1:]))
    assert ops.LAUNCHES["gauss_ext_term"] == 2
    assert ops.LAUNCH_CENSUS["gauss_ext_term"] == {
        (f"{k5['route']},{B}x{A_out}", "r1" if B == 1 else "rn", C): 2}


@pytest.mark.cuda
def test_k5_cuda_census_shape_bits_and_refusals(card):
    """At the rents census shape the kernel's output is bit-equal over
    launches and over the int32 and int64 forms of the same coordinates
    and slots (the fold reads both exactly); inputs it does not take raise
    on the card, with no launch: five coordinates, an output of rank 5,
    int16 coordinates, a coordinate that does not broadcast, and a table
    whose rows are not the product of the env axes."""
    k5 = _k5_case(card, 256, 51, 5, "rents")
    a = ops.gauss_ext_term(**k5)
    wide = dict(k5, coords=tuple(c.long() for c in k5["coords"]),
                slot=k5["slot"].long())
    torch.cuda.synchronize()
    assert torch.equal(a, ops.gauss_ext_term(**k5))
    assert torch.equal(a, ops.gauss_ext_term(**wide))
    state, key = k5["coords"]
    ops.reset_counts()
    bad = [dict(k5, coords=(state, key) * 2 + (key,),
                env_shape=k5["env_shape"] * 2 + (1,)),
           dict(k5, full=(256, 51, 1, 1, 1)),
           dict(k5, coords=(state, key.to(torch.int16))),
           dict(k5, coords=(state, key[:7])),
           dict(k5, env_shape=(51, 179))]
    for kw in bad:
        with pytest.raises(ValueError):
            ops.gauss_ext_term(**kw)
    assert ops.LAUNCHES["gauss_ext_term"] == 0


# ---------------------------------------------------------------- K6


def _k6_brute(k6):
    """out[b, a] by a Python loop over the referrers (float64), in either
    form: dense (t, alive, slot) or list (cnt)."""
    p = k6["p"].double()
    member, lens = k6["member"], k6["lens"]
    B, V = k6["lc"].shape[0], member.shape[1]
    out = np.zeros((B, V))
    for b in range(B):
        l = int(k6["lc"][b])
        pr = p[0 if p.shape[0] == 1 else b]
        if "cnt" in k6:
            n = min(int(k6["cnt"][b]), k6["obs"].shape[1])
            obs, st = k6["obs"][b].tolist(), k6["st"][b].tolist()
            refs = range(n)
        else:
            obs, st = k6["obs"].tolist(), k6["st"].tolist()
            refs = [r for r in range(len(obs)) if bool(k6["alive"][r])
                    and int(k6["t"][r]) == int(k6["slot"][b])]
        for r in refs:
            if st[r] == 1:
                same = float(torch.log1p(-pr[r]))
                diff = float(torch.log(pr[r])) - np.log(float(lens[l]))
                out[b] += np.where(np.arange(V) == obs[r], same, diff)
            elif st[r] == 2:
                out[b] += np.where(member[l].numpy(), 0.0, -1000.0)
    return out


@pytest.mark.parametrize("shared_p", [False, True])
def test_k6_plain_matches_brute_force(shared_p):
    from pclean_tpu_torch.kernel_bench import k6_inputs

    k6 = k6_inputs(torch.device("cpu"), B=5, V=9, N=300, L=6, seed=3,
                   missing=0.2, shared_p=shared_p)
    k6["lc"][1] = 0            # the empty list (lens clamps to 1)
    k6["slot"][2] = 99         # a slot no referrer points at
    got = ops.maybe_swap_ext_plain(**k6)
    np.testing.assert_allclose(got.numpy(), _k6_brute(k6), rtol=1e-5,
                               atol=1e-3)
    assert float(got[2].abs().sum()) == 0.0
    mag = ops.maybe_swap_ext_plain(**k6, absolute=True)
    assert bool((mag >= got.abs() - 1e-3).all())


@pytest.mark.parametrize("shared_p", [False, True])
def test_k6_plain_list_form_matches_brute_force(shared_p):
    from pclean_tpu_torch.kernel_bench import k6_inputs

    k6 = k6_inputs(torch.device("cpu"), B=4, V=7, N=40, L=5, seed=4,
                   missing=0.2, shared_p=shared_p, lists=True)
    k6["cnt"][0] = 0           # a slot with no referrers
    k6["cnt"][1] = 99          # a count past the list clamps to it
    got = ops.maybe_swap_ext_plain(**k6)
    np.testing.assert_allclose(got.numpy(), _k6_brute(k6), rtol=1e-5,
                               atol=1e-3)
    assert float(got[0].abs().sum()) == 0.0


def test_k6_wrapper_takes_plain_version_on_cpu_without_counting():
    from pclean_tpu_torch.kernel_bench import k6_inputs

    ops.reset_counts()
    k6 = k6_inputs(torch.device("cpu"), B=2, V=4, N=20, L=3)
    assert torch.equal(ops.maybe_swap_ext(**k6),
                       ops.maybe_swap_ext_plain(**k6))
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("B,V", [(1, 2), (1, 300), (1, 4096), (1, 4097),
                                 (64, 4096), (0, 27), (3, 100_000)])
def test_k6_plan_covers_its_options(B, V):
    """Each form's option groups cover V with no group left empty: the
    dense form 4,096 options a 512-thread block, the list form 64 a warp
    and min(8, ceil(V / 64)) warps a block."""
    for dense in (True, False):
        plan = ops.maybe_swap_ext_plan(B, V, dense)
        gx, gy = plan["grid"]
        assert gx == B and 1 <= gy <= 65535
        if dense:
            assert plan["threads"] == 512
            per = 4096
        else:
            warps = min(8, -(-V // 64))
            assert plan["threads"] == 32 * warps
            per = 64 * warps
        assert gy * per >= V > (gy - 1) * per


@pytest.mark.parametrize("B,V,dense,route", [
    (1, 241, False, "warp"),      # the flights path: a list of 256
    (1, 222, False, "warp"),
    (1, 241, True, "block"),      # the dense form over 2,376 rows
    (64, 4096, True, "block"),
    (64, 4096, False, "warp"),    # long lists stay on the warp route
    (1, 2, False, "warp"),        # one atom and the dummy
    (4096, 241, False, "warp"),   # many rows of short lists
    (1, 1, True, "block"),
    (1, 4097, True, "block"),     # more options than a block owns
    (1, 4097, False, "warp"),
])
def test_k6_plan_routes_by_form(B, V, dense, route):
    plan = ops.maybe_swap_ext_plan(B, V, dense)
    assert plan["route"] == route
    assert plan["threads"] == (512 if dense else 32 * min(8, -(-V // 64)))


def test_k6_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(1, 0)
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(-1, 10)
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(1, 4096 * 65536, True)
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(1, 512 * 65536)
    assert ops.maybe_swap_ext_plan(1, 4096 * 65535, True)["grid"] == \
        (1, 65535)


def test_k6_census_keys_by_form_axis_rows_and_options():
    ops.reset_counts()
    try:
        for rows, V, mode in [(1, 241, "list,256"), (1, 241, "list,256"),
                              (1, 222, "list,256"), (1, 241, "dense,2376")]:
            ops._count("maybe_swap_ext", rows, V, mode)
        got = [(r["mode"], r["rows"], r["K"], r["launches"])
               for r in ops.census() if r["kernel"] == "maybe_swap_ext"]
        assert got[0] == ("list,256", "r1", 241, 2)
        assert sorted(got[1:]) == [("dense,2376", "r1", 241, 1),
                                   ("list,256", "r1", 222, 1)]
    finally:
        ops.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "empty_slot", "all_missing", "V2",
                                  "gated", "shared_p", "big", "path_list",
                                  "gated_list", "big_list"])
def test_k6_cuda_matches_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k6, k6_inputs

    # one Flight slot against 2,376 Obs rows (dense form), or against its
    # list of up to 256 referrers (the flights path's referrer bound)
    B, V, Cs = 1, 300, 2376
    lists = case.endswith("_list")
    if lists:
        Cs = 256
    if case.startswith("big"):
        B, V, Cs = 64, 4096, 50_000
    elif case == "V2":
        V = 2                     # one atom and the dummy
    k6 = k6_inputs(card, B, V, Cs, seed=7, shared_p=case == "shared_p",
                   lists=lists)
    if lists:
        k6["cnt"][0] = Cs         # a full list
    if case == "empty_slot":
        k6["slot"][0] = 2 * B + 5
    elif case == "all_missing":
        k6["st"] = torch.full_like(k6["st"], 2)
    elif case.startswith("gated"):
        k6["p"] = torch.full_like(k6["p"], 1e-5)
    check_k6(ops, k6)
    out = ops.maybe_swap_ext(**k6)
    if case == "empty_slot":
        assert float(out[0].abs().sum()) == 0.0
    if case == "all_missing":
        lc = k6["lc"].long()
        n = (k6["alive"] & (k6["t"] == k6["slot"][0])).sum()
        want = torch.where(k6["member"][lc[0]], 0.0, -1000.0) * n
        torch.testing.assert_close(out[0], want.float(), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kept", [0, 1, 23, 31, 32, 33, 256])
def test_k6_cuda_short_lists(card, kept):
    """The flights path's form: one Flight slot against its list of 256,
    `kept` of them its referrers, V = 241 (the warp route's shape)."""
    from pclean_tpu_torch.kernel_bench import check_k6, k6_inputs

    k6 = k6_inputs(card, 1, 241, 256, seed=kept, lists=True)
    k6["cnt"].fill_(kept)
    assert ops.maybe_swap_ext_plan(1, 241)["route"] == "warp"
    check_k6(ops, k6)
    out = ops.maybe_swap_ext(**k6)
    if kept == 0:
        assert float(out.abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "cnt_past_N", "dense_2376", "V1", "V32", "V241", "V4096", "V4097",
    "p_shared", "p_rows", "crowded_list", "crowded_dense", "B64"])
def test_k6_cuda_routes_match_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k6, k6_inputs

    B, V, N, lists, shared_p, per_slot = 1, 241, 256, True, False, 0
    if case.startswith("V"):
        V = int(case[1:])
    elif case in ("dense_2376", "crowded_dense"):
        N, lists, per_slot = 2376, False, 24
    elif case == "p_shared":
        B, shared_p = 8, True
    elif case == "p_rows":
        B = 8
    elif case == "crowded_list":
        N = 1024
    elif case == "B64":
        B = 64
    elif case == "cnt_past_N":
        B = 4
    k6 = k6_inputs(card, B, V, N, seed=11, lists=lists, shared_p=shared_p,
                   per_slot=per_slot)
    if case == "cnt_past_N":
        k6["cnt"] = torch.tensor([N + 1, N + 300, 2 ** 30, N], device=card,
                                 dtype=torch.int32)
    elif case == "crowded_list":     # 1,000 referrers: four warp steps
        k6["cnt"].fill_(1000)
    elif case == "crowded_dense":    # one slot holding 1,000 of 2,376 rows
        k6["t"][:1000] = k6["slot"][0]
        k6["alive"][:1000] = True
    check_k6(ops, k6)
    out = ops.maybe_swap_ext(**k6)
    if case == "cnt_past_N":         # a count past the list reads it whole
        full = dict(k6, cnt=torch.full_like(k6["cnt"], N))
        assert torch.equal(out, ops.maybe_swap_ext(**full))


# ---------------------------------------------------------------- K7 / K8


def _k7_reference(k7):
    """K7 by a Python loop over the referrers (numpy): hoisted through the
    hop columns (later hops clamped), or per row."""
    V = k7["V"]
    val = k7["val"].numpy()
    w = k7["w"].numpy()
    if k7.get("hops") is not None:
        cap = k7["cap"]
        out = np.zeros((cap, V))
        hops = [h.numpy() for h in k7["hops"]]
        for r in range(len(val)):
            g = int(hops[0][r])
            for h in hops[1:]:
                g = int(h[min(max(g, 0), len(h) - 1)])
            if w[r] and 0 <= g < cap and 0 <= val[r] < V:
                out[g, val[r]] += 1
        return out
    B, R = w.shape
    out = np.zeros((B, V))
    for b in range(B):
        vrow = val[0 if val.shape[0] == 1 else b]
        for r in range(R):
            if w[b, r] and 0 <= vrow[r] < V:
                out[b, vrow[r]] += 1
    return out


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_k7_plain_hoisted_matches_reference(hops):
    from pclean_tpu_torch.kernel_bench import k7_seeded

    k7 = k7_seeded(torch.device("cpu"), G=12, V=9, R=400, per_row=False,
                   hops=hops, seed=hops)
    got = ops.referrer_hist_plain(**k7)
    assert got.shape == (12, 9) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _k7_reference(k7))
    assert 0 < float(got.sum()) < 400


@pytest.mark.parametrize("rows_val", [1, 6])
def test_k7_plain_per_row_matches_reference(rows_val):
    from pclean_tpu_torch.kernel_bench import k7_seeded

    k7 = k7_seeded(torch.device("cpu"), G=6, V=11, R=300, per_row=True,
                   rows_val=rows_val, seed=4)
    k7["w"][2] = False                 # a row with no referrers
    got = ops.referrer_hist_plain(**k7)
    np.testing.assert_array_equal(got.numpy(), _k7_reference(k7))
    assert float(got[2].abs().sum()) == 0.0 and float(got.sum()) > 0


def test_k8_plain_matches_reference():
    from pclean_tpu_torch.kernel_bench import k8_seeded

    k8 = k8_seeded(torch.device("cpu"), B=5, E=7, Vc=6, V=13, R=200,
                   rows_pairs=5, seed=3, density=0.3)
    k8["w"][1] = False
    SA = k8["SA"].double().numpy()
    rv, val, w = (k8[k].numpy() for k in ("rv", "val", "w"))
    want = np.zeros((5, 7))
    for b in range(5):
        for r in range(200):
            c, o = rv[b, r], val[b, r]
            if w[b, r] and 0 <= c < 6 and 0 <= o < 13:
                want[b] += SA[:, c, o]
    got = ops.sa_ext_term_plain(**k8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-2)
    assert float(got[1].abs().sum()) == 0.0
    mag = ops.sa_ext_term_plain(**dict(k8, SA=k8["SA"].abs()))
    assert bool((mag >= got.abs() - 1e-2).all())


def test_k8_plain_takes_pair_rows_of_different_lengths():
    """rv and val are each [1 or B, R]: a [1, R] side beside a [B, R] one
    broadcasts (the card's wrapper expands it the same way); any other
    shape raises on the CPU as on the card."""
    from pclean_tpu_torch.kernel_bench import k8_seeded

    k8 = k8_seeded(torch.device("cpu"), B=4, E=5, Vc=6, V=7, R=30,
                   rows_pairs=1, seed=2, density=0.5)
    want = ops.sa_ext_term_plain(**k8)
    for side in ("rv", "val"):
        wide = dict(k8, **{side: k8[side].expand(4, -1).clone()})
        assert torch.equal(ops.sa_ext_term_plain(**wide), want)
        assert torch.equal(ops.sa_ext_term(**wide), want)
    with pytest.raises(ValueError):
        ops.sa_ext_term_plain(**dict(k8, rv=k8["rv"][:, :10]))
    with pytest.raises(ValueError):
        ops.sa_ext_term(**dict(k8, val=k8["val"].expand(3, -1)))


def test_k7_k8_wrappers_take_plain_version_on_cpu_without_counting():
    from pclean_tpu_torch.kernel_bench import k7_seeded, k8_seeded

    ops.reset_counts()
    cpu = torch.device("cpu")
    for per_row in (False, True):
        k7 = k7_seeded(cpu, G=4, V=5, R=50, per_row=per_row)
        assert torch.equal(ops.referrer_hist(**k7),
                           ops.referrer_hist_plain(**k7))
    k8 = k8_seeded(cpu, B=3, E=4, Vc=3, V=5, R=40)
    assert torch.equal(ops.sa_ext_term(**k8), ops.sa_ext_term_plain(**k8))
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert not any(ops.LAUNCH_CENSUS.values())


@pytest.mark.parametrize("R,G,V,per_row", [
    (100_000, 512, 110, False),   # the hospital path's largest histogram
    (100_000, 128, 49, False),    # County, three hops
    (100_000, 4096, 5125, True),  # scaled's un-hoisted Hospital sweep
    (100_000, 1, 110, True),      # one row (the sequential replays)
    (256, 64, 300, True),         # a compacted list
    (0, 512, 110, False), (1, 1, 1, True), (5, 3, 70_000, True),
    (3_000_000, 11264, 2000, False),
    (100_000, 11264, 1832, False),  # scaled's hoisted Hospital histogram
    (50_000, 4096, 1766, False),    # rents' hoisted County histogram
    (100_000, 1, 5125, True),       # scaled's one-row Hospital sweep
    (100_000, 512, 111, False),     # hospital's largest, one tile
    (100_000, 4096, 111, True),     # hospital's batched per-row sweep
    (100_003, 2, 60_000, True),     # ragged rows, V over one tile
])
def test_k7_plan_covers_its_work(R, G, V, per_row):
    plan = ops.referrer_hist_plan(R, G, V, per_row)
    cells = V if per_row else G * V
    assert plan["threads"] == 256
    if plan["route"] == "private":
        assert 1 <= plan["tile"] and plan["smem"] == 4 * plan["tile"]
        assert plan["smem"] <= 48 * 1024   # the entry's limit
        assert plan["tiles"] * plan["tile"] >= cells > \
            (plan["tiles"] - 1) * plan["tile"]
    else:
        assert plan["tile"] == plan["smem"] == 0 and plan["tiles"] == 1
    assert plan["chunks"] * plan["per"] >= R
    assert R == 0 or (plan["chunks"] - 1) * plan["per"] < R
    assert 1 <= plan["chunks"] and plan["tiles"] <= 65535
    assert not per_row or plan["chunks"] <= 65535
    assert plan["grid"] == ((G, plan["chunks"], plan["tiles"]) if per_row
                            else (plan["chunks"], plan["tiles"]))
    if per_row and G >= 264:
        assert plan["chunks"] == 1   # the rows alone fill the card


@pytest.mark.parametrize("R,G,V,per_row,route", [
    (100_000, 11264, 1832, False, "sparse"),  # scaled hoisted: 20.6 M cells
    (50_000, 4096, 1766, False, "sparse"),    # rents hoisted: 7.2 M cells
    (100_000, 1, 5125, True, "sparse"),       # one row of V = 5,125
    (100_000, 1472, 138, False, "sparse"),    # scaled's County, 0.5 a cell
    (100_000, 512, 111, False, "sparse"),     # hospital's widest, 1.8
    (100_000, 4096, 5125, True, "sparse"),    # scaled's batched sweep
    # hospital's crowded histograms: 2 or more counts a cell
    (100_000, 512, 94, False, "private"),
    (100_000, 256, 75, False, "private"),
    (100_000, 128, 14, False, "private"),
    (100_000, 1, 111, True, "private"),       # one row of hospital's V
    (100_000, 1, 138, True, "private"),       # one row of scaled's County
    (100_000, 4, 5, False, "private"),        # 5,000 counts a cell
    (100_000, 300, 5, True, "private"),       # one chunk a row
])
def test_k7_plan_routes_by_counts_a_cell(R, G, V, per_row, route):
    plan = ops.referrer_hist_plan(R, G, V, per_row)
    assert plan["route"] == route
    assert (plan["load"] >= ops._K7_LOAD_MIN) == (route == "private")


@pytest.mark.parametrize("E,groups", [(1, 1), (8, 1), (9, 1), (14, 1),
                                      (78, 1), (128, 1), (129, 2), (300, 3)])
def test_k8_plan_gives_each_option_its_threads(E, groups):
    """Options go in groups of 128 a block (4 a lane of its warps), one
    group a grid index, at one row and at 4,096 rows."""
    for B in (1, 4096):
        plan = ops.sa_ext_term_plan(B, E, 100_000)
        assert plan["threads"] == 256 and plan["groups"] == groups
        assert plan["grid"] == (B, plan["splits"], groups)
        assert groups * 128 >= E > (groups - 1) * 128
    with pytest.raises(ValueError):
        ops.sa_ext_term_plan(1, 0, 100)


@pytest.mark.parametrize("B,E,R", [
    (1, 14, 100_000), (1, 78, 100_000), (4096, 14, 100_000),
    (4096, 78, 100_000), (1, 14, 100_001), (64, 14, 5000), (8, 14, 1),
    (8, 14, 0), (3, 300, 70_001), (1, 5, 511), (132, 20, 100_000),
    (65_536, 14, 256), (1, 1, 2 ** 24)])
def test_k8_plan_splits_the_referrer_axis(B, E, R):
    plan = ops.sa_ext_term_plan(B, E, R)
    S, per = plan["splits"], plan["per"]
    gx, gy, gz = plan["grid"]
    assert (gx, gy, gz) == (B, S, plan["groups"])
    assert 1 <= gy <= 65535 and 1 <= gz <= 65535
    assert per % 16 == 0 and per >= 16
    assert S * per >= R > (S - 1) * per or (R == 0 and S == 1)
    # splits only as far as needed to give the card three blocks an SM
    assert S == 1 or B * gz * (S - 1) < 3 * ops.N_SMS
    assert S == 1 or per >= ops._K8_MIN_PER - 15
    if S > 1:
        assert plan["scratch"] == B * S * E
        assert plan["merge_grid"] * 8 >= B * E > (plan["merge_grid"] - 1) * 8
    else:
        assert plan["scratch"] == 0 and plan["merge_grid"] == 0


@pytest.mark.parametrize("B,E,splits,per,scratch", [
    (1, 14, 391, 256, 391 * 14),     # County, one row (67 launches a run)
    (1, 78, 391, 256, 391 * 78),     # Measure, one row (6)
    (4096, 14, 1, 100_000, 0),       # County, batched (6)
    (4096, 78, 1, 100_000, 0),       # Measure, batched (1)
])
def test_k8_plan_hospital_census_shapes(B, E, splits, per, scratch):
    """The hospital path's four census shapes (R = 100,000 Records): one
    row fills the card with 391 blocks of 256 referrers and a merge
    launch; 4,096 rows take one block a row and write out directly."""
    plan = ops.sa_ext_term_plan(B, E, 100_000)
    assert (plan["splits"], plan["per"], plan["scratch"]) == \
        (splits, per, scratch)
    assert plan["grid"] == (B, splits, 1)


def test_k8_plan_stays_inside_the_grid():
    """However long the referrer axis, one row splits into at most three
    blocks an SM (longer splits, not more of them); options past the grid
    and empty shapes are refused."""
    for R in (10 ** 7, 2 ** 31 - 1):
        plan = ops.sa_ext_term_plan(1, 14, R)
        assert plan["splits"] <= 3 * ops.N_SMS and plan["per"] % 16 == 0
        assert plan["splits"] * plan["per"] >= R
    with pytest.raises(ValueError):
        ops.sa_ext_term_plan(1, 128 * 65536, 100)
    with pytest.raises(ValueError):
        ops.sa_ext_term_plan(1, 14, -1)


def _to_lists(w, val, R):
    """The dense form's referrers as per-row compacted lists of length R:
    (w [B, R], val [B, R]) with each row's referrers first, in order."""
    B = w.shape[0]
    wl = torch.zeros((B, R), dtype=torch.bool, device=w.device)
    vl = torch.zeros((B, R), dtype=val.dtype, device=w.device)
    for b in range(B):
        idx = torch.nonzero(w[b])[:, 0][:R]
        wl[b, :len(idx)] = True
        vl[b, :len(idx)] = val[0 if val.shape[0] == 1 else b, idx]
    return wl, vl


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "hospital", "hospital_3hops", "R0", "R1", "out_of_range", "all_dead",
    "rows_scaled", "rows_one", "rows_list", "rows_R0", "rows_wide_V",
    "list_vs_dense", "scaled_hoisted", "rents_hoisted", "rows_one_wide",
    "rows_ragged", "hoisted_unaligned", "hoisted_crowded", "rows_crowded"])
def test_k7_cuda_matches_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k7, k7_seeded

    if case.startswith("hospital"):
        k7 = k7_seeded(card, G=512, V=110, R=100_000, per_row=False,
                       hops=3 if case.endswith("3hops") else 1)
    elif case in ("R0", "R1"):
        k7 = k7_seeded(card, G=512, V=110, R=int(case[1]), per_row=False,
                       dead=0.0)
    elif case == "out_of_range":
        k7 = k7_seeded(card, G=64, V=20, R=50_000, per_row=False, hops=2)
        k7["hops"][0][::3] = -5
        k7["hops"][1][::5] = 10_000
        k7["val"][1::7] = 20
    elif case == "all_dead":
        k7 = k7_seeded(card, G=128, V=49, R=100_000, per_row=False, hops=3,
                       dead=1.0)
    elif case == "rows_scaled":
        k7 = k7_seeded(card, G=4096, V=5125, R=100_000, per_row=True,
                       density=12 / 100_000)
    elif case == "rows_one":
        k7 = k7_seeded(card, G=1, V=110, R=100_000, per_row=True,
                       density=0.02)
    elif case == "rows_list":
        k7 = k7_seeded(card, G=64, V=300, R=256, per_row=True, rows_val=64,
                       density=0.5)
    elif case == "rows_R0":
        k7 = k7_seeded(card, G=4, V=30, R=0, per_row=True)
    elif case == "rows_wide_V":   # V over one 12,288-cell tile
        k7 = k7_seeded(card, G=3, V=30_000, R=20_000, per_row=True,
                       density=0.5)
    elif case == "scaled_hoisted":   # the sparse route at scaled's shape
        k7 = k7_seeded(card, G=11264, V=1832, R=100_000, per_row=False)
    elif case == "rents_hoisted":
        k7 = k7_seeded(card, G=4096, V=1766, R=50_000, per_row=False)
    elif case == "rows_one_wide":    # the sparse route at one row
        k7 = k7_seeded(card, G=1, V=5125, R=100_000, per_row=True,
                       density=12 / 100_000)
    elif case == "rows_ragged":   # rows of 100,003 bytes: every 16-B phase
        k7 = k7_seeded(card, G=40, V=60_000, R=100_003, per_row=True,
                       density=0.01)
    elif case == "hoisted_crowded":   # the private route: 20 cells
        k7 = k7_seeded(card, G=4, V=5, R=100_000, per_row=False, hops=2)
    elif case == "rows_crowded":      # private, chunks adding into zeroes
        k7 = k7_seeded(card, G=1, V=5, R=100_000, per_row=True,
                       density=0.5)
    elif case == "hoisted_unaligned":   # w, val and hops from an odd offset
        k7 = k7_seeded(card, G=512, V=111, R=100_013, per_row=False, hops=2)
        k7 = dict(k7, val=k7["val"][13:], w=k7["w"][13:],
                  hops=[k7["hops"][0][13:]] + k7["hops"][1:])
    else:
        k7 = k7_seeded(card, G=32, V=200, R=50_000, per_row=True,
                       density=0.01)
        wl, vl = _to_lists(k7["w"], k7["val"], 1024)
        dense = ops.referrer_hist(**k7)
        lists = ops.referrer_hist(vl, wl, 200)
        torch.cuda.synchronize()
        assert torch.equal(dense, lists)
    check_k7(ops, k7)
    R, G = k7["w"].shape[-1], k7.get("cap") or k7["w"].shape[0]
    route = ops.referrer_hist_plan(R, G, k7["V"], "cap" not in k7)["route"]
    if case in ("scaled_hoisted", "rents_hoisted", "rows_one_wide",
                "hospital", "rows_scaled"):
        assert route == "sparse"
    if case in ("hoisted_crowded", "rows_crowded"):
        assert route == "private"
    out = ops.referrer_hist(**k7)
    if case == "all_dead" or case.endswith("R0"):
        assert float(out.abs().sum()) == 0.0
    if case == "R1":
        assert float(out.sum()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "county", "measure", "R0", "R1", "all_dead", "list", "list_vs_dense",
    "crowded", "one_row", "mixed_pair_rows"])
def test_k8_cuda_matches_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k8, k8_seeded

    # the hospital County sweep: 4,096 rows against 100,000 Records, SA
    # over 14 states x 78 codes x ~1,200 stateavg words; Measure: the roles
    # swapped
    if case == "county":
        k8 = k8_seeded(card, B=4096, E=14, Vc=78, V=1200, R=100_000,
                       density=1 / 128)
    elif case == "measure":
        k8 = k8_seeded(card, B=4096, E=78, Vc=14, V=1200, R=100_000,
                       density=1 / 128)
    elif case in ("R0", "R1"):
        k8 = k8_seeded(card, B=8, E=14, Vc=78, V=1200, R=int(case[1]),
                       density=1.0)
    elif case == "all_dead":
        k8 = k8_seeded(card, B=64, E=14, Vc=78, V=1200, R=100_000,
                       density=0.0)
    elif case == "list":
        k8 = k8_seeded(card, B=64, E=30, Vc=20, V=500, R=256, rows_pairs=64,
                       density=0.6)
    elif case == "crowded":   # 20,000 referrers on one row
        k8 = k8_seeded(card, B=4, E=14, Vc=78, V=1200, R=100_000,
                       density=0.0)
        k8["w"][1, :40_000:2] = True
    elif case == "one_row":
        k8 = k8_seeded(card, B=1, E=78, Vc=14, V=1200, R=100_000,
                       density=0.03)
    elif case == "mixed_pair_rows":   # rv [B, R] beside val [1, R]
        k8 = k8_seeded(card, B=64, E=14, Vc=78, V=1200, R=5000,
                       density=0.1)
        k8["rv"] = k8["rv"].expand(64, -1).clone()
    else:
        k8 = k8_seeded(card, B=16, E=14, Vc=78, V=1200, R=50_000,
                       density=0.02)
        _, rv_l = _to_lists(k8["w"], k8["rv"], 2048)
        wl, val_l = _to_lists(k8["w"], k8["val"], 2048)
        dense = ops.sa_ext_term(**k8)
        lists = dict(SA=k8["SA"], rv=rv_l, val=val_l, w=wl)
        mag = ops.sa_ext_term_plain(**dict(k8, SA=k8["SA"].abs()))
        torch.cuda.synchronize()
        torch.testing.assert_close(ops.sa_ext_term(**lists), dense,
                                   rtol=0, atol=float(1e-5 * mag.max()))
        check_k8(ops, lists)
    check_k8(ops, k8)
    out = ops.sa_ext_term(**k8)
    if case in ("all_dead", "R0"):
        assert float(out.abs().sum()) == 0.0
    if case == "crowded":
        assert float(out[0].abs().sum()) == 0.0
        assert float(out[1].abs().min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kept", [0.0, 0.026, 0.112, 1.0])
def test_k8_cuda_one_row(card, kept):
    """One row of 100,000 Records at the hospital path's County shape with
    0%, 2.6% (Measure's share), 11% (County's) and every Record kept: the
    split over 391 blocks and the merge launch; two launches give the same
    bits."""
    from pclean_tpu_torch.kernel_bench import check_k8, k8_seeded

    k8 = k8_seeded(card, B=1, E=14, Vc=78, V=1133, R=100_000,
                   density=kept)
    assert ops.sa_ext_term_plan(1, 14, 100_000)["splits"] == 391
    check_k8(ops, k8)
    a, b = ops.sa_ext_term(**k8), ops.sa_ext_term(**k8)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if kept == 0.0:
        assert float(a.abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "R100001", "odd_offset", "odd_offset_rows", "out_of_range",
    "pairs_1_beside_B", "B4096", "deterministic", "splits", "E32", "E33",
    "E300"])
def test_k8_cuda_split_edges(card, case):
    from pclean_tpu_torch.kernel_bench import check_k8, k8_seeded

    if case == "R100001":     # the last split ends inside a 16-byte word
        k8 = k8_seeded(card, B=3, E=14, Vc=78, V=1133, R=100_001,
                       density=0.05)
        k8["w"][:, -1] = True
    elif case.startswith("odd_offset"):   # w at an odd byte address
        B, R, lead = (1, 100_000, 13) if case == "odd_offset" else \
            (5, 100_003, 7)
        k8 = k8_seeded(card, B=B, E=14, Vc=78, V=1133, R=R, density=0.05)
        flat = torch.zeros((lead + B * R,), dtype=torch.bool, device=card)
        flat[lead:] = k8["w"].reshape(-1)
        flat[:lead] = True                 # bytes before the mask: not read
        k8["w"] = flat[lead:].view(B, R)
        assert k8["w"].data_ptr() % 2 == 1 and k8["w"].is_contiguous()
    elif case == "out_of_range":   # pairs out of range are dropped
        k8 = k8_seeded(card, B=4, E=14, Vc=78, V=1133, R=20_000,
                       rows_pairs=4, density=0.2)
        k8["rv"][1] = 78
        k8["val"][2] = -1
        k8["rv"][3, ::2] = -7
    elif case == "pairs_1_beside_B":   # rv [1, R] beside val [B, R]
        k8 = k8_seeded(card, B=64, E=78, Vc=14, V=1133, R=20_000,
                       density=0.05)
        val_b = k8["val"].expand(64, -1).clone()
        both = ops.sa_ext_term(**dict(k8, val=val_b))
        torch.cuda.synchronize()
        assert torch.equal(both, ops.sa_ext_term(**k8))
        k8["val"] = val_b
    elif case == "B4096":
        k8 = k8_seeded(card, B=4096, E=78, Vc=14, V=1133, R=100_000,
                       density=1 / 40)
        assert ops.sa_ext_term_plan(4096, 78, 100_000)["splits"] == 1
    elif case == "deterministic":   # 64 rows split 5 ways, then merged
        k8 = k8_seeded(card, B=64, E=14, Vc=78, V=1133, R=100_000,
                       density=0.1)
        runs = [ops.sa_ext_term(**k8) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
    elif case.startswith("E"):   # one option a lane, or more; option groups
        k8 = k8_seeded(card, B=3, E=int(case[1:]), Vc=14, V=1133, R=20_000,
                       density=0.1)
    else:   # split counts the plan gives: 391, 196, 7, 3 and 1
        for B, S in ((1, 391), (2, 196), (64, 7), (132, 3), (396, 1)):
            k8 = k8_seeded(card, B=B, E=14, Vc=78, V=1133, R=100_000,
                           density=0.112)
            assert ops.sa_ext_term_plan(B, 14, 100_000)["splits"] == S
            check_k8(ops, k8)
        k8 = k8_seeded(card, B=2, E=14, Vc=78, V=1133, R=100_000,
                       density=0.112)
        k8["w"][1, 50_000:] = False     # splits with nothing kept
    check_k8(ops, k8)
    out = ops.sa_ext_term(**k8)
    if case == "out_of_range":
        assert float(out[1:3].abs().sum()) == 0.0
        assert float(out[0].abs().min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("R,P", [(1, 2), (64, 16), (1, 16), (1, 1024),
                                 (4096, 2), (3, 1000), (2, 16384), (2, 16),
                                 (3, 16), (64, 32), (5, 33)])
def test_k9_cuda_matches_plain(card, R, P):
    from pclean_tpu_torch.kernel_bench import check_k9, k9_inputs

    for retained in (False, True):
        for mode in ops.K9_MODES:
            check_k9(ops, k9_inputs(card, R, P, mode, retained))


@pytest.mark.cuda
@pytest.mark.parametrize("R,P", [(1, 16), (64, 16), (2, 16), (3, 16),
                                 (64, 32), (7, 1), (9, 5), (4096, 2),
                                 (33, 31)])
def test_k9_cuda_group_path_bit_equal_to_block_path(card, R, P):
    """The group path (the plan's at P <= 32) against the block path on
    the same inputs, the block's words set by hand
    (kernel_bench.k9_launch): sel (or j), ws_out and lml bit-equal, in
    both modes, with and without the retained particle, NEG_INF weights
    among them; and a group of 32 lanes at P = 16 likewise."""
    from pclean_tpu_torch.kernel_bench import k9_inputs, k9_launch

    block = dict(threads=32 * -(-P // 32), smem=12 * P, group=0)
    for retained in (False, True):
        for mode in ops.K9_MODES:
            k9 = k9_inputs(card, R, P, mode, retained, seed=R + P)
            k9["ws"][::3, ::2] = NEG_INF
            plan = ops.pg_resample_plan(R, P)
            assert plan["group"] == ops._pow2(P)
            runs = [k9_launch(ops, k9, plan), k9_launch(ops, k9, block)]
            if P == 16:
                runs.append(k9_launch(ops, k9, dict(plan, group=32)))
            want = ops.pg_resample(k9["ws"], k9["u"], mode, retained)
            torch.cuda.synchronize()
            for got in runs:
                for x, y in zip(got, runs[1]):
                    assert (x is None and y is None) or torch.equal(x, y)
            for x, y in zip(want, [t for t in runs[1] if t is not None]):
                assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["equal", "neg_inf"])
def test_k9_cuda_edges(card, case):
    """All-equal weights (ESS = P: no row resamples) and rows whose
    particles but one are NEG_INF (ESS = 1: every row with P > 2
    resamples, and every draw lands on the one live particle)."""
    from pclean_tpu_torch.kernel_bench import check_k9

    R, P = 8, 64
    ws = torch.full((R, P), -3.0, device=card)
    if case == "neg_inf":
        ws.fill_(-1e30)
        ws[torch.arange(R), torch.arange(R) * 7] = -5.0
    u = torch.rand((R, P), device=card)
    for retained in (False, True):
        check_k9(ops, dict(ws=ws, u=u, mode="resample", retained=retained))
        sel, ws_out, lml = ops.pg_resample(ws, u, "resample", retained)
        torch.cuda.synchronize()
        if case == "equal":
            assert torch.equal(ws_out, ws)
            assert float(lml.abs().max()) == 0.0
        else:
            live = torch.arange(R, device=card) * (P + 7)
            keep = sel if not retained else sel[:, 1:]
            assert bool((keep == live[:, None]).all())
    check_k9(ops, dict(ws=ws, u=u[:, 0].contiguous(), mode="final",
                       retained=False))


# ---------------------------------------------------------------- K10, K11


def _chain_model(device):
    """tests/test_torch_host.py's chain model (Record -> Hospital -> County,
    the state observed two hops down) through the port alone: the one
    model whose latent sweep has hop entries to move."""
    import pclean_tpu_torch.dists as d
    from pclean_tpu_torch.engine.compile import compile_model
    from pclean_tpu_torch.model.builder import ModelBuilder
    from pclean_tpu_torch.model.query import ObservedDataset, Query

    states = ["al", "ak", "az"]
    names = ["memorial hospital", "st vincent", "county general", "mercy"]
    b = ModelBuilder()
    with b.cls("County") as c:
        c.learned("props", d.Proportions())
        c.choice("state", d.ChooseProportionally(states, d.ParamRef("props")))
    with b.cls("Hospital") as c:
        c.fk("loc", "County")
        c.choice("name", d.StringPrior(3, 30, names))
    with b.cls("Record") as c:
        c.fk("hosp", "Hospital")
        c.choice("name_obs", d.AddTypos(d.Ref("hosp.name")))
    model = b.finish()
    q = Query.build(model, "Record", [("name", "hosp.name", "name_obs"),
                                      ("state", "hosp.loc.state")])
    ds = ObservedDataset(q, {"name": [names[i % 4] for i in range(24)],
                             "state": [states[i % 3] for i in range(24)]})
    return compile_model(model, [ds], capacities={"County": 12,
                                                  "Hospital": 12},
                         device=device)


def _row_model(which, dev):
    """(engine, seeded arenas, params) of a model for K10 and K11 on the
    card: the hospital workload (240 rows), the flights workload (300
    rows) or the chain model."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine, InferenceConfig
    from pclean_tpu_torch.kernel_bench import row_state
    from pclean_tpu_torch.workloads import flights, hospital

    if which == "hospital":
        cm, cfg = hospital.setup(rows=240, batch=16, device=dev)[:2]
    elif which == "flights":
        cm, cfg = flights.setup(rows=300, flights=12, websites=8,
                                capacities={"Flight": 16,
                                            "TrackingWebsite": 16},
                                device=dev)[:2]
    else:
        cm, cfg = _chain_model(dev), InferenceConfig()
    _a, params = init_state(cm, 0, device=dev)
    return Engine(cm, cfg, device=dev), row_state(cm, 7, device=dev), params


def _kinds(cm):
    out = []
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        out += ([(cid, "init"), (cid, "obs")] if lay.observed else
                [(cid, "latent" if lay.fk_vertices else "leaf")])
    return out


_K11_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
               torch.int32, torch.int64, torch.float32, torch.float64)


def _k11_edges(eng, arenas, card, seed: int = 0) -> int:
    """K11 on a copy of each class's carry (with fks), the plain version
    on a CPU copy, bit-equal, over rows of mixed dtypes: the row's every
    stored value and two births a fk, both of one class at one slot
    (-1 to the capacity, int32 or int64, is_new drawn), so a row writes
    more columns than a warp has lanes; sources of every dtype into int32
    and float32 columns, the alive bit marked on every third row, under
    torch.cuda.set_sync_debug_mode("error"). Returns the most writes a
    row made."""
    from pclean_tpu_torch.engine.propose import Birth
    from pclean_tpu_torch.engine.smc import own_carry
    from pclean_tpu_torch.kernel_bench import _leaves, _tree_map

    cm = eng.cm
    rng = np.random.default_rng(seed)
    cpu = lambda t: t.cpu()  # noqa: E731

    def val(hi):
        dt = _K11_DTYPES[int(rng.integers(len(_K11_DTYPES)))]
        x = torch.tensor([int(rng.integers(0, hi))])
        return (x * 1.37 if dt.is_floating_point else x).to(dt)

    most = 0
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        if not lay.fk_vertices:
            continue
        a, _r = own_carry(cm, cid, arenas)
        ac = _tree_map(a, cpu)
        car, car_c = ops.RowCarry(cm, cid, a), ops.RowCarry(cm, cid, ac)
        cap = lay.capacity
        rows = []
        for r in range(12):
            env2 = {v: val(6) for v in lay.store}
            births = []
            for fkv in lay.fk_vertices:
                tc = cm.node(cid, fkv).target_class
                tcap = cm.layouts[tc].capacity
                bs = int(rng.integers(-1, tcap + 1))
                sdt = torch.int32 if rng.random() < 0.5 else torch.int64
                births += [Birth(fkv, tc, torch.tensor([rng.random() < 0.7]),
                                 torch.tensor([bs], dtype=sdt),
                                 {tv: val(4) for tv in cm.layouts[tc].store})
                           for _ in range(2)]
            slot = [int(rng.integers(0, cap)), -1, cap, cap - 1][r % 4]
            rows.append((torch.tensor([slot]), env2, births,
                         torch.tensor([rng.random() < 0.8]), r % 3 == 0))
        for s, env2, births, acc, ma in rows:
            most = max(most, len(ops.row_write_writes(car_c, s, env2, births,
                                                      acc, ma)))
        dev = [(s.to(card), _tree_map(env2, lambda t: t.to(card)),
                [Birth(b.fk_vid, b.target_class, b.is_new.to(card),
                       b.slot.to(card), _tree_map(b.values,
                                                  lambda t: t.to(card)))
                 for b in births], acc.to(card), ma)
               for s, env2, births, acc, ma in rows]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s, env2, births, acc, ma in dev:
                ops.row_write(car, s, env2, births, acc, ma)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for s, env2, births, acc, ma in rows:
            ops.row_write(car_c, s, env2, births, acc, ma)
        for name, x, y in _leaves(a, ac, "arenas"):
            assert torch.equal(x.cpu(), y), f"{cid}: {name}"
    return most


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["hospital", "flights", "chain"])
def test_k10_k11_cuda_match_plain(card, which):
    """K10 and K11 on a copy of each class's carry, the plain versions on
    a CPU copy (kernel_bench.shadow_rows: 64 rows of every kind, live and
    dead slots, fks out of range, births at slot -1), bit-equal; then
    K11's edges (_k11_edges: two births of one class at one slot, mixed
    dtypes, hospital's rows past a warp's lanes)."""
    from pclean_tpu_torch.kernel_bench import shadow_rows

    eng, arenas, params = _row_model(which, card)
    for cid, kind in _kinds(eng.cm):
        r = shadow_rows(ops, eng, arenas, params, cid, kind, n=64, seed=3)
        assert r["launches"] > 0 and r["mismatches"] == [], r
    if which == "chain":
        h = shadow_rows(ops, eng, arenas, params, "Hospital", "latent", n=64)
        assert h["hop_entries"] > 0 and h["mismatches"] == [], h
    most = _k11_edges(eng, arenas, card, seed=4)
    assert which != "hospital" or most > 32


@pytest.mark.cuda
def test_k10_cuda_every_tier_and_mode(card):
    """K10 against its plain version on the limits model's seeded state (a
    fifth of its fk values out of range): every class with fks in obs,
    latent and hop mode, the plans in both parameter blocks (S and C1-C8
    in tier 0, C0 and Record in 1), S and T reached by many paths of one
    tree (kernel_bench.shadow_rows, every leaf bit-equal)."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.kernel_bench import row_state, shadow_rows
    from pclean_tpu_torch.workloads import limits

    cm, cfg = limits.setup(rows=64, batch=8, device=card)[:2]
    _a, params = init_state(cm, 0, device=card)
    eng = Engine(cm, cfg, device=card)
    arenas = row_state(cm, 9, oob=0.2, device=card)
    tiers = set()
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        if not lay.fk_vertices:
            continue
        mode = "obs" if lay.observed else "latent"
        for kind in (["init", "obs"] if lay.observed else ["latent"]):
            r = shadow_rows(ops, eng, arenas, params, cid, kind, n=48,
                            seed=5)
            assert r["launches"] > 0 and r["mismatches"] == [], r
        for hop in ((False,) if lay.observed else (False, True)):
            tiers.add(ops.row_delta_plan(cm, cid, mode, hop)["tier"])
    assert tiers == {0, 1}


@pytest.mark.cuda
def test_k10_k11_cuda_edges_and_no_host_sync(card):
    """Slots -1, the capacity and past it, a birth at -1 and at its class's
    capacity, on the chain model (hop entries) and the flights model
    (propagated chains), every K10 mode and K11, under
    torch.cuda.set_sync_debug_mode("error"): bit-equal to the plain
    versions on a CPU copy, and no call waits for the card; then K11's
    edges on the hospital model (_k11_edges), rows past a warp's lanes."""
    from pclean_tpu_torch.engine.propose import Birth
    from pclean_tpu_torch.engine.refresh import hop_histograms, refresh
    from pclean_tpu_torch.engine.smc import own_carry
    from pclean_tpu_torch.kernel_bench import _leaves, _tree_map

    for which in ("chain", "flights"):
        eng, arenas, _p = _row_model(which, card)
        cm = eng.cm
        for cid in cm.model.class_order:
            lay = cm.layouts[cid]
            if not lay.fk_vertices:
                continue
            mode = "obs" if lay.observed else "latent"
            rel = refresh(cm, arenas, eng.obs_dev)
            hops = [] if lay.observed else \
                hop_histograms(cm, cid, arenas, eng.obs_dev)
            a, r = own_carry(cm, cid, arenas, rel)
            cpu = lambda t: t.cpu()  # noqa: E731
            car = ops.RowCarry(cm, cid, a, r, eng.obs_dev, hops)
            ac, rc_ = _tree_map(a, cpu), _tree_map(r, cpu)
            car_c = ops.RowCarry(cm, cid, ac, rc_,
                                 _tree_map(eng.obs_dev, cpu),
                                 _tree_map(hops, cpu))
            fk = torch.zeros((len(lay.fk_vertices),), dtype=torch.int64,
                             device=card)
            fkc = fk.cpu()
            cap = lay.capacity
            fkv = lay.fk_vertices[0]
            tc = cm.node(cid, fkv).target_class
            tcap = cm.layouts[tc].capacity
            tv = next(iter(cm.layouts[tc].store))
            slots = [torch.tensor([s], device=card)
                     for s in (-1, 0, cap - 1, cap, cap + 5)]
            births = [Birth(fkv, tc, torch.tensor([True], device=card),
                            torch.tensor([bs], device=card),
                            {tv: torch.tensor([1], device=card)})
                      for bs in (-1, tcap, tcap - 1)]
            env2 = {fkv: torch.tensor([tcap - 1], device=card)}
            acc = torch.tensor([True], device=card)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for s in slots:
                    ops.row_delta(car, s, -1, mode,
                                  save_fk=fk if mode == "latent" else None)
                    ops.row_write(car, s, env2, births, acc)
                    ops.row_delta(car, s, +1, mode, old_fk=fk)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for s in slots:
                sc = s.cpu()
                ops.row_delta(car_c, sc, -1, mode,
                              save_fk=fkc if mode == "latent" else None)
                ops.row_write(car_c, sc, _tree_map(env2, cpu),
                              [Birth(b.fk_vid, b.target_class, b.is_new.cpu(),
                                     b.slot.cpu(), _tree_map(b.values, cpu))
                               for b in births], acc.cpu())
                ops.row_delta(car_c, sc, +1, mode, old_fk=fkc)
            for name, x, y in _leaves(a, ac, "arenas") + _leaves(r, rc_,
                                                                 "rel"):
                assert torch.equal(x.cpu(), y), f"{which} {cid}: {name}"
    # K11 past a warp's lanes, two births of one class at one slot, mixed
    # dtypes, with no call waiting for the card
    eng, arenas, _p = _row_model("hospital", card)
    assert _k11_edges(eng, arenas, card, seed=6) > 32
