"""The port's hand kernels: plain versions against their JAX
counterparts (CPU), and CUDA kernels against the plain versions (card only).

  K1 enum_logsumexp — pclean_tpu.utils.logsumexp over concat([exist, new])
     (propose.py score_fk / score_choice): rtol 1e-6, the same f32 formula
     summed in another order; the finite NEG_INF rules exactly.
  K2 inv_cdf_sample — pclean_tpu.engine.propose._inv_cdf_from_u fed the same
     uniforms: equal indices, dead (NEG_INF) entries never drawn.
  K3 obs_gather_sum — sum of AddTypos gathers M_c[obs_c, word_c], and the
     one-hot contraction of _matmul_obs_term/_mm_flush: rtol 1e-5.
  K4 gauss_suffstats and K5 gauss_ext_term — the rents path's Gaussian
     statistics and closed-form external; their plain versions are held to
     the JAX package in tests/test_torch_rents.py, and here on the card the
     kernels to the plain versions (kernel_bench.check_k4 / check_k5) at
     the rents shapes and the edges: all referrers dead, a group with no
     referrers, slots and groups out of range, C = 1, one slot taking
     20,000 referrers, and one row for K5.

The launch plans of K1, K2 and K3 (path, geometry and tile sizes, a
function of the shapes alone) are checked here for legal geometry on the
H100, and K1's plan for the path it gives each shape the main path
launches it at.

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
                               rtol=1e-6)
    rec2, lz2 = ops.enum_logsumexp_plain(torch.as_tensor(ex))
    assert rec2.data_ptr() == torch.as_tensor(ex).data_ptr() or \
        np.array_equal(rec2.numpy(), ex)
    np.testing.assert_allclose(lz2.numpy(),
                               np.asarray(jlogsumexp(jnp.asarray(ex), -1)),
                               rtol=1e-6)


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
                             torch.zeros((1, 2), dtype=torch.int32),
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
    p5 = ops.gauss_ext_term_plan(B, A)
    assert p5["threads"] == 256 and p5["grid"] * 256 >= B * A
    assert (p5["grid"] - 1) * 256 < B * A


def test_census_counts_launches_by_mode_rows_and_length():
    ops.reset_counts()
    try:
        for rows, K, mode in [(1, 11264, "fk"), (1, 138, "choice"),
                              (1, 138, "choice"), (4096, 138, "choice")]:
            ops._count("enum_logsumexp", rows, K, mode)
        ops._count("inv_cdf_sample", 1, 11265)
        ops._count("obs_gather_sum", 1)
        rows = ops.census()
        assert [(r["kernel"], r["mode"], r["rows"], r["K"], r["launches"])
                for r in rows] == [
            ("enum_logsumexp", "choice", "r1", 138, 2),
            ("enum_logsumexp", "fk", "r1", 11264, 1),
            ("enum_logsumexp", "choice", "rn", 138, 1),
            ("inv_cdf_sample", None, "r1", 11265, 1)]
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
                                  "out_of_range", "C1", "crowded"])
def test_k4_cuda_matches_plain(card, case):
    from pclean_tpu_torch.kernel_bench import check_k4

    rng = np.random.default_rng(11)
    R, cap, C = 50_000, 4096, 5   # the rents path: Obs rows into County
    if case == "C1":
        C = 1
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
    if case == "all_dead":
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
])
def test_k5_cuda_matches_plain(card, B, A, C, case):
    from pclean_tpu_torch.kernel_bench import check_k5

    rng = np.random.default_rng(12)
    cap, E, I = 4096, 51 * 180, 51 * 180 * C
    k4 = _k4_inputs(card, rng, 50_000, cap, C)
    n, sz, szz, pre0 = ops.gauss_suffstats_plain(**k4)
    values = torch.as_tensor(rng.normal(1500, 1000, I).astype(np.float32),
                             device=card)
    tbl = torch.as_tensor(rng.integers(0, I, (E, C)).astype(np.int32),
                          device=card)
    key = rng.integers(0, 180, B)
    idx = torch.as_tensor((np.arange(A)[None, :] * 180 + key[:, None])
                          .astype(np.int32), device=card)
    slot = torch.as_tensor(rng.choice(cap, B, replace=False).astype(np.int32),
                           device=card)
    if case == "out_of_range":   # gathers clamp like the JAX package's
        idx[0, 0] = E + 5
        slot[-1] = cap + 1
        tbl[0, 0] = -4
    k5 = dict(values=values, tbl=tbl, idx=idx, slot=slot, n=n, sz=sz,
              szz=szz, pre0=pre0, coef=-0.5 / 150.0 ** 2)
    check_k5(ops, k5)


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
    plan = ops.maybe_swap_ext_plan(B, V)
    gx, gy = plan["grid"]
    assert plan["threads"] == 512 and gx == B
    assert gy * 4096 >= V > (gy - 1) * 4096


def test_k6_plan_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(1, 0)
    with pytest.raises(ValueError):
        ops.maybe_swap_ext_plan(1, 4096 * 65536)


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
