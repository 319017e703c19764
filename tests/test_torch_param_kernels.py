"""K22 gamma_draw and K23 py_resample (the parameter resampling) on the
CPU: their plain versions against pclean_tpu and jax.random, and on the
card (-m cuda) the kernels against their plain versions.

  * the stream: Philox4x32-10 of ops.philox_plain equals Random123's
    known answers; the same seed gives the same draws, another seed others;
  * ops.gamma_plain at alpha in {0.3, 1, 2.5, 40}: mean and variance within
    5 standard errors of jax.random.gamma's sample on 20,000 draws each,
    and a two-sample Kolmogorov-Smirnov test against it at p > 1e-3;
  * ops.gamma_draw_plain's Dirichlet rows (dirichlet_log) and Beta pairs
    against jax.random.dirichlet and jax.random.beta: each coordinate's
    mean and variance within 5 standard errors, on 20,000 rows each;
  * ops.tree_sum_plain equals its definition (pairs h apart, halving);
  * ops.py_resample_plain: its three scores equal to pclean_tpu's
    pitman_yor_score, as is the port's (rtol 1e-5: float32 sums of up to
    512 terms in another order), on seeded sizes with dead slots and slots alive with
    no references, and its accepts equal to JAX's formula wherever
    |alpha - log u| exceeds that tolerance;
  * resample_all on the CPU: every parameter and Pitman-Yor pair drawn,
    one seed taken from the generator, the same seed twice bit-equal;
    one K22 stage on the shipped models, a second where a statistic reads
    a value the first draws (its statistics then see that value); out=
    draws in place, bit-equal to the draws into new tensors.
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops

ALPHAS = (0.3, 1.0, 2.5, 40.0)
N = 20_000


def _seed(x: int) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.int64)


def test_philox_known_answers():
    """Random123's known-answer vectors of philox4x32_10."""
    t = lambda *v: [torch.tensor([x], dtype=torch.int64) for x in v]  # noqa
    cases = [(t(0, 0, 0, 0, 0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             (t(*[0xffffffff] * 6),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             (t(0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344, 0xa4093822,
                0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for args, want in cases:
        assert tuple(int(x) for x in ops.philox_plain(*args)) == want


def test_same_seed_same_draws():
    alpha = torch.tensor([0.3, 1.0, 2.5, 40.0] * 8)
    elem = torch.arange(alpha.numel())
    a = ops.gamma_plain(alpha, elem, _seed(11))
    assert torch.equal(a, ops.gamma_plain(alpha, elem, _seed(11)))
    assert not torch.equal(a, ops.gamma_plain(alpha, elem, _seed(12)))
    assert not torch.equal(a, ops.gamma_plain(alpha, elem + 1, _seed(11)))
    d = [ops.gamma_desc("dirichlet_log", torch.tensor([1.0, 2.0, 0.5]), 3,
                        3, torch.tensor([[0, 4, 1]] * 3, dtype=torch.int32)),
         ops.gamma_desc("beta", torch.tensor([1.0, 3.0]), 4, 2)]
    x, y = ops.gamma_draw_plain(d, _seed(5)), ops.gamma_draw_plain(d, _seed(5))
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    # a descriptor's elements follow the earlier descriptors' elements on
    # the stream: alone, the Beta rows draw other gammas
    one = ops.gamma_draw_plain(d[1:], _seed(5))[0]
    assert not torch.equal(one, x[1])


def _close(x, y, what):
    """Means and variances of two samples within 5 standard errors."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    se = np.sqrt(x.var() / len(x) + y.var() / len(y))
    assert abs(x.mean() - y.mean()) < 5 * se, (what, x.mean(), y.mean())
    m4 = np.mean((x - x.mean()) ** 4) + np.mean((y - y.mean()) ** 4)
    se_v = np.sqrt(m4 / len(x))
    assert abs(x.var() - y.var()) < 5 * se_v, (what, x.var(), y.var())


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gamma_matches_jax_in_distribution(alpha):
    import jax
    from scipy import stats

    g = ops.gamma_plain(torch.full((N,), alpha), torch.arange(N),
                        _seed(int(alpha * 1000) + 1)).numpy()
    j = np.asarray(jax.random.gamma(jax.random.PRNGKey(3), alpha, (N,)))
    assert np.all(g >= 0) and np.all(np.isfinite(g))
    _close(g, j, f"gamma({alpha})")
    assert stats.ks_2samp(g, j).pvalue > 1e-3


def test_dirichlet_and_beta_match_jax_in_distribution():
    import jax

    conc = torch.tensor([0.5, 1.0, 3.0, 0.25])
    counts = torch.tensor([2, 0, 1, 5], dtype=torch.int32)
    d = ops.gamma_desc("dirichlet_log", conc, N, 4,
                       counts.expand(N, 4))
    b = ops.gamma_desc("beta", torch.tensor([10.0, 50.0]), N, 2,
                       torch.tensor([[3, 7]], dtype=torch.int32).expand(N, 2))
    logv, beta = ops.gamma_draw_plain([d, b], _seed(77))
    v = logv.exp().numpy()
    np.testing.assert_allclose(v.sum(1), 1.0, rtol=1e-5)
    jd = np.asarray(jax.random.dirichlet(
        jax.random.PRNGKey(4), (conc + counts).numpy(), (N,)))
    for k in range(4):
        _close(v[:, k], jd[:, k], f"dirichlet[{k}]")
    jb = np.asarray(jax.random.beta(jax.random.PRNGKey(5), 13.0, 57.0, (N,)))
    _close(beta.numpy(), jb, "beta")


def test_tree_sum_is_its_definition():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 8, 13, 64, 100):
        x = torch.tensor(rng.normal(size=(3, n)).astype(np.float32))
        P = 1
        while P < n:
            P *= 2
        want = torch.cat([x, torch.zeros(3, P - n)], 1)
        while want.shape[1] > 1:
            h = want.shape[1] // 2
            want = torch.stack([want[:, i] + want[:, i + h]
                                for i in range(h)], 1)
        assert torch.equal(ops.tree_sum_plain(x), want[:, 0])


def _py_case(rng, cap):
    rc = rng.integers(0, 9, cap).astype(np.int32)
    rc[rng.random(cap) < 0.3] = 0            # alive with no references
    alive = rng.random(cap) < 0.75            # dead slots
    s = np.float32(rng.gamma(1.0) + 0.1)
    d = np.float32(rng.random() * 0.9)
    return rc, alive, s, d


@pytest.mark.parametrize("cap", [1, 7, 64, 512])
def test_py_resample_plain_matches_jax(cap):
    """Its scores against pclean_tpu's pitman_yor_score at the same (s, d)
    pairs, and its two accepts against JAX's formula on those scores,
    over 6 seeded classes of each capacity."""
    import jax.numpy as jnp
    from pclean_tpu.engine.gibbs_params import pitman_yor_score
    from pclean_tpu_torch.engine.gibbs_params import \
        pitman_yor_score as port_score

    rng = np.random.default_rng(cap)
    cases = [_py_case(rng, cap) for _ in range(6)]
    classes = [ops.py_class(torch.tensor(rc), torch.tensor(al),
                            torch.tensor(s), torch.tensor(d))
               for rc, al, s, d in cases]
    scores = []
    out = ops.py_resample_plain(classes, _seed(cap), scores=scores)
    tol = 1e-5
    decided = 0
    for (rc, al, s, d), sc, (s1, d1) in zip(cases, scores, out):
        on = jnp.asarray(al & (rc > 0))
        sz = jnp.asarray(rc)
        jscore = lambda a, b: float(pitman_yor_score(  # noqa: E731
            jnp.float32(a), jnp.float32(b), sz, on))
        sp, dp = float(sc["s_prop"]), float(sc["d_prop"])
        want = (jscore(s, d), jscore(sp, d))
        np.testing.assert_allclose([float(sc["old"]), float(sc["new"])], want,
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(float(port_score(
            torch.tensor(s), torch.tensor(d), torch.tensor(rc),
            torch.tensor(al & (rc > 0)))), want[0], rtol=tol, atol=tol)
        alpha = want[1] + (-float(s)) - want[0] - (-sp)
        if abs(alpha - float(sc["log_u0"])) > tol * (1 + abs(alpha)):
            decided += 1
            assert bool(sc["acc"]) == (float(sc["log_u0"]) < alpha)
        s_now = sp if bool(sc["acc"]) else float(s)
        assert float(s1) == np.float32(s_now)
        new2 = jscore(s_now, dp)
        np.testing.assert_allclose(float(sc["new2"]), new2, rtol=tol,
                                   atol=tol)
        gap = new2 - float(sc["cur"])
        if abs(gap - float(sc["log_u2"])) > tol * (1 + abs(gap)):
            assert bool(sc["acc2"]) == (float(sc["log_u2"]) < gap)
        assert float(d1) == (np.float32(dp) if bool(sc["acc2"]) else d)
    assert decided > 0


def test_py_resample_plain_writes_outputs_in_place():
    rng = np.random.default_rng(3)
    rc, al, s, d = _py_case(rng, 32)
    st, dt = torch.tensor(s), torch.tensor(d)
    c = [ops.py_class(torch.tensor(rc), torch.tensor(al), st, dt)]
    want = ops.py_resample_plain(c, _seed(9))[0]
    got = ops.py_resample_plain(c, _seed(9), outs=[(st, dt)])[0]
    assert got[0] is st and got[1] is dt
    assert float(st) == float(want[0]) and float(dt) == float(want[1])


def test_resample_all_on_the_cpu_draws_every_parameter():
    """On the hospital model (240 synthetic rows): every Proportions'
    log_value a normalised row, every latent class's Pitman-Yor pair
    drawn, one int64 seed taken from the generator, the same generator
    state twice bit-equal."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.gibbs_params import resample_all
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.kernel_bench import _leaves
    from pclean_tpu_torch.workloads import hospital

    cm, cfg = hospital.setup(rows=240, batch=16, device="cpu")[:2]
    arenas, params = init_state(cm, 0, device="cpu")
    eng = Engine(cm, cfg, device="cpu")
    arenas, params, _g = eng.initialize(1, arenas, params)
    outs = [resample_all(cm, arenas, params, eng.obs_dev,
                         torch.Generator().manual_seed(4))[1]
            for _ in range(2)]
    assert [n for n, x, y in _leaves(outs[0], outs[1], "p")
            if not torch.equal(x, y)] == []
    new = outs[0]
    for (cid, vid), meta in cm.param_meta.items():
        lv = new[cid][vid]["log_value"]
        np.testing.assert_allclose(lv.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
        assert lv is not params[cid][vid]["log_value"]
    moved = sum(not torch.equal(new["__py__"][c]["strength"],
                                params["__py__"][c]["strength"])
                for c in new["__py__"])
    assert moved > 0
    seen = []
    real = ops.draw_seed
    try:
        ops.draw_seed = lambda g, d: seen.append(1) or real(g, d)
        resample_all(cm, arenas, params, eng.obs_dev,
                     torch.Generator().manual_seed(4))
    finally:
        ops.draw_seed = real
    assert seen == [1]


@pytest.mark.parametrize("name", ["hospital", "flights", "rents"])
def test_draw_stages_one_stage_on_the_shipped_models(name):
    """No statistic of the shipped models reads a learned parameter
    (stats_reads empty), so resample_all draws every Proportions and Prob
    value in one K22 stage, in param_meta's order."""
    from pclean_tpu_torch.engine import gibbs_params as gp
    from pclean_tpu_torch.workloads import flights, hospital, rents

    setup = dict(hospital=lambda: hospital.setup(rows=240, batch=16,
                                                 device="cpu"),
                 flights=lambda: flights.setup(rows=120, flights=8,
                                               websites=6, device="cpu"),
                 rents=lambda: rents.setup(rows=400, states=4, counties=12,
                                           device="cpu"))[name]
    cm = setup()[0]
    assert cm.param_meta
    assert all(gp.stats_reads(cm, *k) == set() for k in cm.param_meta)
    assert gp.draw_stages(cm) == [list(cm.param_meta)]


def test_resample_all_stages_where_statistics_read_a_drawn_value(
        monkeypatch):
    """Where a parameter's statistics read a parameter that the pending
    K22 launch draws (here declared through stats_reads on the hospital
    model), that launch goes first: two stages, two seeds, two K22
    launches, and the later parameter's statistics see the value drawn
    for the earlier one, as in JAX's loop; undeclared, one stage and the
    statistics see the value from before the call."""
    from pclean_tpu_torch.engine import gibbs_params as gp
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import hospital

    cm, cfg = hospital.setup(rows=240, batch=16, device="cpu")[:2]
    arenas, params = init_state(cm, 0, device="cpu")
    eng = Engine(cm, cfg, device="cpu")
    arenas, params, _g = eng.initialize(1, arenas, params)
    first, second = list(cm.param_meta)[:2]
    real_stats, real_draw = gp.suffstats, ops.gamma_draw

    def run():
        seen, launches = {}, []

        def stats(cm_, cid, vid, arenas_, rel, params_, obs):
            if (cid, vid) == second:
                seen["first"] = params_[first[0]][first[1]]["log_value"]
            return real_stats(cm_, cid, vid, arenas_, rel, params_, obs)

        def draw(descs, seed, outs=None):
            launches.append(len(descs))
            return real_draw(descs, seed, outs)

        monkeypatch.setattr(gp, "suffstats", stats)
        monkeypatch.setattr(ops, "gamma_draw", draw)
        new = gp.resample_all(cm, arenas, params, eng.obs_dev,
                              torch.Generator().manual_seed(4))[1]
        monkeypatch.setattr(gp, "suffstats", real_stats)
        monkeypatch.setattr(ops, "gamma_draw", real_draw)
        return new, seen["first"], launches

    new, saw, launches = run()
    assert launches == [len(cm.param_meta)]
    assert saw is params[first[0]][first[1]]["log_value"]

    cm.__dict__.pop("_draw_stages", None)
    real_reads = gp.stats_reads
    monkeypatch.setattr(gp, "stats_reads", lambda cm_, cid, vid: (
        {cm_.canon(*first)} if (cid, vid) == second
        else real_reads(cm_, cid, vid)))
    try:
        assert gp.draw_stages(cm) == [[first], list(cm.param_meta)[1:]]
        new, saw, launches = run()
    finally:
        cm.__dict__.pop("_draw_stages", None)
    assert launches == [1, len(cm.param_meta) - 1]
    assert saw is new[first[0]][first[1]]["log_value"]
    assert not torch.equal(saw, params[first[0]][first[1]]["log_value"])


def test_resample_all_draws_into_out_in_place():
    """resample_all(out=own): K22 and K23 write into own's leaves (a
    one-row loop's copy, which its captured graph reads), bit-equal to the
    draws into new tensors from the same generator state; the caller's
    params stay unchanged."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.gibbs_params import resample_all
    from pclean_tpu_torch.engine.row_graph import own_params
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.kernel_bench import _leaves
    from pclean_tpu_torch.workloads import hospital

    cm, cfg = hospital.setup(rows=240, batch=16, device="cpu")[:2]
    arenas, params = init_state(cm, 0, device="cpu")
    eng = Engine(cm, cfg, device="cpu")
    arenas, params, _g = eng.initialize(1, arenas, params)
    keep = own_params(params)
    want = resample_all(cm, arenas, params, eng.obs_dev,
                        torch.Generator().manual_seed(4))[1]
    own = own_params(params)
    got = resample_all(cm, arenas, own, eng.obs_dev,
                       torch.Generator().manual_seed(4), out=own)[1]
    assert [n for n, x, y in _leaves(got, want, "p")
            if not torch.equal(x, y)] == []
    assert [n for n, x, y in _leaves(params, keep, "p")
            if not torch.equal(x, y)] == []
    for cid, vid in cm.param_meta:
        assert got[cid][vid]["log_value"] is own[cid][vid]["log_value"]
    for cid, sd in got["__py__"].items():
        assert sd["strength"] is own["__py__"][cid]["strength"]
        assert sd["discount"] is own["__py__"][cid]["discount"]


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


def _descs(dev, rng, shapes):
    out = []
    for mode, rows, width, counts in shapes:
        base = torch.tensor(rng.gamma(1.0, size=width).astype(np.float32)
                            + np.float32(0.05), device=dev)
        if mode == "beta":
            base = torch.tensor([10.0, 50.0], device=dev)
        cnt = torch.tensor(rng.integers(0, 40, (rows, width)),
                           dtype=torch.int32, device=dev) if counts else None
        out.append(ops.gamma_desc(mode, base, rows, width, cnt))
    return out


K22_SHAPES = {
    "hospital": [("dirichlet_log", 1, 4, True), ("dirichlet_log", 1, 6, True),
                 ("dirichlet_log", 1, 2, True)],
    "flights": [("beta", 38, 2, True)],
    "wide": [("gamma", 3, 700, False), ("dirichlet_log", 2, 1000, True),
             ("dirichlet_log", 5, 1, False), ("beta", 1, 2, False)],
    "many": [("dirichlet_log", 1, 3, True)] * 70,
    # the census shapes: flights' 39 Beta pairs, scaled's and rents' one
    # Dirichlet row, hospital's three
    "flights_census": [("beta", 39, 2, True)],
    "scaled": [("dirichlet_log", 1, 50, True)],
    "rents": [("dirichlet_log", 1, 51, True)],
    "hospital_census": [("dirichlet_log", 1, 23, True),
                        ("dirichlet_log", 1, 14, True),
                        ("dirichlet_log", 1, 8, True)],
    # descriptors of mixed widths and modes in one launch: rows of 1 to
    # 200 on blocks of 256, Beta pairs, plain gammas
    "mixed": [("dirichlet_log", 1, 23, True), ("dirichlet_log", 2, 7, True),
              ("beta", 5, 2, True), ("gamma", 1, 1, False),
              ("dirichlet_log", 1, 64, True), ("dirichlet_log", 3, 200, True),
              ("gamma", 2, 33, True)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K22_SHAPES))
def test_k22_cuda_bit_equal_to_plain(card, case):
    rng = np.random.default_rng(1)
    d = _descs(card, rng, K22_SHAPES[case])
    seed = torch.tensor([987654321987], dtype=torch.int64, device=card)
    before = ops.LAUNCHES["gamma_draw"]
    got = ops.gamma_draw(d, seed)
    assert ops.LAUNCHES["gamma_draw"] == before + \
        -(-len(d) // ops.K22_MAX_DESC)
    want = ops.gamma_draw_plain(d, seed)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_k22_cuda_alpha_grid_bit_equal(card):
    """Gamma draws over alphas from 1e-3 to 1e4 (the boost, the rounds)."""
    a = torch.logspace(-3, 4, 4096, device=card)
    d = [ops.gamma_desc("gamma", a, 1, a.numel())]
    seed = torch.tensor([5], dtype=torch.int64, device=card)
    got = ops.gamma_draw(d, seed)[0]
    want = ops.gamma_draw_plain(d, seed)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [[64, 128, 256, 512, 64, 128],
                                  [1, 2, 3], [11264], [8] * 70, [1], [31],
                                  [1024], [1025], [2048], [4096],
                                  [11264, 1472], [16384], [16385],
                                  [5, 16385, 64, 11264], [40, 700] * 32,
                                  [262144], [262145], [5, 1000000, 64]])
def test_k23_cuda_bit_equal_to_plain(card, caps):
    rng = np.random.default_rng(len(caps) + max(caps))
    classes, copies = [], []
    for cap in caps:
        rc, al, s, d = _py_case(rng, cap)
        c = ops.py_class(torch.tensor(rc, device=card),
                         torch.tensor(al, device=card),
                         torch.tensor(s, device=card),
                         torch.tensor(d, device=card))
        classes.append(c)
        copies.append((c["strength"].clone(), c["discount"].clone()))
    seed = torch.tensor([31337], dtype=torch.int64, device=card)
    want = ops.py_resample_plain(classes, seed)
    before = ops.LAUNCHES["py_resample"]
    got = ops.py_resample(classes, seed)
    assert ops.LAUNCHES["py_resample"] - before == len(
        ops.py_resample_plan(caps))
    ins = ops.py_resample(classes, seed, outs=copies)   # in place
    torch.cuda.synchronize()
    for (a, b), (c, d), (e, f) in zip(got, want, ins):
        assert torch.equal(a, c) and torch.equal(b, d)
        assert torch.equal(e, c) and torch.equal(f, d)


@pytest.mark.cuda
def test_k22_k23_cuda_refuse_what_they_do_not_take(card):
    seed = torch.tensor([1], dtype=torch.int64, device=card)
    base = torch.ones(3, device=card)
    with pytest.raises(ValueError):
        ops.gamma_draw([ops.gamma_desc("beta", base, 1, 3)], seed)
    with pytest.raises(ValueError):
        ops.gamma_draw([ops.gamma_desc("gamma", base.double(), 1, 3)], seed)
    with pytest.raises(ValueError):
        ops.gamma_draw([ops.gamma_desc("gamma", base, 1, 3)], seed.int())
    with pytest.raises(ValueError):
        ops.gamma_desc("poisson", base, 1, 3)
    rc = torch.ones(4, dtype=torch.int32, device=card)
    al = torch.ones(4, dtype=torch.bool, device=card)
    s = torch.tensor(1.0, device=card)
    with pytest.raises(ValueError):
        ops.py_resample([ops.py_class(rc.long(), al, s, s)], seed)
    with pytest.raises(ValueError):
        ops.py_resample([ops.py_class(rc, al, s.double(), s)], seed)


@pytest.mark.cuda
def test_resample_all_cuda_one_launch_each_and_no_host_sync(card):
    """resample_all on the hospital model on the card under
    torch.cuda.set_sync_debug_mode("error"): one K22 and one K23 launch
    a call, no host sync, every Proportions' row normalised."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.gibbs_params import resample_all
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import hospital

    cm, cfg = hospital.setup(rows=240, batch=16, device="cuda")[:2]
    arenas, params = init_state(cm, 0, device="cuda")
    eng = Engine(cm, cfg, device="cuda")
    arenas, params, gen = eng.initialize(1, arenas, params)
    rel = refresh(cm, arenas, eng.obs_dev)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _a, new = resample_all(cm, arenas, params, eng.obs_dev, gen, rel=rel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gamma_draw"] == before["gamma_draw"] + 1
    assert ops.LAUNCHES["py_resample"] == before["py_resample"] + 1
    for (cid, vid) in cm.param_meta:
        lv = new[cid][vid]["log_value"]
        torch.testing.assert_close(lv.exp().sum(-1).cpu(),
                                   torch.ones(lv.shape[0]), rtol=1e-5,
                                   atol=0)
