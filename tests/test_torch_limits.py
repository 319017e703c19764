"""The card kernels' fixed limits: split plans and raised limits on the CPU,
on workloads/limits.py's synthetic model (a class of 66 stored columns,
fk chains of 5, 7 and 9 hops, a record of four ancestor axes, a level of
more than 64 operands, 29 nodes in Record's fk tree), and on the card
(-m cuda) each split or raised kernel against its plain version.

  * K18 and the folds: chain_folds' cuts for chains of 5, 7 and 9 hops
    past K18's 4, K7's 8 columns and K14's 4 hops; fold_chain through the
    plain gathers equals the unfolded chase; the model's row lookups,
    hoisted histograms and prop scatters ask for chains that long;
  * K10: the model's Record plan takes the larger parameter block (29
    fk-tree nodes, chains of 9 hops) and fits it; a plan past both blocks
    raises, naming the model's feature;
  * K11, K15, K14's cascade: the model's Record row birthing a Wide writes
    more than 64 values (three launches) and Wide's batched write has 67
    columns (two); batch_write_plain (out of place) over the column
    chunks gives the columns of one call;
  * K16/K17: the model's Anc block picks a record at four ancestors, and
    the kernels take up to seven;
  * K20: the model's widest level holds more than 64 operands (one a
    Wide column), and a seeded level of 260 operands and
    more than 384 steps nests 40 deep: level_stages cuts both, and the
    split plain evaluation is bit-equal to the unsplit one;
  * one small CPU run (64 rows, B = 8) of the model through the port and
    pclean_tpu: init F1 of the port's 2 seeds within pclean_tpu's 2-seed
    range +- 0.02 (ROADMAP's whole-run parity).
"""
import warnings

import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.workloads import limits

ROWS, BATCH = 64, 8


@pytest.fixture(scope="module")
def model():
    warnings.simplefilter("ignore", RuntimeWarning)
    cm, cfg, dirty, clean, query, _s = limits.setup(rows=ROWS, batch=BATCH,
                                                    device="cpu")
    return cm, cfg, dirty, clean, query


def _spy(monkeypatch, name, calls):
    real = getattr(ops, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(ops, name, spy)


@pytest.fixture(scope="module")
def traced(model):
    """The kernels' wrappers' calls over the model's init on the CPU (the
    plain versions run; the arguments are what the card would get)."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    cm, cfg = model[:2]
    mp = pytest.MonkeyPatch()
    calls = {n: [] for n in ("row_gather", "referrer_hist", "rel_scatter",
                             "choice_sample", "fk_sample", "level_sum",
                             "batch_write", "row_write")}
    for n, c in calls.items():
        _spy(mp, n, c)
    try:
        arenas, params = init_state(cm, 0, device="cpu")
        eng = Engine(cm, cfg, device="cpu")
        arenas, params, gen = eng.initialize(1, arenas, params)
        arenas, params, gen = eng.run(gen, arenas, params)
    finally:
        mp.undo()
    return calls, (arenas, params, eng)


@pytest.mark.parametrize("hops", [5, 7, 9])
@pytest.mark.parametrize("most", [ops.K18_MAX_HOPS + 1, ops.K14_MAX_HOPS - 1,
                                  7])
def test_chain_folds_cut_long_chains(hops, most):
    folds = ops.chain_folds(hops, most)
    if hops <= most:
        assert folds == []
        return
    assert folds[0][0] == 0 and all(a[1] == b[0]
                                    for a, b in zip(folds, folds[1:]))
    assert all(1 <= hi - lo <= ops.K18_MAX_HOPS + 1 for lo, hi in folds)
    assert hops - folds[-1][1] <= most


@pytest.mark.parametrize("hops", [5, 7, 9])
def test_fold_chain_reaches_the_same_targets(hops):
    rng = np.random.default_rng(hops)
    cols = [torch.tensor(rng.integers(-2, 40, 37), dtype=torch.int32)
            for _ in range(hops)]
    start = torch.tensor(rng.integers(-3, 40, (5, 7)))
    want = ops.row_gather_plain(start, cols[:-1], cols[-1])
    for most in (1, 2, ops.K14_MAX_HOPS, ops.K18_MAX_HOPS + 1):
        s, rest = ops.fold_chain(start, cols, most)
        assert len(rest) <= most
        got = ops.row_gather_plain(s, rest[:-1], rest[-1]) if rest else s
        assert torch.equal(got, want)


def test_model_asks_for_long_chains(traced):
    calls = traced[0]
    k18 = max(len(a[1]) for a, _kw in calls["row_gather"])
    assert k18 > ops.K18_MAX_HOPS
    k7 = [len(kw.get("hops") or ()) for _a, kw in calls["referrer_hist"]]
    assert max(k7) > ops._K7_MAX_HOPS
    k14 = max(len(sd["hops"]) for a, _kw in calls["rel_scatter"]
              for sd in a[3])
    assert k14 > ops.K14_MAX_HOPS
    assert max(k7) == 9


def test_k10_takes_the_larger_block(model):
    cm = model[0]
    plan = ops.row_delta_plan(cm, "Record", "obs")
    assert len(plan["nodes"]) == 29 and plan["tier"] == 1
    assert sorted(len(e["chain"]) for e in plan["props"]) == [5, 7, 9]
    assert len(plan["words"]) <= ops.k10_words(1)
    assert ops.K10_PARAM_BYTES <= ops.PARAM_MAX
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        if lay.observed or not lay.fk_vertices:
            continue
        for hop in (False, True):
            p = ops.row_delta_plan(cm, cid, "latent", hop)
            assert len(p["words"]) <= ops.k10_words(p["tier"])
    assert ops.k10_tier(24, 32, 6) == 0 and ops.k10_tier(25, 0, 0) == 1
    with pytest.raises(ValueError, match="fk tree"):
        ops.k10_tier(65, 1, 1, "Record")
    with pytest.raises(ValueError, match="hops"):
        ops.k10_tier(3, 1, 17, "Record")


def test_row_writes_and_batched_columns_split(model, traced):
    cm = model[0]
    assert len(cm.layouts["Wide"].store) == limits.WIDE > ops.K15_MAX_COLS
    chunks = ops.batch_write_chunks(limits.WIDE + 1)
    assert [hi - lo for lo, hi in chunks] == [48, 19]
    assert ops.row_write_chunks(limits.WIDE + 3) == [(0, 64), (64, 69)]
    assert ops.row_write_chunks(0) == [(0, 0)]
    assert ops.cascade_groups(17) == [(0, 8), (8, 16), (16, 17)]
    assert ops.cascade_groups(0) == [(0, 0)]
    widths = [len(a[0]) + (a[4] is not None if len(a) > 4 else
                           kw.get("alive") is not None)
              for a, kw in traced[0]["batch_write"]]
    assert max(widths) > ops.K15_MAX_COLS
    # the split plain evaluation: column chunks one after another
    rng = np.random.default_rng(0)
    cols = [torch.tensor(rng.integers(0, 5, 20), dtype=torch.int32)
            for _ in range(60)]
    vals = [torch.tensor(rng.integers(0, 9, 6)) for _ in range(60)]
    slots = torch.tensor([0, 3, 19, -1, 25, 7])
    ok = torch.tensor([True, True, False, True, True, True])
    one, _alive = ops.batch_write_plain(cols, vals, slots, ok)
    split = []
    for lo, hi in ops.batch_write_chunks(len(cols)):
        split += ops.batch_write_plain(cols[lo:hi], vals[lo:hi], slots,
                                       ok)[0]
    assert len(split) == len(one) == len(cols)
    assert all(torch.equal(a, b) for a, b in zip(one, split))


@pytest.mark.parametrize("B", [1, 256])
def test_k15_plan_past_the_old_limit(B):
    """Wide's batched write at the card test's shape (65 columns and the
    alive bits): two launches, each launch's columns copied and written as
    the kernel reads its words (test_torch_rel_kernels.run_k15), bit-equal
    to the plain version."""
    from pclean_tpu_torch import kernel_bench as kb
    from test_torch_rel_kernels import _k15_plan_check

    mode = "Wide cap=300 " + ",".join(["i32<i32"] * 60 + ["f32<f32"] * 5
                                      + ["alive"])
    inp = kb.k15_inputs("cpu", mode, B)
    assert len(ops.batch_write_chunks(66)) == 2
    _k15_plan_check(*inp["args"], sms=132)


def test_model_row_write_exceeds_one_launch(model):
    """A Record row that births a Wide: its writes (Record's stored values
    and the Wide's) past K11's 64."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.propose import Birth

    cm = model[0]
    arenas, _p = init_state(cm, 0, device="cpu")
    car = ops.RowCarry(cm, "Record", arenas)
    st = torch.tensor([0])
    lay = cm.layouts["Record"]
    env2 = {v: torch.zeros((1,), dtype=torch.int32) for v in lay.store}
    wide = Birth(lay.fk_vertices[1], "Wide", torch.tensor([True]),
                 torch.tensor([1]), {v: torch.zeros((1,), dtype=torch.int32)
                                     for v in cm.layouts["Wide"].store})
    writes = ops.row_write_writes(car, st, env2, [wide], None, True)
    assert len(writes) > ops.K11_MAX_WRITES
    chunks = ops.row_write_chunks(len(writes))
    assert len(chunks) == -(-len(writes) // ops.K11_MAX_WRITES) >= 2


def test_model_records_have_four_ancestor_axes(traced):
    d = max(len(a[1]) for a, _kw in traced[0]["choice_sample"])
    assert d == 4 and ops._MAX_ANC >= d


def _seeded_level(rng, n_ops=260, depth=40):
    """A level of n_ops operands (dense [B, V] or [B, 1] terms and gathers)
    whose program nests `depth` deep, then adds every operand."""
    B, V = 3, 5
    operands = []
    for i in range(n_ops):
        if i % 3 == 2:
            M = torch.tensor(rng.normal(size=(6, 6)).astype(np.float32))
            operands.append(ops.level_gather(
                M, torch.tensor(rng.integers(0, 6, (B, 1))),
                torch.tensor(rng.integers(0, 6, (1, V))), (B, V)))
        else:
            shape = (B, V) if i % 3 == 0 else (B, 1)
            operands.append(ops.level_dense(torch.tensor(
                rng.normal(size=shape).astype(np.float32))))
    Z, P, A = ops.LEVEL_ZERO, ops.LEVEL_PUSH, ops.LEVEL_ADD
    code = [(Z, 0)]
    for k in range(depth):
        code += [(Z, 0), (P, k)]
    code += [(A, 0)] * (2 * depth)
    for k in range(n_ops):
        code += [(P, k), (A, 0)]
    return ops.level_program(code), operands


def test_k20_splits_long_levels_bit_equal(traced):
    prog, operands = _seeded_level(np.random.default_rng(2))
    assert len(prog) > ops.K20_MAX_PROG and len(operands) > ops.K20_MAX_OPS
    assert ops.level_stack(prog) > ops.K20_MAX_STACK
    with pytest.raises(ValueError):
        ops.level_plan(prog, operands, 2, card=False)
    stages = ops.level_stages(prog, operands)
    assert len(stages) > 1
    for p, srcs in stages:
        assert len(p) <= ops.K20_MAX_PROG and len(srcs) <= ops.K20_MAX_OPS
        assert ops.level_stack(p) <= ops.K20_MAX_STACK
    want = ops.level_sum_plain(prog, operands, 2)
    assert torch.equal(ops.level_sum_split_plain(prog, operands, 2), want)
    # the model's own widest level at one row
    big = max(traced[0]["level_sum"], key=lambda c: len(c[0][1]))
    (p, ops_, rank), kw = big[0][:3], big[1]
    assert len(ops_) > ops.K20_MAX_OPS
    assert len(ops.level_stages(p, ops_)) > 1
    assert torch.equal(ops.level_sum_split_plain(p, ops_, rank),
                       ops.level_sum_plain(p, ops_, rank))
    # a level that fits keeps one launch, as it is
    small = min(traced[0]["level_sum"], key=lambda c: len(c[0][1]))
    (p, ops_), _kw = small[0][:2], small[1]
    assert ops.level_stages(p, ops_) == [
        (list(p), [("o", i) for i in range(len(ops_))])]


def test_limits_model_init_f1_within_jax_seed_range(model):
    import jax
    from pclean_tpu.analysis import evaluate_accuracy_device as j_eval
    from pclean_tpu.engine import compile as jcompile
    from pclean_tpu.engine import smc as jsmc
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from test_torch_host import JNS

    cm, cfg, dirty, clean, query = model
    cm_j, _c, dirty_j, clean_j, q_j, _s = limits.setup(rows=ROWS, ns=JNS)
    assert dirty_j == dirty and clean_j == clean
    f_j, f_t = [], []
    for seed in range(2):
        a, p = jcompile.init_state(cm_j, jax.random.PRNGKey(seed))
        eng = jsmc.Engine(cm_j, jsmc.InferenceConfig(
            batch_rows=BATCH, rejuv_frequency=cfg.rejuv_frequency))
        a, p, _k = eng.initialize(jax.random.PRNGKey(seed + 1), a, p)
        f_j.append(j_eval(cm_j, a, p, dirty, clean, q_j)["f1"])
        a, p = init_state(cm, seed, device="cpu")
        eng_t = Engine(cm, cfg, device="cpu")
        a, p, _g = eng_t.initialize(seed + 1, a, p)
        f_t.append(evaluate_accuracy_device(cm, a, p, dirty, clean,
                                            query)["f1"])
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


I8, I32, I64, F32 = torch.int8, torch.int32, torch.int64, torch.float32
SAMPLE_CASES = {   # (kernel, census fields, K): past the old limits
    "k16 drawn d4": ("fk_sample", dict(form="drawn", mask="shared", B=64,
                                       cap=100, comp=False, d=4), 101),
    "k16 retained d7": ("fk_sample", dict(form="retained", mask="own", B=9,
                                          cap=40, comp=True, d=7), 21),
    "k17 draw d5": ("choice_sample", dict(form="draw", dtype=F32, B=33,
                                          d=5), 7),
    "k17 pick d7": ("choice_sample", dict(form="pick", dtype=I8, B=20,
                                          d=7), 1),
    "k18 nine hops": ("row_gather", dict(cols=[(I32, 5000)] + [
        (I32, 300)] * 8 + [(F32, 300)]), 5000),
    "k18 five hops one slot": ("row_gather", dict(cols=[
        (I64, 64), (I32, 64), (I8, 64), (I32, 64), (I32, 64),
        (I32, 64)]), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_kernels_past_the_old_limits_on_card(card, case):
    from pclean_tpu_torch import kernel_bench as kb

    kernel, fields, K = SAMPLE_CASES[case]
    before = ops.LAUNCHES[kernel]
    kb.check_sample(ops, kb.sample_inputs(card, kernel, fields, K))
    if kernel == "row_gather":   # the folds launch K18 too
        hops = len(fields["cols"]) - 1
        assert ops.LAUNCHES[kernel] - before == 1 + len(ops.chain_folds(
            hops + 1, ops.K18_MAX_HOPS + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [
    "refcount n=300 src=300 +1a:300,40,40,40,40,40,40,40,40 -",
    "prop n=200 src=300 +1asc:300,40,40,40,40,40,40 i32 idx",
    "delta n=64 src=300 -1a:300,40,40,40,40q/+1ax:300,40,40,40,40 - idx",
    "cascade X fks=17"])
def test_k14_past_the_old_limits_on_card(card, mode):
    from pclean_tpu_torch import kernel_bench as kb

    kb.check_k14(ops, kb.k14_inputs(card, mode, 40 if mode[0] != "c"
                                    else 500))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256])
def test_k15_past_the_old_limit_on_card(card, B):
    from pclean_tpu_torch import kernel_bench as kb

    mode = "Wide cap=300 " + ",".join(["i32<i32"] * 60 + ["f32<f32"] * 5
                                      + ["alive"])
    before = ops.LAUNCHES["batch_write"]
    kb.check_k15(ops, kb.k15_inputs(card, mode, B))
    assert ops.LAUNCHES["batch_write"] - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("hops", [9, 14])
def test_k7_hoisted_past_the_old_limit_on_card(card, hops):
    rng = np.random.default_rng(hops)
    N, cap, V = 4000, 50, 7
    cols = [torch.tensor(rng.integers(-1, 60, N), dtype=I32, device=card)] \
        + [torch.tensor(rng.integers(-1, 60, 60), dtype=I32, device=card)
           for _ in range(hops - 1)]
    val = torch.tensor(rng.integers(-1, V + 1, N), dtype=I32, device=card)
    w = torch.tensor(rng.random(N) < 0.7, device=card)
    got = ops.referrer_hist(val, w, V, cap=cap, hops=cols)
    want = ops.referrer_hist_plain(val.cpu(), w.cpu(), V, cap=cap,
                                   hops=[c.cpu() for c in cols])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k20_split_level_bit_equal_on_card(card):
    prog, operands = _seeded_level(np.random.default_rng(2))
    from pclean_tpu_torch.kernel_bench import _tree_map

    dev_ops = _tree_map(operands, lambda t: t.to(card))
    before = ops.LAUNCHES["level_sum"]
    got = ops.level_sum(prog, dev_ops, 2, B=3, label="test")
    n = len(ops.level_stages(prog, operands))
    assert ops.LAUNCHES["level_sum"] - before == n > 1
    want = ops.level_sum_plain(prog, dev_ops, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_limits_model_on_card(card):
    """The model on the card: K10 and K11 against their plain versions on
    every class kind (kernel_bench.shadow_rows: Record's plan in the
    larger block, Wide's rows past 64 writes), refresh and the hop
    histograms through K14's folds against the CPU (check_rel_state),
    then compile -> initialize -> one sweep with every one-row loop
    graphed, F1 above 0.9 on 64 rows."""
    from pclean_tpu_torch import kernel_bench as kb
    from pclean_tpu_torch.analysis import evaluate_accuracy_device
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine

    cm, cfg, dirty, clean, query, _s = limits.setup(rows=ROWS, batch=BATCH,
                                                    device="cuda")
    arenas, params = init_state(cm, 0, device="cuda")
    eng = Engine(cm, cfg, device="cuda")
    seeded = kb.row_state(cm, 7, device="cuda")
    for cid in cm.model.class_order:
        lay = cm.layouts[cid]
        kinds = (["init", "obs"] if lay.observed else
                 ["latent" if lay.fk_vertices else "leaf"])
        for kind in kinds:
            r = kb.shadow_rows(ops, eng, seeded, params, cid, kind, n=16,
                               seed=3)
            assert r["launches"] > 0 and r["mismatches"] == [], r
    rs = kb.check_rel_state(ops, eng, seeded)
    assert rs["mismatches"] == [], rs
    arenas, params, gen = eng.initialize(1, arenas, params)
    arenas, params, gen = eng.run(gen, arenas, params)
    res = evaluate_accuracy_device(cm, arenas, params, dirty, clean, query)
    assert res["f1"] > 0.9, res
