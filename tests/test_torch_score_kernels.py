"""The one-row score kernels K12 fk_score and K13 choice_score.

CPU: the plain versions against the port's tracer composition they
replace (BlockTracer.py_logprobs, score_fk's adds and concat,
score_choice's delta and adds, enum_logsumexp_plain: the same torch ops,
so bit-equal) and against pclean_tpu's arithmetic (its BlockTracer.
py_logprobs, score_fk's concat and score_choice's delta, with
pclean_tpu.utils.logsumexp) on numpy-seeded inputs: record and logZ
within rtol 1e-5, atol 1e-5, the score pass's tolerance (two libraries'
log and their sums in another order), NEG_INF entries exactly. Edges:
every candidate dead, NEG_INF children, K = 1 and V = 2, per-row states 0,
1 and 2 and a static state, children broadcast over the enumeration rows,
a class with and without params["__py__"] (device scalars against the
class's constants), per-row relational leaves [1, K]. Then one-row blocks
of the scaled CPU config and the toy models through the port's
BlockTracer (K12/K13's plain versions) against pclean_tpu's tracer on a
shared state with its uniform pool (tests/test_torch_propose.py's Pair):
records and logZ within that tolerance, sampled values and births equal.
K12's and K13's plans are K1's at the same shape (the split path taken as
K1's block path).

The JAX package is imported inside the CPU tests only, so the module also
loads on the card's machine, which has no JAX. Card (`cuda` marker;
`python -m pytest -m cuda tests/test_torch_score_kernels.py` on the H100): the kernels against the
plain versions on the card at the paths' shapes and the edges: record
bit-equal (the same float operations, one rounding each), logZ within K1's
rule (1e-6 of the larger of |logZ| and the row's |max|: the same f32
formula summed in another order).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.engine import propose as tprop
from pclean_tpu_torch.utils import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-5)
NINF = float(NEG_INF)


def _fk_inputs(seed, K, full, dead=0.3, ninf_children=0.0, per_row=False,
               py=True, bcast=False):
    """numpy-seeded K12 inputs: refcounts 0-5 (a share `dead` of the slots
    dead), children [full..., K] (or [1, 1.., K] broadcast), new_children
    [full...], total and nrows int64 scalars (or [1] per-row leaves),
    strength and discount (float32 scalars, or the class's floats)."""
    rng = np.random.default_rng(seed)
    refc = rng.integers(0, 6, K).astype(np.int32)
    alive = rng.random(K) >= dead
    ch_shape = ((1,) * len(full) + (K,)) if bcast else tuple(full) + (K,)
    ch = rng.normal(0.0, 2.0, ch_shape).astype(np.float32)
    ch[rng.random(ch_shape) < ninf_children] = NINF
    nch = rng.normal(0.0, 2.0, tuple(full)).astype(np.float32)
    total = np.int64(refc[alive].sum())
    nrows = np.int64(alive.sum())
    s, d = np.float32(rng.uniform(0.5, 3.0)), np.float32(rng.uniform(0, 0.6))
    out = dict(refcount=refc, alive=alive, total=total, nrows=nrows,
               children=ch, new_children=nch, full=tuple(full),
               strength=s, discount=d, py=py, per_row=per_row)
    return out


def _t(x, dev="cpu"):
    return torch.as_tensor(np.asarray(x), device=dev)


def _fk_torch(inp, dev="cpu"):
    rc, al = _t(inp["refcount"], dev), _t(inp["alive"], dev)
    tot, nr = _t(inp["total"], dev), _t(inp["nrows"], dev)
    if inp["per_row"]:
        rc, al, tot, nr = rc[None], al[None], tot.reshape(1), nr.reshape(1)
    if inp["py"]:
        s, d = _t(inp["strength"], dev), _t(inp["discount"], dev)
    else:
        s, d = float(inp["strength"]), float(inp["discount"])
    return (rc, al, tot, nr, s, d, _t(inp["children"], dev),
            _t(inp["new_children"], dev), inp["full"])


class _FakeCM:
    """What BlockTracer.py_logprobs reads of a compiled model."""

    def __init__(self, s, d):
        self._c = SimpleNamespace(py_strength=s, py_discount=d)

    def cls(self, tc):
        return self._c

    def const(self, v, dtype=None):
        return torch.tensor(v, dtype=dtype)


def _port_composition(inp):
    """score_fk's arithmetic as the port's tracer composed it before K12:
    py_logprobs, the adds, the concat and enum_logsumexp_plain."""
    rc, al, tot, nr, s, d, ch, nch, full = _fk_torch(inp)
    rel = {"T": {"refcount": rc, "alive": al, "total": tot, "nrows": nr}}
    params = {"__py__": {"T": {"strength": s, "discount": d}}} \
        if inp["py"] else {}
    tr = SimpleNamespace(cm=_FakeCM(float(inp["strength"]),
                                    float(inp["discount"])),
                         rel=rel, params=params)
    tr._py_sd = lambda tc: tprop.BlockTracer._py_sd(tr, tc)
    ex, new = tprop.BlockTracer.py_logprobs(tr, "T")
    K, depth = rc.shape[-1], len(full) - 1
    ex = ex.reshape((-1,) + (1,) * depth + (K,)) + ch
    new = new.reshape(-1)
    new = new.reshape((new.shape[0],) + (1,) * depth) + nch
    return ops.enum_logsumexp_plain(
        ex.expand(full + (K,)).reshape(-1, K).contiguous(),
        new.expand(full).reshape(-1).contiguous())


def _jax_reference(inp):
    """pclean_tpu's py_logprobs (its BlockTracer method on the same state)
    and score_fk's concat + logsumexp."""
    import jax.numpy as jnp
    from pclean_tpu.engine import propose as jprop
    from pclean_tpu.utils import logsumexp as jlogsumexp

    rel = {"T": {"refcount": jnp.asarray(inp["refcount"]),
                 "alive": jnp.asarray(inp["alive"]),
                 "total": jnp.asarray(inp["total"]),
                 "nrows": jnp.asarray(inp["nrows"])}}
    params = {"__py__": {"T": {"strength": jnp.asarray(inp["strength"]),
                               "discount": jnp.asarray(inp["discount"])}}} \
        if inp["py"] else {}
    cm = SimpleNamespace(cls=lambda tc: SimpleNamespace(
        py_strength=float(inp["strength"]),
        py_discount=float(inp["discount"])))
    ex, new = jprop.BlockTracer.py_logprobs(
        SimpleNamespace(cm=cm, rel=rel, params=params), "T")
    full, K = inp["full"], len(inp["refcount"])
    exist = jnp.broadcast_to(ex + jnp.asarray(inp["children"]), full + (K,))
    new = jnp.broadcast_to(new + jnp.asarray(inp["new_children"]), full)
    rec = jnp.concatenate([exist, new[..., None]], -1).reshape(-1, K + 1)
    return np.asarray(rec), np.asarray(jlogsumexp(rec, axis=-1))


FK_CASES = {
    "one row": dict(K=40, full=(1,)),
    "rows": dict(K=70, full=(1, 3, 2)),
    "all dead": dict(K=24, full=(1, 2), dead=1.0),
    "ninf children": dict(K=33, full=(1, 2), ninf_children=0.5),
    "all ninf": dict(K=9, full=(1,), dead=1.0, ninf_children=1.0),
    "K = 1": dict(K=1, full=(1,)),
    "broadcast": dict(K=50, full=(1, 4), bcast=True),
    "no __py__": dict(K=30, full=(1, 2), py=False),
    "per-row leaves": dict(K=30, full=(1,), per_row=True),
}


@pytest.mark.parametrize("case", list(FK_CASES))
def test_fk_score_plain_matches_tracer_and_jax(case):
    kw = dict(FK_CASES[case])
    inp = _fk_inputs(11, kw.pop("K"), kw.pop("full"), **kw)
    rec, logz = ops.fk_score_plain(*_fk_torch(inp))
    r0, z0 = _port_composition(inp)
    assert torch.equal(rec, r0) and torch.equal(logz, z0)
    rj, zj = _jax_reference(inp)
    np.testing.assert_allclose(rec.numpy(), rj, **TOL)
    np.testing.assert_array_equal(rec.numpy() == NINF, rj == NINF)
    np.testing.assert_allclose(logz.numpy(), zj, **TOL)
    # through the wrapper on CPU tensors: the plain version
    r2, z2 = ops.fk_score(*_fk_torch(inp))
    assert torch.equal(r2, rec) and torch.equal(z2, logz)


def _choice_inputs(seed, V, full, state="rows", bcast=False, obs=True,
                   ninf_children=0.0, obs_dtype=np.int32):
    """numpy-seeded K13 inputs over the enumeration rows `full` (batch axis
    first, B = 1): enum [.., V] (or broadcast over the rows), children,
    obs_ld over the rows, the observed code (some out of range) and the
    state: per row ("rows": 0, 1 or 2 along the batch axis, a tensor
    aligned like obs) or a static code."""
    rng = np.random.default_rng(seed)
    depth = len(full) - 1
    en_shape = (1,) * len(full) + (V,) if bcast else tuple(full) + (V,)
    en = rng.normal(0.0, 2.0, en_shape).astype(np.float32)
    ch = rng.normal(0.0, 1.0, tuple(full) + (V,)).astype(np.float32)
    ch[rng.random(ch.shape) < ninf_children] = NINF
    ld = rng.normal(-2.0, 1.0, tuple(full)).astype(np.float32)
    ov = np.full((full[0],) + (1,) * depth, rng.integers(0, V + 1),
                 dtype=obs_dtype)
    st = state
    if state == "rows":
        st = np.full((full[0],) + (1,) * depth, seed % 3, dtype=np.int8)
    return dict(enum=en, children=ch, obs_ld=ld if obs else None,
                obs=ov if obs else None, state=st if obs else 0,
                full=tuple(full))


def _choice_torch(inp, dev="cpu"):
    st = inp["state"]
    return (_t(inp["enum"], dev), _t(inp["children"], dev), inp["full"],
            None if inp["obs_ld"] is None else _t(inp["obs_ld"], dev),
            None if inp["obs"] is None else _t(inp["obs"], dev),
            _t(st, dev) if isinstance(st, np.ndarray) else st)


def _choice_composition(inp):
    """score_choice's arithmetic as the port's tracer composed it before
    K13 (the B > 1 path keeps it)."""
    en, ch, full, ld, ov, st = _choice_torch(inp)
    V = en.shape[-1]
    if ov is not None:
        delta = torch.where(torch.arange(V) == ov[..., None], ld[..., None],
                            torch.tensor(NINF))
        st1 = (st == 1) if torch.is_tensor(st) else \
            torch.tensor(st == 1).reshape((1,) * len(full))
        logits = torch.where(st1[..., None], delta, en)
    else:
        logits = en
    total = (logits + ch).expand(full + (V,))
    return ops.enum_logsumexp_plain(total.reshape(-1, V).contiguous())


def _choice_jax(inp):
    import jax.numpy as jnp
    from pclean_tpu.utils import logsumexp as jlogsumexp

    full, V = inp["full"], inp["enum"].shape[-1]
    en = jnp.broadcast_to(jnp.asarray(inp["enum"]), full + (V,))
    if inp["obs"] is not None:
        ov = jnp.asarray(inp["obs"])
        delta = jnp.where(jnp.arange(V) == ov[..., None],
                          jnp.asarray(inp["obs_ld"])[..., None], NINF)
        st = inp["state"]
        st = jnp.asarray(st)[..., None] if isinstance(st, np.ndarray) \
            else st
        logits = jnp.where(st == 1, delta, en)
    else:
        logits = en
    total = (logits + jnp.asarray(inp["children"])).reshape(-1, V)
    return np.asarray(total), np.asarray(jlogsumexp(total, axis=-1))


CHOICE_CASES = {
    "state 0": dict(seed=0, V=5, full=(1,)),
    "state 1": dict(seed=1, V=5, full=(1, 3)),
    "state 2": dict(seed=2, V=7, full=(1, 2)),
    "static observed": dict(seed=4, V=6, full=(1, 2), state=1),
    "no observation": dict(seed=5, V=6, full=(1, 3), obs=False),
    "V = 2": dict(seed=7, V=2, full=(1,)),
    "broadcast enum": dict(seed=10, V=9, full=(1, 4), bcast=True),
    "ninf children": dict(seed=13, V=8, full=(1, 2), ninf_children=0.5),
    "int64 obs": dict(seed=16, V=12, full=(1, 2, 3), obs_dtype=np.int64),
}


@pytest.mark.parametrize("case", list(CHOICE_CASES))
def test_choice_score_plain_matches_tracer_and_jax(case):
    kw = dict(CHOICE_CASES[case])
    inp = _choice_inputs(kw.pop("seed"), kw.pop("V"), kw.pop("full"), **kw)
    rec, logz = ops.choice_score_plain(*_choice_torch(inp))
    r0, z0 = _choice_composition(inp)
    assert torch.equal(rec, r0) and torch.equal(logz, z0)
    rj, zj = _choice_jax(inp)
    np.testing.assert_allclose(rec.numpy(), rj, **TOL)
    np.testing.assert_allclose(logz.numpy(), zj, **TOL)
    r2, z2 = ops.choice_score(*_choice_torch(inp))
    assert torch.equal(r2, rec) and torch.equal(z2, logz)


@pytest.mark.parametrize("R,K", [(1, 1), (1, 138), (1, 512), (1, 513),
                                 (3, 1472), (1, 11264), (8, 11264),
                                 (9, 11264), (70, 40)])
def test_score_plans_are_k1s(R, K):
    """K12's and K13's geometry is K1's at the same shape; where K1 splits
    a row over a cluster, K1's block path; legal on the H100: a warp a row
    with rows * 32 threads, or a block a row of up to 16 warps."""
    for plan, mode in ((ops.fk_score_plan(R, K), "fk"),
                       (ops.choice_score_plan(R, K), "choice")):
        k1 = ops.enum_logsumexp_plan(R, K, mode)
        if k1["path"] == "split":
            k1 = ops.enum_logsumexp_plan(R, K, mode, path="block")
        assert plan == k1
        assert plan["path"] in ("warp", "block") and plan["cluster"] == 1
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 512
        assert plan["grid"][0] * plan["rows"] >= R
        if plan["rows"] > 1:
            assert plan["threads"] == 32 * plan["rows"]


def _one_row_pair(which):
    from test_torch_host import JNS, TNS, chain, composed, scaled_pair, tiny
    from test_torch_propose import Pair
    from pclean_tpu.engine import smc as jsmc
    from pclean_tpu_torch.engine import smc as tsmc

    if which == "scaled":
        (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = scaled_pair()
    else:
        build = {"tiny": tiny, "chain": chain, "composed": composed}[which]
        (cm_j, _qj), (cm_t, _qt) = build(JNS), build(TNS)
        cfg_j = jsmc.InferenceConfig(batch_rows=4)
        cfg_t = tsmc.InferenceConfig(batch_rows=4)
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


@pytest.mark.parametrize("which,blocks", [
    ("scaled", [("Record", 0), ("Hospital", 0)]),
    ("chain", [("Record", 0), ("Hospital", 0)]),
    ("composed", [("Record", 0), ("County", 0)]),
    ("tiny", [("Row", 0), ("Obj", 0)])])
def test_one_row_blocks_through_k12_k13_match_jax(which, blocks):
    """One-row blocks (B = 1: every fk through K12, every enumerable
    choice through K13) against pclean_tpu's tracer, one slot at a time,
    with its uniform pool: logZ and records within TOL, samples and births
    equal (Pair.block's checks)."""
    import jax

    pair = _one_row_pair(which)
    before = dict(ops.LAUNCHES)
    for cid, plan_idx in blocks:
        cap = pair.cm_t.layouts[cid].capacity
        for i, slot in enumerate(np.linspace(0, cap - 1, 2).astype(int)):
            keys = jax.random.split(jax.random.PRNGKey(31 + i), 1)
            pair.block(cid, plan_idx, np.array([slot]), keys)
    # the plain versions ran (CPU tensors): nothing launched
    assert ops.LAUNCHES == before


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


def _check(rec0, z0, rec1, z1):
    """Record bit-equal, logZ within K1's rule."""
    torch.cuda.synchronize()
    assert torch.equal(rec0, rec1)
    d = (z1 - z0).abs()
    scale = torch.maximum(z0.abs(), rec0.amax(-1).abs())
    assert bool(((d <= 1e-6 * scale) | (z1 == z0)).all()), float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FK_CASES) + ["hospital", "scaled",
                                                   "scaled rows", "int32"])
def test_k12_cuda_matches_plain(card, case):
    kw = dict(FK_CASES.get(case, {}))
    if case == "hospital":
        kw = dict(K=1832, full=(1,))
    elif case == "scaled":
        kw = dict(K=11264, full=(1,))
    elif case == "scaled rows":
        kw = dict(K=11264, full=(1, 3), bcast=True)
    elif case == "int32":
        kw = dict(K=300, full=(1, 2))
    inp = _fk_inputs(23, kw.pop("K"), kw.pop("full"), **kw)
    args = list(_fk_torch(inp, card))
    if case == "int32":
        args[2], args[3] = args[2].to(torch.int32), args[3].to(torch.int32)
    before = ops.LAUNCHES["fk_score"]
    r0, z0 = ops.fk_score_plain(*args)
    r1, z1 = ops.fk_score(*args)
    assert ops.LAUNCHES["fk_score"] == before + 1
    _check(r0, z0, r1, z1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CHOICE_CASES) + ["V = 341"])
def test_k13_cuda_matches_plain(card, case):
    kw = dict(CHOICE_CASES.get(case, dict(seed=3, V=341, full=(1, 2))))
    inp = _choice_inputs(kw.pop("seed"), kw.pop("V"), kw.pop("full"), **kw)
    args = _choice_torch(inp, card)
    before = ops.LAUNCHES["choice_score"]
    r0, z0 = ops.choice_score_plain(*args)
    r1, z1 = ops.choice_score(*args)
    assert ops.LAUNCHES["choice_score"] == before + 1
    _check(r0, z0, r1, z1)


@pytest.mark.cuda
def test_k12_k13_refuse_what_they_do_not_take(card):
    inp = _fk_inputs(1, 16, (1,))
    args = list(_fk_torch(inp, card))
    args[0] = args[0].to(torch.int64)
    with pytest.raises(ValueError):
        ops.fk_score(*args)
    args = list(_fk_torch(inp, card))
    with pytest.raises(ValueError):
        ops.fk_score(*args[:8], (1,) * 9)
    c = _choice_inputs(1, 4, (1,))
    en, ch, full, ld, ov, st = _choice_torch(c, card)
    with pytest.raises(ValueError):
        ops.choice_score(en, ch, full, ld, ov, st.to(torch.int32))


@pytest.mark.parametrize("R,V,state", [(1, 23, "rows"), (4096, 2, "rows"),
                                       (5, 7, 1), (5, 7, "static"),
                                       (1, 5, 1)])
def test_k13_bench_inputs_read_both_branches(R, V, state):
    """kernel_bench's K13 inputs, which the card's census check and timing
    use: with "rows" the enumeration rows take states 0, 1 and 2 in turn,
    so the record reads the enum logits exactly on the rows not in state 1
    (and on every row with the static code); k13_bytes counts the enum
    logits of those rows only, obs_ld of the others."""
    from pclean_tpu_torch import kernel_bench as kb

    inp = kb.k13_inputs("cpu", R, V, state=state)
    en, ch, full, ld, obs, st = inp["args"]
    if state == "rows":
        want = (torch.arange(R) % 3).reshape(full)
        assert torch.equal(st.to(torch.int64), want)
        if R >= 3:
            assert set(st.reshape(-1).tolist()) == {0, 1, 2}
    rec, _z = ops.choice_score_plain(*inp["args"])
    rec2, _z2 = ops.choice_score_plain(en + 1.0, *inp["args"][1:])
    moved = (rec2 != rec).any(-1)
    if obs is None:
        seen = torch.zeros(R, dtype=torch.bool)
    else:
        seen = (st.expand(full) == 1).reshape(-1)
    assert torch.equal(moved, ~seen)
    n_seen = int(seen.sum())
    want_bytes = (4 * R * V + 4 * (R - n_seen) * V
                  + (st.numel() if torch.is_tensor(st) else 0)
                  + (4 * n_seen + 4 if n_seen else 0) + 4 * R * V + 4 * R)
    assert kb.k13_bytes(inp) == want_bytes
