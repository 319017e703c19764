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


# ------------------------------------------- the child level fused in

AXES = (3, 4)   # test_torch_level_kernels' enumeration axes
# seeded child levels (test_torch_level_kernels' generators: score_plan's
# nested sums over dense terms, copy-mode equalities on int and FLOAT
# columns, non-enumerable observed terms and deferred AddTypos gathers)
FUSED_CASES = {
    "dense": dict(depth=1, kinds=["dense"], nest=2),
    "eq int": dict(depth=1, kinds=["eq"], statics=[None, 1]),
    "eq float": dict(depth=2, kinds=["eq"], statics=[None, 1],
                     floats=[True]),
    "sel": dict(depth=1, kinds=["sel"], statics=[None, 0, 2]),
    "gathers": dict(depth=1, kinds=["dense"], gathers=11),
    "mixed": dict(depth=2, kinds=["dense", "eq", "sel"],
                  statics=[None, 1, 2], floats=[False, True], gathers=3,
                  nest=3),
}


def _seeded_level(case, seed, depth=None, dev="cpu"):
    """A one-row child level of FUSED_CASES[case] at `depth` (the case's
    own by default), rank 1 + depth over (1,) + AXES[:depth]: (ops.Level,
    the parent's eager value of it)."""
    from test_torch_level_kernels import _gathers, _plan, _to

    c = FUSED_CASES[case]
    depth = c["depth"] if depth is None else depth
    rng = np.random.default_rng(seed)
    rank = 1 + depth
    ops_, terms = [], []
    code, total = _plan(rng, 1, rank, c.get("nest", 1), c["kinds"],
                        c.get("statics", [None]), c.get("floats", [False]),
                        ops_, terms)
    if c.get("gathers") and depth > 0:
        total = _gathers(rng, rank, c["gathers"], ops_, code, total)
    return ops.Level(ops.level_program(code), _to(ops_, dev), rank,
                     "test"), total


def _fused_args(kernel, case, seed, dev="cpu"):
    """A fused call's arguments: K13 (enum, children, full, obs_ld, obs,
    state) with its rows in states 0, 1, 2 in turn; K12 (refcount, alive,
    total, nrows, s, d, ch_e, ch_n, full) with ch_n a level of the same
    kinds one depth up. The record's rows are (1,) + AXES[:depth - 1],
    its options or slots AXES[depth - 1]."""
    lv, _want = _seeded_level(case, seed, dev=dev)
    depth = lv.rank - 1
    full, K = (1,) + AXES[:depth - 1], AXES[depth - 1]
    if kernel == "choice":
        inp = _choice_inputs(seed, K, full)
        en, _ch, full, ld, ov, st = _choice_torch(inp, dev)
        if full[1:]:   # a state per enumeration row
            st = (torch.arange(int(np.prod(full))) % 3).to(
                torch.int8).reshape(full).to(dev)
        return en, lv, full, ld, ov, st
    inp = _fk_inputs(seed, K, full)
    args = list(_fk_torch(inp, dev))
    ch_n, _w = _seeded_level("sel" if depth == 1 else case, seed + 7,
                             depth=depth - 1, dev=dev)
    args[6], args[7] = lv, ch_n
    return tuple(args)


def _pair(kernel, args):
    """The parent's pair: K20's plain version of each child level, then
    the score kernel's plain version on the sums."""
    sums = [ops.level_sum_plain(x.prog, x.operands, x.rank)
            if isinstance(x, ops.Level) else x for x in args]
    return (ops.choice_score_plain if kernel == "choice"
            else ops.fk_score_plain)(*sums)


@pytest.mark.parametrize("kernel", ["choice", "fk"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_plain_is_the_parents_pair(kernel, case):
    """The fused plain versions (the level summed by level_value, then the
    score arithmetic) bit-equal to the parent's K20-then-K12/K13 pair on
    seeded levels of every operand kind; the level's sum bit-equal to the
    parent's eager expression; on the CPU the wrapper is the plain
    version and launches nothing."""
    for seed in range(2):
        args = _fused_args(kernel, case, seed)
        lv, want = _seeded_level(case, seed)
        assert torch.equal(ops.level_value(lv), want)
        r0, z0 = _pair(kernel, args)
        plain = ops.choice_score_plain if kernel == "choice" \
            else ops.fk_score_plain
        r1, z1 = plain(*args)
        assert torch.equal(r1, r0) and torch.equal(z1, z0)
        before = dict(ops.LAUNCHES)
        r2, z2 = (ops.choice_score if kernel == "choice"
                  else ops.fk_score)(*args)
        assert ops.LAUNCHES == before
        assert torch.equal(r2, r0) and torch.equal(z2, z0)


def _f32(bits):
    import struct
    return np.float32(struct.unpack("<f", struct.pack("<i", bits))[0])


def _read_k13(words):
    """csrc/choice_score.cu written out in Python over its plan: each
    row's state, observation and offsets from the head, each option's
    logit and the child level evaluated at (r, v) as the kernel evaluates
    it, one float32 add. Returns the record [R, V]."""
    from test_torch_level_kernels import _ld, read_level_at

    h, lv = words[:ops.K13_HEAD], words[ops.K13_HEAD:]
    en, ld, obs, obs_dt, state, code, V, nd, _rec, _logz, R = h[:11]
    es, sizes = h[15], h[16:16 + nd]
    assert lv[0] == R * V

    def off(first, r):
        o = 0
        for i in range(nd - 1, -1, -1):
            o += (r % sizes[i]) * h[first + i]
            r //= sizes[i]
        return o

    out = np.empty((R, V), np.float32)
    for r in range(R):
        c = int(_ld(state, 1, off(48, r))) if state else code
        seen = obs != 0 and c == 1
        for v in range(V):
            if seen:
                ov = int(_ld(obs, obs_dt, off(40, r)))
                lg = _ld(ld, 6, off(32, r)) if v == ov else np.float32(NINF)
            else:
                lg = _ld(en, 6, off(24, r) + v * es)
            out[r, v] = np.float32(lg + read_level_at(lv, r * V + v))
    return out


def _read_k12(words):
    """csrc/fk_score.cu written out in Python over its plan: the prior of
    each slot and the fresh row (torch's float32 log, as the plain version
    on the CPU), ch_e evaluated at (r, k), ch_n at r, one float32 add
    each. Returns the record [R, K + 1]."""
    from test_torch_level_kernels import _ld, read_level_at

    h = words[:ops.K12_HEAD]
    refc, alive, K, tot, tdt, nr, ndt, sp, sb, dp, db = h[:11]
    R, nl = h[13], h[18]
    lve, lvn = words[ops.K12_HEAD:nl], words[nl:]
    assert lve[0] == R * K and lvn[0] == R
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    s = _ld(sp, 6, 0) if sp else _f32(sb)
    d = _ld(dp, 6, 0) if dp else _f32(db)
    logden = torch.log(f32(np.float32(_ld(tot, tdt, 0))) + f32(s))
    out = np.empty((R, K + 1), np.float32)
    for r in range(R):
        fresh = torch.log(f32(d) * f32(np.float32(_ld(nr, ndt, 0)))
                          + f32(s)) - logden
        out[r, K] = np.float32(fresh.item() + read_level_at(lvn, r))
        for k in range(K):
            cnt = int(_ld(refc, 4, k))
            if _ld(alive, 0, k) and cnt > 0:
                ex = (torch.log(torch.clamp(f32(np.float32(cnt)) - f32(d),
                                            min=1e-30)) - logden).item()
            else:
                ex = NINF
            out[r, k] = np.float32(np.float32(ex)
                                   + read_level_at(lve, r * K + k))
    return out


@pytest.mark.parametrize("kernel", ["choice", "fk"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_plan_read_as_the_kernel_reads_it(kernel, case):
    """K12's and K13's words (the head, then each level over the record's
    shape, an element a thread), read word by word as the kernels read
    them through the CPU tensors' addresses: the record bit-equal to the
    parent's pair."""
    args = _fused_args(kernel, case, 3)
    want, _z = _pair(kernel, args)
    if kernel == "choice":
        en, lv, full, ld, ov, st = args
        R, V = int(np.prod(full)), en.shape[-1]
        rec, logz = torch.empty(R, V), torch.empty(R)
        plan = ops.choice_score_plan(R, V, ops.score_spread(R))
        words = ops.choice_score_words(en, lv, full, ld, ov, st, rec, logz,
                                       plan, card=False)
        assert len(words) <= ops.K13_WORDS
        got = _read_k13(words)
    else:
        *head, ch_e, ch_n, full = args
        R, K = int(np.prod(full)), head[0].shape[-1]
        rec, logz = torch.empty(R, K + 1), torch.empty(R)
        plan = ops.fk_score_plan(R, K, ops.score_spread(R))
        words = ops.fk_score_words(*head, ch_e, ch_n, full, rec, logz, plan,
                                   card=False)
        assert len(words) <= ops.K12_WORDS
        got = _read_k12(words)
    np.testing.assert_array_equal(got, want.numpy())


def _wide_level(rng, rank, n_ops=64):
    """A level at the edge of one K20 launch: n_ops copy-mode equalities
    with static states (two references each: 128 with 64), a program of
    ~360 steps; its words are ~2,060, so two do not fit K12's block."""
    shape = (1,) + AXES[:rank - 1]
    operands = [ops.level_eq(
        torch.as_tensor(rng.integers(0, 3, shape).astype(np.int32)),
        torch.as_tensor(rng.integers(0, 3, (1,) * rank)), 1, False)
        for _ in range(n_ops)]
    Z, O, A = ops.LEVEL_ZERO, ops.LEVEL_ADDOP, ops.LEVEL_ADD
    prog = [(Z, 0)] + [(O, i) for i in range(n_ops)] + [(Z, 0), (A, 0)] * 150
    return ops.Level(prog, operands, rank, "wide")


def test_fused_levels_past_one_launch_split_bit_equal():
    """A one-row level past one K20 launch: its earlier stages summed by
    K20 (level_stages), the last fused; a ch_e/ch_n pair too large for
    one parameter block with K12's head: ch_n summed by K20 first, as one
    dense term. Each bit-equal to the parent's sum, and each counted as a
    split of the score kernel (score_fusion)."""
    from pclean_tpu_torch import kernel_bench as kb

    rng = np.random.default_rng(5)
    prog, operands = kb.split_level(rng, n_ops=100, depth=40, B=1,
                                    V=AXES[0])
    lv = ops.Level(prog, operands, 2, "staged")
    n = len(ops.level_stages(prog, operands))
    assert n > 1 and ops.score_fusion([lv])["stages"] == [n - 1]
    last = ops._fuse_prepare(lv, 2)   # its K20 stages: plain on the CPU
    assert len(ops.level_stages(last.prog, last.operands)) == 1
    assert torch.equal(ops.level_value(last), ops.level_value(lv))
    en = torch.as_tensor(rng.normal(size=(1, AXES[0])).astype(np.float32))
    r0, z0 = ops.choice_score_plain(en, ops.level_value(lv), (1,))
    rec, logz = torch.empty(1, AXES[0]), torch.empty(1)
    words = ops.choice_score_words(
        en, last, (1,), None, None, 0, rec, logz,
        ops.choice_score_plan(1, AXES[0], True), card=False)
    np.testing.assert_array_equal(_read_k13(words), r0.numpy())
    assert torch.equal(ops.choice_score(en, lv, (1,))[0], r0)
    # the pair
    ch_e, ch_n = _wide_level(rng, 2), _wide_level(rng, 1)
    inp = _fk_inputs(6, AXES[0], (1,))
    head = list(_fk_torch(inp))[:6]
    fus = ops.score_fusion([ch_e, ch_n])
    assert fus["n_first"] and fus["stages"] == [0, 1]
    assert fus["words"] <= ops.K12_WORDS
    assert ops.K12_HEAD + sum(len(ops.level_plan(
        x.prog, x.operands, x.rank, card=False)[0]) for x in (ch_e, ch_n)) \
        > ops.K12_WORDS
    n1 = ops._fuse_prepare(ch_n, 1, whole=True)
    assert len(n1.operands) == 1 and n1.operands[0]["kind"] == "dense"
    assert torch.equal(ops.level_value(n1), ops.level_value(ch_n))
    r0, _z = _pair("fk", head + [ch_e, ch_n, (1,)])
    rec, logz = torch.empty(1, AXES[0] + 1), torch.empty(1)
    words = ops.fk_score_words(*head, ch_e, n1, (1,), rec, logz,
                               ops.fk_score_plan(1, AXES[0]), card=False)
    assert len(words) == fus["words"]
    np.testing.assert_array_equal(_read_k12(words), r0.numpy())
    with pytest.raises(ValueError):   # both levels: past the block
        ops.fk_score_words(*head, ch_e, ch_n, (1,), rec, logz,
                           ops.fk_score_plan(1, AXES[0]), card=False)
    assert torch.equal(ops.fk_score(*head, ch_e, ch_n, (1,))[0], r0)


@pytest.mark.parametrize("K", [2, 8, 23, 512, 1472, 7735, 11264])
def test_fused_geometry_follows_the_level(K):
    """Which geometry a fused level gets: at one row a thread a slot
    (score_spread), in a block of up to 1,024, a cluster of up to 8 such
    blocks a row past that, grid (cluster, R); over more rows K1's
    plan."""
    for R in (1, 3, 4096):
        assert ops.score_spread(R) == (R == 1)
        for plan_fn, mode in ((ops.fk_score_plan, "fk"),
                              (ops.choice_score_plan, "choice")):
            k1 = ops.enum_logsumexp_plan(R, K, mode)
            if k1["path"] == "split":
                k1 = ops.enum_logsumexp_plan(R, K, mode, path="block")
            assert plan_fn(R, K, False) == k1
            p = plan_fn(R, K, True)
            threads = min(1024, 32 * -(-K // 32))
            assert p == dict(path="slots", threads=threads, rows=1,
                             cluster=min(8, -(-K // threads)),
                             grid=(min(8, -(-K // threads)), R))
            assert p["threads"] * p["cluster"] >= min(K, 8192)


def test_tracer_hands_one_row_levels_to_k12_k13():
    """At one row every K12/K13 child that is not a constant is an
    ops.Level (no K20 of its own); over B rows the tracer sums the same
    levels by K20 and launches K1/K21 as before. Hospital's Record block
    on the CPU (the plain versions)."""
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.workloads import hospital

    cm, cfg = hospital.setup(rows=60, batch=16, device="cpu")[:2]
    eng = Engine(cm, cfg, device="cpu")
    arenas, params = init_state(cm, 0, device="cpu")
    rel = refresh(cm, arenas, eng.obs_dev)
    seen = {"level_sum": [], "fk_score": [], "choice_score": []}

    def spy(name):
        real = getattr(ops, name)

        def call(*a, **kw):
            seen[name].append(a)
            return real(*a, **kw)
        return call

    from unittest import mock
    with mock.patch.object(ops, "level_sum", spy("level_sum")), \
            mock.patch.object(ops, "fk_score", spy("fk_score")), \
            mock.patch.object(ops, "choice_score", spy("choice_score")):
        eng._propose("Record", arenas, rel, params, torch.arange(1),
                     torch.Generator().manual_seed(1), False)
        one = {k: list(v) for k, v in seen.items()}
        for v in seen.values():
            v.clear()
        eng._propose("Record", arenas, rel, params, torch.arange(4),
                     torch.Generator().manual_seed(1), False)
    children = [a[1] for a in one["choice_score"]] + \
        [x for a in one["fk_score"] for x in a[6:8]]
    assert one["fk_score"] and one["choice_score"]
    for x in children:
        assert isinstance(x, ops.Level) or (x.numel() == 1
                                            and float(x) == 0.0)
    # the parent's 28 one-row K20 launches: 26 fed these 6 K12 and 14 K13
    assert (len(one["fk_score"]), len(one["choice_score"])) == (6, 14)
    assert sum(isinstance(x, ops.Level) for x in children) == 26
    # the one-row K20 launches left: the root level of each of the
    # Record class's two blocks
    assert len(one["level_sum"]) == 2
    assert all(a[2] == 1 for a in one["level_sum"])
    assert not seen["fk_score"] and not seen["choice_score"]
    assert seen["level_sum"]


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
@pytest.mark.parametrize("path", [None, "warp", "block", "slots"])
@pytest.mark.parametrize("kernel", ["choice", "fk"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_cuda_matches_plain(card, case, kernel, path):
    """The fused K12 and K13 (the child levels summed in the launch) on
    every geometry against the parent's pair on the card (K20's plain
    version, then the score kernel's): record bit-equal, logZ within K1's
    rule; one launch, no K20."""
    from pclean_tpu_torch import kernel_bench as kb

    name = "choice_score" if kernel == "choice" else "fk_score"
    for seed in range(2):
        args = _fused_args(kernel, case, seed, dev=card)
        before = dict(ops.LAUNCHES)
        r1, z1 = kb._score_fns(ops, name, path)[0](*args)
        assert ops.LAUNCHES[name] == before[name] + 1
        assert ops.LAUNCHES["level_sum"] == before["level_sum"]
        r0, z0 = _pair(kernel, args)
        _check(r0, z0, r1, z1)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(23, 1), (512, 11), (1472, 1), (3000, 3),
                                 (11264, 3)])
@pytest.mark.parametrize("name", ["fk_score", "choice_score"])
def test_fused_cuda_gather_levels(card, name, K, n):
    """Heavy one-row levels (n deferred gathers over [1, K], as the
    hospital and scaled paths make them) on the slots path, a cluster a
    row past 1,024 slots, and on K1's plan: bit-equal to the pair the
    parent launched (K20, then the score kernel on its sum)."""
    from pclean_tpu_torch import kernel_bench as kb

    inp = kb.score_ab_inputs(card, name, K, n, 1133)
    plan = getattr(ops, name + "_plan")(1, K, True)
    assert plan["path"] == "slots" and plan["cluster"] == min(8, -(-K // 1024))
    for path in (None, "block"):
        lvs = [ops.Level(ops.level_program(p), o, r, "t")
               for p, o, r in inp["levels"]]
        r1, z1 = kb._score_fns(ops, name, path)[0](*inp["head"], *lvs,
                                                    *inp["tail"])
        r0, z0 = kb.score_ab_call(ops, inp, fused=False)()
        _check(r0, z0, r1, z1)


@pytest.mark.cuda
def test_fused_cuda_splits_bit_equal(card):
    """A level past one launch (its earlier stages by K20, the last
    fused) and a ch_e/ch_n pair past K12's parameter block (ch_n by K20
    first), on the card: bit-equal to the plain versions, the K20 launches
    and the splits counted."""
    from pclean_tpu_torch import kernel_bench as kb
    from test_torch_level_kernels import _to

    rng = np.random.default_rng(5)
    prog, operands = kb.split_level(rng, n_ops=100, depth=40, B=1,
                                    V=AXES[0])
    lv = ops.Level(prog, _to(operands, card), 2, "staged")
    n = len(ops.level_stages(prog, operands))
    en = torch.as_tensor(rng.normal(size=(1, AXES[0])).astype(np.float32),
                         device=card)
    before, split = dict(ops.LAUNCHES), ops.SPLITS.get("choice_score", 0)
    r1, z1 = ops.choice_score(en, lv, (1,))
    assert ops.LAUNCHES["level_sum"] - before["level_sum"] == n - 1
    assert ops.SPLITS["choice_score"] == split + 1
    _check(*ops.choice_score_plain(en, lv, (1,)), r1, z1)
    ch_e, ch_n = (_wide_level(rng, 2), _wide_level(rng, 1))
    ch_e = ops.Level(ch_e.prog, _to(ch_e.operands, card), 2, "wide")
    ch_n = ops.Level(ch_n.prog, _to(ch_n.operands, card), 1, "wide")
    head = list(_fk_torch(_fk_inputs(6, AXES[0], (1,)), card))[:6]
    before, split = dict(ops.LAUNCHES), ops.SPLITS.get("fk_score", 0)
    r1, z1 = ops.fk_score(*head, ch_e, ch_n, (1,))
    assert ops.LAUNCHES["level_sum"] - before["level_sum"] == 1
    assert ops.SPLITS["fk_score"] == split + 1
    _check(*ops.fk_score_plain(*head, ch_e, ch_n, (1,)), r1, z1)


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
