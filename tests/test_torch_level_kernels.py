"""The score pass's accumulation glue: K20 level_sum and K21 py_prior.

CPU: level_sum_plain against the parent's nested eager expression, which
each test writes out itself (score_plan's `total = zeros; total = total +
step`, a step `term + score_plan(rest)`, copy mode's and the
non-enumerable branch's where chains, _mm_flush's K3 sum added last), bit
for bit on seeded term lists of every operand kind: dense terms, copy-mode
equality on an int and on a FLOAT column, non-enumerable observed terms,
the states 0, 1 and 2 static and per row, deferred AddTypos gathers, depth
0 to 2. K20's and K21's plans, read word by word as the kernels read them
(a Python reading through the tensors' addresses: K20's merged axes,
divisors and elements a thread), against the plain versions; K20's plan
cached by the level's structure taking new tensors' pointers, word for
word a fresh plan's; the axis merging and the divisors. py_prior_plain against pclean_tpu's py_logprobs plus the
children (its BlockTracer method, the compaction's select and the adds),
within the score pass's tolerance (rtol 1e-5, atol 1e-5: two libraries'
logs), with and without compaction, with [cap] and [B, cap] leaves.
One-row and batched blocks of the scaled, flights and hospital (240-row
synth) models through the new path against pclean_tpu's tracer under its
uniform pools, as test_one_row_blocks_through_k12_k13_match_jax holds
them, with the tracer seen calling K20 and K21 (their plain versions on
the CPU).

Card (`cuda` marker; `python -m pytest -m cuda
tests/test_torch_level_kernels.py` on the H100): K20 and K21 against their
plain versions on the card, bit-equal (the same float operations, one
rounding each), at every operand kind and the paths' shapes, K20 at every
instantiation (stack depths 1-12, merged and unmerged axes); their
refusals; graphed hospital and flights rows bit-equal to their eager rows
with K20 launched inside the graph. The JAX package is imported inside the
CPU tests only.
"""
import ctypes
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.utils import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-5)
NINF = float(NEG_INF)
AXES = (3, 4)   # the enumeration axes of a seeded level at depth 1 and 2


# ------------------------------------------------------- seeded levels


def _state(rng, B, rank, static):
    """A state operand: the static code, or int8 per-row codes 0-2."""
    if static is not None:
        return static
    return torch.as_tensor(rng.integers(0, 3, (B,) + (1,) * (rank - 1))
                           .astype(np.int8))


def _dense(rng, B, rank):
    """A float32 term varying over a random subset of the level's axes."""
    full = (B,) + AXES[:rank - 1]
    shape = tuple(n if rng.random() < 0.6 else 1 for n in full)
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.1] = NINF
    return torch.as_tensor(x)


def _term(rng, kind, B, rank, static=None, is_float=False):
    """One seeded operand of `kind` and its value as the parent's eager
    code computed it (copy mode: propose.py score_step; the non-enumerable
    branch: score_choice; a static observation's log-density: dense)."""
    zero = torch.zeros(())
    st = _state(rng, B, rank, static)
    st1 = torch.full((1,) * rank, st == 1) if isinstance(st, int) \
        else st == 1
    st2 = torch.full((1,) * rank, st == 2) if isinstance(st, int) \
        else st == 2
    if kind == "dense":
        x = _dense(rng, B, rank)
        return ops.level_dense(x), x
    if kind == "eq":
        ova_shape = (B,) + (1,) * (rank - 1)
        full = (B,) + AXES[:rank - 1]
        if is_float:
            ova = torch.as_tensor(rng.normal(0, 50, ova_shape)
                                  .astype(np.float32))
            jit = rng.choice([0.0, 1e-7, 1e-3], full).astype(np.float32)
            val = ova + torch.as_tensor(jit) * torch.clamp(ova.abs(),
                                                           min=1.0)
            eq = torch.abs(val - ova) <= 1e-6 * torch.clamp(torch.abs(ova),
                                                           min=1.0)
        else:
            ova = torch.as_tensor(rng.integers(0, 4, ova_shape))
            val = torch.as_tensor(rng.integers(0, 4, full).astype(np.int32))
            eq = val == ova
        ref = torch.where(st1, torch.where(eq, zero, NINF), zero)
        return ops.level_eq(val, ova, st, is_float), ref
    if kind == "sel":
        obs_ld = _dense(rng, B, rank)
        miss = torch.tensor(float(rng.normal(0, 3)), dtype=torch.float32) \
            if rng.random() < 0.5 else _dense(rng, B, rank)
        ref = torch.where(st1, obs_ld, torch.where(st2, miss, zero))
        return ops.level_sel(obs_ld, miss, st), ref
    raise ValueError(kind)


def _plan(rng, B, rank, nest, kinds, statics, floats, ops_, terms):
    """A seeded plan: its postfix code (as BlockTracer.score_plan builds
    it) and its value as the parent's score_plan computed it."""
    code = [(ops.LEVEL_ZERO, 0)]
    total = torch.zeros((1,) * rank)
    for _ in range(int(rng.integers(1, 4))):
        # a level of a few dozen operands at most, as the paths' are
        what = "leaf" if len(ops_) >= 24 or not nest else rng.choice(
            ["leaf", "term", "plan"])
        kind = str(rng.choice(kinds))
        if what == "leaf" and kind == "dense":
            o, v = _term(rng, "dense", B, rank)
            ops_.append(o)
            code += [(ops.LEVEL_PUSH, len(ops_) - 1)]
            step = v
        elif what in ("leaf", "term"):
            o, v = _term(rng, kind, B, rank, statics[rng.integers(
                len(statics))], bool(rng.choice(floats)))
            ops_.append(o)
            i = len(ops_) - 1
            terms.append(kind)
            rest_code, rest = _plan(rng, B, rank, nest - 1, kinds,
                                    statics, floats, ops_, terms) \
                if what == "term" else ([(ops.LEVEL_ZERO, 0)],
                                        torch.zeros((1,) * rank))
            code += rest_code + [(ops.LEVEL_ADDOP, i)]
            step = v + rest
        else:
            sub_code, step = _plan(rng, B, rank, nest - 1, kinds, statics,
                                   floats, ops_, terms)
            code += sub_code
        code.append((ops.LEVEL_ADD, 0))
        total = total + step
    return code, total


def _gathers(rng, rank, n, ops_, code, total):
    """n deferred AddTypos columns of a one-row level (_mm_flush's frame):
    K3's plain sum (from 0, in column order) added to the total last, as
    the parent's _mm_flush did; the code K20 gets for them."""
    axes = AXES[:rank - 1]
    K = int(np.prod(axes))
    mats, obs, words = [], [], []
    code.append((ops.LEVEL_ZERO, 0))
    for _ in range(n):
        V = int(rng.integers(3, 9))
        M = torch.as_tensor(rng.normal(0, 1, (V, V)).astype(np.float32))
        ov = torch.as_tensor(rng.integers(-1, V + 2, (1,)))  # clamped
        word_shape = (1,) + tuple(a if rng.random() < 0.7 else 1
                                  for a in axes)
        word = torch.as_tensor(rng.integers(0, V + 1, word_shape))
        mats.append(M)
        obs.append(ov)
        words.append(word)
        ops_.append(ops.level_gather(M, ov.reshape((1,) * rank), word,
                                     (1,) + axes))
        code.append((ops.LEVEL_ADDOP, len(ops_) - 1))
    code.append((ops.LEVEL_ADD, 0))
    ob = torch.stack([o.reshape(-1).expand(1) for o in obs],
                     dim=1).to(torch.int32)
    wd = torch.stack([w.expand((1,) + axes).reshape(K)
                      for w in words]).to(torch.int32)
    out = ops.obs_gather_sum_plain(mats, ob, wd)
    return total + out.reshape((1,) + axes)


LEVEL_CASES = {
    "dense d0": dict(depth=0, kinds=["dense"], B=3),
    "dense d2 nested": dict(depth=2, kinds=["dense"], B=2, nest=3),
    "eq int per-row": dict(depth=1, kinds=["eq"], B=4, statics=[None]),
    "eq float per-row": dict(depth=1, kinds=["eq"], B=4, statics=[None],
                             floats=[True]),
    "eq static 0 1 2": dict(depth=2, kinds=["eq"], B=2, statics=[0, 1, 2],
                            floats=[False, True]),
    "sel per-row": dict(depth=1, kinds=["sel"], B=5, statics=[None]),
    "sel static 0 1 2": dict(depth=0, kinds=["sel"], B=3,
                             statics=[0, 1, 2]),
    "mixed d1": dict(depth=1, kinds=["dense", "eq", "sel"], B=3,
                     statics=[None, 1, 2], floats=[False, True], nest=2),
    "mixed d2": dict(depth=2, kinds=["dense", "eq", "sel"], B=2,
                     statics=[None, 0, 1], floats=[False, True], nest=3),
    "gathers d1 one row": dict(depth=1, kinds=["dense", "eq"], B=1,
                               gathers=3),
    "gathers d2 one row": dict(depth=2, kinds=["dense", "sel", "eq"], B=1,
                               statics=[None, 1], gathers=10, nest=2),
}


def _level(case, seed=0):
    """(program, operands, rank, the parent's eager value) of a case."""
    c = LEVEL_CASES[case]
    rng = np.random.default_rng(seed)
    rank = 1 + c["depth"]
    ops_, terms = [], []
    code, total = _plan(rng, c["B"], rank, c.get("nest", 1), c["kinds"],
                        c.get("statics", [None]), c.get("floats", [False]),
                        ops_, terms)
    if c.get("gathers"):
        total = _gathers(rng, rank, c["gathers"], ops_, code, total)
    return ops.level_program(code), ops_, rank, total


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_sum_plain_is_the_parents_eager_sum(case, seed):
    """Bit-equal, of the eager sum's shape; the CPU wrapper takes the plain
    version and launches nothing."""
    prog, operands, rank, want = _level(case, seed)
    before = dict(ops.LAUNCHES)
    got = ops.level_sum(prog, operands, rank, B=LEVEL_CASES[case]["B"])
    assert ops.LAUNCHES == before
    assert got.shape == want.shape == ops.level_shape(operands, rank)
    assert got.dtype == torch.float32
    assert torch.equal(got, want), (got - want).abs().max()
    # every PUSH followed by ADD is folded
    assert all(not (a[0] == ops.LEVEL_PUSH and b[0] == ops.LEVEL_ADD)
               for a, b in zip(prog, prog[1:]))


def test_level_program_and_stack():
    P, Z, A, O = ops.LEVEL_PUSH, ops.LEVEL_ZERO, ops.LEVEL_ADD, \
        ops.LEVEL_ADDOP
    code = [(Z, 0), (Z, 0), (P, 0), (A, 0), (O, 1), (A, 0), (P, 2), (A, 0)]
    prog = ops.level_program(code)
    assert prog == [(Z, 0), (Z, 0), (O, 0), (O, 1), (A, 0), (O, 2)]
    assert ops.level_stack(prog) == 2
    # rents' County level: five zeros nested, the term at the fourth
    rents = [(Z, 0)] * 5 + [(A, 0), (P, 0), (A, 0), (A, 0), (A, 0), (A, 0)]
    assert ops.level_program(rents) == [(Z, 0)] * 4 + [(O, 0)] + \
        [(A, 0)] * 3
    assert ops.level_stack(ops.level_program(rents)) == 4
    # the folds keep the bits, a -0 and a NaN term included
    x = torch.tensor([-0.0, 1.5, float("nan"), -3.0])
    for c in (rents, code, [(Z, 0), (Z, 0), (A, 0), (Z, 0), (A, 0),
                            (P, 0), (A, 0)]):
        got = ops.level_sum_plain(ops.level_program(c),
                                  [ops.level_dense(x)] * 3, 1)
        stack = []   # the code as written, one torch add a step
        for op, a in c:
            if op == Z:
                stack.append(torch.zeros(1))
            elif op == P:
                stack.append(x)
            else:   # ADDOP adds the term, ADD the value above
                b = x if op == O else stack.pop()
                stack[-1] = stack[-1] + b
        assert torch.equal(got.view(torch.int32),
                           stack[0].expand(4).view(torch.int32))
    with pytest.raises(ValueError):
        ops.level_stack([(Z, 0), (Z, 0)])
    with pytest.raises(ValueError):
        ops.level_stack([(A, 0)])


# ------------------------------------------- the plans, read as the card


_CT = {0: ctypes.c_uint8, 1: ctypes.c_int8, 2: ctypes.c_uint8,
       3: ctypes.c_int16, 4: ctypes.c_int32, 5: ctypes.c_int64,
       6: ctypes.c_float, 7: ctypes.c_double}


def _ld(ptr, dt, i):
    ct = _CT[int(dt)]
    v = ct.from_address(int(ptr) + int(i) * ctypes.sizeof(ct)).value
    return np.float32(v) if dt == 6 else v


def _divide(n, word):
    """csrc/level_sum.cu's divide: (umulhi(n, magic) + n) >> shift."""
    magic, shift = word & 0xffffffff, word >> 32
    return (((n * magic) >> 32) + n) >> shift


def _k20_element(words, coord, c):
    """csrc/level_eval.cuh's evaluation of the plan's program at one
    element (its coordinates on the outer merged axes and its position c
    along the innermost), written out in Python: each reference's offset
    from the coordinates and its innermost stride, float32 arithmetic (one
    rounding a step)."""
    rank = words[1]
    n_refs, n_ops, n_prog = words[11], words[12], words[13]
    refs = [words[32 + 10 * r: 42 + 10 * r] for r in range(n_refs)]
    base = 32 + 10 * n_refs
    opw = [words[base + 6 * i: base + 6 * i + 6] for i in range(n_ops)]
    prog = words[base + 6 * n_ops: base + 6 * n_ops + n_prog]

    def at(r, coord, c):
        rf = refs[r]
        off = sum(x * st for x, st in zip(coord, rf[2:])) + \
            c * rf[2 + rank - 1]
        return _ld(rf[0], rf[1], off)

    def operand(o, coord, c):
        kind = o[0]
        if kind == 0:
            return at(o[1], coord, c)
        st = int(at(o[3], coord, c)) if o[3] >= 0 and kind != 3 else o[4]
        if kind == 1:
            if st != 1:
                return np.float32(0)
            v, ov = at(o[1], coord, c), at(o[2], coord, c)
            if o[5] == 1:
                v, ov = np.float32(v), np.float32(ov)
                eq = abs(v - ov) <= np.float32(1e-6) * max(abs(ov),
                                                           np.float32(1))
            elif o[5] == 2:
                eq = np.float32(v) == np.float32(ov)
            else:
                eq = int(v) == int(ov)
            return np.float32(0) if eq else np.float32(NINF)
        if kind == 2:
            return at(o[1], coord, c) if st == 1 else (
                at(o[2], coord, c) if st == 2 else np.float32(0))
        V = o[5]
        a = min(max(int(at(o[1], coord, c)), 0), V - 1)
        b = min(max(int(at(o[2], coord, c)), 0), V - 1)
        return _ld(o[4], 6, a * V + b)

    stack = []
    for w in prog:
        op, arg = w >> 32, w & 0xffffffff
        if op == ops.LEVEL_ZERO:
            stack.append(np.float32(0))
        elif op == ops.LEVEL_PUSH:
            stack.append(np.float32(operand(opw[arg], coord, c)))
        elif op == ops.LEVEL_ADD:
            b = stack.pop()
            stack[-1] = np.float32(stack[-1] + b)
        else:
            stack[-1] = np.float32(stack[-1] + operand(opw[arg], coord, c))
    return stack[0]


def _place(words, t, E):
    """The kernel's place of thread t (E elements a thread): the outer
    coordinates by the plan's divisors, the first element's position along
    the innermost axis and its row-major index."""
    rank, sizes = words[1], words[2:2 + words[1]]
    tpr, div_tpr, divs = words[14], words[17], words[18:25]
    row = _divide(t, div_tpr)
    assert row == t // tpr
    c0 = (t - row * tpr) * E
    first = row * sizes[-1] + c0
    coord = [0] * (rank - 1)
    for d in range(rank - 2, 0, -1):
        q = _divide(row, divs[d])
        assert q == row // sizes[d]
        coord[d], row = row - q * sizes[d], q
    if rank > 1:
        coord[0] = row
    return coord, c0, first


def read_level_at(words, n):
    """A fused level's value at element n of its output (an element a
    thread, as K12 and K13 evaluate it)."""
    coord, c0, first = _place(words, n, 1)
    assert first == n and words[14] == words[2 + words[1] - 1]
    return _k20_element(words, coord, c0)


def _read_k20(words):
    """csrc/level_sum.cu's kernel, written out in Python over the plan:
    each thread's place from its index by the plan's divisors (the merged
    axes, the instantiation's elements a thread along the innermost), each
    element evaluated as the kernel evaluates it (_k20_element); the
    instantiation holds the program's depth."""
    N, rank = words[0], words[1]
    sizes = words[2:2 + rank]
    n_refs, n_ops, n_prog = words[11], words[12], words[13]
    tpr, rows, threads = words[14], words[15], words[16]
    kernel = words[25]
    E = ops.K20_KERNELS[kernel][2]
    assert threads == rows * tpr and rows * sizes[-1] == N
    base = 32 + 10 * n_refs + 6 * n_ops
    prog = words[base: base + n_prog]
    assert ops.level_stack([(w >> 32, w & 0xffffffff) for w in prog]) <= \
        ops.K20_KERNELS[kernel][0]
    out = np.full(N, np.nan, np.float32)
    for t in range(threads):
        coord, c0, first = _place(words, t, E)
        for j in range(min(E, sizes[-1] - c0)):
            out[first + j] = _k20_element(words, coord, c0 + j)
    return out


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_k20_plan_read_as_the_kernel_reads_it(case):
    prog, operands, rank, want = _level(case, 3)
    words, shape = ops.level_plan(prog, operands, rank, card=False)
    assert shape == tuple(want.shape) and len(words) <= ops.K20_WORDS
    assert words[ops.K20_OUT] == 0   # the caller's output goes here
    got = _read_k20(words)
    np.testing.assert_array_equal(got.reshape(shape), want.numpy())


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_k20_cached_plan_takes_new_tensors(case):
    """The plan a call takes from the structure cache (level_words: the
    words built at the structure's first call, the call's pointers written
    in) equals a fresh level_plan of the new tensors, word for word; the
    same level at another B or label is another entry."""
    prog, operands, rank, _want = _level(case, 5)
    first = ops.level_words(prog, operands, rank, B=7, label="cache",
                            card=False)
    fresh = [{k: v.clone() if torch.is_tensor(v) else v for k, v in o.items()}
             for o in operands]   # the same structure, new storage
    got = ops.level_words(prog, fresh, rank, B=7, label="cache", card=False)
    want, _shape = ops.level_plan(prog, fresh, rank, card=False)
    assert len(got) == 1 and got[0] == want
    assert first[0] != want   # the pointers moved
    n = len(ops._K20_PLANS)
    ops.level_words(prog, fresh, rank, B=8, label="cache", card=False)
    assert len(ops._K20_PLANS) == n + 1


def test_k20_merges_axes_every_reference_walks_as_one():
    """level_axes: size-1 axes dropped, an axis folded into the one outside
    it where every reference's outer stride is its inner stride times the
    inner size (a broadcast reference's 0 and 0 included)."""
    A = ops.level_axes
    # rents' [256, 4,096, 2]: a [1, 4096, 2] term and a per-row [256, 1, 1]
    assert A((256, 4096, 2), [[0, 2, 1], [1, 0, 0]]) == \
        ([256, 8192], [[0, 1], [1, 0]])
    assert A((1, 64), [[0, 1], [0, 0]]) == ([64], [[1], [0]])
    assert A((1, 1), [[0, 0]]) == ([1], [[0]])
    assert A((3, 4, 5), [[0, 5, 1], [20, 5, 1], [0, 0, 0]]) == \
        ([3, 20], [[0, 1], [20, 1], [0, 0]])
    assert A((3, 4, 5), [[0, 0, 1], [0, 1, 0]]) == \
        ([3, 4, 5], [[0, 0, 1], [0, 1, 0]])
    # the instantiation: 8 elements a thread for a wide shallow level
    Z, A, P = ops.LEVEL_ZERO, ops.LEVEL_ADD, ops.LEVEL_PUSH
    for shape, code, want in (
            ((256, 4096, 2), [(Z, 0), (P, 0), (A, 0)], (2, True, 8)),
            ((256, 4096, 2), [(Z, 0)] * 5 + [(A, 0), (P, 0)] + [(A, 0)] * 4,
             (4, True, 8)),
            ((256, 4096, 2), [(Z, 0)] * 6 + [(P, 0)] + [(A, 0)] * 6,
             (8, True, 4)),
            ((1, 512), [(Z, 0), (P, 0), (A, 0)], (2, True, 1)),
            ((4, 5), [(Z, 0)] * 6 + [(P, 0)] + [(A, 0)] * 6, (8, True, 1)),
            ((4, 5), [(Z, 0)] * 10 + [(P, 0)] + [(A, 0)] * 10,
             (ops.K20_MAX_STACK, False, 4))):
        words, _s = ops.level_plan(ops.level_program(code),
                                   [ops.level_dense(torch.zeros(shape))],
                                   len(shape), card=False)
        assert ops.K20_KERNELS[words[ops._K20_KERNEL]] == want, shape
    for d in (1, 2, 3, 7, 64, 1000, 4097, 2 ** 20 + 3):
        w = ops._divider(d)
        for n in (0, 1, d - 1, d, d + 1, 5 * d + 3, 2 ** 31 - 1):
            assert _divide(n, w) == n // d


def test_k20_plan_refuses_what_the_kernel_does_not_take():
    prog, operands, rank, _want = _level("mixed d1", 0)
    with pytest.raises(ValueError):   # off the card
        ops.level_plan(prog, operands, rank)
    bad = [dict(o) for o in operands]
    i = next(j for j, o in enumerate(bad) if o["kind"] == "dense")
    bad[i]["x"] = bad[i]["x"].double()
    with pytest.raises(ValueError):
        ops.level_plan(prog, bad, rank, card=False)
    with pytest.raises(ValueError):   # a program leaving two values
        ops.level_plan(prog + [(ops.LEVEL_ZERO, 0)], operands, rank,
                       card=False)
    with pytest.raises(ValueError):
        ops.level_plan([(ops.LEVEL_PUSH, len(operands))], operands, rank,
                       card=False)
    deep = [(ops.LEVEL_ZERO, 0)] * (ops.K20_MAX_STACK + 1) + \
        [(ops.LEVEL_ADD, 0)] * ops.K20_MAX_STACK
    with pytest.raises(ValueError):
        ops.level_plan(deep, operands, rank, card=False)
    many = [ops.level_dense(torch.zeros(1))] * (ops.K20_MAX_OPS + 1)
    with pytest.raises(ValueError):
        ops.level_plan([(ops.LEVEL_ZERO, 0)], many, 1, card=False)
    clash = [ops.level_dense(torch.zeros(1, 3)),
             ops.level_dense(torch.zeros(1, 4))]
    with pytest.raises(ValueError):   # operands that do not broadcast
        ops.level_plan([(ops.LEVEL_ZERO, 0), (ops.LEVEL_ADDOP, 0),
                        (ops.LEVEL_ADDOP, 1)], clash, 2, card=False)


# ------------------------------------------------------------------ K21


def _prior_inputs(seed, B, cap, full, comp=None, per_row=False, py=True,
                  bcast=False, ch_k=False, idx32=False, unaligned=False):
    """numpy-seeded K21 inputs: refcounts 0-5, 30% dead; per-row leaves
    [B, cap] with totals and nrows [B], else [cap] and scalars; comp: Kc
    candidates (live slots first, ascending, padded with cap; int32 with
    idx32), nc of them real; children [full..., K] (broadcast over the
    rows with bcast, over the candidates with ch_k) and new_children
    [full...]; `unaligned`: _prior_torch puts refcount, alive and the
    children 4 bytes (alive 1) past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    lead = (B,) if per_row else ()
    refc = rng.integers(0, 6, lead + (cap,)).astype(np.int32)
    alive = rng.random(lead + (cap,)) >= 0.3
    total = (refc * alive).sum(-1).astype(np.int64)
    nrows = alive.sum(-1).astype(np.int64)
    K = cap
    idx = nc = None
    if comp is not None:
        K = comp
        live = np.flatnonzero((refc.reshape(-1, cap)[0] > 0)
                              & alive.reshape(-1, cap)[0])
        n = min(len(live), K - 2)
        idx = np.full(K, cap, np.int32 if idx32 else np.int64)
        idx[:n] = live[:n]
        nc = np.int64(n)
    ch_shape = ((1,) * len(full) if bcast else tuple(full)) + \
        ((1,) if ch_k else (K,))
    ch = rng.normal(0.0, 2.0, ch_shape).astype(np.float32)
    ch[rng.random(ch_shape) < 0.1] = NINF
    nch = rng.normal(0.0, 2.0, tuple(full)).astype(np.float32)
    s, d = np.float32(rng.uniform(0.5, 3.0)), np.float32(rng.uniform(0, 0.6))
    return dict(refcount=refc, alive=alive, total=total, nrows=nrows,
                idx=idx, nc=nc, children=ch, new_children=nch,
                full=tuple(full), strength=s, discount=d, py=py,
                unaligned=unaligned)


def _prior_torch(inp, dev="cpu"):
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)  # noqa: E731

    def off(x):   # a contiguous copy one element past a 16-byte boundary
        x = t(x)
        if not inp["unaligned"]:
            return x
        buf = torch.empty(x.numel() + 16 // x.element_size(),
                          dtype=x.dtype, device=dev)
        base = (-buf.data_ptr() % 16) // x.element_size() + 1
        return buf[base:base + x.numel()].view(x.shape).copy_(x)

    s, d = (t(inp["strength"]), t(inp["discount"])) if inp["py"] else \
        (float(inp["strength"]), float(inp["discount"]))
    comp = None if inp["idx"] is None else (t(inp["idx"]), t(inp["nc"]))
    return (off(inp["refcount"]), off(inp["alive"]), t(inp["total"]),
            t(inp["nrows"]), s, d, comp, off(inp["children"]),
            t(inp["new_children"]), inp["full"])


def _prior_jax(inp):
    """pclean_tpu's BlockTracer.py_logprobs on each row's leaves (the
    tracer runs one row under vmap), score_fk's compaction select, and
    the children added: (exist [R, K], new [R])."""
    import jax.numpy as jnp
    from pclean_tpu.engine import propose as jprop

    full = inp["full"]
    B, depth = full[0], len(full) - 1
    rows = []
    for b in range(B):
        pick = (lambda x: x[b]) if inp["refcount"].ndim == 2 else \
            (lambda x: x)
        rel = {"T": {k: jnp.asarray(pick(inp[k]))
                     for k in ("refcount", "alive", "total", "nrows")}}
        params = {"__py__": {"T": {
            "strength": jnp.asarray(inp["strength"]),
            "discount": jnp.asarray(inp["discount"])}}} if inp["py"] else {}
        cm = SimpleNamespace(cls=lambda tc: SimpleNamespace(
            py_strength=float(inp["strength"]),
            py_discount=float(inp["discount"])))
        ex, new = jprop.BlockTracer.py_logprobs(
            SimpleNamespace(cm=cm, rel=rel, params=params), "T")
        if inp["idx"] is not None:
            cap = inp["refcount"].shape[-1]
            K = len(inp["idx"])
            slot_ids = jnp.minimum(jnp.asarray(inp["idx"]), cap - 1)
            ex = jnp.where(jnp.arange(K) < inp["nc"], ex[slot_ids], NINF)
        K = ex.shape[-1]
        ch = np.broadcast_to(inp["children"], full + (K,))[b]
        nch = np.broadcast_to(inp["new_children"], full)[b]
        rows.append((np.asarray(ex + ch).reshape(-1, K),
                     np.asarray(new + nch).reshape(-1)))
    return (np.concatenate([r[0] for r in rows]),
            np.concatenate([r[1] for r in rows]))


PRIOR_CASES = {
    "shared": dict(B=4, cap=40, full=(4,)),
    "shared rows": dict(B=3, cap=30, full=(3, 2, 2)),
    "comp": dict(B=4, cap=50, full=(4,), comp=24),
    "comp per-row": dict(B=3, cap=40, full=(3,), comp=20, per_row=True),
    "per-row": dict(B=3, cap=33, full=(3, 2), per_row=True),
    "broadcast children": dict(B=5, cap=20, full=(5, 3), bcast=True),
    "no __py__": dict(B=2, cap=30, full=(2,), py=False, comp=12),
    "one row comp": dict(B=1, cap=64, full=(1,), comp=16),
    # the route's edges: every vector (K a multiple of 4, aligned); a tail
    # of 1-3 candidates; children one value a row (stride 0 along k);
    # leaves and children off a 16-byte boundary; a compaction of int32
    # indices with a tail
    "vectors": dict(B=3, cap=64, full=(3, 2), per_row=True),
    "tail": dict(B=2, cap=39, full=(2, 3), per_row=True),
    "children along k": dict(B=3, cap=24, full=(3, 2), ch_k=True),
    "unaligned": dict(B=3, cap=48, full=(3,), per_row=True, unaligned=True),
    "comp int32 tail": dict(B=3, cap=40, full=(3,), comp=22, idx32=True),
}


@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_py_prior_plain_matches_jax_py_logprobs(case):
    inp = _prior_inputs(5, **PRIOR_CASES[case])
    before = dict(ops.LAUNCHES)
    exist, new = ops.py_prior(*_prior_torch(inp))
    assert ops.LAUNCHES == before   # CPU: the plain version
    ej, nj = _prior_jax(inp)
    assert exist.shape == ej.shape and new.shape == nj.shape
    np.testing.assert_allclose(exist.numpy(), ej, **TOL)
    np.testing.assert_allclose(new.numpy(), nj, **TOL)
    # NEG_INF entries (dead or padded slots) exactly
    np.testing.assert_array_equal(exist.numpy() <= NINF / 2, ej <= NINF / 2)


def _read_k21(words):
    """csrc/py_prior.cu's kernels, written out in Python over the plan: in
    the row kernel (words[K21_UNIT] 4) a row a group of
    2^words[K21_ROW_LOG] threads (at most the block), the row's terms
    once, then each thread's units of four candidates, each load and
    store a vector where the route's word says (its address asserted
    16-byte aligned, alive's four bytes 4-byte aligned), element by
    element elsewhere and in a row's last unit of fewer than four; in the
    flat kernel (1) an entry at a time."""
    R, K, nd = words[22], words[23], words[24]
    sizes = words[25:25 + nd]
    chs, chk, ncs = words[33:33 + nd], words[41], words[42:42 + nd]
    route, tpr = words[ops.K21_ROUTE], 1 << words[ops.K21_ROW_LOG]
    V = words[ops.K21_UNIT]
    assert tpr <= ops.K21_THREADS and (tpr >= -(-K // 4) or
                                       tpr == ops.K21_THREADS)
    assert V == 4 or (V == 1 and R * (K + 1) < 1 << 31)
    if V == 1:   # the flat kernel: the row's entries one by one
        tpr = 1
    idx, idt = words[14], words[15]
    if route & ops.K21_LEAF_VEC:
        assert not idx
    isz = {4: 4, 5: 8}.get(idt, 0)

    def vec(ptr, align=16):
        assert ptr % align == 0, (ptr, align)

    def scalar(ptr, bits):
        if ptr:
            return _ld(ptr, 6, 0)
        return np.frombuffer(np.int32(bits).tobytes(), np.float32)[0]

    s, d = scalar(words[10], words[11]), scalar(words[12], words[13])
    exist = np.zeros((R, K), np.float32)
    new = np.zeros(R, np.float32)
    f = np.float32
    for r in range(R):
        coord = np.unravel_index(r, sizes)
        b = coord[0]
        och = sum(c * x for c, x in zip(coord, chs))
        onch = sum(c * x for c, x in zip(coord, ncs))
        total = f(_ld(words[4], words[5], b * words[6]))
        logden = np.log(f(total + s))
        nv = f(_ld(words[7], words[8], b * words[9]))
        new[r] = f(f(np.log(f(f(d * nv) + s)) - logden)
                   + _ld(words[19], 6, onch))
        at0 = b * words[2]
        nc = _ld(words[16], words[17], 0) if idx else K
        for t in range(tpr):
            for u in range(t, -(-K // V), tpr):
                k0 = V * u
                ks = range(k0, min(K, k0 + V))
                full = len(ks) == 4
                if idx and full and route & ops.K21_IDX_VEC:
                    vec(idx + isz * k0)
                if not idx:
                    slots = list(ks)
                else:
                    # min(idx, cap - 1), then take()'s clamp at 0
                    slots = [max(min(_ld(idx, idt, k), words[3] - 1), 0)
                             for k in ks]
                if full and route & ops.K21_LEAF_VEC:
                    vec(words[0] + 4 * (at0 + k0))
                    vec(words[1] + at0 + k0, 4)
                if full and route & ops.K21_CH_VEC:
                    assert chk == 1
                    vec(words[18] + 4 * (och + k0))
                if full and route & ops.K21_EXIST_VEC:
                    vec(words[20] + 4 * (r * K + k0))
                for k, slot in zip(ks, slots):
                    prior = f(NINF)
                    cnt = _ld(words[0], 4, at0 + slot)
                    if k < nc and _ld(words[1], 0, at0 + slot) and cnt > 0:
                        prior = f(np.log(max(f(f(cnt) - d), f(1e-30)))
                                  - logden)
                    exist[r, k] = f(prior + _ld(words[18], 6,
                                                och + k * chk))
    return exist, new


def _k21_plan_read(case, unit=None):
    inp = _prior_inputs(7, **PRIOR_CASES[case])
    args = _prior_torch(inp)
    want_e, want_n = ops.py_prior_plain(*args)
    e, n = torch.empty_like(want_e), torch.empty_like(want_n)
    words = ops.py_prior_words(*args, e, n, card=False)
    assert len(words) == ops.K21_WORDS
    if unit is not None:   # the other kernel over the same plan
        words[ops.K21_UNIT] = unit
    got_e, got_n = _read_k21(words)
    np.testing.assert_allclose(got_e, want_e.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_n, want_n.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_e <= NINF / 2,
                                  want_e.numpy() <= NINF / 2)


@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_k21_plan_read_as_the_kernel_reads_it(case):
    """The plan's layout: the Python reading of csrc/py_prior.cu over the
    words, in the kernel the plan picks (the flat one at these sizes),
    against the plain version (numpy's log against torch's: rtol 1e-6;
    NEG_INF entries exactly)."""
    _k21_plan_read(case)


@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_k21_row_kernel_plan_read_as_the_kernel_reads_it(case):
    """As above, the row kernel forced (four candidates a thread, every
    vector access asserted aligned)."""
    _k21_plan_read(case, unit=4)


_L, _C, _E, _I = (ops.K21_LEAF_VEC, ops.K21_CH_VEC, ops.K21_EXIST_VEC,
                  ops.K21_IDX_VEC)
K21_ROUTES = {"shared": _L | _C | _E, "vectors": _L | _C | _E, "tail": 0,
              "children along k": _L | _E, "unaligned": _E,
              "comp int32 tail": _I, "comp": _C | _E | _I, "per-row": 0}


@pytest.mark.parametrize("case", list(K21_ROUTES))
def test_k21_route_and_row_threads(case):
    """The route py_prior_words picks at its edges (vectors only where
    every row's address along k allows them; no leaf vectors through a
    compaction, its int32 or int64 indices in vectors; children strided
    along k, as stride 0 is, element by element); the flat kernel at these
    small sizes, the row kernel's threads a row enough for its units of
    four, at most the block."""
    inp = _prior_inputs(2, **PRIOR_CASES[case])
    args = _prior_torch(inp)
    K = args[6][0].shape[0] if args[6] is not None else args[0].shape[-1]
    R = int(np.prod(inp["full"]))
    words = ops.py_prior_words(*args, torch.empty((R, K)), torch.empty(R),
                               card=False)
    assert words[ops.K21_ROUTE] == K21_ROUTES[case]
    assert words[ops.K21_UNIT] == 1
    assert 1 << words[ops.K21_ROW_LOG] == min(
        ops.K21_THREADS, 1 << (-(-K // 4) - 1).bit_length())


def test_k21_rows_on_one_grid_axis():
    """Rows go along the grid's x axis only, a block 256 / a row's threads
    of them, so 70,001 rows of 8 candidates in the row kernel (the work
    fills the card) are 547 blocks of 128 rows (no 65,535 limit); rows
    past 2^31 are refused, and a call of 2^33 entries takes the row
    kernel."""
    inp = _prior_inputs(3, B=70001, cap=8, full=(70001,))
    args = _prior_torch(inp)
    words = ops.py_prior_words(*args, torch.empty((70001, 8)),
                               torch.empty(70001), card=False)
    rows = ops.K21_THREADS >> words[ops.K21_ROW_LOG]
    assert words[ops.K21_UNIT] == 4
    assert rows == 128 and -(-70001 // rows) == 547
    big = list(args)
    big[7] = torch.zeros((1, 8)).expand(1 << 16, 1 << 15, 8)
    big[8] = torch.zeros(()).expand(1 << 16, 1 << 15)
    big[9] = (1 << 16, 1 << 15)
    with pytest.raises(ValueError):
        ops.py_prior_words(*big, torch.empty(0), torch.empty(0), card=False)
    big[7] = torch.zeros((1, 8)).expand(1 << 16, 1 << 14, 8)
    big[8] = torch.zeros(()).expand(1 << 16, 1 << 14)
    big[9] = (1 << 16, 1 << 14)
    out = (torch.empty((1 << 30, 8), device="meta"),   # no storage
           torch.empty(1 << 30, device="meta"))
    assert ops.py_prior_words(*big, *out, card=False)[ops.K21_UNIT] == 4


def test_k21_words_refuse_what_the_kernel_does_not_take():
    inp = _prior_inputs(1, B=3, cap=20, full=(3,), comp=8)
    args = list(_prior_torch(inp))
    e, n = torch.empty((3, 8)), torch.empty(3)
    with pytest.raises(ValueError):    # off the card
        ops.py_prior_words(*args, e, n)
    bad = list(args)
    bad[0] = bad[0].long()
    with pytest.raises(ValueError):
        ops.py_prior_words(*bad, e, n, card=False)
    bad = list(args)
    bad[7] = bad[7].double()
    with pytest.raises(ValueError):
        ops.py_prior_words(*bad, e, n, card=False)
    with pytest.raises(ValueError):    # outputs of another size
        ops.py_prior_words(*args, torch.empty((3, 9)), n, card=False)
    bad = list(args)
    bad[9] = (1,) * 9
    with pytest.raises(ValueError):
        ops.py_prior_words(*bad, e, n, card=False)


# ------------------------------------- the card's census inputs (CPU)


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_k20_bench_inputs_rebuild_the_census_shape(case):
    """kernel_bench's K20 inputs, which the card's census check and timing
    use, from the fields the wrapper records: the same program, operand
    kinds, static codes, reference shapes and dtypes; the plain version
    runs on them; the bytes bound counts every reference and the output."""
    from pclean_tpu_torch import kernel_bench as kb

    prog, operands, rank, _want = _level(case, 4)
    shape = ops.level_shape(operands, rank)
    f = ops._level_fields(prog, operands, rank, shape)
    inp = kb.level_inputs("cpu", "level_sum", f, int(np.prod(shape)))
    prog2, ops2, rank2 = inp["args"]
    assert prog2 == list(prog) and rank2 == rank
    assert ops._level_fields(prog2, ops2, rank2, shape) == f
    out = ops.level_sum_plain(*inp["args"])
    assert tuple(out.shape) == shape
    assert kb.level_bytes(inp) >= 4 * out.numel() + sum(
        t.numel() * t.element_size() for o in ops2
        for _n, t in ops._level_tensors(o))


@pytest.mark.parametrize("case", ["shared", "comp per-row", "no __py__"])
def test_k21_bench_inputs_rebuild_the_census_shape(case):
    from pclean_tpu_torch import kernel_bench as kb

    c = PRIOR_CASES[case]
    f = dict(B=c["B"], full=c["full"], cap=c["cap"],
             comp=c.get("comp") is not None,
             per_row=c.get("per_row", False), sd=c.get("py", True),
             counts=(torch.int64, torch.int32))
    K = c.get("comp") or c["cap"]
    inp = kb.level_inputs("cpu", "py_prior", f, K)
    refc, alive, total, nrows, s, d, comp, ch, nch, full = inp["args"]
    assert refc.shape == ((c["B"],) if f["per_row"] else ()) + (c["cap"],)
    assert (comp is not None) == f["comp"] and torch.is_tensor(s) == f["sd"]
    assert total.dtype == torch.int64 and nrows.dtype == torch.int32
    exist, new = ops.py_prior_plain(*inp["args"])
    R = int(np.prod(full))
    assert exist.shape == (R, K) and new.shape == (R,)
    assert kb.level_bytes(inp) > 4 * (R * K + R)


# ---------------------------------------------------- blocks against JAX


def _spies():
    """Spies on the K20 and K21 entries the tracer calls (on the CPU they
    take the plain versions)."""
    return (mock.patch.object(ops, "level_sum", wraps=ops.level_sum),
            mock.patch.object(ops, "py_prior", wraps=ops.py_prior))


def _score_spies():
    """Spies on K12 and K13, which take a one-row level unsummed."""
    return (mock.patch.object(ops, "fk_score", wraps=ops.fk_score),
            mock.patch.object(ops, "choice_score", wraps=ops.choice_score))


def _level_kinds(ls, fk=None, ch=None) -> set:
    """The operand kinds of the levels the tracer summed through K20 (the
    level_sum spy) and, at one row, handed to K12 and K13 (ops.Level
    arguments of their spies)."""
    kinds = {o["kind"] for c in ls.call_args_list for o in c.args[1]}
    fused = [x for c in (fk.call_args_list if fk else [])
             for x in c.args[6:8]] + \
        [c.args[1] for c in (ch.call_args_list if ch else [])]
    return kinds | {o["kind"] for x in fused if isinstance(x, ops.Level)
                    for o in x.operands}


@pytest.fixture(scope="module")
def scaled_pair():
    from test_torch_host import scaled_pair as build
    from test_torch_propose import Pair

    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = build()
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


@pytest.mark.parametrize("n", [1, 12])
def test_scaled_blocks_through_k20_k21_match_jax(scaled_pair, n):
    """The scaled Record block (a batched fk level through K21 at n > 1,
    K12 at one row; its candidate axis compacted at n > 1) and a latent
    Hospital block, one row and n rows."""
    import jax

    lsum, prior = _spies()
    with lsum as ls, prior as pp:
        slots = np.sort(np.random.default_rng(n).choice(512, n,
                                                        replace=False))
        keys = jax.random.split(jax.random.PRNGKey(3 + n), n)
        scaled_pair.block("Record", 0, slots, keys,
                          cand={"Hospital": 64} if n > 1 else None)
        cap = scaled_pair.cm_t.layouts["Hospital"].capacity
        live = np.flatnonzero(scaled_pair.rt["Hospital"]["alive"].numpy())
        hs = np.concatenate([live[:n - 1], [cap - 1]]) if n > 1 \
            else live[:1]
        scaled_pair.block("Hospital", 0, hs,
                          jax.random.split(jax.random.PRNGKey(9), len(hs)))
    assert ls.call_count > 0
    assert (pp.call_count > 0) == (n > 1)


@pytest.fixture(scope="module")
def hospital_pair():
    from test_torch_hospital import hospital_pair as build
    from test_torch_propose import Pair

    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = build()
    return Pair(cm_j, cfg_j, cm_t, cfg_t)


@pytest.mark.parametrize("n", [1, 16])
def test_hospital_record_blocks_through_k20_k21_match_jax(hospital_pair, n):
    """Both hospital Record blocks in plan order (the second reads the
    first's Hospital for the stateavg), one row and a batch of 16: the
    deferred AddTypos gathers as level operands at one row (summed inside
    the K12/K13 launch that reads them; through K3 over the batch, its
    output a dense operand of K20), the batched fk levels through K21."""
    import jax
    from test_torch_hospital import _chain

    lsum, prior = _spies()
    fks, chs = _score_spies()
    with lsum as ls, prior as pp, fks as fk, chs as ch:
        slots = np.sort(np.random.default_rng(n).choice(240, n,
                                                        replace=False))
        _chain(hospital_pair, "Record", slots,
               jax.random.split(jax.random.PRNGKey(21 + n), n))
    kinds = _level_kinds(ls, fk, ch)
    assert "dense" in kinds and ("gather" in kinds) == (n == 1)
    assert (pp.call_count > 0) == (n > 1)


@pytest.fixture(scope="module")
def flights_pair():
    from test_torch_flights import flights_pair as build
    from test_torch_propose import Pair

    (cm_j, cfg_j, _q), (cm_t, cfg_t, _qt), _d, _c = build()
    return Pair(cm_j, cfg_j, cm_t, cfg_t, sweep=True)


@pytest.mark.parametrize("cid,n", [("Obs", 1), ("Obs", 8), ("Flight", 1)])
def test_flights_blocks_through_k20_match_jax(flights_pair, cid, n):
    """Every flights Obs block in plan order (the copy-mode equalities of
    its observed flight and website columns, its observed times'
    non-enumerable terms with their missing cells: K20's eq and sel
    operands, at one row inside the K12/K13 launch that reads them) and
    the Flight blocks, one row and a batch of 8. The port's
    score-pass prior draws (MaybeSwap's swaps) come from torch's global
    generator here, the JAX package's from its keys: the two agree where
    neither swaps, and the generator is seeded so that the test does not
    depend on the tests run before it in the process."""
    import jax
    from test_torch_hospital import _chain

    lsum, _prior = _spies()
    fks, chs = _score_spies()
    cap = flights_pair.cm_t.layouts[cid].capacity
    slots = np.sort(np.random.default_rng(n).choice(min(cap, 300), n,
                                                    replace=False))
    torch.manual_seed(0)
    with lsum as ls, fks as fk, chs as ch:
        _chain(flights_pair, cid, slots,
               jax.random.split(jax.random.PRNGKey(n), n))
    kinds = _level_kinds(ls, fk, ch)
    assert kinds >= ({"eq", "sel", "dense"} if cid == "Obs" else {"dense"})


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


def _to(operands, dev):
    out = []
    for o in operands:
        out.append({k: v.to(dev) if torch.is_tensor(v) else v
                    for k, v in o.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_k20_cuda_matches_plain(card, case):
    for seed in range(3):
        prog, operands, rank, _want = _level(case, seed)
        operands = _to(operands, card)
        before = ops.LAUNCHES["level_sum"]
        got = ops.level_sum(prog, operands, rank, B=2, label="test")
        assert ops.LAUNCHES["level_sum"] == before + 1
        want = ops.level_sum_plain(prog, operands, rank)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), case


@pytest.mark.cuda
def test_k20_cuda_at_a_batched_level(card):
    """A level over 4,096 rows and 1,472 candidates (a batched fk's E
    branch: K3's output and copy-mode equalities per candidate)."""
    rng = np.random.default_rng(0)
    B, K = 4096, 1472
    k3 = torch.as_tensor(rng.normal(0, 1, (B, K)).astype(np.float32))
    val = torch.as_tensor(rng.integers(0, 50, (1, K)).astype(np.int32))
    ov = torch.as_tensor(rng.integers(0, 50, (B, 1)))
    st = torch.as_tensor(rng.integers(0, 3, (B, 1)).astype(np.int8))
    operands = _to([ops.level_eq(val, ov, st, False), ops.level_dense(k3)],
                   card)
    Z, A, O = ops.LEVEL_ZERO, ops.LEVEL_ADD, ops.LEVEL_ADDOP
    prog = [(Z, 0), (Z, 0), (O, 0), (A, 0), (O, 1)]
    got = ops.level_sum(prog, operands, 2, B=B, label="test")
    want = ops.level_sum_plain(prog, operands, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3, 4, 7, 12])
@pytest.mark.parametrize("shape", [(64, 301, 2), (128, 301, 2), (1, 1, 1),
                                   (5, 3, 7)])
def test_k20_cuda_every_instantiation(card, depth, shape):
    """Programs of depth 1-12 (the register stacks of 2, 4 and 8 and the
    local stack) over levels whose axes merge ([64, 301, 2] -> [64, 602])
    or do not, ragged against 4 and 8 elements a thread (from K20_WIDE
    elements; 1 below), one output: bit-equal to the
    plain version, the instantiation the one the depth asks for."""
    rng = np.random.default_rng(depth)
    B, K, V = shape
    t = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    operands = [
        ops.level_dense(t(rng.normal(0, 2, (1, K, V)).astype(np.float32))),
        ops.level_dense(t(rng.normal(0, 2, (B, 1, 1)).astype(np.float32))),
        ops.level_eq(t(rng.integers(0, 3, (1, K, V)).astype(np.int32)),
                     t(rng.integers(0, 3, (B, 1, 1))),
                     t(rng.integers(0, 3, (B, 1, 1)).astype(np.int8)), False),
        ops.level_sel(t(rng.normal(0, 2, (B, K, V)).astype(np.float32)),
                      t(np.float32(-3.5)), 2)]
    P, Z, A, O = ops.LEVEL_PUSH, ops.LEVEL_ZERO, ops.LEVEL_ADD, \
        ops.LEVEL_ADDOP
    prog = [(Z, 0)] + [(P, k % 4) for k in range(depth - 1)] + \
        [(O, 3), (O, 2)] + [(A, 0)] * (depth - 1) + [(O, 1)]
    assert ops.level_stack(prog) == depth
    words, _shape = ops.level_plan(prog, operands, 3)
    d, narrow, e = ops.K20_KERNELS[words[ops._K20_KERNEL]]
    assert narrow and d >= depth or (depth > 8 and not narrow)
    assert e == ((8 if depth <= 4 else 4) if B * K * V >= ops.K20_WIDE
                 else 1) or not narrow
    assert words[1] == (1 if B * K * V == 1 else 2)   # [B, K x V]
    got = ops.level_sum(prog, operands, 3, B=B, label="test")
    want = ops.level_sum_plain(prog, operands, 3)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_k20_cuda_refuses_what_it_does_not_take(card):
    prog, operands, rank, _w = _level("mixed d1", 0)
    operands = _to(operands, card)
    i = max(j for j, o in enumerate(operands) if o["kind"] == "dense")
    assert i > 0
    bad = [dict(o) for o in operands]
    bad[i] = ops.level_dense(operands[i]["x"].double())
    with pytest.raises(ValueError):
        ops.level_sum(prog, bad, rank)
    with pytest.raises(ValueError):
        ops.level_sum(prog, operands, ops.K20_MAX_DIMS + 1)
    mixed = [dict(o) for o in operands]
    mixed[i] = ops.level_dense(operands[i]["x"].cpu())  # one on the CPU
    with pytest.raises(ValueError):
        ops.level_sum(prog, mixed, rank)


# the card's own K21 cases: scaled's shape with shared and per-row leaves,
# and more rows than a grid's y or z axis holds
CARD_PRIOR_CASES = {
    "scaled": dict(B=4096, cap=11264, full=(4096,)),
    "scaled rows": dict(B=4096, cap=11264, full=(4096,), per_row=True),
    "many rows": dict(B=70001, cap=8, full=(70001,), per_row=True),
    "many rows tail": dict(B=66000, cap=7, full=(66000,), comp=5),
}


def _k21_forced(args, unit):
    """K21 launched with its plan's kernel set to `unit` (1 the flat
    kernel, 4 the row kernel) whatever the call's size: (exist, new)."""
    comp, ch, full = args[6], args[7], args[9]
    K = comp[0].shape[0] if comp is not None else args[0].shape[-1]
    R = int(np.prod(full))
    e = torch.empty((R, K), dtype=torch.float32, device=ch.device)
    n = torch.empty((R,), dtype=torch.float32, device=ch.device)
    words = ops.py_prior_words(*args, e, n)
    words[ops.K21_UNIT] = unit
    arr = (ctypes.c_int64 * ops.K21_WORDS)(*words)
    ops._check(ops._fn("py_prior")(arr, ops.K21_WORDS, ops._stream(ch)),
               "py_prior")
    return e, n


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PRIOR_CASES) + list(CARD_PRIOR_CASES))
def test_k21_cuda_matches_plain(card, case):
    """The plan's kernel (flat or row, by the size) and each of the two
    forced: every output bit-equal to the plain version."""
    kw = PRIOR_CASES.get(case) or CARD_PRIOR_CASES[case]
    inp = _prior_inputs(3, **kw)
    args = _prior_torch(inp, card)
    e0, n0 = ops.py_prior_plain(*args)
    before = ops.LAUNCHES["py_prior"]
    e1, n1 = ops.py_prior(*args, cls="T")
    assert ops.LAUNCHES["py_prior"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(e0, e1) and torch.equal(n0, n1), case
    for unit in (1, 4):
        e1, n1 = _k21_forced(args, unit)
        torch.cuda.synchronize()
        assert torch.equal(e0, e1) and torch.equal(n0, n1), (case, unit)


@pytest.mark.cuda
def test_k21_cuda_refuses_what_it_does_not_take(card):
    inp = _prior_inputs(1, B=3, cap=20, full=(3,), comp=8)
    args = list(_prior_torch(inp, card))
    args[0] = args[0].long()
    with pytest.raises(ValueError):
        ops.py_prior(*args)
    args = list(_prior_torch(inp, card))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        ops.py_prior(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["hospital", "flights"])
def test_graphed_rows_through_k20_bit_equal_to_eager(card, which):
    """A hospital ramp and a flights sweep of 24 rows, once eager with the
    kernels and once as replays of the captured row step: every leaf
    bit-equal, the launch counts equal, K20 among them."""
    from pclean_tpu_torch.engine import smc as tsmc
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.kernel_bench import graph_against_eager
    from pclean_tpu_torch.workloads import flights, hospital

    if which == "hospital":
        cm, cfg = hospital.setup(rows=240, batch=16, device=card)[:2]
    else:
        cm, cfg = flights.setup(rows=300, flights=12, websites=8,
                                capacities={"Flight": 16,
                                            "TrackingWebsite": 16},
                                device=card)[:2]
    arenas, params = init_state(cm, 0, device=card)
    eng = tsmc.Engine(cm, cfg, device=card)
    obs = cm.obs_specs[0].class_id
    before = ops.LAUNCHES["level_sum"]
    if which == "hospital":
        r = graph_against_eager(eng, arenas, params, "ramp", obs, 24)
    else:
        arenas, params, _g = eng.initialize(1, arenas, params)
        r = graph_against_eager(eng, arenas, params, "sweep", obs, 24)
    assert r["mismatches"] == [], r
    assert r["stats"]["captures"] == 1 and r["stats"]["replayed"] == 23
    assert ops.LAUNCHES["level_sum"] > before
