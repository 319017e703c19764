"""K14 rel_scatter's and K23 py_resample's launch plans, and plain models
of the orders their kernels add in (no JAX, no card):

  * ops.rel_scatter_plan at the census shapes of the six paths and the
    limits model: the route (a thread a source, or a histogram in each
    block's shared memory for a refcount-shaped spec), the blocks, one
    launch; C just under and just over a block's shared memory; specs
    the histogram does not take stay a thread a source;
  * ops.py_resample_plan at the paths' class capacities, the limits
    model's and the largest it takes: threads a block, cluster size,
    slots a thread, launches (scaled's and hospital's classes in one
    launch each); a class past K23_MAX_ROUNDS slots a thread refused;
  * k23_tree_model, csrc/py_resample.cu's sum written out level by level
    with the kernel's slot layout (block b of W holds slots b + W u; the
    levels over a thread's slots in registers, or in rounds of 16 folded
    on a stack in bit-reversed order, then inside a block, then across
    the cluster's blocks), bit-equal to ops.tree_sum_plain on seeded
    float32 terms at P from 1 to 32,768 (and 524,288 in the plan's
    geometry), every cluster size and block the kernel takes, caps that
    are not powers of two;
  * k14_hist_model, csrc/rel_scatter.cu's histogram route written out:
    each block's grid-stride units of sources and their adds into its
    bins, then the flush of every nonzero bin, bit-equal to
    ops.rel_scatter_plain on kernel_bench.k14_inputs specs at 1, 7 and the
    plan's blocks: the exclusion, int32 and int64 fk columns, no alive
    column, wrapping and dropped targets, every source into one target,
    none alive;
  * kernel_bench.sass_paths, which counts K23's lgammaf and logf for its
    operations bound, on a listing written out by hand.
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch import kernel_bench as kb
from pclean_tpu_torch import ops

# (census mode, C, the route the plan takes): scaled's refcounts (Records
# into Hospitals; Hospitals into Counties, a latent replay row's excluding
# a slot), a propagated observation with a code over 1,000,000 Records,
# the batched deltas and the limits model's long chain
K14_SHAPES = [
    ("refcount n=1000000 src=1000000 +1a:1000000 -", 11264, "local"),
    ("refcount n=1000000 src=1000000 +1ax:1000000q -", 11264, "local"),
    ("refcount n=11264 src=11264 +1ax:11264 -", 1472, "thread"),
    ("refcount n=11264 src=11264 +1a:11264 -", 1472, "thread"),
    ("refcount n=100000 src=100000 +1a:100000 -", 1472, "local"),
    ("refcount n=50000 src=50000 +1a:50000 -", 64, "local"),
    ("refcount n=50000 src=50000 +1a:50000 -", 4096, "thread"),   # rents'
    ("refcount n=8192 src=8192 +1a:8192 -", 32, "thread"),
    ("refcount n=4000000 src=4000000 +1a:4000000 -", 100000, "thread"),
    ("prop n=1000000 src=1000000 +1asc:1000000,11264 i32", 11264, "thread"),
    ("prop n=1000000 src=1000000 +1a:1000000,11264 -", 11264, "thread"),
    ("delta n=4096 src=100000 -1as:100000,1000 - idx", 1000, "thread"),
    ("delta n=200000 src=200000 -1a:200000/+1a:200000 -", 4000, "thread"),
    ("delta n=64 src=11264 +1wc:11264,1472 i32 idx", 1472, "thread"),
    ("refcount n=300 src=300 +1a:300,40,40,40,40,40,40,40,40 -", 40,
     "thread"),
]


def _spec(mode, C, dev="cpu", seed=0):
    return kb.k14_inputs(torch.device(dev), mode, C, seed=seed)


def _plan(inp):
    _k, cnt, code, sides, n, slots = inp["args"][:6]
    return ops.rel_scatter_plan(n, cnt.shape[0], sides, code, slots)


@pytest.mark.parametrize("mode,C,route", K14_SHAPES)
def test_rel_scatter_plan_at_census_shapes(mode, C, route):
    n = kb.k14_parse(mode)["n"]
    plan = _plan(_spec(mode, C) if n <= 1000000 else
                 dict(args=(None, torch.zeros(C, dtype=torch.int32), None,
                            [ops.scatter_side([torch.zeros(
                                1, dtype=torch.int32)])], n, None)))
    assert plan["route"] == route and plan["launches"] == 1
    if route == "thread":
        assert plan["blocks"] == -(-n // ops.K14_THREADS)
        return
    assert plan["threads"] == ops.K14_HIST_THREADS
    assert plan["blocks"] == min(ops.N_SMS, -(-n // (
        ops.K14_HIST_THREADS * ops.K14_UNIT)))
    assert plan["smem"] == 4 * C <= ops.K14_SMEM_MAX


def test_rel_scatter_plan_refuses_what_the_histogram_does_not_take():
    col = torch.zeros(1, dtype=torch.int32)
    sides = [ops.scatter_side([col])]
    C = ops.K14_SMEM_MAX // 4
    n = ops.K14_HIST_RATIO * (C + 1)
    # just under and just over a block's shared memory
    assert ops.rel_scatter_plan(n, C, sides, None)["route"] == "local"
    assert ops.rel_scatter_plan(n, C + 1, sides, None)["route"] == "thread"
    assert ops._k14_hist_spec(sides, None, None)
    code = torch.zeros(1, dtype=torch.int32)
    for sd, slots in (([ops.scatter_side([col], code=code)], None),
                      ([ops.scatter_side([col], state=col)], None),
                      ([ops.scatter_side([col, col])], None),
                      ([ops.scatter_side([col.to(torch.int8)])], None),
                      (sides * 2, None), (sides, col.long())):
        assert not ops._k14_hist_spec(sd, code, slots)
        assert ops.rel_scatter_plan(n, 100, sd, code, slots)["route"] == \
            "thread"
    # the thresholds: sources, then sources a target
    assert ops.rel_scatter_plan(ops.K14_HIST_MIN - 1, 100, sides,
                                None)["route"] == "thread"
    n = max(ops.K14_HIST_MIN, 100 * ops.K14_HIST_RATIO)
    assert ops.rel_scatter_plan(n, n // ops.K14_HIST_RATIO, sides,
                                None)["route"] == "local"
    assert ops.rel_scatter_plan(n, n // ops.K14_HIST_RATIO + 1, sides,
                                None)["route"] == "thread"


# (caps of one launch's classes, threads, cluster, slots a thread,
# launches)
K23_SHAPES = [
    ((11264, 1472), 1024, 16, 1, 1),      # scaled
    ((4096,), 256, 16, 1, 1),             # rents
    ((64, 128, 256, 512, 64, 128), 512, 1, 1, 1),   # hospital
    ((160, 160), 256, 1, 1, 1),           # flights
    ((100, 23, 7), 128, 1, 1, 1),
    ((8,) * 9, 32, 1, 1, 1),              # the limits model
    ((1,), 32, 1, 1, 1),
    ((1025,), 256, 8, 1, 1),              # portable clusters
    ((16385,), 1024, 16, 2, 1),
    ((262144,), 1024, 16, 16, 1),
    ((262145, 64), 1024, 16, 32, 1),      # in rounds of 16
    ((1 << 27,), 1024, 16, 8192, 1),
    ((8,) * 70, 32, 1, 1, 2),
]


@pytest.mark.parametrize("caps,T,CL,S,launches", K23_SHAPES)
def test_py_resample_plan(caps, T, CL, S, launches):
    plan = ops.py_resample_plan(list(caps))
    assert len(plan) == launches
    p = plan[0]
    assert (p["threads"], p["cluster"], p["slots"]) == (T, CL, S)
    assert p["blocks"] == (p["hi"] - p["lo"]) * CL
    assert [q["lo"] for q in plan] == list(range(0, len(caps),
                                                 ops.K23_MAX_CLASSES))
    for k, cap in enumerate(caps[:ops.K23_MAX_CLASSES]):
        P = ops._pow2(cap)
        assert p["per_class"][k] == P // min(P, CL * T)


def test_py_resample_plan_refuses_past_its_slots():
    with pytest.raises(ValueError):
        ops.py_resample_plan([(1 << 27) + 1])
    with pytest.raises(ValueError):
        ops.py_resample_plan([64, 1 << 28])


def _geometry(cap: int, T: int, CL: int):
    """The kernel's layout of a class of `cap` slots in blocks of T
    threads, clusters of CL: (W blocks, Tk threads, S slots a thread)."""
    P = ops._pow2(cap)
    W = min(P, CL)
    Tk = min(P // W, T)
    return W, Tk, P // W // Tk


def k23_tree_model(x, T: int, CL: int):
    """csrc/py_resample.cu's sum over one class's terms x (float32 [cap])
    in the geometry (T threads a block, clusters of CL), level by level as
    the kernel takes them: W = min(P, CL) blocks, block b holding slots
    b + W (t + Tk m); the levels over m in registers (past
    K23_MAX_SLOTS, m = r + R g: the levels over g for each round r, the
    rounds taken in bit-reversed order and folded on a stack), over t
    inside each block, then over b across blocks; returns block 0's
    thread 0's sum."""
    cap = x.shape[0]
    P = ops._pow2(cap)
    W, Tk, S = _geometry(cap, T, CL)
    xp = torch.zeros(P, dtype=torch.float32)
    xp[:cap] = x
    v = xp.reshape(S, Tk, W)   # v[m, t, b] is slot b + W (t + Tk m)
    G = min(S, ops.K23_MAX_SLOTS)
    R = S // G
    v = v.reshape(G, R, Tk, W)   # m = r + R g
    w = G // 2
    while w >= 1:   # the register levels over g: slot distance W Tk R w
        v = torch.cat([v[:w] + v[w:2 * w], v[2 * w:]])
        w //= 2
    v = v[0]
    lr = R.bit_length() - 1
    stack = [None] * (lr + 1)
    for j in range(R):   # the rounds in bit-reversed order on a stack
        r = int(f"{j:0{lr}b}"[::-1], 2) if lr else 0
        val, lvl = v[r], 0
        while (j >> lvl) & 1:
            val = stack[lvl] + val
            lvl += 1
        stack[lvl] = val
    v = stack[lr]
    d = Tk // 2
    while d >= 1:   # inside a block: thread t reads t + d
        v = torch.cat([v[:d] + v[d:2 * d], v[2 * d:]])
        d //= 2
    v = v[0]
    h = W // 2
    while h >= 1:   # across blocks: block 0's warp, lane b reads b + h
        v = torch.cat([v[:h] + v[h:2 * h], v[2 * h:]])
        h //= 2
    return v[0]


@pytest.mark.parametrize("th", [32, 128, 1024])
@pytest.mark.parametrize("cl", [1, 2, 4, 8, 16])
def test_k23_tree_model_is_tree_sum_plain(cl, th):
    rng = np.random.default_rng(cl * th)
    caps = [1, 2, 3, 31, 32, 33, 100, 1000, 1024, 1025, 3000, 4096, 5000,
            11264, 16384, 16385, 20000, 32768]
    for cap in caps:
        x = torch.tensor(rng.normal(size=cap).astype(np.float32) *
                         rng.choice([1e-3, 1.0, 1e4], size=cap)
                         .astype(np.float32))
        want = ops.tree_sum_plain(x)
        assert torch.equal(k23_tree_model(x, th, cl), want), (cap, cl, th)
        plan = ops.py_resample_plan([cap])[0]
        assert torch.equal(k23_tree_model(x, plan["threads"],
                                          plan["cluster"]), want), cap
    # a small class in a launch sized for a large one: its cluster's
    # geometry, the class's own W, Tk and S
    big = ops.py_resample_plan([11264, 1472, 64, 5])[0]
    for cap in (1472, 64, 5):
        x = torch.tensor(rng.normal(size=cap).astype(np.float32))
        for T, CL in ((big["threads"], big["cluster"]), (th, cl)):
            assert torch.equal(k23_tree_model(x, T, CL),
                               ops.tree_sum_plain(x))


def test_k23_tree_model_in_rounds_at_the_plans_geometry():
    # more than K23_MAX_SLOTS slots a thread in the plan's own launch
    rng = np.random.default_rng(7)
    for cap in (262145, 400000):
        plan = ops.py_resample_plan([cap])[0]
        assert plan["slots"] == 32
        x = torch.tensor(rng.normal(size=cap).astype(np.float32))
        assert torch.equal(k23_tree_model(x, plan["threads"],
                                          plan["cluster"]),
                           ops.tree_sum_plain(x))


def k14_hist_model(inp: dict, plan: dict) -> None:
    """csrc/rel_scatter.cu's histogram route on CPU tensors, in place on
    inp's cnt: block b of the grid takes units of K14_UNIT consecutive
    sources, unit u at (b 1,024 + thread) + k x (blocks x 1,024); each
    counted source (alive, not the excluded slot) adds the side's sign at
    its target (its fk column read at the source clamped, the drop rule)
    into its block's bins; then every block adds each nonzero bin to cnt."""
    _k, cnt, code, sides, n, slots, exclude, src = inp["args"]
    sd = sides[0]
    C, B = cnt.shape[0], plan["blocks"]
    s = np.arange(n)
    block = (s // ops.K14_UNIT // ops.K14_HIST_THREADS) % B
    w = np.ones(n, np.int64)
    if sd["alive"] is not None:
        w &= sd["alive"].numpy().astype(np.int64)
    if sd["exclude"] and exclude is not None:
        w *= s != int(np.asarray(exclude).reshape(-1)[0])
    col = sd["hops"][0]
    t = col.numpy().astype(np.int64)[np.clip(s, 0, col.shape[0] - 1)]
    t = np.where(t < 0, t + C, t)
    keep = (t >= 0) & (t < C) & (w > 0)
    bins = np.zeros((B, C), np.int64)
    np.add.at(bins, (block[keep], t[keep]), sd["sign"])
    out = cnt.numpy().astype(np.int64)
    for b in range(B):   # the flush: one add a nonzero bin a block
        out += bins[b]
    cnt.copy_(torch.tensor(((out + 2 ** 31) % 2 ** 32 - 2 ** 31)
                           .astype(np.int32)))


K14_MODEL_CASES = [
    ("refcount n=20000 src=20000 +1a:20000 -", 300),
    ("refcount n=20000 src=20000 +1ax:20000 -", 64),
    ("refcount n=30001 src=30001 +1ax:30001q -", 500),
    ("refcount n=9999 src=9999 +1:9999 -", 7),
    ("refcount n=70000 src=70000 +1a:70000 -", 3),
]


@pytest.mark.parametrize("blocks", [None, 1, 7])
@pytest.mark.parametrize("mode,C", K14_MODEL_CASES)
def test_k14_hist_model_matches_plain(mode, C, blocks):
    for seed in (0, 1):
        inp = _spec(mode, C, seed=seed)
        want = kb._tree_map(inp, lambda t: t.clone())
        ops.rel_scatter_plain(*want["args"])
        n = inp["args"][4]
        k14_hist_model(inp, dict(blocks=blocks or ops._k14_blocks(
            "local", n)))
        assert torch.equal(inp["args"][1], want["args"][1])


@pytest.mark.parametrize("edit", ["one target", "wrapped", "none alive"])
def test_k14_hist_model_edges(edit):
    inp = _spec("refcount n=70000 src=70000 +1a:70000 -", 3)
    sd = inp["args"][3][0]
    col = sd["hops"][0]
    if edit == "one target":
        col.fill_(1)
        col[::7] = 3    # dropped
    elif edit == "wrapped":
        col.copy_(-1 - col.abs() % 3)   # every target in [-3, -1]
    else:
        sd["alive"].zero_()
    want = kb._tree_map(inp, lambda t: t.clone())
    ops.rel_scatter_plain(*want["args"])
    plan = _plan(inp)
    assert plan["route"] == "local"
    k14_hist_model(inp, plan)
    assert torch.equal(inp["args"][1], want["args"][1])
    if edit == "one target":
        assert int(want["args"][1][1]) > 0 and int(want["args"][1][0]) == 0


# a listing as cuobjdump -sass prints one: a predicated early exit, a
# predicated branch round a block, a CALL, the trailing self-branch and
# NOPs
SASS = """
        Function : probe
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x0 */
        /*0010*/                   S2R R0, SR_TID.X ;          /* 0x0 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x7, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/              @!P1 BRA 0x80 ;
        /*0050*/                   FADD R2, R2, R3 ;
        /*0060*/                   FMUL R2, R2, R3 ;
        /*0070*/                   CALL.REL.NOINC 0xc0 ;
        /*0080*/                   STG.E [R4.64], R2 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
        /*00b0*/                   NOP;
        /*00c0*/                   FADD R2, R2, R3 ;
        /*00d0*/                   RET.REL.NODEC R20 0x0 ;
        /*00e0*/                   BRA 0xe0;
        /*00f0*/                   NOP;
        ..........
        Function : copy
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   EXIT ;
        /*0020*/                   BRA 0x20;
"""


def test_sass_paths_counts_the_shortest_path():
    got = kb.sass_paths(SASS)
    # the early exit: 4 instructions; through the branch: 7; the callee
    # after the last EXIT is counted in `all`, not entered
    assert got["probe"] == dict(shortest=4, all=14)
    assert got["copy"] == dict(shortest=2, all=2)
