"""K18 row_gather over groups of chains, and the tracer's grouped reads.

CPU: the group plain version (row_gather_group_plain, the kernel's walk of
row_gather_plan's hop-column tree) against row_gather_plain chain by
chain, with clamped and out-of-range indices at every hop; the plan's
launches within K18_MAX_NODES and K18_MAX_CHAINS, shared prefixes loaded
once; K18's words read as csrc/row_gather.cu reads them (a Python reading
through the CPU tensors' addresses). On the port's small scaled, flights
and hospital models: every copy-mode read of a block lies in its fk's
copy_groups entry and each (fk, depth, slots) is gathered once; every
block's records, logZ, sampled values and births with the grouped reads
bit-equal to the tracer reading each vertex by its own row_value (the
parent's copy mode), drawn and retained.

Card (`cuda` marker; `python -m pytest -m cuda
tests/test_torch_gather_groups.py` on the H100): the group kernel against
the plain version, bit-equal, one launch a plan launch. No JAX here.
"""
import ctypes

import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.engine import propose as tprop

I8, I16, I32, I64 = torch.int8, torch.int16, torch.int32, torch.int64
F32 = torch.float32


def _group(seed, n_chains=6, cap=40, shared=True):
    """A seeded group: columns of several dtypes and lengths whose values
    run 3 past both ends of the next column (clamped), chains of 0-4 hops
    drawn over a few hop columns (so prefixes repeat where `shared`), a
    leaf of any dtype each; slots [5, 3] from -3 to past the first
    column."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(3, cap)) for _ in range(6)]
    hop = [torch.as_tensor(rng.integers(-3, n + 3, lens[(i + 1) % 6])
                           ).to([I32, I64, I16, I8, I32, I64][i])
           for i, n in enumerate(lens)]
    leaves = [torch.as_tensor(rng.normal(0, 5, n)).to(dt) for n, dt in
              zip(lens, [F32, I32, I8, I64, torch.float64, torch.bool])]
    chains = []
    for _ in range(n_chains):
        k = int(rng.integers(0, 5))
        start = 0 if shared else int(rng.integers(0, 6))
        idx = [(start + j) % 6 for j in range(k)]
        chains.append(([hop[i] for i in idx], leaves[(start + k) % 6]))
    slot = torch.as_tensor(rng.integers(-3, lens[0] + 4, (5, 3)))
    return slot, chains


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shared", [True, False])
def test_group_plain_is_each_chain(seed, shared):
    slot, chains = _group(seed, 9, shared=shared)
    chains.append((chains[0][0] * 2, chains[0][1]))   # 0-8 hops: one past
    got = ops.row_gather_group_plain(slot, chains)
    got2 = ops.row_gather_group(slot, chains)   # the CPU wrapper
    for (hops, leaf), g, g2 in zip(chains, got, got2):
        want = ops.row_gather_plain(slot, hops, leaf)
        assert g.dtype == want.dtype == leaf.dtype
        assert g.shape == slot.shape
        assert torch.equal(g, want) and torch.equal(g2, want)


def test_plan_shares_prefixes_and_splits_at_the_limits():
    P = ops.row_gather_plan
    spec = (((0, 1), 5), ((0, 1), 6), ((0,), 7), ((), 8), ((2,), 5))
    (nodes, leaves), = P(spec)
    assert nodes == ((0, 0), (1, 1), (2, 0))   # 0, 0 -> 1, 2
    assert leaves == ((0, 2, 5), (1, 2, 6), (2, 1, 7), (3, 0, 8),
                      (4, 3, 5))
    many = tuple(((g % 3, 10 + g % 5), 20 + g) for g in range(40))
    for spec in (many, tuple(((g, g + 50), 99) for g in range(9))):
        launches = P(spec)
        assert len(launches) > 1
        seen = []
        for nodes, leaves in launches:
            assert len(nodes) <= ops.K18_MAX_NODES
            assert 1 <= len(leaves) <= ops.K18_MAX_CHAINS
            assert all(0 <= p <= j for j, (_c, p) in enumerate(nodes))
            assert len(set(nodes)) == len(nodes)
            for g, node, leaf in leaves:   # the node's path is the hops
                path = []
                while node:
                    path.insert(0, nodes[node - 1][0])
                    node = nodes[node - 1][1]
                assert tuple(path) == spec[g][0] and leaf == spec[g][1]
                seen.append(g)
        assert seen == list(range(len(spec)))
    with pytest.raises(ValueError):
        P((((1, 2, 3, 4, 5), 0),))


_CT = {0: ctypes.c_uint8, 1: ctypes.c_int8, 2: ctypes.c_uint8,
       3: ctypes.c_int16, 4: ctypes.c_int32, 5: ctypes.c_int64,
       6: ctypes.c_float, 7: ctypes.c_double}
_BITS = {1: ctypes.c_uint8, 2: ctypes.c_uint16, 4: ctypes.c_uint32,
         8: ctypes.c_uint64}


def _read_k18(words, n_out):
    """csrc/row_gather.cu's kernel, written out in Python over the plan:
    the class's slots (the unused ones 0), each slot's offset by the sizes
    and strides where it is not contiguous, the tree's nodes in order, each
    chain's leaf bytes copied to its output at the slot's position."""
    N, dims, sp, sdt, contig = words[:5]
    sizes, strides = words[5:5 + dims], words[13:13 + dims]
    n_nodes, n_chains, cls = words[21], words[22], words[23]
    most_nodes, most_chains = ops.K18_CLASSES[cls]
    assert n_nodes <= most_nodes and n_chains <= most_chains
    assert len(words) == 24 + 4 * most_nodes + 5 * most_chains
    nodes = [words[24 + 4 * j: 28 + 4 * j] for j in range(n_nodes)]
    c0 = 24 + 4 * most_nodes
    chains = [words[c0 + 5 * g: c0 + 5 * g + 5] for g in range(n_chains)]
    assert not any(words[24 + 4 * n_nodes:c0] + words[c0 + 5 * n_chains:])
    assert n_chains == n_out

    def ld(p, dt, i):
        ct = _CT[dt]
        return int(ct.from_address(p + i * ctypes.sizeof(ct)).value)

    for i in range(N):
        off = i
        if not contig:
            off, r = 0, i
            for d in range(dims - 1, -1, -1):
                off += (r % sizes[d]) * strides[d]
                r //= sizes[d]
        t = [ld(sp, sdt, off)]
        for col, dt, n, parent in nodes:
            assert parent <= len(t) - 1
            t.append(ld(col, dt, min(max(t[parent], 0), n - 1)))
        for node, leaf, n, out, es in chains:
            ct = _BITS[es]
            v = ct.from_address(leaf + min(max(t[node], 0), n - 1) * es).value
            ct.from_address(out + i * es).value = v


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("n_chains", [1, 3, 7, 20])
def test_k18_words_read_as_the_kernel_reads_them(seed, strided, n_chains):
    slot, chains = _group(seed, n_chains)
    if strided:
        slot = slot.t()
        assert not slot.is_contiguous()
    cols, spec = ops._chain_spec(chains)
    want = ops.row_gather_group_plain(slot, chains)
    for nodes, leaves in ops.row_gather_plan(spec):
        words, cpos, opos = ops.row_gather_words(slot, cols, nodes, leaves)
        assert len(words) <= ops.K18_WORDS and words[2] == 0
        words[2] = slot.data_ptr()
        for pos, j in cpos:
            assert words[pos] == 0
            words[pos] = cols[j].data_ptr()
        outs = {}
        for pos, g in opos:
            outs[g] = torch.empty(slot.shape, dtype=want[g].dtype)
            words[pos] = outs[g].data_ptr()
        _read_k18(words, len(opos))
        for g, o in outs.items():
            assert torch.equal(o, want[g]), g


# ------------------------------------------------ the tracer's groups


def _model(which):
    from pclean_tpu_torch.engine.compile import init_state
    from pclean_tpu_torch.engine.smc import Engine
    from pclean_tpu_torch.engine.refresh import refresh
    from pclean_tpu_torch.workloads import flights, hospital, scaled

    if which == "hospital":
        cm, cfg = hospital.setup(rows=240, batch=16, device="cpu")[:2]
    elif which == "flights":
        cm, cfg = flights.setup(rows=300, flights=12, websites=8,
                                capacities={"Flight": 16,
                                            "TrackingWebsite": 16},
                                device="cpu")[:2]
    else:
        cm, cfg = scaled.setup(rows=600, counties=12, hospitals=40,
                               names=30, zips=10, batch=16,
                               device="cpu")[:2]
    eng = Engine(cm, cfg, device="cpu")
    arenas, params = init_state(cm, 0, device="cpu")
    arenas, params, _g = eng.initialize(1, arenas, params)
    return cm, eng, arenas, params, refresh(cm, arenas, eng.obs_dev)


@pytest.fixture(scope="module", params=["hospital", "flights", "scaled"])
def model(request):
    return request.param, _model(request.param)


def _blocks(m, cid, slots, seed, retained):
    """Every block of class cid in plan order, each fed the env the one
    before it sampled (Engine._propose's chain), on one seeded generator:
    per block (logZ, records, env, births)."""
    cm, eng, arenas, params, rel = m
    gen = torch.Generator().manual_seed(seed)
    st = torch.as_tensor(slots)
    obs_row = eng._obs_row_slices(cid, st, rel)
    env, out = {}, []
    for plan in cm.cls(cid).plans:
        tr = tprop.BlockTracer(cm, cid, arenas, rel, params, eng.obs_dev,
                               obs_row, env, st, force_retained=retained)
        logZ, res = tr.run(plan, gen)
        out.append((logZ, dict(tr.records), res.env, res.births))
        env = res.env
    return out


def _one_by_one(self, cache, node, depth, src, slot):
    """The parent's copy mode: each vertex by its own row_value at the
    fk's slots."""
    tc = tprop._fk(self.cm, self.cid, node.fk_id).target_class
    return self.row_value(tc, node.sub_id, slot)


def _slots(cm, cid, n, seed):
    cap = cm.layouts[cid].capacity
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(min(cap, 200), n, replace=False))


def test_copy_groups_hold_every_copy_read(model, monkeypatch):
    """Every copy-mode read of every block (both passes, one row and a
    batch) is of a target vertex in its fk's copy_groups entry, and the
    reads of one (fk, depth, slots) come from one gather of the group."""
    name, m = model
    cm = m[0]
    reads, gathers = [], []
    real_copy, real_values = tprop.BlockTracer._copy_value, tprop.row_values

    def copy_spy(self, cache, node, depth, src, slot):
        groups = tprop.copy_groups(self.cm, self.cid, self._root_plan)
        assert node.sub_id in groups[node.fk_id], (name, node)
        reads.append((id(cache), node.fk_id, depth, src))   # src kept
        return real_copy(self, cache, node, depth, src, slot)

    def values_spy(*a, **kw):
        if str(kw.get("label", "")).endswith("copy"):
            gathers.append(a[4])
        return real_values(*a, **kw)

    monkeypatch.setattr(tprop.BlockTracer, "_copy_value", copy_spy)
    monkeypatch.setattr(tprop, "row_values", values_spy)
    for cid in cm.model.class_order:
        for n in (1, 6):
            _blocks(m, cid, _slots(cm, cid, n, n), 3, False)
    contexts = {(c, fk, d, id(src)) for c, fk, d, src in reads}
    assert len(gathers) == len(contexts) < len(reads), name
    # every plan step read in copy mode is in the group of each fk its
    # chain passes, under the target vertex that fk's node names
    for cid in cm.model.class_order:
        for plan in cm.cls(cid).plans:
            groups = tprop.copy_groups(cm, cid, plan)
            steps = list(plan.steps)
            while steps:
                step = steps.pop()
                steps += step.rest.steps
                node = cm.node(cid, step.idx)
                while isinstance(node, tprop.SubmodelNode):
                    assert node.sub_id in groups[node.fk_id]
                    node = node.subnode
            for fk, subs in groups.items():
                assert len(set(subs)) == len(subs) >= 1


@pytest.mark.parametrize("retained", [False, True])
def test_grouped_reads_bit_equal_to_one_by_one(model, monkeypatch,
                                               retained):
    name, m = model
    cm = m[0]
    for cid in cm.model.class_order:
        for n in (1, 6):
            slots = _slots(cm, cid, n, 7 + n)
            got = _blocks(m, cid, slots, 11, retained)
            with monkeypatch.context() as mp:
                mp.setattr(tprop.BlockTracer, "_copy_value", _one_by_one)
                want = _blocks(m, cid, slots, 11, retained)
            for (lz, rec, env, births), (lz0, rec0, env0, births0) in zip(
                    got, want):
                assert torch.equal(lz, lz0), (name, cid)
                assert rec.keys() == rec0.keys()
                for k in rec:
                    assert torch.equal(rec[k], rec0[k]), (name, cid, k)
                assert env.keys() == env0.keys()
                for v in env:
                    assert torch.equal(env[v], env0[v]), (name, cid, v)
                assert len(births) == len(births0)
                for b, b0 in zip(births, births0):
                    assert torch.equal(b.slot, b0.slot)
                    assert torch.equal(b.is_new, b0.is_new)
                    assert b.values.keys() == b0.values.keys()
                    for v in b.values:
                        assert torch.equal(b.values[v], b0.values[v])


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_chains", [1, 5, 20])
def test_k18_group_matches_plain_on_card(card, seed, n_chains):
    slot, chains = _group(seed, n_chains, cap=300)
    slot = slot.to(card)
    if seed % 2:
        slot = slot.t()
    chains = [([h.to(card) for h in hops], leaf.to(card))
              for hops, leaf in chains]
    cols, spec = ops._chain_spec(chains)
    before = ops.LAUNCHES["row_gather"]
    got = ops.row_gather_group(slot, chains, label="test")
    launches = ops.LAUNCHES["row_gather"] - before
    want = ops.row_gather_group_plain(slot, chains)
    torch.cuda.synchronize()
    assert launches == len(ops.row_gather_plan(spec))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    again = ops.row_gather_group(slot, chains, label="test")   # cached
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(again, want))
