"""K11's plan (ops.row_write_plan, ops.row_write_fill) read as
csrc/row_write.cu reads it, on the CPU.

`run_k11` is the kernel written out in Python over one launch's words
bound to CPU tensors (card=False), reading and writing through the words'
addresses as the kernel does (the group table's and the writes' fields
each an array of its own): a thread a group loads its slot and masks
and a thread a write its value (the element's bytes, by its dtype's size),
every load before any store; each group resolves its slot under the drop
rule and its masks into the block's shared table; then each write, in an
order of its own (the threads store in no order), stores where no later
write into its column (the plan's links) applies at its slot. Held bit for
bit to K11's plain version (ops.row_write_plain) and to pclean_tpu's
smc.apply_row on kernel_bench.row_state's seeded states of the hospital,
flights and chain models (accept and reject, mark_alive on and off, births
new and not, slots -1, at the capacity and past it), with two births of
one class at one slot, with sources, slots and columns of mixed dtypes,
and on the limits model's Record row that births a Wide, past one launch's
64 writes, in two launches.
"""
import ctypes
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pclean_tpu.engine import smc as jsmc
from pclean_tpu.engine.propose import Birth as JBirth
from pclean_tpu_torch import ops
from pclean_tpu_torch.engine import smc as tsmc
from pclean_tpu_torch.engine.propose import Birth as TBirth
from test_torch_row_kernels import MODELS, _row, models  # noqa: F401

_SIZE = {0: 1, 1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 4, 7: 8}
_CT = {0: ctypes.c_uint8, 1: ctypes.c_int8, 2: ctypes.c_uint8,
       3: ctypes.c_int16, 4: ctypes.c_int32, 5: ctypes.c_int64,
       6: ctypes.c_float, 7: ctypes.c_double}


def ld_bits(p: int, sz: int) -> int:
    """The kernel's ld_bits: sz bytes at p (0: no load)."""
    return int.from_bytes(ctypes.string_at(p, sz), "little") if sz else 0


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def bits_f(v: int, dt: int) -> float:
    if dt == 6:
        return float(struct.unpack("<f", v.to_bytes(4, "little"))[0])
    if dt == 7:
        return struct.unpack("<d", v.to_bytes(8, "little"))[0]
    return float(bits_i(v, dt))


def bits_i(v: int, dt: int) -> int:
    """bits_i: the element as an integer, a float truncated toward 0."""
    if dt in (1, 3, 4, 5):
        return _signed(v, 8 * _SIZE[dt])
    if dt in (6, 7):
        return int(np.trunc(bits_f(v, dt)))
    return v


def st(p: int, dt: int, i: int, v) -> None:
    """pclean_st_i for an int v (a bool stores v != 0, an int narrows as a
    C cast), or a float v stored into a float or bool column."""
    c = _CT[dt]
    if dt == 0:
        v = int(v != 0)
    elif dt < 6:
        v = _signed(int(v), 8 * ctypes.sizeof(c)) if dt != 2 else \
            int(v) & 255
    else:
        v = float(v)
    c.from_address(p + i * ctypes.sizeof(c)).value = v


def run_k11(words, order_seed: int = 0) -> None:
    """csrc/row_write.cu's kernel over one launch's bound words."""
    w = list(words)
    assert len(w) == ops.K11_WORDS
    n, ng = w[0], w[1]
    assert 0 <= n <= ops.K11_MAX_WRITES and 0 <= ng <= ops.K11_MAX_GROUPS
    # every load first: a thread a group, a thread a write
    grp = [[w[base + g] for base in (ops.K11_G_SLOT, ops.K11_G_MA,
                                     ops.K11_G_MB, ops.K11_G_PK)]
           for g in range(ng)]
    wr = [[w[base + j] for base in (ops.K11_W_DST, ops.K11_W_SRC,
                                    ops.K11_W_PK)] for j in range(n)]
    gl = []
    for slot, ma, mb, pk in grp:
        assert slot
        gl.append((pk, ma, mb, ld_bits(slot, _SIZE[pk & 15]),
                   ld_bits(ma, _SIZE[pk >> 4 & 15] if ma else 0),
                   ld_bits(mb, _SIZE[pk >> 8 & 15] if mb else 0)))
    vl = []
    for j, (dst, src, pk) in enumerate(wr):
        assert dst and (pk >> 8 & 255) < ng
        assert pk >> 16 == 0 or j + 1 < pk >> 16 <= n   # links go forward
        vl.append(ld_bits(src, _SIZE[pk >> 4 & 15] if src else 0))
    # each group's slot (the drop rule) and masks: the shared table
    sh = []
    for pk, ma, mb, sb, ab, bb in gl:
        length = pk >> 12
        s = bits_i(sb, pk & 15)
        s = s + length if s < 0 else s
        ok = (not ma or bits_i(ab, pk >> 4 & 15) != 0) and \
            (not mb or bits_i(bb, pk >> 8 & 15) != 0) and 0 <= s < length
        sh.append((s, ok))
    # the stores, the threads in an order of their own
    for j in np.random.default_rng(order_seed).permutation(n):
        dst, src, pk = wr[j]
        s, ok = sh[pk >> 8 & 255]
        if not ok:
            continue
        nx, last = pk >> 16, True
        while nx:
            npk = wr[nx - 1][2]
            if sh[npk >> 8 & 255] == (s, True):
                last = False
                break
            nx = npk >> 16
        if not last:
            continue
        ddt, sdt = pk & 15, pk >> 4 & 15
        if not src or sdt < 6:
            v = bits_i(vl[j], sdt) if src else 1
            st(dst, ddt, s, float(v) if ddt >= 6 else v)
            continue
        vf = bits_f(vl[j], sdt)
        if ddt == 6:
            vf = float(np.float32(vf))
        st(dst, ddt, s, vf if ddt in (0, 6, 7) else int(np.trunc(vf)))


def k11_cpu(car, slot, env2, births, accept, mark_alive=False,
            seed: int = 0) -> int:
    """ops.row_write's plan for this row, bound to the CPU carry and read
    by run_k11, launch after launch; returns the launches."""
    if isinstance(accept, bool):
        accept = None if accept else torch.zeros((1,), dtype=torch.bool)
    plan = ops.row_write_plan(car, env2, births, mark_alive, card=False)
    launches = ops.row_write_fill(plan, slot, env2, births, accept,
                                  card=False)
    for i, words in enumerate(launches):
        run_k11(words, seed + i)
    return len(launches)


def _equal(a, b, what):
    for c in a:
        for v, x in a[c]["values"].items():
            y = b[c]["values"][v]
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {c}.{v}"
        assert torch.equal(a[c]["alive"], b[c]["alive"]), f"{what}: {c}.alive"


def _equal_jax(aj, at, what):
    for c in aj:
        for v, x in aj[c]["values"].items():
            np.testing.assert_array_equal(np.asarray(x),
                                          at[c]["values"][v].numpy(),
                                          err_msg=f"{what}: {c}.{v}")
        np.testing.assert_array_equal(np.asarray(aj[c]["alive"]),
                                      at[c]["alive"].numpy(),
                                      err_msg=f"{what}: {c}.alive")


def _carries(m, cid, at):
    a_k, _r = tsmc.own_carry(m.cm_t, cid, at)
    a_p, _r = tsmc.own_carry(m.cm_t, cid, at)
    return (ops.RowCarry(m.cm_t, cid, a_k), a_k), \
        (ops.RowCarry(m.cm_t, cid, a_p), a_p)


@pytest.mark.parametrize("mark_alive", [True, False])
@pytest.mark.parametrize("accept", [True, False])
@pytest.mark.parametrize("which", MODELS)
def test_k11_plan_read_as_the_kernel_reads_it(  # noqa: F811
        models, which, accept, mark_alive):
    m = models(which)
    at, aj = m.state(5)
    rng = np.random.default_rng(6)
    for cid in [m.obs_cid] + m.latents():
        (car_k, a_k), (car_p, a_p) = _carries(m, cid, at)
        aj2 = aj
        cap = m.cm_t.layouts[cid].capacity
        for k, slot in enumerate((2, cap - 1, -1, cap, cap + 3)):
            (env_t, b_t), (env_j, b_j) = _row(m, cid, rng, slot, k % 2 == 0)
            st_ = torch.tensor([slot])
            acc = torch.tensor([accept])
            aj2 = jsmc.apply_row(m.cm_j, cid, aj2, slot, env_j, b_j,
                                 jnp.asarray(accept), mark_alive)
            ops.row_write_plain(car_p, st_, env_t, b_t, acc, mark_alive)
            assert k11_cpu(car_k, st_, env_t, b_t, acc, mark_alive, k) == 1
            what = f"{which} {cid} slot {slot}"
            _equal(a_k, a_p, what)
            _equal_jax(aj2, a_k, what)


@pytest.mark.parametrize("which", MODELS)
def test_k11_two_births_of_one_class_at_one_slot(models, which):  # noqa: F811
    """Births into one class in list order: two at one slot under every
    is_new pair (the last that applies stores), one at another slot and
    one at -1 beside them; the row's own values rejected and accepted."""
    m = models(which)
    at, aj = m.state(8)
    rng = np.random.default_rng(9)
    for cid in [m.obs_cid] + m.latents():
        lay = m.cm_t.layouts[cid]
        fkv = lay.fk_vertices[0]
        tc = m.cm_t.node(cid, fkv).target_class
        tcap = m.cm_t.layouts[tc].capacity
        tvs = list(m.cm_t.layouts[tc].store)[:3]
        (car_k, a_k), (car_p, a_p) = _carries(m, cid, at)
        aj2 = aj
        for r, (n1, n2) in enumerate(((True, True), (True, False),
                                      (False, True), (False, False))):
            (env_t, _b), (env_j, _bj) = _row(m, cid, rng, r + 1, False)
            bs = int(rng.integers(0, tcap))
            spec = [(bs, n1), (tcap - 1 - bs, True), (bs, n2), (-1, True)]
            b_t, b_j = [], []
            for s, new in spec:
                vals = {v: int(rng.integers(0, 4)) if
                        m.cm_t.layouts[tc].store[v] == "i" else
                        float(np.float32(rng.random())) for v in tvs}
                b_t.append(TBirth(fkv, tc, torch.tensor([new]),
                                  torch.tensor([s]),
                                  {v: torch.tensor([x]) for v, x in
                                   vals.items()}))
                b_j.append(JBirth(fkv, tc, jnp.asarray(new), jnp.asarray(s),
                                  {v: jnp.asarray(x) for v, x in
                                   vals.items()}))
            accept = r != 3
            acc = torch.tensor([accept])
            st_ = torch.tensor([r + 1])
            aj2 = jsmc.apply_row(m.cm_j, cid, aj2, r + 1, env_j, b_j,
                                 jnp.asarray(accept), False)
            ops.row_write_plain(car_p, st_, env_t, b_t, acc)
            plan = ops.row_write_plan(car_k, env_t, b_t, False, card=False)
            # each birth its own group, every column of the class linked
            # from the first birth's write to the third's
            words = plan["chunks"][0]["words"]
            assert words[1] == 1 + len(spec)
            k11_cpu(car_k, st_, env_t, b_t, acc, seed=r)
            what = f"{which} {cid} births {spec}"
            _equal(a_k, a_p, what)
            _equal_jax(aj2, a_k, what)


_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
           torch.int64, torch.float32, torch.float64)


@pytest.mark.parametrize("slot_dt", [torch.int32, torch.int64])
@pytest.mark.parametrize("which", ["hospital", "flights"])
def test_k11_mixed_dtypes(models, which, slot_dt):  # noqa: F811
    """Sources of every dtype into int32 and float32 columns (a float into
    an int truncates, a bool into a float is 0 or 1), the alive bit, slots
    of int32 and int64 and both masks: the plan read as the kernel reads
    it against the plain version."""
    m = models(which)
    at, _aj = m.state(11)
    rng = np.random.default_rng(12)
    for cid in [m.obs_cid] + m.latents():
        (car_k, a_k), (car_p, a_p) = _carries(m, cid, at)
        cap = m.cm_t.layouts[cid].capacity
        for r in range(6):
            (env_t, b_t), _j = _row(m, cid, rng, r, r % 2 == 0)
            dts = rng.permutation(len(_DTYPES))

            def cast(x, i):
                dt = _DTYPES[dts[i % len(dts)]]
                return (x * 3.7).to(dt) if dt.is_floating_point else \
                    x.to(dt)

            env_t = {v: cast(x, i) for i, (v, x) in enumerate(env_t.items())}
            b_t = [TBirth(b.fk_vid, b.target_class, b.is_new,
                          b.slot.to(slot_dt),
                          {v: cast(x, i + j) for j, (v, x) in
                           enumerate(b.values.items())})
                   for i, b in enumerate(b_t)]
            slot = [r, -1, cap, cap - 1, -cap, -cap - 1][r]
            st_ = torch.tensor([slot], dtype=slot_dt)
            acc = torch.tensor([r != 4])
            ops.row_write_plain(car_p, st_, env_t, b_t, acc, r % 3 == 0)
            k11_cpu(car_k, st_, env_t, b_t, acc, r % 3 == 0, r)
            _equal(a_k, a_p, f"{which} {cid} row {r}")


def test_k11_limits_wide_row_in_two_launches():
    """The limits model's Record row that births a Wide: its writes past
    one launch's 64, two launches in order, bit-equal to the plain
    version (every Wide column linked to no other, each launch with its
    own group table)."""
    from pclean_tpu_torch.kernel_bench import row_state
    from pclean_tpu_torch.workloads import limits

    cm = limits.setup(rows=64, batch=8, device="cpu")[0]
    arenas = row_state(cm, 3, device="cpu")
    lay = cm.layouts["Record"]
    rng = np.random.default_rng(4)
    a_k, _r = tsmc.own_carry(cm, "Record", arenas)
    a_p, _r = tsmc.own_carry(cm, "Record", arenas)
    car_k, car_p = ops.RowCarry(cm, "Record", a_k), \
        ops.RowCarry(cm, "Record", a_p)
    for r, (slot, wslot) in enumerate(((1, 2), (3, -1), (5, 2))):
        env2 = {v: torch.tensor([int(rng.integers(0, 4))], dtype=torch.int32)
                for v in lay.store}
        wide = TBirth(lay.fk_vertices[1], "Wide", torch.tensor([r != 2]),
                      torch.tensor([wslot]),
                      {v: torch.tensor([int(rng.integers(0, 9))])
                       for v in cm.layouts["Wide"].store})
        acc = torch.tensor([True])
        st_ = torch.tensor([slot])
        ops.row_write_plain(car_p, st_, env2, [wide], acc, True)
        plan = ops.row_write_plan(car_k, env2, [wide], True, card=False)
        assert len(plan["chunks"]) >= 2
        assert k11_cpu(car_k, st_, env2, [wide], acc, True, r) == \
            len(plan["chunks"])
        _equal(a_k, a_p, f"limits row {r}")
