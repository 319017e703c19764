"""A synthetic model past every fixed limit of the card kernels.

Not a deployment: a small relational model whose shapes exceed each
kernel's single-launch limit, so that the port's splits and raised limits
(ops.chain_folds, row_write_chunks, batch_write_chunks, cascade_groups,
level_stages, K10_TIERS, the sample kernels' ancestor axes) run on a real
path. Its classes:

  * a chain C0 -> C1 -> ... -> C8 (an `up` fk each), every link also an
    fk `side` -> S -> T, so that Record's fk tree holds 27 + 2 nodes (K10's
    larger block); each C_k has a `name`;
  * Wide, WIDE stored choices a0..a{WIDE-1} (ChooseUniformly of two
    words): a Record row that births a Wide writes more than K11's 64
    values, a batched Wide step more than K15's 48 columns, and a level
    of the Wide blocks sums more than K20's 64 operands (one a column);
  * Anc, five ChooseUniformly choices x1..x5, each one's options a
    compute_list of the one before: x5's record has four ancestor axes
    (K16/K17 past 3);
  * Record (observed): fks c0 -> C0, w -> Wide and anc -> Anc in blocks of
    their own, and AddTypos observations of C4.name (5 fk hops), C6.name
    (7 hops), C8.name (9 hops: K7's and K14's chains past 8 and 4, K18's
    past 4), of every Wide column and of Anc.x5, and direct observations of
    the same three names (propagated observations along 5, 7 and 9 hops:
    K10's chains past 6).

`build_model(ns)` and `setup(ns=...)` take a namespace of a package's
builder, dists, query and compile (the port's by default), so that the CPU
tests build the same model through pclean_tpu.
"""
from __future__ import annotations

import random
from types import SimpleNamespace

DEPTH = 9           # fk hops from Record to C8
OBSERVED_HOPS = (5, 7, 9)
WIDE = 66
ENTITIES = 4
WORDS = ("alpha", "bravo")
ANC_VOCAB = ("pq", "qr")


def port_ns(device="cuda"):
    from .. import dists
    from ..engine.compile import compile_model
    from ..model.builder import ModelBuilder
    from ..model.query import ObservedDataset, Query

    return SimpleNamespace(d=dists, B=ModelBuilder, Q=Query, DS=ObservedDataset,
                           compile=compile_model, kw={"device": device})


def _next_options(a: str) -> list:
    """x_{k+1}'s options given x_k: two of three words."""
    return ["pq", "qr"] if a == "pq" else ["qr", "rs"]


def _path(k: int) -> str:
    """Record's path to C_{k-1}.name, k fk hops."""
    return ".".join(["c0"] + ["up"] * (k - 1) + ["name"])


def build_model(ns):
    d = ns.d
    b = ns.B()
    with b.cls("T") as c:
        c.choice("tag", d.ChooseUniformly(["t0", "t1"]))
    with b.cls("S") as c:
        c.fk("t", "T")
        c.choice("tag", d.ChooseUniformly(["s0", "s1"]))
    for k in range(DEPTH - 1, -1, -1):
        with b.cls(f"C{k}") as c:
            if k < DEPTH - 1:
                c.fk("up", f"C{k + 1}")
            c.fk("side", "S")
            c.choice("name", d.ChooseUniformly(
                [f"n{k}e{e}" for e in range(ENTITIES)]))
    with b.cls("Wide") as c:
        for j in range(WIDE):
            c.choice(f"a{j}", d.ChooseUniformly(list(WORDS)))
    with b.cls("Anc") as c:
        c.choice("x1", d.ChooseUniformly(list(ANC_VOCAB)))
        for k in range(2, 6):
            c.compute_list(f"o{k}", _next_options, [f"x{k - 1}"])
            c.choice(f"x{k}", d.ChooseUniformly(d.Ref(f"o{k}")))
    with b.cls("Record") as c:
        with c.block():
            c.fk("c0", "C0")
            for h in OBSERVED_HOPS:
                c.choice(f"n{h}", d.AddTypos(d.Ref(_path(h)), 2))
        with c.block():
            c.fk("w", "Wide")
            for j in range(WIDE):
                c.choice(f"a{j}", d.AddTypos(d.Ref(f"w.a{j}"), 2))
        with c.block():
            c.fk("anc", "Anc")
            c.choice("x5", d.AddTypos(d.Ref("anc.x5"), 2))
    return b.finish()


def query_clauses():
    """Each C_{h-1}.name both through Record's AddTypos column (n{h}) and
    observed directly (d{h}: a propagated observation along h hops), each
    Wide column and Anc.x5 through AddTypos."""
    return ([(f"n{h}", _path(h), f"n{h}") for h in OBSERVED_HOPS]
            + [(f"d{h}", _path(h)) for h in OBSERVED_HOPS]
            + [(f"a{j}", f"w.a{j}", f"a{j}") for j in range(WIDE)]
            + [("x5", "anc.x5", "x5")])


def synth(rows: int, seed: int = 0, typo: float = 0.05):
    """(dirty, clean) tables: each row one of ENTITIES entities (its chain
    names, Wide words and Anc path), each cell of an AddTypos column
    typo'd with probability `typo` (one substituted letter)."""
    rng = random.Random(seed)
    anc = []
    for e in range(ENTITIES):
        a = ANC_VOCAB[e % 2]
        for _k in range(4):
            a = _next_options(a)[(e >> _k) & 1]
        anc.append(a)
    cols = [f"n{h}" for h in OBSERVED_HOPS] + \
        [f"d{h}" for h in OBSERVED_HOPS] + \
        [f"a{j}" for j in range(WIDE)] + ["x5"]
    dirty = {c: [] for c in cols}
    clean = {c: [] for c in cols}
    for _ in range(rows):
        e = rng.randrange(ENTITIES)
        vals = [f"n{h - 1}e{e}" for h in OBSERVED_HOPS] * 2 + \
            [WORDS[(e + j) % 2] for j in range(WIDE)] + [anc[e]]
        for c, v in zip(cols, vals):
            clean[c].append(v)
            if rng.random() < typo and c[0] != "d":
                i = rng.randrange(len(v))
                v = v[:i] + rng.choice("xyz") + v[i + 1:]
            dirty[c].append(v)
    return dirty, clean


CAPACITIES = dict({f"C{k}": 8 for k in range(DEPTH)}, S=8, T=8, Wide=8,
                  Anc=8)


def setup(rows=64, batch=8, sweeps=1, seed=0, ns=None, device="cuda",
          **cfg):
    """(cm, config, dirty, clean, query, sweeps) through `ns` (the port's
    by default, on `device`); config is the port's InferenceConfig where
    ns is the port's, else None (the caller builds its own)."""
    ns = port_ns(device) if ns is None else ns
    dirty, clean = synth(rows, seed)
    model = build_model(ns)
    query = ns.Q.build(model, "Record", query_clauses())
    cm = ns.compile(model, [ns.DS(query, dirty)], capacities=CAPACITIES,
                    **ns.kw)
    config = None
    if "device" in ns.kw:
        from ..engine.smc import InferenceConfig

        cfg.setdefault("rejuv_frequency", 16)
        config = InferenceConfig(num_iters=sweeps, batch_rows=batch, **cfg)
    return cm, config, dirty, clean, query, sweeps
