"""Rents workload: continuous and discrete latents with learned means.

The port's own copy of experiments/rents.py (county_key, build_model,
QUERY_CLAUSES, setup), which cannot be imported because it imports jax, and
`synth`, a seeded generator of the rents schema, because the source's
rents_dirty.csv / rents_clean.csv are not in the repository. The model
(reference experiments/rents/run.jl): County keyed by a derived
@guaranteed countykey with per-key name possibilities; Obs with an indexed
learned Mean per (state, countykey, room type), a TransformedGaussian rent
under a latent unit (dollars, or thousands of dollars), AddTypos
(max_typos=2) on the county name, and the queried `corrected =
round(unit.backward(rent))`. Reference config: MH, 1 sweep,
rejuv_frequency=500; County capacity 4,096.
"""
from __future__ import annotations

import random

import torch

from ..dists import (AddTypos, ChooseProportionally, ChooseUniformly, Mean,
                     ParamRef, Proportions, Ref, StringPrior, Transformation,
                     TransformedGaussian, Unmodeled)
from ..engine.compile import compile_model
from ..engine.smc import InferenceConfig
from ..model.builder import ModelBuilder
from ..model.query import ObservedDataset, Query
from .scaled import _typo

CAPACITIES = {"County": 4096}
ROOM_TYPES = ["studio", "1br", "2br", "3br", "4br"]
UNITS = [Transformation(lambda x: x, lambda x: x, lambda x: 1.0),
         Transformation(lambda x: x / 1000.0, lambda x: x * 1000.0,
                        lambda x: 1.0 / 1000.0)]
# the 50 US states and DC, as the source's State column codes them
STATES = ["AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "DC", "FL", "GA",
          "HI", "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA",
          "MI", "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ", "NM", "NY",
          "NC", "ND", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX",
          "UT", "VT", "VA", "WA", "WV", "WI", "WY"]
_STEMS = ["ash", "bar", "bel", "ber", "bro", "cal", "car", "cha", "cla",
          "dal", "del", "dor", "elm", "fair", "fer", "gar", "glen", "ham",
          "har", "hol", "jef", "ken", "lan", "lin", "mar", "mer", "mon",
          "nor", "oak", "pen", "ran", "ros", "sal", "sha", "ston", "tay",
          "val", "war", "wil", "york"]
_ENDS = ["ton", "ford", "ville", "field", "wood", "son", "ley", "more",
         "dale", "land", "burg", "mont", "ridge", "well", "ham"]


def county_key(name: str) -> str:
    """reference load_data.jl:9: first char + last char of the first word."""
    return f"{name[0]}{name.split()[0][-1]}"


def synth(rows: int = 50_000, states: int = 51, counties: int = 1500,
          seed: int = 7, missing: float = 0.0):
    """(dirty, clean) column dicts of the rents schema (County, State, Room
    Type, Monthly Rent; dirty also gets the derived CountyKey, as
    experiments/rents.py:86 derives it), drawn from a seeded latent
    database:

      * `states` states (the first of STATES) and `counties` counties, each
        in a uniform state, named "<Word> County" with the word drawn from a
        shared pool of counties // 3 words, so a name recurs in about three
        states as US county names do (a (state, name) pair is unique);
      * 5 room types; a mean rent per (county, room type), uniform in
        [500, 3000] dollars;
      * each row: a uniform county and room type, and a clean rent of
        round(Normal(mean, 150)) dollars;
      * dirty rent: missing in a share `missing` of the rows, reported in
        thousands (clean / 1000, the second unit) in another 10%, else the
        clean rent. `missing` is 0 by default: pclean_tpu's tracer cannot
        draw an unobserved TransformedGaussian whose mean carries an
        enumeration axis that the unit does not (the take_along_axis of
        pclean_tpu/engine/kernels.py:458-461 raises), so every comparison
        with the JAX package runs without missing rents; the port's own
        tests run it at 0.05;
      * dirty county name: misspelled in 10% of rows, each misspelling drawn
        from a pool of 3 variants of that name (one insert, delete,
        substitute or transpose each, as workloads/scaled.py draws them),
        so the CountyKey of a misspelled name may change too.
    """
    rng = random.Random(seed)
    state_codes = STATES[:states]
    words = [f"{s}{e}".capitalize() for s in _STEMS for e in _ENDS]
    pool = rng.sample(words, min(len(words), max(1, counties // 3)))
    c_state, c_name, seen = [], [], set()
    while len(c_name) < counties:
        st, nm = rng.randrange(states), f"{rng.choice(pool)} County"
        if (st, nm) in seen:
            continue
        seen.add((st, nm))
        c_state.append(st)
        c_name.append(nm)
    mean = [[rng.uniform(500.0, 3000.0) for _ in ROOM_TYPES]
            for _ in range(counties)]
    variants = {nm: [_typo(nm, rng) for _ in range(3)]
                for nm in sorted(set(c_name))}
    cols = ("County", "State", "Room Type", "Monthly Rent")
    dirty = {c: [] for c in cols}
    clean = {c: [] for c in cols}
    for _ in range(rows):
        c = rng.randrange(counties)
        br = rng.randrange(len(ROOM_TYPES))
        rent = float(round(rng.gauss(mean[c][br], 150.0)))
        nm, st = c_name[c], state_codes[c_state[c]]
        u = rng.random()
        dirty_rent = None if u < missing else \
            rent / 1000.0 if u < missing + 0.10 else rent
        dirty_nm = rng.choice(variants[nm]) if rng.random() < 0.10 else nm
        for col, d, v in (("County", dirty_nm, nm), ("State", st, st),
                          ("Room Type", ROOM_TYPES[br], ROOM_TYPES[br]),
                          ("Monthly Rent", dirty_rent, rent)):
            dirty[col].append(d)
            clean[col].append(v)
    dirty["CountyKey"] = [county_key(x) for x in dirty["County"]]
    return dirty, clean


def build_model(possibilities, states):
    b = ModelBuilder()
    with b.cls("County") as c:
        c.learned("state_pops", Proportions())
        c.choice("countykey", Unmodeled())
        c.guaranteed("countykey")
        c.compute_list("name_options",
                       lambda k: possibilities.get(k, []), ["countykey"])
        c.choice("name", StringPrior(10, 35, Ref("name_options")))
        c.choice("state", ChooseProportionally(states, ParamRef("state_pops")))
    with b.cls("Obs") as c:
        c.learned("avg_rent", Mean(1500.0, 1000.0), indexed=True)
        c.fk("county", "County")
        c.choice("county_name", AddTypos(Ref("county.name"), 2))
        c.choice("br", ChooseUniformly(ROOM_TYPES))
        c.choice("unit", ChooseUniformly(UNITS))
        c.compute("rent_key", lambda s, k, br: f"{s}_{k}_{br}",
                  ["county.state", "county.countykey", "br"])
        c.param_lookup("rent_base", "avg_rent", key="rent_key")
        c.choice("rent", TransformedGaussian(Ref("rent_base"), 150.0,
                                             Ref("unit")))
        # corrected = round(unit.backward(rent)) (run.jl:26)
        c.compute_tensor(
            "corrected",
            lambda u, r: torch.round(torch.where(u == 0, r, r * 1000.0)),
            ["unit", "rent"])
    return b.finish()


QUERY_CLAUSES = [
    ("CountyKey", "county.countykey"),
    ("County", "county.name", "county_name"),
    ("State", "county.state"),
    ("Room Type", "br"),
    ("Monthly Rent", "corrected", "rent"),
]


def model_inputs(dirty):
    """(possibilities, states) of experiments/rents.py's setup: the dirty
    county names under each key, in first-seen order, and the states."""
    possibilities: dict[str, list] = {}
    for name in dirty["County"]:
        opts = possibilities.setdefault(county_key(name), [])
        if name not in opts:
            opts.append(name)
    states = list(dict.fromkeys(v for v in dirty["State"] if v is not None))
    return possibilities, states


def setup(rows=50_000, states=51, counties=1500, seed=7, missing=0.0,
          sweeps=None, batch=256, particles=None, device="cuda", **cfg):
    """Compiled workload on `synth`'s data: (cm, config, dirty, clean,
    query, sweeps); observed class 'Obs'."""
    dirty, clean = synth(rows, states, counties, seed, missing)
    model = build_model(*model_inputs(dirty))
    query = Query.build(model, "Obs", QUERY_CLAUSES)
    ds = ObservedDataset(query, dirty)
    sweeps = 1 if sweeps is None else sweeps
    cfg.setdefault("rejuv_frequency", 500)
    if particles:
        cfg.update(use_mh_instead_of_pg=False, num_particles=particles)
    config = InferenceConfig(num_iters=sweeps, batch_rows=batch, **cfg)
    cm = compile_model(model, [ds], capacities=CAPACITIES, device=device)
    return cm, config, dirty, clean, query, sweeps
