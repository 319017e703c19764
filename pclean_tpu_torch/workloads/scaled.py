"""Scaled synthetic workload: Record -> Hospital -> County entity resolution.

The port's own copy of experiments/scaled.py (synth, build_model,
QUERY_CLAUSES, setup, main: `python -m pclean_tpu_torch.workloads.scaled`),
which cannot be imported because it imports jax. A
generated latent database whose entity count grows with the requested
scale; typo'd observations are drawn from a small per-word variant pool
(recurring misspellings), so the AddTypos vocabulary-pair matrices stay
O((4 * names)^2). The model: County(state ~ ChooseProportionally with
learned Proportions) <- Hospital(loc fk, name and zip ~ StringPrior) <-
Record(hosp fk, name/zip/state observed through AddTypos), Pitman-Yor over
every reference slot.

F1 scores repairs of the typo'd name/zip/state columns against the
generating entities (analysis.jl:36-88 semantics).
"""
from __future__ import annotations

import random
import string

from ..dists import (AddTypos, ChooseProportionally, ParamRef, Proportions,
                     Ref, StringPrior)
from ..engine.compile import compile_model
from ..engine.smc import InferenceConfig
from ..model.builder import ModelBuilder
from ..model.query import ObservedDataset, Query
from .common import run, std_argparser

_ADJ = ["mercy", "memorial", "saint", "unity", "grand", "pioneer", "summit",
        "liberty", "harbor", "crescent", "beacon", "cedar", "willow",
        "granite", "sterling", "horizon", "majestic", "evergreen", "redwood",
        "lakeside", "hillcrest", "fairview", "brookside", "maplewood",
        "northgate", "southport", "eastfield", "westbrook", "silverton",
        "goldcrest", "ironwood", "stonebridge", "clearwater", "springdale",
        "riverbend", "oakmont", "pinehurst", "elmwood", "birchwood",
        "ashford", "glenview", "meadowlark", "sunnyvale", "brightwater",
        "bluffside", "canyon", "prairie", "tundra", "sierra", "cascade"]
_NOUN = ["general", "regional", "community", "university", "childrens",
         "veterans", "baptist", "methodist", "lutheran", "presbyterian",
         "county", "municipal", "district", "valley", "heights", "central",
         "metropolitan", "institute", "sanctuary", "pavilion", "center",
         "clinic", "infirmary", "sanatorium", "hospice", "wellness",
         "healing", "recovery", "surgical", "cardiac", "oncology",
         "pediatric", "maternity", "orthopedic", "neurology", "radiology",
         "trauma", "emergency", "rehabilitation", "specialty"]


def _make_names(n: int) -> list[str]:
    names = []
    for noun in _NOUN:
        for adj in _ADJ:
            names.append(f"{adj} {noun} hospital")
            if len(names) == n:
                return names
    raise SystemExit(f"--names {n} exceeds the generator vocabulary "
                     f"({len(_ADJ) * len(_NOUN)})")


def _typo(word: str, rng: random.Random) -> str:
    """One uniform insert/delete/substitute/transpose (add_typos.jl:9-32)."""
    i = rng.randrange(len(word))
    op = rng.randrange(4)
    letters = string.ascii_lowercase
    if op == 0:
        return word[:i] + rng.choice(letters) + word[i:]
    if op == 1 and len(word) > 1:
        return word[:i] + word[i + 1:]
    if op == 2:
        return word[:i] + rng.choice(letters) + word[i + 1:]
    if i + 1 < len(word):
        return word[:i] + word[i + 1] + word[i] + word[i + 2:]
    return word[:i] + rng.choice(letters) + word[i + 1:]


def synth(rows: int, counties: int, hospitals: int, names: int,
          zips: int = 500, typo_prob: float = 0.05, seed: int = 7):
    """Generate (dirty, clean) column dicts for a latent DB of the given
    entity counts. Each misspelling is drawn from a per-word pool of 3
    precomputed variants (recurring typos, bounded observation vocab).

    Hospitals carry (name, zip) and counties carry (state): same-name
    hospitals disambiguate through zip the way the real workload's 15
    columns do, while every per-column vocabulary stays small enough for
    dense AddTypos pair matrices (names and zips are reused across
    entities; the JOINT signature grows with the entity count)."""
    rng = random.Random(seed)
    states = [f"{a}{b}" for a in string.ascii_lowercase
              for b in string.ascii_lowercase][:50]
    name_vocab = _make_names(names)
    zip_vocab = sorted({f"{rng.randrange(10000, 99999)}" for _ in range(zips * 2)})[:zips]
    county_state = [rng.randrange(len(states)) for _ in range(counties)]
    hosp_county = [rng.randrange(counties) for _ in range(hospitals)]
    hosp_name = [rng.randrange(names) for _ in range(hospitals)]
    hosp_zip = [rng.randrange(len(zip_vocab)) for _ in range(hospitals)]
    variants = {w: [_typo(w, rng) for _ in range(3)]
                for w in name_vocab + states + zip_vocab}

    def noisy(w):
        return rng.choice(variants[w]) if rng.random() < typo_prob else w

    dirty = {"name": [], "state": [], "zip": []}
    clean = {"name": [], "state": [], "zip": []}
    for _ in range(rows):
        h = rng.randrange(hospitals)
        nm = name_vocab[hosp_name[h]]
        st = states[county_state[hosp_county[h]]]
        zp = zip_vocab[hosp_zip[h]]
        for col, v in (("name", nm), ("state", st), ("zip", zp)):
            dirty[col].append(noisy(v))
            clean[col].append(v)
    return dirty, clean, name_vocab, states, zip_vocab


def build_model(name_vocab, states, zip_vocab):
    b = ModelBuilder()
    with b.cls("County") as c:
        c.learned("state_props", Proportions())
        c.choice("state", ChooseProportionally(states,
                                               ParamRef("state_props")))
    with b.cls("Hospital") as c:
        c.fk("loc", "County")
        c.choice("name", StringPrior(5, 40, name_vocab))
        c.choice("zip", StringPrior(5, 5, zip_vocab))
    with b.cls("Record") as c:
        c.fk("hosp", "Hospital")
        c.choice("name_obs", AddTypos(Ref("hosp.name"), 2))
        c.choice("zip_obs", AddTypos(Ref("hosp.zip"), 2))
        c.choice("state_obs", AddTypos(Ref("hosp.loc.state"), 2))
    return b.finish()


QUERY_CLAUSES = [("name", "hosp.name", "name_obs"),
                 ("zip", "hosp.zip", "zip_obs"),
                 ("state", "hosp.loc.state", "state_obs")]


def setup(rows=None, counties=1000, hospitals=8000, names=2000, zips=500,
          sweeps=None, batch=64, typo=0.05, particles=None, seed=7,
          device="cuda", **cfg):
    rows = 1_000_000 if rows is None else rows
    dirty, clean, name_vocab, states, zip_vocab = synth(
        rows, counties, hospitals, names, zips, typo, seed)
    model = build_model(name_vocab, states, zip_vocab)
    query = Query.build(model, "Record", QUERY_CLAUSES)
    ds = ObservedDataset(query, dirty)
    sweeps = 1 if sweeps is None else sweeps
    cfg.setdefault("rejuv_frequency", 500)
    if particles:
        cfg.update(use_mh_instead_of_pg=False, num_particles=particles)
    config = InferenceConfig(num_iters=sweeps, batch_rows=batch, **cfg)
    # Explicit capacities from the generator's own entity counts (1.4x,
    # rounded to 64), as the JAX workload sets them: the auto_capacities
    # distinct-joint-signature bound is far too loose here, since typo
    # variants multiply across columns.
    caps = {"Hospital": (int(hospitals * 1.4) + 127) // 64 * 64,
            "County": (int(counties * 1.4) + 127) // 64 * 64}
    cm = compile_model(model, [ds], capacities=caps, auto_capacities=True,
                       device=device)
    return cm, config, dirty, clean, query, sweeps


def occupancy(eng, arenas) -> dict:
    """experiments/scaled.py's extra result: each class's live slots."""
    return {"occupancy": {c: list(v) for c, v in
                          eng.arena_occupancy(arenas).items()}}


def main(argv=None) -> None:
    p = std_argparser(__doc__)
    p.add_argument("--counties", type=int, default=1000)
    p.add_argument("--hospitals", type=int, default=8000)
    p.add_argument("--names", type=int, default=2000)
    p.add_argument("--zips", type=int, default=500)
    p.add_argument("--typo", type=float, default=0.05)
    args = p.parse_args(argv)
    if args.repeat != 1:
        p.error("scaled sizes its tables by --rows, not --repeat")
    if args.batch == 1 and not args.particles:
        args.batch = 64  # scaled default: blocked Gibbs
    run("scaled", args, setup, extra=occupancy, counties=args.counties,
        hospitals=args.hospitals, names=args.names, zips=args.zips,
        typo=args.typo, seed=args.seed + 7)


if __name__ == "__main__":
    main()
