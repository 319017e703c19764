"""Flights workload: multi-source deduplication with per-source error rates.

The port's own copy of experiments/flights.py (CAPACITIES, TIME_FIELDS,
build_model, QUERY_CLAUSES, setup), which cannot be imported because it
imports jax, and `synth`, a seeded generator of the flights schema, because
the source's flights_dirty.csv / flights_clean.csv are not in the
repository. The model (reference experiments/flights/run.jl): Flight keyed
by a @guaranteed flight_id with four TimePrior fields whose atom lists
depend on the latent flight_id; Obs with an indexed learned Prob error rate
per tracking website, bypassed (1e-5) where the website is the flight's own
airline (run.jl:28), and a MaybeSwap observation of each time. Reference
config: MH, 2 particles, 5 sweeps, batch_rows 1.
"""
from __future__ import annotations

import random

from ..dists import MaybeSwap, Prob, Ref, StringPrior, TimePrior
from ..engine.compile import compile_model
from ..engine.smc import InferenceConfig
from ..model.builder import ModelBuilder
from ..model.query import ObservedDataset, Query

CAPACITIES = {"Flight": 160, "TrackingWebsite": 64}
TIME_FIELDS = ["sched_dep_time", "sched_arr_time", "act_dep_time",
               "act_arr_time"]
SHORT = ["sdt", "sat", "adt", "aat"]
AIRLINES = ["AA", "UA", "CO", "DL", "WN", "US", "AS", "B6"]
# airline codes whose own website reports (only) their flights
OWN_SITES = ["AA", "UA", "CO"]
_AIRPORTS = ["ATL", "BOS", "DEN", "DFW", "EWR", "IAH", "JFK", "LAX", "MIA",
             "ORD", "PHX", "SEA", "SFO", "TPA"]
_SITES = ["flightview", "flightaware", "orbitz", "travelocity", "expedia",
          "kayak", "flightstats", "gofly", "allegiantair", "flylouisville",
          "businesstravellogue", "panynj", "phl", "mia", "iad", "dfw",
          "den", "sfo", "world-flight-tracker", "flightarrival",
          "helloflight", "myrateplan", "flights", "boston", "ord", "quicktrip",
          "weather", "foxbusiness", "flytecomm", "mytripandmore",
          "airtravelcenter", "flightexplorer", "wunderground", "usatoday",
          "ifly"]


def fmt_time(minutes: int) -> str:
    """'h:mm a.m.' / 'h:mm p.m.' of a minute of the day, the source's form
    (TimePrior.TIME_RE)."""
    m = minutes % 1440
    h, mm = divmod(m, 60)
    return f"{h % 12 or 12}:{mm:02d} {'a.m.' if h < 12 else 'p.m.'}"


def synth(rows: int = 2376, flights: int = 100, websites: int = 38,
          seed: int = 0, missing: float = 0.03):
    """(dirty, clean) column dicts of the flights schema (src, flight and
    the four TIME_FIELDS), drawn from a seeded latent flights table:

      * `flights` flights, ids "<airline>-<number>-<from>-<to>" with a
        two-letter prefix from AIRLINES; `websites` tracking websites, the
        first len(OWN_SITES) of them the airlines' own sites, named by the
        lowercase airline code, so the trust rule of experiments/flights.py
        (website == the flight id's prefix) fires on their rows;
      * each flight's clean times: a scheduled departure uniform over the
        day (5-minute steps), a scheduled arrival 60-360 minutes later, the
        actual times each 5-60 minutes after the scheduled ones (-10 to +60
        for the arrival), all in 'h:mm a.m.' form;
      * for each flight and field, 1-3 wrong times (the clean one moved by
        5-120 minutes either way), shared by the sources that report it;
      * each website's error rate: Beta(10, 50) (the model's Prob prior,
        mean 1/6) for the other sites, 0.005 for an airline's own site;
      * each row a distinct (website, flight) pair, uniform over the pairs
        where an airline's site reports only its own flights; a row's time
        cell is one of the field's wrong times (uniform) with the website's
        error rate, else the clean time; then a share `missing` of the
        dirty time cells (3% by default) is None. src and flight are always
        observed and clean.
    """
    rng = random.Random(seed)
    ids, seen = [], set()
    while len(ids) < flights:
        a, b = rng.sample(_AIRPORTS, 2)
        fid = f"{rng.choice(AIRLINES)}-{rng.randrange(100, 4000)}-{a}-{b}"
        if fid not in seen:
            seen.add(fid)
            ids.append(fid)
    own = [c.lower() for c in OWN_SITES][:websites]
    sites = own + _SITES[:max(0, websites - len(own))]
    assert len(sites) == websites, "at most 38 websites"
    err = {s: 0.005 if s in own else rng.betavariate(10.0, 50.0)
           for s in sites}
    clean_t, wrong = {}, {}
    for fid in ids:
        sd = 5 * rng.randrange(288)
        sa = sd + rng.randrange(60, 361)
        ad = sd + rng.randrange(5, 61)
        aa = sa + rng.randrange(-10, 61)
        clean_t[fid] = [fmt_time(x) for x in (sd, sa, ad, aa)]
        wrong[fid] = []
        for x in (sd, sa, ad, aa):
            alts, n_alt = [], rng.randrange(1, 4)
            while len(alts) < n_alt:
                w = fmt_time(x + rng.choice([-1, 1]) * rng.randrange(5, 121))
                if w != fmt_time(x) and w not in alts:
                    alts.append(w)
            wrong[fid].append(alts)
    pairs = [(s, f) for s in sites for f in ids
             if s not in own or f[:2].lower() == s]
    picks = rng.sample(pairs, rows) if rows <= len(pairs) else \
        [rng.choice(pairs) for _ in range(rows)]
    cols = ["src", "flight"] + TIME_FIELDS
    dirty = {c: [] for c in cols}
    clean = {c: [] for c in cols}
    for s, f in picks:
        for d in (dirty, clean):
            d["src"].append(s)
            d["flight"].append(f)
        for k, field in enumerate(TIME_FIELDS):
            c = clean_t[f][k]
            v = rng.choice(wrong[f][k]) if rng.random() < err[s] else c
            if rng.random() < missing:
                v = None
            dirty[field].append(v)
            clean[field].append(c)
    return dirty, clean


def build_model(websites, flight_ids, times_for_flight):
    b = ModelBuilder()
    with b.cls("TrackingWebsite") as c:
        c.choice("name", StringPrior(2, 30, websites))
    with b.cls("Flight") as c:
        with c.block():
            c.choice("flight_id", StringPrior(10, 20, flight_ids))
            c.guaranteed("flight_id")
        for field, short in zip(TIME_FIELDS, SHORT):
            c.compute_list(
                f"{short}_atoms",
                (lambda fl: (lambda fid: times_for_flight.get(
                    f"{fid}-{fl}", [])))(field),
                ["flight_id"])
            c.choice(short, TimePrior(Ref(f"{short}_atoms")))
    with b.cls("Obs") as c:
        c.learned("error_probs", Prob(10.0, 50.0), indexed=True)
        with c.block():
            c.fk("flight", "Flight")
        c.fk("src", "TrackingWebsite")
        # reference run.jl:28: self-reporting websites are trusted
        c.compute("self_report",
                  lambda s, fid: s.lower() == fid[:2].lower(),
                  ["src.name", "flight.flight_id"])
        c.param_lookup("error_prob", "error_probs", key="src.name",
                       gate="self_report", gate_value=1e-5)
        with c.block():
            for short in SHORT:
                c.choice(short, MaybeSwap(Ref(f"flight.{short}"),
                                          Ref(f"flight.{short}_atoms"),
                                          Ref("error_prob")))
    return b.finish()


QUERY_CLAUSES = [
    ("sched_dep_time", "flight.sdt", "sdt"),
    ("sched_arr_time", "flight.sat", "sat"),
    ("act_dep_time", "flight.adt", "adt"),
    ("act_arr_time", "flight.aat", "aat"),
    ("flight", "flight.flight_id"),
    ("src", "src.name"),
]


def model_inputs(dirty):
    """(websites, flight_ids, times_for_flight) of experiments/flights.py's
    setup (:88-97): the dirty websites and flight ids in first-seen order,
    and each flight's observed times per field under "<flight>-<field>"."""
    websites = list(dict.fromkeys(v for v in dirty["src"] if v is not None))
    flight_ids = list(dict.fromkeys(v for v in dirty["flight"]
                                    if v is not None))
    times_for_flight: dict[str, list] = {}
    for i, fid in enumerate(dirty["flight"]):
        for field in TIME_FIELDS:
            v = dirty[field][i]
            if v is not None:
                opts = times_for_flight.setdefault(f"{fid}-{field}", [])
                if v not in opts:
                    opts.append(v)
    return websites, flight_ids, times_for_flight


def setup(rows=2376, flights=100, websites=38, seed=0, missing=0.03,
          sweeps=None, batch=1, particles=None, capacities=None,
          device="cuda", **cfg):
    """Compiled workload on `synth`'s data: (cm, config, dirty, clean,
    query, sweeps); observed class 'Obs'. `capacities` defaults to
    CAPACITIES."""
    dirty, clean = synth(rows, flights, websites, seed, missing)
    model = build_model(*model_inputs(dirty))
    query = Query.build(model, "Obs", QUERY_CLAUSES)
    ds = ObservedDataset(query, dirty)
    sweeps = 5 if sweeps is None else sweeps
    if particles:
        cfg.update(use_mh_instead_of_pg=False, num_particles=particles)
    else:
        cfg.setdefault("use_mh_instead_of_pg", True)
    config = InferenceConfig(num_iters=sweeps, batch_rows=batch, **cfg)
    cm = compile_model(model, [ds], capacities=capacities or CAPACITIES,
                       device=device)
    return cm, config, dirty, clean, query, sweeps
