"""Hospital workload: the seven-class relational model with typo errors.

The port's own copy of experiments/hospital.py (CAPACITIES, build_model,
QUERY_CLAUSES, setup) and of experiments/common.py's `tile`, which cannot
be imported because they import jax, and `synth`, a seeded generator of the
hospital schema, because the source's hospital_dirty.csv /
hospital_clean.csv are not in the repository. The model (reference
experiments/hospital/run.jl:5-85): County -> Place -> Hospital <-
HospitalType, Condition -> Measure, and Record with two blocks, one
referencing a Hospital (eleven AddTypos columns, slot chains three deep:
hosp.loc.county.state) and one a Measure (three AddTypos columns and the
composed `stateavg = f"{state}_{code}"` of the hospital's state and the
measure's code). Reference config: MH, 1 sweep; bench.py runs it tiled to
100,000 rows at batch_rows 4096.
"""
from __future__ import annotations

import random
import string

from ..dists import (AddTypos, ChooseProportionally, ChooseUniformly,
                     ParamRef, Proportions, Ref, StringPrior)
from ..engine.compile import compile_model
from ..engine.smc import InferenceConfig
from ..model.builder import ModelBuilder
from ..model.query import ObservedDataset, Query
from .scaled import _ADJ, _NOUN, _typo

CAPACITIES = {"County": 128, "Place": 256, "Condition": 64, "Measure": 128,
              "HospitalType": 64, "Hospital": 512}
COLUMNS = ["ProviderNumber", "HospitalName", "HospitalType", "HospitalOwner",
           "Address1", "PhoneNumber", "EmergencyService", "City",
           "CountyName", "State", "ZipCode", "Condition", "MeasureCode",
           "MeasureName", "Stateavg"]
STATES = ["al", "ga", "tn", "ms"]
HOSPITALS, MEASURES, COUNTIES, PLACES = 55, 40, 30, 45
TYPO_PROB = 0.05
HOSPITAL_TYPES = ["acute care hospitals", "critical access hospitals",
                  "childrens hospitals"]
OWNERS = ["voluntary non-profit - private", "proprietary",
          "government - hospital district or authority",
          "government - local", "voluntary non-profit - church",
          "government - state"]
SERVICES = ["yes", "no"]
CONDITIONS = ["heart attack", "heart failure", "pneumonia",
              "surgical infection prevention", "childrens asthma care",
              "stroke care"]
_PLACE_A = ["maple", "cedar", "birch", "river", "stone", "iron", "silver",
            "green", "frank", "harris", "clay", "lake", "fair", "spring",
            "oak", "pine", "red", "white", "black", "gold"]
_PLACE_B = ["ton", "ville", "burg", "field", "port", "dale", "mont", "wood",
            "ford", "haven", "land", "view"]
_COUNTY = ["autauga", "baldwin", "barbour", "bibb", "blount", "bullock",
           "butler", "calhoun", "chambers", "cherokee", "chilton", "choctaw",
           "clarke", "coffee", "colbert", "conecuh", "coosa", "covington",
           "crenshaw", "cullman", "dekalb", "elmore", "escambia", "etowah",
           "fayette", "geneva", "greene", "henry", "houston", "jackson",
           "jefferson", "lamar", "lawrence", "limestone", "lowndes", "macon",
           "madison", "marengo", "marshall", "mobile", "monroe",
           "montgomery", "morgan", "perry", "pickens", "randolph", "russell",
           "shelby", "sumter", "talladega", "tuscaloosa", "walker",
           "washington", "wilcox", "winston"]
_STREET = ["main", "university", "medical center", "highland", "commerce",
           "washington", "lincoln", "broad", "college", "church", "market",
           "park", "hospital", "memorial", "industrial", "quintard"]
_STREET_KIND = ["street", "avenue", "road", "drive", "boulevard", "parkway"]
_MEASURE_W1 = ["patients", "heart attack patients", "heart failure patients",
               "pneumonia patients", "surgery patients", "children",
               "stroke patients", "outpatients"]
_MEASURE_W2 = ["given aspirin at arrival", "given beta blocker",
               "given discharge instructions", "assessed for smoking",
               "given antibiotics on time", "given oxygen assessment",
               "given flu vaccination", "given pneumococcal vaccination",
               "given ace inhibitor", "whose blood culture was performed",
               "given relievers", "given systemic corticosteroids",
               "given home management plan", "given statin at discharge",
               "given thrombolytic medication", "whose antibiotics stopped"]


def tile(data: dict, times: int) -> dict:
    """experiments/common.py's tile: the dataset's rows repeated `times`
    times (the source's 100,000-row hospital runs)."""
    if times <= 1:
        return data
    return {k: list(v) * times for k, v in data.items()}


def possibilities(data: dict) -> dict:
    """{column: its unique non-missing values in first-seen order}, as
    pclean_tpu/io.py's possibilities_from gives them."""
    out = {}
    for col, vals in data.items():
        seen, uniq = set(), []
        for v in vals:
            if v is None or v in seen:
                continue
            seen.add(v)
            uniq.append(v)
        out[col] = uniq
    return out


def _edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _far(rng: random.Random, make, n: int, min_dist: int = 3) -> list:
    """n values from make(rng), each at least min_dist edits from every
    other, so that a one-edit typo never lands on or next to another
    entity's value."""
    out: list = []
    for _ in range(200 * n):
        if len(out) == n:
            return out
        v = make(rng)
        if all(_edit_distance(v, w) >= min_dist for w in out):
            out.append(v)
    raise ValueError(f"cannot draw {n} values {min_dist} edits apart")


def _digits(k: int):
    return lambda rng: "".join(rng.choice(string.digits) for _ in range(k))


def synth(rows: int = 1000, seed: int = 7):
    """(dirty, clean) column dicts of the hospital schema (the 15 COLUMNS),
    drawn from a seeded latent database:

      * 30 counties named from real county names, each in a uniform one of
        4 states; 45 cities (two-part names), each in a uniform county; 3
        hospital types, 6 owners, 6 conditions;
      * 55 hospitals (the source's ~55 live ones), each in a uniform place,
        with a uniform type, owner and emergency service, a name "<word>
        <word> hospital", an address "<number> <street> <kind>", and random
        digit strings for the provider number (6), phone (10) and zip (5);
      * 40 measures, each a code "<3 letters>-<1-2 digits>", a name
        "<patients> <treatment>" and a uniform condition;
      * every entity value is at least 3 edits from the other values of its
        column, so one typo never makes two entities look alike;
      * each row: a uniform hospital and a uniform measure; Stateavg is
        "<state>_<code>" of the hospital's state and the measure's code;
      * dirty: each cell, independently with probability TYPO_PROB (0.05),
        replaced by one of 3 variants of its value (one insert, delete,
        substitute or transpose each, drawn once per value as
        workloads/scaled.py draws them, so misspellings recur as
        add_typos.jl's do).
    """
    rng = random.Random(seed)
    c_name = rng.sample(_COUNTY, COUNTIES)
    c_state = [rng.randrange(len(STATES)) for _ in range(COUNTIES)]
    p_city = _far(rng, lambda r: r.choice(_PLACE_A) + r.choice(_PLACE_B),
                  PLACES)
    p_county = [rng.randrange(COUNTIES) for _ in range(PLACES)]
    h_name = _far(rng, lambda r: f"{r.choice(_ADJ)} {r.choice(_NOUN)} "
                                 f"hospital", HOSPITALS)
    h_addr = _far(rng, lambda r: f"{r.randrange(100, 10000)} "
                                 f"{r.choice(_STREET)} "
                                 f"{r.choice(_STREET_KIND)}", HOSPITALS)
    h_provider = _far(rng, _digits(6), HOSPITALS)
    h_phone = _far(rng, _digits(10), HOSPITALS)
    h_zip = _far(rng, _digits(5), HOSPITALS)
    h_place = [rng.randrange(PLACES) for _ in range(HOSPITALS)]
    h_type = [rng.choice(HOSPITAL_TYPES) for _ in range(HOSPITALS)]
    h_owner = [rng.choice(OWNERS) for _ in range(HOSPITALS)]
    h_service = [rng.choice(SERVICES) for _ in range(HOSPITALS)]
    m_code = _far(rng, lambda r: "".join(r.choice(string.ascii_lowercase)
                                         for _ in range(3))
                  + f"-{r.randrange(1, 100)}", MEASURES)
    m_name = _far(rng, lambda r: f"{r.choice(_MEASURE_W1)} "
                                 f"{r.choice(_MEASURE_W2)}", MEASURES)
    m_cond = [rng.choice(CONDITIONS) for _ in range(MEASURES)]
    variants: dict = {}

    def noisy(v):
        if rng.random() >= TYPO_PROB:
            return v
        if v not in variants:
            variants[v] = [_typo(v, rng) for _ in range(3)]
        return rng.choice(variants[v])

    dirty = {c: [] for c in COLUMNS}
    clean = {c: [] for c in COLUMNS}
    for _ in range(rows):
        h, m = rng.randrange(HOSPITALS), rng.randrange(MEASURES)
        p = h_place[h]
        c = p_county[p]
        state = STATES[c_state[c]]
        row = dict(ProviderNumber=h_provider[h], HospitalName=h_name[h],
                   HospitalType=h_type[h], HospitalOwner=h_owner[h],
                   Address1=h_addr[h], PhoneNumber=h_phone[h],
                   EmergencyService=h_service[h], City=p_city[p],
                   CountyName=c_name[c], State=state, ZipCode=h_zip[h],
                   Condition=m_cond[m], MeasureCode=m_code[m],
                   MeasureName=m_name[m], Stateavg=f"{state}_{m_code[m]}")
        for col in COLUMNS:
            clean[col].append(row[col])
            dirty[col].append(noisy(row[col]))
    return dirty, clean


def build_model(poss):
    b = ModelBuilder()
    with b.cls("County") as c:
        c.learned("state_proportions", Proportions())
        c.choice("state", ChooseProportionally(poss["State"],
                                               ParamRef("state_proportions")))
        c.choice("county", StringPrior(3, 30, poss["CountyName"]))
    with b.cls("Place") as c:
        c.fk("county", "County")
        c.choice("city", StringPrior(3, 30, poss["City"]))
    with b.cls("Condition") as c:
        c.choice("desc", StringPrior(5, 35, poss["Condition"]))
    with b.cls("Measure") as c:
        c.choice("code", ChooseUniformly(poss["MeasureCode"]))
        c.choice("name", ChooseUniformly(poss["MeasureName"]))
        c.fk("condition", "Condition")
    with b.cls("HospitalType") as c:
        c.choice("desc", StringPrior(10, 30, poss["HospitalType"]))
    with b.cls("Hospital") as c:
        c.learned("owner_dist", Proportions())
        c.learned("service_dist", Proportions())
        c.fk("loc", "Place")
        c.fk("type", "HospitalType")
        c.choice("provider", ChooseUniformly(poss["ProviderNumber"]))
        c.choice("name", StringPrior(3, 50, poss["HospitalName"]))
        c.choice("addr", StringPrior(10, 30, poss["Address1"]))
        c.choice("phone", StringPrior(10, 10, poss["PhoneNumber"]))
        c.choice("owner", ChooseProportionally(poss["HospitalOwner"],
                                               ParamRef("owner_dist")))
        c.choice("zip", ChooseUniformly(poss["ZipCode"]))
        c.choice("service", ChooseProportionally(poss["EmergencyService"],
                                                 ParamRef("service_dist")))
    with b.cls("Record") as c:
        with c.block():
            c.fk("hosp", "Hospital")
            c.choice("service", AddTypos(Ref("hosp.service")))
            c.choice("provider", AddTypos(Ref("hosp.provider")))
            c.choice("name", AddTypos(Ref("hosp.name")))
            c.choice("addr", AddTypos(Ref("hosp.addr")))
            c.choice("city", AddTypos(Ref("hosp.loc.city")))
            c.choice("state", AddTypos(Ref("hosp.loc.county.state")))
            c.choice("zip", AddTypos(Ref("hosp.zip")))
            c.choice("county", AddTypos(Ref("hosp.loc.county.county")))
            c.choice("phone", AddTypos(Ref("hosp.phone")))
            c.choice("type", AddTypos(Ref("hosp.type.desc")))
            c.choice("owner", AddTypos(Ref("hosp.owner")))
        with c.block():
            c.fk("metric", "Measure")
            c.choice("code", AddTypos(Ref("metric.code")))
            c.choice("mname", AddTypos(Ref("metric.name")))
            c.choice("condition", AddTypos(Ref("metric.condition.desc")))
            c.compute("stateavg", lambda s, code: f"{s}_{code}",
                      ["hosp.loc.county.state", "metric.code"])
            c.choice("stateavg_obs", AddTypos(Ref("stateavg")))
    return b.finish()


QUERY_CLAUSES = [
    ("ProviderNumber", "hosp.provider", "provider"),
    ("HospitalName", "hosp.name", "name"),
    ("HospitalType", "hosp.type.desc", "type"),
    ("HospitalOwner", "hosp.owner", "owner"),
    ("Address1", "hosp.addr", "addr"),
    ("PhoneNumber", "hosp.phone", "phone"),
    ("EmergencyService", "hosp.service", "service"),
    ("City", "hosp.loc.city", "city"),
    ("CountyName", "hosp.loc.county.county", "county"),
    ("State", "hosp.loc.county.state", "state"),
    ("ZipCode", "hosp.zip", "zip"),
    ("Condition", "metric.condition.desc", "condition"),
    ("MeasureCode", "metric.code", "code"),
    ("MeasureName", "metric.name", "mname"),
    ("Stateavg", "stateavg", "stateavg_obs"),
]


def setup(rows=1000, repeat=1, sweeps=None, batch=1, particles=None, seed=7,
          device="cuda", **cfg):
    """Compiled workload on `synth`'s tables tiled `repeat` times, as
    experiments/hospital.py's setup tiles the source's: (cm, config, dirty,
    clean, query, sweeps); observed class 'Record'."""
    dirty, clean = synth(rows, seed)
    dirty, clean = tile(dirty, repeat), tile(clean, repeat)
    model = build_model(possibilities(dirty))
    query = Query.build(model, "Record", QUERY_CLAUSES)
    ds = ObservedDataset(query, dirty)
    sweeps = 1 if sweeps is None else sweeps
    if particles:
        cfg.update(use_mh_instead_of_pg=False, num_particles=particles)
    else:
        cfg.setdefault("use_mh_instead_of_pg", True)
    config = InferenceConfig(num_iters=sweeps, batch_rows=batch, **cfg)
    cm = compile_model(model, [ds], capacities=CAPACITIES, device=device)
    return cm, config, dirty, clean, query, sweeps
