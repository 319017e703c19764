"""The port's host I/O, result export, observability and command line,
against pclean_tpu on the CPU.

  * io: read_csv (typed and not), _infer, remove_missing, unique_values and
    possibilities_from equal to pclean_tpu.io's on a CSV the test writes
    with int, float, string, mixed and empty cells and short rows;
  * save_results and save_tables: every file byte-equal to pclean_tpu's
    on the same state, the port's own init carried across by convert.py,
    on tests/test_analysis.py's toy model and the chain model (an fk chain,
    learned proportions). Neither model has a float column, so every file
    is compared byte for byte, none parsed;
  * observe: Phases' timings, counts and report line; trace_to a no-op for
    a falsy dir and a Chrome trace otherwise; effective_entity_counts equal
    to pclean_tpu's on the same state;
  * the runner: `python -m pclean_tpu_torch.workloads.hospital --device
    cpu --rows 60 --json --batch 16` prints one line with
    experiments/common.py report's keys, and the same run from --dirty /
    --clean CSVs written from the same synth tables gives the same line
    but for its time (B = 16 keeps the two runs inside tier-1's budget;
    batch_rows 1 takes ~40 s a run on the CPU).
"""
import csv
import filecmp
import json
import os

import numpy as np
import pytest

from pclean_tpu import io as jio
from pclean_tpu_torch import io as tio
from test_torch_host import JNS, TNS, chain, port_state, tiny, to_jax

CELLS = {
    "ints": ["1", "-2", "", "30", "004"],
    "floats": ["1.5", "2", "", "-3e2", "nan"],
    "strings": ["alice", "", "bob", "bob", "carol"],
    "mixed": ["1", "2.5", "x", "", "3"],
    "empty": ["", "", "", "", ""],
    "short": ["a", "b", "c"],
}


def _write(path):
    header = list(CELLS)
    n = max(len(v) for v in CELLS.values())
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(n):
            row = [CELLS[k][i] if i < len(CELLS[k]) else "" for k in header]
            while row and i >= len(CELLS[header[-1]]) and row[-1] == "":
                row.pop()   # a short row: its last cells absent
            w.writerow(row)


def _same(a, b):
    """Equal lists, nan equal to nan, int and float told apart."""
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        assert type(x) is type(y), (x, y)
        if isinstance(x, float) and np.isnan(x):
            assert np.isnan(y)
        else:
            assert x == y


@pytest.mark.parametrize("typed", [True, False])
def test_read_csv_matches_jax(tmp_path, typed):
    path = str(tmp_path / "t.csv")
    _write(path)
    want, got = jio.read_csv(path, typed), tio.read_csv(path, typed)
    assert list(want) == list(got) == list(CELLS)
    for col in want:
        assert len(got[col]) == 5
        _same(want[col], got[col])
    if typed:
        assert got["ints"][:2] == [1, -2] and got["ints"][4] == 4
        assert got["floats"][1] == 2.0 and isinstance(got["floats"][1], float)
        assert got["mixed"][0] == "1" and got["empty"] == [None] * 5
        assert got["short"][3:] == [None, None]


def test_value_helpers_match_jax(tmp_path):
    path = str(tmp_path / "t.csv")
    _write(path)
    data = tio.read_csv(path, typed=False)
    for col, vals in data.items():
        _same(tio._infer(list(vals)), jio._infer(list(vals)))
    data = tio.read_csv(path)
    for col, vals in data.items():
        _same(tio.remove_missing(vals), jio.remove_missing(vals))
        _same(tio.unique_values(vals), jio.unique_values(vals))
    p_t, p_j = tio.possibilities_from(data), jio.possibilities_from(data)
    assert list(p_t) == list(p_j)
    for col in p_t:
        _same(p_t[col], p_j[col])


# ------------------------------------------------------ results and observe


def _pair(which):
    """(cm_j, q_j), (cm_t, q_t), ds of each, and the port's init state as
    numpy (its own init on the CPU)."""
    from pclean_tpu_torch.engine.smc import InferenceConfig

    build = tiny if which == "toy" else chain
    (cm_j, q_j), (cm_t, q_t) = build(JNS), build(TNS)
    cfg = InferenceConfig(num_iters=1, rejuv_frequency=1000)
    state = port_state(cm_t, cfg, seed=0)
    return (cm_j, q_j), (cm_t, q_t), state


@pytest.fixture(scope="module", params=["toy", "chain"])
def pair(request):
    return request.param, _pair(request.param)


def _datasets(which, q_j, q_t):
    from pclean_tpu.model.query import ObservedDataset as JDS
    from pclean_tpu_torch.model.query import ObservedDataset as TDS
    from test_torch_host import DIRTY

    if which == "toy":
        data = {"name": list(DIRTY)}
    else:
        names = ["memorial hospital", "st vincent", "county general", "mercy"]
        data = {"name": [names[i % 4] for i in range(24)],
                "state": [["al", "ak", "az"][i % 3] for i in range(24)]}
        data["name"][1] = "memorial hospitel"
    return [JDS(q_j, data)], [TDS(q_t, data)]


def test_save_results_byte_equal_to_jax(tmp_path, pair):
    from pclean_tpu.analysis import save_results as jsave
    from pclean_tpu_torch import save_results as tsave
    from pclean_tpu_torch.convert import to_torch

    which, ((cm_j, q_j), (cm_t, q_t), (arenas, params)) = pair
    ds_j, ds_t = _datasets(which, q_j, q_t)
    out_j = jsave(cm_j, to_jax(arenas), to_jax(params), str(tmp_path / "j"),
                  which, ds_j, timestamp=False)
    out_t = tsave(cm_t, to_torch(arenas, "cpu"), to_torch(params, "cpu"),
                  str(tmp_path / "t"), which, ds_t, timestamp=False)
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    assert f"reconstructed_{q_t.class_id}.csv" in files
    assert any(f.startswith("inferred_") for f in files)
    for f in files:
        assert filecmp.cmp(os.path.join(out_j, f), os.path.join(out_t, f),
                           shallow=False), f
    with open(os.path.join(out_t, f"reconstructed_{q_t.class_id}.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 1 + len(next(iter(ds_t[0].columns().values())))


def test_save_tables_byte_equal_to_jax(tmp_path, pair):
    from pclean_tpu.analysis import save_tables as jtables
    from pclean_tpu_torch.analysis import save_tables as ttables
    from pclean_tpu_torch.convert import to_torch

    _which, ((cm_j, _q), (cm_t, _qt), (arenas, params)) = pair
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jtables(cm_j, to_jax(arenas), to_jax(params), str(tmp_path / "j"))
    ttables(cm_t, to_torch(arenas, "cpu"), to_torch(params, "cpu"),
            str(tmp_path / "t"))
    files = sorted(os.listdir(tmp_path / "j"))
    assert files and files == sorted(os.listdir(tmp_path / "t"))
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f


def test_effective_entity_counts_match_jax(pair):
    from pclean_tpu import observe as jobserve
    from pclean_tpu.engine.smc import _obs_device as j_obs
    from pclean_tpu_torch import observe as tobserve
    from pclean_tpu_torch.convert import to_torch
    from pclean_tpu_torch.engine.smc import _obs_device as t_obs

    _which, ((cm_j, _q), (cm_t, _qt), (arenas, _p)) = pair
    want = jobserve.effective_entity_counts(cm_j, to_jax(arenas), j_obs(cm_j))
    got = tobserve.effective_entity_counts(cm_t, to_torch(arenas, "cpu"),
                                           t_obs(cm_t))
    assert got == want and set(got) == {
        c for c in cm_t.model.class_order if not cm_t.layouts[c].observed}
    assert all(n > 0 for n in got.values())


def test_phases_time_count_and_report():
    import time

    from pclean_tpu_torch.observe import Phases

    ph = Phases()
    for _ in range(2):
        with ph.phase("init"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with ph.phase("sweep"):
            raise ValueError("recorded all the same")
    assert ph.counts == {"init": 2, "sweep": 1}
    assert ph.timings["init"] >= 0.02 and ph.timings["sweep"] >= 0.0
    line = json.loads(ph.report())
    assert line == {"phases": ph.summary(), "counts": ph.counts}
    assert set(line["phases"]) == {"init", "sweep"}


def test_trace_to(tmp_path):
    import torch

    from pclean_tpu_torch.observe import trace_to

    for falsy in (None, ""):
        with trace_to(falsy) as prof:
            assert prof is None
    assert not os.listdir(tmp_path)
    with trace_to(str(tmp_path / "tr")) as prof:
        torch.ones(8).add_(1)
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# ------------------------------------------------------------------ runner

REPORT_KEYS = {"experiment", "elapsed_sec", "rows", "sweeps",
               "rows_cleaned_per_sec", "f1", "errors", "changed", "cleaned",
               "precision", "recall", "imputed", "correctly_imputed"}


def _run(capsys, argv):
    from pclean_tpu_torch.workloads import hospital

    hospital.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_hospital_runner_from_synth_and_from_csv(tmp_path, capsys):
    from pclean_tpu_torch.analysis import _write_csv
    from pclean_tpu_torch.workloads import hospital

    argv = ["--device", "cpu", "--rows", "60", "--json", "--batch", "16"]
    a = _run(capsys, argv)
    assert set(a) == REPORT_KEYS
    assert a["experiment"] == "hospital" and a["rows"] == 60
    assert a["sweeps"] == 1 and 0.5 < a["f1"] <= 1.0
    dirty, clean = hospital.synth(60)
    _write_csv(str(tmp_path / "dirty.csv"), dirty)
    _write_csv(str(tmp_path / "clean.csv"), clean)
    assert hospital.load(str(tmp_path / "dirty.csv"),
                         str(tmp_path / "clean.csv")) == (dirty, clean)
    b = _run(capsys, argv + ["--dirty", str(tmp_path / "dirty.csv"),
                             "--clean", str(tmp_path / "clean.csv")])
    for k in ("elapsed_sec", "rows_cleaned_per_sec"):
        a.pop(k), b.pop(k)
    assert a == b


def test_scaled_runner_adds_occupancy(capsys):
    """scaled's main adds each class's occupancy to `report`'s line
    through run's `extra` hook, as experiments/scaled.py's main does."""
    from pclean_tpu_torch.workloads import scaled

    scaled.main(["--device", "cpu", "--rows", "200", "--json",
                 "--counties", "20", "--hospitals", "40", "--names", "30",
                 "--zips", "10"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert set(line) == REPORT_KEYS | {"occupancy"}
    assert line["experiment"] == "scaled" and line["rows"] == 200
    assert set(line["occupancy"]) == {"County", "Hospital"}
    for live, cap in line["occupancy"].values():
        assert 0 < live <= cap
