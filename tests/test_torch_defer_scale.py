"""The rows the batched sweep defers to the sequential replay (rows whose
proposal births an entity), counted where they number in the hundreds.

experiments/scaled.py's model on 8,000 rows of 640 hospitals, 80 counties,
160 names and 40 zips (the 100,000-row scaled config of chip_smoke.py cut
12.5 times, at its 12.5 rows a hospital), B = 256, seed 0: init and one
batched sweep through both packages (test_torch_slice.run_both). About
half the live Hospitals defer a row there, as on the 100,000-row path, so
the counts are in the hundreds and test_torch_slice.deferred_agree's bound
(4 standard deviations) tells a port that defers twice as many rows from
one that matches. About 45 s on the CPU.
"""
from test_torch_host import scaled_pair
from test_torch_slice import deferred_agree, run_both

SIZE = dict(rows=8000, hospitals=640, counties=80, names=160, zips=40)


def test_scaled_sweep_defers_as_many_rows_as_jax_at_hundreds():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = scaled_pair(
        batch=256, size=SIZE)
    (f_j, n_j), (f_t, n_t), _ = run_both(cm_j, cfg_j, q_j, cm_t, cfg_t, q_t,
                                         dirty, clean, 0)
    assert set(n_j) == set(n_t) == {"Hospital"}, (n_j, n_t)
    assert n_j["Hospital"] >= 200, n_j
    assert deferred_agree(n_j["Hospital"], n_t["Hospital"]), (n_j, n_t)
    assert abs(f_t - f_j) <= 0.05, (f_j, f_t)
