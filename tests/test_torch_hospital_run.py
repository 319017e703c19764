"""The hospital path end to end on the CPU in both packages, once: init,
one batched sweep (B = 16) and evaluate_accuracy_device on
tests/test_torch_hospital.py's 240-row synth tables, seed 0.

Both must clean the tables (F1 >= 0.9; the two packages' key streams
differ, so the runs are compared in distribution only), and the port's
batched sweep must defer as many rows to the sequential replay as the JAX
package's, class by class, within the spread of such a count
(test_torch_slice.deferred_agree). Three-seed F1 at the chip's size is
scripts/hospital_jax_floor.py's.
"""
from pclean_tpu_torch.engine.refresh import refresh
from test_torch_hospital import hospital_pair
from test_torch_slice import deferred_agree, run_both


def test_hospital_end_to_end_and_deferred_rows_match_jax():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = hospital_pair()
    (f_j, n_j), (f_t, n_t), (arenas, eng) = run_both(
        cm_j, cfg_j, q_j, cm_t, cfg_t, q_t, dirty, clean, 0)
    assert f_j >= 0.9 and f_t >= 0.9, (f_j, f_t)
    assert abs(f_t - f_j) <= 0.05, (f_j, f_t)
    for cid in set(n_j) | set(n_t):
        assert deferred_agree(n_j.get(cid, 0), n_t.get(cid, 0)), (n_j, n_t)
    rel = refresh(cm_t, arenas, eng.obs_dev)
    assert int(rel["Hospital"]["total"]) == int(rel["Measure"]["total"]) == 240
    assert 40 <= int(rel["Hospital"]["alive"].sum()) <= 60
