"""The fused order of a small batched MH sweep, against pclean_tpu at its
default configuration.

At batch_rows > 1, where the classes' capacities sum to at most
fused_dispatch_rows (8,192 by default), pclean_tpu sweeps every class's
batches first and replays every class's deferred rows after
(scan_sweep_all_batched, smc.py:1481-1564, 2011-2036); the port's
Engine._sweep_batched_fused does the same. On experiments/scaled.py's CPU
config (512 rows, B = 8), with neither package told anything but the
batch size, three seeds each: both take the fused order, the port's F1
lies within the JAX package's own 3-seed range +- 0.02, and the rows each
package's sweep defers, class by class over the seeds, agree within
test_torch_slice.deferred_agree's spread.
"""
from unittest import mock

from pclean_tpu.engine.smc import Engine as JEngine
from pclean_tpu_torch.workloads import scaled as tscaled
from test_torch_host import SMALL, jscaled
from test_torch_slice import deferred_agree, run_both


def test_default_config_takes_the_fused_order_as_jax_does():
    cm_j, cfg_j, dirty, clean, q_j, _ = jscaled.setup(**SMALL, batch=8)
    cm_t, cfg_t, _d, _c, q_t, _ = tscaled.setup(**SMALL, batch=8,
                                                device="cpu")
    assert cfg_j.fused_dispatch_rows == cfg_t.fused_dispatch_rows == 8192
    assert sum(cm_t.layouts[c].capacity for c in cm_t.model.class_order) \
        <= cfg_t.fused_dispatch_rows
    fused = JEngine.scan_sweep_all_batched
    f_j, f_t, n_j, n_t = [], [], {}, {}
    with mock.patch.object(JEngine, "scan_sweep_all_batched",
                           autospec=True, side_effect=fused) as spy:
        for seed in range(3):
            (fj, dj), (ft, dt), (_a, eng) = run_both(
                cm_j, cfg_j, q_j, cm_t, cfg_t, q_t, dirty, clean, seed)
            f_j.append(fj)
            f_t.append(ft)
            for n, d in ((n_j, dj), (n_t, dt)):
                for c, k in d.items():
                    n[c] = n.get(c, 0) + k
            assert {t.get("order") for k, t in eng.phase_times.items()
                    if k.startswith("sweep:")} == {"fused"}
    assert spy.call_count >= 1
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)
    assert n_j.get("Hospital", 0) > 0, n_j
    for c in set(n_j) | set(n_t):
        assert deferred_agree(n_j.get(c, 0), n_t.get(c, 0)), (n_j, n_t)
