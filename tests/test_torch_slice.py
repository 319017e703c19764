"""The whole slice, end to end on the CPU: compile -> init_state ->
Engine.initialize (batched init with replay) -> Engine.run (segmented
batched MH sweep with parameter resampling) -> evaluate_accuracy_device.

The port cannot reproduce the JAX package's key streams, so the two are
held equal in distribution: on experiments/scaled.py's CPU config the
port's F1 over 3 seeds must lie within the JAX package's own range over 3
seeds, widened by 0.02 (two of the ~100 repaired cells), and relational
invariants must hold. The same runs count the rows each package's batched
sweep defers to the sequential replay (rows whose proposal births an
entity): the JAX package's through the `replay_rows(..., rejuv=True)`
calls of its _sweep_batched_segmented (the flags of
scan_sweep_class_batched), the port's as phase_times' replayed_seq_rows.
The JAX side takes the segmented batched drivers (fused_dispatch_rows=0),
the only ones the port has.
"""
from unittest import mock

import jax
import numpy as np
import pytest

from pclean_tpu.analysis import evaluate_accuracy_device as j_eval
from pclean_tpu.engine.compile import init_state as j_init
from pclean_tpu.engine.smc import Engine as JEngine
from pclean_tpu_torch.analysis import (evaluate_accuracy,
                                       evaluate_accuracy_device)
from pclean_tpu_torch.engine.compile import init_state
from pclean_tpu_torch.engine.refresh import refresh
from pclean_tpu_torch.engine.smc import Engine, InferenceConfig
from test_torch_host import CLEAN, DIRTY, TNS, scaled_pair, tiny


def run_both(cm_j, cfg_j, q_j, cm_t, cfg_t, q_t, dirty, clean, seed):
    """init + one sweep of each package from `seed`: (F1, {class: rows the
    batched sweep deferred}) of JAX, then of the port, and the port's
    final (arenas, engine)."""
    deferred_j: dict = {}
    replay = JEngine.replay_rows

    def spy(self, cid, arenas, params, idx, keys, rejuv=False, **kw):
        if rejuv:
            deferred_j[cid] = deferred_j.get(cid, 0) + len(idx)
        return replay(self, cid, arenas, params, idx, keys, rejuv=rejuv,
                      **kw)

    with mock.patch.object(JEngine, "replay_rows", spy):
        a, p = j_init(cm_j, jax.random.PRNGKey(seed))
        eng = JEngine(cm_j, cfg_j)
        a, p, k = eng.initialize(jax.random.PRNGKey(seed + 1), a, p)
        a, p, k = eng.run(k, a, p)
    f_j = j_eval(cm_j, a, p, dirty, clean, q_j)["f1"]
    a, p = init_state(cm_t, seed, device="cpu")
    eng_t = Engine(cm_t, cfg_t, device="cpu")
    a, p, g = eng_t.initialize(seed + 1, a, p)
    a, p, g = eng_t.run(g, a, p)
    f_t = evaluate_accuracy_device(cm_t, a, p, dirty, clean, q_t)["f1"]
    deferred_t = {k.split(":", 1)[1]: v["replayed_seq_rows"]
                  for k, v in eng_t.phase_times.items()
                  if k.startswith("sweep:") and v["replayed_seq_rows"]}
    return (f_j, deferred_j), (f_t, deferred_t), (a, eng_t)


@pytest.fixture(scope="module")
def scaled_runs():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = scaled_pair()
    runs = []
    for seed in range(3):
        jx, pt, (a, eng_t) = run_both(cm_j, cfg_j, q_j, cm_t, cfg_t, q_t,
                                      dirty, clean, seed)
        rel = refresh(cm_t, a, eng_t.obs_dev)
        assert int(rel["Hospital"]["total"]) == 512
        assert int(rel["County"]["total"]) == int(rel["Hospital"]["nrows"])
        runs.append((jx, pt))
    return runs


def test_scaled_f1_within_jax_seed_spread(scaled_runs):
    f_j = [jx[0] for jx, _pt in scaled_runs]
    f_t = [pt[0] for _jx, pt in scaled_runs]
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


def deferred_agree(n_j: int, n_t: int) -> bool:
    """The port defers as many rows as the JAX package: the two counts,
    each a sum of per-row births whose variance is at most its mean, differ
    by at most 4 standard deviations of their difference,
    |n_t - n_j| <= 4 sqrt(n_j + n_t) + 1. At a few rows this tells little;
    tests/test_torch_defer_scale.py holds it at hundreds."""
    return abs(n_t - n_j) <= 4.0 * (n_j + n_t) ** 0.5 + 1.0


def test_scaled_sweep_defers_as_many_rows_as_jax(scaled_runs):
    """Over seeds 0-2 both packages defer a handful of the ~48 live
    Hospitals' rows and no County or Record row (JAX 2, 4, 5 and the port
    6, 2, 5 Hospital rows on the CPU)."""
    n_j = {}
    n_t = {}
    for (_f, dj), (_g, dt) in scaled_runs:
        for c, n in dj.items():
            n_j[c] = n_j.get(c, 0) + n
        for c, n in dt.items():
            n_t[c] = n_t.get(c, 0) + n
    assert set(n_t) <= {"Hospital"} and set(n_j) <= {"Hospital"}
    assert n_j.get("Hospital", 0) > 0
    assert deferred_agree(n_j.get("Hospital", 0), n_t.get("Hospital", 0)), \
        (n_j, n_t)


def test_tiny_model_end_to_end_and_host_eval_agrees():
    cm, q = tiny(TNS)
    a, p = init_state(cm, 0, device="cpu")
    eng = Engine(cm, InferenceConfig(num_iters=1, rejuv_frequency=1000,
                                     batch_rows=4), device="cpu")
    a, p, g = eng.initialize(1, a, p)
    a, p, g = eng.run(g, a, p)
    dev = evaluate_accuracy_device(cm, a, p, {"name": DIRTY},
                                   {"name": CLEAN}, q)
    host = evaluate_accuracy(cm, a, p, {"name": DIRTY}, {"name": CLEAN}, q)
    assert dev == host
    assert dev["f1"] > 0.5, dev
    rel = refresh(cm, a, eng.obs_dev)
    assert int(rel["Obj"]["total"]) == len(DIRTY)
    assert np.all(a["Row"]["alive"].numpy())
