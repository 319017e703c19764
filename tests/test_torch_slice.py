"""The whole slice, end to end on the CPU: compile -> init_state ->
Engine.initialize (batched init with replay) -> Engine.run (segmented
batched MH sweep with parameter resampling) -> evaluate_accuracy_device.

The port cannot reproduce the JAX package's key streams, so the two are
held equal in distribution: on experiments/scaled.py's CPU config the
port's F1 over 3 seeds must lie within the JAX package's own range over 3
seeds, widened by 0.02 (two of the ~100 repaired cells), and relational
invariants must hold. The JAX side takes the segmented batched drivers
(fused_dispatch_rows=0), the only ones the port has.
"""
import jax
import numpy as np

from pclean_tpu.analysis import evaluate_accuracy_device as j_eval
from pclean_tpu.engine.compile import init_state as j_init
from pclean_tpu.engine.smc import Engine as JEngine
from pclean_tpu_torch.analysis import (evaluate_accuracy,
                                       evaluate_accuracy_device)
from pclean_tpu_torch.engine.compile import init_state
from pclean_tpu_torch.engine.refresh import refresh
from pclean_tpu_torch.engine.smc import Engine, InferenceConfig
from test_torch_host import CLEAN, DIRTY, TNS, scaled_pair, tiny


def test_scaled_f1_within_jax_seed_spread():
    (cm_j, cfg_j, q_j), (cm_t, cfg_t, q_t), dirty, clean = scaled_pair()
    f_j, f_t = [], []
    for seed in range(3):
        a, p = j_init(cm_j, jax.random.PRNGKey(seed))
        eng = JEngine(cm_j, cfg_j)
        a, p, k = eng.initialize(jax.random.PRNGKey(seed + 1), a, p)
        a, p, k = eng.run(k, a, p)
        f_j.append(j_eval(cm_j, a, p, dirty, clean, q_j)["f1"])

        a, p = init_state(cm_t, seed, device="cpu")
        eng_t = Engine(cm_t, cfg_t, device="cpu")
        a, p, g = eng_t.initialize(seed + 1, a, p)
        a, p, g = eng_t.run(g, a, p)
        res = evaluate_accuracy_device(cm_t, a, p, dirty, clean, q_t)
        f_t.append(res["f1"])
        rel = refresh(cm_t, a, eng_t.obs_dev)
        assert int(rel["Hospital"]["total"]) == 512
        assert int(rel["County"]["total"]) == int(rel["Hospital"]["nrows"])
    lo, hi = min(f_j) - 0.02, max(f_j) + 0.02
    assert all(lo <= f <= hi for f in f_t), (f_t, f_j)


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
