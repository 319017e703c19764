"""The port's checkpoint (pclean_tpu_torch.engine.checkpoint) on the CPU,
mirroring tests/test_checkpoint.py: a save and load round trip bit-equal
for the arenas, the parameters, the generator's state and Engine.log_ml
(in meta); a run resumed from a checkpoint ends bit-equal to the same run
uninterrupted; a checkpoint of another compiled model (another capacity)
is refused unless strict=False. On the toy model of tests/test_analysis.py
(MH) and the chain model under two-particle PG (a log-ML, learned
proportions).
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch.engine.checkpoint import (fingerprint, load_checkpoint,
                                                save_checkpoint)
from pclean_tpu_torch.engine.compile import init_state
from pclean_tpu_torch.engine.smc import Engine, InferenceConfig
from test_torch_host import TNS, chain, tiny

CONFIGS = {
    "toy": (tiny, dict(num_iters=1, rejuv_frequency=1000)),
    "chain_pg": (lambda ns: chain(ns, cap=24), dict(num_iters=1, rejuv_frequency=8,
                             use_mh_instead_of_pg=False, num_particles=2)),
}


def _init(which):
    build, cfg = CONFIGS[which]
    cm, _q = build(TNS)
    eng = Engine(cm, InferenceConfig(**cfg), device="cpu")
    arenas, params = init_state(cm, 0, device="cpu")
    arenas, params, gen = eng.initialize(1, arenas, params)
    return cm, eng, arenas, params, gen


def _equal(a, b, path="state"):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and \
            a.shape == b.shape and a.device == b.device, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("which", list(CONFIGS))
def test_checkpoint_round_trip_bit_equal(tmp_path, which):
    cm, eng, arenas, params, gen = _init(which)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, cm, arenas, params, gen,
                    meta={"sweeps_done": 0, "log_ml": eng.log_ml})
    a2, p2, g2, meta = load_checkpoint(path, cm)
    _equal(arenas, a2, "arenas")
    _equal(params, p2, "params")
    assert torch.equal(g2.get_state(), gen.get_state())
    assert meta["sweeps_done"] == 0
    _equal(meta["log_ml"], eng.log_ml, "log_ml")
    if which == "chain_pg":
        assert float(eng.log_ml) != 0.0
    # the generator is the saved one, not a copy of the live one: both draw
    # the same numbers next
    assert torch.equal(torch.rand(4, generator=g2),
                       torch.rand(4, generator=gen))


@pytest.mark.parametrize("which", list(CONFIGS))
def test_resumed_run_bit_equal_to_uninterrupted(tmp_path, which):
    cm, eng, arenas, params, gen = _init(which)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, cm, arenas, params, gen,
                    meta={"log_ml": eng.log_ml})
    want = eng.run(gen, arenas, params)
    a2, p2, g2, _meta = load_checkpoint(path, cm)
    eng2 = Engine(cm, eng.config, device="cpu")
    got = eng2.run(g2, a2, p2)
    _equal(want[0], got[0], "arenas")
    _equal(want[1], got[1], "params")
    assert torch.equal(want[2].get_state(), got[2].get_state())


def test_fingerprint_mismatch_refused_unless_not_strict(tmp_path):
    cm, _eng, arenas, params, gen = _init("toy")
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, cm, arenas, params, gen)
    cm2, _q = tiny(TNS, capacity=4)   # another capacity: another fingerprint
    assert fingerprint(cm2) != fingerprint(cm)
    assert fingerprint(tiny(TNS)[0]) == fingerprint(cm)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(path, cm2)
    a, _p, _g, meta = load_checkpoint(path, cm2, strict=False)
    assert meta == {}
    np.testing.assert_array_equal(a["Obj"]["alive"].numpy(),
                                  arenas["Obj"]["alive"].numpy())
