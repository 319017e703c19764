"""pclean_tpu_torch: the PyTorch/CUDA port of pclean_tpu.

A second package beside pclean_tpu (the JAX reference, which stays as it
is). It runs the batched MH blocked-Gibbs path (compile, SMC initialization,
segmented batched sweeps, parameter resampling, accuracy) in PyTorch, with
the block-enumeration hot spots as hand-written CUDA kernels for Hopper
(pclean_tpu_torch/csrc/, wrapped in pclean_tpu_torch/ops.py).

It imports torch, numpy and the standard library only: never jax and never
pclean_tpu. Entry points run on the card unless the caller passes
device="cpu".
"""
from . import dists, utils
from .dists import *  # noqa: F401,F403
from .model.builder import ModelBuilder
from .model.query import ObservedDataset, Query


def __getattr__(name):
    # engine symbols resolve lazily so `import pclean_tpu_torch` stays light
    if name in ("compile_model", "init_state"):
        from .engine import compile as _c

        return getattr(_c, name)
    if name in ("Engine", "InferenceConfig"):
        from .engine import smc

        return getattr(smc, name)
    if name in ("evaluate_accuracy", "evaluate_accuracy_device"):
        from . import analysis

        return getattr(analysis, name)
    raise AttributeError(name)


__all__ = ["ModelBuilder", "Query", "ObservedDataset", "compile_model",
           "init_state", "Engine", "InferenceConfig", "evaluate_accuracy",
           "evaluate_accuracy_device", "dists", "utils"]
__version__ = "0.1.0"
