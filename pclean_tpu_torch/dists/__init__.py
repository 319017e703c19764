"""PClean distributions of the port's paths (see core.py, params.py)."""
from .base import ParamRef, PCleanDistribution, Ref
from .core import (AddNoise, AddTypos, ChooseProportionally, ChooseUniformly,
                   MaybeSwap, StringPrior, TimePrior, Transformation,
                   TransformedGaussian, Unmodeled)
from .params import Mean, Prob, Proportions

__all__ = [
    "PCleanDistribution", "Ref", "ParamRef",
    "ChooseProportionally", "ChooseUniformly", "StringPrior", "TimePrior",
    "AddTypos", "MaybeSwap", "AddNoise", "TransformedGaussian", "Unmodeled", "Transformation",
    "Proportions", "Prob", "Mean",
]
