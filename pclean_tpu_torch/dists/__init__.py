"""PClean distributions of the port's main path (see core.py, params.py)."""
from .base import ParamRef, PCleanDistribution, Ref
from .core import AddTypos, ChooseProportionally, ChooseUniformly, StringPrior
from .params import Mean, Prob, Proportions

__all__ = [
    "PCleanDistribution", "Ref", "ParamRef",
    "ChooseProportionally", "ChooseUniformly", "StringPrior", "AddTypos",
    "Proportions", "Prob", "Mean",
]
