"""Learned-parameter specs and their tensor-backed conjugate state.

Counterpart of pclean_tpu/dists/params.py (reference Parameter interface,
distributions.jl:27-61). The specs are plain data and identical; the state
is a dict of fixed-shape tensors with an explicit leading index axis, and
every draw takes an explicit torch.Generator. The port's main path learns
only Proportions (Dirichlet-categorical, choose_proportionally.jl:23-89);
Prob and Mean keep their specs so models declare them alike, and their
resampling comes with MaybeSwap / AddNoise in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..utils import sample_dirichlet


@dataclass(frozen=True)
class Proportions:
    """Dirichlet prior over an options vector.

    concentration: scalar (reference VariableSizeProportionsParameterPrior)
    or vector (ProportionsParameterPrior), choose_proportionally.jl:23-42.
    """

    concentration: Union[float, tuple] = 1.0


@dataclass(frozen=True)
class Prob:
    """Beta(a, b) prior on a Bernoulli probability (maybe_swap.jl:41-57)."""

    a: float = 1.0
    b: float = 3.0

    @staticmethod
    def from_odds(odds: float) -> "Prob":
        return Prob(odds * 4.0, (1.0 - odds) * 4.0)


@dataclass(frozen=True)
class Mean:
    """Normal(mean, std) prior on the mean of a Gaussian (add_noise.jl:29-34)."""

    mean: float
    std: Optional[float] = None

    def prior_std(self) -> float:
        return self.std if self.std is not None else 0.5 * abs(self.mean)


ParamSpec = Union[Proportions, Prob, Mean]


def _concentration(spec: Proportions, num_options: int,
                   device) -> torch.Tensor:
    conc = np.asarray(spec.concentration, dtype=np.float32)
    if conc.ndim == 0:
        conc = np.full(num_options, float(conc), dtype=np.float32)
    assert conc.shape == (num_options,), (conc.shape, num_options)
    return torch.as_tensor(conc, device=device)


def init_proportions_state(gen: torch.Generator, spec: Proportions,
                           num_options: int, num_indices: int = 1,
                           device="cpu") -> dict:
    conc = _concentration(spec, num_options, device)
    value = sample_dirichlet(gen, conc.expand(num_indices, num_options))
    return {
        "counts": torch.zeros((num_indices, num_options), dtype=torch.int32,
                              device=device),
        "log_value": torch.log(value.to(torch.float32)),
    }


def resample_proportions(gen: torch.Generator, state: dict,
                         spec: Proportions) -> dict:
    """Collapsed Gibbs draw: Dirichlet(prior + counts)
    (choose_proportionally.jl:70-74)."""
    counts = state["counts"].to(torch.float32)
    conc = _concentration(spec, counts.shape[-1], counts.device)
    value = sample_dirichlet(gen, conc[None, :] + counts)
    return {"counts": state["counts"],
            "log_value": torch.log(value.to(torch.float32))}
