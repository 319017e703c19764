"""Learned-parameter specs and their tensor-backed conjugate state.

Counterpart of pclean_tpu/dists/params.py (reference Parameter interface,
distributions.jl:27-61). The specs are plain data and identical; the state
is a dict of fixed-shape tensors with an explicit leading index axis, and
every draw takes an explicit torch.Generator. The three conjugate
families: Proportions (Dirichlet-categorical, choose_proportionally.jl:
23-89), Prob (Beta-Bernoulli, maybe_swap.jl:41-95; Beta drawn as two gamma
draws, since torch's Beta sampler takes no generator) and Mean
(Normal-Normal, add_noise.jl:12-82). State is built on the device the entry
points resolve (the card unless the caller asks for "cpu").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..utils import resolve_device, sample_dirichlet, sample_gamma


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
                           device="cuda") -> dict:
    device = resolve_device(device)
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


def sample_beta(gen: torch.Generator, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Beta(a, b) = X / (X + Y), X ~ Gamma(a), Y ~ Gamma(b)."""
    x = sample_gamma(gen, a)
    y = sample_gamma(gen, b)
    return x / (x + y)


def init_prob_state(gen: torch.Generator, spec: Prob, num_indices: int = 1,
                    device="cuda") -> dict:
    device = resolve_device(device)
    full = lambda v: torch.full((num_indices,), float(v),  # noqa: E731
                                dtype=torch.float32, device=device)
    return {
        "heads": torch.zeros((num_indices,), dtype=torch.int32, device=device),
        "tails": torch.zeros((num_indices,), dtype=torch.int32, device=device),
        "value": sample_beta(gen, full(spec.a), full(spec.b)),
    }


def resample_prob(gen: torch.Generator, state: dict, spec: Prob) -> dict:
    """Beta(a + heads, b + tails) (maybe_swap.jl:87-89)."""
    value = sample_beta(gen, spec.a + state["heads"].to(torch.float32),
                        spec.b + state["tails"].to(torch.float32))
    return {**state, "value": value.to(torch.float32)}


def init_mean_state(gen: torch.Generator, spec: Mean, num_sites: int,
                    num_indices: int = 1, device="cuda") -> dict:
    """`num_sites` = number of AddNoise/TransformedGaussian call sites using
    this parameter; each site has one static noise std, replacing the
    reference's dynamically-grown per-std vectors (add_noise.jl:21-27)."""
    device = resolve_device(device)
    z = torch.randn((num_indices,), generator=gen, device=device)
    return {
        "counts": torch.zeros((num_indices, num_sites), dtype=torch.int32,
                              device=device),
        "sums": torch.zeros((num_indices, num_sites), dtype=torch.float32,
                            device=device),
        "value": (spec.mean + spec.prior_std() * z).to(torch.float32),
    }


def mean_posterior(state: dict, spec: Mean, site_stds: Sequence[float]):
    """(mean, var) [I] of the exact Normal-Normal posterior over all sites
    (add_noise.jl:74-82):

    posterior precision = 1/var0 + sum_s count_s/std_s^2
    posterior mean = var * (mean0/var0 + sum_s sum_s/std_s^2)
    """
    var0 = spec.prior_std() ** 2
    var_s = torch.as_tensor(np.asarray(site_stds, dtype=np.float32),
                            device=state["sums"].device) ** 2  # [S]
    prec = 1.0 / var0 + torch.sum(state["counts"].to(torch.float32)
                                  / var_s[None, :], dim=-1)
    num = spec.mean / var0 + torch.sum(state["sums"] / var_s[None, :], dim=-1)
    var = 1.0 / prec
    return var * num, var


def resample_mean(gen: torch.Generator, state: dict, spec: Mean,
                  site_stds: Sequence[float]) -> dict:
    """One draw from mean_posterior."""
    mean, var = mean_posterior(state, spec, site_stds)
    z = torch.randn(mean.shape, generator=gen, device=mean.device)
    return {**state, "value": (mean + torch.sqrt(var) * z).to(torch.float32)}
