"""Learned-parameter specs and their tensor-backed conjugate state.

Counterpart of pclean_tpu/dists/params.py (reference Parameter interface,
distributions.jl:27-61). The specs are plain data and identical; the state
is a dict of fixed-shape tensors with an explicit leading index axis, and
every draw takes an explicit torch.Generator. The three conjugate
families: Proportions (Dirichlet-categorical, choose_proportionally.jl:
23-89), Prob (Beta-Bernoulli, maybe_swap.jl:41-95; Beta drawn as two gamma
draws, since torch's Beta sampler takes no generator) and Mean
(Normal-Normal, add_noise.jl:12-82). State is built on the device the entry
points resolve (the card unless the caller asks for "cpu"). The Dirichlet
and Beta draws go through K22 (ops.gamma_draw: gamma draws on a
counter-based stream keyed by one seed drawn from the generator, no host
sync); a prior's constants are host tables (prior_table) that the
compiled model uploads once (CompiledModel.use) and passes in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import ops
from ..utils import resolve_device


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


def concentration(spec: Proportions, num_options: int) -> np.ndarray:
    """The Dirichlet prior's concentration, float32 [num_options]."""
    conc = np.asarray(spec.concentration, dtype=np.float32)
    if conc.ndim == 0:
        conc = np.full(num_options, float(conc), dtype=np.float32)
    assert conc.shape == (num_options,), (conc.shape, num_options)
    return conc


def prior_table(spec, meta: dict) -> np.ndarray:
    """A parameter's prior constants as a host table (float32): a
    Proportions' concentration [num_options], a Prob's (a, b), a Mean's
    site variances std_s^2 [S]."""
    if isinstance(spec, Proportions):
        return concentration(spec, meta["num_options"])
    if isinstance(spec, Prob):
        return np.asarray([spec.a, spec.b], dtype=np.float32)
    stds = [s for (_w, s) in meta["sites"]] or [1.0]
    return np.asarray(stds, dtype=np.float32) ** 2


def proportions_desc(conc: torch.Tensor, rows: int, counts=None) -> dict:
    """K22's descriptor of Dirichlet(conc + counts) rows, stored as
    logs (the state's log_value)."""
    return ops.gamma_desc("dirichlet_log", conc, rows, conc.numel(), counts)


def prob_desc(ab: torch.Tensor, heads, tails) -> dict:
    """K22's descriptor of Beta(a + heads, b + tails) [I], ab the (a, b)
    table."""
    counts = torch.stack([heads, tails], 1)
    return ops.gamma_desc("beta", ab, counts.shape[0], 2, counts)


def init_proportions_state(gen: torch.Generator, spec: Proportions,
                           num_options: int, num_indices: int = 1,
                           device="cuda") -> dict:
    device = resolve_device(device)
    conc = torch.as_tensor(concentration(spec, num_options), device=device)
    (log_value,) = ops.gamma_draw([proportions_desc(conc, num_indices)],
                                  ops.draw_seed(gen, device))
    return {
        "counts": torch.zeros((num_indices, num_options), dtype=torch.int32,
                              device=device),
        "log_value": log_value,
    }


def init_prob_state(gen: torch.Generator, spec: Prob, num_indices: int = 1,
                    device="cuda") -> dict:
    device = resolve_device(device)
    zeros = torch.zeros((num_indices,), dtype=torch.int32, device=device)
    ab = torch.as_tensor(prior_table(spec, {}), device=device)
    (value,) = ops.gamma_draw([prob_desc(ab, zeros, zeros)],
                              ops.draw_seed(gen, device))
    return {"heads": zeros, "tails": zeros.clone(), "value": value}


def resample_prob(gen: torch.Generator, state: dict, spec: Prob) -> dict:
    """Beta(a + heads, b + tails) (maybe_swap.jl:87-89)."""
    dev = state["heads"].device
    ab = torch.as_tensor(prior_table(spec, {}), device=dev)
    (value,) = ops.gamma_draw([prob_desc(ab, state["heads"],
                                         state["tails"])],
                              ops.draw_seed(gen, dev))
    return {**state, "value": value}


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


def mean_posterior(state: dict, spec: Mean, site_stds: Sequence[float],
                   var_s=None):
    """(mean, var) [I] of the exact Normal-Normal posterior over all sites
    (add_noise.jl:74-82):

    posterior precision = 1/var0 + sum_s count_s/std_s^2
    posterior mean = var * (mean0/var0 + sum_s sum_s/std_s^2)

    `var_s`: the sites' variances std_s^2 [S] on the state's device
    (prior_table), else built here from site_stds.
    """
    var0 = spec.prior_std() ** 2
    if var_s is None:
        var_s = torch.as_tensor(np.asarray(site_stds, dtype=np.float32)
                                ** 2, device=state["sums"].device)  # [S]
    prec = 1.0 / var0 + torch.sum(state["counts"].to(torch.float32)
                                  / var_s[None, :], dim=-1)
    num = spec.mean / var0 + torch.sum(state["sums"] / var_s[None, :], dim=-1)
    var = 1.0 / prec
    return var * num, var


def resample_mean(gen: torch.Generator, state: dict, spec: Mean,
                  site_stds: Sequence[float], var_s=None) -> dict:
    """One draw from mean_posterior."""
    mean, var = mean_posterior(state, spec, site_stds, var_s)
    z = torch.randn(mean.shape, generator=gen, device=mean.device)
    return {**state, "value": (mean + torch.sqrt(var) * z).to(torch.float32)}
