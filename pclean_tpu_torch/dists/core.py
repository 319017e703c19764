"""PClean distributions, declarative form (the subset the port runs).

The port carries the distributions of its scaled, rents and flights paths:
ChooseProportionally, ChooseUniformly, StringPrior, TimePrior, AddTypos,
MaybeSwap, AddNoise, TransformedGaussian (with its Transformation) and
Unmodeled. The rest of pclean_tpu/dists/core.py (FormatName,
ExpandOnShortVersion, NumberCodePrior) comes with their kernels in a later
slice. Each class mirrors one reference distribution file under
PClean's src/distributions/ (cited per class). Constructors take the same
argument lists as the reference so models read alike; arguments may be:

  * static Python data (lists of options, floats),
  * Ref("attr.path") — value of another model attribute (possibly through a
    reference-slot chain),
  * ParamRef("name") — a learned parameter declared on the class.

The math lives in small helpers here; engine/compile.py turns them into
dense tables over interned Domains, which replace the reference's per-value
interpreter and its `discrete_proposal` enumerations.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .base import ParamRef, PCleanDistribution, Ref

ArgT = Union[Ref, ParamRef, Sequence, float, int, None]


class ChooseProportionally(PCleanDistribution):
    """Categorical over `options` with weights (choose_proportionally.jl:1-21).

    logdensity sums weights over duplicate matching options and is -Inf for
    values outside `options`; full-support discrete proposal.
    """

    enumerable = True

    def __init__(self, options: ArgT, probs: ArgT):
        self.options = options
        self.probs = probs


class ChooseUniformly(PCleanDistribution):
    """Uniform categorical; logdensity = -log(n) assuming the observation is
    possible (choose_uniformly.jl:7-10); enumerable (12-17)."""

    enumerable = True

    def __init__(self, options: ArgT):
        self.options = options


class StringPrior(PCleanDistribution):
    """Letter-bigram prior with enumerated proposal atoms + residual dummy
    (string_prior.jl:14-61)."""

    enumerable = True

    def __init__(self, min_length: int, max_length: int, atoms: ArgT):
        self.min_length = int(min_length)
        self.max_length = int(max_length)
        self.atoms = atoms

    def dummy_value(self) -> str:
        # string_prior.jl:24-26
        return "*" * int(math.floor((self.min_length + self.max_length) / 2))


class TimePrior(PCleanDistribution):
    """'h:mm a.m./p.m.' prior, uniform over 1440 minutes; enumerable over
    atoms matching the regex + dummy (time_prior.jl:5-27)."""

    enumerable = True
    TIME_RE = re.compile(r"^\d?\d:\d\d [ap]\.m\.$")

    def __init__(self, atoms: ArgT):
        self.atoms = atoms

    def dummy_value(self) -> str:
        return "**:** p.m."  # time_prior.jl:16-18

    @classmethod
    def atom_logprob(cls, s: str) -> float:
        return -math.log(1440.0) if cls.TIME_RE.match(s) else -np.inf


class AddTypos(PCleanDistribution):
    """Typo corruption of a source string (add_typos.jl).

    logdensity uses the restricted Damerau-Levenshtein distance as the typo
    count under NegativeBinomial(ceil(len/5), 0.9), with per-typo position
    and letter penalties (add_typos.jl:50-66); optional max_typos cap ->
    IMPOSSIBLE. Missing observations score 0 (supports_missing).
    """

    supports_missing = True

    def __init__(self, word: ArgT, max_typos: Optional[int] = None):
        self.word = word
        self.max_typos = max_typos


class MaybeSwap(PCleanDistribution):
    """With prob p, replace val by a uniform draw from options
    (maybe_swap.jl:5-28). Missing observations: 0 if val in options else
    -1000."""

    supports_missing = True

    def __init__(self, val: ArgT, options: ArgT, prob: ArgT):
        self.val = val
        self.options = options
        self.prob = prob


class AddNoise(PCleanDistribution):
    """Gaussian noise Normal(mean, std) (add_noise.jl:5-7); mean may be a
    learned MeanParameter."""

    def __init__(self, mean: ArgT, std: float):
        self.mean = mean
        self.std = float(std)


@dataclass(frozen=True, eq=False)
class Transformation:
    """User bijection with |g'| for the Jacobian correction
    (transformed_gaussian.jl:5-9). The callables take and return torch
    tensors; `deriv` may return a Python number for a constant derivative.
    Instances compare by identity, so each is one value of a vocabulary."""

    forward: Callable
    backward: Callable
    deriv: Callable


class TransformedGaussian(PCleanDistribution):
    """Gaussian pushed through a Transformation (transformed_gaussian.jl:13-16):
    logdensity = Normal(mean, std).logpdf(backward(x)) - log|deriv(backward(x))|.
    MeanParameter sufficient stats use backward(observed) (26-33)."""

    def __init__(self, mean: ArgT, std: float, transform: ArgT):
        self.mean = mean
        self.std = float(std)
        self.transform = transform


class Unmodeled(PCleanDistribution):
    """logdensity 0 for anything; sampling is an error (unmodeled.jl)."""

    supports_missing = True


# ---------------------------------------------------------------------------
# Shared host-side helpers used by the compiler
# ---------------------------------------------------------------------------

def uniform_enum_logits(mask: np.ndarray) -> np.ndarray:
    """-log(n) over True entries, NEG_INF-ish elsewhere. mask: [..., V]."""
    n = mask.sum(axis=-1, keepdims=True).astype(np.float64)
    with np.errstate(divide="ignore"):
        val = -np.log(np.maximum(n, 1))
    out = np.where(mask, val, -np.inf)
    return out.astype(np.float32)


def residual_dummy_logit(atom_logits: np.ndarray) -> float:
    """log1p(-exp(logsumexp(atom_logits))): the mass a proposal reserves for
    values outside the enumerated atoms (string_prior.jl:16-22,
    time_prior.jl:8-14)."""
    finite = atom_logits[np.isfinite(atom_logits)]
    if finite.size == 0:
        return 0.0
    m = finite.max()
    total = m + math.log(np.exp(finite - m).sum())
    total = min(total, -1e-6)  # guard: enumerated mass must stay below 1
    return float(math.log1p(-math.exp(total)))
