"""PClean distributions, declarative form (the subset the port runs).

The port carries the distributions of its main path: ChooseProportionally,
ChooseUniformly, StringPrior and AddTypos. The rest of pclean_tpu/dists/core.py
(TimePrior, MaybeSwap, AddNoise, TransformedGaussian, FormatName,
ExpandOnShortVersion, NumberCodePrior, Unmodeled) comes with their kernels in
a later slice. Each class mirrors one reference distribution file under
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
from typing import Optional, Sequence, Union

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
