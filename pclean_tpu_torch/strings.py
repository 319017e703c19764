"""String likelihood precompute: edit-distance kernels and a character LM.

Replaces the reference's lazy, memoized per-pair host scoring
(add_typos.jl:47-66, string_prior.jl:41-61) with dense matrices over interned
vocabularies, computed once at model-compile time. On the device these
become gather operands (the AddTypos matrices feed the obs_gather_sum kernel).
Host-side numpy only: a copy of pclean_tpu/strings.py that the port owns so
it never imports the JAX package.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np

from . import native
from .utils import IMPOSSIBLE

# Reference alphabet: a-z, space, '.' (string_prior.jl:9).
ALPHABET = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [" ", "."]
ALPHABET_INDEX = {c: i for i, c in enumerate(ALPHABET)}
UNUSUAL_LETTER_PENALTY = -1000.0  # string_prior.jl:41
LETTERS_PER_TYPO = 5.0  # add_typos.jl:48
TYPO_NB_P = 0.9  # NegativeBinomial success prob (add_typos.jl:37)


def pad_char_codes(strings: Sequence[str], max_len: Optional[int] = None):
    """Encode strings to padded int32 char-code rows for the native kernels."""
    ls = np.array([len(s) for s in strings], dtype=np.int32)
    L = int(max_len if max_len is not None else (ls.max() if len(ls) else 1))
    L = max(L, 1)
    out = np.full((len(strings), L), -1, dtype=np.int32)
    for i, s in enumerate(strings):
        n = min(len(s), L)
        out[i, :n] = np.frombuffer(s[:L].encode("utf-32-le"), dtype=np.uint32).astype(np.int32)
    return out, np.minimum(ls, L)


def osa_distances(a: Sequence[str], b: Sequence[str]) -> np.ndarray:
    """Restricted Damerau-Levenshtein distance matrix [len(a), len(b)]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), dtype=np.int32)
    L = max(max((len(s) for s in a), default=1), max((len(s) for s in b), default=1), 1)
    ac, al = pad_char_codes(a, L)
    bc, bl = pad_char_codes(b, L)
    return native.osa_distance_matrix(ac, al, bc, bl)


def _nb_logpmf(k: np.ndarray, r: np.ndarray, p: float) -> np.ndarray:
    """NegativeBinomial(r, p) log-pmf, Julia/Distributions.jl convention:
    pmf(k) = C(k + r - 1, k) * p^r * (1-p)^k  (number of failures k)."""
    k = np.asarray(k, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    lgamma = np.vectorize(math.lgamma, otypes=[np.float64])
    return (lgamma(k + r) - lgamma(k + 1.0) - lgamma(r)
            + r * math.log(p) + k * math.log1p(-p))


def typos_logdensity_matrix(observed: Sequence[str], sources: Sequence[str],
                            max_typos: Optional[int] = None) -> np.ndarray:
    """AddTypos log-likelihood matrix M[o, s] = log p(observed[o] | sources[s]).

    Matches add_typos.jl:50-66: d = OSA distance; score = NB(ceil(len/5), .9)
    logpmf(d) - d*log(len(source)) - (d/2)*log(26); IMPOSSIBLE beyond
    max_typos. Returns float32 [len(observed), len(sources)].
    """
    d = osa_distances(observed, sources).astype(np.float64)  # [O, S]
    slen = np.array([max(len(s), 1) for s in sources], dtype=np.float64)  # guard log(0)
    r = np.ceil(np.array([len(s) for s in sources], dtype=np.float64) / LETTERS_PER_TYPO)
    r = np.maximum(r, 1e-9)
    ll = _nb_logpmf(d, r[None, :], TYPO_NB_P)
    ll -= d * np.log(slen)[None, :]
    ll -= d / 2.0 * math.log(26.0)
    if max_typos is not None:
        ll = np.where(d > max_typos, IMPOSSIBLE, ll)
    return ll.astype(np.float32)


class CharBigramLM:
    """Letter-bigram language model over the 28-char reference alphabet.

    The reference ships fixed English parameters as CSVs
    (string_prior.jl:6-11, lmparams/*.csv). We instead fit add-delta-smoothed
    bigram statistics on a corpus (by default the model's own proposal atoms),
    and can also load reference-format CSVs for exact parity. Scoring follows
    string_prior.jl:41-61: uniform length prob over [min_len, max_len], chain
    of transition probs, -log(28) for out-of-alphabet chars, per-letter floor
    of -1000.
    """

    def __init__(self, initial_logprobs: np.ndarray, transition_logprobs: np.ndarray):
        # transition_logprobs[next, prev]: column-indexed by previous letter,
        # matching the reference layout (string_prior.jl:32,55).
        self.initial = initial_logprobs.astype(np.float64)
        self.transition = transition_logprobs.astype(np.float64)

    @staticmethod
    def fit(corpus: Sequence[str], delta: float = 0.5) -> "CharBigramLM":
        K = len(ALPHABET)
        init = np.full(K, delta, dtype=np.float64)
        trans = np.full((K, K), delta, dtype=np.float64)
        for s in corpus:
            prev = None
            for ch in s:
                c = ALPHABET_INDEX.get(ch.lower())
                if c is None:
                    prev = None
                    continue
                if prev is None:
                    init[c] += 1.0
                else:
                    trans[c, prev] += 1.0
                prev = c
        init = np.log(init / init.sum())
        trans = np.log(trans / trans.sum(axis=0, keepdims=True))
        return CharBigramLM(init, trans)

    @staticmethod
    def from_csv(initial_path: str, transition_path: str) -> "CharBigramLM":
        init = np.loadtxt(initial_path, delimiter=",").reshape(-1)
        trans = np.loadtxt(transition_path, delimiter=",")
        with np.errstate(divide="ignore"):
            return CharBigramLM(np.log(init), np.log(trans))

    @staticmethod
    def default(corpus: Sequence[str] = ()) -> "CharBigramLM":
        """Reference lmparams from $PCLEAN_LMPARAMS_DIR if present, else fit
        the corpus."""
        ref_dir = os.environ.get("PCLEAN_LMPARAMS_DIR", "")
        ip = os.path.join(ref_dir, "letter_probabilities.csv")
        tp = os.path.join(ref_dir, "letter_transition_matrix.csv")
        if os.path.exists(ip) and os.path.exists(tp):
            try:
                return CharBigramLM.from_csv(ip, tp)
            except Exception:
                pass
        return CharBigramLM.fit(corpus if len(corpus) else ALPHABET)

    def logdensity(self, s: str, min_len: int, max_len: int) -> float:
        """Score one string (string_prior.jl:41-61)."""
        if len(s) < min_len or len(s) > max_len:
            return -np.inf
        score = -math.log(max_len - min_len + 1)
        prev = None
        for ch in s:
            dist = self.initial if prev is None else self.transition[:, prev]
            cur = ALPHABET_INDEX.get(ch.lower())
            prev = cur
            if cur is None:
                score += -math.log(28.0)
            else:
                score += max(float(dist[cur]), UNUSUAL_LETTER_PENALTY)
        return score

    def logdensity_array(self, strings: Sequence[str], min_len: int, max_len: int) -> np.ndarray:
        return np.array([self.logdensity(s, min_len, max_len) for s in strings],
                        dtype=np.float32)
