"""Value interning: closed domains of Python values -> integer codes.

The reference passes raw Julia values (strings, floats, arbitrary objects)
through its interpreter (e.g. option vectors in choose_proportionally.jl,
proposal atoms in string_prior.jl:16-22). On TPU every value must be a fixed
dtype, so at model-compile time each attribute gets a Domain: an ordered,
closed vocabulary of Python values interned to int32 codes, or a float scalar
domain. Dynamic "atom list" arguments (e.g. flights' per-flight TimePrior
atoms, rents' per-county StringPrior possibilities) are interned as codes into
a ListRegistry, which materializes a dense [num_lists, domain_size] membership
mask used by enumeration kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np

MISSING = object()  # sentinel for missing observations at the host level


def is_missing(v: Any) -> bool:
    if v is MISSING or v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return False


class Vocab:
    """Ordered, closed set of hashable Python values interned to int codes."""

    __slots__ = ("values", "index")

    def __init__(self, values: Iterable[Any] = ()):  # preserves order, dedupes
        self.values: list[Any] = []
        self.index: dict[Any, int] = {}
        for v in values:
            self.add(v)

    def add(self, v: Any) -> int:
        code = self.index.get(v)
        if code is None:
            code = len(self.values)
            self.index[v] = code
            self.values.append(v)
        return code

    def encode(self, v: Any) -> int:
        return self.index[v]

    def encode_or_add(self, v: Any) -> int:
        return self.add(v)

    def get(self, v: Any, default: int = -1) -> int:
        return self.index.get(v, default)

    def decode(self, code: int) -> Any:
        return self.values[code]

    def __len__(self) -> int:
        return len(self.values)

    def __contains__(self, v: Any) -> bool:
        return v in self.index

    def encode_array(self, vs: Sequence[Any], missing_code: int = 0):
        """Encode values -> (codes int32 [n], present bool [n]).

        Missing values (None / NaN / MISSING) and out-of-vocab values get
        `missing_code` with present=False.
        """
        n = len(vs)
        codes = np.full(n, missing_code, dtype=np.int32)
        present = np.zeros(n, dtype=bool)
        for i, v in enumerate(vs):
            if is_missing(v):
                continue
            c = self.index.get(v)
            if c is None:
                continue
            codes[i] = c
            present[i] = True
        return codes, present


FLOAT = "float"
CATEGORICAL = "categorical"


@dataclass
class Domain:
    """The value space of one model vertex.

    kind == CATEGORICAL: values live in `vocab`, runtime repr = int32 code.
    kind == FLOAT: runtime repr = float32 scalar.
    """

    kind: str
    vocab: Optional[Vocab] = None

    @staticmethod
    def categorical(values: Iterable[Any]) -> "Domain":
        return Domain(CATEGORICAL, Vocab(values))

    @staticmethod
    def floating() -> "Domain":
        return Domain(FLOAT)

    @property
    def size(self) -> int:
        assert self.kind == CATEGORICAL
        return len(self.vocab)

    def __repr__(self):
        if self.kind == FLOAT:
            return "Domain(float)"
        return f"Domain(categorical, |V|={len(self.vocab)})"


class ListRegistry:
    """Interns lists of values (all belonging to one Domain) as codes.

    Produces a dense membership mask [num_lists, |domain|] plus per-list
    lengths, so kernels can express "uniform over this row's atom set" as a
    masked vector op (reference: time_prior.jl:8-18 atom lists,
    string_prior.jl proposal_atoms).
    """

    def __init__(self, domain: Domain):
        assert domain.kind == CATEGORICAL
        self.domain = domain
        self._lists: list[tuple[int, ...]] = []
        self._index: dict[tuple[int, ...], int] = {}

    def intern(self, values: Sequence[Any]) -> int:
        codes = tuple(sorted({self.domain.vocab.encode_or_add(v) for v in values}))
        code = self._index.get(codes)
        if code is None:
            code = len(self._lists)
            self._index[codes] = code
            self._lists.append(codes)
        return code

    def __len__(self):
        return len(self._lists)

    def mask_matrix(self) -> np.ndarray:
        """bool [num_lists, |domain|]; built after all interning is done."""
        m = np.zeros((len(self._lists), len(self.domain.vocab)), dtype=bool)
        for i, codes in enumerate(self._lists):
            m[i, list(codes)] = True
        return m

    def lengths(self) -> np.ndarray:
        return np.array([len(c) for c in self._lists], dtype=np.int32)
