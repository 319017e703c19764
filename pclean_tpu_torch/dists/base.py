"""Distribution interface and argument reference types.

Counterpart of the reference's duck-typed PCleanDistribution
interface (PClean src/distributions/distributions.jl:1-20):

    random / logdensity / has_discrete_proposal / discrete_proposal /
    discrete_proposal_dummy_value / supports_explicitly_missing_observations

Here the same semantic surface is split in two:
  * declarative constructors (this package) hold the raw model arguments —
    static option lists, references to other model attributes (Ref),
    learned-parameter references (ParamRef);
  * the model compiler (engine/compile.py) resolves arguments against
    interned Domains and asks each distribution for dense prior tables /
    likelihood closures, the dense analogue of the reference's
    `discrete_proposal` enumeration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Ref:
    """Reference to a model attribute, possibly via a reference-slot chain.

    `Ref("hosp.loc.city")` plays the role of the reference DSL's dot
    expressions (syntax.jl:38-65); resolution happens in the builder
    (reference builder.jl:63-77).
    """

    path: str

    def __repr__(self):
        return f"Ref({self.path})"


@dataclass(frozen=True)
class ParamRef:
    """Reference to a learned parameter declared on the same class.

    Counterpart of `@learned` names flowing into distribution argument lists
    (reference syntax.jl:139-150)."""

    name: str

    def __repr__(self):
        return f"ParamRef({self.name})"


class PCleanDistribution:
    """Base class; concrete distributions set class attributes.

    enumerable — reference `has_discrete_proposal` (distributions.jl:11-14).
    supports_missing — reference
        `supports_explicitly_missing_observations` (distributions.jl:20).
    """

    enumerable: bool = False
    supports_missing: bool = False

    # Subclasses store their args in __init__ and implement compile hooks
    # used by engine/compile.py.

    def __repr__(self):
        return type(self).__name__


def as_ref(x: Any) -> Optional[Ref]:
    if isinstance(x, Ref):
        return x
    if isinstance(x, str):
        # Bare strings in argument positions that expect attributes are
        # treated as attribute paths by the DSL layer, never here: a string
        # is data. Return None.
        return None
    return None
