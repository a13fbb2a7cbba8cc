"""Requirement set algebra.

Counterpart of reference pkg/scheduling/requirement.go and requirements.go.
A Requirement is a compressed set over the values of one label key: either a
finite ``values`` set, or the *complement* of one (NotIn/Exists), with
optional inclusive integer bounds gte/lte (Gt/Lt are canonicalized on
construction, requirement.go:87-108) and a MinValues flexibility floor.

This module is deliberately pure-Python and allocation-light: it is the
semantic oracle the tensor encoding (karpenter_tpu_torch/ops/encode.py) is
golden-tested against. It is a copy of the JAX package's module, so the
port imports nothing of that package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

from karpenter_tpu_torch.models import labels as l


class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"
    GTE = "Gte"
    LTE = "Lte"


_MAX_INT = 2**63 - 1


def _parse_int(s: str) -> Optional[int]:
    try:
        return int(s)
    except ValueError:
        return None


def _within_bounds(value: str, gte: Optional[int], lte: Optional[int]) -> bool:
    """Bounds admit only integer-parseable values (requirement.go:334-348)."""
    if gte is None and lte is None:
        return True
    v = _parse_int(value)
    if v is None:
        return False
    if gte is not None and v < gte:
        return False
    if lte is not None and v > lte:
        return False
    return True


@dataclass
class Requirement:
    """One label key's constraint. Construct via `new_requirement`."""

    key: str
    complement: bool = False
    values: frozenset[str] = field(default_factory=frozenset)
    gte: Optional[int] = None  # inclusive
    lte: Optional[int] = None  # inclusive
    min_values: Optional[int] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def new(key: str, operator: "Operator | str", *values: str, min_values: Optional[int] = None) -> "Requirement":
        op = Operator(operator)
        key = l.NORMALIZED_LABELS.get(key, key)
        value_map = l.NORMALIZED_LABEL_VALUES.get(key)
        if value_map:
            values = tuple(value_map.get(v, v) for v in values)

        if op is Operator.IN:
            return Requirement(key=key, complement=False, values=frozenset(values), min_values=min_values)
        if op is Operator.DOES_NOT_EXIST:
            return Requirement(key=key, complement=False, values=frozenset(), min_values=min_values)

        r = Requirement(key=key, complement=True, min_values=min_values)
        if op is Operator.NOT_IN:
            r.values = frozenset(values)
        elif op is Operator.GT:
            v = int(values[0])
            if v == _MAX_INT:
                # Gt MaxInt matches nothing (requirement.go:91-94)
                return Requirement.new(key, Operator.DOES_NOT_EXIST, min_values=min_values)
            r.gte = v + 1
        elif op is Operator.LT:
            r.lte = int(values[0]) - 1
        elif op is Operator.GTE:
            r.gte = int(values[0])
        elif op is Operator.LTE:
            r.lte = int(values[0])
        return r

    # -- semantics ---------------------------------------------------------

    def operator(self) -> Operator:
        """Derive the canonical operator (requirement.go:290-301)."""
        if self.complement:
            return Operator.NOT_IN if self.values else Operator.EXISTS
        return Operator.IN if self.values else Operator.DOES_NOT_EXIST

    def is_lenient(self) -> bool:
        """NotIn / DoesNotExist — tolerated on keys the other side lacks."""
        return self.operator() in (Operator.NOT_IN, Operator.DOES_NOT_EXIST)

    def has(self, value: str) -> bool:
        """True if the requirement admits the value (requirement.go:~Has)."""
        in_set = value in self.values
        ok = (not in_set) if self.complement else in_set
        return ok and _within_bounds(value, self.gte, self.lte)

    def intersection(self, other: "Requirement") -> "Requirement":
        """Exact set intersection (requirement.go:181-214)."""
        complement = self.complement and other.complement
        gte = _max_opt(self.gte, other.gte)
        lte = _min_opt(self.lte, other.lte)
        min_values = _max_opt(self.min_values, other.min_values)
        if gte is not None and lte is not None and gte > lte:
            return Requirement.new(self.key, Operator.DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values  # union of exclusions
        elif self.complement:
            values = other.values - self.values
        elif other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = frozenset(v for v in values if _within_bounds(v, gte, lte))
        if not complement:
            gte, lte = None, None  # concrete sets carry no bounds
        return Requirement(
            key=self.key, complement=complement, values=values, gte=gte, lte=lte, min_values=min_values
        )

    def union(self, other: "Requirement") -> "Requirement":
        """Sound over-approximation of set union (no Go counterpart — the
        reference folds ORed node-selector terms by intersection, which can
        collapse to an empty set; see dra.types.or_node_selector_terms).
        Every value admitted by either side is admitted by the result."""
        both_gte = self.gte is not None and other.gte is not None
        both_lte = self.lte is not None and other.lte is not None
        if self.complement and other.complement:
            values = self.values & other.values
            gte = min(self.gte, other.gte) if both_gte else None
            lte = max(self.lte, other.lte) if both_lte else None
            return Requirement(key=self.key, complement=True, values=values, gte=gte, lte=lte)
        if self.complement:
            return Requirement(key=self.key, complement=True, values=self.values - other.values)
        if other.complement:
            return Requirement(key=self.key, complement=True, values=other.values - self.values)
        return Requirement(key=self.key, complement=False, values=self.values | other.values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Allocation-free fast path (requirement.go:220-254)."""
        gte = _max_opt(self.gte, other.gte)
        lte = _min_opt(self.lte, other.lte)
        if gte is not None and lte is not None and gte > lte:
            return False
        if self.complement and other.complement:
            return True
        if self.complement:
            return any(v not in self.values and _within_bounds(v, gte, lte) for v in other.values)
        if other.complement:
            return any(v not in other.values and _within_bounds(v, gte, lte) for v in self.values)
        return any(v in other.values and _within_bounds(v, gte, lte) for v in self.values)

    def any_value(self) -> str:
        """Some admissible value (requirement.go:~Any); deterministic here."""
        op = self.operator()
        if op is Operator.IN:
            return sorted(self.values)[0]
        if op in (Operator.NOT_IN, Operator.EXISTS):
            # The exclusion set rules out at most len(values) integers, so a
            # bounded scan of len(values)+1 candidates inside [gte, lte]
            # always finds an admissible value if one exists.
            span = len(self.values) + 1
            if self.gte is not None:
                candidates = range(self.gte, self.gte + span)
            elif self.lte is not None:
                candidates = range(self.lte, self.lte - span, -1)
            else:
                candidates = range(0, span)
            for v in candidates:
                if self.has(str(v)):
                    return str(v)
        return ""

    def __len__(self) -> int:
        # complement sets are "infinite minus exclusions" (requirement.go:303-308)
        if self.complement:
            return _MAX_INT - len(self.values)
        return len(self.values)

    def __str__(self) -> str:
        op = self.operator()
        if op in (Operator.EXISTS, Operator.DOES_NOT_EXIST):
            s = f"{self.key} {op.value}"
        else:
            vals = sorted(self.values)
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(vals) - 5} others"]
            s = f"{self.key} {op.value} {vals}"
        if self.gte is not None:
            s += f" >={self.gte}"
        if self.lte is not None:
            s += f" <={self.lte}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def node_selector_requirement(key: str, operator: str, values: Iterable[str] = (), min_values: Optional[int] = None) -> Requirement:
    """Build a Requirement from a NodeSelectorRequirement-shaped triple."""
    return Requirement.new(key, operator, *values, min_values=min_values)


class Requirements:
    """A map key -> Requirement with intersection-on-add semantics.

    Counterpart of reference pkg/scheduling/requirements.go:36-274.
    """

    __slots__ = ("_reqs",)

    def __init__(self, *requirements: Requirement):
        self._reqs: dict[str, Requirement] = {}
        self.add(*requirements)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_labels(labels: dict[str, str]) -> "Requirements":
        return Requirements(*(Requirement.new(k, Operator.IN, v) for k, v in labels.items()))

    @staticmethod
    def from_node_selector_requirements(reqs) -> "Requirements":
        """reqs: iterable of dicts {key, operator, values?, minValues?}."""
        return Requirements(
            *(
                node_selector_requirement(
                    r["key"], r["operator"], r.get("values", ()), r.get("minValues")
                )
                for r in reqs
            )
        )

    @staticmethod
    def from_pod(pod, include_preferred: bool = True) -> "Requirements":
        """Pod -> requirements (requirements.go:90-110): nodeSelector labels,
        heaviest preferred node-affinity term treated as required (when
        include_preferred), and the FIRST required node-affinity term (ORs
        are relaxed by an outer loop)."""
        reqs = Requirements.from_labels(dict(pod.spec.node_selector or {}))
        na = pod.spec.node_affinity
        if na is None:
            return reqs
        if include_preferred and na.preferred:
            heaviest = max(na.preferred, key=lambda t: t.weight)
            reqs.add(*(node_selector_requirement(m["key"], m["operator"], m.get("values", ())) for m in heaviest.match_expressions))
        if na.required:
            reqs.add(*(node_selector_requirement(m["key"], m["operator"], m.get("values", ())) for m in na.required[0].match_expressions))
        return reqs

    # -- map behavior ------------------------------------------------------

    def add(self, *requirements: Requirement) -> None:
        """Add with per-key intersection (requirements.go:133-140)."""
        for req in requirements:
            existing = self._reqs.get(req.key)
            if existing is not None:
                req = req.intersection(existing)
            self._reqs[req.key] = req

    def keys(self) -> set[str]:
        return set(self._reqs)

    def values(self) -> list[Requirement]:
        return list(self._reqs.values())

    def has(self, key: str) -> bool:
        return key in self._reqs

    def get(self, key: str) -> Requirement:
        """Missing keys read as Exists — any value (requirements.go:160-166)."""
        r = self._reqs.get(key)
        if r is None:
            return Requirement.new(key, Operator.EXISTS)
        return r

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._reqs.values())

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, key: str) -> bool:
        return key in self._reqs

    def copy(self) -> "Requirements":
        out = Requirements()
        out._reqs = dict(self._reqs)
        return out

    def relax_min_values(self, key: str, min_values: int) -> None:
        """Lower a key's minValues floor (BestEffort relaxation,
        nodeclaim.go:214-219). Replaces the Requirement object — instances
        may be shared across claims and templates."""
        import dataclasses

        r = self._reqs.get(key)
        if r is not None:
            self._reqs[key] = dataclasses.replace(r, min_values=min_values)

    def labels(self) -> dict[str, str]:
        """Single-valued In requirements as labels (for node fabrication)."""
        out = {}
        for key, req in self._reqs.items():
            if req.operator() is Operator.IN:
                out[key] = req.any_value()
        return out

    # -- compatibility -----------------------------------------------------

    def compatible(self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()) -> Optional[str]:
        """None if `incoming` can loosely be met by self, else an error string.

        Mirrors requirements.go:181-197: custom (non-allowed-undefined) keys
        in `incoming` must be defined on self unless the incoming operator is
        NotIn/DoesNotExist; then all shared keys must intersect.
        """
        for key in incoming.keys():
            if key in allow_undefined:
                continue
            if self.has(key) or incoming.get(key).is_lenient():
                continue
            return f'label "{key}" does not have known values'
        return self.intersects(incoming)

    def is_compatible(self, incoming: "Requirements", allow_undefined: frozenset[str] = frozenset()) -> bool:
        """Allocation-free boolean fast path (no error-string formatting —
        the reference keeps error construction lazy for the same reason,
        nodeclaim.go:543-556)."""
        for key in incoming._reqs:
            if key in allow_undefined:
                continue
            if key in self._reqs or incoming._reqs[key].is_lenient():
                continue
            return False
        return self.intersects_ok(incoming)

    def intersects_ok(self, incoming: "Requirements") -> bool:
        """Boolean twin of intersects() without error strings."""
        mine = self._reqs
        theirs = incoming._reqs
        if len(theirs) < len(mine):
            small, large = theirs, mine
        else:
            small, large = mine, theirs
        for key in small:
            if key not in large:
                continue
            existing = mine[key]
            inc = theirs[key]
            if not existing.has_intersection(inc):
                if inc.is_lenient() and existing.is_lenient():
                    continue
                return False
        return True

    def intersects(self, incoming: "Requirements") -> Optional[str]:
        """None if all shared keys intersect (requirements.go:254-274).

        A failed intersection is forgiven when BOTH sides' operators are in
        {NotIn, DoesNotExist} (both exclude, neither names a required value).
        """
        errs = []
        for key in self.keys() & incoming.keys():
            existing = self.get(key)
            inc = incoming.get(key)
            if not existing.has_intersection(inc):
                if inc.is_lenient() and existing.is_lenient():
                    continue
                errs.append(f"key {key}, {inc} not in {existing}")
        return "; ".join(errs) if errs else None

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._reqs.values())

    def __str__(self) -> str:
        reqs = [str(r) for r in self._reqs.values() if r.key not in l.RESTRICTED_LABELS]
        return ", ".join(sorted(reqs))


# Capacity-type shorthands (reference cloudprovider/types.go ReservedRequirement etc.)
def spot_requirements() -> Requirements:
    return Requirements(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_SPOT))


def on_demand_requirements() -> Requirements:
    return Requirements(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_ON_DEMAND))


def reserved_requirements() -> Requirements:
    return Requirements(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_RESERVED))
