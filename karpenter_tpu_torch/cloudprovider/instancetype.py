"""InstanceType / Offering models.

Counterpart of reference pkg/cloudprovider/types.go:123-598: memoized
allocatable computation with hugepage adjustment and per-offering
capacity/overhead override groups, price ordering, compatibility filtering,
greedy minValues satisfaction, and launch-time truncation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional

from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.scheduling.requirements import (
    on_demand_requirements,
    reserved_requirements,
    spot_requirements,
)
from karpenter_tpu_torch.utils import resources as res

RESERVATION_ID_LABEL = l.RESERVATION_ID_LABEL_KEY

MAX_FLOAT = math.inf


@dataclass
class InstanceTypeOverhead:
    """kube-reserved + system-reserved + eviction threshold
    (types.go:452-463)."""

    kube_reserved: dict[str, float] = field(default_factory=dict)
    system_reserved: dict[str, float] = field(default_factory=dict)
    eviction_threshold: dict[str, float] = field(default_factory=dict)

    def total(self) -> dict[str, float]:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class Offering:
    """Availability of an instance type in (zone × capacity-type
    [× reservation]) at a price (types.go:470-487)."""

    requirements: Requirements
    price: float
    available: bool = True
    reservation_capacity: int = 0
    capacity_override: dict[str, float] = field(default_factory=dict)
    overhead_override: Optional[InstanceTypeOverhead] = None
    _price_overlay_applied: bool = False

    @property
    def capacity_type(self) -> str:
        return self.requirements.get(l.CAPACITY_TYPE_LABEL_KEY).any_value()

    @property
    def zone(self) -> str:
        return self.requirements.get(l.LABEL_TOPOLOGY_ZONE).any_value()

    @property
    def reservation_id(self) -> str:
        return self.requirements.get(RESERVATION_ID_LABEL).any_value()

    def apply_price_overlay(self, change: str) -> None:
        self.price = adjusted_price(self.price, change)
        self._price_overlay_applied = True

    @property
    def is_price_overlaid(self) -> bool:
        return self._price_overlay_applied


def adjusted_price(price: float, change: str) -> float:
    """NodeOverlay price arithmetic: absolute / ±delta / ±percent
    (types.go:493-525)."""
    if not change:
        return price
    if not change.startswith(("+", "-")):
        return float(change)
    if change.endswith("%"):
        adjusted = price * (1 + float(change[:-1]) / 100.0)
    else:
        adjusted = price + float(change)
    return adjusted if adjusted >= 0 else 0.0


@dataclass
class AllocatableOfferings:
    """One allocatable resource set + the offerings producing it
    (types.go:196-199)."""

    allocatable: dict[str, float]
    offerings: list[Offering]


class InstanceType:
    """One machine shape: requirements + offerings + capacity + overhead."""

    def __init__(
        self,
        name: str,
        requirements: Requirements,
        offerings: list[Offering],
        capacity: dict[str, float],
        overhead: Optional[InstanceTypeOverhead] = None,
        dra_slices: Optional[list] = None,
        dra_attribute_bindings: Optional[list] = None,
    ):
        self.name = name
        self.requirements = requirements
        self.offerings = offerings
        # DRA: potential-device ResourceSlice templates this instance type
        # would publish after launch, and attribute-binding declarations for
        # runtime-only attributes (reference types.go InstanceType
        # .DynamicResources; consumed by scheduling/dra).
        self.dra_slices = dra_slices or []
        self.dra_attribute_bindings = dra_attribute_bindings or []
        # resource dicts are float32-quantized at every model boundary so
        # host arithmetic and the f32 device tensors agree exactly
        self.capacity = res.quantize(capacity)
        overhead = overhead or InstanceTypeOverhead()
        self.overhead = InstanceTypeOverhead(
            kube_reserved=res.quantize(overhead.kube_reserved),
            system_reserved=res.quantize(overhead.system_reserved),
            eviction_threshold=res.quantize(overhead.eviction_threshold),
        )
        self._allocatable_offerings: Optional[list[AllocatableOfferings]] = None
        self._capacity_overlay_applied = False

    # -- allocatable (types.go:202-334) -----------------------------------

    def _compute_allocatable(
        self,
        capacity_override: Optional[dict[str, float]],
        overhead_override: Optional[InstanceTypeOverhead],
    ) -> dict[str, float]:
        capacity = dict(self.capacity)
        if capacity_override:
            capacity.update(res.quantize(capacity_override))
        overhead = self.overhead.total()
        if overhead_override is not None:
            overhead = {**overhead, **overhead_override.total()}
        allocatable = res.subtract(capacity, overhead)
        # hugepage reservations come out of allocatable memory (types.go:282-293)
        for name, quantity in capacity.items():
            if name.startswith(res.HUGEPAGES_PREFIX):
                mem = allocatable.get(res.MEMORY, 0.0) - quantity
                allocatable[res.MEMORY] = max(mem, 0.0)
        return allocatable

    def _precompute(self) -> list[AllocatableOfferings]:
        available = [o for o in self.offerings if o.available]
        has_overrides = any(o.capacity_override or o.overhead_override for o in self.offerings)
        if not has_overrides:
            return [AllocatableOfferings(self._compute_allocatable(None, None), available)]
        # group available offerings by their override tuple; base group first
        groups: dict[tuple, AllocatableOfferings] = {}
        base = AllocatableOfferings(self._compute_allocatable(None, None), [])
        order: list[tuple] = [()]
        groups[()] = base
        for o in available:
            if not o.capacity_override and o.overhead_override is None:
                base.offerings.append(o)
                continue
            key = (
                tuple(sorted(o.capacity_override.items())),
                tuple(sorted(o.overhead_override.total().items())) if o.overhead_override else None,
            )
            if key not in groups:
                groups[key] = AllocatableOfferings(
                    self._compute_allocatable(o.capacity_override, o.overhead_override), []
                )
                order.append(key)
            groups[key].offerings.append(o)
        return [groups[k] for k in order]

    def allocatable_offerings(self) -> list[AllocatableOfferings]:
        if self._allocatable_offerings is None:
            self._allocatable_offerings = self._precompute()
        return self._allocatable_offerings

    def allocatable(self) -> dict[str, float]:
        """Base allocatable (no offering overrides)."""
        return self.allocatable_offerings()[0].allocatable

    # -- offerings ---------------------------------------------------------

    def offering_price(self, zone: str, capacity_type: str) -> Optional[float]:
        for o in self.offerings:
            if o.zone == zone and o.capacity_type == capacity_type:
                return o.price
        return None

    def available_offerings(self) -> list[Offering]:
        return [o for o in self.offerings if o.available]

    def cheapest_offering_price(self, reqs: Requirements) -> float:
        """Cheapest available LAUNCHABLE offering compatible with reqs, inf
        if none. Reserved offerings only count when the requirements pin a
        reservation id — a provider never launches into a reservation the
        claim doesn't name (FinalizeScheduling injects the pin,
        nodeclaim.go:393-401), so an unpinned claim prices at spot/OD."""
        pinned = reqs.has(RESERVATION_ID_LABEL)
        best = MAX_FLOAT
        for o in self.offerings:
            if not o.available:
                continue
            if o.capacity_type == l.CAPACITY_TYPE_RESERVED and not pinned:
                continue
            if reqs.is_compatible(o.requirements, l.WELL_KNOWN_LABELS):
                best = min(best, o.price)
        return best

    def has_compatible_offering(self, reqs: Requirements) -> bool:
        return any(
            reqs.is_compatible(o.requirements, l.WELL_KNOWN_LABELS) for o in self.available_offerings()
        )

    def apply_capacity_overlay(self, updated: dict[str, float]) -> None:
        self.capacity = {**self.capacity, **updated}
        self._capacity_overlay_applied = True
        self._allocatable_offerings = None

    @property
    def is_capacity_overlay_applied(self) -> bool:
        return self._capacity_overlay_applied

    @property
    def is_pricing_overlay_applied(self) -> bool:
        return any(o.is_price_overlaid for o in self.offerings)

    def __repr__(self) -> str:
        return f"InstanceType({self.name})"


# -- collection operations (types.go:336-455) ------------------------------


def order_by_price(its: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """Sort by cheapest compatible available offering (types.go:336-356).

    Python's stable sort preserves input order on ties, matching Go's needs
    for deterministic downstream minValues counting.
    """
    return sorted(its, key=lambda it: it.cheapest_offering_price(reqs))


def compatible_instance_types(its: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """Instance types with >=1 available offering compatible with reqs."""
    return [it for it in its if it.has_compatible_offering(reqs)]


def satisfies_min_values(
    its: list[InstanceType], reqs: Requirements
) -> tuple[int, dict[str, int], Optional[str]]:
    """Greedy distinct-value counting over the ordered instance types
    (types.go:399-433). Returns (min needed, unsatisfiable key counts, err)."""
    if not reqs.has_min_values():
        return 0, {}, None
    min_keys = [r for r in reqs if r.min_values is not None]
    values_for_key: dict[str, set[str]] = {r.key: set() for r in min_keys}
    incompatible: dict[str, int] = {}
    for i, it in enumerate(its):
        for r in min_keys:
            values_for_key[r.key].update(it.requirements.get(r.key).values)
        incompatible = {
            k: len(v)
            for k, v in values_for_key.items()
            if len(v) < (reqs.get(k).min_values or 0)
        }
        if not incompatible:
            return i + 1, {}, None
    return len(its), incompatible, (
        f"minValues requirement is not met for label(s) {sorted(incompatible)}" if incompatible else None
    )


def truncate_instance_types(
    its: list[InstanceType],
    reqs: Requirements,
    max_items: int,
    min_values_policy_best_effort: bool = False,
) -> list[InstanceType]:
    """Order by price, truncate, verify minValues still satisfiable
    (types.go:437-455). Raises ValueError if truncation breaks minValues."""
    truncated = order_by_price(list(its), reqs)[:max_items]
    if reqs.has_min_values() and not min_values_policy_best_effort:
        _, _, err = satisfies_min_values(truncated, reqs)
        if err:
            raise ValueError(f"validating minValues, {err}")
    return truncated


def cheapest(offerings: Iterable[Offering]) -> Optional[Offering]:
    offerings = list(offerings)
    return min(offerings, key=lambda o: o.price) if offerings else None


def worst_launch_price(offerings: list[Offering], reqs: Requirements) -> float:
    """Most expensive offering of the capacity type we'd launch with;
    precedence reserved -> spot -> on-demand (types.go:587-598)."""
    for ct_reqs in (reserved_requirements(), spot_requirements(), on_demand_requirements()):
        compat = [
            o
            for o in offerings
            if reqs.is_compatible(o.requirements, l.WELL_KNOWN_LABELS)
            and ct_reqs.is_compatible(o.requirements, l.WELL_KNOWN_LABELS)
        ]
        if compat:
            return max(o.price for o in compat)
    return MAX_FLOAT
