"""The synthetic instance-type catalog of the JAX package's
cloudprovider/fake.py (families × cpu sizes × archs × zones ×
{spot, on-demand}, spot at 70% of on-demand). The scripted provider is not
on the solve path and is not copied."""

from __future__ import annotations

import itertools
from typing import Optional

from karpenter_tpu_torch.cloudprovider.instancetype import InstanceType, InstanceTypeOverhead, Offering
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.utils import resources as res

DEFAULT_ZONES = ("test-zone-1", "test-zone-2", "test-zone-3", "test-zone-4")
GIB = 2**30

# family -> (price multiplier, GiB memory per vCPU)
FAMILIES = {
    "c": (0.8, 2),   # compute optimized
    "s": (1.0, 4),   # standard
    "m": (1.2, 8),   # memory optimized
    "e": (0.6, 1),   # economy
}
CPU_SIZES = (1, 2, 4, 8, 16, 32, 48, 64)
ARCHS = (l.ARCH_AMD64, l.ARCH_ARM64)


def price_of(family: str, cpu: int, arch: str) -> float:
    mult, mem_ratio = FAMILIES[family]
    base = cpu * 0.035 + cpu * mem_ratio * 0.004
    if arch == l.ARCH_ARM64:
        base *= 0.85
    return round(base * mult, 5)


def new_instance_type(
    name: str,
    family: str = "s",
    cpu: int = 4,
    arch: str = l.ARCH_AMD64,
    os: str = "linux",
    zones: tuple[str, ...] = DEFAULT_ZONES,
    capacity_types: tuple[str, ...] = (l.CAPACITY_TYPE_SPOT, l.CAPACITY_TYPE_ON_DEMAND),
    extra_resources: Optional[dict[str, float]] = None,
    price_multiplier: float = 1.0,
    reservations: Optional[list[tuple[str, str, int]]] = None,
) -> InstanceType:
    """reservations: [(zone, reservation_id, capacity)] — adds reserved
    offerings (capacity-type=reserved + reservation-id requirement,
    priced 0 per the reserved->spot->on-demand launch-price precedence,
    types.go:587-598)."""
    mem_ratio = FAMILIES[family][1]
    memory = cpu * mem_ratio * GIB
    capacity = {
        res.CPU: float(cpu),
        res.MEMORY: float(memory),
        res.PODS: float(min(110, 16 + cpu * 8)),
        res.EPHEMERAL_STORAGE: 100.0 * GIB,
        **(extra_resources or {}),
    }
    od_price = price_of(family, cpu, arch) * price_multiplier
    offerings = []
    for zone, ct in itertools.product(zones, capacity_types):
        price = od_price * (0.7 if ct == l.CAPACITY_TYPE_SPOT else 1.0)
        offerings.append(
            Offering(
                requirements=Requirements(
                    Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, zone),
                    Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, ct),
                ),
                price=round(price, 5),
                available=True,
            )
        )
    for zone, rid, cap in reservations or ():
        offerings.append(
            Offering(
                requirements=Requirements(
                    Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, zone),
                    Requirement.new(
                        l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_RESERVED
                    ),
                    Requirement.new(l.RESERVATION_ID_LABEL_KEY, Operator.IN, rid),
                ),
                price=0.0,
                available=True,
                reservation_capacity=cap,
            )
        )
    capacity_types_all = tuple(capacity_types) + (
        (l.CAPACITY_TYPE_RESERVED,) if reservations else ()
    )
    requirements = Requirements(
        Requirement.new(l.LABEL_INSTANCE_TYPE, Operator.IN, name),
        Requirement.new("karpenter-tpu.sh/instance-family", Operator.IN, family),
        Requirement.new("karpenter-tpu.sh/instance-cpu", Operator.IN, str(cpu)),
        Requirement.new(l.LABEL_ARCH, Operator.IN, arch),
        Requirement.new(l.LABEL_OS, Operator.IN, os),
        Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, *zones),
        Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, *capacity_types_all),
    )
    if reservations:
        requirements.add(
            Requirement.new(
                l.RESERVATION_ID_LABEL_KEY,
                Operator.IN,
                *sorted({rid for _, rid, _ in reservations}),
            )
        )
    overhead = InstanceTypeOverhead(
        kube_reserved={res.CPU: 0.080 + cpu * 0.002, res.MEMORY: 255.0 * 2**20 + memory * 0.01},
        system_reserved={res.CPU: 0.0, res.MEMORY: 100.0 * 2**20},
        eviction_threshold={res.MEMORY: 100.0 * 2**20},
    )
    return InstanceType(name, requirements, offerings, capacity, overhead)


def instance_types(n: int = 400) -> list[InstanceType]:
    """Generate n diverse instance types (fake/instancetype.go:99 analog)."""
    out = []
    combos = itertools.cycle(
        (fam, cpu, arch)
        for cpu in CPU_SIZES
        for fam in FAMILIES
        for arch in ARCHS
    )
    seen_multiplier = 0
    for i in range(n):
        fam, cpu, arch = next(combos)
        if i and i % (len(CPU_SIZES) * len(FAMILIES) * len(ARCHS)) == 0:
            seen_multiplier += 1
        name = f"{fam}-{cpu}x-{arch}" + (f"-gen{seen_multiplier}" if seen_multiplier else "")
        out.append(
            new_instance_type(
                name, family=fam, cpu=cpu, arch=arch, price_multiplier=1.0 + 0.07 * seen_multiplier
            )
        )
    return out
