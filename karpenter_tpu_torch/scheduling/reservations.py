"""Reserved capacity per reservation id (a copy of the JAX package's
scheduling/reservations.py, cut to what the encode reads): the capacity of
each id is the least over its duplicate offerings, since several node pools
may reference one reservation (reservationmanager.go:28-47)."""

from __future__ import annotations

from typing import Iterable

from karpenter_tpu_torch.models import labels as l

RESERVED_MODE_FALLBACK = "fallback"
RESERVED_MODE_STRICT = "strict"


class ReservationManager:
    def __init__(self, instance_types: Iterable):
        self.capacity: dict[str, int] = {}
        for it in instance_types:
            for o in it.offerings:
                if o.capacity_type != l.CAPACITY_TYPE_RESERVED:
                    continue
                rid = o.reservation_id
                cur = self.capacity.get(rid)
                if cur is None or cur > o.reservation_capacity:
                    self.capacity[rid] = o.reservation_capacity
