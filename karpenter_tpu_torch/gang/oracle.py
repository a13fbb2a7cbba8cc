"""Host-side slice-shape math (the JAX package's gang/oracle.py, cut to
what objectives/scoring.py reads): per-host capacity is the largest pod
count whose one-multiply-add f32 total fits an allocatable group of a
viable instance type with a compatible available offering."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.utils import resources as res

# the fill kernels' "unbounded" cap (ops/solver.py COUNT_CAP)
COUNT_CAP = 2**22


def merge_scaled(base: dict, req: dict, c: int) -> dict:
    """base + c*req per resource, f32, one multiply-add."""
    out = dict(base)
    cf = np.float32(c)
    for k, v in req.items():
        out[k] = float(np.float32(np.float32(out.get(k, 0.0)) + cf * np.float32(v)))
    return out


def fits_and_offering(groups: list, requirements, requests: dict) -> bool:
    """An allocatable group fits `requests` and holds an offering the
    requirements admit (the reference's host_scheduler._fits_and_offering)."""
    for group in groups:
        if not res.fits(requests, group.allocatable):
            continue
        for o in group.offerings:
            if requirements.is_compatible(o.requirements, l.WELL_KNOWN_LABELS):
                return True
    return False


def slice_capacity(its: list, requirements, daemon: dict, req: dict, host_ports: bool = False) -> int:
    """Max pods per host: the largest c with daemon + c*req fitting some
    viable type (monotone in c: doubling, then binary search). Host-port
    pods cap at one per host."""

    def ok(c: int) -> bool:
        total = merge_scaled(daemon, req, c)
        return any(fits_and_offering(it.allocatable_offerings(), requirements, total) for it in its)

    if not its or not ok(1):
        return 0
    if host_ports:
        return 1
    lo, hi = 1, 2
    while hi < COUNT_CAP and ok(hi):
        lo, hi = hi, hi * 2
    if hi >= COUNT_CAP and ok(hi):
        return COUNT_CAP
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo
