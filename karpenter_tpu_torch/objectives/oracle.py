"""The fleet price a finished solve buys (the JAX package's
objectives/oracle.py `total_price_per_hour`)."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.objectives.scoring import min_available_price


def total_price_per_hour(result) -> float:
    """Sum over fresh claims of the cheapest member type's price: what
    cost_min minimizes, and the objective stage's reported cost."""
    total = 0.0
    for c in result.claims:
        p = min((min_available_price(it) for it in c.instance_types), default=float("inf"))
        if np.isfinite(p):
            total += p
    return total
