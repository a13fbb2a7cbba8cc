"""Host-side objective ranks (the JAX package's objectives/scoring.py).

Each policy turns the template list into a [G] int32 canonical rank: the
order tier 3 tries templates in. Variant 0 of the K-variant fill dispatch
is the canonical rank; variant k promotes the k-th best template to the
front.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.models import labels as l


def min_available_price(it) -> float:
    """Cheapest available offering of one instance type, +inf when the
    catalog has no priced available offering (an unknown price never looks
    cheap)."""
    prices = [o.price for o in it.offerings if o.available]
    return float(min(prices)) if prices else float("inf")


def template_price(template) -> float:
    """Cheapest member instance type: the template's price floor."""
    prices = [min_available_price(it) for it in template.instance_types]
    return min(prices) if prices else float("inf")


def _zone_signature(template) -> tuple:
    reqs = template.requirements
    if reqs.has(l.LABEL_TOPOLOGY_ZONE):
        return tuple(sorted(reqs.get(l.LABEL_TOPOLOGY_ZONE).values))
    return ()


def _frag_size(template) -> float:
    """Best-fit proxy: the smallest member node's total allocatable."""
    sizes = [sum(it.allocatable().values()) for it in template.instance_types]
    return min(sizes) if sizes else float("inf")


def _gang_capacity(template) -> int:
    """Per-host slice capacity for a unit pod (gang/oracle.py)."""
    from karpenter_tpu_torch.gang import oracle

    return oracle.slice_capacity(
        template.instance_types, template.requirements, dict(template.daemon_requests or {}), {"cpu": 1.0},
    )


def _rank_from_keys(keys: list) -> np.ndarray:
    order = sorted(range(len(keys)), key=lambda g: (keys[g], g))
    rank = np.zeros(len(keys), dtype=np.int32)
    for pos, g in enumerate(order):
        rank[g] = pos
    return rank


def canonical_rank(policy: str, templates: list) -> np.ndarray:
    """[G] int32: the policy's template order (0 = tried first). Keys sort
    ascending with the weight index as tie-break."""
    G = len(templates)
    if policy == "lexical":
        return np.arange(G, dtype=np.int32)
    if policy == "cost_min":
        keys: list = [template_price(t) for t in templates]
    elif policy == "frag_aware":
        keys = [_frag_size(t) for t in templates]
    elif policy == "topo_spread":
        # round-robin over distinct zone signatures
        occ: dict = {}
        keys = []
        for t in templates:
            sig = _zone_signature(t)
            keys.append(occ.get(sig, 0))
            occ[sig] = occ.get(sig, 0) + 1
    elif policy == "gang_slice":
        # descending per-host capacity = ascending hosts per gang
        keys = [-_gang_capacity(t) for t in templates]
    else:
        raise ValueError(f"unknown placement objective {policy!r}")
    return _rank_from_keys(keys)


def variant_ranks(rank: np.ndarray, kv: int) -> np.ndarray:
    """[KV, G] int32 one-move perturbations of the canonical rank: row 0
    canonical, row k the template ranked k promoted to min - 1 (which is
    -1 for a canonical rank: ranks are signed). KV clamps to G."""
    G = int(rank.shape[0])
    kv = max(1, min(kv, G))
    order = np.argsort(rank, kind="stable")
    out = np.tile(rank[None, :], (kv, 1)).astype(np.int32)
    front = np.int32(rank.min() - 1)
    for k in range(1, kv):
        out[k, order[k]] = front
    return out
