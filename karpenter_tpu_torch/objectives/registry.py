"""The policy table and the selection rules (the JAX package's
objectives/registry.py).

Selection, per solve (nothing cached at import):

  1. the scheduler's ``objective=`` keyword (a NodePool's placement
     objective),
  2. ``KTPU_OBJECTIVE``,
  3. ``lexical`` — weight-ordered templates, no rank column.

An unknown name resolves to ``lexical``, as in the reference.
``KTPU_OBJECTIVE_K`` caps how many rank variants the K-variant fill
dispatch solves per group (0 or unset: the dp extent, 1 on one card;
always clamped to ops.solver.VARIANT_MAX, so the verdict word's winner
byte stays addressable).
"""

from __future__ import annotations

import os
from typing import Optional

ENV_OBJECTIVE = "KTPU_OBJECTIVE"
ENV_OBJECTIVE_K = "KTPU_OBJECTIVE_K"

#: policy name -> objective id, in ops.solver OBJ_* order
POLICIES = ("lexical", "cost_min", "frag_aware", "topo_spread", "gang_slice")


def objective_id(policy: str) -> int:
    """The objective id ops.solver's score formula switches on."""
    return POLICIES.index(policy)


def resolve_policy(nodepool_policy: Optional[str] = None) -> str:
    """The keyword, then the environment, then lexical; an unknown name
    counts as absent."""
    for cand in (nodepool_policy, os.environ.get(ENV_OBJECTIVE)):
        if cand and cand in POLICIES:
            return cand
    return "lexical"


def active_policy(nodepool_policy: Optional[str] = None) -> str:
    """The policy applied this solve (the reference's, without its
    quarantine rung)."""
    return resolve_policy(nodepool_policy)


def variant_count(dp_rows: int) -> int:
    """How many rank variants to solve per fill group: KTPU_OBJECTIVE_K,
    defaulting to the dp extent, never below 1 nor above VARIANT_MAX."""
    from karpenter_tpu_torch.ops.solver import VARIANT_MAX

    raw = os.environ.get(ENV_OBJECTIVE_K, "")
    try:
        k = int(raw) if raw else 0
    except ValueError:
        k = 0
    if k <= 0:
        k = max(dp_rows, 1)
    return max(1, min(k, VARIANT_MAX))
