"""Placement objectives (the JAX package's objectives/, cut to what the
solve path reads).

A placement objective is a template *rank* — a [G] int32 column on
``ops.solver.Templates`` that tier 3 opens in ascending order — plus a
*score*, which the K-variant fill dispatch (``ops.solver
solve_fill_variants``) minimizes over rank variants of one fill group.
``registry`` holds the policy table and the selection rules (objective=
keyword > KTPU_OBJECTIVE > lexical); ``scoring`` builds each policy's
canonical rank and its one-move variants; ``oracle`` prices a finished
result. The JAX package's "objective" quarantine belongs to its guard
package, which this package does not have: ``active_policy`` is the
resolved policy.
"""

from karpenter_tpu_torch.objectives.registry import (  # noqa: F401
    ENV_OBJECTIVE,
    ENV_OBJECTIVE_K,
    POLICIES,
    active_policy,
    objective_id,
    resolve_policy,
    variant_count,
)
