"""Taint toleration checks (reference pkg/scheduling/taints.go:78-112)."""

from __future__ import annotations

from typing import Iterable, Optional

from karpenter_tpu_torch.models.taints import Taint, Toleration


def tolerates(tolerations: Iterable[Toleration], taint: Taint) -> bool:
    return any(t.tolerates(taint) for t in tolerations)


def tolerates_all(taints: Iterable[Taint], tolerations: Iterable[Toleration]) -> Optional[str]:
    """None if every taint is tolerated, else a message naming the first miss."""
    tolerations = list(tolerations)
    for taint in taints:
        if not tolerates(tolerations, taint):
            return f"did not tolerate taint {taint.key}={taint.value}:{taint.effect}"
    return None


def merge(taints: list[Taint], with_taints: Iterable[Taint]) -> list[Taint]:
    """Append taints not already present by key+effect (taints.go:100-112)."""
    out = list(taints)
    for taint in with_taints:
        if not any(taint.match(t) for t in out):
            out.append(taint)
    return out
