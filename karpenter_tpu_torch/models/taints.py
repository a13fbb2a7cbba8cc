"""Taint / Toleration model with standard Kubernetes matching semantics."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.models import labels as l

# Effects
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Toleration operators
TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str
    value: str = ""

    def match(self, other: "Taint") -> bool:
        """MatchTaint: same key and effect (value ignored)."""
        return self.key == other.key and self.effect == other.effect


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[float] = None

    def tolerates(self, taint: Taint) -> bool:
        """Standard k8s ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        # empty key with Exists tolerates everything
        if not self.key:
            return self.operator == TOLERATION_OP_EXISTS
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return self.value == taint.value


# Karpenter-managed taints (reference pkg/apis/v1/taints.go:27-40)
DISRUPTED_NO_SCHEDULE_TAINT = Taint(key=l.DISRUPTED_TAINT_KEY, effect=NO_SCHEDULE)
UNREGISTERED_NO_EXECUTE_TAINT = Taint(key=l.UNREGISTERED_TAINT_KEY, effect=NO_EXECUTE)

# Taints expected while a node initializes; ignored on uninitialized managed
# nodes (reference pkg/scheduling/taints.go:38-52).
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_EXTERNAL_CLOUD_PROVIDER = "node.cloudprovider.kubernetes.io/uninitialized"

KNOWN_EPHEMERAL_TAINTS = (
    Taint(key=TAINT_NODE_NOT_READY, effect=NO_SCHEDULE),
    Taint(key=TAINT_NODE_NOT_READY, effect=NO_EXECUTE),
    Taint(key=TAINT_NODE_UNREACHABLE, effect=NO_SCHEDULE),
    Taint(key=TAINT_EXTERNAL_CLOUD_PROVIDER, effect=NO_SCHEDULE, value="true"),
    UNREGISTERED_NO_EXECUTE_TAINT,
)

KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES = ("readiness.k8s.io/",)


def is_known_ephemeral_taint(taint: Taint) -> bool:
    if any(known.match(taint) for known in KNOWN_EPHEMERAL_TAINTS):
        return True
    return any(taint.key.startswith(p) for p in KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES)
