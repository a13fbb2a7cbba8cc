"""NodePool: the template half of the JAX package's models/nodepool.py
(the fields build_templates reads; disruption budgets are not on the
solve path)."""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.models.objects import ObjectMeta
from karpenter_tpu_torch.models.taints import Taint


@dataclass
class Limits:
    """Resource caps incl. the synthetic 'nodes' resource."""

    resources: dict[str, float] = field(default_factory=dict)


@dataclass
class NodeClaimTemplateSpec:
    """The NodeClaim spec stamped out by this pool."""

    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    requirements: list[dict] = field(default_factory=list)  # {key, operator, values, minValues}
    node_class_ref: Optional[dict] = None
    expire_after_seconds: Optional[float] = None  # None = Never
    termination_grace_period_seconds: Optional[float] = None


@dataclass
class NodeClaimTemplate:
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    spec: NodeClaimTemplateSpec = field(default_factory=NodeClaimTemplateSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    limits: Optional[Limits] = None
    weight: int = 0  # 1-100; higher = tried first
    replicas: Optional[int] = None  # static capacity pools


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name="default"))
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def is_static(self) -> bool:
        return self.spec.replicas is not None

    def static_hash(self) -> str:
        """Hash of drift-relevant static fields (nodepool.go:334-344)."""
        payload = {
            "labels": self.spec.template.labels,
            "annotations": self.spec.template.annotations,
            "node_class_ref": self.spec.template.spec.node_class_ref,
            "taints": [(t.key, t.value, t.effect) for t in self.spec.template.spec.taints],
            "startup_taints": [(t.key, t.value, t.effect) for t in self.spec.template.spec.startup_taints],
            "expire_after": self.spec.template.spec.expire_after_seconds,
            "termination_grace_period": self.spec.template.spec.termination_grace_period_seconds,
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
