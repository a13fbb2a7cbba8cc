"""NodeClaim templates: NodePool -> solvable template.

Counterpart of reference nodeclaimtemplate.go:55-150: template requirements
are the pool's spec requirements + its labels (including the
karpenter.sh/nodepool label), and the instance-type options are pre-filtered
to those compatible with the template (scheduler.go:154-171).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.cloudprovider.instancetype import InstanceType
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.models.taints import Taint
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.scheduling.requirements import node_selector_requirement


@dataclass
class ClaimTemplate:
    nodepool_name: str
    weight: int
    requirements: Requirements
    instance_types: list[InstanceType]
    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    daemon_requests: dict[str, float] = field(default_factory=dict)
    is_static: bool = False
    expire_after_seconds: "float | None" = None
    termination_grace_period_seconds: "float | None" = None
    nodepool_hash: str = ""  # drift-detection hash (nodepool.go:334-344)


def build_template(pool: NodePool, instance_types: list[InstanceType]) -> ClaimTemplate:
    tmpl = pool.spec.template
    labels = dict(tmpl.labels)
    labels[l.NODEPOOL_LABEL_KEY] = pool.name
    reqs = Requirements()
    for r in tmpl.spec.requirements:
        reqs.add(
            node_selector_requirement(
                r["key"], r["operator"], r.get("values", ()), r.get("minValues")
            )
        )
    reqs.add(*Requirements.from_labels(labels).values())
    # pre-filter the catalog to types compatible with the template: the type
    # must intersect the template requirements and have >=1 available
    # offering compatible with them (scheduler.go:154-171)
    compatible = [
        it
        for it in instance_types
        if it.requirements.intersects(reqs) is None and it.has_compatible_offering(reqs)
    ]
    return ClaimTemplate(
        nodepool_name=pool.name,
        weight=pool.spec.weight,
        requirements=reqs,
        instance_types=compatible,
        taints=list(tmpl.spec.taints),
        startup_taints=list(tmpl.spec.startup_taints),
        labels=labels,
        is_static=pool.is_static,
        expire_after_seconds=tmpl.spec.expire_after_seconds,
        termination_grace_period_seconds=tmpl.spec.termination_grace_period_seconds,
        nodepool_hash=pool.static_hash(),
    )


def build_templates(
    pools: list[tuple[NodePool, list[InstanceType]]],
) -> list[ClaimTemplate]:
    """Templates in weight-priority order, heaviest first
    (provisioner.go:268-289); static pools are excluded from dynamic
    provisioning. Ties keep input (name) order for determinism."""
    out = [build_template(p, its) for p, its in pools if not p.is_static]
    out = [t for t in out if t.instance_types]
    out.sort(key=lambda t: -t.weight)
    return out
