"""Minimal Pod model — just what scheduling and lifecycle need.

Match expressions are plain dicts {key, operator, values} so fixtures read
like YAML. Resource requests are canonical float dicts (see utils.resources).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.models.objects import ObjectMeta
from karpenter_tpu_torch.models.taints import Toleration
from karpenter_tpu_torch.utils import resources as res


@dataclass
class NodeSelectorTerm:
    match_expressions: list[dict] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    match_expressions: list[dict] = field(default_factory=list)


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution: list of OR'd terms
    required: list[NodeSelectorTerm] = field(default_factory=list)
    preferred: list[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    topology_key: str = ""
    label_selector: dict[str, str] = field(default_factory=dict)  # matchLabels only (v0)
    namespaces: list[str] = field(default_factory=list)


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: dict[str, str] = field(default_factory=dict)
    min_domains: Optional[int] = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore


@dataclass
class HostPort:
    port: int
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class PodSpec:
    requests: dict[str, float] = field(default_factory=dict)
    limits: dict[str, float] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: list[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: list[PodAffinityTerm] = field(default_factory=list)
    preferred_pod_affinity: list[PodAffinityTerm] = field(default_factory=list)
    preferred_pod_anti_affinity: list[PodAffinityTerm] = field(default_factory=list)
    tolerations: list[Toleration] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    host_ports: list[HostPort] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: int = 0
    pvc_names: list[str] = field(default_factory=list)
    restart_policy: str = "Always"
    # Names of ResourceClaims (DRA) this pod consumes (pod.spec.resourceClaims)
    resource_claims: list[str] = field(default_factory=list)
    # pod.spec.terminationGracePeriodSeconds (k8s defaults to 30s); drives
    # the TGP-clamped preemptive delete during drain (terminator.go:140-176)
    termination_grace_period_seconds: float = 30.0


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: dict[str, str] = field(default_factory=dict)
    nominated_node_name: str = ""
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name="pod"))
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def is_scheduled(self) -> bool:
        return bool(self.spec.node_name)

    def is_pending(self) -> bool:
        return self.status.phase == "Pending" and not self.spec.node_name

    def is_terminal(self) -> bool:
        return self.status.phase in ("Succeeded", "Failed")

    def is_provisionable(self) -> bool:
        """Pending, unbound, and marked unschedulable by the kube-scheduler
        (reference pkg/utils/pod/scheduling.go IsProvisionable)."""
        return self.is_pending() and self.status.conditions.get("PodScheduled") == "Unschedulable"

    def total_requests(self) -> dict[str, float]:
        return res.merge(self.spec.requests, {res.PODS: 1.0})


def make_pod(
    name: str,
    cpu: "str | float" = "100m",
    memory: "str | float" = "64Mi",
    node_selector: Optional[dict[str, str]] = None,
    **kwargs,
) -> Pod:
    """Convenience factory for tests/benchmarks."""
    spec = PodSpec(
        requests={res.CPU: res.parse_quantity(cpu), res.MEMORY: res.parse_quantity(memory)},
        node_selector=node_selector or {},
        **kwargs,
    )
    pod = Pod(metadata=ObjectMeta(name=name), spec=spec)
    pod.status.conditions["PodScheduled"] = "Unschedulable"
    return pod
