"""Workload generators shared by the tests and chip_smoke.py: copies of the
JAX package's benchmark workloads (bench.py `selector_pods`,
`mixed_pods`, `zonal_pods`, `hostname_pods`, `perpod_pods` and
`make_templates`), built from this package's models so the two engines
see the same problem, and per-pod workloads that reach every path of
the per-pod step: `tier_templates` / `tier_pods` (kinds sharing claims
through a custom key), `guarded_pods` (hostname groups, one of them
initially empty), `wide_zone_pods` (a zone key wider than KSCAN_D) and
`existing_node` (tier 1)."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.controllers.provisioning.host_scheduler import ExistingSimNode
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import build_templates
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.models.pod import (
    NodeAffinity,
    NodeSelectorTerm,
    PodAffinityTerm,
    TopologySpreadConstraint,
    make_pod,
)

TIER = "example.com/tier"


def selector_pods(n: int, seed: int = 0):
    """n pods with random sizes; every fifth pod pins a zone, an arch or a
    capacity type (the selectors-only north-star workload)."""
    rng = np.random.default_rng(seed)
    zones = ("test-zone-1", "test-zone-2", "test-zone-3", "test-zone-4")
    pods = []
    for i in range(n):
        sel = {}
        if i % 5 == 1:
            sel[l.LABEL_TOPOLOGY_ZONE] = zones[i % len(zones)]
        if i % 5 == 2:
            sel[l.LABEL_ARCH] = l.ARCH_AMD64
        if i % 5 == 3:
            sel[l.CAPACITY_TYPE_LABEL_KEY] = l.CAPACITY_TYPE_ON_DEMAND
        pods.append(
            make_pod(
                f"p-{i}",
                cpu=float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.0, 4.0])),
                memory=f"{rng.choice([0.25, 0.5, 1.0, 2.0, 4.0])}Gi",
                node_selector=sel,
            )
        )
    return pods


def make_templates(n_types: int):
    """One default NodePool over the first n_types synthetic instance types."""
    pool = NodePool()
    pool.metadata.name = "default"
    return build_templates([(pool, instance_types(n_types))])


def mixed_pods(n: int):
    """The upstream scheduling benchmark's makeDiversePods: equal fifths of
    generic, zone-spread, hostname-spread, zone pod-affinity and hostname
    pod-anti-affinity pods (every anti pod shares one label)."""
    rng = np.random.default_rng(0)
    pods = []
    for i in range(n):
        p = make_pod(
            f"p-{i}",
            cpu=float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.0])),
            memory=f"{rng.choice([0.25, 0.5, 1.0, 2.0])}Gi",
        )
        kind = i % 5
        if kind == 1:
            p.metadata.labels = {"spread": "zonal"}
            p.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=l.LABEL_TOPOLOGY_ZONE, label_selector={"spread": "zonal"}
                )
            ]
        elif kind == 2:
            p.metadata.labels = {"spread": "host"}
            p.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=l.LABEL_HOSTNAME, label_selector={"spread": "host"}
                )
            ]
        elif kind == 3:
            p.metadata.labels = {"aff": "group"}
            p.spec.pod_affinity = [
                PodAffinityTerm(topology_key=l.LABEL_TOPOLOGY_ZONE, label_selector={"aff": "group"})
            ]
        elif kind == 4:
            p.metadata.labels = {"app": "nginx"}
            p.spec.pod_anti_affinity = [
                PodAffinityTerm(topology_key=l.LABEL_HOSTNAME, label_selector={"app": "nginx"})
            ]
        pods.append(p)
    return pods


def _spread_kinds(n: int, kinds: int, prefix: str, label: str, tag: str, keys: tuple):
    pods = []
    per = max(n // kinds, 1)
    for i in range(n):
        k = min(i // per, kinds - 1)
        p = make_pod(f"{prefix}-{i}", cpu=2.0, memory="1Gi")
        p.metadata.labels = {"grp": str(k), label: f"{tag}{k}"}
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={label: f"{tag}{k}"})
            for key in keys
        ]
        pods.append(p)
    return pods


def zonal_pods(n: int, kinds: int = 4, prefix: str = "zb"):
    """Kinds with a zone-spread constraint each, disjoint selectors (the
    kind-scan route)."""
    return _spread_kinds(n, kinds, prefix, "spread", "z", (l.LABEL_TOPOLOGY_ZONE,))


def hostname_pods(n: int, kinds: int = 4, prefix: str = "hb"):
    """Kinds with a hostname-spread constraint each, disjoint selectors
    (the fill route, carrying hostname-group counts)."""
    return _spread_kinds(n, kinds, prefix, "hspread", "h", (l.LABEL_HOSTNAME,))


def perpod_pods(n: int, kinds: int = 4, prefix: str = "pb"):
    """Kinds spread over two vocab keys (zone and capacity type), which the
    kind scan cannot take: they route to the per-pod scan."""
    return _spread_kinds(
        n, kinds, prefix, "spread", "p", (l.LABEL_TOPOLOGY_ZONE, l.CAPACITY_TYPE_LABEL_KEY)
    )


def tier_templates(n_types: int):
    """One NodePool over the first n_types types whose claims carry the
    custom key TIER In (a, b, c)."""
    pool = NodePool()
    pool.metadata.name = "default"
    pool.spec.template.spec.requirements = [{"key": TIER, "operator": "In", "values": ["a", "b", "c"]}]
    return build_templates([(pool, instance_types(n_types))])


def tier_pods(n_per_kind: int = 6):
    """Two per-pod kinds (zone and capacity-type spread) that share claims
    through TIER: kind A requires TIER In (a, b), kind B TIER In (b, c), so
    a claim narrowed to {a, b} meets a pod with {b, c} — a combined row
    equal to neither side on a key no topology group narrows."""
    pods = []
    for kind, vals in (("A", ["a", "b"]), ("B", ["b", "c"])):
        for i in range(n_per_kind):
            p = make_pod(f"t{kind}-{i}", cpu=0.5, memory="512Mi")
            p.metadata.labels = {"tier": kind}
            p.spec.node_affinity = NodeAffinity(required=[NodeSelectorTerm(
                match_expressions=[{"key": TIER, "operator": "In", "values": vals}])])
            p.spec.topology_spread_constraints = [
                TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={"tier": kind})
                for key in (l.LABEL_TOPOLOGY_ZONE, l.CAPACITY_TYPE_LABEL_KEY)
            ]
            pods.append(p)
    return pods


def existing_node(name: str = "node-a", cpu: float = 6.0) -> ExistingSimNode:
    """An on-demand node in test-zone-1 with cpu cores free."""
    reqs = Requirements()
    reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, name))
    reqs.add(Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, "test-zone-1"))
    reqs.add(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_ON_DEMAND))
    return ExistingSimNode(
        name=name, index=0, requirements=reqs, available={"cpu": cpu, "memory": float(2 * cpu * 2**30), "pods": 110.0},
    )


def guarded_pods(n: int):
    """Per-pod kinds with hostname groups: zone and capacity-type spread
    with a hostname anti-affinity on each kind, and a kind in an
    initially-empty hostname affinity group."""
    pods = _spread_kinds(n, 2, "g", "spread", "g", (l.LABEL_TOPOLOGY_ZONE, l.CAPACITY_TYPE_LABEL_KEY))
    for p in pods:
        p.spec.requests["cpu"] = 0.5
        p.spec.pod_anti_affinity = [PodAffinityTerm(topology_key=l.LABEL_HOSTNAME, label_selector=dict(p.metadata.labels))]
    for i in range(max(n // 4, 1)):
        p = make_pod(f"ha-{i}", cpu=0.25, memory="256Mi")
        p.metadata.labels = {"app": "together"}
        p.spec.pod_affinity = [PodAffinityTerm(topology_key=l.LABEL_HOSTNAME, label_selector={"app": "together"})]
        pods.append(p)
    return pods


def wide_zone_pods(n: int):
    """Zone-spread kinds beside pods that exclude 13 more zone names: the
    zone key holds 17 values, wider than KSCAN_D, so the spread kinds route
    to the per-pod scan."""
    extra = [f"extra-zone-{i}" for i in range(13)]
    away = [make_pod(f"away-{i}", cpu=0.5, memory="512Mi") for i in range(2)]
    for p in away:
        p.spec.node_affinity = NodeAffinity(required=[NodeSelectorTerm(
            match_expressions=[{"key": l.LABEL_TOPOLOGY_ZONE, "operator": "NotIn", "values": extra}])])
    return zonal_pods(n, kinds=2) + away
