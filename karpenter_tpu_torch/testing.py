"""Workload generators shared by the tests and chip_smoke.py: copies of the
JAX package's benchmark workloads (bench.py `selector_pods`,
`mixed_pods`, `zonal_pods`, `hostname_pods`, `perpod_pods` and
`make_templates`), built from this package's models so the two engines
see the same problem."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import build_templates
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.models.pod import PodAffinityTerm, TopologySpreadConstraint, make_pod


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
