"""Workload generators shared by the tests and chip_smoke.py: copies of the
JAX package's benchmark workloads (bench.py `selector_pods` and
`make_templates`), built from this package's models so the two engines
see the same problem."""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import build_templates
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.models.pod import make_pod


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
