"""Result types and FFD ordering shared with the JAX package's host
scheduler (controllers/provisioning/host_scheduler.py), cut to what the
port's solve needs: SimClaim / ExistingSimNode / SchedulingResult, the
placeholder hostnames, the claim finalizers of the decode (reserved
pins, BestEffort minValues), and the pure-Python FFD sort keys (the order
comes out identical to the reference's, native key gather or not)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from karpenter_tpu_torch.cloudprovider.instancetype import RESERVATION_ID_LABEL, InstanceType, satisfies_min_values
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import ClaimTemplate
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.pod import Pod
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.utils import resources as res


@dataclass
class SimClaim:
    """One simulated in-flight NodeClaim."""

    template: ClaimTemplate
    requirements: Requirements
    used: dict[str, float]
    instance_types: list[InstanceType]
    pods: list[Pod] = field(default_factory=list)
    slot: int = 0
    hostname: str = ""  # placeholder hostname (nodeclaim.go:93)
    host_ports: list[tuple] = field(default_factory=list)
    # reservation ids this claim pessimistically holds (nodeclaim.go:52-60)
    reserved_ids: frozenset = frozenset()
    # BestEffort minValues relaxation happened (scheduler.go:769)
    min_values_relaxed: bool = False
    # the gang key when this claim is a slice host of a gang, else None
    gang: Optional[str] = None

    def cheapest_launch(self) -> tuple[Optional[InstanceType], float]:
        """Cheapest (type, price) among viable types/offerings compatible
        with the final requirements (kwok Create behavior)."""
        best_it, best_price = None, float("inf")
        for it in self.instance_types:
            p = it.cheapest_offering_price(self.requirements)
            if p < best_price:
                best_it, best_price = it, p
        return best_it, best_price


@dataclass
class ExistingSimNode:
    """Tier-1 candidate: an existing or in-flight real node
    (existingnode.go:32-75). requirements seed from the node's labels (incl.
    hostname) and evolve as pods land; available is allocatable minus
    current pods minus remaining daemon overhead."""

    name: str
    index: int
    requirements: Requirements
    available: dict[str, float]
    taints: list = field(default_factory=list)
    used: dict[str, float] = field(default_factory=dict)
    pods: list[Pod] = field(default_factory=list)
    host_ports: list[tuple] = field(default_factory=list)  # (ip, port, proto)
    # CSI attach tracking (scheduling.volumes.VolumeUsage); None = no
    # limits published, unconstrained
    volume_usage: object = None

    def clone(self) -> "ExistingSimNode":
        """Pristine copy for simulation retries (relaxation loop)."""
        return ExistingSimNode(
            name=self.name,
            index=self.index,
            requirements=self.requirements.copy(),
            available=dict(self.available),
            taints=list(self.taints),
            used=dict(self.used),
            pods=list(self.pods),
            host_ports=list(self.host_ports),
            volume_usage=self.volume_usage.copy() if self.volume_usage is not None else None,
        )


@dataclass
class SchedulingResult:
    claims: list[SimClaim]
    unschedulable: list[tuple[Pod, str]]
    assignments: dict[str, int]  # pod uid -> claim slot
    existing: list[ExistingSimNode] = field(default_factory=list)
    existing_assignments: dict[str, str] = field(default_factory=dict)  # pod uid -> node name
    # relaxation-ladder provenance: pod uid -> the rung names shed
    relaxations: dict = field(default_factory=dict)

    @property
    def node_count(self) -> int:
        return len(self.claims)

    def total_price(self) -> float:
        return sum(c.cheapest_launch()[1] for c in self.claims)


def hostname_placeholder(seq: int) -> str:
    """Simulation-only hostname for new claims (nodeclaim.go:93); shared by
    both engines so hostname-domain bookkeeping lines up."""
    return f"hostname-placeholder-{seq:04d}"


def finalize_reserved(claim: SimClaim) -> None:
    """FinalizeScheduling's reserved-capacity pin (nodeclaim.go:385-401): a
    claim holding reservations is pinned to capacity-type=reserved and its
    reservation ids, so claims never over-launch into one reservation."""
    if not claim.reserved_ids:
        return
    claim.requirements.add(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_RESERVED))
    claim.requirements.add(Requirement.new(RESERVATION_ID_LABEL, Operator.IN, *sorted(claim.reserved_ids)))


def finalize_min_values(claim: SimClaim) -> None:
    """BestEffort minValues at the end of a solve (scheduler.go:763-772,
    nodeclaim.go:214-219): floors the final viable types cannot meet drop
    to the distinct-value count they reach, and the claim is flagged
    relaxed. A no-op for floors that hold."""
    reqs = claim.requirements
    if not reqs.has_min_values():
        return
    _, unsat, err = satisfies_min_values(claim.instance_types, reqs)
    if not err:
        return
    for key, achievable in unsat.items():
        reqs.relax_min_values(key, achievable)
    claim.min_values_relaxed = True


def normalize_volume_reqs(volume_reqs: Optional[dict]) -> dict:
    """uid -> non-empty list of Requirements alternatives (drops None and
    empty entries)."""
    return {uid: list(v) for uid, v in (volume_reqs or {}).items() if v}


def _canon_terms(terms) -> tuple:
    """Affinity/TSC term lists with their label_selector dicts sorted by
    key, so content-equal pods built with different key order share a
    kind; every other term field rides along positionally."""
    out = []
    for t in terms:
        row = []
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if isinstance(v, dict):
                v = tuple(sorted(v.items()))
            elif isinstance(v, list):
                v = tuple(v)
            row.append(v)
        out.append(tuple(row))
    return tuple(out)


def pod_content_sig(pod: Pod) -> tuple:
    """Canonical content signature for pod-kind grouping, cached on the pod
    object (pod specs are immutable post-construction; the preference
    relaxation ladder derives NEW pod copies and drops the cache). Two pods
    with equal signatures produce identical rows in every encoded problem
    tensor. Dict-typed fields are canonicalized by sorted key; list-typed
    fields keep their order."""
    s = pod.__dict__.get("_sig")
    if s is None:
        sp = pod.spec
        s = (
            tuple(sorted(sp.requests.items())),
            tuple(sorted(sp.limits.items())),
            tuple(sorted(sp.node_selector.items())),
            repr(sp.node_affinity),
            _canon_terms(sp.pod_affinity),
            _canon_terms(sp.pod_anti_affinity),
            _canon_terms(sp.preferred_pod_affinity),
            _canon_terms(sp.preferred_pod_anti_affinity),
            _canon_terms(sp.topology_spread_constraints),
            repr(sp.tolerations),
            repr(sp.host_ports),
            sp.node_name,
            sp.priority,
            tuple(sp.pvc_names),
            tuple(sp.resource_claims),
            sp.termination_grace_period_seconds,
            tuple(sorted(pod.metadata.labels.items())),
            pod.metadata.namespace,  # topology groups are per-namespace
        )
        pod.__dict__["_sig"] = s
    return s


def pod_ffd_key(pod: Pod) -> tuple[tuple, float]:
    """(content sig, FFD size) — CPU + memory/4GiB, queue.go:72-90."""
    req = pod.spec.requests
    return (
        pod_content_sig(pod),
        req.get(res.CPU, 0.0) + req.get(res.MEMORY, 0.0) / (4.0 * 2**30),
    )


def ffd_keys(pods: list[Pod], kind_sig=pod_content_sig) -> tuple[np.ndarray, np.ndarray]:
    """(kind ids by first appearance of `kind_sig`, FFD sizes) for a pod
    list."""
    ids: dict = {}
    n = len(pods)
    sig = np.empty(n, dtype=np.int64)
    sizes = np.empty(n, dtype=np.float64)
    for i, p in enumerate(pods):
        _s, sizes[i] = pod_ffd_key(p)
        sig[i] = ids.setdefault(kind_sig(p), len(ids))
    return sig, sizes


def ffd_sort(pods: list[Pod]) -> list[Pod]:
    """CPU+memory descending (queue.go:72-90), ties grouped by pod kind in
    first-appearance order (stable, so identical pods are contiguous; the
    kind-level fill path relies on it). The kind ids of ffd_keys ARE
    first-appearance ranks, so one lexsort gives the reference's order."""
    sig, sizes = ffd_keys(list(pods))
    return [pods[i] for i in np.lexsort((sig, -sizes))]
