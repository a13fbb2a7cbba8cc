"""Gangs: the pod-group contract of all-or-nothing multi-host slices (a
copy of the JAX package's gang/__init__.py, cut to what the solve needs).

Training jobs arrive as GANGS: identically-specced pods carrying a shared
gang name, a total size and a per-member rank, which must land together
on one multi-host slice or not at all. This module parses and validates
the annotations (`gang_of`, `collect_gangs`) and fixes the gang solve
order (`order_gangs`: largest slice first, members in rank order, gangs
before singleton pods).

Placement semantics (TorchScheduler.solve, as the reference's solve):
  * a gang places only on freshly-opened dedicated claims, which later
    pods never share;
  * rank r lands on slice host r // pods_per_host, contiguous rank blocks
    per claim;
  * every member places in one dispatch, or every member fails together
    with one reason.

The straggler wait (the reference's GangWaitTracker) needs a clock and
metrics and belongs to a provisioner, which this package does not have.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

GANG_NAME_ANNOTATION = "ktpu.dev/gang-name"
GANG_SIZE_ANNOTATION = "ktpu.dev/gang-size"
GANG_RANK_ANNOTATION = "ktpu.dev/gang-rank"
# stamped on every NodeClaim of a gang slice
GANG_CLAIM_ANNOTATION = "ktpu.dev/gang"

# unschedulable reasons (the reference's strings)
GANG_SPILL_REASON = "gang does not fit: no slice shape can hold every member"
GANG_INVALID_REASON = "invalid gang annotations"
GANG_WAITING_REASON = "gang waiting for stragglers"


def gang_of(pod) -> Optional[tuple[str, int, int]]:
    """(gang key, size, rank) parsed from the pod-group annotations, or
    None for singleton pods and malformed annotations (`collect_gangs`
    reports the latter as invalid)."""
    ann = pod.metadata.annotations
    name = ann.get(GANG_NAME_ANNOTATION)
    if not name:
        return None
    try:
        size = int(ann.get(GANG_SIZE_ANNOTATION, ""))
        rank = int(ann.get(GANG_RANK_ANNOTATION, ""))
    except (TypeError, ValueError):
        return None
    if size <= 0 or rank < 0 or rank >= size:
        return None
    return (f"{pod.metadata.namespace}/{name}", size, rank)


def is_gang_pod(pod) -> bool:
    return bool(pod.metadata.annotations.get(GANG_NAME_ANNOTATION))


@dataclass
class GangSpec:
    """One gang's membership as observed in a pod set."""

    key: str
    size: int
    members: dict[int, object] = field(default_factory=dict)  # rank -> Pod
    first_index: int = 0  # first appearance in the input order (tie-break)

    @property
    def complete(self) -> bool:
        return len(self.members) == self.size

    @property
    def missing(self) -> int:
        return self.size - len(self.members)

    def pods_in_rank_order(self) -> list:
        return [self.members[r] for r in sorted(self.members)]


def collect_gangs(pods) -> tuple[list[GangSpec], list, list]:
    """Partition a pod list into (gangs, singletons, invalid): one GangSpec
    per gang key in first-appearance order, and [(pod, reason)] for pods
    whose annotations cannot be honoured — malformed name / size / rank,
    duplicate ranks, conflicting sizes, or members that are not
    content-identical (a slice hosts one worker kind)."""
    from karpenter_tpu_torch.controllers.provisioning.host_scheduler import pod_content_sig

    gangs: dict[str, GangSpec] = {}
    singles: list = []
    invalid: list = []
    for i, pod in enumerate(pods):
        if not is_gang_pod(pod):
            singles.append(pod)
            continue
        parsed = gang_of(pod)
        if parsed is None:
            invalid.append((pod, f"{GANG_INVALID_REASON}: bad name/size/rank"))
            continue
        key, size, rank = parsed
        g = gangs.get(key)
        if g is None:
            g = gangs[key] = GangSpec(key=key, size=size, first_index=i)
        if g.size != size:
            invalid.append((pod, f"{GANG_INVALID_REASON}: conflicting gang-size"))
            continue
        if rank in g.members:
            invalid.append((pod, f"{GANG_INVALID_REASON}: duplicate rank {rank}"))
            continue
        g.members[rank] = pod
    out: list[GangSpec] = []
    for g in gangs.values():
        if len({pod_content_sig(p) for p in g.members.values()}) > 1:
            for p in g.pods_in_rank_order():
                invalid.append((p, f"{GANG_INVALID_REASON}: members not identical"))
            continue
        out.append(g)
    return out, singles, invalid


def order_gangs(gangs: list[GangSpec]) -> list[GangSpec]:
    """The gang solve order: largest slice footprint first (a member's FFD
    size times the gang size), first appearance on ties."""
    from karpenter_tpu_torch.controllers.provisioning.host_scheduler import pod_ffd_key

    def footprint(g: GangSpec) -> float:
        return pod_ffd_key(next(iter(g.members.values())))[1] * g.size

    return sorted(gangs, key=lambda g: (-footprint(g), g.first_index))


def partially_bound_gangs(pods) -> dict[str, tuple[int, int]]:
    """Gang key -> (bound members, size) for every gang with some but not
    all members bound to a node: the all-or-nothing bind invariant's
    violations (empty when it holds)."""
    bound: dict[str, int] = {}
    sizes: dict[str, int] = {}
    for p in pods:
        parsed = gang_of(p)
        if parsed is None:
            continue
        key, size, _rank = parsed
        sizes[key] = size
        if p.spec.node_name:
            bound[key] = bound.get(key, 0) + 1
    return {key: (bound.get(key, 0), size) for key, size in sizes.items() if 0 < bound.get(key, 0) < size}


def make_gang_pods(
    name: str,
    size: int,
    cpu: "str | float" = 1.0,
    memory: "str | float" = "1Gi",
    namespace: str = "default",
    **kwargs,
):
    """One complete gang of `size` rank-annotated, content-identical pods."""
    from karpenter_tpu_torch.models.pod import make_pod

    pods = []
    for rank in range(size):
        p = make_pod(f"{name}-{rank}", cpu=cpu, memory=memory, **kwargs)
        p.metadata.namespace = namespace
        p.metadata.annotations.update(
            {GANG_NAME_ANNOTATION: name, GANG_SIZE_ANNOTATION: str(size), GANG_RANK_ANNOTATION: str(rank)}
        )
        pods.append(p)
    return pods
