"""The preference relaxation ladder, copied from the JAX package
(controllers/provisioning/preferences.py; reference preferences.go:38-146).
Each relaxation round removes exactly ONE preference per failing pod, in
the reference's rung order, and the whole problem re-solves."""

from __future__ import annotations

import copy

from karpenter_tpu_torch.models.pod import Pod
from karpenter_tpu_torch.models.taints import PREFER_NO_SCHEDULE, TOLERATION_OP_EXISTS, Toleration

RUNG_OR_TERM = "required-or-term"
RUNG_PREF_POD_AFFINITY = "preferred-pod-affinity"
RUNG_PREF_POD_ANTI = "preferred-pod-anti-affinity"
RUNG_PREF_NODE = "preferred-node-affinity"
RUNG_SOFT_TSC = "schedule-anyway-tsc"
RUNG_TOLERATE = "tolerate-prefer-no-schedule"


def rungs(pod: Pod) -> list[str]:
    """The pod-specific ladder in reference order; each entry removes one
    preference."""
    out: list[str] = []
    na = pod.spec.node_affinity
    if na is not None and len(na.required) > 1:
        out.extend([RUNG_OR_TERM] * (len(na.required) - 1))
    out.extend([RUNG_PREF_POD_AFFINITY] * len(pod.spec.preferred_pod_affinity))
    out.extend([RUNG_PREF_POD_ANTI] * len(pod.spec.preferred_pod_anti_affinity))
    if na is not None:
        out.extend([RUNG_PREF_NODE] * len(na.preferred))
    out.extend(
        [RUNG_SOFT_TSC]
        * sum(
            1
            for t in pod.spec.topology_spread_constraints
            if t.when_unsatisfiable == "ScheduleAnyway"
        )
    )
    out.append(RUNG_TOLERATE)
    return out


def relax_pod(pod: Pod, applied: int) -> Pod:
    """A copy of pod with the first `applied` rungs of its ladder applied."""
    if applied <= 0:
        return pod
    steps = rungs(pod)[:applied]
    relaxed = copy.copy(pod)
    relaxed.__dict__.pop("_sig", None)  # content changes: drop kind-sig cache
    relaxed.spec = copy.deepcopy(pod.spec)
    na = relaxed.spec.node_affinity

    dropped_or = steps.count(RUNG_OR_TERM)
    if dropped_or and na is not None:
        na.required = na.required[dropped_or:]

    n = steps.count(RUNG_PREF_POD_AFFINITY)
    if n:
        relaxed.spec.preferred_pod_affinity = relaxed.spec.preferred_pod_affinity[n:]
    n = steps.count(RUNG_PREF_POD_ANTI)
    if n:
        relaxed.spec.preferred_pod_anti_affinity = relaxed.spec.preferred_pod_anti_affinity[n:]

    n = steps.count(RUNG_PREF_NODE)
    if n and na is not None:
        # heaviest first (preferences.go:67: sort desc by weight)
        ordered = sorted(na.preferred, key=lambda t: -t.weight)
        na.preferred = ordered[n:]

    n = steps.count(RUNG_SOFT_TSC)
    if n:
        kept, removed = [], 0
        for t in relaxed.spec.topology_spread_constraints:
            if t.when_unsatisfiable == "ScheduleAnyway" and removed < n:
                removed += 1
                continue
            kept.append(t)
        relaxed.spec.topology_spread_constraints = kept

    if RUNG_TOLERATE in steps:
        relaxed.spec.tolerations = list(relaxed.spec.tolerations) + [
            Toleration(operator=TOLERATION_OP_EXISTS, effect=PREFER_NO_SCHEDULE)
        ]
    return relaxed


def run_with_relaxation(pods: list[Pod], solve_round, should_stop=None):
    """The outer relax-and-retry loop: each failing pod sheds one rung per
    round and the whole problem re-solves, until every pod places or no
    failing pod has a rung left. solve_round(current_pods) ->
    SchedulingResult, with fresh state per call. should_stop() is polled
    after each round: when it reports True (the Solve deadline passed) the
    round's result is returned without further relaxation."""
    originals = None
    applied: dict = {}
    current = list(pods)

    def _with_provenance(result):
        if originals is not None:
            result.relaxations = {
                uid: rungs(originals[uid])[:n] for uid, n in applied.items() if n
            }
        return result

    while True:
        result = solve_round(current)
        if should_stop is not None and should_stop():
            return _with_provenance(result)
        if not result.unschedulable:
            return _with_provenance(result)
        if originals is None:
            originals = {p.uid: p for p in pods}
            applied = {p.uid: 0 for p in pods}
        relaxed_any = False
        for p, _reason in result.unschedulable:
            orig = originals.get(p.uid)
            if orig is not None and applied[p.uid] < len(rungs(orig)):
                applied[p.uid] += 1
                relaxed_any = True
        if not relaxed_any:
            return _with_provenance(result)
        current = [relax_pod(originals[p.uid], applied[p.uid]) for p in pods]
