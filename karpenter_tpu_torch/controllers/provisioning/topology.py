"""Topology groups: spread constraints, pod affinity and pod anti-affinity
(port of the JAX package's controllers/provisioning/topology.py, cut to
what the encode needs).

Every TSC and (anti)affinity term becomes a TopologyGroup tracking a
domain -> count map (topology.go / topologygroup.go), seeded from the
pods already bound to nodes; ops/topology.py
turns the groups into the count tensors the solver carries. Owners of an
anti-affinity term also get an inverse group, which records where they
land so that pods matching the selector avoid it (topology.go:330-356).
The host oracle's per-candidate chooser (`get` / `_next_*`) stays in the
JAX package: the device evaluates the same rules.

Selector matching is matchLabels-based; namespaces default to the pod's
own.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Iterable, Optional

from karpenter_tpu_torch.models.pod import Pod
from karpenter_tpu_torch.scheduling import Operator


class TopologyType(enum.Enum):
    SPREAD = "topology spread"
    AFFINITY = "pod affinity"
    ANTI_AFFINITY = "pod anti-affinity"


def _selects(selector: dict[str, str], pod: Pod) -> bool:
    if selector is None:
        return False
    return all(pod.metadata.labels.get(k) == v for k, v in selector.items())


class TopologyGroup:
    def __init__(
        self,
        ttype: TopologyType,
        key: str,
        selector: dict[str, str],
        max_skew: int = 1,
        min_domains: Optional[int] = None,
        namespaces: Optional[frozenset[str]] = None,
        initial_domains: Iterable[str] = (),
    ):
        self.type = ttype
        self.key = key
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.namespaces = namespaces or frozenset({"default"})
        self.domains: dict[str, int] = {d: 0 for d in initial_domains}
        self.owners: set[str] = set()  # pod uids

    def ident(self) -> tuple:
        """Group identity (topologygroup.go Hash)."""
        return (
            self.type,
            self.key,
            tuple(sorted(self.selector.items())),
            self.max_skew,
            self.min_domains,
            tuple(sorted(self.namespaces)),
        )

    def register(self, *domains: str) -> None:
        for d in domains:
            self.domains.setdefault(d, 0)

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1

    def selects(self, pod: Pod) -> bool:
        return pod.metadata.namespace in self.namespaces and _selects(self.selector, pod)

    def is_empty(self) -> bool:
        return all(c == 0 for c in self.domains.values())


def template_universe_domains(templates) -> dict[str, set[str]]:
    """The template/catalog half of the domain universe: template
    In-requirement values plus the instance-type domain values each
    template admits. Immutable per template set, so callers cache it."""
    domains: dict[str, set[str]] = defaultdict(set)
    for t in templates:
        for r in t.requirements:
            if r.operator() is Operator.IN:
                domains[r.key].update(r.values)
        for it in t.instance_types:
            for r in it.requirements:
                if r.operator() is not Operator.IN:
                    continue
                tmpl_req = t.requirements.get(r.key)
                domains[r.key].update(v for v in r.values if tmpl_req.has(v))
    return dict(domains)


def pods_declare_topology(pods: Iterable[Pod]) -> bool:
    """Whether any pod carries a TSC / (anti)affinity term."""
    for p in pods:
        s = p.spec
        if s.topology_spread_constraints or s.pod_affinity or s.pod_anti_affinity:
            return True
    return False


def build_universe_domains(
    templates, existing_nodes=(), template_base: "dict | None" = None
) -> dict[str, set[str]]:
    """key -> every reachable domain (topology.go:105-145): the template
    half (`template_base`, or computed) plus existing nodes' In values."""
    if template_base is None:
        template_base = template_universe_domains(templates)
    domains: dict[str, set[str]] = {k: set(v) for k, v in template_base.items()}
    for n in existing_nodes:
        for r in n.requirements:
            if r.operator() is Operator.IN:
                domains.setdefault(r.key, set()).update(r.values)
    return domains


class Topology:
    """All topology groups for one solve."""

    def __init__(self) -> None:
        self.groups: list[TopologyGroup] = []
        self.inverse_groups: list[TopologyGroup] = []
        self._by_ident: dict[tuple, TopologyGroup] = {}

    @staticmethod
    def build(
        pods: list[Pod],
        universe_domains: "dict[str, set[str]] | callable",
        bound_pods: Optional[list[tuple[Pod, dict[str, str]]]] = None,
    ) -> "Topology":
        """universe_domains: key -> known domains, or a zero-arg callable
        producing it, evaluated only when some pod declares topology.
        bound_pods: pods already placed, with their node's labels; they
        seed the groups' counts (topology.go:361-459 countDomains). A
        topology-free pod set with no bound anti-affinity gets an empty
        Topology."""
        if not pods_declare_topology(pods) and not any(
            entry[0].spec.pod_anti_affinity for entry in bound_pods or ()
        ):
            return Topology()
        if callable(universe_domains):
            universe_domains = universe_domains()
        topo = Topology()
        for pod in pods:
            for tsc in pod.spec.topology_spread_constraints:
                g = topo._ensure(
                    TopologyType.SPREAD, tsc.topology_key, tsc.label_selector, tsc.max_skew,
                    tsc.min_domains, pod, universe_domains.get(tsc.topology_key, set()),
                )
                g.owners.add(pod.uid)
            for term in pod.spec.pod_affinity:
                g = topo._ensure(
                    TopologyType.AFFINITY, term.topology_key, term.label_selector, 1, None, pod,
                    universe_domains.get(term.topology_key, set()),
                )
                g.owners.add(pod.uid)
            for term in pod.spec.pod_anti_affinity:
                g = topo._ensure(
                    TopologyType.ANTI_AFFINITY, term.topology_key, term.label_selector, 1, None, pod,
                    universe_domains.get(term.topology_key, set()),
                )
                g.owners.add(pod.uid)
                ig = topo._ensure_inverse(
                    term.topology_key, term.label_selector,
                    universe_domains.get(term.topology_key, set()), pod.metadata.namespace,
                )
                ig.owners.add(pod.uid)
        for pod, node_labels in bound_pods or []:
            for g in topo.groups:
                domain = node_labels.get(g.key)
                if domain is not None and g.selects(pod):
                    g.record(domain)
            # a bound pod with an anti-affinity term blocks its domain for
            # every pod matching that selector (updateInverseAffinities)
            for term in pod.spec.pod_anti_affinity:
                ig = topo._ensure_inverse(
                    term.topology_key, term.label_selector,
                    universe_domains.get(term.topology_key, set()), pod.metadata.namespace,
                )
                ig.owners.add(pod.uid)
                domain = node_labels.get(term.topology_key)
                if domain is not None:
                    ig.record(domain)
        return topo

    def _ensure(self, ttype, key, selector, max_skew, min_domains, pod, domains) -> TopologyGroup:
        g = TopologyGroup(
            ttype, key, selector, max_skew, min_domains, frozenset({pod.metadata.namespace}), domains
        )
        existing = self._by_ident.get(g.ident())
        if existing is not None:
            return existing
        self._by_ident[g.ident()] = g
        self.groups.append(g)
        return g

    def _ensure_inverse(self, key, selector, domains, namespace: str) -> TopologyGroup:
        g = TopologyGroup(
            TopologyType.ANTI_AFFINITY, key, selector, 1, None, frozenset({namespace}), domains
        )
        ident = ("inverse",) + g.ident()
        existing = self._by_ident.get(ident)
        if existing is not None:
            return existing
        self._by_ident[ident] = g
        self.inverse_groups.append(g)
        return g

    def register(self, key: str, domain: str) -> None:
        for g in self.groups + self.inverse_groups:
            if g.key == key:
                g.register(domain)

    @staticmethod
    def still_declared(g: TopologyGroup, pod: Pod) -> bool:
        """Whether the pod's current spec still declares this group (the
        relaxation ladder strips ScheduleAnyway TSCs from the spec)."""
        if g.type is TopologyType.SPREAD:
            return any(
                t.topology_key == g.key and t.label_selector == g.selector and t.max_skew == g.max_skew
                for t in pod.spec.topology_spread_constraints
            )
        terms = pod.spec.pod_affinity if g.type is TopologyType.AFFINITY else pod.spec.pod_anti_affinity
        return any(t.topology_key == g.key and t.label_selector == g.selector for t in terms)

