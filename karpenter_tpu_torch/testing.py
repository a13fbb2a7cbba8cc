"""Workload generators shared by the tests and chip_smoke.py: copies of the
JAX package's benchmark workloads (bench.py `selector_pods`,
`mixed_pods`, `zonal_pods`, `hostname_pods`, `perpod_pods` and
`make_templates`), built from this package's models so the two engines
see the same problem, and per-pod workloads that reach every path of
the per-pod step: `tier_templates` / `tier_pods` (kinds sharing claims
through a custom key), `guarded_pods` (hostname groups, one of them
initially empty), `wide_zone_pods` (a zone key wider than KSCAN_D) and
`existing_node` (tier 1); and a consolidation fixture (`bound_cluster`,
`candidates`, `prefix_scenarios` / `single_scenarios`,
`topology_factory`, `sequential_signal`, the digests): a cluster whose nodes carry
bound pods, and the what-if scenarios the disruption methods submit.
Karpenter's constraints (`reserved_catalog`, `constrained_templates`,
`hostport_pods`, `attach_volumes`, `reserved_in_use`) build the
constrained cells: reserved offerings, minValues floors, a host-port
deployment, CSI attach limits and PVCs. Gangs (`gang_storm_pods`,
`spread_gang`, `gang_zonal_pods`) build the gang cells: a training-job
burst beside services, and zone- or hostname-spread gangs in a pool with
a spend limit. `mixed_pool_templates` builds the placement objectives'
four family pools.

The consolidation fixture, the constraints and the gang builders reads models only through a `side` namespace
(PORT by default), so the same code builds its twin from another
package's classes."""

from __future__ import annotations

import hashlib
import types
from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.cloudprovider import fake
from karpenter_tpu_torch.gang import make_gang_pods
from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.controllers.provisioning.host_scheduler import ExistingSimNode
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import build_templates
from karpenter_tpu_torch.controllers.provisioning.topology import (
    Topology,
    build_universe_domains,
    template_universe_domains,
)
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.nodepool import NodePool
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.models.pod import (
    HostPort,
    NodeAffinity,
    NodeSelectorTerm,
    PodAffinityTerm,
    TopologySpreadConstraint,
    make_pod,
)
from karpenter_tpu_torch.scheduling.volumes import VolumeUsage
from karpenter_tpu_torch.utils import resources as res

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


def mixed_pool_templates(n_types: int = 48, families=("m", "s", "c", "e"), side=None):
    """One pool per instance family over instance_types(n_types), the
    priciest family first, so that lexical's weight order is the expensive
    choice (the fake catalog's price multipliers: m 1.2, s 1.0, c 0.8, e
    0.6): the JAX package's objective fixture (tests/test_objectives.py
    mixed_pool_templates, bench.py run_objective_stage)."""
    side = side or PORT
    catalog = side.fake.instance_types(n_types)
    pools = []
    for fam in families:
        p = side.NodePool()
        p.metadata.name = f"{fam}-pool"
        p.spec.template.spec.requirements = [
            {"key": "karpenter-tpu.sh/instance-family", "operator": "In", "values": [fam]},
        ]
        pools.append((p, catalog))
    return side.build_templates(pools)


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


def _spread_kinds(n: int, kinds: int, prefix: str, label: str, tag: str, keys: tuple, side=None):
    side = side or PORT
    pods = []
    per = max(n // kinds, 1)
    for i in range(n):
        k = min(i // per, kinds - 1)
        p = side.make_pod(f"{prefix}-{i}", cpu=2.0, memory="1Gi")
        p.metadata.labels = {"grp": str(k), label: f"{tag}{k}"}
        p.spec.topology_spread_constraints = [
            side.TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={label: f"{tag}{k}"})
            for key in keys
        ]
        pods.append(p)
    return pods


def zonal_pods(n: int, kinds: int = 4, prefix: str = "zb", side=None):
    """Kinds with a zone-spread constraint each, disjoint selectors (the
    kind-scan route)."""
    return _spread_kinds(n, kinds, prefix, "spread", "z", ((side or PORT).l.LABEL_TOPOLOGY_ZONE,), side)


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


def wide_zone_pods(n: int, extra_zones: int = 13):
    """Zone-spread kinds beside pods that exclude `extra_zones` more zone
    names: the zone key holds 4 + extra_zones values (17 by default), wider
    than KSCAN_D, so the spread kinds route to the per-pod scan; past 32
    values a key's value bits take two words in the per-pod kernel."""
    extra = [f"extra-zone-{i}" for i in range(extra_zones)]
    away = [make_pod(f"away-{i}", cpu=0.5, memory="512Mi") for i in range(2)]
    for p in away:
        p.spec.node_affinity = NodeAffinity(required=[NodeSelectorTerm(
            match_expressions=[{"key": l.LABEL_TOPOLOGY_ZONE, "operator": "NotIn", "values": extra}])])
    return zonal_pods(n, kinds=2) + away


def many_resources_pods(n: int = 24, extra: int = 36):
    """Per-pod kinds whose pods name `extra` extended resources (R past a
    warp's 32 lanes with the default), at zero but for two pods that ask
    for one no instance type offers."""
    pods = perpod_pods(n, kinds=2)
    for i, p in enumerate(pods):
        p.spec.requests.update({f"example.com/r{r}": 0.0 for r in range(extra)})
        if i < 2:
            p.spec.requests[f"example.com/r{extra - 1}"] = 1.0
    return pods


# ---------------------------------------------------------------------------
# consolidation fixture
# ---------------------------------------------------------------------------

PORT = types.SimpleNamespace(
    make_pod=make_pod, l=l, res=res, Operator=Operator, Requirement=Requirement, Requirements=Requirements,
    ExistingSimNode=ExistingSimNode, Topology=Topology, build_universe_domains=build_universe_domains,
    template_universe_domains=template_universe_domains, fake=fake, NodePool=NodePool,
    build_templates=build_templates, HostPort=HostPort, VolumeUsage=VolumeUsage,
    make_gang_pods=make_gang_pods, TopologySpreadConstraint=TopologySpreadConstraint,
    PodAffinityTerm=PodAffinityTerm,
)


# ---------------------------------------------------------------------------
# dp speculation workloads (the JAX package's tests/test_shard.py builders
# and bench.py's shard stage helpers)
# ---------------------------------------------------------------------------


def existing_sim_nodes(n: int = 2, cpu_avail: float = 4.0, side=PORT) -> list:
    """Part-full on-demand nodes exist-<i> in test-zone-1 (bench.py's
    existing_sim_nodes): dp rows racing to debit them exercise the
    existing-node debit bit."""
    L, R = side.l, side.res
    nodes = []
    for i in range(n):
        name = f"exist-{i}"
        labels = {
            L.LABEL_TOPOLOGY_ZONE: "test-zone-1", L.LABEL_INSTANCE_TYPE: "s-4x-amd64",
            L.CAPACITY_TYPE_LABEL_KEY: L.CAPACITY_TYPE_ON_DEMAND, L.LABEL_ARCH: L.ARCH_AMD64, L.LABEL_OS: "linux",
            L.LABEL_HOSTNAME: name, L.NODEPOOL_LABEL_KEY: "default",
        }
        nodes.append(side.ExistingSimNode(
            name=name, index=i, requirements=side.Requirements.from_labels(labels),
            available={R.CPU: cpu_avail, R.MEMORY: float(8 * 2**30), R.PODS: 50.0},
        ))
    return nodes


def mv_templates(n_types: int, mv: int = 2, side=PORT):
    """One default pool over instance_types(n_types) whose requirements
    carry an instance-type minValues floor (bench.py's mv_templates)."""
    pool = side.NodePool()
    pool.metadata.name = "default"
    pool.spec.template.spec.requirements = [
        {"key": side.l.LABEL_INSTANCE_TYPE, "operator": "Exists", "minValues": mv}
    ]
    return side.build_templates([(pool, side.fake.instance_types(n_types))])


def sized_kind_pods(n: int = 256, kinds: int = 8, prefix: str = "m", mixed: bool = True, side=PORT) -> list:
    """Kinds of n // kinds pods each. mixed: distinct sizes, so later
    (smaller) kinds still fit earlier kinds' part-full claims and dp rows
    replay; else 2 cpu / 1Gi pods labelled grp=<kind>, whose claims fill to
    capacity, so dp rows graft (tests/test_shard.py mixed_kind_pods /
    saturating_kind_pods)."""
    per = n // kinds
    pods = []
    for i in range(n):
        k = i // per
        if mixed:
            pods.append(side.make_pod(f"{prefix}-{i}", cpu=[0.25, 0.5, 1.0][k % 3], memory=f"{[0.5, 1.0][k % 2]}Gi"))
            continue
        p = side.make_pod(f"{prefix}-{i}", cpu=2.0, memory="1Gi")
        p.metadata.labels = {"grp": str(k)}
        pods.append(p)
    return pods


def spread_kind_pods(n: int, kinds: int, prefix: str, keys: tuple, label: str = "spread", shared: bool = False,
                     mixed: bool = False, side=PORT) -> list:
    """Kinds spread over `keys` (topology keys) by their own selector, or
    one selector shared by every kind; 2 cpu / 1Gi pods, or mixed sizes
    (tests/test_shard.py zonal_kind_pods, hostname_spread_pods,
    perpod_kind_pods)."""
    per = n // kinds
    pods = []
    for i in range(n):
        k = i // per
        sel = prefix if shared else f"{prefix}{k}"
        if mixed:
            p = side.make_pod(f"{prefix}-{i}", cpu=[0.25, 0.5, 1.0][k % 3], memory=f"{[0.5, 1.0][k % 2]}Gi")
        else:
            p = side.make_pod(f"{prefix}-{i}", cpu=2.0, memory="1Gi")
        p.metadata.labels = {"grp": str(k), label: sel}
        p.spec.topology_spread_constraints = [
            side.TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={label: sel}) for key in keys
        ]
        pods.append(p)
    return pods


# the dp merge counters both packages keep (the reference's
# last_timings["shard"], the port's last_stats["shard"])
SHARD_KEYS = ("merge_rounds", "groups_committed", "groups_replayed", "verdict_fetches", "verdict_bytes",
              "dp_rows_total", "dp_rows_committed", "dp_rows_replayed", "dp_rows_idle")


def shard_counters(stats: dict) -> dict:
    """A shard record cut to the counters both packages keep: the merge
    counters, per family (committed, replayed) and per family routing
    coverage (dp, sequential)."""
    from karpenter_tpu_torch.controllers.provisioning.scheduler import SHARD_FAMILIES

    out = {k: stats[k] for k in SHARD_KEYS}
    out["families"] = {f: [stats["families"][f]["committed"], stats["families"][f]["replayed"]]
                       for f in SHARD_FAMILIES}
    out["coverage"] = {f: [c["dp"], c["sequential"]] for f, c in stats["coverage"].items()}
    return out


def anti_affinity_pods(n: int = 96, per: int = 24, prefix: str = "ta", side=PORT) -> list:
    """Self-anti-affinity kinds on the hostname key, n // per of them
    (tests/test_shard.py test_shared_hg_selector_conflict_replays)."""
    pods = []
    for i in range(n):
        p = side.make_pod(f"{prefix}-{i}", cpu=0.5, memory="0.5Gi")
        p.metadata.labels = {"app": f"db{i // per}"}
        p.spec.pod_anti_affinity = [
            side.PodAffinityTerm(topology_key=side.l.LABEL_HOSTNAME, label_selector={"app": f"db{i // per}"})
        ]
        pods.append(p)
    return pods


@dataclass
class BoundCluster:
    """Launched nodes and the pods bound to them."""

    nodes: list  # ExistingSimNode per node, in launch order
    labels: dict  # node name -> node labels
    bound: dict  # node name -> its bound pods
    price: dict  # node name -> $/h of its offering
    templates: list


@dataclass
class Candidate:
    """A node consolidation may remove, with the pods it would displace."""

    name: str
    reschedulable_pods: list


def pending_pods(n: int, seed: int = 1, side=PORT, prefix: str = "pending"):
    """selector_pods' shape from another seed, named <prefix>-<i> (seed 0
    and prefix "p" give selector_pods itself)."""
    L = side.l
    rng = np.random.default_rng(seed)
    zones = ("test-zone-1", "test-zone-2", "test-zone-3", "test-zone-4")
    pods = []
    for i in range(n):
        sel = {}
        if i % 5 == 1:
            sel[L.LABEL_TOPOLOGY_ZONE] = zones[i % len(zones)]
        if i % 5 == 2:
            sel[L.LABEL_ARCH] = L.ARCH_AMD64
        if i % 5 == 3:
            sel[L.CAPACITY_TYPE_LABEL_KEY] = L.CAPACITY_TYPE_ON_DEMAND
        pods.append(side.make_pod(
            f"{prefix}-{i}", cpu=float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.0, 4.0])),
            memory=f"{rng.choice([0.25, 0.5, 1.0, 2.0, 4.0])}Gi", node_selector=sel,
        ))
    return pods


def launch_claims(result, templates, side=PORT) -> BoundCluster:
    """Launch every claim of a SchedulingResult as a node (what a cloud
    provider does): its cheapest viable instance type (ties by name), that
    type's cheapest offering compatible with the claim's requirements
    (ties by zone, then capacity type), labels for hostname, zone, capacity
    type, instance type and arch, and available = allocatable - the
    template's daemon overhead - the claim's pods, which become the node's
    bound pods. Nodes are named node-<i> in claim order."""
    L, R = side.l, side.res
    nodes, labels, bound, price = [], {}, {}, {}
    for i, c in enumerate(result.claims):
        it = min(c.instance_types, key=lambda t: (t.cheapest_offering_price(c.requirements), t.name))
        # a claim pinned to its reservations launches into one of them
        pinned = c.requirements.has(L.RESERVATION_ID_LABEL_KEY)
        offers = [
            o for o in it.offerings
            if o.available and (pinned or o.capacity_type != L.CAPACITY_TYPE_RESERVED)
            and c.requirements.is_compatible(o.requirements, L.WELL_KNOWN_LABELS)
        ]
        o = min(offers, key=lambda o: (o.price, o.zone, o.capacity_type))
        name = f"node-{i:04d}"
        lab = {
            L.LABEL_HOSTNAME: name, L.LABEL_TOPOLOGY_ZONE: o.zone, L.CAPACITY_TYPE_LABEL_KEY: o.capacity_type,
            L.LABEL_INSTANCE_TYPE: it.name, L.LABEL_ARCH: it.requirements.get(L.LABEL_ARCH).any_value(),
        }
        if o.capacity_type == L.CAPACITY_TYPE_RESERVED:
            lab[L.RESERVATION_ID_LABEL_KEY] = o.reservation_id
        reqs = side.Requirements()
        for k, v in lab.items():
            reqs.add(side.Requirement.new(k, side.Operator.IN, v))
        avail = R.subtract(R.subtract(it.allocatable(), c.template.daemon_requests),
                           R.merge(*(p.total_requests() for p in c.pods)))
        nodes.append(side.ExistingSimNode(name=name, index=i, requirements=reqs, available=avail))
        labels[name] = lab
        bound[name] = list(c.pods)
        price[name] = o.price
    return BoundCluster(nodes=nodes, labels=labels, bound=bound, price=price, templates=templates)


def bound_cluster(pods, templates, max_claims=None, device="cuda") -> BoundCluster:
    """Provision `pods` with a TorchScheduler solve and launch its claims."""
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    result = TorchScheduler(templates, max_claims=max_claims, device=device).solve(pods)
    if result.unschedulable:
        raise ValueError(f"bound_cluster: {len(result.unschedulable)} pods unschedulable")
    return launch_claims(result, templates)


def candidates(cluster: BoundCluster) -> list:
    """Every node as a consolidation candidate, cheapest first, ties by name."""
    names = sorted(cluster.bound, key=lambda n: (cluster.price[n], n))
    return [Candidate(n, list(cluster.bound[n])) for n in names]


def scenarios_of(sets: list, pending: list) -> tuple[list, list]:
    """(union pods, [(excluded, active uids, counted uids)]) as the
    reference's Provisioner.simulate_batch builds them: active = pending
    and displaced, counted = displaced; the union is the pending pods, then
    each displaced pod once, in scenario order."""
    union: dict = {}
    specs = []
    pending_uids = {p.uid for p in pending}
    for cands in sets:
        displaced = [p for c in cands for p in c.reschedulable_pods]
        for p in displaced:
            union.setdefault(p.uid, p)
        counted = {p.uid for p in displaced}
        specs.append(({c.name for c in cands}, pending_uids | counted, counted))
    return list(pending) + list(union.values()), specs


def prefix_scenarios(cands: list, n: int, pending: list) -> tuple[list, list]:
    """Multi-node consolidation's batch: the prefixes 1..n of `cands`."""
    return scenarios_of([cands[:k] for k in range(1, n + 1)], pending)


def single_scenarios(cands: list, n: int, pending: list) -> tuple[list, list]:
    """Single-node consolidation's batch: each of the first n candidates alone."""
    return scenarios_of([[c] for c in cands[:n]], pending)


def topology_factory(cluster: BoundCluster, side=PORT):
    """factory(pods, excluded): the scenario's topology, seeded from the
    pods bound to every node not excluded, over the universe of the
    templates and those nodes (the reference's Provisioner._build_topology)."""
    base = side.template_universe_domains(cluster.templates)

    def factory(pods, excluded):
        survivors = [n for n in cluster.nodes if n.name not in excluded]
        bound = [(p, cluster.labels[n.name]) for n in survivors for p in cluster.bound[n.name]]
        return side.Topology.build(
            list(pods),
            lambda: side.build_universe_domains(cluster.templates, survivors, template_base=base),
            bound,
        )

    return factory


# a spread count past 2^15: the rank key (count + self)·2^16 + rank wraps
BIG_COUNT = 2**15 + 5


def seed_big_counts(topo, side=PORT):
    """topo with every zone-spread domain's count raised by BIG_COUNT + 0..2
    (past 2^15, where the topology rank key wraps in int32). Returns topo."""
    for g in topo.groups:
        if g.key == side.l.LABEL_TOPOLOGY_ZONE:
            for i, d in enumerate(sorted(g.domains)):
                g.domains[d] += BIG_COUNT + i % 3
    return topo


def sequential_signal(sched, cluster: BoundCluster, factory, pending: list, cands: list) -> tuple[bool, int]:
    """One scenario simulated alone, as a consolidation confirm does: the
    pending and displaced pods solved against the surviving nodes with the
    scenario's topology; (no displaced pod unscheduled, claims opened)."""
    excluded = {c.name for c in cands}
    displaced = [p for c in cands for p in c.reschedulable_pods]
    pods = list(pending) + displaced
    survivors = [n.clone() for n in cluster.nodes if n.name not in excluded]
    result = sched.solve(pods, survivors, None, topology=factory(pods, excluded))
    failed = {p.uid for p, _reason in result.unschedulable} & {p.uid for p in displaced}
    return not failed, len(result.claims)


def cluster_digest(cluster: BoundCluster) -> str:
    """sha256 of the launched nodes: names, labels, available resources and
    bound pod names."""
    h = hashlib.sha256()
    for n in cluster.nodes:
        h.update(repr((n.name, sorted(cluster.labels[n.name].items()), sorted(n.available.items()),
                       sorted(p.name for p in cluster.bound[n.name]))).encode())
    return h.hexdigest()


def signals_digest(signals) -> str:
    """sha256 of a what-if batch's [(feasible, n_new_claims)] list."""
    return hashlib.sha256(repr([(bool(f), int(n)) for f, n in signals]).encode()).hexdigest()


def placements_digest(assignment, vg_counts, hg_counts, vg_key, vocab) -> str:
    """sha256 of what a what-if batch's placements decide: each scenario's
    [L] assignment (a surviving node's index, E + a new claim's slot, or
    < 0), its final hostname group counts by slot and its final vocab-key
    group counts by domain name. int32 arrays [S, L], [S, NGh, Sl] and
    [S, NGv, V] of the real scenarios; `vg_key` [NGv] and the encoder's
    `vocab` name each count's key and value (value ids follow the order in
    which a process met the values, so the digest uses the names)."""
    h = hashlib.sha256()
    for a in (assignment, hg_counts):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    keys = [int(k) for k in np.asarray(vg_key)]
    for scen in np.asarray(vg_counts):
        for k, row in zip(keys, scen):
            names = vocab.values[k]
            h.update(repr((vocab.keys[k], sorted(
                (names[v] if v < len(names) else f"#{v}", int(c)) for v, c in enumerate(row) if c
            ))).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Karpenter's constraints: reservations, minValues, host ports, CSI limits
# ---------------------------------------------------------------------------

# the constrained cells' reservations: catalog index -> (zone, reservation
# id, capacity), on 4 of the 16- and 32-cpu amd64 types (the sizes claims
# of mixed_pods grow to) in the 2 zones where its first claims land
RESERVATIONS = {
    32: ("test-zone-3", "res-c16x", 8),
    34: ("test-zone-4", "res-s16x", 8),
    40: ("test-zone-3", "res-c32x", 16),
    42: ("test-zone-4", "res-s32x", 32),
}
FAMILY_KEY = "karpenter-tpu.sh/instance-family"
# the pool's minValues floors (spot diversity over names and families)
MIN_VALUES = (("node.kubernetes.io/instance-type", 2), (FAMILY_KEY, 2))
INGRESS_PORT = 443
CSI_DRIVER = "ebs.csi.aws.com"
CSI_LIMIT = 4


def reserved_catalog(n: int, reservations: dict = RESERVATIONS, side=PORT) -> list:
    """instance_types(n) with reserved offerings added to the types at the
    indices of `reservations` (capacity-type reserved, price 0)."""
    f = side.fake
    combos = [(fam, cpu, arch) for cpu in f.CPU_SIZES for fam in f.FAMILIES for arch in f.ARCHS]
    out = []
    for i in range(n):
        fam, cpu, arch = combos[i % len(combos)]
        gen = i // len(combos)
        name = f"{fam}-{cpu}x-{arch}" + (f"-gen{gen}" if gen else "")
        zone_rid_cap = reservations.get(i)
        out.append(f.new_instance_type(
            name, family=fam, cpu=cpu, arch=arch, price_multiplier=1.0 + 0.07 * gen,
            reservations=[zone_rid_cap] if zone_rid_cap else None,
        ))
    return out


def constrained_templates(n_types: int, min_values=MIN_VALUES, reservations: dict = RESERVATIONS, side=PORT):
    """Pool "default" over reserved_catalog(n_types) whose requirements
    carry `min_values` as Exists requirements with minValues floors."""
    pool = side.NodePool()
    pool.metadata.name = "default"
    pool.spec.template.spec.requirements = [
        {"key": k, "operator": "Exists", "minValues": v} for k, v in min_values
    ]
    return side.build_templates([(pool, reserved_catalog(n_types, reservations, side))])


def hostport_pods(n: int = 64, port: int = INGRESS_PORT, side=PORT) -> list:
    """An ingress deployment: n pods that each bind host port `port`, so a
    node takes one of them."""
    pods = []
    for i in range(n):
        p = side.make_pod(f"ingress-{i}", cpu=0.5, memory="512Mi")
        p.metadata.labels = {"app": "ingress"}
        p.spec.host_ports = [side.HostPort(port=port)]
        pods.append(p)
    return pods


def attach_volumes(cluster: BoundCluster, pending: list, every_bound: int = 4, every_pending: int = 8,
                   driver: str = CSI_DRIVER, limit: int = CSI_LIMIT, side=PORT) -> dict:
    """CSI attach limits on a launched cluster: every node publishes
    `limit` attachments for `driver`, and every `every_bound`-th bound pod
    (in node order) and every `every_pending`-th pending pod mounts a PVC
    of its own. The nodes' volume usage holds their bound pods' PVCs;
    returns pod uid -> {driver: {pvc}} for every pod with one."""
    vols = {}
    k = 0
    for n in cluster.nodes:
        vu = side.VolumeUsage()
        vu.add_limit(driver, limit)
        for p in cluster.bound[n.name]:
            if k % every_bound == 0:
                v = {driver: {f"pvc-{p.name}"}}
                vu.add(p.uid, v)
                vols[p.uid] = v
            k += 1
        n.volume_usage = vu
    for i, p in enumerate(pending):
        if i % every_pending == 0:
            vols[p.uid] = {driver: {f"pvc-{p.name}"}}
    return vols


def reserved_in_use(cluster: BoundCluster, side=PORT) -> dict:
    """Reservation id -> nodes of the cluster launched into it."""
    out: dict = {}
    for lab in cluster.labels.values():
        rid = lab.get(side.l.RESERVATION_ID_LABEL_KEY)
        if rid is not None:
            out[rid] = out.get(rid, 0) + 1
    return out


def result_digest(result) -> str:
    """sha256 of what a constrained solve decides: per claim its slot,
    hostname, pods, viable types, usage, requirements (reserved pins and
    relaxed floors included), reserved ids, minValues relaxation and host
    ports; the unschedulable pods with their reasons."""
    h = hashlib.sha256()
    for c in result.claims:
        h.update(repr((c.slot, c.hostname, [p.name for p in c.pods], [i.name for i in c.instance_types],
                       sorted(c.used.items()), str(c.requirements), sorted(c.reserved_ids), c.min_values_relaxed,
                       sorted(c.host_ports))).encode())
    for p, reason in result.unschedulable:
        h.update(repr((p.name, reason)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# gangs: all-or-nothing multi-host slices
# ---------------------------------------------------------------------------

# the gang_zonal_budget cell's pool cpu limit: 75% of the cpu its problem
# launches with no limit (the sum of each claim's launched type's cpu,
# 9744 with TPUScheduler: python tests/test_torch_gang.py)
GANG_ZONAL_CPU_LIMIT = 7308.0


def gang_storm_pods(n_gangs: int, size: int, singles: int, side=PORT) -> list:
    """A training-job burst (the JAX package's bench.py gang-storm stage):
    n_gangs gangs of `size` members at 1.5 cpu, the whale gang of 4
    members at 10000 cpu that no instance type can host (it must spill,
    atomically), and `singles` selector pods."""
    pods = []
    for gi in range(n_gangs):
        pods.extend(side.make_gang_pods(f"storm-{gi}", size, cpu=1.5))
    pods.extend(side.make_gang_pods("whale", 4, cpu=10000.0))
    return pods + pending_pods(singles, seed=0, side=side, prefix="p")


def spread_gang(name: str, size: int, cpu: float, key: str, sel: str, side=PORT) -> list:
    """A gang whose members carry one topology spread over `key` (max skew
    1) with the shared selector spread=<sel>."""
    pods = side.make_gang_pods(name, size, cpu=cpu)
    for p in pods:
        p.metadata.labels = dict(p.metadata.labels or {}, spread=sel)
        p.spec.topology_spread_constraints = [
            side.TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={"spread": sel})
        ]
    return pods


def gang_zonal_pods(zonal_gangs: int = 32, zonal_size: int = 16, host_gangs: int = 8, host_size: int = 8,
                    singles: int = 4096, kinds: int = 8, side=PORT) -> list:
    """Zone-spread training jobs beside zonal services: `zonal_gangs`
    gangs of `zonal_size` at 1.0 cpu, each spread over zones with its own
    selector; `host_gangs` gangs of `host_size` at 2.0 cpu spread over
    hostnames; zonal_pods(singles, kinds)."""
    L = side.l
    pods = []
    for i in range(zonal_gangs):
        pods += spread_gang(f"zg-{i}", zonal_size, 1.0, L.LABEL_TOPOLOGY_ZONE, f"zg{i}", side)
    for i in range(host_gangs):
        pods += spread_gang(f"hg-{i}", host_size, 2.0, L.LABEL_HOSTNAME, f"hg{i}", side)
    return pods + zonal_pods(singles, kinds=kinds, side=side)


def launched_cpu(result) -> float:
    """The cpu a result launches: each claim's cheapest type's capacity."""
    return sum(c.cheapest_launch()[0].capacity.get("cpu", 0.0) for c in result.claims)


def slice_digest(result) -> str:
    """sha256 of the slice hosts: per gang claim its slot, gang key and
    pods in order."""
    h = hashlib.sha256()
    for c in result.claims:
        if c.gang:
            h.update(repr((c.slot, c.gang, [p.name for p in c.pods])).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# resident sessions: traces of delta rounds
# ---------------------------------------------------------------------------

# steady_16384x64: the JAX package's bench.py run_steady_stage at its
# defaults (64 kinds x 256 pods of 1 cpu / 1Gi over make_templates(100),
# max_claims=8192; Poisson(64) fresh-kind batches, the newest batch
# departing first with p = 0.35; 12 rounds, seed 0) after its warm-up
# rounds; resident_retract_16380x63: 65 kinds x 252 pods, each round a
# fresh kind of 63 x max(1, Poisson(1)) pods (whole claims of the
# 63-pod type the base fills), the same departures, 16 rounds and then 3
# pops of the newest batch
STEADY = dict(kinds=64, kind_size=256, delta_pods=64, rounds=12, depart_p=0.35, seed=0)
RETRACT = dict(kinds=65, kind_size=252, batch=63, rounds=16, pops=3, depart_p=0.35, seed=0)
RESIDENT_TYPES = 100
RESIDENT_MAX_CLAIMS = 8192


def kind_batch(name: str, n: int, cpu: float = 1.0, side=PORT) -> list:
    """n identical pods of one deployment (label app=<name>), each with its
    name as its uid, so that a session's fingerprint does not depend on
    how many objects the process made before."""
    out = []
    for i in range(n):
        p = side.make_pod(f"{name}-{i}", cpu=cpu, memory="1Gi")
        p.metadata.labels = {"app": name}
        p.metadata.uid = p.metadata.name
        out.append(p)
    return out


def steady_trace(kinds: int = 64, kind_size: int = 256, delta_pods: int = 64, rounds: int = 12,
                 depart_p: float = 0.35, seed: int = 0, side=PORT) -> list:
    """[(label, union pods)] of the steady stage: the cold base, its
    warm-up rounds (a repeat, one batch in, that batch out), then the
    trace rounds, each a LIFO departure with p = depart_p and a fresh-kind
    batch of max(1, Poisson(delta_pods)) pods."""
    rng = np.random.default_rng(seed)
    base = [p for k in range(kinds) for p in kind_batch(f"base-{k}", kind_size, side=side)]
    warm = kind_batch("warmup", delta_pods, side=side)
    out = [("cold", base), ("repeat", base), ("warm+", base + warm), ("warm-", base)]
    live: list = []
    for rnd in range(rounds):
        if live and rng.random() < depart_p:
            live.pop()
        n_new = max(int(rng.poisson(delta_pods)), 1)
        live.append(kind_batch(f"delta-{rnd}", n_new, side=side))
        out.append((f"round {rnd}", base + [p for b in live for p in b]))
    return out


def retract_trace(kinds: int = 65, kind_size: int = 252, batch: int = 63, rounds: int = 16, pops: int = 3,
                  depart_p: float = 0.35, seed: int = 0, side=PORT) -> list:
    """[(label, union pods)] of the retract cell: the cold base, rounds of
    a LIFO departure with p = depart_p and a fresh kind of batch x
    max(1, Poisson(1)) pods, then `pops` rounds that only depart the
    newest batch."""
    rng = np.random.default_rng(seed)
    base = [p for k in range(kinds) for p in kind_batch(f"base-{k}", kind_size, side=side)]
    out = [("cold", base)]
    live: list = []
    for rnd in range(rounds):
        if live and rng.random() < depart_p:
            live.pop()
        n_new = batch * max(1, int(rng.poisson(1)))
        live.append(kind_batch(f"delta-{rnd}", n_new, side=side))
        out.append((f"round {rnd}", base + [p for b in live for p in b]))
    for i in range(pops):
        live.pop()
        out.append((f"pop {i}", base + [p for b in live for p in b]))
    return out


def claims_digest(result) -> str:
    """sha256 of a result's claims (slot, pods, viable types, usage,
    requirements) and unschedulable pods (chip_smoke.py's digest)."""
    h = hashlib.sha256()
    for c in result.claims:
        h.update(repr((c.slot, [p.name for p in c.pods], [i.name for i in c.instance_types],
                       sorted(c.used.items()), str(c.requirements))).encode())
    for p, reason in result.unschedulable:
        h.update(repr((p.name, reason)).encode())
    return h.hexdigest()
