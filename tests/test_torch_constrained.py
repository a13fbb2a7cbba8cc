"""Karpenter's constraints in the port against the JAX package: host ports
(the fill, kind-scan and per-pod routes, wildcard IPs, a kind that
conflicts with itself), CSI attach limits on existing nodes (the marker
column, unlimited drivers), a PVC's single zone alternative, finite cpu
and nodes budgets, minValues (Strict on the name key and on another key,
unsatisfiable, BestEffort relaxed at decode) and reservations (fallback,
strict, exhausted, reserved_in_use, the feature off). Each problem runs
through TorchScheduler(device="cpu").solve against TPUScheduler.solve —
claims, per-pod placement, per-claim requirements (the reserved pins
included), viable types, usage, reserved ids, minValues relaxation, host
ports, price — and through whatif_batch against the reference's signals;
the plain minValues and reservation reductions against the reference's
einsums on seeded inputs. Tolerance: exact equality everywhere.

    python tests/test_torch_constrained.py   # the chip cells' goldens (JAX, CPU)

prints the JAX package's goldens for chip_smoke.py's constrained cells."""

import json
import os
import sys
import time
import types

if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
from karpenter_tpu.cloudprovider import fake as j_fake  # noqa: E402
from karpenter_tpu.controllers.provisioning import TPUScheduler  # noqa: E402
from karpenter_tpu.controllers.provisioning import build_templates as j_build_templates  # noqa: E402
from karpenter_tpu.controllers.provisioning import topology as j_topology  # noqa: E402
from karpenter_tpu.controllers.provisioning.host_scheduler import ExistingSimNode as JNode  # noqa: E402
from karpenter_tpu.models import labels as jl  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.models.nodepool import NodePool as JNodePool  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu.scheduling import Operator as JOp  # noqa: E402
from karpenter_tpu.scheduling import Requirement as JReq  # noqa: E402
from karpenter_tpu.scheduling import Requirements as JReqs  # noqa: E402
from karpenter_tpu.scheduling.volumes import VolumeUsage as JVolumeUsage  # noqa: E402
from karpenter_tpu.utils import resources as j_res  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JAX = types.SimpleNamespace(
    make_pod=j_pod.make_pod, l=jl, res=j_res, Operator=JOp, Requirement=JReq, Requirements=JReqs,
    ExistingSimNode=JNode, Topology=j_topology.Topology, build_universe_domains=j_topology.build_universe_domains,
    template_universe_domains=j_topology.template_universe_domains, fake=j_fake, NodePool=JNodePool,
    build_templates=j_build_templates, HostPort=j_pod.HostPort, VolumeUsage=JVolumeUsage,
    TSC=j_pod.TopologySpreadConstraint, make_templates=bench.make_templates, mixed_pods=bench.mixed_pods,
    zonal_pods=bench.zonal_pods, perpod_pods=bench.perpod_pods, sched=TPUScheduler, kw={},
)
PORT = types.SimpleNamespace(
    **vars(T.PORT), TSC=T.TopologySpreadConstraint, make_templates=T.make_templates, mixed_pods=T.mixed_pods,
    zonal_pods=T.zonal_pods, perpod_pods=T.perpod_pods, sched=TorchScheduler, kw={"device": "cpu"},
)
SIDES = (JAX, PORT)

# the chip cells (chip_smoke.py): constrained_4096x400, hostports_2048x400
# and whatif_constrained_prefix100; the cpu limit is about 75% of the cpu
# the constrained problem launches without one (5533 cpu, TPUScheduler)
CHIP_PODS, CHIP_TYPES, CHIP_INGRESS, CHIP_MAX_CLAIMS = 4096, 400, 64, 4096
CHIP_CPU_LIMIT = 4150.0
CHIP_HOSTPORT_PODS = 2048
CHIP_PENDING, CHIP_CANDS = 64, 100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# what a caller reads
# ---------------------------------------------------------------------------


def view(result) -> dict:
    """Everything a caller reads of a SchedulingResult, keyed by pod NAME
    (uids differ between the two packages' object counters): claims with
    their pods, viable types, usage, requirements (the reserved pins and
    relaxed floors included), reserved ids, minValues relaxation and host
    ports; existing nodes' pods, usage, requirements, host ports and
    attachments; the unschedulable pods; node count and price."""
    name_of = {}
    for c in result.claims:
        for p in c.pods:
            name_of[p.uid] = p.name
    for p, _r in result.unschedulable:
        name_of[p.uid] = p.name
    for n in result.existing:
        for p in n.pods:
            name_of[p.uid] = p.name
    return dict(
        claims=[
            (c.slot, c.hostname, [p.name for p in c.pods], [i.name for i in c.instance_types],
             sorted(c.used.items()), c.template.nodepool_name, str(c.requirements), sorted(c.reserved_ids),
             c.min_values_relaxed, sorted(c.host_ports))
            for c in result.claims
        ],
        assignments=sorted((name_of[u], s) for u, s in result.assignments.items()),
        existing=sorted((name_of[u], n) for u, n in result.existing_assignments.items()),
        existing_nodes=[
            (sorted(n.used.items()), str(n.requirements), sorted(n.host_ports), [p.name for p in n.pods],
             None if n.volume_usage is None else sorted((name_of.get(u, u), sorted((d, sorted(v)) for d, v in
                                                                                    vols.items()))
                                                        for u, vols in n.volume_usage.pod_volumes.items()))
            for n in result.existing
        ],
        unschedulable=[(p.name, r) for p, r in result.unschedulable],
        node_count=result.node_count,
        total_price=result.total_price(),
    )


def _both(build, sched_kw=None, max_claims=64, **solve_kw):
    """build(S) -> (templates, pods, existing nodes, per-side solve kwargs)
    on both sides; the two views, which must be equal."""
    out = []
    for S in SIDES:
        templates, pods, nodes, kw = build(S)
        s = S.sched(templates, max_claims=max_claims, **S.kw, **(sched_kw or {}))
        r = s.solve(pods, existing_nodes=[n.clone() for n in nodes], **kw, **solve_kw)
        out.append((view(r), r, s))
    (vj, _rj, _sj), (vp, rp, sp) = out
    for k in vj:
        assert vj[k] == vp[k], k
    return rp, sp


# ---------------------------------------------------------------------------
# problem builders (both sides)
# ---------------------------------------------------------------------------


def _pods(S, n, cpu=0.5, mem="512Mi", prefix="p", **kw):
    return [S.make_pod(f"{prefix}-{i}", cpu=cpu, memory=mem, **kw) for i in range(n)]


def _node(S, name="node-a", zone="test-zone-1", cpu=4.0, ports=(), limits=None, vols=None):
    reqs = S.Requirements()
    reqs.add(S.Requirement.new(S.l.LABEL_HOSTNAME, S.Operator.IN, name))
    reqs.add(S.Requirement.new(S.l.LABEL_TOPOLOGY_ZONE, S.Operator.IN, zone))
    reqs.add(S.Requirement.new(S.l.CAPACITY_TYPE_LABEL_KEY, S.Operator.IN, S.l.CAPACITY_TYPE_ON_DEMAND))
    n = S.ExistingSimNode(name=name, index=0, requirements=reqs,
                          available={"cpu": cpu, "memory": float(2 * cpu * 2**30), "pods": 110.0},
                          host_ports=list(ports))
    if limits is not None:
        vu = S.VolumeUsage()
        for d, c in limits.items():
            vu.add_limit(d, c)
        for uid, v in (vols or {}).items():
            vu.add(uid, v)
        n.volume_usage = vu
    return n


def _with_port(pods, S, port, ip=""):
    for p in pods:
        p.spec.host_ports = [S.HostPort(port=port, host_ip=ip)]
    return pods


def _ports_fill(S):
    """Selector pods with host ports: a kind on 8080 (wildcard), a kind on
    80 at 10.0.0.1 and one on 80 at 10.0.0.2 (no conflict between them), a
    wildcard kind on 80 (conflicts with both), a node already on 8080."""
    pods = (_with_port(_pods(S, 5, prefix="w8080"), S, 8080)
            + _with_port(_pods(S, 3, prefix="ip1"), S, 80, "10.0.0.1")
            + _with_port(_pods(S, 3, prefix="ip2"), S, 80, "10.0.0.2")
            + _with_port(_pods(S, 2, 0.25, prefix="w80"), S, 80)
            + _pods(S, 10, 0.25, prefix="plain"))
    nodes = [_node(S, ports=[("0.0.0.0", 8080, "TCP")]), _node(S, "node-b", ports=[("10.0.0.1", 80, "TCP")])]
    return S.make_templates(16), pods, nodes, {}


def _ports_kscan(S):
    """Zone-spread kinds whose pods bind one host port (each kind conflicts
    with itself: one pod a node) beside port-free pods."""
    return S.make_templates(40), _with_port(S.zonal_pods(24, kinds=2), S, 9000) + _pods(S, 6), [_node(S)], {}


def _ports_perpod(S):
    """Two-key spread kinds (the per-pod route) with host ports."""
    return S.make_templates(40), _with_port(S.perpod_pods(16, kinds=2), S, 7000), [_node(S)], {}


CSI = "ebs.csi.aws.com"


def _csi_existing(S):
    """Nodes with attach limits: node-a limits ebs to 2 and holds one PVC,
    node-b limits ebs to 1 and is already over it; pods mount ebs PVCs
    (two share one), an unlimited driver's PVC (the marker column), or
    nothing."""
    pods = _pods(S, 8, 0.25, prefix="v")
    vols = {}
    for i, p in enumerate(pods):
        if i < 5:
            vols[p.uid] = {CSI: {f"pvc-{min(i, 3)}"}}
        elif i < 7:
            vols[p.uid] = {"efs.csi.aws.com": {f"efs-{i}"}}
    nodes = [
        _node(S, "node-a", limits={CSI: 2}, vols={"bound-0": {CSI: {"pvc-bound"}}}),
        _node(S, "node-b", zone="test-zone-2", limits={CSI: 1},
              vols={"bound-1": {CSI: {"pvc-x"}}, "bound-2": {CSI: {"pvc-y"}}}),
    ]
    return S.make_templates(8), pods, nodes, {"pod_volumes": vols}


def _volume_zone(S):
    """A PVC's single zone alternative on half the pods (zone-spread and
    plain kinds): the restriction folds into the node side."""
    pods = S.zonal_pods(12, kinds=2) + _pods(S, 6)
    alt = S.Requirements()
    alt.add(S.Requirement.new(S.l.LABEL_TOPOLOGY_ZONE, S.Operator.IN, "test-zone-2", "test-zone-3"))
    vreqs = {p.uid: [alt] for i, p in enumerate(pods) if i % 2 == 0}
    return S.make_templates(40), pods, [_node(S)], {"volume_reqs": vreqs}


def _budget(limits):
    def build(S):
        return S.make_templates(16), S.mixed_pods(40) + _pods(S, 10, 1.0, "2Gi"), [], {
            "budgets": {"default": dict(limits)}}
    return build


def _minvalues(min_values, n_types=24):
    def build(S):
        t = T.constrained_templates(n_types, min_values=min_values, reservations={}, side=S)
        return t, S.mixed_pods(30) + _pods(S, 6, 2.0, "4Gi"), [], {}
    return build


def _reserved(reservations, n_types=24, **solve_kw):
    def build(S):
        t = T.constrained_templates(n_types, min_values=(), reservations=reservations, side=S)
        return t, S.mixed_pods(30) + _pods(S, 8, 1.0, "2Gi", node_selector={S.l.LABEL_ARCH: "amd64"}), [], dict(
            solve_kw)
    return build


RES_SMALL = {16: ("test-zone-1", "res-a", 3), 18: ("test-zone-2", "res-b", 2), 20: ("test-zone-1", "res-c", 1)}

SOLVE_CASES = {
    # name: (build, scheduler kwargs)
    "hostports_fill": (_ports_fill, {}),
    "hostports_kscan": (_ports_kscan, {}),
    "hostports_perpod": (_ports_perpod, {}),
    "csi_existing": (_csi_existing, {}),
    "volume_zone": (_volume_zone, {}),
    "budget_cpu": (_budget({"cpu": 12.0}), {}),
    "budget_nodes": (_budget({"nodes": 4}), {}),
    "minvalues_name": (_minvalues(((T.l.LABEL_INSTANCE_TYPE, 5),)), {}),
    "minvalues_family": (_minvalues(((T.FAMILY_KEY, 3), (T.l.LABEL_INSTANCE_TYPE, 2))), {}),
    "minvalues_unsatisfiable": (_minvalues(((T.FAMILY_KEY, 5),)), {}),
    "minvalues_best_effort": (_minvalues(((T.FAMILY_KEY, 5), (T.l.LABEL_INSTANCE_TYPE, 30))),
                              {"min_values_policy": "BestEffort"}),
    "reserved_fallback": (_reserved(RES_SMALL), {}),
    "reserved_strict": (_reserved(RES_SMALL), {"reserved_mode": "strict"}),
    "reserved_exhausted": (_reserved({16: ("test-zone-1", "res-a", 1)}), {"reserved_mode": "strict"}),
    "reserved_in_use": (_reserved(RES_SMALL, reserved_in_use={"res-a": 2, "res-b": 5}), {}),
    "reserved_disabled": (_reserved(RES_SMALL), {"reserved_capacity_enabled": False}),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_constrained_solve_matches_reference(case):
    """TorchScheduler(device="cpu").solve equals TPUScheduler.solve on the
    problem, and the problem reaches what it names."""
    build, sched_kw = SOLVE_CASES[case]
    rp, ps = _both(build, sched_kw)
    st = ps.last_stats
    claims = rp.claims
    if case.startswith("hostports"):
        assert any(c.host_ports for c in claims) and rp.node_count > 1
        assert all(len(c.host_ports) == len(set(c.host_ports)) for c in claims)
        route = case.split("_")[1]
        assert st[{"fill": "fill_dispatches", "kscan": "kscan_dispatches", "perpod": "perpod_dispatches"}[route]]
    if case == "hostports_fill":
        assert any(n.host_ports and len(n.pods) for n in rp.existing)
    if case == "csi_existing":
        assert rp.existing_assignments and any(len(n.volume_usage.pod_volumes) > 1 for n in rp.existing)
    if case.startswith(("budget", "minvalues", "reserved")) and case not in ("minvalues_best_effort",
                                                                             "reserved_disabled"):
        assert st["fill_dispatches"] == st["kscan_dispatches"] == 0 and st["perpod_dispatches"] > 0
    if case.startswith("budget"):
        assert rp.unschedulable and rp.node_count
    if case == "minvalues_unsatisfiable":
        assert not claims and rp.unschedulable
    if case == "minvalues_best_effort":
        assert st["fill_dispatches"] and all(c.min_values_relaxed for c in claims)
    if case in ("reserved_fallback", "reserved_strict", "reserved_in_use"):
        assert any(c.reserved_ids for c in claims)
    if case == "reserved_disabled":
        assert not any(c.reserved_ids for c in claims) and st["fill_dispatches"]
    if case == "reserved_exhausted":
        assert sum(bool(c.reserved_ids) for c in claims) == 1


def test_perpod_dispatches_count_every_round(monkeypatch):
    """last_stats' perpod_dispatches describes the last round of the
    relaxation ladder; perpod_dispatches_all counts the per-pod chunks of
    every round (each a launch of the per-pod kernel on the card)."""
    calls = []
    real = p_solver.solve_from
    monkeypatch.setattr(p_solver, "solve_from", lambda *a, **k: calls.append(1) or real(*a, **k))
    s = TorchScheduler(T.constrained_templates(24, reservations=RES_SMALL), max_claims=64, device="cpu")
    s.solve(T.mixed_pods(40) + T.hostport_pods(6), budgets={"default": {"cpu": 40.0}})
    st = s.last_stats
    assert st["rounds"] > 1 and st["perpod_dispatches_all"] == len(calls) > st["perpod_dispatches"] > 0


def test_held_reservations_survive_compaction():
    """Per-pod chunks of 16 with boundary compaction: claims holding
    reservations are evicted to the bank (held -> bank_held) and merged
    back at decode (global_claims), and the reserved ids, pins and
    capacities stay the reference's."""

    def build(S):
        t = T.constrained_templates(24, min_values=(), reservations=RES_SMALL, side=S)
        # 3-cpu pods fill a 4-cpu claim each: every claim is dead at the next boundary
        return t, _pods(S, 40, 3.0, "2Gi"), [], {}

    out = []
    for S in SIDES:
        templates, pods, _nodes, _kw = build(S)
        s = S.sched(templates, max_claims=128, **S.kw)
        s.solve_chunk, s.compact_min_pods = 16, 20
        r = s.solve(pods)
        out.append((view(r), r, s))
    (vj, _rj, _sj), (vp, rp, sp) = out
    for k in vj:
        assert vj[k] == vp[k], k
    st = sp.last_stats
    assert st["compactions"] > 0 and st["frozen"] > 0 and st["perpod_dispatches"] > 1
    assert any(c.reserved_ids for c in rp.claims)


# ---------------------------------------------------------------------------
# what-ifs
# ---------------------------------------------------------------------------


class Cluster:
    """One side's consolidation problem over the constrained templates."""

    def __init__(self, S, n_pods=40, n_types=24, n_pending=6, ports=False, reservations=RES_SMALL,
                 min_values=T.MIN_VALUES):
        self.S = S
        self.templates = T.constrained_templates(n_types, min_values=min_values, reservations=reservations, side=S)
        pods = S.mixed_pods(n_pods)
        result = S.sched(self.templates, **S.kw).solve(pods)
        assert not result.unschedulable
        self.cluster = T.launch_claims(result, self.templates, side=S)
        self.cands = T.candidates(self.cluster)
        self.pending = T.pending_pods(n_pending, side=S)
        if ports:
            self.pending += T.hostport_pods(3, port=8443, side=S)
        self.factory = T.topology_factory(self.cluster, side=S)

    def whatif(self, sets, sched_kw=None, **kw):
        pods, specs = T.scenarios_of(sets, self.pending)
        sched = self.S.sched(self.templates, **self.S.kw, **(sched_kw or {}))
        return sched.whatif_batch(pods, [x.clone() for x in self.cluster.nodes], kw.pop("budgets", None), specs,
                                  self.factory, **kw)


def _whatif_both(sched_kw=None, extra=None, **cluster_kw):
    out = []
    for S in SIDES:
        c = Cluster(S, **cluster_kw)
        kw = extra(c) if extra else {}
        sets = [c.cands[:k] for k in range(1, 6)] + [[x] for x in c.cands[:4]]
        out.append(c.whatif(sets, sched_kw, **kw))
    assert out[0] is not None and out[0] == out[1]
    return out[1]


def _csi_and_zone(c):
    vols = T.attach_volumes(c.cluster, c.pending, every_bound=2, every_pending=2, limit=2, side=c.S)
    alt = c.S.Requirements()
    alt.add(c.S.Requirement.new(c.S.l.LABEL_TOPOLOGY_ZONE, c.S.Operator.IN, "test-zone-1", "test-zone-2"))
    return dict(pod_volumes=vols, volume_reqs={p.uid: [alt] for p in c.pending[1::3]},
                reserved_in_use=T.reserved_in_use(c.cluster, side=c.S))


WHATIF_CASES = {
    # name: (scheduler kwargs, extra whatif kwargs from the cluster, cluster kwargs)
    "minvalues_and_reserved": ({}, lambda c: dict(reserved_in_use=T.reserved_in_use(c.cluster, side=c.S)), {}),
    "reserved_strict": ({"reserved_mode": "strict"}, None, {}),
    "csi_and_volume_zone": ({}, _csi_and_zone, {}),
    "host_ports": ({}, None, {"ports": True, "min_values": (), "reservations": {}}),
    "budget": ({}, lambda c: dict(budgets={"default": {"cpu": 16.0}}), {"min_values": (), "reservations": {}}),
    "budget_nodes": ({}, lambda c: dict(budgets={"default": {"nodes": 2}}), {"min_values": (), "reservations": {}}),
    "reserved_disabled": ({"reserved_capacity_enabled": False}, None, {"min_values": ()}),
    "minvalues_best_effort": ({"min_values_policy": "BestEffort"}, None, {"reservations": {}}),
}


@pytest.mark.parametrize("case", sorted(WHATIF_CASES))
def test_constrained_whatif_batch_matches_reference(case):
    """whatif_batch under each constraint returns the reference's
    [(feasible, n_new)] list over prefixes and singletons."""
    sched_kw, extra, cluster_kw = WHATIF_CASES[case]
    sig = _whatif_both(sched_kw, extra, **cluster_kw)
    assert len(sig) == 9 and any(f for f, _n in sig)


def test_whatif_batch_returns_none_for_volume_alternatives():
    """Several volume alternatives, or a volume key a node leaves
    undefined: None on both sides (the callers simulate one by one)."""
    for S in SIDES:
        c = Cluster(S, reservations={}, min_values=())
        a1, a2 = S.Requirements(), S.Requirements()
        a1.add(S.Requirement.new(S.l.LABEL_TOPOLOGY_ZONE, S.Operator.IN, "test-zone-1"))
        a2.add(S.Requirement.new(S.l.LABEL_TOPOLOGY_ZONE, S.Operator.IN, "test-zone-2"))
        assert c.whatif([c.cands[:1]], volume_reqs={c.pending[0].uid: [a1, a2]}) is None
        a3 = S.Requirements()
        a3.add(S.Requirement.new("example.com/rack", S.Operator.IN, "r1"))
        assert c.whatif([c.cands[:1]], volume_reqs={c.pending[0].uid: [a3]}) is None


# ---------------------------------------------------------------------------
# the topology rank key past a count of 2^15
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["kscan", "perpod"])
def test_rank_key_past_2_15_matches_reference(route):
    """Zone counts seeded past 2^15 through solve(topology=): the kind
    scan (H6's plain mode) and the per-pod scan pick the reference's
    domains, whose rank keys wrap."""

    def build(S):
        t = S.make_templates(24)
        pods = S.zonal_pods(24, kinds=2) if route == "kscan" else S.perpod_pods(24, kinds=2)
        topo = S.Topology.build(list(pods), lambda: S.build_universe_domains(
            t, [], template_base=S.template_universe_domains(t)))
        return t, pods, [], {"topology": T.seed_big_counts(topo, S)}

    rp, ps = _both(build)
    assert ps.last_stats[f"{route}_dispatches"] and rp.node_count


def test_rank_key_past_2_15_whatif_seeds():
    """The what-if seeds past 2^15 (every scenario's zone counts): the
    reference's signals."""
    out = []
    for S in SIDES:
        c = Cluster(S, reservations={}, min_values=())
        base = c.factory
        c.factory = lambda pods, excluded, base=base, S=S: T.seed_big_counts(base(pods, excluded), S)
        out.append(c.whatif([c.cands[:k] for k in range(1, 5)] + [[x] for x in c.cands[:3]]))
    assert out[0] is not None and out[0] == out[1] and any(f for f, _n in out[1])


# ---------------------------------------------------------------------------
# the plain reductions
# ---------------------------------------------------------------------------


def test_min_values_ok_matches_reference():
    """The port's _min_values_ok against the reference's _min_values_ok (a bf16
    einsum) on seeded viable sets, keys (-2 padding, -1 names, j) and
    floors, at the edges (a floor met exactly, one short)."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        C, T_, J, V, M = (int(x) for x in (rng.integers(1, 9), rng.integers(1, 40), rng.integers(1, 4),
                                           rng.integers(1, 20), rng.integers(1, 4)))
        viable = rng.random((C, T_)) < rng.random()
        slab = rng.random((T_, J, V)) < 0.2
        key = rng.integers(-2, J, size=(C, M)).astype(np.int32)
        floor = rng.integers(0, 8, size=(C, M)).astype(np.int32)
        want = np.asarray(j_solver._min_values_ok(jnp.asarray(viable), jnp.asarray(key), jnp.asarray(floor),
                                                  jnp.asarray(slab)))
        got = p_solver._min_values_ok(*(torch.from_numpy(a) for a in (viable, key, floor, slab))).numpy()
        assert np.array_equal(got, want)


def _reference_reserve_options(viable, mask, res_ofs, zone_kid, ct_kid, rid_kid, res_vid):
    """The reference's _reserve_options (solver.py:352, a closure of
    _make_step), its einsum verbatim."""
    RID, Zr = res_ofs.shape[1], res_ofs.shape[2]
    zmask = mask[:, zone_kid, :Zr]
    hit = jnp.einsum("bt,trz,bz->br", viable.astype(jnp.bfloat16), res_ofs.astype(jnp.bfloat16),
                     zmask.astype(jnp.bfloat16), preferred_element_type=jnp.float32) > 0
    return hit & mask[:, rid_kid, :RID] & mask[:, ct_kid, res_vid][:, None]


def test_reserve_options_matches_reference():
    """The port's _reserve_options against the reference's einsum on seeded viable
    sets, reserved-offering slabs and requirement masks."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        B, T_, RID, Z, K, V = (int(x) for x in (rng.integers(1, 9), rng.integers(1, 30), rng.integers(1, 5),
                                                rng.integers(1, 5), 6, 8))
        viable = rng.random((B, T_)) < 0.5
        res_ofs = rng.random((T_, RID, Z)) < 0.3
        mask = rng.random((B, K, V)) < 0.6
        args = (1, 2, 3, int(rng.integers(0, V)))
        want = np.asarray(_reference_reserve_options(jnp.asarray(viable), jnp.asarray(mask), jnp.asarray(res_ofs),
                                                     *args))
        got = p_solver._reserve_options(torch.from_numpy(viable), torch.from_numpy(mask), torch.from_numpy(res_ofs),
                                       *args).numpy()
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the chip cells' goldens
# ---------------------------------------------------------------------------


def constrained_problem(S, n_pods=CHIP_PODS, n_types=CHIP_TYPES, n_ingress=CHIP_INGRESS):
    """constrained_4096x400: mixed_pods(4096) and the ingress deployment
    over the constrained templates, with the pool's cpu limit."""
    return (T.constrained_templates(n_types, side=S), S.mixed_pods(n_pods) + T.hostport_pods(n_ingress, side=S),
            {"default": {"cpu": CHIP_CPU_LIMIT}})


def whatif_constrained(S, n_pods=CHIP_PODS, n_types=CHIP_TYPES, n_pending=CHIP_PENDING):
    """whatif_constrained_prefix100: the constrained templates' cluster of
    mixed_pods(4096), 64 pending pods, CSI limits and PVCs, reservations
    in use; (templates, cluster, candidates, pending, factory, kwargs)."""
    templates = T.constrained_templates(n_types, side=S)
    result = S.sched(templates, max_claims=CHIP_MAX_CLAIMS, **S.kw).solve(S.mixed_pods(n_pods))
    assert not result.unschedulable
    cluster = T.launch_claims(result, templates, side=S)
    pending = T.pending_pods(n_pending, side=S)
    vols = T.attach_volumes(cluster, pending, side=S)
    kw = dict(pod_volumes=vols, reserved_in_use=T.reserved_in_use(cluster, side=S))
    return templates, cluster, T.candidates(cluster), pending, T.topology_factory(cluster, side=S), kw


def chip_goldens() -> dict:
    """The JAX package's results on the constrained chip cells."""
    from test_torch_whatif import _placements_digest, _reference_per_scenario, _spying

    out = {}
    t0 = time.perf_counter()
    templates, pods, budgets = constrained_problem(JAX)
    s = TPUScheduler(templates, max_claims=CHIP_MAX_CLAIMS)
    r = s.solve(pods, budgets=budgets)
    out["constrained"] = dict(claims=len(r.claims), unschedulable=len(r.unschedulable),
                              price=round(r.total_price(), 4), digest=T.result_digest(r),
                              reserved=sum(bool(c.reserved_ids) for c in r.claims), wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    t0 = time.perf_counter()
    r = TPUScheduler(bench.make_templates(CHIP_TYPES)).solve(
        bench.mixed_pods(CHIP_HOSTPORT_PODS) + T.hostport_pods(CHIP_INGRESS, side=JAX))
    out["hostports"] = dict(claims=len(r.claims), unschedulable=len(r.unschedulable),
                            price=round(r.total_price(), 4), digest=T.result_digest(r), wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    t0 = time.perf_counter()
    templates, cluster, cands, pending, factory, kw = whatif_constrained(JAX)
    t1 = time.perf_counter()
    pods, specs = T.prefix_scenarios(cands, CHIP_CANDS, pending)
    sched = TPUScheduler(templates)
    sig, calls = _spying(lambda: sched.whatif_batch(pods, [n.clone() for n in cluster.nodes], None, specs, factory,
                                                    **kw))
    wall = time.perf_counter() - t1
    (a, skw, _o), = calls
    t2 = time.perf_counter()
    placements = _placements_digest(_reference_per_scenario(a, skw, CHIP_CANDS), a, sched.encoder.vocab)
    out["whatif"] = dict(nodes=len(cluster.nodes), bound=sum(len(v) for v in cluster.bound.values()),
                         cluster_digest=T.cluster_digest(cluster), reserved_in_use=kw["reserved_in_use"],
                         pvcs=len(kw["pod_volumes"]), digest=T.signals_digest(sig), signals=[[bool(f), int(n)]
                                                                                             for f, n in sig],
                         placements_digest=placements, cluster_s=t1 - t0, wall_s=wall,
                         placements_s=time.perf_counter() - t2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import resource

    g = chip_goldens()
    g["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(g))
