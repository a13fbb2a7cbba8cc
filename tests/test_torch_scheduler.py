"""End to end: TorchScheduler(device="cpu") against the JAX package's
TPUScheduler on the same workloads (the fill cases of tests/test_fill.py,
the 2048 x 400 selector stage, a chunked + compacted solve, and the
topology workloads: the reference benchmark's mixed pods, zonal and
hostname spread, and the per-pod kinds), compared per pod and per claim,
requirements (the narrowed zone) included; host ports and a finite budget
match too (tests/test_torch_constrained.py holds the rest of Karpenter's
constraints); the problems outside the port (gangs, DRA claims) raise
UnsupportedProblem; the package imports neither JAX nor the JAX package;
and nothing runs on a missing card. Tolerance: exact equality."""

import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import bench
from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.controllers.provisioning import host_scheduler as j_host
from karpenter_tpu.models import labels as jl
from karpenter_tpu.models import pod as j_pod
from karpenter_tpu.scheduling import Operator as JOp
from karpenter_tpu.scheduling import Requirement as JReq
from karpenter_tpu.scheduling import Requirements as JReqs
from karpenter_tpu_torch import testing as p_testing
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler, UnsupportedProblem
from karpenter_tpu_torch.controllers.provisioning import host_scheduler as p_host
from karpenter_tpu_torch.models import labels as pl
from karpenter_tpu_torch.models import pod as p_pod
from karpenter_tpu_torch.scheduling import Operator as POp
from karpenter_tpu_torch.scheduling import Requirement as PReq
from karpenter_tpu_torch.scheduling import Requirements as PReqs

ROOT = Path(__file__).resolve().parents[1]

JAX_SIDE = types.SimpleNamespace(
    make_pod=j_pod.make_pod, l=jl, HostPort=j_pod.HostPort, TSC=j_pod.TopologySpreadConstraint,
    Term=j_pod.PodAffinityTerm, Req=JReq, Reqs=JReqs, Op=JOp, Node=j_host.ExistingSimNode,
    templates=bench.make_templates, selector_pods=bench.selector_pods, mixed_pods=bench.mixed_pods,
    zonal_pods=bench.zonal_pods, hostname_pods=bench.hostname_pods, perpod_pods=bench.perpod_pods,
)
PORT_SIDE = types.SimpleNamespace(
    make_pod=p_pod.make_pod, l=pl, HostPort=p_pod.HostPort, TSC=p_pod.TopologySpreadConstraint,
    Term=p_pod.PodAffinityTerm, Req=PReq, Reqs=PReqs, Op=POp, Node=p_host.ExistingSimNode,
    templates=p_testing.make_templates, selector_pods=p_testing.selector_pods,
    mixed_pods=p_testing.mixed_pods, zonal_pods=p_testing.zonal_pods,
    hostname_pods=p_testing.hostname_pods, perpod_pods=p_testing.perpod_pods,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pods(S, n, cpu=0.5, mem="1Gi", prefix="p", **kw):
    return [S.make_pod(f"{prefix}-{i}", cpu=cpu, memory=mem, **kw) for i in range(n)]


def _node_a(S):
    reqs = S.Reqs()
    reqs.add(S.Req.new(S.l.LABEL_HOSTNAME, S.Op.IN, "node-a"))
    reqs.add(S.Req.new(S.l.LABEL_TOPOLOGY_ZONE, S.Op.IN, "test-zone-1"))
    reqs.add(S.Req.new(S.l.CAPACITY_TYPE_LABEL_KEY, S.Op.IN, S.l.CAPACITY_TYPE_ON_DEMAND))
    return S.Node(
        name="node-a", index=0, requirements=reqs,
        available={"cpu": 4.0, "memory": float(8 * 2**30), "pods": 110.0},
    )


def _selector_kinds(S):
    pods = []
    zones = ("test-zone-1", "test-zone-2")
    for i in range(48):
        sel = {}
        if i % 3 == 1:
            sel[S.l.LABEL_TOPOLOGY_ZONE] = zones[i % 2]
        if i % 3 == 2:
            sel[S.l.CAPACITY_TYPE_LABEL_KEY] = S.l.CAPACITY_TYPE_ON_DEMAND
        pods.append(S.make_pod(f"s-{i}", cpu=0.5, memory="1Gi", node_selector=sel))
    return pods


# name -> (build(S) -> (templates, pods, existing), max_claims, expected unschedulable)
CASES = {
    "identical_pods_pack": (lambda S: (S.templates(20), _pods(S, 64), None), 64, 0),
    "two_kinds_water_fill": (
        lambda S: (S.templates(20), _pods(S, 8, 2.0, "4Gi", "big") + _pods(S, 40, 0.25, "256Mi", "small"), None),
        64, 0,
    ),
    "selector_kinds": (lambda S: (S.templates(20), _selector_kinds(S), None), 64, 0),
    "existing_nodes_tier1": (lambda S: (S.templates(20), _pods(S, 24, 0.5, "512Mi"), [_node_a(S)]), 64, 0),
    "impossible_selector": (
        lambda S: (S.templates(20), _pods(S, 5, node_selector={S.l.LABEL_TOPOLOGY_ZONE: "nonexistent-zone"}), None),
        64, 5,
    ),
    "no_room_recovers": (lambda S: (S.templates(1), _pods(S, 8, 0.5, "256Mi"), None), 4, 0),
    "non_exact_quantities": (lambda S: (S.templates(20), _pods(S, 9, 0.3, "300Mi"), None), 16, 0),
}


def _view(result):
    """Everything a caller reads, keyed by pod NAME (uids differ between
    the two packages' object counters)."""
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
             sorted(c.used.items()), c.template.nodepool_name, str(c.requirements))
            for c in result.claims
        ],
        assignments=sorted((name_of[u], s) for u, s in result.assignments.items()),
        existing=sorted((name_of[u], n) for u, n in result.existing_assignments.items()),
        existing_used=[sorted(n.used.items()) for n in result.existing],
        existing_reqs=[str(n.requirements) for n in result.existing],
        unschedulable=[(p.name, r) for p, r in result.unschedulable],
        node_count=result.node_count,
        total_price=result.total_price(),
    )


def _compare(name, build, max_claims, tweak=None):
    jt, jpods, jex = build(JAX_SIDE)
    pt, ppods, pex = build(PORT_SIDE)
    js = TPUScheduler(jt, max_claims=max_claims)
    ps = TorchScheduler(pt, max_claims=max_claims, device="cpu")
    if tweak:
        tweak(js)
        tweak(ps)
    rj = js.solve(jpods, existing_nodes=[n.clone() for n in (jex or [])])
    rp = ps.solve(ppods, existing_nodes=[n.clone() for n in (pex or [])])
    vj, vp = _view(rj), _view(rp)
    for k in vj:
        assert vj[k] == vp[k], (name, k)
    return rp, ps


@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_cases_match_reference(case):
    build, max_claims, unsched = CASES[case]
    rp, _ps = _compare(case, build, max_claims)
    assert len(rp.unschedulable) == unsched
    if case == "no_room_recovers":
        assert rp.node_count == 8
    if case == "existing_nodes_tier1":
        assert len(rp.existing_assignments) == 8


def test_selector_stage_2048x400():
    rp, ps = _compare(
        "selector_2048x400",
        lambda S: (S.templates(400), S.selector_pods(2048), None),
        256,
    )
    assert rp.node_count > 0 and not rp.unschedulable
    assert set(ps.last_timings) == {"encode_s", "device_s", "decode_s"}


def test_chunked_and_compacted_solve():
    """pipeline_min_pods / compact_min_pods lowered on both schedulers: four
    dispatch groups with compaction at the boundaries."""

    def tweak(s):
        s.pipeline_min_pods = 300
        s.compact_min_pods = 300

    rp, ps = _compare(
        "chunked",
        lambda S: (S.templates(60), S.selector_pods(600), None),
        256, tweak,
    )
    assert ps.last_stats["groups"] == 4 and ps.last_stats["compactions"] == 3
    assert ps.last_stats["frozen"] > 0


def test_ffd_order_matches_reference():
    """The pure-Python FFD keys give the reference's pod order."""
    jp, pp = JAX_SIDE.selector_pods(300), PORT_SIDE.selector_pods(300)
    jp += JAX_SIDE.selector_pods(40)  # repeated contents join earlier kinds
    pp += PORT_SIDE.selector_pods(40)
    want = [p.name for p in j_host.ffd_sort(jp)]
    assert [p.name for p in p_host.ffd_sort(pp)] == want


def _compact_early(s):
    s.compact_min_pods = 50


def _zonal_and_hostname(S):
    return S.zonal_pods(120, kinds=3) + S.hostname_pods(60, kinds=2)


TOPOLOGY_CASES = {
    # (build(S) -> (templates, pods, existing), max_claims, tweak)
    "mixed_100x24": (lambda S: (S.templates(24), S.mixed_pods(100), None), 32, None),
    "mixed_300x48_compacted": (lambda S: (S.templates(48), S.mixed_pods(300), None), 96, _compact_early),
    "zonal_hostname_evicted": (lambda S: (S.templates(24), _zonal_and_hostname(S), None), 128, _compact_early),
    "mixed_existing_node": (lambda S: (S.templates(24), S.mixed_pods(80), [_node_a(S)]), 32, None),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_topology_workloads_match_reference(case):
    """Fill and kind-scan dispatches interleaved, compaction at their
    boundaries (evicting claims with narrowed zones into the bank in the
    zonal case), every claim's requirements equal the reference's."""
    build, max_claims, tweak = TOPOLOGY_CASES[case]
    rp, ps = _compare(case, build, max_claims, tweak)
    st = ps.last_stats
    assert st["kscan_dispatches"] > 0 and rp.node_count > 0
    zoned = [c for c in rp.claims if c.requirements.get(pl.LABEL_TOPOLOGY_ZONE).operator() is POp.IN]
    assert zoned, "no claim carries a narrowed zone"
    if tweak is not None:
        assert st["compactions"] > 0
    if case == "zonal_hostname_evicted":
        assert st["frozen"] > 0 and st["fill_dispatches"] > 0
    if case == "mixed_existing_node":
        assert rp.existing_assignments


def _edge_pods(S, kind):
    pods = _pods(S, 4, 0.25, "256Mi")
    for p in pods:
        p.metadata.labels = {"app": "x"}
        if kind == "perpod":
            # two vocab keys (zone and capacity type): the per-pod scan's
            p.spec.topology_spread_constraints = [
                S.TSC(max_skew=1, topology_key=S.l.LABEL_TOPOLOGY_ZONE, label_selector={"app": "x"}),
                S.TSC(max_skew=1, topology_key=S.l.CAPACITY_TYPE_LABEL_KEY, label_selector={"app": "x"}),
            ]
        elif kind == "empty_hostname_affinity":
            # an initially-empty hostname affinity group, no vocab key
            p.spec.pod_affinity = [S.Term(topology_key=S.l.LABEL_HOSTNAME, label_selector={"app": "x"})]
        elif kind == "gang":
            p.metadata.annotations = {"ktpu.dev/gang-name": "g", "ktpu.dev/gang-size": "4"}
        elif kind == "host_ports":
            p.spec.host_ports = [S.HostPort(port=8080)]
        elif kind == "dra":
            p.spec.resource_claims = ["gpu-claim"]
    return pods


@pytest.mark.parametrize("kind", ["gang", "host_ports", "dra"])
def test_out_of_slice_problems_raise(kind):
    """Gang members and DRA claims stay outside the port and raise
    UnsupportedProblem. Host ports are inside it now: pods binding one
    host port (each a node of its own) ride the fill scan and match the
    reference, the claims' host ports included."""
    if kind == "host_ports":
        rp, ps = _compare(kind, lambda S: (S.templates(10), _edge_pods(S, kind), None), 16)
        assert rp.node_count == 4 and all(c.host_ports == [("0.0.0.0", 8080, "TCP")] for c in rp.claims)
        assert ps.last_stats["fill_dispatches"] > 0
        return
    ps = TorchScheduler(p_testing.make_templates(10), max_claims=16, device="cpu")
    with pytest.raises(UnsupportedProblem) as err:
        ps.solve(_edge_pods(PORT_SIDE, kind))
    assert err.value.reason


@pytest.mark.parametrize("kind", ["perpod", "empty_hostname_affinity"])
def test_per_pod_kinds_match_reference(kind):
    """Kinds the reference routes to its per-pod scan (two vocab keys; an
    initially-empty hostname affinity group) solve on the port's per-pod
    scan and match."""
    _rp, ps = _compare(kind, lambda S: (S.templates(10), _edge_pods(S, kind), None), 16)
    assert ps.last_stats["perpod_dispatches"] > 0


def test_perpod_pods_match_reference():
    """perpod_pods (bench.py:106): zone and capacity-type spread per kind."""
    rp, ps = _compare("perpod_pods", lambda S: (S.templates(24), S.perpod_pods(8), None), 32)
    assert ps.last_stats["perpod_dispatches"] == 1 and rp.node_count > 0


def test_finite_budget_raises():
    """A finite cpu budget, which raised before the port had budgets, now
    matches the reference: every kind on the per-pod scan, the pool's
    limit binds and the same pods stay unschedulable."""

    def solve(S, sched_cls, **kw):
        return sched_cls(S.templates(10), max_claims=16, **kw).solve(
            _pods(S, 12, 1.0, "1Gi"), budgets={"default": {"cpu": 8.0}})

    rj, rp = solve(JAX_SIDE, TPUScheduler), solve(PORT_SIDE, TorchScheduler, device="cpu")
    assert _view(rj) == _view(rp)
    assert rp.unschedulable and rp.node_count


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScheduler(p_testing.make_templates(4))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import karpenter_tpu_torch\n"
        "for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, 'karpenter_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'karpenter_tpu' or m.startswith('karpenter_tpu.'))\n"
        "print(len([m for m in sys.modules if m.startswith('karpenter_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the script must fail and print no result, both in the
    checkout and alone in an otherwise empty directory."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120, env=env,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
