"""The port's batched consolidation what-ifs against the JAX package's:
the host topology seeded from bound pods (Topology.build), the seeds'
encode (encode_topology with nonzero counts, encode_topology_counts per
scenario), the plain solve_whatif against the reference's jitted
solve_whatif and its per-scenario solve, TorchScheduler.whatif_batch
against TPUScheduler.whatif_batch end to end (None and
UnsupportedProblem included), solve(topology=...) with bound pods, and
the scenario-mode launcher's parameter block. Inputs come from seeded
generators through both packages; the consolidation fixture
(karpenter_tpu_torch.testing) builds its JAX twin here from the JAX
package's classes. Tolerance: exact equality everywhere.

    python tests/test_torch_whatif.py   # the chip cells' goldens (JAX, CPU)

prints the JAX package's signals for chip_smoke.py's what-if cells."""

import ctypes
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
from karpenter_tpu.controllers.provisioning import TPUScheduler  # noqa: E402
from karpenter_tpu.controllers.provisioning import topology as j_topology  # noqa: E402
from karpenter_tpu.controllers.provisioning.host_scheduler import ExistingSimNode as JNode  # noqa: E402
from karpenter_tpu.models import labels as jl  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu.ops import topology as j_topo  # noqa: E402
from karpenter_tpu.scheduling import Operator as JOp  # noqa: E402
from karpenter_tpu.scheduling import Requirement as JReq  # noqa: E402
from karpenter_tpu.scheduling import Requirements as JReqs  # noqa: E402
from karpenter_tpu.utils import resources as j_res  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler, UnsupportedProblem  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import topology as p_topology  # noqa: E402
from karpenter_tpu_torch.ops import cuda as p_cuda  # noqa: E402
from karpenter_tpu_torch.ops import encode as p_encode  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402
from karpenter_tpu_torch.ops import topology as p_topo  # noqa: E402
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors  # noqa: E402
from karpenter_tpu.ops import kernels as j_kernels  # noqa: E402
from test_torch_perpod import _assert_leaves_equal, _pt, _tonp  # noqa: E402
from test_torch_scheduler import _view  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JAX = types.SimpleNamespace(
    make_pod=j_pod.make_pod, l=jl, res=j_res, Operator=JOp, Requirement=JReq, Requirements=JReqs,
    ExistingSimNode=JNode, Topology=j_topology.Topology, build_universe_domains=j_topology.build_universe_domains,
    template_universe_domains=j_topology.template_universe_domains,
)
# per side: the fixture's namespace, the scheduler, the workload generators
SIDES = {
    "jax": (JAX, TPUScheduler, {}, bench.make_templates, bench.mixed_pods),
    "port": (T.PORT, TorchScheduler, {"device": "cpu"}, T.make_templates, T.mixed_pods),
}

# the chip cells (chip_smoke.py): mixed_pods(4096) x make_templates(400)
# launched as a cluster, 64 pending pods, the first 100 candidates
CHIP_PODS, CHIP_TYPES, CHIP_PENDING, CHIP_CANDS = 4096, 400, 64, 100
CONFIRM_PREFIXES = (1, 10, 100)


class Cell:
    """One side's consolidation problem: the launched cluster, its
    candidates, the pending pods and the topology factory."""

    def __init__(self, side: str, n_pods: int, n_types: int, n_pending: int, pods_fn=None):
        S, sched_cls, kw, make_templates, make_pods = SIDES[side]
        self.side, self.S, self.sched_cls, self.kw = side, S, sched_cls, kw
        self.templates = make_templates(n_types)
        pods = pods_fn(S, n_pods) if pods_fn else make_pods(n_pods)
        result = sched_cls(self.templates, **kw).solve(pods)
        assert not result.unschedulable
        self.cluster = T.launch_claims(result, self.templates, side=S)
        self.cands = T.candidates(self.cluster)
        self.pending = T.pending_pods(n_pending, side=S)
        self.factory = T.topology_factory(self.cluster, side=S)

    def scheduler(self):
        return self.sched_cls(self.templates, **self.kw)

    def whatif(self, kind: str, n: int, sched=None):
        pods, specs = getattr(T, f"{kind}_scenarios")(self.cands, n, self.pending)
        sched = sched or self.scheduler()
        return sched.whatif_batch(pods, [x.clone() for x in self.cluster.nodes], None, specs, self.factory)

    def confirm(self, k: int):
        return T.sequential_signal(self.scheduler(), self.cluster, self.factory, self.pending, self.cands[:k])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _selector_pods(S, n):
    return [S.make_pod(f"s-{i}", cpu=1.5, memory="1Gi") for i in range(n)]


# name -> (pods, n_types, n_pending, pods_fn); each side's cell built once
CELLS = {
    # the tests/test_whatif.py shape: one 1.5-cpu pod per 2-cpu node
    "selector": (8, 12, 2, _selector_pods),
    # every mixed_pods fifth bound: zone spread, hostname spread, zone
    # affinity and hostname anti-affinity seed the counts (~12 nodes)
    "topology": (48, 24, 6, None),
}
_CELL_CACHE: dict = {}


def _cells(name: str) -> tuple:
    if name not in _CELL_CACHE:
        n, types_, pending, fn = CELLS[name]
        _CELL_CACHE[name] = tuple(Cell(side, n, types_, pending, fn) for side in ("jax", "port"))
    return _CELL_CACHE[name]


def _names(cell) -> dict:
    """uid -> name over every pod the cell knows (uids differ between the
    two packages' object counters)."""
    pods = [p for ps in cell.cluster.bound.values() for p in ps] + list(cell.pending)
    return {p.uid: p.name for p in pods}


def _groups_view(topo, name_of) -> tuple:
    def one(g):
        return (g.type.value, g.key, tuple(sorted(g.selector.items())), g.max_skew, g.min_domains,
                tuple(sorted(g.namespaces)), tuple(sorted(g.domains.items())),
                tuple(sorted(name_of[u] for u in g.owners)))

    return [one(g) for g in topo.groups], [one(g) for g in topo.inverse_groups]


@pytest.mark.parametrize("k", [0, 3])
def test_topology_build_seeds_counts_from_bound_pods(k):
    """Topology.build over the union pods with every pod bound to a node
    that is not excluded (the first k candidates are): per-group domain
    counts, owners and the inverse groups equal the reference's."""
    views = []
    for cell in _cells("topology"):
        pods, _specs = T.prefix_scenarios(cell.cands, 6, cell.pending)
        excluded = {c.name for c in cell.cands[:k]}
        views.append(_groups_view(cell.factory(pods, excluded), _names(cell)))
    assert views[0] == views[1]
    groups, inverse = views[1]
    assert {g[1] for g in groups} == {"kubernetes.io/hostname", "topology.kubernetes.io/zone"} and inverse
    # bound pods counted: zone groups by zone, hostname groups by node
    assert any(c > 0 for g in groups for _d, c in g[6])
    assert any(c > 0 for g in inverse for _d, c in g[6])


def test_topology_fast_path_looks_at_bound_anti_affinity():
    """A topology-free pending set yields an empty Topology unless a bound
    pod carries anti-affinity, whose inverse group then records the bound
    pod's domain; both packages alike."""
    out = []
    for S, topo_cls in ((JAX, j_topology.Topology), (T.PORT, p_topology.Topology)):
        free = [S.make_pod(f"f-{i}", cpu=0.5) for i in range(3)]
        anti = S.make_pod("anti", cpu=0.5)
        anti.metadata.labels = {"app": "a"}
        term = j_pod.PodAffinityTerm if S is JAX else T.PodAffinityTerm
        anti.spec.pod_anti_affinity = [term(topology_key=S.l.LABEL_HOSTNAME, label_selector={"app": "a"})]
        plain = S.make_pod("plain", cpu=0.5)
        universe = {S.l.LABEL_HOSTNAME: {"n1", "n2"}}
        labels = {S.l.LABEL_HOSTNAME: "n1"}
        empty = topo_cls.build(free, universe, [(plain, labels)])
        assert not empty.groups and not empty.inverse_groups
        seeded = topo_cls.build(free, universe, [(plain, labels), (anti, labels)])
        out.append(_groups_view(seeded, {anti.uid: "anti"}))
    assert out[0] == out[1]
    assert out[1][1] == [("pod anti-affinity", "kubernetes.io/hostname", (("app", "a"),), 1, None, ("default",),
                          (("n1", 1), ("n2", 0)), ("anti",))]


def _encode_both(name: str, k: int) -> tuple:
    """Both schedulers' encode of the union problem of the first k prefix
    scenarios, with the topology of scenario 0 (bound pods seeded)."""
    out = []
    for cell in _cells(name):
        pods, specs = T.prefix_scenarios(cell.cands, k, cell.pending)
        topo = cell.factory(pods, specs[0][0])
        sched = cell.scheduler()
        nodes = [x.clone() for x in cell.cluster.nodes]
        if cell.side == "jax":
            _sorted, enc = sched._encode(pods, nodes, None, topo)
        else:
            sched.existing_nodes = nodes
            _sorted, enc = sched._encode(pods, None, topo)
        out.append((cell, pods, specs, sched, enc))
    return out


def test_encode_topology_with_bound_pod_seeds():
    """encode_topology with nonzero counts from bound pods: every topology
    tensor equals the reference's."""
    (_jc, _jp, _js, _jsched, jenc), (_pc, _pp, _ps, _psched, penc) = _encode_both("topology", 4)
    jt, pt = jenc["topo_tensors"], penc["topo_tensors"]
    for f in jt._fields:
        assert np.array_equal(np.asarray(getattr(jt, f)), getattr(pt, f).numpy()), f
    assert int(pt.vg_counts0.sum()) > 0 and int(pt.hg_counts0.sum()) > 0


def test_encode_topology_counts_per_scenario():
    """encode_topology_counts of scenarios 1..3 (seeded without their
    excluded nodes' pods), aligned to the baseline by group identity, equal
    the reference's; a scenario with a group the baseline lacks gives None
    in both."""
    both = _encode_both("topology", 4)
    got = []
    for cell, pods, specs, sched, enc in both:
        mod = j_topo if cell.side == "jax" else p_topo
        names = [x.name for x in sched.existing_nodes]
        v_pad = enc["topo_tensors"].vg_counts0.shape[1]
        rows = []
        for excluded, _a, _c in specs[1:]:
            topo_s = cell.factory(pods, excluded)
            for n in names:
                topo_s.register(cell.S.l.LABEL_HOSTNAME, n)
            rows.append(mod.encode_topology_counts(
                topo_s, sched.encoder, enc["E"], enc["n_claims"] + 1, names, v_pad, enc["vg_groups"], enc["hg_groups"],
            ))
        topo_s._ensure_inverse("example.com/rack", {"app": "x"}, set(), "default")
        rows.append(mod.encode_topology_counts(
            topo_s, sched.encoder, enc["E"], enc["n_claims"] + 1, names, v_pad, enc["vg_groups"], enc["hg_groups"],
        ))
        got.append(rows)
    (jr, pr) = got
    for a, b in zip(jr[:-1], pr[:-1]):
        assert a is not None and b is not None
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert jr[-1] is None and pr[-1] is None
    base = both[1][4]["topo_tensors"].hg_counts0.numpy()
    assert any(not np.array_equal(r[1], base) for r in pr[:-1]), "no scenario changed a hostname seed"


def _spying(run) -> tuple:
    """run() with the reference's solve_whatif spied on: run's result and
    the [(args, kwargs, outputs)] of each solve_whatif call."""
    calls = []
    real = j_solver.solve_whatif

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    j_solver.solve_whatif = spy
    try:
        return run(), calls
    finally:
        j_solver.solve_whatif = real


def _capture_whatif(cell, sets) -> tuple:
    """The reference's whatif_batch on candidate sets, with the arguments
    of its solve_whatif call, its outputs and the encoder's vocabulary."""
    pods, specs = T.scenarios_of(sets, cell.pending)
    sched = cell.scheduler()
    sig, calls = _spying(lambda: sched.whatif_batch(
        pods, [x.clone() for x in cell.cluster.nodes], None, specs, cell.factory))
    (a, kw, out), = calls
    return sig, a, kw, out, sched.encoder.vocab


def _reference_per_scenario(a, kw, n: int) -> list:
    """The reference's solve run alone for each of the first n scenarios of
    a captured solve_whatif call, with that scenario's pods, surviving nodes
    and topology seeds: [SolveResult]."""
    idx, active, _count, ev, vg0, hg0, pt, tol, it_allow, exist_ok, ports, conf, vols, exist, it, tm, wk, tt, ptopo = a
    out = []
    for s in range(n):
        ix = jnp.asarray(idx[s])
        pods_s = j_solver.PodTensors(
            reqs=j_kernels.take_set(pt.reqs, ix), strict_reqs=j_kernels.take_set(pt.strict_reqs, ix),
            requests=pt.requests[ix], valid=pt.valid[ix] & active[s],
        )
        out.append(j_solver.solve(
            pods_s, tol[ix], it_allow[ix], exist_ok[ix], ports[ix], conf[ix], vols[ix],
            exist._replace(valid=ev[s]), it, tm, wk, tt._replace(vg_counts0=vg0[s], hg_counts0=hg0[s]),
            j_topo.take_pod_topology(ptopo, ix), **kw,
        ))
    return out


def _placements_digest(results: list, a, vocab) -> str:
    return T.placements_digest(
        np.stack([np.asarray(r.assignment) for r in results]),
        np.stack([np.asarray(r.claims.vg_counts) for r in results]),
        np.stack([np.asarray(r.claims.hg_counts) for r in results]), np.asarray(a[17].vg_key), vocab,
    )


def _to_port(a, kw) -> tuple:
    """The reference's solve_whatif arguments, carried onto the port."""
    conv = [
        *(_pt(x) for x in a[:6]),
        p_solver.from_numpy(p_solver.PodTensors, _tonp(a[6]), "cpu"),
        *(_pt(x) for x in a[7:13]),
        p_solver.from_numpy(p_solver.ExistingNodes, _tonp(a[13]), "cpu"),
        p_solver.from_numpy(InstanceTypeTensors, _tonp(a[14]), "cpu"),
        p_solver.from_numpy(p_solver.Templates, _tonp(a[15]), "cpu"),
        _pt(a[16]),
        p_solver.from_numpy(p_topo.TopologyTensors, _tonp(a[17]), "cpu"),
        p_solver.from_numpy(p_topo.PodTopology, _tonp(a[18]), "cpu"),
    ]
    return conv, dict(zone_kid=kw["zone_kid"], ct_kid=kw["ct_kid"], n_claims=kw["n_claims"], topo_kids=kw["topo_kids"])


@pytest.mark.parametrize("kind", ["prefix", "single"])
def test_solve_whatif_plain_matches_reference(kind):
    """The plain solve_whatif on the reference's own encoded inputs: per
    scenario n_unsched and n_open equal the jitted reference's; each
    scenario's assignment and final carry equal the reference's solve run
    alone with that scenario's pods, surviving nodes and seeds, leaf for
    leaf, and so does the placements digest chip_smoke.py holds."""
    jc, _pc = _cells("topology")
    n = 5
    sets = [jc.cands[:k] for k in range(1, n + 1)] if kind == "prefix" else [[c] for c in jc.cands[:n]]
    _sig, a, kw, (j_unsched, j_open), vocab = _capture_whatif(jc, sets)
    conv, common = _to_port(a, kw)
    unsched, n_open, assignment, states = p_solver.solve_whatif_full(*conv, **common)
    assert np.array_equal(np.asarray(j_unsched), unsched.numpy())
    assert np.array_equal(np.asarray(j_open), n_open.numpy())
    assert int(n_open[:n].min()) > 0
    ref = _reference_per_scenario(a, kw, n)
    for s, res in enumerate(ref):
        assert np.array_equal(np.asarray(res.assignment), assignment[s].numpy()), s
        _assert_leaves_equal(res.claims, states[s], f"scenario {s}")
    got = T.placements_digest(assignment[:n].numpy(), torch.stack([st.vg_counts for st in states[:n]]).numpy(),
                              torch.stack([st.hg_counts for st in states[:n]]).numpy(), conv[17].vg_key, vocab)
    assert got == _placements_digest(ref, a, vocab)
    assert int(conv[17].vg_key.numel()) and int(sum(st.vg_counts.sum() for st in states[:n])) > 0


def test_placements_digest_names_zone_domains():
    """The placements digest reads zone counts by domain name: the same
    counts under another order of value ids give the same digest, a count
    moved to another domain does not."""
    vocab = p_encode.Vocab()
    for z in ("zone-b", "zone-a", "zone-c"):
        vocab.add_value("topology.kubernetes.io/zone", z)
    other = p_encode.Vocab()
    for z in ("zone-c", "zone-a", "zone-b"):
        other.add_value("topology.kubernetes.io/zone", z)
    asg, hg, key = np.arange(6).reshape(2, 3), np.ones((2, 1, 4)), np.zeros(1)
    vg = np.array([[[1, 2, 3, 0]], [[0, 5, 0, 0]]])  # zone-b, zone-a, zone-c, pad
    perm = vg[..., [2, 1, 0, 3]]  # the same counts in the other order
    want = T.placements_digest(asg, vg, hg, key, vocab)
    assert T.placements_digest(asg, perm, hg, key, other) == want
    assert T.placements_digest(asg, vg, hg, key, other) != want


def _signals(cells, sets_fn) -> list:
    out = []
    for cell in cells:
        pods, specs = T.scenarios_of(sets_fn(cell.cands), cell.pending)
        out.append(cell.scheduler().whatif_batch(pods, [x.clone() for x in cell.cluster.nodes], None, specs,
                                                 cell.factory))
    return out


WHATIF_CASES = {
    # name: (cell, candidate sets of the candidates)
    "selector_prefixes_and_singles": ("selector", lambda c: [c[:k] for k in range(1, len(c) + 1)] + [[x] for x in c]),
    "topology_prefixes_and_singles": ("topology", lambda c: [c[:k] for k in range(1, len(c) + 1)] + [[x] for x in c]),
}


@pytest.mark.parametrize("case", sorted(WHATIF_CASES))
def test_whatif_batch_matches_reference(case):
    """TorchScheduler(device="cpu").whatif_batch returns the reference's
    [(feasible, n_new)] list: every prefix of the candidates plus each
    candidate alone (the mix the consolidation methods submit)."""
    name, sets_fn = WHATIF_CASES[case]
    j, p = _signals(_cells(name), sets_fn)
    assert j is not None and j == p
    assert len(p) == 2 * len(_cells(name)[1].cands)


def test_whatif_batch_infeasible_scenario():
    """The replacement catalog cut to the 1-cpu types: the displaced
    1.5-cpu pods fit no new claim and no surviving node, and both packages
    say so for the same scenarios."""
    out = []
    for cell in _cells("selector"):
        pods, specs = T.scenarios_of([cell.cands[:k] for k in range(1, len(cell.cands) + 1)], cell.pending)
        small = SIDES[cell.side][3](8)
        sched = cell.sched_cls(small, **cell.kw)
        out.append(sched.whatif_batch(pods, [x.clone() for x in cell.cluster.nodes], None, specs, cell.factory))
    assert out[0] == out[1]
    assert out[1] and not any(f for f, _n in out[1])


def test_whatif_batch_declines_where_the_reference_does():
    """None, as the reference returns, for a gang pod and for scenarios
    whose topology groups differ from the first one's (a union that leaves
    out the displaced anti-affinity pods, so an excluded node's inverse
    group vanishes)."""
    for cell in _cells("topology"):
        pods, specs = T.prefix_scenarios(cell.cands, 3, cell.pending)
        gang = cell.S.make_pod("gang-0", cpu=0.5)
        gang.metadata.annotations["ktpu.dev/gang-name"] = "g"
        nodes = [x.clone() for x in cell.cluster.nodes]
        assert cell.scheduler().whatif_batch(pods + [gang], nodes, None, specs, cell.factory) is None
        # only the pending pods in the union; scenario 0 keeps every anti pod bound
        anti_nodes = [c for c in cell.cands if any(p.spec.pod_anti_affinity for p in c.reschedulable_pods)]
        sets = [[c for c in cell.cands if c not in anti_nodes][:1], anti_nodes]
        _union, specs = T.scenarios_of(sets, cell.pending)
        pending_uids = {p.uid for p in cell.pending}
        specs = [(ex, pending_uids, set()) for ex, _a, _c in specs]
        assert cell.scheduler().whatif_batch(list(cell.pending), nodes, None, specs, cell.factory) is None


def test_whatif_batch_raises_on_what_the_port_lacks():
    """A pending pod with a DRA resource claim: the port has not ported
    device allocation and raises UnsupportedProblem (CSI attach limits
    and volume zones answer: tests/test_torch_constrained.py)."""
    _jc, pc = _cells("selector")
    dra = pc.S.make_pod("dra-0", cpu=0.5)
    dra.spec.resource_claims = ["gpu-claim"]
    pods, specs = T.prefix_scenarios(pc.cands, 2, pc.pending + [dra])
    nodes = [x.clone() for x in pc.cluster.nodes]
    with pytest.raises(UnsupportedProblem, match="DRA"):
        pc.scheduler().whatif_batch(pods, nodes, None, specs, pc.factory)


@pytest.mark.parametrize("k", [1, 3])
def test_solve_with_topology_from_bound_pods(k):
    """solve(topology=...) of a sequential consolidation confirm: the
    pending and displaced pods of the first k candidates against the
    surviving nodes, with the topology seeded from their bound pods; the
    whole result equals TPUScheduler.solve(topology=...)'s, and so does
    the confirm's signal."""
    views, signals = [], []
    for cell in _cells("topology"):
        excluded = {c.name for c in cell.cands[:k]}
        pods = list(cell.pending) + [p for c in cell.cands[:k] for p in c.reschedulable_pods]
        survivors = [x.clone() for x in cell.cluster.nodes if x.name not in excluded]
        result = cell.scheduler().solve(pods, survivors, None, topology=cell.factory(pods, excluded))
        views.append(_view(result))
        signals.append(cell.confirm(k))
    assert views[0] == views[1]
    assert signals[0] == signals[1]
    assert views[1]["existing"], "no pod landed on a surviving node"


def emulate_whatif(state, xs, ctx, pod_idx, valid, exist_valid):
    """csrc/perpod_scan.cu's scenario mode on the CPU: the plain step for
    every step of every scenario, written back into the stacked carry in
    place, as the kernel writes it."""
    S, L = pod_idx.shape
    out = torch.full((S, L), -1, dtype=torch.int32)
    for s in range(S):
        c = ctx._replace(exist=ctx.exist._replace(valid=exist_valid[s]))
        for i in range(L):
            view = p_solver.scenario_state(state, s)
            x = p_solver._take_x(xs, int(pod_idx[s, i]))._replace(valid=valid[s, i])
            new, a = p_solver._pod_step(view, x, c)
            for f in p_solver.PERPOD_WRITES:
                for dst, src in zip(*(
                    (v if isinstance(v, tuple) else (v,)) for v in (getattr(view, f), getattr(new, f))
                )):
                    dst.copy_(src)
            out[s, i] = a
    return out


def test_whatif_kernel_path_composes(monkeypatch):
    """solve_whatif's kernel path (a stacked carry, one scenario-mode call,
    per-scenario views) with the C call validated by the launcher and then
    emulated by the plain step, against the plain path: equal assignments
    and final carries for every scenario."""
    jc, _pc = _cells("topology")
    _sig, a, kw, _out, _vocab = _capture_whatif(jc, [jc.cands[:k] for k in range(1, 4)])
    conv, common = _to_port(a, kw)
    calls = []
    real = p_cuda.perpod_whatif

    def checked(state, xs, ctx, pod_idx, valid, exist_valid):
        monkeypatch.setattr(p_cuda, "_invoke", lambda source, entry, *args: calls.append(entry))
        real(state, xs, ctx, pod_idx, valid, exist_valid)
        return emulate_whatif(state, xs, ctx, pod_idx, valid, exist_valid)

    monkeypatch.setattr(p_cuda, "perpod_whatif", checked)
    idx, active, _count, ev, vg0, hg0, pods, tol, it_allow, exist_ok, ports, conf, vols, exist, it, tm, wk, tt, ptopo = conv
    xs = p_solver.pod_xs(pods, tol, it_allow, exist_ok, ports, conf, vols, ptopo)
    ctx = p_solver.PerPodCtx(exist, it, tm, wk, tt, **common)
    st0 = p_solver.initial_state(exist, it, tm, tt, common["n_claims"], ports.shape[1], topo_kids=common["topo_kids"])
    valid = pods.valid[idx.long()] & active
    args = (st0, xs, ctx, idx.long(), valid, ev, vg0, hg0)
    ak, sk = p_solver.whatif_loop_kernels(*args)
    ap, sp = p_solver.whatif_loop_plain(*args)
    assert calls == ["perpod_steps"]
    assert torch.equal(ak, ap) and (ak >= 0).any()
    for s, (x, y) in enumerate(zip(sk, sp)):
        fx, fy = p_solver.to_numpy(x), p_solver.to_numpy(y)
        assert all(np.array_equal(fx[k], fy[k]) for k in fx), s


def test_whatif_launcher_passes_the_parameter_block(monkeypatch):
    """The scenario-mode launch with the C entry stubbed: the single-
    scenario block's 83 pointers, each scenario field stacked on a leading
    S axis and pod_idx set, each pointer's byte stride per scenario (the
    stacked fields' row stride, 0 for the shared tables; the reservation
    capacities and held rows among the stacked), the 29 dims with
    L = steps per scenario, S blocks, the packed type tables, steps [0, L)
    in one launch, counted once; a launch of steps [2, 5) alone; with S = 1
    the block is the single-scenario block (pod_idx aside) with every
    stride 0."""
    jc, _pc = _cells("topology")
    seen = []

    def read(p, n):
        return list((ctypes.c_int64 * n).from_address(p.value))

    def fake(source, entry, ptrs, n_ptrs, dims, strides, S, tables, offsets, lo, hi):
        end = read(offsets, len(p_cuda.TABLES) + 1)[-1]
        seen.append((entry, read(ptrs, n_ptrs), read(dims, 29), read(strides, n_ptrs), S,
                     bytes((ctypes.c_uint8 * end).from_address(tables)), lo, hi))

    _sig, a, kw, _out, _vocab = _capture_whatif(jc, [jc.cands[:k] for k in range(1, 4)])
    conv, common = _to_port(a, kw)
    idx, active, _count, ev, vg0, hg0, pods, tol, it_allow, exist_ok, ports, conf, vols, exist, it, tm, wk, tt, ptopo = conv
    xs = p_solver.pod_xs(pods, tol, it_allow, exist_ok, ports, conf, vols, ptopo)
    ctx = p_solver.PerPodCtx(exist, it, tm, wk, tt, **common)
    st0 = p_solver.initial_state(exist, it, tm, tt, common["n_claims"], ports.shape[1], topo_kids=common["topo_kids"])
    S, L = idx.shape
    stacked = p_solver.stack_scenarios(st0, S, vg0, hg0)
    valid = pods.valid[idx.long()] & active
    monkeypatch.setattr(p_cuda, "_invoke", fake)
    p_cuda.reset_launches()
    assignment = p_cuda.perpod_whatif(stacked, xs, ctx, idx, valid, ev)
    (entry, ptrs, dims, strides, s_got, tables, lo, hi), = seen
    assert (entry, s_got, lo, hi) == ("perpod_steps", S, 0, L) and assignment.shape == (S, L)
    assert tables == p_cuda.perpod_tables(it, tm.its, tm.mv_it_values)[0].numpy().tobytes()
    row_max = torch.empty(stacked.used.shape)
    fields, want_strides, want_dims = p_cuda._whatif_fields(stacked, xs, ctx, row_max, assignment, idx, valid, ev)
    assert len(fields) == len(ptrs) == len(strides) == 83 and strides == want_strides
    assert fields[-1][0] == "pod_idx" and ptrs[-1] == idx.data_ptr()
    scen = set(p_cuda._scenario_tensors(stacked, row_max, assignment, idx, valid, ev))
    # every field the step writes has a stride: none shares one carry across the blocks
    assert {f"{f}.mask" if f.endswith("reqs") else f for f in p_solver.PERPOD_WRITES} <= scen
    for (name, t, _dt, shape), got, stride in zip(fields, ptrs, strides):
        # t_order: null, no placement objective's rank (shared, stride 0)
        assert got == (0 if t is None else t.data_ptr()) or name == "row_max", name
        stacked_field = name in scen
        assert stride == (t.stride(0) * t.element_size() if stacked_field else 0), name
        assert shape[0] == S if stacked_field else True
    assert ptrs[[f[0] for f in fields].index("t_order")] == 0
    E, W, G = exist.avail.shape[0], stacked.open.shape[1], tm.its.shape[0]
    assert dims == want_dims and dims[:3] == [E, W, G] and dims[17] == L
    assert strides[[f[0] for f in fields].index("vg_counts")] == vg0[0].numel() * 4
    assert p_cuda.LAUNCHES["perpod_scan_persistent_whatif"] == 1 and p_cuda.LAUNCHES["perpod_scan_persistent"] == 0
    # steps [2, 5) alone, into the caller's buffer
    seen.clear()
    assert p_cuda.perpod_whatif_steps(stacked, xs, ctx, idx, valid, ev, 2, 5, assignment) is assignment
    assert [(e[0], e[6], e[7]) for e in seen] == [("perpod_steps", 2, 5)]
    # S = 1: the single-scenario block of scenario 0, strides 0
    one = p_solver.stack_scenarios(st0, 1, vg0[:1], hg0[:1])
    xs0 = p_solver._take_x(xs, idx[0].long())._replace(valid=valid[0])
    seen.clear()
    a1 = p_cuda.perpod_whatif(one, xs, ctx, idx[:1], valid[:1], ev[:1])
    (_e, ptrs1, dims1, strides1, s1, _t, _lo, _hi), = seen
    assert s1 == 1 and set(strides1) == {0}
    ctx0 = ctx._replace(exist=exist._replace(valid=ev[0]))
    chunk_fields, chunk_dims = p_cuda._perpod_fields(p_solver.scenario_state(one, 0), xs0, ctx0, row_max[0], a1[0])
    assert dims1 == chunk_dims
    for (name, t, _dt, _shape), got in zip(chunk_fields, ptrs1):
        # the carry is the same tensors, one scenario deep
        if name in scen and name not in ("pod_idx", "row_max"):
            assert got == {"valid": valid, "exist.valid": ev}.get(name, t).data_ptr(), name
    # what the launcher refuses: a pod row index past the union, a wrong dtype, steps past L
    with pytest.raises(ValueError, match="pod_idx"):
        p_cuda.perpod_whatif(stacked, xs, ctx, idx + pods.valid.shape[0], valid, ev)
    with pytest.raises(ValueError, match="dtype"):
        p_cuda.perpod_whatif(stacked, xs, ctx, idx, valid.to(torch.int32), ev)
    with pytest.raises(ValueError, match="steps"):
        p_cuda.perpod_whatif_steps(stacked, xs, ctx, idx, valid, ev, 0, L + 1)


def test_open_rows_are_a_prefix_in_whatifs(monkeypatch):
    """The per-pod kernel scans window rows [0, w_open) only: in every
    step of a what-if batch's plain path the open rows are that prefix."""
    _jc, pc = _cells("topology")
    real = p_solver._pod_step
    seen = []

    def checked(state, x, c):
        out = real(state, x, c)
        for st in (state, out[0]):
            W = st.open.shape[0]
            assert torch.equal(st.open, torch.arange(W) < int(st.w_open))
        seen.append(int(out[0].w_open))
        return out

    monkeypatch.setattr(p_solver, "_pod_step", checked)
    pods, specs = T.prefix_scenarios(pc.cands, 4, pc.pending)
    sig = pc.scheduler().whatif_batch(pods, [x.clone() for x in pc.cluster.nodes], None, specs, pc.factory)
    assert sig is not None and seen and max(seen) > 0


def chip_goldens() -> dict:
    """The JAX package's signals on the chip cells, with wall times."""
    t0 = time.perf_counter()
    cell = Cell("jax", CHIP_PODS, CHIP_TYPES, CHIP_PENDING)
    out = dict(
        nodes=len(cell.cluster.nodes), bound=sum(len(v) for v in cell.cluster.bound.values()),
        cluster_digest=T.cluster_digest(cell.cluster), cluster_s=time.perf_counter() - t0,
    )
    for kind in ("single", "prefix"):
        t1 = time.perf_counter()
        sched = cell.scheduler()
        sig, calls = _spying(lambda: cell.whatif(kind, CHIP_CANDS, sched))
        wall = time.perf_counter() - t1
        (a, kw, _out), = calls
        t1 = time.perf_counter()
        placements = _placements_digest(_reference_per_scenario(a, kw, CHIP_CANDS), a, sched.encoder.vocab)
        out[f"{kind}{CHIP_CANDS}"] = dict(
            signals=[[bool(f), int(n)] for f, n in sig], digest=T.signals_digest(sig), wall_s=wall,
            placements_digest=placements, placements_s=time.perf_counter() - t1,
        )
        print(json.dumps({kind: out[f"{kind}{CHIP_CANDS}"]}), flush=True)
    for k in CONFIRM_PREFIXES:
        t1 = time.perf_counter()
        f, n = cell.confirm(k)
        out[f"confirm{k}"] = dict(signal=[bool(f), int(n)], wall_s=time.perf_counter() - t1)
        print(json.dumps({f"confirm{k}": out[f"confirm{k}"]}), flush=True)
    return out


if __name__ == "__main__":
    import resource

    g = chip_goldens()
    g["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(g))
