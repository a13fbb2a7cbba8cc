"""Gangs in the port against the JAX package: the gang contract
(karpenter_tpu_torch.gang against karpenter_tpu.gang on the same pods),
the plain solve_gang leaf for leaf against the jitted reference solve_gang
on the same encoded inputs (no key, a zone key with its bank rows,
hostname spread, a finite cpu budget, a tight nodes budget, a claims axis
too small for the slice, a whale no type hosts, padded segments, and the
one rounding of a host's usage), TorchScheduler.solve against
TPUScheduler.solve end to end (claims with their slice keys, per-pod
placement, unschedulable pods with their reasons in order, price) on the
reference's gang cases, UnsupportedProblem exactly where the reference
hands the solve to its host oracle, and whatif_batch's None on gang pods.
Tolerance: exact equality everywhere.

    python tests/test_torch_gang.py   # the gang chip cells' goldens (JAX, CPU)

prints the JAX package's goldens for chip_smoke.py's gang cells."""

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
from karpenter_tpu import gang as j_gang  # noqa: E402
from karpenter_tpu.cloudprovider import fake as j_fake  # noqa: E402
from karpenter_tpu.controllers.provisioning import TPUScheduler  # noqa: E402
from karpenter_tpu.controllers.provisioning import build_templates as j_build_templates  # noqa: E402
from karpenter_tpu.controllers.provisioning import scheduler as j_sched  # noqa: E402
from karpenter_tpu.models import labels as jl  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.models.nodepool import NodePool as JNodePool  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu.utils import metrics as j_metrics  # noqa: E402
from karpenter_tpu_torch import gang as p_gang  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler, UnsupportedProblem  # noqa: E402
from karpenter_tpu_torch.models import pod as p_pod  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors  # noqa: E402
from karpenter_tpu_torch.ops.topology import TopologyTensors  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JAX = types.SimpleNamespace(
    make_pod=j_pod.make_pod, l=jl, make_gang_pods=j_gang.make_gang_pods, TopologySpreadConstraint=j_pod.TopologySpreadConstraint,
    PodAffinityTerm=j_pod.PodAffinityTerm, HostPort=j_pod.HostPort, NodeAffinity=j_pod.NodeAffinity,
    NodeSelectorTerm=j_pod.NodeSelectorTerm, zonal_pods=bench.zonal_pods, mixed_pods=bench.mixed_pods,
    make_templates=bench.make_templates, fake=j_fake, NodePool=JNodePool, build_templates=j_build_templates,
    gang=j_gang, sched=TPUScheduler, kw={},
)
PORT = types.SimpleNamespace(
    **{**vars(T.PORT), "PodAffinityTerm": p_pod.PodAffinityTerm, "NodeAffinity": p_pod.NodeAffinity,
       "NodeSelectorTerm": p_pod.NodeSelectorTerm, "mixed_pods": T.mixed_pods, "zonal_pods": T.zonal_pods,
       "make_templates": T.make_templates,
       "gang": p_gang, "sched": TorchScheduler, "kw": {"device": "cpu"}},
)
SIDES = (JAX, PORT)
ZONE, HOST = jl.LABEL_TOPOLOGY_ZONE, jl.LABEL_HOSTNAME

# the chip cells (chip_smoke.py): gang_storm_64x16x400 and
# gang_zonal_budget_4096x400
STORM = dict(n_gangs=64, size=16, singles=2048, types=400, max_claims=2048)
ZONAL = dict(types=400, max_claims=4096)


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
    """Everything a caller reads of a SchedulingResult, keyed by pod NAME:
    claims with their slice key, pods, viable types, usage, requirements
    and host ports; the placements; the unschedulable pods with their
    reasons, in order; node count and price."""
    name_of = {}
    for c in result.claims:
        for p in c.pods:
            name_of[p.uid] = p.name
    return dict(
        claims=[
            (c.slot, c.hostname, c.gang, [p.name for p in c.pods], [i.name for i in c.instance_types],
             sorted(c.used.items()), str(c.requirements), sorted(c.host_ports))
            for c in result.claims
        ],
        assignments=sorted((name_of[u], s) for u, s in result.assignments.items()),
        unschedulable=[(p.name, r) for p, r in result.unschedulable],
        node_count=result.node_count,
        total_price=result.total_price(),
    )


def _both(build, n_types=16, max_claims=128, budgets=None):
    """build(S) -> pods on both sides; both views, which must be equal.
    Returns the port's result."""
    out = []
    for S in SIDES:
        sched = S.sched(S.make_templates(n_types), max_claims=max_claims, **S.kw)
        out.append(sched.solve(build(S), budgets=budgets))
    vj, vp = view(out[0]), view(out[1])
    for k in vj:
        assert vj[k] == vp[k], k
    return out[1]


def assert_slices(result, key, size):
    """The gang's claims are dedicated, hold contiguous rank blocks in slot
    order and cover every rank once."""
    ranks = []
    for c in sorted((c for c in result.claims if c.gang == key), key=lambda c: c.slot):
        got = [p_gang.gang_of(p) for p in c.pods]
        assert all(g is not None and g[0] == key for g in got)
        ranks += [g[2] for g in got]
    assert ranks == list(range(size))


# ---------------------------------------------------------------------------
# the gang contract
# ---------------------------------------------------------------------------


def _contract_pods(S):
    dup = S.make_gang_pods("dup", 2, cpu=0.5)
    dup[1].metadata.annotations[S.gang.GANG_RANK_ANNOTATION] = "0"
    hetero = S.make_gang_pods("hetero", 2, cpu=0.5)
    hetero[1].spec.requests["cpu"] = 1.5
    clash = S.make_gang_pods("clash", 2)
    clash[1].metadata.annotations[S.gang.GANG_SIZE_ANNOTATION] = "3"
    bad = S.make_gang_pods("bad", 2)
    bad[0].metadata.annotations[S.gang.GANG_RANK_ANNOTATION] = "x"
    bad[1].metadata.annotations[S.gang.GANG_RANK_ANNOTATION] = "2"
    other = S.make_gang_pods("other", 3, cpu=0.5, namespace="team-b")
    return (S.make_gang_pods("small", 2, cpu=0.5) + dup + [S.make_pod("s-0")] + hetero + clash + bad
            + S.make_gang_pods("big", 4, cpu=2.0) + other[:2] + S.make_gang_pods("tie", 4, cpu=2.0) + [S.make_pod("s-1")])


def test_gang_contract_matches_reference():
    """gang_of, collect_gangs (with its invalid reasons), order_gangs and
    partially_bound_gangs name the same gangs, pods and reasons."""
    out = []
    for S in SIDES:
        pods = _contract_pods(S)
        gangs, singles, invalid = S.gang.collect_gangs(pods)
        pods[4].spec.node_name = "node-a"  # one bound member of "hetero"
        out.append(dict(
            parsed=[S.gang.gang_of(p) for p in pods],
            is_gang=[S.gang.is_gang_pod(p) for p in pods],
            gangs=[(g.key, g.size, g.first_index, g.complete, g.missing, [p.name for p in g.pods_in_rank_order()])
                   for g in gangs],
            singles=[p.name for p in singles],
            invalid=[(p.name, r) for p, r in invalid],
            order=[g.key for g in S.gang.order_gangs(gangs)],
            partial=S.gang.partially_bound_gangs(pods),
        ))
    assert out[0] == out[1]
    assert ("dup-1", f"{j_gang.GANG_INVALID_REASON}: duplicate rank 0") in out[1]["invalid"]
    for name in ("GANG_NAME_ANNOTATION", "GANG_SIZE_ANNOTATION", "GANG_RANK_ANNOTATION", "GANG_CLAIM_ANNOTATION",
                 "GANG_SPILL_REASON", "GANG_INVALID_REASON", "GANG_WAITING_REASON"):
        assert getattr(p_gang, name) == getattr(j_gang, name)


# ---------------------------------------------------------------------------
# the plain solve_gang against the jitted reference
# ---------------------------------------------------------------------------


def _tonp(x):
    return jax.tree.map(np.asarray, x)


def _assert_leaves_equal(jx, px, what):
    a = {}
    for f in jx._fields:
        v = getattr(jx, f)
        if v is None:
            continue
        if hasattr(v, "_fields"):
            a.update({f"{f}.{g}": np.asarray(getattr(v, g)) for g in v._fields})
        else:
            a[f] = np.asarray(v)
    b = p_solver.to_numpy(px)
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        x = a[k].view(np.int32) if a[k].dtype == np.uint32 else a[k]
        assert x.shape == b[k].shape and x.dtype == b[k].dtype, (what, k, x.shape, b[k].shape)
        assert np.array_equal(x, b[k]), (what, k)


class _Problem:
    """One gang problem encoded by the reference, carried onto the port."""

    def __init__(self, pods, n_types=40, max_claims=64, budgets=None, daemon_cpu=None):
        js = self.js = TPUScheduler(bench.make_templates(n_types), max_claims=max_claims)
        _sorted, enc = js._encode(pods, None, budgets)
        self.enc = enc
        tt = enc["template_tensors"]
        if daemon_cpu is not None:
            d = np.array(tt.daemon_requests)
            d[:, js.encoder.resource_names.index("cpu")] = np.float32(daemon_cpu)
            tt = tt._replace(daemon_requests=jnp.asarray(d))
        self.j_args = (enc["exist_tensors"], js.it_tensors, tt, js.well_known, enc["topo_tensors"])
        self.p_args = (
            p_solver.from_numpy(p_solver.ExistingNodes, _tonp(enc["exist_tensors"]), "cpu"),
            p_solver.from_numpy(InstanceTypeTensors, _tonp(js.it_tensors), "cpu"),
            p_solver.from_numpy(p_solver.Templates, _tonp(tt), "cpu"),
            torch.from_numpy(np.array(js.well_known)),
            p_solver.from_numpy(TopologyTensors, _tonp(enc["topo_tensors"]), "cpu"),
        )
        st = j_solver.initial_state(
            enc["exist_tensors"], js.it_tensors, tt, enc["topo_tensors"], enc["n_claims"],
            int(enc["ports_k"].shape[1]), js._res_cap0, window=enc["window"], topo_kids=enc["topo_kids"],
        )
        self.jst, self.pst = st, p_solver.from_numpy(p_solver.SolverState, _tonp(st), "cpu")
        _assert_leaves_equal(self.jst, self.pst, "initial_state")

    def gang_runs(self):
        """Maximal runs of gang segments, per unified key."""
        enc = self.enc
        runs = []
        for seg in enc["segments"]:
            if not enc["gang_kind"][seg[2]]:
                continue
            key = int(enc["gang_vg_key"][seg[2]])
            if runs and runs[-1][0] == key:
                runs[-1][1].append(seg)
            else:
                runs.append((key, [seg]))
        return runs

    def run(self, key, segs, pad=0):
        """One gang run on both sides (with `pad` count-0 segments); the
        records and the carry must be equal."""
        enc = self.enc
        segs = list(segs) + [(0, 0, segs[0][2])] * pad
        kinds = jnp.asarray([s[2] for s in segs])
        counts = jnp.asarray([s[1] - s[0] for s in segs], dtype=jnp.int32)
        jxs = j_sched._gather_kind_xs(
            enc["reqs_k"], enc["strict_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"],
            enc["exist_ok_k"], enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"], kinds, counts,
        )
        pxs = p_solver.from_numpy(p_solver.KindXs, _tonp(jxs), "cpu")
        maxg = max(8, -(-max(s[1] - s[0] for s in segs) // 8) * 8)
        kw = dict(key_kid=-1, n_domains=1, tk_idx=-1)
        if key >= 0:
            kw = dict(key_kid=key, n_domains=len(self.js.encoder.vocab.values[key]),
                      tk_idx=enc["topo_kids"].index(key))
        self.jst, jys = j_solver.solve_gang(
            self.jst, jxs, *self.j_args, zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"], n_claims=enc["n_claims"],
            maxg=maxg, **kw,
        )
        self.pst, pys = p_solver.solve_gang(
            self.pst, pxs, *self.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"], maxg, **kw,
        )
        _assert_leaves_equal(jys, pys, f"ys {segs}")
        _assert_leaves_equal(self.jst, self.pst, f"state after {segs}")
        return jys

    def run_all(self, pad=0):
        return [(key, self.run(key, segs, pad)) for key, segs in self.gang_runs()]


def _statuses(records) -> set:
    return {int(s) for _k, ys in records for s, c in zip(np.asarray(ys.status), np.asarray(ys.leftover)) if c}


def _spread(S, name, size, cpu, key, sel):
    return T.spread_gang(name, size, cpu, key, sel, side=S)


def _port_gang(S, name, size):
    """A gang whose members bind one host port: one member a host."""
    pods = S.make_gang_pods(name, size, cpu=0.5)
    for p in pods:
        p.spec.host_ports = [S.HostPort(port=8443)]
    return pods


def _zone_anti_gang(S, name, size):
    """One member a host (a host port), hosts in pairwise different zones
    (zone anti-affinity on the gang's own label): past the zones' count a
    rank block is refused and the whole gang spills."""
    pods = _port_gang(S, name, size)
    for p in pods:
        p.metadata.labels = dict(p.metadata.labels or {}, anti=name)
        p.spec.pod_anti_affinity = [S.PodAffinityTerm(topology_key=S.l.LABEL_TOPOLOGY_ZONE,
                                                      label_selector={"anti": name})]
    return pods


LEAF_CASES = {
    # name: (build(side) -> pods, kwargs of _Problem, status every unplaced gang shows, a key run)
    "no_key": (lambda S: S.make_gang_pods("a", 8, cpu=1.5) + S.make_gang_pods("b", 5, cpu=0.5)
               + T.pending_pods(10, 0, S, "p"), {}, set(), False),
    "zone_key": (lambda S: _spread(S, "gz", 6, 1.0, ZONE, "gz") + _spread(S, "gy", 9, 2.0, ZONE, "gy")
                 + S.zonal_pods(12, kinds=2), {}, set(), True),
    "hostname_spread": (lambda S: _spread(S, "gh", 4, 1.0, HOST, "gh") + _spread(S, "gi", 6, 3.0, HOST, "gi")
                        + T.pending_pods(6, 0, S, "p"), {}, set(), False),
    "cpu_budget": (lambda S: _spread(S, "gzb", 6, 1.0, ZONE, "gzb") + S.make_gang_pods("gb", 12, cpu=2.0)
                   + S.make_gang_pods("gc", 8, cpu=3.0),
                   dict(budgets={"default": {"cpu": 48.0}}), {p_solver.NO_CLAIM}, True),
    "zone_anti_affinity_spills": (lambda S: _zone_anti_gang(S, "gx", 6) + S.make_gang_pods("gy", 2, cpu=1.0), {},
                                  {p_solver.GANG_SPILL}, True),
    "nodes_budget": (lambda S: S.make_gang_pods("gt", 4, cpu=6.0) + S.make_gang_pods("gu", 2, cpu=0.25),
                     dict(budgets={"default": {"nodes": 1.0}}), {p_solver.GANG_SPILL}, False),
    "claims_axis": (lambda S: _port_gang(S, "gw", 8) + S.make_gang_pods("gv", 3, cpu=0.5),
                    dict(max_claims=4), {p_solver.NO_ROOM}, False),
    "whale": (lambda S: S.make_gang_pods("whale", 4, cpu=10000.0) + S.make_gang_pods("ok", 4, cpu=1.0), {},
              {p_solver.NO_CLAIM}, False),
}


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_solve_gang_leaf_for_leaf(case, pad):
    """Every gang run of the problem on both sides, in order: the records
    and every carry leaf equal the jitted reference's, with and without
    count-0 padding segments."""
    build, kw, statuses, keyed = LEAF_CASES[case]
    prob = _Problem(build(JAX), **kw)
    records = prob.run_all(pad)
    assert records and any(k >= 0 for k, _ys in records) == keyed
    assert _statuses(records) == statuses


def test_one_rounding_of_a_host_usage():
    """A slice host's usage daemon + c_j * req rounds once, as the
    reference's compiled step computes it: with 2.1000001 cpu of daemons
    and 6 pods of 0.1 the host holds 2.7 (two roundings give 2.7000003)."""
    u, q = np.float32(2.1000001), np.float32(0.1)
    assert np.float32(u + np.float32(np.float32(6) * q)) != np.float32(np.float64(u) + 6 * np.float64(q))
    prob = _Problem(JAX.make_gang_pods("r", 6, cpu=0.1), daemon_cpu=u)
    (_key, ys), = prob.run_all()
    assert int(ys.fill[0]) >= 6
    cpu = prob.js.encoder.resource_names.index("cpu")
    assert prob.pst.bank_used[0, cpu].item() == np.float32(np.float64(u) + 6 * np.float64(q))


# ---------------------------------------------------------------------------
# TorchScheduler.solve against TPUScheduler.solve
# ---------------------------------------------------------------------------

E2E = {
    # name: (build(side) -> pods, n_types, max_claims, budgets, [(gang key, size)] to hold to their slices)
    "gang_with_fill_singles": (lambda S: S.make_gang_pods("train-a", 8, cpu=1.5) + T.pending_pods(24, 0, S, "p"),
                               16, 128, None, [("default/train-a", 8)]),
    "several_gangs_largest_first": (
        lambda S: (S.make_gang_pods("small", 2, cpu=0.5) + [S.make_pod(f"s-{i}", cpu=0.5) for i in range(12)]
                   + S.make_gang_pods("big", 6, cpu=1.5) + S.make_gang_pods("mid", 4, cpu=1.0)),
        16, 128, None, [("default/small", 2), ("default/big", 6), ("default/mid", 4)]),
    "gang_with_kscan_singles": (lambda S: S.make_gang_pods("train-k", 6, cpu=1.2) + S.mixed_pods(30),
                                24, 128, None, [("default/train-k", 6)]),
    "small_claims_axis_escalates": (
        lambda S: S.make_gang_pods("train-w", 8, cpu=1.5) + [S.make_pod(f"w-{i}", cpu=0.5) for i in range(8)],
        16, 4, None, [("default/train-w", 8)]),
    "zone_anti_affinity_spills": (lambda S: _zone_anti_gang(S, "gx", 6) + [S.make_pod(f"x-{i}", cpu=0.5) for i in range(4)],
                                  16, 128, None, []),
    "zonal_spread": (lambda S: _spread(S, "gz", 6, 1.0, ZONE, "gz") + [S.make_pod(f"gzs-{i}", cpu=0.5) for i in range(8)],
                     16, 128, None, [("default/gz", 6)]),
    "hostname_spread": (
        lambda S: _spread(S, "gh", 4, 1.0, HOST, "gh") + [S.make_pod(f"ghs-{i}", cpu=0.5) for i in range(6)],
        16, 128, None, [("default/gh", 4)]),
    "cpu_budget": (lambda S: S.make_gang_pods("gb", 4, cpu=1.0) + [S.make_pod(f"gbs-{i}", cpu=0.5) for i in range(8)],
                   16, 128, {"default": {"cpu": 64.0}}, [("default/gb", 4)]),
    "tight_nodes_budget": (
        lambda S: S.make_gang_pods("gt", 4, cpu=6.0) + [S.make_pod(f"gts-{i}", cpu=0.25) for i in range(4)],
        16, 128, {"default": {"nodes": 1.0}}, []),
    "zonal_under_budget": (
        lambda S: _spread(S, "gzb", 6, 1.0, ZONE, "gzb") + [S.make_pod(f"gzbs-{i}", cpu=0.5) for i in range(6)],
        16, 128, {"default": {"cpu": 48.0}}, [("default/gzb", 6)]),
    "unplaceable_fails_together": (
        lambda S: S.make_gang_pods("huge", 4, cpu=10000.0) + [S.make_pod(f"ok-{i}", cpu=0.5) for i in range(6)],
        16, 128, None, []),
    "incomplete_held_out": (
        lambda S: S.make_gang_pods("partial", 4, cpu=1.0)[:2] + [S.make_pod(f"ok-{i}", cpu=0.5) for i in range(4)],
        16, 128, None, []),
    "invalid_surface": (lambda S: _contract_pods(S)[:9] + [S.make_pod("ok-0", cpu=0.5)], 16, 128, None, []),
    "no_singleton_on_slice_headroom": (
        lambda S: S.make_gang_pods("lone", 3, cpu=0.5) + [S.make_pod(f"bf-{i}", cpu=0.5) for i in range(6)],
        16, 128, None, [("default/lone", 3)]),
    "gang_storm_small": (lambda S: T.gang_storm_pods(6, 4, 40, side=S), 24, 128, None,
                         [(f"default/storm-{i}", 4) for i in range(6)]),
    "gang_zonal_budget_small": (lambda S: T.gang_zonal_pods(4, 4, 2, 3, 40, 2, side=S), 24, 128,
                                {"default": {"cpu": 90.0}}, []),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_solve_matches_reference(case):
    """The whole solve: the same claims (slice keys included), placements,
    unschedulable pods and reasons in order, and price."""
    build, n_types, max_claims, budgets, slices = E2E[case]
    result = _both(build, n_types, max_claims, budgets)
    for key, size in slices:
        assert_slices(result, key, size)
    for c in result.claims:
        if c.gang:
            assert all(p_gang.gang_of(p) is not None for p in c.pods)
    # a gang the solve refused fails whole, with one reason
    by_gang: dict = {}
    for p, r in result.unschedulable:
        g = p_gang.gang_of(p)
        if g is not None and not r.startswith((p_gang.GANG_INVALID_REASON, p_gang.GANG_WAITING_REASON)):
            by_gang.setdefault(g[0], []).append(r)
    for key, reasons in by_gang.items():
        assert len(set(reasons)) == 1, (key, reasons)


def test_gang_dispatches_count_every_round(monkeypatch):
    """last_stats["gang_dispatches_all"] counts the gang runs of every
    re-solve (a claims axis too small for the slice escalates and solves
    again), each run padded to a bucket of 8 segments; chip_smoke.py holds
    gang_scan's launches equal to it."""
    runs = []
    real = p_solver.solve_gang

    def counting(state, xs, *args, **kwargs):
        runs.append(int(xs.count.shape[0]))
        return real(state, xs, *args, **kwargs)

    monkeypatch.setattr(p_solver, "solve_gang", counting)
    sched = TorchScheduler(T.make_templates(16), max_claims=4, device="cpu")
    result = sched.solve(T.make_gang_pods("train-w", 8, cpu=1.5) + T.selector_pods(8))
    st = sched.last_stats
    assert st["gang_dispatches_all"] == len(runs) > st["gang_dispatches"] == 1
    assert all(b % 8 == 0 for b in runs)
    assert_slices(result, "default/train-w", 8)


# ---------------------------------------------------------------------------
# UnsupportedProblem exactly where the reference goes to its host oracle
# ---------------------------------------------------------------------------


def _anti_gang(S):
    pods = S.make_gang_pods("ga", 3, cpu=1.0)
    for p in pods:
        p.metadata.labels = {"app": "ga"}
        p.spec.pod_anti_affinity = [S.PodAffinityTerm(topology_key=S.l.LABEL_HOSTNAME, label_selector={"app": "ga"})]
    return pods


def _two_key_gang(S):
    pods = S.make_gang_pods("g2", 4, cpu=1.0)
    for p in pods:
        p.metadata.labels = {"spread": "g2"}
        p.spec.topology_spread_constraints = [
            S.TopologySpreadConstraint(max_skew=1, topology_key=k, label_selector={"spread": "g2"})
            for k in (S.l.LABEL_TOPOLOGY_ZONE, S.l.CAPACITY_TYPE_LABEL_KEY)
        ]
    return pods


def _wide_key_gang(S):
    away = S.make_pod("away-0", cpu=0.5)
    away.spec.node_affinity = S.NodeAffinity(required=[S.NodeSelectorTerm(match_expressions=[
        {"key": S.l.LABEL_TOPOLOGY_ZONE, "operator": "NotIn", "values": [f"extra-zone-{i}" for i in range(13)]}])])
    return _spread(S, "gw", 4, 1.0, S.l.LABEL_TOPOLOGY_ZONE, "gw") + [away]


def _mv_templates(S, n):
    return T.constrained_templates(n, reservations={}, side=S)


def _res_templates(S, n):
    return T.constrained_templates(n, min_values=(), side=S)


HOST_ROUTED = {
    # name: (build(side) -> pods, templates(side, n) or None, the reference's reason)
    "enforced_min_values": (lambda S: S.make_gang_pods("gm", 2, cpu=1.0), _mv_templates,
                            "gang under enforced minValues"),
    "reservations": (lambda S: S.make_gang_pods("gr", 2, cpu=1.0), _res_templates, "gang under reservations"),
    "two_vg_keys": (_two_key_gang, None, "gang vg groups span multiple vocab keys"),
    "key_wider_than_kscan_d": (_wide_key_gang, None, "gang vg key wider than KSCAN_D"),
    "hostname_anti_affinity": (_anti_gang, None, "gang hostname affinity/anti-affinity"),
    # controls: the device route, no fallback on either side
    "zonal_spread_control": (lambda S: _spread(S, "gc", 4, 1.0, S.l.LABEL_TOPOLOGY_ZONE, "gc"), None, None),
    "best_effort_min_values_control": (lambda S: S.make_gang_pods("ge", 2, cpu=1.0), _mv_templates, None),
}


@pytest.mark.parametrize("case", sorted(HOST_ROUTED))
def test_unsupported_exactly_where_reference_falls_back(case):
    """UnsupportedProblem (with the reference's reason) where the
    reference's SOLVER_FALLBACK{reason="gang_constraints"} counter rises on
    the same problem, and a result equal to the reference's where not."""
    build, templates, reason = HOST_ROUTED[case]
    n = 48
    mv = {"min_values_policy": "BestEffort"} if case.startswith("best_effort") else {}
    tj = templates(JAX, n) if templates else bench.make_templates(n)
    tp = templates(PORT, n) if templates else T.make_templates(n)
    before = j_metrics.SOLVER_FALLBACK.get(reason="gang_constraints")
    rj = TPUScheduler(tj, max_claims=64, **mv).solve(build(JAX))
    fell_back = j_metrics.SOLVER_FALLBACK.get(reason="gang_constraints") - before
    sched = TorchScheduler(tp, max_claims=64, device="cpu", **mv)
    if reason is None:
        assert fell_back == 0
        assert view(sched.solve(build(PORT))) == view(rj)
        return
    assert fell_back == 1
    with pytest.raises(UnsupportedProblem) as e:
        sched.solve(build(PORT))
    assert e.value.reason == reason


def test_whatif_batch_none_on_gang_pods():
    """whatif_batch returns None on a pod set holding a gang (the caller
    simulates its scenarios one by one), as the reference does."""
    node = T.existing_node()
    pods = T.make_gang_pods("wg", 2, cpu=0.5) + T.selector_pods(4)
    uids = {p.uid for p in pods}
    sched = TorchScheduler(T.make_templates(16), max_claims=32, device="cpu")

    def factory(pods_, _excluded):
        raise AssertionError("whatif_batch must return before building a topology")

    assert sched.whatif_batch(pods, [node], None, [(set(), uids, uids)], factory) is None
    jp = JAX.make_gang_pods("wg", 2, cpu=0.5) + bench.selector_pods(4)
    jnode = T.existing_node()
    from karpenter_tpu.controllers.provisioning.host_scheduler import ExistingSimNode as JNode
    from karpenter_tpu.scheduling import Requirements as JReqs

    jn = JNode(name=jnode.name, index=0, requirements=JReqs(), available=dict(jnode.available))
    ju = {p.uid for p in jp}
    assert TPUScheduler(bench.make_templates(16), max_claims=32).whatif_batch(
        jp, [jn], None, [(set(), ju, ju)], factory) is None


# ---------------------------------------------------------------------------
# goldens for chip_smoke.py
# ---------------------------------------------------------------------------


def _golden(result) -> dict:
    spilled: dict = {}
    for p, _r in result.unschedulable:
        g = j_gang.gang_of(p)
        key = g[0] if g else "singleton"
        spilled[key] = spilled.get(key, 0) + 1
    reasons: dict = {}
    for _p, r in result.unschedulable:
        reasons[r] = reasons.get(r, 0) + 1
    return dict(
        claims=len(result.claims), unschedulable=len(result.unschedulable), reasons=reasons, spilled=spilled,
        price=round(result.total_price(), 4), slice_hosts=sum(1 for c in result.claims if c.gang),
        slice_digest=T.slice_digest(result), result_digest=T.result_digest(result),
        launched_cpu=T.launched_cpu(result),
    )


def main() -> None:
    t0 = time.time()
    s = STORM
    pods = T.gang_storm_pods(s["n_gangs"], s["size"], s["singles"], side=JAX)
    r = TPUScheduler(bench.make_templates(s["types"]), max_claims=s["max_claims"]).solve(pods)
    print("gang_storm_64x16x400", _golden(r), f"{time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    pods = T.gang_zonal_pods(side=JAX)
    r = TPUScheduler(bench.make_templates(ZONAL["types"]), max_claims=ZONAL["max_claims"]).solve(pods)
    print("gang_zonal_no_limit (cpu limit = 0.75 x launched_cpu)", _golden(r), flush=True)
    pods = T.gang_zonal_pods(side=JAX)
    r = TPUScheduler(bench.make_templates(ZONAL["types"]), max_claims=ZONAL["max_claims"]).solve(
        pods, budgets={"default": {"cpu": T.GANG_ZONAL_CPU_LIMIT}})
    print("gang_zonal_budget_4096x400", _golden(r), f"{time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
