"""The port's per-pod scan (karpenter_tpu_torch.ops.solver solve_from /
_pod_step, the per-pod topology rules of ops/topology.py and the set
helpers of ops/kernels.py) against the JAX package's, on the same
inputs: seeded numpy for the rules and helpers; for solve_from the
reference TPUScheduler's own encode, carried onto the port with
from_numpy, every SolverState leaf and the assignment compared after
every chunk. Also the per-pod kernel's launcher and packed tables, lazy
tiers and the open-row prefix the kernel relies on. Tolerance: exact
equality everywhere."""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.controllers.provisioning import build_templates as j_build_templates
from karpenter_tpu.controllers.provisioning import scheduler as j_sched
from karpenter_tpu.controllers.provisioning.host_scheduler import ExistingSimNode
from karpenter_tpu.cloudprovider.fake import instance_types as j_instance_types
from karpenter_tpu.models import labels as l
from karpenter_tpu.models.nodepool import NodePool as JNodePool
from karpenter_tpu.models.pod import (
    NodeAffinity, NodeSelectorTerm, PodAffinityTerm, TopologySpreadConstraint, make_pod,
)
from karpenter_tpu.ops import encode as j_encode
from karpenter_tpu.ops import kernels as j_kernels
from karpenter_tpu.ops import solver as j_solver
from karpenter_tpu.ops import topology as j_topo
from karpenter_tpu.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.ops import solver as p_solver
from karpenter_tpu_torch.ops import topology as p_topo
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors, ReqSetTensors

TIER = "example.com/tier"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tonp(x):
    return jax.tree.map(np.asarray, x)


def _pt(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _flat(container) -> dict:
    out = {}
    for f in container._fields:
        v = getattr(container, f)
        if v is None:
            continue
        if hasattr(v, "_fields"):
            for g in v._fields:
                out[f"{f}.{g}"] = np.asarray(getattr(v, g))
        else:
            out[f] = np.asarray(v)
    return out


def _assert_leaves_equal(jx, px, what):
    a, b = _flat(jx), p_solver.to_numpy(px)
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in a:
        x, y = a[k], b[k]
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k, x.shape, y.shape, x.dtype, y.dtype)
        assert np.array_equal(x, y), (what, k)


# ---------------------------------------------------------------------------
# 1. per-pod topology rules on seeded counts and masks
# ---------------------------------------------------------------------------

K_R, V_R, NGV_R, C_R = 4, 8, 8, 12


def _random_topology(rng):
    """Groups over 4 keys with every type (spread / affinity / anti),
    minDomains on some, empty groups (the affinity bootstrap), one invalid
    padding group; ranks a permutation of each group's domains."""
    vg_key = rng.integers(0, K_R, NGV_R).astype(np.int32)
    vg_type = (np.arange(NGV_R) % 3).astype(np.int32)
    dom = rng.random((NGV_R, V_R)) < 0.7
    dom[:, 0] = True
    rank = np.full((NGV_R, V_R), 2**30, dtype=np.int32)
    for j in range(NGV_R):
        d = np.flatnonzero(dom[j])
        rank[j, d] = rng.permutation(len(d))
    counts = (rng.integers(0, 4, (NGV_R, V_R)) * dom).astype(np.int32)
    counts[1] = 0  # an empty affinity group
    counts[4, rng.integers(0, V_R)] = 0
    arrs = dict(
        vg_key=vg_key, vg_type=vg_type, vg_skew=rng.integers(1, 3, NGV_R).astype(np.int32),
        vg_min_domains=np.where(np.arange(NGV_R) % 4 == 0, rng.integers(2, 9, NGV_R), 0).astype(np.int32),
        vg_domains=dom, vg_counts0=counts, vg_rank=rank,
        vg_valid=np.arange(NGV_R) < NGV_R - 1,
        hg_type=np.zeros(1, np.int32), hg_skew=np.ones(1, np.int32), hg_counts0=np.zeros((1, 4), np.int32),
        hg_extra_nonempty=np.zeros(1, bool), hg_valid=np.zeros(1, bool),
    )
    jt = j_topo.TopologyTensors(**{k: jnp.asarray(v) for k, v in arrs.items()})
    pt = p_topo.TopologyTensors(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    return jt, pt, counts


def _pod_side(rng):
    return (
        rng.random((K_R, V_R)) < 0.6,  # strict mask
        np.isin(np.arange(NGV_R), rng.choice(NGV_R, 3, replace=False)),  # applies: three groups
        rng.random(NGV_R) < 0.6,  # self
        rng.random(NGV_R) < 0.7,  # records
    )


@pytest.mark.parametrize("seed", range(6))
def test_vg_rules_match_reference(seed):
    """vg_pod_precompute, vg_evaluate and vg_commit (jitted reference) on
    random counts, domains and candidate masks: spread, affinity (with
    the bootstrap) and anti-affinity, minDomains, and a complement key
    that vg_commit must not count."""
    rng = np.random.default_rng(seed)
    jt, pt, counts = _random_topology(rng)
    strict, applies, self_sel, records = _pod_side(rng)
    applies[1] = self_sel[1] = True  # the empty affinity group bootstraps
    pre_j = jax.jit(j_topo.vg_pod_precompute, static_argnums=5)(
        jt, jnp.asarray(counts), jnp.asarray(strict), jnp.asarray(applies), jnp.asarray(self_sel), K_R
    )
    pre_p = p_topo.vg_pod_precompute(
        pt, torch.from_numpy(counts), torch.from_numpy(strict), torch.from_numpy(applies),
        torch.from_numpy(self_sel), K_R,
    )
    for f in p_topo.VGPodPre._fields:
        assert np.array_equal(np.asarray(getattr(pre_j, f)), getattr(pre_p, f).numpy()), f
    assert bool(pre_p.bootstrap.any()), "no group bootstraps"

    comb = rng.random((C_R, K_R, V_R)) < 0.75
    comb[0] = True
    feas_j, upd_j, nar_j = jax.jit(j_topo.vg_evaluate)(jt, pre_j, jnp.asarray(comb))
    feas_p, upd_p, nar_p = p_topo.vg_evaluate(pt, pre_p, torch.from_numpy(comb))
    assert np.array_equal(np.asarray(feas_j), feas_p.numpy())
    assert np.array_equal(np.asarray(upd_j), upd_p.numpy())
    assert np.array_equal(np.asarray(nar_j), nar_p.numpy())
    assert nar_p.any(), "no group narrowed any candidate"

    final_mask = np.asarray(upd_j)[0] & comb[0]
    final_inf = np.zeros(K_R, bool)
    final_inf[int(jt.vg_key[0])] = True  # a complement requirement: never counted
    want = jax.jit(j_topo.vg_commit)(
        jt, jnp.asarray(counts), jnp.asarray(final_mask), jnp.asarray(final_inf), jnp.asarray(records)
    )
    got = p_topo.vg_commit(
        pt, torch.from_numpy(counts), torch.from_numpy(final_mask), torch.from_numpy(final_inf),
        torch.from_numpy(records),
    )
    assert np.array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# 2. set helpers
# ---------------------------------------------------------------------------


def _random_sets(rng, n, k=5, v=8):
    inf = rng.random((n, k)) < 0.3
    arrs = dict(
        mask=rng.random((n, k, v)) < 0.5, inf=inf, excl=inf & (rng.random((n, k)) < 0.5),
        gte=np.where(inf, rng.integers(-5, 5, (n, k)), j_encode.INT_MIN).astype(np.int32),
        lte=np.where(inf, rng.integers(0, 10, (n, k)), j_encode.INT_MAX).astype(np.int32),
        defined=rng.random((n, k)) < 0.7,
    )
    return arrs


def _both(arrs):
    return (j_encode.ReqSetTensors(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            ReqSetTensors(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}))


@pytest.mark.parametrize("seed", range(3))
def test_set_helpers_match_reference(seed):
    rng = np.random.default_rng(10 + seed)
    a = _random_sets(rng, 12)
    b = {k: v.copy() for k, v in a.items()}
    for k in ("mask", "inf", "gte", "defined"):  # perturb some rows, keep others equal
        rows = rng.random(12) < 0.3
        b[k][rows] = _random_sets(rng, 12)[k][rows]
    (ja, pa), (jb, pb) = _both(a), _both(b)
    want = jax.jit(j_kernels.set_eq_rows)(ja, jb)
    got = p_kernels.set_eq_rows(pa, pb)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert got.any() and not got.all()
    one = {k: v[0] for k, v in _random_sets(rng, 1).items()}
    (j1, p1) = _both(one)
    want = jax.jit(j_kernels.per_key_ok_table)(ja, j1)
    assert np.array_equal(np.asarray(want), p_kernels.per_key_ok_table(pa, p1).numpy())
    want = jax.jit(j_kernels.update_set_at, static_argnums=1)(ja, 3, j1)
    got = p_kernels.update_set_at(pa, 3, p1)
    for f in ReqSetTensors._fields:
        assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f
    assert np.array_equal(pa.mask.numpy(), a["mask"]), "update_set_at modified its input"


# ---------------------------------------------------------------------------
# 3. solve_from leaf for leaf
# ---------------------------------------------------------------------------


def _spread_pods(n, kinds, prefix="pb", keys=(l.LABEL_TOPOLOGY_ZONE, l.CAPACITY_TYPE_LABEL_KEY), cpu=2.0, **kw):
    pods = []
    per = max(n // kinds, 1)
    for i in range(n):
        k = min(i // per, kinds - 1)
        p = make_pod(f"{prefix}-{i}", cpu=cpu, memory="1Gi", **kw)
        p.metadata.labels = {"grp": f"{prefix}{k}"}
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=1, topology_key=key, label_selector={"grp": f"{prefix}{k}"})
            for key in keys
        ]
        pods.append(p)
    return pods


def _existing_node():
    reqs = Requirements()
    reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, "node-a"))
    reqs.add(Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, "test-zone-1"))
    reqs.add(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_ON_DEMAND))
    return ExistingSimNode(
        name="node-a", index=0, requirements=reqs,
        available={"cpu": 6.0, "memory": float(12 * 2**30), "pods": 110.0},
    )


def _hostname_pods(n):
    """Per-pod kinds that also carry hostname groups: zone + capacity-type
    spread with a hostname anti-affinity (one pod per claim)."""
    pods = _spread_pods(n, 2, prefix="h", cpu=0.5)
    for p in pods:
        p.spec.pod_anti_affinity = [PodAffinityTerm(topology_key=l.LABEL_HOSTNAME, label_selector=dict(p.metadata.labels))]
    return pods


def tier_templates(n_types):
    """One pool whose claims carry the custom key TIER In (a, b, c)."""
    pool = JNodePool()
    pool.metadata.name = "default"
    pool.spec.template.spec.requirements = [{"key": TIER, "operator": "In", "values": ["a", "b", "c"]}]
    return j_build_templates([(pool, j_instance_types(n_types))])


def tier_pods(S, n_per_kind=6):
    """Two per-pod kinds that share claims through a custom key: kind A
    requires TIER In (a, b), kind B TIER In (b, c). A claim narrowed by A
    to {a, b} meets B with the combined row {b}: equal to neither the pod's
    row nor the stored claim row, on a key that is not a topology key —
    the reference's full it-compat branch."""
    pods = []
    for kind, vals in (("A", ["a", "b"]), ("B", ["b", "c"])):
        for i in range(n_per_kind):
            p = S.make_pod(f"t{kind}-{i}", cpu=0.5, memory="512Mi")
            p.metadata.labels = {"tier": kind}
            p.spec.node_affinity = S.NodeAffinity(required=[S.NodeSelectorTerm(
                match_expressions=[{"key": TIER, "operator": "In", "values": vals}])])
            p.spec.topology_spread_constraints = [
                S.TSC(max_skew=1, topology_key=key, label_selector={"tier": kind})
                for key in (S.l.LABEL_TOPOLOGY_ZONE, S.l.CAPACITY_TYPE_LABEL_KEY)
            ]
            pods.append(p)
    return pods


JAX_MODELS = types.SimpleNamespace(
    make_pod=make_pod, NodeAffinity=NodeAffinity, NodeSelectorTerm=NodeSelectorTerm,
    TSC=TopologySpreadConstraint, l=l,
)


class _Problem:
    """A per-pod problem encoded by the reference, carried onto the port."""

    def __init__(self, pods, templates, max_claims, existing=None, window=0):
        self.js = js = TPUScheduler(templates, max_claims=max_claims)
        _sorted, enc = js._encode(pods, existing)
        self.enc = enc
        assert not any(enc["batchable"][k] or enc["kscan_key"][k] >= 0 for _lo, _hi, k in enc["segments"])
        self.window = window or enc["window"]
        self.j_args = (enc["exist_tensors"], js.it_tensors, enc["template_tensors"], js.well_known, enc["topo_tensors"])
        self.p_args = (
            p_solver.from_numpy(p_solver.ExistingNodes, _tonp(enc["exist_tensors"]), "cpu"),
            p_solver.from_numpy(InstanceTypeTensors, _tonp(js.it_tensors), "cpu"),
            p_solver.from_numpy(p_solver.Templates, _tonp(enc["template_tensors"]), "cpu"),
            _pt(js.well_known),
            p_solver.from_numpy(p_topo.TopologyTensors, _tonp(enc["topo_tensors"]), "cpu"),
        )
        self.common = dict(zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"], n_claims=enc["n_claims"],
                           topo_kids=enc["topo_kids"])

    def initial(self):
        enc = self.enc
        st = j_solver.initial_state(
            enc["exist_tensors"], self.js.it_tensors, enc["template_tensors"], enc["topo_tensors"],
            enc["n_claims"], int(enc["ports_k"].shape[1]), self.js._res_cap0, window=self.window,
            topo_kids=enc["topo_kids"],
        )
        return st, p_solver.from_numpy(p_solver.SolverState, _tonp(st), "cpu")

    def chunk(self, lo, hi, l_pad=None):
        """Both packages' inputs for pods [lo, hi) (the reference's gather)."""
        enc = self.enc
        L = hi - lo
        kidx = np.zeros(l_pad or -(-L // 8) * 8, dtype=np.int64)
        kidx[:L] = enc["kind_of"][lo:hi]
        j = j_sched._gather_pod_chunk(
            enc["reqs_k"], enc["strict_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"],
            enc["exist_ok_k"], enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"],
            jnp.asarray(kidx), L,
        )
        pt, rest, ptopo = j[0], j[1:7], j[7]
        p = (
            p_solver.from_numpy(p_solver.PodTensors, _tonp(pt), "cpu"),
            *(_pt(x) for x in rest),
            p_solver.from_numpy(p_topo.PodTopology, _tonp(ptopo), "cpu"),
        )
        return j, p

    def solve_from(self, jst, pst, lo, hi):
        (jpt, *jrest, jtopo), (ppt, *prest, ptopo) = self.chunk(lo, hi)
        res = j_solver.solve_from(jst, jpt, *jrest, *self.j_args, jtopo, **self.common)
        pst, pa = p_solver.solve_from(pst, ppt, *prest, *self.p_args, ptopo, **self.common)
        return res.claims, np.asarray(res.assignment), pst, pa.numpy()

    def segments(self):
        return self.enc["segments"]


def _any_fallback_ref(prob, jst, lo):
    """The reference's any_fallback for pod `lo` at state jst, evaluated
    with the reference's own helpers (solver.py:439-472)."""
    (jpt, *_rest, jtopo), _ = prob.chunk(lo, lo + 1)
    it, topo, K = prob.js.it_tensors, prob.enc["topo_tensors"], prob.js.it_tensors.reqs.mask.shape[1]
    pod = j_kernels.take_set(jpt.reqs, 0)
    W = jst.open.shape[0]
    pod_b = j_solver._broadcast_pod(pod, W)
    comb = j_kernels.intersect_sets(jst.reqs, pod_b)
    claim_ok = j_kernels.compatible_elemwise(jst.reqs, pod_b, prob.js.well_known)
    pre = j_topo.vg_pod_precompute(topo, jst.vg_counts, jtopo.strict_mask[0], jtopo.vg_applies[0], jtopo.vg_self[0], K)
    _f, upd, _n = j_topo.vg_evaluate(topo, pre, comb.mask)
    comb_t = j_solver._apply_topo(comb, upd, pre.key_touched)
    kid = np.zeros(K, bool)
    kid[list(prob.enc["topo_kids"])] = True
    need = ~j_kernels.set_eq_rows(comb_t, pod_b) & ~j_kernels.set_eq_rows(comb_t, jst.reqs) & ~jnp.asarray(kid)[None, :]
    return bool(jnp.any(jst.open & claim_ok & jnp.any(need, axis=-1)))


CASES = {
    # name: (pods, templates, max_claims, existing, window, chunk length)
    "perpod": lambda: (bench.perpod_pods(40, kinds=4), bench.make_templates(24), 48, None, 0, 16),
    "existing_node": lambda: (_spread_pods(20, 2, cpu=0.5), bench.make_templates(20), 32, [_existing_node()], 0, 12),
    "hostname_groups": lambda: (_hostname_pods(16), bench.make_templates(20), 32, None, 0, 8),
    # a window of 6 rows over 10 claim slots: opens past the window spill,
    # opens past the slots are NO_ROOM
    "no_room_spills": lambda: (bench.perpod_pods(24, kinds=2), bench.make_templates(24), 10, None, 6, 24),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_from_leaf_for_leaf(case):
    """Every chunk of the problem through both solve_from's in order: the
    state after each chunk and the assignment equal the reference's."""
    pods, templates, max_claims, existing, window, step = CASES[case]()
    prob = _Problem(pods, templates, max_claims, existing, window)
    jst, pst = prob.initial()
    _assert_leaves_equal(jst, pst, "initial_state")
    P = prob.enc["P"]
    assigned = []
    for lo in range(0, P, step):
        hi = min(lo + step, P)
        jst, ja, pst, pa = prob.solve_from(jst, pst, lo, hi)
        assert np.array_equal(ja, pa), (case, lo, ja, pa)
        _assert_leaves_equal(jst, pst, f"{case} after pods [{lo}, {hi})")
        assigned.append(pa[: hi - lo])
    a = np.concatenate(assigned)
    E = prob.enc["E"]
    assert (a >= E).any(), "no pod landed on a claim"
    if case == "existing_node":
        assert ((a >= 0) & (a < E)).any(), "no pod landed on the existing node"
    if case == "hostname_groups":
        assert int(pst.hg_counts.sum()) > 0
    if case == "no_room_spills":
        assert (a == p_solver.NO_ROOM).any() and int(pst.spills) > 0


def test_solve_from_takes_the_reference_fallback_branch():
    """A chunk in which the reference's it-compat takes its full pairwise
    branch (any_fallback): a claim stored with TIER {a, b} meets a pod with
    TIER {b, c}. The test confirms the branch with the reference's own
    helpers, then holds the port to the reference leaf for leaf."""
    prob = _Problem(tier_pods(JAX_MODELS), tier_templates(24), 32)
    segs = prob.segments()
    assert len(segs) == 2
    jst, pst = prob.initial()
    lo, hi = segs[0][0], segs[0][1]
    jst, ja, pst, pa = prob.solve_from(jst, pst, lo, hi)
    _assert_leaves_equal(jst, pst, "first kind")
    assert _any_fallback_ref(prob, jst, segs[1][0]), "the reference did not take the fallback branch"
    jst, ja, pst, pa = prob.solve_from(jst, pst, segs[1][0], segs[1][1])
    assert np.array_equal(ja, pa)
    _assert_leaves_equal(jst, pst, "second kind")
    assert (pa >= prob.enc["E"]).any(), "no pod of the second kind landed on a claim"


def test_changed_key_compat_equals_the_fallback_branch():
    """The kernels' it-compat (test only the keys where the narrowed row
    differs from the stored claim row, AND state.its) gives the reference's
    full branch on every pickable claim, on the state where the reference
    falls back."""
    prob = _Problem(tier_pods(JAX_MODELS), tier_templates(24), 32)
    segs = prob.segments()
    jst, pst = prob.initial()
    jst, _ja, pst, _pa = prob.solve_from(jst, pst, segs[0][0], segs[0][1])
    _, (ppt, *prest, ptopo) = prob.chunk(segs[1][0], segs[1][0] + 1)
    xs = p_solver.pod_xs(ppt, *prest, ptopo)
    x = p_solver._take_x(xs, 0)
    exist, it, templates, wk, topo = prob.p_args
    K = it.reqs.mask.shape[1]
    W = pst.open.shape[0]
    pod_b = p_kernels.broadcast_set(x.reqs, W)
    comb = p_kernels.intersect_sets(pst.reqs, pod_b)
    claim_ok = p_kernels.compatible_elemwise(pst.reqs, pod_b, wk)
    pre = p_topo.vg_pod_precompute(topo, pst.vg_counts, x.strict_mask, x.vg_applies, x.vg_self, K)
    _f, upd, _n = p_topo.vg_evaluate(topo, pre, comb.mask)
    comb_t = p_solver._apply_topo(comb, upd, pre.key_touched)
    full = p_kernels.intersects_plain(comb_t, it.reqs) & pst.its
    changed = ~p_kernels.set_eq_rows(comb_t, pst.reqs)  # [W, K]
    ok = torch.ones_like(full)
    for k in range(K):
        ok &= ~changed[:, k, None] | p_kernels.per_key_ok_at(it.reqs, comb_t, k)
    pickable = pst.open & claim_ok
    assert bool(pickable.any())
    assert torch.equal((ok & pst.its)[pickable], full[pickable])


def test_solve_is_initial_state_then_solve_from():
    prob = _Problem(bench.perpod_pods(16, kinds=2), bench.make_templates(20), 24)
    _j, pst = prob.initial()
    _jc, (ppt, *prest, ptopo) = prob.chunk(0, 16)
    a = p_solver.solve_from(pst, ppt, *prest, *prob.p_args, ptopo, **prob.common)
    b = p_solver.solve(ppt, *prest, *prob.p_args, ptopo, **prob.common, window=prob.window)
    assert torch.equal(a[1], b[1])
    fa, fb = p_solver.to_numpy(a[0]), p_solver.to_numpy(b[0])
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_perpod_wrappers_compose_to_the_step():
    """The chunk in pieces through perpod_steps (plain on the CPU): steps
    [0, 1), [1, 7) and [7, 16), each from the state the last left, give
    solve_from's result."""
    prob = _Problem(bench.perpod_pods(16, kinds=2), bench.make_templates(20), 24)
    _j, pst = prob.initial()
    _jc, (ppt, *prest, ptopo) = prob.chunk(0, 16)
    want_state, want = p_solver.solve_from(pst, ppt, *prest, *prob.p_args, ptopo, **prob.common)
    xs = p_solver.pod_xs(ppt, *prest, ptopo)
    ctx = p_solver.PerPodCtx(*prob.p_args, prob.enc["zone_kid"], prob.enc["ct_kid"], prob.enc["n_claims"],
                             tuple(prob.enc["topo_kids"]))
    st, got = pst, []
    for lo, hi in ((0, 1), (1, 7), (7, 16)):
        st, a = p_solver.perpod_steps(st, xs, ctx, lo, hi)
        assert a.shape == (hi - lo,)
        got += a.tolist()
    assert got == want.tolist()
    fa, fb = p_solver.to_numpy(want_state), p_solver.to_numpy(st)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


# cases in which later tiers have finite keys beside an earlier tier's:
# an existing node beside claims and templates, claims beside templates
LAZY_CASES = {
    "existing_node": CASES["existing_node"],
    "hostname_groups": CASES["hostname_groups"],
    "shared_claims": lambda: (_spread_pods(20, 2, cpu=0.5), bench.make_templates(20), 32, None, 0, 12),
}


@pytest.mark.parametrize("seed", range(6))
def test_lazy_tiers_are_exact(seed):
    """The kernel evaluates tier 2 only when no existing node is feasible
    and tier 3 only when no claim is either. _pod_commit with the tier-2
    and tier-3 keys set to BIG wherever tier 1 has a finite key, and the
    tier-3 keys wherever tier 2 does, gives the same assignment and every
    carry leaf, step after step, on each case's pods in a seeded order."""
    rng = np.random.default_rng(seed)
    name = ("existing_node", "hostname_groups", "shared_claims")[seed % 3]
    pods, templates, max_claims, existing, window, _step = LAZY_CASES[name]()
    prob = _Problem(pods, templates, max_claims, existing, window)
    _j, st = prob.initial()
    P = prob.enc["P"]
    order = rng.permutation(P)
    prob.enc["kind_of"] = np.asarray(prob.enc["kind_of"])[order]
    _jc, (ppt, *prest, ptopo) = prob.chunk(0, P)
    xs = p_solver.pod_xs(ppt, *prest, ptopo)
    ctx = p_solver.PerPodCtx(*prob.p_args, prob.enc["zone_kid"], prob.enc["ct_kid"], prob.enc["n_claims"],
                             tuple(prob.enc["topo_kids"]))
    E, W = prob.enc["E"], st.open.shape[0]
    masked = 0
    for i in range(P):
        x = p_solver._take_x(xs, i)
        keys, aux = p_solver._pod_eval_full(st, x, ctx)
        lazy = keys.clone()
        big = p_solver.BIG
        if bool((keys[:E] < big).any()):
            lazy[E:] = big
        elif bool((keys[E:E + W] < big).any()):
            lazy[E + W:] = big
        masked += int(not torch.equal(lazy, keys))
        want_state, want = p_solver._pod_commit(st, x, ctx, keys, aux)
        got_state, got = p_solver._pod_commit(st, x, ctx, lazy, aux)
        assert int(got) == int(want), (name, i)
        fa, fb = p_solver.to_numpy(want_state), p_solver.to_numpy(got_state)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa), (name, i)
        st = want_state
    assert masked, f"{name}: no step had a later tier to skip"


def _assert_open_prefix(state, what):
    W = state.open.shape[0]
    want = torch.arange(W) < int(state.w_open)
    assert torch.equal(state.open.cpu(), want), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_open_rows_are_a_prefix(case):
    """The kernel scans window rows [0, w_open) only: the open rows are
    exactly that prefix in the state every per-pod step starts from and
    leaves, chunk after chunk."""
    pods, templates, max_claims, existing, window, step = CASES[case]()
    prob = _Problem(pods, templates, max_claims, existing, window)
    _j, st = prob.initial()
    ctx = p_solver.PerPodCtx(*prob.p_args, prob.enc["zone_kid"], prob.enc["ct_kid"], prob.enc["n_claims"],
                             tuple(prob.enc["topo_kids"]))
    P = prob.enc["P"]
    opened = 0
    for lo in range(0, P, step):
        _jc, (ppt, *prest, ptopo) = prob.chunk(lo, min(lo + step, P))
        xs = p_solver.pod_xs(ppt, *prest, ptopo)
        for i in range(xs.requests.shape[0]):
            _assert_open_prefix(st, (case, lo, i))
            st, _a = p_solver._pod_step(st, p_solver._take_x(xs, i), ctx)
            _assert_open_prefix(st, (case, lo, i, "after"))
        opened = max(opened, int(st.w_open))
    assert opened > 0


def test_open_rows_are_a_prefix_across_scan_kinds(monkeypatch):
    """The same on a TorchScheduler solve whose per-pod chunks follow fill
    and kind-scan segments, and after a compaction that closes claims."""
    from karpenter_tpu_torch import testing as p_testing
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    real = p_solver._pod_step
    seen = []

    def checked(state, x, c):
        _assert_open_prefix(state, "before")
        out = real(state, x, c)
        _assert_open_prefix(out[0], "after")
        seen.append(int(out[0].w_open))
        return out

    monkeypatch.setattr(p_solver, "_pod_step", checked)
    s = TorchScheduler(p_testing.make_templates(24), max_claims=64, device="cpu")
    s.solve_chunk = 24
    s.solve(p_testing.mixed_pods(30) + p_testing.perpod_pods(40))
    assert s.last_stats["perpod_dispatches"] >= 2 and s.last_stats["kscan_dispatches"] >= 1 and max(seen) > 0
    # compact_state keeps the surviving claims as the prefix
    monkeypatch.setattr(p_solver, "_pod_step", real)
    pods, templates, max_claims, existing, window, _step = CASES["perpod"]()
    prob = _Problem(pods, templates, max_claims, existing, window)
    _j, st = prob.initial()
    _jc, (ppt, *prest, ptopo) = prob.chunk(0, prob.enc["P"])
    st, _a = p_solver.solve_from(st, ppt, *prest, *prob.p_args, ptopo, **prob.common)
    it = prob.p_args[1]
    used = st.used.clone()
    used[1:int(st.w_open):3, 0] = 1e6  # every third claim is full
    r_min = torch.zeros(it.alloc.shape[2])
    r_min[0] = 0.25
    st2, closed = p_solver.compact_state(st._replace(used=used), it, r_min, prob.enc["n_claims"], plain=True,
                                         topo_kids=prob.enc["topo_kids"])
    assert 0 < int(closed) < int(st.w_open)
    _assert_open_prefix(st2, "compacted")


def test_perpod_tables_layout():
    """perpod_tables packs the type tables the kernel reads: each field at
    a 16-byte aligned offset, the type axis innermost, masks, offerings,
    the minValues slab and the reserved offerings as 32-bit words of bits
    (value v of a key at bit v % 32 of word v // 32);
    a second call packs the same bytes again, and a changed source shows."""
    prob = _Problem(_hostname_pods(8), bench.make_templates(20), 16, [_existing_node()])
    it, t_its = prob.p_args[1], prob.p_args[2].its
    buf, off = p_cuda.perpod_tables(it, t_its)
    assert len(off) == len(p_cuda.TABLES) + 1 and all(o % 16 == 0 for o in off) and off[-1] == buf.numel()
    T, GR, R = it.alloc.shape
    K, V = it.reqs.mask.shape[1:]
    Z, C = it.zc_avail.shape[2:]
    raw = buf.numpy()

    def field(i, dtype, shape):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        assert off[i + 1] - off[i] >= n
        return raw[off[i]:off[i] + n].view(dtype).reshape(shape)

    def bits(words, n):
        return ((words[..., None].view(np.uint32) >> np.arange(32, dtype=np.uint32)) & 1).reshape(
            words.shape[:-1] + (-1,))[..., :n].astype(bool)

    G = t_its.shape[0]
    assert np.array_equal(field(0, np.bool_, (G, T)), t_its.numpy())
    assert np.array_equal(field(1, np.bool_, (GR, T)), it.group_valid.numpy().T)
    assert np.array_equal(field(2, np.float32, (GR, R, T)), it.alloc.numpy().transpose(1, 2, 0))
    zc = field(3, np.int32, (GR, (Z * C + 31) // 32, T)).transpose(2, 0, 1)
    assert np.array_equal(bits(zc, Z * C), it.zc_avail.numpy().reshape(T, GR, Z * C))
    assert np.array_equal(field(4, np.float32, (R, T)), it.cap.numpy().T)
    for i, f in ((5, "defined"), (6, "inf"), (7, "excl")):
        assert np.array_equal(field(i, np.bool_, (K, T)), getattr(it.reqs, f).numpy().T), f
    mb = field(8, np.int32, (K, (V + 31) // 32, T)).transpose(2, 0, 1)
    assert np.array_equal(bits(mb, V), it.reqs.mask.numpy())
    assert np.array_equal(field(9, np.int32, (K, T)), it.reqs.gte.numpy().T)
    assert np.array_equal(field(10, np.int32, (K, T)), it.reqs.lte.numpy().T)
    # the minValues slab [T, J, V] and the reserved offerings [T, RID, Z], as
    # bits (r * Z + z for the offerings) with the type axis innermost
    rng = np.random.default_rng(2)
    mv = rng.random((T, 3, V)) < 0.3
    ro = rng.random((T, 2, Z)) < 0.4
    buf2, off2 = p_cuda.perpod_tables(it._replace(res_ofs=torch.from_numpy(ro)), t_its, torch.from_numpy(mv))
    raw2 = buf2.numpy()
    mvw = raw2[off2[11]:off2[11] + 3 * ((V + 31) // 32) * T * 4].view(np.int32).reshape(3, -1, T).transpose(2, 0, 1)
    assert np.array_equal(bits(mvw, V), mv)
    rw = raw2[off2[12]:off2[12] + ((2 * Z + 31) // 32) * T * 4].view(np.int32).reshape(-1, T).T
    assert np.array_equal(bits(rw, 2 * Z), ro.reshape(T, 2 * Z))
    assert len(off2) == len(p_cuda.TABLES) + 1 == 14 and off2[:12] == off[:12]
    # words past 32 values, and the top bit of a word
    x = np.random.default_rng(0).random((3, 4, 70)) < 0.5
    x[..., 31] = True
    assert np.array_equal(bits(p_cuda.bit_words(torch.from_numpy(x)).numpy(), 70), x)
    again, off2 = p_cuda.perpod_tables(it, t_its)
    assert again is not buf and torch.equal(again, buf) and off2 == off
    it.cap[0, 0] += 1.0
    assert not torch.equal(p_cuda.perpod_tables(it, t_its)[0], buf)
    with pytest.raises(ValueError, match="dtype|float32"):
        p_cuda.perpod_tables(it._replace(cap=it.cap.double()), t_its)


# ---------------------------------------------------------------------------
# 6. the per-pod kernel's launcher and its argument block
# ---------------------------------------------------------------------------


def _read(p, n):
    return list((ctypes.c_int64 * n).from_address(p.value))


def test_perpod_launcher_passes_the_parameter_block(monkeypatch):
    """The CUDA path's one launch per chunk, with the C entry stubbed: 82
    pointers in the kernel's field order (each the data of the tensor the
    field names, checked for device, dtype, shape and contiguity; the
    kernel's scratch a fresh [W, R] buffer; the last, the scenario mode's
    pod_idx, null), the 29 dims (the minValues and reservation flags off),
    no strides and one
    block, the packed type tables and their offsets, the steps [0, L); one
    launch counted; a launch of steps [3, 4) alone; nothing launched for
    no steps; the context's own packed tables passed as they are."""
    prob = _Problem(_hostname_pods(12), bench.make_templates(20), 16, [_existing_node()])
    _j, pst = prob.initial()
    _jc, (ppt, *prest, ptopo) = prob.chunk(0, 12, l_pad=16)
    xs = p_solver.pod_xs(ppt, *prest, ptopo)
    ctx = p_solver.PerPodCtx(*prob.p_args, prob.enc["zone_kid"], prob.enc["ct_kid"], prob.enc["n_claims"],
                             tuple(prob.enc["topo_kids"]))
    seen = []

    def fake(source, entry, ptrs, n_ptrs, dims, strides, S, tables, offsets, lo, hi):
        off = _read(offsets, len(p_cuda.TABLES) + 1)
        seen.append((source, entry, _read(ptrs, n_ptrs), _read(dims, 29), strides, S, tables, off, lo, hi,
                     bytes((ctypes.c_uint8 * off[-1]).from_address(tables))))

    monkeypatch.setattr(p_cuda, "_invoke", fake)
    p_cuda.reset_launches()
    st = p_solver.own_perpod_writes(pst)
    assignment = p_cuda.perpod_scan(st, xs, ctx)
    (source, entry, ptrs, dims, strides, S, tables, offsets, lo, hi, raw), = seen
    assert (source, entry, strides, S, lo, hi) == ("perpod_scan", "perpod_steps", None, 1, 0, 16)
    fields, want_dims = p_cuda._perpod_fields(st, xs, ctx, torch.empty(st.used.shape), assignment)
    assert len(fields) == len(ptrs) == 82
    assert fields[-1][:2] == ("pod_idx", None) and ptrs[-1] == 0
    i_row_max = [f[0] for f in fields].index("row_max")
    for (name, t, _dt, _shape), got in zip(fields[:81], ptrs[:81]):
        if name == "row_max":
            assert got and got not in ptrs[:i_row_max], name  # a buffer of its own
        else:
            assert got == t.data_ptr(), name
    E, W, G = prob.enc["E"], pst.open.shape[0], prob.p_args[2].its.shape[0]
    T, K, V = prob.p_args[1].reqs.mask.shape
    assert dims == want_dims and dims[:6] == [E, W, G, T, K, V] and dims[16:18] == [prob.enc["n_claims"], 16]
    assert dims[26:] == [0, 0, 0]
    buf, want_off = p_cuda.perpod_tables(ctx.it, ctx.templates.its)
    assert raw == buf.numpy().tobytes() and offsets == want_off
    assert p_cuda.LAUNCHES["perpod_scan_persistent"] == 1 and p_cuda.LAUNCHES["perpod_scan_persistent_whatif"] == 0
    # steps [3, 4) alone, into the caller's assignment buffer
    seen.clear()
    assert p_cuda.perpod_steps(st, xs, ctx, 3, 4, assignment) is assignment
    assert [(s[1], s[8], s[9]) for s in seen] == [("perpod_steps", 3, 4)]
    seen.clear()
    p_cuda.perpod_steps(st, xs, ctx, 5, 5)
    assert not seen and p_cuda.LAUNCHES["perpod_scan_persistent"] == 2
    # tables packed once (as TorchScheduler does per encode) travel in the context
    own = p_cuda.perpod_tables(ctx.it, ctx.templates.its)
    p_cuda.perpod_steps(st, xs, ctx._replace(tables=own), 0, 1)
    assert seen[-1][6] == own[0].data_ptr() and seen[-1][7] == own[1]
    # what the launcher refuses: steps past the chunk, a non-contiguous field, a wrong dtype
    with pytest.raises(ValueError, match="steps"):
        p_cuda.perpod_steps(st, xs, ctx, 0, 17)
    bad = xs._replace(it_allow=xs.it_allow.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        p_cuda.perpod_scan(st, bad, ctx)
    bad = xs._replace(requests=xs.requests.double())
    with pytest.raises(ValueError, match="dtype"):
        p_cuda.perpod_scan(st, bad, ctx)


def test_scheduler_hands_the_launcher_what_it_takes(monkeypatch):
    """A whole TorchScheduler solve with per-pod, kind-scan and fill kinds
    in which every per-pod chunk is first validated by the CUDA launcher
    (C entry stubbed) and then computed by the plain loop: the launcher
    accepts every chunk, one launch of steps [0, L) per chunk, each with
    the type tables the scheduler packed once for its encode (as it does
    on the card), and the result is unchanged."""
    from karpenter_tpu_torch import testing as p_testing
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    def solve():
        s = TorchScheduler(p_testing.make_templates(24), max_claims=64, device="cpu")
        s.solve_chunk = 24
        r = s.solve(p_testing.mixed_pods(30) + p_testing.perpod_pods(40))
        return [(c.slot, [p.name for p in c.pods], str(c.requirements)) for c in r.claims], s.last_stats

    want, _ = solve()
    calls, packed = [], []
    real_static = TorchScheduler._encode_static

    def static_with_tables(self):
        real_static(self)
        self.perpod_tables = p_cuda.perpod_tables(self.it_tensors, self.template_tensors.its)
        packed.append(self.perpod_tables[0].data_ptr())

    monkeypatch.setattr(TorchScheduler, "_encode_static", static_with_tables)
    monkeypatch.setattr(p_cuda, "_invoke", lambda source, entry, *a: calls.append((entry, a[-2], a[-1], a[5])))
    plain = p_solver.perpod_loop_plain

    def checked(state, xs, ctx):
        p_cuda.perpod_scan(p_solver.own_perpod_writes(state), xs, ctx)
        assert calls[-1][:3] == ("perpod_steps", 0, xs.requests.shape[0])
        return plain(state, xs, ctx)

    monkeypatch.setattr(p_solver, "perpod_loop_plain", checked)
    p_cuda.reset_launches()
    got, stats = solve()
    assert got == want
    assert stats["perpod_dispatches"] == len(calls) >= 2 and {c[0] for c in calls} == {"perpod_steps"}
    assert len(packed) == 1 and {c[3] for c in calls} == set(packed)
    assert p_cuda.LAUNCHES["perpod_scan_persistent"] == len(calls)
