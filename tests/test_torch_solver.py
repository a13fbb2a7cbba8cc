"""The port's fill solve (karpenter_tpu_torch.ops.solver) against the JAX
package's on the identical encoded problem: the reference's TPUScheduler
encodes it, both solvers receive it (the port through from_numpy), and
every leaf of the state and of the per-segment records must be equal
after solve_fill, compact_state and global_claims."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.controllers.provisioning import scheduler as j_sched
from karpenter_tpu.controllers.provisioning.host_scheduler import ExistingSimNode
from karpenter_tpu.models import labels as l
from karpenter_tpu.models.pod import TopologySpreadConstraint, make_pod
from karpenter_tpu.ops import solver as j_solver
from karpenter_tpu.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.ops import solver as p_solver
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors
from karpenter_tpu_torch.ops.topology import TopologyTensors
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tonp(x):
    return jax.tree.map(np.asarray, x)


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


class _Problem:
    """One problem encoded by the reference, carried onto the port."""

    def __init__(self, pods, n_types=30, max_claims=128, existing=None):
        self.js = TPUScheduler(bench.make_templates(n_types), max_claims=max_claims)
        self.js.existing_nodes = list(existing or [])
        _sorted, enc = self.js._encode(pods, existing)
        self.enc = enc
        js = self.js
        self.j_args = (
            enc["exist_tensors"], js.it_tensors, enc["template_tensors"], js.well_known, enc["topo_tensors"],
        )
        dev = "cpu"
        self.p_args = (
            p_solver.from_numpy(p_solver.ExistingNodes, _tonp(enc["exist_tensors"]), dev),
            p_solver.from_numpy(InstanceTypeTensors, _tonp(js.it_tensors), dev),
            p_solver.from_numpy(p_solver.Templates, _tonp(enc["template_tensors"]), dev),
            torch.from_numpy(np.array(js.well_known)),
            p_solver.from_numpy(TopologyTensors, _tonp(enc["topo_tensors"]), dev),
        )

    def initial(self):
        enc = self.enc
        st = j_solver.initial_state(
            enc["exist_tensors"], self.js.it_tensors, enc["template_tensors"], enc["topo_tensors"],
            enc["n_claims"], int(enc["ports_k"].shape[1]), self.js._res_cap0, window=enc["window"],
        )
        return st, p_solver.from_numpy(p_solver.SolverState, _tonp(st), "cpu")

    def xs(self, segs):
        enc = self.enc
        xs = j_sched._gather_fill_xs(
            enc["reqs_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"], enc["exist_ok_k"],
            enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"],
            jnp.asarray([s[2] for s in segs]), jnp.asarray([s[1] - s[0] for s in segs], dtype=jnp.int32),
        )
        return xs, p_solver.from_numpy(p_solver.FillXs, _tonp(xs), "cpu")

    def solve(self, jst, pst, segs):
        enc = self.enc
        jxs, pxs = self.xs(segs)
        jst, jys = j_solver.solve_fill(
            jst, jxs, *self.j_args, zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"], n_claims=enc["n_claims"],
        )
        pst, pys = p_solver.solve_fill(
            pst, pxs, *self.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"],
        )
        return jst, jys, pst, pys


def _selector_pods(n):
    return bench.selector_pods(n)


def _existing_node():
    reqs = Requirements()
    reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, "node-a"))
    reqs.add(Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, "test-zone-1"))
    reqs.add(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_ON_DEMAND))
    return ExistingSimNode(
        name="node-a", index=0, requirements=reqs,
        available={"cpu": 4.0, "memory": float(8 * 2**30), "pods": 110.0},
    )


def _hostname_spread_pods(n):
    pods = []
    for i in range(n):
        p = make_pod(f"h-{i}", cpu=0.25, memory="256Mi")
        p.metadata.labels = {"spread": "host2"}
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=2, topology_key=l.LABEL_HOSTNAME, label_selector={"spread": "host2"})
        ]
        pods.append(p)
    return pods


CASES = {
    "selector": lambda: _Problem(_selector_pods(240), n_types=30, max_claims=64),
    "existing": lambda: _Problem(
        [make_pod(f"p-{i}", cpu=0.5, memory="512Mi") for i in range(24)]
        + [make_pod(f"q-{i}", cpu=0.3, memory="300Mi") for i in range(9)],
        n_types=20, max_claims=32, existing=[_existing_node()],
    ),
    "hostname_spread": lambda: _Problem(_hostname_spread_pods(12), n_types=20, max_claims=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_fill_leaf_for_leaf(case):
    prob = CASES[case]()
    jst, pst = prob.initial()
    _assert_leaves_equal(jst, pst, "initial_state")
    segs = prob.enc["segments"]
    jst, jys, pst, pys = prob.solve(jst, pst, segs)
    _assert_leaves_equal(jys, pys, "ys")
    _assert_leaves_equal(jst, pst, "state")
    assert int(pst.n_open) > 0
    jg = _tonp(j_solver.global_claims(jst))
    pg = p_solver.global_claims(pst)
    for k in ("template", "its", "used", "held"):
        assert np.array_equal(jg[k], pg[k].numpy()), k


def test_compact_state_between_dispatches():
    """Two dispatches with a compaction between them: the state after the
    boundary and after the second dispatch equal the reference's."""
    prob = CASES["selector"]()
    segs = prob.enc["segments"]
    cut = len(segs) // 2
    jst, pst = prob.initial()
    jst, _jys, pst, _pys = prob.solve(jst, pst, segs[:cut])
    req = np.asarray(prob.enc["requests_k"], dtype=np.float32)
    rest = sorted({k for _lo, _hi, k in segs[cut:]})
    # the largest remaining request as the floor, so some claims die
    r_min = req[rest].max(axis=0)
    jst, jclosed = j_solver.compact_state(jst, prob.js.it_tensors, jnp.asarray(r_min), prob.enc["n_claims"])
    pst, pclosed = p_solver.compact_state(pst, prob.p_args[1], torch.from_numpy(r_min), prob.enc["n_claims"])
    assert int(jclosed) == int(pclosed) > 0
    _assert_leaves_equal(jst, pst, "compacted")
    jst, jys, pst, pys = prob.solve(jst, pst, segs[cut:])
    _assert_leaves_equal(jys, pys, "ys after compaction")
    _assert_leaves_equal(jst, pst, "state after compaction")
    jg = _tonp(j_solver.global_claims(jst))
    pg = p_solver.global_claims(pst)
    for k in ("template", "its", "used", "held"):
        assert np.array_equal(jg[k], pg[k].numpy()), k


def test_plain_flag_is_the_cpu_path():
    """plain=True selects the same functions the CPU wrappers run."""
    prob = CASES["existing"]()
    segs = prob.enc["segments"]
    _j, pst = prob.initial()
    _jx, pxs = prob.xs(segs)
    enc = prob.enc
    a, ya = p_solver.solve_fill(pst, pxs, *prob.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"])
    b, yb = p_solver.solve_fill(pst, pxs, *prob.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"], plain=True)
    for x, y in ((a, b), (ya, yb)):
        fa, fb = p_solver.to_numpy(x), p_solver.to_numpy(y)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
