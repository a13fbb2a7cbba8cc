"""The port's zonal kind scan (karpenter_tpu_torch.ops.solver
solve_kind_scan and its H5 / H6 plain versions) against the JAX package's
on the identical encoded problem: the reference's TPUScheduler encodes it,
both solvers receive it (the port through from_numpy), and every leaf of
the state and of the per-segment records must be equal. Also the
topology-key bank rows of compact_state / global_claims. Tolerance:
exact equality everywhere."""

import functools

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
from karpenter_tpu.models.pod import PodAffinityTerm, TopologySpreadConstraint, make_pod
from karpenter_tpu.ops import kernels as j_kernels
from karpenter_tpu.ops import solver as j_solver
from karpenter_tpu.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.ops import solver as p_solver
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors, ReqSetTensors
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


def _existing_node():
    reqs = Requirements()
    reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, "node-a"))
    reqs.add(Requirement.new(l.LABEL_TOPOLOGY_ZONE, Operator.IN, "test-zone-1"))
    reqs.add(Requirement.new(l.CAPACITY_TYPE_LABEL_KEY, Operator.IN, l.CAPACITY_TYPE_ON_DEMAND))
    return ExistingSimNode(
        name="node-a", index=0, requirements=reqs,
        available={"cpu": 6.0, "memory": float(12 * 2**30), "pods": 110.0},
    )


def _web_pods(n):
    """Zone spread AND hostname anti-affinity on one kind: the kind scan
    with a hostname group in its pod loop."""
    pods = []
    for i in range(n):
        p = make_pod(f"w-{i}", cpu=0.5 + 0.5 * (i % 2), memory="512Mi")
        p.metadata.labels = {"app": "web"}
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=1, topology_key=l.LABEL_TOPOLOGY_ZONE, label_selector={"app": "web"})
        ]
        p.spec.pod_anti_affinity = [PodAffinityTerm(topology_key=l.LABEL_HOSTNAME, label_selector={"app": "web"})]
        pods.append(p)
    return pods


def _zone_affinity_pods(n):
    pods = []
    for i in range(n):
        p = make_pod(f"a-{i}", cpu=[0.25, 1.0, 2.0][i % 3], memory="1Gi")
        p.metadata.labels = {"aff": "g"}
        p.spec.pod_affinity = [PodAffinityTerm(topology_key=l.LABEL_TOPOLOGY_ZONE, label_selector={"aff": "g"})]
        pods.append(p)
    return pods


class _Problem:
    """One problem encoded by the reference, carried onto the port."""

    def __init__(self, pods, n_types=24, max_claims=64, existing=None):
        self.js = TPUScheduler(bench.make_templates(n_types), max_claims=max_claims)
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
            topo_kids=enc["topo_kids"],
        )
        return st, p_solver.from_numpy(p_solver.SolverState, _tonp(st), "cpu")

    def kscan_runs(self):
        """Maximal runs of kind-scan segments, per key."""
        enc = self.enc
        runs = []
        for seg in enc["segments"]:
            key = int(enc["kscan_key"][seg[2]]) if not enc["batchable"][seg[2]] else -1
            if runs and runs[-1][0] == key:
                runs[-1][1].append(seg)
            else:
                runs.append((key, [seg]))
        return [(k, segs) for k, segs in runs if k >= 0]

    def kind_xs(self, segs):
        enc = self.enc
        xs = j_sched._gather_kind_xs(
            enc["reqs_k"], enc["strict_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"],
            enc["exist_ok_k"], enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"],
            jnp.asarray([s[2] for s in segs]), jnp.asarray([s[1] - s[0] for s in segs], dtype=jnp.int32),
        )
        return xs, p_solver.from_numpy(p_solver.KindXs, _tonp(xs), "cpu")

    def kscan(self, jst, pst, key, segs, grid_incremental=True):
        enc = self.enc
        jxs, pxs = self.kind_xs(segs)
        counts = [hi - lo for lo, hi, _k in segs]
        maxc = max(64, -(-max(counts) // 64) * 64)
        n_domains = len(self.js.encoder.vocab.values[key])
        jst, jys = j_solver.solve_kind_scan(
            jst, jxs, *self.j_args, zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"],
            n_claims=enc["n_claims"], key_kid=key, n_domains=n_domains, maxc=maxc,
            grid_incremental=grid_incremental,
        )
        req = np.asarray(enc["requests_k"], dtype=np.float32)[[k for _lo, _hi, k in segs]]
        pst, pys = p_solver.solve_kind_scan(
            pst, pxs, *self.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"],
            key_kid=key, n_domains=n_domains, maxc=maxc, counts=counts, requests_np=req,
            grid_incremental=grid_incremental,
        )
        return jst, jys, pst, pys


CASES = {
    "zonal": lambda: _Problem(bench.zonal_pods(48, kinds=3), n_types=24, max_claims=64),
    "mixed": lambda: _Problem(bench.mixed_pods(60), n_types=24, max_claims=64),
    "web_existing": lambda: _Problem(_web_pods(14), n_types=20, max_claims=32, existing=[_existing_node()]),
    "zone_affinity": lambda: _Problem(_zone_affinity_pods(18), n_types=20, max_claims=32),
}


@pytest.mark.parametrize("grid_incremental", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_kind_scan_leaf_for_leaf(case, grid_incremental):
    """Every kind-scan run of the problem, dispatched in order on both
    sides: the state after each run and the per-segment records equal the
    reference's, with the grid reused across equal-request segments and
    with the full recompute at every segment."""
    prob = CASES[case]()
    runs = prob.kscan_runs()
    assert runs
    jst, pst = prob.initial()
    _assert_leaves_equal(jst, pst, "initial_state")
    reused = 0
    for key, segs in runs:
        jst, jys, pst, pys = prob.kscan(jst, pst, key, segs, grid_incremental)
        _assert_leaves_equal(jys, pys, f"ys {segs}")
        _assert_leaves_equal(jst, pst, f"state after {segs}")
        reused += int(pys.grid_reused.sum())
    if not grid_incremental:
        assert reused == 0
    assert int(pst.n_open) > 0


def test_kscan_reuses_the_grid_on_equal_requests():
    """zonal_pods kinds share one request vector, so every segment after the
    first reuses the boundary-adjusted grid, and the result still equals
    the reference's full recompute."""
    prob = CASES["zonal"]()
    (key, segs), = prob.kscan_runs()
    assert len(segs) == 3
    jst, pst = prob.initial()
    jst, jys, pst, pys = prob.kscan(jst, pst, key, segs, grid_incremental=False)
    _j2, pst2 = prob.initial()
    _j3, _jys3, pst2, pys2 = prob.kscan(prob.initial()[0], pst2, key, segs, grid_incremental=True)
    assert pys2.grid_reused.tolist() == [False, True, True]
    a, b = p_solver.to_numpy(pst), p_solver.to_numpy(pst2)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    _assert_leaves_equal(jst, pst2, "incremental == full recompute")


def _segment_inputs(prob, seg):
    """The window-side inputs one kind-scan segment's grid sees, after a
    first dispatch has opened claims."""
    jst, pst = prob.initial()
    key, segs = prob.kscan_runs()[0]
    jst, _jys, pst, _pys = prob.kscan(jst, pst, key, segs[:1])
    return key, pst


@pytest.mark.parametrize("case", ["zonal", "mixed"])
def test_kscan_grid_plain_matches_reference(case):
    """H5's plain modes against the reference's _cap_res_grid, _kscan_capd
    and _kscan_fits_final (jitted) on a window with open claims, for the
    zone key and for a non-zone key (capacity type)."""
    prob = CASES[case]()
    key, pst = _segment_inputs(prob, 0)
    enc = prob.enc
    it_p = prob.p_args[1]
    it_j = prob.js.it_tensors
    zone_kid, ct_kid = enc["zone_kid"], enc["ct_kid"]
    req = np.asarray(enc["requests_k"], dtype=np.float32)[1]
    used = p_solver.to_numpy(pst)["used"]
    grid_j = np.asarray(jax.jit(j_solver._cap_res_grid)(jnp.asarray(used), jnp.asarray(req), it_j))
    grid_p = p_solver.cap_res_grid_plain(torch.from_numpy(used), torch.from_numpy(req), it_p)
    assert np.array_equal(grid_j, grid_p.numpy())
    rng = np.random.default_rng(0)
    W, T = used.shape[0], grid_j.shape[1]
    viable = rng.random((W, T)) < 0.6
    mask = p_solver.to_numpy(pst)["reqs.mask"]
    ct_mask, zmask = mask[:, ct_kid, :], mask[:, zone_kid, :]
    for kid in (key, ct_kid):
        D = len(prob.js.encoder.vocab.values[kid])
        capd = functools.partial(jax.jit, static_argnames=("key_kid", "zone_kid", "D"))(j_solver._kscan_capd)
        want = np.asarray(capd(
            jnp.asarray(grid_j), jnp.asarray(viable), jnp.asarray(ct_mask), jnp.asarray(zmask), it_j,
            key_kid=kid, zone_kid=zone_kid, D=D,
        ))
        got = p_solver.kscan_capd_plain(
            grid_p, torch.from_numpy(viable), torch.from_numpy(ct_mask), torch.from_numpy(zmask), it_p,
            kid, zone_kid, D,
        )
        assert np.array_equal(want, got.numpy()), kid
        g2, c2 = p_solver.kscan_grid(
            torch.from_numpy(used), torch.from_numpy(req), it_p, torch.from_numpy(viable),
            torch.from_numpy(mask), zone_kid, ct_kid, kid, D,
        )
        assert torch.equal(g2, grid_p) and torch.equal(c2, got)
        placed = rng.integers(0, 4, W).astype(np.int32)
        zset = rng.random((W, D)) < 0.5
        fits = functools.partial(jax.jit, static_argnames=("key_kid", "zone_kid", "D"))(j_solver._kscan_fits_final)
        want = np.asarray(fits(
            jnp.asarray(grid_j), jnp.asarray(placed), jnp.asarray(zset), jnp.asarray(ct_mask),
            jnp.asarray(zmask), it_j, key_kid=kid, zone_kid=zone_kid, D=D,
        ))
        got = p_solver.kscan_fits_final(
            grid_p, torch.from_numpy(placed), torch.from_numpy(zset), torch.from_numpy(ct_mask),
            torch.from_numpy(zmask), it_p, kid, zone_kid, D,
        )
        assert np.array_equal(want, got.numpy()), kid


def test_per_key_ok_at_matches_reference():
    prob = CASES["mixed"]()
    key, pst = _segment_inputs(prob, 0)
    it_p = prob.p_args[1]
    st = p_solver.to_numpy(pst)
    b = ReqSetTensors(*(torch.from_numpy(st[f"reqs.{f}"]) for f in ReqSetTensors._fields))
    jb = j_kernels.ReqSetTensors(*(jnp.asarray(st[f"reqs.{f}"]) for f in ReqSetTensors._fields))
    for k in (key, prob.enc["ct_kid"]):
        want = np.asarray(jax.jit(j_kernels.per_key_ok_at, static_argnums=2)(prob.js.it_tensors.reqs, jb, k))
        assert np.array_equal(want, p_kernels.per_key_ok_at(it_p.reqs, b, k).numpy()), k


def test_compact_banks_topology_key_rows():
    """A compaction that evicts claims whose zone the kind scan narrowed:
    the bank keeps each claim's topology-key rows (mask / inf / defined),
    leaf for leaf the reference's compact_state, and global_claims merges
    them back for the decode."""
    prob = _Problem(bench.zonal_pods(40, kinds=2), n_types=24, max_claims=48)
    enc = prob.enc
    tk = enc["topo_kids"]
    assert tk
    jst, pst = prob.initial()
    (key, segs), = prob.kscan_runs()
    jst, _jys, pst, _pys = prob.kscan(jst, pst, key, segs[:1])
    # a floor no claim can take: every open claim dies into the bank
    r_min = np.asarray(enc["requests_k"], dtype=np.float32).max(axis=0) * 64
    jst, jclosed = j_solver.compact_state(jst, prob.js.it_tensors, jnp.asarray(r_min), enc["n_claims"], topo_kids=tk)
    pst, pclosed = p_solver.compact_state(
        pst, prob.p_args[1], torch.from_numpy(r_min), enc["n_claims"], topo_kids=tk
    )
    assert int(jclosed) == int(pclosed) > 0
    _assert_leaves_equal(jst, pst, "compacted with topo_kids")
    banked = pst.bank_tk_def[pst.bank_frozen]
    assert bool(banked.any()), "no narrowed key row reached the bank"
    jg = _tonp(j_solver.global_claims(jst, tk))
    pg = p_solver.global_claims(pst, topo_kids=tk)
    for k in ("template", "its", "used", "held", "tk_mask", "tk_inf", "tk_def"):
        assert np.array_equal(jg[k], pg[k].numpy()), k
    # and a second run against the compacted state still matches
    jst, jys, pst, pys = prob.kscan(jst, pst, key, segs[1:])
    _assert_leaves_equal(jys, pys, "ys after compaction")
    _assert_leaves_equal(jst, pst, "state after compaction")


def test_plain_flag_is_the_cpu_path():
    """plain=True selects the same functions the CPU wrappers run."""
    prob = CASES["web_existing"]()
    (key, segs), = prob.kscan_runs()
    _j, pst = prob.initial()
    _jx, pxs = prob.kind_xs(segs)
    enc = prob.enc
    counts = [hi - lo for lo, hi, _k in segs]
    req = np.asarray(enc["requests_k"], dtype=np.float32)[[k for _lo, _hi, k in segs]]
    kw = dict(key_kid=key, n_domains=len(prob.js.encoder.vocab.values[key]), maxc=64, counts=counts, requests_np=req)
    a, ya = p_solver.solve_kind_scan(pst, pxs, *prob.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"], **kw)
    b, yb = p_solver.solve_kind_scan(
        pst, pxs, *prob.p_args, enc["zone_kid"], enc["ct_kid"], enc["n_claims"], plain=True, **kw
    )
    for x, y in ((a, b), (ya, yb)):
        fa, fb = p_solver.to_numpy(x), p_solver.to_numpy(y)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert int((ya.assignment == 0).sum()) > 0, "no pod landed on the existing node"


def test_launchers_accept_what_the_solve_passes(monkeypatch):
    """Every CUDA launcher's argument checks (device, dtype, shape,
    contiguity, field counts) on the exact tensors a topology solve hands
    its kernels, here on the CPU with the C call stubbed out: each kernel
    call is validated by its launcher, then computed by its plain version,
    and the solve's result is unchanged."""
    from karpenter_tpu_torch import testing as p_testing
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
    from karpenter_tpu_torch.ops import cuda as p_cuda

    def solve():
        s = TorchScheduler(p_testing.make_templates(24), max_claims=32, device="cpu", plain=True)
        s.compact_min_pods = 50
        r = s.solve(p_testing.mixed_pods(100))
        return [(c.slot, [p.name for p in c.pods], str(c.requirements)) for c in r.claims], s.last_stats

    want, _ = solve()
    seen = {}
    monkeypatch.setattr(p_cuda, "_call", lambda name, *a: seen.__setitem__(name, seen.get(name, 0) + 1))
    P, K = p_solver.PLAIN_OPS, p_solver.KSCAN_PLAIN_OPS

    def checked(launch, plain):
        def run(*args):
            launch(*args)
            return plain(*args)

        return run

    monkeypatch.setattr(p_solver, "PLAIN_OPS", p_solver._Ops(
        checked(p_cuda.req_intersects, P.intersects),
        checked(lambda u, v, q, it, m, z, c: p_cuda.fill_count_grid(0, u, q, it, m, z, c, v.shape[0], viable=v),
                P.claim_fill_caps),
        checked(lambda u, n, q, it, m, z, c: p_cuda.fill_count_grid(1, u, q, it, m, z, c, n.shape[0], counts=n),
                P.fits_off_counted),
        checked(p_cuda.water_fill, P.water_fill),
        checked(p_cuda.compact_scatter, P.compact_scatter),
    ))
    monkeypatch.setattr(p_solver, "KSCAN_PLAIN_OPS", p_solver._KOps(
        checked(p_cuda.req_intersects, K.intersects),
        checked(p_cuda.kscan_grid, K.kscan_grid),
        checked(p_cuda.kscan_fits_final, K.kscan_fits_final),
        checked(lambda inp, c, topo, t, n, m, nc: p_cuda.kscan_pod_loop(inp, c, topo, n, m, nc, t.rank),
                K.kscan_pod_loop),
    ))
    # every fetch's leaves through the wire kernel's launcher (H15)
    monkeypatch.setattr(p_kernels, "pack_wire_plain", checked(p_cuda.wire_pack, p_kernels.pack_wire_plain))
    got, stats = solve()
    assert got == want
    assert stats["kscan_dispatches"] > 0 and stats["compactions"] > 0
    # every launcher but the per-pod kernels' (no kind here routes there;
    # tests/test_torch_perpod.py holds that launcher to the solve), their
    # scenario mode (tests/test_torch_whatif.py), the gang kernel's (no
    # gang here; tests/test_torch_gang_emulated.py), the retract
    # kernel's (no resident session here; tests/test_torch_retract_emulated.py)
    # the objective verdict's (a lexical solve has no objective round;
    # tests/test_torch_objective_emulated.py) and the dp kernels' (a dp = 1
    # solve has no merge round; tests/test_torch_shard_emulated.py)
    assert set(seen) == (set(p_cuda.KERNELS) - set(p_cuda.PERPOD_KERNELS) - set(p_cuda.WHATIF_KERNELS)
                         - {"gang_scan", "retract_tail", "objective_verdict", "dp_dead", "dp_verdict",
                            "merge_shard"}), seen
