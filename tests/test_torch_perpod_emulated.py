"""The per-pod kernel's own source, csrc/perpod_scan.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread, barriers
for __syncthreads and the warp collectives) and routes ops/cuda.py's launch
to that library. Each case is a whole TorchScheduler solve on the CPU in
which every per-pod chunk runs through the emulated kernel, in three
launches of consecutive steps, and through the plain loop: the assignment
and every carry leaf equal (the reservation capacities and held rows
included); and what-if batches whose scenario-mode launch equals the
plain per-scenario loop. Among them: minValues floors, reservations
(fallback and strict), budgets and host ports; a spread count past 2^15
(the rank key wraps); 40 allocatable groups; a placement objective's
template rank on tier 3 (cost_min's, which reverses the weight order; a
signed rank with ties), in single and scenario mode. The emulation checks the kernel's
logic, not its timing or what the GPU compiler does with it: chip_smoke.py
holds the compiled kernel to the plain loop on the card. Tolerance: exact.
"""

import ctypes
import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library


def _rewrite(src: str) -> str:
    """Dynamic shared memory, the bulk copy and its mbarrier for the
    emulator's (a memcpy and a barrier)."""
    src = src.replace("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();")
    a = src.index("__device__ __forceinline__ void stage_tables(")
    b = src.index("struct Pick {")
    return src[:a] + (
        "__device__ __forceinline__ void stage_tables(const TabArgs& ta, char* dst, uint64_t* bar) {\n"
        "  __syncthreads();\n  if (threadIdx.x == 0) memcpy(dst, ta.base, ta.staged);\n}\n"
        "__device__ __forceinline__ void wait_tables(uint64_t* bar) { __syncthreads(); }\n\n"
    ) + src[b:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py with its per-pod launches routed to the emulated kernel
    (its library as .lib)."""
    lib = emulated_library(tmp_path_factory, "perpod_scan", rewrite=_rewrite)
    fn = c_entry(lib, "perpod_steps")

    def invoke(source, entry, *args):
        assert (source, entry) == ("perpod_scan", "perpod_steps")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated perpod_steps: error {rc}")

    invoke.lib = lib

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


# reservations of the constrained cases: catalog index -> (zone, id, capacity)
RES_SMALL = {16: ("test-zone-1", "res-a", 3), 18: ("test-zone-2", "res-b", 2), 20: ("test-zone-1", "res-c", 1)}
def seeded_topology(pods, templates, nodes=(), side=T.PORT):
    """The pods' topology with every zone-spread domain's count seeded past
    2^15 (testing.seed_big_counts)."""
    return T.seed_big_counts(side.Topology.build(list(pods), lambda: side.build_universe_domains(
        templates, list(nodes), template_base=side.template_universe_domains(templates))), side)


def many_groups_templates(n_groups: int = 40):
    """make_templates(8) plus a type whose offerings carry n_groups
    distinct capacity overrides: n_groups allocatable groups."""
    from karpenter_tpu_torch.cloudprovider.fake import new_instance_type

    it = new_instance_type("grouped-8x", cpu=8)
    base = list(it.offerings)
    it.offerings = [
        type(o)(requirements=o.requirements, price=o.price + 0.001 * g, available=True,
                capacity_override={"memory": float((8 + g) * 2**30)})
        for g, o in ((g, base[g % len(base)]) for g in range(n_groups))
    ]
    it._allocatable_offerings = None
    pool = T.NodePool()
    pool.metadata.name = "default"
    return T.build_templates([(pool, T.instance_types(8) + [it])])


def _same(a, b) -> list:
    fa, fb = p_solver.to_numpy(a), p_solver.to_numpy(b)
    return [k for k in fa if not np.array_equal(fa[k], fb[k])]


SOLVES = {
    # name: (templates, max_claims, pods, existing nodes)
    "mixed_and_perpod": lambda: (T.make_templates(24), 64, T.mixed_pods(30) + T.perpod_pods(40), []),
    "custom_key_fallback": lambda: (T.tier_templates(24), 32, T.tier_pods(), []),
    "hostname_groups_existing_node": lambda: (T.make_templates(24), 64, T.guarded_pods(40), [T.existing_node()]),
    "zone_key_17_values": lambda: (T.make_templates(24), 64, T.wide_zone_pods(32), [T.existing_node(cpu=1.0)]),
    "zone_key_45_values": lambda: (
        T.make_templates(24), 64, T.wide_zone_pods(32, extra_zones=41), [T.existing_node(cpu=1.0)]),
    "window_spills": lambda: (T.make_templates(24), 8, T.perpod_pods(64, kinds=4), []),
    # K = 8 keys, V = 4096 values, NGv = 2: the widest vocabulary the
    # earlier two-kernel design took at these K and NGv (a block workspace
    # of 2 K V + 14 NGv V bytes); here 2 of the 16 warps evaluate rows
    "zone_key_4096_values": lambda: (
        T.make_templates(24), 64, T.wide_zone_pods(32, extra_zones=2100), [T.existing_node(cpu=1.0)]),
    # R = 40 resources, past a warp's 32 lanes
    "resources_past_32": lambda: (T.make_templates(24), 32, T.many_resources_pods(), []),
    # enforced minValues (names and families), reservations, a cpu budget
    # and host ports: every kind on the per-pod scan, full type scans
    "constrained": lambda: (
        T.constrained_templates(24, reservations=RES_SMALL), 64, T.mixed_pods(40) + T.hostport_pods(6), [],
        {"budgets": {"default": {"cpu": 40.0}}}),
    # floors that bind: every family must stay viable on a claim
    "constrained_floors_bind": lambda: (
        T.constrained_templates(24, min_values=((T.FAMILY_KEY, 4), (T.l.LABEL_INSTANCE_TYPE, 6)), reservations={}),
        64, T.mixed_pods(40), []),
    "constrained_strict": lambda: (
        T.constrained_templates(24, min_values=(), reservations=RES_SMALL), 64,
        T.mixed_pods(30) + T.perpod_pods(16, kinds=2) + T.selector_pods(30), [], {}, {"reserved_mode": "strict"}),
    # zone counts past 2^15 through solve(topology=): the rank key wraps
    "rank_key_past_2_15": lambda: (
        T.make_templates(24), 64, T.perpod_pods(24, kinds=2), [],
        {"topology": seeded_topology(T.perpod_pods(24, kinds=2), T.make_templates(24))}),
    # GR = 40 allocatable groups, past a word of group bits
    "allocatable_groups_40": lambda: (many_groups_templates(40), 32, T.perpod_pods(24, kinds=2), []),
    # a placement objective's rank on tier 3: cost_min over the four family
    # pools (priciest first) tries them in reverse weight order (e, c, s,
    # m), so the tier's walk in rank order and its early stop are exercised
    "objective_cost_min_reverses_weight": lambda: (
        T.mixed_pool_templates(24), 64, T.perpod_pods(40, kinds=4), [], {}, {"objective": "cost_min"}),
    "objective_topo_spread_mixed": lambda: (
        T.mixed_pool_templates(24), 64, T.mixed_pods(30) + T.perpod_pods(24, kinds=2), [], {},
        {"objective": "topo_spread"}),
    # a rank with negative values and ties (a promoted variant's -1 and
    # equal ranks, ties to the lowest index): signed, never an index
    "objective_rank_signed_with_ties": lambda: (
        T.mixed_pool_templates(24), 64, T.perpod_pods(40, kinds=4), [], {},
        {"objective": "cost_min", "_rank": [1, -1, 1, -3]}),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_emulated_kernel_equals_plain_loop(case, emulated, monkeypatch):
    """Every per-pod chunk of a CPU solve through the emulated kernel, in
    launches of steps [0, 1), [1, L/2), [L/2, L) (each from the carry the
    last left), against the plain loop: assignment and every leaf equal."""
    templates, max_claims, pods, nodes, *extra = SOLVES[case]()
    solve_kw = extra[0] if extra else {}
    sched_kw = extra[1] if len(extra) > 1 else {}
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.perpod_loop_plain
    checked, flags = [], []

    def both(state, xs, ctx):
        sp, ap = plain(state, xs, ctx)
        sk = p_solver.own_perpod_writes(state)
        L = xs.requests.shape[0]
        a = p_cuda.perpod_steps(sk, xs, ctx, 0, min(1, L))
        p_cuda.perpod_steps(sk, xs, ctx, min(1, L), L // 2, a)
        p_cuda.perpod_steps(sk, xs, ctx, L // 2, L, a)
        assert torch.equal(a, ap), (case, len(checked), a.tolist(), ap.tolist())
        assert not _same(sk, sp), (case, len(checked), _same(sk, sp))
        checked.append(L)
        flags.append((ctx.flags.mv_active, ctx.flags.res_active, bool(sp.held.any()), int(ctx.it.zc_avail.shape[1]),
                      int(sp.vg_counts.max()), ctx.templates.rank))
        return sp, ap

    monkeypatch.setattr(p_solver, "perpod_loop_plain", both)
    sched_kw = dict(sched_kw)
    rank = sched_kw.pop("_rank", None)
    if rank is not None:
        monkeypatch.setattr(TorchScheduler, "_objective_rank",
                            lambda self, policy: torch.tensor(rank, dtype=torch.int32))
    s = TorchScheduler(templates, max_claims=max_claims, device="cpu", **sched_kw)
    r = s.solve(pods, existing_nodes=nodes, **solve_kw)
    # a NO_ROOM re-solve with a larger window runs its chunks again
    assert checked and 0 < s.last_stats["perpod_dispatches"] <= len(checked) and r.node_count > 0
    if case.startswith("constrained"):  # the branches ran: reservations held
        assert all(f[0] or f[1] for f in flags)
        if case != "constrained_floors_bind":
            assert all(f[1] for f in flags) and any(f[2] for f in flags) and (case != "constrained" or flags[0][0])
    if case == "allocatable_groups_40":
        assert flags[0][3] >= 40  # the base group and the 40 overrides
    if case == "rank_key_past_2_15":
        assert min(f[4] for f in flags) >= T.BIG_COUNT
    if case.startswith("objective_"):
        assert flags[0][5] is not None and r.claims
        if case == "objective_cost_min_reverses_weight":  # the cheapest family's pool, not the first
            assert {c.template.nodepool_name for c in r.claims} == {"e-pool"}


@pytest.fixture(scope="module")
def cluster():
    templates = T.make_templates(24)
    res = TorchScheduler(templates, device="cpu").solve(T.mixed_pods(48))
    cl = T.launch_claims(res, templates)
    return templates, cl, T.candidates(cl), T.pending_pods(6), T.topology_factory(cl)


@pytest.fixture(scope="module")
def constrained_cluster():
    """A cluster over the constrained templates (minValues, reservations):
    CSI limits and PVCs, reservations in use, the zone counts past 2^15."""
    templates = T.constrained_templates(24, reservations=RES_SMALL)
    res = TorchScheduler(templates, device="cpu").solve(T.mixed_pods(40))
    cl = T.launch_claims(res, templates)
    pending = T.pending_pods(6) + T.hostport_pods(2)
    kw = dict(pod_volumes=T.attach_volumes(cl, pending, every_bound=2, every_pending=2, limit=2),
              reserved_in_use=T.reserved_in_use(cl))
    base = T.topology_factory(cl)

    def factory(pods, excluded):
        return T.seed_big_counts(base(pods, excluded))

    return templates, cl, T.candidates(cl), pending, factory, kw


@pytest.fixture(scope="module")
def pool_cluster():
    """A cluster over the four family pools, provisioned under cost_min."""
    templates = T.mixed_pool_templates(24)
    res = TorchScheduler(templates, device="cpu", objective="cost_min").solve(T.mixed_pods(48))
    cl = T.launch_claims(res, templates)
    return templates, cl, T.candidates(cl), T.pending_pods(6), T.topology_factory(cl)


@pytest.mark.parametrize("kind", ["prefix", "single", "constrained_prefix", "constrained_strict", "rank_prefix"])
def test_emulated_kernel_whatif_equals_plain_loop(kind, emulated, cluster, constrained_cluster, pool_cluster,
                                                  monkeypatch):
    """A what-if batch whose one scenario-mode launch (a block per
    scenario) equals the plain loop run per scenario: assignments and every
    scenario's final carry (reservation capacities and held rows
    included). The constrained batches carry minValues, reservations (in
    use; strict in one), CSI limits and PVCs, host ports and zone counts
    past 2^15; the rank batch cost_min's template rank."""
    kw, sched_kw = {}, {}
    if kind == "rank_prefix":  # cost_min's rank on every scenario's tier 3
        templates, cl, cands, pending, factory = pool_cluster
        sched_kw = {"objective": "cost_min"}
        kind = "prefix"
    elif kind.startswith("constrained"):
        templates, cl, cands, pending, factory, kw = constrained_cluster
        sched_kw = {"reserved_mode": "strict"} if kind.endswith("strict") else {}
        kind = "prefix"
    else:
        templates, cl, cands, pending, factory = cluster
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.whatif_loop_plain
    seen = []

    def both(state0, xs, ctx, idx, valid, ev, vg0, hg0):
        assert (ctx.templates.rank is not None) == ("objective" in sched_kw)
        ap, sp = plain(state0, xs, ctx, idx, valid, ev, vg0, hg0)
        ak, sk = p_solver.whatif_loop_kernels(state0, xs, ctx, idx, valid, ev, vg0, hg0)
        assert torch.equal(ak, ap)
        assert all(not _same(a, b) for a, b in zip(sk, sp))
        seen.append(int((ak >= 0).sum()))
        return ap, sp

    monkeypatch.setattr(p_solver, "whatif_loop_plain", both)
    pods, specs = getattr(T, f"{kind}_scenarios")(cands, 5, pending)
    sig = TorchScheduler(templates, device="cpu", **sched_kw).whatif_batch(
        pods, [x.clone() for x in cl.nodes], None, specs, factory, **kw)
    assert sig is not None and seen and seen[0] > 0


def test_workspace_mirror_equals_the_kernel(emulated):
    """ops/cuda.py perpod_workspace (the launcher's check) equals the
    kernel's own carve, over K, V, NGv, NGh, R, T, G, the minValues keys J
    and the reservation ids RID over RZ zones, and the warps that
    evaluate rows; one warp's workspace fits every shape the earlier
    two-kernel design took (2 K V + 14 NGv V bytes and its 4 KB of static
    shared memory within a block's 227 KB), and wider ones."""
    fn = emulated.lib.perpod_workspace
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int64
    rng = np.random.default_rng(0)
    for _ in range(200):
        K, V = int(rng.choice([8, 16, 32])), int(rng.choice([8, 64, 512, 4096]))
        NGv, NGh, R, T_, G = (int(x) for x in rng.integers(1, 40, 5))
        Z, C = int(rng.integers(1, V + 1)), int(rng.integers(1, min(V, 4) + 1))
        J, M, RID, RZ = (int(x) for x in rng.integers(1, [4, 5, min(V, 40) + 1, Z + 1]))
        dims = [3, 64, G, T_, K, V, R, 2, Z, C, NGv, NGh, 70, 2, 1, 1, 64, 16, 0, 1, J, M, RID, RZ, 2, 2, 1, 1, 0]
        for nev in (1, 7, 16):
            assert p_cuda.perpod_workspace(dims, nev) == fn(p_cuda._i64_array(dims), nev), (dims, nev)
    room = p_cuda.SMEM_BLOCK - p_cuda.SMEM_STATIC
    flags_off = [1, 1, 1, 1, -1, -1, 0, 0, 0]  # J, M, RID, RZ, rid_kid, res_vid and the three flags
    for K in (8, 16, 32, 64):
        for V in (8, 64, 512, 1024, 4096, 8192, 16384):
            for NGv in (1, 2, 4, 16, 64):
                dims = [1, 64, 1, 400, K, V, 4, 1, 4, 2, NGv, 4, 70, 1, 1, 1, 64, 64, 0, 1] + flags_off
                if 2 * K * V + 14 * NGv * V + 16 * K + 12 * NGv + 48 + 4096 <= 227 * 1024:
                    assert p_cuda.perpod_workspace(dims, 1) <= room, (K, V, NGv)
    assert p_cuda.perpod_workspace([1, 64, 1, 400, 8, 8192, 4, 1, 4, 2, 1, 4, 70, 1, 1, 1, 64, 64, 0, 1]
                                   + flags_off) <= room


def test_launcher_refuses_a_workspace_too_wide(monkeypatch):
    """A vocabulary whose pod terms leave no room for one warp's row
    scratch (V = 4096 values, NGv = 64 groups): the launcher's check names
    K, V and NGv, and nothing is launched."""
    s = TorchScheduler(T.make_templates(24), max_claims=32, device="cpu")
    _sorted, enc = s._encode(T.perpod_pods(8, kinds=2), None)
    *rows, pod_topo = s._gather_pod_chunk(enc, np.zeros(8, dtype=np.int64), 8)
    xs = p_solver.pod_xs(*rows, pod_topo)
    it, tt = s.it_tensors, enc["topo_tensors"]
    T_, K = it.reqs.mask.shape[:2]
    wide_it = it._replace(reqs=it.reqs._replace(mask=torch.zeros((T_, K, 4096), dtype=torch.bool)))
    wide_tt = tt._replace(vg_type=torch.zeros(64, dtype=torch.int32))
    ctx = p_solver.PerPodCtx(enc["exist_tensors"], wide_it, enc["template_tensors"], s.well_known, wide_tt,
                             enc["zone_kid"], enc["ct_kid"], enc["n_claims"], tuple(enc["topo_kids"]))
    state = p_solver.initial_state(enc["exist_tensors"], it, enc["template_tensors"], tt, enc["n_claims"],
                                   enc["n_ports"], topo_kids=enc["topo_kids"])
    monkeypatch.setattr(p_cuda, "_invoke", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match=rf"K={K} keys x V=4096 values with NGv=64 vocab-key groups need"):
        p_cuda.perpod_steps(p_solver.own_perpod_writes(state), xs, ctx, 0, 1)
