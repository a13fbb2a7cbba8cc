"""The gang kernel's own source, csrc/gang_scan.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads) and routes ops/cuda.py's launch to that
library. Each case is a whole TorchScheduler solve on the CPU in which
every gang run goes through the plain loop (`_gang_step` per segment,
whose result the solve keeps) and through the emulated kernel on the same
inputs: every carry leaf the gang scan writes and every GangYs leaf
equal. The cases are small versions of chip_smoke.py's two gang cells
(a gang storm with its whale beside selector pods; zone- and
hostname-spread gangs beside zonal pods under a pool cpu limit) and the
routes around them: a tight nodes budget, a claims axis too small for a
slice, a gang that binds a host port (one pod a host), and zone
anti-affinity refusing a rank block (the whole gang spills); four family
pools (G = 4 templates) with a rank and without one; R = 7, 14 and 24
resource columns (registers, and read in place); a pool cpu limit
that a placement lowers below the types' caps, so that the walk's cap
words are refreshed and a later gang finds no type; gangs of 5 and 7
pods two to a host (the last rank block holds the remainder); a nodes
budget that spills five gangs while the kernel's producers run ahead of
its walk. Variant builds keep the producers' ring in device memory (its
shared-memory budget lowered by the source rewrite), test fits_at in the
walk itself, and bisect the max-fit counts from a wrong seed; four pools
under cost_min with a cpu limit on the cheapest (the template switches
once it runs out); gangs of three sizes in FFD order (consecutive
segments with equal pods a host and other requests). The emulator's
mbarrier blocks a waiting fiber until the phase completes, so a missing
wait between the producers and the walk reads a slot's old or unwritten
bytes. The emulation checks the kernel's logic, not its timing or what
the GPU compiler does with it: chip_smoke.py holds the compiled kernel to
the plain loop on the card. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.models.pod import HostPort, PodAffinityTerm
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library, limited_call


HELPERS = ("// ---- the mbarriers, the bulk copy and the producers' named barrier",
           "// ---- end of the mbarrier helpers")
EMU_HELPERS = """
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  emu_yield(8);
  emu_mbar_init(bar, (int)count);
}
__device__ __forceinline__ void mbar_fence_init() {}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar); }
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) { emu_mbar_arrive_tx(bar, bytes); }
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  emu_bulk_copy(dst, src, bytes, bar);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) { emu_mbar_wait(bar, parity); }
__device__ __forceinline__ void mbar_wait_idle(uint64_t* bar, uint32_t parity) { emu_mbar_wait(bar, parity); }
__device__ __forceinline__ void producers_sync() { emu_named_sync(kProducers); }
"""


# the walk's cap words, stored by lane 0 after a ballot and loaded by every
# lane: noted for the emulator's memory-order check (a ballot orders no
# memory, so a __syncwarp must stand between a store and another lane's load)
CAPW_NOTES = (
    ("          if (lane == 0) m.capw[(int64_t)g * TW + k0 + u] = w;\n",
     "          if (lane == 0) { emu_note_write(&m.capw[(int64_t)g * TW + k0 + u]); m.capw[(int64_t)g * TW + k0 + u] = w; }\n"),
    ("  for (int k = 0; k < TW; ++k)\n    all = all && m.capw[(int64_t)g * TW + k] ==",
     "  for (int k = 0; k < TW; ++k)\n    all = (emu_note_read(&m.capw[(int64_t)g * TW + k]), all) && m.capw[(int64_t)g * TW + k] =="),
)

# stores of the launch's set-up and the rounds their thread gives way
# before each (cuda_emu.h emu_yield): a read of what they store that lacks
# the barrier after them then meets the old bytes
SETUP_STORES = (("    m.budget[i] = p.budget[i];\n", 1024), ("    m.zcb[cell] = bits;\n", 256))


# variant builds: the producers' ring in the device workspace (its
# shared-memory budget lowered); the walk testing fits_at at c_j itself, as
# where the max-fit counts do not stand for it (a request or daemon usage
# negative or not finite); the max-fit counts bisected from a wrong seed
VARIANTS = {
    "ring_in_device_memory": ("constexpr size_t kRingSmem = kSmemMax;", "constexpr size_t kRingSmem = 16;"),
    "fits_at_in_the_walk": ("    bool mono = true;\n", "    bool mono = false;\n"),
    "bisected_max_fit": ("maxfit_of<kN>(dg, rq, al, R, cnt)", "maxfit_of<kN>(dg, rq, al, R, cnt / 2)"),
}


def _rewrite(src: str, variant: str = "") -> str:
    """Dynamic shared memory (zeroed), the mbarriers, the bulk copy and
    the producers' named barrier for the emulator's (a wait blocks its
    fiber until the phase completes; a bulk copy lands when its barrier
    is waited on), threads that give way before set-up stores; a variant
    build's change (VARIANTS)."""
    a, b = (src.index(h) for h in HELPERS)
    src = src[:a] + EMU_HELPERS + src[b:]
    for a, b in CAPW_NOTES:
        assert src.count(a) == 1
        src = src.replace(a, b)
    for store, rounds in SETUP_STORES:
        assert src.count(store) == 1
        src = src.replace(store, f"    emu_yield({rounds});\n" + store)
    if variant:
        old, new = VARIANTS[variant]
        assert src.count(old) == 1
        src = src.replace(old, new)
    # shared memory starts zeroed (thread 0 runs first): a read before its
    # store then finds no valid cell, no offering and no budget, and the
    # walk's result differs
    return src.replace("extern __shared__ __align__(16) char smem[];",
                       "char* smem = emu_smem();\n  if (threadIdx.x == 0) memset(smem, 0, g_emu->smem.size());")


def _invoker(lib):
    """ops/cuda.py's C-entry call routed to an emulated build's entries."""
    entries = {e: c_entry(lib, e) for e in ("gang_scan", "gang_scan_workspace")}

    def invoke(source, entry, *args):
        assert source == "gang_scan"
        rc = limited_call(entries[entry], *args, None)
        if rc:
            raise p_cuda.KernelError(f"emulated {entry}: error {rc}")

    return invoke


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated gang kernel."""
    invoke = _invoker(emulated_library(tmp_path_factory, "gang_scan", rewrite=_rewrite))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def emulated_variant(request, tmp_path_factory):
    """The same for each variant build."""
    invoke = _invoker(emulated_library(tmp_path_factory, "gang_scan", rewrite=lambda s: _rewrite(s, request.param)))

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _leaves(x) -> dict:
    return p_solver.to_numpy(x)


def _checked(invoke, monkeypatch):
    """ops.solver.solve_gang run twice on every gang run of a solve — the
    plain loop (kept) and the emulated kernel after the batched precompute
    — with every written carry leaf and GangYs leaf compared; yields the
    list of runs checked, a dict each (B, maxg, key_kid, G, rank, the
    segments' counts, the plain loop's GangYs and budgets before and
    after)."""
    runs = []
    plain_solve_gang = p_solver.solve_gang
    monkeypatch.setattr(p_cuda, "_invoke", invoke)
    monkeypatch.setattr(p_cuda, "_GANG_LAYOUTS", p_cuda.LayoutCache(16))  # layouts of this build's plan

    def both(state, xs, exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims, maxg,
             key_kid=-1, n_domains=1, tk_idx=-1, plain=False):
        st_p, ys_p = plain_solve_gang(state, xs, exist, it, templates, well_known, topo, zone_kid, ct_kid,
                                      n_claims, maxg, key_kid, n_domains, tk_idx, plain=True)
        pre = p_solver.gang_precompute(xs, it, templates, well_known, topo, zone_kid, ct_kid, key_kid, n_domains)
        st_k = state._replace(**{f: getattr(state, f).clone() for f in p_solver.GANG_WRITES})
        ys_k = p_solver.GangYs(*p_cuda.gang_scan(pre, st_k, exist, it, templates, topo, zone_kid, n_claims, maxg,
                                                 key_kid, n_domains, tk_idx))
        a, b = _leaves(st_p), _leaves(st_k)
        assert set(a) == set(b)
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not bad, bad
        ya, yb = _leaves(ys_p), _leaves(ys_k)
        bad = [k for k in ya if not np.array_equal(ya[k], yb[k])]
        assert not bad, (bad, ya, yb)
        runs.append(dict(B=int(xs.count.shape[0]), maxg=maxg, key_kid=key_kid, G=int(templates.its.shape[0]),
                         rank=templates.rank is not None, count=xs.count.tolist(), ys=ya,
                         budget0=state.budget.tolist(), budget1=st_p.budget.tolist(), cap=it.cap.tolist()))
        return st_p, ys_p

    monkeypatch.setattr(p_solver, "solve_gang", both)
    return runs


@pytest.fixture
def checked(emulated, monkeypatch):
    return _checked(emulated, monkeypatch)


@pytest.fixture
def checked_variant(emulated_variant, monkeypatch):
    return _checked(emulated_variant, monkeypatch)


def _host_port_gang(n: int = 4):
    pods = T.make_gang_pods("ingress-gang", n, cpu=0.5)
    for p in pods:
        p.spec.host_ports = [HostPort(port=8443)]
    return pods


def _with_resources(pods: list, extra: int) -> list:
    """The pods naming `extra` extended resources at zero: R = 4 + extra
    resource columns (the kernel keeps R <= 4, 8 and 16 in registers and
    reads more in place)."""
    for p in pods:
        p.spec.requests.update({f"example.com/r{r}": 0.0 for r in range(extra)})
    return pods


def _zone_anti_gang(n: int):
    """One member a host, hosts in pairwise different zones: past the four
    zones a rank block is refused and the gang spills."""
    pods = _host_port_gang(n)
    for p in pods:
        p.metadata.labels = dict(p.metadata.labels or {}, anti="ingress-gang")
        p.spec.pod_anti_affinity = [PodAffinityTerm(topology_key=T.l.LABEL_TOPOLOGY_ZONE,
                                                    label_selector={"anti": "ingress-gang"})]
    return pods


CASES = {
    # name: (templates, max_claims, pods, budgets, want a key run)
    "gang_storm": lambda: (T.make_templates(24), 128, T.gang_storm_pods(6, 4, 48), None, False),
    "gang_zonal_budget": lambda: (
        T.make_templates(24), 128, T.gang_zonal_pods(4, 4, 2, 3, 48, 2), {"default": {"cpu": 60.0}}, True),
    "gang_zonal": lambda: (T.make_templates(24), 128, T.gang_zonal_pods(5, 6, 3, 4, 24, 2), None, True),
    "tight_nodes_budget": lambda: (
        T.make_templates(16), 64, T.make_gang_pods("gt", 4, cpu=6.0) + T.selector_pods(6), {"default": {"nodes": 1.0}},
        False),
    "claims_axis_escalates": lambda: (T.make_templates(16), 4, T.gang_storm_pods(3, 6, 6), None, False),
    "host_port_gang": lambda: (T.make_templates(16), 64, _host_port_gang() + T.selector_pods(8), None, False),
    "zone_anti_affinity_spills": lambda: (T.make_templates(16), 64, _zone_anti_gang(6) + T.selector_pods(4), None,
                                          True),
    # a placement objective's rank on the slice template (cost_min reverses
    # the four family pools' weight order), with and without a key
    "gang_storm_cost_min_rank": lambda: (T.mixed_pool_templates(24), 128, T.gang_storm_pods(6, 4, 48), None, False,
                                         "cost_min"),
    "gang_zonal_cost_min_rank": lambda: (T.mixed_pool_templates(24), 128, T.gang_zonal_pods(5, 6, 3, 4, 24, 2), None,
                                         True, "cost_min"),
    # G = 4 templates in weight order (no rank column): the first pool wins
    "pools_no_rank": lambda: (T.mixed_pool_templates(24), 128, T.gang_storm_pods(6, 4, 48), None, False, "lexical"),
    # a cpu limit the placements use up: the cap words of the template are
    # refreshed after each placement, and the last gang finds no type
    "budget_refreshes_cap_words": lambda: (T.make_templates(24), 128, T.gang_storm_pods(6, 4, 48),
                                           {"default": {"cpu": 40.0}}, False),
    # 2 pods a host: 7 pods on 4 hosts and 5 on 3, the last host the remainder
    "want_3_with_a_remainder": lambda: (
        T.make_templates(24), 64, T.make_gang_pods("w7", 7, cpu=1.5) + T.make_gang_pods("w5", 5, cpu=1.5)
        + T.selector_pods(6), None, False),
    # R = 7, 14 and 24 resource columns, with a key and without one
    "resources_7": lambda: (T.make_templates(24), 128, _with_resources(T.gang_storm_pods(6, 4, 48), 3), None, False),
    "resources_14_zonal": lambda: (T.make_templates(24), 128, _with_resources(T.gang_zonal_pods(4, 4, 2, 3, 48, 2), 10),
                                   {"default": {"cpu": 60.0}}, True),
    "resources_24": lambda: (T.make_templates(24), 128, _with_resources(T.gang_storm_pods(6, 4, 48), 20), None, False),
    # cost_min picks e-pool until its cpu limit runs out: cap words of a
    # template another warp set up, refreshed after placements
    "pools_budget_switches_template": lambda: (T.mixed_pool_templates(24), 128, T.gang_storm_pods(8, 4, 48),
                                               {"e-pool": {"cpu": 30.0}}, False, "cost_min"),
    # gangs of three sizes in FFD order: consecutive segments with the same
    # pods a host and another request must not reuse each other's rows
    "three_gang_sizes": lambda: (
        T.make_templates(24), 128, sum((T.make_gang_pods(f"m{i}", 4, cpu=(1.5, 1.9, 0.7)[i % 3]) for i in range(9)),
                                       []) + T.selector_pods(8), None, False),
    # a nodes budget for two gangs: the third to seventh spill while the
    # producers run ahead of the walk
    "spill_with_producers_ahead": lambda: (
        T.make_templates(24), 64, sum((T.make_gang_pods(f"s{i}", 4, cpu=1.5) for i in range(7)), [])
        + T.selector_pods(4), {"default": {"nodes": 5.0}}, False),
}


def _runs_show(case: str, runs: list) -> None:
    """What a case is for, seen in its runs."""
    ys = [(r, i) for r in runs for i in range(r["B"])]
    if case.startswith("pools") or case.endswith("cost_min_rank"):
        assert all(r["G"] >= 2 for r in runs) and all(r["rank"] == (case != "pools_no_rank") for r in runs)
    if case == "budget_refreshes_cap_words":
        placed = [i for r, i in ys if r["ys"]["n_opened"][i] > 0]
        assert any(r["ys"]["status"][i] == p_solver.NO_CLAIM and r["count"][i] > 0 and i > placed[0] for r, i in ys)
        r = runs[0]
        assert any(all(c <= b for c, b in zip(cap, r["budget0"][0])) and not all(c <= b for c, b in zip(cap, r["budget1"][0]))
                   for cap in r["cap"]), "no type's cap went past the refreshed budget"
    if case.startswith("resources"):
        assert all(len(r["budget0"][0]) == int(case.split("_")[1]) for r in runs)
        assert any(r["ys"]["n_opened"][i] > 0 for r, i in ys)
    if case == "pools_budget_switches_template":
        assert len({r["ys"]["tmpl"][i] for r, i in ys if r["ys"]["n_opened"][i] > 0}) >= 2
    if case == "three_gang_sizes":
        fills = [r["ys"]["fill"][i] for r, i in ys if r["count"][i] > 0]
        assert len(set(fills)) >= 2 and any(a == b for a, b in zip(fills, fills[1:]))
    if case == "want_3_with_a_remainder":
        assert any(r["ys"]["n_opened"][i] >= 3 and r["count"][i] % r["ys"]["fill"][i] for r, i in ys)
    if case == "spill_with_producers_ahead":
        spills = [i for r, i in ys if r["ys"]["status"][i] == p_solver.GANG_SPILL]
        assert len(spills) >= 4 and min(spills) + 3 < runs[0]["B"]


def _solve_case(case: str, runs: list) -> None:
    templates, max_claims, pods, budgets, keyed, *objective = CASES[case]()
    sched = TorchScheduler(templates, max_claims=max_claims, device="cpu", objective=(objective or [None])[0])
    result = sched.solve(pods, budgets=budgets)
    assert runs, "no gang run"
    assert any(r["key_kid"] >= 0 for r in runs) == keyed
    assert any(c.gang for c in result.claims) or result.unschedulable
    if objective == ["cost_min"] and not budgets:
        assert {c.template.nodepool_name for c in result.claims if c.gang} == {"e-pool"}
    _runs_show(case, runs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gang_kernel_source_matches_plain_loop(case, checked):
    """Every gang run of the solve: the kernel source's carry and records
    equal the plain loop's (the solve itself keeps the plain result)."""
    _solve_case(case, checked)


@pytest.mark.parametrize("case", ["gang_storm", "gang_zonal_budget", "want_3_with_a_remainder"])
def test_gang_kernel_variant_builds(case, checked_variant):
    """The same on each variant build: the producers' ring in the kernel's
    device workspace (the layout a launch takes when three slots do not
    fit in shared memory), the walk testing fits_at itself, the max-fit
    counts found by bisection."""
    _solve_case(case, checked_variant)
