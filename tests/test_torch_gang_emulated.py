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
anti-affinity refusing a rank block (the whole gang spills). The emulation
checks the kernel's logic, not its timing or what the GPU compiler does
with it: chip_smoke.py holds the compiled kernel to the plain loop on the
card. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.models.pod import HostPort, PodAffinityTerm
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library


def _rewrite(src: str) -> str:
    """Dynamic shared memory for the emulator's."""
    return src.replace("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated gang kernel."""
    lib = emulated_library(tmp_path_factory, "gang_scan", rewrite=_rewrite)
    fn = c_entry(lib, "gang_scan")

    def invoke(source, entry, *args):
        assert (source, entry) == ("gang_scan", "gang_scan")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated gang_scan: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _leaves(x) -> dict:
    return p_solver.to_numpy(x)


@pytest.fixture
def checked(emulated, monkeypatch):
    """ops.solver.solve_gang run twice on every gang run of a solve — the
    plain loop (kept) and the emulated kernel after the batched precompute
    — with every written carry leaf and GangYs leaf compared; yields the
    list of runs checked, (B, maxg, key_kid) each."""
    runs = []
    plain_solve_gang = p_solver.solve_gang
    monkeypatch.setattr(p_cuda, "_invoke", emulated)

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
        runs.append((int(xs.count.shape[0]), maxg, key_kid))
        return st_p, ys_p

    monkeypatch.setattr(p_solver, "solve_gang", both)
    yield runs


def _host_port_gang(n: int = 4):
    pods = T.make_gang_pods("ingress-gang", n, cpu=0.5)
    for p in pods:
        p.spec.host_ports = [HostPort(port=8443)]
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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gang_kernel_source_matches_plain_loop(case, checked):
    """Every gang run of the solve: the kernel source's carry and records
    equal the plain loop's (the solve itself keeps the plain result)."""
    templates, max_claims, pods, budgets, keyed, *objective = CASES[case]()
    sched = TorchScheduler(templates, max_claims=max_claims, device="cpu", objective=(objective or [None])[0])
    result = sched.solve(pods, budgets=budgets)
    assert checked, "no gang run"
    assert any(k >= 0 for _b, _m, k in checked) == keyed
    assert any(c.gang for c in result.claims) or result.unschedulable
    if objective:
        assert {c.template.nodepool_name for c in result.claims if c.gang} == {"e-pool"}
