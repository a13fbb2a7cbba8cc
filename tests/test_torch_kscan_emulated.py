"""The kind scan's pod-loop kernel (H6), csrc/kscan_pod_loop.cu, run on
the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one thread per CUDA thread,
barriers for __syncthreads and the warp collectives) and routes ops/cuda.py's
launch to that library. In CPU solves with kind-scan kinds, every segment's
pod loop runs through the emulated kernel and through the plain loop
(ops/solver.py kscan_pod_loop_plain) from the same carry: the assignment
and every carry leaf equal. The cases cover weight order and a placement
objective's template rank on tier 3 (cost_min's, which reverses the
weight order over the four family pools; a signed rank with ties). The
emulation checks the kernel's logic, not its timing or what the GPU
compiler does with it: chip_smoke.py holds the compiled kernel to the
plain loop on the card. Tolerance: exact.
"""

import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated pod-loop kernel."""
    lib = emulated_library(tmp_path_factory, "kscan_pod_loop")
    fn = c_entry(lib, "kscan_pod_loop")

    def invoke(source, entry, *args):
        assert (source, entry) == ("kscan_pod_loop", "kscan_pod_loop")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated kscan_pod_loop: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


SOLVES = {
    # name: (templates, max_claims, pods, scheduler keywords)
    "weight_order": lambda: (T.make_templates(24), 32, T.zonal_pods(24, kinds=2), {}),
    "cost_min_reverses_weight": lambda: (T.mixed_pool_templates(24), 32, T.zonal_pods(24, kinds=2),
                                         {"objective": "cost_min"}),
    "cost_min_mixed": lambda: (T.mixed_pool_templates(24), 64, T.mixed_pods(40), {"objective": "cost_min"}),
    "signed_rank_with_ties": lambda: (T.mixed_pool_templates(24), 32, T.zonal_pods(24, kinds=2),
                                      {"objective": "cost_min", "_rank": [1, -1, 1, -3]}),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_emulated_pod_loop_equals_plain_loop(case, emulated, monkeypatch):
    """Every kind-scan segment of a CPU solve through the emulated kernel
    and the plain loop from the same carry: assignment and carry equal."""
    templates, max_claims, pods, kw = SOLVES[case]()
    kw = dict(kw)
    rank = kw.pop("_rank", None)
    if rank is not None:
        monkeypatch.setattr(TorchScheduler, "_objective_rank",
                            lambda self, policy: torch.tensor(rank, dtype=torch.int32))
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.kscan_pod_loop_plain
    seen = []

    def both(inp, c, topo, tm, count, maxc, n_claims):
        ck = p_solver.PodLoopCarry(*(x.clone() for x in c))
        ak = p_cuda.kscan_pod_loop(inp, ck, topo, count, maxc, n_claims, tm.rank)
        ap = plain(inp, c, topo, tm, count, maxc, n_claims)
        assert torch.equal(ak, ap), (case, len(seen), ak.tolist(), ap.tolist())
        bad = [f for f, a, b in zip(c._fields, ck, c) if not torch.equal(a, b)]
        assert not bad, (case, len(seen), bad)
        seen.append((count, tm.rank is not None))
        return ap

    monkeypatch.setattr(p_solver, "kscan_pod_loop_plain", both)
    s = TorchScheduler(templates, max_claims=max_claims, device="cpu", **kw)
    r = s.solve(pods)
    assert seen and s.last_stats["kscan_dispatches"] > 0 and r.node_count > 0
    assert all(has_rank == ("objective" in kw) for _n, has_rank in seen)
    if case == "cost_min_reverses_weight":
        assert {c.template.nodepool_name for c in r.claims} == {"e-pool"}
