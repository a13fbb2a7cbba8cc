"""The wire kernel's own source, csrc/wire_pack.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, std::atomic for the
atomics) and routes ops/cuda.py's launch to that library. ops/cuda.py's
launcher (its descriptor table included) then runs on CPU tensors and is
held to the plain version, ops/kernels.py pack_wire_plain, byte for byte:
on tests/test_torch_wire.py's leaf sets (0-d and empty leaves, bool
groups straddling leaves, groups that start unaligned after an odd bool
group, int16 / uint32 / float32 beside int32), on a pipeline group's
prep (live-row slices, int32 -> int16 narrowing, a fill_max over whole
grids whose max sits in a padding row, an empty fill_e grid), and on
every fetch of pipelined CPU solves and a dp solve's verdict words. The
emulation checks the kernel's logic, not its timing or what the GPU
compiler does with it: chip_smoke.py holds the compiled kernel to the
plain version on the card. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.controllers.provisioning import scheduler as p_sched
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import kernels as p_kernels
from cuda_emu_build import c_entry, emulated_library
from test_torch_wire import LEAF_SETS, _numpy_set, _outputs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated wire kernel."""
    lib = emulated_library(tmp_path_factory, "wire_pack")
    fn = c_entry(lib, "wire_pack")

    def invoke(source, entry, *args):
        assert (source, entry) == ("wire_pack", "wire_pack")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated wire_pack: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _check(monkeypatch, emulated, leaves, what):
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    before = p_cuda.LAUNCHES["wire_pack"]
    got = p_cuda.wire_pack(leaves)
    assert p_cuda.LAUNCHES["wire_pack"] == before + 1
    want = p_kernels.pack_wire_plain(leaves)
    assert got.dtype == torch.uint8 and got.shape == want.shape, what
    assert torch.equal(got, want), what


@pytest.mark.parametrize("name", sorted(LEAF_SETS))
def test_emulated_wire_on_leaf_sets(monkeypatch, emulated, name):
    _check(monkeypatch, emulated, [torch.from_numpy(a.copy()) for a in _numpy_set(name, seed=5)], name)


def test_emulated_wire_on_a_group_prep(monkeypatch, emulated):
    """A pipeline group's leaves (slices, narrowing, the fill_max over
    whole grids), behind an odd bool group so the int32 and int16 groups
    start unaligned."""
    flat, specs = _outputs(np.random.default_rng(9), E=3, W=40)
    tmpl = torch.arange(64, dtype=torch.int32) % 5
    leaves = [torch.tensor([True, False, True])] + p_sched._make_group_prep(specs)(
        tmpl, [torch.from_numpy(a) for a in flat]
    )
    _check(monkeypatch, emulated, leaves, "group prep")
    assert int(p_kernels.fetch_tree([leaves[-1]])[0]) == 40000


def test_emulated_wire_on_solve_fetches(monkeypatch, emulated):
    """Every fetch of pipelined CPU solves (fill and kind-scan groups, the
    final state reads, per-pod chunks under a budget) and of a dp solve
    (its 4-byte verdict words) packs alike through the emulated kernel."""
    seen = []
    real = p_kernels.pack_wire_plain

    def both(leaves):
        want = real(leaves)
        monkeypatch.setattr(p_cuda, "_invoke", emulated)
        got = p_cuda.wire_pack(leaves)
        assert torch.equal(got, want), f"fetch {len(seen)}"
        seen.append(want.numel())
        return want

    monkeypatch.setattr(p_kernels, "pack_wire_plain", both)
    sched = TorchScheduler(T.make_templates(12), max_claims=64, device="cpu")
    sched.pipeline_chunks, sched.pipeline_min_pods = 2, 0
    sched.solve(T.mixed_pods(40))
    assert sched.last_timings["pipeline"]["n_chunks"] == 2
    sched.solve_chunk = 16
    sched.solve(T.mixed_pods(24), budgets={"default": {"cpu": 1e5}})
    dp = TorchScheduler(T.make_templates(12), max_claims=64, device="cpu", dp=2)
    dp.pipeline_min_pods = 32
    dp.solve(T.selector_pods(48))
    assert dp.last_stats["shard"]["verdict_fetches"] >= 1
    assert 4 in seen, "no verdict word went through the kernel"
    assert len(seen) >= 6
