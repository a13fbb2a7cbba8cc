"""The fill grid kernel (H2), csrc/fill_count_grid.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, two SMs, the bulk
copy of a catalog tile replaced by a memcpy) and routes ops/cuda.py's
launch to that library. ops/cuda.py's launcher packs the catalog as on
the card (fill_grid_catalog). Each case holds the kernel to the plain
versions, claim_fill_caps_plain (mode 0) and fits_off_counted_plain (mode
1), on seeded inputs: broadcast usage and mask rows, no offering gate,
(zone, capacity-type) pairs past 64 bits, several allocatable groups, 16
resources, a type count that is no multiple of the vector width, rows
with no viable type, a catalog tiled past the shared memory and one past
it read from device memory, a launch of one row (a row split over the
block's warps) and of many (several blocks). A small CPU solve runs every
fill-step H2 call through both. The emulation checks the kernel's logic,
not its timing or what the GPU compiler does with it: chip_smoke.py holds
the compiled kernel to the plain versions on the card. Tolerance: exact.
"""

import types

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
    a = src.index("__device__ __forceinline__ void stage_tile(")
    b = src.index("// ---- helpers")
    return src[:a] + (
        "__device__ __forceinline__ void stage_tile(const char* src, char* dst, uint32_t bytes, uint64_t* bar,\n"
        "                                           int k) {\n"
        "  __syncthreads();\n  if (threadIdx.x == 0) memcpy(dst, src, bytes);\n}\n"
        "__device__ __forceinline__ void wait_tile(uint64_t* bar, int k) { __syncthreads(); }\n\n"
    ) + src[b:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated fill grid kernel."""
    fn = c_entry(emulated_library(tmp_path_factory, "fill_count_grid", rewrite=_rewrite), "fill_count_grid")

    def invoke(source, entry, *args):
        assert (source, entry) == ("fill_count_grid", "fill_count_grid")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated fill_count_grid: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


ZONE, CT = 0, 1  # the mask's key rows the offering test reads


def _catalog(rng, T_, GR, R, Z, C):
    alloc = rng.uniform(1.0, 60.0, (T_, GR, R)).astype(np.float32)
    alloc[rng.random((T_, GR, R)) < 0.1] = 0.0
    return types.SimpleNamespace(
        alloc=torch.from_numpy(alloc),
        group_valid=torch.from_numpy(rng.random((T_, GR)) < 0.8),
        zc_avail=torch.from_numpy(rng.random((T_, GR, Z, C)) < 0.3),
    )


def _rows(rng, B, T_, R, K, V, p_viable=0.5):
    used = rng.uniform(0.0, 30.0, (B, R)).astype(np.float32)
    used[rng.random((B, R)) < 0.2] = 0.0
    req = rng.uniform(0.0, 4.0, R).astype(np.float32)
    req[rng.random(R) < 0.25] = 0.0
    mask = rng.random((B, K, V)) < 0.6
    viable = rng.random((B, T_)) < p_viable
    viable[::3] = False  # rows with no viable type
    counts = rng.integers(0, 9, B).astype(np.int32)
    return (torch.from_numpy(used), torch.from_numpy(req), torch.from_numpy(mask), torch.from_numpy(viable),
            torch.from_numpy(counts))


CASES = {
    # name: (T, GR, R, Z, C, B, tile budget in bytes or None for the launcher's)
    "one_word": (40, 1, 4, 4, 2, 24, None),
    "two_words_gr3_r16": (37, 3, 16, 13, 5, 20, None),
    "one_row": (53, 2, 4, 4, 2, 1, None),
    "many_rows": (19, 1, 3, 3, 2, 70, None),
    "tiled": (45, 2, 4, 13, 5, 18, 1024),
    "unstaged": (21, 2, 4, 4, 2, 9, 8),
    # few rows: on the emulator's two SMs, a staged tile shared by a block's
    # row groups of 4 warps each
    "wpr4_few_rows_staged": (29, 2, 4, 4, 2, 5, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_fill_grid_equals_plain(case, emulated, monkeypatch):
    """Both modes through the emulated kernel against the plain versions:
    per-row and broadcast usage and mask rows, and mode 1 without the
    offering gate (compact_state's liveness rule)."""
    T_, GR, R, Z, C, B, budget = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    if budget is not None:
        monkeypatch.setattr(p_cuda, "FILL_GRID_SMEM", budget)
    it = _catalog(rng, T_, GR, R, Z, C)
    K, V = 3, max(Z, C) + 2
    used, req, mask, viable, counts = _rows(rng, B, T_, R, K, V)
    cat = p_cuda.fill_grid_catalog(it)
    if case == "tiled":
        assert cat.staged and cat.ntiles > 1
    if case == "unstaged":
        assert not cat.staged
    if case == "two_words_gr3_r16":
        assert cat.dims[5] == 2  # Z * C = 65 pairs: two words
    for label, u, m in (("rows", used, mask), ("broadcast used", used[:1], mask),
                        ("broadcast mask", used, mask[:1]), ("both broadcast", used[:1], mask[:1])):
        off = p_solver.off_for_plain(m, it, ZONE, CT)
        got = p_cuda.fill_count_grid(0, u.contiguous(), req, it, m.contiguous(), ZONE, CT, B, viable=viable)
        want = p_solver.claim_fill_caps_plain(u, viable, req, it, off)
        assert torch.equal(got, want), (case, label, got.tolist(), want.tolist())
        got = p_cuda.fill_count_grid(1, u.contiguous(), req, it, m.contiguous(), ZONE, CT, B, counts=counts)
        want = p_solver.fits_off_counted_plain(u, counts, req, it, off)
        assert torch.equal(got, want), (case, label, (got != want).nonzero().tolist()[:8])
    got = p_cuda.fill_count_grid(1, used, req, it, None, 0, 0, B, counts=counts)
    assert torch.equal(got, p_solver.fits_off_counted_plain(used, counts, req, it, None)), (case, "no gate")
    got = p_cuda.fill_count_grid(0, used, req, it, None, 0, 0, B, viable=viable)
    ones = torch.ones((1, T_, GR), dtype=torch.bool)
    assert torch.equal(got, p_solver.claim_fill_caps_plain(used, viable, req, it, ones)), (case, "no gate")
    assert got[::3].eq(0).all()


def test_emulated_fill_grid_in_a_solve(emulated, monkeypatch):
    """Every H2 call of a small CPU fill solve (tier-2 caps and fits_final,
    tier 3's one-row count and G-row / broadcast fits, the compaction's
    liveness test) through the emulated kernel and the plain version."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    calls = {0: 0, 1: 0}
    plain0, plain1 = p_solver._claim_fill_caps_from_mask_plain, p_solver._fits_off_counted_from_mask_plain

    def caps(used, viable, req, it, rows_mask, zone_kid, ct_kid):
        want = plain0(used, viable, req, it, rows_mask, zone_kid, ct_kid)
        got = p_cuda.fill_count_grid(0, used.contiguous(), req.contiguous(), it, rows_mask.contiguous(), zone_kid,
                                     ct_kid, viable.shape[0], viable=viable.contiguous())
        assert torch.equal(got, want), (calls, got.tolist(), want.tolist())
        calls[0] += 1
        return want

    def fits(used, counts, req, it, rows_mask, zone_kid, ct_kid):
        want = plain1(used, counts, req, it, rows_mask, zone_kid, ct_kid)
        m = None if rows_mask is None else rows_mask.contiguous()
        got = p_cuda.fill_count_grid(1, used.contiguous(), req.contiguous(), it, m, zone_kid, ct_kid,
                                     counts.shape[0], counts=counts.contiguous())
        assert torch.equal(got, want), calls
        calls[1] += 1
        return want

    monkeypatch.setattr(p_solver, "_claim_fill_caps_from_mask_plain", caps)
    monkeypatch.setattr(p_solver, "_fits_off_counted_from_mask_plain", fits)
    s = TorchScheduler(T.make_templates(12), max_claims=8, device="cpu")
    r = s.solve(T.selector_pods(24))
    assert r.node_count > 0
    assert calls[0] >= 2 and calls[1] >= 3, calls
