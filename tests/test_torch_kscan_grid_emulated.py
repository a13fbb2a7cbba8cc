"""The kind scan's grid kernel (H5), csrc/kscan_grid.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, two SMs) and routes
ops/cuda.py's launch to that library. ops/cuda.py's launchers pack the
catalog as on the card (kscan_catalog: H2's packed catalog and the key's
admit column). Each case holds the three modes to the plain versions,
bit for bit, on seeded inputs: mode 0 (grid and capd) against
_kscan_grid_plain, mode 1 (capd of a given, debited grid) and mode 2
(fits-final) against kscan_fits_final_plain; on the zone key and on
another key; several allocatable groups with invalid ones; (zone,
capacity-type) pairs past 32 and past 64 bits (two words); D = 1 and
D = 16; a type
count that is no multiple of the warp; types undefined on the key; one
row (a row split over the block's warps) and 256 (several blocks, many
rows a block); a catalog tiled past the shared memory and one read from
device memory. A small CPU kind-scan solve runs every H5 call through
both. The emulation checks the kernel's logic, not its timing or what
the GPU compiler does with it: chip_smoke.py holds the compiled kernel to
the plain versions on the card. Tolerance: exact.
"""

import types

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library, limited_call


COPY = "i += kThreads) dst[i] = src[i];"
READ = "          const int tl_idx = t - t_lo;\n"
# the row's pair words: lane 0's store of each 32-bit half, every lane's loads
WORD_STORE = "if (lane == 0) reinterpret_cast<uint32_t*>(words)[base / 32 + h] = m;"
WORD_LOADS = ("w0 = words[0];", "& words[w]")
NOTE_WORDS = """
__device__ __forceinline__ int emu_note_words(const uint64_t* words, int w) {
  emu_note_read(reinterpret_cast<const uint32_t*>(words + w));
  emu_note_read(reinterpret_cast<const uint32_t*>(words + w) + 1);
  return w;
}
"""


def _rewrite(src: str) -> str:
    """Dynamic shared memory for the emulator's, and fibers that give way
    to the others (up to 8 rounds, cuda_emu.h emu_yield) around each int4
    of the catalog tile's copy into it and before each type's reads of
    the tile: a read that lacks the barrier after the copy, or a read of
    tile k - 1 that lacks the barrier before the copy of tile k, then
    meets the wrong bytes. The row's pair words are noted for the
    emulator's memory-order check (emu_note_read / emu_note_write): a
    ballot orders no memory, so a lane's load of a row's words and lane
    0's store of the next row's must have a __syncwarp between them."""
    assert src.count(COPY) == 1 and src.count(READ) == 1 and src.count(WORD_STORE) == 1
    assert src.count(WORD_LOADS[0]) == 1 and src.count(WORD_LOADS[1]) == 2
    src = (src.replace("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();")
           .replace(COPY, "i += kThreads) { emu_yield(8); dst[i] = src[i]; emu_yield(8); }")
           .replace(READ, "          emu_yield(64);\n" + READ)
           .replace(WORD_STORE, "if (lane == 0) { emu_note_write(reinterpret_cast<uint32_t*>(words) + base / 32 + h); "
                                "reinterpret_cast<uint32_t*>(words)[base / 32 + h] = m; }")
           .replace(WORD_LOADS[0], "w0 = words[emu_note_words(words, 0)];")
           .replace(WORD_LOADS[1], "& words[emu_note_words(words, w)]"))
    anchor = "// any offering of a cell within the row's pair words"
    assert src.count(anchor) == 1
    return src.replace(anchor, NOTE_WORDS + anchor)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated grid kernel."""
    fn = c_entry(emulated_library(tmp_path_factory, "kscan_grid", rewrite=_rewrite), "kscan_grid")

    def invoke(source, entry, *args):
        assert (source, entry) == ("kscan_grid", "kscan_grid")
        rc = limited_call(fn, *args, None)
        if rc:
            raise RuntimeError(f"emulated kscan_grid: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


ZONE, CT, OTHER = 0, 1, 2  # the requirement masks' key rows


def _catalog(rng, T_, GR, R, Z, C, V):
    alloc = rng.uniform(1.0, 60.0, (T_, GR, R)).astype(np.float32)
    alloc[rng.random((T_, GR, R)) < 0.1] = 0.0
    defined = rng.random((T_, 3)) < 0.7  # a type undefined on the key admits every domain
    mask = rng.random((T_, 3, V)) < 0.5
    return types.SimpleNamespace(
        alloc=torch.from_numpy(alloc),
        group_valid=torch.from_numpy(rng.random((T_, GR)) < 0.8),
        zc_avail=torch.from_numpy(rng.random((T_, GR, Z, C)) < 0.3),
        reqs=types.SimpleNamespace(defined=torch.from_numpy(defined), mask=torch.from_numpy(mask)),
    )


def _rows(rng, N, T_, R, V, D):
    used = rng.uniform(0.0, 30.0, (N, R)).astype(np.float32)
    used[rng.random((N, R)) < 0.2] = 0.0
    req = rng.uniform(0.0, 4.0, R).astype(np.float32)
    req[rng.random(R) < 0.25] = 0.0
    mask = rng.random((N, 3, V)) < 0.6
    viable = rng.random((N, T_)) < 0.6
    viable[3::5] = False  # rows with no viable type
    placed = rng.integers(0, 9, N).astype(np.int32)
    zset = rng.random((N, D)) < 0.5
    return tuple(torch.from_numpy(x) for x in (used, req, mask, viable, placed, zset))


CASES = {
    # name: (T, GR, R, Z, C, V, N, key row, D, tile budget in bytes or None for the launcher's)
    "zone_one_word": (40, 1, 4, 4, 2, 6, 24, ZONE, 4, None),
    "zone_two_words_d16_gr3": (37, 3, 5, 20, 5, 22, 20, ZONE, 16, None),
    "zone_40_pairs": (31, 1, 4, 8, 5, 10, 14, ZONE, 8, None),
    "zone_d1": (33, 2, 4, 3, 2, 5, 9, ZONE, 1, None),
    "ct_key_d_c": (45, 2, 4, 4, 3, 6, 30, CT, 3, None),
    "other_key_d16_two_words": (29, 2, 16, 20, 5, 22, 12, OTHER, 16, None),
    "other_key_d1": (50, 1, 3, 4, 2, 6, 7, OTHER, 1, None),
    "one_row": (53, 2, 4, 4, 2, 6, 1, ZONE, 4, None),
    "rows_256": (19, 1, 4, 4, 2, 6, 256, OTHER, 5, None),
    "tiled": (150, 2, 4, 13, 5, 14, 36, ZONE, 8, 4096),
    "unstaged": (21, 2, 4, 4, 2, 6, 9, CT, 2, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kscan_grid_equals_plain(case, emulated, monkeypatch):
    """Modes 0, 1 and 2 through the emulated kernel against the plain
    versions."""
    T_, GR, R, Z, C, V, N, key, D, budget = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    if budget is not None:
        monkeypatch.setattr(p_cuda, "FILL_GRID_SMEM", budget)
    it = _catalog(rng, T_, GR, R, Z, C, V)
    used, req, mask, viable, placed, zset = _rows(rng, N, T_, R, V, D)
    fill = p_cuda.kscan_catalog(it, key, D).fill
    if case == "tiled":
        assert fill.staged and fill.ntiles > 1
    if case == "unstaged":
        assert not fill.staged
    if "two_words" in case:
        assert fill.dims[5] == 2
    kid = (ZONE, CT, key, D)
    grid_k, capd_k = p_cuda.kscan_grid(used, req, it, viable, mask, *kid)
    grid_p, capd_p = p_solver._kscan_grid_plain(used, req, it, viable, mask, *kid)
    assert torch.equal(grid_k, grid_p), (case, "grid", (grid_k != grid_p).nonzero()[:8].tolist())
    assert torch.equal(capd_k, capd_p), (case, "capd", capd_k.tolist(), capd_p.tolist())
    assert capd_p.any(), case
    debited = torch.clamp(grid_p - torch.from_numpy(rng.integers(0, 3, (N, 1, 1)).astype(np.int32)), min=0)
    _, capd_k = p_cuda.kscan_grid(used, req, it, viable, mask, *kid, debited.contiguous())
    _, capd_p = p_solver._kscan_grid_plain(used, req, it, viable, mask, *kid, debited)
    assert torch.equal(capd_k, capd_p), (case, "capd of a given grid", capd_k.tolist(), capd_p.tolist())
    ct_m, z_m = mask[:, CT, :].contiguous(), mask[:, ZONE, :].contiguous()
    fits_k = p_cuda.kscan_fits_final(grid_p, placed, zset, ct_m, z_m, it, key, ZONE, D)
    fits_p = p_solver.kscan_fits_final_plain(grid_p, placed, zset, ct_m, z_m, it, key, ZONE, D)
    assert torch.equal(fits_k, fits_p), (case, "fits-final", (fits_k != fits_p).nonzero()[:8].tolist())
    assert fits_p.any() and not fits_p.all(), case


def test_emulated_kscan_grid_in_a_solve(emulated, monkeypatch):
    """Every H5 call of a small CPU kind-scan solve (tier 2's grid, tier
    3's, the reused grid and fits-final) through the emulated kernel, each
    against the plain version on the same inputs."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain_grid, plain_fits = p_solver._kscan_grid_plain, p_solver.kscan_fits_final_plain
    calls = {"grid": 0, "reused": 0, "fits": 0}

    def grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid=None):
        want = plain_grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid)
        got = p_cuda.kscan_grid(used.contiguous(), req.contiguous(), it, viable.contiguous(),
                                rows_mask.contiguous(), zone_kid, ct_kid, key_kid, D,
                                None if grid is None else grid.contiguous())
        assert all(torch.equal(a, b) for a, b in zip(got, want)), calls
        calls["grid" if grid is None else "reused"] += 1
        return want

    def fits(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D):
        want = plain_fits(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D)
        got = p_cuda.kscan_fits_final(grid.contiguous(), placed.contiguous(), zset.contiguous(),
                                      ct_mask.contiguous(), zmask.contiguous(), it, key_kid, zone_kid, D)
        assert torch.equal(got, want), calls
        calls["fits"] += 1
        return want

    monkeypatch.setattr(p_solver, "_kscan_grid_plain", grid)
    monkeypatch.setattr(p_solver, "kscan_fits_final_plain", fits)
    s = TorchScheduler(T.make_templates(24), max_claims=32, device="cpu")
    r = s.solve(T.zonal_pods(24, kinds=2))
    assert r.node_count > 0
    assert calls["grid"] >= 2 and calls["fits"] >= 1, calls
