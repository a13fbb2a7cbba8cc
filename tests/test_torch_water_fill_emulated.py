"""The water-fill kernel (H3), csrc/water_fill.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives) and routes
ops/cuda.py's launch to that library. Each case holds the launcher to
water_fill_plain, bit for bit, on seeded inputs: one row, a row count
that is no multiple of the block, the fill step's window of 4096 rows,
rows past the registers (each thread's contiguous chunk in device memory,
with few and with all rows live), counts that put max(p) + rem + 1 past
2^24 (the 24 steps stop
short of the level) and past 2^31 (every sum and level wraps), rem = 0,
sum(f) <= rem, all f = 0 and negative capacities; the window's cases run
the register kernel (rounds of 2 levels over each warp's live rows, with
few and with most rows live), the chunk cases the chunk walk (rounds of
5 levels, the last 4). A small CPU solve runs every fill-step H3 call
through both. The emulation checks the kernel's logic, not its timing or what
the GPU compiler does with it: chip_smoke.py holds the compiled kernel
to the plain version on the card. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library, limited_call


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated water-fill kernel."""
    fn = c_entry(emulated_library(tmp_path_factory, "water_fill"), "water_fill")

    def invoke(source, entry, *args):
        assert (source, entry) == ("water_fill", "water_fill")
        rc = limited_call(fn, *args, None)
        if rc:
            raise RuntimeError(f"emulated water_fill: error {rc}")

    return invoke


def _case(name: str, rng):
    """(p, f, rem) of case `name`, int32 tensors."""
    def ints(lo, hi, n):
        return rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)

    n, p_hi, f_hi, rem = {
        "one_row": (1, 40, 9, 3),
        "ragged_300": (300, 40, 6, 400),
        "window_4096": (4096, 40, 6, 3000),
        "window_4096_few_live": (4096, 40, 6, 300),
        "chunks_5000_few_live": (5000, 40, 6, 2000),
        "chunks_4500_all_live": (4500, 40, 6, 9000),
        "stops_short_2p25": (4096, 1 << 25, 6, 3000),
        "wraps_2p31": (600, (1 << 31) - 1, 6, 900),
        "rem_zero": (700, 40, 6, 0),
        "sum_f_le_rem": (700, 40, 6, 100_000),
        "all_f_zero": (500, 40, 1, 5),
        "negative_f": (500, 40, 6, 500),
    }[name]
    p, f = ints(0, p_hi, n), ints(0, f_hi, n)
    if name == "window_4096_few_live":
        f[rng.random(n) < 0.95] = 0  # about 200 live rows
    if name == "chunks_5000_few_live":
        f[rng.random(n) < 0.5] = 0  # about 2500 live rows
    if name == "chunks_4500_all_live":
        f = ints(1, f_hi, n)  # every row live
    if name == "negative_f":
        f[rng.random(n) < 0.2] *= -1
        p[rng.random(n) < 0.1] *= -1
    return torch.from_numpy(p), torch.from_numpy(f), torch.tensor(rem, dtype=torch.int32)


CASES = ("one_row", "ragged_300", "window_4096", "chunks_5000_few_live", "chunks_4500_all_live",
         "stops_short_2p25", "wraps_2p31", "rem_zero", "sum_f_le_rem", "all_f_zero", "negative_f",
         "window_4096_few_live")


@pytest.mark.parametrize("case", CASES)
def test_emulated_water_fill_equals_plain(case, emulated, monkeypatch):
    """The kernel through ops/cuda.py's launcher against water_fill_plain."""
    rng = np.random.default_rng(CASES.index(case))
    p, f, rem = _case(case, rng)
    want = p_solver.water_fill_plain(p, f, rem)
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    if case == "stops_short_2p25":
        assert int(p.max()) + int(rem) + 1 > 1 << 24
    got = p_cuda.water_fill(p, f, rem)
    assert torch.equal(got, want), (case, (got != want).nonzero().flatten()[:8].tolist())


def test_emulated_water_fill_in_a_solve(emulated, monkeypatch):
    """Every H3 call of a small CPU fill solve through the emulated kernel,
    each against water_fill_plain on the same inputs."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.water_fill_plain
    calls = []

    def routed(p, f, rem):
        want = plain(p, f, rem)
        got = p_cuda.water_fill(p.contiguous(), f.contiguous(), rem)
        assert torch.equal(got, want), (len(calls), got.tolist(), want.tolist())
        calls.append(int(rem))
        return want

    monkeypatch.setattr(p_solver, "water_fill_plain", routed)
    s = TorchScheduler(T.make_templates(12), max_claims=8, device="cpu")
    r = s.solve(T.selector_pods(24))
    assert r.node_count > 0
    assert len(calls) >= 2 and any(calls), calls
