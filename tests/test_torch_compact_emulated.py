"""The row-movement kernel (H4), csrc/compact_scatter.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread, the
blocks of a grid one after another, barriers for __syncthreads and the
warp collectives) and routes ops/cuda.py's launch to that library, so the
launcher (its cached layouts and its once-allocated look-back workspace)
runs on CPU tensors. Each case holds the kernel exactly to the plain
version, ops/solver.py compact_scatter_plain: both modes; row counts
that cross tile borders (the look-back); fields of 1, 2, 4, 8, 16 and
1000 bytes a row and one whose base is odd; topology-key fields; every
row dead and every row alive; and a build whose tiles publish no
inclusive prefix, so that every look-back walks the aggregates back to
tile 0 over several 32-flag windows. Every launch must leave the
workspace zeroed. A small CPU solve runs each of its compactions, bank
scatters and decode merges through both. The emulation checks the
kernel's logic, not its timing or what the GPU compiler does with it:
chip_smoke.py holds the compiled kernel to the plain version on the card.
Every emulated launch runs under a time limit (cuda_emu_build.limited_call).
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library, limited_call

AGGREGATES_ONLY = "  if (lane == 0 && tile > 0) store_flag(flags + tile, kInclusive | (unsigned)(prefix + count));\n"


def _aggregates_only(src: str) -> str:
    """A build whose tiles past 0 never publish their inclusive prefix."""
    assert AGGREGATES_ONLY in src
    return src.replace(AGGREGATES_ONLY, "")


def _router(fn):
    def invoke(source, entry, *args):
        assert (source, entry) == ("compact_scatter", "compact_scatter")
        rc = limited_call(fn, *args, None)
        if rc:
            raise p_cuda.KernelError(f"emulated compact_scatter: error {rc}")

    return invoke


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry calls routed to the emulated kernel: the build
    as written, and the aggregates-only build."""
    libs = {
        "plain": emulated_library(tmp_path_factory, "compact_scatter"),
        "aggregates": emulated_library(tmp_path_factory, "compact_scatter", rewrite=_aggregates_only),
    }
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {k: _router(c_entry(lib, "compact_scatter")) for k, lib in libs.items()}
    torch.set_num_threads(n)


def _odd_field(rng, n: int, width: int) -> torch.Tensor:
    """An [n, width] uint8 field whose base address is odd (a contiguous
    view one byte into its storage)."""
    base = torch.from_numpy(rng.integers(0, 256, n * width + 1).astype(np.uint8))
    return base[1:].view(n, width)


def _fields(rng, n: int, T_: int):
    """Window fields of 1, 2, 4, 8, 16 and T_ bytes a row, 12 bytes in
    int32 (4-byte chunks), a [n, K, V] mask and an odd-based one."""
    return [
        torch.from_numpy(rng.random(n) < 0.5),
        torch.from_numpy(rng.integers(-9, 9, (n, 1)).astype(np.int16)),
        torch.from_numpy(rng.integers(-9, 99, n).astype(np.int32)),
        torch.from_numpy(rng.random((n, 8)) < 0.5),
        torch.from_numpy(rng.uniform(0, 9, (n, 4)).astype(np.float32)),
        torch.from_numpy(rng.random((n, T_)) < 0.5),
        torch.from_numpy(rng.integers(-99, 99, (n, 3)).astype(np.int32)),
        torch.from_numpy(rng.random((n, 5, 8)) < 0.5),
        _odd_field(rng, n, 5),
    ]


def _tk_fields(rng, n: int, K: int, V: int):
    return [torch.from_numpy(rng.random((n, K, V)) < 0.5), torch.from_numpy(rng.random((n, K)) < 0.5),
            torch.from_numpy(rng.integers(-5, 5, (n, K)).astype(np.int32))]


def _filled(ts, rng):
    """Destinations holding something else already (the fill / the bank)."""
    out = []
    for t in ts:
        d = torch.from_numpy(rng.integers(0, 2, tuple(t.shape)).astype(np.uint8)).to(t.dtype)
        out.append(d.contiguous())
    return out


def _check_both(mode, sel, srcs, n_dst, rng, tk=(), tk_srcs=(), build=None, emulated=None, monkeypatch=None):
    """The emulated kernel against compact_scatter_plain on the same
    destinations; the workspace zeroed after the launch."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated[build or "plain"])
    dk = _filled([torch.empty((n_dst,) + tuple(s.shape[1:]), dtype=s.dtype) for s in srcs], rng)
    tdk = _filled([torch.empty((n_dst, len(tk)) + tuple(s.shape[2:]), dtype=s.dtype) for s in tk_srcs], rng)
    dp, tdp = [d.clone() for d in dk], [d.clone() for d in tdk]
    before = p_cuda.LAUNCHES["compact_scatter"]
    p_cuda.compact_scatter(mode, sel, srcs, dk, tk, tk_srcs, tdk)
    assert p_cuda.LAUNCHES["compact_scatter"] == before + 1
    p_solver.compact_scatter_plain(mode, sel, srcs, dp, tk, tk_srcs, tdp)
    for j, (a, b) in enumerate(zip(dk + tdk, dp + tdp)):
        assert torch.equal(a, b), (mode, j)
    for ws in p_cuda._SCATTER_WS.values():
        assert not ws.any(), "a launch left the look-back workspace dirty"


# name: (rows, catalog width T, share alive, build)
COMPACT = {
    "one_tile": (20, 7, 0.5, None),
    "three_tiles": (70, 1000, 0.6, None),
    "every_row_dead": (45, 13, 0.0, None),
    "every_row_alive": (77, 13, 1.0, None),
    "tile_border_exact": (64, 9, 0.5, None),
    "aggregates_past_32_tiles": (32 * 37 + 5, 3, 0.4, "aggregates"),
}


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_emulated_compaction_equals_plain(case, emulated, monkeypatch):
    """Mode 0, the stable compaction: every field lands at the alive rows'
    exclusive prefix count, the rows behind keep the fill."""
    n, T_, p_alive, build = COMPACT[case]
    rng = np.random.default_rng(sorted(COMPACT).index(case))
    srcs = _fields(rng, n, T_)
    alive = torch.from_numpy(rng.random(n) < p_alive)
    _check_both(0, alive, srcs, n, rng, build=build, emulated=emulated, monkeypatch=monkeypatch)


# name: (rows, destination rows, share kept, with topology-key fields)
DROP = {
    "bank_rows": (50, 64, 0.5, False),
    "bank_rows_tk": (70, 80, 0.6, True),
    "ids_out_of_range": (40, 30, 0.9, True),
    "nothing_kept": (33, 40, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(DROP))
def test_emulated_drop_scatter_equals_plain(case, emulated, monkeypatch):
    """Mode 1, the reference's mode="drop" scatter: row i to ids[i] when
    0 <= ids[i] < n_dst, negative and too-large ids dropped; with the
    topology-key fields (key rows 3 and 1 of a [n, 5, ...] source), in
    the same launch."""
    n, n_dst, p_keep, with_tk = DROP[case]
    rng = np.random.default_rng(100 + sorted(DROP).index(case))
    srcs = _fields(rng, n, 11)
    ids = rng.permutation(max(n, n_dst) + 8)[:n].astype(np.int32) - 4  # a few negative, a few past n_dst
    ids = np.where(rng.random(n) < p_keep, ids, n_dst + 3).astype(np.int32)
    tk, tk_srcs = ((3, 1), _tk_fields(rng, n, 5, 8)) if with_tk else ((), [])
    _check_both(1, torch.from_numpy(ids), srcs, n_dst, rng, tk, tk_srcs, emulated=emulated,
                monkeypatch=monkeypatch)


def test_emulated_compaction_with_key_rows(emulated, monkeypatch):
    """Mode 0 with topology-key fields beside the whole-row ones."""
    rng = np.random.default_rng(7)
    n = 90
    alive = torch.from_numpy(rng.random(n) < 0.5)
    _check_both(0, alive, _fields(rng, n, 6), n, rng, (4, 0, 2), _tk_fields(rng, n, 6, 16),
                emulated=emulated, monkeypatch=monkeypatch)


def test_launcher_refusals_keep_their_messages(emulated, monkeypatch):
    """The launcher's refusals, raised before any launch, as before the
    redesign; a checked layout is not trusted for a non-contiguous call."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated["plain"])
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.integers(0, 9, (8, 3)).astype(np.int32))
    alive = torch.ones(8, dtype=torch.bool)
    with pytest.raises(p_cuda.LaunchRefused, match="sel: dtype"):
        p_cuda.compact_scatter(1, alive, [s], [torch.empty_like(s)])
    with pytest.raises(p_cuda.LaunchRefused, match="need matching src/dst lists"):
        p_cuda.compact_scatter(0, alive, [s], [])
    with pytest.raises(p_cuda.LaunchRefused, match="key-row fields need key ids"):
        p_cuda.compact_scatter(0, alive, [s], [torch.empty_like(s)], (), [s], [s])
    with pytest.raises(p_cuda.LaunchRefused, match=r"compact_scatter: src \(8, 3\) / dst \(8, 4\)"):
        p_cuda.compact_scatter(0, alive, [s], [torch.empty((8, 4), dtype=torch.int32)])
    with pytest.raises(p_cuda.LaunchRefused, match="dst: dtype"):
        p_cuda.compact_scatter(0, alive, [s], [torch.empty((8, 3), dtype=torch.float32)])
    with pytest.raises(p_cuda.LaunchRefused, match="tk src"):
        p_cuda.compact_scatter(0, alive, [s], [torch.empty_like(s)], (5,), [s.view(8, 3, 1)],
                               [torch.empty((8, 1, 1), dtype=torch.int32)])
    d = torch.empty_like(s)
    p_cuda.compact_scatter(0, alive, [s], [d])
    assert torch.equal(d, s)
    with pytest.raises(p_cuda.LaunchRefused, match="src: not contiguous"):
        p_cuda.compact_scatter(0, alive, [s.t().contiguous().t()], [d])
    with pytest.raises(p_cuda.KernelError, match="error"):
        p_cuda.compact_scatter(0, alive, [s] * 17, [torch.empty_like(s) for _ in range(17)])


def test_small_solve_moves_every_row_through_the_kernel(emulated, monkeypatch):
    """Every H4 call of a small CPU solve (the compactions with their bank
    scatters, topology-key rows included, and the decode's global_claims)
    runs through the emulated kernel and the plain version alike."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated["plain"])
    plain = p_solver.compact_scatter_plain
    calls = []

    def both(mode, sel, srcs, dsts, tk=(), tk_srcs=(), tk_dsts=()):
        dk = [d.clone() for d in dsts]
        tdk = [d.clone() for d in tk_dsts]
        p_cuda.compact_scatter(mode, sel, srcs, dk, tk, tk_srcs, tdk)
        plain(mode, sel, srcs, dsts, tk, tk_srcs, tk_dsts)
        for a, b in zip(dk + tdk, list(dsts) + list(tk_dsts)):
            assert torch.equal(a, b), mode
        calls.append((mode, len(tk_srcs)))

    monkeypatch.setattr(p_solver, "compact_scatter_plain", both)
    sched = TorchScheduler(T.make_templates(12), max_claims=48, device="cpu")
    sched.compact_min_pods = 0  # compact between dispatches at this size too
    res = sched.solve(T.mixed_pods(60))
    assert res.claims
    assert {m for m, _ in calls} == {0, 1}
    assert any(n_tk for _m, n_tk in calls), "no topology-key rows moved"
