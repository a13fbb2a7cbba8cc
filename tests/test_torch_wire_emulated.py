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
every fetch of pipelined CPU solves and a dp solve's verdict words; and
on the kernel's own paths: leaves at every offset mod 16 of the wire and
of their sources in the int32, int16-narrowed and float32 groups (16-byte
lines copied aligned, by a funnel shift, and byte by byte at the ragged
ends), bool groups whose leaf boundaries fall at every phase mod 8
(edge bytes) with long leaves read unaligned, empty leaves, fill_max
sources whose lengths are not multiples of four elements, a single
4-byte word, and a fetch of 300 leaves whose descriptor blob is past the
kernel's parameter space (copied to the device first). The emulation
checks the kernel's logic, not its timing or what the GPU compiler does
with it: chip_smoke.py holds the compiled kernel to the plain version on
the card. Tolerance: exact.
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


def _view(rng, dtype, n: int, shift: int) -> torch.Tensor:
    """n random elements as a contiguous view `shift` elements into a
    larger tensor, so that its address is not 16-byte aligned."""
    if dtype == torch.bool:
        base = torch.from_numpy(rng.random(n + shift) < 0.5)
    elif dtype == torch.float32:
        base = torch.from_numpy(rng.standard_normal(n + shift).astype(np.float32))
    else:
        base = torch.from_numpy(rng.integers(-70000, 70000, size=n + shift).astype(np.int32))
    return base[shift:]


@pytest.mark.parametrize("group", ["int32", "int16_narrowed", "float32"])
def test_emulated_wire_at_every_offset(monkeypatch, emulated, group):
    """The group after a bool group of o bytes, o = 0 .. 15, so that it
    starts at every offset mod 16 of the wire; its leaves (lengths 1-70,
    one empty) read from views shifted 0-3 elements, so source and wire
    offsets share an alignment in some and not in others."""
    rng = np.random.default_rng(11)
    for o in range(16):
        leaves = [torch.from_numpy(rng.random(8 * o) < 0.5)]
        for k, n in enumerate((1, 70, 0, 37, 5, 64, 3, 17)):
            shift = (k + o) % 4
            if group == "int16_narrowed":
                src = _view(rng, torch.int32, 2 * n + 2, shift).reshape(-1, 2)
                leaves.append(p_kernels.WireLeaf(src, rows=n, narrow=True))
            else:
                leaves.append(_view(rng, torch.int32 if group == "int32" else torch.float32, n, shift))
        _check(monkeypatch, emulated, leaves, f"{group} at offset {o}")


@pytest.mark.parametrize("lead", range(8))
def test_emulated_wire_bools_straddle_at_every_phase(monkeypatch, emulated, lead):
    """A bool group whose leaf boundaries fall at every phase mod 8 (a
    leading leaf of `lead` elements, then leaves of 1-9 elements, empty
    ones, a 2-d leaf) and long leaves whose whole bytes are read 16 at a
    time, from views shifted 0-7 bytes; a live-row slice among them."""
    rng = np.random.default_rng(lead)
    leaves = [_view(rng, torch.bool, lead, lead % 3)]
    for k, n in enumerate((1, 2, 0, 3, 4, 5, 6, 7, 8, 9, 300, 0, 129, 1000)):
        leaves.append(_view(rng, torch.bool, n, (k + lead) % 8))
    leaves.append(torch.from_numpy(rng.random((7, 3)) < 0.5))
    leaves.append(p_kernels.WireLeaf(torch.from_numpy(rng.random((40, 9)) < 0.5), rows=23))
    leaves.append(torch.tensor([1, 2, 3], dtype=torch.int32))
    _check(monkeypatch, emulated, leaves, f"bools after a leading {lead}")


def test_emulated_wire_empty_leaves(monkeypatch, emulated):
    """Fetches whose leaves are all empty or 0-d, and empty leaves
    between non-empty ones of every group."""
    _check(monkeypatch, emulated, [torch.zeros(0, dtype=torch.bool), torch.zeros((0, 4), dtype=torch.int32)],
           "all empty")
    _check(monkeypatch, emulated, [torch.tensor(True), torch.zeros(0, dtype=torch.float32), torch.tensor(7)
                                   .to(torch.int32), torch.zeros(0, dtype=torch.int32)], "0-d beside empty")
    rng = np.random.default_rng(2)
    leaves = []
    for k in range(6):
        leaves += [torch.zeros(0, dtype=torch.int32), _view(rng, torch.int32, 3 + k, k % 4),
                   torch.zeros((0, 3), dtype=torch.bool), _view(rng, torch.bool, 5 + k, k)]
    _check(monkeypatch, emulated, leaves, "empty between")


def test_emulated_wire_fill_max_sources(monkeypatch, emulated):
    """A fill_max over several sources whose lengths are not multiples of
    the kernel's 4-element loads, each a view shifted 0-3 elements; the
    max at the first element, at the last, in a padding row, negative
    everywhere; beside the int32 leaves it sits among."""
    rng = np.random.default_rng(4)
    for where in ("first", "last", "middle", "negative"):
        srcs = []
        for k, n in enumerate((1, 5, 7, 13, 1029, 8197)):
            v = _view(rng, torch.int32, n, k % 4)
            if where == "negative":
                v -= 200000
            srcs.append(v)
        pick = {"first": (0, 0), "last": (5, 8196), "middle": (4, 513), "negative": (3, 12)}[where]
        srcs[pick[0]][pick[1]] = 90000 if where != "negative" else -100
        leaves = [torch.tensor([True, False, True]), _view(rng, torch.int32, 9, 1), p_kernels.WireMax(srcs),
                  _view(rng, torch.int32, 4, 2)]
        _check(monkeypatch, emulated, leaves, f"fill_max at {where}")
        _check(monkeypatch, emulated, leaves, f"fill_max at {where}, again (the scratch was reset)")


def test_emulated_wire_one_word(monkeypatch, emulated):
    """A single 4-byte word (a dp verdict) and a 0-d int32."""
    _check(monkeypatch, emulated, [torch.tensor([123456789], dtype=torch.int32)], "one word")
    _check(monkeypatch, emulated, [torch.tensor(-5, dtype=torch.int32)], "0-d word")


def test_emulated_wire_blob_past_the_parameter_space(monkeypatch, emulated):
    """300 leaves of every group: the descriptor blob is past the 4000
    bytes the kernel takes in its parameters, so it is copied to a device
    buffer before the launch."""
    rng = np.random.default_rng(8)
    leaves = []
    for k in range(100):
        leaves += [_view(rng, torch.int32, 1 + k % 9, k % 4), _view(rng, torch.bool, 1 + k % 11, k % 8),
                   _view(rng, torch.float32, 2 + k % 5, k % 3)]
    lay = p_cuda._WireLayout(leaves)
    assert lay.blob.nbytes > p_cuda.WIRE_PARAM_BYTES
    _check(monkeypatch, emulated, leaves, "300 leaves")
