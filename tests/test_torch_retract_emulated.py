"""The retract kernel's own source, csrc/retract_tail.cu, run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives) and routes
ops/cuda.py's launch to that library. ops/cuda.py's launcher then runs on
CPU tensors and is held to the plain version (ops/solver.py
retract_tail_plain) on every state leaf: seeded states with the window
full, with closed rows among open ones, with frozen bank rows on both
sides of the cut, at cut 0, at a cut inside and at n_open, with row
lengths that take the kernel's 16-, 4- and 1-byte moves; and the
resident states of whole CPU sessions, each retract of which goes through
the kernel and the plain version. The emulation checks the kernel's
logic, not its timing or what the GPU compiler does with it:
chip_smoke.py holds the compiled kernel to the plain version on the card.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from karpenter_tpu_torch.ops.encode import ReqSetTensors
from cuda_emu_build import c_entry, emulated_library


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated retract kernel."""
    lib = emulated_library(tmp_path_factory, "retract_tail")
    fn = c_entry(lib, "retract_tail")

    def invoke(source, entry, *args):
        assert (source, entry) == ("retract_tail", "retract_tail")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated retract_tail: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _assert_equal(want, got, what):
    a, b = p_solver.to_numpy(want), p_solver.to_numpy(got)
    assert set(a) == set(b)
    bad = [k for k in a if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    assert not bad, (what, bad)


def _seeded_state(seed: int, W: int, NB: int, n_open: int, K: int, V: int, T_: int, R: int, TK: int,
                  full: bool = False) -> p_solver.SolverState:
    """A state whose window holds n_open claims (all W rows open when
    `full`, else with closed rows among them) and whose bank holds frozen
    rows at ids both below and at or past any cut; every other column
    random from the seed."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if full:
        open_ = np.ones(W, dtype=bool)
        ids = rng.permutation(n_open)[:W]
    else:
        open_ = rng.random(W) < 0.6
        ids = rng.choice(n_open, size=W, replace=False)
    slot_of = np.where(open_, ids, NB).astype(np.int32)
    reqs = ReqSetTensors(
        mask=t(rng.random((W, K, V)) < 0.5), inf=t(rng.random((W, K)) < 0.5), excl=t(rng.random((W, K)) < 0.5),
        gte=t(rng.integers(-1000, 1000, (W, K), dtype=np.int32)),
        lte=t(rng.integers(-1000, 1000, (W, K), dtype=np.int32)), defined=t(rng.random((W, K)) < 0.5),
    )
    E, G, RID, NP, NV = 2, 3, 2, 1, 1
    i32 = np.int32
    return p_solver.SolverState(
        exist_reqs=ReqSetTensors(*(c[:E].clone() for c in reqs)),
        exist_used=t(rng.random((E, R), dtype=np.float32)),
        reqs=reqs,
        used=t(rng.random((W, R), dtype=np.float32)),
        its=t(rng.random((W, T_)) < 0.5),
        template=t(rng.integers(0, G, W, dtype=i32)),
        open=t(open_),
        pods=t(rng.integers(0, 50, W, dtype=i32)),
        n_open=torch.tensor(n_open, dtype=torch.int32),
        slot_of=t(slot_of),
        w_open=torch.tensor(int(open_.sum()), dtype=torch.int32),
        w_hw=torch.tensor(W, dtype=torch.int32),
        spills=torch.tensor(3, dtype=torch.int32),
        bank_frozen=t(rng.random(NB) < 0.5),
        bank_template=t(rng.integers(0, G, NB, dtype=i32)),
        bank_its=t(rng.random((NB, T_)) < 0.5),
        bank_used=t(rng.random((NB, R), dtype=np.float32)),
        bank_held=t(rng.random((NB, RID)) < 0.5),
        bank_tk_mask=t(rng.random((NB, TK, V)) < 0.5),
        bank_tk_inf=t(rng.random((NB, TK)) < 0.5),
        bank_tk_def=t(rng.random((NB, TK)) < 0.5),
        budget=t(rng.random((G, R), dtype=np.float32)),
        nodes_budget=t(rng.random(G, dtype=np.float32)),
        vg_counts=t(rng.integers(0, 9, (1, V), dtype=i32)),
        hg_counts=t(rng.integers(0, 9, (1, E + NB + 1), dtype=i32)),
        exist_ports=t(rng.integers(0, 2**31, (E, NP), dtype=i32)),
        claim_ports=t(rng.integers(-(2**31), 2**31, (W, NP), dtype=i32)),
        exist_vols=t(rng.integers(0, 2**31, (E, NV), dtype=i32)),
        res_cap=t(rng.integers(0, 9, RID, dtype=i32)),
        held=t(rng.random((W, RID)) < 0.5),
    )


# (seed, W, NB, n_open, K, V, T, R, TK, full): 16-byte rows (K x V = 128,
# T = 48), 4-byte rows (R = 3 floats) and byte rows (K x V = 15, T = 37);
# several window blocks (W = 200 > 64 rows a block) and bank blocks
STATES = {
    "window_full": (0, 64, 96, 80, 8, 16, 48, 4, 1, True),
    "closed_rows_vector_rows": (1, 200, 256, 240, 8, 16, 48, 4, 2, False),
    "closed_rows_byte_rows": (2, 70, 130, 110, 3, 5, 37, 3, 1, False),
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_kernel_matches_plain_on_seeded_states(emulated, monkeypatch, name):
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    seed, W, NB, n_open, *rest = STATES[name]
    state = _seeded_state(seed, W, NB, n_open, *rest)
    before = p_solver.to_numpy(state)
    for cut in sorted({0, 1, n_open // 3, n_open // 2, n_open - 1, n_open, NB}):
        want = p_solver.retract_tail_plain(state, cut)
        got = p_cuda.retract_tail(state, cut)
        _assert_equal(want, got, f"{name} cut {cut}")
        assert int(got.w_open) == int((state.open & (state.slot_of < cut)).sum())
    after = p_solver.to_numpy(state)
    assert all(np.array_equal(before[k], after[k]) for k in before), "the input state changed"


@pytest.mark.parametrize("compact", [False, True])
def test_kernel_matches_plain_in_sessions(emulated, monkeypatch, compact):
    """A small retract cell (3 kinds of whole claims, 8 rounds and 3 pops)
    through a CPU session, every retract_tail through the emulated kernel
    and the plain version (which the session keeps); with compaction the
    resident state carries frozen bank rows."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    orig = p_solver.retract_tail
    cuts = []

    def both(state, cut, plain=False):
        want = orig(state, cut, plain=True)
        _assert_equal(want, p_cuda.retract_tail(state, cut), f"cut {cut}")
        cuts.append(cut)
        return want

    monkeypatch.setattr(p_solver, "retract_tail", both)
    sched = TorchScheduler(T.make_templates(12), max_claims=64, device="cpu")
    if compact:
        sched.compact_min_pods = 8
        sched.pipeline_chunks, sched.pipeline_min_pods = 2, 0
    session = sched.resident_session()
    for label, union in T.retract_trace(kinds=3, kind_size=4, batch=4, rounds=8, pops=3):
        session.solve(list(union))
        assert session.last_mode == "delta" or label == "cold", (label, session.last_reason)
    assert len(cuts) >= 3
    assert bool(session._r["state"].bank_frozen.any()) == compact
