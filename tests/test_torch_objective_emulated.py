"""The objective verdict kernel's own source, csrc/objective_verdict.cu,
run on the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, the blocks of a grid
one after another) and routes ops/cuda.py's launch to that library. The
launcher then runs on CPU tensors and is held to the plain version
(ops/solver.py objective_verdict_plain): the scores and the verdict word
on seeded variant outcomes, for each objective, KV 1 to 24, every variant
infeasible, every feasible score +inf, and tied scores; and inside CPU
solves, every objective round of which goes through the kernel and the
plain version. The emulation checks the kernel's logic, not its timing or
what the GPU compiler does with it: chip_smoke.py holds the compiled
kernel to the plain version on the card. Tolerance: exact (the scores
bit for bit).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated verdict kernel."""
    lib = emulated_library(tmp_path_factory, "objective_verdict")
    fn = c_entry(lib, "objective_verdict")
    calls = []

    def invoke(source, entry, *args):
        assert (source, entry) == ("objective_verdict", "objective_verdict")
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated objective_verdict: error {rc}")
        calls.append(1)

    invoke.calls = calls
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _outcomes(seed: int, KV: int, W: int = 96, T_: int = 40, B: int = 3, G: int = 5, *, feasible=0.6,
              unpriced=0.0, tie=False):
    """KV seeded variant outcomes over one base (w_open 20, spills 1): each
    opened a few rows past the base, some with leftovers or a spill; a
    price column with `unpriced` of its types at +inf. `tie` copies
    variant 0 into every odd variant."""
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.01, 9.0, T_).astype(np.float32)
    price[rng.random(T_) < unpriced] = np.inf
    base_w, base_sp = 20, 1
    outs = []
    for v in range(KV):
        w_open = base_w + int(rng.integers(0, W - base_w + 1))
        ok = rng.random() < feasible
        leftover = np.zeros(B, np.int32) if ok else rng.integers(0, 3, B).astype(np.int32)
        spills = base_sp if ok or rng.random() < 0.5 else base_sp + 1
        if not ok and leftover.sum() == 0 and spills == base_sp:
            leftover[0] = 1
        outs.append(p_solver.VariantOut(
            its=torch.from_numpy(rng.random((W, T_)) < 0.3),
            open=torch.from_numpy(rng.random(W) < 0.9),
            pods=torch.from_numpy(rng.integers(0, 60, W).astype(np.int32)),
            template=torch.from_numpy(rng.integers(0, G, W).astype(np.int32)),
            w_open=torch.tensor(w_open, dtype=torch.int32),
            spills=torch.tensor(spills, dtype=torch.int32),
            leftover=torch.from_numpy(leftover),
        ))
    if tie:
        outs = [outs[0] if v % 2 else o for v, o in enumerate(outs)]
    return torch.tensor(base_w, dtype=torch.int32), torch.tensor(base_sp, dtype=torch.int32), outs, torch.from_numpy(price), G


def _both(emulated, monkeypatch, base_w, base_sp, outs, price, objective, G):
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    sp, wp = p_solver.objective_verdict_plain(base_w, base_sp, outs, price, objective, G)
    sk, wk = p_cuda.objective_verdict(base_w, base_sp, outs, price, objective, G)
    assert torch.equal(wk, wp), (hex(int(wk[0]) & 0xFFFFFFFF), hex(int(wp[0]) & 0xFFFFFFFF))
    # scores bit for bit (+inf included)
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32)), (sk.tolist(), sp.tolist())
    return sk, int(wk[0]) & 0xFFFFFFFF


OBJECTIVES = {"cost_min": p_solver.OBJ_COST_MIN, "frag_aware": p_solver.OBJ_FRAG_AWARE,
              "topo_spread": p_solver.OBJ_TOPO_SPREAD, "gang_slice": p_solver.OBJ_GANG_SLICE,
              "lexical": p_solver.OBJ_LEXICAL}


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("KV", [1, 2, 4, 7, 24])
def test_emulated_verdict_equals_plain(objective, KV, emulated, monkeypatch):
    """Seeded outcomes, each objective, KV from 1 to VARIANT_MAX: scores
    and word equal; the word's winner is the argmin of the feasible
    scores (ties to the lowest index)."""
    base_w, base_sp, outs, price, G = _outcomes(KV * 7 + OBJECTIVES[objective], KV)
    scores, w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, OBJECTIVES[objective], G)
    feas = [(w >> v) & 1 for v in range(KV)]
    if any(feas):
        best = min((float(scores[v]), v) for v in range(KV) if feas[v])[1]
        assert (w >> 24) & 0xFF == best
    assert w & ((1 << 24) - 1) & ~((1 << KV) - 1) == 0


@pytest.mark.parametrize("case", ["all_infeasible", "all_inf", "ties"])
def test_emulated_verdict_edges(case, emulated, monkeypatch):
    """No feasible variant: winner 0, no feasibility bit. Every feasible
    cost_min score +inf (an opened claim whose viable types are all
    unpriced): the argmin of all-inf is 0, even with variant 0 infeasible
    (the reference's quirk, kept). Tied scores: the lowest index wins."""
    if case == "all_infeasible":
        base_w, base_sp, outs, price, G = _outcomes(1, 6, feasible=0.0)
        _s, w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, p_solver.OBJ_COST_MIN, G)
        assert w == 0
    elif case == "all_inf":
        base_w, base_sp, outs, price, G = _outcomes(2, 5, unpriced=1.0)
        outs = [o._replace(w_open=base_w + 30, open=torch.ones_like(o.open)) for o in outs]
        outs[0] = outs[0]._replace(leftover=torch.ones_like(outs[0].leftover))
        outs[3] = outs[3]._replace(leftover=torch.zeros_like(outs[3].leftover), spills=base_sp.clone(),
                                   w_open=base_w + 30)
        scores, w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, p_solver.OBJ_COST_MIN, G)
        assert not w & 1 and (w >> 3) & 1 and (w >> 24) == 0
        assert bool(torch.isinf(scores[3]))
    else:
        base_w, base_sp, outs, price, G = _outcomes(3, 8, feasible=1.0, tie=True)
        for obj in (p_solver.OBJ_COST_MIN, p_solver.OBJ_FRAG_AWARE, p_solver.OBJ_GANG_SLICE):
            scores, w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, obj, G)
            assert float(scores[1]) == float(scores[0])
            assert (w >> 24) & 0xFF != 1


def test_emulated_frag_aware_past_2_24(emulated, monkeypatch):
    """frag_aware with 1075 opened rows: n·1e6 is not a float, and the one
    rounding (fma) differs from two; the kernel's __fmaf_rn equals the
    plain f64-rounded-once value."""
    W = 1600
    base_w = torch.tensor(0, dtype=torch.int32)
    out = p_solver.VariantOut(
        its=torch.zeros((W, 4), dtype=torch.bool), open=torch.ones(W, dtype=torch.bool),
        pods=torch.full((W,), 1, dtype=torch.int32), template=torch.zeros(W, dtype=torch.int32),
        w_open=torch.tensor(1075, dtype=torch.int32), spills=torch.tensor(0, dtype=torch.int32),
        leftover=torch.zeros(1, dtype=torch.int32),
    )
    scores, _w = _both(emulated, monkeypatch, base_w, torch.tensor(0, dtype=torch.int32), [out],
                       torch.ones(4), p_solver.OBJ_FRAG_AWARE, 1)
    one = np.float32(1075 * 1e6 - 1075)
    two = np.float32(np.float32(np.float32(1075) * np.float32(1e6)) - np.float32(1075))
    assert one != two and float(scores[0]) == float(one)


@pytest.mark.parametrize("policy", ["cost_min", "frag_aware", "topo_spread", "gang_slice"])
def test_emulated_verdict_inside_cpu_solves(policy, emulated, monkeypatch):
    """A K = 4 CPU solve in which every objective round's verdict runs
    through the emulated kernel and the plain version: equal each round,
    and the solve's result equals the plain solve's."""
    monkeypatch.setenv("KTPU_OBJECTIVE_K", "4")
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.objective_verdict_plain
    rounds = []

    def both(base_w, base_sp, outs, price, objective, G):
        sp, wp = plain(base_w, base_sp, outs, price, objective, G)
        sk, wk = p_cuda.objective_verdict(base_w, base_sp, outs, price, objective, G)
        assert torch.equal(wk, wp) and torch.equal(sk.view(torch.int32), sp.view(torch.int32))
        rounds.append(int(wk[0]) & 0xFFFFFFFF)
        return sp, wp

    pods = T.mixed_pods(96)
    want = TorchScheduler(T.mixed_pool_templates(24), max_claims=128, device="cpu", objective=policy).solve(pods)
    monkeypatch.setattr(p_solver, "objective_verdict_plain", both)
    got = TorchScheduler(T.mixed_pool_templates(24), max_claims=128, device="cpu", objective=policy).solve(pods)
    assert rounds and T.claims_digest(got) == T.claims_digest(want)
    assert all(w & 0xF for w in rounds)
