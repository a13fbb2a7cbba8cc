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
plain version. The kernel spreads each variant's window rows over blocks
of XLA's 32-row windows (after lo = p // 2 padding rows) and folds their
partials in XLA's order in the block that takes the last ticket; the
rewrite routes its cross-block stores, adds, ticket and loads through
cuda_emu.h's memory model (a store not fenced before the ticket, or a
load not fenced after it, meets stale bytes), and cases reach what only
that layout has: opened rows across window boundaries, the only opened
row last in the last window, two launches on one workspace (the ticket
and the counts reset), more templates than threads and than the shared
histogram, gang_slice's p_max in another block, columns off their
16-byte alignment, the near-tie fleets, a W that is not a multiple of
32, W and G whose folds take two and three levels, and windows whose
integer sums pass 2^24 (gang_slice sums such a window's rows again). The
frag_aware case past 2^24 also holds the jitted reference's score. The
emulation checks the kernel's logic, not its timing or what the GPU
compiler does with it: chip_smoke.py holds the compiled kernel to the
plain version on the card. Tolerance: exact (the scores bit for bit).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import solver as j_solver

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from cuda_emu_build import c_entry, emulated_library


# the kernel's dynamic shared memory and cross-block helpers, their cuda_emu.h
# stand-ins, and a place where its threads give way
REWRITES = (
    ("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();"),
    ("  *p = v;\n}", "  emu_xstore(p, v);\n}"),
    ("  return __ldcg(p);", "  return emu_xload(p);"),
    ("{ atomicAdd(p, v); }", "{ emu_xadd(p, v); }"),
    ("{ return atomicAdd(t, 1u); }", "{ return emu_ticket(t); }"),
    # a thread gives way between its histogram add and its exchange, so an
    # add that lacks the barrier after the zeroing meets a later zero
    ("          atomicAdd(&s_hist[g], 1);\n", "          atomicAdd(&s_hist[g], 1);\n          emu_yield(8);\n"),
)


def rewrite(src: str) -> str:
    for old, new in REWRITES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated verdict kernel."""
    lib = emulated_library(tmp_path_factory, "objective_verdict", rewrite)
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
              unpriced=0.0, tie=False, base_w: int = 20):
    """KV seeded variant outcomes over one base (w_open base_w, spills 1):
    each opened a few rows past the base, some with leftovers or a spill; a
    price column with `unpriced` of its types at +inf. `tie` copies
    variant 0 into every odd variant."""
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.01, 9.0, T_).astype(np.float32)
    price[rng.random(T_) < unpriced] = np.inf
    base_sp = 1
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


class _St(NamedTuple):
    """The fields the reference's _objective_score reads of a state."""

    open: jnp.ndarray
    w_open: jnp.ndarray
    its: jnp.ndarray
    pods: jnp.ndarray
    template: jnp.ndarray


def _reference_score(base_w, out, price, objective: int, G: int) -> float:
    """The JAX package's jitted _objective_score of one variant outcome."""
    st = _St(*(jnp.asarray(t.numpy()) for t in (out.open, out.w_open, out.its, out.pods, out.template)))
    score = jax.jit(lambda b, s, p: j_solver._objective_score(b, s, p, objective, G))
    return score(st._replace(w_open=jnp.asarray(int(base_w), jnp.int32)), st, jnp.asarray(price.numpy()))


def test_emulated_frag_aware_past_2_24(emulated, monkeypatch):
    """frag_aware with 1075 opened rows: n·1e6 is not a float, and one
    rounding differs from two; the kernel's fma (one rounding) equals the
    plain version and the jitted reference bit for bit."""
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
    ref = _reference_score(base_w, out, torch.ones(4), p_solver.OBJ_FRAG_AWARE, 1)
    assert np.float32(ref).view(np.int32) == scores[:1].numpy().view(np.int32)[0]


def test_emulated_near_tie_fleets(emulated, monkeypatch):
    """ROADMAP §3's near-tie fleets (200 claims each over 400 priced
    types, a window of 256): the kernel's cost_min scores equal the plain
    version's and the reference's bit for bit, one ulp apart, and the
    word's winner is the reference's."""
    from test_torch_objectives import _near_tie_round

    _a, _ja, _exact, j_scores, j_winner, p_scores, word = _near_tie_round()
    from test_torch_objectives import _near_tie

    price, fleets, *_rest = _near_tie()
    n, W = len(fleets[0]), len(fleets[0]) + 56
    outs = []
    for rows in fleets:
        its = torch.zeros((W, price.shape[0]), dtype=torch.bool)
        its[torch.arange(n), torch.tensor(rows)] = True
        outs.append(p_solver.VariantOut(
            its=its, open=torch.arange(W) < n, pods=torch.ones(W, dtype=torch.int32),
            template=torch.zeros(W, dtype=torch.int32), w_open=torch.tensor(n, dtype=torch.int32),
            spills=torch.tensor(0, dtype=torch.int32), leftover=torch.zeros(1, dtype=torch.int32)))
    zero = torch.tensor(0, dtype=torch.int32)
    scores, w = _both(emulated, monkeypatch, zero, zero, outs, torch.from_numpy(price), p_solver.OBJ_COST_MIN, 1)
    assert np.array_equal(scores.numpy().view(np.int32), np.asarray(j_scores, dtype=np.float32).view(np.int32))
    assert (w >> 24) & 0xFF == j_winner and w == word and scores[0] != scores[1]


def _big_pods(W: int, seed: int, G: int = 2, T_: int = 16):
    """Two variants over W rows, most open from base 0: pods near 2^20 on
    most rows (a window's integer sum passes 2^24), small ones between and
    one row in 40 near 2^21 (p_max - pods passes 2^20 on the others, so
    gang_slice's window sums pass 2^24 too), seeded prices."""
    rng = np.random.default_rng(seed)
    outs = []
    for v in range(2):
        pods = np.where(rng.random(W) < 0.7, rng.integers((1 << 20) - 4000, 1 << 20, W),
                        rng.integers(0, 9, W))
        pods = np.where(rng.random(W) < 0.025, rng.integers(1 << 21, (1 << 21) + 4000, W), pods).astype(np.int32)
        outs.append(p_solver.VariantOut(
            its=torch.from_numpy(rng.random((W, T_)) < 0.5), open=torch.from_numpy(rng.random(W) < 0.95),
            pods=torch.from_numpy(pods), template=torch.from_numpy(rng.integers(0, G, W).astype(np.int32)),
            w_open=torch.tensor(W - v, dtype=torch.int32), spills=torch.tensor(0, dtype=torch.int32),
            leftover=torch.zeros(2, dtype=torch.int32)))
    price = torch.from_numpy((10.0 ** rng.uniform(-3, 3, T_)).astype(np.float32))
    return torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), outs, price, G


@pytest.mark.parametrize("objective", sorted(set(OBJECTIVES) - {"lexical"}))
@pytest.mark.parametrize("W", [45, 1100, 33000])
def test_emulated_tree_order(W, objective, emulated, monkeypatch):
    """XLA's order in the kernel: W = 45 (not a multiple of 32: 19 padding
    rows, 9 before the first window), W = 1100 (35 windows: the fold takes
    two levels) and W = 33000 (1032 windows: three levels), with pods whose
    window sums pass 2^24 (gang_slice, frag_aware and their windows' exact
    integer sums round differently there) and
    prices spanning 10^-3 to 10^3: kernel, plain version and the jitted
    reference bit for bit."""
    oid = OBJECTIVES[objective]
    base_w, base_sp, outs, price, G = _big_pods(W, W + oid)
    scores, _w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, oid, G)
    for v, out in enumerate(outs):
        ref = _reference_score(base_w, out, price, oid, G)
        assert np.float32(ref).view(np.int32) == scores[v:v + 1].numpy().view(np.int32)[0], (v, float(ref))


@pytest.mark.parametrize("G", [1500, 7000])
def test_emulated_topo_spread_tree_over_templates(G, emulated, monkeypatch):
    """topo_spread's sum over G in XLA's order: G = 1500 (47 windows, then
    2) and G = 7000 (219, then 7), counts whose squares pass 2^24 (every
    row of a variant on one template): kernel, plain version and reference
    bit for bit. A G whose levels pass a warp's shared floats is refused
    before the launch, naming the limit."""
    W = 4200
    base_w, base_sp, outs, price, _G = _big_pods(W, G)
    outs[0] = outs[0]._replace(template=torch.full((W,), G - 1, dtype=torch.int32))
    rng = np.random.default_rng(G)
    outs[1] = outs[1]._replace(template=torch.from_numpy(rng.integers(0, G, W).astype(np.int32)))
    scores, _w = _both(emulated, monkeypatch, base_w, base_sp, outs, price, p_solver.OBJ_TOPO_SPREAD, G)
    for v, out in enumerate(outs):
        ref = _reference_score(base_w, out, price, p_solver.OBJ_TOPO_SPREAD, G)
        assert np.float32(ref).view(np.int32) == scores[v:v + 1].numpy().view(np.int32)[0], (v, float(ref))
    with pytest.raises(p_cuda.LaunchRefused, match="more than a warp's 256"):
        p_cuda.objective_verdict(base_w, base_sp, outs, price, p_solver.OBJ_TOPO_SPREAD, 40000)


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


def _out(W: int, T_: int, opened: dict, *, w_open: int, leftover=(0,), spills: int = 0, seed: int = 0):
    """One variant outcome whose open rows are exactly `opened`
    ({row: (pods, template)}), each with a seeded viable-type row."""
    rng = np.random.default_rng(seed)
    open_ = np.zeros(W, bool)
    pods = np.zeros(W, np.int32)
    tmpl = np.zeros(W, np.int32)
    for r, (p, g) in opened.items():
        open_[r], pods[r], tmpl[r] = True, p, g
    return p_solver.VariantOut(
        its=torch.from_numpy(rng.random((W, T_)) < 0.4), open=torch.from_numpy(open_), pods=torch.from_numpy(pods),
        template=torch.from_numpy(tmpl), w_open=torch.tensor(w_open, dtype=torch.int32),
        spills=torch.tensor(spills, dtype=torch.int32), leftover=torch.tensor(leftover, dtype=torch.int32),
    )


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    off = 1 if flat.data_ptr() % 16 == 0 else 0
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


LAYOUT_CASES = ("straddle", "straddle_wide", "last_row_last_chunk", "pmax_other_block", "misaligned",
                "leftover_past_window")


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_emulated_verdict_layouts(case, objective, emulated, monkeypatch):
    """Cases only the work-item layout reaches: opened rows across the
    32-row windows (W = 300 from base 50; W = 1000 with T = 400, rows of 25
    16-byte vectors); a variant whose only opened row is the window's last
    (W = 200, the last window's row) beside one with none; gang_slice's
    p_max on a row of another window than the rest; every column and the
    price row a byte or an element off their 16-byte alignment; more
    leftover entries than window rows (the leftover chunks past W)."""
    oid = OBJECTIVES[objective]
    if case == "straddle":
        args = _outcomes(101, 4, W=300, base_w=50, G=7)
    elif case == "straddle_wide":
        args = _outcomes(102, 3, W=1000, T_=400, base_w=10, G=9)
    elif case == "last_row_last_chunk":
        W = 200
        outs = [_out(W, 40, {W - 1: (7, 2)}, w_open=W, seed=1), _out(W, 40, {}, w_open=W, seed=2),
                _out(W, 40, {W - 1: (3, 1), 5: (1, 0)}, w_open=W - 1, seed=3)]
        args = (torch.tensor(10, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), outs,
                torch.from_numpy(np.random.default_rng(4).uniform(0.1, 5.0, 40).astype(np.float32)), 3)
    elif case == "pmax_other_block":
        W = 256
        outs = [_out(W, 24, {70: (2, 0), 130: (3, 1), 250: (41, 2), 251: (5, 1)}, w_open=W, seed=5),
                _out(W, 24, {3: (90, 0), 64: (1, 0), 127: (2, 2), 128: (4, 1)}, w_open=200, seed=6)]
        args = (torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), outs,
                torch.from_numpy(np.random.default_rng(7).uniform(0.1, 5.0, 24).astype(np.float32)), 3)
    elif case == "misaligned":
        base_w, base_sp, outs, price, G = _outcomes(103, 3, W=150, T_=37, base_w=30)
        outs = [o._replace(its=_misaligned(o.its), open=_misaligned(o.open), pods=_misaligned(o.pods),
                           template=_misaligned(o.template), leftover=_misaligned(o.leftover)) for o in outs]
        args = (base_w, base_sp, outs, _misaligned(price), G)
    else:
        args = _outcomes(104, 5, W=40, B=150, base_w=5, feasible=0.5)
    _both(emulated, monkeypatch, *args[:4], oid, args[4])


@pytest.mark.parametrize("G", [300, 2100])
def test_emulated_topo_spread_many_templates(G, emulated, monkeypatch):
    """topo_spread with more templates than the block's 256 threads (G =
    300, counted in the shared histogram) and than that histogram (G =
    2100, counted straight into the [KV, G] scratch)."""
    base_w, base_sp, outs, price, _G = _outcomes(105 + G, 4, W=260, base_w=3, G=G)
    _both(emulated, monkeypatch, base_w, base_sp, outs, price, p_solver.OBJ_TOPO_SPREAD, G)


def test_emulated_two_launches_share_the_workspace(emulated, monkeypatch):
    """Launches in a row on one workspace (the stream's): each equals the
    plain version, so the last block left the ticket and the template
    counts at 0 for the next; a smaller layout after a larger one reuses
    the grown workspace, and the layouts alternate."""
    first = _outcomes(201, 6, W=300, base_w=40, G=40)
    second = _outcomes(202, 6, W=300, base_w=40, G=40)
    small = _outcomes(203, 2, W=64, base_w=0, G=4)
    for args, obj in ((first, p_solver.OBJ_TOPO_SPREAD), (second, p_solver.OBJ_TOPO_SPREAD),
                      (small, p_solver.OBJ_COST_MIN), (first, p_solver.OBJ_GANG_SLICE),
                      (second, p_solver.OBJ_TOPO_SPREAD)):
        _both(emulated, monkeypatch, *args[:4], obj, args[4])
    parts, hist, ticket = p_cuda._OBJ_WORKSPACES[(torch.device("cpu"), None)]
    assert int(ticket[0]) == 0 and not bool(hist.any())
