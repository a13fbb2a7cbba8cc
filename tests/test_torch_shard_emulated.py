"""The dp speculation kernels' own sources, csrc/dp_dead.cu (H12),
csrc/dp_verdict.cu (H13) and csrc/merge_shard.cu (H14), run on the CPU.

The CUDA kernels cannot run here, so this file compiles each with the
host's C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, the blocks of a grid
one after another) and routes ops/cuda.py's launches to those libraries.
The launchers then run on CPU tensors and are held to the plain versions
(ops/solver.py dp_dead_plain, dp_verdict_plain, merge_shard_fill_plain /
merge_shard_kscan_plain):
- inside CPU solves with dp = 2, 4 and 16 (fill, kind scan, per-pod,
  existing nodes, hostname groups, minValues under a budget), every
  round's deadness matrix, verdict word and every commit through the
  kernel and the plain version, equal, and the solve's result equal to
  the plain solve's;
- on a captured round widened to DP = 1, 5, 16 and 33 (two lanes of the
  word; past 32 rows H12's row pointers leave its parameters for a
  table; H13 takes 16 rows in its parameters and refuses 33), with
  padding rows (r_min = +inf) among the rows, in both of H12's modes;
- H13's findings one at a time on a round whose rows change nothing:
  fills in a row's third slab, leftovers, pods, vg / hg groups and
  templates in a second bit word, existing nodes (usage and requirement
  bytes) in a second and third, budgets, node counts, reservations,
  spills and deadness, each leaving its word; sixteen rows and
  launches in a row on one workspace;
- H14's output arena (its views alias no input and each other no byte;
  an in-place write into one leaves the rest) and the window's byte
  ranges on a commit widened to 1536 rows (many chunks, sources off the
  destination's alignment, sources the plain version clamps, no grab);
- H12's ceiling test at its edges (a total equal to the catalog's
  largest allocatable, a total of 0, a +inf request, a NaN usage), the
  kind-scan mode on the zone key and on another key, a catalog past the
  16384 cells H12 once refused (read in place, not staged), and launches
  in a row on one workspace.
H12's and H13's rewrites route their cross-block ors, tickets and loads
through cuda_emu.h's memory model (a missing fence or a ticket taken
early meets stale bytes); H13's and H14's flag a vector access off its
alignment, which x86 would hide.
The emulation checks the kernels' logic, not their timing or what the
GPU compiler does with them: chip_smoke.py holds the compiled kernels to
the plain versions on the card. Tolerance: exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver

from cuda_emu_build import c_entry, emulated_library
from test_torch_scheduler import _view

SOURCES = ("dp_dead", "dp_verdict", "merge_shard")
L_ZONE, L_CT, L_HOST = T.l.LABEL_TOPOLOGY_ZONE, T.l.CAPACITY_TYPE_LABEL_KEY, T.l.LABEL_HOSTNAME


# H12's dynamic shared memory, staged copies and cross-block helpers, and
# their cuda_emu.h stand-ins
DEAD_REWRITES = (
    ("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();"),
    # the staged catalog's copies give way, so a read that lacks the
    # barrier after them meets bytes not yet copied
    ("i += kThreads) s_cells[i] = a.cells[i];", "i += kThreads) { emu_yield(64); s_cells[i] = a.cells[i]; }"),
    ("i += kThreads) s_alloc[i] = a.alloc[i];", "i += kThreads) { emu_yield(64); s_alloc[i] = a.alloc[i]; }"),
    ("{ atomicOr(p, v); }", "{ emu_xor(p, v); }"),
    ("{ return __ldcg(p); }", "{ return emu_xload(p); }"),
    ("{ return atomicAdd(t, 1u); }", "{ return emu_ticket(t); }"),
)


def dead_rewrite(src: str) -> str:
    for old, new in DEAD_REWRITES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


# every vector access of H13 and H14 must be aligned to its width (the GPU
# faults on a misaligned one, x86 does not): the rewrites flag one in
# `emu_misaligned`, which fails the call
ALIGN_PRELUDE = ('extern "C" int emu_misaligned;\nint emu_misaligned = 0;\n'
                 "static inline void emu_al(const void* p, size_t n) {\n"
                 "  if ((uintptr_t)p % n) __atomic_store_n(&emu_misaligned, 1, __ATOMIC_RELAXED);\n}\n")

# H13's cross-block helpers and their cuda_emu.h stand-ins, and its vector
# loads' alignment
VERDICT_REWRITES = (
    ("{ atomicOr(p, v); }", "{ emu_xor(p, v); }"),
    ("{ return __ldcg(p); }", "{ return emu_xload(p); }"),
    ("{ return atomicAdd(t, 1u); }", "{ return emu_ticket(t); }"),
    ("return *reinterpret_cast<const int4*>(p + c);",
     "{ emu_al(p + c, 16); return *reinterpret_cast<const int4*>(p + c); }"),
    ("const float4 x = s4[w], y = b4[w];", "emu_al(&s4[w], 16); emu_al(&b4[w], 16); const float4 x = s4[w], y = b4[w];"),
    ("if (!(sw[w] == bw[w]))", "if ((emu_al(&sw[w], sizeof(Word)), emu_al(&bw[w], sizeof(Word)), !(sw[w] == bw[w])))"),
    # a warp gives way before it ORs its fields' nodes into the block's word,
    # so a read of the word that lacks the barrier after the ORs misses some
    ("if (m && lane == 0) atomicOr(&s_m, m);", "if (m && lane == 0) { emu_yield(64); atomicOr(&s_m, m); }"),
)
# H14's vector copies' alignment
MERGE_REWRITES = (
    ("for (int64_t x = tid; x < body; x += nthreads) d4[x] = s4[x];\n  } else",
     "for (int64_t x = tid; x < body; x += nthreads) { emu_al(&d4[x], 16); emu_al(&s4[x], 16); d4[x] = s4[x]; }\n"
     "  } else"),
    ("for (int64_t x = tid; x < body; x += nthreads) d4[x] = s4[x];\n  }\n",
     "for (int64_t x = tid; x < body; x += nthreads) { emu_al(&d4[x], 4); emu_al(&s4[x], 4); d4[x] = s4[x]; }\n  }\n"),
)


def _rewrite(src: str, rewrites) -> str:
    for old, new in rewrites:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    assert src.count("#include <string.h>\n") == 1
    return src.replace("#include <string.h>\n", "#include <string.h>\n" + ALIGN_PRELUDE)


def verdict_rewrite(src: str) -> str:
    return _rewrite(src, VERDICT_REWRITES)


def merge_rewrite(src: str) -> str:
    return _rewrite(src, MERGE_REWRITES)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry calls routed to the emulated dp kernels."""
    rewrites = {"dp_dead": dead_rewrite, "dp_verdict": verdict_rewrite, "merge_shard": merge_rewrite}
    libs = {name: emulated_library(tmp_path_factory, name, rewrites[name]) for name in SOURCES}
    fns = {name: c_entry(lib, name) for name, lib in libs.items()}
    misaligned = {name: ctypes.c_int.in_dll(libs[name], "emu_misaligned") for name in ("dp_verdict", "merge_shard")}
    calls = {n: 0 for n in SOURCES}

    def invoke(source, entry, *args):
        assert source == entry and source in fns, (source, entry)
        rc = fns[source](*args, None)
        if rc:
            raise RuntimeError(f"emulated {source}: error {rc}")
        if source in misaligned and misaligned[source].value:
            misaligned[source].value = 0
            pytest.fail(f"emulated {source}: a vector access off its alignment")
        calls[source] += 1

    invoke.calls = calls
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _same_state(a, b, what):
    for f in p_solver.SolverState._fields:
        x, y = getattr(a, f), getattr(b, f)
        xs, ys = (list(x), list(y)) if isinstance(x, tuple) else ([x], [y])
        for i, (u, v) in enumerate(zip(xs, ys)):
            assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v), (what, f, i)


def _both_ways(monkeypatch, emulated, rounds: list):
    """Route the dp wrappers through the emulated kernels AND the plain
    versions, assert they agree, return the plain results; each round's
    H12 / H13 inputs are appended to `rounds`."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain_dead, plain_verdict = p_solver.dp_dead_plain, p_solver.dp_verdict_plain
    plain_fill, plain_kscan = p_solver.merge_shard_fill_plain, p_solver.merge_shard_kscan_plain

    def dead(base, specs, r_min, it, key=None, plain=False):
        want = plain_dead(base, specs, r_min, it, key)
        got = p_cuda.dp_dead(base, specs, r_min, it, key)
        assert torch.equal(got, want), (got, want)
        rounds.append(dict(base=base, specs=specs, r_min=r_min, it=it, key=key))
        return want

    def verdict(base, specs, dead_m, exist, n_claims, vin, plain=False):
        want = plain_verdict(base, specs, dead_m, exist, n_claims, vin)
        got = p_cuda.dp_verdict(base, specs, dead_m, exist, n_claims, vin)
        assert torch.equal(got, want), (got, want)
        rounds[-1].update(dead=dead_m, exist=exist, n_claims=n_claims, vin=vin)
        return want

    def fill(committed, spec, base, plain=False):
        want = plain_fill(committed, spec, base)
        got, shifted, _none = p_cuda.merge_shard(committed, spec, base, None)
        _same_state(got, want[0], "merge_shard fill")
        assert torch.equal(shifted, want[1])
        return want

    def kscan(committed, spec, assignment, base, plain=False):
        want = plain_kscan(committed, spec, assignment, base)
        got, shifted, assign = p_cuda.merge_shard(committed, spec, base, assignment)
        _same_state(got, want[0], "merge_shard kscan")
        assert torch.equal(shifted, want[1]) and torch.equal(assign, want[2])
        return want

    monkeypatch.setattr(p_solver, "dp_dead", dead)
    monkeypatch.setattr(p_solver, "dp_verdict", verdict)
    monkeypatch.setattr(p_solver, "merge_shard_fill", fill)
    monkeypatch.setattr(p_solver, "merge_shard_kscan", kscan)


SOLVES = {
    "fill_dp16": (lambda: T.sized_kind_pods(256, kinds=16, prefix="x", mixed=False), 16, None, None, None),
    "fill_graft": (lambda: T.sized_kind_pods(128, kinds=4, prefix="s", mixed=False), 2, None, None, None),
    "fill_replay": (lambda: T.sized_kind_pods(128, kinds=4, prefix="m"), 2, None, None, None),
    "existing": (lambda: T.sized_kind_pods(128, kinds=4, prefix="e"), 2, None,
                 lambda: T.existing_sim_nodes(cpu_avail=8.0), None),
    "hostname_spread": (lambda: T.spread_kind_pods(96, 4, "h", (L_HOST,), label="hspread"), 2, None, None, None),
    "kscan": (lambda: T.spread_kind_pods(96, 4, "z", (L_ZONE,)), 2, None, None, None),
    "kscan_shared": (lambda: T.spread_kind_pods(96, 4, "zs", (L_ZONE,), shared=True), 2, None, None, None),
    "perpod_dp4": (lambda: T.spread_kind_pods(128, 4, "pp", (L_ZONE, L_CT)), 4, 32, None, None),
    "perpod_mv_budget": (lambda: T.spread_kind_pods(128, 4, "pb", (L_ZONE, L_CT), mixed=True), 2, 32, None,
                         {"default": {"cpu": 1e6}}),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_emulated_kernels_inside_cpu_solves(case, emulated, monkeypatch):
    pods_fn, dp, chunk, existing_fn, budgets = SOLVES[case]
    templates = T.mv_templates(24) if case == "perpod_mv_budget" else T.make_templates(24)

    def solve(dp_n):
        s = TorchScheduler(templates, device="cpu", dp=dp_n)
        s.pipeline_min_pods = 32
        if chunk:
            s.solve_chunk = chunk
        kw = dict(budgets={p: dict(b) for p, b in budgets.items()}) if budgets else {}
        return s.solve(pods_fn(), existing_fn() if existing_fn else [], **kw), s.last_stats

    want, _stats = solve(1)
    rounds = []
    _both_ways(monkeypatch, emulated, rounds)
    got, stats = solve(dp)
    assert _view(got) == _view(want)
    assert stats["shard"]["merge_rounds"] == len(rounds) >= 1
    assert emulated.calls["dp_dead"] >= len(rounds) and emulated.calls["dp_verdict"] >= len(rounds)


def _captured_round(monkeypatch, pods, dp, chunk=None, which: int = 0, existing=None):
    """The H12 / H13 inputs of a CPU dp solve's first round (or round
    `which`; plain versions throughout), with `existing` nodes."""
    rounds = []
    dead_plain, verdict_plain = p_solver.dp_dead, p_solver.dp_verdict

    def dead(base, specs, r_min, it, key=None, plain=False):
        rounds.append(dict(base=base, specs=specs, r_min=r_min, it=it, key=key))
        return dead_plain(base, specs, r_min, it, key)

    def verdict(base, specs, dead_m, exist, n_claims, vin, plain=False):
        rounds[-1].update(dead=dead_m, exist=exist, n_claims=n_claims, vin=vin)
        return verdict_plain(base, specs, dead_m, exist, n_claims, vin)

    with monkeypatch.context() as m:
        m.setattr(p_solver, "dp_dead", dead)
        m.setattr(p_solver, "dp_verdict", verdict)
        s = TorchScheduler(T.make_templates(24), device="cpu", dp=dp)
        s.pipeline_min_pods = 32
        if chunk:
            s.solve_chunk = chunk
        s.solve(pods, existing or [])
    return rounds[which]


def _widen(rnd: dict, DP: int, pad_every: int):
    """The round's rows repeated to DP rows, every pad_every-th a padding
    row (r_min = +inf)."""
    n = len(rnd["specs"])
    pick = [r % n for r in range(DP)]
    r_min = rnd["r_min"][pick].clone()
    for r in range(DP):
        if pad_every and r % pad_every == pad_every - 1:
            r_min[r] = float("inf")
    vin = rnd["vin"]
    rows = {f: (getattr(vin, f)[pick] if getattr(vin, f) is not None else None)
            for f in ("exist_ok_rows", "rec_v", "app_v", "rec_h", "app_h", "apply_tmpl")}
    lists = {f: ([getattr(vin, f)[i] for i in pick] if getattr(vin, f) is not None else None)
             for f in ("fill_c", "leftover")}
    return [rnd["specs"][i] for i in pick], r_min, vin._replace(r_min=r_min, **rows, **lists)


@pytest.mark.parametrize("family", ["fill", "kscan", "perpod"])
@pytest.mark.parametrize("DP", [1, 5, 16, 33])
def test_emulated_round_widened(family, DP, emulated, monkeypatch):
    """A captured round's rows repeated to DP = 1, 5, 16 and 33 (the word's
    second lane, and past the 32 rows whose pointers ride H12's
    parameters), every third row a padding row: H12 (its kscan mode on the
    kind-scan round) and H13 equal their plain versions; H13 takes up to
    16 rows, their pointers in its parameters, and refuses 33 before the
    launch, naming the limit."""
    if family == "fill":
        rnd = _captured_round(monkeypatch, T.sized_kind_pods(128, kinds=4, prefix="w", mixed=False), 2)
    elif family == "kscan":
        rnd = _captured_round(monkeypatch, T.spread_kind_pods(96, 4, "wz", (L_ZONE,)), 2)
    else:
        rnd = _captured_round(monkeypatch, T.spread_kind_pods(128, 4, "wp", (L_ZONE, L_CT)), 4, chunk=32)
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    specs, r_min, vin = _widen(rnd, DP, 3)
    base, it, key = rnd["base"], rnd["it"], rnd["key"]
    assert (key is not None) == (family == "kscan")
    want_dead = p_solver.dp_dead_plain(base, specs, r_min, it, key)
    assert torch.equal(p_cuda.dp_dead(base, specs, r_min, it, key), want_dead)
    if DP > 2:
        assert bool(want_dead[2].all())  # a padding row: everything dead for +inf
    want = p_solver.dp_verdict_plain(base, specs, want_dead, rnd["exist"], rnd["n_claims"], vin)
    if DP > p_cuda.DP_VERDICT_ROWS:
        with pytest.raises(p_cuda.LaunchRefused, match=r"outside \[1, 16\]"):
            p_cuda.dp_verdict(base, specs, want_dead, rnd["exist"], rnd["n_claims"], vin)
        assert want.shape == ((DP + 31) // 32,)
        return
    got = p_cuda.dp_verdict(base, specs, want_dead, rnd["exist"], rnd["n_claims"], vin)
    assert got.shape == ((DP + 31) // 32,) and torch.equal(got, want)


_ROUNDS: dict = {}


def _round(family: str) -> dict:
    """The captured last round of a small CPU dp solve of `family` (fill,
    kscan; its base holds open claims), kept for the module."""
    if family not in _ROUNDS:
        with pytest.MonkeyPatch.context() as m:
            if family == "fill":
                pods = T.sized_kind_pods(128, kinds=4, prefix="w", mixed=False)
            else:
                pods = T.spread_kind_pods(96, 4, "wz", (L_ZONE,))
            _ROUNDS[family] = _captured_round(m, pods, 2, which=-1)
    return _ROUNDS[family]


def _dead_both(emulated, monkeypatch, base, specs, r_min, it, key):
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    want = p_solver.dp_dead_plain(base, specs, r_min, it, key)
    got = p_cuda.dp_dead(base, specs, r_min, it, key)
    assert torch.equal(got, want), (got, want)
    return want


def _ceiling(it) -> torch.Tensor:
    return torch.where(it.group_valid[:, :, None], it.alloc, float("-inf")).amax(dim=(0, 1))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_usage"])
@pytest.mark.parametrize("family", ["fill", "kscan"])
def test_emulated_dead_ceiling_edges(family, nan, emulated, monkeypatch):
    """H12's ceiling test where it must not decide wrongly: a request whose
    total with an open row's usage equals the catalog's largest
    allocatable in one resource, the row viable for the type that holds it
    (the scan must run: in the fill mode that cell takes it), a
    request of 0 (totals of 0 where the row uses nothing), a +inf request
    (a padding row: dead everywhere) and the round's own request; with the
    base's usage finite, or NaN in one resource of every other open row."""
    rnd = _round(family)
    base, specs, it, key = rnd["base"], rnd["specs"], rnd["it"], rnd["key"]
    ceil = _ceiling(it).numpy()
    rows = torch.nonzero(base.open).flatten().tolist()
    assert rows
    u = base.used[rows[0]].numpy()
    k = int(np.argmax(np.isfinite(ceil) & (ceil > u)))
    # the first open row may also use the type that holds the ceiling
    t_max = int(torch.nonzero((it.alloc[:, :, k] == float(ceil[k])) & it.group_valid)[0, 0])
    its = base.its.clone()
    its[rows[0], t_max] = True
    base = base._replace(its=its)
    at = np.zeros_like(u)
    at[k] = np.float32(ceil[k]) - np.float32(u[k])
    while np.float32(u[k]) + at[k] > ceil[k]:
        at[k] = np.nextafter(at[k], np.float32(-np.inf))
    while np.float32(u[k]) + at[k] < ceil[k]:
        at[k] = np.nextafter(at[k], np.float32(np.inf))
    assert np.float32(u[k]) + at[k] == ceil[k]
    r_min = torch.stack([torch.from_numpy(at), torch.zeros_like(rnd["r_min"][0]),
                         torch.full_like(rnd["r_min"][0], float("inf")), rnd["r_min"][0]])
    specs = [specs[i % len(specs)] for i in range(4)]
    if nan:
        used = base.used.clone()
        used[rows[1::2], k] = float("nan")
        base = base._replace(used=used)
    dead = _dead_both(emulated, monkeypatch, base, specs, r_min, it, key)
    assert bool(dead[2].all())
    if not nan:
        assert not bool(dead[1, 0])
        if key is None:  # the cell at the ceiling takes the request exactly
            assert not bool(dead[0, 0])


def _tiled(it, n: int):
    """The catalog's types repeated n times (the same cells, n * T types)."""
    def tile(t):
        return t.repeat(n, *([1] * (t.dim() - 1)))

    return it._replace(**{f: (type(v)(*map(tile, v)) if isinstance(v, tuple) else tile(v))
                          for f, v in it._asdict().items()})


@pytest.mark.parametrize("case", ["zone_key", "other_key", "past_16384_cells", "fill_past_16384_cells"])
def test_emulated_dead_catalogs(case, emulated, monkeypatch):
    """The kind scan's mode on the zone key and on another vocab key of the
    catalog (a key every type leaves undefined admits every domain), and
    a catalog past the 16384 (type, group) cells H12 refused before its
    cell words: the captured round's types repeated to T * GR > 16384,
    too large to stage, read in place, in both modes."""
    rnd = _round("fill" if case.startswith("fill") else "kscan")
    base, specs, r_min, it, key = rnd["base"], rnd["specs"], rnd["r_min"], rnd["it"], rnd["key"]
    if case.endswith("past_16384_cells"):  # the base's first 8 open claims: a dead row scans every type
        keep = torch.zeros_like(base.open)
        keep[torch.nonzero(base.open).flatten()[:8]] = True
        base = base._replace(open=keep)
    else:
        r_min = torch.cat([r_min, r_min * 0.5, r_min * 4.0])
    specs = [specs[i % len(specs)] for i in range(r_min.shape[0])]
    if case == "other_key":
        K, V = it.reqs.mask.shape[1:]
        other = next(k for k in range(K) if k != key.zone_kid)
        key = p_solver.DpKey(other, key.zone_kid, min(4, V))
    elif case.endswith("past_16384_cells"):
        T_, GR = it.alloc.shape[:2]
        n = 16384 // (T_ * GR) + 1
        it = _tiled(it, n)
        assert it.alloc.shape[0] * GR > 16384
        base = base._replace(its=base.its.repeat(1, n))
        specs = [s._replace(its=s.its.repeat(1, n)) for s in specs]
    _dead_both(emulated, monkeypatch, base, specs, r_min, it, key)


def test_emulated_dead_launches_share_the_workspace(emulated, monkeypatch):
    """H12 launches in a row on one workspace (the stream's): a kind-scan
    round, a fill round, the fill round at DP = 33 (its table; two alive
    words, both with live requests) and the kind-scan round again each
    equal the plain version, so the last block left the alive words and
    the ticket at 0; they are 0 after."""
    kr, fr = _round("kscan"), _round("fill")
    wide, r33, _vin = _widen(fr, 33, 3)
    r33[1::2] = 0.0  # requests of 0 (31 and 32 among them, one in each alive word) are alive on open rows
    r33[32] = 0.0
    for base, specs, r_min, it, key in (
            (kr["base"], kr["specs"], kr["r_min"], kr["it"], kr["key"]),
            (fr["base"], fr["specs"], fr["r_min"], fr["it"], None),
            (fr["base"], wide, r33, fr["it"], None),
            (kr["base"], kr["specs"], kr["r_min"], kr["it"], kr["key"])):
        dead = _dead_both(emulated, monkeypatch, base, specs, r_min, it, key)
        if len(specs) == 33:
            assert not bool(dead[31].all()) and not bool(dead[32].all())
    alive, ticket = p_cuda._DP_WORKSPACES[(torch.device("cpu"), None)]
    assert int(ticket[0]) == 0 and not bool(alive.any())


# ---- H13's findings, one at a time, on a round whose rows change nothing ----


def _tile_exist(st, n: int):
    """The state's existing-node fields repeated to n times the nodes."""
    def rep(t):
        return t.repeat(n, *([1] * (t.dim() - 1)))

    return st._replace(exist_used=rep(st.exist_used), exist_ports=rep(st.exist_ports), exist_vols=rep(st.exist_vols),
                       exist_reqs=type(st.exist_reqs)(*map(rep, st.exist_reqs)))


def _quiet_round(family: str, DP: int = 4):
    """DP rows that each leave the round's base as it was (every row the
    base itself, fill grids and leftovers 0, no group records or
    applies), the deadness matrix all dead and r_min 0 (every valid node
    viable for every row): the verdict word is all ones. fill: the fill
    family's last round (open claims below the base's w_open), rows of 1,
    5 and 9 segments; kscan: the kind-scan family (pods columns, vg
    groups widened to 64); existing: the fill round of a solve with
    existing nodes, tiled to 80 nodes (three bit words); apply: the
    per-pod family's budget / reservation bit, 40 templates."""
    if family == "existing":
        with pytest.MonkeyPatch.context() as m:
            rnd = _captured_round(m, T.sized_kind_pods(128, kinds=4, prefix="eq", mixed=False), 2, which=-1,
                                  existing=T.existing_sim_nodes(cpu_avail=8.0))
        base = _tile_exist(rnd["base"], 40)
        exist = rnd["exist"]._replace(valid=exist_rep(rnd["exist"].valid, 40), avail=exist_rep(rnd["exist"].avail, 40))
    else:
        rnd = _round("kscan" if family == "kscan" else "fill")
        base, exist = rnd["base"], rnd["exist"]
    E, R = base.exist_used.shape
    W = base.open.shape[0]
    assert int(base.w_open) > 1
    fill = family in ("fill", "existing")
    B = [1, 5, 9, 2][:DP] + [3] * max(DP - 4, 0)
    specs = [base._replace(pods=base.pods.clone(), spills=base.spills.clone(), exist_used=base.exist_used.clone(),
                           exist_reqs=type(base.exist_reqs)(*(t.clone() for t in base.exist_reqs)),
                           budget=base.budget.clone(), nodes_budget=base.nodes_budget.clone(),
                           res_cap=base.res_cap.clone()) for _q in range(DP)]
    NGv = 64 if family == "kscan" else 0
    NGh = 64
    z = dict(dtype=torch.bool)
    vin = p_solver.DpVerdictIn(
        r_min=torch.zeros((DP, R)), exist_ok_rows=torch.ones((DP, E), **z),
        rec_v=torch.zeros((DP, NGv), **z), app_v=torch.zeros((DP, NGv), **z), rec_h=torch.zeros((DP, NGh), **z),
        app_h=torch.zeros((DP, NGh), **z),
        apply_tmpl=torch.zeros((DP, base.budget.shape[0]), **z) if family == "apply" else None,
        fill_c=[torch.zeros((b, W), dtype=torch.int32) for b in B] if fill else None,
        leftover=[torch.zeros(b, dtype=torch.int32) for b in B] if fill else None)
    dead = torch.ones((DP, 1 + DP), dtype=torch.bool)
    return dict(base=base, specs=specs, dead=dead, exist=exist, n_claims=rnd["n_claims"], vin=vin)


def exist_rep(t, n):
    return t.repeat(n, *([1] * (t.dim() - 1)))


def _verdict_word(emulated, monkeypatch, r) -> int:
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    args = (r["base"], r["specs"], r["dead"], r["exist"], r["n_claims"], r["vin"])
    want = p_solver.dp_verdict_plain(*args)
    got = p_cuda.dp_verdict(*args)
    assert torch.equal(got, want), (got, want)
    return int(want[0]) & 0xFFFFFFFF


FINDINGS = {
    # name: (family, mutation of the quiet round, the word it leaves)
    "quiet_fill": ("fill", lambda r: None, 0b1111),
    "quiet_kscan": ("kscan", lambda r: None, 0b1111),
    "fill_touch_last_slab": ("fill", lambda r: r["vin"].fill_c[2].__setitem__((8, int(r["base"].w_open) - 1), 1),
                             0b0011),
    "fill_touch_at_w_open": ("fill", lambda r: r["vin"].fill_c[1].__setitem__((4, int(r["base"].w_open)), 3), 0b1111),
    "leftover": ("fill", lambda r: r["vin"].leftover[1].__setitem__(3, 2), 0b0001),
    "pods_touch": ("kscan", lambda r: r["specs"][2].pods.__setitem__(int(r["base"].w_open) - 1,
                                                                        int(r["base"].pods[int(r["base"].w_open) - 1])
                                                                        + 1), 0b0011),
    "pods_fewer": ("kscan", lambda r: r["specs"][1].pods.__setitem__(0, int(r["base"].pods[0]) - 1), 0b1111),
    "vg_record_apply": ("kscan", lambda r: (r["vin"].rec_v.__setitem__((0, 60), True),
                                            r["vin"].app_v.__setitem__((2, 60), True)), 0b0011),
    "vg_record_later_row": ("kscan", lambda r: (r["vin"].rec_v.__setitem__((2, 5), True),
                                                r["vin"].app_v.__setitem__((1, 5), True)), 0b1111),
    "hg_record_apply": ("fill", lambda r: (r["vin"].rec_h.__setitem__((1, 50), True),
                                           r["vin"].app_h.__setitem__((3, 50), True)), 0b0111),
    "exist_usage": ("existing", lambda r: r["specs"][0].exist_used.__setitem__((37, 0), -1.0), 0b0001),
    "exist_reqs_byte": ("existing", lambda r: r["specs"][1].exist_reqs[0].__setitem__(
        (79,) + (0,) * (r["specs"][1].exist_reqs[0].dim() - 1), ~r["specs"][1].exist_reqs[0][(79,) + (0,) * (
            r["specs"][1].exist_reqs[0].dim() - 1)]), 0b0011),
    "exist_not_viable": ("existing", lambda r: (r["specs"][0].exist_used.__setitem__((37, 0), -1.0),
                                                r["vin"].exist_ok_rows[1:, 37].fill_(False)), 0b1111),
    "budget": ("apply", lambda r: (r["specs"][0].budget.__setitem__((21, 0), -3.0),
                                   r["vin"].apply_tmpl.__setitem__((3, 21), True)), 0b0111),
    "nodes_budget": ("apply", lambda r: (r["specs"][1].nodes_budget.__setitem__(33, 7.0),
                                         r["vin"].apply_tmpl.__setitem__((2, 33), True)), 0b0011),
    "reservation": ("apply", lambda r: r["specs"][1].res_cap.__setitem__(0, int(r["base"].res_cap[0]) - 1), 0b0011),
    "spills": ("fill", lambda r: r["specs"][2].spills.add_(1), 0b0011),
    "dead": ("fill", lambda r: r["dead"].__setitem__((1, 0), False), 0b0001),
    "dead_earlier_opens": ("fill", lambda r: r["dead"].__setitem__((3, 1 + 2), False), 0b0111),
}


@pytest.mark.parametrize("case", sorted(FINDINGS))
def test_emulated_verdict_findings(case, emulated, monkeypatch):
    """Each of H13's findings alone on a round whose rows change nothing
    (_quiet_round, DP = 4; each group or template on a lane past 15 of its
    word or in a second word): a fill below the base's w_open in a segment of
    a row's third slab (and one at w_open, which does not count), a
    leftover, more pods below w_open (fewer do not count), a vg / hg group
    an earlier row records and a later one applies (the other way round
    does not count; groups in a second bit word), an existing node's usage
    or a requirement byte changed where a later row may use it (not where
    its existing-node gate is closed; nodes in a second and third bit
    word), a budget or node count of a template a later row's pods
    consider (templates in a second bit word), a reservation capacity, a
    new spill, a row's base or an earlier row's opens alive: kernel and
    plain version equal, and the word is the one the finding leaves."""
    family, mutate, want = FINDINGS[case]
    if family == "apply":
        r = _quiet_round("kscan")
        G, R = r["base"].budget.shape
        base = r["base"]._replace(budget=torch.rand((40, R)) * 10, nodes_budget=torch.full((40,), 5.0),
                                  res_cap=torch.tensor([4, 9], dtype=torch.int32))
        r["base"] = base
        r["specs"] = [base._replace(budget=base.budget.clone(), nodes_budget=base.nodes_budget.clone(),
                                    res_cap=base.res_cap.clone()) for _q in range(4)]
        r["vin"] = r["vin"]._replace(apply_tmpl=torch.zeros((4, 40), dtype=torch.bool))
    else:
        r = _quiet_round(family)
    mutate(r)
    assert _verdict_word(emulated, monkeypatch, r) == want


def test_emulated_verdict_dp16_and_workspace(emulated, monkeypatch):
    """Sixteen quiet rows, then findings at rows 9 and 14, then the quiet
    round again, on one workspace: each equals the plain version (the last
    block left the bit words and the ticket at 0), and the words are all
    ones, ones below row 9, all ones."""
    quiet = _quiet_round("fill", DP=16)
    assert _verdict_word(emulated, monkeypatch, quiet) == 0xFFFF
    r = _quiet_round("fill", DP=16)
    r["vin"].leftover[14][2] = 1
    r["specs"][9].spills.add_(1)
    assert _verdict_word(emulated, monkeypatch, r) == 0x1FF
    assert _verdict_word(emulated, monkeypatch, _quiet_round("fill", DP=16)) == 0xFFFF
    ws, ticket = p_cuda._DPV_WORKSPACES[(torch.device("cpu"), None)]
    assert int(ticket[0]) == 0 and not bool(ws.any())


# ---- H14: the output arena and the window's byte ranges ----------------------


def _captured_commit(kscan: bool):
    """The arguments of the first commit of a small CPU dp solve (fill:
    merge_shard_fill's (committed, spec, base); kscan: merge_shard_kscan's
    (committed, spec, assignment, base))."""
    name = "merge_shard_kscan" if kscan else "merge_shard_fill"
    rec = []
    real = getattr(p_solver, name)

    def grab(*a, **k):
        rec.append(a)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(p_solver, name, grab)
        pods = (T.spread_kind_pods(96, 4, "cz", (L_ZONE,)) if kscan
                else T.sized_kind_pods(128, kinds=4, prefix="cf", mixed=False))
        s = TorchScheduler(T.make_templates(24), device="cpu", dp=2)
        s.pipeline_min_pods = 32
        s.solve(pods, T.existing_sim_nodes(cpu_avail=8.0))
    assert rec, name
    return rec[0]


def _merge_both(emulated, monkeypatch, committed, spec, base, assignment=None):
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    got = p_cuda.merge_shard(committed, spec, base, assignment)
    if assignment is None:
        want = p_solver.merge_shard_fill_plain(committed, spec, base) + (None,)
    else:
        want = p_solver.merge_shard_kscan_plain(committed, spec, assignment, base)
    _same_state(got[0], want[0], "merge_shard")
    assert torch.equal(got[1], want[1])
    assert assignment is None or torch.equal(got[2], want[2])
    return got


def _ranges(ts) -> list:
    return [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in ts if t.numel()]


@pytest.mark.parametrize("mode", ["fill", "kscan"])
def test_emulated_merge_arena(mode, emulated, monkeypatch):
    """The merged state's written fields are views of one arena: each
    aliases no byte of committed, spec or base, no two overlap, and an
    in-place write into one leaves every other (and the inputs) as it
    was."""
    args = _captured_commit(mode == "kscan")
    committed, spec = args[0], args[1]
    base = args[-1]
    assignment = args[2] if mode == "kscan" else None
    merged, shifted, assign = _merge_both(emulated, monkeypatch, committed, spec, base, assignment)
    written = [t for f in p_solver.SolverState._fields for t in
               (getattr(merged, f) if isinstance(getattr(merged, f), tuple) else (getattr(merged, f),))
               if all(t is not u for st in (committed,) for g in p_solver.SolverState._fields
                      for u in (getattr(st, g) if isinstance(getattr(st, g), tuple) else (getattr(st, g),)))]
    written += [shifted] + ([assign] if assign is not None else [])
    assert len(written) >= 20
    inputs = [u for st in (committed, spec, base) for g in p_solver.SolverState._fields
              for u in (getattr(st, g) if isinstance(getattr(st, g), tuple) else (getattr(st, g),))]
    out_r, in_r = _ranges(written), _ranges(inputs)
    for a0, a1 in out_r:
        assert all(a1 <= b0 or b1 <= a0 for b0, b1 in in_r)
    out_r.sort()
    assert all(x[1] <= y[0] for x, y in zip(out_r, out_r[1:]))
    before = [t.clone() for t in written]
    ins = [t.clone() for t in inputs]
    merged.used.add_(1.0)
    for t, b in zip(written, before):
        if t is not merged.used:
            assert torch.equal(t, b)
    assert all(torch.equal(t, b) for t, b in zip(inputs, ins))


@pytest.mark.parametrize("case", ["wide_window", "clamped_sources", "no_grab"])
def test_emulated_merge_window_ranges(case, emulated, monkeypatch):
    """The window's byte ranges on a captured fill commit widened to 1536
    rows (the columns' bytes in many chunks): grabbed rows 700-899 from
    the spec's 650-849 (sources off the destination's alignment);
    sources the plain version clamps to the window's last row (a spec
    w_open past W: copied row by row); and k = 0 (committed throughout)."""
    committed, spec, base = _captured_commit(False)
    n = 1536 // committed.open.shape[0]

    def widen(st, w_open):
        out = {}
        for f in p_solver.GRAFT_WINDOW + ("open", "slot_of"):
            v = getattr(st, f)
            rep = (lambda t: t.repeat(n, *([1] * (t.dim() - 1))))
            out[f] = type(v)(*map(rep, v)) if isinstance(v, tuple) else rep(v)
        return st._replace(**out, w_open=torch.tensor(w_open, dtype=torch.int32))

    W = committed.open.shape[0] * n
    cw, bw, sw = {"wide_window": (700, 650, 850), "clamped_sources": (1400, 1480, 1600),
                  "no_grab": (700, 650, 650)}[case]
    c, s, b = widen(committed, cw), widen(spec, sw), widen(base, bw)
    assert W == 1536 and c.used.shape[0] == W
    merged, _shifted, _a = _merge_both(emulated, monkeypatch, c, s, b)
    if case == "wide_window":
        assert torch.equal(merged.its[700:900], s.its[650:850]) and torch.equal(merged.its[:700], c.its[:700])


def test_emulated_merge_exist_whole_node(emulated, monkeypatch):
    """A node the row touched in one usage component (the fourth, a lane's
    word) is copied whole from the spec, where committed holds other
    bytes in every field (an earlier commit's): each of the node's fields
    equals the spec's, and the other nodes committed's."""
    committed, spec, base = _captured_commit(False)
    E = committed.exist_used.shape[0]
    assert E >= 2 and committed.exist_used.shape[1] >= 4

    def bump(st, k):
        return st._replace(exist_used=st.exist_used + k, exist_ports=st.exist_ports + k,
                           exist_vols=st.exist_vols + k,
                           exist_reqs=type(st.exist_reqs)(*(t ^ True if t.dtype == torch.bool else t + k
                                                            for t in st.exist_reqs)))

    committed = bump(base, 1)
    used = base.exist_used.clone()
    used[1, 3] += 0.5
    spec = base._replace(exist_used=used)
    merged, _s, _a = _merge_both(emulated, monkeypatch, committed, spec, base)
    for got, sp, cm in zip(p_solver.exist_leaves(merged), p_solver.exist_leaves(spec), p_solver.exist_leaves(committed)):
        assert torch.equal(got[1], sp[1]) and torch.equal(got[0], cm[0])
