"""The dp speculation kernels' own sources, csrc/dp_dead.cu (H12),
csrc/dp_verdict.cu (H13) and csrc/merge_shard.cu (H14), run on the CPU.

The CUDA kernels cannot run here, so this file compiles each with the
host's C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads and the warp collectives, the blocks of a grid
one after another) and routes ops/cuda.py's launches to those libraries.
The launchers then run on CPU tensors and are held to the plain versions
(ops/solver.py dp_dead_plain, dp_verdict_plain, merge_shard_fill_plain /
merge_shard_kscan_plain):
- inside CPU solves with dp = 2 and 4 (fill, kind scan, per-pod, existing
  nodes, hostname groups, minValues under a budget), every round's
  deadness matrix, verdict word and every commit through the kernel and
  the plain version, equal, and the solve's result equal to the plain
  solve's;
- on a captured round widened to DP = 1, 5 and 33 (two lanes of the
  word; past 32 rows H12's row pointers leave its parameters for a
  table), with padding rows (r_min = +inf) among the rows, in both of
  H12's modes;
- H12's ceiling test at its edges (a total equal to the catalog's
  largest allocatable, a total of 0, a +inf request, a NaN usage), the
  kind-scan mode on the zone key and on another key, a catalog past the
  16384 cells H12 once refused (read in place, not staged), and launches
  in a row on one workspace.
H12's rewrite routes its cross-block ors, ticket and loads through
cuda_emu.h's memory model (a missing fence or a ticket taken early meets
stale bytes).
The emulation checks the kernels' logic, not their timing or what the
GPU compiler does with them: chip_smoke.py holds the compiled kernels to
the plain versions on the card. Tolerance: exact.
"""

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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry calls routed to the emulated dp kernels."""
    fns = {name: c_entry(emulated_library(tmp_path_factory, name, dead_rewrite if name == "dp_dead" else None),
                         name) for name in SOURCES}
    calls = {n: 0 for n in SOURCES}

    def invoke(source, entry, *args):
        assert source == entry and source in fns, (source, entry)
        rc = fns[source](*args, None)
        if rc:
            raise RuntimeError(f"emulated {source}: error {rc}")
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


def _captured_round(monkeypatch, pods, dp, chunk=None, which: int = 0):
    """The H12 / H13 inputs of a CPU dp solve's first round (or round
    `which`; plain versions throughout)."""
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
        s.solve(pods)
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
@pytest.mark.parametrize("DP", [1, 5, 33])
def test_emulated_round_widened(family, DP, emulated, monkeypatch):
    """A captured round's rows repeated to DP = 1, 5 and 33 (the word's
    second lane, and past the 32 rows whose pointers ride H12's
    parameters), every third row a padding row: H12 (its kscan mode on the
    kind-scan round) and H13 equal their plain versions."""
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
