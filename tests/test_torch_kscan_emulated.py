"""The kind scan's pod-loop kernel (H6), csrc/kscan_pod_loop.cu, run on
the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread,
barriers for __syncthreads, the named barrier and the warp collectives)
and routes ops/cuda.py's launch to that library. In CPU solves with
kind-scan kinds, every segment's pod loop runs through the emulated kernel
and through the plain loop (ops/solver.py kscan_pod_loop_plain) from the
same carry: the assignment and every carry leaf equal. The cases cover
weight order and a placement objective's template rank on tier 3
(cost_min's, which reverses the weight order over the four family pools;
a signed rank with ties). Seeded segments then reach the kernel's other
paths: a 16-value zone key with spread, affinity and anti-affinity groups,
a hostname affinity group that turns non-empty mid-segment, existing
nodes filled to their cap, a self-conflicting pod, claims opened
mid-segment until the window is full and the pods spill, and, in a build
whose staging capacities are lowered, live rows and hostname slots past
shared memory (read from the workspace). Every call also checks that
the kernel's shared-memory arrays are aligned to their elements, which
x86 tolerates and the GPU does not (one case has an odd row count, the
layout that once misaligned them). The emulation checks the
kernel's logic, not its timing or what the GPU compiler does with it:
chip_smoke.py holds the compiled kernel to the plain loop on the card.
Tolerance: exact.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import solver as p_solver
from karpenter_tpu_torch.ops import topology as p_topo
from cuda_emu_build import c_entry, emulated_library


# after the kernel lays out its shared-memory arrays: each must be aligned
# to its element (the GPU faults on a misaligned load, x86 does not), so
# the build flags a misaligned layout in `emu_misaligned`
ALIGN_CHECK = """
  if ((uintptr_t)st.srec % 16 || (uintptr_t)st.sok % 4 || (uintptr_t)st.sroom2 % 2)
    __atomic_store_n(&emu_misaligned, 1, __ATOMIC_RELAXED);
"""


def _rewrite(src: str, caps=None) -> str:
    """Dynamic shared memory and the named barrier for the emulator's, and
    the alignment check of the staged arrays; caps (rows, slots) lowers
    the staging capacities, so that the workspace path runs at small
    shapes."""
    src = src.replace("extern __shared__ __align__(16) char smem[];", "char* smem = emu_smem();")
    src = src.replace('asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");', "emu_named_sync(n);")
    src, n_layout = re.subn(r"(\n  st\.groom2 = [^\n]*;\n)", lambda m: m.group(1) + ALIGN_CHECK, src)
    assert n_layout == 1
    src = 'extern "C" int emu_misaligned;\nint emu_misaligned = 0;\n' + src
    if caps:
        src, n_rows = re.subn(r"constexpr int kRowCap = \d+;", f"constexpr int kRowCap = {caps[0]};", src)
        src, n_slots = re.subn(r"constexpr int kSlotCap = \d+;", f"constexpr int kSlotCap = {caps[1]};", src)
        assert n_rows == n_slots == 1
    return src


def _invoker(tmp_path_factory, caps=None):
    lib = emulated_library(tmp_path_factory, "kscan_pod_loop", rewrite=lambda s: _rewrite(s, caps))
    fn = c_entry(lib, "kscan_pod_loop")
    misaligned = ctypes.c_int.in_dll(lib, "emu_misaligned")

    def invoke(source, entry, *args):
        assert (source, entry) == ("kscan_pod_loop", "kscan_pod_loop")
        misaligned.value = 0
        rc = fn(*args, None)
        if rc:
            raise RuntimeError(f"emulated kscan_pod_loop: error {rc}")
        assert misaligned.value == 0, "a shared-memory array of the kernel is not aligned to its element"

    return invoke


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated pod-loop kernel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _invoker(tmp_path_factory)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emulated_small(tmp_path_factory):
    """The same with 24 live-row records and 16 hostname slots staged in
    shared memory: the rest in the workspace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _invoker(tmp_path_factory, caps=(24, 16))
    torch.set_num_threads(n)


SOLVES = {
    # name: (templates, max_claims, pods, scheduler keywords)
    "weight_order": lambda: (T.make_templates(24), 32, T.zonal_pods(24, kinds=2), {}),
    "cost_min_reverses_weight": lambda: (T.mixed_pool_templates(24), 32, T.zonal_pods(24, kinds=2),
                                         {"objective": "cost_min"}),
    "cost_min_mixed": lambda: (T.mixed_pool_templates(24), 64, T.mixed_pods(40), {"objective": "cost_min"}),
    "signed_rank_with_ties": lambda: (T.mixed_pool_templates(24), 32, T.zonal_pods(24, kinds=2),
                                      {"objective": "cost_min", "_rank": [1, -1, 1, -3]}),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_emulated_pod_loop_equals_plain_loop(case, emulated, monkeypatch):
    """Every kind-scan segment of a CPU solve through the emulated kernel
    and the plain loop from the same carry: assignment and carry equal."""
    templates, max_claims, pods, kw = SOLVES[case]()
    kw = dict(kw)
    rank = kw.pop("_rank", None)
    if rank is not None:
        monkeypatch.setattr(TorchScheduler, "_objective_rank",
                            lambda self, policy: torch.tensor(rank, dtype=torch.int32))
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_solver.kscan_pod_loop_plain
    seen = []

    def both(inp, c, topo, tm, count, maxc, n_claims):
        ck = p_solver.PodLoopCarry(*(x.clone() for x in c))
        ak = p_cuda.kscan_pod_loop(inp, ck, topo, count, maxc, n_claims, tm.rank)
        ap = plain(inp, c, topo, tm, count, maxc, n_claims)
        assert torch.equal(ak, ap), (case, len(seen), ak.tolist(), ap.tolist())
        bad = [f for f, a, b in zip(c._fields, ck, c) if not torch.equal(a, b)]
        assert not bad, (case, len(seen), bad)
        seen.append((count, tm.rank is not None))
        return ap

    monkeypatch.setattr(p_solver, "kscan_pod_loop_plain", both)
    s = TorchScheduler(templates, max_claims=max_claims, device="cpu", **kw)
    r = s.solve(pods)
    assert seen and s.last_stats["kscan_dispatches"] > 0 and r.node_count > 0
    assert all(has_rank == ("objective" in kw) for _n, has_rank in seen)
    if case == "cost_min_reverses_weight":
        assert {c.template.nodepool_name for c in r.claims} == {"e-pool"}


def _segment(seed, E=5, W=48, G=6, D=4, NGv=2, NGh=2, count=40, w_open0=30, n_open0=None, NCAP=None,
             vg_types=(0, 1), vg_gate=(True, False), hg_types=(0, 2), hg_gate=(True, False), self_conf=False,
             cap_e=(0, 3), capd=(0, 5), static_p=0.3, hg_p=0.1, hg_counts=True, rank=None, open_past=0.0,
             placed=(0, 1)):
    """A seeded kind-scan segment: (PodLoopIn, PodLoopCarry, topology,
    templates, count, maxc, n_claims). Open rows below w_open0, their
    slots mapped, the groups of each family recording and selecting the
    pod, those of vg_gate / hg_gate applying to it; open_past opens rows
    at or past w_open0 too, and placed seeds the carry's pl_n."""
    rng = np.random.default_rng(seed)
    NCAP = NCAP or W + 8
    n_open0 = n_open0 if n_open0 is not None else w_open0 + 2
    S = E + NCAP + 1
    V = D + 3

    def b(*shape, p=0.5):
        return torch.from_numpy(rng.random(shape) < p)

    def i(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    def t(x, dt=torch.int32):
        return torch.tensor(x, dtype=dt)

    def per(vals, n):
        return [vals[k % len(vals)] for k in range(n)]

    ar = np.arange(W)
    dom = b(NGv, V, p=0.8)
    dom[:, :2] = True
    topo = p_topo.TopologyTensors(
        vg_key=torch.zeros(NGv, dtype=torch.int32), vg_type=t(per(vg_types, NGv)), vg_skew=i(1, 4, NGv),
        vg_min_domains=i(0, 3, NGv), vg_domains=dom, vg_counts0=torch.zeros((NGv, V), dtype=torch.int32),
        vg_rank=i(0, 5, NGv, V), vg_valid=torch.ones(NGv, dtype=torch.bool),
        hg_type=t(per(hg_types, NGh)), hg_skew=i(1, 4, NGh), hg_counts0=torch.zeros((NGh, S), dtype=torch.int32),
        hg_extra_nonempty=torch.zeros(NGh, dtype=torch.bool), hg_valid=torch.ones(NGh, dtype=torch.bool),
    )
    ones_v, ones_h = torch.ones(NGv, dtype=torch.bool), torch.ones(NGh, dtype=torch.bool)
    inp = p_solver.PodLoopIn(
        cap_e=i(*cap_e, E), zie0=b(E, p=0.2),
        open0=(torch.from_numpy(ar < w_open0) & b(W, p=0.9)) | (torch.from_numpy(ar >= w_open0) & b(W, p=open_past)),
        static_n0=b(W, p=static_p), pods0=i(0, 6, W), zin0=b(W, p=0.2), static_g=b(G, p=0.8),
        capd_g=i(1, 6, G, D), z0_g=b(G, D, p=0.8), zinf_g=b(G, p=0.2), w_open0=t(w_open0),
        self_conf=t(self_conf, torch.bool), key_touched=t(bool(rng.random() < 0.7), torch.bool),
        gate=t(per(vg_gate, NGv), torch.bool), recs=ones_v.clone(), vg_self=ones_v.clone(), pd=b(D, p=0.85),
        hg_applies=t(per(hg_gate, NGh), torch.bool), hg_records=ones_h.clone(), hg_self=ones_h.clone(),
    )
    slot_of = torch.from_numpy(np.where(ar < w_open0, ar + n_open0 - w_open0, NCAP).astype(np.int32))
    hgc = (b(NGh, S, p=hg_p) & torch.from_numpy(np.arange(S) < E + n_open0)).to(torch.int32) if hg_counts else \
        torch.zeros((NGh, S), dtype=torch.int32)
    carry = p_solver.PodLoopCarry(
        zn=b(W, D, p=0.6), ze=b(E, D, p=0.6), capd=i(*capd, W, D), pl_n=i(*placed, W),
        pl_e=torch.zeros(E, dtype=torch.int32), tmpl_n=torch.zeros(W, dtype=torch.int32), cnt=i(0, 3, NGv, D),
        hgc=hgc, n_open=t(n_open0), w_open=t(w_open0), slot_of=slot_of, spills=t(0),
    )
    templates = types.SimpleNamespace(rank=None if rank is None else t(rank))
    return inp, carry, topo, templates, count, count, NCAP


SEGMENTS = {
    # name: (fixture, _segment keywords, the paths the case must show)
    "zone_key_16": ("emulated", dict(D=16, NGv=3, vg_types=(0, 2, 1), vg_gate=(True, False, False), count=48,
                                     static_p=0.05), {"opened"}),
    "hostname_affinity_turns_nonempty": (
        "emulated", dict(E=1, cap_e=(0, 1), NGh=1, hg_types=(1,), hg_gate=(True,), vg_gate=(False,), hg_counts=False,
                         capd=(3, 6), count=24), {"affinity"}),
    "existing_filled_to_cap": ("emulated", dict(E=12, cap_e=(1, 3), count=40), {"existing"}),
    "self_conflict": ("emulated", dict(self_conf=True, count=40), {"opened"}),
    "window_full_spills": ("emulated", dict(W=40, w_open0=34, n_open0=34, NCAP=60, G=3, static_p=0.0, count=30,
                                            cap_e=(0, 1), rank=[2, 0, 1]), {"opened", "spills"}),
    "open_rows_past_w_open_and_placed_counts": ("emulated", dict(open_past=0.5, placed=(0, 3), static_p=0.6, count=40),
                                                {"opened"}),
    # E + G + W odd: the slot words follow an odd count of 16-byte records
    "zone_key_4_odd_row_count": ("emulated", dict(E=7, W=50, G=6, count=40), {"odd"}),
    "workspace_rows_and_slots": ("emulated_small", dict(W=56, w_open0=40, E=6, G=5, NGh=3, hg_gate=(True, True, False),
                                                        static_p=0.5, count=48), {"opened", "workspace"}),
}


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_emulated_pod_loop_segments(case, request, monkeypatch):
    """Seeded segments through the emulated kernel and the plain loop from
    the same carry: assignment and every carry leaf equal."""
    fixture, kw, shows = SEGMENTS[case]
    monkeypatch.setattr(p_cuda, "_invoke", request.getfixturevalue(fixture))
    inp, c, topo, tm, count, maxc, n_claims = _segment(sorted(SEGMENTS).index(case), **kw)
    c0 = p_solver.PodLoopCarry(*(x.clone() for x in c))
    ck = p_solver.PodLoopCarry(*(x.clone() for x in c))
    ak = p_cuda.kscan_pod_loop(inp, ck, topo, count, maxc, n_claims, tm.rank)
    ap = p_solver.kscan_pod_loop_plain(inp, c, topo, tm, count, maxc, n_claims)
    assert torch.equal(ak, ap), (case, ak.tolist(), ap.tolist())
    bad = [f for f, a, b in zip(c._fields, ck, c) if not torch.equal(a, b)]
    assert not bad, (case, bad)
    # the paths each case is for
    placed = ap[ap >= 0]
    if "opened" in shows:
        assert int(c.w_open) > int(inp.w_open0), ("no claim opened mid-segment", ap.tolist())
    if "affinity" in shows:  # the first pod bootstraps the group, the rest follow it to its slot
        assert int(c0.hgc.sum()) == 0 and int(c.hgc.sum()) == placed.numel() > 1, ap.tolist()
        assert len(set(placed.tolist())) == 1, ap.tolist()
    if "existing" in shows:
        assert bool(((c.pl_e == inp.cap_e) & (inp.cap_e > 0)).any()), ("no existing node filled to its cap", ap.tolist())
    if "spills" in shows:
        assert int(c.w_open) == c.zn.shape[0] and int(c.spills) > 0 and bool((ap == p_solver.NO_ROOM).any())
    if "odd" in shows:
        assert (c.ze.shape[0] + inp.static_g.shape[0] + c.zn.shape[0]) % 2 == 1
    if "workspace" in shows:  # more live rows than the 24 records staged, more slots than the 16 words
        live = (int((c0.pl_e < inp.cap_e).sum()) + int(inp.static_g.sum())
                + int((inp.open0 & inp.static_n0).sum()) + int(c.w_open) - int(inp.w_open0))
        assert live > 24 and c.hgc.shape[1] > 16, live
