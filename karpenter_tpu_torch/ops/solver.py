"""The solve paths (port of the JAX package's ops/solver.py): the
kind-level fill scan, the zonal kind scan, the per-pod scan, and the
window/bank bookkeeping around them.

One fill step places one pod KIND (a run of content-identical pods, in
FFD order) through the reference's 3-tier cascade (scheduler.go:582-612):

  tier 1  existing nodes in index order, each filled to capacity
  tier 2  in-flight claims of the active window, water-filled
          fewest-pods-first with earliest-slot tie-break
  tier 3  ceil(rem / cap) new claims of the first feasible template

`solve_fill` runs the steps as a Python loop over the B segments; every
tensor stays on the device, so a solve never syncs with the host. The
claims axis is an active WINDOW of W rows (`slot_of` maps rows to global
claim ids); `compact_state` evicts capacity-dead claims into the frozen
bank between dispatches and stable-compacts the survivors. The kind scan
(`solve_kind_scan`) and the per-pod scan (`solve_from`) thread the same
carry, one pod at a time through the same three tiers.

Hand-written CUDA kernels carry the hot work (csrc/, launched through
ops/cuda.py):

  H1 req_intersects   kernels.intersects         tier 2 / tier 3 it_compat
  H2 fill_count_grid  claim_fill_caps,           tier 2 caps, fits_final,
                      fits_off_counted           tier 3, compact liveness
  H3 water_fill       water_fill                 tier 2 distribution
  H4 compact_scatter  compact_scatter            compaction, bank, decode
  H5 kscan_grid       kscan_grid,                the kind scan's grid,
                      kscan_fits_final           capd and final types
  H6 kscan_pod_loop   kscan_pod_loop             the kind scan's pod loop
  H7/H8 perpod_scan_persistent                   the per-pod scan: a chunk
                      perpod_steps, solve_from,  of steps, or every step of
                      solve_whatif               S what-if scenarios, in
                                                 one launch
  H11 objective_verdict objective_verdict        the K-variant fill
                      (solve_fill_variants)      dispatch's scores and
                                                 verdict word
  H12 dp_dead         dp_dead                    a dp round's deadness
                                                 matrix (fill / kscan)
  H13 dp_verdict      dp_verdict                 a dp round's packed word
  H14 merge_shard     merge_shard_fill,          one dp commit's graft
                      merge_shard_kscan

Each wrapper runs the kernel on CUDA tensors and its plain version (same
module, `*_plain`) on CPU tensors. `plain=True` on the solve entry points,
compact_state and global_claims selects the plain versions explicitly,
whatever the device (a comparison run, never a fallback).

Numerics are the reference's exactly: int32 everywhere, IEEE division,
first-index ties, stable compaction, COUNT_CAP = 2^22, and every f32
charge `used + c*req` rounded ONCE — the JAX package's compiled step
fuses that multiply-add (XLA:CPU contracts it: 2.1000001 + 6 x 0.1 gives
2.7, where two roundings give 2.7000003), so the kernels use __fmaf_rn
and the plain versions `_madd`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from karpenter_tpu_torch.ops import cuda, kernels
from karpenter_tpu_torch.ops.encode import INT_MAX, INT_MIN, InstanceTypeTensors, ReqSetTensors, as_tensor, to_device
from karpenter_tpu_torch.ops.kernels import (
    broadcast_set,
    compatible_elemwise,
    intersect_sets,
    packed_any,
    packed_conflict,
    packed_count_and,
    select_set,
    take_set,
)
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.ops.topology import (
    BIG_I32,
    RANK_BASE,
    TYPE_AFFINITY,
    TYPE_ANTI,
    TYPE_SPREAD,
    TopologyTensors,
    _onehot_rows,
    hg_commit,
    hg_evaluate,
)

# assignment sentinels
NO_CLAIM = -1  # no compatible existing node, in-flight claim, or template
NO_ROOM = -2  # a template was feasible but the claim-slot capacity is full
BIG = 2**31 - 1
COUNT_CAP = 2**22  # "unbounded" per-candidate fill cap

I32 = torch.int32
F32 = torch.float32


class Templates(NamedTuple):
    """NodeClaim templates in weight-priority order (index 0 = first try)."""

    reqs: ReqSetTensors  # [G, K, V]
    its: torch.Tensor  # [G, T] bool — statically compatible instance types
    daemon_requests: torch.Tensor  # [G, R] f32
    valid: torch.Tensor  # [G] bool
    budget: torch.Tensor  # [G, R] f32 — remaining pool limits (+inf unlimited)
    nodes_budget: torch.Tensor  # [G] f32
    mv_key: torch.Tensor  # [G, M] i32
    mv_min: torch.Tensor  # [G, M] i32
    mv_it_values: torch.Tensor  # [T, J, V] bool
    rank: Optional[torch.Tensor] = None  # [G] i32 — None = weight order


class ExistingNodes(NamedTuple):
    """Existing/in-flight real nodes (tier 1). Port and volume bitsets ride
    as packed int32 lanes (kernels.pack_bool_np layout)."""

    reqs: ReqSetTensors  # [E, K, V]
    avail: torch.Tensor  # [E, R] f32
    valid: torch.Tensor  # [E] bool
    ports: torch.Tensor  # [E, NPp] i32
    vols: torch.Tensor  # [E, NVp] i32
    vol_limits: torch.Tensor  # [E, ND] f32
    vol_driver: torch.Tensor  # [ND, NVp] i32


class SolverState(NamedTuple):
    """The scan carry: a window of W claim rows over the global claim axis
    [0, NCAP), the frozen bank of evicted claims, and the counters."""

    exist_reqs: ReqSetTensors  # [E, K, V]
    exist_used: torch.Tensor  # [E, R]
    reqs: ReqSetTensors  # [W, K, V]
    used: torch.Tensor  # [W, R]
    its: torch.Tensor  # [W, T] bool
    template: torch.Tensor  # [W] i32
    open: torch.Tensor  # [W] bool
    pods: torch.Tensor  # [W] i32
    n_open: torch.Tensor  # [] i32 — global claims opened (next global id)
    slot_of: torch.Tensor  # [W] i32 — global claim id per row (NCAP = unused)
    w_open: torch.Tensor  # [] i32 — open claims resident in the window
    w_hw: torch.Tensor  # [] i32 — high-water of w_open
    spills: torch.Tensor  # [] i32 — opens refused because the window was full
    bank_frozen: torch.Tensor  # [NCAP] bool
    bank_template: torch.Tensor  # [NCAP] i32
    bank_its: torch.Tensor  # [NCAP, T] bool
    bank_used: torch.Tensor  # [NCAP, R] f32
    bank_held: torch.Tensor  # [NCAP, RID] bool
    bank_tk_mask: torch.Tensor  # [NCAP, TK, V] bool
    bank_tk_inf: torch.Tensor  # [NCAP, TK] bool
    bank_tk_def: torch.Tensor  # [NCAP, TK] bool
    budget: torch.Tensor  # [G, R]
    nodes_budget: torch.Tensor  # [G]
    vg_counts: torch.Tensor  # [NGv, V]
    hg_counts: torch.Tensor  # [NGh, E + NCAP + 1]
    exist_ports: torch.Tensor  # [E, NPp] i32
    claim_ports: torch.Tensor  # [W, NPp] i32
    exist_vols: torch.Tensor  # [E, NVp] i32
    res_cap: torch.Tensor  # [RID] i32
    held: torch.Tensor  # [W, RID] bool


class FillYs(NamedTuple):
    """Per-segment fill record (the decode expands these to per-pod
    assignments host-side)."""

    fill_e: torch.Tensor  # [E] i32 — pods landed per existing node
    fill_c: torch.Tensor  # [W] i32 — pods landed per WINDOW row
    open_start: torch.Tensor  # [] i32 — w_open before this segment
    n_opened: torch.Tensor  # [] i32 — new claims opened (contiguous rows)
    tmpl: torch.Tensor  # [] i32 — template of opened claims (-1 = none)
    leftover: torch.Tensor  # [] i32 — pods that failed to place
    status: torch.Tensor  # [] i32 — NO_CLAIM / NO_ROOM for the leftover


class FillXs(NamedTuple):
    """Per-segment (pod kind) inputs to the fill scan."""

    reqs: ReqSetTensors  # [B, K, V]
    requests: torch.Tensor  # [B, R]
    tmpl_ok: torch.Tensor  # [B, G]
    it_allow: torch.Tensor  # [B, T]
    exist_ok: torch.Tensor  # [B, E]
    ports: torch.Tensor  # [B, NP]
    port_conf: torch.Tensor  # [B, NP]
    vols: torch.Tensor  # [B, NV]
    count: torch.Tensor  # [B] i32 — pods of this kind (0 = padding row)
    hg_applies: torch.Tensor  # [B, NGh]
    hg_records: torch.Tensor  # [B, NGh]
    hg_self: torch.Tensor  # [B, NGh]


# ---------------------------------------------------------------------------
# numpy <-> torch converters (the JAX package's containers, fetched as
# numpy, carried onto a device; and back)
# ---------------------------------------------------------------------------


def _np_leaf(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed bitsets: same bits in int32 lanes
        a = a.view(np.int32)
    return a


def from_numpy(cls, src, device):
    """Build container `cls` on `device` from an object with the same
    field names holding numpy arrays (e.g. a JAX container after
    jax.tree.map(np.asarray, ...)). Nested requirement sets convert to
    ReqSetTensors; None fields stay None."""
    vals = []
    for f in cls._fields:
        v = getattr(src, f, None)
        if v is None:
            vals.append(None)
        elif hasattr(v, "_fields"):
            vals.append(ReqSetTensors(*(as_tensor(_np_leaf(getattr(v, g)), device) for g in ReqSetTensors._fields)))
        else:
            vals.append(as_tensor(_np_leaf(v), device))
    return cls(*vals)


def to_numpy(container) -> dict:
    """A container as a flat {field: numpy} dict (requirement sets become
    {field}.{component} entries), for leaf-for-leaf comparisons."""
    out = {}
    for f in container._fields:
        v = getattr(container, f)
        if v is None:
            continue
        if isinstance(v, ReqSetTensors):
            for g in ReqSetTensors._fields:
                out[f"{f}.{g}"] = getattr(v, g).cpu().numpy()
        else:
            out[f] = v.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _i32(x, device) -> torch.Tensor:
    # a fill, not a host->device copy
    return torch.full((), x, dtype=I32, device=device)


def _madd(u: torch.Tensor, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """f32 u + c*r rounded once, like a fused multiply-add: evaluated in
    f64, where the product of a count below 2^23 and an f32 is exact and
    the sum is exact for addends within 2^29 of each other (resource
    columns hold one unit each), then rounded to f32."""
    return (u.double() + c.double() * r.double()).float()


def _pick_template(tmpl_feas: torch.Tensor, templates: Templates) -> torch.Tensor:
    """Tier-3 template choice: first feasible in rank order ([] int64).
    With no rank column this is argmax of the mask — the lowest-index
    (highest-weight) feasible template, index 0 when none is feasible."""
    if templates.rank is None:
        return torch.argmax(tmpl_feas.to(I32))
    big = torch.full_like(templates.rank, BIG)
    return torch.argmin(torch.where(tmpl_feas, templates.rank, big))


def identity_reqs(n: int, k: int, v: int, device) -> ReqSetTensors:
    """The intersection-identity encoding (all keys undefined)."""
    return ReqSetTensors(
        mask=torch.ones((n, k, v), dtype=torch.bool, device=device),
        inf=torch.ones((n, k), dtype=torch.bool, device=device),
        excl=torch.zeros((n, k), dtype=torch.bool, device=device),
        gte=torch.full((n, k), INT_MIN, dtype=I32, device=device),
        lte=torch.full((n, k), INT_MAX, dtype=I32, device=device),
        defined=torch.zeros((n, k), dtype=torch.bool, device=device),
    )


def initial_state(
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    topo: TopologyTensors,
    n_claims: int,
    n_ports: int,
    res_cap0=None,
    window: int = 0,
    topo_kids: tuple = (),
) -> SolverState:
    """The empty carry. `window` bounds the hot claims axis (0 = the full
    global space n_claims); `n_ports` is the PACKED port lane count."""
    dev = it.alloc.device
    NB = n_claims
    W = min(window, NB) if window else NB
    K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
    T, R = it.alloc.shape[0], it.alloc.shape[2]
    E = exist.avail.shape[0]
    RID = it.res_ofs.shape[1]
    TK = max(len(topo_kids), 1)
    b = dict(dtype=torch.bool, device=dev)
    return SolverState(
        exist_reqs=exist.reqs,
        exist_used=torch.zeros((E, R), dtype=F32, device=dev),
        reqs=identity_reqs(W, K, V, dev),
        used=torch.zeros((W, R), dtype=F32, device=dev),
        its=torch.zeros((W, T), **b),
        template=torch.zeros(W, dtype=I32, device=dev),
        open=torch.zeros(W, **b),
        pods=torch.zeros(W, dtype=I32, device=dev),
        n_open=_i32(0, dev),
        slot_of=torch.full((W,), NB, dtype=I32, device=dev),
        w_open=_i32(0, dev),
        w_hw=_i32(0, dev),
        spills=_i32(0, dev),
        bank_frozen=torch.zeros(NB, **b),
        bank_template=torch.zeros(NB, dtype=I32, device=dev),
        bank_its=torch.zeros((NB, T), **b),
        bank_used=torch.zeros((NB, R), dtype=F32, device=dev),
        bank_held=torch.zeros((NB, RID), **b),
        bank_tk_mask=torch.zeros((NB, TK, V), **b),
        bank_tk_inf=torch.zeros((NB, TK), **b),
        bank_tk_def=torch.zeros((NB, TK), **b),
        budget=templates.budget,
        nodes_budget=templates.nodes_budget,
        vg_counts=topo.vg_counts0,
        hg_counts=topo.hg_counts0,
        exist_ports=exist.ports,
        claim_ports=torch.zeros((W, n_ports), dtype=I32, device=dev),
        exist_vols=exist.vols,
        res_cap=(
            torch.as_tensor(res_cap0, dtype=I32, device=dev)
            if res_cap0 is not None
            else torch.zeros(RID, dtype=I32, device=dev)
        ),
        held=torch.zeros((W, RID), **b),
    )


# ---------------------------------------------------------------------------
# H2 fill_count_grid: plain versions and wrappers
# ---------------------------------------------------------------------------


def off_for_plain(rows_mask, it: InstanceTypeTensors, zone_kid: int, ct_kid: int) -> torch.Tensor:
    """[B, T, GR] bool — an available offering exists in a (zone, ct) the
    rows' requirement masks admit (the reference's `_off_for`, as an
    exact boolean any instead of a bf16 einsum > 0)."""
    T, GR, Z, C = it.zc_avail.shape
    zm = rows_mask[:, zone_kid, :Z]
    cm = rows_mask[:, ct_kid, :C]
    # admitted (zone, ct) pairs against available ones: a 0/1 matrix
    # product whose counts (<= Z*C) are exact in f32
    pairs = (zm[:, :, None] & cm[:, None, :]).reshape(-1, Z * C).to(F32)
    avail = it.zc_avail.reshape(T * GR, Z * C).to(F32)
    return (pairs @ avail.T > 0).reshape(-1, T, GR)


def _fits_cells(used, c, req, it, okc) -> torch.Tensor:
    """okc & AND_r((used + c*req <= alloc) | (used + c*req == 0)) over
    [B, T, GR]; used [B, R], c [B, T, GR] counts (or broadcastable), each
    charge rounded once as in _madd."""
    acc = okc
    ud, cd, rd = used.double(), c.double(), req.double()
    for r in range(req.shape[0]):
        t = (ud[:, None, None, r] + cd * rd[r]).float()
        acc = acc & ((t <= it.alloc[None, :, :, r]) | (t == 0.0))
    return acc


def claim_fill_caps_plain(used, viable, req, it, off) -> torch.Tensor:
    """[B] i32 — max pods addable per row: the best (type, group) among
    the row's viable types (the reference's `_claim_fill_caps`)."""
    pos = req > 0.0
    safe = torch.where(pos, req, torch.ones_like(req))
    okc = off & it.group_valid[None] & viable[:, :, None]
    cap = float(COUNT_CAP)
    est = torch.full(okc.shape, cap, dtype=F32, device=used.device)
    for r in range(req.shape[0]):
        head = it.alloc[None, :, :, r] - used[:, None, None, r]
        ratio = torch.where(pos[r], head / safe[r], torch.full_like(head, float("inf")))
        est = torch.minimum(est, ratio)
    est = torch.where(torch.isfinite(est), est, torch.full_like(est, cap))
    c0 = torch.clamp(torch.floor(est), 0.0, cap).to(I32)

    def ok(c):
        return _fits_cells(used, c, req, it, okc)

    up = ok(c0 + 1)
    mid = ok(c0)
    cdn = torch.clamp(c0 - 1, min=0)
    dn = ok(cdn)
    zero = torch.zeros_like(c0)
    c = torch.where(mid, torch.where(up, c0 + 1, c0), torch.where(dn, cdn, zero))
    c = torch.where(okc, c, zero)
    if c[0].numel() == 0:
        return torch.zeros(c.shape[0], dtype=I32, device=c.device)
    return c.flatten(1).max(dim=1).values


def fits_off_counted_plain(used, counts, req, it, off) -> torch.Tensor:
    """[B, T] bool — any over groups of used + counts*req fitting an
    allocatable group with an offering (the reference's
    `_fits_off_counted` reduced over GR). used [B or 1, R]; off
    [B or 1, T, GR] or None for no offering gate."""
    okc = it.group_valid[None]
    if off is not None:
        okc = okc & off
    B = counts.shape[0]
    okc = okc.expand((B,) + tuple(it.group_valid.shape))
    used = used.expand(B, used.shape[1])
    return _fits_cells(used, counts[:, None, None], req, it, okc).any(dim=-1)


def _off_or_none(rows_mask, it, zone_kid, ct_kid):
    return None if rows_mask is None else off_for_plain(rows_mask, it, zone_kid, ct_kid)


def _claim_fill_caps_from_mask_plain(used, viable, req, it, rows_mask, zone_kid, ct_kid):
    return claim_fill_caps_plain(used, viable, req, it, off_for_plain(rows_mask, it, zone_kid, ct_kid))


def _fits_off_counted_from_mask_plain(used, counts, req, it, rows_mask, zone_kid, ct_kid):
    return fits_off_counted_plain(used, counts, req, it, _off_or_none(rows_mask, it, zone_kid, ct_kid))


def claim_fill_caps(used, viable, req, it, rows_mask, zone_kid, ct_kid) -> torch.Tensor:
    """H2 max-count mode: [B] i32 (kernel on CUDA, plain on CPU); the
    offering test reads the zone / capacity-type rows of rows_mask."""
    if used.device.type == "cpu":
        return _claim_fill_caps_from_mask_plain(used, viable, req, it, rows_mask, zone_kid, ct_kid)
    return cuda.fill_count_grid(
        0, used, req, it, rows_mask, zone_kid, ct_kid, viable.shape[0], viable=viable
    )


def fits_off_counted(used, counts, req, it, rows_mask, zone_kid, ct_kid) -> torch.Tensor:
    """H2 fits-at-count mode: [B, T] bool (kernel on CUDA, plain on CPU);
    rows_mask None drops the offering gate."""
    if used.device.type == "cpu":
        return _fits_off_counted_from_mask_plain(used, counts, req, it, rows_mask, zone_kid, ct_kid)
    return cuda.fill_count_grid(
        1, used, req, it, rows_mask, zone_kid, ct_kid, counts.shape[0], counts=counts
    )


# ---------------------------------------------------------------------------
# H3 water_fill
# ---------------------------------------------------------------------------


def water_fill_plain(p: torch.Tensor, f: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """[N] i32 — distribute rem pods fewest-pods-first with earliest-slot
    tie-break: raise a water level L over the counts; claims fill to
    min(f, L-1-p); the remainder at level L goes to eligible claims in
    slot order (the reference's `_water_fill`)."""
    f = torch.minimum(f, rem)
    total = f.sum(dtype=I32)
    zero = torch.zeros_like(p)

    def placed(L):
        return torch.minimum(f, torch.maximum(zero, L - p)).sum(dtype=I32)

    lo = torch.zeros((), dtype=I32, device=p.device)
    hi = p.max() + rem + 1
    for _ in range(24):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        geq = placed(mid) >= rem
        lo, hi = torch.where(geq, lo, mid + 1), torch.where(geq, mid, hi)
    L = lo
    base = torch.minimum(f, torch.maximum(zero, (L - 1) - p))
    r0 = rem - base.sum(dtype=I32)
    elig = (f > 0) & (p + base == L - 1) & (base < f)
    e32 = elig.to(I32)
    rank = torch.cumsum(e32, 0, dtype=I32) - e32
    extra = (elig & (rank < r0)).to(I32)
    return torch.where(total <= rem, f, base + extra)


def water_fill(p: torch.Tensor, f: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """H3: kernel on CUDA, plain on CPU."""
    if p.device.type == "cpu":
        return water_fill_plain(p, f, rem)
    return cuda.water_fill(p, f, rem)


# ---------------------------------------------------------------------------
# H4 compact_scatter
# ---------------------------------------------------------------------------


def compact_scatter_plain(
    mode: int, sel: torch.Tensor, srcs: list, dsts: list,
    tk: tuple = (), tk_srcs: list = (), tk_dsts: list = (),
) -> None:
    """Move rows of each src into its dst in place: mode 0 to the
    stable-compacted position of the alive rows (sel bool), mode 1 to
    sel[i] with out-of-range ids dropped (the reference's mode="drop").
    Each tk_src ([n, K, ...]) moves only its key rows `tk`, gathered into
    its tk_dst ([n_dst, len(tk), ...]) — the topology-key bank rows."""
    srcs = list(srcs) + [s[:, list(tk)] for s in tk_srcs]
    dsts = list(dsts) + list(tk_dsts)
    n_dst = dsts[0].shape[0]
    if mode == 0:
        a32 = sel.to(I32)
        pos = torch.cumsum(a32, 0, dtype=I32) - a32
        keep = sel
    else:
        pos = sel
        keep = (sel >= 0) & (sel < n_dst)
    # dropped rows land in a spare row past the end, sliced off after
    target = torch.where(keep, pos, torch.full_like(pos, n_dst)).long()
    for s, d in zip(srcs, dsts):
        buf = torch.cat([d, d[:1]]) if d.shape[0] else d.new_empty((1,) + tuple(d.shape[1:]))
        buf.index_copy_(0, target, s)
        d.copy_(buf[:n_dst])


def compact_scatter(
    mode: int, sel: torch.Tensor, srcs: list, dsts: list,
    tk: tuple = (), tk_srcs: list = (), tk_dsts: list = (),
) -> None:
    """H4: kernel on CUDA, plain on CPU."""
    if sel.device.type == "cpu":
        compact_scatter_plain(mode, sel, srcs, dsts, tk, tk_srcs, tk_dsts)
    else:
        cuda.compact_scatter(mode, sel, srcs, dsts, tk, tk_srcs, tk_dsts)


class _Ops(NamedTuple):
    intersects: object
    claim_fill_caps: object
    fits_off_counted: object
    water_fill: object
    compact_scatter: object


KERNEL_OPS = _Ops(kernels.intersects, claim_fill_caps, fits_off_counted, water_fill, compact_scatter)
PLAIN_OPS = _Ops(
    kernels.intersects_plain,
    _claim_fill_caps_from_mask_plain,
    _fits_off_counted_from_mask_plain,
    water_fill_plain,
    compact_scatter_plain,
)


def _ops(plain: bool) -> _Ops:
    return PLAIN_OPS if plain else KERNEL_OPS


# ---------------------------------------------------------------------------
# window / bank bookkeeping
# ---------------------------------------------------------------------------


def _tk_fields(reqs: ReqSetTensors) -> list:
    """The requirement components whose topology-key rows the bank keeps."""
    return [reqs.mask, reqs.inf, reqs.defined]


def compact_state(
    state: SolverState,
    it: InstanceTypeTensors,
    r_min: torch.Tensor,  # [R] f32 — elementwise min request over remaining pods
    n_claims: int,
    plain: bool = False,
    topo_kids: tuple = (),
) -> tuple[SolverState, torch.Tensor]:
    """Evict capacity-dead claims from the window into the frozen bank,
    then stable-compact survivors to the front. A claim is dead when no
    viable (type, group) cell fits used + r_min (every remaining pod
    requests at least r_min, so it can never pass tier 2 again). The bank
    keeps each evicted claim's decode columns and, for every topology key
    in `topo_kids`, its requirement rows (mask / inf / defined), so the
    decode can read a banked claim's narrowed zone. Returns (state',
    n_closed). Functional: the input state is not modified."""
    ops = _ops(plain)
    NB = n_claims
    W = state.open.shape[0]
    dev = state.used.device
    ones = torch.ones(W, dtype=I32, device=dev)
    fits = ops.fits_off_counted(state.used, ones, r_min, it, None, 0, 0)  # [W, T]
    alive_cap = (fits & state.its).any(dim=1)
    close = state.open & ~alive_cap
    # bank rows of the closed claims, at their global ids
    bank = dict(
        bank_frozen=state.bank_frozen.clone(),
        bank_template=state.bank_template.clone(),
        bank_its=state.bank_its.clone(),
        bank_used=state.bank_used.clone(),
        bank_held=state.bank_held.clone(),
    )
    tk_bank = {}
    if topo_kids:
        tk_bank = dict(
            bank_tk_mask=state.bank_tk_mask.clone(),
            bank_tk_inf=state.bank_tk_inf.clone(),
            bank_tk_def=state.bank_tk_def.clone(),
        )
    idx = torch.where(close, state.slot_of, torch.full_like(state.slot_of, NB))
    ops.compact_scatter(
        1,
        idx,
        [torch.ones(W, dtype=torch.bool, device=dev), state.template, state.its, state.used, state.held],
        list(bank.values()),
        tuple(topo_kids),
        _tk_fields(state.reqs) if topo_kids else [],
        list(tk_bank.values()),
    )
    # survivors to the front, identity / zero fill behind them
    alive = state.open & ~close
    K, V = state.reqs.mask.shape[1], state.reqs.mask.shape[2]
    reqs2 = identity_reqs(W, K, V, dev)
    used2 = torch.zeros_like(state.used)
    its2 = torch.zeros_like(state.its)
    template2 = torch.zeros_like(state.template)
    open2 = torch.zeros_like(state.open)
    pods2 = torch.zeros_like(state.pods)
    slot2 = torch.full_like(state.slot_of, NB)
    ports2 = torch.zeros_like(state.claim_ports)
    held2 = torch.zeros_like(state.held)
    ops.compact_scatter(
        0,
        alive,
        list(state.reqs) + [state.used, state.its, state.template, state.open, state.pods,
                            state.slot_of, state.claim_ports, state.held],
        list(reqs2) + [used2, its2, template2, open2, pods2, slot2, ports2, held2],
    )
    return (
        state._replace(
            reqs=reqs2,
            used=used2,
            its=its2,
            template=template2,
            open=open2,
            pods=pods2,
            slot_of=slot2,
            w_open=alive.sum(dtype=I32),
            claim_ports=ports2,
            held=held2,
            **bank,
            **tk_bank,
        ),
        close.sum(dtype=I32),
    )


# ---------------------------------------------------------------------------
# H10 retract_tail: the resident session's suffix undo
# ---------------------------------------------------------------------------

# the window columns retract_tail compacts and the bank columns it clears
RETRACT_WINDOW = ("reqs", "used", "its", "template", "open", "pods", "slot_of", "claim_ports", "held")
RETRACT_BANK = (
    "bank_frozen", "bank_template", "bank_its", "bank_used", "bank_held", "bank_tk_mask", "bank_tk_inf",
    "bank_tk_def",
)


def retract_fill(state: SolverState) -> dict:
    """The value each window column holds in a row no claim occupies:
    identity requirements, zeros, and the NCAP sentinel in slot_of."""
    NB = state.bank_frozen.shape[0]
    fill = dict(used=0.0, its=False, template=0, open=False, pods=0, slot_of=NB, claim_ports=0, held=False)
    fill["reqs"] = ReqSetTensors(mask=True, inf=True, excl=False, gte=INT_MIN, lte=INT_MAX, defined=False)
    return fill


def retract_tail_plain(state: SolverState, cut: int) -> SolverState:
    """The plain version of H10 (the reference's retract_tail): undo every
    claim with global id >= cut. Window rows that stay open with a global
    id below the cut keep their order at the front (stable compaction),
    the rows behind them take the unused-row values, bank rows at or past
    the cut are cleared, n_open becomes cut and w_open the rows kept;
    w_hw and spills stay as they are. Functional: the input state is not
    modified, and the result shares no window or bank tensor with it."""
    NB = state.bank_frozen.shape[0]
    dev = state.used.device
    alive = state.open & (state.slot_of < cut)
    fill = retract_fill(state)
    srcs, dsts, out = [], [], {}
    for f in RETRACT_WINDOW:
        v = getattr(state, f)
        if f == "reqs":
            dst = ReqSetTensors(*(torch.full_like(c, x) for c, x in zip(v, fill[f])))
            srcs += list(v)
            dsts += list(dst)
        else:
            dst = torch.full_like(v, fill[f])
            srcs.append(v)
            dsts.append(dst)
        out[f] = dst
    compact_scatter_plain(0, alive, srcs, dsts)
    bkeep = torch.arange(NB, dtype=I32, device=dev) < cut
    for f in RETRACT_BANK:
        v = getattr(state, f)
        keep = bkeep.reshape((NB,) + (1,) * (v.dim() - 1))
        out[f] = torch.where(keep, v, torch.zeros_like(v))
    return state._replace(n_open=_i32(cut, dev), w_open=alive.sum(dtype=I32), **out)


def retract_tail(state: SolverState, cut: int, plain: bool = False) -> SolverState:
    """H10: the kernel on CUDA, the plain version on the CPU (or with
    plain=True). `cut` is a host int: the call reads nothing back."""
    if plain or state.used.device.type == "cpu":
        return retract_tail_plain(state, cut)
    return cuda.retract_tail(state, cut)


def global_template(state: SolverState) -> torch.Tensor:
    """[NCAP] i32 — the global template column alone (the JAX package's
    global_template, solver.py:952): the pipelined decode's snapshot after
    a dispatch. A claim's template is fixed when it opens, so window rows
    over the bank give every opened slot's template. A fresh tensor, never
    a view of the state: later dispatches rewrite the window."""
    NB = state.bank_template.shape[0]
    out = torch.empty(NB + 1, dtype=I32, device=state.template.device)
    out[:NB].copy_(state.bank_template)
    # unused rows carry the NCAP sentinel and land on the spare element
    out.scatter_(0, state.slot_of.long(), state.template)
    return out[:NB]


def global_claims(state: SolverState, plain: bool = False, topo_kids: tuple = ()) -> dict:
    """Merge the hot window over the frozen bank into global-slot-indexed
    decode columns (template/its/used/held, plus tk_mask/tk_inf/tk_def —
    the topology-key requirement rows — when topo_kids is given). Window
    rows override bank rows at their global id; unused rows carry the
    NCAP sentinel and drop."""
    out = dict(
        template=state.bank_template.clone(),
        its=state.bank_its.clone(),
        used=state.bank_used.clone(),
        held=state.bank_held.clone(),
    )
    tk_out = {}
    if topo_kids:
        tk_out = dict(
            tk_mask=state.bank_tk_mask.clone(),
            tk_inf=state.bank_tk_inf.clone(),
            tk_def=state.bank_tk_def.clone(),
        )
    _ops(plain).compact_scatter(
        1, state.slot_of, [state.template, state.its, state.used, state.held], list(out.values()),
        tuple(topo_kids), _tk_fields(state.reqs) if topo_kids else [], list(tk_out.values()),
    )
    out.update(tk_out)
    return out


# ---------------------------------------------------------------------------
# the fill step
# ---------------------------------------------------------------------------


def _count_cap_seq(used: torch.Tensor, req: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """[...] i32 — max c >= 0 with used + c*req <= limit elementwise over
    the trailing resource axis (total-based pass rule, +/-1-verified float
    estimate, zero on failure)."""
    pos = req > 0.0
    safe = torch.where(pos, req, torch.ones_like(req))
    head = limit - used
    est = torch.where(pos, head / safe, torch.full_like(head, float("inf"))).min(dim=-1).values
    cap = float(COUNT_CAP)
    est = torch.floor(torch.where(torch.isfinite(est), est, torch.full_like(est, cap)))
    c0 = torch.clamp(est, 0.0, cap).to(I32)

    def ok(c):
        t = _madd(used, c[..., None], req)
        return ((t <= limit) | (t == 0.0)).all(dim=-1)

    up = ok(c0 + 1)
    mid = ok(c0)
    cdn = torch.clamp(c0 - 1, min=0)
    dn = ok(cdn)
    zero = torch.zeros_like(c0)
    return torch.where(mid, torch.where(up, c0 + 1, c0), torch.where(dn, cdn, zero))


def _hg_slot_caps(topo: TopologyTensors, counts, slots, applies, records, self_sel) -> torch.Tensor:
    """[C] i32 — how many MORE pods of this kind each slot admits under the
    hostname groups (hg_evaluate's per-pod checks solved for the count)."""
    cnt = counts[:, slots.long()].T  # [C, NGh]
    rec = records[None, :]
    self_ = self_sel[None, :].to(I32)
    skew = topo.hg_skew[None, :]
    inf = torch.full_like(cnt, COUNT_CAP)
    zero = torch.zeros_like(cnt)
    one = torch.ones_like(cnt)
    spread = torch.where(rec, skew - self_ - cnt + 1, torch.where(cnt + self_ <= skew, inf, zero))
    anti = torch.where(cnt == 0, torch.where(rec, one, inf), zero)
    aff = torch.where(cnt > 0, inf, zero)
    t = topo.hg_type[None, :]
    cap = torch.where(t == TYPE_SPREAD, spread, torch.where(t == TYPE_AFFINITY, aff, anti))
    gate = (applies & topo.hg_valid)[None, :]
    cap = torch.where(gate, cap, inf)
    return torch.clamp(cap.min(dim=-1).values, 0, COUNT_CAP)


def _fill_step(
    state: SolverState,
    x: FillXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    ops: _Ops,
) -> tuple[SolverState, FillYs]:
    dev = state.used.device
    NCAP = n_claims
    E = exist.avail.shape[0]
    G = templates.its.shape[0]
    W = state.open.shape[0]
    count = x.count
    requests = x.requests
    self_conf = packed_conflict(x.ports, x.port_conf)
    no_wk = torch.zeros_like(well_known)

    # ---- tier 1: fill existing nodes in index order -------------------
    pod_e = broadcast_set(x.reqs, E)
    comb_e = intersect_sets(state.exist_reqs, pod_e)
    compat_e = compatible_elemwise(state.exist_reqs, pod_e, no_wk)
    ports_ok_e = ~packed_conflict(x.port_conf[None, :], state.exist_ports)
    cap_res_e = _count_cap_seq(state.exist_used, requests[None, :], exist.avail)
    cap_topo_e = _hg_slot_caps(
        topo, state.hg_counts, torch.arange(E, dtype=I32, device=dev),
        x.hg_applies, x.hg_records, x.hg_self,
    )
    cap_e = torch.minimum(cap_res_e, cap_topo_e)
    cap_e = torch.where(self_conf, torch.clamp(cap_e, max=1), cap_e)
    newv_e = state.exist_vols | x.vols[None, :]
    vcount_e = packed_count_and(newv_e[:, None, :], exist.vol_driver[None, :, :]).to(F32)
    vols_ok_e = (vcount_e <= exist.vol_limits).all(dim=-1) | ~packed_any(x.vols)
    feas_e = exist.valid & x.exist_ok & compat_e & ports_ok_e & vols_ok_e
    cap_e = torch.where(feas_e, cap_e, torch.zeros_like(cap_e))
    cap_e = torch.minimum(cap_e, count)
    before = torch.cumsum(cap_e, 0, dtype=I32) - cap_e
    fill_e = torch.minimum(torch.clamp(count - before, min=0), cap_e)
    rem = count - fill_e.sum(dtype=I32)

    landed_e = fill_e > 0
    new_exist_used = _madd(state.exist_used, fill_e[:, None], requests[None, :])
    new_exist_reqs = select_set(landed_e, comb_e, state.exist_reqs)
    new_exist_ports = torch.where(
        landed_e[:, None], state.exist_ports | x.ports[None, :], state.exist_ports
    )
    new_exist_vols = torch.where(
        landed_e[:, None], state.exist_vols | x.vols[None, :], state.exist_vols
    )

    # ---- tier 2: water-fill in-flight claims (the active window) ------
    pod_b = broadcast_set(x.reqs, W)
    comb = intersect_sets(state.reqs, pod_b)
    claim_ok = compatible_elemwise(state.reqs, pod_b, well_known)
    it_compat = ops.intersects(comb, it.reqs)  # [W, T] (intersects is symmetric)
    allow_t = x.it_allow[None, :]
    viable = state.its & it_compat & allow_t
    cap_res_n = ops.claim_fill_caps(state.used, viable, requests, it, comb.mask, zone_kid, ct_kid)
    cap_topo_n = _hg_slot_caps(
        topo, state.hg_counts, E + state.slot_of, x.hg_applies, x.hg_records, x.hg_self
    )
    ports_ok_n = ~packed_conflict(x.port_conf[None, :], state.claim_ports)
    tol = x.tmpl_ok[state.template.long()]
    feas_n = state.open & claim_ok & tol & ports_ok_n
    f_n = torch.minimum(cap_res_n, cap_topo_n)
    f_n = torch.where(self_conf, torch.clamp(f_n, max=1), f_n)
    f_n = torch.where(feas_n, f_n, torch.zeros_like(f_n))
    fill_c2 = ops.water_fill(state.pods, f_n, rem)
    rem2 = rem - fill_c2.sum(dtype=I32)

    landed_n = fill_c2 > 0
    used2 = _madd(state.used, fill_c2[:, None], requests[None, :])
    fits_final = ops.fits_off_counted(state.used, fill_c2, requests, it, comb.mask, zone_kid, ct_kid)
    its2 = torch.where(landed_n[:, None], viable & fits_final, state.its)
    reqs2 = select_set(landed_n, comb, state.reqs)
    pods2 = state.pods + fill_c2
    ports2 = torch.where(
        landed_n[:, None], state.claim_ports | x.ports[None, :], state.claim_ports
    )

    # ---- tier 3: open new claims, each filled to capacity -------------
    pod_g = broadcast_set(x.reqs, G)
    comb0 = intersect_sets(templates.reqs, pod_g)
    tmpl_compat = compatible_elemwise(templates.reqs, pod_g, well_known)
    it_compat0 = ops.intersects(comb0, it.reqs)  # [G, T]
    ones_g = torch.ones(G, dtype=I32, device=dev)
    fits_off0 = ops.fits_off_counted(
        templates.daemon_requests, ones_g, requests, it, comb0.mask, zone_kid, ct_kid
    )
    cap_ok = (it.cap[None, :, :] <= state.budget[:, None, :]).all(dim=-1)
    its0 = templates.its & it_compat0 & fits_off0 & allow_t & cap_ok
    cap_topo_fresh = _hg_slot_caps(
        topo, state.hg_counts, (E + state.n_open).reshape(1),
        x.hg_applies, x.hg_records, x.hg_self,
    )[0]
    tmpl_feas = (
        templates.valid
        & tmpl_compat
        & x.tmpl_ok
        & its0.any(dim=-1)
        & (state.nodes_budget >= 1.0)
    )
    g = _pick_template(tmpl_feas, templates).reshape(1)  # [1] int64
    g32 = g.to(I32)[0]
    any_template = tmpl_feas.any() & (cap_topo_fresh > 0)
    # only the chosen template's row is needed (rows are independent)
    daemon_g = templates.daemon_requests.index_select(0, g)  # [1, R]
    its0_g = its0.index_select(0, g)  # [1, T]
    mask0_g = comb0.mask.index_select(0, g).contiguous()  # [1, K, V]
    f_new0 = ops.claim_fill_caps(daemon_g, its0_g, requests, it, mask0_g, zone_kid, ct_kid)[0]
    f_new = torch.minimum(f_new0, cap_topo_fresh)
    f_new = torch.where(self_conf, torch.clamp(f_new, max=1), f_new)
    zero = torch.zeros((), dtype=I32, device=dev)
    f_new = torch.where(any_template, torch.clamp(f_new, min=0), zero)
    # fresh claims take contiguous WINDOW rows at w_open and contiguous
    # GLOBAL ids at n_open; the window and the global cap both bound opens
    avail_w = torch.clamp(W - state.w_open, min=0)
    avail_cap = torch.clamp(NCAP - state.n_open, min=0)
    slots_avail = torch.minimum(avail_w, avail_cap)
    want = torch.where(
        f_new > 0,
        torch.div(rem2 + f_new - 1, torch.clamp(f_new, min=1), rounding_mode="floor"),
        zero,
    )
    n_new = torch.minimum(want, slots_avail)
    spilled = (want > n_new) & (avail_cap > slots_avail)
    idx = torch.arange(W, dtype=I32, device=dev)
    i_new = idx - state.w_open
    is_new = (i_new >= 0) & (i_new < n_new)
    c_new = torch.where(
        is_new, torch.minimum(torch.clamp(rem2 - i_new * f_new, min=0), f_new), torch.zeros_like(idx)
    )
    placed3 = c_new.sum(dtype=I32)
    leftover = rem2 - placed3
    status = torch.where(any_template, _i32(NO_ROOM, dev), _i32(NO_CLAIM, dev))
    new_slot_of = torch.where(is_new, state.n_open + i_new, state.slot_of)

    used3 = torch.where(
        is_new[:, None],
        _madd(daemon_g, c_new[:, None], requests[None, :]),
        used2,
    )
    fits_new = ops.fits_off_counted(daemon_g, c_new, requests, it, mask0_g, zone_kid, ct_kid)
    its3 = torch.where(is_new[:, None], its0_g & fits_new, its2)
    comb0_g = ReqSetTensors(*(c.index_select(0, g)[0] for c in comb0))
    reqs3 = select_set(is_new, broadcast_set(comb0_g, W), reqs2)
    template3 = torch.where(is_new, g32, state.template)
    open3 = state.open | is_new
    pods3 = torch.where(is_new, c_new, pods2)
    ports3 = torch.where(
        (is_new & (c_new > 0))[:, None], ports2 | x.ports[None, :], ports2
    )
    new_n_open = state.n_open + n_new
    new_w_open = state.w_open + n_new

    # hostname-group counts for every landed pod, at GLOBAL slots (window
    # rows map through slot_of; out-of-range ids drop)
    S = state.hg_counts.shape[1]
    fill_claims = torch.where(is_new, c_new, fill_c2)
    slot_ids = E + new_slot_of
    slot_ids = torch.where((slot_ids >= 0) & (slot_ids < S), slot_ids, torch.full_like(slot_ids, S))
    fill_slots = torch.zeros(S + 1, dtype=I32, device=dev)
    fill_slots[:E] = fill_e
    fill_slots.index_add_(0, slot_ids.long(), fill_claims)
    rec = (x.hg_records & topo.hg_valid).to(I32)
    new_hg_counts = state.hg_counts + rec[:, None] * fill_slots[None, :S]

    # budget bookkeeping (+inf for every fill-routed problem)
    max_cap = torch.where(its0_g[0][:, None], it.cap, torch.full_like(it.cap, float("-inf"))).max(dim=0).values
    max_cap = torch.where(torch.isfinite(max_cap), max_cap, torch.zeros_like(max_cap))
    n_new_f = n_new.to(F32)
    new_budget = state.budget.clone()
    new_budget.index_add_(0, g, (-max_cap * n_new_f)[None, :])
    new_nodes_budget = state.nodes_budget.clone()
    new_nodes_budget.index_add_(0, g, (-n_new_f).reshape(1))

    ys = FillYs(
        fill_e=fill_e,
        fill_c=fill_claims,
        open_start=state.w_open,
        n_opened=n_new,
        tmpl=torch.where(n_new > 0, g32, _i32(-1, dev)),
        leftover=leftover,
        status=status,
    )
    return (
        state._replace(
            exist_reqs=new_exist_reqs,
            exist_used=new_exist_used,
            reqs=reqs3,
            used=used3,
            its=its3,
            template=template3,
            open=open3,
            pods=pods3,
            n_open=new_n_open,
            slot_of=new_slot_of,
            w_open=new_w_open,
            w_hw=torch.maximum(state.w_hw, new_w_open),
            spills=state.spills + spilled.to(I32),
            budget=new_budget,
            nodes_budget=new_nodes_budget,
            hg_counts=new_hg_counts,
            exist_ports=new_exist_ports,
            claim_ports=ports3,
            exist_vols=new_exist_vols,
        ),
        ys,
    )


def _take_x(xs, j: int):
    """Row j of a per-segment or per-pod input container (FillXs, KindXs,
    PodXs)."""
    return type(xs)(
        *(ReqSetTensors(*(c[j] for c in v)) if isinstance(v, ReqSetTensors) else v[j] for v in xs)
    )


def solve_fill(
    state: SolverState,
    xs: FillXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    plain: bool = False,
) -> tuple[SolverState, FillYs]:
    """Kind-level batch placement over the B segments of xs (the
    reference's lax.scan as a loop); returns (state', ys stacked over B)."""
    ops = _ops(plain)
    ys = []
    for j in range(xs.count.shape[0]):
        state, y = _fill_step(
            state, _take_x(xs, j), exist, it, templates, well_known, topo,
            zone_kid, ct_kid, n_claims, ops,
        )
        ys.append(y)
    if not ys:
        raise ValueError("solve_fill needs at least one segment")
    return state, FillYs(*(torch.stack(f) for f in zip(*ys)))


# ---------------------------------------------------------------------------
# placement objectives: K rank variants of one fill group and their verdict
# (the JAX package's solve_fill_variants / _objective_score)
# ---------------------------------------------------------------------------
# A non-lexical policy solves each fill group under KV template ranks
# (variant 0 the policy's canonical rank, variant k the k-th best template
# promoted to the front), every variant from the same base state, and
# folds the outcomes into one verdict word: bits [0, KV) the variants whose
# group placed every pod without a window spill, bits [24, 32) the
# feasible variant of least score (ties to the lowest index; 0 when none is
# feasible, or when every feasible score is +inf). The caller fetches the
# word, commits the winner's state or replays the group.

# objective ids (objectives/registry.py POLICIES order)
OBJ_LEXICAL = 0
OBJ_COST_MIN = 1
OBJ_FRAG_AWARE = 2
OBJ_TOPO_SPREAD = 3
OBJ_GANG_SLICE = 4

# the verdict word keeps its top byte for the winner, so at most 24 rank
# variants ride one 32-bit word
VARIANT_MAX = 24

# the SolverState fields a variant's commit takes from the winner (the
# reference's ShardFillState); w_hw becomes max(base w_hw, winner w_open)
FILL_COMMIT = (
    "reqs", "used", "its", "template", "open", "pods", "slot_of", "claim_ports", "held", "n_open", "w_open",
    "spills", "exist_reqs", "exist_used", "exist_ports", "exist_vols", "hg_counts",
)


class VariantOut(NamedTuple):
    """What the verdict reads of one variant's fill solve."""

    its: torch.Tensor  # [W, T] bool
    open: torch.Tensor  # [W] bool
    pods: torch.Tensor  # [W] i32
    template: torch.Tensor  # [W] i32
    w_open: torch.Tensor  # [] i32
    spills: torch.Tensor  # [] i32
    leftover: torch.Tensor  # [B] i32 — per segment


def variant_out(state: SolverState, ys: FillYs) -> VariantOut:
    return VariantOut(state.its, state.open, state.pods, state.template, state.w_open, state.spills, ys.leftover)


# XLA:CPU's f32 sum of n elements, the block and its padding rule
XLA_SUM_BLOCK = 32


def xla_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """[...] f32: the sum over the last axis of f32 `x` in the order XLA:CPU
    sums it (jax 0.9.0; the optimised HLO of `jnp.sum` over n elements is a
    `reduce-window` with `window={size=32 stride=32 pad=lo_hi}` followed
    by a reduce of the ceil(n / 32) partials). With p = ceil(n / 32) * 32
    - n, lo = p // 2 zeros go before the elements and p - lo after them;
    each block of 32 is summed left to right in f32 from +0.0; the
    partials are summed again by the same rule while more than 32 are
    left, and what is left in order. Every add rounds to f32, so the
    result is the reference's bit for bit."""
    x = x.to(F32)
    lead = x.shape[:-1]
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(lead, dtype=F32, device=x.device)
    while True:
        m = -(-n // XLA_SUM_BLOCK)
        p = m * XLA_SUM_BLOCK - n
        lo = p // 2
        if p:
            x = torch.cat([x.new_zeros(lead + (lo,)), x, x.new_zeros(lead + (p - lo,))], dim=-1)
        blocks = x.reshape(lead + (m, XLA_SUM_BLOCK))
        s = torch.zeros(lead + (m,), dtype=F32, device=x.device)
        for j in range(XLA_SUM_BLOCK):
            s = s + blocks[..., j]
        if m == 1:
            return s[..., 0]
        x, n = s, m


def objective_score_plain(base_w_open, v: VariantOut, price_t: torch.Tensor, objective: int, G: int) -> torch.Tensor:
    """[] f32: the realized score of the claims one variant opened (window
    rows [base_w_open, v.w_open) that are open), the reference's
    _objective_score formulas with every f32 sum in XLA's order
    (xla_tree_sum), so scores equal the reference's bit for bit: an
    integer sum past 2^24 and a sum of f32 prices round where the
    reference's do. cost_min: the opened rows' cheapest viable price over
    W; frag_aware: n·1e6 − landed, landed the f32 sum of the pods over W,
    one rounding (XLA contracts it into an fma); topo_spread: the f32 sum
    over G of each template's opened count squared; gang_slice: the f32
    sum over W of p_max − pods, then + n_opened."""
    W = v.open.shape[0]
    rows = torch.arange(W, dtype=I32, device=v.open.device)
    opened = (rows >= base_w_open) & (rows < v.w_open) & v.open
    n_opened = (v.w_open - base_w_open).to(F32)
    zero = torch.zeros_like(v.pods)
    if objective == OBJ_COST_MIN:
        row_price = torch.where(v.its, price_t[None, :], float("inf")).amin(dim=1)
        return xla_tree_sum(torch.where(opened, row_price, 0.0))
    if objective == OBJ_FRAG_AWARE:
        landed = xla_tree_sum(torch.where(opened, v.pods, zero).to(F32))
        return (n_opened.double() * 1e6 - landed.double()).float()
    if objective == OBJ_TOPO_SPREAD:
        cnt = torch.zeros(G, dtype=F32, device=v.open.device)
        cnt.index_add_(0, v.template.long(), opened.to(F32))
        return xla_tree_sum(cnt * cnt)
    if objective == OBJ_GANG_SLICE:
        p_max = torch.where(opened, v.pods, zero).max()
        return xla_tree_sum(torch.where(opened, p_max - v.pods, zero).to(F32)) + n_opened
    return torch.zeros((), dtype=F32, device=v.open.device)


def objective_verdict_plain(base_w_open, base_spills, outs: list, price_t: torch.Tensor, objective: int,
                            G: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [KV] f32, verdict word [1] i32): each variant's score, its
    feasibility bit (its segments' leftovers sum to 0 and its spill count
    is the base's) in bit v, and the argmin of the feasible scores in bits
    [24, 32) — the first index of the least value of where(feasible,
    scores, +inf), 0 when no variant is feasible. Every score +inf makes
    that argmin 0 even where variant 0 is infeasible, as in the
    reference."""
    KV = len(outs)
    if not 1 <= KV <= VARIANT_MAX:
        raise ValueError(f"objective_verdict: {KV} variants outside [1, {VARIANT_MAX}]")
    scores = torch.stack([objective_score_plain(base_w_open, v, price_t, objective, G) for v in outs])
    feasible = torch.stack([(v.leftover.sum() == 0) & (v.spills == base_spills) for v in outs])
    masked = torch.where(feasible, scores, torch.full_like(scores, float("inf")))
    winner = torch.where(feasible.any(), torch.argmin(masked), torch.zeros((), dtype=torch.int64, device=scores.device))
    bits = (feasible.to(torch.int64) << torch.arange(KV, device=scores.device)).sum()
    return scores, (bits | (winner << 24)).to(I32).reshape(1)


def objective_verdict(base_w_open, base_spills, outs: list, price_t: torch.Tensor, objective: int, G: int):
    """H11: the verdict in one launch on CUDA, the plain version on CPU."""
    if price_t.device.type == "cpu":
        return objective_verdict_plain(base_w_open, base_spills, outs, price_t, objective, G)
    return cuda.objective_verdict(base_w_open, base_spills, outs, price_t, objective, G)


def solve_fill_variants(
    state: SolverState,
    xs: FillXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    ranks: torch.Tensor,  # [KV, G] i32 — row 0 the policy's canonical rank
    price_t: torch.Tensor,  # [T] f32 — per-type min offering price (+inf unpriced)
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    objective: int,
    plain: bool = False,
) -> tuple[list, list, torch.Tensor, torch.Tensor]:
    """KV rank variants of ONE fill group, each the group's full fill solve
    from `state` under templates._replace(rank=ranks[v]) (one after
    another; the fill step works out of place, so no variant writes into
    the base or another variant), then the verdict (H11). Returns
    (the KV states, the KV FillYs, verdict word [1] i32, scores [KV] f32);
    no host sync."""
    states, yss = [], []
    for v in range(ranks.shape[0]):
        st, ys = solve_fill(
            state, xs, exist, it, templates._replace(rank=ranks[v]), well_known, topo, zone_kid, ct_kid,
            n_claims, plain=plain,
        )
        states.append(st)
        yss.append(ys)
    outs = [variant_out(st, ys) for st, ys in zip(states, yss)]
    G = templates.its.shape[0]
    verdict = objective_verdict_plain if plain else objective_verdict
    scores, word = verdict(state.w_open, state.spills, outs, price_t, objective, G)
    return states, yss, word, scores


def commit_variant(state: SolverState, win: SolverState) -> SolverState:
    """The base state with the winner's fill fields (FILL_COMMIT) and
    w_hw = max(base w_hw, winner w_open): the reference's commit."""
    return state._replace(**{f: getattr(win, f) for f in FILL_COMMIT}, w_hw=torch.maximum(state.w_hw, win.w_open))


# ---------------------------------------------------------------------------
# the zonal kind scan: same-kind batched placement for vocab-key topology
# kinds (the JAX package's solve_kind_scan / _make_kind_step)
# ---------------------------------------------------------------------------
# A run of identical pods whose every applying / recording vocab-key group
# shares ONE key with at most KSCAN_D values (zones in practice). Per
# segment, one full-width precompute (torch + H1 + H5) hoists everything
# but the topology counts, the per-row narrowed domain sets and the
# capacities; the pods then replay one at a time (kernel H6, one launch
# per segment) over a compact [rows, D] domain representation with the
# per-pod engine's decisions: tier 1 earliest existing node, tier 2
# fewest pods / earliest slot, tier 3 first feasible template; spread
# narrows to the (min count, sorted-name rank) domain, affinity to the
# counted compatible set or the rank-min bootstrap, anti-affinity to the
# zero-count domains; counts commit for single-valued or anti sets.

KSCAN_D = 16  # max domain width a kind-scan key may have


class KindXs(NamedTuple):
    """Per-segment (pod kind) inputs to the kind scan."""

    reqs: ReqSetTensors  # [B, K, V]
    strict_mask: torch.Tensor  # [B, K, V]
    requests: torch.Tensor  # [B, R]
    tmpl_ok: torch.Tensor  # [B, G]
    it_allow: torch.Tensor  # [B, T]
    exist_ok: torch.Tensor  # [B, E]
    ports: torch.Tensor  # [B, NP]
    port_conf: torch.Tensor  # [B, NP]
    vols: torch.Tensor  # [B, NV]
    count: torch.Tensor  # [B] i32
    vg_applies: torch.Tensor  # [B, NGv]
    vg_records: torch.Tensor  # [B, NGv]
    vg_self: torch.Tensor  # [B, NGv]
    hg_applies: torch.Tensor  # [B, NGh]
    hg_records: torch.Tensor  # [B, NGh]
    hg_self: torch.Tensor  # [B, NGh]


class KindYs(NamedTuple):
    """Per-segment kind-scan record: each pod's slot in E-space (existing
    < E, claims E + global id) or NO_ROOM / NO_CLAIM."""

    assignment: torch.Tensor  # [B, MAXC] i32
    grid_reused: torch.Tensor  # [B] bool — the boundary-adjusted grid was reused


# ---- H5 kscan_grid: plain versions and wrappers ---------------------------


def cap_res_grid_plain(used: torch.Tensor, req: torch.Tensor, it: InstanceTypeTensors) -> torch.Tensor:
    """[N, T, GR] i32 — max count per (type, allocatable group) cell with
    used + c*req within alloc (the +/-1-verified estimate and total-based
    pass rule of claim_fill_caps; the reference's `_cap_res_grid`)."""
    pos = req > 0.0
    safe = torch.where(pos, req, torch.ones_like(req))
    N = used.shape[0]
    T, GR = it.alloc.shape[:2]
    cap = float(COUNT_CAP)
    est = torch.full((N, T, GR), cap, dtype=F32, device=used.device)
    for r in range(req.shape[0]):
        head = it.alloc[None, :, :, r] - used[:, None, None, r]
        est = torch.minimum(est, torch.where(pos[r], head / safe[r], torch.full_like(head, float("inf"))))
    c0 = torch.clamp(torch.floor(est), 0.0, cap).to(I32)
    okc = it.group_valid[None].expand(N, T, GR)

    def ok(c):
        return _fits_cells(used, c, req, it, okc)

    up = ok(c0 + 1)
    mid = ok(c0)
    cdn = torch.clamp(c0 - 1, min=0)
    dn = ok(cdn)
    zero = torch.zeros_like(c0)
    c = torch.where(mid, torch.where(up, c0 + 1, c0), torch.where(dn, cdn, zero))
    return torch.where(okc, c, zero)


def kscan_admit(it: InstanceTypeTensors, key_kid: int, D: int) -> torch.Tensor:
    """[T, D] bool — the per-key intersects() term between each type's
    requirement at key_kid and the single-value set {d}."""
    return ~it.reqs.defined[:, key_kid, None] | it.reqs.mask[:, key_kid, :D]


def _pairs_off(zm: torch.Tensor, cm: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """[N, T, GR] bool — any over (z, c) of zm[n, z] & cm[n, c] &
    avail[t, g, z, c], as an exact 0/1 product."""
    T, GR, Z, C = avail.shape
    pairs = (zm[:, :, None] & cm[:, None, :]).reshape(-1, Z * C).to(F32)
    return (pairs @ avail.reshape(T * GR, Z * C).to(F32).T > 0).reshape(-1, T, GR)


def kscan_capd_plain(grid, viable, ct_mask, zmask, it, key_kid: int, zone_kid: int, D: int) -> torch.Tensor:
    """[N, D] i32 — max pods addable per row IF placed in domain d of
    key_kid: the max grid cell over (type, group) cells the domain admits
    with an available offering there (the reference's `_kscan_capd`)."""
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    admit = kscan_admit(it, key_kid, D)
    zero = torch.zeros_like(grid)
    cols = []
    if key_kid == zone_kid:
        for d in range(D):
            one = torch.zeros((ct_mask.shape[0], Z), dtype=torch.bool, device=grid.device)
            one[:, d] = True
            off_d = _pairs_off(one, ct_mask[:, :C], it.zc_avail)
            m = viable[:, :, None] & admit[None, :, d, None] & off_d
            cols.append(torch.where(m, grid, zero).amax(dim=(1, 2)))
    else:
        base = viable[:, :, None] & _pairs_off(zmask[:, :Z], ct_mask[:, :C], it.zc_avail)
        for d in range(D):
            m = base & admit[None, :, d, None]
            cols.append(torch.where(m, grid, zero).amax(dim=(1, 2)))
    return torch.stack(cols, dim=-1)


def kscan_fits_final_plain(grid, placed, zset, ct_mask, zmask, it, key_kid: int, zone_kid: int, D: int) -> torch.Tensor:
    """[N, T] bool — fits_off at the final count within the final narrowed
    domains (the reference's `_kscan_fits_final`)."""
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    fits = grid >= placed[:, None, None]
    if key_kid == zone_kid:
        zm = zset[:, :Z] if Z <= D else torch.nn.functional.pad(zset, (0, Z - D))
    else:
        zm = zmask[:, :Z]
    return (fits & _pairs_off(zm, ct_mask[:, :C], it.zc_avail)).any(dim=-1)


def _kscan_grid_plain(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid=None):
    if grid is None:
        grid = cap_res_grid_plain(used, req, it)
    capd = kscan_capd_plain(
        grid, viable, rows_mask[:, ct_kid, :], rows_mask[:, zone_kid, :], it, key_kid, zone_kid, D
    )
    return grid, capd


def kscan_grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid=None):
    """H5 grid mode: (grid [N, T, GR] i32, capd [N, D] i32). With `grid`
    given (a reused boundary-adjusted grid) only capd is computed."""
    if used.device.type == "cpu":
        return _kscan_grid_plain(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid)
    return cuda.kscan_grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid)


def kscan_fits_final(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D) -> torch.Tensor:
    """H5 fits-final mode: [N, T] bool (kernel on CUDA, plain on CPU)."""
    if grid.device.type == "cpu":
        return kscan_fits_final_plain(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D)
    return cuda.kscan_fits_final(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D)


# ---- H6 kscan_pod_loop: plain version and wrapper -------------------------


def vg_eval_plain(topo: TopologyTensors, gate, selfs, pd, D: int):
    """The reference's `_vg_eval`: returns eval_candidates(zs [C, D], cnt
    [NGv, D]) -> (feasible [C], newz [C, D]), the vocab-key group rules on
    the compact domain columns of the kind's one key."""
    dom = topo.vg_domains[:, :D]
    rank = topo.vg_rank[:, :D]
    skew = topo.vg_skew
    mind = topo.vg_min_domains
    in_universe = dom & pd[None, :]
    supported = in_universe.sum(dim=-1, dtype=I32)
    self_add = selfs.to(I32)
    big = torch.tensor(BIG_I32, dtype=I32, device=dom.device)

    def eval_candidates(zs, cnt):
        masked = torch.where(in_universe, cnt, big)
        minc = masked.min(dim=-1).values
        minc = torch.where((mind > 0) & (supported < mind), torch.zeros_like(minc), minc)
        minc = torch.where(minc == BIG_I32, torch.zeros_like(minc), minc)
        eff = cnt + self_add[:, None]
        ok_skew = (eff - minc[:, None]) <= skew[:, None]
        opts = dom & pd[None, :] & (cnt > 0)
        group_empty = ~torch.any(cnt > 0, dim=-1)
        no_compat = ~torch.any(pd[None, :] & (cnt > 0), dim=-1)
        bootstrap = selfs & (group_empty | no_compat)
        cnt_zero = cnt == 0

        valid_sp = dom[None] & zs[:, None, :] & ok_skew[None]
        sp_key = torch.where(valid_sp, (eff * RANK_BASE + rank)[None], big)
        sp_mask = _onehot_rows(valid_sp, torch.argmin(sp_key, dim=-1))
        any_sp = torch.any(valid_sp, dim=-1)

        opts_c = opts[None] & zs[:, None, :]
        any_opts = torch.any(opts_c, dim=-1, keepdim=True)
        boot_space = (dom & pd[None, :])[None] & zs[:, None, :]
        boot_idx = torch.argmin(torch.where(boot_space, rank[None], big), dim=-1)
        boot_mask = _onehot_rows(boot_space, boot_idx)
        aff_mask = torch.where(any_opts, opts_c, boot_mask & bootstrap[None, :, None])
        any_aff = torch.any(aff_mask, dim=-1)

        anti_mask = boot_space & cnt_zero[None]
        any_anti = torch.any(anti_mask, dim=-1)

        t = topo.vg_type[None, :]
        narrowed = torch.where(
            (t == TYPE_SPREAD)[..., None], sp_mask,
            torch.where((t == TYPE_AFFINITY)[..., None], aff_mask, anti_mask),
        )
        ok = torch.where(t == TYPE_SPREAD, any_sp, torch.where(t == TYPE_AFFINITY, any_aff, any_anti))
        feasible = torch.all(~gate[None, :] | ok, dim=-1)
        upd = torch.all(~gate[None, :, None] | narrowed, dim=1)  # [C, D]
        return feasible, zs & upd

    return eval_candidates


class PodLoopIn(NamedTuple):
    """Segment invariants of the kind scan's pod loop (read-only)."""

    cap_e: torch.Tensor  # [E] i32 — existing-node resource caps (0 = infeasible)
    zie0: torch.Tensor  # [E] bool — existing rows' key complement bit at segment start
    open0: torch.Tensor  # [W] bool
    static_n0: torch.Tensor  # [W] bool — claim_ok & toleration & ports
    pods0: torch.Tensor  # [W] i32
    zin0: torch.Tensor  # [W] bool
    static_g: torch.Tensor  # [G] bool
    capd_g: torch.Tensor  # [G, D] i32 (self-conflict clamped)
    z0_g: torch.Tensor  # [G, D] bool
    zinf_g: torch.Tensor  # [G] bool
    w_open0: torch.Tensor  # [] i32
    self_conf: torch.Tensor  # [] bool
    key_touched: torch.Tensor  # [] bool
    gate: torch.Tensor  # [NGv] bool — vg_applies & vg_valid
    recs: torch.Tensor  # [NGv] bool — vg_records & vg_valid
    vg_self: torch.Tensor  # [NGv] bool
    pd: torch.Tensor  # [D] bool — the pod's strict domains
    hg_applies: torch.Tensor  # [NGh] bool
    hg_records: torch.Tensor  # [NGh] bool
    hg_self: torch.Tensor  # [NGh] bool


class PodLoopCarry(NamedTuple):
    """What a landing mutates; the loop updates these tensors in place."""

    zn: torch.Tensor  # [W, D] bool — window rows' narrowed domain sets
    ze: torch.Tensor  # [E, D] bool
    capd: torch.Tensor  # [W, D] i32
    pl_n: torch.Tensor  # [W] i32 — pods landed per window row this segment
    pl_e: torch.Tensor  # [E] i32
    tmpl_n: torch.Tensor  # [W] i32
    cnt: torch.Tensor  # [NGv, D] i32
    hgc: torch.Tensor  # [NGh, S] i32
    n_open: torch.Tensor  # [] i32
    w_open: torch.Tensor  # [] i32
    slot_of: torch.Tensor  # [W] i32
    spills: torch.Tensor  # [] i32


def kscan_pod_loop_plain(
    inp: PodLoopIn, c: PodLoopCarry, topo: TopologyTensors, templates: Templates,
    count: int, maxc: int, n_claims: int,
) -> torch.Tensor:
    """The kind scan's per-pod loop, one pod at a time in torch (the
    reference's pod_step under lax.while_loop); updates the carry in place
    and returns the [maxc] i32 assignment row. No host sync: the trip
    count is the segment's host-known pod count."""
    dev = c.zn.device
    E, W, G = c.ze.shape[0], c.zn.shape[0], inp.static_g.shape[0]
    D = c.zn.shape[1]
    NCAP = n_claims
    eval_candidates = vg_eval_plain(topo, inp.gate, inp.vg_self, inp.pd, D)
    is_anti = topo.vg_type == TYPE_ANTI
    ar_e = torch.arange(E, dtype=I32, device=dev)
    ar_n = torch.arange(W, dtype=I32, device=dev)
    big = torch.tensor(BIG, dtype=I32, device=dev)
    assignment = torch.full((maxc,), NO_CLAIM, dtype=I32, device=dev)
    zn, ze, capd, pl_n, pl_e = c.zn.clone(), c.ze.clone(), c.capd.clone(), c.pl_n.clone(), c.pl_e.clone()
    tmpl_n, cnt, hgc, slot_of = c.tmpl_n.clone(), c.cnt.clone(), c.hgc.clone(), c.slot_of.clone()
    n_open, w_open, spills = c.n_open.clone(), c.w_open.clone(), c.spills.clone()
    for i in range(count):
        zs_all = torch.cat([ze, zn, inp.z0_g], dim=0)
        f_topo, newz = eval_candidates(zs_all, cnt)
        slots_all = torch.cat([ar_e, E + slot_of, (E + n_open).reshape(1).expand(G)])
        hg_ok = hg_evaluate(topo, hgc, slots_all, inp.hg_applies, inp.hg_self)

        # tier 1: earliest feasible existing node
        feas_e = (pl_e < inp.cap_e) & f_topo[:E] & hg_ok[:E]
        pick_e = torch.argmin(torch.where(feas_e, ar_e, big))
        found_e = feas_e.any()
        # tier 2: fewest pods, earliest slot
        newz_n = newz[E:E + W]
        lim_n = torch.where(inp.self_conf, torch.clamp(capd, max=1), capd)
        fits_n = torch.any(newz_n & (lim_n > pl_n[:, None]), dim=-1)
        fresh = (ar_n >= inp.w_open0) & (ar_n < w_open)
        feas_n = (
            (inp.open0 | fresh) & (inp.static_n0 | fresh) & f_topo[E:E + W] & fits_n
            & hg_ok[E:E + W] & ~found_e
        )
        order = (inp.pods0 + pl_n) * W + ar_n
        pick = torch.argmin(torch.where(feas_n, order, big))
        found = feas_n.any()
        # tier 3: first feasible template
        newz_g = newz[E + W:]
        fits_g = torch.any(newz_g & (inp.capd_g >= 1), dim=-1)
        tmpl_feas = inp.static_g & f_topo[E + W:] & fits_g & hg_ok[E + W:]
        g = _pick_template(tmpl_feas, templates)
        any_t = tmpl_feas.any() & ~found_e & ~found
        can_open = any_t & (w_open < W) & (n_open < NCAP)
        spilled = any_t & ~can_open & (n_open < NCAP)

        place = found_e | found | can_open
        cslot = torch.where(found, pick.to(I32), w_open)
        gslot = torch.where(found, slot_of[pick], n_open)
        slot = torch.where(found_e, pick_e.to(I32), E + gslot)
        assignment[i] = torch.where(
            place, slot, torch.where(any_t, _i32(NO_ROOM, dev), _i32(NO_CLAIM, dev))
        )

        win_z = torch.where(found_e, newz[pick_e], torch.where(found, newz_n[pick], newz_g[g]))
        win_zinf_old = torch.where(found_e, inp.zie0[pick_e], torch.where(found, inp.zin0[pick], inp.zinf_g[g]))
        win_zinf = win_zinf_old & ~inp.key_touched
        single = win_z.sum(dtype=I32) == 1
        do = inp.recs & ~win_zinf & (is_anti | single)
        delta = (do[:, None] & win_z[None, :]).to(I32)
        cnt = cnt + torch.where(place, delta, torch.zeros_like(delta))
        hgc = hg_commit(hgc, slot, inp.hg_records & place, topo.hg_valid)

        upd_claim = (found | can_open) & ~found_e
        opened = can_open & ~found
        row_c = (ar_n == cslot)
        row_e = (ar_e == pick_e) & found_e
        zn = torch.where((row_c & upd_claim)[:, None], win_z[None, :], zn)
        ze = torch.where(row_e[:, None], win_z[None, :], ze)
        capd = torch.where((row_c & opened)[:, None], inp.capd_g[g][None, :], capd)
        pl_n = pl_n + (row_c & upd_claim).to(I32)
        pl_e = pl_e + row_e.to(I32)
        tmpl_n = torch.where(row_c & opened, g.to(I32), tmpl_n)
        slot_of = torch.where(row_c & opened, n_open, slot_of)
        n_open = n_open + opened.to(I32)
        w_open = w_open + opened.to(I32)
        spills = spills + spilled.to(I32)
    for dst, src in zip(c, (zn, ze, capd, pl_n, pl_e, tmpl_n, cnt, hgc, n_open, w_open, slot_of, spills)):
        dst.copy_(src)
    return assignment


def kscan_pod_loop(inp, c, topo, templates, count, maxc, n_claims) -> torch.Tensor:
    """H6: the pod loop in one launch on CUDA, the plain loop on CPU."""
    if c.zn.device.type == "cpu":
        return kscan_pod_loop_plain(inp, c, topo, templates, count, maxc, n_claims)
    return cuda.kscan_pod_loop(inp, c, topo, count, maxc, n_claims, templates.rank)


def _kind_step(
    state: SolverState,
    x: KindXs,
    grid_prev: Optional[torch.Tensor],  # the previous segment's boundary-adjusted grid, to reuse
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    key_kid: int,
    D: int,
    count: int,
    maxc: int,
    ops: "_KOps",
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """One kind-scan segment (the reference's seg_step): the per-segment
    precompute, the pod loop (H6), and the segment-end writeback. Returns
    (state', assignment [maxc], grid_next [W, T, GR])."""
    dev = state.used.device
    E = exist.avail.shape[0]
    G = templates.its.shape[0]
    W = state.open.shape[0]
    requests = x.requests
    self_conf = packed_conflict(x.ports, x.port_conf)
    pd = x.strict_mask[key_kid, :D]
    key_touched = torch.any(x.vg_applies & topo.vg_valid)
    no_wk = torch.zeros_like(well_known)

    # ---- per-segment invariants ---------------------------------------
    # tier 2: claims (the active window)
    pod_b = broadcast_set(x.reqs, W)
    comb = intersect_sets(state.reqs, pod_b)
    claim_ok = compatible_elemwise(state.reqs, pod_b, well_known)
    it_compat = ops.intersects(comb, it.reqs)  # [W, T]
    viable0 = state.its & it_compat & x.it_allow[None, :]
    tol = x.tmpl_ok[state.template.long()]
    ports_ok_n = ~packed_conflict(x.port_conf[None, :], state.claim_ports)
    static_n0 = claim_ok & tol & ports_ok_n
    comb_mask = comb.mask.contiguous()
    grid_n, capd_n0 = ops.kscan_grid(
        state.used, requests, it, viable0, comb_mask, zone_kid, ct_kid, key_kid, D, grid_prev
    )

    # tier 1: existing nodes
    pod_e = broadcast_set(x.reqs, E)
    comb_e = intersect_sets(state.exist_reqs, pod_e)
    compat_e = compatible_elemwise(state.exist_reqs, pod_e, no_wk)
    ports_ok_e = ~packed_conflict(x.port_conf[None, :], state.exist_ports)
    newv_e = state.exist_vols | x.vols[None, :]
    vcount_e = packed_count_and(newv_e[:, None, :], exist.vol_driver[None, :, :]).to(F32)
    vols_ok_e = (vcount_e <= exist.vol_limits).all(dim=-1) | ~packed_any(x.vols)
    cap_e = _count_cap_seq(state.exist_used, requests[None, :], exist.avail)
    static_e = exist.valid & x.exist_ok & compat_e & ports_ok_e & vols_ok_e
    cap_e = torch.where(static_e, cap_e, torch.zeros_like(cap_e))
    cap_e = torch.where(self_conf, torch.clamp(cap_e, max=1), cap_e)

    # tier 3: fresh templates
    pod_g = broadcast_set(x.reqs, G)
    comb0 = intersect_sets(templates.reqs, pod_g)
    tmpl_compat = compatible_elemwise(templates.reqs, pod_g, well_known)
    it_compat0 = ops.intersects(comb0, it.reqs)  # [G, T]
    its0 = templates.its & it_compat0 & x.it_allow[None, :]
    static_g = templates.valid & tmpl_compat & x.tmpl_ok
    comb0_mask = comb0.mask.contiguous()
    grid_g, capd_g = ops.kscan_grid(
        templates.daemon_requests, requests, it, its0, comb0_mask, zone_kid, ct_kid, key_kid, D
    )
    capd_g = torch.where(self_conf, torch.clamp(capd_g, max=1), capd_g)

    zin0 = comb.inf[:, key_kid]
    zie0 = comb_e.inf[:, key_kid]
    w_open0 = state.w_open
    inp = PodLoopIn(
        cap_e=cap_e.contiguous(), zie0=zie0.contiguous(), open0=state.open,
        static_n0=static_n0.contiguous(), pods0=state.pods, zin0=zin0.contiguous(),
        static_g=static_g.contiguous(), capd_g=capd_g.contiguous(),
        z0_g=comb0.mask[:, key_kid, :D].contiguous(), zinf_g=comb0.inf[:, key_kid].contiguous(),
        w_open0=w_open0, self_conf=self_conf, key_touched=key_touched,
        gate=(x.vg_applies & topo.vg_valid).contiguous(),
        recs=(x.vg_records & topo.vg_valid).contiguous(), vg_self=x.vg_self.contiguous(),
        pd=pd.contiguous(), hg_applies=x.hg_applies.contiguous(),
        hg_records=x.hg_records.contiguous(), hg_self=x.hg_self.contiguous(),
    )
    carry = PodLoopCarry(
        zn=comb.mask[:, key_kid, :D].contiguous(),
        ze=comb_e.mask[:, key_kid, :D].contiguous(),
        capd=capd_n0.contiguous(),
        pl_n=torch.zeros(W, dtype=I32, device=dev),
        pl_e=torch.zeros(E, dtype=I32, device=dev),
        tmpl_n=state.template.clone(),
        cnt=state.vg_counts[:, :D].clone(memory_format=torch.contiguous_format),
        hgc=state.hg_counts.clone(),
        n_open=state.n_open.clone(),
        w_open=state.w_open.clone(),
        slot_of=state.slot_of.clone(),
        spills=state.spills.clone(),
    )
    assignment = ops.kscan_pod_loop(inp, carry, topo, templates, count, maxc, n_claims)

    # ---- segment-end writeback ------------------------------------------
    pl_n, pl_e = carry.pl_n, carry.pl_e
    landed_n = pl_n > 0
    landed_e = pl_e > 0
    opened_here = landed_n & ~state.open
    tmpl_n = carry.tmpl_n
    tmpl_l = tmpl_n.long()
    zset_f = carry.zn
    zinf_f = zin0 & ~(key_touched & landed_n)

    # usage: one multiply-add per (segment, candidate), rounded once
    base_used = torch.where(opened_here[:, None], templates.daemon_requests[tmpl_l], state.used)
    new_used = torch.where(landed_n[:, None], _madd(base_used, pl_n[:, None], requests[None, :]), state.used)
    new_exist_used = _madd(state.exist_used, pl_e[:, None], requests[None, :])

    # requirements: claim ∩ pod (template ∩ pod for fresh claims) with the
    # key row narrowed to the carried domain set
    V = comb.mask.shape[2]
    base_reqs = select_set(opened_here, ReqSetTensors(*(f[tmpl_l] for f in comb0)), comb)
    beyond = torch.arange(V, device=dev) >= D
    km = base_reqs.mask[:, key_kid, :] & beyond[None, :]
    km[:, :D] = zset_f
    new_inf_k = torch.where(landed_n, zinf_f, base_reqs.inf[:, key_kid])
    final_reqs = _narrow_key(base_reqs, key_kid, km, new_inf_k, landed_n & key_touched)
    new_reqs = select_set(landed_n, final_reqs, state.reqs)

    # viable types at the final count within the final domains
    viable_base = torch.where(opened_here[:, None], its0[tmpl_l], viable0)
    ok_key = kernels.per_key_ok_at(it.reqs, final_reqs, key_kid)  # [W, T]
    grid_base = torch.where(opened_here[:, None, None], grid_g[tmpl_l], grid_n)
    ct_final = torch.where(opened_here[:, None], comb0.mask[tmpl_l, ct_kid, :], comb.mask[:, ct_kid, :])
    zf_final = torch.where(opened_here[:, None], comb0.mask[tmpl_l, zone_kid, :], comb.mask[:, zone_kid, :])
    fits_f = ops.kscan_fits_final(
        grid_base.contiguous(), pl_n, zset_f, ct_final.contiguous(), zf_final.contiguous(),
        it, key_kid, zone_kid, D,
    )
    new_its = torch.where(landed_n[:, None], viable_base & ok_key & fits_f, state.its)

    new_ports = torch.where(landed_n[:, None], state.claim_ports | x.ports[None, :], state.claim_ports)
    new_eports = torch.where(landed_e[:, None], state.exist_ports | x.ports[None, :], state.exist_ports)
    new_evols = torch.where(landed_e[:, None], state.exist_vols | x.vols[None, :], state.exist_vols)

    # existing-node requirements writeback (same key-row treatment)
    ekm = comb_e.mask[:, key_kid, :] & beyond[None, :]
    ekm[:, :D] = carry.ze
    e_inf_k = zie0 & ~(key_touched & landed_e)
    final_ereqs = _narrow_key(comb_e, key_kid, ekm, e_inf_k, landed_e & key_touched)
    new_ereqs = select_set(landed_e, final_ereqs, state.exist_reqs)

    new_vg = state.vg_counts.clone()
    new_vg[:, :D] = carry.cnt

    # boundary grid: landed rows debited by their pod counts (fresh rows
    # re-based on the template grid), for reuse by an equal-request segment
    grid_next = torch.where(
        landed_n[:, None, None], torch.clamp(grid_base - pl_n[:, None, None], min=0), grid_n
    )
    ar = torch.arange(W, dtype=I32, device=dev)
    state = state._replace(
        exist_reqs=new_ereqs,
        exist_used=new_exist_used,
        reqs=new_reqs,
        used=new_used,
        its=new_its,
        template=torch.where(opened_here, tmpl_n, state.template),
        open=state.open | ((ar >= w_open0) & (ar < carry.w_open)),
        pods=state.pods + pl_n,
        n_open=carry.n_open,
        slot_of=carry.slot_of,
        w_open=carry.w_open,
        w_hw=torch.maximum(state.w_hw, carry.w_open),
        spills=carry.spills,
        vg_counts=new_vg,
        hg_counts=carry.hgc,
        exist_ports=new_eports,
        claim_ports=new_ports,
        exist_vols=new_evols,
    )
    return state, assignment, grid_next


def _narrow_key(base: ReqSetTensors, k: int, key_mask, inf_k, marked) -> ReqSetTensors:
    """base with key k's row replaced: mask key_mask, complement bit inf_k
    (bounds and exclusions kept only where it stays a complement), and
    `marked` rows defined (touched keys become finite In sets)."""
    mask = base.mask.clone()
    mask[:, k, :] = key_mask
    inf = base.inf.clone()
    inf[:, k] = inf_k
    excl = base.excl.clone()
    excl[:, k] = base.excl[:, k] & inf_k
    gte = base.gte.clone()
    gte[:, k] = torch.where(inf_k, base.gte[:, k], torch.full_like(base.gte[:, k], INT_MIN))
    lte = base.lte.clone()
    lte[:, k] = torch.where(inf_k, base.lte[:, k], torch.full_like(base.lte[:, k], INT_MAX))
    defined = base.defined.clone()
    defined[:, k] = base.defined[:, k] | marked
    return ReqSetTensors(mask=mask, inf=inf, excl=excl, gte=gte, lte=lte, defined=defined)


class _KOps(NamedTuple):
    intersects: object
    kscan_grid: object
    kscan_fits_final: object
    kscan_pod_loop: object


KSCAN_KERNEL_OPS = _KOps(kernels.intersects, kscan_grid, kscan_fits_final, kscan_pod_loop)
KSCAN_PLAIN_OPS = _KOps(kernels.intersects_plain, _kscan_grid_plain, kscan_fits_final_plain, kscan_pod_loop_plain)


def grid_reuse_flags(requests_np: np.ndarray, grid_incremental: bool = True) -> list:
    """Per segment, whether the previous segment's boundary-adjusted grid
    is this segment's grid: the request rows are equal (host-known, so the
    choice needs no device read). The first segment always computes."""
    if not grid_incremental:
        return [False] * len(requests_np)
    return [False] + [
        bool(np.array_equal(requests_np[j], requests_np[j - 1])) for j in range(1, len(requests_np))
    ]


def solve_kind_scan(
    state: SolverState,
    xs: KindXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    key_kid: int,
    n_domains: int,
    maxc: int,
    counts: list,
    requests_np: np.ndarray,
    grid_incremental: bool = True,
    plain: bool = False,
) -> tuple[SolverState, KindYs]:
    """The zonal kind scan over the B segments of xs, threading the same
    SolverState as the fill scan. `counts` and `requests_np` are the
    segments' pod counts and request rows on the host (the pod loop's trip
    counts and the grid-reuse decisions); they must equal xs.count and
    xs.requests."""
    ops = KSCAN_PLAIN_OPS if plain else KSCAN_KERNEL_OPS
    reuse = grid_reuse_flags(np.asarray(requests_np), grid_incremental)
    grid = None
    rows = []
    for j in range(len(counts)):
        state, a, grid = _kind_step(
            state, _take_x(xs, j), grid if reuse[j] else None, exist, it, templates, well_known,
            topo, zone_kid, ct_kid, n_claims, key_kid, n_domains, int(counts[j]), maxc, ops,
        )
        rows.append(a)
    if not rows:
        raise ValueError("solve_kind_scan needs at least one segment")
    return state, KindYs(
        assignment=torch.stack(rows),
        grid_reused=to_device(torch.as_tensor(reuse, dtype=torch.bool), state.used.device),
    )


# ---------------------------------------------------------------------------
# the per-pod scan: one pod per step through the three tiers (the JAX
# package's solve / solve_from / _make_step)
# ---------------------------------------------------------------------------
# Kinds the fill scan and the kind scan cannot take — vocab-key groups over
# two or more keys, a key wider than KSCAN_D, an initially-empty hostname
# affinity group — place one pod at a time: tier 1 the earliest feasible
# existing node (strict Compatible), tier 2 the feasible in-flight claim
# with the fewest pods (earliest window row on ties), tier 3 a new claim of
# the first feasible template. Every candidate's combined requirements are
# narrowed by the vocab-key groups before its instance types are filtered
# (nodeclaim.go:199-213), and the winner's counts commit before the next
# pod. On CUDA a chunk of pods runs as one launch of
# perpod_scan_persistent (one block loops the chunk's steps: the pod's
# terms once, the live rows of each tier a warp each, pick and commit in
# place); `_pod_step` is its plain version.


class PodTensors(NamedTuple):
    """Per-pod rows of a chunk (the kind rows gathered by pod)."""

    reqs: ReqSetTensors  # [L, K, V] (preferences folded in)
    strict_reqs: ReqSetTensors  # [L, K, V] required-only
    requests: torch.Tensor  # [L, R] f32
    valid: torch.Tensor  # [L] bool — False on padding rows


class PodXs(NamedTuple):
    """The per-pod scan inputs, stacked over the chunk's L pods (one row
    is one step's xs in the reference)."""

    reqs: ReqSetTensors  # [L, K, V]
    requests: torch.Tensor  # [L, R]
    tmpl_ok: torch.Tensor  # [L, G]
    it_allow: torch.Tensor  # [L, T]
    exist_ok: torch.Tensor  # [L, E]
    ports: torch.Tensor  # [L, NPp] i32 packed
    port_conf: torch.Tensor  # [L, NPp] i32 packed
    vols: torch.Tensor  # [L, NVp] i32 packed
    valid: torch.Tensor  # [L]
    vg_applies: torch.Tensor  # [L, NGv]
    vg_records: torch.Tensor  # [L, NGv]
    vg_self: torch.Tensor  # [L, NGv]
    hg_applies: torch.Tensor  # [L, NGh]
    hg_records: torch.Tensor  # [L, NGh]
    hg_self: torch.Tensor  # [L, NGh]
    strict_mask: torch.Tensor  # [L, K, V]


class PerPodFlags(NamedTuple):
    """The per-pod scan's minValues and reservation flags (the reference's
    of the same names)."""

    # enforced minValues floors (Strict policy with a template carrying one)
    mv_active: bool = False
    # reserved capacity: reserve/release per claim, the strict refusals;
    # the reservation-id key and the reserved capacity type's value id
    res_active: bool = False
    res_strict: bool = False
    rid_kid: int = -1
    res_vid: int = -1


class PerPodCtx(NamedTuple):
    """The problem the per-pod step reads (never written)."""

    exist: ExistingNodes
    it: InstanceTypeTensors
    templates: Templates
    well_known: torch.Tensor  # [K]
    topo: TopologyTensors
    zone_kid: int
    ct_kid: int
    n_claims: int
    topo_kids: tuple
    # the kernel's packed type tables (ops/cuda.py perpod_tables: buffer,
    # offsets), built once per encode; None: the launch builds them
    tables: Optional[tuple] = None
    flags: PerPodFlags = PerPodFlags()


def _fits_and_offering(total, comb: ReqSetTensors, it: InstanceTypeTensors, zone_kid: int, ct_kid: int):
    """[B, T] bool — an allocatable group where total fits (zero requests
    always pass) AND an available offering in a (zone, capacity type) the
    combined requirements admit (nodeclaim.go:630-652 fits()); the
    reference's bf16 einsum is an exact boolean any here."""
    t = total[:, None, None, :]
    fit = ((t <= it.alloc[None]) | (t == 0.0)).all(dim=-1) & it.group_valid[None]
    return (fit & off_for_plain(comb.mask, it, zone_kid, ct_kid)).any(dim=-1)


def _min_values_ok(viable: torch.Tensor, mv_key_c: torch.Tensor, mv_min_c: torch.Tensor, mv_it_values: torch.Tensor):
    """[C] bool — every minValues floor of each candidate holds over its
    viable types [C, T] (SatisfiesMinValues, types.go:399-433): key -1
    counts the types, key j >= 0 the distinct values of min-keyed key j
    in the slab [T, J, V]. The reference's bf16 einsum as an exact product
    of 0/1 matrices (sums at most T, exact in f32)."""
    C, T = viable.shape
    J, V = mv_it_values.shape[1], mv_it_values.shape[2]
    present = (viable.to(F32) @ mv_it_values.reshape(T, J * V).to(F32)).reshape(C, J, V) > 0
    counts_all = present.sum(dim=-1, dtype=I32)  # [C, J]
    name_count = viable.sum(dim=-1, dtype=I32)  # [C]
    per_key = counts_all.gather(1, mv_key_c.clamp(0, J - 1).long())  # [C, M]
    cnt = torch.where(mv_key_c == -1, name_count[:, None], per_key)
    return ((mv_min_c <= 0) | (cnt >= mv_min_c)).all(dim=-1)


def _reserve_options(viable: torch.Tensor, comb_mask: torch.Tensor, res_ofs: torch.Tensor, zone_kid: int,
                    ct_kid: int, rid_kid: int, res_vid: int) -> torch.Tensor:
    """[B, RID] bool — the reserved offerings each candidate could hold over
    its viable types [B, T] (offeringsToReserve, nodeclaim.go:313-332): an
    available reserved offering [T, RID, Z] on a surviving type whose zone,
    capacity type and reservation id the combined requirements' mask
    [B, K, V] admit. The reference's bf16 einsum as an exact 0/1 product."""
    T, RID, Zr = res_ofs.shape
    B = viable.shape[0]
    per_rz = (viable.to(F32) @ res_ofs.reshape(T, RID * Zr).to(F32)).reshape(B, RID, Zr) > 0
    hit = (per_rz & comb_mask[:, zone_kid, :Zr][:, None, :]).any(dim=-1)
    return hit & comb_mask[:, rid_kid, :RID] & comb_mask[:, ct_kid, res_vid][:, None]


def _apply_topo(reqs: ReqSetTensors, upd: torch.Tensor, touched: torch.Tensor) -> ReqSetTensors:
    """AND the topology domain masks into candidate requirements: touched
    keys become concrete finite sets (requirements.Add of an In set)."""
    inf = reqs.inf & ~touched[None, :]
    return ReqSetTensors(
        mask=reqs.mask & upd,
        inf=inf,
        excl=reqs.excl & inf,
        gte=torch.where(inf, reqs.gte, torch.full_like(reqs.gte, INT_MIN)),
        lte=torch.where(inf, reqs.lte, torch.full_like(reqs.lte, INT_MAX)),
        defined=reqs.defined | touched[None, :],
    )


def _pod_eval_full(state: SolverState, x: PodXs, c: PerPodCtx):
    """Every candidate of one pod, as the reference's step computes them:
    (keys [E + W + G] i32, aux). A key is BIG for an infeasible row, else
    its tie key: the row index in tier 1, pods·W + row in tier 2, the
    template's order in tier 3. Tier precedence is the commit's."""
    exist, it, templates, topo = c.exist, c.it, c.templates, c.topo
    dev = state.used.device
    K = it.reqs.mask.shape[1]
    E, G, W = exist.avail.shape[0], templates.its.shape[0], state.open.shape[0]
    big = torch.full((), BIG, dtype=I32, device=dev)
    no_wk = torch.zeros_like(c.well_known)

    # ---- tier 1: existing nodes, strict Compatible (existingnode.go:101)
    pod_e = broadcast_set(x.reqs, E)
    comb_e = intersect_sets(state.exist_reqs, pod_e)
    exist_compat = compatible_elemwise(state.exist_reqs, pod_e, no_wk)
    total_e = state.exist_used + x.requests[None, :]
    exist_fit = ((total_e <= exist.avail) | (total_e == 0.0)).all(dim=-1)
    pre = topo_ops.vg_pod_precompute(topo, state.vg_counts, x.strict_mask, x.vg_applies, x.vg_self, K)
    topo_e, upd_e, _ = topo_ops.vg_evaluate(topo, pre, comb_e.mask)
    topo_eh = hg_evaluate(topo, state.hg_counts, torch.arange(E, dtype=I32, device=dev), x.hg_applies, x.hg_self)
    ports_ok_e = ~packed_conflict(x.port_conf[None, :], state.exist_ports)
    newv_e = state.exist_vols | x.vols[None, :]
    vcount_e = packed_count_and(newv_e[:, None, :], exist.vol_driver[None, :, :]).to(F32)
    vols_ok_e = (vcount_e <= exist.vol_limits).all(dim=-1) | ~packed_any(x.vols)
    feas_e = (
        exist.valid & x.exist_ok & exist_compat & exist_fit & topo_e & topo_eh & ports_ok_e & vols_ok_e & x.valid
    )

    # ---- tier 2: the window's in-flight claims
    pod_b = broadcast_set(x.reqs, W)
    comb = intersect_sets(state.reqs, pod_b)
    claim_ok = compatible_elemwise(state.reqs, pod_b, c.well_known)
    topo_n, upd_n, _ = topo_ops.vg_evaluate(topo, pre, comb.mask)
    topo_nh = hg_evaluate(topo, state.hg_counts, E + state.slot_of, x.hg_applies, x.hg_self)
    comb_t = _apply_topo(comb, upd_n, pre.key_touched)
    # incremental it-compat, as the reference classifies each (claim, key):
    # equal to the pod row -> the pod x type table; equal to the stored
    # claim row -> implied by state.its; a topology key -> exact; anything
    # else on a pickable claim -> the full pairwise intersects for all rows
    kid_mask = torch.zeros(K, dtype=torch.bool, device=dev)
    kid_mask[list(c.topo_kids)] = True
    eq_p = kernels.set_eq_rows(comb_t, pod_b)
    eq_c = kernels.set_eq_rows(comb_t, state.reqs)
    nonkid = ~kid_mask[None, :]
    need_exact = ~eq_p & ~eq_c & nonkid
    any_fallback = torch.any(state.open & claim_ok & need_exact.any(dim=-1))
    pod_tkok = kernels.per_key_ok_table(it.reqs, x.reqs)  # [T, K]
    viol = ((eq_p & ~eq_c & nonkid).to(F32) @ (~pod_tkok).to(F32).T) > 0.0
    fast = ~viol
    for k in c.topo_kids:
        fast = fast & kernels.per_key_ok_at(it.reqs, comb_t, k)
    it_compat = torch.where(any_fallback, kernels.intersects_plain(comb_t, it.reqs), fast)
    total = state.used + x.requests[None, :]
    fits_off = _fits_and_offering(total, comb_t, it, c.zone_kid, c.ct_kid)
    new_its = state.its & it_compat & fits_off & x.it_allow[None, :]
    tol = x.tmpl_ok[state.template.long()]
    ports_ok_n = ~packed_conflict(x.port_conf[None, :], state.claim_ports)
    feas = state.open & claim_ok & tol & topo_n & topo_nh & ports_ok_n & new_its.any(dim=-1) & x.valid
    tmpl_c = state.template.long()
    if c.flags.mv_active:
        feas = feas & _min_values_ok(new_its, templates.mv_key[tmpl_c], templates.mv_min[tmpl_c],
                                     templates.mv_it_values)
    if c.flags.res_active:
        ofs_c = _reserve_options(new_its, comb_t.mask, it.res_ofs, c.zone_kid, c.ct_kid, c.flags.rid_kid,
                                 c.flags.res_vid)
        to_res = ofs_c & (state.held | (state.res_cap > 0)[None, :])
        if c.flags.res_strict:
            # strict (scheduler.go:75-78): refuse an add when compatible
            # reserved offerings exist but none can be held, or when it
            # would drop the claim's reservations
            feas = feas & ~((ofs_c.any(dim=-1) | state.held.any(dim=-1)) & ~to_res.any(dim=-1))
    else:
        to_res = state.held

    # ---- tier 3: a new claim per template; hostname groups read the
    # fresh slot E + n_open (hg_counts keeps a spare column past the cap)
    pod_g = broadcast_set(x.reqs, G)
    comb0 = intersect_sets(templates.reqs, pod_g)
    tmpl_compat = compatible_elemwise(templates.reqs, pod_g, c.well_known)
    topo_g, upd_g, _ = topo_ops.vg_evaluate(topo, pre, comb0.mask)
    topo_gh = hg_evaluate(topo, state.hg_counts, (E + state.n_open).reshape(1).expand(G), x.hg_applies, x.hg_self)
    comb0_t = _apply_topo(comb0, upd_g, pre.key_touched)
    it_compat0 = kernels.intersects_plain(comb0_t, it.reqs)  # [G, T]
    total0 = templates.daemon_requests + x.requests[None, :]
    fits_off0 = _fits_and_offering(total0, comb0_t, it, c.zone_kid, c.ct_kid)
    cap_ok = (it.cap[None, :, :] <= state.budget[:, None, :]).all(dim=-1)  # NodePool limits
    its0 = templates.its & it_compat0 & fits_off0 & x.it_allow[None, :] & cap_ok
    tmpl_feas = (
        templates.valid & tmpl_compat & x.tmpl_ok & topo_g & topo_gh & its0.any(dim=-1)
        & (state.nodes_budget >= 1.0) & x.valid
    )
    if c.flags.mv_active:
        tmpl_feas = tmpl_feas & _min_values_ok(its0, templates.mv_key, templates.mv_min, templates.mv_it_values)
    if c.flags.res_active:
        ofs0 = _reserve_options(its0, comb0_t.mask, it.res_ofs, c.zone_kid, c.ct_kid, c.flags.rid_kid,
                                 c.flags.res_vid)
        to_res0 = ofs0 & (state.res_cap > 0)[None, :]
        if c.flags.res_strict:
            tmpl_feas = tmpl_feas & ~(ofs0.any(dim=-1) & ~to_res0.any(dim=-1))
    else:
        to_res0 = torch.zeros((G, state.held.shape[1]), dtype=torch.bool, device=dev)
    order_g = torch.arange(G, dtype=I32, device=dev) if templates.rank is None else templates.rank

    keys = torch.cat([
        torch.where(feas_e, torch.arange(E, dtype=I32, device=dev), big),
        torch.where(feas, state.pods * W + torch.arange(W, dtype=I32, device=dev), big),
        torch.where(tmpl_feas, order_g, big),
    ])
    aux = dict(
        comb_e_t=_apply_topo(comb_e, upd_e, pre.key_touched), total_e=total_e, comb_t=comb_t,
        new_its=new_its, total=total, comb0_t=comb0_t, its0=its0, any_fallback=any_fallback,
        to_res=to_res, to_res0=to_res0,
    )
    return keys, aux


def _pod_commit(state: SolverState, x: PodXs, c: PerPodCtx, keys: torch.Tensor, aux: dict):
    """Pick and commit (the reference's merge of the three tiers and its
    carry update): tier 1 beats tier 2 beats tier 3, each the least key
    (first index on ties). Returns (state', assignment [] i32)."""
    exist, it, templates, topo = c.exist, c.it, c.templates, c.topo
    dev = state.used.device
    E, G, W = exist.avail.shape[0], templates.its.shape[0], state.open.shape[0]
    NCAP = c.n_claims
    ke, kn, kg = keys[:E], keys[E:E + W], keys[E + W:]
    pick_e = torch.argmin(ke)
    found_e = ke[pick_e] < BIG
    pick = torch.argmin(kn)
    found = (kn[pick] < BIG) & ~found_e
    g = torch.argmin(kg)
    any_template = (kg[g] < BIG) & x.valid & ~found_e & ~found
    can_open = any_template & (state.w_open < W) & (state.n_open < NCAP)
    # a refusal with global capacity left is a WINDOW spill
    spilled = any_template & ~can_open & (state.n_open < NCAP)

    gslot = torch.where(found, state.slot_of[pick], state.n_open)
    slot = torch.where(found_e, pick_e.to(I32), E + gslot)
    place = found_e | found | can_open
    assignment = torch.where(
        place, slot, torch.where(any_template, _i32(NO_ROOM, dev), _i32(NO_CLAIM, dev))
    )

    # existing node (its topology-narrowed requirements are stored)
    comb_e_t = aux["comb_e_t"]
    win_e = take_set(comb_e_t, pick_e)
    new_exist_reqs = select_set(found_e, kernels.update_set_at(state.exist_reqs, pick_e, win_e), state.exist_reqs)
    new_exist_used = state.exist_used.clone()
    new_exist_used[pick_e] = torch.where(found_e, aux["total_e"][pick_e], state.exist_used[pick_e])
    new_exist_ports = state.exist_ports.clone()
    new_exist_ports[pick_e] = torch.where(found_e, state.exist_ports[pick_e] | x.ports, state.exist_ports[pick_e])
    new_exist_vols = state.exist_vols.clone()
    new_exist_vols[pick_e] = torch.where(found_e, state.exist_vols[pick_e] | x.vols, state.exist_vols[pick_e])

    # claim (tier 2 or 3); cslot is out of range only when nothing commits
    upd_claim = (found | can_open) & ~found_e
    opened = can_open & ~found
    cslot = torch.clamp(torch.where(found, pick.to(I32), state.w_open), max=W - 1).long()
    sel_reqs = select_set(found, take_set(aux["comb_t"], pick), take_set(aux["comb0_t"], g))
    sel_its = torch.where(found, aux["new_its"][pick], aux["its0"][g])
    sel_used = torch.where(found, aux["total"][pick], templates.daemon_requests[g] + x.requests)
    sel_template = torch.where(found, state.template[pick], g.to(I32))
    final_reqs = select_set(found_e, win_e, sel_reqs)
    new_vg = torch.where(
        place, topo_ops.vg_commit(topo, state.vg_counts, final_reqs.mask, final_reqs.inf, x.vg_records),
        state.vg_counts,
    )
    new_hg = torch.where(place, hg_commit(state.hg_counts, slot, x.hg_records, topo.hg_valid), state.hg_counts)

    def put(t, v, pred=upd_claim):
        out = t.clone()
        out[cslot] = torch.where(pred, v, t[cslot])
        return out

    new_reqs = select_set(upd_claim, kernels.update_set_at(state.reqs, cslot, sel_reqs), state.reqs)
    opened_i = opened.to(I32)
    new_w_open = state.w_open + opened_i

    # limits bookkeeping on open: the max capacity over the claim's viable
    # types (scheduler.go:791 subtractMax); inf budgets stay inf
    max_cap = torch.where(aux["its0"][g][:, None], it.cap, torch.full_like(it.cap, float("-inf"))).max(dim=0).values
    max_cap = torch.where(torch.isfinite(max_cap), max_cap, torch.zeros_like(max_cap))
    new_budget = state.budget.clone()
    new_budget[g] = torch.where(opened, state.budget[g] + -max_cap, state.budget[g])
    new_nodes_budget = state.nodes_budget.clone()
    new_nodes_budget[g] = torch.where(opened, state.nodes_budget[g] + -1.0, state.nodes_budget[g])

    # reserved capacity: hold the winner's options, taking newly held ids
    # from the capacity and returning dropped ones (nodeclaim.go:260-262)
    new_res_cap, new_held = state.res_cap, state.held
    if c.flags.res_active:
        sel_res = torch.where(found, aux["to_res"][pick], aux["to_res0"][g])
        prev_res = found & state.held[pick]
        delta = (prev_res & ~sel_res).to(I32) - (sel_res & ~prev_res).to(I32)
        new_res_cap = torch.where(upd_claim, state.res_cap + delta, state.res_cap)
        new_held = put(state.held, sel_res)

    return state._replace(
        exist_reqs=new_exist_reqs,
        exist_used=new_exist_used,
        reqs=new_reqs,
        used=put(state.used, sel_used),
        its=put(state.its, sel_its),
        template=put(state.template, sel_template),
        open=put(state.open, torch.ones((), dtype=torch.bool, device=dev)),
        pods=put(state.pods, state.pods[cslot] + 1),
        n_open=state.n_open + opened_i,
        slot_of=put(state.slot_of, state.n_open, opened),
        w_open=new_w_open,
        w_hw=torch.maximum(state.w_hw, new_w_open),
        spills=state.spills + spilled.to(I32),
        budget=new_budget,
        nodes_budget=new_nodes_budget,
        vg_counts=new_vg,
        hg_counts=new_hg,
        exist_ports=new_exist_ports,
        claim_ports=put(state.claim_ports, state.claim_ports[cslot] | x.ports),
        exist_vols=new_exist_vols,
        res_cap=new_res_cap,
        held=new_held,
    ), assignment


def _pod_step(state: SolverState, x: PodXs, c: PerPodCtx):
    """One pod through the three tiers (the reference's _make_step step):
    every candidate's key, then the pick and commit."""
    keys, aux = _pod_eval_full(state, x, c)
    return _pod_commit(state, x, c, keys, aux)


def pod_xs(pods: PodTensors, tmpl_ok, it_allow, exist_ok, ports, port_conf, vols, pod_topo) -> PodXs:
    """The chunk's scan inputs (the reference's _xs)."""
    return PodXs(
        reqs=pods.reqs, requests=pods.requests, tmpl_ok=tmpl_ok, it_allow=it_allow, exist_ok=exist_ok,
        ports=ports, port_conf=port_conf, vols=vols, valid=pods.valid,
        vg_applies=pod_topo.vg_applies, vg_records=pod_topo.vg_records, vg_self=pod_topo.vg_self,
        hg_applies=pod_topo.hg_applies, hg_records=pod_topo.hg_records, hg_self=pod_topo.hg_self,
        strict_mask=pod_topo.strict_mask,
    )


# the carry fields a per-pod step writes (the kernels update them in place)
PERPOD_WRITES = (
    "exist_reqs", "exist_used", "reqs", "used", "its", "template", "open", "pods", "n_open", "slot_of",
    "w_open", "w_hw", "spills", "budget", "nodes_budget", "vg_counts", "hg_counts", "exist_ports",
    "claim_ports", "exist_vols", "res_cap", "held",
)


def own_perpod_writes(state: SolverState) -> SolverState:
    """The state with private copies of every field the kernels write, so
    an in-place chunk leaves the caller's state (and the problem tensors
    that the initial state aliases) untouched."""

    def own(v):
        if isinstance(v, ReqSetTensors):
            return ReqSetTensors(*(t.clone(memory_format=torch.contiguous_format) for t in v))
        return v.clone(memory_format=torch.contiguous_format)

    return state._replace(**{f: own(getattr(state, f)) for f in PERPOD_WRITES})


def perpod_loop_plain(state: SolverState, xs: PodXs, c: PerPodCtx):
    """The chunk as a Python loop of `_pod_step` (functional)."""
    out = []
    for i in range(xs.requests.shape[0]):
        state, a = _pod_step(state, _take_x(xs, i), c)
        out.append(a)
    return state, (torch.stack(out) if out else torch.zeros(0, dtype=I32, device=state.used.device))


def perpod_loop_kernels(state: SolverState, xs: PodXs, c: PerPodCtx):
    """The chunk as one launch of perpod_scan_persistent. The kernel
    updates the carry in place (the JAX package's scan cannot), into
    private copies of the fields it writes."""
    state = own_perpod_writes(state)
    return state, cuda.perpod_scan(state, xs, c)


def perpod_steps(state: SolverState, xs: PodXs, c: PerPodCtx, lo: int, hi: int):
    """Steps lo .. hi - 1 of the chunk: (state', assignment [hi - lo] i32)
    — one kernel launch on CUDA, into private copies of the written
    fields; the plain step in a Python loop on the CPU."""
    if state.used.device.type == "cpu":
        return perpod_loop_plain(state, _take_x(xs, slice(lo, hi)), c)
    state = own_perpod_writes(state)
    return state, cuda.perpod_steps(state, xs, c, lo, hi)[lo:hi]


def solve_from(
    state: SolverState,
    pods: PodTensors,
    pod_tmpl_ok: torch.Tensor,  # [L, G] bool
    pod_it_allow: torch.Tensor,  # [L, T] bool
    pod_exist_ok: torch.Tensor,  # [L, E] bool
    pod_ports: torch.Tensor,  # [L, NPp] i32 packed
    pod_port_conf: torch.Tensor,  # [L, NPp] i32 packed
    pod_vols: torch.Tensor,  # [L, NVp] i32 packed
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    pod_topo: topo_ops.PodTopology,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    topo_kids: tuple = (),
    plain: bool = False,
    tables: Optional[tuple] = None,
    flags: PerPodFlags = PerPodFlags(),
) -> tuple[SolverState, torch.Tensor]:
    """Resume the per-pod scan from `state` over a chunk of L pod rows;
    returns (state', assignment [L] i32: E-space slot, NO_ROOM or
    NO_CLAIM). The input state is not modified. On CUDA (plain=False) the
    chunk runs as one kernel launch, with no host sync, reading the type
    tables packed in `tables` (cuda.perpod_tables of it and templates;
    None: the launch packs them); on the CPU, or with plain=True,
    `_pod_step` loops in Python. `flags` turn on the minValues floors and
    the reservations (PerPodFlags)."""
    xs = pod_xs(pods, pod_tmpl_ok, pod_it_allow, pod_exist_ok, pod_ports, pod_port_conf, pod_vols, pod_topo)
    ctx = PerPodCtx(exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims, tuple(topo_kids), tables,
                    flags)
    if plain or state.used.device.type == "cpu":
        return perpod_loop_plain(state, xs, ctx)
    return perpod_loop_kernels(state, xs, ctx)


def solve(
    pods: PodTensors, pod_tmpl_ok, pod_it_allow, pod_exist_ok, pod_ports, pod_port_conf, pod_vols,
    exist: ExistingNodes, it: InstanceTypeTensors, templates: Templates, well_known, topo: TopologyTensors,
    pod_topo, zone_kid: int, ct_kid: int, n_claims: int, topo_kids: tuple = (), window: int = 0,
    plain: bool = False, res_cap0=None, tables: Optional[tuple] = None, flags: PerPodFlags = PerPodFlags(),
) -> tuple[SolverState, torch.Tensor]:
    """initial_state followed by solve_from (the reference's solve)."""
    state = initial_state(
        exist, it, templates, topo, n_claims, pod_ports.shape[1], res_cap0, window=window, topo_kids=topo_kids,
    )
    return solve_from(
        state, pods, pod_tmpl_ok, pod_it_allow, pod_exist_ok, pod_ports, pod_port_conf, pod_vols,
        exist, it, templates, well_known, topo, pod_topo, zone_kid, ct_kid, n_claims, topo_kids, plain, tables, flags,
    )


# ---------------------------------------------------------------------------
# batched consolidation what-ifs (the JAX package's solve_whatif)
# ---------------------------------------------------------------------------


def stack_scenarios(state: SolverState, S: int, vg_counts0: torch.Tensor, hg_counts0: torch.Tensor) -> SolverState:
    """`state` with every field the per-pod step writes stacked on a
    leading scenario axis of S private copies, the topology counts taken
    from the per-scenario seeds [S, NGv, V] / [S, NGh, Sl]; the fields the
    step never writes (the bank) stay shared."""

    def rep(t):
        return t.unsqueeze(0).expand((S,) + tuple(t.shape)).contiguous()

    out = {}
    for f in PERPOD_WRITES:
        v = getattr(state, f)
        out[f] = ReqSetTensors(*(rep(t) for t in v)) if isinstance(v, ReqSetTensors) else rep(v)
    out["vg_counts"] = vg_counts0.to(I32).clone(memory_format=torch.contiguous_format)
    out["hg_counts"] = hg_counts0.to(I32).clone(memory_format=torch.contiguous_format)
    return state._replace(**out)


def scenario_state(state: SolverState, s: int) -> SolverState:
    """Scenario s of a stacked state (views)."""
    return state._replace(**{
        f: (ReqSetTensors(*(t[s] for t in v)) if isinstance(v, ReqSetTensors) else v[s])
        for f, v in ((f, getattr(state, f)) for f in PERPOD_WRITES)
    })


def whatif_loop_plain(state0, xs: PodXs, ctx: PerPodCtx, idx, valid, exist_valid, vg0, hg0):
    """The plain per-pod loop once per scenario, each from state0 with its
    own topology seeds, surviving nodes and pod rows xs[idx[s]] (valid
    rows valid[s]): ([S, L] assignment, the final carry of each scenario)."""
    rows, states = [], []
    for s in range(idx.shape[0]):
        c = ctx._replace(exist=ctx.exist._replace(valid=exist_valid[s]),
                         topo=ctx.topo._replace(vg_counts0=vg0[s], hg_counts0=hg0[s]))
        st = state0._replace(vg_counts=vg0[s], hg_counts=hg0[s])
        st, a = perpod_loop_plain(st, _take_x(xs, idx[s])._replace(valid=valid[s]), c)
        states.append(st)
        rows.append(a)
    return torch.stack(rows), states


def whatif_loop_kernels(state0, xs: PodXs, ctx: PerPodCtx, idx, valid, exist_valid, vg0, hg0):
    """All scenarios in one launch of the per-pod kernel in scenario mode
    (one block per scenario), into a stacked carry (stack_scenarios); the
    same outputs as whatif_loop_plain (the final carries are views of the
    stacked one)."""
    S = idx.shape[0]
    stacked = stack_scenarios(state0, S, vg0, hg0)
    assignment = cuda.perpod_whatif(
        stacked, xs, ctx, idx.to(I32).contiguous(), valid.contiguous(), exist_valid.contiguous(),
    )
    return assignment, [scenario_state(stacked, s) for s in range(S)]


def solve_whatif_full(
    scen_pod_idx: torch.Tensor,  # [S, L] i32 — this scenario's pods (rows of the union)
    scen_active: torch.Tensor,  # [S, L] bool — real entries (False = padding)
    scen_count: torch.Tensor,  # [S, L] bool — pods whose failure counts (displaced)
    scen_exist_valid: torch.Tensor,  # [S, E] bool — per-scenario surviving nodes
    scen_vg_counts0: torch.Tensor,  # [S, NGv, V] i32 — per-scenario topology seeds
    scen_hg_counts0: torch.Tensor,  # [S, NGh, Sl] i32
    pods: PodTensors,
    pod_tmpl_ok: torch.Tensor,
    pod_it_allow: torch.Tensor,
    pod_exist_ok: torch.Tensor,
    pod_ports: torch.Tensor,
    pod_port_conf: torch.Tensor,
    pod_vols: torch.Tensor,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    pod_topo: topo_ops.PodTopology,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    topo_kids: tuple = (),
    window: int = 0,
    plain: bool = False,
    tables: Optional[tuple] = None,
    res_cap0=None,
    flags: PerPodFlags = PerPodFlags(),
):
    """solve_whatif with everything it computes: (n_unsched [S] i32,
    n_open [S] i32, assignment [S, L] i32, the final carry of each
    scenario). The plain path runs the plain per-pod loop once per
    scenario, each from its own initial state (what jax.vmap of the
    reference's `one` computes: the reservation capacities res_cap0 and
    the held rows start afresh in every scenario); on CUDA (plain=False)
    all S scenarios run in one launch of the per-pod kernel in scenario
    mode, with no host sync (`tables` and the flags as solve_from's)."""
    idx = scen_pod_idx.long()
    valid = pods.valid[idx] & scen_active  # [S, L]
    xs = pod_xs(pods, pod_tmpl_ok, pod_it_allow, pod_exist_ok, pod_ports, pod_port_conf, pod_vols, pod_topo)
    ctx = PerPodCtx(exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims, tuple(topo_kids), tables,
                    flags)
    state0 = initial_state(exist, it, templates, topo, n_claims, pod_ports.shape[1], res_cap0, window=window,
                           topo_kids=topo_kids)
    loop = whatif_loop_plain if plain or valid.device.type == "cpu" else whatif_loop_kernels
    assignment, states = loop(state0, xs, ctx, idx, valid, scen_exist_valid, scen_vg_counts0, scen_hg_counts0)
    n_open = torch.stack([st.n_open for st in states])
    n_unsched = (scen_count & valid & (assignment < 0)).sum(dim=1, dtype=I32)
    return n_unsched, n_open, assignment, states


def solve_whatif(*args, **kwargs) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched consolidation what-ifs (the reference's solve_whatif,
    solver.py:1120-1205): S disruption scenarios over one encoded union
    problem, each a per-pod scan over its own compact pod list against its
    own surviving nodes and topology count seeds. Arguments as
    solve_whatif_full; returns per scenario (n_unsched [S] i32 — failures
    among the pods the scenario counts, n_open [S] i32 — new claims)."""
    n_unsched, n_open, _assignment, _states = solve_whatif_full(*args, **kwargs)
    return n_unsched, n_open


# ---------------------------------------------------------------------------
# gangs: all-or-nothing slice placement (the JAX package's solve_gang /
# _make_gang_step)
# ---------------------------------------------------------------------------
# One segment per gang, pods in rank order. The slice shape is closed
# form: the chosen template's per-host fill f (the fill step's tier-3 cap),
# then want = ceil(count / f) hosts. The hosts' rank blocks j = 0 .. want-1
# are evaluated in order on fresh hostname slots E + n_open + j: the
# hostname groups at the slot, and under ONE narrow vocab key the kind
# scan's group rules (vg_eval_plain) against counts fixed within a block;
# each block's remaining types feed its bank row and its budget debit.
# Any failing block spills the whole gang. A placed gang writes its hosts
# straight into the frozen bank (rows n_open + j: dedicated claims that no
# later pod shares; slot_of and w_open do not move), charges budget[g]
# once with the summed per-block debits, nodes_budget[g] with want, and
# commits the counts. On CUDA one launch of gang_scan (H9) walks the
# run's segments; `_gang_step` is its plain version.

GANG_SPILL = -3  # a constraint no claims-axis escalation fixes (node budget, a refused rank block)


class GangYs(NamedTuple):
    """Per-gang segment record (the decode expands the rank blocks)."""

    open_g: torch.Tensor  # [] i32 — first global claim id of the slice
    n_opened: torch.Tensor  # [] i32 — hosts opened (0 = the gang did not place)
    fill: torch.Tensor  # [] i32 — pods per host (the last host takes the rest)
    tmpl: torch.Tensor  # [] i32 — slice template (-1 = none)
    leftover: torch.Tensor  # [] i32 — 0 (placed) or the whole gang
    status: torch.Tensor  # [] i32 — NO_CLAIM / NO_ROOM / GANG_SPILL (NO_ROOM when placed)


def _gang_offd(it: InstanceTypeTensors, off_g: torch.Tensor, cmask: torch.Tensor, key_kid: int,
               zone_kid: int, D: int) -> torch.Tensor:
    """[D, T, GR] bool — an available offering exists if the block lands
    in domain d: for the zone key the offerings of zone d in the admitted
    capacity types, for another key the template's offering mask."""
    T, GR, Z, C = it.zc_avail.shape
    if key_kid != zone_kid:
        return off_g[None].expand(D, T, GR)
    if D > Z:
        raise ValueError(f"solve_gang: zone key with D={D} > Z={Z}")
    return (it.zc_avail[:, :, :D, :] & cmask[None, None, None, :C]).any(dim=-1).permute(2, 0, 1)


def _gang_step(
    state: SolverState,
    x: KindXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    maxg: int,
    key_kid: int,
    D: int,
    tk_idx: int,
) -> tuple[SolverState, GangYs]:
    """One gang segment (the reference's `_make_gang_step` step), plain."""
    dev = state.used.device
    NCAP = n_claims
    G, T = templates.its.shape
    E = exist.avail.shape[0]
    has_key = key_kid >= 0
    count = x.count
    requests = x.requests
    R = requests.shape[0]
    self_conf = packed_conflict(x.ports, x.port_conf)
    gate = x.vg_applies & topo.vg_valid
    recs = x.vg_records & topo.vg_valid
    rec_h = x.hg_records & topo.hg_valid
    key_touched = torch.any(gate)
    is_anti = topo.vg_type == TYPE_ANTI
    zero = torch.zeros((), dtype=I32, device=dev)

    # the slice template: the fill step's tier 3 (topology is never read
    # here: a template whose blocks fail on topology spills the gang)
    pod_g = broadcast_set(x.reqs, G)
    comb0 = intersect_sets(templates.reqs, pod_g)
    tmpl_compat = compatible_elemwise(templates.reqs, pod_g, well_known)
    it_compat0 = kernels.intersects_plain(comb0, it.reqs)  # [G, T]
    off_g = off_for_plain(comb0.mask, it, zone_kid, ct_kid)  # [G, T, GR]
    daemon = templates.daemon_requests
    fits_off0 = fits_off_counted_plain(daemon, torch.ones(G, dtype=I32, device=dev), requests, it, off_g)
    cap_ok = torch.all(it.cap[None, :, :] <= state.budget[:, None, :], dim=-1)
    its0 = templates.its & it_compat0 & fits_off0 & x.it_allow[None, :] & cap_ok
    tmpl_feas = (
        templates.valid & tmpl_compat & x.tmpl_ok & torch.any(its0, dim=-1) & (state.nodes_budget >= 1.0)
    )
    g = _pick_template(tmpl_feas, templates)
    any_t = torch.any(tmpl_feas) & (count > 0)

    # the slice shape: per-host capacity f, want = ceil(count / f) hosts
    f0 = claim_fill_caps_plain(daemon, its0, requests, it, off_g)[g]
    f = torch.where(self_conf, torch.clamp(f0, max=1), f0)
    f = torch.where(any_t, torch.clamp(f, min=0), zero)
    want = torch.where(f > 0, torch.div(count + f - 1, torch.clamp(f, min=1), rounding_mode="floor"), zero)
    avail_cap = torch.clamp(NCAP - state.n_open, min=0)
    budget_ok = state.nodes_budget[g] >= want.to(F32)
    shaped = any_t & (f > 0)
    try_place = shaped & (want <= avail_cap) & budget_ok

    j = torch.arange(maxg, dtype=I32, device=dev)
    c_j = torch.minimum(torch.clamp(count - j * f, min=0), f)  # [maxg] pods on host j
    used_j = _madd(daemon[g][None, :], c_j[:, None], requests[None, :])
    its0_g = its0[g]

    # the rank blocks: block j lands on a fresh hostname with counts fixed
    # within the block (records land after the block's add loop)
    if has_key:
        pd = x.strict_mask[key_kid, :D]
        eval_candidates = vg_eval_plain(topo, gate, x.vg_self, pd, D)
        admit = kscan_admit(it, key_kid, D)
        grid_row = cap_res_grid_plain(daemon[g][None], requests, it)[0]  # [T, GR]
        offd = _gang_offd(it, off_g[g], comb0.mask[g, ct_kid], key_kid, zone_kid, D)
        capTd = torch.where(offd, grid_row[None], torch.zeros_like(grid_row)[None]).amax(dim=-1).T  # [T, D]
        z0 = comb0.mask[g, key_kid, :D]
        win_zinf = comb0.inf[g, key_kid] & ~key_touched
    else:
        fits_legacy = fits_off_counted_plain(
            daemon[g][None, :], c_j, requests, it, off_g[g][None].expand((maxg,) + tuple(off_g.shape[1:]))
        )  # [maxg, T]

    cnt = state.vg_counts[:, :D].clone()
    hgc = state.hg_counts.clone()
    S = hgc.shape[1]
    ok = torch.ones((), dtype=torch.bool, device=dev)
    its_b = torch.zeros((maxg, T), dtype=torch.bool, device=dev)
    z_b = torch.zeros((maxg, D), dtype=torch.bool, device=dev)
    debit = torch.zeros(R, dtype=F32, device=dev)
    neg_inf = torch.full_like(it.cap, float("-inf"))
    for jj in range(maxg):
        active = try_place & (jj < want)
        cj = torch.minimum(torch.clamp(count - jj * f, min=0), f)
        # the block's slot; past the hostname slots only when inactive
        slot = torch.clamp(E + state.n_open + jj, max=S - 1).reshape(1)
        hg_ok = hg_evaluate(topo, hgc, slot, x.hg_applies, x.hg_self)[0]
        if has_key:
            feas, newz = eval_candidates(z0[None], cnt)
            zj = newz[0]
            compat_j = torch.where(key_touched, torch.any(zj[None, :] & admit, dim=-1), True)
            fits_j = torch.any(zj[None, :] & (capTd >= cj), dim=-1)
            its_j = its0_g & compat_j & fits_j
            vg_ok = feas[0]
        else:
            zj = torch.zeros(D, dtype=torch.bool, device=dev)
            its_j = its0_g & fits_legacy[jj]
            vg_ok = torch.ones((), dtype=torch.bool, device=dev)
        blk_ok = vg_ok & hg_ok & torch.any(its_j)
        commit = active & blk_ok & ok
        if has_key:
            single = zj.sum(dtype=I32) == 1
            do = recs & ~win_zinf & (is_anti | single)
            cnt = torch.where(commit, cnt + (do[:, None] & zj[None, :]).to(I32) * cj, cnt)
        hgc2 = hgc.clone()
        hgc2[:, slot.long()] += torch.where(rec_h, cj, zero)[:, None].to(hgc.dtype)
        hgc = torch.where(commit, hgc2, hgc)
        # the block's budget debit over its remaining types (subtractMax
        # per opened claim)
        max_cap_j = torch.where(its_j[:, None], it.cap, neg_inf).amax(dim=0)
        max_cap_j = torch.where(torch.isfinite(max_cap_j), max_cap_j, torch.zeros_like(max_cap_j))
        ok = ok & (blk_ok | ~active)
        its_b[jj] = its_j
        z_b[jj] = zj
        debit = torch.where(commit, debit + max_cap_j, debit)
    placed = try_place & ok

    # NO_ROOM: bound by the claims axis (solve escalates it); GANG_SPILL:
    # the nodes budget, or a rank block refused
    status = torch.where(
        shaped & ~budget_ok,
        torch.full_like(zero, GANG_SPILL),
        torch.where(
            try_place & ~ok,
            torch.full_like(zero, GANG_SPILL),
            torch.where(shaped, torch.full_like(zero, NO_ROOM), torch.full_like(zero, NO_CLAIM)),
        ),
    )

    # the atomic commit: block j -> global claim n_open + j, straight into
    # the frozen bank (the reference's scatter to NCAP with mode="drop" is
    # a mask of the active rows here)
    rows = placed & (j < want)
    gid = (state.n_open + j)[rows].long()
    opened = torch.where(placed, want, zero)
    g32 = g.to(I32)
    bank_frozen = state.bank_frozen.clone()
    bank_template = state.bank_template.clone()
    bank_its = state.bank_its.clone()
    bank_used = state.bank_used.clone()
    bank_frozen[gid] = True
    bank_template[gid] = g32
    bank_its[gid] = its_b[rows]
    bank_used[gid] = used_j[rows]
    bank_tk = {}
    if tk_idx >= 0:
        V = comb0.mask.shape[2]
        tk_rows = torch.cat([z_b, comb0.mask[g, key_kid, D:][None].expand(maxg, V - D)], dim=1)
        tk_mask = state.bank_tk_mask.clone()
        tk_inf = state.bank_tk_inf.clone()
        tk_def = state.bank_tk_def.clone()
        tk_mask[gid, tk_idx] = tk_rows[rows]
        tk_inf[gid, tk_idx] = win_zinf
        tk_def[gid, tk_idx] = comb0.defined[g, key_kid] | key_touched
        bank_tk = dict(bank_tk_mask=tk_mask, bank_tk_inf=tk_inf, bank_tk_def=tk_def)
    budget = state.budget.clone()
    budget[g] = budget[g] + -torch.where(placed, debit, torch.zeros_like(debit))
    nodes_budget = state.nodes_budget.clone()
    nodes_budget[g] = nodes_budget[g] + -opened.to(F32)
    vg_counts = state.vg_counts.clone()
    vg_counts[:, :D] = torch.where(placed, cnt, state.vg_counts[:, :D])
    new_state = state._replace(
        bank_frozen=bank_frozen,
        bank_template=bank_template,
        bank_its=bank_its,
        bank_used=bank_used,
        n_open=state.n_open + opened,
        budget=budget,
        nodes_budget=nodes_budget,
        vg_counts=vg_counts,
        hg_counts=torch.where(placed, hgc, state.hg_counts),
        **bank_tk,
    )
    ys = GangYs(
        open_g=state.n_open.clone(),
        n_opened=opened,
        fill=f,
        tmpl=torch.where(placed, g32, torch.full_like(zero, -1)),
        leftover=torch.where(placed, zero, count),
        status=status,
    )
    return new_state, ys


class GangPre(NamedTuple):
    """gang_scan's state-free per-segment inputs (`gang_precompute`), B
    segments: nothing here reads the carry."""

    its_base: torch.Tensor  # [B, G, T] bool — templates.its & it_compat0 & it_allow
    tmpl_base: torch.Tensor  # [B, G] bool — valid & tmpl_compat & tmpl_ok
    zmask: torch.Tensor  # [B, G, Z] bool — template ∩ pod zone rows
    cmask: torch.Tensor  # [B, G, C] bool — template ∩ pod capacity-type rows
    requests: torch.Tensor  # [B, R] f32
    count: torch.Tensor  # [B] i32
    self_conf: torch.Tensor  # [B] bool
    zinf: torch.Tensor  # [B, G] bool — the key row's complement bit
    zdef: torch.Tensor  # [B, G] bool
    kmask: torch.Tensor  # [B, G, V] bool — the key row (its first D values: the domains)
    pd: torch.Tensor  # [B, D] bool — strict domain mask
    key_touched: torch.Tensor  # [B] bool
    gate: torch.Tensor  # [B, NGv] bool
    recs: torch.Tensor  # [B, NGv] bool
    vg_self: torch.Tensor  # [B, NGv] bool
    hg_applies: torch.Tensor  # [B, NGh] bool
    hg_rec: torch.Tensor  # [B, NGh] bool — records & valid
    hg_self: torch.Tensor  # [B, NGh] bool
    admit: torch.Tensor  # [T, D] bool


def gang_precompute(xs: KindXs, it: InstanceTypeTensors, templates: Templates, well_known, topo: TopologyTensors,
                    zone_kid: int, ct_kid: int, key_kid: int, D: int) -> GangPre:
    """The per-segment terms of the gang step that read no carry, batched
    over the B segments: template ∩ pod (H1 for the type compatibility),
    the template gates, the offering rows, and the key's rows."""
    B = xs.count.shape[0]
    G, T = templates.its.shape
    K, V = templates.reqs.mask.shape[1], templates.reqs.mask.shape[2]
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]

    tm = ReqSetTensors(*(c[None].expand((B,) + tuple(c.shape)).reshape((B * G,) + tuple(c.shape[1:]))
                         for c in templates.reqs))
    pod = ReqSetTensors(*(c[:, None].expand((B, G) + tuple(c.shape[1:])).reshape((B * G,) + tuple(c.shape[1:]))
                          for c in xs.reqs))
    comb0 = intersect_sets(tm, pod)
    tmpl_compat = compatible_elemwise(tm, pod, well_known).reshape(B, G)
    it_compat0 = kernels.intersects(ReqSetTensors(*(c.contiguous() for c in comb0)), it.reqs).reshape(B, G, T)
    mask = comb0.mask.reshape(B, G, K, V)
    gate = xs.vg_applies & topo.vg_valid[None]
    has_key = key_kid >= 0
    kk = key_kid if has_key else 0
    dd = D if has_key else 1
    return GangPre(
        its_base=(templates.its[None] & it_compat0 & xs.it_allow[:, None, :]).contiguous(),
        tmpl_base=(templates.valid[None] & tmpl_compat & xs.tmpl_ok).contiguous(),
        zmask=mask[:, :, zone_kid, :Z].contiguous(),
        cmask=mask[:, :, ct_kid, :C].contiguous(),
        requests=xs.requests.contiguous(),
        count=xs.count.contiguous(),
        self_conf=packed_conflict(xs.ports, xs.port_conf).contiguous(),
        zinf=comb0.inf.reshape(B, G, K)[:, :, kk].contiguous(),
        zdef=comb0.defined.reshape(B, G, K)[:, :, kk].contiguous(),
        kmask=mask[:, :, kk, :].contiguous(),
        pd=xs.strict_mask[:, kk, :dd].contiguous(),
        key_touched=torch.any(gate, dim=-1).contiguous(),
        gate=gate.contiguous(),
        recs=(xs.vg_records & topo.vg_valid[None]).contiguous(),
        vg_self=xs.vg_self.contiguous(),
        hg_applies=xs.hg_applies.contiguous(),
        hg_rec=(xs.hg_records & topo.hg_valid[None]).contiguous(),
        hg_self=xs.hg_self.contiguous(),
        admit=kscan_admit(it, kk, dd).contiguous(),
    )


GANG_WRITES = ("n_open", "budget", "nodes_budget", "vg_counts", "hg_counts", "bank_frozen", "bank_template",
               "bank_its", "bank_used", "bank_tk_mask", "bank_tk_inf", "bank_tk_def")


def solve_gang(
    state: SolverState,
    xs: KindXs,
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    maxg: int,
    key_kid: int = -1,
    n_domains: int = 1,
    tk_idx: int = -1,
    plain: bool = False,
) -> tuple[SolverState, GangYs]:
    """Gang-atomic slice placement over the B gang segments of xs (one
    segment per gang, pods in rank order; count 0 pads), threading the
    same SolverState as the other scans. `maxg` bounds the hosts of a
    slice (a gang of N pods never needs more than N); `key_kid` /
    `n_domains` name the ONE narrow vocab key the run's gang kinds
    interact with (-1: none), `tk_idx` that key's row among the bank's
    topo_kids columns. On CUDA (plain False) one launch of gang_scan (H9)
    after the batched precompute; otherwise `_gang_step` per segment.
    Functional: the input state is not modified."""
    if plain or state.used.device.type == "cpu":
        ys = []
        for j in range(xs.count.shape[0]):
            state, y = _gang_step(
                state, _take_x(xs, j), exist, it, templates, well_known, topo, zone_kid, ct_kid,
                n_claims, maxg, key_kid, n_domains, tk_idx,
            )
            ys.append(y)
        if not ys:
            raise ValueError("solve_gang needs at least one segment")
        return state, GangYs(*(torch.stack(f) for f in zip(*ys)))
    pre = gang_precompute(xs, it, templates, well_known, topo, zone_kid, ct_kid, key_kid, n_domains)
    state = state._replace(**{f: getattr(state, f).clone() for f in GANG_WRITES})
    ys = cuda.gang_scan(pre, state, exist, it, templates, topo, zone_kid, n_claims, maxg, key_kid,
                        n_domains, tk_idx)
    return state, GangYs(*ys)


# ---------------------------------------------------------------------------
# dp speculation (the JAX package's solve_fill_dp / solve_kscan_dp /
# solve_perpod_dp, their verdict word and merge_shard_fill /
# merge_shard_kscan)
# ---------------------------------------------------------------------------
# DP chunk groups (fill or kind-scan segments, or per-pod chunks) solve
# from the SAME round base; the host merges them in order. Row r commits
# without a re-solve iff every live open claim of the base, and every
# claim an earlier row q < r opened, is capacity-dead for r's elementwise-
# min request (fits is total-based and monotone in the request, so no pod
# of r could have landed on them), r filled no pre-base window row, its
# topology records / existing-node debits / budget debits are disjoint
# from what later rows read, nothing spilled, and the cumulative graft
# offsets stay inside the window and the claims axis. A commit grafts the
# row's fresh window rows at the committed w_open with global ids shifted
# by the claim-id offset, and adds its count and debit deltas; the first
# refused row replays sequentially. Either way the result equals the
# sequential solve bit for bit.
#
# On one card the rows are not a mesh: the fill and kind-scan rows run
# one after another through H1-H3 / H5-H6, the per-pod rows as one launch
# of the per-pod kernel in scenario mode (a block per row). H12 dp_dead
# computes the deadness matrix, H13 dp_verdict the packed word and H14
# merge_shard the graft; each has its plain version here.

# the window columns a graft copies (slot_of and open get their own rule)
GRAFT_WINDOW = ("reqs", "used", "its", "template", "pods", "claim_ports", "held")


def rows_dead_plain(used, its, open_mask, it: InstanceTypeTensors, r_min) -> torch.Tensor:
    """[] bool — every row of open_mask is capacity-dead for r_min: used +
    r_min (one f32 add) fits no viable (type, allocatable group) cell (the
    reference's `_rows_dead`, compact_state's eviction rule as a
    predicate). r_min = +inf rows fit nothing (a padding row)."""
    total = used + r_min[None, :]  # [W, R]
    fit = it.group_valid[None] & its[:, :, None]
    for r in range(total.shape[1]):
        t = total[:, None, None, r]
        fit = fit & ((t <= it.alloc[None, :, :, r]) | (t == 0.0))
    return ~(open_mask & fit.flatten(1).any(dim=1)).any()


def kscan_rows_dead_plain(used, its, open_mask, it: InstanceTypeTensors, r_min, key_kid: int, zone_kid: int,
                          D: int) -> torch.Tensor:
    """[] bool — every row of open_mask is per-domain capacity-dead for
    r_min: the grid count at (used, r_min) admits no pod in any domain of
    the key over the all-admitting zone / capacity-type masks (the
    reference's `_kscan_rows_dead`)."""
    W = used.shape[0]
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    grid = cap_res_grid_plain(used, r_min, it)
    ones = dict(dtype=torch.bool, device=used.device)
    capd = kscan_capd_plain(grid, its, torch.ones((W, C), **ones), torch.ones((W, Z), **ones), it, key_kid,
                            zone_kid, D)
    return ~(open_mask & (capd > 0).any(dim=-1)).any()


def window_live_dead(state: SolverState, it: InstanceTypeTensors, r_min) -> torch.Tensor:
    """[] bool — every live open window claim is capacity-dead for r_min."""
    return rows_dead_plain(state.used, state.its, state.open, it, r_min)


def fill_touched_below(fill_c: torch.Tensor, w_lo) -> torch.Tensor:
    """[] bool — a fill landed on a window row below w_lo ([B, W] fill_c)."""
    rows = torch.arange(fill_c.shape[-1], dtype=I32, device=fill_c.device)
    return ((fill_c > 0) & (rows < w_lo)[None, :]).any()


def group_r_min(count: torch.Tensor, requests: torch.Tensor) -> torch.Tensor:
    """[R] — the elementwise-min request over a group's live (count > 0)
    segments or valid pods; +inf for a group with none (padding)."""
    inf = torch.full_like(requests, float("inf"))
    return torch.where((count > 0)[:, None], requests, inf).amin(dim=0)


def opened_rows(base: SolverState, spec: SolverState) -> torch.Tensor:
    """[W] bool — the claims a speculative row opened: window rows
    [base.w_open, spec.w_open) that are open."""
    rows = torch.arange(spec.open.shape[0], dtype=I32, device=spec.open.device)
    return (rows >= base.w_open) & (rows < spec.w_open) & spec.open


def exist_leaves(st: SolverState) -> list:
    """The existing-node fields a row's touch is read from, in H13's and
    H14's order: usage (f32), ports, volumes, the six requirement
    components."""
    return [st.exist_used, st.exist_ports, st.exist_vols, *st.exist_reqs]


def exist_touched(spec: SolverState, base: SolverState) -> torch.Tensor:
    """[E] bool — existing nodes whose state the row changed: any field
    delta against the round base (the reference's `_exist_touched`)."""
    E = base.exist_used.shape[0]
    d = torch.zeros(E, dtype=torch.bool, device=base.exist_used.device)
    for a, b in zip(exist_leaves(spec), exist_leaves(base)):
        d = d | (a != b).reshape(E, -1).any(dim=1)
    return d


def exist_conflict(base: SolverState, specs: list, exist: ExistingNodes, exist_ok_rows, r_min) -> torch.Tensor:
    """[q, r] bool — row q touched an existing node row r could use:
    viable = valid & exist_ok_rows & _count_cap_seq(base used, r_min,
    avail) > 0 (a conservative superset; the reference's
    `_exist_conflict_ok` before its triangular reduction)."""
    touched = torch.stack([exist_touched(s, base) for s in specs])  # [DP, E]
    cap = _count_cap_seq(base.exist_used[None], r_min[:, None, :], exist.avail[None])  # [DP, E]
    viable = exist.valid[None, :] & exist_ok_rows & (cap > 0)
    return (touched[:, None, :] & viable[None, :, :]).any(dim=-1)


def budget_res_conflict(base: SolverState, specs: list, apply_tmpl) -> torch.Tensor:
    """[q, r] bool — row q changed template g's budget or node count and
    row r's pods may consider g, or row q changed any reservation capacity
    (the reference's `_budget_res_conflict`)."""
    touch_b = torch.stack([(s.budget != base.budget).any(dim=-1) | (s.nodes_budget != base.nodes_budget)
                           for s in specs])  # [DP, G]
    touch_res = torch.stack([(s.res_cap != base.res_cap).any() for s in specs])  # [DP]
    return (touch_b[:, None, :] & apply_tmpl[None, :, :]).any(dim=-1) | touch_res[:, None]


def topo_conflict(rec_v, app_v, rec_h, app_h) -> torch.Tensor:
    """[q, r] bool — row q records into a vocab-key or hostname group row r
    applies."""
    return (rec_v[:, None, :] & app_v[None, :, :]).any(dim=-1) | (rec_h[:, None, :] & app_h[None, :, :]).any(dim=-1)


class DpKey(NamedTuple):
    """The kind scan's vocab key (H12's kscan mode)."""

    key_kid: int
    zone_kid: int
    D: int


def dp_dead_plain(base: SolverState, specs: list, r_min, it: InstanceTypeTensors,
                  key: Optional[DpKey] = None) -> torch.Tensor:
    """[DP, 1 + DP] bool — entry [r, 0]: every live open claim of the base
    is dead for r_min[r]; entry [r, 1 + q]: every claim row q opened is.
    `key` None: the fill / per-pod predicate (rows_dead_plain), else the
    kind scan's (kscan_rows_dead_plain)."""

    def dead(used, its, om, rm):
        if key is None:
            return rows_dead_plain(used, its, om, it, rm)
        return kscan_rows_dead_plain(used, its, om, it, rm, *key)

    opened = [opened_rows(base, s) for s in specs]
    out = []
    for r in range(len(specs)):
        out.append(torch.stack([dead(base.used, base.its, base.open, r_min[r])]
                               + [dead(s.used, s.its, o, r_min[r]) for s, o in zip(specs, opened)]))
    return torch.stack(out)


def dp_dead(base: SolverState, specs: list, r_min, it: InstanceTypeTensors, key: Optional[DpKey] = None,
            plain: bool = False) -> torch.Tensor:
    """H12: the deadness matrix in one launch on CUDA, the plain version on
    the CPU (or with plain=True)."""
    if plain or r_min.device.type == "cpu":
        return dp_dead_plain(base, specs, r_min, it, key)
    return cuda.dp_dead(base, specs, r_min, it, key)


class DpVerdictIn(NamedTuple):
    """The per-row terms the verdict reads besides the states: each row's
    min request, its existing-node gate, the topology groups it records
    into / applies, the templates its pods may consider (per-pod family,
    else None), and the fill family's fill grids and leftovers (else
    None: the touch is read from the pods columns)."""

    r_min: torch.Tensor  # [DP, R] f32
    exist_ok_rows: torch.Tensor  # [DP, E] bool
    rec_v: torch.Tensor  # [DP, NGv] bool (zero-width for fill rows)
    app_v: torch.Tensor  # [DP, NGv]
    rec_h: torch.Tensor  # [DP, NGh]
    app_h: torch.Tensor  # [DP, NGh]
    apply_tmpl: Optional[torch.Tensor] = None  # [DP, G] bool
    fill_c: Optional[list] = None  # DP x [B_r, W] i32
    leftover: Optional[list] = None  # DP x [B_r] i32


def dp_verdict_word_plain(base: SolverState, specs: list, dead, n_claims: int, touched, extra_ok) -> torch.Tensor:
    """[lanes] int32 — the packed commit verdict (the reference's
    `_dp_verdict_word`): row r's bit is set iff r and every row before it
    pass: base dead and every earlier row's opens dead for r (`dead`),
    nothing touched below the base's w_open, the family extra, no new
    spill, and the cumulative window / claims-axis graft offsets in
    bounds."""
    DP = len(specs)
    W = base.open.shape[0]
    qi = torch.arange(DP, device=dead.device)
    cross_ok = (dead[:, 1:] | (qi[None, :] >= qi[:, None])).all(dim=1)
    spills = torch.stack([s.spills for s in specs])
    w_open = torch.stack([s.w_open for s in specs])
    n_open = torch.stack([s.n_open for s in specs])
    fit_w = base.w_open + torch.cumsum(w_open - base.w_open, 0) <= W
    fit_n = base.n_open + torch.cumsum(n_open - base.n_open, 0) <= n_claims
    ok = dead[:, 0] & cross_ok & ~touched & extra_ok & (spills == base.spills) & fit_w & fit_n
    prefix = torch.cumsum((~ok).to(I32), 0) == 0
    return kernels.pack_bool(prefix)


def dp_verdict_plain(base: SolverState, specs: list, dead, exist: ExistingNodes, n_claims: int,
                     vin: DpVerdictIn) -> torch.Tensor:
    """The plain version of H13: each row's touched bit (fill: a fill below
    the base's w_open; else more pods than the base on a row below it), the
    family extra (fill: zero leftovers; every family: the vg / hg record-
    vs-apply bit and the existing-node debit bit; per-pod: the budget /
    reservation bit), then the word."""
    W = base.open.shape[0]
    below = torch.arange(W, dtype=I32, device=base.open.device) < base.w_open
    if vin.fill_c is not None:
        touched = torch.stack([fill_touched_below(fc, base.w_open) for fc in vin.fill_c])
    else:
        touched = torch.stack([((s.pods > base.pods) & below).any() for s in specs])
    conflict = topo_conflict(vin.rec_v, vin.app_v, vin.rec_h, vin.app_h)
    conflict = conflict | exist_conflict(base, specs, exist, vin.exist_ok_rows, vin.r_min)
    if vin.apply_tmpl is not None:
        conflict = conflict | budget_res_conflict(base, specs, vin.apply_tmpl)
    extra = kernels.pairwise_commit_ok(conflict)
    if vin.leftover is not None:
        extra = extra & torch.stack([lo.sum() == 0 for lo in vin.leftover])
    return dp_verdict_word_plain(base, specs, dead, n_claims, touched, extra)


def dp_verdict(base: SolverState, specs: list, dead, exist: ExistingNodes, n_claims: int, vin: DpVerdictIn,
               plain: bool = False) -> torch.Tensor:
    """H13: the verdict word in one launch on CUDA, the plain version on the
    CPU (or with plain=True)."""
    if plain or dead.device.type == "cpu":
        return dp_verdict_plain(base, specs, dead, exist, n_claims, vin)
    return cuda.dp_verdict(base, specs, dead, exist, n_claims, vin)


def _row_masks(live, xs, topo: TopologyTensors, vg: bool) -> dict:
    """Per-row any over a row's live segments / valid pods ([DP, N] masks
    `live`) of the record / apply / existing-node gates."""
    def any_live(m):
        return (live[:, :, None] & m).any(dim=1)

    dp = live.shape[0]
    out = dict(exist_ok_rows=any_live(xs["exist_ok"]), rec_h=any_live(xs["hg_records"]) & topo.hg_valid[None],
               app_h=any_live(xs["hg_applies"]) & topo.hg_valid[None])
    if vg:
        out.update(rec_v=any_live(xs["vg_records"]) & topo.vg_valid[None],
                   app_v=any_live(xs["vg_applies"]) & topo.vg_valid[None])
    else:
        z = torch.zeros((dp, 0), dtype=torch.bool, device=live.device)
        out.update(rec_v=z, app_v=z)
    return out


def _stack_rows(xs_rows: list, fields: tuple) -> tuple:
    """Rows of different segment counts padded with count-0 segments and
    stacked: (live [DP, Bmax], {field: [DP, Bmax, ...]}, r_min [DP, R])."""
    Bm = max(x.count.shape[0] for x in xs_rows)

    def pad(t):
        n = Bm - t.shape[0]
        return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))]) if n else t

    live = torch.stack([pad(x.count) > 0 for x in xs_rows])
    out = {f: torch.stack([pad(getattr(x, f)) for x in xs_rows]) for f in fields}
    r_min = torch.stack([group_r_min(x.count, x.requests) for x in xs_rows])
    return live, out, r_min


def solve_fill_dp(
    state: SolverState,
    xs_rows: list,  # DP FillXs, one chunk group each (count-0 segments pad)
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    plain: bool = False,
) -> tuple[list, list, torch.Tensor]:
    """Speculative dp fan-out of fill chunk groups: every row's group solves
    from the same base `state` (one after another through H1-H3, out of
    place), then H12 and H13. Returns (DP row states, DP FillYs, verdict
    word [lanes] int32); no host sync."""
    specs, yss = [], []
    for xs in xs_rows:
        st, ys = solve_fill(state, xs, exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims,
                            plain=plain)
        specs.append(st)
        yss.append(ys)
    live, xs_b, r_min = _stack_rows(xs_rows, ("exist_ok", "hg_records", "hg_applies"))
    vin = DpVerdictIn(r_min=r_min, **_row_masks(live, xs_b, topo, vg=False),
                      fill_c=[ys.fill_c for ys in yss], leftover=[ys.leftover for ys in yss])
    dead = dp_dead(state, specs, r_min, it, plain=plain)
    return specs, yss, dp_verdict(state, specs, dead, exist, n_claims, vin, plain=plain)


def solve_kscan_dp(
    state: SolverState,
    xs_rows: list,  # DP KindXs, one chunk group each
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    key_kid: int,
    n_domains: int,
    maxc: int,
    counts_rows: list,  # DP host lists of the rows' segment counts
    requests_rows: list,  # DP host [B_r, R] request rows
    grid_incremental: bool = True,
    plain: bool = False,
) -> tuple[list, list, torch.Tensor]:
    """Speculative dp fan-out of kind-scan chunk groups: each row's segments
    scan from the base with a fresh grid (H5 / H6, rows one after
    another), then H12 in its kscan mode and H13 with the vg / hg record-
    vs-apply bit. Returns (DP row states, DP KindYs, verdict word)."""
    specs, yss = [], []
    for xs, counts, req in zip(xs_rows, counts_rows, requests_rows):
        st, ys = solve_kind_scan(state, xs, exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims,
                                 key_kid, n_domains, maxc, counts, req, grid_incremental, plain)
        specs.append(st)
        yss.append(ys)
    live, xs_b, r_min = _stack_rows(xs_rows, ("exist_ok", "hg_records", "hg_applies", "vg_records", "vg_applies"))
    vin = DpVerdictIn(r_min=r_min, **_row_masks(live, xs_b, topo, vg=True))
    dead = dp_dead(state, specs, r_min, it, DpKey(key_kid, zone_kid, n_domains), plain=plain)
    return specs, yss, dp_verdict(state, specs, dead, exist, n_claims, vin, plain=plain)


def solve_perpod_dp(
    state: SolverState,
    pods: PodTensors,  # the round's gathered pod block
    pod_tmpl_ok: torch.Tensor,
    pod_it_allow: torch.Tensor,
    pod_exist_ok: torch.Tensor,
    pod_ports: torch.Tensor,
    pod_port_conf: torch.Tensor,
    pod_vols: torch.Tensor,
    pod_idx: torch.Tensor,  # [DP, L] — row r's step i reads block row pod_idx[r, i]
    valid: torch.Tensor,  # [DP, L] bool — False past a row's chunk
    exist: ExistingNodes,
    it: InstanceTypeTensors,
    templates: Templates,
    well_known: torch.Tensor,
    topo: TopologyTensors,
    pod_topo: topo_ops.PodTopology,
    zone_kid: int,
    ct_kid: int,
    n_claims: int,
    topo_kids: tuple = (),
    plain: bool = False,
    tables: Optional[tuple] = None,
    flags: PerPodFlags = PerPodFlags(),
) -> tuple[list, torch.Tensor, torch.Tensor]:
    """Speculative dp fan-out of per-pod chunks: every row scans its chunk
    from the same base. On CUDA the DP rows run in ONE launch of the
    per-pod kernel in scenario mode (a block per row) over a stacked copy
    of the base (its own vg / hg counts on every row; the problem's
    topology seeds stay the solve's), reading the base's existing nodes on
    every row; the plain version loops perpod_loop_plain from the base per
    row. Then H12 and H13 with the budget / reservation bit. Returns (DP
    row states, assignment [DP, L] int32, verdict word)."""
    DP, L = pod_idx.shape
    idx = pod_idx.long()
    xs = pod_xs(pods, pod_tmpl_ok, pod_it_allow, pod_exist_ok, pod_ports, pod_port_conf, pod_vols, pod_topo)
    ctx = PerPodCtx(exist, it, templates, well_known, topo, zone_kid, ct_kid, n_claims, tuple(topo_kids), tables,
                    flags)
    if plain or valid.device.type == "cpu":
        specs, rows = [], []
        for r in range(DP):
            st, a = perpod_loop_plain(state, _take_x(xs, idx[r])._replace(valid=valid[r]), ctx)
            specs.append(st)
            rows.append(a)
        assignment = torch.stack(rows)
    else:
        stacked = stack_scenarios(state, DP, state.vg_counts.expand((DP,) + tuple(state.vg_counts.shape)),
                                  state.hg_counts.expand((DP,) + tuple(state.hg_counts.shape)))
        exist_valid = exist.valid.expand(DP, exist.valid.shape[0]).contiguous()
        assignment = cuda.perpod_whatif(stacked, xs, ctx, pod_idx.to(I32).contiguous(), valid.contiguous(),
                                        exist_valid)
        specs = [scenario_state(stacked, r) for r in range(DP)]
    inf = torch.full((DP, L, pods.requests.shape[1]), float("inf"), dtype=F32, device=valid.device)
    r_min = torch.where(valid[:, :, None], pods.requests[idx], inf).amin(dim=1)
    rows_x = dict(exist_ok=pod_exist_ok[idx], hg_records=pod_topo.hg_records[idx],
                  hg_applies=pod_topo.hg_applies[idx], vg_records=pod_topo.vg_records[idx],
                  vg_applies=pod_topo.vg_applies[idx])
    vin = DpVerdictIn(r_min=r_min, **_row_masks(valid, rows_x, topo, vg=True),
                      apply_tmpl=(valid[:, :, None] & pod_tmpl_ok[idx]).any(dim=1))
    dead = dp_dead(state, specs, r_min, it, plain=plain)
    return specs, assignment, dp_verdict(state, specs, dead, exist, n_claims, vin, plain=plain)


# ---- the graft (H14's plain version) ---------------------------------------


def graft_window_fields(committed: SolverState, spec: SolverState, base_n_open, base_w_open) -> tuple:
    """The window graft shared by every family (the reference's
    `_graft_window_fields`): spec rows [base_w_open, spec.w_open) land at
    committed.w_open.. with global ids shifted by delta = committed.n_open
    - base_n_open. Returns (field updates, shifted slot map, delta)."""
    W = committed.open.shape[0]
    NB = committed.bank_frozen.shape[0]
    dev = committed.open.device
    k = spec.w_open - base_w_open
    delta = committed.n_open - base_n_open
    pos = torch.arange(W, dtype=I32, device=dev) - committed.w_open
    grab = (pos >= 0) & (pos < k)
    src = torch.clamp(base_w_open + pos, 0, W - 1).long()
    shifted = torch.where((spec.slot_of >= base_n_open) & (spec.slot_of < NB), spec.slot_of + delta, spec.slot_of)

    def take(cf, sf):
        g = grab.reshape(grab.shape + (1,) * (cf.dim() - 1))
        return torch.where(g, sf[src], cf)

    w_open = committed.w_open + k
    fields = dict(
        reqs=select_set(grab, take_set(spec.reqs, src), committed.reqs),
        **{f: take(getattr(committed, f), getattr(spec, f)) for f in GRAFT_WINDOW if f != "reqs"},
        open=committed.open | grab,
        slot_of=torch.where(grab, shifted[src], committed.slot_of),
        n_open=committed.n_open + (spec.n_open - base_n_open),
        w_open=w_open,
        w_hw=torch.maximum(committed.w_hw, w_open),
    )
    return fields, shifted, delta


def graft_exist_fields(committed: SolverState, spec: SolverState, base: SolverState) -> dict:
    """Whole-field graft of every existing node the row touched (a field
    delta against the round base; the reference's `_graft_exist_fields`)."""
    touched = exist_touched(spec, base)

    def sel(a, b):
        return torch.where(touched.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return dict(
        exist_reqs=select_set(touched, spec.exist_reqs, committed.exist_reqs),
        exist_used=sel(spec.exist_used, committed.exist_used),
        exist_ports=sel(spec.exist_ports, committed.exist_ports),
        exist_vols=sel(spec.exist_vols, committed.exist_vols),
    )


def merge_hg_delta(committed: SolverState, spec_hg, base: SolverState, delta, spec_n_open) -> torch.Tensor:
    """The hostname-group count merge (the reference's `_merge_hg_delta`):
    existing-node columns [0, E) add the row's delta in place, fresh-claim
    columns add it shifted by the claim-id delta."""
    E = committed.exist_used.shape[0]
    S = committed.hg_counts.shape[1]
    cols = torch.arange(S, dtype=I32, device=spec_hg.device)
    src_c = torch.clamp(cols - delta, 0, S - 1).long()
    dh = spec_hg - base.hg_counts
    in_rng = (cols - delta >= E + base.n_open) & (cols - delta < E + spec_n_open)
    zero = torch.zeros_like(dh)
    return committed.hg_counts + torch.where(in_rng[None, :], dh[:, src_c], zero) + torch.where(
        (cols < E)[None, :], dh, zero)


def merge_shard_fill_plain(committed: SolverState, spec: SolverState, base: SolverState) -> tuple:
    """The plain version of H14's fill mode (the reference's
    merge_shard_fill): (merged state, shifted slot map). Out of place."""
    fields, shifted, delta = graft_window_fields(committed, spec, base.n_open, base.w_open)
    hg = merge_hg_delta(committed, spec.hg_counts, base, delta, spec.n_open)
    return committed._replace(hg_counts=hg, **graft_exist_fields(committed, spec, base), **fields), shifted


def merge_shard_kscan_plain(committed: SolverState, spec: SolverState, assignment, base: SolverState) -> tuple:
    """The plain version of H14's kscan / per-pod mode (the reference's
    merge_shard_kscan): the fill graft plus the vg delta, the finite
    budget and node-count deltas, the reservation delta and the assignment
    shift (slots >= E + base.n_open move by the claim-id delta; existing
    nodes and the < 0 sentinels pass). (merged, shifted, assignment')."""
    fields, shifted, delta = graft_window_fields(committed, spec, base.n_open, base.w_open)
    E = committed.exist_used.shape[0]
    zb = torch.zeros_like(base.budget)
    zn = torch.zeros_like(base.nodes_budget)
    merged = committed._replace(
        vg_counts=committed.vg_counts + (spec.vg_counts - base.vg_counts),
        hg_counts=merge_hg_delta(committed, spec.hg_counts, base, delta, spec.n_open),
        budget=committed.budget + torch.where(torch.isfinite(base.budget), spec.budget - base.budget, zb),
        nodes_budget=committed.nodes_budget + torch.where(
            torch.isfinite(base.nodes_budget), spec.nodes_budget - base.nodes_budget, zn),
        res_cap=committed.res_cap + (spec.res_cap - base.res_cap),
        **graft_exist_fields(committed, spec, base),
        **fields,
    )
    assign = torch.where(assignment >= E + base.n_open, assignment + delta, assignment)
    return merged, shifted, assign


def merge_shard_fill(committed: SolverState, spec: SolverState, base: SolverState, plain: bool = False) -> tuple:
    """H14 fill mode: one commit out of place in one launch on CUDA, the
    plain version on the CPU (or with plain=True)."""
    if plain or committed.used.device.type == "cpu":
        return merge_shard_fill_plain(committed, spec, base)
    merged, shifted, _assign = cuda.merge_shard(committed, spec, base, None)
    return merged, shifted


def merge_shard_kscan(committed: SolverState, spec: SolverState, assignment, base: SolverState,
                      plain: bool = False) -> tuple:
    """H14 kscan / per-pod mode (see merge_shard_kscan_plain)."""
    if plain or committed.used.device.type == "cpu":
        return merge_shard_kscan_plain(committed, spec, assignment, base)
    return cuda.merge_shard(committed, spec, base, assignment)
