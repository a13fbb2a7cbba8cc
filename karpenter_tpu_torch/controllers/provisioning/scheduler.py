"""The scheduling engine: encode -> ops.solver (PyTorch + CUDA) -> decode.

A port of the JAX package's TPUScheduler (controllers/provisioning/
scheduler.py). Every pod kind routes as the reference routes it: complete
gangs first, one all-or-nothing gang scan segment each; selector pods and
hostname topology groups to the kind-level fill scan, kinds whose
vocab-key groups (zone spread, zone affinity) share ONE narrow key to the
zonal kind scan, and every other topology kind — vocab-key groups over
two or more keys, a key wider than KSCAN_D, an initially-empty hostname
affinity group — to the per-pod scan, in chunks. Under finite NodePool
budgets, enforced minValues or reservations every singleton kind rides
the per-pod scan. Host ports, CSI attach limits and a PVC's single zone
alternative ride every route. The same FFD order, topology encode,
routing, chunking and compaction boundaries and decode give a result
equal to TPUScheduler.solve's. DRA claims, volume topologies with several
alternatives, volume keys an existing node leaves undefined, and the
gangs the reference sends to its host oracle (under enforced minValues or
reservations, vocab-key groups over several keys or a key wider than
KSCAN_D, hostname affinity or anti-affinity) raise UnsupportedProblem;
nothing falls back to another engine.

A placement objective (the `objective=` keyword, else KTPU_OBJECTIVE, else
lexical) puts its canonical template rank on every engine's tier-3 pick
and, unless lexical, solves each fill group under KTPU_OBJECTIVE_K rank
variants, committing the feasible variant of least score off one 4-byte
verdict word per group (H11) and replaying the group when none is
feasible.

With dp > 1 (`TorchScheduler(dp=N)`, the reference's mesh dp extent) the
pipeline's consecutive fill groups, a kind-scan run's chunk groups and a
per-pod run's chunks speculate dp at a time from one round base and merge
in order: a row commits (a graft, H14) when the round's verdict word (H12,
H13; one 4-byte fetch per round) proves it independent of every earlier
row, the first refused row replays sequentially. The result is the dp = 1
result bit for bit; last_stats["shard"] counts the reference's merge
events.
"""

from __future__ import annotations

import copy
import os
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import gang as gang_mod
from karpenter_tpu_torch import objectives
from karpenter_tpu_torch.cloudprovider.instancetype import InstanceType
from karpenter_tpu_torch.controllers.provisioning import preferences as prefs
from karpenter_tpu_torch.controllers.provisioning.host_scheduler import (
    ExistingSimNode,
    SchedulingResult,
    SimClaim,
    ffd_keys,
    finalize_min_values,
    finalize_reserved,
    hostname_placeholder,
    normalize_volume_reqs,
    pod_content_sig,
)
from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import ClaimTemplate
from karpenter_tpu_torch.controllers.provisioning.topology import (
    Topology,
    TopologyType,
    build_universe_domains,
    template_universe_domains,
)
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.pod import Pod
from karpenter_tpu_torch.ops import cuda as ops_cuda
from karpenter_tpu_torch.ops import solver as ops_solver
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.objectives import scoring as obj_scoring
from karpenter_tpu_torch.ops.encode import (
    ProblemEncoder,
    ReqSetTensors,
    as_tensor,
    encode_requirements_np,
    to_device,
    type_price_column,
)
from karpenter_tpu_torch.ops.kernels import WireLeaf, WireMax, fetch_async, fetch_tree, leading_ones, pack_bool_np
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.scheduling import hostports
from karpenter_tpu_torch.scheduling.reservations import ReservationManager
from karpenter_tpu_torch.scheduling.taints import tolerates_all
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.sampler import read_cpu_seconds, read_rss_bytes

# last_stats counters of the K-variant objective dispatch (the reference's
# OBJECTIVE_ROUNDS / OBJECTIVE_VARIANT_WINS / verdict byte counters)
OBJECTIVE_STATS = ("objective_committed", "objective_replayed", "wins_canonical", "wins_perturbed",
                   "verdict_fetches", "verdict_bytes", "variant_solves")

# NO_ROOM is a device-shape artifact: solve() grows the claims axis and
# re-solves, so this reason only surfaces if recovery is impossible
NO_ROOM_REASON = "claim-slot capacity exhausted; raise max_claims"
NO_CLAIM_REASON = "no compatible in-flight claim or template"


class UnsupportedProblem(ValueError):
    """The problem needs a part of the solver this package has not ported
    (DRA claims, volume topologies with several alternatives or with a key
    an existing node leaves undefined, gangs the reference hands to its
    host oracle)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# the dp speculation families of last_stats["shard"] (the reference's
# _SHARD_FAMILIES): fill groups split by what shared state the verdict
# proved disjoint (plain capacity, existing-node debits, hostname-group
# counts), then the kind-scan and per-pod engines
SHARD_FAMILIES = ("fill", "existing", "topo_fill", "kscan", "perpod")


def _new_shard_stats(dp: int) -> dict:
    """last_stats["shard"] of a solve with dp rows: the reference's merge
    counters (last_timings["shard"]) for the same events."""
    return dict(
        dp=dp, merge_rounds=0, groups_committed=0, groups_replayed=0, verdict_fetches=0, verdict_bytes=0,
        dp_rows_total=0, dp_rows_committed=0, dp_rows_replayed=0, dp_rows_idle=0,
        families={f: {"committed": 0, "replayed": 0} for f in SHARD_FAMILIES},
        coverage={f: {"dp": 0, "sequential": 0} for f in SHARD_FAMILIES},
    )


def _next_pow2(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _slim_outputs(specs: tuple, flat) -> tuple[list, list]:
    """Shared output slimming of the fetch preps (the reference's
    _slim_outputs): every output sliced to its live rows and the fill
    grids narrowed to int16, as WireLeaf views that the wire kernel reads
    in place. Returns the leaves plus the full fill grids whose max guards
    the narrowing (empty fill_e grids are kept as leaves, not maxed)."""
    proc: list = []
    maxes: list = []
    i = 0
    for spec in specs:
        if spec[0] == "pods":
            proc.append(flat[i])
            i += 1
        elif spec[0] == "kscan":
            proc.append(WireLeaf(flat[i], spec[1]))
            proc.append(WireLeaf(flat[i + 1], spec[1]))  # per-segment grid_reused
            i += 2
        elif spec[0] == "gang":
            proc.extend(WireLeaf(a, spec[1]) for a in flat[i : i + 5])
            i += 5
        else:
            B = spec[1]
            fc, fe, os_, no_, st_, sm = flat[i : i + 6]
            i += 6
            maxes.append(fc)
            if fe.numel():
                maxes.append(fe)
            proc.extend(
                [
                    WireLeaf(fc, B, narrow=True),
                    WireLeaf(fe, B, narrow=True),
                    WireLeaf(os_, B),
                    WireLeaf(no_, B),
                    WireLeaf(st_, B),
                    sm,  # the dispatch's window -> global slot map
                ]
            )
    return proc, maxes


# scalar/column head every decode fetch starts with (before the tk rows)
_STATE_HEAD = ("template", "its", "used", "held", "n_open", "w_open", "w_hw", "spills")
# the topology-key rows that follow the head when the solve has topo keys
_TK_NAMES = ("c_mask", "c_inf", "c_def", "e_mask", "e_inf", "e_def")


def _state_reads(state, tk: tuple, plain: bool = False) -> list:
    """The final-state reads every decode needs: global-slot claim
    finalization columns (hot window merged over the frozen bank), the
    n_open / window scalars and, with topology keys, the topo-key
    requirement rows of claims and existing nodes."""
    g = ops_solver.global_claims(state, plain=plain, topo_kids=tk)
    proc = [g["template"], g["its"], g["used"], g["held"], state.n_open, state.w_open, state.w_hw, state.spills]
    if tk:
        kid = list(tk)
        proc.extend(
            [
                g["tk_mask"],
                g["tk_inf"],
                g["tk_def"],
                state.exist_reqs.mask[:, kid, :],
                state.exist_reqs.inf[:, kid],
                state.exist_reqs.defined[:, kid],
            ]
        )
    return proc


def _with_max(proc: list, maxes: list) -> list:
    if maxes:
        proc.append(WireMax(maxes))
    return proc


def _make_fetch_prep(specs: tuple, tk: tuple, plain: bool = False):
    """The single fetch's prep: state head, the slimmed outputs in order,
    fill_max, then the topo-key rows (the reference's _make_fetch_prep;
    a plain function: nothing is compiled)."""
    n_head = len(_STATE_HEAD)

    def _prep(state, flat):
        reads = _state_reads(state, tk, plain)
        out, maxes = _slim_outputs(specs, flat)
        return _with_max(reads[:n_head] + out, maxes) + reads[n_head:]

    return _prep


def _make_group_prep(specs: tuple):
    """One pipeline group's prep: the post-group template snapshot, the
    group's slimmed outputs and its own fill_max."""

    def _prep(tmpl, flat):
        out, maxes = _slim_outputs(specs, flat)
        return _with_max([tmpl] + out, maxes)

    return _prep


def _make_final_prep(tk: tuple, plain: bool = False):
    """The final-state reads alone."""

    def _prep(state):
        return _state_reads(state, tk, plain)

    return _prep


def _make_group_final_prep(specs: tuple, tk: tuple, plain: bool = False):
    """The last pipeline group's prep: its outputs AND the final-state
    reads ride one wire, so the pipelined decode pays no trailing fetch."""

    def _prep(tmpl, flat, state):
        out, maxes = _slim_outputs(specs, flat)
        return _with_max([tmpl] + out, maxes) + _state_reads(state, tk, plain)

    return _prep


def _partition_ranges(weights: Sequence, n_groups: int) -> list[tuple[int, int]]:
    """Split [0, len(weights)) into <= n_groups contiguous ranges with
    roughly balanced total weight (the pipelined decode's chunk groups)."""
    n = len(weights)
    n_groups = max(min(n_groups, n), 1)
    total = float(sum(weights)) or 1.0
    out: list[tuple[int, int]] = []
    lo = 0
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if len(out) < n_groups - 1 and acc >= total * (len(out) + 1) / n_groups:
            out.append((lo, i + 1))
            lo = i + 1
    if lo < n:
        out.append((lo, n))
    return out


def _merge_scaled(base: dict, req: dict, c: int) -> dict:
    """base + c*req per resource, in the fill scan's f32 convention (one
    product, one sum, each rounded) so host decode matches the device."""
    out = dict(base)
    cf = np.float32(c)
    for k, v in req.items():
        out[k] = float(np.float32(np.float32(out.get(k, 0.0)) + cf * np.float32(v)))
    return out


def _decode_fill_segments(ctx, segs, f) -> None:
    """Expand every segment's per-row counts to a per-pod slot stream via
    one np.repeat over (value, count) pairs, then apply it grouped — the
    per-pod replay order of the reference: tier 1 in node-index order,
    tier 2 in water-fill interleave order, tier 3 in slot order, leftovers
    last; f32 usage merges one multiply-add per (segment, node). Fill
    grids address WINDOW rows; `slot_map` (the dispatch's slot_of)
    translates them to global claim ids."""
    E = ctx.E
    pods_sorted = ctx.pods_sorted
    lo0 = segs[0][0]
    vals: list[int] = []
    cnts: list[int] = []
    fixups: list = []  # (stream_pos, slots, counts, p0s) multi-slot tier-2 runs
    exist_merges: list = []  # (kind, e_slots, e_counts) per segment
    claim_events: list = []  # (slot, kind, count) per touched claim
    fill_c = f["fill_c"]
    fill_e = f["fill_e"]
    open_start = f["open_start"]
    n_opened = f["n_opened"]
    status = f["status"]
    slot_map = np.asarray(f["slot_map"], dtype=np.int64)
    pc = ctx.claim_pod_counts
    js, ss = np.nonzero(fill_c)
    cc = fill_c[js, ss].tolist()
    ss_l = ss.tolist()
    gs_l = slot_map[ss].tolist() if ss.size else []
    row_ptr = np.searchsorted(js, np.arange(len(segs) + 1))
    for j, (lo, hi, kind) in enumerate(segs):
        count = hi - lo
        if count == 0:
            continue
        placed = 0
        # tier 1: existing nodes in index order
        if E:
            e_idx = np.flatnonzero(fill_e[j])
            if e_idx.size:
                el = e_idx.tolist()
                cl = fill_e[j][e_idx].tolist()
                vals += el
                cnts += cl
                placed += sum(cl)
                exist_merges.append((kind, el, cl))
        a, b = int(row_ptr[j]), int(row_ptr[j + 1])
        pairs = list(zip(ss_l[a:b], gs_l[a:b], cc[a:b]))
        new_lo = int(open_start[j])
        new_hi = new_lo + int(n_opened[j])
        # tier 2: water-fill interleave over in-flight claims
        t2 = [(g_, c) for s, g_, c in pairs if not new_lo <= s < new_hi]
        if t2:
            if len(t2) > 1:
                fixups.append(
                    (
                        lo - lo0 + placed,
                        [g_ for g_, _ in t2],
                        [c for _, c in t2],
                        [int(pc[g_]) for g_, _ in t2],
                    )
                )
            for g_, c in t2:
                vals.append(E + g_)
                cnts.append(c)
                pc[g_] += c
                placed += c
                claim_events.append((g_, kind, c))
        # tier 3: new claims in slot order, each filled to capacity
        if new_hi > new_lo:
            for s, g_, c in pairs:
                if new_lo <= s < new_hi:
                    vals.append(E + g_)
                    cnts.append(c)
                    pc[g_] += c
                    placed += c
                    claim_events.append((g_, kind, c))
        left = count - placed
        if left > 0:
            vals.append(ops_solver.NO_ROOM if int(status[j]) == ops_solver.NO_ROOM else -1)
            cnts.append(left)
    stream = np.repeat(np.asarray(vals, dtype=np.int64), np.asarray(cnts, dtype=np.int64))
    # tier-2 interleave fixups: rewrite the slot-grouped span in
    # fewest-pods-first (level, slot) order
    for pos, slots, counts, p0s in fixups:
        c2 = np.asarray(counts, dtype=np.int64)
        n2 = int(c2.sum())
        p0 = np.asarray(p0s, dtype=np.int64)
        t2a = np.asarray(slots, dtype=np.int64)
        ar = np.arange(n2, dtype=np.int64)
        cum0 = np.cumsum(c2) - c2
        levels = ar - np.repeat(cum0 - p0, c2)
        slots_rep = np.repeat(t2a, c2)
        order = np.argsort(levels * ctx.NC1 + slots_rep, kind="stable")
        stream[pos : pos + n2] = E + slots_rep[order]

    # claims ensured in ascending-slot order, pods grouped by slot
    cmask = stream >= E
    if cmask.any():
        ci = np.flatnonzero(cmask)
        cs = stream[ci] - E
        o = np.argsort(cs, kind="stable")
        cs_sorted = cs[o]
        ci_list = (ci[o] + lo0).tolist()
        bounds = np.flatnonzero(np.diff(cs_sorted)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(cs_sorted)]))
        for a, b in zip(starts.tolist(), ends.tolist()):
            s = int(cs_sorted[a])
            claim = ctx.ensure_claim(s)
            batch = [pods_sorted[i] for i in ci_list[a:b]]
            claim.pods.extend(batch)
            for p in batch:
                ctx.assignments[p.metadata.uid] = s
    for s, kind, c in claim_events:
        ck = ctx.claim_kinds[s]
        ck[kind] = ck.get(kind, 0) + c
        pk = ctx.kind_ports(kind)
        if pk:
            ctx.slot_to_claim[s].host_ports.extend(pk * c)
    # existing nodes (index order per segment)
    emask = (stream >= 0) & (stream < E)
    if emask.any():
        ei = np.flatnonzero(emask)
        es = stream[ei]
        o = np.argsort(es, kind="stable")
        es_sorted = es[o]
        ei_sorted = ei[o]
        bounds = np.flatnonzero(np.diff(es_sorted)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(es_sorted)]))
        ei_list = (ei_sorted + lo0).tolist()
        for a, b in zip(starts.tolist(), ends.tolist()):
            node = ctx.existing_nodes[int(es_sorted[a])]
            batch = [pods_sorted[i] for i in ei_list[a:b]]
            node.pods.extend(batch)
            for p in batch:
                ctx.existing_assignments[p.metadata.uid] = node.name
    for kind, e_idx, ce in exist_merges:
        req_d = ctx.kind_total(kind)
        pk = ctx.kind_ports(kind)
        for e, c in zip(e_idx, ce):
            node = ctx.existing_nodes[e]
            node.used = _merge_scaled(node.used, req_d, c)
            if pk:
                node.host_ports.extend(pk * c)
            nk = ctx.node_kinds.setdefault(e, {})
            nk[kind] = nk.get(kind, 0) + c
    # leftovers, in stream (= segment) order
    nmask = stream < 0
    if nmask.any():
        for i in np.flatnonzero(nmask).tolist():
            reason = NO_ROOM_REASON if stream[i] == ops_solver.NO_ROOM else NO_CLAIM_REASON
            ctx.unschedulable.append((pods_sorted[lo0 + i], reason))


def _apply_assignments(ctx, idx0: int, arr: np.ndarray) -> None:
    """Per-pod decode of a kind-scan segment: arr[i] is pod (idx0+i)'s
    E-space slot (existing node < E, claim E + global id) or a negative
    sentinel. Claims apply grouped by slot (a stable order, so each claim's
    pods and the order claims open match the sequential replay);
    existing-node landings merge usage one pod at a time; failures append
    in pod order."""
    E = ctx.E
    pods_sorted = ctx.pods_sorted
    kind_of = ctx.kind_of
    cm = arr >= E
    if cm.any():
        ci = np.flatnonzero(cm)
        cs = arr[ci] - E
        o = np.argsort(cs, kind="stable")
        cs_s = cs[o]
        ci_s = ci[o] + idx0
        bounds = np.flatnonzero(np.diff(cs_s)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(cs_s)]))
        for a, b in zip(starts.tolist(), ends.tolist()):
            s = int(cs_s[a])
            claim = ctx.ensure_claim(s)
            il = ci_s[a:b].tolist()
            batch = [pods_sorted[i] for i in il]
            claim.pods.extend(batch)
            ck = ctx.claim_kinds[s]
            for i, p in zip(il, batch):
                ctx.assignments[p.metadata.uid] = s
                k = int(kind_of[i])
                ck[k] = ck.get(k, 0) + 1
                pk = ctx.kind_ports(k)
                if pk:
                    claim.host_ports.extend(pk)
            ctx.claim_pod_counts[s] += b - a
    em = (arr >= 0) & (arr < E)
    if em.any():
        for i in np.flatnonzero(em).tolist():
            pod = pods_sorted[idx0 + i]
            k = int(kind_of[idx0 + i])
            e = int(arr[i])
            node = ctx.existing_nodes[e]
            node.used = res.merge(node.used, ctx.kind_total(k))
            node.pods.append(pod)
            node.host_ports.extend(ctx.kind_ports(k))
            nk = ctx.node_kinds.setdefault(e, {})
            nk[k] = nk.get(k, 0) + 1
            ctx.existing_assignments[pod.metadata.uid] = node.name
    nm = arr < 0
    if nm.any():
        for i in np.flatnonzero(nm).tolist():
            reason = NO_ROOM_REASON if arr[i] == ops_solver.NO_ROOM else NO_CLAIM_REASON
            ctx.unschedulable.append((pods_sorted[idx0 + i], reason))


def _decode_gang_segments(ctx, segs, f, gang_key_of_kind: dict) -> None:
    """Expand each gang segment: slice host j takes the contiguous rank
    block [j*f, (j+1)*f) and is marked with the gang's key; a gang that did
    not place fails every member together with one reason (the claims axis,
    its spill, or no template)."""
    for j, (lo, hi, kind) in enumerate(segs):
        count = hi - lo
        if count == 0:
            continue
        if int(f["leftover"][j]):
            st = int(f["status"][j])
            reason = (
                NO_ROOM_REASON if st == ops_solver.NO_ROOM
                else gang_mod.GANG_SPILL_REASON if st == ops_solver.GANG_SPILL
                else NO_CLAIM_REASON
            )
            ctx.unschedulable.extend((ctx.pods_sorted[i], reason) for i in range(lo, hi))
            continue
        fj = int(f["fill"][j])
        base = int(f["open_g"][j])
        pk = ctx.kind_ports(kind)
        for cj in range(int(f["n_opened"][j])):
            slot = base + cj
            claim = ctx.ensure_claim(slot)
            claim.gang = gang_key_of_kind.get(int(kind))
            batch = [ctx.pods_sorted[i] for i in range(lo + cj * fj, lo + min((cj + 1) * fj, count))]
            claim.pods.extend(batch)
            for p in batch:
                ctx.assignments[p.metadata.uid] = slot
            if pk:
                claim.host_ports.extend(pk * len(batch))
            ck = ctx.claim_kinds[slot]
            ck[kind] = ck.get(kind, 0) + len(batch)
            ctx.claim_pod_counts[slot] += len(batch)


def _fold_narrowing(vocab, topo_kids: tuple, reqs: Requirements, mask_r, inf_r, def_r, what: str) -> None:
    """Intersect the device's vocab-key topology narrowing into host
    requirements. Rows are gathered to the topo_kids axis (row j = key
    topo_kids[j]); a key the device never narrowed equals the host-side
    intersection already rebuilt, so the add is an exact no-op there."""
    for j, kid in enumerate(topo_kids):
        if not def_r[j] or inf_r[j]:
            continue
        key = vocab.keys[kid]
        vals = [v for vi, v in enumerate(vocab.values[kid]) if mask_r[j, vi]]
        if not vals:
            raise RuntimeError(f"device narrowed {key} to the empty set on {what}")
        reqs.add(Requirement.new(key, Operator.IN, *vals))


class TorchScheduler:
    """One scheduler per template/catalog set, reusable across solve()
    calls (the vocab may grow between calls). Runs on `device` ("cuda" by
    default; raises when CUDA is absent — pass device="cpu" for the plain
    CPU path). plain=True runs the kernels' plain versions on the device
    (a comparison run). reserved_mode ("fallback" or "strict"),
    reserved_capacity_enabled, min_values_policy ("Strict" or
    "BestEffort") and objective (a placement objective of
    objectives.POLICIES; None: KTPU_OBJECTIVE, else lexical) are the
    reference's settings of the same names; dp is its mesh's dp extent
    (1: no speculation; KTPU_SHARD_DP / _KSCAN / _EXISTING / _PERPOD = 0
    opt out as in the reference)."""

    def __init__(
        self,
        templates: list[ClaimTemplate],
        max_claims: Optional[int] = None,
        device="cuda",
        plain: bool = False,
        reserved_mode: str = "fallback",
        reserved_capacity_enabled: bool = True,
        min_values_policy: str = "Strict",
        objective: Optional[str] = None,
        dp: int = 1,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchScheduler: CUDA is not available (pass device='cpu' to run on the CPU)"
            )
        self.plain = plain
        self.reserved_mode = reserved_mode
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.min_values_policy = min_values_policy
        self.templates = templates
        self.max_claims = max_claims
        self.existing_nodes: list[ExistingSimNode] = []
        # union catalog over all templates, stable order, deduped by name
        seen: dict[str, InstanceType] = {}
        for t in templates:
            for it in t.instance_types:
                seen.setdefault(it.name, it)
        self.catalog: list[InstanceType] = list(seen.values())
        self._it_index = {name: i for i, name in enumerate(seen)}
        self._tmpl_it_idx: dict = {}
        # pipeline chunking and boundary compaction (the reference's rule:
        # ~4 dispatch groups at P >= 4096, compaction from P >= 1024)
        self.pipeline_chunks = int(os.environ.get("KTPU_PIPELINE_CHUNKS", "4"))
        self.pipeline_min_pods = int(os.environ.get("KTPU_PIPELINE_MIN_PODS", "4096"))
        self.compact_min_pods = 1024
        self.solve_chunk = 2048  # per-pod chunk length (the reference's KTPU_SOLVE_CHUNK default)
        self._n_claims_override: Optional[int] = None
        self._last_n_claims: Optional[int] = None
        self.last_timings: dict = {}
        self.last_stats: dict = {}
        self.encoder = ProblemEncoder(device=self.device)
        for t in templates:
            self.encoder.observe_requirements(t.requirements)
        for it in self.catalog:
            self.encoder.observe_instance_type(it)
        self._vocab_sig: Optional[tuple] = None
        self._universe_base: Optional[dict] = None
        self._pad_buckets: dict = {}  # pad buckets handed out, per axis kind
        # per solve: the pool budgets, volume-topology alternatives, CSI
        # volumes per pod uid and reservation ids already taken
        self.budgets: dict = {}
        self._volume_reqs: dict = {}
        self._pod_vols: dict = {}
        self._reserved_in_use: dict = {}
        # resident-session capture: while a ResidentSession wraps this
        # scheduler, full solves keep their final device state and decode
        # bookkeeping here, so that delta rounds resume from them
        self._capture = False
        self._captured: Optional[dict] = None
        # elementwise max of the r_min vectors boundary compaction used this
        # solve — the session's eviction floor (an arrival below it could
        # have fit a claim the solve evicted)
        self._last_compact_rmin: Optional[np.ndarray] = None
        # placement objective: resolved per solve; the rank and price
        # columns derive from the catalog encode and reset with it
        self.objective = objective
        self._active_policy = "lexical"
        self._objective_ranks: dict = {}
        self._price_t: Optional[torch.Tensor] = None
        # dp speculation: the reference's mesh dp extent (1 = none) and its
        # opt-outs, read as the reference reads them
        if dp < 1:
            raise ValueError(f"TorchScheduler: dp={dp} must be at least 1")
        self.dp = dp
        self.shard_dp = os.environ.get("KTPU_SHARD_DP", "1") not in ("0", "false")
        self.shard_kscan = os.environ.get("KTPU_SHARD_KSCAN", "1") not in ("0", "false")
        self.shard_existing = os.environ.get("KTPU_SHARD_EXISTING", "1") not in ("0", "false")
        self.shard_perpod = os.environ.get("KTPU_SHARD_PERPOD", "1") not in ("0", "false")
        self._shard_stats: Optional[dict] = None
        # the pipelined decode: the solve's chunk sink, its per-dispatch
        # events (on the card), the side stream its fetches run on
        self._chunk_sink = None
        self._dispatch_events: list = []
        self._side_stream = None
        self._t_fetch_done: Optional[float] = None
        self._pipeline_stats: Optional[dict] = None
        self._last_fetched: dict = {}

    def resident_session(self):
        """Wrap this scheduler in a ResidentSession: the solver state stays
        on the device across solve() calls and steady rounds feed only the
        pod delta through it."""
        from karpenter_tpu_torch.controllers.provisioning.resident import ResidentSession

        return ResidentSession(self)

    # -- encoding ----------------------------------------------------------

    def _sig(self) -> tuple:
        v = self.encoder.vocab
        return (v.n_keys, tuple(len(vals) for vals in v.values), self.encoder.n_resources)

    def _pads(self) -> tuple[int, int]:
        v = self.encoder.vocab
        return _next_pow2(max(v.n_keys, 1), 8), _next_pow2(max(v.max_values, 1), 8)

    def _encode_static(self) -> None:
        """(Re-)encode instance types + templates against the current vocab."""
        enc = self.encoder
        dev = self.device
        k_pad, v_pad = self._pads()
        self.it_tensors = enc.encode_instance_types(self.catalog, k_pad, v_pad)
        T = len(self.catalog)
        G = len(self.templates)
        tmpl_reqs = enc.encode_requirements([t.requirements for t in self.templates], k_pad, v_pad)
        its = np.zeros((G, T), dtype=bool)
        daemon = np.zeros((G, enc.n_resources), dtype=np.float32)
        for g, t in enumerate(self.templates):
            for it in t.instance_types:
                its[g, self._it_index[it.name]] = True
            daemon[g] = enc.resources_vector(t.daemon_requests)
        # minValues floors from the templates (pods never carry them): key -1
        # counts instance-type names, key j >= 0 the j-th other min-keyed
        # label, whose values per type sit in the [T, J, V] slab — each
        # type's raw value set for the key, for NotIn too (Values(),
        # requirement.go:282-284, as satisfies_min_values counts)
        mv_keys_named: list[str] = []
        mv_lists = []
        for t in self.templates:
            entries = []
            for r in t.requirements.values():
                if r.min_values is None:
                    continue
                if r.key == l.LABEL_INSTANCE_TYPE:
                    entries.append((-1, r.min_values))
                else:
                    if r.key not in mv_keys_named:
                        mv_keys_named.append(r.key)
                    entries.append((mv_keys_named.index(r.key), r.min_values))
            mv_lists.append(entries)
        M = _next_pow2(max((len(e) for e in mv_lists), default=1), 1)
        mv_key = np.full((G, M), -2, dtype=np.int32)
        mv_min = np.zeros((G, M), dtype=np.int32)
        for g, entries in enumerate(mv_lists):
            for m, (k, v) in enumerate(entries):
                mv_key[g, m] = k
                mv_min[g, m] = v
        mv_it_values = np.zeros((T, max(len(mv_keys_named), 1), v_pad), dtype=bool)
        for j, key_name in enumerate(mv_keys_named):
            kid = enc.vocab.key_to_id.get(key_name)
            if kid is None:
                continue
            for t_idx, it in enumerate(self.catalog):
                if not it.requirements.has(key_name):
                    continue
                for v in it.requirements.get(key_name).values:
                    vid = enc.vocab.value_to_id[kid].get(v)
                    if vid is not None:
                        mv_it_values[t_idx, j, vid] = True
        self._mv_active = any(mv_lists)
        self.template_tensors = ops_solver.Templates(
            reqs=tmpl_reqs,
            its=as_tensor(its, dev),
            daemon_requests=as_tensor(daemon, dev),
            valid=torch.ones(G, dtype=torch.bool, device=dev),
            # per-solve budgets are patched in by _encode
            budget=torch.full((G, enc.n_resources), float("inf"), dtype=torch.float32, device=dev),
            nodes_budget=torch.full((G,), float("inf"), dtype=torch.float32, device=dev),
            mv_key=as_tensor(mv_key, dev),
            mv_min=as_tensor(mv_min, dev),
            mv_it_values=as_tensor(mv_it_values, dev),
        )
        wk = enc.vocab.well_known_mask()
        self.well_known = as_tensor(np.pad(wk, (0, k_pad - len(wk)), constant_values=False), dev)
        # the per-pod kernel's packed type tables, once per encode (the
        # plain path never reads them)
        self.perpod_tables = (
            ops_cuda.perpod_tables(self.it_tensors, self.template_tensors.its, self.template_tensors.mv_it_values)
            if dev.type == "cuda" and not self.plain else None
        )
        # the reserved-capacity vocabulary (reservationmanager.go:40-47);
        # capacities are read per solve
        self._rid_kid, self._res_vid, self._rid_names = enc.reservation_ids()
        self._res_active = (
            self.reserved_capacity_enabled and self._rid_kid >= 0 and self._res_vid >= 0
            and bool(self.it_tensors.res_ofs.any())
        )
        self._objective_ranks = {}
        self._price_t = None
        self._vocab_sig = self._sig()

    def _encode_budgets(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The pools' remaining limits per template ([G, R] resources, [G]
        nodes; +inf where a pool sets none)."""
        enc = self.encoder
        G = len(self.templates)
        budget = np.full((G, enc.n_resources), np.inf, dtype=np.float32)
        nodes_budget = np.full(G, np.inf, dtype=np.float32)
        for g, t in enumerate(self.templates):
            pool_budget = self.budgets.get(t.nodepool_name)
            if pool_budget is not None:
                for k, v in pool_budget.items():
                    if k == "nodes":
                        nodes_budget[g] = v
                    elif k in enc.resource_names:
                        budget[g, enc.resource_names.index(k)] = v
        return as_tensor(budget, self.device), as_tensor(nodes_budget, self.device)

    def _res_cap0(self) -> np.ndarray:
        """[RID] i32 reservation capacities for this solve: the catalog's
        counts minus the ids pinned by claims not launched yet."""
        cap0 = np.zeros(self.it_tensors.res_ofs.shape[1], dtype=np.int32)
        if self._rid_names:
            rm = ReservationManager(self.catalog)
            for i, rid in enumerate(self._rid_names):
                cap0[i] = rm.capacity.get(rid, 0)
            for rid, n in self._reserved_in_use.items():
                if rid in self._rid_names:
                    i = self._rid_names.index(rid)
                    cap0[i] = max(cap0[i] - n, 0)
        return cap0

    def _flags(self) -> ops_solver.PerPodFlags:
        """The per-pod scan's minValues and reservation flags (BestEffort
        never enforces floors in the solve; the decode relaxes them,
        nodeclaim.go:606-613)."""
        return ops_solver.PerPodFlags(
            mv_active=self._mv_active and self.min_values_policy != "BestEffort",
            res_active=self._res_active, res_strict=self.reserved_mode == "strict",
            rid_kid=self._rid_kid, res_vid=self._res_vid,
        )

    def _encode_existing(self, e_pad: int) -> ops_solver.ExistingNodes:
        enc = self.encoder
        dev = self.device
        k_pad, v_pad = self._pads()
        reqs = ReqSetTensors.from_numpy(
            encode_requirements_np(
                enc.vocab,
                [n.requirements for n in self.existing_nodes]
                + [Requirements()] * (e_pad - len(self.existing_nodes)),
                k_pad, v_pad, enc.skip_keys,
            ),
            dev,
        )
        avail = np.zeros((e_pad, enc.n_resources), dtype=np.float32)
        for e, n in enumerate(self.existing_nodes):
            avail[e] = enc.resources_vector(n.available)
        valid = np.zeros(e_pad, dtype=bool)
        valid[: len(self.existing_nodes)] = True
        # ports and volumes: filled in by _encode_ports / _encode_volumes
        return ops_solver.ExistingNodes(
            reqs=reqs, avail=as_tensor(avail, dev), valid=as_tensor(valid, dev),
            ports=None, vols=None, vol_limits=None, vol_driver=None,
        )

    def _encode_ports(self, reps: list, exist_tensors):
        """The host-port vocabulary over the nodes' and the kinds' ports, and
        per kind its ports and the ports it conflicts with (same port and
        protocol, and the same IP or a wildcard on either side), packed 32
        per int32 lane: (exist_tensors with its ports, ports_k, conf_k)."""
        port_index: dict = {}
        for n in self.existing_nodes:
            for key in n.host_ports:
                port_index.setdefault(key, len(port_index))
        for p in reps:
            for h in p.spec.host_ports:
                port_index.setdefault(hostports.port_key(h), len(port_index))
        port_keys = list(port_index)
        U, E = len(reps), exist_tensors.avail.shape[0]
        NP = max(len(port_keys), 1)
        ports = np.zeros((U, NP), dtype=bool)
        conf = np.zeros((U, NP), dtype=bool)
        wild = hostports.WILDCARD_IP
        for u, p in enumerate(reps):
            for h in p.spec.host_ports:
                ip, port, proto = hostports.port_key(h)
                ports[u, port_index[(ip, port, proto)]] = True
                for j, (jip, jport, jproto) in enumerate(port_keys):
                    if port == jport and proto == jproto and (ip == wild or jip == wild or ip == jip):
                        conf[u, j] = True
        exist_ports = np.zeros((E, NP), dtype=bool)
        for e, n in enumerate(self.existing_nodes):
            for key in n.host_ports:
                exist_ports[e, port_index[key]] = True
        exist_tensors = exist_tensors._replace(ports=as_tensor(pack_bool_np(exist_ports), self.device))
        return exist_tensors, pack_bool_np(ports), pack_bool_np(conf)

    def _encode_volumes(self, reps: list, exist_tensors):
        """CSI attach limits (volumeusage.go:187-229): a (driver, PVC) column
        vocabulary over the drivers some node limits, shared by the nodes'
        usage and the kinds' volumes, plus a marker column that flags a
        kind carrying any volume (the check must run for it, even when all
        its volumes belong to unlimited drivers). Inert one-lane tensors
        when no node limits a driver or no kind carries a volume. Returns
        (exist_tensors with vols / vol_limits / vol_driver, vols_k)."""
        U, E = len(reps), exist_tensors.avail.shape[0]
        limited_drivers = {d for n in self.existing_nodes if n.volume_usage is not None for d in n.volume_usage.limits}
        pod_vols = self._pod_vols
        if limited_drivers and any(pod_vols.get(p.uid) for p in reps):
            col_index: dict = {}
            drv_index: dict = {}

            def vol_col(driver: str, pvc: str) -> None:
                if driver in limited_drivers:
                    drv_index.setdefault(driver, len(drv_index))
                    col_index.setdefault((driver, pvc), len(col_index))

            for n in self.existing_nodes:
                vu = n.volume_usage
                if vu is None:
                    continue
                for driver in vu.limits:
                    drv_index.setdefault(driver, len(drv_index))
                for vols in vu.pod_volumes.values():
                    for driver, pvcs in vols.items():
                        for pvc in pvcs:
                            vol_col(driver, pvc)
            for p in reps:
                for driver, pvcs in (pod_vols.get(p.uid) or {}).items():
                    for pvc in pvcs:
                        vol_col(driver, pvc)
            marker = len(col_index)
            NV = _next_pow2(len(col_index) + 1, 1)
            ND = _next_pow2(max(len(drv_index), 1), 1)
            vol_driver = np.zeros((NV, ND), dtype=bool)
            for (driver, _pvc), c in col_index.items():
                vol_driver[c, drv_index[driver]] = True
            exist_vols = np.zeros((E, NV), dtype=bool)
            vol_limits = np.full((E, ND), np.inf, dtype=np.float32)
            for e, n in enumerate(self.existing_nodes):
                vu = n.volume_usage
                if vu is None:
                    continue
                for driver, cap in vu.limits.items():
                    vol_limits[e, drv_index[driver]] = float(cap)
                for vols in vu.pod_volumes.values():
                    for driver, pvcs in vols.items():
                        for pvc in pvcs:
                            c = col_index.get((driver, pvc))
                            if c is not None:
                                exist_vols[e, c] = True
            vols_k = np.zeros((U, NV), dtype=bool)
            for u, p in enumerate(reps):
                vols = pod_vols.get(p.uid)
                if vols:
                    vols_k[u, marker] = True
                for driver, pvcs in (vols or {}).items():
                    for pvc in pvcs:
                        c = col_index.get((driver, pvc))
                        if c is not None:
                            vols_k[u, c] = True
        else:
            vol_driver = np.zeros((1, 1), dtype=bool)
            exist_vols = np.zeros((E, 1), dtype=bool)
            vol_limits = np.full((E, 1), np.inf, dtype=np.float32)
            vols_k = np.zeros((U, 1), dtype=bool)
        dev = self.device
        exist_tensors = exist_tensors._replace(
            vols=as_tensor(pack_bool_np(exist_vols), dev),
            vol_limits=as_tensor(vol_limits, dev),
            vol_driver=as_tensor(pack_bool_np(vol_driver.T), dev),
        )
        return exist_tensors, pack_bool_np(vols_k)

    def universe_base(self) -> dict:
        """The cached template/catalog half of the topology domain universe."""
        if self._universe_base is None:
            self._universe_base = template_universe_domains(self.templates)
        return self._universe_base

    def _check_supported(self, pods: Sequence[Pod]) -> None:
        """Raise UnsupportedProblem for what no ported engine runs: DRA
        claims (the volume checks are solve's and whatif_batch's, the gang
        classes _route_gangs', where the reference routes them)."""
        for p in pods:
            if p.spec.resource_claims:
                raise UnsupportedProblem(f"pod {p.name}: DRA resource claims")

    def _kind_sig(self, pod: Pod):
        """The pod-kind signature: its content, refined by its volume
        topology alternatives (pods of one kind share every encoded row)."""
        alts = self._volume_reqs.get(pod.uid)
        vol_sig = None if not alts else tuple(
            tuple((r.key, r.complement, tuple(sorted(r.values)), r.gte, r.lte)
                  for r in sorted(a.values(), key=lambda r: r.key))
            for a in alts
        )
        return (pod_content_sig(pod), vol_sig)

    def _pod_reqs(self, pod: Pod) -> Requirements:
        """The pod's requirements with its PVC's zone restriction folded in
        (volume topology narrows the node side, not the strict
        requirements that topology counting reads — volumetopology.go).
        Only single-alternative problems get here."""
        reqs = Requirements.from_pod(pod)
        alts = self._volume_reqs.get(pod.uid)
        if alts:
            reqs.add(*alts[0].values())
        return reqs

    def _kind_rows(self, reps: list, nodes: list, e_pad: int) -> dict:
        """The per-kind encoded rows of the kind representatives `reps` at
        the current pads: reqs / strict (numpy requirement encodings),
        it_allow [U, T], requests [U, R], tol [U, G] (template taints
        tolerated) and exist_ok [U, e_pad] (taints and the hostname /
        instance-type selectors against `nodes`). Shared by _encode and a
        resident session's arrival delta."""
        enc = self.encoder
        k_pad, v_pad = self._pads()
        U = len(reps)
        rep_reqs = [self._pod_reqs(p) for p in reps]
        row_memo: dict = {}
        reqs_np = encode_requirements_np(enc.vocab, rep_reqs, k_pad, v_pad, enc.skip_keys, row_memo=row_memo)
        strict_np = encode_requirements_np(
            enc.vocab, [Requirements.from_pod(p, include_preferred=False) for p in reps],
            k_pad, v_pad, enc.skip_keys, row_memo=row_memo,
        )
        it_allow = enc.it_allow_mask(rep_reqs, self.catalog)
        for u in range(U):
            # hostname selectors can never match a not-yet-named node
            if not enc.hostname_allows(rep_reqs[u], None):
                it_allow[u, :] = False
        requests = np.stack([enc.resources_vector(p.total_requests()) for p in reps]).astype(np.float32)
        tol = np.array(
            [[tolerates_all(t.taints, p.spec.tolerations) is None for t in self.templates] for p in reps],
            dtype=bool,
        ).reshape(U, len(self.templates))
        exist_ok = np.zeros((U, e_pad), dtype=bool)
        for e, n in enumerate(nodes):
            hostname = n.requirements.get(l.LABEL_HOSTNAME).any_value() or None
            it_name = (
                n.requirements.get(l.LABEL_INSTANCE_TYPE).any_value() or None
                if n.requirements.has(l.LABEL_INSTANCE_TYPE)
                else None
            )
            for u, p in enumerate(reps):
                rq = rep_reqs[u]
                ok = tolerates_all(n.taints, p.spec.tolerations) is None
                ok = ok and enc.hostname_allows(rq, hostname)
                if ok and rq.has(l.LABEL_INSTANCE_TYPE):
                    r = rq.get(l.LABEL_INSTANCE_TYPE)
                    ok = r.has(it_name) if it_name is not None else r.is_lenient()
                exist_ok[u, e] = ok
        return dict(reqs=reqs_np, strict=strict_np, it_allow=it_allow, requests=requests, tol=tol,
                    exist_ok=exist_ok)

    def _encode(self, pods: Sequence[Pod], budgets, topology: Optional[Topology] = None) -> tuple[list[Pod], dict]:
        """Encode one problem (the provisioning solve's, or the what-ifs'
        union problem). `topology` (seeded from bound pods by the caller) is
        used as given; without it one is built from the pods alone (lazy
        universe: a topology-free pod set never builds it). Its keys and
        domains join the vocab before the pads freeze."""
        dev = self.device
        pods_all = list(pods)
        # ---- gang partition: complete gangs form a rank-ordered prefix,
        # largest slice first; invalid gangs and gangs still waiting for
        # stragglers never enter the solve (reported first, in this order)
        gangs, singles, invalid = gang_mod.collect_gangs(pods_all)
        pre_unsched: list = list(invalid)
        gang_prefix: list = []
        gang_bounds: list = []  # (lo, hi, gang key) within the prefix
        for g in gang_mod.order_gangs(gangs):
            if not g.complete:
                pre_unsched.extend((p, gang_mod.GANG_WAITING_REASON) for p in g.pods_in_rank_order())
                continue
            lo_g = len(gang_prefix)
            gang_prefix.extend(g.pods_in_rank_order())
            gang_bounds.append((lo_g, len(gang_prefix), g.key))
        pods_list = gang_prefix + singles
        n_gang = len(gang_prefix)
        P = len(pods_list)
        cap = self.max_claims or _next_pow2(max(P, 1))
        if self._capture and not self.max_claims:
            # a resident session's base solve keeps claim-axis headroom for
            # the delta rounds that append into its claim space (results do
            # not depend on the axis)
            cap *= 2
        n_claims = self._n_claims_override or cap
        self._last_n_claims = n_claims
        if topology is None:
            topology = Topology.build(
                pods_all,
                lambda: build_universe_domains(
                    self.templates, self.existing_nodes, template_base=self.universe_base()
                ),
            )
        if topology.groups or topology.inverse_groups:
            for node in self.existing_nodes:
                topology.register(l.LABEL_HOSTNAME, node.name)
        for g in topology.groups + topology.inverse_groups:
            if g.key in self.encoder.skip_keys:
                continue
            self.encoder.vocab.add_key(g.key)
            for d in g.domains:
                self.encoder.vocab.add_value(g.key, d)
        # ---- FFD sort + pod-kind dedup ---------------------------------
        if P:
            # kinds refined by the volume restriction (the reference's _kind_sig)
            sig, sizes = ffd_keys(pods_list, self._kind_sig)
            # each gang is its own kind (negative ids never collide), and
            # only the singletons FFD-sort, ties by first appearance among them
            for gi, (lo_g, hi_g, _key) in enumerate(gang_bounds):
                sig[lo_g:hi_g] = -(gi + 1)
            _, first0, inv0 = np.unique(sig[n_gang:], return_index=True, return_inverse=True)
            ranks = np.argsort(np.argsort(first0))[inv0]
            order = np.concatenate(
                [np.arange(n_gang, dtype=np.int64), n_gang + np.lexsort((ranks, -sizes[n_gang:]))]
            )
            pods_sorted = [pods_list[i] for i in order]
            # kind ids numbered by first appearance in the SORTED sequence
            sig_sorted = sig[order]
            _, first1, inv1 = np.unique(sig_sorted, return_index=True, return_inverse=True)
            r1 = np.argsort(np.argsort(first1))
            kind_of = r1[inv1]
            reps = [pods_sorted[int(first1[u])] for u in np.argsort(r1)]
        else:
            pods_sorted = []
            kind_of = np.zeros(1, dtype=np.int64)
            reps = [Pod()]
        # kind -> gang key (the prefix keeps its positions through the sort)
        gang_key_of_kind = {int(kind_of[lo_g]): key for lo_g, _hi, key in gang_bounds}
        # vocab observation order: templates, catalog (constructor), topology
        # domains, then pod kinds, then existing nodes — value ids decide
        # mask layout
        for p in reps:
            self.encoder.observe_pod(p)
            for alt in self._volume_reqs.get(p.uid) or ():
                for r in alt.values():
                    self.encoder.vocab.add_key(r.key)
                    for v in r.values:
                        self.encoder.vocab.add_value(r.key, v)
        for n in self.existing_nodes:
            self.encoder.observe_requirements(n.requirements)
            self.encoder.observe_resources(n.available)
        if self._vocab_sig != self._sig():
            self._encode_static()
        self._check_supported(pods_all)
        self.budgets = {k: dict(v) for k, v in (budgets or {}).items()}
        budget, nodes_budget = self._encode_budgets()
        template_tensors = self.template_tensors._replace(budget=budget, nodes_budget=nodes_budget)
        # the placement objective, resolved per solve: its canonical rank on
        # every engine's tier-3 pick (lexical keeps weight order, no rank)
        self._active_policy = objectives.active_policy(self.objective)
        if self._active_policy != "lexical":
            template_tensors = template_tensors._replace(rank=self._objective_rank(self._active_policy))
        E = _next_pow2(max(len(self.existing_nodes), 1), 1)
        exist_tensors = self._encode_existing(E)
        U = len(reps)
        v_pad = self._pads()[1]
        enc = self.encoder
        rows = self._kind_rows(reps, self.existing_nodes, E)
        reqs_np, strict_np = rows["reqs"], rows["strict"]
        requests, tol, exist_ok = rows["requests"], rows["tol"], rows["exist_ok"]
        # topology tensors; the hostname slot space gets one spare column so
        # tier 3's fresh-slot read stays in bounds when every slot is open
        topo, vg, hg = topo_ops.encode_topology(
            topology, enc, E, n_claims + 1, [n.name for n in self.existing_nodes], v_pad, dev
        )
        pod_topo, rel = topo_ops.encode_pod_topology(
            topology, vg, hg, reps, as_tensor(strict_np[0], dev)
        )
        exist_tensors, ports_k, conf_k = self._encode_ports(reps, exist_tensors)
        exist_tensors, vols_k = self._encode_volumes(reps, exist_tensors)
        n_ports = exist_tensors.ports.shape[1]
        zone_kid, ct_kid = enc.zone_ct_key_ids()
        topo_kids = tuple(sorted({enc.vocab.key_to_id[g.key] for g in vg}))
        segments: list[tuple[int, int, int]] = []
        if P:
            ko = kind_of[:P]
            starts = np.concatenate(([0], np.flatnonzero(ko[1:] != ko[:-1]) + 1))
            ends = np.concatenate((starts[1:], [P]))
            segments = [(int(lo), int(hi), int(ko[lo])) for lo, hi in zip(starts, ends)]
        # under finite budgets, enforced minValues or reservations every
        # kind rides the per-pod scan (the reference's allow_fill)
        flags = self._flags()
        allow_fill = not flags.mv_active and not flags.res_active and not any(v for v in self.budgets.values())
        gang_kind, gang_vg_key = self._route_gangs(gang_key_of_kind, U, rel, vg, hg, flags)
        batchable, kscan_key = self._classify(reps, rel, vg, hg, allow_fill, gang_kind)
        kinds = dict(
            reqs=ReqSetTensors.from_numpy(reqs_np, dev),
            strict=ReqSetTensors.from_numpy(strict_np, dev),
            requests=as_tensor(requests, dev),
            tmpl_ok=as_tensor(tol, dev),
            it_allow=as_tensor(rows["it_allow"], dev),
            exist_ok=as_tensor(exist_ok, dev),
            ports=as_tensor(ports_k, dev),
            port_conf=as_tensor(conf_k, dev),
            vols=as_tensor(vols_k, dev),
            topo=pod_topo,
        )
        return pods_sorted, dict(
            kinds=kinds,
            requests_np=requests,
            kind_of=kind_of,
            segments=segments,
            batchable=batchable,
            kscan_key=kscan_key,
            gang_kind=gang_kind,
            gang_vg_key=gang_vg_key,
            gang_key_of_kind=gang_key_of_kind,
            kind_hg=(rel["hga"] | rel["hgr"]).any(axis=1),
            pre_unsched=pre_unsched,
            reps=reps,
            exist_tensors=exist_tensors,
            template_tensors=template_tensors,
            res_cap0=as_tensor(self._res_cap0(), dev),
            topo_tensors=topo,
            topology=topology,
            vg_groups=vg,
            hg_groups=hg,
            topo_kids=topo_kids,
            zone_kid=zone_kid,
            ct_kid=ct_kid,
            n_claims=n_claims,
            n_ports=n_ports,
            E=E,
            P=P,
        )

    def _route_gangs(self, gang_key_of_kind: dict, U: int, rel: dict, vg: list, hg: list, flags) -> tuple:
        """The gang kinds' route (the reference's, scheduler.py:2116-2176):
        (gang_kind [U] bool, gang_vg_key [U] — the ONE narrow vocab key a
        gang kind's groups share, -1 for none). Where the reference hands
        the solve to its host oracle (_GangHostRoute) this raises
        UnsupportedProblem with the reference's reason: enforced minValues,
        reservations, vocab-key groups over several keys or a key wider
        than KSCAN_D, hostname affinity or anti-affinity. (The reference's
        "gang" quarantine rung belongs to its guard package, which this
        package does not have.)"""
        gang_kind = np.zeros(U, dtype=bool)
        for k in gang_key_of_kind:
            gang_kind[k] = True
        gang_vg_key = np.full(U, -1, dtype=np.int64)
        if not gang_key_of_kind:
            return gang_kind, gang_vg_key
        vocab = self.encoder.vocab
        vga, vgr, hga, hgr = rel["vga"], rel["vgr"], rel["hga"], rel["hgr"]
        vkeys = [vocab.key_to_id[g.key] for g in vg]
        host_why = None
        if flags.mv_active:
            host_why = "gang under enforced minValues"
        elif flags.res_active:
            host_why = "gang under reservations"
        for u in np.flatnonzero(gang_kind).tolist():
            if host_why:
                break
            keys = {vkeys[j] for j in range(len(vg)) if vga[u, j] or vgr[u, j]}
            if len(keys) > 1:
                host_why = "gang vg groups span multiple vocab keys"
            elif keys:
                kid = next(iter(keys))
                if len(vocab.values[kid]) > ops_solver.KSCAN_D:
                    host_why = "gang vg key wider than KSCAN_D"
                else:
                    gang_vg_key[u] = kid
            for j in np.flatnonzero(hga[u] | hgr[u]).tolist():
                if hg[j].type is not TopologyType.SPREAD:
                    host_why = "gang hostname affinity/anti-affinity"
                    break
        if host_why:
            raise UnsupportedProblem(host_why)
        return gang_kind, gang_vg_key

    def _classify(self, reps: list, rel: dict, vg: list, hg: list, allow_fill: bool, gang_kind) -> tuple:
        """Route every singleton kind (the reference's batchability and
        kscan-key rules): a kind rides the fill scan unless it interacts
        with a vocab-key group or with an initially-empty hostname affinity
        group (whose bootstrap is ordered); such a kind rides the kind scan
        when every vocab-key group it applies to or records into shares ONE
        key with at most KSCAN_D values (kscan_key = that key), and the
        per-pod scan otherwise (kscan_key = -1). Without allow_fill every
        kind rides the per-pod scan. Gang kinds are never batchable."""
        U = len(reps)
        vga, vgr, hga = rel["vga"], rel["vgr"], rel["hga"]
        empty_aff = np.zeros(hga.shape[1], dtype=bool)
        for j, g in enumerate(hg):
            if g.type is TopologyType.AFFINITY and g.is_empty():
                empty_aff[j] = True
        batchable = np.array(
            [not vga[u].any() and not vgr[u].any() and not (hga[u] & empty_aff).any() for u in range(U)],
            dtype=bool,
        ) & allow_fill & ~gang_kind
        kscan_key = np.full(U, -1, dtype=np.int64)
        if not allow_fill:
            return batchable, kscan_key
        vocab = self.encoder.vocab
        vkeys = [vocab.key_to_id[g.key] for g in vg]
        for u in np.flatnonzero(~batchable).tolist():
            keys = {vkeys[j] for j in range(len(vg)) if vga[u, j] or vgr[u, j]}
            if len(keys) == 1:
                kid = next(iter(keys))
                if len(vocab.values[kid]) <= ops_solver.KSCAN_D:
                    kscan_key[u] = kid
        return batchable, kscan_key

    # -- solving -----------------------------------------------------------

    def _gather(self, enc: dict, segs: list) -> tuple[dict, torch.Tensor, ReqSetTensors]:
        k = enc["kinds"]
        kid = to_device(torch.as_tensor([s[2] for s in segs], dtype=torch.long), self.device)
        counts = to_device(torch.as_tensor([s[1] - s[0] for s in segs], dtype=torch.int32), self.device)
        rows = {f: k[f][kid] for f in ("requests", "tmpl_ok", "it_allow", "exist_ok", "ports", "port_conf", "vols")}
        rows["topo"] = topo_ops.take_pod_topology(k["topo"], kid)
        return rows, counts, ReqSetTensors(*(c[kid] for c in k["reqs"]))

    def _gather_fill_xs(self, enc: dict, segs: list) -> ops_solver.FillXs:
        """Kind -> segment row gather (the reference's `_gather_fill_xs`)."""
        rows, counts, reqs = self._gather(enc, segs)
        pt = rows.pop("topo")
        return ops_solver.FillXs(
            reqs=reqs, count=counts, hg_applies=pt.hg_applies, hg_records=pt.hg_records,
            hg_self=pt.hg_self, **rows,
        )

    def _gather_kind_xs(self, enc: dict, segs: list) -> ops_solver.KindXs:
        """Kind -> segment row gather (the reference's `_gather_kind_xs`)."""
        rows, counts, reqs = self._gather(enc, segs)
        pt = rows.pop("topo")
        return ops_solver.KindXs(
            reqs=reqs, strict_mask=pt.strict_mask, count=counts,
            vg_applies=pt.vg_applies, vg_records=pt.vg_records, vg_self=pt.vg_self,
            hg_applies=pt.hg_applies, hg_records=pt.hg_records, hg_self=pt.hg_self, **rows,
        )

    def _pad(self, kind: str, n: int, step: int) -> int:
        """The reference's PadBucketCache rule: a multiple of `step`,
        reusing the least bucket already handed out for `kind` that covers
        n under the pow2 ceiling."""
        n = max(n, 1)
        tight = max(step, -(-n // step) * step)
        ceiling = _next_pow2(n, step)
        known = self._pad_buckets.setdefault(kind, set())
        covering = [c for c in known if tight <= c <= ceiling]
        if covering:
            return min(covering)
        known.add(tight)
        return tight

    def _gather_pod_chunk(self, enc: dict, kidx: np.ndarray, n_valid: int) -> tuple:
        """Kind -> pod row gather for one per-pod chunk (the reference's
        `_gather_pod_chunk`); rows past n_valid are padding (valid False)."""
        k = enc["kinds"]
        kid = to_device(torch.as_tensor(kidx, dtype=torch.long), self.device)
        pods = ops_solver.PodTensors(
            reqs=ReqSetTensors(*(c[kid] for c in k["reqs"])),
            strict_reqs=ReqSetTensors(*(c[kid] for c in k["strict"])),
            requests=k["requests"][kid],
            valid=torch.arange(len(kidx), device=self.device) < n_valid,
        )
        rows = tuple(k[f][kid] for f in ("tmpl_ok", "it_allow", "exist_ok", "ports", "port_conf", "vols"))
        return (pods, *rows, topo_ops.take_pod_topology(k["topo"], kid))

    def _kscan_maxc(self, n: int) -> int:
        """The pod loop's assignment-buffer length (bucket "kscan_cap")."""
        return self._pad("kscan_cap", n, 64)

    def _pipeline_target(self, enc: dict) -> int:
        """Pods per dispatch group of the software-pipeline split; 0 when
        the solve is too small to split."""
        K_pipe = self.pipeline_chunks
        if K_pipe <= 1 or enc["P"] < max(self.pipeline_min_pods, 1):
            return 0
        return max(-(-enc["P"] // K_pipe), 1)

    def _runs(self, enc: dict) -> list:
        """Maximal runs of consecutive segments with one route — ("gang",
        key), ("fill",), ("kscan", key) or ("perpod",) — with big fill runs
        split into ~pipeline_chunks dispatches (the reference's
        software-pipeline split); gang, kscan and per-pod runs keep their
        exact segments."""
        batchable, kscan_key = enc["batchable"], enc["kscan_key"]
        gang_kind, gang_vg_key = enc["gang_kind"], enc["gang_vg_key"]
        runs: list = []
        for seg in enc["segments"]:
            k = seg[2]
            if gang_kind[k]:
                m = ("gang", int(gang_vg_key[k]))
            elif batchable[k]:
                m = ("fill",)
            else:
                m = ("kscan", int(kscan_key[k])) if kscan_key[k] >= 0 else ("perpod",)
            if runs and runs[-1][0] == m:
                runs[-1][1].append(seg)
            else:
                runs.append((m, [seg]))
        target = self._pipeline_target(enc)
        if not target:
            return runs
        split: list = []
        for mode, segs in runs:
            if mode[0] != "fill" or len(segs) <= 1:
                split.append((mode, segs))
                continue
            cur: list = []
            cur_pods = 0
            for seg in segs:
                cur.append(seg)
                cur_pods += seg[1] - seg[0]
                if cur_pods >= target:
                    split.append((mode, cur))
                    cur, cur_pods = [], 0
            if cur:
                split.append((mode, cur))
        return split

    def _initial_state(self, enc: dict) -> ops_solver.SolverState:
        """The empty carry of an encoded problem (window = the claims axis)."""
        return ops_solver.initial_state(
            enc["exist_tensors"], self.it_tensors, enc["template_tensors"], enc["topo_tensors"], enc["n_claims"],
            enc["n_ports"], enc["res_cap0"], window=enc["n_claims"], topo_kids=enc["topo_kids"],
        )

    def _gang_args(self, enc: dict, segs: list, key: int) -> tuple:
        """solve_gang's inputs for one gang run: (xs, maxg, key kwargs). One
        segment per gang, padded with count-0 rows to a "gang_segments"
        bucket; maxg the "gang_cap" bucket over the largest gang (a gang of
        N pods never opens more than N hosts)."""
        B_pad = self._pad("gang_segments", len(segs), 8)
        padded = list(segs) + [(0, 0, segs[0][2])] * (B_pad - len(segs))
        maxg = self._pad("gang_cap", max(hi - lo for lo, hi, _k in segs), 8)
        kw = dict(key_kid=-1, n_domains=1, tk_idx=-1)
        if key >= 0:
            kw = dict(key_kid=key, n_domains=len(self.encoder.vocab.values[key]), tk_idx=enc["topo_kids"].index(key))
        return self._gather_kind_xs(enc, padded), maxg, kw

    def _run_solve(self, enc: dict):
        """One dispatch per run (fill scan or kind scan) or per chunk of a
        per-pod run, with boundary compaction; with dp > 1 the dp merge
        loops take consecutive fill groups, split kind-scan runs and per-pod
        chunks. Returns the final state and the per-dispatch outputs
        ("fill", segs, ys, slot_of) / ("kscan", segs, ys) / ("pods", lo,
        hi, assignment) / ("gang", segs, ys), and per output the global
        template snapshot after it when the solve pipelines its decode."""
        n_claims = enc["n_claims"]
        topo_kids = enc["topo_kids"]
        state = self._initial_state(enc)
        runs = self._runs(enc)
        chunk = self.solve_chunk
        target = self._pipeline_target(enc)
        if target:
            chunk = min(chunk, max(target, 256))
        kind_of = enc["kind_of"]
        requests_np = enc["requests_np"]
        remaining = np.zeros(requests_np.shape[0], dtype=np.int64)
        for lo, hi, k in enc["segments"]:
            remaining[k] += hi - lo
        compact = enc["P"] >= self.compact_min_pods
        common = (
            enc["exist_tensors"], self.it_tensors, enc["template_tensors"], self.well_known,
            enc["topo_tensors"], enc["zone_kid"], enc["ct_kid"], n_claims,
        )
        outputs = []
        # per output, the global template column after it (the pipelined
        # decode's snapshots; None when the solve fetches once)
        tmpl_snaps: Optional[list] = [] if target else None
        self._dispatch_events = []
        n_compactions = 0
        n = dict.fromkeys(("fill", "kscan", "perpod", "gang", "perpod_dp"), 0)
        obj = dict.fromkeys(OBJECTIVE_STATS, 0)
        self._shard_stats = shard = _new_shard_stats(self.dp) if self.dp > 1 else None

        def maybe_compact(st):
            nonlocal n_compactions
            if not compact or not (remaining > 0).any():
                return st
            r_min = requests_np[remaining > 0].min(axis=0)
            prev = self._last_compact_rmin
            self._last_compact_rmin = r_min if prev is None else np.maximum(prev, r_min)
            st, _closed = ops_solver.compact_state(
                st, self.it_tensors, to_device(torch.from_numpy(np.array(r_min, order="C")), self.device), n_claims,
                plain=self.plain, topo_kids=topo_kids,
            )
            n_compactions += 1
            return st

        def done(st, out, pods_of):
            """Record one dispatch's output (with the pipelined decode's
            template snapshot and, on the card, an event after it), count its
            pods off and compact."""
            outputs.append(out)
            if tmpl_snaps is not None:
                tmpl_snaps.append(ops_solver.global_template(st))
                if st.template.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    self._dispatch_events.append(ev)
            if isinstance(pods_of, tuple):
                np.subtract.at(remaining, kind_of[pods_of[0]:pods_of[1]], 1)
            else:
                for lo_, hi_, k_ in pods_of:
                    remaining[k_] -= hi_ - lo_
            return maybe_compact(st)

        def fill_seq(st, segs):
            n["fill"] += 1
            xs = self._gather_fill_xs(enc, segs)
            if self._active_policy != "lexical":
                return self._run_fill_objective(enc, st, xs, common, obj)
            return ops_solver.solve_fill(st, xs, *common, plain=self.plain)

        def kscan_seq(st, segs, key):
            n["kscan"] += 1
            counts = [hi - lo for lo, hi, _k in segs]
            return ops_solver.solve_kind_scan(
                st, self._gather_kind_xs(enc, segs), *common,
                key_kid=key, n_domains=len(self.encoder.vocab.values[key]),
                maxc=self._kscan_maxc(max(counts)), counts=counts,
                requests_np=requests_np[[k for _lo, _hi, k in segs]], plain=self.plain,
            )

        def perpod_seq(st, clo, chi):
            n["perpod"] += 1
            L = chi - clo
            kidx = np.zeros(self._pad("perpod_pods", L, 8), dtype=np.int64)
            kidx[:L] = kind_of[clo:chi]
            *rows, pod_topo = self._gather_pod_chunk(enc, kidx, L)
            return ops_solver.solve_from(
                st, *rows, *common[:5], pod_topo, *common[5:], topo_kids=topo_kids, plain=self.plain,
                tables=self.perpod_tables, flags=self._flags(),
            )

        reasons = self._dp_reasons(enc)
        runs = self._dp_runs(runs, enc, reasons)
        dp_ctx = SimpleNamespace(enc=enc, common=common, done=done, fill_seq=fill_seq, kscan_seq=kscan_seq,
                                 perpod_seq=perpod_seq, n=n)
        for mode, segs in runs:
            if mode[0] == "gang":
                self._shard_eligible("gang", "sequential", "gang_atomic")
                xs, maxg, gang_kw = self._gang_args(enc, segs, mode[1])
                state, ys = ops_solver.solve_gang(state, xs, *common, maxg=maxg, plain=self.plain, **gang_kw)
                n["gang"] += 1
                state = done(state, ("gang", segs, ys), segs)
            elif mode[0] == "perpod":
                lo, hi = segs[0][0], segs[-1][1]
                chunks = [(clo, min(clo + chunk, hi)) for clo in range(lo, hi, chunk)]
                if not reasons["perpod"] and len(chunks) >= 2:
                    state = self._run_perpod_dp(dp_ctx, state, chunks)
                    continue
                for clo, chi in chunks:
                    self._shard_eligible("perpod", "sequential", reasons["perpod"] or "single_chunk")
                    state, assignment = perpod_seq(state, clo, chi)
                    state = done(state, ("pods", clo, chi, assignment), (clo, chi))
            elif mode[0] in ("fill", "fill_dp"):
                groups = segs if mode[0] == "fill_dp" else [segs]
                if mode[0] == "fill_dp" and self._active_policy == "lexical":
                    state = self._run_fill_dp(dp_ctx, state, groups)
                    continue
                for g in groups:
                    if self._active_policy == "lexical":
                        self._shard_eligible(self._fill_family(enc, g), "sequential",
                                             reasons["fill"] or "single_group")
                    state, ys = fill_seq(state, g)
                    state = done(state, ("fill", g, ys, state.slot_of), g)
            elif mode[0] == "kscan_dp":
                state = self._run_kscan_dp(dp_ctx, state, mode[1], segs)
            else:
                self._shard_eligible("kscan", "sequential", reasons["kscan"] or "single_group")
                state, ys = kscan_seq(state, segs, mode[1])
                state = done(state, ("kscan", segs, ys), segs)
        self.last_stats = dict(
            segments=len(enc["segments"]), groups=len(runs), fill_dispatches=n["fill"],
            kscan_dispatches=n["kscan"], perpod_dispatches=n["perpod"], perpod_dp_rounds=n["perpod_dp"],
            gang_dispatches=n["gang"], compactions=n_compactions, policy=self._active_policy, **obj,
        )
        if shard is not None:
            self.last_stats["shard"] = shard
        return state, outputs, tmpl_snaps

    # -- dp speculation ------------------------------------------------------

    def _dp_reasons(self, enc: dict) -> dict:
        """Per family ("fill", "kscan", "perpod") the first failed dp-
        eligibility conjunct ("" when eligible; the reference's
        _dp_block_reason without its quarantine conjunct)."""

        def reason(family_flag: bool, optout: str) -> str:
            if not self._pipeline_target(enc):
                return "no_pipeline"
            if self.dp <= 1:
                return "no_dp_mesh"
            if not self.shard_dp:
                return "shard_dp_off"
            if not family_flag:
                return optout
            if not (self.shard_existing or not self.existing_nodes):
                return "existing_optout"
            return ""

        return dict(fill=reason(True, ""), kscan=reason(self.shard_kscan, "kscan_optout"),
                    perpod=reason(self.shard_perpod, "perpod_optout"))

    def _dp_runs(self, runs: list, enc: dict, reasons: dict) -> list:
        """Consecutive fill runs (the pipeline's groups) merge into one
        ("fill_dp",) item holding their segment lists; a kind-scan run
        splits into ("kscan_dp", key) chunk groups by a pod target sized to
        the run (reference scheduler.py:2596-2648)."""
        if not reasons["fill"]:
            merged, i = [], 0
            while i < len(runs):
                j = i
                while j < len(runs) and runs[j][0][0] == "fill":
                    j += 1
                if j - i >= 2:
                    merged.append((("fill_dp",), [segs for _m, segs in runs[i:j]]))
                    i = j
                    continue
                merged.append(runs[i])
                i += 1
            runs = merged
        if reasons["kscan"]:
            return runs
        out = []
        for mode, segs in runs:
            if mode[0] != "kscan" or len(segs) <= 1:
                out.append((mode, segs))
                continue
            target = max(-(-sum(hi - lo for lo, hi, _k in segs) // self.pipeline_chunks), 1)
            groups, cur, cur_pods = [], [], 0
            for seg in segs:
                cur.append(seg)
                cur_pods += seg[1] - seg[0]
                if cur_pods >= target:
                    groups.append(cur)
                    cur, cur_pods = [], 0
            if cur:
                groups.append(cur)
            out.append((("kscan_dp", mode[1]), groups) if len(groups) >= 2 else (mode, segs))
        return out

    def _fill_family(self, enc: dict, segs: list) -> str:
        """The speculation family of a fill group: "existing" when the solve
        has real existing nodes, else "topo_fill" when a kind of the group
        interacts with a hostname group, else "fill"."""
        if self.existing_nodes:
            return "existing"
        if any(bool(enc["kind_hg"][k]) for _lo, _hi, k in segs):
            return "topo_fill"
        return "fill"

    def _shard_eligible(self, family: str, path: str, reason: str = "") -> None:
        """Count a group's route in last_stats["shard"]["coverage"]: "dp"
        when it entered a merge round, "sequential" otherwise."""
        if self._shard_stats is not None:
            self._shard_stats["coverage"].setdefault(family, {"dp": 0, "sequential": 0})[path] += 1

    def _shard_round(self, n_rows: int, n_commit: int, word) -> None:
        """Count one merge round: its verdict fetch and the dp rows it
        committed, replayed and left idle."""
        st = self._shard_stats
        st["merge_rounds"] += 1
        st["verdict_fetches"] += 1
        st["verdict_bytes"] += int(word.nbytes)
        st["dp_rows_total"] += self.dp
        st["dp_rows_committed"] += n_commit
        st["dp_rows_replayed"] += n_rows - n_commit
        st["dp_rows_idle"] += self.dp - n_rows

    def _shard_account(self, family: str, committed: bool) -> None:
        self._shard_eligible(family, "dp")
        st = self._shard_stats
        st["groups_committed" if committed else "groups_replayed"] += 1
        st["families"][family]["committed" if committed else "replayed"] += 1

    def _fetch_verdict(self, word, n_rows: int) -> int:
        """The round's one host sync: fetch the packed word, count the round,
        return how many leading rows commit."""
        w = fetch_tree(dict(word=word))["word"]
        n_commit = leading_ones(w, n_rows)
        self._shard_round(n_rows, n_commit, w)
        return n_commit

    def _merge_loop(self, state, items: list, speculate, commit, replay, family):
        """The dp merge rounds shared by the three families: up to dp items
        speculate from the round base (padded to dp rows), one verdict word
        is fetched, the leading-ones prefix commits in order (each followed
        by compaction), exactly one refused item replays sequentially, and
        the next round starts from there."""
        gi = 0
        while gi < len(items):
            round_items = items[gi: gi + self.dp]
            base = state
            rows, word = speculate(base, round_items)
            n_commit = self._fetch_verdict(word, len(round_items))
            for r in range(n_commit):
                state = commit(state, base, rows, r, round_items[r])
                self._shard_account(family(round_items[r]), True)
            if n_commit < len(round_items):
                state = replay(state, round_items[n_commit])
                self._shard_account(family(round_items[n_commit]), False)
                gi += n_commit + 1
            else:
                gi += n_commit
        return state

    def _run_fill_dp(self, c, state, groups: list):
        """Consecutive fill groups through the dp merge loop (the
        reference's _run_fill_dp): a round's groups solve from the base
        (solve_fill_dp, short rounds padded with a count-0 group), commits
        graft through H14 (merge_shard_fill; the output's slot map is the
        row's shifted slot_of), a refusal replays through solve_fill."""
        enc = c.enc

        def speculate(base, round_groups):
            pad = [(0, 0, round_groups[0][0][2])]
            xs_rows = [self._gather_fill_xs(enc, g) for g in round_groups]
            xs_rows += [self._gather_fill_xs(enc, pad)] * (self.dp - len(round_groups))
            specs, yss, word = ops_solver.solve_fill_dp(base, xs_rows, *c.common, plain=self.plain)
            return (specs, yss), word

        def commit(state, base, rows, r, segs):
            merged, shifted = ops_solver.merge_shard_fill(state, rows[0][r], base, plain=self.plain)
            c.n["fill"] += 1
            return c.done(merged, ("fill", segs, rows[1][r], shifted), segs)

        def replay(state, segs):
            state, ys = c.fill_seq(state, segs)
            return c.done(state, ("fill", segs, ys, state.slot_of), segs)

        return self._merge_loop(state, groups, speculate, commit, replay, lambda g: self._fill_family(enc, g))

    def _run_kscan_dp(self, c, state, key: int, groups: list):
        """Kind-scan chunk groups of vocab key `key` through the dp merge
        loop (the reference's _run_kscan_dp): rows scan from the base with a
        fresh grid each (solve_kscan_dp), commits graft through H14's kscan
        mode (the assignment re-based), a refusal replays."""
        enc = c.enc
        requests_np = enc["requests_np"]
        D = len(self.encoder.vocab.values[key])

        def speculate(base, round_groups):
            rows = list(round_groups) + [[(0, 0, round_groups[0][0][2])]] * (self.dp - len(round_groups))
            counts = [[hi - lo for lo, hi, _k in g] for g in rows]
            maxc = self._kscan_maxc(max(max(cs) for cs in counts))
            specs, yss, word = ops_solver.solve_kscan_dp(
                base, [self._gather_kind_xs(enc, g) for g in rows], *c.common, key_kid=key, n_domains=D,
                maxc=maxc, counts_rows=counts, requests_rows=[requests_np[[k for _lo, _hi, k in g]] for g in rows],
                plain=self.plain,
            )
            return (specs, yss), word

        def commit(state, base, rows, r, segs):
            ys = rows[1][r]
            merged, _shifted, assign = ops_solver.merge_shard_kscan(state, rows[0][r], ys.assignment, base,
                                                                    plain=self.plain)
            c.n["kscan"] += 1
            return c.done(merged, ("kscan", segs, ys._replace(assignment=assign)), segs)

        def replay(state, segs):
            state, ys = c.kscan_seq(state, segs, key)
            return c.done(state, ("kscan", segs, ys), segs)

        return self._merge_loop(state, groups, speculate, commit, replay, lambda _g: "kscan")

    def _run_perpod_dp(self, c, state, chunks: list):
        """Consecutive per-pod chunks through the dp merge loop (the
        reference's _run_perpod_dp): a round's chunks run in one launch of
        the per-pod kernel in scenario mode (solve_perpod_dp, row r's pods
        at pod_idx[r] of one gathered block, zero-valid rows padding a
        short round), commits graft through H14's kscan mode, a refusal
        replays through solve_from."""
        enc = c.enc
        kind_of = enc["kind_of"]

        def speculate(base, round_chunks):
            L = self._pad("perpod_pods_dp", max(chi - clo for clo, chi in round_chunks), 8)
            kidx = np.zeros(self.dp * L, dtype=np.int64)
            valid = np.zeros((self.dp, L), dtype=bool)
            for r, (clo, chi) in enumerate(round_chunks):
                kidx[r * L: r * L + chi - clo] = kind_of[clo:chi]
                valid[r, : chi - clo] = True
            *rows, pod_topo = self._gather_pod_chunk(enc, kidx, self.dp * L)
            pod_idx = np.arange(self.dp * L, dtype=np.int32).reshape(self.dp, L)
            specs, assignment, word = ops_solver.solve_perpod_dp(
                base, *rows, as_tensor(pod_idx, self.device), as_tensor(valid, self.device), *c.common[:5],
                pod_topo, *c.common[5:], topo_kids=enc["topo_kids"], plain=self.plain, tables=self.perpod_tables,
                flags=self._flags(),
            )
            c.n["perpod_dp"] += 1
            return (specs, assignment), word

        def commit(state, base, rows, r, ch):
            merged, _shifted, assign = ops_solver.merge_shard_kscan(state, rows[0][r], rows[1][r], base,
                                                                    plain=self.plain)
            return c.done(merged, ("pods", ch[0], ch[1], assign), ch)

        def replay(state, ch):
            state, assignment = c.perpod_seq(state, *ch)
            return c.done(state, ("pods", ch[0], ch[1], assignment), ch)

        return self._merge_loop(state, chunks, speculate, commit, replay, lambda _ch: "perpod")

    # -- placement objectives ------------------------------------------------

    def _objective_price_t(self) -> torch.Tensor:
        """[T] f32 per-type min offering price (+inf unpriced), cached until
        the next catalog encode."""
        if self._price_t is None:
            self._price_t = type_price_column(self.it_tensors)
        return self._price_t

    def _objective_rank(self, policy: str) -> torch.Tensor:
        """The policy's canonical [G] int32 rank on the device, cached per
        policy until the next catalog encode."""
        r = self._objective_ranks.get(policy)
        if r is None:
            r = self._objective_ranks[policy] = as_tensor(obj_scoring.canonical_rank(policy, self.templates),
                                                          self.device)
        return r

    def _objective_variant_ranks(self, policy: str, kv: int) -> torch.Tensor:
        """[KV, G] int32 rank variants (row 0 canonical), cached per (policy,
        kv); KV clamps to G."""
        key = (policy, "variants", kv)
        r = self._objective_ranks.get(key)
        if r is None:
            base = obj_scoring.canonical_rank(policy, self.templates)
            r = self._objective_ranks[key] = as_tensor(obj_scoring.variant_ranks(base, kv), self.device)
        return r

    def _run_fill_objective(self, enc: dict, state, xs, common: tuple, stats: dict):
        """One fill group under the K-variant objective dispatch (the
        reference's _run_fill_objective with one device): KV rank variants
        solved from the same base (solve_fill_variants), one 4-byte verdict
        word fetched; the winner commits (w_hw = max(w_hw, its w_open)) and
        its FillYs decode against the committed slot_of; with no feasible
        variant the group replays through solve_fill under the canonical
        rank; with dp > 1 each round counts as a merge round in
        last_stats["shard"] and the variants default to dp. Returns (state, ys)."""
        policy = self._active_policy
        kv = objectives.variant_count(self.dp)
        ranks = self._objective_variant_ranks(policy, kv)
        states, yss, word, _scores = ops_solver.solve_fill_variants(
            state, xs, *common[:5], ranks, self._objective_price_t(), *common[5:],
            objective=objectives.objective_id(policy), plain=self.plain,
        )
        w = int(fetch_tree(dict(word=word))["word"][0]) & 0xFFFFFFFF
        stats["verdict_fetches"] += 1
        stats["verdict_bytes"] += 4
        if self._shard_stats is not None:
            for k, v in (("merge_rounds", 1), ("verdict_fetches", 1), ("verdict_bytes", 4)):
                self._shard_stats[k] += v
        stats["variant_solves"] += ranks.shape[0]
        if w & ((1 << 24) - 1):
            winner = (w >> 24) & 0xFF
            stats["objective_committed"] += 1
            stats["wins_canonical" if winner == 0 else "wins_perturbed"] += 1
            return ops_solver.commit_variant(state, states[winner]), yss[winner]
        stats["objective_replayed"] += 1
        return ops_solver.solve_fill(state, xs, *common, plain=self.plain)

    def _solve_once(self, pods: Sequence[Pod], existing_nodes, budgets, topology=None) -> SchedulingResult:
        if self._chunk_sink is not None:
            # a fresh round invalidates every chunk streamed so far
            self._chunk_sink(("reset", None))
        t0 = time.perf_counter()
        self.existing_nodes = existing_nodes
        self._last_compact_rmin = None
        pods_sorted, enc = self._encode(pods, budgets, topology)
        t1 = time.perf_counter()
        state, outputs, tmpl_snaps = self._run_solve(enc)
        self._t_fetch_done = None
        self._pipeline_stats = None
        out = self._decode(pods_sorted, enc, outputs, state, tmpl_snaps)
        t3 = time.perf_counter()
        # on the pipelined path device_s ends at the first group's fetch, so
        # decode_s holds the later groups' (hidden) device time
        t2 = self._t_fetch_done or t1
        self.last_timings = dict(encode_s=t1 - t0, device_s=t2 - t1, decode_s=t3 - t2)
        if self._pipeline_stats is not None:
            self.last_timings["pipeline"] = self._pipeline_stats
        fetched = self._last_fetched
        self.last_stats.update(
            n_open=int(fetched["n_open"]),
            live_hw=int(fetched["w_hw"]),
            resident=int(fetched["w_open"]),
            frozen=int(fetched["n_open"]) - int(fetched["w_open"]),
            n_claims=enc["n_claims"],
        )
        return out

    def solve(
        self,
        pods: Sequence[Pod],
        existing_nodes: Optional[list[ExistingSimNode]] = None,
        budgets: Optional[dict[str, dict[str, float]]] = None,
        topology: Optional[Topology] = None,
        volume_reqs: Optional[dict] = None,
        reserved_mode: Optional[str] = None,
        reserved_in_use: Optional[dict[str, int]] = None,
        pod_volumes: Optional[dict] = None,
        topology_factory=None,
        deadline: Optional[float] = None,
        now=None,
        bound_pods=None,
        chunk_sink=None,
    ) -> SchedulingResult:
        """Schedule pods onto existing nodes and new claims, with the
        preference relaxation ladder and NO_ROOM recovery of the reference
        (the claims axis grows and the problem re-solves until every pod
        had a real chance at a slot). `topology`, when given (seeded from
        the pods bound to the existing nodes, as a consolidation
        simulation builds it), replaces the one built from the pods; every
        round solves on a pristine deep copy of it; `topology_factory`,
        when given instead, builds each round's topology from the round's
        pods (the reference's argument of the same name). `budgets` are the
        pools' remaining limits ({pool: {resource or "nodes": amount}}),
        `volume_reqs` each pod uid's volume-topology alternatives,
        `pod_volumes` each pod uid's CSI volumes ({driver: {pvc}}),
        `reserved_in_use` the reservation ids held by claims not launched
        yet, and `reserved_mode` overrides the scheduler's for this solve.
        `deadline` (on the clock `now`, time.monotonic by default) stops the
        relaxation ladder after the round that reaches it (the device solve
        itself is atomic); `bound_pods`, the data form of topology seeding,
        is accepted and unused by the in-process solve, as in the reference;
        `chunk_sink` is called with ("reset", None) at the start of every
        round and ("chunk", delta) after each decoded chunk group, a delta
        holding the claims' new pods as (slot, [uids]) and the new existing
        and unschedulable entries."""
        norm_vol = normalize_volume_reqs(volume_reqs)
        now_fn = now if now is not None else time.monotonic
        if any(len(alts) > 1 for alts in norm_vol.values()):
            # the reference's host oracle tries each alternative per pod
            raise UnsupportedProblem("volume topologies with several alternatives")
        if norm_vol and existing_nodes:
            keys = {r.key for alts in norm_vol.values() for a in alts for r in a.values()}
            if any(not n.requirements.has(k) for n in existing_nodes for k in keys):
                raise UnsupportedProblem("volume topology key undefined on an existing node")
        base_existing = list(existing_nodes or [])
        self._n_claims_override = None
        self._volume_reqs = norm_vol
        self._pod_vols = pod_volumes or {}
        self._reserved_in_use = reserved_in_use or {}
        round_dispatches = []  # per _solve_once: (its per-pod chunks, its gang runs)

        def solve_round(current: list[Pod]) -> SchedulingResult:
            while True:
                if topology_factory is not None:
                    topo = topology_factory(current)
                else:
                    topo = copy.deepcopy(topology) if topology is not None else None
                result = self._solve_once(current, [n.clone() for n in base_existing], budgets, topo)
                st = self.last_stats
                shard = st.get("shard") or {}
                round_dispatches.append((st["perpod_dispatches"], st["gang_dispatches"], st["perpod_dp_rounds"],
                                         shard.get("merge_rounds", 0), shard.get("groups_committed", 0)))
                cap = _next_pow2(max(len(current), 1))
                used = self._last_n_claims or self.max_claims or cap
                leftover = sum(1 for _, reason in result.unschedulable if reason == NO_ROOM_REASON)
                if used >= cap or not leftover:
                    return result
                # one-shot escalation sized from the measured claim density
                placed = max(len(current) - leftover, 1)
                est = int(used * len(current) / placed * 1.25) + 32
                self._n_claims_override = min(max(used * 2, -(-est // 256) * 256), cap)

        def should_stop() -> bool:
            return deadline is not None and now_fn() >= deadline

        prev_mode = self.reserved_mode
        if reserved_mode is not None:
            self.reserved_mode = reserved_mode
        self._chunk_sink = chunk_sink
        try:
            result = prefs.run_with_relaxation(list(pods), solve_round, should_stop)
        finally:
            self.reserved_mode = prev_mode
            self._chunk_sink = None
        # last_stats describe the last round (last_stats["shard"] too); these
        # count every round
        self.last_stats.update(
            rounds=len(round_dispatches),
            perpod_dispatches_all=sum(r[0] for r in round_dispatches),
            gang_dispatches_all=sum(r[1] for r in round_dispatches),
            perpod_dp_rounds_all=sum(r[2] for r in round_dispatches),
            merge_rounds_all=sum(r[3] for r in round_dispatches),
            dp_commits_all=sum(r[4] for r in round_dispatches),
        )
        return result

    # -- batched consolidation what-ifs -------------------------------------

    def whatif_batch(
        self,
        pods: Sequence[Pod],
        existing_nodes: list[ExistingSimNode],
        budgets: Optional[dict[str, dict[str, float]]],
        scenarios: list[tuple[set, set, set]],
        topology_factory,
        volume_reqs: Optional[dict] = None,
        reserved_in_use: Optional[dict[str, int]] = None,
        bound_pods=None,
        pod_volumes: Optional[dict] = None,
    ) -> Optional[list[tuple[bool, int]]]:
        """Batched disruption what-ifs (the reference's whatif_batch,
        scheduler.py:1332-1487): S candidate exclusion sets solved in one
        device dispatch instead of S sequential simulations
        (multinodeconsolidation.go:136-183). `pods` is the union pod set
        (pending + every scenario's displaced pods); each scenario is
        (excluded node names, active pod uids, counted pod uids), and
        topology_factory(pods, excluded) builds the scenario's topology
        seeded from the pods bound to its surviving nodes. Returns
        (feasible, n_new_claims) per scenario, feasible meaning no counted
        pod went unscheduled.

        None where the reference returns None, so that the caller
        simulates the scenarios one by one: gang pods, volume topologies
        with several alternatives or a key some node leaves undefined, and
        scenarios whose topology groups differ from the first one's. DRA
        claims, which the port has not ported, raise UnsupportedProblem.
        `volume_reqs`, `pod_volumes` and `reserved_in_use` are solve's;
        `bound_pods` is the reference's data form for a remote engine and
        is not read."""
        t0 = time.perf_counter()
        vol = normalize_volume_reqs(volume_reqs)
        if any(len(alts) > 1 for alts in vol.values()):
            return None
        if vol and existing_nodes:
            keys = {r.key for alts in vol.values() for a in alts for r in a.values()}
            if any(not n.requirements.has(k) for n in existing_nodes for k in keys):
                return None
        pods = list(pods)
        if any(gang_mod.is_gang_pod(p) for p in pods):
            return None
        inputs = self._whatif_inputs(pods, existing_nodes, budgets, scenarios, topology_factory, vol,
                                     reserved_in_use, pod_volumes)
        if inputs is None:
            return None
        args, kwargs = inputs
        t1 = time.perf_counter()
        n_unsched, n_open = ops_solver.solve_whatif(*args, **kwargs)
        fetched = fetch_tree(dict(n_unsched=n_unsched, n_open=n_open))
        t2 = time.perf_counter()
        out = [(int(fetched["n_unsched"][s]) == 0, int(fetched["n_open"][s])) for s in range(len(scenarios))]
        self.last_timings = dict(encode_s=t1 - t0, device_s=t2 - t1, decode_s=time.perf_counter() - t2)
        return out

    def _whatif_inputs(self, pods: list, existing_nodes, budgets, scenarios, topology_factory, volume_reqs=None,
                       reserved_in_use=None, pod_volumes=None):
        """solve_whatif's (args, kwargs) for whatif_batch: the union encode
        with scenario 0's topology, each scenario's compact pod list in FFD
        order, its surviving nodes and its topology seeds; None when a
        scenario's topology groups differ from scenario 0's. Sets
        last_stats (S, L, E, W, ...)."""
        self._volume_reqs = normalize_volume_reqs(volume_reqs)
        self._pod_vols = pod_volumes or {}
        self._reserved_in_use = reserved_in_use or {}
        # the what-if always runs unwindowed on the cold claims axis
        self._n_claims_override = None
        self.existing_nodes = [n.clone() for n in existing_nodes]
        topo0 = topology_factory(pods, scenarios[0][0])
        pods_sorted, enc = self._encode(pods, budgets, topo0)
        tt = enc["topo_tensors"]
        E, P, n_claims = enc["E"], enc["P"], enc["n_claims"]
        node_names = [n.name for n in self.existing_nodes]
        kidx = np.zeros(_next_pow2(max(P, 1), 1), dtype=np.int64)
        kidx[:P] = enc["kind_of"][:P]
        # the union's pod rows (the reference's _materialize_pods)
        pt, tol, it_allow, exist_ok, ports, port_conf, vols, pod_topo = self._gather_pod_chunk(enc, kidx, P)
        # each scenario's compact pod list, in FFD order: the scan length is
        # the largest scenario's, not the union's; both axes pad to powers
        # of two
        S = len(scenarios)
        S_pad = _next_pow2(S, 1)
        uids = [p.uid for p in pods_sorted]
        per_scenario = [[i for i, u in enumerate(uids) if u in active] for _ex, active, _counted in scenarios]
        L = _next_pow2(max((len(ix) for ix in per_scenario), default=1), 1)
        idx = np.zeros((S_pad, L), dtype=np.int32)
        active = np.zeros((S_pad, L), dtype=bool)
        counted = np.zeros((S_pad, L), dtype=bool)
        exist_valid = np.ones((S_pad, E), dtype=bool)
        vg0 = np.repeat(tt.vg_counts0.cpu().numpy()[None], S_pad, axis=0)
        hg0 = np.repeat(tt.hg_counts0.cpu().numpy()[None], S_pad, axis=0)
        for s, (excluded, _active, counted_uids) in enumerate(scenarios):
            for e, name in enumerate(node_names):
                exist_valid[s, e] = name not in excluded
            ix = per_scenario[s]
            idx[s, : len(ix)] = ix
            active[s, : len(ix)] = True
            counted[s, : len(ix)] = [uids[i] in counted_uids for i in ix]
            if s == 0:
                continue  # scenario 0's seeds are the encoded baseline
            topo_s = topology_factory(pods, excluded)
            for name in node_names:
                topo_s.register(l.LABEL_HOSTNAME, name)
            counts = topo_ops.encode_topology_counts(
                topo_s, self.encoder, E, n_claims + 1, node_names, tt.vg_counts0.shape[1],
                enc["vg_groups"], enc["hg_groups"],
            )
            if counts is None:
                # inverse anti-affinity groups come from bound pods, which
                # differ per exclusion set: the shared encode cannot hold
                # every scenario
                return None
            vg0[s], hg0[s] = counts
        dev = self.device
        self.last_stats = dict(scenarios=S, S=S_pad, L=L, E=E, W=n_claims, P=P)
        args = (
            *(as_tensor(a, dev) for a in (idx, active, counted, exist_valid, vg0, hg0)),
            pt, tol, it_allow, exist_ok, ports, port_conf, vols, enc["exist_tensors"], self.it_tensors,
            enc["template_tensors"], self.well_known, tt, pod_topo, enc["zone_kid"], enc["ct_kid"], n_claims,
        )
        return args, dict(
            topo_kids=enc["topo_kids"], plain=self.plain, tables=self.perpod_tables, res_cap0=enc["res_cap0"],
            flags=self._flags(),
        )

    # -- decoding ----------------------------------------------------------

    def _template_it_index(self, template):
        cached = self._tmpl_it_idx.get(id(template))
        if cached is None:
            its = list(template.instance_types)
            idx = np.array([self._it_index[it.name] for it in its], dtype=np.int64)
            cached = self._tmpl_it_idx[id(template)] = (its, idx)
        return cached

    def _decode_pipelined(self, groups, specs, flat, flat_spans, weights, tmpl_snaps, state, tk, read_group) -> dict:
        """The pipelined path (the reference's, scheduler.py:4181-4300):
        fetch and decode chunk group i while the card may still run the
        later groups. On the card each group's wire is packed (H15) and
        copied into pinned memory on a side stream that waits on the
        event recorded after the group's last dispatch, and the host waits
        on that copy alone. The last group's wire carries the final state
        reads. Returns last_timings["pipeline"]: the reference's keys
        (overlap_frac counts by position, in_flight = G - 1 - gi) and
        `true_overlap_groups`, the groups fetched and decoded before the
        solve's last dispatch had finished on the card (None on the CPU)."""
        G = len(groups)
        events = self._dispatch_events
        side = None
        if self.device.type == "cuda":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(device=self.device)
            side = self._side_stream
        chunk_stats: list[dict] = []
        true_overlap = 0
        for gi, (glo, ghi) in enumerate(groups):
            in_flight = G - 1 - gi
            last_group = gi == G - 1
            cpu0 = read_cpu_seconds()
            sg = tuple(specs[glo:ghi])
            f_lo, f_hi = flat_spans[glo][0], flat_spans[ghi - 1][1]
            t0 = time.perf_counter()
            after = events[ghi - 1] if events else None
            if last_group:
                leaves = _make_group_final_prep(sg, tk, self.plain)(tmpl_snaps[ghi - 1], flat[f_lo:f_hi], state)
                if side is not None:
                    # the state reads were just issued on the solve's stream
                    after = torch.cuda.Event()
                    after.record()
            else:
                leaves = _make_group_prep(sg)(tmpl_snaps[ghi - 1], flat[f_lo:f_hi])
            fetched_flat = fetch_async(leaves, after=after, stream=side).wait()
            t1 = time.perf_counter()
            if self._t_fetch_done is None:
                self._t_fetch_done = t1
            read_group(fetched_flat, glo, ghi, last_group, False)
            t2 = time.perf_counter()
            if events and not events[-1].query():
                true_overlap += 1
            chunk_stats.append(
                {
                    "idx": gi,
                    "pods": int(sum(weights[glo:ghi])),
                    "in_flight": in_flight,
                    "wire_s": t1 - t0,
                    "decode_s": t2 - t1,
                    "host_rss_mb": round(read_rss_bytes() / 2**20, 1),
                    "cpu_s": round(read_cpu_seconds() - cpu0, 4),
                }
            )
        # the reference's attribution: a chunk's wire + decode time is
        # overlapped when later groups were still in flight; chunk 0's wire
        # time (the wait for the card to finish it) counts on neither side
        t_final = 0.0

        def _chunk_cost(st):
            return (st["wire_s"] if st["idx"] > 0 else 0.0) + st["decode_s"]

        overlapped = sum(_chunk_cost(st) for st in chunk_stats if st["in_flight"])
        total = sum(_chunk_cost(st) for st in chunk_stats) + t_final
        return {
            "n_chunks": G,
            "overlap_frac": round(overlapped / total, 4) if total > 0 else 0.0,
            "fused_final": True,
            "sync_wire_s": round(chunk_stats[0]["wire_s"], 4),
            "wire_s": round(sum(st["wire_s"] for st in chunk_stats) + t_final, 4),
            "host_decode_s": round(sum(st["decode_s"] for st in chunk_stats), 4),
            "final_fetch_s": round(t_final, 4),
            "chunks": [
                {**st, "wire_s": round(st["wire_s"], 4), "decode_s": round(st["decode_s"], 4)}
                for st in chunk_stats
            ],
            "true_overlap_groups": true_overlap if events else None,
        }

    def _decode(self, pods_sorted: list[Pod], enc: dict, outputs: list, state, tmpl_snaps=None) -> SchedulingResult:
        """Claim-level decode (the reference's _decode): fetch the dispatch
        outputs, slimmed by the fetch preps, and replay the pod -> slot
        bookkeeping in dispatch order (fill grids expanded, kind-scan and
        per-pod assignments applied per pod), then finalize each claim's
        requirements (template + its pod kinds + hostname + the device's
        topology narrowing), usage (device carry) and viable instance types
        (device mask). A solve of P >= pipeline_min_pods with two or more
        outputs fetches and decodes group by group (rehydrate, apply_output,
        widen_fill, flush_chunk), the last group's wire carrying the final
        state reads; any other solve fetches once."""
        E = enc["E"]
        kind_of = enc["kind_of"]
        topo_kids = enc["topo_kids"]
        tk = tuple(topo_kids)
        vocab = self.encoder.vocab
        reps: list[Pod] = enc["reps"]
        flat: list = []  # device tensors, in prep order
        specs: list = []  # the outputs' structure, for the preps
        flat_spans: list = []  # per-output [lo, hi) into flat
        weights: list = []  # per-output decode weight (pods covered)
        for o in outputs:
            lo_f = len(flat)
            if o[0] == "pods":
                flat.append(o[3])
                specs.append(("pods",))
                weights.append(o[2] - o[1])
            elif o[0] == "kscan":
                flat.extend([o[2].assignment, o[2].grid_reused])
                specs.append(("kscan", len(o[1])))
                weights.append(sum(hi - lo for lo, hi, _ in o[1]))
            elif o[0] == "gang":
                ys = o[2]
                flat.extend([ys.open_g, ys.n_opened, ys.fill, ys.leftover, ys.status])
                specs.append(("gang", len(o[1])))
                weights.append(sum(hi - lo for lo, hi, _ in o[1]))
            else:
                ys = o[2]
                flat.extend([ys.fill_c, ys.fill_e, ys.open_start, ys.n_opened, ys.status, o[3]])
                specs.append(("fill", len(o[1])))
                weights.append(sum(hi - lo for lo, hi, _ in o[1]))
            flat_spans.append((lo_f, len(flat)))
        fetched: dict = {}
        tmpl_ref: list = [None]  # the template column in effect (a snapshot or the final one)
        claims: list[SimClaim] = []
        slot_to_claim: dict[int, SimClaim] = {}
        claim_kinds: dict[int, dict[int, int]] = {}
        node_kinds: dict[int, dict[int, int]] = {}
        # pods decided before the solve: invalid gangs and gangs waiting for
        # stragglers
        unschedulable: list[tuple[Pod, str]] = list(enc["pre_unsched"])
        assignments: dict[str, int] = {}
        existing_assignments: dict[str, str] = {}
        hostname_seq = 0
        U = len(reps)
        kind_reqs_c: list = [None] * U
        kind_total_c: list = [None] * U
        kind_ports_c: list = [None] * U

        def kind_reqs(k: int) -> Requirements:
            if kind_reqs_c[k] is None:
                kind_reqs_c[k] = self._pod_reqs(reps[k])
            return kind_reqs_c[k]

        def kind_ports(k: int) -> list:
            if kind_ports_c[k] is None:
                kind_ports_c[k] = [hostports.port_key(h) for h in reps[k].spec.host_ports]
            return kind_ports_c[k]

        def kind_total(k: int) -> dict:
            if kind_total_c[k] is None:
                kind_total_c[k] = reps[k].total_requests()
            return kind_total_c[k]

        def ensure_claim(slot: int) -> SimClaim:
            nonlocal hostname_seq
            claim = slot_to_claim.get(slot)
            if claim is None:
                tmpl = self.templates[int(tmpl_ref[0][slot])]
                hostname_seq += 1
                hostname = hostname_placeholder(hostname_seq)
                requirements = tmpl.requirements.copy()
                requirements.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, hostname))
                claim = SimClaim(
                    template=tmpl,
                    requirements=requirements,
                    used={},
                    instance_types=[],
                    pods=[],
                    slot=slot,
                    hostname=hostname,
                )
                slot_to_claim[slot] = claim
                claims.append(claim)
                claim_kinds[slot] = {}
            return claim

        ctx = SimpleNamespace(
            E=E,
            NC1=np.int64(enc["n_claims"] + 1),
            existing_nodes=self.existing_nodes,
            pods_sorted=pods_sorted,
            ensure_claim=ensure_claim,
            slot_to_claim=slot_to_claim,
            claim_kinds=claim_kinds,
            claim_pod_counts=np.zeros(enc["n_claims"], dtype=np.int64),
            assignments=assignments,
            existing_assignments=existing_assignments,
            unschedulable=unschedulable,
            node_kinds=node_kinds,
            kind_total=kind_total,
            kind_ports=kind_ports,
            kind_of=kind_of,
        )

        def apply_output(out) -> None:
            if out[0] == "pods":
                _, lo, hi, assignment = out
                _apply_assignments(ctx, lo, np.asarray(assignment[: hi - lo], dtype=np.int64))
            elif out[0] == "gang":
                _decode_gang_segments(ctx, out[1], out[2], enc["gang_key_of_kind"])
            elif out[0] == "kscan":
                _, segs, assign, _grid_reused = out
                for j, (lo, hi, _kind) in enumerate(segs):
                    _apply_assignments(ctx, lo, np.asarray(assign[j][: hi - lo], dtype=np.int64))
            else:
                _decode_fill_segments(ctx, out[1], out[2])

        def rehydrate(o, spec, it_f):
            """Rebuild one output from its fetched host arrays (the preps'
            emission order); returns (output, is_fill)."""
            if spec[0] == "pods":
                return (o[0], o[1], o[2], next(it_f)), False
            if spec[0] == "kscan":
                return (o[0], o[1], next(it_f), next(it_f)), False
            names = ("open_g", "n_opened", "fill", "leftover", "status") if spec[0] == "gang" else (
                "fill_c", "fill_e", "open_start", "n_opened", "status", "slot_map")
            return (o[0], o[1], {n: next(it_f) for n in names}), spec[0] == "fill"

        def widen_fill(idx_range, new_outs) -> None:
            # a fill count overflowed the int16 narrowing (a claim admitted
            # >32k identical pods): refetch those grids at full width
            wide = {
                i: (WireLeaf(outputs[i][2].fill_c, len(o[1])), WireLeaf(outputs[i][2].fill_e, len(o[1])))
                for i, o in zip(idx_range, new_outs)
                if o[0] == "fill"
            }
            got = fetch_tree(wide)
            for i, o in zip(idx_range, new_outs):
                if o[0] == "fill":
                    o[2]["fill_c"], o[2]["fill_e"] = got[i]

        # chunk-sink deltas (the SolveStream): only rows appended since the
        # previous flush
        sink = self._chunk_sink
        emitted_claim: dict[int, int] = {}
        sink_marks = [0, 0]  # existing_assignments, unschedulable

        def flush_chunk() -> None:
            if sink is None:
                return
            delta_claims = []
            for claim in claims:
                n0 = emitted_claim.get(claim.slot, 0)
                if len(claim.pods) > n0:
                    delta_claims.append((claim.slot, [p.uid for p in claim.pods[n0:]]))
                    emitted_claim[claim.slot] = len(claim.pods)
            ea = list(existing_assignments.items())
            delta_exist = ea[sink_marks[0] :]
            sink_marks[0] = len(ea)
            delta_unsched = [(p.uid, r) for p, r in unschedulable[sink_marks[1] :]]
            sink_marks[1] = len(unschedulable)
            if delta_claims or delta_exist or delta_unsched:
                sink(("chunk", {"claims": delta_claims, "existing": delta_exist, "unsched": delta_unsched}))

        def read_group(fetched_flat, lo: int, hi: int, state_reads: bool, head: bool):
            """Rehydrate outputs [lo, hi) from one fetch; the state reads
            sit before them (`head`) or after them."""
            it_f = iter(fetched_flat)
            if state_reads and head:
                fetched.update((name, next(it_f)) for name in _STATE_HEAD)
            else:
                tmpl_ref[0] = next(it_f)
            new_outs = []
            any_fill = False
            for o, spec in zip(outputs[lo:hi], specs[lo:hi]):
                out, is_fill = rehydrate(o, spec, it_f)
                any_fill |= is_fill
                new_outs.append(out)
            fill_max = next(it_f) if any_fill else None
            if state_reads:
                if not head:
                    fetched.update((name, next(it_f)) for name in _STATE_HEAD)
                if tk:
                    fetched.update((name, next(it_f)) for name in _TK_NAMES)
                tmpl_ref[0] = fetched["template"]
            if fill_max is not None and int(fill_max) >= 2**15:
                widen_fill(range(lo, hi), new_outs)
            for out in new_outs:
                apply_output(out)
            flush_chunk()

        groups = None
        if tmpl_snaps is not None and len(outputs) >= 2:
            K = self.pipeline_chunks if self._pipeline_target(enc) else 0
            if K >= 2:
                groups = _partition_ranges(weights, K)
                if len(groups) < 2:
                    groups = None
        if groups is None:
            # single fetch: one wire, the state reads included
            prep = _make_fetch_prep(tuple(specs), tk, self.plain)
            fetched_flat = fetch_tree(prep(state, flat))
            self._t_fetch_done = time.perf_counter()
            read_group(fetched_flat, 0, len(outputs), True, True)
        else:
            self._pipeline_stats = self._decode_pipelined(
                groups, specs, flat, flat_spans, weights, tmpl_snaps, state, tk, read_group
            )
        self._last_fetched = fetched

        its_mask = fetched["its"]
        used_np = fetched["used"]
        held = fetched["held"]
        n_rid = len(self._rid_names)
        rids = self.encoder._resource_ids
        proto_cache: dict = {}
        its_cache: dict = {}
        for claim in claims:
            s = claim.slot
            ksig = tuple(sorted(claim_kinds[s]))
            tid = id(claim.template)
            memo = proto_cache.get((tid, ksig))
            if memo is None:
                proto = claim.template.requirements.copy()
                names = set(claim.template.daemon_requests)
                for k in ksig:
                    proto.add(*kind_reqs(k).values())
                    names.update(kind_total(k))
                names = sorted(names)
                ridx = np.array([rids[n] for n in names], dtype=np.int64)
                memo = proto_cache[(tid, ksig)] = (proto, names, ridx)
            proto, names, ridx = memo
            reqs = proto.copy()
            reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, claim.hostname))
            claim.requirements = reqs
            if topo_kids:
                _fold_narrowing(
                    vocab, topo_kids, reqs, fetched["c_mask"][s], fetched["c_inf"][s],
                    fetched["c_def"][s], f"claim slot {s}",
                )
            claim.used = dict(zip(names, used_np[s][ridx].tolist()))
            row = np.asarray(its_mask[s])
            ikey = (tid, row.tobytes())
            sel_list = its_cache.get(ikey)
            if sel_list is None:
                t_its, t_cat_idx = self._template_it_index(claim.template)
                sel = np.flatnonzero(row[t_cat_idx])
                sel_list = its_cache[ikey] = [t_its[i] for i in sel.tolist()]
            claim.instance_types = list(sel_list)
            # the reservations the scan holds for this claim
            if n_rid:
                claim.reserved_ids = frozenset(self._rid_names[r] for r in np.nonzero(held[s][:n_rid])[0])
            finalize_reserved(claim)
            if self.min_values_policy == "BestEffort":
                finalize_min_values(claim)

        for e, kinds in node_kinds.items():
            node = self.existing_nodes[e]
            for k in kinds:
                node.requirements.add(*kind_reqs(k).values())
            if topo_kids:
                _fold_narrowing(
                    vocab, topo_kids, node.requirements, fetched["e_mask"][e], fetched["e_inf"][e],
                    fetched["e_def"][e], f"existing node {node.name}",
                )
        # attach tracking of the pods that landed on existing nodes
        if self._pod_vols:
            by_name = {n.name: n for n in self.existing_nodes}
            for uid, node_name in existing_assignments.items():
                vols = self._pod_vols.get(uid)
                node = by_name.get(node_name)
                if vols and node is not None and node.volume_usage is not None:
                    node.volume_usage.add(uid, vols)
        result = SchedulingResult(
            claims=claims,
            unschedulable=unschedulable,
            assignments=assignments,
            existing=self.existing_nodes,
            existing_assignments=existing_assignments,
        )
        if self._capture:
            # a resident session's adoption material: the final device state
            # and the decode bookkeeping delta rounds extend; the relaxation
            # and NO_ROOM loops overwrite it each round, so it always matches
            # the returned result
            self._captured = dict(
                state=state,
                enc=enc,
                pods_sorted=list(pods_sorted),
                claims=claims,
                slot_to_claim=slot_to_claim,
                claim_kinds=claim_kinds,
                claim_pod_counts=ctx.claim_pod_counts,
                assignments=assignments,
                existing_assignments=existing_assignments,
                node_kinds=node_kinds,
                n_open=int(fetched["n_open"]),
                compact_rmin=self._last_compact_rmin,
            )
        return result
