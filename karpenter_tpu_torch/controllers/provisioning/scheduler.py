"""The scheduling engine: encode -> ops.solver (PyTorch + CUDA) -> decode.

A port of the JAX package's TPUScheduler (controllers/provisioning/
scheduler.py). Every pod kind routes as the reference routes it: selector
pods and hostname topology groups to the kind-level fill scan, kinds
whose vocab-key groups (zone spread, zone affinity) share ONE narrow key
to the zonal kind scan, and every other topology kind — vocab-key groups
over two or more keys, a key wider than KSCAN_D, an initially-empty
hostname affinity group — to the per-pod scan, in chunks. Under finite
NodePool budgets, enforced minValues or reservations every kind rides the
per-pod scan. Host ports, CSI attach limits and a PVC's single zone
alternative ride every route. The same FFD order, topology encode,
routing, chunking and compaction boundaries and decode give a result
equal to TPUScheduler.solve's. Gang members, DRA claims, volume
topologies with several alternatives and volume keys an existing node
leaves undefined raise UnsupportedProblem; nothing falls back to another
engine.
"""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

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
from karpenter_tpu_torch.ops.encode import (
    ProblemEncoder,
    ReqSetTensors,
    as_tensor,
    encode_requirements_np,
)
from karpenter_tpu_torch.ops.kernels import fetch_tree, pack_bool_np
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements
from karpenter_tpu_torch.scheduling import hostports
from karpenter_tpu_torch.scheduling.reservations import ReservationManager
from karpenter_tpu_torch.scheduling.taints import tolerates_all
from karpenter_tpu_torch.utils import resources as res

# NO_ROOM is a device-shape artifact: solve() grows the claims axis and
# re-solves, so this reason only surfaces if recovery is impossible
NO_ROOM_REASON = "claim-slot capacity exhausted; raise max_claims"
NO_CLAIM_REASON = "no compatible in-flight claim or template"

GANG_ANNOTATIONS = ("ktpu.dev/gang-name", "ktpu.dev/gang-size", "ktpu.dev/gang-rank")


class UnsupportedProblem(ValueError):
    """The problem needs a part of the solver this package has not ported
    (gang members, DRA claims, volume topologies with several alternatives
    or with a key an existing node leaves undefined)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _next_pow2(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
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
    reserved_capacity_enabled and min_values_policy ("Strict" or
    "BestEffort") are the reference's settings of the same names."""

    def __init__(
        self,
        templates: list[ClaimTemplate],
        max_claims: Optional[int] = None,
        device="cuda",
        plain: bool = False,
        reserved_mode: str = "fallback",
        reserved_capacity_enabled: bool = True,
        min_values_policy: str = "Strict",
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
        self.pipeline_chunks = 4
        self.pipeline_min_pods = 4096
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
        """Raise UnsupportedProblem for what no ported engine runs: gang
        members and DRA claims (the volume checks are solve's and
        whatif_batch's, where the reference routes them)."""
        for p in pods:
            if p.spec.resource_claims:
                raise UnsupportedProblem(f"pod {p.name}: DRA resource claims")
            if any(k in p.metadata.annotations for k in GANG_ANNOTATIONS):
                raise UnsupportedProblem(f"pod {p.name}: gang member")

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

    def _encode(self, pods: Sequence[Pod], budgets, topology: Optional[Topology] = None) -> tuple[list[Pod], dict]:
        """Encode one problem (the provisioning solve's, or the what-ifs'
        union problem). `topology` (seeded from bound pods by the caller) is
        used as given; without it one is built from the pods alone (lazy
        universe: a topology-free pod set never builds it). Its keys and
        domains join the vocab before the pads freeze."""
        dev = self.device
        pods_list = list(pods)
        P = len(pods_list)
        cap = self.max_claims or _next_pow2(max(P, 1))
        n_claims = self._n_claims_override or cap
        self._last_n_claims = n_claims
        if topology is None:
            topology = Topology.build(
                pods_list,
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
            order = np.lexsort((sig, -sizes))  # ffd_sort's order
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
        self._check_supported(pods_list)
        self.budgets = {k: dict(v) for k, v in (budgets or {}).items()}
        budget, nodes_budget = self._encode_budgets()
        template_tensors = self.template_tensors._replace(budget=budget, nodes_budget=nodes_budget)
        E = _next_pow2(max(len(self.existing_nodes), 1), 1)
        exist_tensors = self._encode_existing(E)
        U = len(reps)
        k_pad, v_pad = self._pads()
        enc = self.encoder
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
        exist_ok = np.zeros((U, E), dtype=bool)
        for e, n in enumerate(self.existing_nodes):
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
        batchable, kscan_key = self._classify(reps, rel, vg, hg, allow_fill)
        kinds = dict(
            reqs=ReqSetTensors.from_numpy(reqs_np, dev),
            strict=ReqSetTensors.from_numpy(strict_np, dev),
            requests=as_tensor(requests, dev),
            tmpl_ok=as_tensor(tol, dev),
            it_allow=as_tensor(it_allow, dev),
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
            reps=reps,
            exist_tensors=exist_tensors,
            template_tensors=template_tensors,
            res_cap0=as_tensor(self._res_cap0(), dev),
            topo_tensors=topo,
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

    def _classify(self, reps: list, rel: dict, vg: list, hg: list, allow_fill: bool) -> tuple:
        """Route every kind (the reference's batchability and kscan-key
        rules): a kind rides the fill scan unless it interacts with a
        vocab-key group or with an initially-empty hostname affinity group
        (whose bootstrap is ordered); such a kind rides the kind scan when
        every vocab-key group it applies to or records into shares ONE key
        with at most KSCAN_D values (kscan_key = that key), and the per-pod
        scan otherwise (kscan_key = -1). Without allow_fill every kind
        rides the per-pod scan."""
        U = len(reps)
        vga, vgr, hga = rel["vga"], rel["vgr"], rel["hga"]
        empty_aff = np.zeros(hga.shape[1], dtype=bool)
        for j, g in enumerate(hg):
            if g.type is TopologyType.AFFINITY and g.is_empty():
                empty_aff[j] = True
        batchable = np.array(
            [not vga[u].any() and not vgr[u].any() and not (hga[u] & empty_aff).any() for u in range(U)],
            dtype=bool,
        ) & allow_fill
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
        kid = torch.as_tensor([s[2] for s in segs], dtype=torch.long).to(self.device)
        counts = torch.as_tensor([s[1] - s[0] for s in segs], dtype=torch.int32).to(self.device)
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
        kid = torch.as_tensor(kidx, dtype=torch.long).to(self.device)
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
        """Maximal runs of consecutive segments with one route — ("fill",),
        ("kscan", key) or ("perpod",) — with big fill runs split into
        ~pipeline_chunks dispatches (the reference's software-pipeline
        split); kscan and per-pod runs keep their exact segments."""
        batchable, kscan_key = enc["batchable"], enc["kscan_key"]
        runs: list = []
        for seg in enc["segments"]:
            k = seg[2]
            m = ("fill",) if batchable[k] else ("kscan", int(kscan_key[k])) if kscan_key[k] >= 0 else ("perpod",)
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

    def _run_solve(self, enc: dict):
        """One dispatch per run (fill scan or kind scan) or per chunk of a
        per-pod run, with boundary compaction; returns the final state and
        the per-dispatch outputs ("fill", segs, ys, slot_of) / ("kscan",
        segs, ys) / ("pods", lo, hi, assignment)."""
        n_claims = enc["n_claims"]
        topo_kids = enc["topo_kids"]
        state = ops_solver.initial_state(
            enc["exist_tensors"], self.it_tensors, enc["template_tensors"],
            enc["topo_tensors"], n_claims, enc["n_ports"], enc["res_cap0"], window=n_claims, topo_kids=topo_kids,
        )
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
        n_compactions = 0
        n_fill = n_kscan = n_perpod = 0

        def maybe_compact(st):
            nonlocal n_compactions
            if not compact or not (remaining > 0).any():
                return st
            r_min = requests_np[remaining > 0].min(axis=0)
            st, _closed = ops_solver.compact_state(
                st, self.it_tensors, as_tensor(r_min, self.device), n_claims,
                plain=self.plain, topo_kids=topo_kids,
            )
            n_compactions += 1
            return st

        for mode, segs in runs:
            if mode[0] == "perpod":
                lo, hi = segs[0][0], segs[-1][1]
                for clo in range(lo, hi, chunk):
                    chi = min(clo + chunk, hi)
                    L = chi - clo
                    kidx = np.zeros(self._pad("perpod_pods", L, 8), dtype=np.int64)
                    kidx[:L] = kind_of[clo:chi]
                    *rows, pod_topo = self._gather_pod_chunk(enc, kidx, L)
                    state, assignment = ops_solver.solve_from(
                        state, *rows, *common[:5], pod_topo, *common[5:], topo_kids=topo_kids, plain=self.plain,
                        tables=self.perpod_tables, flags=self._flags(),
                    )
                    outputs.append(("pods", clo, chi, assignment))
                    n_perpod += 1
                    np.subtract.at(remaining, kind_of[clo:chi], 1)
                    state = maybe_compact(state)
                continue
            if mode[0] == "fill":
                xs = self._gather_fill_xs(enc, segs)
                state, ys = ops_solver.solve_fill(state, xs, *common, plain=self.plain)
                outputs.append(("fill", segs, ys, state.slot_of))
                n_fill += 1
            else:
                key = mode[1]
                counts = [hi - lo for lo, hi, _k in segs]
                state, ys = ops_solver.solve_kind_scan(
                    state, self._gather_kind_xs(enc, segs), *common,
                    key_kid=key, n_domains=len(self.encoder.vocab.values[key]),
                    maxc=self._kscan_maxc(max(counts)), counts=counts,
                    requests_np=requests_np[[k for _lo, _hi, k in segs]], plain=self.plain,
                )
                outputs.append(("kscan", segs, ys))
                n_kscan += 1
            for lo, hi, k in segs:
                remaining[k] -= hi - lo
            state = maybe_compact(state)
        self.last_stats = dict(
            segments=len(enc["segments"]), groups=len(runs), fill_dispatches=n_fill,
            kscan_dispatches=n_kscan, perpod_dispatches=n_perpod, compactions=n_compactions,
        )
        return state, outputs

    def _solve_once(self, pods: Sequence[Pod], existing_nodes, budgets, topology=None) -> SchedulingResult:
        t0 = time.perf_counter()
        self.existing_nodes = existing_nodes
        pods_sorted, enc = self._encode(pods, budgets, topology)
        t1 = time.perf_counter()
        state, outputs = self._run_solve(enc)
        tk = list(enc["topo_kids"])
        fetch = dict(
            claims=ops_solver.global_claims(state, plain=self.plain, topo_kids=enc["topo_kids"]),
            n_open=state.n_open, w_open=state.w_open, w_hw=state.w_hw, spills=state.spills,
            outputs=[
                dict(
                    fill_c=o[2].fill_c, fill_e=o[2].fill_e, open_start=o[2].open_start,
                    n_opened=o[2].n_opened, status=o[2].status, slot_map=o[3],
                )
                if o[0] == "fill"
                else dict(assignment=o[3]) if o[0] == "pods"
                else dict(assignment=o[2].assignment, grid_reused=o[2].grid_reused)
                for o in outputs
            ],
        )
        if tk:
            fetch.update(
                e_mask=state.exist_reqs.mask[:, tk, :],
                e_inf=state.exist_reqs.inf[:, tk],
                e_def=state.exist_reqs.defined[:, tk],
            )
        fetched = fetch_tree(fetch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        out = self._decode(pods_sorted, enc, outputs, fetched)
        t3 = time.perf_counter()
        self.last_timings = dict(encode_s=t1 - t0, device_s=t2 - t1, decode_s=t3 - t2)
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
    ) -> SchedulingResult:
        """Schedule pods onto existing nodes and new claims, with the
        preference relaxation ladder and NO_ROOM recovery of the reference
        (the claims axis grows and the problem re-solves until every pod
        had a real chance at a slot). `topology`, when given (seeded from
        the pods bound to the existing nodes, as a consolidation
        simulation builds it), replaces the one built from the pods; every
        round solves on a pristine deep copy of it. `budgets` are the
        pools' remaining limits ({pool: {resource or "nodes": amount}}),
        `volume_reqs` each pod uid's volume-topology alternatives,
        `pod_volumes` each pod uid's CSI volumes ({driver: {pvc}}),
        `reserved_in_use` the reservation ids held by claims not launched
        yet, and `reserved_mode` overrides the scheduler's for this solve."""
        norm_vol = normalize_volume_reqs(volume_reqs)
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
        round_dispatches = []  # per _solve_once: its per-pod chunks

        def solve_round(current: list[Pod]) -> SchedulingResult:
            while True:
                topo = copy.deepcopy(topology) if topology is not None else None
                result = self._solve_once(current, [n.clone() for n in base_existing], budgets, topo)
                round_dispatches.append(self.last_stats["perpod_dispatches"])
                cap = _next_pow2(max(len(current), 1))
                used = self._last_n_claims or self.max_claims or cap
                leftover = sum(1 for _, reason in result.unschedulable if reason == NO_ROOM_REASON)
                if used >= cap or not leftover:
                    return result
                # one-shot escalation sized from the measured claim density
                placed = max(len(current) - leftover, 1)
                est = int(used * len(current) / placed * 1.25) + 32
                self._n_claims_override = min(max(used * 2, -(-est // 256) * 256), cap)

        prev_mode = self.reserved_mode
        if reserved_mode is not None:
            self.reserved_mode = reserved_mode
        try:
            result = prefs.run_with_relaxation(list(pods), solve_round)
        finally:
            self.reserved_mode = prev_mode
        # last_stats describe the last round; these count every round
        self.last_stats.update(rounds=len(round_dispatches), perpod_dispatches_all=sum(round_dispatches))
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
        if any(p.metadata.annotations.get(GANG_ANNOTATIONS[0]) for p in pods):
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

    def _decode(self, pods_sorted: list[Pod], enc: dict, outputs: list, fetched: dict) -> SchedulingResult:
        """Claim-level decode from the fetched device state: replay the
        pod -> slot bookkeeping in dispatch order (fill grids expanded,
        kind-scan and per-pod assignments applied per pod), then finalize each claim's
        requirements (template + its pod kinds + hostname + the device's
        topology narrowing), usage (device carry) and viable instance types
        (device mask)."""
        E = enc["E"]
        kind_of = enc["kind_of"]
        topo_kids = enc["topo_kids"]
        vocab = self.encoder.vocab
        reps: list[Pod] = enc["reps"]
        claims_cols = fetched["claims"]
        claim_template = claims_cols["template"]
        claims: list[SimClaim] = []
        slot_to_claim: dict[int, SimClaim] = {}
        claim_kinds: dict[int, dict[int, int]] = {}
        node_kinds: dict[int, dict[int, int]] = {}
        unschedulable: list[tuple[Pod, str]] = []
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
                tmpl = self.templates[int(claim_template[slot])]
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
        for o, f in zip(outputs, fetched["outputs"]):
            if o[0] == "fill":
                _decode_fill_segments(ctx, o[1], f)
                continue
            if o[0] == "pods":
                _apply_assignments(ctx, o[1], np.asarray(f["assignment"][: o[2] - o[1]], dtype=np.int64))
                continue
            for j, (lo, hi, _kind) in enumerate(o[1]):
                _apply_assignments(ctx, lo, np.asarray(f["assignment"][j][: hi - lo], dtype=np.int64))

        its_mask = claims_cols["its"]
        used_np = claims_cols["used"]
        held = claims_cols["held"]
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
                    vocab, topo_kids, reqs, claims_cols["tk_mask"][s], claims_cols["tk_inf"][s],
                    claims_cols["tk_def"][s], f"claim slot {s}",
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
        return SchedulingResult(
            claims=claims,
            unschedulable=unschedulable,
            assignments=assignments,
            existing=self.existing_nodes,
            existing_assignments=existing_assignments,
        )
