"""Topology as tensors (port of the JAX package's ops/topology.py, cut to
what the fill step, the zonal kind scan and the per-pod step need).

Every group's domain -> count map becomes a row of a count matrix that the
solver carries:

  vocab-key groups   counts [NGv, V]   domains are vocab value ids of the
  (zone, custom)                       group's key
  hostname groups    counts [NGh, S]   domains are candidate slots (S = E
                                       existing + claim slots + 1 spare); a
                                       new claim IS a fresh hostname domain

The per-pod rules — `vg_pod_precompute` / `vg_evaluate` / `vg_commit`
for vocab-key groups, `hg_evaluate` / `hg_commit` for hostname groups —
are the plain per-pod step's (ops/solver.py `_pod_step`; the per-pod kernel
inlines them). The kind scan's compact-domain twin of the vocab-key half
is ops/solver.py `vg_eval_plain` (kernel H6).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.ops.encode import as_tensor

BIG_I32 = 2**31 - 1
RANK_BASE = 1 << 16  # count * RANK_BASE + rank stays in int32 while counts < 2^14

TYPE_SPREAD = 0
TYPE_AFFINITY = 1
TYPE_ANTI = 2


class TopologyTensors(NamedTuple):
    # vocab-key groups
    vg_key: torch.Tensor  # [NGv] i32
    vg_type: torch.Tensor  # [NGv] i32
    vg_skew: torch.Tensor  # [NGv] i32
    vg_min_domains: torch.Tensor  # [NGv] i32 (0 = unset)
    vg_domains: torch.Tensor  # [NGv, V] bool
    vg_counts0: torch.Tensor  # [NGv, V] i32
    vg_rank: torch.Tensor  # [NGv, V] i32 (sorted-name rank; 2^30 for non-domains)
    vg_valid: torch.Tensor  # [NGv] bool
    # hostname groups
    hg_type: torch.Tensor  # [NGh] i32
    hg_skew: torch.Tensor  # [NGh] i32
    hg_counts0: torch.Tensor  # [NGh, S] i32 — S = E existing + claim slots + 1
    hg_extra_nonempty: torch.Tensor  # [NGh] bool — counts exist outside the slot space
    hg_valid: torch.Tensor  # [NGh] bool


class PodTopology(NamedTuple):
    """Per-kind group relations (host-computed)."""

    vg_applies: torch.Tensor  # [P, NGv] bool — group restricts the pod
    vg_records: torch.Tensor  # [P, NGv] bool — pod's placement counts into group
    vg_self: torch.Tensor  # [P, NGv] bool — group selector matches the pod
    hg_applies: torch.Tensor  # [P, NGh] bool
    hg_records: torch.Tensor  # [P, NGh] bool
    hg_self: torch.Tensor  # [P, NGh] bool
    strict_mask: torch.Tensor  # [P, K, V] bool — strict pod requirement masks


def _pow2(n: int, floor: int = 1) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def empty_topology_tensors(v_pad: int, s_slots: int, device) -> TopologyTensors:
    """The no-groups TopologyTensors, field for field what encode_topology
    builds for an empty group list (skews 1, valid bits False, vg ranks
    2^30)."""
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return TopologyTensors(
        vg_key=torch.zeros(1, **i32),
        vg_type=torch.zeros(1, **i32),
        vg_skew=torch.ones(1, **i32),
        vg_min_domains=torch.zeros(1, **i32),
        vg_domains=torch.zeros((1, v_pad), **b),
        vg_counts0=torch.zeros((1, v_pad), **i32),
        vg_rank=torch.full((1, v_pad), 2**30, **i32),
        vg_valid=torch.zeros(1, **b),
        hg_type=torch.zeros(1, **i32),
        hg_skew=torch.ones(1, **i32),
        hg_counts0=torch.zeros((1, s_slots), **i32),
        hg_extra_nonempty=torch.zeros(1, **b),
        hg_valid=torch.zeros(1, **b),
    )


def encode_topology(
    topology,
    encoder,
    e_slots: int,
    n_slots: int,
    existing_names: Sequence[str],
    v_pad: int,
    device,
):
    """Host Topology + ProblemEncoder -> (TopologyTensors on `device`, vg
    groups, hg groups). existing_names maps hostname domains to slots
    [0, E); counts on hostnames outside the slot space set
    hg_extra_nonempty."""
    from karpenter_tpu_torch.controllers.provisioning.topology import TopologyType

    vocab = encoder.vocab
    groups = topology.groups + topology.inverse_groups
    if not groups:
        return empty_topology_tensors(v_pad, e_slots + n_slots, device), [], []
    vg = [g for g in groups if g.key != l.LABEL_HOSTNAME]
    hg = [g for g in groups if g.key == l.LABEL_HOSTNAME]
    NGv, NGh = _pow2(max(len(vg), 1)), _pow2(max(len(hg), 1))
    S = e_slots + n_slots
    type_map = {
        TopologyType.SPREAD: TYPE_SPREAD,
        TopologyType.AFFINITY: TYPE_AFFINITY,
        TopologyType.ANTI_AFFINITY: TYPE_ANTI,
    }

    vg_key = np.zeros(NGv, dtype=np.int32)
    vg_type = np.zeros(NGv, dtype=np.int32)
    vg_skew = np.ones(NGv, dtype=np.int32)
    vg_mind = np.zeros(NGv, dtype=np.int32)
    vg_domains = np.zeros((NGv, v_pad), dtype=bool)
    vg_counts0 = np.zeros((NGv, v_pad), dtype=np.int32)
    vg_rank = np.full((NGv, v_pad), 2**30, dtype=np.int32)
    vg_valid = np.zeros(NGv, dtype=bool)
    for j, g in enumerate(vg):
        kid = vocab.add_key(g.key)
        vg_key[j] = kid
        vg_type[j] = type_map[g.type]
        vg_skew[j] = g.max_skew
        vg_mind[j] = g.min_domains or 0
        for rank, name in enumerate(sorted(g.domains)):
            vid = vocab.value_to_id[kid].get(name)
            if vid is None:
                continue  # a domain no requirement mentions: unreachable
            vg_domains[j, vid] = True
            vg_counts0[j, vid] = g.domains[name]
            vg_rank[j, vid] = rank
        vg_valid[j] = True

    slot_of = {name: i for i, name in enumerate(existing_names)}
    hg_type = np.zeros(NGh, dtype=np.int32)
    hg_skew = np.ones(NGh, dtype=np.int32)
    hg_counts0 = np.zeros((NGh, S), dtype=np.int32)
    hg_extra = np.zeros(NGh, dtype=bool)
    hg_valid = np.zeros(NGh, dtype=bool)
    for j, g in enumerate(hg):
        hg_type[j] = type_map[g.type]
        hg_skew[j] = g.max_skew
        for name, count in g.domains.items():
            if count <= 0:
                continue
            s = slot_of.get(name)
            if s is None:
                hg_extra[j] = True
            else:
                hg_counts0[j, s] = count
        hg_valid[j] = True

    arrs = dict(
        vg_key=vg_key, vg_type=vg_type, vg_skew=vg_skew, vg_min_domains=vg_mind,
        vg_domains=vg_domains, vg_counts0=vg_counts0, vg_rank=vg_rank, vg_valid=vg_valid,
        hg_type=hg_type, hg_skew=hg_skew, hg_counts0=hg_counts0,
        hg_extra_nonempty=hg_extra, hg_valid=hg_valid,
    )
    return TopologyTensors(**{k: as_tensor(v, device) for k, v in arrs.items()}), vg, hg


def encode_topology_counts(
    topology,
    encoder,
    e_slots: int,
    n_slots: int,
    existing_names: Sequence[str],
    v_pad: int,
    base_vg: Sequence,
    base_hg: Sequence,
):
    """Numpy-only (vg_counts0 [NGv, v_pad], hg_counts0 [NGh, E + slots])
    of a what-if scenario's topology, rows aligned to a baseline encode's
    group lists by ident(): inverse anti-affinity groups come from bound
    pods, which differ per exclusion set, so positions do not line up.
    None when the scenario's group multiset differs from the baseline's
    (the caller then simulates the scenarios one by one)."""
    groups = topology.groups + topology.inverse_groups
    vg = [g for g in groups if g.key != l.LABEL_HOSTNAME]
    hg = [g for g in groups if g.key == l.LABEL_HOSTNAME]

    def align(scenario_groups, base_groups):
        by_ident: dict = {}
        for g in scenario_groups:
            by_ident.setdefault(g.ident(), []).append(g)
        ordered = []
        for b in base_groups:
            bucket = by_ident.get(b.ident())
            if not bucket:
                return None
            ordered.append(bucket.pop(0))
        if any(bucket for bucket in by_ident.values()):
            return None  # groups the baseline encode lacks
        return ordered

    vg_aligned = align(vg, base_vg)
    hg_aligned = align(hg, base_hg)
    if vg_aligned is None or hg_aligned is None:
        return None
    NGv, NGh = _pow2(max(len(base_vg), 1)), _pow2(max(len(base_hg), 1))
    vocab = encoder.vocab
    vg_counts0 = np.zeros((NGv, v_pad), dtype=np.int32)
    for j, g in enumerate(vg_aligned):
        kid = vocab.add_key(g.key)
        for name, count in g.domains.items():
            vid = vocab.value_to_id[kid].get(name)
            if vid is not None:
                vg_counts0[j, vid] = count
    slot_of = {name: i for i, name in enumerate(existing_names)}
    hg_counts0 = np.zeros((NGh, e_slots + n_slots), dtype=np.int32)
    for j, g in enumerate(hg_aligned):
        for name, count in g.domains.items():
            s = slot_of.get(name)
            if count > 0 and s is not None:
                hg_counts0[j, s] = count
    return vg_counts0, hg_counts0


def encode_pod_topology(topology, vg, hg, pods, strict_mask: torch.Tensor):
    """(PodTopology on strict_mask's device, host numpy twins {vga, vgr,
    hga, hgr}) for the kind representatives `pods`; the twins drive the
    host-side kind classification without a device read."""
    P = strict_mask.shape[0]
    dev = strict_mask.device
    NGv_pad = _pow2(max(len(vg), 1))
    NGh_pad = _pow2(max(len(hg), 1))
    rel = {name: np.zeros((P, n), dtype=bool) for name, n in (
        ("vga", NGv_pad), ("vgr", NGv_pad), ("vgs", NGv_pad),
        ("hga", NGh_pad), ("hgr", NGh_pad), ("hgs", NGh_pad),
    )}
    inverse = set(id(g) for g in topology.inverse_groups)
    for fam, groups in (("vg", vg), ("hg", hg)):
        a, r, s = rel[fam + "a"], rel[fam + "r"], rel[fam + "s"]
        for i, pod in enumerate(pods):
            for j, g in enumerate(groups):
                sel = g.selects(pod)
                own = pod.uid in g.owners and topology.still_declared(g, pod)
                if id(g) in inverse:
                    a[i, j], r[i, j] = sel, own
                else:
                    a[i, j], r[i, j] = own, sel
                s[i, j] = sel
    pt = PodTopology(
        vg_applies=as_tensor(rel["vga"], dev),
        vg_records=as_tensor(rel["vgr"], dev),
        vg_self=as_tensor(rel["vgs"], dev),
        hg_applies=as_tensor(rel["hga"], dev),
        hg_records=as_tensor(rel["hgr"], dev),
        hg_self=as_tensor(rel["hgs"], dev),
        strict_mask=strict_mask,
    )
    return pt, {k: rel[k] for k in ("vga", "vgr", "hga", "hgr")}


def take_pod_topology(pt: PodTopology, idx) -> PodTopology:
    """Index every per-kind row (the kind -> segment gathers)."""
    return PodTopology(*(x[idx] for x in pt))


# ---------------------------------------------------------------------------
# per-pod step functions (plain torch; the per-pod kernel inlines the same rules,
# kernel H6 its hostname half)
# ---------------------------------------------------------------------------


def _onehot_rows(space: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[C, NG, V] one-hot of idx per (c, j), zeroed where space is empty."""
    V = space.shape[-1]
    oh = torch.arange(V, device=idx.device)[None, None, :] == idx[:, :, None]
    return oh & torch.any(space, dim=-1, keepdim=True)


class VGPodPre(NamedTuple):
    """Candidate-independent per-pod terms of the vocab-key groups."""

    pd: torch.Tensor  # [NGv, V] the pod's strict domains per group
    eff: torch.Tensor  # [NGv, V] count + self
    ok_skew: torch.Tensor  # [NGv, V]
    opts: torch.Tensor  # [NGv, V] affinity options (count > 0, pod-compatible)
    bootstrap: torch.Tensor  # [NGv]
    cnt_zero: torch.Tensor  # [NGv, V]
    gate: torch.Tensor  # [NGv] the group applies to this pod
    key_touched: torch.Tensor  # [K]
    keys_eq: torch.Tensor  # [NGv, K]


def vg_pod_precompute(
    topo: TopologyTensors,
    counts: torch.Tensor,  # [NGv, V]
    pod_strict_mask: torch.Tensor,  # [K, V]
    applies: torch.Tensor,  # [NGv]
    self_sel: torch.Tensor,  # [NGv]
    n_keys: int,
) -> VGPodPre:
    """The spread minimum over the pod's supported domains (0 under an
    unmet minDomains), skew-valid domains, affinity options and the
    bootstrap flag (topologygroup.go:298-381)."""
    pd = pod_strict_mask[topo.vg_key.long()]
    dom = topo.vg_domains
    cnt = counts
    in_universe = dom & pd
    supported = in_universe.sum(dim=-1, dtype=torch.int32)
    big = torch.full_like(cnt, BIG_I32)
    minc = torch.where(in_universe, cnt, big).min(dim=-1).values
    zero = torch.zeros_like(minc)
    minc = torch.where((topo.vg_min_domains > 0) & (supported < topo.vg_min_domains), zero, minc)
    minc = torch.where(minc == BIG_I32, zero, minc)
    eff = cnt + self_sel.to(torch.int32)[:, None]
    ok_skew = (eff - minc[:, None]) <= topo.vg_skew[:, None]
    pos = cnt > 0
    opts = dom & pd & pos
    group_empty = ~torch.any(pos, dim=-1)
    no_compat = ~torch.any(pd & pos, dim=-1)
    bootstrap = self_sel & (group_empty | no_compat)
    gate = applies & topo.vg_valid
    keys_eq = topo.vg_key[:, None] == torch.arange(n_keys, dtype=torch.int32, device=cnt.device)[None, :]
    key_touched = torch.any(gate[:, None] & keys_eq, dim=0)
    return VGPodPre(
        pd=pd, eff=eff, ok_skew=ok_skew, opts=opts, bootstrap=bootstrap, cnt_zero=cnt == 0,
        gate=gate, key_touched=key_touched, keys_eq=keys_eq,
    )


def vg_evaluate(topo: TopologyTensors, pre: VGPodPre, comb_mask: torch.Tensor):
    """(feasible [C], upd [C, K, V], narrowed [C, NGv, V]) for candidates
    with combined masks comb_mask [C, K, V]: spread narrows to the domain
    of least (count + self, sorted-name rank), affinity to the counted
    compatible domains or the rank-first bootstrap domain, anti-affinity
    to the zero-count domains; upd is the AND of every applying group's
    choice at its key. Ties go to the first index (argmin)."""
    nd = comb_mask[:, topo.vg_key.long(), :]  # [C, NGv, V]
    dom = topo.vg_domains
    big = torch.tensor(BIG_I32, dtype=torch.int32, device=nd.device)

    valid_sp = dom[None] & nd & pre.ok_skew[None]
    spread_key = torch.where(valid_sp, (pre.eff * RANK_BASE + topo.vg_rank)[None], big)
    sp_mask = _onehot_rows(valid_sp, torch.argmin(spread_key, dim=-1))
    any_sp = torch.any(valid_sp, dim=-1)

    opts_c = pre.opts[None] & nd
    any_opts = torch.any(opts_c, dim=-1, keepdim=True)
    boot_space = dom[None] & pre.pd[None] & nd
    boot_idx = torch.argmin(torch.where(boot_space, topo.vg_rank[None], big), dim=-1)
    boot_mask = _onehot_rows(boot_space, boot_idx)
    aff_mask = torch.where(any_opts, opts_c, boot_mask & pre.bootstrap[None, :, None])
    any_aff = torch.any(aff_mask, dim=-1)

    anti_mask = boot_space & pre.cnt_zero[None]
    any_anti = torch.any(anti_mask, dim=-1)

    t = topo.vg_type[None, :]
    narrowed = torch.where(
        (t == TYPE_SPREAD)[..., None], sp_mask,
        torch.where((t == TYPE_AFFINITY)[..., None], aff_mask, anti_mask),
    )
    ok = torch.where(t == TYPE_SPREAD, any_sp, torch.where(t == TYPE_AFFINITY, any_aff, any_anti))
    feasible = torch.all(~pre.gate[None, :] | ok, dim=-1)
    contrib = ~(pre.gate[None, :, None, None] & pre.keys_eq[None, :, :, None]) | narrowed[:, :, None, :]
    upd = torch.all(contrib, dim=1)  # [C, K, V]
    return feasible, upd, narrowed


def vg_commit(
    topo: TopologyTensors,
    counts: torch.Tensor,  # [NGv, V]
    final_mask: torch.Tensor,  # [K, V] the winner's requirement masks
    final_inf: torch.Tensor,  # [K]
    records: torch.Tensor,  # [NGv]
) -> torch.Tensor:
    """Count the winner's final values of each recording group's key
    (topology.go:190-212): all of them for anti-affinity, a collapsed
    single value otherwise, never a complement requirement."""
    key = topo.vg_key.long()
    vals = final_mask[key]
    finite = ~final_inf[key]
    single = vals.sum(dim=-1, dtype=torch.int32) == 1
    is_anti = topo.vg_type == TYPE_ANTI
    do = records & topo.vg_valid & finite & (is_anti | single)
    return counts + (do[:, None] & vals).to(counts.dtype)


def hg_evaluate(
    topo: TopologyTensors,
    counts: torch.Tensor,  # [NGh, S]
    cand_slots: torch.Tensor,  # [C] i32 — candidate hostname slots
    applies: torch.Tensor,  # [NGh]
    self_sel: torch.Tensor,  # [NGh]
) -> torch.Tensor:
    """[C] bool — hostname-group feasibility per candidate slot."""
    cnt_s = counts[:, cand_slots.long()].T  # [C, NGh]
    self_add = self_sel.to(torch.int32)[None, :]
    ok_spread = (cnt_s + self_add) <= topo.hg_skew[None, :]
    group_empty = ~(torch.any(counts > 0, dim=-1) | topo.hg_extra_nonempty)  # [NGh]
    ok_aff = (cnt_s > 0) | (self_sel & group_empty)[None, :]
    ok_anti = cnt_s == 0
    t = topo.hg_type[None, :]
    ok = torch.where(t == TYPE_SPREAD, ok_spread, torch.where(t == TYPE_AFFINITY, ok_aff, ok_anti))
    gate = applies & topo.hg_valid
    return torch.all(~gate[None, :] | ok, dim=-1)


def hg_commit(
    counts: torch.Tensor,  # [NGh, S]
    slot: torch.Tensor,  # [] i32 — the winner's hostname slot
    records: torch.Tensor,  # [NGh]
    valid: torch.Tensor,  # [NGh]
) -> torch.Tensor:
    delta = (records & valid).to(counts.dtype)
    out = counts.clone()
    out.index_add_(1, slot.reshape(1).long(), delta[:, None])
    return out
