"""Lossless tensor encoding of the scheduling problem (port of the JAX
package's ops/encode.py).

A batch of requirement sets is encoded as dense tensors over a
problem-wide vocabulary:

  mask[B, K, V]  bool  which vocab values the requirement admits (each
                       entity's own bounds folded in host-side)
  inf[B, K]      bool  complement bit: admits values OUTSIDE the vocab
  excl[B, K]     bool  complement has a non-empty exclusion set (NotIn-ness)
  gte/lte[B, K]  int32 inclusive bounds with sentinels; only consulted for
                       complement x complement intersections
  defined[B, K]  bool  whether the entity constrains this key at all

Undefined keys are the identity element of intersection (mask all-ones,
inf=1, excl=0, bounds=sentinels, defined=0). The host builds numpy arrays
and hands back torch tensors on the requested device; value ids (and so
the mask layout) follow vocab observation order, which callers must keep
identical to the reference's to compare tensors bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.cloudprovider.instancetype import InstanceType
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.models.pod import Pod
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.utils import resources as res

INT_MIN = -(2**31) + 1
INT_MAX = 2**31 - 1

# Canonical resource axis prefix; extended resources appended per problem.
BASE_RESOURCES = (res.CPU, res.MEMORY, res.PODS, res.EPHEMERAL_STORAGE)


def as_tensor(a, device) -> torch.Tensor:
    """numpy -> torch on `device`, keeping dtype (bool/int32/float32) and
    shape (0-dim included); the host copy keeps torch off numpy's buffer."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` without making the host wait: torch
    synchronizes the stream after a copy from pageable memory, which in the
    dispatch loop would hold the host until the card drained every queued
    dispatch. On the card the copy goes through pinned memory, queued."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Vocab:
    """Per-key value vocabulary for one problem instance."""

    def __init__(self) -> None:
        self.keys: list[str] = []
        self.key_to_id: dict[str, int] = {}
        self.values: list[list[str]] = []  # per key
        self.value_to_id: list[dict[str, int]] = []

    def add_key(self, key: str) -> int:
        kid = self.key_to_id.get(key)
        if kid is None:
            kid = len(self.keys)
            self.key_to_id[key] = kid
            self.keys.append(key)
            self.values.append([])
            self.value_to_id.append({})
        return kid

    def add_value(self, key: str, value: str) -> int:
        kid = self.add_key(key)
        vid = self.value_to_id[kid].get(value)
        if vid is None:
            vid = len(self.values[kid])
            self.value_to_id[kid][value] = vid
            self.values[kid].append(value)
        return vid

    def observe(self, reqs: Requirements, skip_keys: frozenset[str] = frozenset()) -> None:
        for r in reqs:
            if r.key in skip_keys:
                continue
            self.add_key(r.key)
            for v in r.values:
                self.add_value(r.key, v)

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def max_values(self) -> int:
        return max((len(v) for v in self.values), default=0)

    def well_known_mask(self) -> np.ndarray:
        return np.array([k in l.WELL_KNOWN_LABELS for k in self.keys], dtype=bool)


class ReqSetTensors(NamedTuple):
    """A batch of encoded requirement sets; leading axis is the batch."""

    mask: torch.Tensor  # [B, K, V] bool
    inf: torch.Tensor  # [B, K] bool
    excl: torch.Tensor  # [B, K] bool
    gte: torch.Tensor  # [B, K] int32
    lte: torch.Tensor  # [B, K] int32
    defined: torch.Tensor  # [B, K] bool

    @staticmethod
    def from_numpy(arrs, device) -> "ReqSetTensors":
        """From six numpy arrays (a tuple in field order, or anything with
        the fields as attributes, such as the JAX container)."""
        if not isinstance(arrs, (tuple, list)):
            arrs = [getattr(arrs, f) for f in ReqSetTensors._fields]
        return ReqSetTensors(*(as_tensor(np.asarray(a), device) for a in arrs))


def _requirement_row(vocab: Vocab, k: int, r, V: int, memo: dict) -> np.ndarray:
    """[V] bool admitted-value row for one requirement at key id k,
    memoized by requirement content (deployment-shaped problems repeat the
    same selectors across many kinds)."""
    vals = vocab.values[k]
    key = (k, r.complement, r.gte, r.lte, frozenset(r.values))
    row = memo.get(key)
    if row is not None:
        return row
    row = np.zeros(V, dtype=bool)
    if r.gte is None and r.lte is None:
        ids = [vocab.value_to_id[k][v] for v in r.values if v in vocab.value_to_id[k]]
        if r.complement:
            row[: len(vals)] = True
            row[ids] = False
        else:
            row[ids] = True
    else:
        for vid, value in enumerate(vals):
            row[vid] = r.has(value)
    memo[key] = row
    return row


def encode_requirements_np(
    vocab: Vocab,
    req_sets: Sequence[Requirements],
    k_pad: Optional[int] = None,
    v_pad: Optional[int] = None,
    skip_keys: frozenset[str] = frozenset(),
    row_memo: Optional[dict] = None,
) -> tuple[np.ndarray, ...]:
    """The six component arrays as numpy (mask, inf, excl, gte, lte,
    defined). Every value referenced must already be in the vocab."""
    B = len(req_sets)
    K = k_pad or max(vocab.n_keys, 1)
    V = v_pad or max(vocab.max_values, 1)
    mask = np.ones((B, K, V), dtype=bool)
    inf = np.ones((B, K), dtype=bool)
    excl = np.zeros((B, K), dtype=bool)
    gte = np.full((B, K), INT_MIN, dtype=np.int32)
    lte = np.full((B, K), INT_MAX, dtype=np.int32)
    defined = np.zeros((B, K), dtype=bool)
    memo: dict = row_memo if row_memo is not None else {}
    # padding key slots beyond the vocab stay at the identity encoding
    for b, reqs in enumerate(req_sets):
        for r in reqs:
            if r.key in skip_keys:
                continue
            k = vocab.key_to_id[r.key]
            mask[b, k] = _requirement_row(vocab, k, r, V, memo)
            inf[b, k] = r.complement
            excl[b, k] = r.complement and bool(r.values)
            # saturating clamp to int32 on both sides
            gte[b, k] = min(max(r.gte, INT_MIN), INT_MAX) if r.gte is not None else INT_MIN
            lte[b, k] = min(max(r.lte, INT_MIN), INT_MAX) if r.lte is not None else INT_MAX
            defined[b, k] = True
    return mask, inf, excl, gte, lte, defined


def encode_requirements(
    vocab: Vocab,
    req_sets: Sequence[Requirements],
    k_pad: Optional[int] = None,
    v_pad: Optional[int] = None,
    skip_keys: frozenset[str] = frozenset(),
    device="cuda",
) -> ReqSetTensors:
    """Encode requirement sets against an already-built vocab, on
    `device`. Keys in skip_keys are left out of the dense encoding (the
    caller enforces their semantics by other means)."""
    return ReqSetTensors.from_numpy(
        encode_requirements_np(vocab, req_sets, k_pad, v_pad, skip_keys), device
    )


class InstanceTypeTensors(NamedTuple):
    """Dense instance-type catalog. GR is the allocatable-override group
    axis: group 0 is the base allocatable; padded groups have alloc=-inf
    so nothing fits them."""

    reqs: ReqSetTensors  # [T, K, V]
    alloc: torch.Tensor  # [T, GR, R] f32
    cap: torch.Tensor  # [T, R] f32 — full capacity (NodePool limits filtering)
    group_valid: torch.Tensor  # [T, GR] bool
    zc_avail: torch.Tensor  # [T, GR, Z, C] bool — available offering exists in (zone, ct)
    price_zc: torch.Tensor  # [T, Z, C] f32 — min available price, +inf when none
    valid: torch.Tensor  # [T] bool
    res_ofs: torch.Tensor  # [T, RID, Z] bool — reserved offerings

    @property
    def n_types(self) -> int:
        return self.alloc.shape[0]


class PodTensors(NamedTuple):
    reqs: ReqSetTensors  # [P, K, V] (preferences folded in)
    strict_reqs: ReqSetTensors  # [P, K, V] required-only
    requests: torch.Tensor  # [P, R] f32 (includes pods=1)
    valid: torch.Tensor  # [P] bool


class ProblemEncoder:
    """Builds the vocab + resource axis, then encodes entities onto
    `device`. Usage: construct, observe() everything, then encode_*."""

    def __init__(self, special_it_name: bool = True, device="cuda") -> None:
        self.device = torch.device(device)
        self.vocab = Vocab()
        self.resource_names: list[str] = list(BASE_RESOURCES)
        self._resource_ids: dict[str, int] = {n: i for i, n in enumerate(self.resource_names)}
        # zone / capacity-type key ids for offering encoding
        self.vocab.add_key(l.LABEL_TOPOLOGY_ZONE)
        self.vocab.add_key(l.CAPACITY_TYPE_LABEL_KEY)
        # instance-type NAME and hostname stay out of the dense encoding:
        # name selectors fold into static allowed-type masks, hostname
        # selectors into the static pod x node masks
        self.skip_keys: frozenset[str] = (
            frozenset({l.LABEL_INSTANCE_TYPE, l.LABEL_HOSTNAME}) if special_it_name else frozenset()
        )

    # -- observation -------------------------------------------------------

    def observe_resources(self, rl: dict[str, float]) -> None:
        for name in rl:
            if name not in self._resource_ids:
                self._resource_ids[name] = len(self.resource_names)
                self.resource_names.append(name)

    def observe_requirements(self, reqs: Requirements) -> None:
        self.vocab.observe(reqs, self.skip_keys)

    def observe_pod(self, pod: Pod) -> None:
        self.vocab.observe(Requirements.from_pod(pod), self.skip_keys)
        self.observe_resources(pod.total_requests())

    def observe_instance_type(self, it: InstanceType) -> None:
        self.vocab.observe(it.requirements, self.skip_keys)
        self.observe_resources(it.capacity)
        for o in it.offerings:
            self.vocab.observe(o.requirements, self.skip_keys)
            self.observe_resources(o.capacity_override)

    def hostname_allows(self, reqs: Requirements, hostname: Optional[str]) -> bool:
        """Whether a requirement set's hostname requirement admits the given
        hostname (None = a not-yet-named new node)."""
        if not reqs.has(l.LABEL_HOSTNAME):
            return True
        r = reqs.get(l.LABEL_HOSTNAME)
        if hostname is None:
            return r.is_lenient()
        return r.has(hostname)

    def it_allow_mask(self, req_sets: Sequence[Requirements], its: Sequence[InstanceType]) -> np.ndarray:
        """[B, T] bool — which instance types each requirement set's
        instance-type-NAME requirement admits (True when undefined)."""
        out = np.ones((len(req_sets), len(its)), dtype=bool)
        for b, reqs in enumerate(req_sets):
            if not reqs.has(l.LABEL_INSTANCE_TYPE):
                continue
            r = reqs.get(l.LABEL_INSTANCE_TYPE)
            for t, it in enumerate(its):
                out[b, t] = r.has(it.name)
        return out

    # -- encoding ----------------------------------------------------------

    @property
    def n_resources(self) -> int:
        return len(self.resource_names)

    def resources_vector(self, rl: dict[str, float]) -> np.ndarray:
        out = np.zeros(self.n_resources, dtype=np.float32)
        for name, v in rl.items():
            out[self._resource_ids[name]] = v
        return out

    def encode_requirements(
        self, req_sets: Sequence[Requirements], k_pad: Optional[int] = None, v_pad: Optional[int] = None
    ) -> ReqSetTensors:
        return encode_requirements(
            self.vocab, req_sets, k_pad, v_pad, self.skip_keys, self.device
        )

    def encode_pods(self, pods: Sequence[Pod]) -> PodTensors:
        reqs = self.encode_requirements([Requirements.from_pod(p) for p in pods])
        strict = self.encode_requirements(
            [Requirements.from_pod(p, include_preferred=False) for p in pods]
        )
        requests = np.stack(
            [self.resources_vector(p.total_requests()) for p in pods]
        ) if pods else np.zeros((0, self.n_resources), dtype=np.float32)
        return PodTensors(
            reqs=reqs,
            strict_reqs=strict,
            requests=as_tensor(requests.astype(np.float32), self.device),
            valid=torch.ones(len(pods), dtype=torch.bool, device=self.device),
        )

    def encode_instance_types_np(self, its: Sequence[InstanceType]) -> dict:
        """The catalog slabs as numpy (reqs left to the caller's pads)."""
        T = len(its)
        zone_kid = self.vocab.key_to_id[l.LABEL_TOPOLOGY_ZONE]
        ct_kid = self.vocab.key_to_id[l.CAPACITY_TYPE_LABEL_KEY]
        Z = max(len(self.vocab.values[zone_kid]), 1)
        C = max(len(self.vocab.values[ct_kid]), 1)
        GR = max((len(it.allocatable_offerings()) for it in its), default=1)
        R = self.n_resources

        alloc = np.full((T, GR, R), -np.inf, dtype=np.float32)
        cap = np.zeros((T, R), dtype=np.float32)
        group_valid = np.zeros((T, GR), dtype=bool)
        zc_avail = np.zeros((T, GR, Z, C), dtype=bool)
        price_zc = np.full((T, Z, C), np.inf, dtype=np.float32)

        zone_values = self.vocab.values[zone_kid]
        ct_values = self.vocab.values[ct_kid]
        rid_kid = self.vocab.key_to_id.get(l.RESERVATION_ID_LABEL_KEY)
        rid_values = self.vocab.values[rid_kid] if rid_kid is not None else []
        RID = max(len(rid_values), 1)
        res_ofs = np.zeros((T, RID, Z), dtype=bool)
        for t, it in enumerate(its):
            cap[t] = self.resources_vector(it.capacity)
            for g, group in enumerate(it.allocatable_offerings()):
                alloc[t, g] = self.resources_vector(group.allocatable)
                group_valid[t, g] = True
                for o in group.offerings:  # already available-filtered
                    # an offering admits every (zone, ct) its requirements
                    # allow: a missing key reads as Exists
                    zreq = o.requirements.get(l.LABEL_TOPOLOGY_ZONE)
                    creq = o.requirements.get(l.CAPACITY_TYPE_LABEL_KEY)
                    zs = [z for z, v in enumerate(zone_values) if zreq.has(v)]
                    cs = [c for c, v in enumerate(ct_values) if creq.has(v)]
                    # empty vocab for a key: mark the padding column, which
                    # unconstrained claim masks always admit
                    if not zone_values and zreq.complement:
                        zs = [0]
                    if not ct_values and creq.complement:
                        cs = [0]
                    for z in zs:
                        for c in cs:
                            zc_avail[t, g, z, c] = True
                            price_zc[t, z, c] = min(price_zc[t, z, c], o.price)
            for o in it.offerings:
                if o.capacity_type != l.CAPACITY_TYPE_RESERVED or not o.available:
                    continue
                rid = o.reservation_id
                if rid not in rid_values:
                    continue  # unseen by any requirement: unreachable
                r = rid_values.index(rid)
                zreq = o.requirements.get(l.LABEL_TOPOLOGY_ZONE)
                for z, v in enumerate(zone_values):
                    if zreq.has(v):
                        res_ofs[t, r, z] = True
        return dict(
            alloc=alloc, cap=cap, group_valid=group_valid, zc_avail=zc_avail,
            price_zc=price_zc, valid=np.ones(T, dtype=bool), res_ofs=res_ofs,
        )

    def encode_instance_types(
        self, its: Sequence[InstanceType], k_pad: Optional[int] = None, v_pad: Optional[int] = None
    ) -> InstanceTypeTensors:
        slabs = self.encode_instance_types_np(its)
        return InstanceTypeTensors(
            reqs=self.encode_requirements([it.requirements for it in its], k_pad, v_pad),
            **{k: as_tensor(v, self.device) for k, v in slabs.items()},
        )

    def zone_ct_key_ids(self) -> tuple[int, int]:
        return (
            self.vocab.key_to_id[l.LABEL_TOPOLOGY_ZONE],
            self.vocab.key_to_id[l.CAPACITY_TYPE_LABEL_KEY],
        )

    def reservation_ids(self) -> tuple[int, int, list[str]]:
        """(reservation-id key id, the reserved capacity type's value id,
        the reservation ids in value-id order); -1 ids when the vocab has
        no reservation."""
        rid_kid = self.vocab.key_to_id.get(l.RESERVATION_ID_LABEL_KEY, -1)
        ct_kid = self.vocab.key_to_id.get(l.CAPACITY_TYPE_LABEL_KEY)
        res_vid = -1
        if ct_kid is not None and l.CAPACITY_TYPE_RESERVED in self.vocab.values[ct_kid]:
            res_vid = self.vocab.values[ct_kid].index(l.CAPACITY_TYPE_RESERVED)
        rid_names = list(self.vocab.values[rid_kid]) if rid_kid >= 0 else []
        return rid_kid, res_vid, rid_names


def type_price_column(itt: InstanceTypeTensors) -> torch.Tensor:
    """[T] f32: each type's min available offering price over every (zone,
    capacity type) cell, +inf when the catalog never priced it (the
    reference's type_price_column): the cost objective's per-claim price
    floor is the min of it over the claim's viable types."""
    return itt.price_zc.amin(dim=(1, 2))
