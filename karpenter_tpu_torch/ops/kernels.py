"""Batched requirement-set algebra, packed bitsets and the one-copy fetch
(port of the JAX package's ops/kernels.py).

Semantics (golden-tested against karpenter_tpu_torch/scheduling):

  has_intersection  <->  Requirement.has_intersection   (requirement.go:220)
  intersects        <->  Requirements.Intersects        (requirements.go:254)
  compatible_elemwise <-> Requirements.Compatible      (requirements.go:181)
  intersect_sets    <->  Requirements.Add               (requirements.go:133)

`intersects` is kernel H1: on a CUDA tensor it launches
csrc/req_intersects.cu, on a CPU tensor it runs `intersects_plain`.
`set_eq_rows`, `per_key_ok_table` and `update_set_at` serve the plain
per-pod step only (the per-pod kernel, H7/H8, inlines the same tests).

The wire: every fetch packs its leaves into one uint8 buffer with the JAX
package's _pack_wire layout. On a CUDA tensor that is kernel H15
(csrc/wire_pack.cu, one launch per fetch, reading each leaf in place,
slicing and narrowing included); on a CPU tensor `pack_wire_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.ops import cuda
from karpenter_tpu_torch.ops.encode import INT_MAX, INT_MIN, ReqSetTensors


def lenient(r: ReqSetTensors) -> torch.Tensor:
    """[B, K] bool — operator in {NotIn, DoesNotExist}.

    NotIn        = complement with non-empty exclusions (inf & excl)
    DoesNotExist = concrete empty set (~inf & no admissible vocab value)
    """
    any_mask = torch.any(r.mask, dim=-1)
    return r.defined & ((r.inf & r.excl) | (~r.inf & ~any_mask))


def has_intersection_at(a: ReqSetTensors, b: ReqSetTensors, k: int) -> torch.Tensor:
    """[A, B] bool — non-empty intersection at key k (the reference's
    has_intersection_keys, one key at a time):
    any(maskA & maskB) | (infA & infB & max(gte) <= min(lte)).
    The any over values is a 0/1 matrix product (exact: the counts stay
    far below 2^24), which keeps the [A, B, V] product out of memory."""
    hit = (a.mask[:, k].float() @ b.mask[:, k].float().T) > 0
    gte = torch.maximum(a.gte[:, k, None], b.gte[None, :, k])
    lte = torch.minimum(a.lte[:, k, None], b.lte[None, :, k])
    return hit | (a.inf[:, k, None] & b.inf[None, :, k] & (gte <= lte))


def intersects_plain(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[A, B] bool — all shared keys intersect (requirements.go:254-274); a
    failed per-key intersection is forgiven when BOTH operators are in
    {NotIn, DoesNotExist}."""
    len_a, len_b = lenient(a), lenient(b)
    ok = torch.ones((a.mask.shape[0], b.mask.shape[0]), dtype=torch.bool, device=a.mask.device)
    for k in range(a.mask.shape[1]):
        shared = a.defined[:, k, None] & b.defined[None, :, k]
        both_lenient = len_a[:, k, None] & len_b[None, :, k]
        ok &= ~shared | has_intersection_at(a, b, k) | both_lenient
    return ok


def intersects(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[A, B] bool — kernel H1 on CUDA tensors, the plain version on CPU
    tensors. The relation is symmetric: intersects(a, b) == intersects(b, a).T."""
    if a.mask.device.type == "cpu":
        return intersects_plain(a, b)
    return cuda.req_intersects(a, b)


def has_intersection_keys_elemwise(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[B, K] bool — per-key non-empty intersection over a shared batch."""
    hit = torch.any(a.mask & b.mask, dim=-1)
    gte = torch.maximum(a.gte, b.gte)
    lte = torch.minimum(a.lte, b.lte)
    return hit | (a.inf & b.inf & (gte <= lte))


def intersects_elemwise(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[B] bool — intersects() over aligned batches."""
    shared = a.defined & b.defined
    both_lenient = lenient(a) & lenient(b)
    ok = ~shared | has_intersection_keys_elemwise(a, b) | both_lenient
    return torch.all(ok, dim=-1)


def compatible_elemwise(a: ReqSetTensors, b: ReqSetTensors, well_known: torch.Tensor) -> torch.Tensor:
    """[B] bool — compatible() over aligned batches (a=node side, b=incoming)."""
    custom_ok = ~b.defined | well_known[None, :] | a.defined | lenient(b)
    return torch.all(custom_ok, dim=-1) & intersects_elemwise(a, b)


def set_eq_rows(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[..., K] bool — full-tuple per-key equality over broadcastable
    batches (mask, complement bit, exclusions, bounds, defined). Equal
    encodings denote the same requirement, so they intersect a third set
    alike: the per-pod step's incremental it-compat rests on this."""
    return (
        torch.all(a.mask == b.mask, dim=-1)
        & (a.inf == b.inf)
        & (a.excl == b.excl)
        & (a.gte == b.gte)
        & (a.lte == b.lte)
        & (a.defined == b.defined)
    )


def per_key_ok_table(a: ReqSetTensors, b: ReqSetTensors) -> torch.Tensor:
    """[A, K] bool — the per-key intersects() term between every row of a
    and ONE set b ([K, V] components); intersects(a_i, b) is the AND of
    row i."""
    shared = a.defined & b.defined[None, :]
    hit = torch.any(a.mask & b.mask[None], dim=-1)
    gte = torch.maximum(a.gte, b.gte[None, :])
    lte = torch.minimum(a.lte, b.lte[None, :])
    nonempty = hit | (a.inf & b.inf[None, :] & (gte <= lte))
    both_lenient = lenient(a) & lenient(b)[None, :]
    return ~shared | nonempty | both_lenient


def update_set_at(r: ReqSetTensors, idx, value: ReqSetTensors) -> ReqSetTensors:
    """r with batch row idx replaced by value (functional: r is not
    modified)."""
    out = []
    for x, v in zip(r, value):
        y = x.clone()
        y[idx] = v
        out.append(y)
    return ReqSetTensors(*out)


def per_key_ok_at(a: ReqSetTensors, b: ReqSetTensors, k: int) -> torch.Tensor:
    """[B, A] bool — the per-key intersects() term at key k between every
    row of a ([A, K, V]) and every row of b ([B, K, V]):
    ~shared | nonempty | both_lenient, in the solver's [claims, types]
    orientation."""
    shared = b.defined[:, None, k] & a.defined[None, :, k]
    nonempty = has_intersection_at(b, a, k)
    both_lenient = lenient(b)[:, None, k] & lenient(a)[None, :, k]
    return ~shared | nonempty | both_lenient


def intersect_sets(a: ReqSetTensors, b: ReqSetTensors) -> ReqSetTensors:
    """Elementwise requirement-set intersection over a shared batch shape:
    masks AND, complement AND, exclusions OR, bounds tighten, defined OR.
    Complement x complement with empty bounds collapses to a concrete
    DoesNotExist, and concrete results carry no bounds or exclusions
    (requirement.go:186-213), which keeps the derived leniency exact."""
    inf0 = a.inf & b.inf
    gte0 = torch.maximum(a.gte, b.gte)
    lte0 = torch.minimum(a.lte, b.lte)
    inf = inf0 & (gte0 <= lte0)
    return ReqSetTensors(
        mask=a.mask & b.mask,
        inf=inf,
        excl=(a.excl | b.excl) & inf,
        gte=torch.where(inf, gte0, torch.full_like(gte0, INT_MIN)),
        lte=torch.where(inf, lte0, torch.full_like(lte0, INT_MAX)),
        defined=a.defined | b.defined,
    )


def select_set(pred: torch.Tensor, a: ReqSetTensors, b: ReqSetTensors) -> ReqSetTensors:
    """where(pred, a, b) over every component; pred broadcasts from [B]."""

    def w(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)

    return ReqSetTensors(*(w(x, y) for x, y in zip(a, b)))


def take_set(r: ReqSetTensors, idx) -> ReqSetTensors:
    """Index the batch axis (an int, or an index tensor)."""
    return ReqSetTensors(*(x[idx] for x in r))


def broadcast_set(r: ReqSetTensors, n: int) -> ReqSetTensors:
    """One set ([K, V] components) broadcast to a batch of n."""
    return ReqSetTensors(*(x.unsqueeze(0).expand((n,) + tuple(x.shape)) for x in r))


# ---------------------------------------------------------------------------
# Packed boolean bitsets: int32 lanes in the reference's uint32 bit layout
# (column j in lane j//32 at bit j%32) — torch has no uint32 shifts on the
# CPU, and the bit patterns are identical under a view.
# ---------------------------------------------------------------------------

PACK_LANE = 32


def packed_width(n: int) -> int:
    """Lanes needed for an n-column bitset (>= 1)."""
    return max(-(-n // PACK_LANE), 1)


def pack_bool_np(a) -> np.ndarray:
    """Host-side packer: [..., N] bool -> [..., ceil(N/32)] int32."""
    a = np.asarray(a, dtype=bool)
    n = a.shape[-1]
    lanes = packed_width(n)
    pad = lanes * PACK_LANE - n
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), dtype=bool)], axis=-1)
    bits = a.reshape(a.shape[:-1] + (lanes, PACK_LANE)).astype(np.uint32)
    weights = np.uint32(1) << np.arange(PACK_LANE, dtype=np.uint32)
    return (bits * weights).sum(axis=-1, dtype=np.uint32).view(np.int32)


def pack_bool(a: torch.Tensor) -> torch.Tensor:
    """Device-side twin of pack_bool_np (same lane and bit layout): [..., N]
    bool -> [..., ceil(N/32)] int32 (the reference's uint32 lanes, same
    bits)."""
    n = a.shape[-1]
    lanes = packed_width(n)
    pad = lanes * PACK_LANE - n
    if pad:
        a = torch.cat([a, torch.zeros(a.shape[:-1] + (pad,), dtype=torch.bool, device=a.device)], dim=-1)
    bits = a.reshape(a.shape[:-1] + (lanes, PACK_LANE)).to(torch.int64)
    weights = torch.ones(PACK_LANE, dtype=torch.int64, device=a.device) << torch.arange(
        PACK_LANE, dtype=torch.int64, device=a.device)
    return ((bits * weights).sum(dim=-1) & 0xFFFFFFFF).to(torch.uint32).view(torch.int32)


def unpack_bool_np(packed, n: int) -> np.ndarray:
    """[..., L] 32-bit lanes -> [..., n] bool (inverse of pack_bool_np)."""
    packed = np.asarray(packed).view(np.uint32)
    shifts = np.arange(PACK_LANE, dtype=np.uint32)
    bits = (packed[..., :, None] >> shifts) & np.uint32(1)
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * PACK_LANE,))
    return flat[..., :n].astype(bool)


def leading_ones(packed, n: int) -> int:
    """The host's decode of a dp verdict word: the number of leading set
    bits among the first n columns of a packed [L] word — the groups that
    commit (the device already prefix-ANDs the rows; decode stops at the
    first clear bit either way)."""
    k = 0
    for b in unpack_bool_np(packed, n).reshape(-1)[:n]:
        if not b:
            break
        k += 1
    return k


def pairwise_commit_ok(conflict: torch.Tensor) -> torch.Tensor:
    """[DP] bool from a [q, r] conflict matrix: row r passes iff no EARLIER
    row q < r conflicts with it (conflicts at q >= r are ignored: the
    sequential replay only ever commits prefixes)."""
    n = conflict.shape[0]
    qi = torch.arange(n, device=conflict.device)
    return (~conflict | (qi[:, None] >= qi[None, :])).all(dim=0)


def packed_conflict(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...] bool — any(a & b) over the packed trailing axis."""
    return torch.any((a & b) != 0, dim=-1)


def packed_any(a: torch.Tensor) -> torch.Tensor:
    """[...] bool — any set bit over the packed trailing axis."""
    return torch.any(a != 0, dim=-1)


def packed_count_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...] int32 — popcount(a & b) over the packed trailing axis."""
    x = a & b
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(PACK_LANE):
        count += (x >> i) & 1
    return count.sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# The wire: one packed uint8 buffer per fetch (kernel H15 on the card)
# ---------------------------------------------------------------------------


class WireLeaf:
    """A fetch leaf read in place: the first `rows` rows of `src` (all of
    them when None), narrowed int32 -> int16 when `narrow` (the fetch
    preps' live-row slice and fill-grid narrowing). The wire kernel reads
    `src` where it lies, so the slice and the narrowing cost no launch."""

    __slots__ = ("src", "rows", "narrow")

    def __init__(self, src: torch.Tensor, rows: Optional[int] = None, narrow: bool = False):
        if narrow and src.dtype != torch.int32:
            raise ValueError(f"WireLeaf: only int32 narrows to int16, not {src.dtype}")
        self.src = src
        self.rows = src.shape[0] if rows is None else min(int(rows), src.shape[0])
        self.narrow = narrow

    @property
    def shape(self) -> tuple:
        return (self.rows,) + tuple(self.src.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return torch.int16 if self.narrow else self.src.dtype

    def tensor(self) -> torch.Tensor:
        t = self.src[: self.rows]
        return t.to(torch.int16) if self.narrow else t


class WireMax:
    """A 0-d int32 fetch leaf: the max over every element of `srcs`, each
    read at full size (the fetch preps' `fill_max` overflow guard over the
    whole fill grids)."""

    __slots__ = ("srcs",)
    shape = ()
    dtype = torch.int32

    def __init__(self, srcs):
        self.srcs = tuple(srcs)
        if not self.srcs or any(s.dtype != torch.int32 or s.numel() == 0 for s in self.srcs):
            raise ValueError("WireMax: one or more non-empty int32 sources")

    def tensor(self) -> torch.Tensor:
        return torch.stack([s.max() for s in self.srcs]).max()


_WIRE_TYPES = (torch.Tensor, WireLeaf, WireMax)

_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.uint32: np.uint32,
    torch.int64: np.int64,
    torch.float32: np.float32,
}


def materialize(leaf) -> torch.Tensor:
    """The plain tensor a fetch leaf stands for."""
    return leaf if isinstance(leaf, torch.Tensor) else leaf.tensor()


def dtype_groups(dtypes) -> dict:
    """{dtype: [leaf positions]} in order of first appearance — the wire's
    group order (the JAX package's _pack_wire)."""
    groups: dict = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
    return groups


def packbits_plain(bits: torch.Tensor) -> torch.Tensor:
    """np.packbits of a flat bool tensor: big-endian bits in each byte, the
    last byte zero-padded."""
    n = bits.numel()
    pad = -n % 8
    b = bits.reshape(-1).to(torch.int32)
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=b.device)
    return (b.reshape(-1, 8) * w).sum(dim=1, dtype=torch.int32).to(torch.uint8)


def pack_wire_plain(leaves: list) -> torch.Tensor:
    """The plain version of the wire kernel (H15), with the JAX package's
    _pack_wire byte layout: the leaves' dtype groups in order of first
    appearance, each the concatenation of its raveled leaves; bools
    packbits'ed across the whole group (one byte may straddle two leaves),
    every other dtype as its little-endian bytes. One uint8 tensor on the
    leaves' device."""
    ts = [materialize(t) for t in leaves]
    parts = []
    for dt, idx in dtype_groups([t.dtype for t in ts]).items():
        if dt == torch.bool:
            parts.append(packbits_plain(torch.cat([ts[i].reshape(-1) for i in idx])))
        else:
            parts.extend(ts[i].contiguous().reshape(-1).view(torch.uint8) for i in idx if ts[i].numel())
    if not parts:
        return torch.empty(0, dtype=torch.uint8, device=ts[0].device)
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def wire_layout(metas: list) -> tuple[list, int]:
    """[(dtype, [leaf positions], group byte offset, group elements)] and
    the wire's total bytes, for leaves of (shape, torch dtype) `metas`."""
    groups = []
    off = 0
    for dt, idx in dtype_groups([dt for _shape, dt in metas]).items():
        n = sum(math.prod(metas[i][0]) for i in idx)
        groups.append((dt, idx, off, n))
        off += -(-n // 8) if dt == torch.bool else n * dt.itemsize
    return groups, off


def unpack_wire(wire: np.ndarray, metas: list) -> list:
    """The host side of the wire: numpy arrays of (shape, torch dtype)
    `metas` from a packed uint8 buffer (the JAX package's
    _fetch_tree_impl decode, np.unpackbits(seg, count=n) included). Non-bool
    arrays are views of `wire`."""
    out: list = [None] * len(metas)
    groups, _total = wire_layout(metas)
    for dt, idx, woff, n in groups:
        npdt = np.dtype(_NP_DTYPES[dt])
        nbytes = -(-n // 8) if dt == torch.bool else n * npdt.itemsize
        seg = wire[woff : woff + nbytes]
        host = np.unpackbits(seg, count=n).astype(bool) if dt == torch.bool else seg.view(npdt)[:n]
        off = 0
        for i in idx:
            shape = tuple(metas[i][0])
            size = math.prod(shape)
            out[i] = host[off : off + size].reshape(shape)
            off += size
    return out


def canonicalize_for_wire(leaves: list) -> list:
    """The JAX package's _canonicalize_for_wire re-lays leaves partitioned
    over a device mesh as replicated before its packer. The port runs on
    one card, where every leaf is whole already: the identity."""
    return leaves


def _leaves(tree, out: list):
    if isinstance(tree, _WIRE_TYPES):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)


def _rebuild(tree, it):
    if isinstance(tree, _WIRE_TYPES):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def wire_sources(leaf) -> tuple:
    """The tensors a fetch leaf reads."""
    if isinstance(leaf, torch.Tensor):
        return (leaf,)
    return (leaf.src,) if isinstance(leaf, WireLeaf) else leaf.srcs


# fetches since the last reset_wire_stats(): wire bytes moved, and the bytes
# the same leaves take whole (unsliced, unnarrowed, a bool per byte)
WIRE_STATS = dict(fetches=0, wire_bytes=0, raw_bytes=0)


def reset_wire_stats() -> None:
    for k in WIRE_STATS:
        WIRE_STATS[k] = 0


def _raw_bytes(leaf) -> int:
    if isinstance(leaf, WireMax):
        return 4
    return sum(s.numel() * s.element_size() for s in wire_sources(leaf))


class PendingFetch:
    """A fetch in flight: wait() blocks until its wire is on the host and
    returns the tree with numpy arrays in place of its leaves."""

    def __init__(self, tree, host: Optional[torch.Tensor], metas: list, done=None, ready=None):
        self._tree, self._host, self._metas, self._done, self._ready = tree, host, metas, done, ready
        self.nbytes = 0 if host is None else host.numel()

    def wait(self):
        if self._ready is not None:
            return self._ready
        if self._done is not None:
            self._done.synchronize()
        host = unpack_wire(self._host.numpy(), self._metas) if self._metas else []
        self._ready = _rebuild(self._tree, iter(host))
        return self._ready


def fetch_async(tree, after=None, stream=None) -> PendingFetch:
    """Start the device->host transfer of a nested dict/list/tuple of
    tensors, WireLeaf and WireMax leaves as ONE packed wire. On the card,
    the wire kernel (H15) packs every leaf in one launch on `stream`
    (torch's current stream when None), after CUDA event `after`, and the
    wire is copied into its own pinned host buffer; every tensor the
    launch reads is marked as used on that stream. On the CPU the plain
    version packs. Non-tensor leaves pass through."""
    leaves: list = []
    _leaves(tree, leaves)
    if not leaves:
        return PendingFetch(tree, None, [], ready=tree)
    leaves = canonicalize_for_wire(leaves)
    metas = [(tuple(t.shape), t.dtype) for t in leaves]
    dev = wire_sources(leaves[0])[0].device
    if any(s.device != dev for t in leaves for s in wire_sources(t)):
        raise ValueError("fetch: leaves on more than one device")
    WIRE_STATS["fetches"] += 1
    WIRE_STATS["raw_bytes"] += sum(_raw_bytes(t) for t in leaves)
    if dev.type == "cpu":
        host = pack_wire_plain(leaves)
        WIRE_STATS["wire_bytes"] += host.numel()
        return PendingFetch(tree, host, metas)
    stream = stream or torch.cuda.current_stream(dev)
    with torch.cuda.stream(stream):
        if after is not None:
            stream.wait_event(after)
        wire = cuda.wire_pack(leaves)
        host = torch.empty(wire.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(wire, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    if stream != torch.cuda.current_stream(dev):
        for t in leaves:
            for s in wire_sources(t):
                s.record_stream(stream)
    WIRE_STATS["wire_bytes"] += host.numel()
    return PendingFetch(tree, host, metas, done=done)


def fetch_tree(tree):
    """Device->host transfer of a nested dict/list/tuple of tensors (and
    WireLeaf / WireMax leaves) as one packed wire, waited for: every leaf
    comes back as a numpy array in place. Non-tensor leaves pass through."""
    return fetch_async(tree).wait()
