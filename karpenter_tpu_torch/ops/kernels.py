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
"""

from __future__ import annotations

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
# One-copy fetch
# ---------------------------------------------------------------------------


def _leaves(tree, out: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
}


def fetch_tree(tree):
    """Device->host transfer of a nested dict/list/tuple of tensors with
    ONE copy: every leaf's bytes are concatenated on the device, copied
    once, and re-sliced into numpy arrays on the host. Non-tensor leaves
    pass through."""
    leaves: list = []
    _leaves(tree, leaves)
    if not leaves:
        return tree
    wire = torch.cat(
        [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    ).cpu().numpy()
    host = []
    off = 0
    for t in leaves:
        n = t.numel() * t.element_size()
        host.append(wire[off : off + n].view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape)))
        off += n
    return _rebuild(tree, iter(host))
