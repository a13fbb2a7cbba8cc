"""Build, load and launch the hand-written Hopper kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` (all started together) into a
shared library with a plain C interface, loaded with ctypes. The build
lands in build/karpenter_tpu_torch/<hash of sources and flags>/ under the
repository root, at first CUDA use, so a fresh checkout builds everything
itself. Launchers validate device, dtype, shape and contiguity, allocate
their outputs with torch, launch on torch's current stream, raise when the
C entry reports a CUDA error, and add one to LAUNCHES[name] per launch.
No launcher ever falls back to a plain version.
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import math
import operator
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# the per-pod scan's kernel, csrc/perpod_scan.cu: one launch per chunk of
# steps; its scenario mode (the batched what-ifs) counted on its own
PERPOD_KERNELS = ("perpod_scan_persistent",)
WHATIF_KERNELS = ("perpod_scan_persistent_whatif",)
KERNELS = (
    "req_intersects", "fill_count_grid", "water_fill", "compact_scatter", "kscan_grid",
    "kscan_pod_loop", *PERPOD_KERNELS, *WHATIF_KERNELS, "gang_scan", "retract_tail", "objective_verdict",
    "dp_dead", "dp_verdict", "merge_shard", "wire_pack",
)
# csrc/<source>.cu of each kernel (its own name unless listed), and the C
# entry points of each source (its own name unless listed)
SOURCE = {k: ("perpod_scan" if k in PERPOD_KERNELS + WHATIF_KERNELS else k) for k in KERNELS}
ENTRIES = {"perpod_scan": ("perpod_steps",), "gang_scan": ("gang_scan", "gang_scan_workspace")}
SOURCES = tuple(dict.fromkeys(SOURCE.values()))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"

# launches per kernel since the last reset_launches() (chip_smoke reads them)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


class LaunchRefused(KernelError, ValueError):
    """A launcher refused its arguments (device, dtype, layout or shape)
    before launching its kernel."""


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every source that is not built yet (one nvcc per source,
    in parallel) and load all of them. Returns {"seconds", "dir", "logs"};
    raises RuntimeError with the compiler's output on a failed build."""
    if len(_libs) == len(SOURCES):
        return BUILD_INFO
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            lib,
        )
    logs = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        (out / f"{name}.log").write_text(text)
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise KernelError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    for name in SOURCES:
        _libs[name] = _load(name, out / f"lib{name}.so")
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out), logs=logs)
    return BUILD_INFO


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_ARGTYPES = {
    "req_intersects": [_P] * 8 + [_I, _P, _P],
    "fill_count_grid": [_I, _P, _P, _P, _I64, _P, _P, _I64, _I, _P, _P, _P, _I, _P, _P],
    "water_fill": [_P, _P, _P, _I, _P, _P],
    "compact_scatter": [_I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _P],
    "kscan_grid": [_I, _P, _P, _P],
    "kscan_pod_loop": [_P, _I, _P, _P],
    "perpod_steps": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P],
    "gang_scan": [_P, _I, _P, _P],
    "gang_scan_workspace": [_P, _P, _P],
    "retract_tail": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "objective_verdict": [_P, _I, _P],
    "dp_dead": [_P, _I, _P, _P],
    "dp_verdict": [_P, _I, _P, _P],
    "merge_shard": [_P, _I, _P, _P],
    "wire_pack": [_P, _I64, _P, _P],
}


def _load(source: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in ENTRIES.get(source, (source,)):
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _invoke(source: str, entry: str, *args) -> None:
    """Call C entry `entry` of csrc/<source>.cu on torch's current stream;
    raise when it reports a CUDA error."""
    if source not in _libs:
        build()
    lib = _libs[source]
    rc = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{source}_error_string")(rc).decode()
        raise KernelError(f"{entry} launch failed: CUDA error {rc} ({msg})")


def _call(name: str, *args) -> None:
    """Launch kernel `name` once through its own C entry."""
    _invoke(SOURCE[name], name, *args)
    LAUNCHES[name] += 1


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if t.device != dev:
        raise LaunchRefused(f"{what}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise LaunchRefused(f"{what}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise LaunchRefused(f"{what}: not contiguous")
    return t


def _check_all(kernel: str, names, srcs, want, dev) -> None:
    """A layout's full check: each source's device, dtype, contiguity
    (_check) and shape against `want`'s (shape, dtype) pairs."""
    for name, t, (shape, dt) in zip(names, srcs, want):
        _check(t, name, dt, dev)
        if tuple(t.shape) != tuple(shape):
            raise LaunchRefused(f"{kernel}: {name} shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class LayoutCache:
    """A launcher's checked launch layouts by key (shapes, dtypes, the
    parameters that fix the kernel's dims): a layout is built, and checked
    in full, the first time its key is seen; the oldest of `cap` goes first."""

    def __init__(self, cap: int):
        self.cap = cap
        self.items: dict = {}

    def get(self, key, build):
        lay = self.items.get(key)
        if lay is None:
            if len(self.items) >= self.cap:
                self.items.pop(next(iter(self.items)))
            lay = self.items[key] = build()
        return lay


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


_REQ_DTYPES = (torch.bool, torch.bool, torch.bool, torch.int32, torch.int32, torch.bool)
# the types of one of csrc/req_intersects.cu's many-row tiles (a warp, four
# types a lane): the packed catalog's type axis is padded to a multiple of
# it, so that each tile's slice of a row starts on a 512-byte boundary
REQ_TILE_TYPES = 128


class ReqCatalog:
    """csrc/req_intersects.cu's packed form of one ReqSetTensors `b` (the
    catalog side, B types), with the type axis innermost and padded to Bp,
    a multiple of REQ_TILE_TYPES: [4][NKW][Bp] 32-bit words of key
    bits (defined, lenient, infinite, any mask value; bit k % 32 of word
    k // 32), then gte / lte [K][Bp] int32 and the mask [K][V/8][Bp] as
    8-byte words of V/8 values each, every section 16-byte aligned. The
    padding types define no key. `dims` is the C entry's (B, Bp, K, V, NKW)
    as a ctypes array."""

    def __init__(self, b):
        dev = b.mask.device
        for f, dt in zip(b._fields, _REQ_DTYPES):
            _check(getattr(b, f), f"b.{f}", dt, dev)
        B, K, V = b.mask.shape
        if V % 8:
            raise LaunchRefused(f"req_intersects: V={V} must be a multiple of 8")
        if any(tuple(getattr(b, f).shape) != (B, K) for f in b._fields[1:]):
            raise LaunchRefused(f"req_intersects: catalog shapes {[tuple(x.shape) for x in b]}")
        NKW = max(1, -(-K // 32))
        Bp = -(-B // REQ_TILE_TYPES) * REQ_TILE_TYPES
        any_m = b.mask.any(dim=-1)
        lenient = b.defined & ((b.inf & b.excl) | (~b.inf & ~any_m))
        bits = torch.stack([b.defined, lenient, b.inf, any_m])  # [4, B, K]
        if K == 0:
            bits = torch.zeros((4, B, 1), dtype=torch.bool, device=dev)
        words = bit_words(bits).permute(0, 2, 1)  # [4, NKW, B]

        def typed_last(x: torch.Tensor) -> torch.Tensor:  # [..., B] -> [..., Bp] bytes
            out = torch.zeros(tuple(x.shape[:-1]) + (Bp,), dtype=x.dtype, device=dev)
            out[..., :B] = x
            raw = out.contiguous().view(torch.uint8).reshape(-1)
            return torch.cat([raw, torch.zeros(-raw.numel() % 16, dtype=torch.uint8, device=dev)])

        mask8 = torch.zeros((K, V // 8, Bp, 8), dtype=torch.bool, device=dev)
        mask8[:, :, :B] = b.mask.reshape(B, K, V // 8, 8).permute(1, 2, 0, 3)
        self.packed = torch.cat([
            typed_last(words), typed_last(b.gte.T), typed_last(b.lte.T),
            mask8.view(torch.uint8).reshape(-1),
        ])
        self.device, self.B, self.K, self.V = dev, B, K, V
        self.dims = (ctypes.c_int * 5)(B, Bp, K, V, NKW)
        self.dims_ptr = ctypes.cast(self.dims, ctypes.c_void_p)


def req_catalog(b) -> ReqCatalog:
    """The packed catalog of requirement sets `b`, built and checked once
    per catalog (packed_catalog)."""
    return packed_catalog("req_intersects", tuple(b), lambda: ReqCatalog(b))


def req_intersects(a, b) -> torch.Tensor:
    """H1: [A, B] bool intersects(a, b) for two ReqSetTensors on CUDA. The
    catalog side `b` is packed and checked once per catalog (req_catalog);
    every call checks the claim side `a`."""
    cat = req_catalog(b)
    A, K, V = a.mask.shape
    if (K, V) != (cat.K, cat.V):
        raise LaunchRefused(f"req_intersects: key/value axes differ {a.mask.shape} vs {b.mask.shape}")
    for f, dt in zip(a._fields, _REQ_DTYPES):
        t = _check(getattr(a, f), f"a.{f}", dt, cat.device)
        if f != "mask" and tuple(t.shape) != (A, K):
            raise LaunchRefused(f"req_intersects: a.{f} {tuple(t.shape)} vs ({A}, {K})")
    if a.mask.data_ptr() % 8:
        raise LaunchRefused("req_intersects: a.mask is not 8-byte aligned")
    out = torch.empty((A, cat.B), dtype=torch.bool, device=cat.device)
    _call("req_intersects", *[t.data_ptr() for t in a], cat.packed.data_ptr(), cat.dims_ptr, A, out.data_ptr())
    return out


# Packed catalogs (H1's ReqCatalog, H2's FillGridCatalog, H5's
# KScanCatalog), each built once per catalog: keyed on its kind, its
# parameters and the identity of its source tensors. An entry holds those
# tensors, so their ids stay theirs while it lives, and their version
# counters, so a catalog changed in place is packed anew. The oldest of
# PACKED_CATALOG_CAP entries goes first: a catalog holds one of H1's, one
# of H2's and one of H5's for each (key, D) the kind scan reads it on, so
# at one such pair 5 live catalogs stay packed.
PACKED_CATALOG_CAP = 16
_PACKED_CATALOGS: dict = {}


def packed_catalog(kind: str, sources: tuple, build, *params):
    """build()'s packed catalog of the tensors `sources`, cached (see
    _PACKED_CATALOGS)."""
    key = (kind, *params, *map(id, sources))
    versions = tuple(t._version for t in sources)
    hit = _PACKED_CATALOGS.get(key)
    if hit is not None and hit[0] == versions:
        return hit[1]
    _PACKED_CATALOGS.pop(key, None)
    if len(_PACKED_CATALOGS) >= PACKED_CATALOG_CAP:
        _PACKED_CATALOGS.pop(next(iter(_PACKED_CATALOGS)))
    cat = build()
    _PACKED_CATALOGS[key] = (versions, cat, sources)
    return cat


# H2's packed catalog: the bytes of shared memory a block stages a tile of
# it into (csrc/fill_count_grid.cu adds its per-warp scratch beside it)
FILL_GRID_SMEM = 200 * 1024


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def fill_grid_r_bucket(R: int) -> int:
    """The floats a packed catalog cell holds: R rounded up to 4, 8 or 16
    (csrc/fill_count_grid.cu r_bucket)."""
    return 4 if R <= 4 else 8 if R <= 8 else 16


def fill_grid_tile_bytes(TT: int, GR: int, R: int, NWZ: int) -> int:
    """Bytes of one tile of TT types of the packed catalog (its three
    sections, each padded to 16 bytes, as csrc/fill_count_grid.cu lays
    them out)."""
    cells = GR * TT
    return _pad16(4 * fill_grid_r_bucket(R) * cells) + _pad16(8 * NWZ * cells) + _pad16(cells)


class FillGridCatalog:
    """csrc/fill_count_grid.cu's packed catalog of one InstanceTypeTensors:
    ceil(T / TT) tiles of TT types, each [GR][TT][RB] f32 allocatable (R
    padded to RB = fill_grid_r_bucket(R), so that a cell is whole 16-byte
    loads), [NWZ][GR][TT] 64-bit words of available (zone, capacity-type)
    pairs (bit z*C + c) and [GR][TT] validity bytes; TT is the most types whose
    tile fits FILL_GRID_SMEM (staged = 0: one tile of all T types, read
    from device memory, when not even one type fits). `dims` is the C
    entry's (T, GR, R, Z, C, NWZ, TT, staged) as a ctypes array."""

    def __init__(self, it):
        alloc, gv, zc = it.alloc, it.group_valid, it.zc_avail
        dev = alloc.device
        _check(alloc, "alloc", torch.float32, dev)
        _check(gv, "group_valid", torch.bool, dev)
        _check(zc, "zc_avail", torch.bool, dev)
        T, GR, R = alloc.shape
        Z, C = zc.shape[2], zc.shape[3]
        if tuple(gv.shape) != (T, GR) or tuple(zc.shape[:2]) != (T, GR):
            raise LaunchRefused(f"fill_count_grid: catalog shapes {tuple(alloc.shape)} {tuple(gv.shape)} "
                                f"{tuple(zc.shape)}")
        if R > 16:
            raise LaunchRefused(f"fill_count_grid: R={R} resources, the kernel takes at most 16")
        NWZ = max(1, -(-(Z * C) // 64))
        per_type = fill_grid_tile_bytes(1, GR, R, NWZ)
        TT = T
        while TT > 1 and fill_grid_tile_bytes(TT, GR, R, NWZ) > FILL_GRID_SMEM:
            TT = max(1, min(TT - 1, FILL_GRID_SMEM * TT // fill_grid_tile_bytes(TT, GR, R, NWZ)))
        staged = int(T > 0 and per_type <= FILL_GRID_SMEM)
        if not staged:
            TT = max(T, 1)
        nt = -(-T // TT) if T else 0
        Tp = nt * TT
        RB = fill_grid_r_bucket(R)
        a = torch.zeros((Tp, GR, RB), dtype=torch.float32, device=dev)
        a[:T, :, :R] = alloc
        bits = torch.zeros((Tp, GR, NWZ * 64), dtype=torch.int64, device=dev)
        bits[:T, :, :Z * C] = zc.reshape(T, GR, Z * C).to(torch.int64)
        shifts = torch.arange(64, dtype=torch.int64, device=dev)
        words = (bits.view(Tp, GR, NWZ, 64) << shifts).sum(dim=-1)  # distinct bits: the sum is their OR
        v = torch.zeros((Tp, GR), dtype=torch.uint8, device=dev)
        v[:T] = gv.to(torch.uint8)

        def section(x: torch.Tensor) -> torch.Tensor:  # [nt, ...] -> [nt, bytes padded to 16]
            flat = x.contiguous().view(torch.uint8).reshape(nt, -1)
            pad = _pad16(flat.shape[1]) - flat.shape[1]
            return torch.cat([flat, torch.zeros((nt, pad), dtype=torch.uint8, device=dev)], dim=1)

        self.packed = torch.cat([
            section(a.view(nt, TT, GR, RB).permute(0, 2, 1, 3)),
            section(words.view(nt, TT, GR, NWZ).permute(0, 3, 2, 1)),
            section(v.view(nt, TT, GR).permute(0, 2, 1)),
        ], dim=1).contiguous() if nt else torch.zeros((0,), dtype=torch.uint8, device=dev)
        self.device, self.T, self.R, self.Z, self.C = dev, T, R, Z, C
        self.ntiles, self.staged = nt, staged
        self.dims = (ctypes.c_int * 8)(T, GR, R, Z, C, NWZ, TT, staged)
        self.dims_ptr = ctypes.cast(self.dims, ctypes.c_void_p)


def fill_grid_catalog(it) -> FillGridCatalog:
    """The packed catalog of `it`, built once per catalog (packed_catalog,
    on its alloc / group_valid / zc_avail tensors)."""
    return packed_catalog("fill_count_grid", (it.alloc, it.group_valid, it.zc_avail),
                          lambda: FillGridCatalog(it), FILL_GRID_SMEM)


def fill_count_grid(
    mode: int,
    used: torch.Tensor,
    req: torch.Tensor,
    it,
    rows_mask: Optional[torch.Tensor],
    zone_kid: int,
    ct_kid: int,
    n_rows: int,
    viable: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H2. mode 0: [n_rows] int32 max fill count over viable cells; mode 1:
    [n_rows, T] bool fits at counts[b]. `used` is [n_rows, R] or [1, R]
    (broadcast); `rows_mask` is the [n_rows or 1, K, V] requirement mask
    whose zone / capacity-type rows gate the offering test, or None for no
    offering gate. The catalog is checked and packed once
    (fill_grid_catalog); a call checks its own tensors."""
    cat = fill_grid_catalog(it)
    dev, T, R = cat.device, cat.T, cat.R
    _check(used, "used", torch.float32, dev)
    _check(req, "req", torch.float32, dev)
    if used.shape[1] != R or req.shape != (R,) or used.shape[0] not in (1, n_rows):
        raise LaunchRefused(f"fill_count_grid: used {tuple(used.shape)} / req {tuple(req.shape)} vs R={R}, rows={n_rows}")
    used_stride = 0 if used.shape[0] == 1 else R
    if rows_mask is not None:
        _check(rows_mask, "rows_mask", torch.bool, dev)
        K, V = rows_mask.shape[1], rows_mask.shape[2]
        if rows_mask.shape[0] not in (1, n_rows) or cat.Z > V or cat.C > V:
            raise LaunchRefused(f"fill_count_grid: rows_mask {tuple(rows_mask.shape)} vs rows={n_rows}, Z={cat.Z}, C={cat.C}")
        base = rows_mask.data_ptr()
        zptr, cptr = base + zone_kid * V, base + ct_kid * V
        mask_stride = 0 if rows_mask.shape[0] == 1 else K * V
        gate = 1
    else:
        zptr = cptr = None
        mask_stride = 0
        gate = 0
    if mode == 0:
        _check(viable, "viable", torch.bool, dev)
        if viable.shape != (n_rows, T):
            raise LaunchRefused(f"fill_count_grid: viable {tuple(viable.shape)} vs ({n_rows}, {T})")
        out = torch.empty(n_rows, dtype=torch.int32, device=dev)
    else:
        _check(counts, "counts", torch.int32, dev)
        if counts.shape != (n_rows,):
            raise LaunchRefused(f"fill_count_grid: counts {tuple(counts.shape)} vs ({n_rows},)")
        out = torch.empty((n_rows, T), dtype=torch.bool, device=dev)
    _call(
        "fill_count_grid", mode, cat.packed.data_ptr(), req.data_ptr(), used.data_ptr(), used_stride, zptr, cptr,
        mask_stride, gate, _ptr(viable), _ptr(counts), out.data_ptr(), n_rows, cat.dims_ptr,
    )
    return out


def water_fill(p: torch.Tensor, f: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """H3: [N] int32 water-fill of `rem` (a device int32 scalar) pods. One
    pass checks device, dtype, layout and shape; only the output is
    allocated."""
    dev = p.device
    i32 = torch.int32
    if not (p.dtype == i32 and f.dtype == i32 and rem.dtype == i32 and p.dim() == 1 and f.shape == p.shape
            and rem.numel() == 1 and f.device == dev and rem.device == dev and p.is_contiguous()
            and f.is_contiguous()):
        _check(p, "p", i32, dev)
        _check(f, "f", i32, dev)
        _check(rem.reshape(1), "rem", i32, dev)
        raise LaunchRefused(f"water_fill: p {tuple(p.shape)} vs f {tuple(f.shape)}")
    out = torch.empty_like(p)
    _call("water_fill", p.data_ptr(), f.data_ptr(), rem.data_ptr(), p.shape[0], out.data_ptr())
    return out


# csrc/compact_scatter.cu kTile: the rows a block owns, one look-back flag each
H4_TILE = 32


class _ScatterLayout:
    """One checked compact_scatter layout: each field's (row bytes, source
    row bytes, key-row segment bytes) and the key ids as the C entry's host
    arrays, and the pointer array a call fills."""

    def __init__(self, mode, sel, srcs, dsts, tk, tk_srcs, tk_dsts):
        dev = sel.device
        n = sel.shape[0]
        _check(sel, "sel", torch.bool if mode == 0 else torch.int32, dev)
        if not srcs or len(srcs) != len(dsts) or len(tk_srcs) != len(tk_dsts):
            raise LaunchRefused("compact_scatter: need matching src/dst lists")
        if tk_srcs and not tk:
            raise LaunchRefused("compact_scatter: key-row fields need key ids")
        n_dst = dsts[0].shape[0]
        layout = []
        for s, d in zip(srcs, dsts):
            _check(s, "src", s.dtype, dev)
            _check(d, "dst", s.dtype, dev)
            if s.shape[0] != n or d.shape[0] != n_dst or s.shape[1:] != d.shape[1:]:
                raise LaunchRefused(f"compact_scatter: src {tuple(s.shape)} / dst {tuple(d.shape)} vs rows {n}/{n_dst}")
            rb = s[0].numel() * s.element_size() if n else 0
            layout += [rb, rb, 0]
        for s, d in zip(tk_srcs, tk_dsts):
            _check(s, "tk src", s.dtype, dev)
            _check(d, "tk dst", s.dtype, dev)
            if (s.shape[0] != n or d.shape[0] != n_dst or d.shape[1] != len(tk)
                    or s.shape[2:] != d.shape[2:] or max(tk) >= s.shape[1]):
                raise LaunchRefused(f"compact_scatter: tk src {tuple(s.shape)} / dst {tuple(d.shape)} vs tk {tk}")
            seg = s[0, 0].numel() * s.element_size() if n else 0
            layout += [seg * len(tk), s[0].numel() * s.element_size() if n else 0, seg]
        k = len(srcs) + len(tk_srcs)
        self.n, self.n_dst, self.k = n, n_dst, k
        self.n_tk = len(tk) if tk_srcs else 0
        self.layout = (ctypes.c_int64 * (3 * k))(*layout)
        self.tk = (ctypes.c_int * max(len(tk), 1))(*tk)
        self.ptrs = (ctypes.c_int64 * (2 * k))()
        self.args = [ctypes.cast(x, ctypes.c_void_p) for x in (self.ptrs, self.layout, self.tk)]


_SCATTER_LAYOUTS = LayoutCache(64)
# mode 0's look-back workspaces, one per (device, stream): [2 + tiles]
# int32, zeroed once; every launch leaves it zeroed
_SCATTER_WS: dict = {}


def _scatter_workspace(sel: torch.Tensor, tiles: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(sel.device).cuda_stream if sel.is_cuda else None
    key = (sel.device, stream)
    ws = _SCATTER_WS.get(key)
    if ws is None or ws.numel() < 2 + tiles:
        ws = _SCATTER_WS[key] = torch.zeros(2 + max(tiles, 4096 // H4_TILE), dtype=torch.int32, device=sel.device)
    return ws


def compact_scatter(
    mode: int, sel: torch.Tensor, srcs: list, dsts: list,
    tk: tuple = (), tk_srcs: list = (), tk_dsts: list = (),
) -> None:
    """H4: move rows of every src field into its dst field, in place —
    mode 0: to the stable-compacted position of the alive rows (sel =
    [n] bool); mode 1: to sel[i] (int32 ids), dropping out-of-range ids.
    Each tk_src [n, K, ...] moves only its key rows `tk` into its tk_dst
    [n_dst, len(tk), ...], in the same launch. One launch, no allocation
    (mode 0's workspace is allocated once per stream): a layout of field
    shapes and dtypes is checked in full the first time it is seen, later
    calls by one pass over device and contiguity."""
    ts = (sel, *srcs, *tk_srcs, *dsts, *tk_dsts)
    key = (mode, tuple(tk), len(srcs), len(tk_srcs),
           *[(t.shape, t.dtype, t.get_device(), t.is_contiguous()) for t in ts])
    lay = _SCATTER_LAYOUTS.get(key, lambda: _ScatterLayout(mode, sel, srcs, dsts, tk, tk_srcs, tk_dsts))
    k = lay.k
    ptrs = [t.data_ptr() for t in ts]
    lay.ptrs[0::2] = ptrs[1:1 + k]
    lay.ptrs[1::2] = ptrs[1 + k:]
    tiles = -(-lay.n // H4_TILE)
    ws = _scatter_workspace(sel, tiles) if mode == 0 else None
    _call(
        "compact_scatter", mode, lay.n, ptrs[0], lay.n_dst, k, *lay.args[:2], lay.n_tk, lay.args[2],
        _ptr(ws), ws.numel() - 2 if ws is not None else 0,
    )


def _i64_array(vals) -> ctypes.Array:
    return (ctypes.c_int64 * len(vals))(*vals)


class KScanCatalog:
    """csrc/kscan_grid.cu's catalog side for one (catalog, key, D): H2's
    packed catalog (fill_grid_catalog, shared with H2) and a [T] int32
    column of each type's admitted domains of the key, bit d of
    ~defined[t, key] | mask[t, key, d] for d < D. Built and checked once
    (kscan_catalog). It keeps the checked launch layouts read through it
    (layout), so they go with it."""

    def __init__(self, it, key_kid: int, D: int):
        dev = it.alloc.device
        K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
        if D < 1 or D > 16 or D > V:
            raise LaunchRefused(f"kscan_grid: D={D} outside [1, min(16, V={V})]")
        _check(it.alloc, "alloc", torch.float32, dev)
        _check(it.group_valid, "group_valid", torch.bool, dev)
        _check(it.zc_avail, "zc_avail", torch.bool, dev)
        _check(it.reqs.defined, "it.defined", torch.bool, dev)
        _check(it.reqs.mask, "it.mask", torch.bool, dev)
        self.fill = fill_grid_catalog(it)
        bits = ~it.reqs.defined[:, key_kid, None] | it.reqs.mask[:, key_kid, :D]  # [T, D]
        shifts = torch.arange(D, dtype=torch.int64, device=dev)
        self.admit = (bits.to(torch.int64) << shifts).sum(dim=-1).to(torch.int32).contiguous()
        T, GR, R, Z, C, NWZ, TT, staged = self.fill.dims
        self.device, self.T, self.GR, self.R, self.Z, self.K, self.V = dev, T, GR, R, Z, K, V
        self.dims = (T, GR, R, Z, C, D, NWZ, TT, staged)
        self.layouts = LayoutCache(16)

    def layout(self, key, build) -> "_KScanLayout":
        """The layout of `key` (mode, keys, shapes and dtypes): cached, or
        built (checked in full) by build()."""
        return self.layouts.get(key, build)


def kscan_catalog(it, key_kid: int, D: int) -> KScanCatalog:
    """The catalog side of H5 for (it, key_kid, D), built once
    (packed_catalog, on it's alloc / group_valid / zc_avail and
    requirement tensors)."""
    return packed_catalog(
        "kscan_grid", (it.alloc, it.group_valid, it.zc_avail, it.reqs.defined, it.reqs.mask),
        lambda: KScanCatalog(it, key_kid, D), key_kid, D, FILL_GRID_SMEM,
    )


class _KScanLayout:
    """One checked kscan_grid / kscan_fits_final layout: the C entry's dims
    and the pointer array a call fills (csrc/kscan_grid.cu's order)."""

    def __init__(self, cat: KScanCatalog, N: int, zone: bool, mask_stride: int):
        T, GR, R, Z, C, D, NWZ, TT, staged = cat.dims
        self.N = N
        self.ptrs = (ctypes.c_int64 * 11)(cat.fill.packed.data_ptr(), cat.admit.data_ptr())
        self.dims = (ctypes.c_int64 * 12)(N, T, GR, R, Z, C, D, int(zone), NWZ, TT, staged, mask_stride)
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), ctypes.cast(self.dims, ctypes.c_void_p))


def _check_place(dev, names: tuple, ts) -> None:
    """Device and contiguity of a layout's tensors in one pass; a failure
    raises _check's LaunchRefused."""
    index = dev.index if dev.type == "cuda" else -1
    if not (all(map(torch.Tensor.is_contiguous, ts)) and set(map(torch.Tensor.get_device, ts)) == {index}):
        for name, t in zip(names, ts):
            _check(t, name, t.dtype, dev)


def kscan_grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid=None):
    """H5 grid mode: (grid [N, T, GR] int32, capd [N, D] int32) for the
    rows of `used` [N, R], the viable mask [N, T] and the rows' [N, K, V]
    requirement mask (its zone / capacity-type rows gate offerings). With
    `grid` given, only capd is computed from it. The catalog side is
    packed once (kscan_catalog), each layout of shapes, dtypes and keys
    checked in full once; a call checks device and contiguity in one pass
    and allocates only its outputs."""
    cat = kscan_catalog(it, key_kid, D)
    dev = cat.device
    mode = 0 if grid is None else 1
    ts = (used, req, viable, rows_mask) if grid is None else (used, req, viable, rows_mask, grid)
    key = (mode, zone_kid, ct_kid, used.shape, used.dtype, req.shape, req.dtype, viable.shape, viable.dtype,
           rows_mask.shape, rows_mask.dtype, None if grid is None else (grid.shape, grid.dtype))
    lay = cat.layout(key, lambda: _kscan_grid_layout(cat, used, req, viable, rows_mask, zone_kid, key_kid, D, grid))
    _check_place(dev, ("used", "req", "viable", "rows_mask", "grid"), ts)
    N, V = lay.N, cat.V
    if grid is None:
        grid = torch.empty((N, cat.T, cat.GR), dtype=torch.int32, device=dev)
    capd = torch.empty((N, D), dtype=torch.int32, device=dev)
    base = rows_mask.data_ptr()
    p = lay.ptrs
    p[2], p[3], p[4] = req.data_ptr(), used.data_ptr(), viable.data_ptr()
    p[5], p[6] = base + zone_kid * V, base + ct_kid * V
    p[9], p[10] = grid.data_ptr(), capd.data_ptr()
    _call("kscan_grid", mode, *lay.args)
    return grid, capd


def _kscan_grid_layout(cat, used, req, viable, rows_mask, zone_kid, key_kid, D, grid) -> _KScanLayout:
    dev = cat.device
    T, GR, R, Z, K, V = cat.T, cat.GR, cat.R, cat.Z, cat.K, cat.V
    N = used.shape[0]
    _check(used, "used", torch.float32, dev)
    _check(req, "req", torch.float32, dev)
    _check(viable, "viable", torch.bool, dev)
    _check(rows_mask, "rows_mask", torch.bool, dev)
    if used.shape != (N, R) or req.shape != (R,) or viable.shape != (N, T) or rows_mask.shape != (N, K, V):
        raise LaunchRefused(f"kscan_grid: used {tuple(used.shape)} viable {tuple(viable.shape)} mask {tuple(rows_mask.shape)}")
    if key_kid == zone_kid and D > Z:
        raise LaunchRefused(f"kscan_grid: zone key with D={D} > Z={Z}")
    if grid is not None:
        _check(grid, "grid", torch.int32, dev)
        if grid.shape != (N, T, GR):
            raise LaunchRefused(f"kscan_grid: grid {tuple(grid.shape)} vs ({N}, {T}, {GR})")
    return _KScanLayout(cat, N, key_kid == zone_kid, K * V)


def kscan_fits_final(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D) -> torch.Tensor:
    """H5 fits-final mode: [N, T] bool any over g of grid >= placed[n] with
    an offering in the final domains zset [N, D] (zone key) or the zone
    mask rows zmask [N, V]; ct_mask [N, V] gates capacity types. Checked
    and launched as kscan_grid."""
    cat = kscan_catalog(it, key_kid, D)
    dev = cat.device
    ts = (grid, placed, zset, ct_mask, zmask)
    key = (2, zone_kid, grid.shape, grid.dtype, placed.shape, placed.dtype, zset.shape, zset.dtype,
           ct_mask.shape, ct_mask.dtype, zmask.shape, zmask.dtype)
    lay = cat.layout(key, lambda: _fits_final_layout(cat, grid, placed, zset, ct_mask, zmask, key_kid, zone_kid, D))
    _check_place(dev, ("grid", "placed", "zset", "ct_mask", "zmask"), ts)
    out = torch.empty((lay.N, cat.T), dtype=torch.bool, device=dev)
    p = lay.ptrs
    p[5], p[6], p[7], p[8] = zmask.data_ptr(), ct_mask.data_ptr(), zset.data_ptr(), placed.data_ptr()
    p[9], p[10] = grid.data_ptr(), out.data_ptr()
    _call("kscan_grid", 2, *lay.args)
    return out


def _fits_final_layout(cat, grid, placed, zset, ct_mask, zmask, key_kid, zone_kid, D) -> _KScanLayout:
    dev = cat.device
    T, GR, V = cat.T, cat.GR, cat.V
    N = grid.shape[0]
    _check(grid, "grid", torch.int32, dev)
    _check(placed, "placed", torch.int32, dev)
    _check(zset, "zset", torch.bool, dev)
    _check(ct_mask, "ct_mask", torch.bool, dev)
    _check(zmask, "zmask", torch.bool, dev)
    if (grid.shape != (N, T, GR) or placed.shape != (N,) or zset.shape != (N, D)
            or ct_mask.shape != (N, V) or zmask.shape != (N, V)):
        raise LaunchRefused("kscan_fits_final: shapes disagree")
    return _KScanLayout(cat, N, key_kid == zone_kid, V)


_LOOP_IN = (
    ("cap_e", torch.int32), ("zie0", torch.bool), ("open0", torch.bool), ("static_n0", torch.bool),
    ("pods0", torch.int32), ("zin0", torch.bool), ("static_g", torch.bool), ("capd_g", torch.int32),
    ("z0_g", torch.bool), ("zinf_g", torch.bool), ("w_open0", torch.int32), ("self_conf", torch.bool),
    ("key_touched", torch.bool), ("gate", torch.bool), ("recs", torch.bool), ("vg_self", torch.bool),
    ("pd", torch.bool), ("hg_applies", torch.bool), ("hg_records", torch.bool), ("hg_self", torch.bool),
)
_LOOP_TOPO = (
    ("vg_type", torch.int32), ("vg_skew", torch.int32), ("vg_min_domains", torch.int32),
    ("vg_domains", torch.bool), ("vg_rank", torch.int32), ("hg_type", torch.int32),
    ("hg_skew", torch.int32), ("hg_valid", torch.bool), ("hg_extra_nonempty", torch.bool),
)
_LOOP_CARRY = (
    ("zn", torch.bool), ("ze", torch.bool), ("capd", torch.int32), ("pl_n", torch.int32),
    ("pl_e", torch.int32), ("tmpl_n", torch.int32), ("cnt", torch.int32), ("hgc", torch.int32),
    ("n_open", torch.int32), ("w_open", torch.int32), ("slot_of", torch.int32), ("spills", torch.int32),
)


def rank_order(rank: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The templates in the order tier 3 tries them: [G] int32, a stable
    argsort of the rank column (ties to the lowest index); None (weight
    order) for no rank. The kernels key tier 3 on a template's position in
    it, so a rank is compared as a signed value and never used as an
    index."""
    return None if rank is None else torch.argsort(rank, stable=True).to(torch.int32)


def kscan_pod_loop(inp, carry, topo, count: int, maxc: int, n_claims: int, rank=None) -> torch.Tensor:
    """H6: the kind scan's pod loop for one segment in one launch. `inp`
    (ops.solver.PodLoopIn) is read, `carry` (PodLoopCarry) updated in
    place; returns the [maxc] int32 assignment row. `rank` (the
    templates' [G] int32 rank, None for weight order) orders tier 3."""
    dev = carry.zn.device
    W, D = carry.zn.shape
    E = carry.ze.shape[0]
    G = inp.static_g.shape[0]
    NGv, NGh = topo.vg_type.shape[0], topo.hg_type.shape[0]
    S, V = carry.hgc.shape[1], topo.vg_domains.shape[1]
    if count > maxc:
        raise LaunchRefused(f"kscan_pod_loop: {count} pods > buffer {maxc}")
    shapes = dict(
        cap_e=(E,), zie0=(E,), open0=(W,), static_n0=(W,), pods0=(W,), zin0=(W,), static_g=(G,),
        capd_g=(G, D), z0_g=(G, D), zinf_g=(G,), w_open0=(), self_conf=(), key_touched=(),
        gate=(NGv,), recs=(NGv,), vg_self=(NGv,), pd=(D,), hg_applies=(NGh,), hg_records=(NGh,),
        hg_self=(NGh,), zn=(W, D), ze=(E, D), capd=(W, D), pl_n=(W,), pl_e=(E,), tmpl_n=(W,),
        cnt=(NGv, D), hgc=(NGh, S), n_open=(), w_open=(), slot_of=(W,), spills=(),
    )
    ptrs = []
    for group, fields in ((inp, _LOOP_IN), (topo, _LOOP_TOPO), (carry, _LOOP_CARRY)):
        for name, dt in fields:
            t = _check(getattr(group, name), name, dt, dev)
            if name in shapes and tuple(t.shape) != shapes[name]:
                raise LaunchRefused(f"kscan_pod_loop: {name} {tuple(t.shape)} vs {shapes[name]}")
            ptrs.append(t.data_ptr())
    out = torch.full((maxc,), -1, dtype=torch.int32, device=dev)
    ptrs.append(out.data_ptr())
    order = rank_order(rank)
    if order is not None and (tuple(order.shape) != (G,) or order.device != dev):
        raise LaunchRefused(f"kscan_pod_loop: rank {tuple(rank.shape)} on {rank.device} vs ({G},) on {dev}")
    ptrs.append(0 if order is None else order.data_ptr())
    # the kernel's workspace: live-row records past its shared memory
    # [E+G+W][4], hostname slot words past it [S], row -> record [W], the
    # records' next-room words [E+G+W]
    ws = torch.empty(5 * (E + G + W) + S + W, dtype=torch.int32, device=dev)
    ptrs.append(ws.data_ptr())
    _call(
        "kscan_pod_loop", ctypes.cast(_i64_array(ptrs), ctypes.c_void_p), len(ptrs),
        ctypes.cast(_i64_array([E, W, G, D, NGv, NGh, S, V, n_claims, count]), ctypes.c_void_p),
    )
    return out




# ---------------------------------------------------------------------------
# the per-pod scan: perpod_scan_persistent, one launch per chunk of steps
# (one block) or per what-if batch (one block per scenario)
# ---------------------------------------------------------------------------


def _set_fields(prefix: str, r, n: int, K: int, V: int) -> list:
    b, i = torch.bool, torch.int32
    shapes = ((n, K, V), (n, K), (n, K), (n, K), (n, K), (n, K))
    return [(f"{prefix}.{f}", getattr(r, f), dt, sh)
            for f, dt, sh in zip(r._fields, (b, b, b, i, i, b), shapes)]


def _perpod_fields(state, xs, ctx, row_max, assignment) -> tuple[list, list]:
    """The 83 (name, tensor, dtype, shape) fields of csrc/perpod_scan.cu's
    parameter block, in its order, and its 29 dims. `row_max` [W, R] f32 is
    the kernel's scratch. t_order (rank_order of the templates' rank) is
    None for weight order (a null pointer). The last, pod_idx, is None (a
    null pointer: step i reads pod row i); scenario mode sets it. The type
    tables travel packed (`perpod_tables`)."""
    b, i, f = torch.bool, torch.int32, torch.float32
    exist, it, tm, topo = ctx.exist, ctx.it, ctx.templates, ctx.topo
    W, T = state.its.shape
    E, R = exist.avail.shape
    G = tm.its.shape[0]
    K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
    GR, Z, C = it.zc_avail.shape[1], it.zc_avail.shape[2], it.zc_avail.shape[3]
    NGv, NGh = topo.vg_type.shape[0], topo.hg_type.shape[0]
    Sl = state.hg_counts.shape[1]
    NPp, NVp, ND = state.claim_ports.shape[1], state.exist_vols.shape[1], exist.vol_limits.shape[1]
    L = xs.requests.shape[0]
    NCAP = ctx.n_claims
    J, M = tm.mv_it_values.shape[1], tm.mv_key.shape[1]
    RID, RZ = it.res_ofs.shape[1], it.res_ofs.shape[2]
    if Sl < E + NCAP + 1:
        raise LaunchRefused(f"perpod_scan: hostname slots {Sl} < E + n_claims + 1 = {E + NCAP + 1}")
    fields = (
        _set_fields("exist_reqs", state.exist_reqs, E, K, V)
        + [("exist_used", state.exist_used, f, (E, R))]
        + _set_fields("reqs", state.reqs, W, K, V)
        + [
            ("used", state.used, f, (W, R)), ("its", state.its, b, (W, T)), ("template", state.template, i, (W,)),
            ("open", state.open, b, (W,)), ("pods", state.pods, i, (W,)), ("n_open", state.n_open, i, ()),
            ("slot_of", state.slot_of, i, (W,)), ("w_open", state.w_open, i, ()), ("w_hw", state.w_hw, i, ()),
            ("spills", state.spills, i, ()), ("budget", state.budget, f, (G, R)),
            ("nodes_budget", state.nodes_budget, f, (G,)), ("vg_counts", state.vg_counts, i, (NGv, V)),
            ("hg_counts", state.hg_counts, i, (NGh, Sl)), ("exist_ports", state.exist_ports, i, (E, NPp)),
            ("claim_ports", state.claim_ports, i, (W, NPp)), ("exist_vols", state.exist_vols, i, (E, NVp)),
            ("res_cap", state.res_cap, i, (RID,)), ("held", state.held, b, (W, RID)),
            ("avail", exist.avail, f, (E, R)), ("exist.valid", exist.valid, b, (E,)),
            ("vol_limits", exist.vol_limits, f, (E, ND)), ("vol_driver", exist.vol_driver, i, (ND, NVp)),
        ]
        + _set_fields("templates.reqs", tm.reqs, G, K, V)
        + [
            ("daemon_requests", tm.daemon_requests, f, (G, R)),
            ("templates.valid", tm.valid, b, (G,)), ("t_order", rank_order(tm.rank), i, (G,)),
            ("mv_key", tm.mv_key, i, (G, M)),
            ("mv_min", tm.mv_min, i, (G, M)), ("well_known", ctx.well_known, b, (K,)),
            ("vg_key", topo.vg_key, i, (NGv,)), ("vg_type", topo.vg_type, i, (NGv,)),
            ("vg_skew", topo.vg_skew, i, (NGv,)), ("vg_min_domains", topo.vg_min_domains, i, (NGv,)),
            ("vg_domains", topo.vg_domains, b, (NGv, V)), ("vg_rank", topo.vg_rank, i, (NGv, V)),
            ("vg_valid", topo.vg_valid, b, (NGv,)), ("hg_type", topo.hg_type, i, (NGh,)),
            ("hg_skew", topo.hg_skew, i, (NGh,)), ("hg_extra_nonempty", topo.hg_extra_nonempty, b, (NGh,)),
            ("hg_valid", topo.hg_valid, b, (NGh,)),
        ]
        + _set_fields("pods.reqs", xs.reqs, L, K, V)
        + [
            ("requests", xs.requests, f, (L, R)), ("tmpl_ok", xs.tmpl_ok, b, (L, G)),
            ("it_allow", xs.it_allow, b, (L, T)), ("exist_ok", xs.exist_ok, b, (L, E)),
            ("ports", xs.ports, i, (L, NPp)), ("port_conf", xs.port_conf, i, (L, NPp)),
            ("vols", xs.vols, i, (L, NVp)), ("valid", xs.valid, b, (L,)),
            ("vg_applies", xs.vg_applies, b, (L, NGv)), ("vg_records", xs.vg_records, b, (L, NGv)),
            ("vg_self", xs.vg_self, b, (L, NGv)), ("hg_applies", xs.hg_applies, b, (L, NGh)),
            ("hg_records", xs.hg_records, b, (L, NGh)), ("hg_self", xs.hg_self, b, (L, NGh)),
            ("strict_mask", xs.strict_mask, b, (L, K, V)), ("row_max", row_max, f, (W, R)),
            ("assignment", assignment, i, (L,)), ("pod_idx", None, i, (L,)),
        ]
    )
    dims = [E, W, G, T, K, V, R, GR, Z, C, NGv, NGh, Sl, NPp, NVp, ND, NCAP, L, ctx.zone_kid, ctx.ct_kid,
            J, M, RID, RZ, ctx.flags.rid_kid, ctx.flags.res_vid, int(ctx.flags.mv_active),
            int(ctx.flags.res_active), int(ctx.flags.res_strict)]
    need = perpod_workspace(dims)
    if need > SMEM_BLOCK - SMEM_STATIC:
        raise LaunchRefused(
            f"perpod_scan: K={K} keys x V={V} values with NGv={NGv} vocab-key groups need {need} B of shared "
            f"memory (the pod's terms and one warp's row scratch), above the {SMEM_BLOCK - SMEM_STATIC} B a "
            f"block has beside the kernel's static part"
        )
    return fields, dims


# a block's shared memory on an H100 (csrc/perpod_scan.cu kSmemMax), and at
# least the per-pod kernel's static shared memory (ptxas -v: chip_smoke.py
# checks it)
SMEM_BLOCK = 232448
SMEM_STATIC = 8192


def perpod_workspace(dims, nev: int = 1) -> int:
    """Bytes of csrc/perpod_scan.cu's shared-memory workspace (its
    `carve`, each field rounded up to 16 bytes) for `dims` (the 29 dims of
    _perpod_fields) with `nev` warps evaluating rows: the pod's terms, the
    vocab-key counts and ranks, the reservation capacities, then per warp a
    byte copy of its row's mask and two row scratches (with the minValues
    and reservation words). The launch runs as many of its 16 warps as fit,
    at least one."""
    _E, _W, G, T, K, V, R, _GR, Z, C, NGv, NGh, _Sl, NPp, NVp = dims[:15]
    J, _M, RID, RZ = dims[20:24]
    NW, NZW = -(-V // 32), -(-(Z * C) // 32)
    pod = ([4 * NGv * NW, NGv, K, NGh, NGh, 4 * NGv * V] + [4 * NGv] * 4 + [4 * NGh] * 2
           + [4 * NGv * V, 16, 4 * RID, 4 * K * NW, 4 * K * NW] + [K] * 5 + [4 * K] * 2 + [4 * NGv * NW] * 3
           + [NGv] * 3 + [4 * NGv, NGh, NGh, 4 * R, T, G, T, 4 * NPp, 4 * NVp, 4 * 512, 4 * 512, 16])
    row = ([4 * K * NW] * 2 + [4 * NGv * NW] + [K] * 8 + [4 * K] * 4 + [4 * NZW, 4 * R, 4 * R]
           + [4 * J * NW, 4 * -(-(RID * RZ) // 32), 4 * -(-RID // 32)])

    def padded(sizes):
        return sum(-(-n // 16) * 16 for n in sizes)

    return padded(pod) + nev * padded([K * V]) + 2 * nev * padded(row)


# csrc/perpod_scan.cu's packed type tables, in its staging order (Tab):
# the hot tables first, so that the staged prefix keeps them when shared
# memory is short
TABLES = ("t_its", "group_valid", "alloc", "zc_bits", "cap", "defined", "inf", "excl", "mask_bits", "gte", "lte",
          "mv_bits", "res_bits")
TABLE_SOURCES = ("it.mask", "it.inf", "it.excl", "it.gte", "it.lte", "it.defined", "alloc", "group_valid",
                 "zc_avail", "cap", "templates.its", "templates.mv_it_values", "res_ofs")


def bit_words(x: torch.Tensor) -> torch.Tensor:
    """[..., n] bool -> [..., ceil(n / 32)] int32: bit i of word w is x[..., 32 w + i]."""
    n = x.shape[-1]
    nw = (n + 31) // 32
    pad = torch.zeros(x.shape[:-1] + (nw * 32 - n,), dtype=torch.bool, device=x.device)
    b = torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nw, 32)).to(torch.int64)
    s = (b << torch.arange(32, dtype=torch.int64, device=x.device)).sum(dim=-1)
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def perpod_tables(it, t_its, mv_it_values: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, list]:
    """The type tables csrc/perpod_scan.cu reads, packed into one uint8
    buffer (TABLES order, each field padded to 16 bytes) with the type axis
    innermost: t_its [G, T], group_valid [GR, T], alloc [GR, R, T], the
    offerings as (zone, capacity type) bits z*C + c [GR, ceil(Z*C/32), T],
    cap [R, T], the catalog requirements' defined / inf / excl [K, T], mask
    as value bits [K, ceil(V/32), T], gte / lte [K, T], the minValues slab
    mv_it_values [T, J, V] as value bits [J, ceil(V/32), T] (None: one key
    of no values), the reserved offerings res_ofs [T, RID, RZ] as bits
    r*RZ + z [ceil(RID*RZ/32), T]. Returns (buffer, the byte offset of each
    field and the total). TorchScheduler builds it once per encode of the
    catalog (PerPodCtx.tables); a launch whose context carries none builds
    its own."""
    T, GR, R = it.alloc.shape
    V = it.reqs.mask.shape[2]
    if mv_it_values is None:
        mv_it_values = torch.zeros((T, 1, V), dtype=torch.bool, device=it.alloc.device)
    srcs = (*it.reqs, it.alloc, it.group_valid, it.zc_avail, it.cap, t_its, mv_it_values, it.res_ofs)
    want = (torch.bool,) * 3 + (torch.int32,) * 2 + (torch.bool, torch.float32, torch.bool, torch.bool,
                                                       torch.float32, torch.bool, torch.bool, torch.bool)
    for name, t, dt in zip(TABLE_SOURCES, srcs, want):
        if t.dtype != dt or t.device != it.alloc.device:
            raise LaunchRefused(f"perpod_tables: {name} is {t.dtype} on {t.device}, expected {dt} on {it.alloc.device}")
    if mv_it_values.shape[0] != T or mv_it_values.shape[2] != V:
        raise LaunchRefused(f"perpod_tables: mv_it_values {tuple(mv_it_values.shape)} vs T={T}, V={V}")
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    RID, RZ = it.res_ofs.shape[1], it.res_ofs.shape[2]
    reqs = it.reqs
    fields = (
        t_its, it.group_valid.T, it.alloc.permute(1, 2, 0),
        bit_words(it.zc_avail.reshape(T, GR, Z * C)).permute(1, 2, 0), it.cap.T,
        reqs.defined.T, reqs.inf.T, reqs.excl.T, bit_words(reqs.mask).permute(1, 2, 0), reqs.gte.T, reqs.lte.T,
        bit_words(mv_it_values).permute(1, 2, 0), bit_words(it.res_ofs.reshape(T, RID * RZ)).T,
    )
    pieces, offsets = [], [0]
    for t in fields:
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        pad = -raw.numel() % 16
        pieces += [raw, torch.zeros(pad, dtype=torch.uint8, device=raw.device)]
        offsets.append(offsets[-1] + raw.numel() + pad)
    return torch.cat(pieces), offsets


def _perpod_launch(fields, dims, strides, S: int, ctx, lo: int, hi: int, what: str) -> None:
    """Check every field (device, dtype, shape, contiguity) and launch
    perpod_scan_persistent once for steps lo .. hi - 1."""
    dev = ctx.it.alloc.device
    ptrs = []
    for name, t, dt, shape in fields:
        if t is None:
            ptrs.append(0)
            continue
        _check(t, name, dt, dev)
        if tuple(t.shape) != shape:
            raise LaunchRefused(f"{what}: {name} {tuple(t.shape)} vs {shape}")
        ptrs.append(t.data_ptr())
    fl = ctx.flags
    if fl.res_active and not (0 <= fl.rid_kid < dims[4] and 0 <= fl.res_vid < dims[5]):
        raise LaunchRefused(f"{what}: reservations on with rid_kid={fl.rid_kid}, res_vid={fl.res_vid}")
    if not 0 <= lo <= hi <= dims[17]:
        raise LaunchRefused(f"{what}: steps [{lo}, {hi}) outside [0, {dims[17]})")
    if lo == hi:
        return
    tables, offsets = ctx.tables if ctx.tables is not None else perpod_tables(
        ctx.it, ctx.templates.its, ctx.templates.mv_it_values)
    _invoke(
        "perpod_scan", "perpod_steps", ctypes.cast(_i64_array(ptrs), ctypes.c_void_p), len(ptrs),
        ctypes.cast(_i64_array(dims), ctypes.c_void_p),
        None if strides is None else ctypes.cast(_i64_array(strides), ctypes.c_void_p), S,
        tables.data_ptr(), ctypes.cast(_i64_array(offsets), ctypes.c_void_p), lo, hi,
    )
    LAUNCHES[PERPOD_KERNELS[0] if strides is None else WHATIF_KERNELS[0]] += 1


def _assignment_buffer(xs) -> torch.Tensor:
    return torch.full((xs.requests.shape[0],), -1, dtype=torch.int32, device=xs.requests.device)


def perpod_steps(state, xs, ctx, lo: int, hi: int, assignment: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Steps lo .. hi - 1 of the chunk in one launch: `state`
    (ops.solver.SolverState; its written fields private to the caller) is
    updated in place; step i writes assignment[i] of the [L] int32 buffer
    (a fresh one of -1 when None), which is returned."""
    if assignment is None:
        assignment = _assignment_buffer(xs)
    row_max = torch.empty(state.used.shape, dtype=torch.float32, device=state.used.device)
    fields, dims = _perpod_fields(state, xs, ctx, row_max, assignment)
    _perpod_launch(fields, dims, None, 1, ctx, lo, hi, "perpod_scan")
    return assignment


def perpod_scan(state, xs, ctx) -> torch.Tensor:
    """Every step of the chunk in one launch; returns the [L] int32 assignment."""
    return perpod_steps(state, xs, ctx, 0, xs.requests.shape[0])


# ---------------------------------------------------------------------------
# scenario mode: S per-pod scans, one block each, in one launch
# ---------------------------------------------------------------------------

def _whatif_fields(state, xs, ctx, row_max, assignment, pod_idx, valid, exist_valid) -> tuple[list, list, list]:
    """csrc/perpod_scan.cu's scenario-mode block: the single-scenario
    block's 83 (name, tensor, dtype, shape) fields with each scenario
    field (`_scenario_tensors`) stacked on a leading S axis and pod_idx
    [S, L] set, their 83 byte strides per scenario (0 for the shared
    tables), and the 29 dims (L = steps per scenario). `xs` holds the
    union's pod rows, which step i of scenario s reads at pod_idx[s, i]."""
    S, L = pod_idx.shape
    from karpenter_tpu_torch.ops.solver import PERPOD_WRITES

    first = state._replace(**{f: _first(getattr(state, f)) for f in PERPOD_WRITES})
    ctx0 = ctx._replace(exist=ctx.exist._replace(valid=exist_valid[0]))
    base, dims = _perpod_fields(first, xs, ctx0, row_max[0], assignment[0])
    stacked = _scenario_tensors(state, row_max, assignment, pod_idx, valid, exist_valid)
    fields, strides = [], []
    for name, t, dt, shape in base:
        if name in stacked:
            t = stacked[name]
            shape = (S,) + ((L,) if name in ("valid", "assignment", "pod_idx") else shape)
            strides.append(t.stride(0) * t.element_size() if S > 1 else 0)
        else:
            strides.append(0)
        fields.append((name, t, dt, shape))
    dims[17] = L
    return fields, strides, dims


def _first(v):
    """Scenario 0's view of a stacked field (a tensor or a requirement set)."""
    return type(v)(*(t[0] for t in v)) if isinstance(v, tuple) else v[0]


def _scenario_tensors(state, row_max, assignment, pod_idx, valid, exist_valid) -> dict:
    """The parameter-block fields that differ per scenario, by name, each
    stacked on a leading S axis: every carry field the step writes
    (solver.PERPOD_WRITES; requirement sets field by field), exist.valid,
    the validity row, the kernel's scratch, the assignment and pod_idx."""
    from karpenter_tpu_torch.ops.solver import PERPOD_WRITES

    out = {}
    for f in PERPOD_WRITES:
        v = getattr(state, f)
        if isinstance(v, tuple):
            out.update((f"{f}.{g}", t) for g, t in zip(v._fields, v))
        else:
            out[f] = v
    out.update({"exist.valid": exist_valid, "valid": valid, "row_max": row_max, "assignment": assignment,
                "pod_idx": pod_idx})
    return out


def perpod_whatif_steps(state, xs, ctx, pod_idx, valid, exist_valid, lo: int, hi: int,
                        assignment: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Steps lo .. hi - 1 of S scenarios in one launch, one block per
    scenario: `state` (ops.solver.SolverState whose written fields are
    stacked [S, ...] and private to the caller) is updated in place; step i
    of scenario s places the union pod row pod_idx[s, i] when valid[s, i],
    against the nodes exist_valid[s], into assignment[s, i] of the [S, L]
    int32 buffer (a fresh one of -1 when None), which is returned."""
    S, L = pod_idx.shape
    if assignment is None:
        assignment = torch.full((S, L), -1, dtype=torch.int32, device=pod_idx.device)
    row_max = torch.empty(state.used.shape, dtype=torch.float32, device=state.used.device)
    fields, strides, dims = _whatif_fields(state, xs, ctx, row_max, assignment, pod_idx, valid, exist_valid)
    P = xs.requests.shape[0]
    if L and (int(pod_idx.min()) < 0 or int(pod_idx.max()) >= P):
        raise LaunchRefused(f"perpod_whatif: pod_idx outside the {P} pod rows")
    _perpod_launch(fields, dims, strides, S, ctx, lo, hi, "perpod_whatif")
    return assignment


def perpod_whatif(state, xs, ctx, pod_idx, valid, exist_valid) -> torch.Tensor:
    """Every step of S scenarios in one launch; returns the [S, L] int32 assignment."""
    return perpod_whatif_steps(state, xs, ctx, pod_idx, valid, exist_valid, 0, pod_idx.shape[1])


# ---------------------------------------------------------------------------
# gangs: gang_scan, one launch per gang run (one block walks its segments)
# ---------------------------------------------------------------------------


# the gang kernel's inputs and carry in csrc/gang_scan.cu's order (its
# `Gang` struct; the outputs ys and the workspace follow)
_GANG_FIELDS = (
    "its_base", "tmpl_base", "zmask", "cmask", "requests", "count", "self_conf", "zinf", "zdef", "kmask", "pd",
    "key_touched", "gate", "recs", "vg_self", "hg_applies", "hg_rec", "hg_self", "alloc", "group_valid", "zc_avail",
    "cap", "admit", "daemon_requests", "rank", "vg_type", "vg_skew", "vg_min_domains", "vg_domains", "vg_rank",
    "hg_type", "hg_skew", "hg_valid", "hg_extra_nonempty", "n_open", "budget", "nodes_budget", "vg_counts",
    "hg_counts", "bank_frozen", "bank_template", "bank_its", "bank_used", "bank_tk_mask", "bank_tk_inf",
    "bank_tk_def",
)
_GANG_RANK = _GANG_FIELDS.index("rank")
_GANG_LAYOUTS = LayoutCache(16)
_SHAPE, _DTYPE = operator.attrgetter("shape"), operator.attrgetter("dtype")


class _GangLayout:
    """One checked gang_scan layout: every field's dtype and shape checked,
    the C entry's dims, the workspace and shared-memory bytes the kernel
    plans for them (C entry gang_scan_workspace), and the pointer array a
    call fills."""

    def __init__(self, ts: tuple, dims: list, dev):
        B, G, T, GR, R, Z, C, V, D, NGv, NGh, S, E, NCAP, maxg, TK, tk_idx, has_key, _zone = dims
        b, i, f = torch.bool, torch.int32, torch.float32
        want = (
            (b, (B, G, T)), (b, (B, G)), (b, (B, G, Z)), (b, (B, G, C)), (f, (B, R)), (i, (B,)), (b, (B,)),
            (b, (B, G)), (b, (B, G)), (b, (B, G, V)), (b, (B, D)), (b, (B,)), (b, (B, NGv)), (b, (B, NGv)),
            (b, (B, NGv)), (b, (B, NGh)), (b, (B, NGh)), (b, (B, NGh)), (f, (T, GR, R)), (b, (T, GR)),
            (b, (T, GR, Z, C)), (f, (T, R)), (b, (T, D)), (f, (G, R)), (i, (G,)), (i, (NGv,)), (i, (NGv,)),
            (i, (NGv,)), (b, (NGv, V)), (i, (NGv, V)), (i, (NGh,)), (i, (NGh,)), (b, (NGh,)), (b, (NGh,)),
            (i, ()), (f, (G, R)), (f, (G,)), (i, (NGv, V)), (i, (NGh, S)), (b, (NCAP,)), (i, (NCAP,)),
            (b, (NCAP, T)), (f, (NCAP, R)), (b, (NCAP, TK, V)), (b, (NCAP, TK)), (b, (NCAP, TK)),
        )
        for name, t, (dt, shape) in zip(_GANG_FIELDS, ts, want):
            if t is None:  # rank: lexical order
                continue
            _check(t, name, dt, dev)
            if tuple(t.shape) != shape:
                raise LaunchRefused(f"gang_scan: {name} {tuple(t.shape)} vs {shape}")
        if S < E + NCAP + 1:
            raise LaunchRefused(f"gang_scan: hostname slots {S} < E + n_claims + 1 = {E + NCAP + 1}")
        if tk_idx >= TK or (tk_idx >= 0 and not has_key):
            raise LaunchRefused(f"gang_scan: tk_idx={tk_idx} with TK={TK}")
        if Z * C > 64:
            raise LaunchRefused(f"gang_scan: Z x C = {Z * C} offerings past the 64-bit offering mask")
        self.B = B
        self.names = tuple(n for n, t in zip(_GANG_FIELDS, ts) if t is not None)
        self.dims = _i64_array(dims)
        sizes = (ctypes.c_int64 * 2)()
        try:
            _invoke("gang_scan", "gang_scan_workspace", ctypes.cast(self.dims, ctypes.c_void_p),
                    ctypes.cast(sizes, ctypes.c_void_p))
        except KernelError as e:
            raise LaunchRefused(f"gang_scan: dims {dims} refused ({e})") from None
        self.ws_bytes, self.smem = int(sizes[0]), int(sizes[1])
        self.ptrs = (ctypes.c_int64 * (len(_GANG_FIELDS) + 2))()
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), len(self.ptrs), ctypes.cast(self.dims, ctypes.c_void_p))


def gang_scan(pre, state, exist, it, templates, topo, zone_kid: int, n_claims: int, maxg: int, key_kid: int,
              D: int, tk_idx: int) -> tuple:
    """H9: every gang segment of `pre` (ops.solver.GangPre, B rows) in one
    launch. The carry fields of `state` it writes (ops.solver.GANG_WRITES,
    private to the caller) are updated in place; returns the six [B]
    int32 GangYs rows (open_g, n_opened, fill, tmpl, leftover, status),
    views of one [6, B] tensor.
    A layout of shapes, dtypes and key parameters is checked in full the
    first time it is seen; a call checks device and contiguity in one pass
    and allocates its outputs and the kernel's workspace."""
    dev = state.used.device
    has_key = key_kid >= 0
    Dk = D if has_key else 1
    if not 1 <= Dk <= 16:
        raise LaunchRefused(f"gang_scan: key domains D={Dk} outside [1, 16]")
    ts = (*pre[:18], it.alloc, it.group_valid, it.zc_avail, it.cap, pre.admit, templates.daemon_requests,
          templates.rank, topo.vg_type, topo.vg_skew, topo.vg_min_domains, topo.vg_domains, topo.vg_rank,
          topo.hg_type, topo.hg_skew, topo.hg_valid, topo.hg_extra_nonempty, state.n_open, state.budget,
          state.nodes_budget, state.vg_counts, state.hg_counts, state.bank_frozen, state.bank_template,
          state.bank_its, state.bank_used, state.bank_tk_mask, state.bank_tk_inf, state.bank_tk_def)
    present = [t for t in ts if t is not None]  # rank is None in lexical order
    key = (n_claims, maxg, key_kid, Dk, tk_idx, key_kid == zone_kid, exist.avail.shape[0], templates.rank is None,
           tuple(map(_SHAPE, present)), tuple(map(_DTYPE, present)))

    def build():
        B, G, T = pre.its_base.shape
        Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
        if has_key and key_kid == zone_kid and Dk > Z:
            raise LaunchRefused(f"gang_scan: zone key with D={Dk} > Z={Z}")
        dims = [B, G, T, it.alloc.shape[1], it.alloc.shape[2], Z, C, state.vg_counts.shape[1], Dk,
                state.vg_counts.shape[0], state.hg_counts.shape[0], state.hg_counts.shape[1], exist.avail.shape[0],
                n_claims, maxg, state.bank_tk_inf.shape[1], tk_idx, int(has_key), int(has_key and key_kid == zone_kid)]
        return _GangLayout(ts, dims, dev)

    lay = _GANG_LAYOUTS.get(key, build)
    _check_place(dev, lay.names, present)
    ys = torch.empty((6, lay.B), dtype=torch.int32, device=dev)
    ws = torch.empty(lay.ws_bytes, dtype=torch.uint8, device=dev)
    ptrs = list(map(torch.Tensor.data_ptr, present))
    if templates.rank is None:
        ptrs.insert(_GANG_RANK, 0)
    lay.ptrs[:] = ptrs + [ys.data_ptr(), ws.data_ptr()]
    _call("gang_scan", *lay.args)
    return ys.unbind(0)


def _fill_word(x, dtype: torch.dtype) -> int:
    """A column's unused-row value as the 4-byte pattern the kernel writes
    (1-byte values repeated four times)."""
    if dtype == torch.bool:
        return 0x01010101 if x else 0
    if dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", float(x)))[0]
    if dtype == torch.int32:
        return int(x) & 0xFFFFFFFF
    raise LaunchRefused(f"retract_tail: no fill pattern for {dtype}")


def _columns(state, names: tuple, rows: int, dev, fill: Optional[dict] = None) -> tuple:
    """(srcs, fresh dsts, row bytes, fill words, {name: new column}) of the
    named state columns, requirement sets split into their components."""
    from karpenter_tpu_torch.ops.encode import ReqSetTensors

    srcs, dsts, rbs, words, out = [], [], [], [], {}
    for f in names:
        v = getattr(state, f)
        comps = list(v) if isinstance(v, ReqSetTensors) else [v]
        fills = (list(fill[f]) if isinstance(v, ReqSetTensors) else [fill[f]]) if fill else [0] * len(comps)
        new = []
        for c, x in zip(comps, fills):
            _check(c, f, c.dtype, dev)
            if c.shape[0] != rows:
                raise LaunchRefused(f"retract_tail: {f} has {c.shape[0]} rows, expected {rows}")
            d = torch.empty_like(c)
            srcs.append(c)
            dsts.append(d)
            rbs.append(c.numel() // max(rows, 1) * c.element_size())
            words.append(_fill_word(x, c.dtype))
            new.append(d)
        out[f] = ReqSetTensors(*new) if isinstance(v, ReqSetTensors) else new[0]
    return srcs, dsts, rbs, words, out


def retract_tail(state, cut: int):
    """H10: the resident session's suffix undo (ops.solver.retract_tail_plain)
    in one launch. Returns a new SolverState whose window and bank columns
    and n_open / w_open are fresh tensors; the input state is not
    modified."""
    from karpenter_tpu_torch.ops.solver import RETRACT_BANK, RETRACT_WINDOW, retract_fill

    dev = state.used.device
    W, NB = state.open.shape[0], state.bank_frozen.shape[0]
    if not 0 <= int(cut) <= NB:
        raise LaunchRefused(f"retract_tail: cut {cut} outside [0, {NB}]")
    _check(state.open, "open", torch.bool, dev)
    _check(state.slot_of, "slot_of", torch.int32, dev)
    srcs, dsts, rbs, words, out = _columns(state, RETRACT_WINDOW, W, dev, retract_fill(state))
    bsrcs, bdsts, brbs, _words, bout = _columns(state, RETRACT_BANK, NB, dev)
    w_open = torch.empty((), dtype=torch.int32, device=dev)
    n_open = torch.empty((), dtype=torch.int32, device=dev)

    def arr(ctype, vals):
        return ctypes.cast((ctype * max(len(vals), 1))(*vals), ctypes.c_void_p)

    _call(
        "retract_tail", W, NB, int(cut), len(srcs), arr(ctypes.c_void_p, [t.data_ptr() for t in srcs]),
        arr(ctypes.c_void_p, [t.data_ptr() for t in dsts]), arr(ctypes.c_int64, rbs), arr(ctypes.c_uint32, words),
        len(bsrcs), arr(ctypes.c_void_p, [t.data_ptr() for t in bsrcs]),
        arr(ctypes.c_void_p, [t.data_ptr() for t in bdsts]), arr(ctypes.c_int64, brbs),
        state.open.data_ptr(), state.slot_of.data_ptr(), w_open.data_ptr(), n_open.data_ptr(),
    )
    return state._replace(n_open=n_open, w_open=w_open, **out, **bout)


# ---------------------------------------------------------------------------
# placement objectives: objective_verdict, one launch per objective round
# ---------------------------------------------------------------------------


# csrc/objective_verdict.cu's work item (XLA's 32-row window, and leftover
# entries) and its partial's bytes: the launcher sizes the workspace by
# them, the C entry refuses a smaller one; and the floats a warp holds of
# the fold's levels (ops.solver.xla_tree_sum over the windows and over G)
OBJ_ROWS = 32
OBJ_PART_BYTES = 32
OBJ_LEVEL_FLOATS = 256


def tree_level_floats(n: int) -> int:
    """The partials XLA's order keeps above n values (every level of
    ceil(n / 32) while more than 32 are left): csrc/objective_verdict.cu's
    level_floats."""
    total = 0
    while n > 32:
        n = -(-n // 32)
        total += n
    return total
_OBJ_FIELDS = ("its", "open", "pods", "template", "w_open", "spills", "leftover")
_OBJ_LAYOUTS = LayoutCache(32)
# H11's workspace, one per (device, stream): the work items' partials, the
# [KV, G] template counts and the ticket; every launch leaves the counts
# and the ticket at 0 for the next one on its stream
_OBJ_WORKSPACES: dict = {}


class _ObjLayout:
    """One checked objective_verdict layout (KV variants' shapes and dtypes,
    the objective, G): the C entry's dims, the workspace it needs and the
    pointer array a call fills."""

    def __init__(self, srcs: list, KV: int, objective: int, G: int, dev):
        b, i, f = torch.bool, torch.int32, torch.float32
        W, T = srcs[0].shape if srcs[0].dim() == 2 else (-1, -1)
        B = srcs[6 * KV].shape[0] if srcs[6 * KV].dim() == 1 else -1
        want = dict(its=((W, T), b), open=((W,), b), pods=((W,), i), template=((W,), i), w_open=((), i),
                    spills=((), i), leftover=((B,), i))
        names = [f"{n}[{v}]" for n in _OBJ_FIELDS for v in range(KV)] + ["base_w_open", "base_spills", "price_t"]
        shapes = [want[n] for n in _OBJ_FIELDS for _v in range(KV)] + [((), i), ((), i), ((T,), f)]
        _check_all("objective_verdict", names, srcs, shapes, dev)
        nb = -(-max(W, 0) // OBJ_ROWS)
        for what, n in (("W", nb), ("G", G)):
            if tree_level_floats(n) > OBJ_LEVEL_FLOATS:
                raise LaunchRefused(f"objective_verdict: the sum over {what} keeps {tree_level_floats(n)} partials, "
                                    f"more than a warp's {OBJ_LEVEL_FLOATS}")
        nc = max(nb, -(-B // OBJ_ROWS), 1)
        self.names = tuple(names)
        self.parts, self.hist = KV * nc * OBJ_PART_BYTES, KV * G
        self.dims = _i64_array([KV, W, T, B, G, objective, self.parts, self.hist])
        self.ptrs = (ctypes.c_int64 * (len(srcs) + 5))()
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), len(self.ptrs), ctypes.cast(self.dims, ctypes.c_void_p))


def _stream_key(dev) -> tuple:
    """(dev, its current stream's handle): the key of a launcher's
    per-stream workspace (None for the stream on the CPU)."""
    return dev, torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _objective_workspace(dev, parts: int, hist: int) -> tuple:
    """(parts, hist, ticket) of (dev, the current stream), grown to hold
    `parts` bytes and `hist` counts (a grown workspace starts zeroed)."""
    key = _stream_key(dev)
    ws = _OBJ_WORKSPACES.get(key)
    if ws is None or ws[0].numel() < parts or ws[1].numel() < hist:
        have = (ws[0].numel(), ws[1].numel()) if ws is not None else (0, 0)
        ws = _OBJ_WORKSPACES[key] = (
            torch.empty(max(parts, have[0]), dtype=torch.uint8, device=dev),
            torch.zeros(max(hist, have[1], 1), dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
        )
    return ws


def objective_verdict(base_w_open, base_spills, outs: list, price_t, objective: int, G: int):
    """H11: the KV variants' scores and the verdict word of one objective
    round (ops.solver.objective_verdict_plain) in one launch. `outs` are
    the variants' ops.solver.VariantOut, read where they lie (no stacking).
    A layout of shapes, dtypes, objective and G is checked in full once; a
    call checks device and contiguity in one pass and allocates only the
    scores and the word (the workspace is the stream's). Returns (scores
    [KV] f32, word [1] int32)."""
    KV = len(outs)
    if not 1 <= KV <= 24:
        raise LaunchRefused(f"objective_verdict: {KV} variants outside [1, 24]")
    if not 0 <= objective <= 4:
        raise LaunchRefused(f"objective_verdict: objective id {objective}")
    srcs = [t for field in zip(*outs) for t in field] + [base_w_open, base_spills, price_t]
    dev = price_t.device
    key = (objective, G, tuple(map(_SHAPE, srcs)), tuple(map(_DTYPE, srcs)))
    lay = _OBJ_LAYOUTS.get(key, lambda: _ObjLayout(srcs, KV, objective, G, dev))
    _check_place(dev, lay.names, srcs)
    parts, hist, ticket = _objective_workspace(dev, lay.parts, lay.hist)
    scores = torch.empty(KV, dtype=torch.float32, device=dev)
    word = torch.empty(1, dtype=torch.int32, device=dev)
    lay.ptrs[:] = [*map(torch.Tensor.data_ptr, srcs), scores.data_ptr(), word.data_ptr(), parts.data_ptr(),
                   hist.data_ptr(), ticket.data_ptr()]
    _call("objective_verdict", *lay.args)
    return scores, word


# ---------------------------------------------------------------------------
# dp speculation: dp_dead (H12), dp_verdict (H13), merge_shard (H14)
# ---------------------------------------------------------------------------


def _table(rows: list, dev) -> torch.Tensor:
    """A [DP, F] int64 table of device pointers (and counts) on `dev`,
    uploaded from pinned memory without blocking the host (the caching
    host allocator keeps the pinned block until the copy has run)."""
    host = torch.tensor(rows, dtype=torch.int64)
    if dev.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(dev, non_blocking=True)


class DpCatalog:
    """csrc/dp_dead.cu's catalog side for one catalog and mode: the cells
    the mode may use as [T, ceil(GR / 32)] int32 bit words (bit g % 32 of
    word g // 32: group_valid, and in the kind scan's mode (`key`) some
    domain d < D of the key admits the cell — the type's key requirement
    holds d and, for the zone key, an available offering in zone d; for
    another key, any available offering), and each resource's ceiling, the
    largest allocatable over valid cells (-inf with none, NaN where one is
    NaN: csrc/dp_dead.cu's ceiling test then never fires). Built once per
    (catalog, key) (dp_catalog); it keeps the checked launch layouts read
    through it."""

    def __init__(self, it, key):
        dev = it.alloc.device
        _check(it.alloc, "alloc", torch.float32, dev)
        _check(it.group_valid, "group_valid", torch.bool, dev)
        T, GR, R = it.alloc.shape
        if tuple(it.group_valid.shape) != (T, GR):
            raise LaunchRefused(f"dp_dead: group_valid {tuple(it.group_valid.shape)} vs ({T}, {GR})")
        usable = it.group_valid
        if key is not None:
            K, V = it.reqs.mask.shape[1:]
            _check(it.zc_avail, "zc_avail", torch.bool, dev)
            _check(it.reqs.defined, "it.reqs.defined", torch.bool, dev)
            _check(it.reqs.mask, "it.reqs.mask", torch.bool, dev)
            if not 0 <= key.key_kid < K or not 1 <= key.D <= V:
                raise LaunchRefused(f"dp_dead: key {key} outside K={K}, V={V}")
            dom = ~it.reqs.defined[:, key.key_kid, None] | it.reqs.mask[:, key.key_kid, :key.D]  # [T, D]
            av = it.zc_avail  # [T, GR, Z, C]
            if key.key_kid == key.zone_kid:
                dz = min(key.D, av.shape[2])
                admit = (dom[:, None, :dz] & av.any(dim=-1)[:, :, :dz]).any(dim=-1)
            else:
                admit = dom.any(dim=-1)[:, None] & av.flatten(2).any(dim=-1)
            usable = usable & admit
        self.cells = bit_words(usable).contiguous()
        self.ceiling = torch.where(it.group_valid[:, :, None], it.alloc, float("-inf")).amax(dim=(0, 1)).contiguous()
        self.device, self.T, self.GR, self.R, self.kscan = dev, T, GR, R, int(key is not None)
        self.alloc = it.alloc
        self.layouts = LayoutCache(16)


def dp_catalog(it, key) -> DpCatalog:
    """H12's catalog side of `it` in the mode of `key` (None: fill /
    per-pod; an ops.solver.DpKey: the kind scan's), built once
    (packed_catalog)."""
    if key is None:
        return packed_catalog("dp_dead", (it.alloc, it.group_valid), lambda: DpCatalog(it, None))
    return packed_catalog("dp_dead", (it.alloc, it.group_valid, it.zc_avail, it.reqs.defined, it.reqs.mask),
                          lambda: DpCatalog(it, key), key.key_kid, key.zone_kid, key.D)


# the dp rows whose pointers ride H12's kernel parameters (csrc/dp_dead.cu
# kParamRows); past it they go in a [DP, 4] table uploaded from pinned
# memory without blocking
DP_PARAM_ROWS = 32
_DP_ROW_FIELDS = ("used", "its", "open", "w_open")
# H12's workspace, one per (device, stream): the alive words and the
# ticket, which every launch leaves at 0 for the next one on its stream
_DP_WORKSPACES: dict = {}


class _DpLayout:
    """One checked dp_dead layout (DP, the rows' shapes and dtypes): the C
    entry's dims and the pointer array a call fills."""

    def __init__(self, cat: DpCatalog, srcs: list, DP: int):
        b, i, f = torch.bool, torch.int32, torch.float32
        W, R = srcs[0].shape if srcs[0].dim() == 2 else (-1, -1)
        T = cat.T
        want = dict(used=((W, R), f), its=((W, T), b), open=((W,), b), w_open=((), i))
        names = [f"base.{n}" for n in _DP_ROW_FIELDS] + [f"{n}[{q}]" for q in range(DP) for n in _DP_ROW_FIELDS]
        shapes = [want[n] for _q in range(DP + 1) for n in _DP_ROW_FIELDS] + [((DP, R), f)]
        names.append("r_min")
        if R != cat.R:
            raise LaunchRefused(f"dp_dead: {R} resources in the rows, {cat.R} in the catalog")
        _check_all("dp_dead", names, srcs, shapes, cat.device)
        self.names = tuple(names)
        self.nwr = -(-DP // 32)
        self.words = (1 + DP) * self.nwr
        self.params = DP <= DP_PARAM_ROWS
        self.dims = _i64_array([DP, W, T, cat.GR, R, cat.kscan, cat.cells.shape[1], self.words])
        self.ptrs = (ctypes.c_int64 * (12 + (4 * DP if self.params else 0)))()
        self.ptrs[5], self.ptrs[6], self.ptrs[7] = cat.alloc.data_ptr(), cat.cells.data_ptr(), cat.ceiling.data_ptr()
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), len(self.ptrs), ctypes.cast(self.dims, ctypes.c_void_p))


def _dp_workspace(dev, words: int) -> tuple:
    """(alive words, ticket) of (dev, the current stream), grown to hold
    `words` (a grown workspace starts zeroed)."""
    key = _stream_key(dev)
    ws = _DP_WORKSPACES.get(key)
    if ws is None or ws[0].numel() < words:
        ws = _DP_WORKSPACES[key] = (torch.zeros(max(words, 64), dtype=torch.int32, device=dev),
                                    torch.zeros(1, dtype=torch.int32, device=dev))
    return ws


def dp_dead(base, specs: list, r_min, it, key=None) -> torch.Tensor:
    """H12: the [DP, 1 + DP] deadness matrix of a dp round (ops.solver.
    dp_dead_plain) in one launch; `key` (ops.solver.DpKey) selects the kind
    scan's predicate. The row states are read where they lie. The catalog
    side is built once per (catalog, key) (dp_catalog) and each layout of
    DP, shapes and dtypes checked in full once; a call checks device and
    contiguity in one pass, passes up to DP_PARAM_ROWS rows' pointers in
    the kernel's parameters (more in a table uploaded from pinned memory)
    and allocates only the matrix."""
    cat = dp_catalog(it, key)
    dev = cat.device
    DP = len(specs)
    if not 1 <= DP <= 1024:
        raise LaunchRefused(f"dp_dead: DP={DP} outside [1, 1024]")
    srcs = [base.used, base.its, base.open, base.w_open]
    for s in specs:
        srcs += (s.used, s.its, s.open, s.w_open)
    srcs.append(r_min)
    lay = cat.layouts.get((DP, tuple(map(_SHAPE, srcs)), tuple(map(_DTYPE, srcs))),
                          lambda: _DpLayout(cat, srcs, DP))
    _check_place(dev, lay.names, srcs)
    alive, ticket = _dp_workspace(dev, lay.words)
    dead = torch.empty((DP, 1 + DP), dtype=torch.bool, device=dev)
    ptrs = list(map(torch.Tensor.data_ptr, srcs))
    p = lay.ptrs
    p[0], p[1], p[2], p[3] = ptrs[:4]
    p[4], p[8], p[9], p[10] = r_min.data_ptr(), dead.data_ptr(), alive.data_ptr(), ticket.data_ptr()
    if lay.params:
        p[11] = 0
        p[12:] = ptrs[4:-1]
    else:
        table = _table([ptrs[4 + 4 * q:8 + 4 * q] for q in range(DP)], dev)
        p[11] = table.data_ptr()
    _call("dp_dead", *lay.args)
    return dead


def _node_bytes(t: torch.Tensor) -> int:
    n = 1
    for d in t.shape[1:]:
        n *= d
    return n * t.element_size()


# H13's rows whose pointers ride its kernel's parameters (csrc/dp_verdict.cu
# kMaxDP); a round of more rows is refused
DP_VERDICT_ROWS = 16
_DPV_LAYOUTS = LayoutCache(32)
# H13's workspace, one per (device, stream): the rows' flag and bit words
# and the ticket, which every launch leaves at 0 for the next one
_DPV_WORKSPACES: dict = {}


class _DpVerdictLayout:
    """One checked dp_verdict layout (DP, the family, the sources' shapes
    and dtypes, in csrc/dp_verdict.cu's pointer order): the names the
    per-call check reports, the C entry's dims and the pointer array a
    call fills (the sources, then the workspace, ticket and word)."""

    def __init__(self, base, specs, vin, n_claims: int, srcs: list):
        b, i, f = torch.bool, torch.int32, torch.float32
        DP = len(specs)
        W, R = base.used.shape
        E = base.exist_used.shape[0]
        G = base.budget.shape[0]
        RID = base.res_cap.shape[0]
        NGv, NGh = vin.rec_v.shape[1], vin.rec_h.shape[1]
        fill, apply = vin.fill_c is not None, vin.apply_tmpl is not None
        ex = [base.exist_used, base.exist_ports, base.exist_vols, *base.exist_reqs]
        ex_want = [(tuple(t.shape), t.dtype) for t in ex]
        if ex_want[0] != ((E, R), f):
            raise LaunchRefused(f"dp_verdict: base.exist_used {ex_want[0]}, expected ({E}, {R}) float32")
        debits = [("budget", ((G, R), f)), ("nodes_budget", ((G,), f)), ("res_cap", ((RID,), i))] if apply else []
        names = [f"base.{n}" for n in ("w_open", "n_open", "spills", "pods")] + [f"base.exist[{k}]" for k in range(9)]
        want = [((), i)] * 3 + [((W,), i)] + ex_want
        names += [f"base.{n}" for n, _w in debits] + ["dead", "r_min", "exist_ok_rows", "rec_v", "app_v", "rec_h",
                                                        "app_h"]
        want += [w for _n, w in debits] + [((DP, 1 + DP), b), ((DP, R), f), ((DP, E), b), ((DP, NGv), b),
                                            ((DP, NGv), b), ((DP, NGh), b), ((DP, NGh), b)]
        if apply:
            names.append("apply_tmpl")
            want.append(((DP, G), b))
        names += ["exist.valid", "exist.avail"]
        want += [((E,), b), ((E, R), f)]
        segs = []
        for q in range(DP):
            names += [f"{n}[{q}]" for n in ("w_open", "n_open", "spills")]
            want += [((), i)] * 3
            if fill:
                B = vin.fill_c[q].shape[0] if vin.fill_c[q].dim() == 2 else -1
                names += [f"fill_c[{q}]", f"leftover[{q}]"]
                want += [((B, W), i), ((B,), i)]
                segs.append(B)
            else:
                names.append(f"pods[{q}]")
                want.append(((W,), i))
                segs.append(0)
            names += [f"exist[{k}][{q}]" for k in range(9)] + [f"{n}[{q}]" for n, _w in debits]
            want += ex_want + [w for _n, w in debits]
        _check_all("dp_verdict", names, srcs, want, srcs[0].device)
        self.names = tuple(names)
        nw = sum(-(-n // 32) for n in (E, NGv, NGh)) + (-(-G // 32) if apply else 0)
        self.words = DP * (1 + 2 * nw)
        self.n = len(srcs)
        self.dims = _i64_array([DP, W, E, R, NGv, NGh, G, RID, n_claims, int(fill), int(apply), self.words,
                                *(_node_bytes(t) for t in ex), *segs])
        self.ptrs = (ctypes.c_int64 * (self.n + 3))()
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), len(self.ptrs), ctypes.cast(self.dims, ctypes.c_void_p))


def _dpv_workspace(dev, words: int) -> tuple:
    """(words, ticket) of (dev, the current stream), grown to hold `words`
    (a grown workspace starts zeroed)."""
    key = _stream_key(dev)
    ws = _DPV_WORKSPACES.get(key)
    if ws is None or ws[0].numel() < words:
        ws = _DPV_WORKSPACES[key] = (torch.zeros(max(words, 64), dtype=torch.int32, device=dev),
                                     torch.zeros(1, dtype=torch.int32, device=dev))
    return ws


def dp_verdict(base, specs: list, dead, exist, n_claims: int, vin) -> torch.Tensor:
    """H13: the packed verdict word of a dp round (ops.solver.
    dp_verdict_plain) in one launch, reading H12's matrix `dead` and the
    round's ops.solver.DpVerdictIn. Every row's pointers ride the kernel's
    parameters (at most DP_VERDICT_ROWS rows); a layout of DP, family,
    shapes and dtypes is checked in full once, a call checks device and
    contiguity in one pass and allocates only the word (the workspace is
    the stream's). Returns [ceil(DP / 32)] int32."""
    DP = len(specs)
    if not 1 <= DP <= DP_VERDICT_ROWS:
        raise LaunchRefused(f"dp_verdict: DP={DP} outside [1, {DP_VERDICT_ROWS}] (the rows' pointers ride the "
                            f"kernel's parameters)")
    fill, at = vin.fill_c is not None, vin.apply_tmpl
    srcs = [base.w_open, base.n_open, base.spills, base.pods, base.exist_used, base.exist_ports, base.exist_vols,
            *base.exist_reqs]
    if at is not None:
        srcs += [base.budget, base.nodes_budget, base.res_cap]
    srcs += [dead, vin.r_min, vin.exist_ok_rows, vin.rec_v, vin.app_v, vin.rec_h, vin.app_h]
    if at is not None:
        srcs.append(at)
    srcs += [exist.valid, exist.avail]
    for q, s in enumerate(specs):
        srcs += [s.w_open, s.n_open, s.spills]
        srcs += [vin.fill_c[q], vin.leftover[q]] if fill else [s.pods]
        srcs += [s.exist_used, s.exist_ports, s.exist_vols, *s.exist_reqs]
        if at is not None:
            srcs += [s.budget, s.nodes_budget, s.res_cap]
    dev = dead.device
    key = (DP, fill, at is not None, n_claims, tuple(map(_SHAPE, srcs)), tuple(map(_DTYPE, srcs)))
    lay = _DPV_LAYOUTS.get(key, lambda: _DpVerdictLayout(base, specs, vin, n_claims, srcs))
    _check_place(dev, lay.names, srcs)
    ws, ticket = _dpv_workspace(dev, lay.words)
    word = torch.empty((DP + 31) // 32, dtype=torch.int32, device=dev)
    p, n = lay.ptrs, lay.n
    p[:n] = list(map(torch.Tensor.data_ptr, srcs))
    p[n], p[n + 1], p[n + 2] = ws.data_ptr(), ticket.data_ptr(), word.data_ptr()
    _call("dp_verdict", *lay.args)
    return word


_MERGE_LAYOUTS = LayoutCache(32)
# the merged state's count and debit fields each mode writes
_MERGE_QUADS = {False: ("hg_counts",), True: ("hg_counts", "vg_counts", "budget", "nodes_budget", "res_cap")}
_MERGE_SCALARS = (("committed", "n_open"), ("committed", "w_open"), ("committed", "w_hw"), ("spec", "n_open"),
                  ("spec", "w_open"), ("base", "n_open"), ("base", "w_open"))


def _merge_sources(committed, spec, base, assignment) -> list:
    """H14's inputs in csrc/merge_shard.cu's order, the pointer slots of
    outputs left out: window columns (committed, spec), existing-node
    fields (committed, spec, base), open, slot_of (committed, spec), the
    mode's count and debit fields (committed, spec, base), the assignment,
    the seven scalars."""
    from karpenter_tpu_torch.ops.solver import GRAFT_WINDOW, exist_leaves

    srcs = []
    for name in GRAFT_WINDOW:
        c, s = getattr(committed, name), getattr(spec, name)
        if isinstance(c, tuple):
            for ct, st in zip(c, s):
                srcs += [ct, st]
        else:
            srcs += [c, s]
    for c, s, b in zip(exist_leaves(committed), exist_leaves(spec), exist_leaves(base)):
        srcs += [c, s, b]
    srcs += [committed.open, committed.slot_of, spec.slot_of]
    for name in _MERGE_QUADS[assignment is not None]:
        srcs += [getattr(committed, name), getattr(spec, name), getattr(base, name)]
    if assignment is not None:
        srcs.append(assignment)
    st = dict(committed=committed, spec=spec, base=base)
    return srcs + [getattr(st[w], n) for w, n in _MERGE_SCALARS]


class _MergeLayout:
    """One checked merge_shard layout (the mode, every input's shape and
    dtype): the names the per-call check reports, the output arena (each
    output a 256-byte-aligned view of one allocation, with the committed
    field's dtype and shape), the C entry's dims and the pointer array a
    call fills (input slots, output offsets)."""

    def __init__(self, committed, spec, base, assignment, srcs: list):
        from karpenter_tpu_torch.ops.solver import GRAFT_WINDOW, exist_leaves

        i32 = torch.int32
        dev = committed.used.device
        kscan = assignment is not None
        W = committed.open.shape[0]
        NB = committed.bank_frozen.shape[0]
        E, R = committed.exist_used.shape
        NGh, S = committed.hg_counts.shape
        NGv, V = committed.vg_counts.shape
        G = committed.budget.shape[0]
        RID = committed.res_cap.shape[0]
        names, want, outs = [], [], []  # outs: (field, component, dtype, shape)
        win_bytes = []
        for name in GRAFT_WINDOW:
            c = getattr(committed, name)
            parts = list(enumerate(c)) if isinstance(c, tuple) else [(None, c)]
            for comp, t in parts:
                label = name if comp is None else f"{name}.{comp}"
                names += [f"committed.{label}", f"spec.{label}"]
                want += [(tuple(t.shape), t.dtype)] * 2
                outs.append((name, comp, t.dtype, tuple(t.shape)))
                win_bytes.append(_node_bytes(t) if t.dim() else 0)
        ex = exist_leaves(committed)
        for n, t in enumerate(ex):
            names += [f"{w}.exist[{n}]" for w in ("committed", "spec", "base")]
            want += [(tuple(t.shape), t.dtype)] * 3
            outs.append(("exist", n, t.dtype, tuple(t.shape)))
        names += ["committed.open", "committed.slot_of", "spec.slot_of"]
        want += [((W,), torch.bool), ((W,), i32), ((W,), i32)]
        outs += [("open", None, torch.bool, (W,)), ("slot_of", None, i32, (W,)), ("shifted", None, i32, (W,))]
        quad = dict(hg_counts=(i32, (NGh, S)), vg_counts=(i32, (NGv, V)), budget=(torch.float32, (G, R)),
                    nodes_budget=(torch.float32, (G,)), res_cap=(i32, (RID,)))
        for name in _MERGE_QUADS[kscan]:
            dt, shape = quad[name]
            names += [f"{w}.{name}" for w in ("committed", "spec", "base")]
            want += [(shape, dt)] * 3
            outs.append((name, None, dt, shape))
        if kscan:
            names.append("assignment")
            want.append((tuple(assignment.shape), i32))
            outs.append(("assignment", None, i32, tuple(assignment.shape)))
        names += [f"{w}.{n}" for w, n in _MERGE_SCALARS]
        want += [((), i32)] * len(_MERGE_SCALARS)
        outs += [(n, None, i32, ()) for n in ("n_open", "w_open", "w_hw")]
        if ex[0].dtype != torch.float32 or tuple(ex[0].shape) != (E, R):
            raise LaunchRefused(f"merge_shard: committed.exist_used {tuple(ex[0].shape)} {ex[0].dtype}, expected "
                                f"({E}, {R}) float32")
        _check_all("merge_shard", names, srcs, want, dev)
        self.names = tuple(names)
        # the arena: each output 256-byte aligned, at out_offsets bytes
        self.views, self.out_offsets, off = [], [], 0
        for field, comp, dt, shape in outs:
            es = torch.empty((), dtype=dt).element_size()
            stride, acc = [], 1
            for d in reversed(shape):
                stride.append(acc)
                acc *= d
            self.views.append((field, comp, dt, shape, tuple(reversed(stride)), off // es))
            self.out_offsets.append(off)
            off += -(-(acc * es) // 256) * 256
        self.bytes = max(off, 256)
        self.dtypes = tuple(dict.fromkeys(dt for _f, _c, dt, _s in outs))
        # the pointers: the sources, then the outputs
        n_win = len(win_bytes)
        self.n = len(srcs)
        k = self.n + len(self.out_offsets)
        self.ptrs = (ctypes.c_int64 * k)()
        # the merged state's fields from the views, by position
        fields = [v[0] for v in self.views]
        self.n_reqs = fields.count("reqs")
        self.plain = [(n, j) for j, n in enumerate(fields) if n not in ("reqs", "exist", "shifted", "assignment")]
        self.exist0 = fields.index("exist")
        self.shifted = fields.index("shifted")
        self.assign = fields.index("assignment") if kscan else None
        self.dims = _i64_array([n_win, W, NB, E, R, NGh, S, NGv, V, G, RID, assignment.numel() if kscan else 0,
                                int(kscan), *win_bytes, *(_node_bytes(t) for t in ex)])
        self.args = (ctypes.cast(self.ptrs, ctypes.c_void_p), k, ctypes.cast(self.dims, ctypes.c_void_p))


def merge_shard(committed, spec, base, assignment=None) -> tuple:
    """H14: one dp commit out of place (ops.solver.merge_shard_fill_plain,
    or merge_shard_kscan_plain with `assignment`) in one launch. Returns
    (merged state, shifted slot map, shifted assignment or None); every
    field the commit writes is a fresh tensor: a view of one output arena,
    256-byte aligned, disjoint from the others. A layout of mode, shapes
    and dtypes is checked in full once (_MERGE_LAYOUTS); a call checks
    device and contiguity in one pass and allocates only the arena."""
    from karpenter_tpu_torch.ops.encode import ReqSetTensors

    srcs = _merge_sources(committed, spec, base, assignment)
    dev = committed.used.device
    key = (assignment is not None, tuple(map(_SHAPE, srcs)), tuple(map(_DTYPE, srcs)))
    lay = _MERGE_LAYOUTS.get(key, lambda: _MergeLayout(committed, spec, base, assignment, srcs))
    _check_place(dev, lay.names, srcs)
    arena = torch.empty(lay.bytes, dtype=torch.uint8, device=dev)
    typed = {dt: arena.view(dt) for dt in lay.dtypes}
    p, n, at = lay.ptrs, lay.n, arena.data_ptr()
    p[:n] = list(map(torch.Tensor.data_ptr, srcs))
    p[n:] = [at + off for off in lay.out_offsets]
    _call("merge_shard", *lay.args)
    views = [typed[dt].as_strided(shape, stride, off) for _f, _c, dt, shape, stride, off in lay.views]
    e0 = lay.exist0
    merged = committed._replace(
        reqs=ReqSetTensors(*views[:lay.n_reqs]), exist_used=views[e0], exist_ports=views[e0 + 1],
        exist_vols=views[e0 + 2], exist_reqs=ReqSetTensors(*views[e0 + 3:e0 + 9]),
        **{name: views[j] for name, j in lay.plain},
    )
    return merged, views[lay.shifted], None if lay.assign is None else views[lay.assign]


# ---------------------------------------------------------------------------
# the wire: wire_pack (H15), one launch per fetch
# ---------------------------------------------------------------------------

# items a block of csrc/wire_pack.cu takes per task kind: 16-byte output
# lines (copy, narrow, bool), 16-byte source units (max), edge bytes
_WIRE_KIND = {"copy": 0, "narrow": 1, "bool": 2, "edge": 3, "max": 4, "nop": 5}
_WIRE_PER = {"copy": 1024, "narrow": 512, "bool": 256, "edge": 256, "max": 2048, "nop": 1}
_WIRE_HEADER = np.dtype([("n_tasks", "<u4"), ("n_blocks", "<u4"), ("n_members", "<u4"), ("n_edges", "<u4"),
                         ("wire", "<u8"), ("scratch", "<u8"), ("max_off", "<u4"), ("n_max_blocks", "<u4"),
                         ("off_members", "<u4"), ("off_edges", "<u4"), ("off_chunks", "<u4"), ("pad", "<u4")])
_WIRE_TASK = np.dtype([("src", "<u8"), ("dst", "<u4"), ("n", "<u4"), ("first_block", "<u4"), ("e0", "<u4"),
                       ("kind", "<u4"), ("per", "<u4")])
_WIRE_MEMBER = np.dtype([("src", "<u8"), ("e0", "<u4"), ("pad", "<u4")])
_WIRE_EDGE = np.dtype([("dst", "<u4"), ("e8", "<u4"), ("base", "<u4"), ("rel", "<u4")])
# a blob past this goes to the device before the launch (the parameter
# space of CUDA before 12.1; csrc/wire_pack.cu takes up to 32000 bytes in
# its parameters with 12.1 and later)
WIRE_PARAM_BYTES = 4000


def _lines(a: int, b: int) -> int:
    """16-byte lines of the byte range [a, b)."""
    return (b + 15) // 16 - a // 16 if b > a else 0


class _WireLayout:
    """One fetch signature's descriptor blob for csrc/wire_pack.cu (its
    Header, Task, Member and Edge structs, then a uint16 task index per
    block), built from the leaves' shapes, dtypes, live rows and narrowing
    once; a call copies it, writes the sources' pointers into the slots
    `slot_u64` (u64 positions) from its pointer list at `slot_src`, the
    wire's and the scratch's, and launches. Raises LaunchRefused on a
    source that is not contiguous."""

    def __init__(self, leaves: list):
        from karpenter_tpu_torch.ops import kernels

        metas = [(tuple(t.shape), t.dtype) for t in leaves]
        groups, self.nbytes = kernels.wire_layout(metas)
        first_src, n_src = [], 0
        for t in leaves:
            for s in kernels.wire_sources(t):
                if not s.is_contiguous():
                    raise LaunchRefused("wire_pack: a source is not contiguous")
            first_src.append(n_src)
            n_src += len(kernels.wire_sources(t))
        tasks: list = []  # (kind, source index or -1, dst, n, e0, blocks)
        members: list = []  # (source index, group element offset)
        edges: list = []  # (dst, e8, base, rel)
        self.max_off = 0

        def add(kind: str, src: int, dst: int, n: int, e0: int, items: int) -> None:
            blocks = -(-items // _WIRE_PER[kind])
            if blocks:
                tasks.append((kind, src, dst, n, e0, blocks))

        for dt, idx, goff, n in groups:
            if dt == torch.bool:
                base = len(members)
                starts = []
                e = 0
                cut = set()  # group bytes a member boundary or the group's end cuts
                for i in idx:
                    cnt = math.prod(metas[i][0])
                    if not cnt:
                        continue
                    members.append((first_src[i], e))
                    starts.append(e)
                    j0, j1 = -(-e // 8), (e + cnt) // 8
                    if j1 > j0:
                        add("bool", first_src[i], goff, cnt, e, _lines(goff + j0, goff + j1))
                    if e % 8:
                        cut.add(e // 8)
                    if (e + cnt) % 8:
                        cut.add((e + cnt) // 8)
                    e += cnt
                for j in sorted(cut):
                    first = bisect.bisect_right(starts, 8 * j) - 1
                    rel = 0
                    for b in range(8):
                        el = 8 * j + b
                        r = 0xF if el >= n else bisect.bisect_right(starts, el) - 1 - first
                        rel |= r << (4 * b)
                    edges.append((goff + j, 8 * j, base + first, rel))
                continue
            es = dt.itemsize
            e = 0
            for i in idx:
                t = leaves[i]
                cnt = math.prod(metas[i][0])
                off = goff + e * es
                e += cnt
                if isinstance(t, kernels.WireMax):
                    self.max_off = off
                    for k, src in enumerate(t.srcs):
                        add("max", first_src[i] + k, 0, src.numel(), 0, (src.numel() + 6) // 4)
                elif cnt and isinstance(t, kernels.WireLeaf) and t.narrow:
                    add("narrow", first_src[i], off, cnt, 0, _lines(off, off + 2 * cnt))
                elif cnt:
                    add("copy", first_src[i], off, cnt * es, 0, _lines(off, off + cnt * es))
        if edges:
            add("edge", -1, 0, len(edges), 0, len(edges))
        if not tasks:
            add("nop", -1, 0, 0, 0, 1)
        if len(tasks) > 0xFFFF:
            raise LaunchRefused(f"wire_pack: {len(tasks)} tasks past the chunk table's uint16")
        t_arr = np.zeros(len(tasks), dtype=_WIRE_TASK)
        chunks = []
        for x, (kind, _src, dst, n, e0, blocks) in enumerate(tasks):
            t_arr[x] = (0, dst, n, len(chunks), e0, _WIRE_KIND[kind], _WIRE_PER[kind])
            chunks += [x] * blocks
        m_arr = np.zeros(len(members), dtype=_WIRE_MEMBER)
        m_arr["e0"] = [e0 for _s, e0 in members]
        e_arr = np.array(edges, dtype=_WIRE_EDGE) if edges else np.zeros(0, dtype=_WIRE_EDGE)
        off_members = _WIRE_HEADER.itemsize + t_arr.nbytes
        off_edges = off_members + m_arr.nbytes
        off_chunks = off_edges + e_arr.nbytes
        head = np.zeros(1, dtype=_WIRE_HEADER)
        head[0] = (len(tasks), len(chunks), len(members), len(edges), 0, 0, self.max_off,
                   sum(b for kind, *_r, b in tasks if kind == "max"), off_members, off_edges, off_chunks, 0)
        c_arr = np.array(chunks, dtype="<u2")
        raw = b"".join(a.tobytes() for a in (head, t_arr, m_arr, e_arr, c_arr))
        self.blob = np.zeros(-(-len(raw) // 16) * 16, dtype=np.uint8)
        self.blob[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        # the pointer slots: each task's source, each member's
        t0 = _WIRE_HEADER.itemsize // 8
        slots = [(t0 + 4 * x, src) for x, (_k, src, *_r) in enumerate(tasks) if src >= 0]
        slots += [(off_members // 8 + 2 * x, src) for x, (src, _e0) in enumerate(members)]
        self.slot_u64 = np.array([a for a, _b in slots], dtype=np.int64)
        self.slot_src = np.array([b for _a, b in slots], dtype=np.int64)
        self.has_max = any(kind == "max" for kind, *_r in tasks)


_WIRE_LAYOUTS = LayoutCache(64)
# the max's scratch, one per (device, stream): [ticket 0, max INT32_MIN],
# left so by every launch
_WIRE_SCRATCH: dict = {}


def _wire_scratch(dev) -> torch.Tensor:
    key = _stream_key(dev)
    ws = _WIRE_SCRATCH.get(key)
    if ws is None:
        ws = _WIRE_SCRATCH[key] = torch.tensor([0, -(2**31)], dtype=torch.int32, device=dev)
    return ws


def wire_pack(leaves: list) -> torch.Tensor:
    """H15: the fetch's whole wire (ops.kernels.pack_wire_plain's layout) in
    one launch on torch's current stream. The descriptor blob of the
    leaves' signature (types, shapes, dtypes, live rows, narrowing) is
    built once (_WireLayout); a call checks the sources' contiguity, writes
    their pointers into a copy and passes it in the kernel's parameters.
    Returns the uint8 wire on the leaves' device."""
    from karpenter_tpu_torch.ops.kernels import WireLeaf

    srcs, meta = [], []
    for t in leaves:
        c = t.__class__
        if c is torch.Tensor:
            srcs.append(t)
            meta.append(None)
        elif c is WireLeaf:
            srcs.append(t.src)
            meta.append((t.rows, t.narrow))
        else:  # WireMax
            srcs.extend(t.srcs)
            meta.append(len(t.srcs))
    key = (tuple(map(_SHAPE, srcs)), tuple(map(_DTYPE, srcs)), tuple(meta))
    if not all(map(torch.Tensor.is_contiguous, srcs)):
        raise LaunchRefused("wire_pack: a source is not contiguous")
    lay = _WIRE_LAYOUTS.get(key, lambda: _WireLayout(leaves))
    dev = srcs[0].device
    wire = torch.empty(lay.nbytes, dtype=torch.uint8, device=dev)
    blob = lay.blob.copy()
    b64 = blob.view(np.uint64)
    b64[lay.slot_u64] = np.fromiter(map(torch.Tensor.data_ptr, srcs), dtype=np.uint64, count=len(srcs))[lay.slot_src]
    b64[2] = wire.data_ptr()
    if lay.has_max:
        b64[3] = _wire_scratch(dev).data_ptr()
    table = torch.empty(blob.nbytes, dtype=torch.uint8, device=dev) if blob.nbytes > WIRE_PARAM_BYTES else None
    _call("wire_pack", blob.ctypes.data, blob.nbytes, _ptr(table))
    return wire
