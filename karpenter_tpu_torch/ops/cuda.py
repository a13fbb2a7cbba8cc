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

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

KERNELS = ("req_intersects", "fill_count_grid", "water_fill", "compact_scatter")
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
    for name in KERNELS:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel that is not built yet (one nvcc per source,
    in parallel) and load all of them. Returns {"seconds", "dir", "logs"};
    raises RuntimeError with the compiler's output on a failed build."""
    if len(_libs) == len(KERNELS):
        return BUILD_INFO
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in KERNELS:
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
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    for name in KERNELS:
        _libs[name] = _load(name, out / f"lib{name}.so")
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out), logs=logs)
    return BUILD_INFO


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_ARGTYPES = {
    "req_intersects": [_P] * 12 + [_I] * 4 + [_P, _P],
    "fill_count_grid": [_I, _P, _P, _P, _P, _P, _I64, _P, _P, _I64, _I, _P, _P]
    + [_I] * 6 + [_P, _P],
    "water_fill": [_P, _P, _P, _I, _P, _P],
    "compact_scatter": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _call(name: str, *args) -> None:
    if name not in _libs:
        build()
    lib = _libs[name]
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{what}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def req_intersects(a, b) -> torch.Tensor:
    """H1: [A, B] bool intersects(a, b) for two ReqSetTensors on CUDA."""
    dev = a.mask.device
    A, K, V = a.mask.shape
    B = b.mask.shape[0]
    if b.mask.shape[1:] != (K, V):
        raise ValueError(f"req_intersects: key/value axes differ {a.mask.shape} vs {b.mask.shape}")
    if V % 8:
        raise ValueError(f"req_intersects: V={V} must be a multiple of 8")
    args = []
    for side, r in (("a", a), ("b", b)):
        for f, dt in zip(r._fields, (torch.bool, torch.bool, torch.bool, torch.int32, torch.int32, torch.bool)):
            t = _check(getattr(r, f), f"{side}.{f}", dt, dev)
            if f == "mask" and t.data_ptr() % 8:
                raise ValueError(f"req_intersects: {side}.mask is not 8-byte aligned")
            args.append(t.data_ptr())
    out = torch.empty((A, B), dtype=torch.bool, device=dev)
    _call("req_intersects", *args, A, B, K, V, out.data_ptr())
    return out


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
    offering gate."""
    dev = used.device
    T, GR, R = it.alloc.shape
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    _check(used, "used", torch.float32, dev)
    _check(req, "req", torch.float32, dev)
    if used.shape[1] != R or req.shape != (R,) or used.shape[0] not in (1, n_rows):
        raise ValueError(f"fill_count_grid: used {tuple(used.shape)} / req {tuple(req.shape)} vs R={R}, rows={n_rows}")
    alloc = _check(it.alloc, "alloc", torch.float32, dev)
    gv = _check(it.group_valid, "group_valid", torch.bool, dev)
    zc = _check(it.zc_avail, "zc_avail", torch.bool, dev)
    used_stride = 0 if used.shape[0] == 1 else R
    if rows_mask is not None:
        _check(rows_mask, "rows_mask", torch.bool, dev)
        K, V = rows_mask.shape[1], rows_mask.shape[2]
        if rows_mask.shape[0] not in (1, n_rows) or Z > V or C > V:
            raise ValueError(f"fill_count_grid: rows_mask {tuple(rows_mask.shape)} vs rows={n_rows}, Z={Z}, C={C}")
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
            raise ValueError(f"fill_count_grid: viable {tuple(viable.shape)} vs ({n_rows}, {T})")
        out = torch.empty(n_rows, dtype=torch.int32, device=dev)
    else:
        _check(counts, "counts", torch.int32, dev)
        if counts.shape != (n_rows,):
            raise ValueError(f"fill_count_grid: counts {tuple(counts.shape)} vs ({n_rows},)")
        out = torch.empty((n_rows, T), dtype=torch.bool, device=dev)
    _call(
        "fill_count_grid", mode, alloc.data_ptr(), gv.data_ptr(), zc.data_ptr(),
        req.data_ptr(), used.data_ptr(), used_stride, zptr, cptr, mask_stride,
        gate, _ptr(viable), _ptr(counts), n_rows, T, GR, R, Z, C, out.data_ptr(),
    )
    return out


def water_fill(p: torch.Tensor, f: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """H3: [N] int32 water-fill of `rem` (a device int32 scalar) pods."""
    dev = p.device
    _check(p, "p", torch.int32, dev)
    _check(f, "f", torch.int32, dev)
    rem = _check(rem.reshape(1), "rem", torch.int32, dev)
    if f.shape != p.shape or p.dim() != 1:
        raise ValueError(f"water_fill: p {tuple(p.shape)} vs f {tuple(f.shape)}")
    out = torch.empty_like(p)
    _call("water_fill", p.data_ptr(), f.data_ptr(), rem.data_ptr(), p.shape[0], out.data_ptr())
    return out


def compact_scatter(mode: int, sel: torch.Tensor, srcs: list, dsts: list) -> None:
    """H4: move rows of every src field into its dst field, in place —
    mode 0: to the stable-compacted position of the alive rows (sel =
    [n] bool); mode 1: to sel[i] (int32 ids), dropping out-of-range ids."""
    dev = sel.device
    n = sel.shape[0]
    _check(sel, "sel", torch.bool if mode == 0 else torch.int32, dev)
    if not srcs or len(srcs) != len(dsts):
        raise ValueError("compact_scatter: need matching src/dst lists")
    n_dst = dsts[0].shape[0]
    row_bytes = []
    for s, d in zip(srcs, dsts):
        _check(s, "src", s.dtype, dev)
        _check(d, "dst", s.dtype, dev)
        if s.shape[0] != n or d.shape[0] != n_dst or s.shape[1:] != d.shape[1:]:
            raise ValueError(f"compact_scatter: src {tuple(s.shape)} / dst {tuple(d.shape)} vs rows {n}/{n_dst}")
        row_bytes.append(s[0].numel() * s.element_size() if n else 0)
    k = len(srcs)
    src_arr = (ctypes.c_void_p * k)(*[s.data_ptr() for s in srcs])
    dst_arr = (ctypes.c_void_p * k)(*[d.data_ptr() for d in dsts])
    rb_arr = (ctypes.c_int64 * k)(*row_bytes)
    pos = torch.empty(n, dtype=torch.int32, device=dev) if mode == 0 else None
    _call(
        "compact_scatter", mode, n, sel.data_ptr(), n_dst, k,
        ctypes.cast(src_arr, ctypes.c_void_p), ctypes.cast(dst_arr, ctypes.c_void_p),
        ctypes.cast(rb_arr, ctypes.c_void_p), _ptr(pos),
    )
