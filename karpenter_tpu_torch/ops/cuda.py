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

# the per-pod scan's kernel, csrc/perpod_scan.cu: one launch per chunk of
# steps; its scenario mode (the batched what-ifs) counted on its own
PERPOD_KERNELS = ("perpod_scan_persistent",)
WHATIF_KERNELS = ("perpod_scan_persistent_whatif",)
KERNELS = (
    "req_intersects", "fill_count_grid", "water_fill", "compact_scatter", "kscan_grid",
    "kscan_pod_loop", *PERPOD_KERNELS, *WHATIF_KERNELS,
)
# csrc/<source>.cu of each kernel (its own name unless listed), and the C
# entry points of each source (its own name unless listed)
SOURCE = {k: ("perpod_scan" if k in PERPOD_KERNELS + WHATIF_KERNELS else k) for k in KERNELS}
ENTRIES = {"perpod_scan": ("perpod_steps",)}
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
        raise RuntimeError(
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
    "req_intersects": [_P] * 12 + [_I] * 4 + [_P, _P],
    "fill_count_grid": [_I, _P, _P, _P, _P, _P, _I64, _P, _P, _I64, _I, _P, _P]
    + [_I] * 6 + [_P, _P],
    "water_fill": [_P, _P, _P, _I, _P, _P],
    "compact_scatter": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "kscan_grid": [_I, _P, _P, _P],
    "kscan_pod_loop": [_P, _I, _P, _P],
    "perpod_steps": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P],
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
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")


def _call(name: str, *args) -> None:
    """Launch kernel `name` once through its own C entry."""
    _invoke(SOURCE[name], name, *args)
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


def compact_scatter(
    mode: int, sel: torch.Tensor, srcs: list, dsts: list,
    tk: tuple = (), tk_srcs: list = (), tk_dsts: list = (),
) -> None:
    """H4: move rows of every src field into its dst field, in place —
    mode 0: to the stable-compacted position of the alive rows (sel =
    [n] bool); mode 1: to sel[i] (int32 ids), dropping out-of-range ids.
    Each tk_src [n, K, ...] moves only its key rows `tk` into its tk_dst
    [n_dst, len(tk), ...], in the same launch."""
    dev = sel.device
    n = sel.shape[0]
    _check(sel, "sel", torch.bool if mode == 0 else torch.int32, dev)
    if not srcs or len(srcs) != len(dsts) or len(tk_srcs) != len(tk_dsts):
        raise ValueError("compact_scatter: need matching src/dst lists")
    if tk_srcs and not tk:
        raise ValueError("compact_scatter: key-row fields need key ids")
    n_dst = dsts[0].shape[0]
    row_bytes, src_bytes, seg_bytes = [], [], []
    for s, d in zip(srcs, dsts):
        _check(s, "src", s.dtype, dev)
        _check(d, "dst", s.dtype, dev)
        if s.shape[0] != n or d.shape[0] != n_dst or s.shape[1:] != d.shape[1:]:
            raise ValueError(f"compact_scatter: src {tuple(s.shape)} / dst {tuple(d.shape)} vs rows {n}/{n_dst}")
        rb = s[0].numel() * s.element_size() if n else 0
        row_bytes.append(rb)
        src_bytes.append(rb)
        seg_bytes.append(0)
    for s, d in zip(tk_srcs, tk_dsts):
        _check(s, "tk src", s.dtype, dev)
        _check(d, "tk dst", s.dtype, dev)
        if (s.shape[0] != n or d.shape[0] != n_dst or d.shape[1] != len(tk)
                or s.shape[2:] != d.shape[2:] or max(tk) >= s.shape[1]):
            raise ValueError(f"compact_scatter: tk src {tuple(s.shape)} / dst {tuple(d.shape)} vs tk {tk}")
        seg = s[0, 0].numel() * s.element_size() if n else 0
        row_bytes.append(seg * len(tk))
        src_bytes.append(s[0].numel() * s.element_size() if n else 0)
        seg_bytes.append(seg)
    fields = list(srcs) + list(tk_srcs)
    outs = list(dsts) + list(tk_dsts)
    k = len(fields)
    src_arr = (ctypes.c_void_p * k)(*[s.data_ptr() for s in fields])
    dst_arr = (ctypes.c_void_p * k)(*[d.data_ptr() for d in outs])
    rb_arr = (ctypes.c_int64 * k)(*row_bytes)
    sb_arr = (ctypes.c_int64 * k)(*src_bytes)
    seg_arr = (ctypes.c_int64 * k)(*seg_bytes)
    tk_arr = (ctypes.c_int * max(len(tk), 1))(*tk)
    pos = torch.empty(n, dtype=torch.int32, device=dev) if mode == 0 else None
    _call(
        "compact_scatter", mode, n, sel.data_ptr(), n_dst, k,
        ctypes.cast(src_arr, ctypes.c_void_p), ctypes.cast(dst_arr, ctypes.c_void_p),
        ctypes.cast(rb_arr, ctypes.c_void_p), ctypes.cast(sb_arr, ctypes.c_void_p),
        ctypes.cast(seg_arr, ctypes.c_void_p), len(tk) if tk_srcs else 0,
        ctypes.cast(tk_arr, ctypes.c_void_p), _ptr(pos),
    )


def _i64_array(vals) -> ctypes.Array:
    return (ctypes.c_int64 * len(vals))(*vals)


def _kscan_grid_call(mode, ptrs: list, dims: list) -> None:
    _call(
        "kscan_grid", mode, ctypes.cast(_i64_array([p or 0 for p in ptrs]), ctypes.c_void_p),
        ctypes.cast(_i64_array(dims), ctypes.c_void_p),
    )


def _kscan_common(it, key_kid: int, D: int, dev):
    T, GR, R = it.alloc.shape
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
    if D < 1 or D > 16 or D > V:
        raise ValueError(f"kscan_grid: D={D} outside [1, min(16, V={V})]")
    alloc = _check(it.alloc, "alloc", torch.float32, dev)
    gv = _check(it.group_valid, "group_valid", torch.bool, dev)
    zc = _check(it.zc_avail, "zc_avail", torch.bool, dev)
    idef = _check(it.reqs.defined, "it.defined", torch.bool, dev)
    imask = _check(it.reqs.mask, "it.mask", torch.bool, dev)
    ptrs = [alloc.data_ptr(), gv.data_ptr(), zc.data_ptr()]
    key_ptrs = [idef.data_ptr() + key_kid, imask.data_ptr() + key_kid * V]
    return T, GR, R, Z, C, K, V, ptrs, key_ptrs


def kscan_grid(used, req, it, viable, rows_mask, zone_kid, ct_kid, key_kid, D, grid=None):
    """H5 grid mode: (grid [N, T, GR] int32, capd [N, D] int32) for the
    rows of `used` [N, R], the viable mask [N, T] and the rows' [N, K, V]
    requirement mask (its zone / capacity-type rows gate offerings). With
    `grid` given, only capd is computed from it."""
    dev = used.device
    T, GR, R, Z, C, K, V, ptrs, key_ptrs = _kscan_common(it, key_kid, D, dev)
    N = used.shape[0]
    _check(used, "used", torch.float32, dev)
    _check(req, "req", torch.float32, dev)
    _check(viable, "viable", torch.bool, dev)
    _check(rows_mask, "rows_mask", torch.bool, dev)
    if used.shape != (N, R) or req.shape != (R,) or viable.shape != (N, T) or rows_mask.shape != (N, K, V):
        raise ValueError(f"kscan_grid: used {tuple(used.shape)} viable {tuple(viable.shape)} mask {tuple(rows_mask.shape)}")
    if key_kid == zone_kid and D > Z:
        raise ValueError(f"kscan_grid: zone key with D={D} > Z={Z}")
    mode = 0 if grid is None else 1
    if grid is None:
        grid = torch.empty((N, T, GR), dtype=torch.int32, device=dev)
    else:
        _check(grid, "grid", torch.int32, dev)
        if grid.shape != (N, T, GR):
            raise ValueError(f"kscan_grid: grid {tuple(grid.shape)} vs ({N}, {T}, {GR})")
    capd = torch.empty((N, D), dtype=torch.int32, device=dev)
    base = rows_mask.data_ptr()
    _kscan_grid_call(
        mode,
        ptrs + [req.data_ptr(), used.data_ptr(), viable.data_ptr(), base + zone_kid * V,
                base + ct_kid * V] + key_ptrs + [0, 0, grid.data_ptr(), capd.data_ptr()],
        [N, T, GR, R, Z, C, D, int(key_kid == zone_kid), K * V, K, K * V],
    )
    return grid, capd


def kscan_fits_final(grid, placed, zset, ct_mask, zmask, it, key_kid, zone_kid, D) -> torch.Tensor:
    """H5 fits-final mode: [N, T] bool any over g of grid >= placed[n] with
    an offering in the final domains zset [N, D] (zone key) or the zone
    mask rows zmask [N, V]; ct_mask [N, V] gates capacity types."""
    dev = grid.device
    T, GR, R, Z, C, K, V, ptrs, key_ptrs = _kscan_common(it, key_kid, D, dev)
    N = grid.shape[0]
    _check(grid, "grid", torch.int32, dev)
    _check(placed, "placed", torch.int32, dev)
    _check(zset, "zset", torch.bool, dev)
    _check(ct_mask, "ct_mask", torch.bool, dev)
    _check(zmask, "zmask", torch.bool, dev)
    if (grid.shape != (N, T, GR) or placed.shape != (N,) or zset.shape != (N, D)
            or ct_mask.shape != (N, V) or zmask.shape != (N, V)):
        raise ValueError("kscan_fits_final: shapes disagree")
    out = torch.empty((N, T), dtype=torch.bool, device=dev)
    _kscan_grid_call(
        2,
        ptrs + [0, 0, 0, zmask.data_ptr(), ct_mask.data_ptr()] + key_ptrs
        + [zset.data_ptr(), placed.data_ptr(), grid.data_ptr(), out.data_ptr()],
        [N, T, GR, R, Z, C, D, int(key_kid == zone_kid), V, K, K * V],
    )
    return out


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


def kscan_pod_loop(inp, carry, topo, count: int, maxc: int, n_claims: int) -> torch.Tensor:
    """H6: the kind scan's pod loop for one segment in one launch. `inp`
    (ops.solver.PodLoopIn) is read, `carry` (PodLoopCarry) updated in
    place; returns the [maxc] int32 assignment row."""
    dev = carry.zn.device
    W, D = carry.zn.shape
    E = carry.ze.shape[0]
    G = inp.static_g.shape[0]
    NGv, NGh = topo.vg_type.shape[0], topo.hg_type.shape[0]
    S, V = carry.hgc.shape[1], topo.vg_domains.shape[1]
    if count > maxc:
        raise ValueError(f"kscan_pod_loop: {count} pods > buffer {maxc}")
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
                raise ValueError(f"kscan_pod_loop: {name} {tuple(t.shape)} vs {shapes[name]}")
            ptrs.append(t.data_ptr())
    out = torch.full((maxc,), -1, dtype=torch.int32, device=dev)
    ptrs.append(out.data_ptr())
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
    """The 82 (name, tensor, dtype, shape) fields of csrc/perpod_scan.cu's
    parameter block, in its order, and its 29 dims. `row_max` [W, R] f32 is
    the kernel's scratch. The last, pod_idx, is None (a null pointer: step
    i reads pod row i); scenario mode sets it. The type tables travel
    packed (`perpod_tables`)."""
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
        raise ValueError(f"perpod_scan: hostname slots {Sl} < E + n_claims + 1 = {E + NCAP + 1}")
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
            ("templates.valid", tm.valid, b, (G,)), ("mv_key", tm.mv_key, i, (G, M)),
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
        raise ValueError(
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
            raise ValueError(f"perpod_tables: {name} is {t.dtype} on {t.device}, expected {dt} on {it.alloc.device}")
    if mv_it_values.shape[0] != T or mv_it_values.shape[2] != V:
        raise ValueError(f"perpod_tables: mv_it_values {tuple(mv_it_values.shape)} vs T={T}, V={V}")
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
            raise ValueError(f"{what}: {name} {tuple(t.shape)} vs {shape}")
        ptrs.append(t.data_ptr())
    fl = ctx.flags
    if fl.res_active and not (0 <= fl.rid_kid < dims[4] and 0 <= fl.res_vid < dims[5]):
        raise ValueError(f"{what}: reservations on with rid_kid={fl.rid_kid}, res_vid={fl.res_vid}")
    if not 0 <= lo <= hi <= dims[17]:
        raise ValueError(f"{what}: steps [{lo}, {hi}) outside [0, {dims[17]})")
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
    block's 82 (name, tensor, dtype, shape) fields with each scenario
    field (`_scenario_tensors`) stacked on a leading S axis and pod_idx
    [S, L] set, their 82 byte strides per scenario (0 for the shared
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
        raise ValueError(f"perpod_whatif: pod_idx outside the {P} pod rows")
    _perpod_launch(fields, dims, strides, S, ctx, lo, hi, "perpod_whatif")
    return assignment


def perpod_whatif(state, xs, ctx, pod_idx, valid, exist_valid) -> torch.Tensor:
    """Every step of S scenarios in one launch; returns the [S, L] int32 assignment."""
    return perpod_whatif_steps(state, xs, ctx, pod_idx, valid, exist_valid, 0, pod_idx.shape[1])
