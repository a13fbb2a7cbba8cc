"""Build a kernel source of karpenter_tpu_torch/ops/csrc on the CPU,
against tests/cuda_emu.h, for the emulated-kernel suites
(tests/test_torch_*_emulated.py):

    from cuda_emu_build import c_entry, emulated_library
    fn = c_entry(emulated_library(tmp_path_factory, "retract_tail"), "retract_tail")

The source is rewritten for the emulator (the CUDA header for cuda_emu.h
and its thread-local globals, each <<<...>>> launch for emu_launch,
then the suite's own `rewrite`, for what else a source uses), compiled
with the host's C++ compiler into a shared library and loaded with ctypes;
the entry's argtypes are ops/cuda.py's. A library is built once per test
session, keyed by a hash of the rewritten source, the emulator and the
compiler flags, in a directory the session's xdist workers share, so the
workers do not each compile it.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import pytest

from karpenter_tpu_torch.ops import cuda as p_cuda

HERE = Path(__file__).resolve().parent
FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread")
PRELUDE = ('#include "cuda_emu.h"\nthread_local Dim threadIdx, blockIdx;\nDim blockDim;\nEmuBlock* g_emu;\n'
           "thread_local int tl_parity;")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(([^)]*)\);")


def emulated_source(source: str, rewrite=None) -> str:
    """csrc/<source>.cu with the CUDA header and launch syntax swapped for
    the emulator's, then `rewrite` applied."""
    src = (p_cuda.CSRC / f"{source}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    src, n = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4, \6);", src)
    assert n >= 1, "no kernel launch"
    return rewrite(src) if rewrite else src


def _shared_dir(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    # xdist gives each worker its own basetemp under one session directory
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "cuda_emu"
    root.mkdir(exist_ok=True)
    return root


def emulated_library(tmp_path_factory, source: str, rewrite=None) -> ctypes.CDLL:
    """The emulated build of csrc/<source>.cu, loaded (built at most once
    per session); skips when the host has no C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the emulated kernel")
    src = emulated_source(source, rewrite)
    h = hashlib.sha256(" ".join(FLAGS).encode() + src.encode() + (HERE / "cuda_emu.h").read_bytes())
    for header in sorted(p_cuda.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    lib = _shared_dir(tmp_path_factory) / f"lib{source}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        d = tmp_path_factory.mktemp(f"{source}_emu")
        (d / f"{source}.cpp").write_text(src)
        tmp = d / f"lib{source}.so"
        res = subprocess.run(
            [cxx, *FLAGS, f"-I{HERE}", f"-I{p_cuda.CSRC}", "-o", str(tmp), str(d / f"{source}.cpp")],
            capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr[-4000:]
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def c_entry(lib: ctypes.CDLL, entry: str):
    """C entry `entry` of an emulated build, with ops/cuda.py's argtypes;
    a call fails its test when one of its launches deadlocked (cuda_emu.h
    emu_error) or two lanes of a warp raced on a noted address
    (emu_race)."""
    fn = getattr(lib, entry)
    fn.argtypes = p_cuda._ARGTYPES[entry]
    fn.restype = ctypes.c_int
    err = ctypes.c_int.in_dll(lib, "emu_error")
    race = ctypes.c_int.in_dll(lib, "emu_race")

    def call(*args) -> int:
        rc = fn(*args)
        if err.value:
            err.value = 0
            pytest.fail(f"emulated {entry}: a launch deadlocked (every unfinished CUDA thread waits at a barrier)")
        if race.value:
            race.value = 0
            pytest.fail(f"emulated {entry}: a race — two lanes of a warp accessed one address, one of them storing, "
                        "with no __syncwarp or __syncthreads between them (cuda_emu.h emu_note_*), or an mbarrier "
                        "was used before its init")
        return rc

    return call


def limited_call(fn, *args, limit_s: float = 60.0) -> int:
    """fn(*args) (an emulated C entry) on a thread of its own; fails the
    test when it has not returned within limit_s seconds, so that a
    kernel stuck in a spin-wait fails its test and does not hang the suite
    (the stuck thread is left behind; a launch whose CUDA threads all wait
    at barriers ends at once, and c_entry fails its test)."""
    box = {}

    def run():
        try:
            box["rc"] = fn(*args)
        except BaseException as e:  # raised again on the test's thread
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(limit_s)
    if th.is_alive():
        pytest.fail(f"emulated kernel still running after {limit_s} s: a deadlock?")
    if "error" in box:
        raise box["error"]
    return box["rc"]
