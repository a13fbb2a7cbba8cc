"""Resource-list arithmetic.

Counterpart of the reference's resource helpers (reference:
pkg/utils/resources/resources.go — Merge/Subtract/Fits/Cmp over
corev1.ResourceList). We represent a resource list as a plain
``dict[str, float]`` with canonical units:

  cpu               cores (fractional)
  memory            bytes
  pods              count
  ephemeral-storage bytes
  <extended>        count (e.g. "nvidia.com/gpu", "hugepages-2Mi" in bytes)

Quantities may be given as Kubernetes quantity strings ("100m", "1Gi",
"2.5", "1e3") and are parsed to floats with `parse_quantity`.
"""

from __future__ import annotations

import math
import re

import numpy as np

# Canonical resource names (mirror corev1 resource names).
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
HUGEPAGES_PREFIX = "hugepages-"

_BIN_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC_SUFFIX = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}

_QTY_RE = re.compile(r"^([+-]?[0-9.eE+-]+?)(Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])?$")


def parse_quantity(q: "str | int | float") -> float:
    """Parse a Kubernetes quantity ('100m', '1Gi', 3, '2e3') into a float.

    Values are quantized to float32 so host-side resource arithmetic is
    bit-identical to the device solver's f32 tensors (same inputs, same
    accumulation order -> same sums, making exact <= comparisons safe on
    both sides).
    """
    if isinstance(q, (int, float)):
        return float(np.float32(q))
    s = q.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {q!r}")
    num, suffix = m.groups()
    value = float(num)
    if suffix:
        value *= _BIN_SUFFIX.get(suffix) or _DEC_SUFFIX[suffix]
    return float(np.float32(value))


def parse_resource_list(rl: "dict[str, str | int | float] | None") -> dict[str, float]:
    return {k: parse_quantity(v) for k, v in (rl or {}).items()}


def quantize(rl: "dict[str, float] | None") -> dict[str, float]:
    """Round every value to float32 (the framework-wide resource dtype)."""
    return {k: float(np.float32(v)) for k, v in (rl or {}).items()}


def merge(*lists: "dict[str, float] | None") -> dict[str, float]:
    """Sum resource lists key-wise (reference Merge semantics).

    Accumulates in float32 to stay bit-identical with the device solver.
    """
    out: dict[str, float] = {}
    for rl in lists:
        for k, v in (rl or {}).items():
            out[k] = float(np.float32(np.float32(out.get(k, 0.0)) + np.float32(v)))
    return out


def subtract(a: dict[str, float], b: dict[str, float]) -> dict[str, float]:
    """a - b key-wise; keys only in b appear negated (reference Subtract)."""
    out = dict(a)
    for k, v in b.items():
        out[k] = float(np.float32(np.float32(out.get(k, 0.0)) - np.float32(v)))
    return out


def fits(candidate: dict[str, float], total: dict[str, float]) -> bool:
    """True iff every requested resource in candidate is <= total[k].

    Exact comparison: both sides of the framework quantize to float32 and
    accumulate in the same order, so no epsilon is needed (and using one
    would diverge from the device solver's exact f32 compare).

    A resource requested but absent from total is treated as 0 available
    (so any positive request fails), matching the reference's Fits.
    """
    return all(v <= total.get(k, 0.0) for k, v in candidate.items())


def cmp(a: float, b: float, rel_tol: float = 1e-9) -> int:
    if math.isclose(a, b, rel_tol=rel_tol, abs_tol=1e-12):
        return 0
    return -1 if a < b else 1


def max_resources(*lists: dict[str, float]) -> dict[str, float]:
    out: dict[str, float] = {}
    for rl in lists:
        for k, v in rl.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def is_zero(rl: dict[str, float]) -> bool:
    return all(v <= 0 for v in rl.values())


def format_cpu(cores: float) -> str:
    if cores == int(cores):
        return str(int(cores))
    return f"{int(round(cores * 1000))}m"
