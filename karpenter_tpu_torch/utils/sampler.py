"""Process samplers for the pipelined decode's per-group envelope
(last_timings["pipeline"]["chunks"]: host_rss_mb, cpu_s): the port's own
copy of the JAX package's envelope/sampler.py readers."""

from __future__ import annotations

import os

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_rss_bytes() -> int:
    """Live resident set size (VmRSS) of this process in bytes."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except OSError:  # non-Linux: the high-water mark is all there is
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def read_cpu_seconds() -> float:
    """User + system CPU seconds across ALL threads of this process."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime
