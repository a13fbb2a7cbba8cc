#!/usr/bin/env python3
"""Time H1 req_intersects, H2 fill_count_grid, H3 water_fill, H4
compact_scatter, H5 kscan_grid, H6 kscan_pod_loop, H9 gang_scan, H11
objective_verdict, H12 dp_dead, H13 dp_verdict, H14 merge_shard and H15
wire_pack of one checkout of this repository on one NVIDIA GPU.

    python3 kernel_timing.py [--repo DIR] [--tag NAME] [--cells] [--only KERNEL,...]

DIR is the checkout whose karpenter_tpu_torch is imported (default: the
one holding this script); it builds its own kernels. The script runs
chip_smoke.py's (the one next to this script) phase-3 checks of H1-H6,
H9 and H15 against DIR's package, each in its call shapes at the north
star's catalog (T = 1000) and a window of 4096 rows: H1 at tier 2 (W
claim rows), tier 3 (G template rows) and a seeded catalog of 70 keys
(three key words), and at the kind step's tier 2 and tier 3 (T = 400);
H2 in each call shape of the fill step and the compaction; H3 on the
window, at W = 131072, with counts past 2^24 (the bisection stops
short), rem = 0 and sum(f) <= rem; H4 in the
compaction (14 window fields), compact_state's bank columns, the drop
scatter, global_claims, the topology-key bank and a compaction at W =
131072; H5 in modes 0 (tier 2's W rows and tier 3's G rows), 1 and 2,
each on the zone key and on the capacity-type key (T = 400); H6 over a
256-pod segment at the mixed cell's shapes and over
one segment at W = 8192, D = 16 past its shared-memory staging; H9 on
the gang runs of the two gang cells (gang_storm_64x16x400's run of 72
segments; gang_zonal_budget_4096x400's zone-key run of 32 and its
hostname run of 8) and on gang_storm with every gang its own cpu
request (64 segments, none reusing the one before's terms), each launch
on its own copy of the carry, cloned before the timed window; H15 on
three recorded fetches (the north
star's first pipeline group, mixed's last group with its final state
reads, a dp verdict word of 4 bytes); H11 at objectives_mixed_16384x400's
first round under each of the four non-lexical policies and with every
type unpriced; H12 and H13 on the first round of each of
chip_smoke.SHARD_KERNEL_CELLS (fill, kind-scan and per-pod modes) and H14
on each cell's first commit (its fill mode on the existing twin's, its
kscan mode on the zonal twin's and the per-pod cell's), after
which the warm solves of chip_smoke.SYNC_DP_CELLS list the lines that
made the host wait (chip_smoke.sync_points). --only runs the phases of
the named kernels alone (e.g. --only objective_verdict,dp_verdict,merge_shard). Each call shape's line
(chip_smoke.CALL_SHAPES) gives the kernel's device ms
per launch and per call (torch.profiler, over every `__global__` function
of DIR's source of that kernel, so an older design that launched two
kernels a call is counted whole), the CUDA-event ms and the launcher's host ms per
call, the bound, and whether the kernel equals its plain version.
--cells runs, in place of the kernel checks, the north star
(selector_pods(100_000) x make_templates(1000)) and mixed_pods(16384) x
make_templates(400) at max_claims=4096: a cold solve, three warm ones
(their walls and device_s), and one more under torch.profiler (device
busy, idle share, and H1-H6's, H9's and H15's device ms and launches).
Prints the card's name and power limit first and one JSON line last. To
compare two checkouts, run both in one call on one card, in turns (A, B,
B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

def use_checkout_kernels(smoke, repo: str) -> None:
    """Point chip_smoke's profiled kernel names at DIR's own: every
    `__global__` function of the source of H1-H6, H9 and H11-H15."""
    csrc = os.path.join(repo, "karpenter_tpu_torch", "ops", "csrc")
    sources = (("req_intersects", "H1_NAMES"), ("fill_count_grid", "H2_NAMES"), ("water_fill", "H3_NAMES"),
               ("compact_scatter", "H4_NAMES"), ("kscan_grid", "H5_NAMES"), ("kscan_pod_loop", "H6_NAMES"),
               ("gang_scan", "H9_NAMES"), ("objective_verdict", "H11_NAMES"), ("dp_dead", "H12_NAMES"),
               ("dp_verdict", "H13_NAMES"), ("merge_shard", "H14_NAMES"), ("wire_pack", "H15_NAMES"))
    for source, attr in sources:
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            names = tuple(dict.fromkeys(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                                   f.read())))
        assert names, f"no kernel in {source}.cu"
        setattr(smoke, attr, names)
    smoke.PROFILED_KERNELS = tuple((source, getattr(smoke, attr)) for source, attr in sources)


def cells(smoke, card: str, repo: str, tag: str) -> int:
    """The north star and mixed cells' warm walls and profiles (--cells)."""
    import tempfile
    import time

    import torch

    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    out = {}
    for name, templates, pods in (("northstar", T.make_templates(1000), T.selector_pods(100_000)),
                                  ("mixed", T.make_templates(400), T.mixed_pods(smoke.MIXED_PODS))):
        sched = TorchScheduler(templates, max_claims=4096)
        sched.solve(pods)
        walls, device_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.solve(pods)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            device_s.append(sched.last_timings["device_s"])
        with tempfile.TemporaryDirectory() as d:
            prof = smoke.profile_run(lambda: sched.solve(pods), d, f"{name}_{tag}", quiet=True)
        row = dict(warm_walls=walls, warm_device_s=device_s)
        if prof["by_name"]:
            row.update(device_busy_s=prof["device_busy_s"], idle_share=prof["idle_share"])
            for k, names in smoke.PROFILED_KERNELS:
                n, ms = smoke.kernel_device(prof["by_name"], names)
                row[k] = dict(launches=n, device_ms=ms)
        out[name] = row
        print(f"cell {name}: {json.dumps(row)}", flush=True)
    print(json.dumps(dict(card=card, repo=repo, tag=tag, cells=out)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", flush=True)
        return 1
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
    from karpenter_tpu_torch.ops import cuda

    if not os.path.abspath(cuda.__file__).startswith(repo):
        print(f"FAIL: imported {cuda.__file__}, not from {repo}", flush=True)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    use_checkout_kernels(smoke, repo)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card} | repo {repo} {args.tag}", flush=True)
    cuda.build()
    if args.cells:
        return cells(smoke, card, repo, args.tag)
    only = set(filter(None, args.only.split(",")))
    timed = ("req_intersects", "fill_count_grid", "water_fill", "compact_scatter", "kscan_grid", "kscan_pod_loop",
             "gang_scan", "objective_verdict", "dp_dead", "dp_verdict", "merge_shard", "wire_pack")
    if only - set(timed):
        print(f"FAIL: --only names no timed kernel: {sorted(only - set(timed))}", flush=True)
        return 1

    def wanted(*names) -> bool:
        return not only or bool(only.intersection(names))

    results = []
    if wanted("req_intersects", "fill_count_grid", "water_fill", "compact_scatter"):
        sched = TorchScheduler(T.make_templates(1000), max_claims=4096)
        sched._encode(T.selector_pods(16), None)
        results += smoke.kernel_phase(sched)
    if wanted("kscan_grid", "kscan_pod_loop"):
        sched_m = TorchScheduler(T.make_templates(400), max_claims=4096)
        _sorted, enc_m = sched_m._encode(T.mixed_pods(64), None)
        smoke.kscan_kernel_phase(sched_m, enc_m, results)
    if wanted("gang_scan"):
        smoke.gang_kernel_phase(torch, cuda, smoke.gang_cells(T, TorchScheduler), results)
    if wanted("objective_verdict"):
        smoke.objective_kernel_phase(torch, cuda, T, TorchScheduler, results)
    if wanted("dp_dead", "dp_verdict", "merge_shard"):
        smoke.shard_kernel_phase(torch, cuda, T, TorchScheduler, results)
        dp_cells = {c[0]: c for c in smoke.shard_cells(T)}
        for label in smoke.SYNC_DP_CELLS:
            sched_s = smoke.shard_sched(TorchScheduler, dp_cells[label])
            smoke.shard_solve(sched_s, dp_cells[label])
            smoke.sync_points(torch, sched_s, lambda: smoke.shard_solve(sched_s, dp_cells[label]), label)
    if wanted("wire_pack"):
        smoke.wire_kernel_phase(torch, cuda, T, TorchScheduler, results)
    keep = {r["name"]: {k: r.get(k) for k in ("ms", "event_ms", "launcher_ms", "plain_ms", "bound_ms", "equal")}
            for r in results if r["name"] in timed and wanted(r["name"])}
    shapes = [{k: v for k, v in c.items() if k in ("kernel", "label", "equal", "device_ms", "device_call_ms",
                                                     "device_launches", "calls", "event_ms", "launcher_ms",
                                                     "bound_ms")} for c in smoke.CALL_SHAPES if wanted(c["kernel"])]
    print(json.dumps(dict(card=card, repo=repo, tag=args.tag,
                          nvcc_regs={k: re.findall(r"Used (\d+) registers", v)
                                     for k, v in cuda.BUILD_INFO.get("logs", {}).items() if k in timed},
                          kernels=keep, shapes=shapes)), flush=True)
    bad = [n for n, r in keep.items() if not r["equal"]] + [c["label"] for c in shapes if not c["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
