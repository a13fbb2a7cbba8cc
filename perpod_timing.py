#!/usr/bin/env python3
"""Time the per-pod scan of one checkout of this repository on one NVIDIA GPU.

    python3 perpod_timing.py [--repo DIR] [--tag NAME]

DIR is the checkout whose karpenter_tpu_torch is imported (default: the
one holding this script); it builds its own kernels. Two cells, each with
a cold call, a warm call, then one more warm call under torch.profiler:

  perpod         TorchScheduler(make_templates(400), max_claims=4096).solve
                 on perpod_pods(4096, kinds=8)
  whatif_prefix  TorchScheduler(make_templates(400)).whatif_batch on the
                 prefixes 1..100 of the cheapest candidates of
                 mixed_pods(4096) provisioned and launched as a cluster,
                 with 64 pending pods

For each: the device time and launches of the per-pod kernels (every
kernel whose name holds "perpod_"), the scan's steps (the per-pod chunks'
lengths, or the batch's L), their ms per step, device_s of the warm calls
and the profiled call's device idle share. Prints one JSON line, with the
card's name and power limit. To compare two checkouts, run both in one
call on one card, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile


def profile(fn) -> dict:
    """One call of fn under chip_smoke.py's profile_run (the one next to
    this script): the device busy share over the call's wall and the
    per-pod kernels' device time and launches."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with tempfile.TemporaryDirectory() as d:
        p = smoke.profile_run(fn, d, "perpod_timing")
    by_name = p.pop("by_name")
    p.pop("top", None)
    if not by_name:
        return dict(measured=False)
    mine = {n: v for n, v in by_name.items() if "perpod_" in n}
    return dict(p, measured=True, kernel_ms=sum(ms for _c, ms in mine.values()),
                kernel_launches=sum(c for c, _ms in mine.values()), kernels=sorted(n[:80] for n in mine))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", flush=True)
        return 1
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
    from karpenter_tpu_torch.ops import cuda, solver

    if not os.path.abspath(cuda.__file__).startswith(repo):
        print(f"FAIL: imported {cuda.__file__}, not from {repo}", flush=True)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cuda.build()
    out = dict(repo=repo, tag=args.tag, card=card)

    # the per-pod cell: steps are the lengths of the chunks solve_from runs
    steps = []
    real_solve_from = solver.solve_from

    def counting(state, pods, *rest, **kw):
        steps.append(pods.valid.shape[0])
        return real_solve_from(state, pods, *rest, **kw)

    templates = T.make_templates(400)
    pods = T.perpod_pods(4096, kinds=8)
    sched = TorchScheduler(templates, max_claims=4096)
    sched.solve(pods)
    sched.solve(pods)
    torch.cuda.synchronize()
    warm_device_s = sched.last_timings["device_s"]
    solver.solve_from = counting
    try:
        p = profile(lambda: sched.solve(pods))
    finally:
        solver.solve_from = real_solve_from
    p.update(warm_device_s=warm_device_s, profiled_device_s=sched.last_timings["device_s"], steps=sum(steps),
             claims=sched.last_stats.get("claims"))
    if p.get("measured"):
        p["ms_per_step"] = p["kernel_ms"] / max(sum(steps), 1)
    out["perpod"] = p

    # the what-if prefix cell
    cl = T.bound_cluster(T.mixed_pods(4096), templates)
    cands = T.candidates(cl)
    pending = T.pending_pods(64)
    factory = T.topology_factory(cl)
    bpods, specs = T.prefix_scenarios(cands, 100, pending)
    ws = TorchScheduler(templates)

    def batch():
        return ws.whatif_batch(bpods, [n.clone() for n in cl.nodes], None, specs, factory)

    batch()
    sig = batch()
    torch.cuda.synchronize()
    warm_device_s = ws.last_timings["device_s"]
    w = profile(batch)
    w.update(warm_device_s=warm_device_s, profiled_device_s=ws.last_timings["device_s"],
             steps=ws.last_stats["L"], S=ws.last_stats["S"], signals_digest=T.signals_digest(sig))
    if w.get("measured"):
        w["ms_per_step"] = w["kernel_ms"] / max(ws.last_stats["L"], 1)
    out["whatif_prefix"] = w
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
