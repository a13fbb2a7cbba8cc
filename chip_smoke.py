#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --kernels-only   # stop after phase 3

Phases, any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from karpenter_tpu_torch/ops/csrc;
  3. each kernel against its plain PyTorch version on the card, exact
     equality, with times for kernel, plain version and the least time
     the card could take (bound): H1-H4 at the north-star shapes (W=4096
     claims, T=1000 types, GR=1, R=4, Z=4, C=2, K=V=8); H4's topology-key
     mode, H5 and H6 at the kind scan's (W=4096, T=400, D=4 zones, the
     encoded topology of mixed_pods: NGv 2, NGh 4; H6 over one segment of
     256 pods); seeded inputs, the catalog tensors being the real encoded
     ones; the per-pod kernel (perpod_scan_persistent, H7 + H8 in one
     launch per chunk) on the per-pod cell's real encoded problem
     (perpod_pods(4096, kinds=8) x make_templates(400): W=4096 claim rows,
     T=400, NGv 16), from the state a first 1024-pod chunk leaves: one
     step, 8 steps and a 256-pod chunk through the kernel against the same
     steps through the plain step; its scenario mode on the what-if prefix
     cell's encode (S=128 scenarios): one step of every scenario in one
     launch, and 4 scenarios (the largest prefix among them) run to the end
     through the kernel and through the plain loop; assignments and every
     carry leaf equal; the same two checks with the kernel's minValues and
     reservation branches on: one step, 8 steps and a 256-pod chunk of
     constrained_4096x400 from the state after 1024 pods, and in scenario
     mode on whatif_constrained_prefix100's encode (reservation
     capacities and held rows among the carry leaves);
  4. the main paths, each with the launch counts zeroed just before its
     cold solve and read just after, then two warm solves: the fill path,
     TorchScheduler(make_templates(1000), max_claims=4096) on
     selector_pods(100_000), held to the JAX package's result (2273
     claims, 0 unschedulable, 3149.6813 $/h) with H1-H4 launched; the
     topology path, TorchScheduler(make_templates(400), max_claims=4096) on
     mixed_pods(16384), held to 3277 claims, 0 unschedulable, 354.7156 $/h
     and 31 fill / 30 kind-scan dispatches / 60 compactions, with all six
     kernels launched; the per-pod path, TorchScheduler(make_templates(400),
     max_claims=4096) on perpod_pods(4096, kinds=8), held to 136 claims, 0
     unschedulable, 143.0965 $/h, the JAX package's assignment digest, 4
     per-pod dispatches and 3 compactions, with the per-pod kernel launched
     once per chunk and H2 and H4. One more warm solve of each under
     torch.profiler (device busy share and device time by kernel, trace and
     summary under build/profile/; the per-pod kernel's ms per launch and
     per step beside its bound per step over the same steps); small
     solves on the card held to the same solves on the CPU: 2048 selector
     pods, 1024 mixed pods (also 205 claims,
     21.5043 $/h), perpod_pods(256), mixed and per-pod kinds in one solve,
     and the custom-key workload that drives the per-pod step's full
     it-compat branch; then the consolidation path: mixed_pods(4096) x
     make_templates(400) provisioned and launched as 819 nodes with 4096
     bound pods, 64 pending pods, and TorchScheduler.whatif_batch on
     multi-node consolidation's batch (the prefixes 1..100 of the cheapest
     candidates) and single-node consolidation's (each of them alone),
     cold and twice warm, held to the JAX package's signals, with the
     per-pod kernel in scenario mode launched once per batch; one more warm
     call of each batch under torch.profiler; the sequential confirm of
     prefixes 1, 10 and 100 (TorchScheduler.solve(topology=...)) held to
     the JAX package's; then Karpenter's constraints: constrained_4096x400
     (mixed_pods(4096) and a 64-pod deployment on host port 443 over
     constrained_templates(400): minValues 2 on instance-type names and
     families, reserved offerings on 4 types, a pool cpu limit that binds;
     max_claims=4096), cold and twice warm, held to the JAX package's
     claims, unschedulable pods, $/h and result digest, every kind on the
     per-pod kernel (once per chunk, no fill or kind-scan dispatch), its
     kernel ms per step from a profiled warm solve beside its bound;
     hostports_2048x400 (mixed_pods(2048) and the deployment over
     make_templates(400): host-port bits on the fill and kind-scan
     kernels), held to the JAX package's; whatif_constrained_prefix100
     (the constrained templates' cluster of mixed_pods(4096), CSI attach
     limits and PVCs, reservations in use, 64 pending pods, the prefixes
     1..100) held to the JAX package's signals and placements, one launch
     in scenario mode, and one profiled warm batch;
  5. the three main-path solves with the kernels' plain versions on the
     card, which must give the identical digest (claims, pods, types,
     usage, requirements), and the wall of phase 3's plain what-if
     sub-batch.
The second-to-last line is one JSON object of per-kernel numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

# the JAX package's result for selector_pods(100_000) x make_templates(1000),
# max_claims=4096 (TPUScheduler.solve on the CPU at commit 153c45d)
GOLDEN_CLAIMS = 2273
GOLDEN_PRICE = 3149.6813
# ... for mixed_pods(16384) x make_templates(400), max_claims=4096 (the
# reference benchmark's headline mix), with its dispatch counts, and for
# mixed_pods(1024) x make_templates(400), max_claims=256 (the same, at 2f973d0)
MIXED_PODS = 16384
MIXED_CLAIMS = 3277
MIXED_PRICE = 354.7156
MIXED_STATS = {"fill_dispatches": 31, "kscan_dispatches": 30, "compactions": 60}
SMALL_MIXED = (205, 21.5043)
# ... for perpod_pods(4096, kinds=8) x make_templates(400), max_claims=4096
# (TPUScheduler.solve on the CPU at 9314712): claims, price, the digest()
# of its result, and its chunking (4 per-pod chunks of 1024, compactions
# between them)
PERPOD_PODS, PERPOD_KINDS = 4096, 8
PERPOD_CLAIMS = 136
PERPOD_PRICE = 143.0965
PERPOD_DIGEST = "f40733bccab8f8d5e928195a48f32abeb61a6629511dc59ca1190979f9a0f261"
PERPOD_STATS = {"perpod_dispatches": 4, "compactions": 3}
# ... for the consolidation what-ifs (`python tests/test_torch_whatif.py`:
# TPUScheduler.whatif_batch and TPUScheduler.solve(topology=...) on the CPU,
# the JAX package at 05db391): mixed_pods(4096) x make_templates(400)
# provisioned and launched by the consolidation fixture (nodes, bound pods,
# cluster_digest), 64 pending pods, the first 100 candidates; the
# [(feasible, n_new)] list and signals_digest of each batch, and the
# sequential confirm's signal for prefixes 1, 10 and 100
WHATIF_PODS, WHATIF_TYPES, WHATIF_PENDING, WHATIF_CANDS = 4096, 400, 64, 100
WHATIF_CLUSTER = (819, 4096, "6438ce59b952c04d68567d8a2d253c0b80ea14da1e280da08ed309a0cee5e8e1")
WHATIF_GOLDEN = {
    "prefix": ([(True, k) for k in range(1, 101)],
               "6b138f7464188d8b40eccaaa88ef1c30ed8307dbb3808e17314837a35b3f0e4c"),
    "single": ([(True, 1)] * 100, "723e81c45816f47fe3e68d23400bd8458d53012a1798466d590d8529d3c4a7b9"),
}
WHATIF_CONFIRM = {1: (True, 1), 10: (True, 10), 100: (True, 100)}
# ... and each batch's placements_digest: every real scenario's assignment,
# final hostname counts and zone counts by domain name, from the JAX
# package's solve run per scenario on the arguments of the batch's
# solve_whatif call (same source, commit and cluster)
WHATIF_PLACEMENTS = {
    "prefix": "2351f73c1df49678c977ebca9ec586f154ffc3f92d7f51a5cb2d471af7cfb1b1",
    "single": "4774cc66b5f6724686cbcf5aa9627f51a2f49d526f696bfac2374ae868e60213",
}
# ... for the constrained cells (`python tests/test_torch_constrained.py`:
# TPUScheduler on the CPU, the JAX package at 823a69e):
# constrained_4096x400, mixed_pods(4096) and a 64-pod ingress deployment on
# host port 443 over constrained_templates(400) (minValues 2 on names and
# families, reservations on 4 types) with a pool cpu limit of 4150 (75% of
# the 5533 cpu the problem launches without one), max_claims=4096: claims,
# unschedulable pods, $/h (reserved claims at 0) and testing.result_digest
CONSTRAINED_PODS, CONSTRAINED_INGRESS, CONSTRAINED_TYPES = 4096, 64, 400
CONSTRAINED_CPU_LIMIT = 4150.0
CONSTRAINED_GOLDEN = (67, 1504, 35.0462, "95f3dac060101e971bad314654c5ee8566609fa0b929d8bddeb5b26c3532b412")
# hostports_2048x400: mixed_pods(2048) and the ingress deployment over
# make_templates(400), no limit: claims, $/h, result_digest
HOSTPORTS_PODS = 2048
HOSTPORTS_GOLDEN = (410, 43.1019, "e08c63873a86e98b2bdca7c2f9c6eaf72ca07496c25554d2107a43837b23a3a6")
# whatif_constrained_prefix100: mixed_pods(4096) provisioned over
# constrained_templates(400) (no limit) and launched (nodes, bound pods,
# cluster_digest), reservations in use by the nodes launched into them,
# CSI limit 4 on every node with a PVC on every 4th bound and every 8th
# of the 64 pending pods; the prefixes 1..100: signals_digest and the
# placements digest
WHATIF_C_CLUSTER = (819, 4096, "9918ce157b8189ae07de347c45d6b43eaeec20392174f60ec79d7d551fa2699c")
WHATIF_C_GOLDEN = ("6b138f7464188d8b40eccaaa88ef1c30ed8307dbb3808e17314837a35b3f0e4c",
                   "091fe961c67739156a965188628cd7608142f1dd5b2ca8d7c03bdeff6b337d61")
# H100 SXM data-sheet peaks (dense, no sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12  # f32 on the CUDA cores: the rate the scalar work runs at


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = nops / PEAK_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_phase(sched) -> list[dict]:
    """Phase 3: each kernel vs its plain version on seeded inputs at the
    north-star shapes, the catalog tensors being the real encoded ones."""
    import torch

    from karpenter_tpu_torch.ops import kernels, solver
    from karpenter_tpu_torch.ops.encode import ReqSetTensors

    dev = torch.device("cuda")
    it = sched.it_tensors
    T, GR, R = it.alloc.shape
    K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
    W = 4096
    zone_kid, ct_kid = sched.encoder.zone_ct_key_ids()
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand_bool(*shape, p=0.5):
        return (torch.rand(shape, generator=g) < p).to(dev)

    # a window of claim-side requirement sets: identity rows intersected
    # with the catalog's own rows, so masks are realistic and varied
    pick = torch.randint(0, T, (W,), generator=g).to(dev)
    undefine = rand_bool(W, K, p=0.6)
    cat = ReqSetTensors(*(x[pick] for x in it.reqs))
    ident = solver.identity_reqs(W, K, V, dev)
    comb = kernels.select_set(undefine, ident, cat)
    comb = ReqSetTensors(*(x.contiguous() for x in comb))
    results = []

    def record(name, source, replaces, out_k, out_p, ms, plain_ms, b, library_ms=None):
        equal = torch.equal(out_k, out_p)
        err = 0.0 if equal else float((out_k.to(torch.float64) - out_p.to(torch.float64)).abs().max())
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=library_ms, equal=equal,
        ))
        print(f"kernel {name}: equal={equal} (tolerance: exact) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.5f} ({b[1]})", flush=True)

    # H1 req_intersects: [W, K, V] claim sets x [T, K, V] catalog
    out_k = kernels.intersects(comb, it.reqs)
    out_p = kernels.intersects_plain(comb, it.reqs)
    shared = (comb.defined[:, None, :] & it.reqs.defined[None, :, :]).sum().item()
    record(
        "req_intersects", "karpenter_tpu_torch/ops/csrc/req_intersects.cu",
        "karpenter_tpu/ops/kernels.py:54", out_k, out_p,
        time_ms(lambda: kernels.intersects(comb, it.reqs)),
        time_ms(lambda: kernels.intersects_plain(comb, it.reqs), iters=5),
        bound(nbytes(*comb, *it.reqs, out_k), 15.0 * shared),
    )

    # H2 fill_count_grid (max-count mode, the tier-2 caps call)
    used = (torch.rand((W, R), generator=g) * it.alloc[:, 0, :].max(0).values.cpu() * 0.5).to(dev)
    req = (it.alloc[pick[:1], 0, :][0] * 0.03).contiguous()
    viable = rand_bool(W, T, p=0.5)
    out_k = solver.claim_fill_caps(used, viable, req, it, comb.mask, zone_kid, ct_kid)
    out_p = solver.claim_fill_caps_plain(
        used, viable, req, it, solver.off_for_plain(comb.mask, it, zone_kid, ct_kid)
    )
    cells = int(viable.sum().item()) * GR
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    record(
        "fill_count_grid", "karpenter_tpu_torch/ops/csrc/fill_count_grid.cu",
        "karpenter_tpu/ops/solver.py:1355", out_k, out_p,
        time_ms(lambda: solver.claim_fill_caps(used, viable, req, it, comb.mask, zone_kid, ct_kid)),
        time_ms(lambda: solver._claim_fill_caps_from_mask_plain(
            used, viable, req, it, comb.mask, zone_kid, ct_kid), iters=3),
        bound(nbytes(viable, used, req, it.alloc, it.zc_avail, it.group_valid, out_k)
              + W * 2 * Z, cells * (2 * R + 9 * R + Z * C)),
    )
    # its fits-at-count mode, checked too (the same kernel)
    counts = torch.randint(0, 8, (W,), generator=g, dtype=torch.int32).to(dev)
    fk = solver.fits_off_counted(used, counts, req, it, comb.mask, zone_kid, ct_kid)
    fp = solver.fits_off_counted_plain(
        used, counts, req, it, solver.off_for_plain(comb.mask, it, zone_kid, ct_kid)
    )
    if not torch.equal(fk, fp):
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0
    print(f"kernel fill_count_grid (fits mode): equal={torch.equal(fk, fp)}", flush=True)

    # H3 water_fill on the window
    p = torch.randint(0, 40, (W,), generator=g, dtype=torch.int32).to(dev)
    f = torch.randint(0, 6, (W,), generator=g, dtype=torch.int32).to(dev)
    rem = torch.tensor(3000, dtype=torch.int32, device=dev)
    out_k = solver.water_fill(p, f, rem)
    out_p = solver.water_fill_plain(p, f, rem)
    record(
        "water_fill", "karpenter_tpu_torch/ops/csrc/water_fill.cu",
        "karpenter_tpu/ops/solver.py:1402", out_k, out_p,
        time_ms(lambda: solver.water_fill(p, f, rem), iters=50),
        time_ms(lambda: solver.water_fill_plain(p, f, rem), iters=10),
        bound(nbytes(p, f, out_k) + 4, 24.0 * W * 4 + 10.0 * W),
    )
    # any window size: 100k pods without max_claims give W = 131072
    pw = torch.randint(0, 40, (131072,), generator=g, dtype=torch.int32).to(dev)
    fw = torch.randint(0, 6, (131072,), generator=g, dtype=torch.int32).to(dev)
    remw = torch.tensor(200_000, dtype=torch.int32, device=dev)
    eqw = torch.equal(solver.water_fill(pw, fw, remw), solver.water_fill_plain(pw, fw, remw))
    if not eqw:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0
    print(f"kernel water_fill (N=131072): equal={eqw}", flush=True)

    # H4 compact_scatter: compaction of every window field
    NB = W
    alive = rand_bool(W, p=0.5)
    srcs = list(comb) + [
        used, viable, f, alive.clone(), p, torch.arange(W, dtype=torch.int32, device=dev),
        torch.zeros((W, 1), dtype=torch.int32, device=dev), torch.zeros((W, 1), dtype=torch.bool, device=dev),
    ]

    def fresh():
        return [torch.zeros_like(s) for s in srcs]

    dk, dp = fresh(), fresh()
    solver.compact_scatter(0, alive, srcs, dk)
    solver.compact_scatter_plain(0, alive, srcs, dp)
    eq = all(torch.equal(a, b) for a, b in zip(dk, dp))
    moved = int(alive.sum().item())
    row_bytes = sum(s[0].numel() * s.element_size() for s in srcs)
    dk2 = fresh()
    record(
        "compact_scatter", "karpenter_tpu_torch/ops/csrc/compact_scatter.cu",
        "karpenter_tpu/ops/solver.py:843", torch.tensor(eq), torch.tensor(True),
        time_ms(lambda: solver.compact_scatter(0, alive, srcs, dk2)),
        time_ms(lambda: solver.compact_scatter_plain(0, alive, srcs, dk2), iters=5),
        bound(2 * moved * row_bytes + W, 0.0),
    )
    # its drop-scatter mode (bank / global_claims), checked too
    ids = torch.where(alive, torch.randperm(W, generator=g).to(dev).to(torch.int32),
                      torch.full((W,), NB, dtype=torch.int32, device=dev))
    dk, dp = fresh(), fresh()
    solver.compact_scatter(1, ids, srcs, dk)
    solver.compact_scatter_plain(1, ids, srcs, dp)
    eq1 = all(torch.equal(a, b) for a, b in zip(dk, dp))
    if not eq1:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0
    print(f"kernel compact_scatter (drop mode): equal={eq1}", flush=True)
    return results


def kscan_kernel_phase(sched, enc, results: list) -> None:
    """Phase 3b: H4's topology-key mode, H5 and H6 against their plain
    versions at the kind scan's shapes on the mixed_pods path: the real
    encoded catalog of make_templates(400) and its topology tensors (NGv 2,
    NGh 4), a window of W = 4096 claim rows, D = 4 zones; H6 runs one
    segment of 256 pods over seeded counts and domain sets, with open
    rows, fresh rows opening during the segment, and the claim-slot
    capacity running out, and once more with the zone counts past 2^15
    (where the rank key wraps). Exact equality."""
    import torch

    from karpenter_tpu_torch.ops import kernels, solver
    from karpenter_tpu_torch.testing import BIG_COUNT
    from karpenter_tpu_torch.ops.encode import ReqSetTensors

    dev = torch.device("cuda")
    it = sched.it_tensors
    T, GR, R = it.alloc.shape
    K, V = it.reqs.mask.shape[1], it.reqs.mask.shape[2]
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    W = NCAP = 4096
    zone_kid, ct_kid = enc["zone_kid"], enc["ct_kid"]
    D = len(sched.encoder.vocab.values[zone_kid])
    topo = enc["topo_tensors"]
    templates = enc["template_tensors"]
    g = torch.Generator(device="cpu").manual_seed(1)

    def rand_bool(*shape, p=0.5):
        return (torch.rand(shape, generator=g) < p).to(dev)

    def rand_int(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(dev)

    def mode_line(label, ms, plain_ms, b):
        print(f"kernel {label}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b[0]:.5f} ({b[1]})", flush=True)

    def entry(name, source, replaces, equal, ms, plain_ms, b):
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=0,
            max_abs_err=0.0 if equal else 1.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=None, equal=equal,
        ))
        print(f"kernel {name}: equal={equal} (tolerance: exact) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.5f} ({b[1]})", flush=True)

    pick = torch.randint(0, T, (W,), generator=g).to(dev)
    cat = ReqSetTensors(*(x[pick] for x in it.reqs))
    comb = kernels.select_set(rand_bool(W, K, p=0.6), solver.identity_reqs(W, K, V, dev), cat)
    comb = ReqSetTensors(*(x.contiguous() for x in comb))

    # H4 in its topology-key mode: the bank scatter of compact_state
    tk = tuple(enc["topo_kids"])
    ids = torch.where(rand_bool(W, p=0.5), torch.randperm(W, generator=g).to(dev).to(torch.int32),
                      torch.full((W,), NCAP, dtype=torch.int32, device=dev))
    used = (torch.rand((W, R), generator=g) * it.alloc[:, 0, :].max(0).values.cpu() * 0.5).to(dev)
    srcs = [rand_bool(W), rand_int(0, 3, W), rand_bool(W, T), used]
    tk_srcs = [comb.mask, comb.inf, comb.defined]

    def fresh():
        return ([torch.zeros_like(s) for s in srcs],
                [torch.zeros((W, len(tk)) + tuple(s.shape[2:]), dtype=s.dtype, device=dev) for s in tk_srcs])

    (dk, tdk), (dp, tdp) = fresh(), fresh()
    solver.compact_scatter(1, ids, srcs, dk, tk, tk_srcs, tdk)
    solver.compact_scatter_plain(1, ids, srcs, dp, tk, tk_srcs, tdp)
    eq_tk = all(torch.equal(a, b) for a, b in zip(dk + tdk, dp + tdp))
    print(f"kernel compact_scatter (topology-key mode, tk={tk}): equal={eq_tk}", flush=True)
    h4 = next(r for r in results if r["name"] == "compact_scatter")
    if not eq_tk:
        h4["equal"], h4["max_abs_err"] = False, 1.0
    moved = int(((ids >= 0) & (ids < NCAP)).sum().item())
    row_bytes = sum(d[0].numel() * d.element_size() for d in dk + tdk)
    mode_line(
        "compact_scatter (topology-key mode)",
        time_ms(lambda: solver.compact_scatter(1, ids, srcs, dk, tk, tk_srcs, tdk)),
        time_ms(lambda: solver.compact_scatter_plain(1, ids, srcs, dp, tk, tk_srcs, tdp), iters=5),
        bound(2 * moved * row_bytes + nbytes(ids), 0.0),
    )

    # H5 kscan_grid: grid + capd, capd from a reused grid, fits-final
    req = enc["kinds"]["requests"][1].contiguous()
    viable = rand_bool(W, T, p=0.6)
    grid_k, capd_k = solver.kscan_grid(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D)
    grid_p, capd_p = solver._kscan_grid_plain(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D)
    eq5 = torch.equal(grid_k, grid_p) and torch.equal(capd_k, capd_p)
    debited = torch.clamp(grid_p - rand_int(0, 3, W, 1, 1), min=0).contiguous()
    _, capd_rk = solver.kscan_grid(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D, debited)
    _, capd_rp = solver._kscan_grid_plain(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D, debited)
    eq5r = torch.equal(capd_rk, capd_rp)
    placed = rand_int(0, 6, W)
    zset = rand_bool(W, D, p=0.5)
    ct_m, z_m = comb.mask[:, ct_kid, :].contiguous(), comb.mask[:, zone_kid, :].contiguous()
    fits_k = solver.kscan_fits_final(grid_p, placed, zset, ct_m, z_m, it, zone_kid, zone_kid, D)
    fits_p = solver.kscan_fits_final_plain(grid_p, placed, zset, ct_m, z_m, it, zone_kid, zone_kid, D)
    eq5f = torch.equal(fits_k, fits_p)
    print(f"kernel kscan_grid: grid+capd equal={eq5}, capd of a reused grid equal={eq5r}, "
          f"fits-final equal={eq5f}", flush=True)
    cells = W * T * GR
    mode_line(
        "kscan_grid (capd of a reused grid)",
        time_ms(lambda: solver.kscan_grid(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D, debited)),
        time_ms(lambda: solver._kscan_grid_plain(
            used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D, debited), iters=3),
        bound(nbytes(debited, viable, it.zc_avail, capd_p) + W * V, cells * D * C),
    )
    mode_line(
        "kscan_grid (fits-final)",
        time_ms(lambda: solver.kscan_fits_final(grid_p, placed, zset, ct_m, z_m, it, zone_kid, zone_kid, D)),
        time_ms(lambda: solver.kscan_fits_final_plain(
            grid_p, placed, zset, ct_m, z_m, it, zone_kid, zone_kid, D), iters=3),
        bound(nbytes(grid_p, placed, zset, ct_m, it.zc_avail, fits_p), cells * (1 + Z * C)),
    )
    entry(
        "kscan_grid", "karpenter_tpu_torch/ops/csrc/kscan_grid.cu", "karpenter_tpu/ops/solver.py:2751",
        eq5 and eq5r and eq5f,
        time_ms(lambda: solver.kscan_grid(used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D)),
        time_ms(lambda: solver._kscan_grid_plain(
            used, req, it, viable, comb.mask, zone_kid, ct_kid, zone_kid, D), iters=3),
        # reads: usage, viable mask, the rows' zone / capacity-type rows and
        # the catalog; writes: the grid and capd. Operations: the count of
        # count_cell.cuh per cell (R subtract+divide, three R-wide fma
        # checks) and the D x C per-zone offering test.
        bound(nbytes(used, req, viable, it.alloc, it.zc_avail, it.group_valid, grid_p, capd_p)
              + W * 2 * V, cells * (2 * R + 9 * R + D * C)),
    )

    # H6 kscan_pod_loop: one segment of 256 pods
    E, G = enc["E"], templates.its.shape[0]
    NGv, NGh = topo.vg_type.shape[0], topo.hg_type.shape[0]
    S = topo.hg_counts0.shape[1]
    count = maxc = 256
    w_open0, n_open0 = 3800, NCAP - 30  # 30 claim slots left
    ar = torch.arange(W, device=dev)
    slot_of = torch.where(ar < w_open0, ar + n_open0 - w_open0, torch.full_like(ar, NCAP)).to(torch.int32)
    checks = []
    times = []
    for variant, grp, big in (("zone spread", 0, 0), ("zone affinity", 1, 0),
                              ("zone spread, counts past 2^15", 0, BIG_COUNT)):
        one = torch.zeros(NGv, dtype=torch.bool, device=dev)
        one[grp] = True
        inp = solver.PodLoopIn(
            cap_e=rand_int(0, 4, E), zie0=rand_bool(E, p=0.2), open0=(ar < w_open0) & rand_bool(W, p=0.95),
            static_n0=rand_bool(W, p=0.01), pods0=rand_int(0, 30, W), zin0=rand_bool(W, p=0.1),
            static_g=torch.ones(G, dtype=torch.bool, device=dev), capd_g=rand_int(1, 6, G, D),
            z0_g=rand_bool(G, D, p=0.95), zinf_g=rand_bool(G, p=0.2),
            w_open0=torch.tensor(w_open0, dtype=torch.int32, device=dev),
            self_conf=torch.tensor(False, device=dev), key_touched=torch.tensor(True, device=dev),
            gate=one & topo.vg_valid, recs=one & topo.vg_valid, vg_self=one.clone(),
            pd=rand_bool(D, p=0.8), hg_applies=rand_bool(NGh, p=0.5), hg_records=rand_bool(NGh, p=0.5),
            hg_self=rand_bool(NGh, p=0.5),
        )
        carry0 = solver.PodLoopCarry(
            zn=rand_bool(W, D, p=0.6), ze=rand_bool(E, D, p=0.6), capd=rand_int(0, 4, W, D),
            pl_n=torch.zeros(W, dtype=torch.int32, device=dev),
            pl_e=torch.zeros(E, dtype=torch.int32, device=dev),
            tmpl_n=torch.zeros(W, dtype=torch.int32, device=dev), cnt=rand_int(2, 4, NGv, D) + big,
            # hostname counts on the slots in use; the fresh slots are empty
            hgc=((torch.rand((NGh, S), generator=g) < 0.05) & (torch.arange(S) < E + n_open0))
            .to(torch.int32).to(dev),
            n_open=torch.tensor(n_open0, dtype=torch.int32, device=dev),
            w_open=torch.tensor(w_open0, dtype=torch.int32, device=dev), slot_of=slot_of.clone(),
            spills=torch.tensor(0, dtype=torch.int32, device=dev),
        )

        def clone(c):
            return solver.PodLoopCarry(*(x.clone() for x in c))

        ck, cp = clone(carry0), clone(carry0)
        ak = solver.kscan_pod_loop(inp, ck, topo, templates, count, maxc, NCAP)
        ap = solver.kscan_pod_loop_plain(inp, cp, topo, templates, count, maxc, NCAP)
        eq = torch.equal(ak, ap) and all(torch.equal(a, b) for a, b in zip(ck, cp))
        hist = {k: int(v) for k, v in (
            ("existing", ((ak >= 0) & (ak < E)).sum()), ("claims", (ak >= E).sum()),
            ("no_room", (ak == solver.NO_ROOM).sum()), ("no_claim", (ak == solver.NO_CLAIM).sum()),
            ("opened", ck.n_open - n_open0))}
        print(f"kernel kscan_pod_loop ({variant}): equal={eq} {json.dumps(hist)}", flush=True)
        checks.append(eq)
        if big:
            continue
        # time the launch alone (the carry reset between launches is outside the events)
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(10)]
        for a, b in ev:
            c = clone(carry0)
            torch.cuda.synchronize()
            a.record()
            solver.kscan_pod_loop(inp, c, topo, templates, count, maxc, NCAP)
            b.record()
        torch.cuda.synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in ev) / len(ev))
    plain_ms = time_ms(lambda: solver.kscan_pod_loop_plain(
        inp, clone(carry0), topo, templates, count, maxc, NCAP), iters=2, warmup=1)
    # per pod, one pass over the candidate rows: domain bits, capacity row,
    # placed / pods / slot counters and the hostname counts at each slot;
    # operations: the NGv x D group terms per candidate
    rows = E + W + G
    row_bytes = (E * (D + 8) + W * (5 * D + 14) + G * (5 * D + 2)) + NGh * rows * 4
    entry(
        "kscan_pod_loop", "karpenter_tpu_torch/ops/csrc/kscan_pod_loop.cu",
        "karpenter_tpu/ops/solver.py:3093", all(checks), sum(times) / len(times), plain_ms,
        bound(count * row_bytes, count * rows * NGv * D * 4.0),
    )


def launch_ms(run_once, setups: list) -> float:
    """Mean device time of one launch: CUDA events around `run_once(x)`
    alone for each prepared input x (its set-up outside the events)."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in setups]
    torch.cuda.synchronize()
    for x, (a, b) in zip(setups, ev):
        a.record()
        run_once(x)
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / len(ev)


def perpod_kernel_phase(sched, enc, results: list, first: int = 1024, n: int = 256,
                        cell: str = "perpod_4096x400") -> dict:
    """Phase 3c: the per-pod kernel against the plain loop on a per-pod
    cell's real encoded problem (its minValues and reservation flags on
    when the cell carries them). A first chunk of 1024 pods through the
    kernel opens claims (and takes reservations and budget); from that
    state, one step, 8 steps (one launch each, `perpod_steps`) and the
    256-pod chunk through the kernel against the same steps through the
    plain step: the assignment and every carry leaf equal (reservation
    capacities and held rows included). Times: one launch of the 256-step
    chunk (device events), per step, beside its bound averaged over the
    same 256 steps. Appends the kernel's entry to `results` (None: returns
    it as "entry" only); returns the chunk's launch inputs, as
    perpod_step_bounds reads them."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import cuda as kc
    from karpenter_tpu_torch.ops import solver

    n_claims = enc["n_claims"]
    tm = enc["template_tensors"]
    common = (enc["exist_tensors"], sched.it_tensors, tm, sched.well_known, enc["topo_tensors"])
    keys_args = (enc["zone_kid"], enc["ct_kid"], n_claims, tuple(enc["topo_kids"]))
    flags = sched._flags()
    ctx = solver.PerPodCtx(*common, *keys_args, kc.perpod_tables(sched.it_tensors, tm.its, tm.mv_it_values), flags)
    kind_of = enc["kind_of"]

    def rows(lo, hi):
        *r, pt = sched._gather_pod_chunk(enc, np.asarray(kind_of[lo:hi], dtype=np.int64), hi - lo)
        return r, pt

    def run(state, lo, hi, plain):
        r, pt = rows(lo, hi)
        return solver.solve_from(state, *r, *common, pt, *keys_args, plain=plain, flags=flags)

    def same(a, b):
        fa, fb = solver.to_numpy(a), solver.to_numpy(b)
        return all(np.array_equal(fa[k], fb[k]) for k in fa)

    state0 = solver.initial_state(
        enc["exist_tensors"], sched.it_tensors, tm, enc["topo_tensors"], n_claims,
        enc["n_ports"], enc["res_cap0"], window=n_claims, topo_kids=enc["topo_kids"],
    )
    state1, _a = run(state0, 0, first, False)
    torch.cuda.synchronize()
    r, pt = rows(first, first + n)
    xs = solver.pod_xs(*r, pt)
    checks = {}
    for steps in (1, 8):
        sk, ak = solver.perpod_steps(state1, xs, ctx, 0, steps)
        sp, ap = solver.perpod_loop_plain(state1, solver._take_x(xs, slice(0, steps)), ctx)
        checks[f"{steps} step(s)"] = torch.equal(ak, ap) and same(sk, sp)
    sk, ak = run(state1, first, first + n, False)
    t0 = time.perf_counter()
    sp, ap = run(state1, first, first + n, True)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / n
    checks[f"{n}-pod chunk"] = torch.equal(ak, ap) and same(sk, sp)
    E = enc["E"]
    hist = {"claims": int((ak >= E).sum()), "existing": int(((ak >= 0) & (ak < E)).sum()),
            "failed": int((ak < 0).sum()), "open_before": int(state1.n_open), "open_after": int(sk.n_open),
            "flags": {k: int(v) for k, v in flags._asdict().items()},
            "res_cap_before": state1.res_cap.tolist(), "res_cap_after": sk.res_cap.tolist(),
            "held_rows": int(sk.held.any(-1).sum())}
    print(f"kernel perpod_scan_persistent (one block, {cell}): from the state after {first} pods, kernel == "
          f"plain: {json.dumps(checks)} {json.dumps(hist)}", flush=True)

    # one launch of the n-step chunk, on private copies made outside the events
    copies = [solver.own_perpod_writes(state1) for _ in range(5)]
    ms = launch_ms(lambda c: kc.perpod_steps(c, xs, ctx, 0, n), copies) / n
    chunk = dict(state0=state1, xs=xs, ctx=ctx, assignment=ak[None])
    b, live = perpod_step_bounds([chunk])
    ok = all(checks.values())
    print(f"kernel perpod_scan_persistent ({cell}): {ms:.5f} ms per step ({n} steps in one launch), plain "
          f"{plain_step_ms:.4f} ms per step, bound {b[0]:.7f} ms per step ({b[1]}) {json.dumps(live)}", flush=True)
    entry = dict(
        name="perpod_scan_persistent", route="cuda", source="karpenter_tpu_torch/ops/csrc/perpod_scan.cu",
        replaces="karpenter_tpu/ops/solver.py:315", launches=0, max_abs_err=0.0 if ok else 1.0,
        ms=ms, plain_ms=plain_step_ms, bound_ms=b[0], bound_by=b[1], library_ms=None, equal=ok,
    )
    if results is not None:
        results.append(entry)
    chunk["entry"] = entry
    return chunk


def scalar_tests(st, xs, ctx, rows, valid, ev, amax):
    """The per-pod kernel's scalar tests (row_cheap) of one step, from the
    carry before it, for S scenarios at once: st's written fields carry a
    leading [S] axis, rows [S] are the steps' pod rows, valid [S], ev [S, E]
    the surviving nodes, amax [T, R] each type's most allocatable over its
    valid groups. Returns (pass1 [S, E], pass2 [S, W], pass3 [S, G],
    gate1 [S, E], gate3 [S, G], the hostname groups that apply [S],
    whether the pod has volumes [S]); gate: the row's live test alone."""
    import torch

    exist, tm, tt = ctx.exist, ctx.templates, ctx.topo
    E = exist.avail.shape[0]
    req = xs.requests[rows]  # [S, R]
    conf = xs.port_conf[rows]
    hgate = xs.hg_applies[rows] & tt.hg_valid  # [S, NGh]
    hself = xs.hg_self[rows].to(torch.int32)
    nonempty = tt.hg_extra_nonempty | (st.hg_counts > 0).any(-1)  # [S, NGh]

    def fits(used, cap):
        t = used + req[:, None, :]
        return ((t <= cap) | (t == 0)).all(-1)

    def hostname_ok(counts):  # counts [S, NGh, n] at each row's slot
        ht = tt.hg_type[None, :, None]
        ok = torch.where(ht == 0, counts + hself[..., None] <= tt.hg_skew[None, :, None],
                         torch.where(ht == 1, (counts > 0) | ((hself[..., None] > 0) & ~nonempty[..., None]),
                                     counts == 0))
        return (ok | ~hgate[..., None]).all(1)

    def ports_free(used_ports):
        return ((conf[:, None, :] & used_ports) == 0).all(-1)

    def popcount(x):
        x = x.to(torch.int64) & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return ((x * 0x01010101) & 0xFFFFFFFF) >> 24

    vols = xs.vols[rows]  # [S, NVp]
    has_vols = (vols != 0).any(-1)
    gate1 = ev & xs.exist_ok[rows] & valid[:, None]
    held = (st.exist_vols | vols[:, None, :])[:, :, None, :] & exist.vol_driver[None, None]  # [S, E, ND, NVp]
    vol_ok = ((popcount(held).sum(-1) <= exist.vol_limits[None]).all(-1)) | ~has_vols[:, None]
    pass1 = (gate1 & fits(st.exist_used, exist.avail[None]) & ports_free(st.exist_ports) & vol_ok
             & hostname_ok(st.hg_counts[:, :, :E]))
    W = int(st.w_open.max()) if st.w_open.numel() else 0
    W = min(W, st.open.shape[1])
    its = st.its[:, :W]  # [S, W, T]
    row_max = torch.where(its[..., None], amax[None, None], torch.tensor(float("-inf"), device=its.device)).amax(2)
    slot2 = (E + st.slot_of[:, :W].long()).clamp(max=st.hg_counts.shape[2] - 1)
    counts2 = st.hg_counts.gather(2, slot2[:, None, :].expand(-1, st.hg_counts.shape[1], -1))
    tok = xs.tmpl_ok[rows]  # [S, G]
    pass2 = (st.open[:, :W] & (torch.arange(W, device=its.device)[None] < st.w_open[:, None]) & valid[:, None]
             & fits(st.used[:, :W], row_max) & ports_free(st.claim_ports[:, :W])
             & tok.gather(1, st.template[:, :W].long().clamp(min=0)) & hostname_ok(counts2))
    gate3 = tm.valid[None] & tok & (st.nodes_budget >= 1.0) & valid[:, None]
    slot3 = (E + st.n_open.long()).clamp(max=st.hg_counts.shape[2] - 1)
    counts3 = st.hg_counts.gather(2, slot3[:, None, None].expand(-1, st.hg_counts.shape[1], 1))
    pass3 = gate3 & hostname_ok(counts3)
    return pass1, pass2, pass3, gate1, gate3, hgate.sum(-1), has_vols


def perpod_step_bounds(chunks: list) -> tuple:
    """The per-pod kernel's bound per step: the bytes one launch must move,
    over the memory rate, divided by its steps, from this run's data,
    summed over `chunks` (each one launch: its inputs xs / ctx, the carry
    before it `state0`, its assignment [S, n] and, in scenario mode, a
    stacked state0 and pod_idx / valid / exist_valid). The launch is
    replayed one step at a time (a launch of the same kernel per step) so
    that each step's tests read the carry that step saw. Counted: once per
    launch the type and group tables (under the minValues or reservation
    flags also every type's min-keyed value words and reserved-offering
    bits); per step the assignment; per real
    step the pod's rows, its gate rows and the vocab-key counts, and for
    each tier the step reaches (tier 2 when no existing node takes the
    pod, tier 3 when no claim does either: the kernel's order, which the
    pick makes exact; tiers 1 and 3 only up to the chosen row, since the
    least feasible index decides) each candidate row's live flag; a live
    row's scalar tests (free resources or a claim's resource ceilings,
    ports, volumes, the hostname counts of the groups that apply); and
    only for a row that passes them its requirement row and, for claims
    and templates, its viable-type row, and under the flags its
    template's floors and (claims) its held row; per placed pod the
    winner's rows and counts written. Returns (bound, row stats per
    step)."""
    import torch

    from karpenter_tpu_torch.ops import cuda as kc
    from karpenter_tpu_torch.ops import solver

    total_bytes, steps = 0, 0
    stats = dict(steps=0, real_steps=0, rows_reached=0, rows_tested=0, rows_full=0, tier2_full=0)
    for ch in chunks:
        xs, ctx, want = ch["xs"], ch["ctx"], ch["assignment"]
        it, tm, tt, exist = ctx.it, ctx.templates, ctx.topo, ctx.exist
        scen = "pod_idx" in ch
        S, n = want.shape
        dev = want.device
        E, G = exist.avail.shape[0], tm.its.shape[0]
        T, K, V = it.reqs.mask.shape
        R = it.alloc.shape[2]
        NGv, NGh = tt.vg_type.shape[0], tt.hg_type.shape[0]
        NPp, NVp, ND = xs.port_conf.shape[1], xs.vols.shape[1], exist.vol_limits.shape[1]
        idx = ch["pod_idx"].long() if scen else torch.arange(n, device=dev)[None]
        ev = ch["exist_valid"] if scen else exist.valid[None]
        valid = (ch["valid"] if scen else xs.valid[None]) & (idx >= 0)
        amax = torch.where(it.group_valid[..., None], it.alloc, torch.tensor(float("-inf"), device=dev)).amax(1)
        run = solver.own_perpod_writes(ch["state0"])
        got = torch.full((S, n), -1, dtype=torch.int32, device=dev)
        req_row = K * V + 11 * K
        pod_row = req_row + K * V + 4 * R + T + G + E + 4 + 3 * (NGv + NGh)
        # under the flags the type tables gain the slab words and reserved
        # bits (read once per launch, like the others); a fully read row
        # reads its template's floors and (claims) its held row
        RID, RZ = it.res_ofs.shape[1], it.res_ofs.shape[2]
        mv_on, res_on = int(ctx.flags.mv_active), int(ctx.flags.res_active)
        full_row = mv_on * 8 * tm.mv_key.shape[1]
        held_row = res_on * RID
        tables = (nbytes(*it.reqs, it.alloc, it.group_valid, it.zc_avail, it.cap, tm.its, tt.vg_domains, tt.vg_rank)
                  + mv_on * T * 4 * tm.mv_it_values.shape[1] * -(-V // 32) + res_on * T * 4 * -(-(RID * RZ) // 32))
        total_bytes += tables + S * n * 5
        acc = torch.zeros(7, dtype=torch.int64, device=dev)
        for i in range(n):
            # a single-scenario carry's written fields gain the [1] axis (views)
            st = run if scen else run._replace(**{
                f: type(v)(*(t[None] for t in v)) if isinstance(v, tuple) else v[None]
                for f, v in ((f, getattr(run, f)) for f in solver.PERPOD_WRITES)})
            w_open0, n_open0 = st.w_open.long(), st.n_open.long()
            p1, p2, p3, g1, g3, n_hg, has_vols = scalar_tests(st, xs, ctx, idx[:, i], valid[:, i], ev, amax)
            if scen:
                kc.perpod_whatif_steps(run, xs, ctx, ch["pod_idx"], ch["valid"], ev, i, i + 1, got)
            else:
                kc.perpod_steps(run, xs, ctx, i, i + 1, got[0])
            a = got[:, i].long()
            v = valid[:, i]
            on_node = v & (a >= 0) & (a < E)
            opened = v & (a - E >= n_open0)
            reach2 = v & ~on_node
            reach3 = v & ((a < 0) | opened)
            # tier 1 up to the chosen node, tier 3 up to the chosen template
            cut1 = torch.where(on_node, a, torch.full_like(a, E - 1))
            upto1 = torch.arange(E, device=dev)[None] <= cut1[:, None]
            tmpl_after = st.template.gather(1, w_open0.clamp(max=st.template.shape[1] - 1)[:, None])[:, 0]
            cut3 = torch.where(opened, tmpl_after.long(), torch.full_like(a, G - 1))
            upto3 = (torch.arange(G, device=dev)[None] <= cut3[:, None]) & reach3[:, None]
            Wn = p2.shape[1]
            rows2 = (torch.arange(Wn, device=dev)[None] < w_open0[:, None]) & reach2[:, None]
            t1, f1 = (g1 & upto1 & v[:, None]), (p1 & upto1 & v[:, None])
            t2, f2 = rows2, p2 & rows2
            t3, f3 = (g3 & upto3), (p3 & upto3)
            cheap1 = 8 * R + 4 * NPp + 4 * n_hg + has_vols * (4 * NVp + 4 * ND)
            cheap2 = 9 + 8 * R + 4 * NPp + 4 * n_hg
            placed = v & (a >= 0)
            step_bytes = (
                v * (pod_row + 4 * NGv * V)
                + (upto1 & v[:, None]).sum(1) + t1.sum(1) * cheap1 + f1.sum(1) * req_row
                + t2.sum(1) * cheap2 + f2.sum(1) * (req_row + T + full_row + held_row)
                + upto3.sum(1) * 5 + reach3 * 4 * n_hg + f3.sum(1) * (req_row + 8 * R + T + full_row)
                + placed * (req_row + 4 * R + T + 8 * NGv * V + 8 * NGh + held_row)
            )
            # the winner passed its scalar tests (a check of this replica of them)
            found = reach2 & (a >= E) & ~opened
            won2 = (st.slot_of[:, :Wn].long() == (a - E)[:, None]) & rows2
            wrong = ((on_node & ~p1.gather(1, a.clamp(0, E - 1)[:, None])[:, 0]) | (found & ~(p2 & won2).any(1))
                     | (opened & ~p3.gather(1, cut3.clamp(0, G - 1)[:, None])[:, 0]))
            acc += torch.stack([step_bytes.sum(), (upto1 & v[:, None]).sum() + rows2.sum() + upto3.sum(),
                                t1.sum() + t2.sum() + t3.sum(), f1.sum() + f2.sum() + f3.sum(), f2.sum(), v.sum(),
                                wrong.sum()])
        acc = acc.tolist()
        if acc[6]:
            raise RuntimeError(f"perpod_step_bounds: {acc[6]} winners fail the replica of the scalar tests")
        total_bytes += acc[0]
        for k, x in zip(("rows_reached", "rows_tested", "rows_full", "tier2_full", "real_steps"), acc[1:]):
            stats[k] += x
        if not torch.equal(got, want):
            raise RuntimeError("perpod_step_bounds: the step-by-step replay differs from the timed launch")
        steps += n
        stats["steps"] += n
    per = {k + "_per_step": stats[k] / max(stats["steps"], 1)
           for k in ("rows_reached", "rows_tested", "rows_full", "tier2_full")}
    return bound(total_bytes / max(steps, 1), 0.0), {**stats, **per}


def whatif_kernel_phase(cell, results: list) -> tuple:
    """Phase 3d: the per-pod kernel in scenario mode against the plain
    per-scenario loop, on a what-if prefix cell's encode (S = 128
    scenarios, each its own pods, surviving nodes and topology seeds; the
    constrained cell's with its flags, reservation capacities, CSI limits
    and PVCs): one step of all 128 scenarios in one launch, and 4
    scenarios (the largest prefix among them) run to the end, assignments
    and every carry leaf equal (reservation capacities and held rows
    included). Times: one launch of the whole batch (every step of all
    scenarios), per step, beside its bound averaged over the same steps.
    Appends the kernel's entry to `results` (None: not appended). Returns
    (the plain sub-batch's wall in s, the batch's launch inputs with the
    entry)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import cuda as kc
    from karpenter_tpu_torch.ops import solver

    sched, pods, specs = cell["sched"], *cell["batches"]["prefix"]
    args, kwargs = sched._whatif_inputs(pods, [n.clone() for n in cell["cluster"].nodes], None, specs,
                                        cell["factory"], **cell.get("kw", {}))
    idx, active, _count, ev, vg0, hg0, pt, tol, it_allow, exist_ok, ports, conf, vols, exist, it, tm, wk, tt, ptopo = args[:19]
    zone_kid, ct_kid, n_claims = args[19:]
    topo_kids = tuple(kwargs["topo_kids"])
    flags = kwargs["flags"]
    S, L = idx.shape
    xs = solver.pod_xs(pt, tol, it_allow, exist_ok, ports, conf, vols, ptopo)
    ctx = solver.PerPodCtx(exist, it, tm, wk, tt, zone_kid, ct_kid, n_claims, topo_kids, kwargs["tables"], flags)
    st0 = solver.initial_state(exist, it, tm, tt, n_claims, ports.shape[1], kwargs["res_cap0"], topo_kids=topo_kids)
    valid = (pt.valid[idx.long()] & active).contiguous()
    idx_h = idx.cpu().numpy()

    def same(a, b):
        fa, fb = solver.to_numpy(a), solver.to_numpy(b)
        return all(np.array_equal(fa[k], fb[k]) for k in fa)

    # one step of every scenario in one launch
    k_state = solver.stack_scenarios(st0, S, vg0, hg0)
    a_k = kc.perpod_whatif_steps(k_state, xs, ctx, idx, valid, ev, 0, 1)[:, 0]
    eq1 = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(S):
        c = ctx._replace(exist=exist._replace(valid=ev[s]), topo=tt._replace(vg_counts0=vg0[s], hg_counts0=hg0[s]))
        x = solver._take_x(xs, int(idx_h[s, 0]))._replace(valid=valid[s, 0])
        sp, ap = solver._pod_step(st0._replace(vg_counts=vg0[s], hg_counts=hg0[s]), x, c)
        eq1 = eq1 and int(ap) == int(a_k[s]) and same(solver.scenario_state(k_state, s), sp)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    # 4 scenarios to the end, the largest prefix among them
    n_real = len(specs)
    pick = torch.tensor([0, n_real // 3, 2 * n_real // 3, n_real - 1], device=idx.device)
    sub = (*(a[pick] for a in args[:6]), *args[6:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = solver.solve_whatif_full(*sub, topo_kids=topo_kids, res_cap0=kwargs["res_cap0"], flags=flags)
    torch.cuda.synchronize()
    kernel_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p = solver.solve_whatif_full(*sub, topo_kids=topo_kids, plain=True, res_cap0=kwargs["res_cap0"], flags=flags)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    eq_sub = (all(torch.equal(a, b) for a, b in zip(out_k[:3], out_p[:3]))
              and all(same(a, b) for a, b in zip(out_k[3], out_p[3])))
    hist = {"S": S, "L": L, "E": int(exist.avail.shape[0]), "W": n_claims,
            "sub_n_open": out_k[1].tolist(), "sub_n_unsched": out_k[0].tolist(),
            "sub_placed": int((out_k[2] >= 0).sum()), "kernel_wall_s": round(kernel_wall, 4),
            "flags": {k: int(v) for k, v in flags._asdict().items()},
            "sub_res_cap": [st.res_cap.tolist() for st in out_k[3]],
            "sub_held_rows": [int(st.held.any(-1).sum()) for st in out_k[3]]}
    label = cell.get("label", "whatif_prefix100")
    print(f"kernel perpod_scan_persistent (scenario mode, {label}): one step of {S} scenarios == plain: {eq1}; "
          f"4 scenarios x {L} steps == plain: {eq_sub} {json.dumps(hist)}", flush=True)

    # one launch of the whole batch on private copies made outside the events
    copies = [solver.stack_scenarios(st0, S, vg0, hg0) for _ in range(3)]
    outs = []
    ms = launch_ms(lambda c: outs.append(kc.perpod_whatif(c, xs, ctx, idx, valid, ev)), copies) / L
    batch = dict(state0=solver.stack_scenarios(st0, S, vg0, hg0), xs=xs, ctx=ctx, assignment=outs[0], pod_idx=idx,
                 valid=valid, exist_valid=ev)
    b, live = perpod_step_bounds([batch])
    ok = eq1 and eq_sub
    print(f"kernel perpod_scan_persistent (scenario mode, {label}): {ms:.5f} ms per step ({L} steps of {S} "
          f"scenarios in one launch), plain {plain_step_ms:.4f} ms per step (all {S} scenarios), bound "
          f"{b[0]:.7f} ms per step ({b[1]}) {json.dumps(live)}", flush=True)
    entry = dict(
        name="perpod_scan_persistent_whatif", route="cuda", source="karpenter_tpu_torch/ops/csrc/perpod_scan.cu",
        replaces="karpenter_tpu/ops/solver.py:1120", launches=0, max_abs_err=0.0 if ok else 1.0,
        ms=ms, plain_ms=plain_step_ms, bound_ms=b[0], bound_by=b[1], library_ms=None, equal=ok,
    )
    if results is not None:
        results.append(entry)
    batch["entry"] = entry
    return plain_wall, batch


def whatif_cell(torch, T, templates) -> dict:
    """The consolidation cells' problem on the card: mixed_pods(4096)
    provisioned by a TorchScheduler solve and launched (held to the JAX
    package's cluster), 64 pending pods, the cheapest candidates, the
    topology factory, and multi-node (prefix) and single-node batches."""
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    t0 = time.perf_counter()
    cl = T.bound_cluster(T.mixed_pods(WHATIF_PODS), templates)
    torch.cuda.synchronize()
    got = (len(cl.nodes), sum(len(v) for v in cl.bound.values()), T.cluster_digest(cl))
    print(f"whatif cluster: {got[0]} nodes, {got[1]} bound pods, digest {got[2][:16]}..., "
          f"provisioned on the card in {time.perf_counter() - t0:.3f}s", flush=True)
    if got != WHATIF_CLUSTER:
        raise RuntimeError(f"whatif cluster {got} differs from the JAX package's {WHATIF_CLUSTER}")
    cands = T.candidates(cl)
    pending = T.pending_pods(WHATIF_PENDING)
    batches = {kind: getattr(T, f"{kind}_scenarios")(cands, WHATIF_CANDS, pending) for kind in ("prefix", "single")}
    golden = {kind: (*WHATIF_GOLDEN[kind], WHATIF_PLACEMENTS[kind]) for kind in ("prefix", "single")}
    return dict(cluster=cl, cands=cands, pending=pending, factory=T.topology_factory(cl), batches=batches,
                sched=TorchScheduler(templates), templates=templates, golden=golden)


def whatif_path(torch, cuda, T, cell, kind: str) -> dict:
    """Drive one what-if batch: launch counts zeroed just before a cold
    whatif_batch and read just after, the signals held to the JAX
    package's (cell["golden"][kind]: the signals or None, their digest, the
    placements digest), two warm calls that must agree. Returns the
    launches or raises RuntimeError."""
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler

    sched = TorchScheduler(cell["templates"])
    pods, specs = cell["batches"][kind]
    kw = cell.get("kw", {})

    def run():
        t0 = time.perf_counter()
        sig = sched.whatif_batch(pods, [n.clone() for n in cell["cluster"].nodes], None, specs, cell["factory"],
                                 **kw)
        torch.cuda.synchronize()
        return sig, time.perf_counter() - t0

    label = cell.get("label", f"whatif_{kind}{WHATIF_CANDS}")
    cuda.reset_launches()
    sig, wall = run()
    launches = dict(cuda.LAUNCHES)
    print(f"{label} cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} stats={json.dumps(sched.last_stats)} "
          f"launches={json.dumps(launches)}", flush=True)
    want, want_digest, want_placements = cell["golden"][kind]
    digest_ = T.signals_digest(sig) if sig is not None else None
    print(f"{label} signals: digest {digest_} (JAX {want_digest}); feasible {sum(f for f, _n in sig or ())}"
          f"/{len(sig or ())}, new claims {sum(n for _f, n in sig or ())}", flush=True)
    if (want is not None and sig != want) or digest_ != want_digest:
        raise RuntimeError(f"{label}: signals differ from the JAX package's")
    # what the placements decide, held to the JAX package's: the batch's
    # solve_whatif on the same inputs, run again for every scenario's
    # assignment and final hostname counts, and its zone counts by domain
    from karpenter_tpu_torch.ops import solver

    args, kwargs = sched._whatif_inputs(pods, [n.clone() for n in cell["cluster"].nodes], None, specs,
                                        cell["factory"], **kw)
    _unsched, _open, assignment, states = solver.solve_whatif_full(*args, **kwargs)
    n = len(specs)
    placements = T.placements_digest(
        assignment[:n].cpu().numpy(), torch.stack([st.vg_counts for st in states[:n]]).cpu().numpy(),
        torch.stack([st.hg_counts for st in states[:n]]).cpu().numpy(), args[17].vg_key.cpu().numpy(),
        sched.encoder.vocab,
    )
    print(f"{label} placements: digest {placements} (JAX {want_placements}); "
          f"{int((assignment[:n] >= 0).sum())} pods placed", flush=True)
    if placements != want_placements:
        raise RuntimeError(f"{label}: placements differ from the JAX package's")
    cell[f"{kind}_run"] = whatif_launch_inputs(args, kwargs, assignment)
    if launches[cuda.WHATIF_KERNELS[0]] != 1 or any(launches[k] for k in cuda.PERPOD_KERNELS):
        raise RuntimeError(f"{label}: expected one launch of the per-pod kernel in scenario mode, got "
                           f"{json.dumps(launches)}")
    for i in range(2):
        sig_w, wall = run()
        print(f"{label} warm {i}: wall={wall:.3f}s {json.dumps(sched.last_timings)}", flush=True)
        if sig_w != sig:
            raise RuntimeError(f"{label}: warm call differs from the cold call")
    cell[f"{kind}_sched"] = sched
    return launches


def whatif_launch_inputs(args, kwargs, assignment) -> dict:
    """A what-if batch's one launch, as perpod_step_bounds reads it, from
    its solve_whatif arguments and its [S, L] assignment."""
    import torch

    from karpenter_tpu_torch.ops import solver

    idx, active, _count, ev, vg0, hg0, pt, tol, it_allow, exist_ok, ports, conf, vols, exist, it, tm, wk, tt, ptopo = args[:19]
    zone_kid, ct_kid, n_claims = args[19:]
    topo_kids = tuple(kwargs["topo_kids"])
    st0 = solver.initial_state(exist, it, tm, tt, n_claims, ports.shape[1], kwargs["res_cap0"], topo_kids=topo_kids)
    return dict(
        xs=solver.pod_xs(pt, tol, it_allow, exist_ok, ports, conf, vols, ptopo),
        ctx=solver.PerPodCtx(exist, it, tm, wk, tt, zone_kid, ct_kid, n_claims, topo_kids, kwargs["tables"],
                             kwargs["flags"]),
        state0=solver.stack_scenarios(st0, idx.shape[0], vg0, hg0), pod_idx=idx,
        valid=pt.valid[idx.long()] & active, exist_valid=ev, assignment=assignment,
    )


def constrained_cell(T, TorchScheduler) -> dict:
    """constrained_4096x400's problem: templates, pods, budgets and a
    scheduler for it."""
    templates = T.constrained_templates(CONSTRAINED_TYPES)
    pods = T.mixed_pods(CONSTRAINED_PODS) + T.hostport_pods(CONSTRAINED_INGRESS)
    budgets = {"default": {"cpu": CONSTRAINED_CPU_LIMIT}}
    return dict(templates=templates, pods=pods, budgets=budgets,
                sched=TorchScheduler(templates, max_claims=4096))


def constrained_whatif_cell(torch, T, TorchScheduler, templates) -> dict:
    """whatif_constrained_prefix100's problem on the card: mixed_pods(4096)
    provisioned over the constrained templates by a TorchScheduler solve
    and launched (held to the JAX package's cluster), the CSI limits and
    PVCs, the reservations in use, 64 pending pods and the prefix batch."""
    t0 = time.perf_counter()
    result = TorchScheduler(templates, max_claims=4096).solve(T.mixed_pods(WHATIF_PODS))
    torch.cuda.synchronize()
    if result.unschedulable:
        raise RuntimeError(f"whatif_constrained cluster: {len(result.unschedulable)} pods unschedulable")
    cl = T.launch_claims(result, templates)
    got = (len(cl.nodes), sum(len(v) for v in cl.bound.values()), T.cluster_digest(cl))
    print(f"whatif_constrained cluster: {got[0]} nodes, {got[1]} bound pods, digest {got[2][:16]}..., "
          f"provisioned on the card in {time.perf_counter() - t0:.3f}s", flush=True)
    if got != WHATIF_C_CLUSTER:
        raise RuntimeError(f"whatif_constrained cluster {got} differs from the JAX package's {WHATIF_C_CLUSTER}")
    cands = T.candidates(cl)
    pending = T.pending_pods(WHATIF_PENDING)
    kw = dict(pod_volumes=T.attach_volumes(cl, pending), reserved_in_use=T.reserved_in_use(cl))
    print(f"whatif_constrained: {len(kw['pod_volumes'])} pods with a PVC, reservations in use "
          f"{json.dumps(kw['reserved_in_use'])}", flush=True)
    batches = {"prefix": T.prefix_scenarios(cands, WHATIF_CANDS, pending)}
    return dict(cluster=cl, cands=cands, pending=pending, factory=T.topology_factory(cl), batches=batches,
                sched=TorchScheduler(templates), templates=templates, kw=kw, label=f"whatif_constrained_prefix"
                f"{WHATIF_CANDS}", golden={"prefix": (None, *WHATIF_C_GOLDEN)})


def constrained_path(torch, cuda, cell, kernels, profile_dir) -> dict:
    """Drive constrained_4096x400: launch counts zeroed just before a cold
    solve and read just after, the result held to the JAX package's
    (claims, unschedulable pods, $/h, result_digest), every kind on the
    per-pod scan (no fill or kind-scan dispatch, the per-pod kernel once
    per chunk), two warm solves with the same digest, one more under
    torch.profiler with the kernel's ms per step beside its bound. Returns
    the launches or raises RuntimeError."""
    from karpenter_tpu_torch import testing as T

    sched, pods, budgets = cell["sched"], cell["pods"], cell["budgets"]
    cuda.reset_launches()
    t0 = time.perf_counter()
    result = sched.solve(pods, budgets=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    st = sched.last_stats
    print(f"constrained_4096x400 cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} stats={json.dumps(st)} "
          f"launches={json.dumps(launches)}", flush=True)
    got = (result.node_count, len(result.unschedulable), round(result.total_price(), 4), T.result_digest(result))
    print(f"constrained_4096x400 result: claims={got[0]} unschedulable={got[1]} total_price={got[2]:.4f} "
          f"reserved claims={sum(bool(c.reserved_ids) for c in result.claims)} digest {got[3]} "
          f"(JAX {CONSTRAINED_GOLDEN})", flush=True)
    if got[:2] != CONSTRAINED_GOLDEN[:2] or abs(got[2] - CONSTRAINED_GOLDEN[2]) >= 1e-2 \
            or got[3] != CONSTRAINED_GOLDEN[3]:
        raise RuntimeError(f"constrained_4096x400: {got} differs from the JAX package's {CONSTRAINED_GOLDEN}")
    if st["fill_dispatches"] or st["kscan_dispatches"]:
        raise RuntimeError("constrained_4096x400: a fill or kind-scan dispatch under finite budgets")
    # the relaxation ladder re-solves (its unschedulable pods shed a
    # preference), so the per-pod kernel launches once per chunk of every
    # round; H2 and H4 run in the compactions
    n_chunks = st["perpod_dispatches_all"]
    if launches[cuda.PERPOD_KERNELS[0]] != n_chunks or not n_chunks:
        raise RuntimeError(f"constrained_4096x400: {launches[cuda.PERPOD_KERNELS[0]]} launches of the per-pod "
                           f"kernel for {n_chunks} chunks over {st['rounds']} rounds")
    if any(launches[k] for k in ("water_fill", "kscan_grid", "kscan_pod_loop")):
        raise RuntimeError(f"constrained_4096x400: fill or kind-scan kernels launched {json.dumps(launches)}")
    for i in range(2):
        t0 = time.perf_counter()
        r = sched.solve(pods, budgets=budgets)
        torch.cuda.synchronize()
        print(f"constrained_4096x400 warm {i}: wall={time.perf_counter() - t0:.3f}s "
              f"{json.dumps(sched.last_timings)}", flush=True)
        if T.result_digest(r) != got[3]:
            raise RuntimeError("constrained_4096x400: warm solve differs from the cold solve")
    chunks = record_chunks(cuda, lambda: sched.solve(pods, budgets=budgets))
    entry = dict(name=cuda.PERPOD_KERNELS[0])
    profiled_kernel([entry], cuda.PERPOD_KERNELS[0], "false",
                    profile_run(lambda: sched.solve(pods, budgets=budgets), profile_dir, "constrained")["by_name"],
                    chunks, "constrained_4096x400")
    print(f"constrained_4096x400 kernel: {json.dumps(entry)}", flush=True)
    return launches


def hostports_path(torch, cuda, T, TorchScheduler, profile_dir) -> dict:
    """Drive hostports_2048x400 (the fill and kind-scan routes with host
    ports) through solve_path, held to the JAX package's claims and $/h
    with H2, H3, H5 and H6 launched, then to its result_digest; one more
    warm solve under torch.profiler. Returns the launches or raises
    RuntimeError."""
    sched = TorchScheduler(T.make_templates(CONSTRAINED_TYPES))
    pods = T.mixed_pods(HOSTPORTS_PODS) + T.hostport_pods(CONSTRAINED_INGRESS)
    result, launches = solve_path(torch, cuda, "hostports_2048x400", sched, pods, HOSTPORTS_GOLDEN[:2], {},
                                  ("fill_count_grid", "water_fill", "kscan_grid", "kscan_pod_loop"))
    got = T.result_digest(result)
    print(f"hostports_2048x400: claims with host ports={sum(1 for c in result.claims if c.host_ports)} "
          f"digest {got} (JAX {HOSTPORTS_GOLDEN[2]})", flush=True)
    if got != HOSTPORTS_GOLDEN[2]:
        raise RuntimeError("hostports_2048x400: result digest differs from the JAX package's")
    profile_run(lambda: sched.solve(pods), profile_dir, "hostports")
    return launches


def record_chunks(cuda, fn) -> list:
    """Run fn with every single-scenario launch of the per-pod kernel
    recorded (its inputs, a copy of the carry before it, its assignment),
    as perpod_step_bounds reads them."""
    from karpenter_tpu_torch.ops import solver

    rec = []
    real = cuda.perpod_scan

    def recording(state, xs, ctx):
        state0 = solver.own_perpod_writes(state)
        a = real(state, xs, ctx)
        rec.append(dict(state0=state0, xs=xs, ctx=ctx, assignment=a[None]))
        return a

    cuda.perpod_scan = recording
    try:
        fn()
    finally:
        cuda.perpod_scan = real
    return rec


def profiled_kernel(kernels: list, name: str, inst: str, by_name: dict, launches: list, cell: str = "") -> None:
    """Print the per-pod kernel's device time per launch and per step in a
    profiled call (instantiation <inst>) of cell `cell`, its bound per step
    over the same launches; set them on the kernel's entry of `kernels`
    when it is there."""
    label = f"{name} ({cell})" if cell else name
    hits = [v for n, v in by_name.items() if f"perpod_scan_persistent_kernel<{inst}>(" in n]
    if not hits:
        print(f"kernel {label}: device time not measured (no profiled launch)", flush=True)
        return
    (n, ms), = hits
    steps = sum(ch["assignment"].shape[1] for ch in launches)
    b, live = perpod_step_bounds(launches)
    print(f"kernel {label}: {ms / n:.4f} ms per launch, {ms / steps:.6f} ms per step on the device ({n} launches, "
          f"{steps} steps profiled), bound {b[0]:.7f} ms per step ({b[1]}) over the same steps {json.dumps(live)}",
          flush=True)
    for k in kernels:
        if k["name"] == name:
            k.update(ms=ms / steps, bound_ms=b[0], bound_by=b[1])


def profile_run(fn, out_dir, tag) -> dict:
    """One more warm call of fn under torch.profiler: device busy share
    over the call's wall, and device time by kernel name (from the chrome
    trace, so launches of one name are summed and overlaps counted once).
    Returns the summary (wall_s, device_busy_s, idle_share, ...) with
    by_name {kernel name: (launches, device ms)}; by_name alone, empty, when
    not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        print(f"profile {tag}: not measured (the trace holds no device events)", flush=True)
        return dict(by_name={})
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in dev:
        n, d = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, d + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    summary = dict(
        wall_s=wall, device_busy_s=busy / 1e6, idle_share=1.0 - busy / 1e6 / wall,
        device_events=len(dev),
        top=[dict(name=n[:90], launches=c, ms=d / 1e3) for n, (c, d) in top],
    )
    with open(os.path.join(out_dir, f"{tag}_profile.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"profile {tag}: wall={wall:.3f}s device_busy={busy / 1e6:.4f}s "
          f"idle_share={summary['idle_share']:.4f} device_events={len(dev)}", flush=True)
    for t in summary["top"]:
        print(f"  device {t['ms']:9.3f} ms  x{t['launches']:6d}  {t['name']}", flush=True)
    return dict(summary, by_name={n: (c, d / 1e3) for n, (c, d) in by_name.items()})


def digest(result) -> str:
    h = hashlib.sha256()
    for c in result.claims:
        h.update(repr((c.slot, [p.name for p in c.pods], [i.name for i in c.instance_types],
                       sorted(c.used.items()), str(c.requirements))).encode())
    for p, reason in result.unschedulable:
        h.update(repr((p.name, reason)).encode())
    return h.hexdigest()


def solve_path(torch, cuda, label, sched, pods, golden, expect_stats, kernels_needed):
    """Drive one main path: launch counts zeroed just before a cold solve
    and read just after, the result held to the JAX package's (claims,
    price, nothing unschedulable) and to its dispatch counts, two warm
    solves that must give the same digest. Returns (result, launches) or
    raises RuntimeError."""
    cuda.reset_launches()
    t0 = time.perf_counter()
    result = sched.solve(pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    print(f"{label} cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} "
          f"stats={json.dumps(sched.last_stats)} launches={json.dumps(launches)}", flush=True)
    claims, unsched, price = result.node_count, len(result.unschedulable), result.total_price()
    print(f"{label} result: claims={claims} unschedulable={unsched} total_price={price:.4f}", flush=True)
    if unsched:
        raise RuntimeError(f"{label}: {unsched} pods unschedulable")
    if claims != golden[0] or abs(price - golden[1]) >= 1e-2:
        raise RuntimeError(f"{label}: {claims} claims / {price:.4f} $/h, expected {golden[0]} / {golden[1]}")
    for k, want in expect_stats.items():
        if sched.last_stats.get(k) != want:
            raise RuntimeError(f"{label}: {k}={sched.last_stats.get(k)}, expected {want}")
    idle = [k for k in kernels_needed if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"{label}: kernels never launched: {idle}")
    for i in range(2):
        t0 = time.perf_counter()
        r = sched.solve(pods)
        torch.cuda.synchronize()
        print(f"{label} warm {i}: wall={time.perf_counter() - t0:.3f}s "
              f"{json.dumps(sched.last_timings)}", flush=True)
        if digest(r) != digest(result):
            raise RuntimeError(f"{label}: warm solve differs from the cold solve")
    return result, launches


def main() -> int:
    kernels_only = "--kernels-only" in sys.argv[1:]
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
        from karpenter_tpu_torch import testing as T
        from karpenter_tpu_torch.ops import cuda
        from karpenter_tpu_torch.testing import (
            existing_node, guarded_pods, make_templates, many_resources_pods, mixed_pods, perpod_pods, selector_pods,
            tier_pods, tier_templates, wide_zone_pods, zonal_pods,
        )
    except ImportError as err:
        return fail(f"karpenter_tpu_torch is not importable here ({err})")
    t_start = time.perf_counter()

    # phase 1
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    # phase 2
    info = cuda.build()
    print(f"build: {len(cuda.KERNELS)} kernels in {info['seconds']:.1f}s -> {info['dir']}", flush=True)
    for name, log in info["logs"].items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
    # the launcher's workspace check counts on the per-pod kernel's static
    # shared memory staying within cuda.SMEM_STATIC
    static = [int(m) for m in re.findall(r"(\d+) bytes smem", info["logs"].get("perpod_scan", ""))]
    if static and max(static) > cuda.SMEM_STATIC:
        return fail(f"perpod_scan: {max(static)} B of static shared memory, above cuda.SMEM_STATIC")

    # phase 3 (the schedulers' encodes supply the real catalog and topology tensors)
    templates = make_templates(1000)
    sched = TorchScheduler(templates, max_claims=4096)
    sched._encode(selector_pods(16), None)
    kernels = kernel_phase(sched)
    templates_m = make_templates(400)
    sched_m = TorchScheduler(templates_m, max_claims=4096)
    _sorted, enc_m = sched_m._encode(mixed_pods(64), None)
    kscan_kernel_phase(sched_m, enc_m, kernels)
    pods_p = perpod_pods(PERPOD_PODS, kinds=PERPOD_KINDS)
    sched_p = TorchScheduler(templates_m, max_claims=4096)
    _sorted, enc_p = sched_p._encode(pods_p, None)
    perpod_kernel_phase(sched_p, enc_p, kernels)
    try:
        cell_w = whatif_cell(torch, T, templates_m)
    except RuntimeError as err:
        return fail(str(err))
    whatif_plain_wall, _batch = whatif_kernel_phase(cell_w, kernels)
    # the constrained cells: the kernel's minValues and reservation branches
    cell_c = constrained_cell(T, TorchScheduler)
    _sorted, enc_c = cell_c["sched"]._encode(cell_c["pods"], cell_c["budgets"])
    checks_c = [perpod_kernel_phase(cell_c["sched"], enc_c, None, cell="constrained_4096x400")["entry"]]
    try:
        cell_wc = constrained_whatif_cell(torch, T, TorchScheduler, cell_c["templates"])
    except RuntimeError as err:
        return fail(str(err))
    whatif_c_plain_wall, batch_c = whatif_kernel_phase(cell_wc, None)
    checks_c.append(batch_c["entry"])
    bad = [k["name"] for k in kernels + checks_c if not k["equal"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")
    if kernels_only:
        print(f"kernels only: stopping after phase 3 ({time.perf_counter() - t_start:.1f}s)", flush=True)
        return 0

    # phase 4: the fill path (north star), the topology path (mixed_pods),
    # then the per-pod path (perpod_pods); a kernel's launches in the JSON
    # line are the sum over the three cold solves, each counted from zero
    pods = selector_pods(100_000)
    sched = TorchScheduler(templates, max_claims=4096)
    fill_kernels = ("req_intersects", "fill_count_grid", "water_fill", "compact_scatter")
    pods_m = mixed_pods(MIXED_PODS)
    sched_m = TorchScheduler(templates_m, max_claims=4096)
    sched_p = TorchScheduler(templates_m, max_claims=4096)
    profile_dir = os.path.join("build", "profile")
    try:
        result, launches_n = solve_path(torch, cuda, "north star", sched, pods, (GOLDEN_CLAIMS, GOLDEN_PRICE), {},
                                        fill_kernels)
        profile_run(lambda: sched.solve(pods), profile_dir, "northstar")
        result_m, launches_m = solve_path(
            torch, cuda, "mixed path", sched_m, pods_m, (MIXED_CLAIMS, MIXED_PRICE), MIXED_STATS,
            [k for k in cuda.KERNELS if k not in cuda.PERPOD_KERNELS + cuda.WHATIF_KERNELS],
        )
        profile_run(lambda: sched_m.solve(pods_m), profile_dir, "mixed")
        result_p, launches_p = solve_path(
            torch, cuda, "perpod path", sched_p, pods_p, (PERPOD_CLAIMS, PERPOD_PRICE), PERPOD_STATS,
            (*cuda.PERPOD_KERNELS, "fill_count_grid", "compact_scatter"),
        )
    except RuntimeError as err:
        return fail(str(err))
    if digest(result_p) != PERPOD_DIGEST:
        return fail(f"perpod path: digest {digest(result_p)} differs from the JAX package's {PERPOD_DIGEST}")
    print("perpod path: digest equal to the JAX package's", flush=True)
    if launches_p[cuda.PERPOD_KERNELS[0]] != PERPOD_STATS["perpod_dispatches"]:
        return fail(f"perpod path: {launches_p[cuda.PERPOD_KERNELS[0]]} launches of the per-pod kernel, "
                    f"expected one per chunk ({PERPOD_STATS['perpod_dispatches']})")
    # the kernel's device time per launch and per step in the profiled warm
    # solve, beside its bound over the same steps (a solve is deterministic:
    # the chunks are recorded from another warm solve)
    chunks = record_chunks(cuda, lambda: sched_p.solve(pods_p))
    profiled_kernel(kernels, cuda.PERPOD_KERNELS[0], "false",
                    profile_run(lambda: sched_p.solve(pods_p), profile_dir, "perpod")["by_name"], chunks)
    # small problems on the card against the plain CPU path
    small_t = make_templates(400)
    r_gpu = TorchScheduler(small_t, max_claims=256).solve(selector_pods(2048))
    r_cpu = TorchScheduler(small_t, max_claims=256, device="cpu").solve(selector_pods(2048))
    if digest(r_gpu) != digest(r_cpu) or r_gpu.unschedulable:
        return fail("2048-pod solve on the card differs from the CPU solve")
    print(f"small check: 2048 selector pods x 400 types, {r_gpu.node_count} claims, card == CPU", flush=True)
    r_gpu = TorchScheduler(small_t, max_claims=256).solve(mixed_pods(1024))
    r_cpu = TorchScheduler(small_t, max_claims=256, device="cpu").solve(mixed_pods(1024))
    price = r_gpu.total_price()
    if digest(r_gpu) != digest(r_cpu) or r_gpu.unschedulable:
        return fail("1024 mixed pods on the card differ from the CPU solve")
    if r_gpu.node_count != SMALL_MIXED[0] or abs(price - SMALL_MIXED[1]) >= 1e-2:
        return fail(f"1024 mixed pods: {r_gpu.node_count} claims / {price:.4f} $/h, expected {SMALL_MIXED}")
    print(f"small check: 1024 mixed pods x 400 types, {r_gpu.node_count} claims, "
          f"{price:.4f} $/h, card == CPU", flush=True)
    small_t24 = make_templates(24)
    for label, tmpl, mc, make, nodes in (
        ("perpod_pods(256)", small_t, 256, lambda: perpod_pods(256, kinds=4), []),
        ("mixed_pods(80) + perpod_pods(48)", small_t24, 128, lambda: mixed_pods(80) + perpod_pods(48), []),
        ("custom-key kinds (the full it-compat branch)", tier_templates(24), 32, tier_pods, []),
        ("per-pod kinds with hostname groups and an existing node", small_t24, 64, lambda: guarded_pods(40),
         [existing_node()]),
        ("a 17-value zone key", small_t24, 64, lambda: wide_zone_pods(32), [existing_node(cpu=1.0)]),
        ("a 45-value zone key (two words of value bits)", small_t24, 64, lambda: wide_zone_pods(32, extra_zones=41),
         [existing_node(cpu=1.0)]),
        ("a 2104-value zone key (V = 4096: fewer warps' row scratches fit)", small_t24, 64,
         lambda: wide_zone_pods(32, extra_zones=2100), [existing_node(cpu=1.0)]),
        ("40 resources (past a warp's 32 lanes)", small_t24, 32, many_resources_pods, []),
    ):
        s_gpu = TorchScheduler(tmpl, max_claims=mc)
        r_gpu = s_gpu.solve(make(), existing_nodes=nodes)
        r_cpu = TorchScheduler(tmpl, max_claims=mc, device="cpu").solve(make(), existing_nodes=nodes)
        if digest(r_gpu) != digest(r_cpu) or not s_gpu.last_stats["perpod_dispatches"]:
            return fail(f"{label} on the card differs from the CPU solve (or ran no per-pod chunk)")
        print(f"small check: {label}, {r_gpu.node_count} claims, {len(r_gpu.existing_assignments)} on existing "
              f"nodes, {len(r_gpu.unschedulable)} unschedulable, card == CPU", flush=True)
    # zone counts past 2^15 through solve(topology=) on the kind scan: H6's
    # rank key wraps as the plain version's does
    def seeded(pods):
        return T.seed_big_counts(T.PORT.Topology.build(list(pods), lambda: T.PORT.build_universe_domains(
            small_t24, [], template_base=T.PORT.template_universe_domains(small_t24))))

    s_gpu = TorchScheduler(small_t24, max_claims=64)
    cuda.reset_launches()
    r_gpu = s_gpu.solve(zonal_pods(64, kinds=2), topology=seeded(zonal_pods(64, kinds=2)))
    n_h6 = cuda.LAUNCHES["kscan_pod_loop"]
    r_cpu = TorchScheduler(small_t24, max_claims=64, device="cpu").solve(
        zonal_pods(64, kinds=2), topology=seeded(zonal_pods(64, kinds=2)))
    if digest(r_gpu) != digest(r_cpu) or not s_gpu.last_stats["kscan_dispatches"] or not n_h6:
        return fail("zonal pods with zone counts past 2^15 on the card differ from the CPU solve "
                    "(or ran no kscan_pod_loop launch)")
    print(f"small check: zonal_pods(64) with zone counts past 2^15, {r_gpu.node_count} claims, "
          f"{n_h6} kscan_pod_loop launches, card == CPU", flush=True)

    # the consolidation path: both batches, a profiled warm prefix batch,
    # the sequential confirms
    try:
        launches_w = [whatif_path(torch, cuda, T, cell_w, kind) for kind in ("prefix", "single")]
    except RuntimeError as err:
        return fail(str(err))
    # the constrained cells: Karpenter's constraints on the per-pod scan,
    # host ports on the fill and kind-scan routes, the constrained what-ifs
    try:
        launches_c = constrained_path(torch, cuda, cell_c, kernels, profile_dir)
        launches_h = hostports_path(torch, cuda, T, TorchScheduler, profile_dir)
        launches_wc = whatif_path(torch, cuda, T, cell_wc, "prefix")
    except RuntimeError as err:
        return fail(str(err))
    pods_wc, specs_wc = cell_wc["batches"]["prefix"]
    sched_wc = cell_wc["prefix_sched"]
    by_name = profile_run(
        lambda: sched_wc.whatif_batch(pods_wc, [n.clone() for n in cell_wc["cluster"].nodes], None, specs_wc,
                                      cell_wc["factory"], **cell_wc["kw"]),
        profile_dir, "whatif_constrained",
    )["by_name"]
    profiled_kernel([], cuda.WHATIF_KERNELS[0], "true", by_name, [cell_wc["prefix_run"]], cell_wc["label"])
    for k in kernels:
        k["launches"] = sum(ln[k["name"]] for ln in [launches_n, launches_m, launches_p, *launches_w, launches_c,
                                                      launches_h, launches_wc])
    for kind in ("prefix", "single"):
        pods_w, specs_w = cell_w["batches"][kind]
        sched_w = cell_w[f"{kind}_sched"]
        by_name = profile_run(
            lambda: sched_w.whatif_batch(pods_w, [n.clone() for n in cell_w["cluster"].nodes], None, specs_w,
                                         cell_w["factory"]),
            profile_dir, f"whatif_{kind}",
        )["by_name"]
        # the JSON line carries the prefix batch's numbers
        profiled_kernel(kernels if kind == "prefix" else [], cuda.WHATIF_KERNELS[0], "true", by_name,
                        [cell_w[f"{kind}_run"]])
    for n_cands, want in WHATIF_CONFIRM.items():
        t0 = time.perf_counter()
        got = T.sequential_signal(TorchScheduler(templates_m), cell_w["cluster"], cell_w["factory"],
                                  cell_w["pending"], cell_w["cands"][:n_cands])
        torch.cuda.synchronize()
        print(f"whatif confirm prefix {n_cands}: {got} (JAX {want}) in {time.perf_counter() - t0:.3f}s", flush=True)
        if got != want:
            return fail(f"sequential confirm of prefix {n_cands}: {got}, the JAX package's {want}")

    # phase 5: plain versions on the card
    for label, tmpl, ps, ref in (("north star", templates, pods, result), ("mixed path", templates_m, pods_m, result_m),
                                 ("perpod path", templates_m, pods_p, result_p)):
        t0 = time.perf_counter()
        r_plain = TorchScheduler(tmpl, max_claims=4096, plain=True).solve(ps)
        torch.cuda.synchronize()
        same = digest(r_plain) == digest(ref)
        print(f"plain on card, {label}: wall={time.perf_counter() - t0:.3f}s digest_equal={same}", flush=True)
        if not same:
            return fail(f"plain-version solve of the {label} on the card gives another assignment")
    print(f"plain on card, what-if sub-batch (4 scenarios of whatif_prefix{WHATIF_CANDS}, phase 3): "
          f"wall={whatif_plain_wall:.3f}s; of {cell_wc['label']}: wall={whatif_c_plain_wall:.3f}s", flush=True)

    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    for k in kernels:
        k.pop("equal")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
