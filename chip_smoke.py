#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # needs one CUDA card

Phases, any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the four hand-written kernels from karpenter_tpu_torch/ops/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     north-star shapes (W=4096 claims, T=1000 types, GR=1, R=4, Z=4, C=2,
     K=V=8), seeded inputs, exact equality; times for kernel, plain
     version and the least time the card could take (bound);
  4. the main path: TorchScheduler(make_templates(1000), max_claims=4096)
     on selector_pods(100_000), one cold and two warm solves, held to the
     JAX package's result on this workload (2273 claims, 0 unschedulable,
     3149.6813 $/h), with every kernel launched during the cold solve; one
     more warm solve under torch.profiler (device busy share and device
     time by kernel, trace and summary under build/profile/); and a 2048-pod
     solve on the card held to the same solve on the CPU;
  5. the same 100k solve with the kernels' plain versions on the card,
     which must give the identical assignment digest.
The second-to-last line is one JSON object of per-kernel numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

# the JAX package's result for selector_pods(100_000) x make_templates(1000),
# max_claims=4096 (TPUScheduler.solve on the CPU at commit 153c45d)
GOLDEN_CLAIMS = 2273
GOLDEN_PRICE = 3149.6813
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


def profile_solve(sched, pods, out_dir) -> None:
    """One more warm solve under torch.profiler: device busy share over the
    solve's wall, and device time by kernel name (from the chrome trace,
    so launches of one name are summed and overlaps counted once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "northstar_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.solve(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        print("profile: not measured (the trace holds no device events)", flush=True)
        return
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
    with open(os.path.join(out_dir, "northstar_profile.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"profile: wall={wall:.3f}s device_busy={busy / 1e6:.4f}s "
          f"idle_share={summary['idle_share']:.4f} device_events={len(dev)}", flush=True)
    for t in summary["top"]:
        print(f"  device {t['ms']:9.3f} ms  x{t['launches']:6d}  {t['name']}", flush=True)


def digest(result) -> str:
    h = hashlib.sha256()
    for c in result.claims:
        h.update(repr((c.slot, [p.name for p in c.pods], [i.name for i in c.instance_types],
                       sorted(c.used.items()))).encode())
    for p, reason in result.unschedulable:
        h.update(repr((p.name, reason)).encode())
    return h.hexdigest()


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
        from karpenter_tpu_torch.ops import cuda
        from karpenter_tpu_torch.testing import make_templates, selector_pods
    except ImportError as err:
        return fail(f"karpenter_tpu_torch is not importable here ({err})")

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

    # phase 3 (the scheduler's encode supplies the real catalog tensors)
    templates = make_templates(1000)
    sched = TorchScheduler(templates, max_claims=4096)
    sched._encode(selector_pods(16), None)
    kernels = kernel_phase(sched)
    bad = [k["name"] for k in kernels if not k["equal"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")

    # phase 4: the main path
    pods = selector_pods(100_000)
    sched = TorchScheduler(templates, max_claims=4096)
    cuda.reset_launches()
    t0 = time.perf_counter()
    result = sched.solve(pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    print(f"main path cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} "
          f"stats={json.dumps(sched.last_stats)} launches={json.dumps(launches)}", flush=True)
    claims, unsched, price = result.node_count, len(result.unschedulable), result.total_price()
    print(f"main path result: claims={claims} unschedulable={unsched} total_price={price:.4f}", flush=True)
    if unsched:
        return fail(f"{unsched} pods unschedulable")
    if claims != GOLDEN_CLAIMS:
        return fail(f"{claims} claims, expected {GOLDEN_CLAIMS}")
    if abs(price - GOLDEN_PRICE) >= 1e-2:
        return fail(f"total price {price:.4f}, expected {GOLDEN_PRICE}")
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        return fail(f"kernels never launched on the main path: {idle}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    warm = []
    for i in range(2):
        t0 = time.perf_counter()
        r = sched.solve(pods)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        print(f"main path warm {i}: wall={warm[-1]:.3f}s {json.dumps(sched.last_timings)}", flush=True)
        if digest(r) != digest(result):
            return fail("warm solve differs from the cold solve")
    profile_solve(sched, pods, os.path.join("build", "profile"))
    # a small problem on the card against the plain CPU path
    small_t = make_templates(400)
    r_gpu = TorchScheduler(small_t, max_claims=256).solve(selector_pods(2048))
    r_cpu = TorchScheduler(small_t, max_claims=256, device="cpu").solve(selector_pods(2048))
    if digest(r_gpu) != digest(r_cpu) or r_gpu.unschedulable:
        return fail("2048-pod solve on the card differs from the CPU solve")
    print(f"small check: 2048 pods x 400 types, {r_gpu.node_count} claims, card == CPU", flush=True)

    # phase 5: plain versions on the card
    t0 = time.perf_counter()
    r_plain = TorchScheduler(templates, max_claims=4096, plain=True).solve(pods)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    same = digest(r_plain) == digest(result)
    print(f"plain on card: wall={plain_wall:.3f}s digest_equal={same}", flush=True)
    if not same:
        return fail("plain-version solve on the card gives another assignment")

    for k in kernels:
        k.pop("equal")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
