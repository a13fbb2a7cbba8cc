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
     claims, T=1000 types, GR=1, R=4, Z=4, C=2, K=V=8), H1, H2 and H4 in
     each of their call shapes, each with its device time from
     torch.profiler beside the CUDA-event and launcher times: H1 at tier
     2 (W rows) and tier 3 (G template rows) and on seeded catalogs of
     K=70 keys (three key words; 4096 x 1000 at V=16, 37 x 400 at V=64);
     H2 in each call shape of the fill step and the compaction (tier 2's
     caps and fits_final, tier 3's G-row, one-row and broadcast calls,
     the liveness test); H4 in the compaction (the 14 window fields),
     compact_state's bank columns, the drop scatter, global_claims and a
     compaction at W=131072, each launched twice (the look-back
     workspace must come back zeroed); H1 at the kind step's tier 2 and
     tier 3, H4's topology-key
     mode, H5 and H6 at the kind scan's (W=4096, T=400, D=4 zones, the
     encoded topology of mixed_pods: NGv 2, NGh 4; H6 over one segment of
     256 pods, its device time profiled, and one seeded segment at W=8192,
     D=16 whose live rows overflow its shared-memory staging); seeded
     inputs, the catalog tensors being the real encoded
     ones; the per-pod kernel (perpod_scan_persistent, H7 + H8 in one
     launch per chunk) on the per-pod cell's real encoded problem
     (perpod_pods(4096, kinds=8) x make_templates(400): W=4096 claim rows,
     T=400, NGv 16), from the state a first 1024-pod chunk leaves: one
     step, 8 steps and a 256-pod chunk through the kernel against the same
     steps through the plain step; its scenario mode on the what-if prefix
     cell's encode (S=128 scenarios): one step of every scenario in one
     launch, and WHATIF_SUB scenarios (the largest prefix among them) run to the end
     through the kernel and through the plain loop; assignments and every
     carry leaf equal; the same two checks with the kernel's minValues and
     reservation branches on: one step, 8 steps and a 256-pod chunk of
     constrained_4096x400 from the state after 1024 pods, and in scenario
     mode on whatif_constrained_prefix100's encode (reservation
     capacities and held rows among the carry leaves); the gang kernel
     (gang_scan, H9) on the leading gang runs of each gang cell below
     (gang_storm's one run; gang_zonal_budget's zone-key run from the
     empty carry and its hostname run from the carry the first leaves),
     against the plain loop: every carry leaf it writes and every GangYs
     leaf, with device (profiler), event and launcher ms, each launch on
     a fresh copy of the carry; the retract kernel (retract_tail, H10) on
     the resident state resident_retract_16380x63 holds after its 16
     rounds (W = NB = 8192 rows), at the cuts n_open, every round's
     boundary and 0, against its plain version: every state leaf; under
     a placement objective's rank: H6 with cost_min's rank over the four
     family pools, the per-pod kernel on objectives_perpod_4096x400 under
     cost_min (one block) and in scenario mode on prefix100's shapes over
     the four pools (S = 128 scenarios, 2 to the end); the objective
     verdict kernel (objective_verdict, H11) at
     objectives_mixed_16384x400's first cost_min round (K = 4 variants of
     the first fill group), under each objective's formula and with every
     type unpriced, scores bit for bit and the word, each of those five
     call shapes timed (device, event and launcher ms); the dp kernels
     (dp_dead H12, dp_verdict H13, merge_shard H14) on the first merge
     round and first commit of three dp cells below (SHARD_KERNEL_CELLS:
     fill with existing-node debits, the kind scan, the per-pod scan at
     DP = 4), the deadness matrix, the word and every merged leaf, H12 and
     H13 timed on each cell's round and H14 on its commit (device, event
     and launcher ms);
  4. the main paths, each with the launch counts zeroed just before its
     cold solve and read just after, then WARM_CALLS warm solves: the fill path,
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
     cold and warm (WARM_CALLS), held to the JAX package's signals, with the
     per-pod kernel in scenario mode launched once per batch; one more warm
     call of each batch under torch.profiler; the sequential confirm of
     prefixes 1, 10 and 100 (TorchScheduler.solve(topology=...)) held to
     the JAX package's; then Karpenter's constraints: constrained_4096x400
     (mixed_pods(4096) and a 64-pod deployment on host port 443 over
     constrained_templates(400): minValues 2 on instance-type names and
     families, reserved offerings on 4 types, a pool cpu limit that binds;
     max_claims=4096), cold and warm, held to the JAX package's
     claims, unschedulable pods, $/h and result digest, every kind on the
     per-pod kernel (once per chunk, no fill or kind-scan dispatch), its
     kernel ms per step from a profiled warm solve beside its bound;
     hostports_2048x400 (mixed_pods(2048) and the deployment over
     make_templates(400): host-port bits on the fill and kind-scan
     kernels), held to the JAX package's; whatif_constrained_prefix100
     (the constrained templates' cluster of mixed_pods(4096), CSI attach
     limits and PVCs, reservations in use, 64 pending pods, the prefixes
     1..100) held to the JAX package's signals and placements, one launch
     in scenario mode, and one profiled warm batch; then gangs:
     gang_storm_64x16x400 (64 gangs x 16 at 1.5 cpu, the whale gang of 4 x
     10000 cpu, selector_pods(2048) over make_templates(400),
     max_claims=2048) and gang_zonal_budget_4096x400 (32 zone-spread gangs
     x 16, 8 hostname-spread gangs x 8, zonal_pods(4096, kinds=8), a pool
     cpu limit that binds, max_claims=4096), cold and warm, held to
     the JAX package's claims, unschedulable pods and reasons (the whale
     alone spills, whole), $/h, slice hosts and digests, gang_scan
     launched once per gang run of every round, one profiled warm solve
     each; then the resident session (TorchScheduler.resident_session()):
     resident_retract_16380x63 (65 kinds x 252 pods of 1 cpu / 1Gi over
     make_templates(100), max_claims=8192; 16 rounds of a fresh kind of
     63 x max(1, Poisson(1)) pods, the newest batch departing first with
     p = 0.35, seed 0; then 3 pops of the newest batch) and steady_16384x64
     (the JAX package's bench.py steady stage: 64 kinds x 256, Poisson(64)
     batches, 12 rounds, after its warm-up rounds), every round's mode,
     reason, claims and digest and the final fingerprint held to the JAX
     package's, retract_tail launched once per retract round (5 in the
     retract cell, every round of which stays on the delta path), per
     round the wall, encode / device split, fill dispatches and H10
     launches, the delta p50 / p95 / max beside the p95 of a forced full
     re-solve of the final union, and a profiled delta round's idle share;
     then placement objectives: objectives_mixed_16384x400
     (mixed_pods(16384) over the four family pools of
     testing.mixed_pool_templates(400), max_claims=4096,
     KTPU_OBJECTIVE_K=4) under each of the five policies and
     objectives_perpod_4096x400 (perpod_pods(4096, kinds=8) over the same
     pools) under lexical and cost_min, each a cold solve held to the JAX
     package's claims, unschedulable pods, $/h, digest and objective-round
     counts, objective_verdict launched once per objective round, the cost
     gate (cost_min no pricier than lexical), a warm lexical and cost_min
     solve, and a profiled warm cost_min solve; then dp speculation
     (TorchScheduler(dp=N), shard_cells): the JAX package's bench shard
     stage, selector_pods(8192) x make_templates(200) at dp 2, and its
     zonal, hostname, existing-node, per-pod and minValues + budget
     twins at 512 pods, the north star and zonal_pods(4096) x 400 at dp 2,
     the per-pod and constrained cells at dp 4, each a cold solve held to
     the JAX package's result and merge counters (SHARD_GOLDEN), dp_dead
     and dp_verdict launched once per merge round, merge_shard once per
     commit and the per-pod kernel's scenario mode once per per-pod
     round, a warm solve, and a profiled warm solve of the per-pod dp
     cell (H12-H14's device time); shard_8192x200's and the per-pod dp
     cell's warm solves also list the lines that made the host wait
     (sync_points);
  5. the north star and mixed solves and perpod_pods(1024, kinds=8) with
     the kernels' plain versions on the card, which must give the digest
     of the card's kernel solve (claims, pods, types, usage,
     requirements), and the wall of phase 3's plain what-if sub-batch.
The run prints each phase's seconds.
The second-to-last line is one JSON object of per-kernel numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

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
# phase 5's plain per-pod solve on the card: perpod_pods at this depth,
# held to the card's kernel solve of the same problem
PLAIN_PERPOD_PODS = 1024
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
# the gang cells (python tests/test_torch_gang.py prints them, TPUScheduler
# on the CPU): gang_storm_64x16x400 — 64 gangs x 16 members at 1.5 cpu,
# the whale gang of 4 x 10000 cpu and selector_pods(2048) over
# make_templates(400), max_claims=2048 (the JAX package's bench.py gang
# storm at its TPU sizes); gang_zonal_budget_4096x400 — 32 zone-spread
# gangs x 16 at 1.0 cpu, 8 hostname-spread gangs x 8 at 2.0 cpu and
# zonal_pods(4096, kinds=8) over make_templates(400), max_claims=4096, a
# pool cpu limit of testing.GANG_ZONAL_CPU_LIMIT (75% of the 9744 cpu the
# problem launches without one): claims, unschedulable pods and reasons,
# the gangs that spilled, $/h, slice hosts and testing.slice_digest /
# result_digest
GANG_TYPES = 400
GANG_STORM = dict(n_gangs=64, size=16, singles=2048, max_claims=2048)
GANG_STORM_GOLDEN = dict(
    claims=112, unschedulable=4, reasons={"no compatible in-flight claim or template": 4},
    spilled={"default/whale": 4}, price=109.5592, slice_hosts=64,
    slice_digest="695086e9e2d0cb32c8187bd11750904de3c7f8fe0582a8780a196d35cdc01eed",
    result_digest="d6cabe4171ce9bd7f9c90c95930cc997a39babeb17d7da85e2ad6bdf18ce2076",
)
GANG_ZONAL_MAX_CLAIMS = 4096
GANG_ZONAL_GOLDEN = dict(
    claims=116, unschedulable=1850, reasons={"no compatible in-flight claim or template": 1850},
    spilled={"singleton": 1850}, price=82.5913, slice_hosts=40,
    slice_digest="0fa701be3eda7c3bc3df33edb7f6ca18955cc709081a0babb68e507b3c99b0d5",
    result_digest="8e380e3f44788b502e03705e016894edff12fbaebeb348e62782e5f79e03891b",
)
# the resident cells (python tests/test_torch_resident.py prints them: the
# JAX package's ResidentSession on the CPU, at 6fcc76f): per round of each
# trace (testing.retract_trace / steady_trace) its label, mode, reason,
# claims and digest(); the final fingerprint; and the retract_tail
# dispatches over the trace
RESIDENT_GOLDEN = {
    "resident_retract_16380x63": dict(
        rounds=[
            ('cold', 'full', 'cold', 260, 'a6cae46e21c4502fcbed43ebfbafefa85e57e70df438c0df404b6f16d3fcf4fc'),
            ('round 0', 'delta', 'delta', 261, '586ef36f2d89ff2d24fd1e4daa9aeb5bffd1c1d784715b90a5a5e7c562d62b6d'),
            ('round 1', 'delta', 'delta', 261, '5d04a49e72b985bacdb851dfb3c441a347de9fa405dd518d92b2f832235f73be'),
            ('round 2', 'delta', 'delta', 264, 'df05ab4050165be9d4894e5f0117d7fb41636ada33d061e4e50a895081e204c0'),
            ('round 3', 'delta', 'delta', 265, '3b9f69e8646e21d1311f6e5ba02a15431eb8903f4c5e4ac10c073d0243bb4d21'),
            ('round 4', 'delta', 'delta', 266, '5b57a2c4a76721815b8c74e0c99ecbfdfd8aad3fb18c0a45112c8d9f616de270'),
            ('round 5', 'delta', 'delta', 267, '0ad4185fc781f7de67c95dfa4399c440c8d3962461f6c4b6cb4f6c3d51dcc7d6'),
            ('round 6', 'delta', 'delta', 268, '78a5082d463fdb06f80915a878bb68f8b69fa8e6555a3445aa2c2e5b656a496b'),
            ('round 7', 'delta', 'delta', 269, '84011465cb15a964d236d82c046ea848a535d2031439b62d57a7bacb455d6544'),
            ('round 8', 'delta', 'delta', 270, 'bb0de4b2d3ea7969ebe732f0a5726de4286c844d52655aa189a66b2a2e9c1c56'),
            ('round 9', 'delta', 'delta', 274, '7e1e5189c4b082e80dc436882df1717cf570011a36ae65015c41ccc41eda2349'),
            ('round 10', 'delta', 'delta', 275, '827ec8c91ae2b4f265feeb677450ce47116d800c519c12a032943bd9f0031000'),
            ('round 11', 'delta', 'delta', 276, '5973c96407f64dd21fc47d828e4064fa9fd03d7618f080054353fcfd5143f158'),
            ('round 12', 'delta', 'delta', 278, '4f66c55d6c0251b792c2810980946a2171e5f9b34b96612f6d8dea383eaf23c1'),
            ('round 13', 'delta', 'delta', 279, '992c66a37a3843451d350137fc9ea246d29cbc64d3e203faa1bdd1b39fcbc415'),
            ('round 14', 'delta', 'delta', 280, 'cc979df84a6292c49e64e59a44d11a36256a5b25e12f97c70fef55774b90b431'),
            ('round 15', 'delta', 'delta', 281, 'a7ef7f23d53eddcdff5cdc5cd73ea67f8676915504a69b44d72ae9d598d48ac6'),
            ('pop 0', 'delta', 'delta', 280, 'cc979df84a6292c49e64e59a44d11a36256a5b25e12f97c70fef55774b90b431'),
            ('pop 1', 'delta', 'delta', 279, '992c66a37a3843451d350137fc9ea246d29cbc64d3e203faa1bdd1b39fcbc415'),
            ('pop 2', 'delta', 'delta', 278, '4f66c55d6c0251b792c2810980946a2171e5f9b34b96612f6d8dea383eaf23c1'),
        ],
        fingerprint='1189bbed3b4d791f',
        retracts=5,
    ),
    "steady_16384x64": dict(
        rounds=[
            ('cold', 'full', 'cold', 261, 'f6f921ab5ce91dc503000e7fc3eb5bec5c8503b8f68925e6ff7d28a93069a47b'),
            ('repeat', 'full', 'no_delta', 261, 'f6f921ab5ce91dc503000e7fc3eb5bec5c8503b8f68925e6ff7d28a93069a47b'),
            ('warm+', 'delta', 'delta', 262, '4584211a7733302bbc828fe17b3a3ad49b564d1aeb88f7fe96e53c61924c73c3'),
            ('warm-', 'full', 'retract_impure', 261, 'f6f921ab5ce91dc503000e7fc3eb5bec5c8503b8f68925e6ff7d28a93069a47b'),
            ('round 0', 'delta', 'delta', 262, '5b4e9e16ec86cc8ddaedcc24e3f8e0bbf5e0b6b1b2535813ae524b5a207788fa'),
            ('round 1', 'full', 'retract_impure', 262, '62e6a33b792823e99652ecc6d07a2a9411a159d12ddedcffe8764c046b0f35e3'),
            ('round 2', 'delta', 'delta', 263, '692b460e6ad55b7f3dcc3e5458466e98e214992d4b1526951c9be95aa3022dec'),
            ('round 3', 'delta', 'delta', 264, 'f40a75dafe2e1178e2fb50d35b290c8bdd7d60275574c9066f0551c3706bfaae'),
            ('round 4', 'delta', 'delta', 265, 'b69b89c10762cab1016e4c40e167d3e9a1f7392eaf0e56e65bed1fc27a707c04'),
            ('round 5', 'delta', 'delta', 266, '46c1343d6c798ba2a395e50a70d99e1aee3455e2b4f7eb741696bd3cf68d5904'),
            ('round 6', 'delta', 'delta', 267, 'f95a57bc09717b2ae31e2d92f6a93a00af4a7fb4f504fe59d0fbfcfcd7a4ff69'),
            ('round 7', 'delta', 'delta', 268, '6f445c3a8e640e655ad85e77c0b02020e88d0a169bf78099df5475340173e418'),
            ('round 8', 'delta', 'delta', 269, '4a663c30c14fe6a458b1af6eb17176e160983874026b2ce3eefd4cb2547becf6'),
            ('round 9', 'delta', 'delta', 270, '518b62be4a27c8d0727f932ab47bdb520784e8fc826753d44084a66160748cf4'),
            ('round 10', 'full', 'retract_impure', 270, '605fc3bfa6234944b3252c0c7b638e3bd0964f39e9db08d7677db1abdfb94dc8'),
            ('round 11', 'full', 'retract_base', 270, 'a11346514e77e7f4140411e15d55573ffc202989e82aa977a1181417c7fd536c'),
        ],
        fingerprint='33cb023dc8e9d7dc',
        retracts=0,
    ),
}

# the objective cells (python tests/test_torch_objectives.py prints them:
# TPUScheduler on the CPU, mesh None, a fresh scheduler per solve, the JAX
# package at df8eb8b): objectives_mixed_16384x400 — mixed_pods(16384) over
# testing.mixed_pool_templates(400) (four family pools over
# instance_types(400), priciest first), max_claims=4096,
# KTPU_OBJECTIVE_K=4, under each policy; objectives_perpod_4096x400 —
# perpod_pods(4096, kinds=8) over the same pools, lexical and cost_min.
# Per policy: claims, unschedulable pods, $/h (objectives.oracle
# total_price_per_hour), claims_digest, and the objective rounds committed
# / replayed with their canonical / perturbed wins
OBJ_TYPES, OBJ_MAX_CLAIMS, OBJ_K = 400, 4096, 4
OBJ_MIXED_PODS = 16384
OBJ_PERPOD_PODS, OBJ_PERPOD_KINDS = 4096, 8
OBJ_MIXED_GOLDEN = {
    "lexical": (3277, 0, 1015.6989, "19bddc3295f40da9a8e3672174c8b173ff15c5a43ccd5a84488e663765f424eb", 0, 0, 0, 0),
    "cost_min": (3277, 0, 395.2077, "b8a5bd75e77e8902d452443ad81988eb039033249112b2647e10b816d1d22da4", 31, 0, 23, 8),
    "frag_aware": (3277, 0, 443.7228, "53b91bde4a12901929733dcbc9cc5772a91f3a24e7111861873e75753589dc66", 31, 0, 31, 0),
    "topo_spread": (3277, 0, 1015.6989, "19bddc3295f40da9a8e3672174c8b173ff15c5a43ccd5a84488e663765f424eb", 31, 0, 31, 0),
    "gang_slice": (3277, 0, 1015.6989, "19bddc3295f40da9a8e3672174c8b173ff15c5a43ccd5a84488e663765f424eb", 31, 0, 31, 0),
}
OBJ_PERPOD_GOLDEN = {
    "lexical": (136, 0, 404.9006, "4a27bb66dcffd70eef273203b33adae0ee7b8ad64bc43a5b03869957cdc87a44", 0, 0, 0, 0),
    # every kind per-pod: no fill group, so no objective round
    "cost_min": (136, 0, 117.844, "d4995ed13516c978f5e0b0a23425fd1626615e022bf1b2e597013c9cf8a83276", 0, 0, 0, 0),
}

# dp speculation (TorchScheduler(dp=N)): shard_8192x200 is the JAX
# package's bench.py shard stage (selector_pods(8192) x make_templates(200),
# max_claims=2048, pipeline_min_pods=1024) with its twins at 512 pods
# (pipeline_min_pods=256): zonal, hostname, 2-cpu "eb" pods over two part-
# full existing nodes, per-pod kinds at solve_chunk 128, and the same per-
# pod kinds over minValues templates under a cpu budget; then the north
# star, the zonal kind scan and the per-pod cell at dp 2 / 2 / 4 and the
# constrained cell at dp 4. Each cell's (claims, unschedulable, $/h,
# digest) and the JAX package's last_timings["shard"] counters on the
# virtual 8-device mesh split as the cell's dp (python
# tests/test_torch_shard.py); the results equal the sequential goldens.
def shard_golden(dp: int, family: str, rounds: tuple) -> dict:
    """testing.shard_counters of a cell whose groups all speculate in one
    family: rounds = (merge rounds, groups committed, groups replayed, dp
    rows committed, replayed, idle)."""
    n, com, rep, rc, rr, ri = rounds
    fams = ("fill", "existing", "topo_fill", "kscan", "perpod")
    return dict(merge_rounds=n, groups_committed=com, groups_replayed=rep, verdict_fetches=n, verdict_bytes=4 * n,
                dp_rows_total=dp * n, dp_rows_committed=rc, dp_rows_replayed=rr, dp_rows_idle=ri,
                families={f: [com, rep] if f == family else [0, 0] for f in fams},
                coverage={f: [com + rep, 0] if f == family else [0, 0] for f in fams})


# every cell: 4 groups in 3 rounds, the first row committed
_R2, _R4 = (3, 1, 3, 1, 4, 1), (3, 1, 3, 1, 6, 5)
SHARD_GOLDEN = {  # label: (claims, unschedulable, $/h, digest, dp, family, rounds)
    "shard_8192x200": (187, 0, 289.8397, "490e0b4e6c3961442cd582338264949cc682659fbe88b2d5509550e38288bbc5", 2,
                       "fill", _R2),
    "shard_8192x200 zonal twin": (20, 0, 15.1482, "29f2720cd360ed2f953973ca0e439827137d12dc06fc7da3755a4e2c7e5f3b6d",
                                  2, "kscan", _R2),
    "shard_8192x200 hostname twin": (64, 0, 28.5146,
                                     "baaa3880015c0b2d09148d32d4c38ff3c075d9e2592883ca6f20ca201438b14f", 2,
                                     "topo_fill", _R2),
    "shard_8192x200 existing twin": (17, 0, 14.7027,
                                     "4c808b7af781d1bcda1f66eecafa2ee157ce2cbba0bbc28a873bf655cdd9741b", 2,
                                     "existing", _R2),
    "shard_8192x200 perpod twin": (20, 0, 18.3943, "82c9b741d97c8e63fc2eca2d790aa6d51b96dc522c7b510f95c39c762bad9265",
                                   2, "perpod", _R2),
    "shard_8192x200 mv+budget twin": (20, 0, 18.3943,
                                      "4a005c4badac3d7b40c8ada3c88a4bc4dd685c19f0f35d29e15007c8d6e7c863", 2, "perpod",
                                      _R2),
    "shard_northstar_100000x1000_dp2": (2273, 0, 3149.6813,
                                        "f93e2d85fcf69919951f92ceefffd3f24a1195d89061a47340507bc1713e72de", 2, "fill",
                                        _R2),
    "shard_zonal_4096x400_dp2": (136, 0, 117.844, "7078c3cd9aa7581c7822d44ed5008830fb70eb904b03b82541745bc4d2641058",
                                 2, "kscan", _R2),
    "shard_perpod_4096x400_dp4": (136, 0, 143.0965, PERPOD_DIGEST, 4, "perpod", _R4),
    "shard_constrained_4096x400_dp4": (*CONSTRAINED_GOLDEN, 4, "perpod", _R4),
}
# the cells whose first round and first commit phase 3 holds H12-H14 to
# (fill with existing-node debits, kind scan, per-pod: each of H12's modes
# and H14's); the first one's round is timed
SHARD_KERNEL_CELLS = ("shard_8192x200 existing twin", "shard_8192x200 zonal twin", "shard_perpod_4096x400_dp4")
# the dp cells whose warm solve also lists the lines that made the host
# wait (sync_points): the fill family's and the per-pod family's
SYNC_DP_CELLS = ("shard_8192x200", "shard_perpod_4096x400_dp4")

# warm calls after a cell's cold call, each held to the cold result (one,
# so that the whole run stays well inside its time limit on a slow host)
WARM_CALLS = 1
# scenarios of the what-if cells' batch run to the end through the
# per-pod kernel and the plain loop in phase 3 (the plain loop is slow)
WHATIF_SUB = 2

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


# one record per call shape phase 3 times (kernel, label, equal, times,
# bound): kernel_timing.py prints them
CALL_SHAPES: list = []

# the device kernels of H1-H6 by name
H1_NAMES = ("req_intersects_kernel",)
H2_NAMES = ("fill_grid_kernel",)
H3_NAMES = ("water_fill_rows", "water_fill_chunks")
H4_NAMES = ("compact_scatter_kernel",)
H5_NAMES = ("kscan_grid_kernel",)
H6_NAMES = ("pod_loop_kernel",)
H9_NAMES = ("gang_scan_kernel",)
H11_NAMES = ("objective_verdict_kernel",)
H12_NAMES = ("dp_dead_kernel",)
H13_NAMES = ("dp_verdict_kernel",)
H14_NAMES = ("merge_shard_kernel",)
H15_NAMES = ("wire_pack_kernel",)


def kernel_device(by_name: dict, names: tuple) -> tuple[int, float]:
    """(launches, device ms) of the profiled kernels whose name holds one of `names`."""
    hits = [v for n, v in by_name.items() if any(k in n for k in names)]
    return sum(c for c, _ms in hits), sum(ms for _c, ms in hits)


def launch_times(run, names: tuple, setups: list, tag: str) -> dict:
    """One launcher call timed three ways, each over the prepared inputs
    `setups` (run(x) once per x; their set-up is outside every timer):
    launcher_ms, the host's time per call with nothing waited for; event_ms,
    CUDA events around the back-to-back calls, per call (the larger of the
    launcher and the kernel); device_ms, the kernel's device time per launch
    from torch.profiler over the calls (None when the profile holds no
    launch)."""
    import torch

    run(setups[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in setups:
        run(x)
    host = (time.perf_counter() - t0) / len(setups) * 1e3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for x in setups:
        run(x)
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / len(setups)
    by_name = profile_run(lambda: [run(x) for x in setups], os.path.join("build", "profile"), tag,
                          quiet=True, tries=3)["by_name"]
    n, ms = kernel_device(by_name, names)
    return dict(launcher_ms=host, event_ms=ev, device_ms=ms / n if n else None, device_launches=n,
                calls=len(setups), device_call_ms=ms / len(setups) if n else None)


def fmt_times(t: dict) -> str:
    dev = f"{t['device_ms']:.5f}" if t["device_ms"] is not None else "not measured"
    if t["device_ms"] is not None and t["device_launches"] != t["calls"]:
        dev += f" device_call_ms={t['device_call_ms']:.5f} ({t['device_launches']} launches, {t['calls']} calls)"
    return f"device_ms={dev} event_ms={t['event_ms']:.4f} launcher_ms={t['launcher_ms']:.4f}"


def h2_cases(sched, comb, g) -> list:
    """H2's call shapes on the north star's catalog (T = 1000) and a window
    of W = 4096 claim rows: (label, kernel call, plain call, bytes, ops)
    for the tier-2 caps (mode 0, W rows) and fits_final (mode 1, W rows),
    tier 3's fits_off0 (mode 1, G template rows), f_new0 (mode 0, one row)
    and fits_new (mode 1, W rows on one broadcast usage and mask row), and
    the compaction's liveness test (mode 1, W rows, no offering gate).
    Bytes: each input read once and the output written once; operations:
    per cell the count's R subtract-and-divide and two R-wide fma checks
    plus the Z x C offering test (mode 0, viable cells), one R-wide fma
    check and the offering test (mode 1)."""
    import torch

    from karpenter_tpu_torch.ops import solver
    from karpenter_tpu_torch.testing import selector_pods

    dev = torch.device("cuda")
    it = sched.it_tensors
    T, GR, R = it.alloc.shape
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    W = comb.mask.shape[0]
    zone_kid, ct_kid = sched.encoder.zone_ct_key_ids()
    _sorted, enc = sched._encode(selector_pods(16), None)
    tm = enc["template_tensors"]
    G = tm.its.shape[0]
    daemon, tmask = tm.daemon_requests.contiguous(), tm.reqs.mask.contiguous()
    used = (torch.rand((W, R), generator=g) * it.alloc[:, 0, :].max(0).values.cpu() * 0.5).to(dev)
    req = (it.alloc[int(torch.randint(0, T, (1,), generator=g))][0] * 0.03).contiguous()
    viable = (torch.rand((W, T), generator=g) < 0.5).to(dev)
    counts = torch.randint(0, 8, (W,), generator=g, dtype=torch.int32).to(dev)
    ones_w, ones_g = torch.ones(W, dtype=torch.int32, device=dev), torch.ones(G, dtype=torch.int32, device=dev)
    cat = nbytes(it.alloc, it.zc_avail, it.group_valid)

    def off(mask):
        return None if mask is None else solver.off_for_plain(mask, it, zone_kid, ct_kid)

    def caps(u, v, m):
        return (lambda: solver.claim_fill_caps(u, v, req, it, m, zone_kid, ct_kid),
                lambda: solver.claim_fill_caps_plain(u, v, req, it, off(m)),
                nbytes(u, v, req) + cat + (m.shape[0] * 2 * m.shape[2]) + 4 * v.shape[0],
                int(v.sum().item()) * GR * (2 * R + 6 * R + Z * C))

    def fits(u, n, m, q=req):
        kid = (zone_kid, ct_kid) if m is not None else (0, 0)
        rows = n.shape[0]
        return (lambda: solver.fits_off_counted(u, n, q, it, m, *kid),
                lambda: solver.fits_off_counted_plain(u, n, q, it, off(m)),
                nbytes(u, n, q) + cat + (0 if m is None else m.shape[0] * 2 * m.shape[2]) + rows * T,
                rows * T * GR * (3 * R + (Z * C if m is not None else 0)))

    r_min = (req * 0.5).contiguous()
    return [
        ("tier-2 caps (mode 0, W rows)", 0, *caps(used, viable, comb.mask)),
        ("tier-2 fits_final (mode 1, W rows)", 1, *fits(used, counts, comb.mask)),
        (f"tier-3 fits_off0 (mode 1, G = {G} rows)", 1, *fits(daemon, ones_g, tmask)),
        ("tier-3 f_new0 (mode 0, one row)", 0, *caps(daemon[:1], viable[:1].contiguous(), tmask[:1])),
        ("tier-3 fits_new (mode 1, W rows, broadcast used and mask)", 1, *fits(daemon[:1], counts, tmask[:1])),
        ("compaction liveness (mode 1, W rows, no offering gate)", 1, *fits(used, ones_w, None, r_min)),
    ]


def h1_bound(a, b, out) -> tuple[float, str]:
    """H1's least time: each input read once and the output written once,
    or 15 operations a shared (row, type, key) triple."""
    shared = (a.defined[:, None, :] & b.defined[None, :, :]).sum().item()
    return bound(nbytes(*a, *b, out), 15.0 * shared)


def h1_multiword(g, dev) -> list:
    """Seeded claim rows and catalogs past one 32-key word: K = 70 keys
    (three words) at V = 16 and V = 64 values, about two keys shared a
    pair, NotIn / DoesNotExist keys and bounds down to INT_MIN."""
    import torch

    from karpenter_tpu_torch.ops.encode import INT_MAX, INT_MIN, ReqSetTensors

    def sets(n, K, V, p_def):
        kind = torch.randint(0, 5, (n, K), generator=g)
        mask = torch.rand((n, K, V), generator=g) < 0.3
        mask[kind == 2] = ~mask[kind == 2]
        mask[kind == 4] = False
        inf = (kind >= 2) & (kind != 4)
        gte = torch.randint(-6, 6, (n, K), generator=g, dtype=torch.int32)
        lte = gte + torch.randint(-3, 8, (n, K), generator=g, dtype=torch.int32)
        wide = torch.rand((n, K), generator=g) < 0.3
        gte[wide], lte[wide] = INT_MIN, INT_MAX
        defined = torch.rand((n, K), generator=g) < p_def
        return ReqSetTensors(*(x.contiguous().to(dev) for x in (mask, inf, kind == 2, gte, lte, defined)))

    return [(f"K = 70 keys, V = {V} (three key words; seeded, {A} x {B})", sets(A, 70, V, 3.0 / 70),
             sets(B, 70, V, 0.7)) for A, B, V in ((4096, 1000, 16), (37, 400, 64))]


def h1_cases(cases: list) -> dict:
    """H1 in each call shape (label, a, b): exact against the plain version,
    with device, event and launcher ms and the bound; "main" holds the
    first case's (out_k, out_p, times, plain ms, bound)."""
    import torch

    from karpenter_tpu_torch.ops import kernels

    equal, main = True, None
    for label, a, b in cases:
        out_k, out_p = kernels.intersects(a, b), kernels.intersects_plain(a, b)
        eq = torch.equal(out_k, out_p)
        equal = equal and eq
        t = launch_times(lambda _x: kernels.intersects(a, b), H1_NAMES, [None] * 20, "req_intersects")
        bd = h1_bound(a, b, out_k)
        print(f"kernel req_intersects ({label}): equal={eq} (tolerance: exact) {fmt_times(t)} "
              f"bound_ms={bd[0]:.5f} ({bd[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="req_intersects", label=label, equal=eq, bound_ms=bd[0], **t))
        if main is None:
            main = (out_k, out_p, t, time_ms(lambda: kernels.intersects_plain(a, b), iters=5), bd)
    return dict(equal=equal, main=main)


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

    # H1 req_intersects in each call shape: tier 2's W claim rows and tier
    # 3's G template rows against the catalog, and a seeded multi-word
    # catalog; the kernels line carries tier 2's device time
    from karpenter_tpu_torch.testing import selector_pods

    _sorted, enc = sched._encode(selector_pods(16), None)
    tm = ReqSetTensors(*(x.contiguous() for x in enc["template_tensors"].reqs))
    h1 = h1_cases([("tier 2 (W = 4096 claim rows, T = 1000)", comb, it.reqs),
                   (f"tier 3 (G = {tm.mask.shape[0]} template rows, T = 1000)", tm, it.reqs),
                   *h1_multiword(g, dev)])
    out_k, out_p, t, plain_ms, b = h1["main"]
    record(
        "req_intersects", "karpenter_tpu_torch/ops/csrc/req_intersects.cu",
        "karpenter_tpu/ops/kernels.py:54", out_k, out_p,
        t["device_ms"] if t["device_ms"] is not None else t["event_ms"], plain_ms, b,
    )
    results[-1].update(event_ms=t["event_ms"], launcher_ms=t["launcher_ms"])
    if not h1["equal"]:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0

    # H2 fill_count_grid: every call shape of the fill step and the
    # compaction, each exact against its plain version; the kernels line
    # carries the tier-2 caps call's device time
    h2_equal, h2_main = True, None
    for label, mode, run_k, run_p, nb, nops in h2_cases(sched, comb, g):
        out_k, out_p = run_k(), run_p()
        eq = torch.equal(out_k, out_p)
        h2_equal = h2_equal and eq
        t = launch_times(lambda _x: run_k(), H2_NAMES, [None] * 20, "fill_count_grid")
        b = bound(nb, nops)
        print(f"kernel fill_count_grid ({label}): equal={eq} (tolerance: exact) {fmt_times(t)} "
              f"bound_ms={b[0]:.5f} ({b[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="fill_count_grid", label=label, equal=eq, bound_ms=b[0], **t))
        if h2_main is None:
            plain_ms = time_ms(run_p, iters=3)
            h2_main = (out_k, out_p, t, plain_ms, b)
    out_k, out_p, t, plain_ms, b = h2_main
    record(
        "fill_count_grid", "karpenter_tpu_torch/ops/csrc/fill_count_grid.cu",
        "karpenter_tpu/ops/solver.py:1355", out_k, out_p,
        t["device_ms"] if t["device_ms"] is not None else t["event_ms"], plain_ms, b,
    )
    results[-1].update(event_ms=t["event_ms"], launcher_ms=t["launcher_ms"])
    if not h2_equal:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0
    used = (torch.rand((W, R), generator=g) * it.alloc[:, 0, :].max(0).values.cpu() * 0.5).to(dev)
    viable = rand_bool(W, T, p=0.5)

    # H3 water_fill in each call shape: the fill step's window, a window of
    # 131072 rows, and the edges of its closed form; the kernels line
    # carries the window's device time
    h3 = h3_cases(g, dev)
    p, f = h3["window"]
    out_k, out_p, t, plain_ms, b = h3["main"]
    record(
        "water_fill", "karpenter_tpu_torch/ops/csrc/water_fill.cu",
        "karpenter_tpu/ops/solver.py:1402", out_k, out_p,
        t["device_ms"] if t["device_ms"] is not None else t["event_ms"], plain_ms, b,
    )
    results[-1].update(event_ms=t["event_ms"], launcher_ms=t["launcher_ms"])
    if not h3["equal"]:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0

    # H4 compact_scatter in each call shape of compact_state and
    # global_claims at the north star's window, and a compaction at W =
    # 131072 (100k pods without max_claims); the kernels line carries the
    # compaction's device time
    NB = W
    alive = rand_bool(W, p=0.5)
    ids = torch.where(alive, torch.randperm(W, generator=g).to(dev).to(torch.int32),
                      torch.full((W,), NB, dtype=torch.int32, device=dev))
    template = torch.arange(W, dtype=torch.int32, device=dev)
    held = torch.zeros((W, 1), dtype=torch.bool, device=dev)
    window = list(comb) + [used, viable, f, alive.clone(), p, template,
                           torch.zeros((W, 1), dtype=torch.int32, device=dev), held]
    Wl = 131072
    big = [rand_bool(Wl, K, V), torch.rand((Wl, R), generator=g).to(dev), rand_bool(Wl, T),
           torch.randint(0, 99, (Wl,), generator=g, dtype=torch.int32).to(dev)]
    h4 = h4_cases([
        ("compaction (mode 0, the 14 window fields, W = 4096)", 0, alive, window, W),
        ("bank (mode 1, compact_state's 5 bank columns)", 1, ids,
         [torch.ones(W, dtype=torch.bool, device=dev), template, viable, used, held], NB),
        ("drop scatter (mode 1, the 14 window fields)", 1, ids, window, NB),
        ("global_claims (mode 1, 4 columns over the bank)", 1, ids, [template, viable, used, held], NB),
        (f"compaction (mode 0, W = {Wl})", 0, rand_bool(Wl, p=0.5), big, Wl),
    ])
    out_k, out_p, t, plain_ms, b = h4["main"]
    record(
        "compact_scatter", "karpenter_tpu_torch/ops/csrc/compact_scatter.cu",
        "karpenter_tpu/ops/solver.py:843", out_k, out_p,
        t["device_call_ms"] if t["device_call_ms"] is not None else t["event_ms"], plain_ms, b,
    )
    results[-1].update(event_ms=t["event_ms"], launcher_ms=t["launcher_ms"])
    if not h4["equal"]:
        results[-1]["equal"] = False
        results[-1]["max_abs_err"] = 1.0
    return results


def h3_cases(g, dev) -> dict:
    """H3 in each call shape, exact against water_fill_plain, with device,
    event and launcher ms and the bound (p and f read once, the result
    written once; 24 bisection steps of 4 operations a row and 10 a row
    for the final pass): the fill step's window (W = 4096: counts 0-39,
    capacities 0-5, 3000 pods), W = 131072 (100k pods without
    max_claims), counts up to 2^25 (max(p) + rem + 1 past 2^24: the 24
    steps stop short of the level), counts up to 2^31 - 1 (every sum and
    level wraps in two's complement), rem = 0, and sum(f) <= rem. "main"
    holds the window's (out_k, out_p, times, plain ms, bound), "window" its
    (p, f)."""
    import torch

    from karpenter_tpu_torch.ops import solver

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32).to(dev)

    def rem_of(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    W, Wl = 4096, 131072
    cases = [
        ("the window (W = 4096, 3000 pods)", ints(0, 40, W), ints(0, 6, W), rem_of(3000)),
        (f"W = {Wl}, 200000 pods", ints(0, 40, Wl), ints(0, 6, Wl), rem_of(200_000)),
        ("W = 4096, counts up to 2^25 (the bisection stops short)", ints(0, 1 << 25, W), ints(0, 6, W),
         rem_of(3000)),
        ("W = 4096, counts up to 2^31 - 1 (sums and levels wrap)", ints(0, (1 << 31) - 1, W), ints(0, 6, W),
         rem_of(3000)),
        ("W = 4096, rem = 0", ints(0, 40, W), ints(0, 6, W), rem_of(0)),
        ("W = 4096, sum(f) <= rem", ints(0, 40, W), ints(0, 6, W), rem_of(100_000)),
    ]
    equal, main = True, None
    for label, p, f, rem in cases:
        out_k, out_p = solver.water_fill(p, f, rem), solver.water_fill_plain(p, f, rem)
        eq = torch.equal(out_k, out_p)
        equal = equal and eq
        t = launch_times(lambda _x: solver.water_fill(p, f, rem), H3_NAMES, [None] * 20, "water_fill")
        n = p.shape[0]
        bd = bound(nbytes(p, f, out_k) + 4, 24.0 * n * 4 + 10.0 * n)
        print(f"kernel water_fill ({label}): equal={eq} (tolerance: exact) {fmt_times(t)} "
              f"bound_ms={bd[0]:.7f} ({bd[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="water_fill", label=label, equal=eq, bound_ms=bd[0], **t))
        if main is None:
            main = (out_k, out_p, t, time_ms(lambda: solver.water_fill_plain(p, f, rem), iters=10), bd)
    return dict(equal=equal, main=main, window=cases[0][1:3])


def h4_cases(cases: list) -> dict:
    """H4 in each call shape (label, mode, sel, srcs, destination rows[,
    tk, tk_srcs]): the destinations start filled with a pattern (the rows
    nobody writes must keep it), the kernel twice against the plain
    version, with device (per call), event and launcher ms and the bound
    (each moved row read once and written once); "main" holds the first
    case's (equal as a tensor, True, times, plain ms, bound)."""
    import torch

    from karpenter_tpu_torch.ops import solver

    equal, main = True, None
    for label, mode, sel, srcs, n_dst, *rest in cases:
        tk, tk_srcs = rest if rest else ((), [])

        def filled(shape, dtype):
            n = math.prod(shape)
            return torch.arange(n, device=sel.device).remainder(3).to(dtype).reshape(shape)

        def fresh():
            return ([filled((n_dst,) + tuple(s.shape[1:]), s.dtype) for s in srcs],
                    [filled((n_dst, len(tk)) + tuple(s.shape[2:]), s.dtype) for s in tk_srcs])

        dk, tdk = fresh()
        dk2, tdk2 = [d.clone() for d in dk], [d.clone() for d in tdk]
        dp, tdp = [d.clone() for d in dk], [d.clone() for d in tdk]
        solver.compact_scatter(mode, sel, srcs, dk, tk, tk_srcs, tdk)
        solver.compact_scatter(mode, sel, srcs, dk2, tk, tk_srcs, tdk2)  # a second launch: the workspace reset
        solver.compact_scatter_plain(mode, sel, srcs, dp, tk, tk_srcs, tdp)
        eq = all(torch.equal(x, y) for x, y in zip(dk + tdk, dp + tdp))
        eq = eq and all(torch.equal(x, y) for x, y in zip(dk2 + tdk2, dp + tdp))
        equal = equal and eq
        t = launch_times(lambda _x: solver.compact_scatter(mode, sel, srcs, dk, tk, tk_srcs, tdk), H4_NAMES,
                         [None] * 20, "compact_scatter")
        keep = sel if mode == 0 else (sel >= 0) & (sel < n_dst)
        moved = int(keep.sum().item())
        row_bytes = sum(d[0].numel() * d.element_size() for d in dk + tdk)
        bd = bound(2 * moved * row_bytes + nbytes(sel), 0.0)
        print(f"kernel compact_scatter ({label}): equal={eq} (tolerance: exact) {fmt_times(t)} "
              f"bound_ms={bd[0]:.5f} ({bd[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="compact_scatter", label=label, equal=eq, bound_ms=bd[0], **t))
        if main is None:
            plain_ms = time_ms(lambda: solver.compact_scatter_plain(mode, sel, srcs, dp, tk, tk_srcs, tdp), iters=5)
            main = (torch.tensor(eq), torch.tensor(True), t, plain_ms, bd)
    return dict(equal=equal, main=main)


def kscan_kernel_phase(sched, enc, results: list, rank_enc: Optional[dict] = None) -> None:
    """Phase 3b: H4's topology-key mode, H5 and H6 against their plain
    versions at the kind scan's shapes on the mixed_pods path: the real
    encoded catalog of make_templates(400) and its topology tensors (NGv 2,
    NGh 4), a window of W = 4096 claim rows, D = 4 zones; H6 runs one
    segment of 256 pods over seeded counts and domain sets, with open
    rows, fresh rows opening during the segment, and the claim-slot
    capacity running out, and once more with the zone counts past 2^15
    (where the rank key wraps), and once with tier 3 under cost_min's
    template rank over the four family pools (`rank_enc`, an encode of
    objectives_mixed_16384x400's scheduler). Exact equality."""
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

    h4t = h4_cases([(f"topology-key bank (mode 1, 4 columns + 3 key-row fields, tk={tk})", 1, ids, srcs, NCAP,
                     tk, tk_srcs)])
    # H1 at the kind step's shapes: tier 2's W claim rows and tier 3's G
    # template rows against the mixed cell's catalog (T = 400)
    tm = ReqSetTensors(*(x.contiguous() for x in templates.reqs))
    h1 = h1_cases([("kind step tier 2 (W = 4096 claim rows, T = 400)", comb, it.reqs),
                   (f"kind step tier 3 (G = {tm.mask.shape[0]} template rows, T = 400)", tm, it.reqs)])
    for name, ok in (("compact_scatter", h4t["equal"]), ("req_intersects", h1["equal"])):
        if not ok:
            row = next(r for r in results if r["name"] == name)
            row["equal"], row["max_abs_err"] = False, 1.0

    # H5 kscan_grid in each call shape of the kind step, on the zone key and
    # on the capacity-type key; the kernels line carries mode 0's device
    # time at tier 2 on the zone key
    req = enc["kinds"]["requests"][1].contiguous()
    h5 = h5_cases(sched, enc, comb, used, req, g)
    t, plain_ms, b = h5["main"]
    entry(
        "kscan_grid", "karpenter_tpu_torch/ops/csrc/kscan_grid.cu", "karpenter_tpu/ops/solver.py:2751",
        h5["equal"], t["device_ms"] if t["device_ms"] is not None else t["event_ms"], plain_ms, b,
    )
    results[-1].update(event_ms=t["event_ms"], launcher_ms=t["launcher_ms"])

    # H6 kscan_pod_loop: one segment of 256 pods; last, tier 3 under a
    # placement objective's rank (cost_min's over the four family pools,
    # rank_enc: the weight order reversed)
    count = maxc = 256
    w_open0, n_open0 = 3800, NCAP - 30  # 30 claim slots left
    ar = torch.arange(W, device=dev)
    slot_of = torch.where(ar < w_open0, ar + n_open0 - w_open0, torch.full_like(ar, NCAP)).to(torch.int32)
    checks = []
    times = []
    timed = None
    cases = [("zone spread", 0, 0, enc), ("zone affinity", 1, 0, enc), ("zone spread, counts past 2^15", 0, BIG_COUNT, enc)]
    if rank_enc is not None:
        cases.append(("zone spread, cost_min rank over four pools", 0, 0, rank_enc))
    for variant, grp, big, c_enc in cases:
        templates, topo = c_enc["template_tensors"], c_enc["topo_tensors"]
        E, G = c_enc["E"], templates.its.shape[0]
        NGv, NGh = topo.vg_type.shape[0], topo.hg_type.shape[0]
        S = topo.hg_counts0.shape[1]
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
        opened_t = ck.tmpl_n[w_open0:int(ck.w_open)].tolist()
        hist = {k: int(v) for k, v in (
            ("existing", ((ak >= 0) & (ak < E)).sum()), ("claims", (ak >= E).sum()),
            ("no_room", (ak == solver.NO_ROOM).sum()), ("no_claim", (ak == solver.NO_CLAIM).sum()),
            ("opened", ck.n_open - n_open0))}
        hist["opened_templates"] = sorted(set(opened_t))
        if templates.rank is not None:
            hist["rank"] = templates.rank.tolist()
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
        t = sum(a.elapsed_time(b) for a, b in ev) / len(ev)
        if c_enc is not enc:
            # the same launch in weight order, for the rank's cost
            lex = templates._replace(rank=None)
            t_lex = launch_ms(lambda c: solver.kscan_pod_loop(inp, c, topo, lex, count, maxc, NCAP),
                              [clone(carry0) for _ in range(10)])
            print(f"kernel kscan_pod_loop ({variant}): ms={t:.4f}; the same inputs in weight order "
                  f"ms={t_lex:.4f}", flush=True)
            continue
        times.append(t)
        timed = timed or (inp, carry0, topo, templates, ck)
    inp, carry0, topo, templates, ck = timed
    plain_ms = time_ms(lambda: solver.kscan_pod_loop_plain(
        inp, clone(carry0), topo, templates, count, maxc, NCAP), iters=2, warmup=1)
    th6 = launch_times(lambda c: solver.kscan_pod_loop(inp, c, topo, templates, count, maxc, NCAP), H6_NAMES,
                       [clone(carry0) for _ in range(10)], "kscan_pod_loop")
    print(f"kernel kscan_pod_loop (zone spread, {count} pods, W={W}, D={D}): {fmt_times(th6)} "
          f"(events around each launch alone: {sum(times) / len(times):.4f})", flush=True)
    b, live = h6_bound(inp, carry0, ck, topo, count)
    print(f"kernel kscan_pod_loop (zone spread): {live} live rows, bound_ms={b[0]:.7f} ({b[1]})", flush=True)
    # a segment whose live rows overflow the kernel's shared-memory staging
    # (W = 8192, D = 16: 8192 records staged, the rest in its workspace)
    eq_o = overflow_phase(g)
    checks.append(eq_o)
    entry(
        "kscan_pod_loop", "karpenter_tpu_torch/ops/csrc/kscan_pod_loop.cu",
        "karpenter_tpu/ops/solver.py:3093", all(checks),
        th6["device_ms"] if th6["device_ms"] is not None else sum(times) / len(times), plain_ms,
        b,
    )
    results[-1].update(event_ms=th6["event_ms"], launcher_ms=th6["launcher_ms"])


def h5_cases(sched, enc, comb, used, req, g) -> dict:
    """H5 in each call shape of the kind step at the mixed cell's catalog
    (T = 400), each exact against its plain version, with device, event and
    launcher ms and the bound: mode 0 (grid and capd) on tier 2's W = 4096
    claim rows and on tier 3's G template rows, mode 1 (capd of a reused,
    debited grid) and mode 2 (fits-final), each on the zone key (D = the
    zones) and on the capacity-type key (D = C). Bytes: each input read
    once (a row's zone and capacity-type mask rows, the catalog) and each
    output written once; operations: per cell the count of count_cell.cuh
    (R subtract+divide, three R-wide fma checks) and the D x C offering
    test (modes 0 / 1), the Z x C one (mode 2). "main" holds mode 0's at
    tier 2 on the zone key: (times, plain ms, bound)."""
    import torch

    from karpenter_tpu_torch.ops import solver

    dev = used.device
    it = sched.it_tensors
    T, GR, R = it.alloc.shape
    V = it.reqs.mask.shape[2]
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    zone_kid, ct_kid = enc["zone_kid"], enc["ct_kid"]
    tm = enc["template_tensors"]
    W, G = used.shape[0], tm.its.shape[0]
    tmask = tm.reqs.mask.contiguous()

    def rand_bool(*shape, p=0.5):
        return (torch.rand(shape, generator=g) < p).to(dev)

    cat = nbytes(it.alloc, it.zc_avail, it.group_valid, it.reqs.defined[:, 0], it.reqs.mask[:, 0, :16])
    viable, viable_g = rand_bool(W, T, p=0.6), rand_bool(G, T, p=0.6)
    placed = torch.randint(0, 6, (W,), generator=g, dtype=torch.int32).to(dev)
    ct_m, z_m = comb.mask[:, ct_kid, :].contiguous(), comb.mask[:, zone_kid, :].contiguous()
    cases = []
    for key, key_kid, D in (("zone key", zone_kid, len(sched.encoder.vocab.values[zone_kid])),
                            ("capacity-type key", ct_kid, C)):
        kid = (zone_kid, ct_kid, key_kid, D)
        grid_p, capd_p = solver._kscan_grid_plain(used, req, it, viable, comb.mask, *kid)
        debited = torch.clamp(grid_p - torch.randint(0, 3, (W, 1, 1), generator=g, dtype=torch.int32).to(dev),
                              min=0).contiguous()
        zset = rand_bool(W, D, p=0.5)
        cells, cells_g = W * T * GR, G * T * GR
        grid_ops = 2 * R + 9 * R + D * C
        for label, run_k, run_p, nb, nops in (
            (f"mode 0, tier 2 (W = {W} claim rows), {key}, D = {D}",
             lambda u=used, v=viable, m=comb.mask, kid=kid: solver.kscan_grid(u, req, it, v, m, *kid),
             lambda u=used, v=viable, m=comb.mask, kid=kid: solver._kscan_grid_plain(u, req, it, v, m, *kid),
             nbytes(used, req, viable, grid_p, capd_p) + cat + W * 2 * V, cells * grid_ops),
            (f"mode 0, tier 3 (G = {G} template rows), {key}, D = {D}",
             lambda kid=kid: solver.kscan_grid(tm.daemon_requests, req, it, viable_g, tmask, *kid),
             lambda kid=kid: solver._kscan_grid_plain(tm.daemon_requests, req, it, viable_g, tmask, *kid),
             nbytes(tm.daemon_requests, req, viable_g) + G * T * GR * 4 + G * D * 4 + cat + G * 2 * V,
             cells_g * grid_ops),
            (f"mode 1 (capd of a reused grid, W = {W}), {key}, D = {D}",
             lambda kid=kid, d=debited: solver.kscan_grid(used, req, it, viable, comb.mask, *kid, d),
             lambda kid=kid, d=debited: solver._kscan_grid_plain(used, req, it, viable, comb.mask, *kid, d),
             nbytes(debited, viable, capd_p) + cat + W * 2 * V, cells * D * C),
            (f"mode 2 (fits-final, W = {W}), {key}, D = {D}",
             lambda zs=zset, kk=key_kid, D=D, gp=grid_p: solver.kscan_fits_final(
                 gp, placed, zs, ct_m, z_m, it, kk, zone_kid, D),
             lambda zs=zset, kk=key_kid, D=D, gp=grid_p: solver.kscan_fits_final_plain(
                 gp, placed, zs, ct_m, z_m, it, kk, zone_kid, D),
             nbytes(grid_p, placed, zset, ct_m, z_m) + cat + W * T, cells * (1 + Z * C)),
        ):
            cases.append((label, run_k, run_p, nb, nops))
    equal, main = True, None
    for label, run_k, run_p, nb, nops in cases:
        out_k, out_p = run_k(), run_p()
        pairs = zip(out_k, out_p) if isinstance(out_k, tuple) else ((out_k, out_p),)
        eq = all(torch.equal(a, b) for a, b in pairs)
        equal = equal and eq
        t = launch_times(lambda _x: run_k(), H5_NAMES, [None] * 20, "kscan_grid")
        bd = bound(nb, nops)
        print(f"kernel kscan_grid ({label}): equal={eq} (tolerance: exact) {fmt_times(t)} "
              f"bound_ms={bd[0]:.5f} ({bd[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="kscan_grid", label=label, equal=eq, bound_ms=bd[0], **t))
        if main is None:
            main = (t, time_ms(run_p, iters=3), bd)
    return dict(equal=equal, main=main)


def h6_bound(inp, carry0, carry1, topo, count: int) -> tuple:
    """H6's bound on one segment, (bound, live rows). Bytes: the segment's
    inputs and the topology leaves the kernel reads, read once; the carry
    read once and written once; the assignment written once (none of it
    grows with the pods: the pods of a segment need each row's state only
    once, the kernel keeps it on chip). Operations: per pod, the NGv x D
    group terms of each live row, the rows this run's data makes
    candidates: existing nodes with room, the templates that pass the
    static test, the open window rows that pass it with capacity left, and
    the claims opened in the segment (from carry1, the kernel's carry)."""
    from karpenter_tpu_torch.ops import cuda

    live = (int((carry0.pl_e < inp.cap_e).sum()) + int(inp.static_g.sum())
            + int((inp.open0 & inp.static_n0 & (carry0.capd > 0).any(dim=1)).sum())
            + int(carry1.w_open) - int(inp.w_open0))
    NGv, D = carry0.cnt.shape
    moved = (nbytes(*inp) + nbytes(*(getattr(topo, n) for n, _dt in cuda._LOOP_TOPO))
             + 2 * nbytes(*carry0) + 4 * count)
    return bound(moved, count * live * NGv * D * 4.0), live


def overflow_segment(g, E: int = 512, W: int = 8192, G: int = 400, D: int = 16, count: int = 64):
    """A seeded kind-scan segment on the card whose live rows overflow
    H6's shared-memory staging: E existing nodes (caps 0-2), W window rows
    (the first W - 64 open, 95% static), G templates, a D-value zone key
    with a spread group (applies) and an affinity group (records), four
    hostname groups (spread and anti-affinity apply; counts at 5% of the
    slots in use). Returns (PodLoopIn, PodLoopCarry, topology, templates,
    count, n_claims)."""
    import types

    import torch

    from karpenter_tpu_torch.ops import solver, topology

    dev = torch.device("cuda")
    NGv, NGh, V = 2, 4, D + 4
    NCAP = W + 8
    S = E + NCAP + 1
    w_open0 = W - 64
    n_open0 = w_open0 + 8

    def b(*shape, p=0.5):
        return (torch.rand(shape, generator=g) < p).to(dev)

    def i(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(dev)

    def t(x, dt=torch.int32):
        return torch.tensor(x, dtype=dt, device=dev)

    topo = topology.TopologyTensors(
        vg_key=t([0, 0]), vg_type=t([0, 1]), vg_skew=t([2, 1]), vg_min_domains=t([0, 0]), vg_domains=b(NGv, V, p=0.9),
        vg_counts0=torch.zeros((NGv, V), dtype=torch.int32, device=dev), vg_rank=i(0, 8, NGv, V),
        vg_valid=t([True, True], torch.bool), hg_type=t([0, 2, 1, 0]), hg_skew=t([2, 1, 1, 3]),
        hg_counts0=torch.zeros((NGh, S), dtype=torch.int32, device=dev),
        hg_extra_nonempty=torch.zeros(NGh, dtype=torch.bool, device=dev), hg_valid=t([True] * NGh, torch.bool),
    )
    ar = torch.arange(W, device=dev)
    inp = solver.PodLoopIn(
        cap_e=i(0, 3, E), zie0=b(E, p=0.2), open0=ar < w_open0, static_n0=b(W, p=0.95), pods0=i(0, 20, W),
        zin0=b(W, p=0.1), static_g=b(G, p=0.9), capd_g=i(1, 6, G, D), z0_g=b(G, D, p=0.9), zinf_g=b(G, p=0.2),
        w_open0=t(w_open0), self_conf=t(False, torch.bool), key_touched=t(True, torch.bool),
        gate=t([True, False], torch.bool), recs=t([True, True], torch.bool), vg_self=t([True, True], torch.bool),
        pd=b(D, p=0.9), hg_applies=t([True, True, False, False], torch.bool), hg_records=t([True] * NGh, torch.bool),
        hg_self=t([True, False, True, True], torch.bool),
    )
    carry = solver.PodLoopCarry(
        zn=b(W, D, p=0.6), ze=b(E, D, p=0.6), capd=i(0, 4, W, D), pl_n=torch.zeros(W, dtype=torch.int32, device=dev),
        pl_e=torch.zeros(E, dtype=torch.int32, device=dev), tmpl_n=torch.zeros(W, dtype=torch.int32, device=dev),
        cnt=i(0, 3, NGv, D),
        hgc=((torch.rand((NGh, S), generator=g) < 0.05) & (torch.arange(S) < E + n_open0)).to(torch.int32).to(dev),
        n_open=t(n_open0), w_open=t(w_open0),
        slot_of=torch.where(ar < w_open0, ar + n_open0 - w_open0, torch.full_like(ar, NCAP)).to(torch.int32),
        spills=t(0),
    )
    return inp, carry, topo, types.SimpleNamespace(rank=None), count, NCAP


def overflow_phase(g) -> bool:
    """H6 on overflow_segment against the plain loop (assignment and every
    carry leaf, exact), with its times and the count of live rows past
    the kernel's 8192 staged records."""
    import torch

    from karpenter_tpu_torch.ops import solver

    inp, carry0, topo, tm, count, NCAP = overflow_segment(g)
    W, D = carry0.zn.shape
    E, G = carry0.ze.shape[0], inp.static_g.shape[0]

    def clone(c):
        return solver.PodLoopCarry(*(x.clone() for x in c))

    ck, cp = clone(carry0), clone(carry0)
    ak = solver.kscan_pod_loop(inp, ck, topo, tm, count, count, NCAP)
    ap = solver.kscan_pod_loop_plain(inp, cp, topo, tm, count, count, NCAP)
    eq = torch.equal(ak, ap) and all(torch.equal(a, b) for a, b in zip(ck, cp))
    t = launch_times(lambda c: solver.kscan_pod_loop(inp, c, topo, tm, count, count, NCAP), H6_NAMES,
                     [clone(carry0) for _ in range(5)], "kscan_pod_loop_overflow")
    b, live = h6_bound(inp, carry0, ck, topo, count)
    print(f"kernel kscan_pod_loop (overflow segment: W={W}, D={D}, E={E}, G={G}, {count} pods, about {live} live "
          f"rows, past the 8192 staged): equal={eq} (tolerance: exact) placed={int((ak >= 0).sum())} "
          f"{fmt_times(t)} bound_ms={b[0]:.7f} ({b[1]})", flush=True)
    return eq


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
    least feasible index — tier 3's position in the rank order — decides) each candidate row's live flag; a live
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
        # each template's position in tier 3's try order
        pos3 = (torch.arange(G, device=dev) if tm.rank is None
                else torch.argsort(kc.rank_order(tm.rank).long()))
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
            # (under a rank, up to the chosen template's position in the try order)
            cutp = torch.where(opened, pos3[cut3], torch.full_like(a, G - 1))
            upto3 = (pos3[None] <= cutp[:, None]) & reach3[:, None]
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


def whatif_kernel_phase(cell, results: list, n_sub: int = WHATIF_SUB) -> tuple:
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
    # n_sub scenarios to the end, the largest prefix among them
    n_real = len(specs)
    pick = torch.tensor(sorted({(n_real - 1) * j // (n_sub - 1) for j in range(n_sub)}), device=idx.device)
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
          f"{len(pick)} scenarios x {L} steps == plain: {eq_sub} {json.dumps(hist)}", flush=True)

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
    placements digest), WARM_CALLS warm calls that must agree. Returns the
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
    for i in range(WARM_CALLS):
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
    per chunk), WARM_CALLS warm solves with the same digest, one more under
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
    for i in range(WARM_CALLS):
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


def gang_cells(T, TorchScheduler) -> list:
    """The two gang cells' problems: label, pods, budgets, a scheduler,
    the JAX package's golden."""
    templates = T.make_templates(GANG_TYPES)
    st = GANG_STORM
    return [
        dict(label="gang_storm_64x16x400", pods=T.gang_storm_pods(st["n_gangs"], st["size"], st["singles"]),
             budgets=None, sched=TorchScheduler(templates, max_claims=st["max_claims"]), golden=GANG_STORM_GOLDEN),
        dict(label="gang_zonal_budget_4096x400", pods=T.gang_zonal_pods(),
             budgets={"default": {"cpu": T.GANG_ZONAL_CPU_LIMIT}},
             sched=TorchScheduler(templates, max_claims=GANG_ZONAL_MAX_CLAIMS), golden=GANG_ZONAL_GOLDEN),
    ]


def gang_golden(T, result) -> dict:
    """What the gang cells hold to the JAX package's (tests/test_torch_gang.py
    _golden, without the launched cpu)."""
    from karpenter_tpu_torch.gang import gang_of

    spilled: dict = {}
    reasons: dict = {}
    for p, r in result.unschedulable:
        g = gang_of(p)
        key = g[0] if g else "singleton"
        spilled[key] = spilled.get(key, 0) + 1
        reasons[r] = reasons.get(r, 0) + 1
    return dict(
        claims=len(result.claims), unschedulable=len(result.unschedulable), reasons=reasons, spilled=spilled,
        price=round(result.total_price(), 4), slice_hosts=sum(1 for c in result.claims if c.gang),
        slice_digest=T.slice_digest(result), result_digest=T.result_digest(result),
    )


def gang_kernel_phase(torch, cuda, cells: list, results: list) -> None:
    """Phase 3d: H9 gang_scan against its plain version (`_gang_step` per
    segment) on the leading gang runs of each gang cell's real encoded
    problem (the runs before its first run of another kind), the first
    from the empty carry and each later one from the carry the one before
    it leaves: every carry leaf the scan writes (bank rows, n_open,
    budgets, vg / hg counts, the bank's key rows) and every GangYs leaf,
    exact. Times per run: the kernel's device ms per launch (torch.profiler),
    CUDA-event and launcher ms per call (launch_times; every launch on its
    own copy of the carry, cloned before the timed window), the bound
    (the run's inputs read once, the bank rows it writes written once).
    The first cell's first run goes into the kernels line, with the plain
    loop's time (the other runs' plain loops are held, not timed). One more problem, gang_storm's with every gang
    its own cpu request, has no segment whose state-free terms equal the
    one before's (the kernel reuses them where they do: 63 of
    gang_storm's 65 live segments, 31 of 32 and 7 of 8 in
    gang_zonal_budget's runs); it is held and timed alike."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import solver

    storm = cells[0]["sched"]
    varied = dict(label="gang_storm_64x16x400, every gang its own cpu request",
                  pods=[p for i in range(GANG_STORM["n_gangs"])
                        for p in T.make_gang_pods(f"v{i}", GANG_STORM["size"], cpu=1.0 + 0.01 * i)],
                  budgets=None, sched=type(storm)(T.make_templates(GANG_TYPES), max_claims=GANG_STORM["max_claims"],
                                                  device=storm.device))
    for cell in [*cells, varied]:
        sched = cell["sched"]
        _sorted, enc = sched._encode(cell["pods"], cell["budgets"])
        common = (enc["exist_tensors"], sched.it_tensors, enc["template_tensors"], sched.well_known,
                  enc["topo_tensors"], enc["zone_kid"], enc["ct_kid"], enc["n_claims"])
        state = sched._initial_state(enc)
        for n_run, (mode, segs) in enumerate(sched._runs(enc)):
            if mode[0] != "gang":
                break
            xs, maxg, kw = sched._gang_args(enc, segs, mode[1])
            st_k, ys_k = solver.solve_gang(state, xs, *common, maxg=maxg, **kw)
            st_p, ys_p = solver.solve_gang(state, xs, *common, maxg=maxg, plain=True, **kw)
            torch.cuda.synchronize()
            pairs = [(f, getattr(st_k, f), getattr(st_p, f)) for f in solver.GANG_WRITES]
            pairs += [(f, getattr(ys_k, f), getattr(ys_p, f)) for f in solver.GangYs._fields]
            bad = [f for f, a, b in pairs if not torch.equal(a, b)]
            err = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().nan_to_num(0.0).max())
                      if a.numel() else 0.0 for _f, a, b in pairs)
            pre = solver.gang_precompute(xs, sched.it_tensors, enc["template_tensors"], sched.well_known,
                                         enc["topo_tensors"], enc["zone_kid"], enc["ct_kid"], kw["key_kid"],
                                         kw["n_domains"])
            n_calls = 20
            # launch_times calls once, then n_calls three ways; its profile
            # may run up to 3 times when the trace holds no device event
            carries = iter([state._replace(**{f: getattr(state, f).clone() for f in solver.GANG_WRITES})
                            for _ in range(5 * n_calls + 1)])
            args = (sched.it_tensors, enc["template_tensors"], enc["topo_tensors"], enc["zone_kid"],
                    enc["n_claims"], maxg, kw["key_kid"], kw["n_domains"], kw["tk_idx"])
            t = launch_times(lambda _x: cuda.gang_scan(pre, next(carries), enc["exist_tensors"], *args), H9_NAMES,
                             [None] * n_calls, "gang_scan")
            first = cell is cells[0] and n_run == 0
            plain_ms = (time_ms(lambda: solver.solve_gang(state, xs, *common, maxg=maxg, plain=True, **kw),
                                iters=2, warmup=1) if first else None)
            it = sched.it_tensors
            T_, GR, R = it.alloc.shape
            Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
            B = xs.count.shape[0]
            hosts = int(ys_k.n_opened.sum())
            tk = st_k.bank_tk_mask.shape[2] + 2 if kw["tk_idx"] >= 0 else 0
            b = bound(
                nbytes(*pre, it.alloc, it.group_valid, it.zc_avail, it.cap, enc["template_tensors"].daemon_requests,
                       state.budget, state.nodes_budget, state.vg_counts) + hosts * (T_ + 4 * R + 5 + tk) + 24 * B,
                float(B * T_ * GR * (9 * R + Z * C) + hosts * T_ * GR * 2 * R),
            )
            label = (f"{cell['label']}, gang run {n_run} (B={B} segments, maxg={maxg}, key {kw['key_kid']}, "
                     f"{hosts} slice hosts, Z x C = {Z * C})")
            plain_txt = f" plain_ms={plain_ms:.4f}" if plain_ms is not None else ""
            print(f"kernel gang_scan ({label}): equal={not bad} (tolerance: exact; {len(pairs)} leaves) "
                  f"{fmt_times(t)}{plain_txt} bound_ms={b[0]:.5f} ({b[1]})", flush=True)
            if bad:
                print(f"  gang_scan leaves that differ: {bad}", flush=True)
            CALL_SHAPES.append(dict(kernel="gang_scan", label=label, equal=not bad, bound_ms=b[0], **t))
            if first:
                results.append(dict(
                    name="gang_scan", route="cuda", source="karpenter_tpu_torch/ops/csrc/gang_scan.cu",
                    replaces="karpenter_tpu/ops/solver.py:2657", launches=0, max_abs_err=err,
                    ms=t["device_ms"] if t["device_ms"] is not None else t["event_ms"], event_ms=t["event_ms"],
                    launcher_ms=t["launcher_ms"], plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                    library_ms=None, equal=not bad,
                ))
            elif bad:
                results[-1]["equal"] = False
                results[-1]["max_abs_err"] = max(results[-1]["max_abs_err"], err)
            state = st_p


def gang_path(torch, cuda, T, cell, profile_dir) -> dict:
    """Drive one gang cell: launch counts zeroed just before a cold solve
    and read just after, the result held to the JAX package's (claims,
    unschedulable pods and reasons, the gangs that spilled, $/h, slice
    hosts, slice and result digests), gang_scan launched once per gang run
    of every round, WARM_CALLS warm solves with the same digest, one more under
    torch.profiler (idle share, gang_scan's device ms per launch). Returns
    the launches or raises RuntimeError."""
    label, sched, pods, budgets = cell["label"], cell["sched"], cell["pods"], cell["budgets"]
    cuda.reset_launches()
    t0 = time.perf_counter()
    result = sched.solve(pods, budgets=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    st = sched.last_stats
    print(f"{label} cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} stats={json.dumps(st)} "
          f"launches={json.dumps(launches)}", flush=True)
    got = gang_golden(T, result)
    print(f"{label} result: {json.dumps(got)}", flush=True)
    want = cell["golden"]
    for k, v in want.items():
        same = abs(got[k] - v) < 1e-2 if k == "price" else got[k] == v
        if not same:
            raise RuntimeError(f"{label}: {k} {got[k]} differs from the JAX package's {v}")
    print(f"{label}: equal to the JAX package's result", flush=True)
    if not st["gang_dispatches_all"] or launches["gang_scan"] != st["gang_dispatches_all"]:
        raise RuntimeError(f"{label}: {launches['gang_scan']} gang_scan launches for {st['gang_dispatches_all']} "
                           f"gang runs over {st['rounds']} rounds")
    for i in range(WARM_CALLS):
        t0 = time.perf_counter()
        r = sched.solve(pods, budgets=budgets)
        torch.cuda.synchronize()
        print(f"{label} warm {i}: wall={time.perf_counter() - t0:.3f}s {json.dumps(sched.last_timings)}", flush=True)
        if T.result_digest(r) != got["result_digest"] or T.slice_digest(r) != got["slice_digest"]:
            raise RuntimeError(f"{label}: warm solve differs from the cold solve")
    by_name = profile_run(lambda: sched.solve(pods, budgets=budgets), profile_dir, label)["by_name"]
    n, ms = kernel_device(by_name, H9_NAMES)
    if n:
        print(f"kernel gang_scan ({label}): {ms / n:.4f} ms per launch on the device ({n} launches profiled)",
              flush=True)
    else:
        print(f"kernel gang_scan ({label}): device time not measured (no profiled launch)", flush=True)
    return launches


def resident_state(torch, T, TorchScheduler):
    """The resident_retract_16380x63 session on the card after its cold
    base and its 16 rounds (the pops left out), every round's mode held to
    the JAX package's."""
    session = TorchScheduler(T.make_templates(T.RESIDENT_TYPES), max_claims=T.RESIDENT_MAX_CLAIMS).resident_session()
    golden = RESIDENT_GOLDEN["resident_retract_16380x63"]["rounds"]
    for (label, union), want in zip(T.retract_trace(**T.RETRACT), golden):
        if label.startswith("pop"):
            break
        session.solve(list(union))
        if (session.last_mode, session.last_reason) != want[1:3]:
            raise RuntimeError(f"resident_retract_16380x63 {label}: {session.last_mode}/{session.last_reason}, "
                               f"the JAX package's {want[1]}/{want[2]}")
    torch.cuda.synchronize()
    return session


def resident_kernel_phase(torch, cuda, T, TorchScheduler, results: list, profile_dir) -> None:
    """Phase 3e: H10 retract_tail against its plain version on the resident
    state of resident_retract_16380x63 (W = NB = 8192 rows), at the cuts
    n_open (a no-op), every surviving round's boundary and 0: every state
    leaf, exact. Times at the last round's boundary (one round's undo):
    the kernel's device time per launch (torch.profiler over 20 launches:
    CUDA events around launcher calls measure the launcher's host work,
    ~0.24 ms, not the kernel; the phase fails when the profile holds no
    launch of the kernel), the launcher call (CUDA events), the plain
    version, and the bound: the bytes the out-of-place function must move,
    over the card's memory rate — every window row written, the rows that
    stay alive read, the open / slot_of flags read, the bank rows below
    the cut copied and those at or past it cleared."""
    import numpy as np

    from karpenter_tpu_torch.ops import solver

    session = resident_state(torch, T, TorchScheduler)
    r = session._r
    state = r["state"]
    cuts = sorted({r["n_open"], 0} | {int(rec["n_open_start"]) for rec in r["rounds"]}, reverse=True)
    bad, err = [], 0.0
    for cut in cuts:
        got = solver.to_numpy(cuda.retract_tail(state, cut))
        want = solver.to_numpy(solver.retract_tail_plain(state, cut))
        for k, a in got.items():
            b = want[k]
            if a.shape != b.shape or not np.array_equal(a, b):
                bad.append((cut, k))
                if a.shape == b.shape and a.size:
                    err = max(err, float(np.nan_to_num(np.abs(a.astype(np.float64) - b.astype(np.float64))).max()))
    cut = int(r["rounds"][-1]["n_open_start"])
    call_ms = time_ms(lambda: cuda.retract_tail(state, cut), iters=50, warmup=5)
    plain_ms = time_ms(lambda: solver.retract_tail_plain(state, cut), iters=10, warmup=2)
    by_name = profile_run(lambda: [cuda.retract_tail(state, cut) for _ in range(20)], profile_dir,
                          "retract_tail", tries=3)["by_name"]
    hits = [v for n, v in by_name.items() if "retract_tail_kernel" in n]
    if not hits:
        raise RuntimeError("kernel retract_tail: the profile of 20 launches holds no launch of "
                           "retract_tail_kernel: its device time is not measured")
    ms = hits[0][1] / hits[0][0]
    W, NB = state.open.shape[0], state.bank_frozen.shape[0]
    window = nbytes(*state.reqs, *(getattr(state, f) for f in solver.RETRACT_WINDOW if f != "reqs"))
    alive = int((state.open & (state.slot_of < cut)).sum())
    flags = nbytes(state.open, state.slot_of)
    bank_row = sum(nbytes(getattr(state, f)) // NB for f in solver.RETRACT_BANK)
    moved = dict(window_written=window, alive_read=alive * (window // W), flags_read=flags,
                 bank_copied=2 * cut * bank_row, bank_cleared=(NB - cut) * bank_row)
    b = bound(sum(moved.values()), 0.0)
    print(f"kernel retract_tail (resident_retract_16380x63 after 16 rounds: W={W}, NB={NB}, n_open={r['n_open']}, "
          f"cuts {cuts}): equal={not bad} (tolerance: exact; {len(got)} leaves a cut) ms={ms:.5f} (device, "
          f"profiled, {hits[0][0]} launches seen; launcher call {call_ms:.4f}) plain_ms={plain_ms:.4f} "
          f"bound_ms={b[0]:.5f} ({b[1]}; cut {cut}, {alive} rows alive, bytes {json.dumps(moved)}) "
          f"ms/bound={ms / b[0]:.1f}", flush=True)
    if bad:
        print(f"  retract_tail leaves that differ (cut, leaf): {bad[:20]}", flush=True)
    results.append(dict(
        name="retract_tail", route="cuda", source="karpenter_tpu_torch/ops/csrc/retract_tail.cu",
        replaces="karpenter_tpu/ops/solver.py:899", launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b[0], bound_by=b[1], library_ms=None, equal=not bad,
    ))


def resident_path(torch, cuda, T, TorchScheduler, name: str, trace: list, batch: int, profile_dir) -> dict:
    """Drive one resident cell through TorchScheduler.resident_session():
    launch counts zeroed just before the first round and read just after
    the last; every round's mode, reason, claims and digest and the final
    fingerprint held to the JAX package's, H10 launched once per retract
    round (the JAX package's retract_tail dispatches); per round the wall,
    encode_s / device_s, fill dispatches and H10 launches; p50 / p95 / max
    of the trace's delta rounds; the p95 of a warmed forced full re-solve
    of the final union (4 solves), which must give the final round's
    digest, and its ratio to the delta p95 (the reference's bench gate is
    5x: printed, not enforced); one more arrival round of `batch` pods
    under torch.profiler (idle share), and with it a retract round when the
    cell retracts. Returns the launches or raises RuntimeError."""
    import numpy as np

    golden = RESIDENT_GOLDEN[name]
    templates = T.make_templates(T.RESIDENT_TYPES)
    sched = TorchScheduler(templates, max_claims=T.RESIDENT_MAX_CLAIMS)
    session = sched.resident_session()
    cuda.reset_launches()
    lat = []
    for (label, union), want in zip(trace, golden["rounds"]):
        h0 = cuda.LAUNCHES["retract_tail"]
        t0 = time.perf_counter()
        result = session.solve(list(union))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h10 = cuda.LAUNCHES["retract_tail"] - h0
        mode, reason = session.last_mode, session.last_reason
        fills = session.last_delta["fill_dispatches"] if mode == "delta" else sched.last_stats.get("fill_dispatches")
        tm = session.last_timings
        got = (label, mode, reason, len(result.claims), digest(result))
        print(f"{name} {label}: {mode}/{reason} pods={len(union)} wall={wall:.4f}s encode_s={tm['encode_s']:.4f} "
              f"device_s={tm['device_s']:.4f} fill_dispatches={fills} retract_tail={h10} claims={got[3]} "
              f"digest_equal={got[4] == want[4]}", flush=True)
        if result.unschedulable:
            raise RuntimeError(f"{name} {label}: {len(result.unschedulable)} pods unschedulable")
        if got != tuple(want):
            raise RuntimeError(f"{name} {label}: {got[1:4]} differs from the JAX package's {tuple(want[1:4])} "
                               f"(or the digest does)")
        if h10 != session.last_delta["retract_dispatches"]:
            raise RuntimeError(f"{name} {label}: {h10} retract_tail launches for "
                               f"{session.last_delta['retract_dispatches']} retracts")
        if label.startswith(("round", "pop")):
            lat.append((mode, wall))
    launches = dict(cuda.LAUNCHES)
    if session.fingerprint != golden["fingerprint"]:
        raise RuntimeError(f"{name}: fingerprint {session.fingerprint}, the JAX package's {golden['fingerprint']}")
    if launches["retract_tail"] != golden["retracts"]:
        raise RuntimeError(f"{name}: {launches['retract_tail']} retract_tail launches, the JAX package dispatched "
                           f"retract_tail {golden['retracts']} times")
    idle = [k for k in ("req_intersects", "fill_count_grid", "water_fill", "compact_scatter") if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"{name}: kernels never launched: {idle}")
    print(f"{name}: every round equal to the JAX package's (modes, claims, digests), fingerprint "
          f"{session.fingerprint}, launches={json.dumps(launches)}", flush=True)
    delta = np.asarray([w for m, w in lat if m == "delta"] or [float("nan")])
    union = list(trace[-1][1])
    full_sched = TorchScheduler(templates, max_claims=T.RESIDENT_MAX_CLAIMS)
    full_sched.solve(union)
    full = []
    for _ in range(4):
        t0 = time.perf_counter()
        fres = full_sched.solve(union)
        torch.cuda.synchronize()
        full.append(time.perf_counter() - t0)
        if digest(fres) != golden["rounds"][-1][4]:
            raise RuntimeError(f"{name}: the forced full re-solve of the final union differs from the last round")
    p95_delta, p95_full = float(np.percentile(delta, 95)), float(np.percentile(np.asarray(full), 95))
    summary = dict(
        cell=name, rounds=len(lat), delta_rounds=int(sum(m == "delta" for m, _w in lat)),
        p50_delta_s=float(np.percentile(delta, 50)), p95_delta_s=p95_delta, max_delta_s=float(delta.max()),
        p95_full_s=p95_full, full_over_delta_p95=p95_full / p95_delta, bench_gate_x=5.0,
        retract_tail_launches=launches["retract_tail"],
    )
    print(f"{name} summary: {json.dumps(summary)}", flush=True)
    extra = union + T.kind_batch("profiled", batch)
    prof = profile_run(lambda: session.solve(extra), profile_dir, f"{name}_delta_append")
    print(f"{name} profiled append round: {session.last_mode}/{session.last_reason} "
          f"idle_share={prof.get('idle_share', 'not measured')}", flush=True)
    if session.last_mode != "delta":
        raise RuntimeError(f"{name}: the profiled append round left the delta path ({session.last_reason})")
    if golden["retracts"]:
        h0 = cuda.LAUNCHES["retract_tail"]
        prof = profile_run(lambda: session.solve(union), profile_dir, f"{name}_delta_retract")
        h10 = cuda.LAUNCHES["retract_tail"] - h0
        print(f"{name} profiled retract round: {session.last_mode}/{session.last_reason} retract_tail={h10} "
              f"idle_share={prof.get('idle_share', 'not measured')}", flush=True)
        if session.last_mode != "delta":
            raise RuntimeError(f"{name}: the profiled retract round left the delta path ({session.last_reason})")
        if h10 != 1:
            raise RuntimeError(f"{name}: the profiled retract round launched retract_tail {h10} times, not once")
    return launches


def objective_kernel_phase(torch, cuda, T, TorchScheduler, results: list) -> None:
    """Phase 3e: H11 objective_verdict against its plain version at the
    first objective round of objectives_mixed_16384x400 under cost_min: the
    round's first fill group (a quarter of the 16384 pods) solved under
    the K = 4 rank variants from the empty state (H1-H3), then the verdict
    over those four outcomes scored by each non-lexical objective's
    formula, and once with every type unpriced (every cost_min score +inf:
    the winner is 0). Scores bit for bit and the word equal. Each of the
    five call shapes is timed (launch_times: the kernel's device ms per
    launch, CUDA-event and launcher ms per call) beside its bound, the
    bytes (and, for cost_min, operations) the function needs on this
    round's data (verdict_bytes); the kernels line carries cost_min's,
    with the plain version's time."""
    from karpenter_tpu_torch import objectives
    from karpenter_tpu_torch.ops import solver

    sched = TorchScheduler(T.mixed_pool_templates(OBJ_TYPES), max_claims=OBJ_MAX_CLAIMS, objective="cost_min")
    _sorted, enc = sched._encode(T.mixed_pods(OBJ_MIXED_PODS), None)
    segs = next(s for m, s in sched._runs(enc) if m[0] == "fill")
    state = sched._initial_state(enc)
    xs = sched._gather_fill_xs(enc, segs)
    ranks = sched._objective_variant_ranks("cost_min", OBJ_K)
    price = sched._objective_price_t()
    tm = enc["template_tensors"]
    outs = []
    for v in range(ranks.shape[0]):
        st, ys = solver.solve_fill(state, xs, enc["exist_tensors"], sched.it_tensors, tm._replace(rank=ranks[v]),
                                   sched.well_known, enc["topo_tensors"], enc["zone_kid"], enc["ct_kid"],
                                   enc["n_claims"])
        outs.append(solver.variant_out(st, ys))
    G = len(sched.templates)
    args = (state.w_open, state.spills, outs)
    base = int(state.w_open)
    checks = {}
    for name, p_t in [(n, price) for n in objectives.POLICIES[1:]] + [("cost_min, every type unpriced",
                                                                        torch.full_like(price, float("inf")))]:
        oid = objectives.objective_id(name.split(",")[0])
        sk, wk = cuda.objective_verdict(*args, p_t, oid, G)
        sp, wp = solver.objective_verdict_plain(*args, p_t, oid, G)
        w = int(wk[0]) & 0xFFFFFFFF
        ok = torch.equal(wk, wp) and torch.equal(sk.view(torch.int32), sp.view(torch.int32))
        if p_t is not price:
            ok = ok and (w >> 24) == 0 and bool(torch.isinf(sk).all())
        checks[name] = ok
        t = launch_times(lambda _x: cuda.objective_verdict(*args, p_t, oid, G), H11_NAMES, [None] * 20,
                         "objective_verdict")
        moved, ops = verdict_bytes(base, outs, price.shape[0], oid)
        b = bound(moved, ops)
        label = f"{name} (objectives_mixed_16384x400's first round, {len(outs)} variants)"
        print(f"kernel objective_verdict ({name}): equal={ok} (tolerance: exact) word=0x{w:08x} "
              f"winner={(w >> 24) & 0xFF} scores={sk.tolist()} {fmt_times(t)} bound_ms={b[0]:.6f} ({b[1]}, "
              f"{moved} bytes)", flush=True)
        CALL_SHAPES.append(dict(kernel="objective_verdict", label=label, equal=ok, bound_ms=b[0], **t))
        if name == "cost_min":
            timed, b_cost = t, b
    cost = objectives.objective_id("cost_min")
    plain_ms = time_ms(lambda: solver.objective_verdict_plain(*args, price, cost, G), iters=10)
    ok = all(checks.values())
    print(f"kernel objective_verdict: equal={ok} (tolerance: exact) plain_ms={plain_ms:.4f} {len(segs)} segments, "
          f"{len(outs)} variants, opened {[int(o.w_open) - base for o in outs]} rows", flush=True)
    results.append(dict(
        name="objective_verdict", route="cuda", source="karpenter_tpu_torch/ops/csrc/objective_verdict.cu",
        replaces="karpenter_tpu/ops/solver.py:1960", launches=0, max_abs_err=0.0 if ok else 1.0,
        ms=timed["device_ms"] if timed["device_ms"] is not None else timed["event_ms"], event_ms=timed["event_ms"],
        launcher_ms=timed["launcher_ms"], plain_ms=plain_ms, bound_ms=b_cost[0], bound_by=b_cost[1],
        library_ms=None, equal=ok,
    ))


def verdict_bytes(base_w_open: int, outs: list, T: int, objective: int = 1) -> tuple[int, int]:
    """(bytes, operations) H11's function needs on one round's data: each
    variant's opened rows of its viable-type slab under cost_min (its row
    minimum, T operations a row) or their pods / template entries under
    the other objectives, the open flags of the rows it opened, its
    leftovers and two scalars; the price column (cost_min), the base
    scalars, the scores and the word."""
    cost = objective == 1  # cost_min's id (objectives.POLICIES order)
    moved, ops = (T * 4 if cost else 0) + 8 + len(outs) * 4 + 4, 0
    for o in outs:
        w_v = int(o.w_open)
        opened = int(o.open[base_w_open:w_v].sum())
        moved += opened * (T if cost else 4) + (w_v - base_w_open) + 8 + o.leftover.numel() * 4
        ops += opened * (T if cost else 1)
    return moved, ops


def objective_whatif_cell(torch, T, TorchScheduler) -> dict:
    """The per-pod kernel's scenario mode under a rank at prefix100's
    shapes: mixed_pods(4096) provisioned over the four family pools and
    launched, 64 pending pods, the prefixes 1..100 of the cheapest
    candidates, batched under cost_min (whose rank reverses the pools'
    weight order)."""
    templates = T.mixed_pool_templates(OBJ_TYPES)
    cl = T.bound_cluster(T.mixed_pods(WHATIF_PODS), templates)
    pending = T.pending_pods(WHATIF_PENDING)
    return dict(cluster=cl, factory=T.topology_factory(cl), sched=TorchScheduler(templates, objective="cost_min"),
                batches={"prefix": T.prefix_scenarios(T.candidates(cl), WHATIF_CANDS, pending)},
                label=f"whatif_prefix{WHATIF_CANDS} under cost_min over the four family pools")


def objective_paths(torch, cuda, T, TorchScheduler, profile_dir, kernels: list) -> tuple:
    """Phase 4: objectives_mixed_16384x400 under each policy and
    objectives_perpod_4096x400 under lexical and cost_min, each a cold
    solve on a fresh scheduler with the launch counts zeroed just before
    and read just after, held to the JAX package's claims, unschedulable
    pods, $/h, digest and objective-round counts; H11 launched once per
    objective round (every fill group of a non-lexical policy), H6 with
    the rank; the cost gate (cost_min no pricier than lexical). Then one
    warm solve each of lexical and cost_min on the mixed cell (device_s
    side by side) and a profiled warm cost_min solve (H11's device time
    per launch, set on its entry of `kernels`; the idle share). Returns (the launches of every cold
    solve, {policy: $/h}) or raises RuntimeError."""
    from karpenter_tpu_torch import objectives
    from karpenter_tpu_torch.objectives.oracle import total_price_per_hour

    os.environ["KTPU_OBJECTIVE_K"] = str(OBJ_K)
    launches_all, prices, scheds = [], {}, {}
    cells = [("objectives_mixed_16384x400", OBJ_MIXED_GOLDEN, objectives.POLICIES,
              lambda: T.mixed_pods(OBJ_MIXED_PODS)),
             ("objectives_perpod_4096x400", OBJ_PERPOD_GOLDEN, tuple(OBJ_PERPOD_GOLDEN),
              lambda: T.perpod_pods(OBJ_PERPOD_PODS, kinds=OBJ_PERPOD_KINDS))]
    for cell, golden, policies, make_pods in cells:
        pods = make_pods()
        for policy in policies:
            sched = TorchScheduler(T.mixed_pool_templates(OBJ_TYPES), max_claims=OBJ_MAX_CLAIMS, objective=policy)
            cuda.reset_launches()
            t0 = time.perf_counter()
            r = sched.solve(pods)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(cuda.LAUNCHES)
            launches_all.append(launches)
            st = sched.last_stats
            got = (r.node_count, len(r.unschedulable), round(total_price_per_hour(r), 4), digest(r),
                   st["objective_committed"], st["objective_replayed"], st["wins_canonical"], st["wins_perturbed"])
            print(f"{cell} {policy}: wall={wall:.3f}s {json.dumps(sched.last_timings)} claims={got[0]} "
                  f"unschedulable={got[1]} total_price_per_hour={got[2]:.4f} digest={got[3][:16]}... "
                  f"rounds committed={got[4]} replayed={got[5]} wins canonical={got[6]} perturbed={got[7]} "
                  f"stats={json.dumps(st)} launches={json.dumps(launches)}", flush=True)
            want = golden[policy]
            if got[:2] != want[:2] or abs(got[2] - want[2]) >= 1e-3 or got[3] != want[3] or got[4:] != want[4:]:
                raise RuntimeError(f"{cell} {policy}: {got} differs from the JAX package's {want}")
            n_rounds = st["objective_committed"] + st["objective_replayed"]
            mixed = cell.startswith("objectives_mixed")
            if launches["objective_verdict"] != n_rounds or (mixed and policy != "lexical" and not n_rounds):
                raise RuntimeError(f"{cell} {policy}: {launches['objective_verdict']} objective_verdict launches "
                                   f"for {n_rounds} objective rounds")
            if mixed and not launches["kscan_pod_loop"]:
                raise RuntimeError(f"{cell} {policy}: no kscan_pod_loop launch")
            if not mixed and launches[cuda.PERPOD_KERNELS[0]] != st["perpod_dispatches"]:
                raise RuntimeError(f"{cell} {policy}: per-pod kernel launches differ from its chunks")
            prices[(cell, policy)] = got[2]
            scheds[(cell, policy)] = (sched, pods)
        print(f"{cell}: digests equal to the JAX package's under {', '.join(policies)}", flush=True)
    for cell in ("objectives_mixed_16384x400", "objectives_perpod_4096x400"):
        lex, cmin = prices[(cell, "lexical")], prices[(cell, "cost_min")]
        print(f"{cell} cost gate: cost_min {cmin:.4f} $/h <= lexical {lex:.4f} $/h: {cmin <= lex + 1e-6}", flush=True)
        if cmin > lex + 1e-6:
            raise RuntimeError(f"{cell}: cost_min buys a pricier fleet than lexical")
    for policy in ("lexical", "cost_min"):
        sched, pods = scheds[("objectives_mixed_16384x400", policy)]
        t0 = time.perf_counter()
        r = sched.solve(pods)
        torch.cuda.synchronize()
        print(f"objectives_mixed_16384x400 {policy} warm: wall={time.perf_counter() - t0:.3f}s "
              f"{json.dumps(sched.last_timings)}", flush=True)
        if digest(r) != OBJ_MIXED_GOLDEN[policy][3]:
            raise RuntimeError(f"objectives_mixed_16384x400 {policy}: warm solve differs from the cold solve")
    sched, pods = scheds[("objectives_mixed_16384x400", "cost_min")]
    # the bytes each round's verdict needs, from one more warm solve (the
    # solve is deterministic: the profiled one runs the same rounds)
    real, rounds_b = cuda.objective_verdict, []

    def recording(base_w_open, base_spills, outs, price, objective, G):
        rounds_b.append(verdict_bytes(int(base_w_open), outs, price.shape[0]))
        return real(base_w_open, base_spills, outs, price, objective, G)

    cuda.objective_verdict = recording
    try:
        sched.solve(pods)
    finally:
        cuda.objective_verdict = real
    by_name = profile_run(lambda: (cuda.reset_launches(), sched.solve(pods)), profile_dir, "objectives_cost_min",
                          tries=3)["by_name"]
    rounds = sched.last_stats["verdict_fetches"]
    hits = [(c, d) for n, (c, d) in by_name.items() if "objective_verdict_kernel" in n]
    if not hits or hits[0][0] != rounds or cuda.LAUNCHES["objective_verdict"] != rounds:
        raise RuntimeError(f"objectives_mixed_16384x400 cost_min: the profiled solve's {rounds} objective rounds "
                           f"show {hits[0][0] if hits else 0} objective_verdict device events and "
                           f"{cuda.LAUNCHES['objective_verdict']} launches")
    c, d = hits[0]
    b = bound(sum(x for x, _o in rounds_b) / len(rounds_b), sum(o for _x, o in rounds_b) / len(rounds_b))
    print(f"kernel objective_verdict (objectives_mixed_16384x400 cost_min, profiled warm solve): "
          f"{d / c:.5f} ms per launch on the device ({c} launches), bound {b[0]:.6f} ms per launch ({b[1]}) "
          f"over the same rounds, {sum(x for x, _o in rounds_b)} bytes in all", flush=True)
    # the kernels line carries the kernel's own device time over the main
    # path's rounds (the events around a launcher call also hold its zeroed
    # ticket's fill) beside its bound over the same rounds
    for k in kernels:
        if k["name"] == "objective_verdict":
            k.update(ms=d / c, bound_ms=b[0], bound_by=b[1])
    return launches_all, prices


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


def profile_run(fn, out_dir, tag, quiet: bool = False, tries: int = 1) -> dict:
    """One more warm call of fn under torch.profiler: device busy share
    over the call's wall, and device time by kernel name (from the chrome
    trace, so launches of one name are summed and overlaps counted once).
    Returns the summary (wall_s, device_busy_s, idle_share, ...) with
    by_name {kernel name: (launches, device ms)}; by_name alone, empty, when
    not measured. The profiler now and then records no device activity at
    all for a call whose kernels ran: with tries > 1, fn (which must then be
    safe to repeat) is profiled again, up to `tries` calls in all, while
    the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}_trace.json")
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
        if dev:
            break
        if attempt + 1 < tries:
            print(f"profile {tag}: the trace holds no device events; profiling again", flush=True)
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
    if not quiet:
        print(f"profile {tag}: wall={wall:.3f}s device_busy={busy / 1e6:.4f}s "
              f"idle_share={summary['idle_share']:.4f} device_events={len(dev)}", flush=True)
        for t in summary["top"]:
            print(f"  device {t['ms']:9.3f} ms  x{t['launches']:6d}  {t['name']}", flush=True)
    return dict(summary, by_name={n: (c, d / 1e3) for n, (c, d) in by_name.items()})


# the kernels whose device time phase 4 reports from its profiled warm
# solves of the north star and mixed
PROFILED_KERNELS = (("req_intersects", H1_NAMES), ("fill_count_grid", H2_NAMES), ("water_fill", H3_NAMES),
                    ("compact_scatter", H4_NAMES), ("kscan_grid", H5_NAMES), ("kscan_pod_loop", H6_NAMES),
                    ("gang_scan", H9_NAMES), ("wire_pack", H15_NAMES))


def profiled_kernels(tag: str, prof: dict) -> None:
    """H1-H6's, H9's and H15's device time and launches in a profiled warm solve."""
    if not prof["by_name"]:
        return
    for name, names in PROFILED_KERNELS:
        n, ms = kernel_device(prof["by_name"], names)
        per = f"{ms / n:.5f}" if n else "-"
        print(f"profile {tag}: {name} device {ms:.3f} ms over {n} launches ({per} ms a launch) of "
              f"{prof['device_busy_s'] * 1e3:.1f} ms device-busy", flush=True)


def shard_cells(T) -> list:
    """The dp cells: (label, templates, pods, existing nodes, budgets,
    max_claims, scheduler attributes), in SHARD_GOLDEN's order."""
    eb = dict(pipeline_min_pods=256)
    pp = dict(pipeline_min_pods=256, solve_chunk=128)
    return [
        ("shard_8192x200", T.make_templates(200), T.selector_pods(8192), [], None, 2048,
         dict(pipeline_min_pods=1024)),
        ("shard_8192x200 zonal twin", T.make_templates(200), T.zonal_pods(512, kinds=8), [], None, None, eb),
        ("shard_8192x200 hostname twin", T.make_templates(200), T.hostname_pods(512, kinds=8), [], None, None, eb),
        ("shard_8192x200 existing twin", T.make_templates(200),
         T.sized_kind_pods(512, kinds=8, prefix="eb", mixed=False), T.existing_sim_nodes(), None, None, eb),
        ("shard_8192x200 perpod twin", T.make_templates(200), T.perpod_pods(512, kinds=8), [], None, None, pp),
        ("shard_8192x200 mv+budget twin", T.mv_templates(200), T.perpod_pods(512, kinds=8, prefix="bb"), [],
         {"default": {"cpu": 1e6}}, None, pp),
        ("shard_northstar_100000x1000_dp2", T.make_templates(1000), T.selector_pods(100_000), [], None, 4096, {}),
        ("shard_zonal_4096x400_dp2", T.make_templates(400), T.zonal_pods(4096, kinds=8), [], None, 4096, {}),
        ("shard_perpod_4096x400_dp4", T.make_templates(400), T.perpod_pods(PERPOD_PODS, kinds=PERPOD_KINDS), [], None,
         4096, {}),
        ("shard_constrained_4096x400_dp4", T.constrained_templates(CONSTRAINED_TYPES),
         T.mixed_pods(CONSTRAINED_PODS) + T.hostport_pods(CONSTRAINED_INGRESS), [],
         {"default": {"cpu": CONSTRAINED_CPU_LIMIT}}, 4096, {}),
    ]


def shard_sched(TorchScheduler, cell):
    """A fresh scheduler for a dp cell at its dp extent and attributes."""
    label, templates, _pods, _nodes, _budgets, max_claims, attrs = cell
    sched = TorchScheduler(templates, max_claims=max_claims, dp=SHARD_GOLDEN[label][4])
    for k, v in attrs.items():
        setattr(sched, k, v)
    return sched


def shard_solve(sched, cell):
    """One solve of a dp cell's problem (its existing nodes cloned)."""
    _label, _templates, pods, nodes, budgets, _mc, _attrs = cell
    kw = dict(budgets={p: dict(b) for p, b in budgets.items()}) if budgets else {}
    return sched.solve(pods, [n.clone() for n in nodes], **kw)


DP_FUNCS = ("dp_dead", "dp_verdict", "merge_shard_fill", "merge_shard_kscan")


def record_dp_round(TorchScheduler, cell) -> dict:
    """A cold solve of a dp cell with the first call of each dp function
    recorded ({name: (args, kwargs)}): the inputs of its first merge round
    and first commit."""
    from karpenter_tpu_torch.ops import solver

    rec, real = {}, {n: getattr(solver, n) for n in DP_FUNCS}

    def wrap(n):
        def f(*a, **k):
            rec.setdefault(n, (a, k))
            return real[n](*a, **k)
        return f

    for n in DP_FUNCS:
        setattr(solver, n, wrap(n))
    try:
        shard_solve(shard_sched(TorchScheduler, cell), cell)
    finally:
        for n in DP_FUNCS:
            setattr(solver, n, real[n])
    return rec


def _leaves(st) -> list:
    return [t for v in st for t in (v if isinstance(v, tuple) else (v,))]


def dead_bytes(base, specs, it) -> int:
    """The bytes H12's function needs on a round's data: the viable-type
    bytes and usage of each source's live rows (the base's open rows, each
    row's fresh opens), the open flags, the catalog's alloc and group
    flags (and for the kind scan its key rows and offerings), r_min, the
    matrix out."""
    from karpenter_tpu_torch.ops import solver

    T, GR, R = it.alloc.shape
    rows = int(base.open.sum()) + sum(int(solver.opened_rows(base, s).sum()) for s in specs)
    return (rows * (T + 4 * R) + (1 + len(specs)) * base.open.shape[0] + nbytes(it.alloc, it.group_valid)
            + len(specs) * (4 * R + 1 + len(specs)))


def verdict_dp_bytes(base, specs, vin) -> int:
    """The bytes H13's function needs: each row's fill grid below the
    base's w_open (or its pods column there), leftovers, existing-node
    fields, budgets and reservations, the base's, the per-row masks, the
    word."""
    bw = int(base.w_open)
    per = 0
    for q, s in enumerate(specs):
        per += 4 * bw * (vin.fill_c[q].shape[0] if vin.fill_c is not None else 1)
        per += nbytes(vin.leftover[q]) if vin.leftover is not None else 0
        per += nbytes(s.exist_used, s.exist_ports, s.exist_vols, *s.exist_reqs, s.w_open, s.n_open, s.spills)
        if vin.apply_tmpl is not None:
            per += nbytes(s.budget, s.nodes_budget, s.res_cap)
    masks = [m for m in (vin.r_min, vin.exist_ok_rows, vin.rec_v, vin.app_v, vin.rec_h, vin.app_h, vin.apply_tmpl)
             if m is not None]
    return per + nbytes(base.exist_used, base.exist_ports, base.exist_vols, *base.exist_reqs, *masks) + 4 * bw + 4


def merge_bytes(committed, spec, assignment) -> int:
    """The bytes H14's function needs: every window column read once (the
    committed row or the grafted one) and written once, slot_of and the
    shifted map, the existing-node fields of three states and the result,
    the counts and debits likewise, the assignment in and out."""
    from karpenter_tpu_torch.ops.solver import GRAFT_WINDOW, exist_leaves

    win = [t for f in GRAFT_WINDOW for t in _leaves([getattr(committed, f)])] + [committed.open]
    ex = exist_leaves(committed)
    cnt = [committed.hg_counts]
    if assignment is not None:
        cnt += [committed.vg_counts, committed.budget, committed.nodes_budget, committed.res_cap]
    return (2 * nbytes(*win) + 4 * nbytes(committed.slot_of) + 4 * nbytes(*ex) + 4 * nbytes(*cnt)
            + (2 * nbytes(assignment) if assignment is not None else 0))


def shard_kernel_phase(torch, cuda, T, TorchScheduler, results: list) -> None:
    """Phase 3f: H12 dp_dead, H13 dp_verdict and H14 merge_shard against
    their plain versions on real rounds (SHARD_KERNEL_CELLS): the first
    merge round and first commit of shard_8192x200's existing twin (fill:
    H12's fill mode, H13 with the fill grids, leftovers and existing-node
    debits, H14's fill mode), of its zonal twin (H12's kscan mode, H14's
    kscan mode) and of shard_perpod_4096x400_dp4 (DP = 4 rows of the
    per-pod kernel's scenario mode, H13 with the budget / reservation
    bit). Matrix, word and every merged leaf equal. H12, H13 and H14 are
    timed on each cell's round and commit (launch_times: device ms per
    launch, CUDA-event and launcher ms per call; H14 in its fill mode on
    the existing twin's commit and its kscan mode on the others') beside
    their bounds; the plain versions on the first cell's."""
    from karpenter_tpu_torch.ops import solver

    cells = {c[0]: c for c in shard_cells(T)}
    checks, timed = {}, {}
    for label in SHARD_KERNEL_CELLS:
        rec = record_dp_round(TorchScheduler, cells[label])
        missing = [n for n in ("dp_dead", "dp_verdict") if n not in rec]
        merge = "merge_shard_fill" if "merge_shard_fill" in rec else "merge_shard_kscan"
        if missing or merge not in rec:
            raise RuntimeError(f"{label}: no dp round or commit recorded ({missing}, {sorted(rec)})")
        (base, specs, r_min, it, *key), _kw = rec["dp_dead"]
        key = key[0] if key else None
        dk = cuda.dp_dead(base, specs, r_min, it, key)
        dp = solver.dp_dead_plain(base, specs, r_min, it, key)
        (vb, vs, dead, exist, n_claims, vin), _kw = rec["dp_verdict"]
        wk = cuda.dp_verdict(vb, vs, dead, exist, n_claims, vin)
        wp = solver.dp_verdict_plain(vb, vs, dead, exist, n_claims, vin)
        args, _kw = rec[merge]
        if merge == "merge_shard_fill":
            committed, spec, mbase = args
            assign = None
            mk = cuda.merge_shard(committed, spec, mbase, None)
            mp = solver.merge_shard_fill_plain(committed, spec, mbase) + (None,)
        else:
            committed, spec, assign, mbase = args
            mk = cuda.merge_shard(committed, spec, mbase, assign)
            mp = solver.merge_shard_kscan_plain(committed, spec, assign, mbase)
        m_eq = all(torch.equal(a, b) for a, b in zip(_leaves(mk[0]), _leaves(mp[0]))) and torch.equal(mk[1], mp[1])
        m_eq = m_eq and (assign is None or torch.equal(mk[2], mp[2]))
        checks[label] = dict(dp_dead=torch.equal(dk, dp), dp_verdict=torch.equal(wk, wp), merge_shard=m_eq)
        print(f"kernel dp (first round of {label}): DP={len(specs)} kscan mode={key is not None} "
              f"dead={dk.to(torch.int32).tolist()} word=0x{int(wk[0]) & 0xFFFFFFFF:08x} "
              f"equal={json.dumps(checks[label])} (tolerance: exact) merge={merge}", flush=True)
        shapes = dict(
            dp_dead=(lambda _x: cuda.dp_dead(base, specs, r_min, it, key), H12_NAMES, dead_bytes(base, specs, it)),
            dp_verdict=(lambda _x: cuda.dp_verdict(vb, vs, dead, exist, n_claims, vin), H13_NAMES,
                        verdict_dp_bytes(vb, vs, vin)),
            merge_shard=(lambda _x: cuda.merge_shard(committed, spec, mbase, assign), H14_NAMES,
                         merge_bytes(committed, spec, assign)),
        )
        for name, (run, names, moved) in shapes.items():
            t = launch_times(run, names, [None] * 20, name)
            b = bound(moved, 0.0)
            shape = (f"first round of {label} (DP={len(specs)}, {'kscan' if key is not None else 'fill / per-pod'} "
                     f"mode)") if name != "merge_shard" else f"first commit of {label} ({merge})"
            print(f"kernel {name} ({shape}): equal={checks[label][name]} {fmt_times(t)} bound_ms={b[0]:.6f} "
                  f"({b[1]}, {moved} bytes)", flush=True)
            CALL_SHAPES.append(dict(kernel=name, label=shape, equal=checks[label][name], bound_ms=b[0], **t))
            if label == SHARD_KERNEL_CELLS[0]:
                timed[name] = (t, b)
        if label == SHARD_KERNEL_CELLS[0]:  # bound now: the loop's names move on to the next cell
            plain = dict(
                dp_dead=functools.partial(solver.dp_dead_plain, base, specs, r_min, it, key),
                dp_verdict=functools.partial(solver.dp_verdict_plain, vb, vs, dead, exist, n_claims, vin),
                merge_shard=functools.partial(solver.merge_shard_fill_plain, committed, spec, mbase),
            )
    sources = dict(dp_dead=("dp_dead.cu", "karpenter_tpu/ops/solver.py:2030"),
                   dp_verdict=("dp_verdict.cu", "karpenter_tpu/ops/solver.py:2100"),
                   merge_shard=("merge_shard.cu", "karpenter_tpu/ops/solver.py:2287"))
    for name, (t, b) in timed.items():
        plain_ms = time_ms(plain[name], iters=5)
        ok = all(c[name] for c in checks.values())
        ms = t["device_ms"] if t["device_ms"] is not None else t["event_ms"]
        print(f"kernel {name}: equal={ok} (tolerance: exact) ms={ms:.5f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b[0]:.6f} ({b[1]})", flush=True)
        results.append(dict(
            name=name, route="cuda", source=f"karpenter_tpu_torch/ops/csrc/{sources[name][0]}",
            replaces=sources[name][1], launches=0, max_abs_err=0.0 if ok else 1.0, ms=ms, event_ms=t["event_ms"],
            launcher_ms=t["launcher_ms"], plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None, equal=ok,
        ))


def shard_paths(torch, cuda, T, TorchScheduler, profile_dir, kernels: list) -> list:
    """Phase 4: the dp cells, each a cold solve of TorchScheduler(dp=N) on a
    fresh scheduler with the launch counts zeroed just before and read just
    after, held to the JAX package's claims, unschedulable pods, $/h,
    digest and merge counters (last_stats["shard"], the last relaxation
    round's, as the reference's); H12 and H13 launched once per merge round
    and H14 once per commit over every round of the solve, the per-pod
    kernel's scenario mode once per per-pod merge round and its single
    mode once per sequential chunk or replay; a cell with no merge round
    fails. One warm solve each (the same digest), and a profiled warm
    solve of the per-pod dp cell (H12-H14's device time per launch, set on
    their entries of `kernels`). Returns the launches of every cold solve
    or raises RuntimeError."""
    out = []
    for cell in shard_cells(T):
        label = cell[0]
        claims, unsched, price, want_digest, dp, family, rounds = SHARD_GOLDEN[label]
        sched = shard_sched(TorchScheduler, cell)
        cuda.reset_launches()
        t0 = time.perf_counter()
        r = shard_solve(sched, cell)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        out.append(launches)
        st = sched.last_stats
        counters = T.shard_counters(st["shard"])
        dg = (T.result_digest if label.startswith("shard_constrained") else digest)(r)
        got = (r.node_count, len(r.unschedulable), round(r.total_price(), 4), dg)
        print(f"{label}: wall={wall:.3f}s {json.dumps(sched.last_timings)} claims={got[0]} unschedulable={got[1]} "
              f"total_price={got[2]:.4f} digest={dg[:16]}... shard={json.dumps(counters)} "
              f"all-rounds merge_rounds={st['merge_rounds_all']} commits={st['dp_commits_all']} "
              f"per-pod dp rounds={st['perpod_dp_rounds_all']} chunks={st['perpod_dispatches_all']} "
              f"launches={json.dumps(launches)}", flush=True)
        if got[:2] != (claims, unsched) or abs(got[2] - price) >= 1e-2 or dg != want_digest:
            raise RuntimeError(f"{label}: {got} differs from the JAX package's {(claims, unsched, price, want_digest)}")
        if counters != shard_golden(dp, family, rounds):
            raise RuntimeError(f"{label}: merge counters {counters} differ from the JAX package's "
                               f"{shard_golden(dp, family, rounds)}")
        if not st["merge_rounds_all"]:
            raise RuntimeError(f"{label}: the dp path ran no merge round")
        fams = {f: c for f, c in counters["families"].items() if c != [0, 0]}
        print(f"{label}: families committed / replayed {json.dumps(fams)}", flush=True)
        want = dict(dp_dead=st["merge_rounds_all"], dp_verdict=st["merge_rounds_all"],
                    merge_shard=st["dp_commits_all"])
        want[cuda.WHATIF_KERNELS[0]] = st["perpod_dp_rounds_all"]
        want[cuda.PERPOD_KERNELS[0]] = st["perpod_dispatches_all"]
        bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if bad:
            raise RuntimeError(f"{label}: launches (got, expected) {bad}")
        if family == "perpod" and st["perpod_dp_rounds_all"] != st["merge_rounds_all"]:
            raise RuntimeError(f"{label}: {st['perpod_dp_rounds_all']} scenario-mode launches for "
                               f"{st['merge_rounds_all']} merge rounds")
        t0 = time.perf_counter()
        r2 = shard_solve(sched, cell)
        torch.cuda.synchronize()
        print(f"{label} warm: wall={time.perf_counter() - t0:.3f}s {json.dumps(sched.last_timings)}", flush=True)
        if digest(r2) != digest(r):
            raise RuntimeError(f"{label}: warm solve differs from the cold solve")
        if label in SYNC_DP_CELLS:
            sync_points(torch, sched, lambda: shard_solve(sched, cell), label)
        if label == "shard_perpod_4096x400_dp4":
            profiled_dp_kernels(cuda, kernels, lambda: shard_solve(sched, cell), profile_dir)
    return out


def profiled_dp_kernels(cuda, kernels: list, solve, profile_dir) -> None:
    """H12-H14's device time per launch in a profiled warm solve of the
    per-pod dp cell, beside their bounds over the same rounds (the bytes
    each launch's function needs, recorded in one more warm solve: the
    solve is deterministic); set on their entries of `kernels`."""
    real = dict(dp_dead=cuda.dp_dead, dp_verdict=cuda.dp_verdict, merge_shard=cuda.merge_shard)
    moved = {n: [] for n in real}

    def dead(base, specs, r_min, it, key=None):
        moved["dp_dead"].append(dead_bytes(base, specs, it))
        return real["dp_dead"](base, specs, r_min, it, key)

    def verdict(base, specs, d, exist, n_claims, vin):
        moved["dp_verdict"].append(verdict_dp_bytes(base, specs, vin))
        return real["dp_verdict"](base, specs, d, exist, n_claims, vin)

    def merge(committed, spec, base, assignment=None):
        moved["merge_shard"].append(merge_bytes(committed, spec, assignment))
        return real["merge_shard"](committed, spec, base, assignment)

    cuda.dp_dead, cuda.dp_verdict, cuda.merge_shard = dead, verdict, merge
    try:
        solve()
    finally:
        cuda.dp_dead, cuda.dp_verdict, cuda.merge_shard = real["dp_dead"], real["dp_verdict"], real["merge_shard"]
    by_name = profile_run(solve, profile_dir, "shard_perpod_dp4")["by_name"]
    for name, sizes in moved.items():
        hits = [(c, d) for n, (c, d) in by_name.items() if f"{name}_kernel" in n]
        if not hits or hits[0][0] != len(sizes):
            print(f"kernel {name} (shard_perpod_4096x400_dp4, profiled warm solve): device time not measured "
                  f"({hits[0][0] if hits else 0} device events for {len(sizes)} launches)", flush=True)
            continue
        c, d = hits[0]
        b = bound(sum(sizes) / len(sizes), 0.0)
        print(f"kernel {name} (shard_perpod_4096x400_dp4, profiled warm solve): {d / c:.5f} ms per launch on the "
              f"device ({c} launches), bound {b[0]:.7f} ms per launch ({b[1]}) over the same launches", flush=True)
        for k in kernels:
            if k["name"] == name:
                k.update(ms=d / c, bound_ms=b[0], bound_by=b[1])


def record_fetches(cuda, fn) -> list:
    """Run fn with the leaves of every wire fetch recorded (what the wire
    kernel, H15, packed), in order."""
    rec = []
    real = cuda.wire_pack

    def recording(leaves):
        rec.append(list(leaves))
        return real(leaves)

    cuda.wire_pack = recording
    try:
        fn()
    finally:
        cuda.wire_pack = real
    return rec


def wire_read_bytes(leaves) -> int:
    """The bytes the wire kernel must read for a fetch: each leaf's live
    elements, each max source whole."""
    from karpenter_tpu_torch.ops import kernels

    total = 0
    for t in leaves:
        if isinstance(t, kernels.WireMax):
            total += sum(nbytes(s) for s in t.srcs)
        elif isinstance(t, kernels.WireLeaf):
            total += t.src[: t.rows].numel() * t.src.element_size()
        else:
            total += nbytes(t)
    return total


def wire_kernel_phase(torch, cuda, T, TorchScheduler, results: list) -> None:
    """H15 wire_pack against pack_wire_plain on the card, byte for byte, on
    three real fetches: the north star's first pipeline group, the mixed
    cell's last group with its final state reads, and a dp verdict word
    (the existing-node twin of shard_8192x200). Per fetch: the kernel's
    device ms per launch (torch.profiler), CUDA-event and
    launcher ms per call (launch_times), the bound (bytes read and written
    once) and the plain version's ms. The kernels line carries the
    largest fetch's numbers."""
    from karpenter_tpu_torch.ops import kernels

    picks = []
    north = record_fetches(cuda, lambda: TorchScheduler(T.make_templates(1000), max_claims=4096).solve(
        T.selector_pods(100_000)))
    picks.append(("north star, first pipeline group", north[0]))
    mixed = record_fetches(cuda, lambda: TorchScheduler(T.make_templates(400), max_claims=4096).solve(
        T.mixed_pods(MIXED_PODS)))
    picks.append(("mixed, last group with the final state reads", mixed[-1]))
    cell = next(c for c in shard_cells(T) if c[0] == "shard_8192x200 existing twin")
    dp = record_fetches(cuda, lambda: shard_solve(shard_sched(TorchScheduler, cell), cell))
    words = [f for f in dp if len(f) == 1 and isinstance(f[0], torch.Tensor) and nbytes(f[0]) == 4]
    if not words:
        raise RuntimeError("wire: the dp cell made no 4-byte verdict fetch")
    picks.append(("dp verdict word (shard_8192x200 existing twin)", words[0]))
    best = None
    for label, leaves in picks:
        got = cuda.wire_pack(leaves)
        want = kernels.pack_wire_plain(leaves)
        equal = got.shape == want.shape and torch.equal(got, want)
        err = 0.0 if equal else 1.0
        t = launch_times(lambda _x: cuda.wire_pack(leaves), H15_NAMES, [None] * 20, "wire_pack")
        plain_ms = time_ms(lambda: kernels.pack_wire_plain(leaves), iters=5)
        read = wire_read_bytes(leaves)
        b = bound(read + want.numel(), 0.0)
        print(f"kernel wire_pack ({label}): equal={equal} (tolerance: exact) leaves={len(leaves)} "
              f"wire_bytes={want.numel()} read_bytes={read} {fmt_times(t)} plain_ms={plain_ms:.4f} "
              f"bound_ms={b[0]:.6f} ({b[1]})", flush=True)
        CALL_SHAPES.append(dict(kernel="wire_pack", label=label, equal=equal, bound_ms=b[0], **t))
        entry = dict(name="wire_pack", route="cuda", source="karpenter_tpu_torch/ops/csrc/wire_pack.cu",
                     replaces="karpenter_tpu/ops/kernels.py:362", launches=0, max_abs_err=err,
                     ms=t["device_ms"] if t["device_ms"] is not None else t["event_ms"], event_ms=t["event_ms"],
                     launcher_ms=t["launcher_ms"], plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                     library_ms=None, equal=equal)
        if not equal:
            results.append(entry)
            return
        if best is None or want.numel() > best[0]:
            best = (want.numel(), entry)
    results.append(best[1])


def sync_points(torch, sched, fn, label: str) -> None:
    """Run fn with CUDA's sync debug mode on inside the scheduler's
    dispatch loop (_run_solve): print each line that made the host wait
    for the card between dispatches, with its count."""
    import warnings
    from collections import Counter

    real = sched._run_solve
    seen = Counter()

    def watched(enc):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real(enc)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                for w in caught:
                    if "synchroniz" in str(w.message):
                        seen[f"{os.path.relpath(w.filename)}:{w.lineno}"] += 1

    sched._run_solve = watched
    try:
        fn()
    finally:
        del sched._run_solve
    print(f"sync points in {label}'s dispatch loop: {sum(seen.values())} {json.dumps(dict(seen.most_common()))}",
          flush=True)


def digest(result) -> str:
    from karpenter_tpu_torch.testing import claims_digest

    return claims_digest(result)


def solve_path(torch, cuda, label, sched, pods, golden, expect_stats, kernels_needed, pipelined=False,
               stream=False):
    """Drive one main path: launch counts zeroed just before a cold solve
    and read just after, the result held to the JAX package's (claims,
    price, nothing unschedulable) and to its dispatch counts, WARM_CALLS warm
    solves that must give the same digest. With `pipelined` the solve must
    decode in two or more chunk groups; with `stream` the first warm solve
    streams through a chunk_sink whose deltas must add up to the result.
    Returns (result, launches) or raises RuntimeError."""
    from karpenter_tpu_torch.ops import kernels

    cuda.reset_launches()
    kernels.reset_wire_stats()
    t0 = time.perf_counter()
    result = sched.solve(pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    wire = dict(kernels.WIRE_STATS)
    print(f"{label} cold: wall={wall:.3f}s {json.dumps(sched.last_timings)} "
          f"stats={json.dumps(sched.last_stats)} launches={json.dumps(launches)}", flush=True)
    print(f"{label} wire: {wire['fetches']} fetches, {wire['wire_bytes']} bytes on the wire, "
          f"{wire['raw_bytes']} bytes in their leaves whole", flush=True)
    pl = sched.last_timings.get("pipeline")
    if pipelined:
        if not pl or pl["n_chunks"] < 2:
            raise RuntimeError(f"{label}: the decode did not pipeline ({pl and pl['n_chunks']} chunk groups)")
        print(f"{label} pipeline: n_chunks={pl['n_chunks']} overlap_frac={pl['overlap_frac']} "
              f"true_overlap_groups={pl['true_overlap_groups']} sync_wire_s={pl['sync_wire_s']} "
              f"wire_s={pl['wire_s']} host_decode_s={pl['host_decode_s']}", flush=True)
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
    for i in range(WARM_CALLS):
        msgs: list = []
        t0 = time.perf_counter()
        r = sched.solve(pods, chunk_sink=msgs.append if stream and i == 0 else None)
        torch.cuda.synchronize()
        print(f"{label} warm {i}: wall={time.perf_counter() - t0:.3f}s "
              f"{json.dumps(sched.last_timings)}", flush=True)
        if digest(r) != digest(result):
            raise RuntimeError(f"{label}: warm solve differs from the cold solve")
        if msgs:
            check_stream(label, msgs, r)
    return result, launches


def check_stream(label: str, msgs: list, result) -> None:
    """The chunk_sink deltas after the last ("reset", None) must add up to
    the result: every claim's pods in order, the existing-node assignments
    and the unschedulable pods."""
    last = max(i for i, (kind, _d) in enumerate(msgs) if kind == "reset")
    claims: dict = {}
    existing, unsched = [], []
    chunks = msgs[last + 1:]
    for _kind, d in chunks:
        for slot, uids in d["claims"]:
            claims.setdefault(slot, []).extend(uids)
        existing += d["existing"]
        unsched += d["unsched"]
    ok = (claims == {c.slot: [p.uid for p in c.pods] for c in result.claims}
          and existing == list(result.existing_assignments.items())
          and unsched == [(p.uid, r) for p, r in result.unschedulable])
    print(f"{label} chunk_sink: {len(chunks)} chunks after the last reset, {len(claims)} claims, "
          f"{sum(len(v) for v in claims.values())} pods; deltas add up to the result: {ok}", flush=True)
    if not ok:
        raise RuntimeError(f"{label}: the chunk_sink deltas do not add up to the result")


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

    phase_s = {"1-2": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    # phase 3 (the schedulers' encodes supply the real catalog and topology tensors)
    templates = make_templates(1000)
    sched = TorchScheduler(templates, max_claims=4096)
    sched._encode(selector_pods(16), None)
    kernels = kernel_phase(sched)
    templates_m = make_templates(400)
    sched_m = TorchScheduler(templates_m, max_claims=4096)
    _sorted, enc_m = sched_m._encode(mixed_pods(64), None)
    # H6's tier 3 under cost_min's rank: an encode of the objective cell's scheduler
    pool_templates = T.mixed_pool_templates(OBJ_TYPES)
    _sorted, enc_o = TorchScheduler(pool_templates, max_claims=OBJ_MAX_CLAIMS, objective="cost_min")._encode(
        mixed_pods(64), None)
    kscan_kernel_phase(sched_m, enc_m, kernels, rank_enc=enc_o)
    pods_p = perpod_pods(PERPOD_PODS, kinds=PERPOD_KINDS)
    sched_p = TorchScheduler(templates_m, max_claims=4096)
    _sorted, enc_p = sched_p._encode(pods_p, None)
    perpod_kernel_phase(sched_p, enc_p, kernels)
    # the per-pod kernel under cost_min's rank (objectives_perpod_4096x400),
    # one block and, at prefix100's shapes over the four pools, scenario mode
    sched_op = TorchScheduler(pool_templates, max_claims=OBJ_MAX_CLAIMS, objective="cost_min")
    _sorted, enc_op = sched_op._encode(pods_p, None)
    checks_o = [perpod_kernel_phase(sched_op, enc_op, None, cell="objectives_perpod_4096x400 under cost_min")["entry"],
                # the same encode in weight order, for the rank's cost
                perpod_kernel_phase(sched_op, dict(enc_op, template_tensors=enc_op["template_tensors"]._replace(
                    rank=None)), None, cell="objectives_perpod_4096x400, the same encode in weight order")["entry"]]
    try:
        cell_wo = objective_whatif_cell(torch, T, TorchScheduler)
    except RuntimeError as err:
        return fail(str(err))
    checks_o.append(whatif_kernel_phase(cell_wo, None, n_sub=2)[1]["entry"])
    # H11 at the objective cell's first round
    objective_kernel_phase(torch, cuda, T, TorchScheduler, kernels)
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
    # the gang cells: H9 on each cell's first gang run
    cells_g = gang_cells(T, TorchScheduler)
    gang_kernel_phase(torch, cuda, cells_g, kernels)
    # the resident session's retract: H10 on a resident state of 8192 rows
    try:
        resident_kernel_phase(torch, cuda, T, TorchScheduler, kernels, os.path.join("build", "profile"))
    except RuntimeError as err:
        return fail(str(err))
    # dp speculation: H12-H14 on the first rounds of three dp cells
    try:
        shard_kernel_phase(torch, cuda, T, TorchScheduler, kernels)
        # the wire: H15 on three real fetches
        wire_kernel_phase(torch, cuda, T, TorchScheduler, kernels)
    except RuntimeError as err:
        return fail(str(err))
    bad = [k["name"] for k in kernels + checks_c + checks_o if not k["equal"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")
    phase_s["3"] = time.perf_counter() - t_phase
    print(f"phase 3: {phase_s['3']:.1f}s (phases 1-2: {phase_s['1-2']:.1f}s)", flush=True)
    t_phase = time.perf_counter()
    if kernels_only:
        print(f"kernels only: stopping after phase 3 ({time.perf_counter() - t_start:.1f}s)", flush=True)
        return 0

    # phase 4: the fill path (north star), the topology path (mixed_pods),
    # then the per-pod path (perpod_pods); a kernel's launches in the JSON
    # line are the sum over the three cold solves, each counted from zero
    pods = selector_pods(100_000)
    sched = TorchScheduler(templates, max_claims=4096)
    fill_kernels = ("req_intersects", "fill_count_grid", "water_fill", "compact_scatter", "wire_pack")
    pods_m = mixed_pods(MIXED_PODS)
    sched_m = TorchScheduler(templates_m, max_claims=4096)
    sched_p = TorchScheduler(templates_m, max_claims=4096)
    profile_dir = os.path.join("build", "profile")
    try:
        result, launches_n = solve_path(torch, cuda, "north star", sched, pods, (GOLDEN_CLAIMS, GOLDEN_PRICE), {},
                                        fill_kernels, pipelined=True)
        profiled_kernels("northstar", profile_run(lambda: sched.solve(pods), profile_dir, "northstar"))
        sync_points(torch, sched, lambda: sched.solve(pods), "north star")
        result_m, launches_m = solve_path(
            torch, cuda, "mixed path", sched_m, pods_m, (MIXED_CLAIMS, MIXED_PRICE), MIXED_STATS,
            [k for k in cuda.KERNELS
             if k not in cuda.PERPOD_KERNELS + cuda.WHATIF_KERNELS
             + ("gang_scan", "retract_tail", "objective_verdict", "dp_dead", "dp_verdict", "merge_shard")],
            pipelined=True, stream=True,
        )
        profiled_kernels("mixed", profile_run(lambda: sched_m.solve(pods_m), profile_dir, "mixed"))
        sync_points(torch, sched_m, lambda: sched_m.solve(pods_m), "mixed")
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
        t0 = time.perf_counter()
        s_gpu = TorchScheduler(tmpl, max_claims=mc)
        r_gpu = s_gpu.solve(make(), existing_nodes=nodes)
        r_cpu = TorchScheduler(tmpl, max_claims=mc, device="cpu").solve(make(), existing_nodes=nodes)
        if digest(r_gpu) != digest(r_cpu) or not s_gpu.last_stats["perpod_dispatches"]:
            return fail(f"{label} on the card differs from the CPU solve (or ran no per-pod chunk)")
        print(f"small check: {label}, {r_gpu.node_count} claims, {len(r_gpu.existing_assignments)} on existing "
              f"nodes, {len(r_gpu.unschedulable)} unschedulable, card == CPU ({time.perf_counter() - t0:.1f}s)",
              flush=True)
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
        # gangs: a training-job burst, zone-spread jobs under a spend limit
        launches_g = [gang_path(torch, cuda, T, cell, profile_dir) for cell in cells_g]
        # the resident session: a retract trace of whole-claim batches, then
        # the JAX package's steady stage
        launches_r = [
            resident_path(torch, cuda, T, TorchScheduler, "resident_retract_16380x63", T.retract_trace(**T.RETRACT),
                          T.RETRACT["batch"], profile_dir),
            resident_path(torch, cuda, T, TorchScheduler, "steady_16384x64", T.steady_trace(**T.STEADY),
                          T.STEADY["delta_pods"], profile_dir),
        ]
        # placement objectives: the four family pools under every policy
        launches_o, _prices = objective_paths(torch, cuda, T, TorchScheduler, profile_dir, kernels)
        # dp speculation: the shard stage and its twins, the dp cells
        launches_s = shard_paths(torch, cuda, T, TorchScheduler, profile_dir, kernels)
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
                                                      launches_h, launches_wc, *launches_g, *launches_r,
                                                      *launches_o, *launches_s])
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

    phase_s["4"] = time.perf_counter() - t_phase
    print(f"phase 4: {phase_s['4']:.1f}s", flush=True)
    t_phase = time.perf_counter()

    # phase 5: plain versions on the card; the per-pod path at 1024 pods,
    # held to the card's kernel solve of the same problem
    pods_p5 = perpod_pods(PLAIN_PERPOD_PODS, kinds=PERPOD_KINDS)
    result_p5 = TorchScheduler(templates_m, max_claims=4096).solve(pods_p5)
    for label, tmpl, ps, ref in (("north star", templates, pods, result), ("mixed path", templates_m, pods_m, result_m),
                                 (f"perpod_pods({PLAIN_PERPOD_PODS}, kinds={PERPOD_KINDS})", templates_m, pods_p5,
                                  result_p5)):
        t0 = time.perf_counter()
        r_plain = TorchScheduler(tmpl, max_claims=4096, plain=True).solve(ps)
        torch.cuda.synchronize()
        same = digest(r_plain) == digest(ref)
        print(f"plain on card, {label}: wall={time.perf_counter() - t0:.3f}s digest_equal={same}", flush=True)
        if not same:
            return fail(f"plain-version solve of the {label} on the card gives another assignment")
    print(f"plain on card, what-if sub-batch ({WHATIF_SUB} scenarios of whatif_prefix{WHATIF_CANDS}, phase 3): "
          f"wall={whatif_plain_wall:.3f}s; of {cell_wc['label']}: wall={whatif_c_plain_wall:.3f}s", flush=True)

    phase_s["5"] = time.perf_counter() - t_phase
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    for k in kernels:
        k.pop("equal")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
