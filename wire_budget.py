#!/usr/bin/env python3
"""Count the wire bytes of the north-star and mixed cells' fetches from
their dispatch structure, without solving anything.

    python3 wire_budget.py        # CPU only, a few seconds

For each cell it encodes the problem on the CPU, splits it into the
dispatches TorchScheduler runs (segment counts per fill and kind-scan run,
the kind scan's assignment width) and counts, from those shapes and the
window W: the bytes the parent commit's single fetch moved (every output
whole at int32, bools a byte each, the merged claim columns), and the bytes
of this commit's fetches (live rows, fill grids at int16, bools as bits,
a template snapshot per pipeline group and fill_max), per pipeline group
(the groups of _partition_ranges) and in all. A count, not a measurement.
"""

from __future__ import annotations

import json

import numpy as np


def cell_bytes(name, templates, pods) -> dict:
    from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
    from karpenter_tpu_torch.controllers.provisioning import scheduler as sched_mod

    s = TorchScheduler(templates, max_claims=4096, device="cpu")
    _sorted, enc = s._encode(pods, None)
    st = s._initial_state(enc)
    W, NB = st.template.shape[0], st.bank_template.shape[0]
    T, R, RID = st.its.shape[1], st.used.shape[1], st.bank_held.shape[1]
    E, V = st.exist_used.shape[0], st.reqs.mask.shape[2]
    TK = len(enc["topo_kids"])
    outs = []  # per output: (int bytes before, bool count before, int bytes after, bool count after, pods)
    for mode, segs in s._runs(enc):
        B = len(segs)
        pods_n = sum(hi - lo for lo, hi, _k in segs)
        if mode[0] == "fill":
            before = 4 * B * W + 4 * B * E + 12 * B + 4 * W
            after = 2 * B * W + 2 * B * E + 12 * B + 4 * W
            outs.append((before, 0, after, 0, pods_n))
        elif mode[0] == "kscan":
            maxc = s._kscan_maxc(max(hi - lo for lo, hi, _k in segs))
            outs.append((4 * B * maxc, B, 4 * B * maxc, B, pods_n))
        else:
            raise SystemExit(f"{name}: a {mode[0]} run; this count covers fill and kind-scan cells")
    state_int = 4 * NB + 4 * NB * R + 16
    state_bool = NB * T + NB * RID + TK * (NB * V + 2 * NB + E * V + 2 * E)
    any_fill = any(o[0] != o[2] for o in outs)

    def packed(n_int, n_bool):
        return n_int + -(-n_bool // 8)

    before = state_int + state_bool + sum(o[0] + o[1] for o in outs)
    single = packed(state_int + sum(o[2] for o in outs) + 4 * any_fill, state_bool + sum(o[3] for o in outs))
    groups = sched_mod._partition_ranges([o[4] for o in outs], s.pipeline_chunks)
    per_group = []
    for gi, (lo, hi) in enumerate(groups):
        gi_int = 4 * NB + sum(o[2] for o in outs[lo:hi]) + 4 * any(o[0] != o[2] for o in outs[lo:hi])
        gi_bool = sum(o[3] for o in outs[lo:hi])
        if gi == len(groups) - 1:
            gi_int, gi_bool = gi_int + state_int, gi_bool + state_bool
        per_group.append(packed(gi_int, gi_bool))
    return dict(cell=name, P=enc["P"], outputs=len(outs), W=W, NB=NB, T=T, R=R, RID=RID, TK=TK,
                outputs_per_group=[hi - lo for lo, hi in groups],
                parent_single_fetch_bytes=before, single_fetch_bytes=single,
                pipeline_group_bytes=per_group, pipeline_bytes=int(np.sum(per_group)))


def main() -> None:
    import torch

    from karpenter_tpu_torch import testing as T

    torch.set_num_threads(2)
    for name, templates, pods in (
        ("northstar", T.make_templates(1000), T.selector_pods(100_000)),
        ("mixed", T.make_templates(400), T.mixed_pods(16384)),
    ):
        print(json.dumps(cell_bytes(name, templates, pods)), flush=True)


if __name__ == "__main__":
    main()
