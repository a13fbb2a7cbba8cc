"""The resident incremental solver: schedule deltas, not snapshots.

A port of the JAX package's ResidentSession (controllers/provisioning/
scheduler.py:4494-5510). A session wraps a TorchScheduler and keeps its
solver state on the device across solve() calls; a steady round feeds
only the pod delta through it: departures of the newest rounds undo with
one retract_tail launch (kernel H10), arrivals append with one fill-scan
dispatch against the resident state. Every round that stays on the delta
path returns what a cold full solve of the current pod set (in session
order) returns, because conservative host-side gates fall back to a full
re-solve wherever they cannot prove it:

  * arrivals append only when the cold FFD sort of the union keeps every
    resident pod in place, and none of them undercuts the eviction floor
    (the elementwise max of the r_min every boundary compaction used);
  * departures retract only as an exact suffix of "pure" rounds (rounds
    whose pods landed only on claims those rounds opened);
  * the session goes resident only on a clean base solve (nothing
    unschedulable, nothing relaxed) of the fill family: no topology, no
    gangs, no enforced minValues, no reservations, no finite budgets, no
    volume machinery;
  * any change of the cluster's shape (vocab or pads, existing-node
    content) is an epoch change: full re-solve, new resident base.

Modes: delta / full / invalidated, each round with its reason.

The reference's shadow audit, quarantine and lying fixture (its guard
package), its fault-injection seams, its round ledger and its Prometheus
counters are not ported: this package has none of them.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch import gang as gang_mod
from karpenter_tpu_torch.controllers.provisioning.host_scheduler import (
    SchedulingResult,
    SimClaim,
    finalize_reserved,
    hostname_placeholder,
    pod_ffd_key,
)
from karpenter_tpu_torch.controllers.provisioning.scheduler import _decode_fill_segments
from karpenter_tpu_torch.controllers.provisioning.topology import Topology, pods_declare_topology
from karpenter_tpu_torch.models import labels as l
from karpenter_tpu_torch.ops import cuda as ops_cuda
from karpenter_tpu_torch.ops import solver as ops_solver
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.ops.encode import ReqSetTensors, as_tensor
from karpenter_tpu_torch.ops.kernels import fetch_tree
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements, hostports


def resident_enabled() -> bool:
    """The KTPU_RESIDENT switch (default on; 0 or false makes every round a
    plain TorchScheduler.solve)."""
    return os.environ.get("KTPU_RESIDENT", "1") not in ("0", "false")


class _DeltaUnsafe(RuntimeError):
    """A delta round failed a soundness gate; the session re-solves the
    round in full."""

    def __init__(self, mode: str, reason: str):
        super().__init__(reason)
        self.mode = mode
        self.reason = reason


def _device_fault(err: Exception) -> bool:
    """A fault of the card itself: a CUDA error that surfaces at a later
    call (as torch's RuntimeError) or device memory running out. It
    raises; it is not a reason to re-solve quietly."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    return isinstance(err, RuntimeError) and "CUDA" in str(err)


def plan_sorted(plan: dict) -> list:
    """The plan's kind entries in kid (first-appearance) order — the local
    kind axis the delta dispatch gathers from."""
    return sorted(plan["plan_kinds"], key=lambda t: t[1])


class ResidentSession:
    """Keeps a TorchScheduler's solver state resident on the device across
    solve() calls and feeds only the pod delta through it (see the module
    docstring). Unknown attributes delegate to the wrapped scheduler."""

    # a caller materializes bound pods only for sessions that ask
    wants_bound_pods = False

    def __init__(self, sched):
        self.sched = sched
        self._r: Optional[dict] = None
        self.last_mode = "full"
        self.last_reason = "cold"
        self.rounds_total = {"delta": 0, "full": 0, "invalidated": 0}
        self.last_timings: dict = {}
        # the delta path's dispatches in the last round (zeros on a full round)
        self.last_delta = {"fill_dispatches": 0, "retract_dispatches": 0}

    def __getattr__(self, name):
        return getattr(self.sched, name)

    # -- bookkeeping helpers ----------------------------------------------

    @staticmethod
    def _existing_sig(nodes) -> tuple:
        return tuple(
            (
                n.name,
                str(n.requirements),
                tuple(sorted(n.available.items())),
                tuple(sorted(n.used.items())),
                repr(n.taints),
                tuple(n.host_ports),
                n.volume_usage is not None,
            )
            for n in nodes or []
        )

    def _grows_vocab(self, rep) -> bool:
        """Whether encoding this kind would grow the vocab or the resource
        axis (the resident tensors predate it); reads the encoder without
        changing it, as observe_pod would see the kind."""
        enc = self.sched.encoder
        v = enc.vocab
        for rq in self.sched._pod_reqs(rep).values():
            if rq.key in enc.skip_keys:
                continue
            kid = v.key_to_id.get(rq.key)
            if kid is None:
                return True
            vt = v.value_to_id[kid]
            if any(val not in vt for val in rq.values):
                return True
        return any(name not in enc._resource_ids for name in rep.total_requests())

    def _kind_memo(self, table: str, k: int, make):
        r = self._r
        out = r[table].get(k)
        if out is None:
            out = r[table][k] = make(r["kind_reps"][k])
        return out

    def _kind_reqs(self, k: int) -> Requirements:
        return self._kind_memo("kind_reqs_c", k, self.sched._pod_reqs)

    def _kind_total(self, k: int) -> dict:
        return self._kind_memo("kind_total_c", k, lambda rep: rep.total_requests())

    def _kind_ports(self, k: int) -> list:
        return self._kind_memo("kind_ports_c", k, lambda rep: [hostports.port_key(h) for h in rep.spec.host_ports])

    # -- the TorchScheduler surface ---------------------------------------

    def solve(
        self,
        pods,
        existing_nodes=None,
        budgets=None,
        topology=None,
        volume_reqs=None,
        reserved_mode=None,
        reserved_in_use=None,
        pod_volumes=None,
        topology_factory=None,
        bound_pods=None,
        deadline=None,
        now=None,
        chunk_sink=None,
    ) -> SchedulingResult:
        """TorchScheduler.solve's arguments; `bound_pods` ((pod, ...)
        entries of the pods bound to the cluster; any with pod
        anti-affinity keeps the round off the delta path) also reaches the
        snapshot solve. `chunk_sink` stays supported: full rounds stream
        through it, delta rounds emit no chunk (the caller's final result
        carries everything)."""
        pods = list(pods)
        kwargs = dict(
            budgets=budgets,
            topology=topology,
            topology_factory=topology_factory,
            volume_reqs=volume_reqs,
            reserved_mode=reserved_mode,
            reserved_in_use=reserved_in_use,
            pod_volumes=pod_volumes,
            deadline=deadline,
            now=now,
            bound_pods=bound_pods,
            chunk_sink=chunk_sink,
        )
        if not resident_enabled():
            self._r = None
            return self.sched.solve(pods, existing_nodes, **kwargs)
        supported = not (
            budgets
            or volume_reqs
            or reserved_in_use
            or pod_volumes
            or (reserved_mode is not None and reserved_mode != self.sched.reserved_mode)
        )
        t0 = time.perf_counter()
        self.last_delta = {"fill_dispatches": 0, "retract_dispatches": 0}
        try:
            if not supported:
                raise _DeltaUnsafe("full", "unsupported_args")
            plan = self._classify(pods, existing_nodes, topology, topology_factory, bound_pods)
            result = self._solve_delta(plan, t0, deadline=deadline, now=now)
            mode, reason = "delta", "delta"
        except _DeltaUnsafe as gate:
            mode, reason = gate.mode, gate.reason
            result = self._solve_full(pods, existing_nodes, kwargs, capture=supported)
        self.last_mode, self.last_reason = mode, reason
        self.rounds_total[mode] += 1
        self.last_timings = dict(self.sched.last_timings or {})
        self.last_timings["resident"] = {"mode": mode, "reason": reason, "wall_s": time.perf_counter() - t0}
        return result

    # -- state fingerprint --------------------------------------------------

    @staticmethod
    def _round_sig(uids, n_open_start: int) -> bytes:
        """Content signature of one committed round: the pods it bound and
        the claim watermark it started from."""
        h = hashlib.blake2s(digest_size=8)
        h.update(str(int(n_open_start)).encode())
        for u in sorted(uids):
            h.update(b"\x00")
            h.update(str(u).encode())
        return h.digest()

    @property
    def fingerprint(self) -> str:
        """Running hash over the committed rounds' signatures; '' when there
        is no resident state."""
        r = self._r
        if r is None:
            return ""
        h = hashlib.blake2s(digest_size=8)
        for rec in r["rounds"]:
            h.update(rec["sig"])
        return h.hexdigest()

    @classmethod
    def replay_chain(cls, sched, pods_by_uid, existing, rounds):
        """Rebuild a session by replaying a cumulative transcript (round k's
        entry is every uid resident after round k, in arrival order). Each
        replayed round runs the gates the original ran, so a chain whose
        rounds all stayed resident gives the same fingerprint. None when a
        replayed round leaves a pod unschedulable or a uid has no pod."""
        session = cls(sched)
        for uids in rounds:
            try:
                pods = [pods_by_uid[u] for u in uids]
            except KeyError:
                return None
            result = session.solve(pods, [n.clone() for n in existing])
            if result.unschedulable:
                return None
        return session

    # -- full path ---------------------------------------------------------

    def _solve_full(self, pods, existing_nodes, kwargs, capture: bool):
        self._r = None
        if not capture:
            return self.sched.solve(pods, existing_nodes, **kwargs)
        self.sched._capture = True
        self.sched._captured = None
        try:
            result = self.sched.solve(pods, existing_nodes, **kwargs)
        finally:
            cap = self.sched._captured
            self.sched._captured = None
            self.sched._capture = False
        self._adopt(cap, existing_nodes, result)
        return result

    def _adopt(self, cap, input_existing, result) -> None:
        """Go resident on a clean captured full solve inside the delta-safe
        constraint family."""
        sched = self.sched
        if cap is None or result.unschedulable or result.relaxations:
            return
        enc = cap["enc"]
        if enc["P"] <= 0:
            return
        if enc["topo_kids"] or enc["vg_groups"] or enc["hg_groups"]:
            return
        topo = enc["topology"]
        if topo is not None and (topo.groups or topo.inverse_groups):
            return
        if bool(np.asarray(enc["gang_kind"]).any()) or enc["pre_unsched"]:
            return
        if not bool(np.all(enc["batchable"])):
            return
        if sched._res_active or sched._mv_active:
            return
        if any(v for v in sched.budgets.values()):
            return
        pods_sorted = cap["pods_sorted"]
        if len({p.uid for p in pods_sorted}) != len(pods_sorted):
            return
        sizes = np.array([pod_ffd_key(p)[1] for p in pods_sorted], dtype=np.float64)
        reps = enc["reps"]
        self._r = dict(
            state=cap["state"],
            enc=enc,
            n_claims=enc["n_claims"],
            order=[p.uid for p in pods_sorted],
            pod_by_uid={p.uid: p for p in pods_sorted},
            # session kid numbering == the union's first-appearance rank (the
            # sorted-order invariant makes the two coincide); ids are never
            # reused, so rank order survives retractions
            ranks=np.asarray(enc["kind_of"][: enc["P"]], dtype=np.int64).copy(),
            sizes=sizes,
            kind_sig_to_kid={sched._kind_sig(rep): k for k, rep in enumerate(reps)},
            kind_reps=dict(enumerate(reps)),
            next_kid=len(reps),
            kind_reqs_c={},
            kind_total_c={},
            kind_ports_c={},
            claims=cap["claims"],
            slot_to_claim=cap["slot_to_claim"],
            claim_kinds=cap["claim_kinds"],
            claim_pod_counts=cap["claim_pod_counts"],
            assignments=cap["assignments"],
            existing_assignments=cap["existing_assignments"],
            node_kinds=cap["node_kinds"],
            existing_nodes=result.existing,
            exist_pristine=[n.clone() for n in (input_existing or [])],
            exist_sig=self._existing_sig(input_existing),
            hostname_seq=len(cap["claims"]),
            rounds=[
                dict(
                    uids={p.uid for p in pods_sorted},
                    start_idx=0,
                    n_open_start=0,
                    pure=True,
                    new_kids=list(range(len(reps))),
                    sig=self._round_sig((p.uid for p in pods_sorted), 0),
                )
            ],
            n_open=int(cap["n_open"]),
            compact_rmin=cap["compact_rmin"],
            proto_cache={},
            its_cache={},
            vocab_sig=sched._sig(),
        )

    # -- classification ----------------------------------------------------

    def _classify(self, pods, existing_nodes, topology, topology_factory, bound_pods) -> dict:
        r = self._r
        sched = self.sched
        if r is None:
            raise _DeltaUnsafe("full", "cold")
        if sched._sig() != r["vocab_sig"]:
            raise _DeltaUnsafe("invalidated", "vocab_changed")
        if self._existing_sig(existing_nodes) != r["exist_sig"]:
            raise _DeltaUnsafe("invalidated", "existing_changed")
        pod_by_uid = r["pod_by_uid"]
        uid_list = [p.metadata.uid for p in pods]
        uids = set(uid_list)
        if len(uids) != len(pods):
            raise _DeltaUnsafe("full", "duplicate_uids")
        # a resident uid must carry the same content (the same object needs
        # no check: pod specs do not change after construction)
        arrivals: list = []
        for p, uid in zip(pods, uid_list):
            old = pod_by_uid.get(uid)
            if old is None:
                arrivals.append(p)
            elif old is not p and sched._kind_sig(p) != sched._kind_sig(old):
                raise _DeltaUnsafe("invalidated", "pod_mutated")
        departed = set(pod_by_uid) - uids
        if not arrivals and not departed:
            raise _DeltaUnsafe("full", "no_delta")
        # departures: an exact suffix of pure rounds
        retract_k = 0
        if departed:
            acc: set = set()
            rounds = r["rounds"]
            while acc != departed:
                retract_k += 1
                if retract_k >= len(rounds):
                    raise _DeltaUnsafe("full", "retract_base")
                rec = rounds[-retract_k]
                if not rec["pure"]:
                    raise _DeltaUnsafe("full", "retract_impure")
                acc |= rec["uids"]
                if not acc <= departed:
                    raise _DeltaUnsafe("full", "retract_unaligned")
        # arrivals: the constraint family
        plan_kinds: list = []  # (sig, kid, rep, is_new)
        if arrivals:
            if pods_declare_topology(arrivals):
                raise _DeltaUnsafe("full", "topology")
            if any(entry[0].spec.pod_anti_affinity for entry in bound_pods or ()):
                raise _DeltaUnsafe("full", "topology")
            if topology is not None and (topology.groups or topology.inverse_groups):
                raise _DeltaUnsafe("full", "topology")
            if topology_factory is not None:
                t = topology_factory(list(arrivals))
                if t.groups or t.inverse_groups:
                    raise _DeltaUnsafe("full", "topology")
            for p in arrivals:
                if gang_mod.is_gang_pod(p):
                    raise _DeltaUnsafe("full", "gang")
                sp = p.spec
                if sp.host_ports or sp.pvc_names or sp.resource_claims or sp.node_name:
                    raise _DeltaUnsafe("full", "pod_features")
            # a kind whose last pods leave with the retracted suffix is a
            # ghost: when it re-arrives it takes a FRESH id, or its stale
            # (too small) rank would sort it ahead of kinds that appear first
            # in the new union order
            surviving_kids = None
            if retract_k:
                cut_idx = r["rounds"][-retract_k]["start_idx"]
                surviving_kids = set(r["ranks"][:cut_idx].tolist())
            seen: dict = {}
            next_kid = r["next_kid"]
            for p in arrivals:
                sig = sched._kind_sig(p)
                if sig in seen:
                    continue
                kid = r["kind_sig_to_kid"].get(sig)
                if kid is not None and surviving_kids is not None and kid not in surviving_kids:
                    kid = None
                if kid is None:
                    if self._grows_vocab(p):
                        raise _DeltaUnsafe("invalidated", "vocab_growth")
                    seen[sig] = (next_kid, p, True)
                    next_kid += 1
                else:
                    seen[sig] = (kid, r["kind_reps"][kid], False)
            plan_kinds = [(sig, kid, rep, new) for sig, (kid, rep, new) in seen.items()]
        return dict(arrivals=arrivals, departed=departed, retract_k=retract_k, plan_kinds=plan_kinds)

    # -- delta path --------------------------------------------------------

    def _solve_delta(self, plan, t0: float, deadline=None, now=None) -> SchedulingResult:
        """Validate and encode the arrivals (host only, nothing mutated),
        then retract and append on the device. last_timings: encode_s the
        host work up to the first device call, device_s the retract, the
        append and its decode. `deadline` / `now` are accepted and unused,
        as in the reference: a delta round has no relaxation ladder."""
        r = self._r
        sched = self.sched
        arrivals = plan["arrivals"]
        retract_k = plan["retract_k"]
        delta = None
        if arrivals:
            entries = plan_sorted(plan)
            kid_of_sig = {sig: kid for sig, kid, _rep, _new in entries}
            local_reps = [rep for _sig, _kid, rep, _new in entries]
            local_of_kid = {kid: i for i, (_sig, kid, _rep, _new) in enumerate(entries)}
            rows = sched._kind_rows(local_reps, r["exist_pristine"], r["enc"]["E"])
            # eviction floor: an arrival below any compaction's r_min could
            # have fit a claim the resident state froze
            rmin = r["compact_rmin"]
            if rmin is not None and not bool(np.all(rows["requests"] >= rmin[None, :])):
                raise _DeltaUnsafe("full", "below_eviction_floor")
            nA = len(arrivals)
            a_ranks = np.empty(nA, dtype=np.int64)
            a_sizes = np.empty(nA, dtype=np.float64)
            for i, p in enumerate(arrivals):
                a_ranks[i] = kid_of_sig[sched._kind_sig(p)]
                a_sizes[i] = pod_ffd_key(p)[1]
            # survivors = session order minus the departed suffix (a sorted
            # sequence stays sorted under deletion); the cold stable lexsort
            # of the union must keep every survivor in place
            cut_idx = r["rounds"][-retract_k]["start_idx"] if retract_k else len(r["order"])
            s_ranks = r["ranks"][:cut_idx]
            s_sizes = r["sizes"][:cut_idx]
            n_surv = len(s_ranks)
            order = np.lexsort((np.concatenate([s_ranks, a_ranks]), -np.concatenate([s_sizes, a_sizes])))
            if not bool((order[:n_surv] == np.arange(n_surv)).all()):
                raise _DeltaUnsafe("full", "ffd_reorder")
            a_order = (order[n_surv:] - n_surv).astype(np.int64)
            kids_sorted = a_ranks[a_order]
            # segments: runs of one kind (contiguous under the stable sort)
            seg_list: list = []
            lo = 0
            for i in range(1, nA + 1):
                if i == nA or kids_sorted[i] != kids_sorted[lo]:
                    seg_list.append((lo, i, int(kids_sorted[lo])))
                    lo = i
            delta = dict(
                arrivals_sorted=[arrivals[i] for i in a_order],
                kids_sorted=kids_sorted,
                sizes_sorted=a_sizes[a_order],
                seg_list=seg_list,
                rows=rows,
                local_reps=local_reps,
                local_of_kid=local_of_kid,
            )
        t1 = time.perf_counter()
        # from here the resident state changes: a failure other than a gate
        # drops it and the round re-solves in full (a kernel that fails to
        # build or launch, a launcher that refuses its arguments and a
        # fault of the card are not such failures: they raise)
        try:
            if retract_k:
                self._retract(retract_k)
            if delta is not None:
                self._append(delta)
        except (_DeltaUnsafe, ops_cuda.KernelError):
            raise
        except Exception as err:
            if _device_fault(err):
                raise
            self._r = None
            raise _DeltaUnsafe("invalidated", f"apply_error:{type(err).__name__}")
        if sched.device.type == "cuda":
            torch.cuda.synchronize(sched.device)
        sched.last_timings = {"encode_s": t1 - t0, "device_s": time.perf_counter() - t1, "decode_s": 0.0}
        return SchedulingResult(
            claims=list(r["claims"]),
            unschedulable=[],
            assignments=dict(r["assignments"]),
            existing=r["existing_nodes"],
            existing_assignments=dict(r["existing_assignments"]),
        )

    def _retract(self, k: int) -> None:
        """Suffix undo of the last k (pure) rounds: one retract_tail launch
        and the mirrored rollback of the host bookkeeping."""
        r = self._r
        target = r["rounds"][-k]
        cut = int(target["n_open_start"])
        r["state"] = ops_solver.retract_tail(r["state"], cut, plain=self.sched.plain)
        self.last_delta["retract_dispatches"] += 1
        claims = r["claims"]
        while claims and claims[-1].slot >= cut:
            c = claims.pop()
            r["slot_to_claim"].pop(c.slot, None)
            r["claim_kinds"].pop(c.slot, None)
            r["claim_pod_counts"][c.slot] = 0
            for p in c.pods:
                r["assignments"].pop(p.uid, None)
        start = target["start_idx"]
        for uid in r["order"][start:]:
            r["pod_by_uid"].pop(uid, None)
        r["order"] = r["order"][:start]
        r["ranks"] = r["ranks"][:start]
        r["sizes"] = r["sizes"][:start]
        # drop kind registrations no surviving pod uses, WITHOUT reusing
        # their ids (monotone ids keep rank order == first-appearance order
        # when a retracted kind re-arrives)
        surviving = set(r["ranks"].tolist())
        for rec in r["rounds"][-k:]:
            for kid in rec["new_kids"]:
                if kid not in surviving:
                    rep = r["kind_reps"].pop(kid, None)
                    if rep is not None:
                        r["kind_sig_to_kid"].pop(self.sched._kind_sig(rep), None)
                    r["kind_reqs_c"].pop(kid, None)
                    r["kind_total_c"].pop(kid, None)
                    r["kind_ports_c"].pop(kid, None)
        del r["rounds"][-k:]
        r["hostname_seq"] = len(claims)
        r["n_open"] = cut

    def _append(self, delta: dict) -> None:
        """Run ONE fill-scan dispatch of the arrival kinds against the
        resident state and extend the session bookkeeping through the fill
        decode."""
        from types import SimpleNamespace

        r = self._r
        sched = self.sched
        enc = r["enc"]
        state = r["state"]
        n_claims = r["n_claims"]
        dev = sched.device
        E = enc["E"]
        arrivals_sorted = delta["arrivals_sorted"]
        seg_list = delta["seg_list"]
        rows = delta["rows"]
        local_of_kid = delta["local_of_kid"]
        local_reps = delta["local_reps"]

        # register the arrival kinds up front (the decode's kind memos read
        # them); a later delta_leftover drops the whole resident state
        new_kids: list = []
        for kid, i_local in local_of_kid.items():
            if kid not in r["kind_reps"]:
                rep = local_reps[i_local]
                r["kind_reps"][kid] = rep
                r["kind_sig_to_kid"][sched._kind_sig(rep)] = kid
                new_kids.append(kid)
        r["next_kid"] = max(r["next_kid"], max(r["kind_reps"]) + 1)

        # arrival kinds carry no host ports or volumes (gated): inert rows
        # at the resident lane widths
        M = len(local_reps)
        ports = torch.zeros((M, state.claim_ports.shape[1]), dtype=torch.int32, device=dev)
        vols = torch.zeros((M, state.exist_vols.shape[1]), dtype=torch.int32, device=dev)
        pod_topo, _rel = topo_ops.encode_pod_topology(
            Topology(), [], [], local_reps, as_tensor(rows["strict"][0], dev)
        )
        kinds = dict(
            reqs=ReqSetTensors.from_numpy(rows["reqs"], dev),
            requests=as_tensor(rows["requests"], dev),
            tmpl_ok=as_tensor(rows["tol"], dev),
            it_allow=as_tensor(rows["it_allow"], dev),
            exist_ok=as_tensor(rows["exist_ok"], dev),
            ports=ports,
            port_conf=ports,
            vols=vols,
            topo=pod_topo,
        )
        B = len(seg_list)
        xs = sched._gather_fill_xs(dict(kinds=kinds), [(lo, hi, local_of_kid[kid]) for lo, hi, kid in seg_list])
        state, ys = ops_solver.solve_fill(
            state, xs, enc["exist_tensors"], sched.it_tensors, enc["template_tensors"], sched.well_known,
            enc["topo_tensors"], enc["zone_kid"], enc["ct_kid"], n_claims, plain=sched.plain,
        )
        self.last_delta["fill_dispatches"] += 1
        f = fetch_tree(dict(
            fill_c=ys.fill_c, fill_e=ys.fill_e, open_start=ys.open_start, n_opened=ys.n_opened, tmpl=ys.tmpl,
            leftover=ys.leftover, status=ys.status, slot_map=state.slot_of, n_open=state.n_open,
        ))
        if int(f["leftover"][:B].sum()) > 0:
            # an arrival failed (NO_ROOM or no template): the full path owns
            # relaxation and escalation, and rebuilds from scratch
            self._r = None
            raise _DeltaUnsafe("full", "delta_leftover")
        slot_map = np.asarray(f["slot_map"], dtype=np.int64)
        f["slot_map"] = slot_map
        fill_c = f["fill_c"] = f["fill_c"][:B]
        fill_e = f["fill_e"] = f["fill_e"][:B]
        open_start, n_opened, tmpl_arr = f["open_start"], f["n_opened"], f["tmpl"]
        opened = [
            w for j in range(B) for w in range(int(open_start[j]), int(open_start[j]) + int(n_opened[j]))
        ]
        claim_template: dict[int, int] = {}
        for j in range(B):
            for w in range(int(open_start[j]), int(open_start[j]) + int(n_opened[j])):
                claim_template[int(slot_map[w])] = int(tmpl_arr[j])

        def ensure_claim(slot: int) -> SimClaim:
            claim = r["slot_to_claim"].get(slot)
            if claim is None:
                tmpl = sched.templates[claim_template[slot]]
                r["hostname_seq"] += 1
                hostname = hostname_placeholder(r["hostname_seq"])
                requirements = tmpl.requirements.copy()
                requirements.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, hostname))
                claim = SimClaim(
                    template=tmpl, requirements=requirements, used={}, instance_types=[], pods=[], slot=slot,
                    hostname=hostname,
                )
                r["slot_to_claim"][slot] = claim
                r["claims"].append(claim)
                r["claim_kinds"][slot] = {}
            return claim

        round_unsched: list = []
        ctx = SimpleNamespace(
            E=E,
            NC1=np.int64(n_claims + 1),
            existing_nodes=r["existing_nodes"],
            pods_sorted=arrivals_sorted,
            ensure_claim=ensure_claim,
            slot_to_claim=r["slot_to_claim"],
            claim_kinds=r["claim_kinds"],
            claim_pod_counts=r["claim_pod_counts"],
            assignments=r["assignments"],
            existing_assignments=r["existing_assignments"],
            unschedulable=round_unsched,
            node_kinds=r["node_kinds"],
            kind_ports=self._kind_ports,
            kind_total=self._kind_total,
        )
        _decode_fill_segments(ctx, seg_list, f)
        assert not round_unsched, "the leftover check missed a failure"
        # existing-node requirements for the kinds that landed on them
        if fill_e.any():
            for j, (_lo, _hi, kid) in enumerate(seg_list):
                for e in np.flatnonzero(fill_e[j]).tolist():
                    r["existing_nodes"][e].requirements.add(*self._kind_reqs(kid).values())
        # refresh the touched claims' device-carried columns
        _js, ss = np.nonzero(fill_c)
        pre_n_open = r["n_open"]
        touched = sorted({int(s) for s in ss} | set(opened))
        if touched:
            idx = torch.as_tensor(touched, dtype=torch.long).to(dev)
            got = fetch_tree(dict(used=state.used[idx], its=state.its[idx]))
            self._finalize_touched([int(slot_map[w]) for w in touched], got["used"], got["its"])
        # commit the session bookkeeping
        pure = not bool(fill_e.any()) and all(int(slot_map[s]) >= pre_n_open for s in ss)
        start_idx = len(r["order"])
        r["order"].extend(p.uid for p in arrivals_sorted)
        r["pod_by_uid"].update({p.uid: p for p in arrivals_sorted})
        r["ranks"] = np.concatenate([r["ranks"], delta["kids_sorted"]])
        r["sizes"] = np.concatenate([r["sizes"], delta["sizes_sorted"]])
        r["rounds"].append(
            dict(
                uids={p.uid for p in arrivals_sorted},
                start_idx=start_idx,
                n_open_start=pre_n_open,
                pure=pure,
                new_kids=new_kids,
                sig=self._round_sig((p.uid for p in arrivals_sorted), pre_n_open),
            )
        )
        r["n_open"] = int(f["n_open"])
        r["state"] = state

    def _finalize_touched(self, touched_slots, used_rows, its_rows) -> None:
        """Rebuild usage, viable instance types and requirements of the
        claims a delta touched, from the device carry (the cold decode's
        per-(template, kind set) memo, without topology narrowing)."""
        r = self._r
        rids = self.sched.encoder._resource_ids
        for slot, urow, irow in zip(touched_slots, used_rows, its_rows):
            claim = r["slot_to_claim"][slot]
            ksig = tuple(sorted(r["claim_kinds"][slot]))
            tid = id(claim.template)
            memo = r["proto_cache"].get((tid, ksig))
            if memo is None:
                proto = claim.template.requirements.copy()
                names = set(claim.template.daemon_requests)
                for k in ksig:
                    proto.add(*self._kind_reqs(k).values())
                    names.update(self._kind_total(k))
                names = sorted(names)
                ridx = np.array([rids[n] for n in names], dtype=np.int64)
                memo = r["proto_cache"][(tid, ksig)] = (proto, names, ridx)
            proto, names, ridx = memo
            reqs = proto.copy()
            reqs.add(Requirement.new(l.LABEL_HOSTNAME, Operator.IN, claim.hostname))
            claim.requirements = reqs
            claim.used = dict(zip(names, np.asarray(urow)[ridx].tolist()))
            row = np.asarray(irow)
            ikey = (tid, row.tobytes())
            sel_list = r["its_cache"].get(ikey)
            if sel_list is None:
                t_its, t_cat_idx = self.sched._template_it_index(claim.template)
                sel = np.flatnonzero(row[t_cat_idx])
                sel_list = r["its_cache"][ikey] = [t_its[i] for i in sel.tolist()]
            claim.instance_types = list(sel_list)
            finalize_reserved(claim)
