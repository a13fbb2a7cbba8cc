"""The resident session (karpenter_tpu_torch.controllers.provisioning.
ResidentSession) against the JAX package's ResidentSession, round by round.

Each case drives both sessions through the same rounds (the same pods,
made from each package's models, with the same uids) and asserts per round
the same mode and reason, the same packing (assert_same_packing, the
hostname of every slot, and a digest of every claim's pods, types, usage
and requirements), and the same fingerprint. The cases are
tests/test_resident.py's that lie inside the port (the reference's
windowed resident states are not: the port's window is the claims axis)
plus every fallback gate a round can hit. Both schedulers size alike here:
max_claims=128 keeps the reference's warm claims axis and window at the
full axis, which is where the port always sits.

Also: retract_tail's plain version against the jitted reference on states
carried across from the JAX package, leaf for leaf, at several cuts;
replay_chain rebuilding a fingerprint; and a plain TorchScheduler.solve,
capture on or off, returning the digests it returned before the session
existed.

`python tests/test_torch_resident.py` prints the JAX package's goldens for
chip_smoke.py's two resident cells. Tolerance: exact.
"""

import os
import sys
import types

if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
from karpenter_tpu.controllers.provisioning import TPUScheduler  # noqa: E402
from karpenter_tpu.controllers.provisioning import host_scheduler as j_host  # noqa: E402
from karpenter_tpu.controllers.provisioning import topology as j_topology  # noqa: E402
from karpenter_tpu.models import labels as jl  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu.scheduling import Requirement as JReq  # noqa: E402
from karpenter_tpu.scheduling import Requirements as JReqs  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import ResidentSession, TorchScheduler  # noqa: E402
from karpenter_tpu_torch.ops import cuda as p_cuda  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402

from test_solver import assert_same_packing  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JAX = types.SimpleNamespace(
    make_pod=j_pod.make_pod, l=jl, Node=j_host.ExistingSimNode, Req=JReq, Reqs=JReqs,
    HostPort=j_pod.HostPort, TSC=j_pod.TopologySpreadConstraint, Topology=j_topology.Topology,
)
PORT = types.SimpleNamespace(
    make_pod=T.make_pod, l=T.l, Node=T.ExistingSimNode, Req=T.Requirement, Reqs=T.Requirements,
    HostPort=T.HostPort, TSC=T.TopologySpreadConstraint, Topology=T.Topology,
)
N_TYPES = 12
MAX_CLAIMS = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kinds(S, name, n, cpu=1.0):
    return T.kind_batch(name, n, cpu=cpu, side=S)


def node(S, name, cpu=8.0):
    return S.Node(
        name=name, index=0, requirements=S.Reqs(S.Req.new(S.l.LABEL_HOSTNAME, "In", name)),
        available={"cpu": cpu, "memory": 8 * 2**30, "pods": 100.0},
    )


def sessions(monkeypatch, k=1, compact_min=None, resident=True):
    """(reference session, port session) with pipeline chunking K and the
    compaction threshold set alike in both."""
    monkeypatch.setenv("KTPU_RESIDENT", "1" if resident else "0")
    monkeypatch.delenv("KTPU_SCAN_WINDOW", raising=False)
    if k > 1:
        monkeypatch.setenv("KTPU_PIPELINE_CHUNKS", str(k))
        monkeypatch.setenv("KTPU_PIPELINE_MIN_PODS", "0")
    else:
        monkeypatch.setenv("KTPU_PIPELINE_CHUNKS", "0")
    if compact_min is not None:
        monkeypatch.setenv("KTPU_COMPACT_MIN_PODS", str(compact_min))
    else:
        monkeypatch.delenv("KTPU_COMPACT_MIN_PODS", raising=False)
    js = TPUScheduler(bench.make_templates(N_TYPES), max_claims=MAX_CLAIMS).resident_session()
    ps_sched = TorchScheduler(T.make_templates(N_TYPES), max_claims=MAX_CLAIMS, device="cpu")
    ps_sched.pipeline_chunks = k if k > 1 else 0
    if k > 1:
        ps_sched.pipeline_min_pods = 0
    if compact_min is not None:
        ps_sched.compact_min_pods = compact_min
    ps = ps_sched.resident_session()
    assert isinstance(ps, ResidentSession)
    return js, ps


def assert_round(rj, rp, js, ps, what):
    assert (ps.last_mode, ps.last_reason) == (js.last_mode, js.last_reason), what
    assert_same_packing(rj, rp)
    assert {c.slot: c.hostname for c in rj.claims} == {c.slot: c.hostname for c in rp.claims}, what
    assert T.claims_digest(rj) == T.claims_digest(rp), what
    assert rj.existing_assignments == rp.existing_assignments, what
    assert ps.fingerprint == js.fingerprint, what


def drive(monkeypatch, case, k=1, compact_min=None, resident=True, cold_check=True):
    """Run case(S) -> [(pods, kwargs)] through both sessions; returns the
    per-round (mode, reason) list and the two sessions."""
    js, ps = sessions(monkeypatch, k, compact_min, resident)
    modes = []
    for i, ((pj, kj), (pp, kp)) in enumerate(zip(case(JAX), case(PORT))):
        rj = js.solve(list(pj), **kj)
        rp = ps.solve(list(pp), **kp)
        assert_round(rj, rp, js, ps, f"round {i}")
        modes.append((ps.last_mode, ps.last_reason))
        if cold_check and not rp.unschedulable and "budgets" not in kp:
            # a delta round equals a cold full solve of the union
            cold = TorchScheduler(T.make_templates(N_TYPES), max_claims=MAX_CLAIMS, device="cpu")
            if k > 1:
                cold.pipeline_chunks, cold.pipeline_min_pods = k, 0
            else:
                cold.pipeline_chunks = 0
            if compact_min is not None:
                cold.compact_min_pods = compact_min
            ex = kp.get("existing_nodes")
            rc = cold.solve(list(pp), [n.clone() for n in ex] if ex else None)
            assert T.claims_digest(rc) == T.claims_digest(rp), f"round {i}: differs from a cold solve"
    assert ps.rounds_total == js.rounds_total
    return modes, js, ps


def plain_rounds(*unions):
    return [(u, {}) for u in unions]


# ---------------------------------------------------------------------------
# tests/test_resident.py's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_arrivals_only(monkeypatch, k):
    def case(S):
        base = kinds(S, "a", 16) + kinds(S, "b", 12)
        d = [kinds(S, f"d{r}", 6) for r in range(3)]
        return plain_rounds(base, base + d[0], base + d[0] + d[1], base + d[0] + d[1] + d[2])

    modes, _js, ps = drive(monkeypatch, case, k)
    assert modes == [("full", "cold")] + [("delta", "delta")] * 3
    assert ps.last_timings["resident"]["mode"] == "delta"


def test_same_kind_arrival_appends(monkeypatch):
    def case(S):
        base = kinds(S, "a", 12) + kinds(S, "b", 12)
        more_b = [S.make_pod(f"b-{12 + i}", cpu=1.0, memory="1Gi") for i in range(6)]
        for p in more_b:
            p.metadata.labels = {"app": "b"}
            p.metadata.uid = p.metadata.name
        return plain_rounds(base, base + more_b)

    modes, _js, _ps = drive(monkeypatch, case)
    assert modes[-1] == ("delta", "delta")


def test_smaller_arrival_without_compaction(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        return plain_rounds(base, base + kinds(S, "small", 5, cpu=0.5))

    assert drive(monkeypatch, case)[0][-1] == ("delta", "delta")


def test_departures_retract(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        return plain_rounds(base, base + kinds(S, "d1", 8), base)

    modes, _js, ps = drive(monkeypatch, case)
    assert modes[1:] == [("delta", "delta")] * 2
    assert ps.last_delta == {"fill_dispatches": 0, "retract_dispatches": 1}


def test_multi_round_suffix_retract(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        b1, b2 = kinds(S, "d1", 6), kinds(S, "d2", 6)
        return plain_rounds(base, base + b1, base + b1 + b2, base)

    modes, _js, ps = drive(monkeypatch, case)
    assert modes[1:] == [("delta", "delta")] * 3
    assert ps.last_delta["retract_dispatches"] == 1


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mixed_round(monkeypatch, k):
    def case(S):
        base = kinds(S, "a", 16)
        b1, b2 = kinds(S, "d1", 8), kinds(S, "d2", 5)
        return plain_rounds(base, base + b1, base + b2)

    modes, _js, ps = drive(monkeypatch, case, k)
    assert modes[-1] == ("delta", "delta")
    assert ps.last_delta == {"fill_dispatches": 1, "retract_dispatches": 1}


def test_ghost_kind_rearrival_gets_a_fresh_rank(monkeypatch):
    """A round that retracts kind b's only batch AND lands a new batch of
    b-content pods after a fresh kind d must not reuse b's stale rank."""
    def case(S):
        base = kinds(S, "a", 12)
        b_old = kinds(S, "b", 6)
        b_new = [S.make_pod(f"b-new-{i}", cpu=1.0, memory="1Gi") for i in range(5)]
        for p in b_new:
            p.metadata.labels = {"app": "b"}
            p.metadata.uid = p.metadata.name
        return plain_rounds(base, base + b_old, base + kinds(S, "d", 5) + b_new)

    modes, _js, ps = drive(monkeypatch, case)
    assert modes[1:] == [("delta", "delta")] * 2
    r = ps._r
    assert r["kind_sig_to_kid"][ps.sched._kind_sig(r["pod_by_uid"]["b-new-0"])] > 2


def test_retract_of_base_pod_triggers_full_resolve(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        b1 = kinds(S, "d1", 6)
        union = base[1:] + b1
        return plain_rounds(base, base + b1, union, union + kinds(S, "d2", 4))

    modes, _js, _ps = drive(monkeypatch, case)
    assert modes[2:] == [("full", "retract_unaligned"), ("delta", "delta")]


def test_partial_batch_departure_triggers_full_resolve(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        b1 = kinds(S, "d1", 8)
        return plain_rounds(base, base + b1, base + b1[:4])

    assert drive(monkeypatch, case)[0][-1] == ("full", "retract_unaligned")


def test_epoch_invalidation_on_vocab_growth(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        newcomer = S.make_pod("sel-0", cpu=1.0, memory="1Gi")
        newcomer.spec.node_selector = {"example.com/team": "search"}
        newcomer.metadata.uid = "sel-0"
        return plain_rounds(base, base + [newcomer])

    modes, _js, _ps = drive(monkeypatch, case, cold_check=False)
    assert modes[-1] == ("invalidated", "vocab_growth")


def test_eviction_floor_falls_back(monkeypatch):
    """A base solve that ran boundary compaction sets the eviction floor;
    an arrival below it goes to the full path."""
    def case(S):
        base = kinds(S, "a", 12) + kinds(S, "b", 12)
        return plain_rounds(base, base + kinds(S, "tiny", 4, cpu=0.25))

    modes, js, _ps = drive(monkeypatch, case, k=2, compact_min=8)
    assert modes[-1] == ("full", "below_eviction_floor")


def test_unschedulable_arrival_falls_back(monkeypatch):
    def case(S):
        base = kinds(S, "a", 12)
        whale = S.make_pod("whale-0", cpu=10000.0, memory="1Gi")
        whale.metadata.uid = "whale-0"
        return plain_rounds(base, base + [whale], base + [whale] + kinds(S, "d1", 3))

    modes, _js, ps = drive(monkeypatch, case)
    assert modes[1][0] == "full"
    # a failing pod parks the session: nothing resident while it stays
    assert modes[2] == ("full", "cold") and ps._r is None


def test_resident_disabled_restores_snapshot_path(monkeypatch):
    def case(S):
        base = kinds(S, "a", 12)
        return plain_rounds(base, base + kinds(S, "d1", 4))

    _modes, _js, ps = drive(monkeypatch, case, resident=False)
    assert ps._r is None and ps.fingerprint == ""


def test_existing_node_change_invalidates(monkeypatch):
    def case(S):
        base = kinds(S, "a", 12)
        union = base + kinds(S, "d1", 4)
        return [
            (base, dict(existing_nodes=[node(S, "n-1")])),
            (union, dict(existing_nodes=[node(S, "n-1")])),
            (union + kinds(S, "d2", 4), dict(existing_nodes=[node(S, "n-1", cpu=4.0)])),
        ]

    modes, _js, _ps = drive(monkeypatch, case)
    assert modes[1:] == [("delta", "delta"), ("invalidated", "existing_changed")]


def test_topology_factory_rounds(monkeypatch):
    """A caller's topology_factory builds each full round's topology (and
    the arrivals' in the topology gate): a factory of empty topologies
    keeps every round on the delta path."""
    def case(S):
        base = kinds(S, "a", 12)
        kw = dict(topology_factory=lambda pods: S.Topology())
        return [(base, kw), (base + kinds(S, "d1", 4), kw), (base, kw)]

    modes, _js, _ps = drive(monkeypatch, case)
    assert modes == [("full", "cold"), ("delta", "delta"), ("delta", "delta")]


def test_round_modes_are_counted(monkeypatch):
    def case(S):
        base = kinds(S, "a", 12)
        union = base + kinds(S, "d1", 4)
        newcomer = S.make_pod("sel-0", cpu=1.0, memory="1Gi")
        newcomer.spec.node_selector = {"example.com/team": "search"}
        newcomer.metadata.uid = "sel-0"
        return plain_rounds(base, union, union + [newcomer])

    _modes, _js, ps = drive(monkeypatch, case, cold_check=False)
    assert ps.rounds_total == {"delta": 1, "full": 1, "invalidated": 1}


# ---------------------------------------------------------------------------
# every other fallback gate
# ---------------------------------------------------------------------------


def _gate_duplicate(S):
    base = kinds(S, "a", 12)
    return plain_rounds(base, base + base[:1])


def _gate_no_delta(S):
    base = kinds(S, "a", 12)
    return plain_rounds(base, list(base))


def _gate_unsupported(S):
    base = kinds(S, "a", 12)
    return [(base, {}), (base + kinds(S, "d1", 4), dict(budgets={"default": {"cpu": 1000.0}}))]


def _gate_topology(S):
    base = kinds(S, "a", 12)
    spread = kinds(S, "sp", 4)
    for p in spread:
        p.spec.topology_spread_constraints = [
            S.TSC(max_skew=1, topology_key=S.l.LABEL_TOPOLOGY_ZONE, label_selector={"app": "sp"})
        ]
    return plain_rounds(base, base + spread)


def _gate_pod_features(S):
    base = kinds(S, "a", 12)
    hp = kinds(S, "hp", 3)
    for p in hp:
        p.spec.host_ports = [S.HostPort(port=8080)]
    return plain_rounds(base, base + hp)


def _gate_pod_mutated(S):
    base = kinds(S, "a", 12)
    twin = S.make_pod("a-0", cpu=2.0, memory="1Gi")
    twin.metadata.labels = {"app": "a"}
    twin.metadata.uid = "a-0"
    return plain_rounds(base, [twin] + base[1:] + kinds(S, "d1", 2))


def _gate_impure(S):
    # the arrival tops up the base's claim: the round is not pure
    base = kinds(S, "a", 1, cpu=0.25)
    return plain_rounds(base, base + kinds(S, "d1", 1, cpu=0.25), base)


def _gate_delta_leftover(S):
    # an arrival pinned to a hostname no claim can have places nowhere
    base = kinds(S, "a", 12)
    pinned = kinds(S, "pinned", 2, cpu=0.5)
    for p in pinned:
        p.spec.node_selector = {S.l.LABEL_HOSTNAME: "nowhere"}
    return plain_rounds(base, base + pinned)


def _gate_retract_base(S):
    # every resident pod departs: the base round would have to unwind
    base = kinds(S, "a", 12)
    return plain_rounds(base, base + kinds(S, "d1", 4), kinds(S, "z", 4))


def _gate_ffd_reorder(S):
    base = kinds(S, "a", 12)
    return plain_rounds(base, base + kinds(S, "big", 3, cpu=4.0))


@pytest.mark.parametrize(
    "case, want",
    [
        (_gate_duplicate, ("full", "duplicate_uids")),
        (_gate_no_delta, ("full", "no_delta")),
        (_gate_unsupported, ("full", "unsupported_args")),
        (_gate_topology, ("full", "topology")),
        (_gate_pod_features, ("full", "pod_features")),
        (_gate_pod_mutated, ("invalidated", "pod_mutated")),
        (_gate_impure, ("full", "retract_impure")),
        (_gate_delta_leftover, ("full", "delta_leftover")),
        (_gate_retract_base, ("full", "retract_base")),
        (_gate_ffd_reorder, ("full", "ffd_reorder")),
    ],
    ids=["duplicate_uids", "no_delta", "unsupported_args", "topology", "pod_features", "pod_mutated",
         "retract_impure", "delta_leftover", "retract_base", "ffd_reorder"],
)
def test_fallback_gates(monkeypatch, case, want):
    modes, _js, _ps = drive(monkeypatch, case, cold_check=case is not _gate_duplicate)
    assert modes[-1] == want


def _retract_refused(state, cut, plain=False):
    # the launcher's own argument check, as a slot_of of the wrong dtype
    # reaches it
    return p_cuda.retract_tail(state._replace(slot_of=state.slot_of.to(torch.int64)), cut)


def _retract_device_fault(state, cut, plain=False):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def _retract_other(state, cut, plain=False):
    raise IndexError("retract")


@pytest.mark.parametrize(
    "fault, raises",
    [(_retract_refused, p_cuda.LaunchRefused), (_retract_device_fault, RuntimeError), (_retract_other, None)],
    ids=["launcher_refusal", "device_fault", "other"],
)
def test_retract_failure_raises_or_invalidates(monkeypatch, fault, raises):
    """A launcher that refuses its arguments, or a fault of the card,
    inside a retract round raises out of the session; any other failure
    while the delta is applied drops the resident state and re-solves the
    round in full (invalidated / apply_error)."""
    _js, ps = sessions(monkeypatch)
    base, b1 = kinds(PORT, "a", 16), kinds(PORT, "d1", 8)
    ps.solve(list(base))
    ps.solve(list(base + b1))
    assert ps.last_mode == "delta"
    monkeypatch.setattr(p_solver, "retract_tail", fault)
    if raises is not None:
        with pytest.raises(raises):
            ps.solve(list(base))
        return
    result = ps.solve(list(base))
    assert (ps.last_mode, ps.last_reason) == ("invalidated", "apply_error:IndexError")
    cold = TorchScheduler(T.make_templates(N_TYPES), max_claims=MAX_CLAIMS, device="cpu")
    cold.pipeline_chunks = 0
    assert T.claims_digest(result) == T.claims_digest(cold.solve(list(base)))


def test_retracted_state_survives_a_later_base_solve(monkeypatch):
    """A retract round reads the resident state after the scheduler ran
    another (non-session) solve: the state shares no tensor with it."""
    js, ps = sessions(monkeypatch)
    rounds = {}
    for S, sess in ((JAX, js), (PORT, ps)):
        base = kinds(S, "a", 16)
        b1, b2 = kinds(S, "d1", 8), kinds(S, "d2", 5)
        sess.solve(list(base))
        sess.solve(list(base + b1))
        sess.sched.solve(kinds(S, "other", 40))
        rounds[id(sess)] = (sess.solve(list(base)), sess.solve(list(base + b2)))
    for a, b in zip(rounds[id(js)], rounds[id(ps)]):
        assert T.claims_digest(a) == T.claims_digest(b)
    assert (ps.last_mode, ps.fingerprint) == (js.last_mode, js.fingerprint) == ("delta", js.fingerprint)


def test_replay_chain_rebuilds_the_fingerprint(monkeypatch):
    def case(S):
        base = kinds(S, "a", 16)
        b1, b2 = kinds(S, "d1", 6), kinds(S, "d2", 7)
        return plain_rounds(base, base + b1, base + b1 + b2, base + b1)

    _modes, js, ps = drive(monkeypatch, case)
    transcript = [list(ps._r["order"][: rec["start_idx"] + len(rec["uids"])]) for rec in ps._r["rounds"]]
    pods = dict(ps._r["pod_by_uid"])
    sched = TorchScheduler(T.make_templates(N_TYPES), max_claims=MAX_CLAIMS, device="cpu")
    sched.pipeline_chunks = 0
    again = ResidentSession.replay_chain(sched, pods, [], transcript)
    assert again is not None and again.fingerprint == ps.fingerprint == js.fingerprint
    assert ResidentSession.replay_chain(sched, pods, [], [transcript[0] + ["missing"]]) is None


# ---------------------------------------------------------------------------
# retract_tail: the plain version against the jitted reference
# ---------------------------------------------------------------------------


def _leaves_equal(jst, pst, what):
    a = p_solver.to_numpy(p_solver.from_numpy(p_solver.SolverState, jax.tree.map(np.asarray, jst), "cpu"))
    b = p_solver.to_numpy(pst)
    assert set(a) == set(b)
    bad = [k for k in a if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]
    assert not bad, (what, bad)


@pytest.mark.parametrize("window", [0, 8])
def test_retract_tail_plain_matches_reference(monkeypatch, window):
    """States from the reference session after a compacted base and three
    delta rounds (window 0: the full axis, bank rows frozen by boundary
    compaction; window 8: a window narrower than the claims axis), at the
    cuts n_open (a no-op), every round boundary, a mid-round id and 0."""
    monkeypatch.setenv("KTPU_RESIDENT", "1")
    monkeypatch.setenv("KTPU_PIPELINE_CHUNKS", "2")
    monkeypatch.setenv("KTPU_PIPELINE_MIN_PODS", "0")
    monkeypatch.setenv("KTPU_COMPACT_MIN_PODS", "8")
    if window:
        monkeypatch.setenv("KTPU_SCAN_WINDOW", str(window))
    else:
        monkeypatch.delenv("KTPU_SCAN_WINDOW", raising=False)
    js = TPUScheduler(bench.make_templates(N_TYPES), max_claims=MAX_CLAIMS).resident_session()
    base = kinds(JAX, "a", 12) + kinds(JAX, "b", 12)
    union = list(base)
    js.solve(union)
    for r in range(3):
        union = union + kinds(JAX, f"d{r}", 5 + 3 * r)
        js.solve(list(union))
        assert js.last_mode == "delta", js.last_reason
    jst = js._r["state"]
    assert bool(np.asarray(jst.bank_frozen).any()), "no frozen bank row: compaction never ran"
    pst = p_solver.from_numpy(p_solver.SolverState, jax.tree.map(np.asarray, jst), "cpu")
    n_open = int(jst.n_open)
    cuts = sorted({n_open, 0, n_open // 2} | {rec["n_open_start"] for rec in js._r["rounds"]})
    for cut in cuts:
        want = j_solver.retract_tail(jst, jnp.int32(cut))
        got = p_solver.retract_tail(pst, cut)
        _leaves_equal(want, got, f"cut {cut}")
        # the wrapper leaves its input as it was
        _leaves_equal(jst, pst, f"input after cut {cut}")


# ---------------------------------------------------------------------------
# the plain solve is unchanged by the capture
# ---------------------------------------------------------------------------

# claims_digest of TorchScheduler(device="cpu").solve on each workload, as
# the port returned them before the resident session (and its capture)
# existed
PLAIN_DIGESTS = {
    "mixed_256x40": "26283b6e9200c488c0fc0cc3beeab48b6099600b71507ec0527fa31ea48975ef",
    "perpod_96x40": "367c55742a30896b24d9c79cf33e45682358d86b24348b15f33fdf5ee143c09c",
    "selector_1100x40": "940cf5e7a391e875e1ab748462394597f87dafad098046dae78b5863f54512ed",
    "selector_256x40": "02f91d99a95f2f4efe25b939c735736770bf51bda71fd7982f913f9e0cd9d841",
}
WORKLOADS = {
    "mixed_256x40": (lambda: T.mixed_pods(256), None),
    "perpod_96x40": (lambda: T.perpod_pods(96, kinds=3), 64),
    # compacted at the boundaries (P >= compact_min_pods)
    "selector_1100x40": (lambda: T.selector_pods(1100), 256),
    "selector_256x40": (lambda: T.selector_pods(256), None),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("capture", [False, True])
def test_plain_solve_digest_unchanged(name, capture):
    make, max_claims = WORKLOADS[name]
    sched = TorchScheduler(T.make_templates(40), max_claims=max_claims, device="cpu")
    sched._capture = capture
    result = sched.solve(make())
    assert T.claims_digest(result) == PLAIN_DIGESTS[name]
    assert (sched._captured is not None) == capture


# ---------------------------------------------------------------------------
# the chip cells' goldens
# ---------------------------------------------------------------------------


def print_goldens() -> None:
    """The JAX package's per-round (mode, reason, claims digest) and final
    fingerprint on chip_smoke.py's two resident cells, and its
    retract_tail dispatches, as Python literals."""
    n_rt = [0]
    orig = j_solver.retract_tail

    def counted(*a, **k):
        n_rt[0] += 1
        return orig(*a, **k)

    j_solver.retract_tail = counted
    try:
        for name, trace in (
            ("resident_retract_16380x63", T.retract_trace(**T.RETRACT, side=JAX)),
            ("steady_16384x64", T.steady_trace(**T.STEADY, side=JAX)),
        ):
            s = TPUScheduler(bench.make_templates(T.RESIDENT_TYPES), max_claims=T.RESIDENT_MAX_CLAIMS)
            session = s.resident_session()
            n_rt[0] = 0
            rounds = []
            for label, union in trace:
                r = session.solve(list(union))
                assert not r.unschedulable
                rounds.append((label, session.last_mode, session.last_reason, len(r.claims), T.claims_digest(r)))
            print(f"{name} = dict(")
            print("    rounds=[")
            for rec in rounds:
                print(f"        {rec!r},")
            print("    ],")
            print(f"    fingerprint={session.fingerprint!r},")
            print(f"    retracts={n_rt[0]},")
            print(")", flush=True)
    finally:
        j_solver.retract_tail = orig


if __name__ == "__main__":
    sys.exit(print_goldens())
