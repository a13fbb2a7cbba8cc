"""The pipelined decode and the rest of solve's arguments on the port
(TorchScheduler.solve with KTPU_PIPELINE_MIN_PODS=0: fetch and decode
group by group, chunk_sink, deadline / now, bound_pods) against the JAX
package's TPUScheduler.

- The three dispatch modes of tests/test_pipeline.py (selector pods on the
  fill scan, the topology mix over fill and kind-scan dispatches, per-pod
  chunks under a pool budget) at K = 2 and 4 chunk groups: the same
  result, the same last_timings["pipeline"]["n_chunks"], and the same
  sequence of chunk_sink messages (uids mapped to pod names); bound_pods
  is accepted. The result does not depend on K, but n_chunks and the
  stream do, so the reference solves once per (problem, K), and every
  check of that pair reads that one solve.
- The streamed deltas add up to the result.
- deadline / now: a stub clock past the deadline stops the relaxation
  ladder after round 1 in both packages, with the same result.
- ResidentSession: a full round streams the reference's chunks; a delta
  round streams none.

Tolerance: exact.
"""

import contextlib
import os

import pytest
import torch

from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.models import pod as j_pod
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.models import pod as p_pod
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401
from test_torch_resident import JAX as RJAX
from test_torch_resident import PORT as RPORT
from test_torch_resident import kinds, sessions
from test_torch_scheduler import JAX_SIDE, PORT_SIDE, _view

# name -> (build(S) -> (templates, pods), max_claims, budgets, solve chunk)
PROBLEMS = {
    "selectors": (lambda S: (S.templates(40), S.selector_pods(160)), 128, None, None),
    "topology_mix": (lambda S: (S.templates(40), S.mixed_pods(120)), 128, None, None),
    "perpod_budgets": (lambda S: (S.templates(24), S.mixed_pods(96)), 128, {"default": {"cpu": 100000.0}}, 24),
}
_REF: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _pipeline_env(k: int, solve_chunk=None):
    env = dict(KTPU_PIPELINE_CHUNKS=str(k), KTPU_PIPELINE_MIN_PODS="0")
    if solve_chunk is not None:
        env["KTPU_SOLVE_CHUNK"] = str(solve_chunk)
    old = {v: os.environ.get(v) for v in (*env, "KTPU_SOLVE_CHUNK", "KTPU_SCAN_WINDOW")}
    os.environ.pop("KTPU_SCAN_WINDOW", None)
    os.environ.update(env)
    try:
        yield
    finally:
        for v, x in old.items():
            if x is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = x


def _stream_view(msgs, name_of) -> list:
    """chunk_sink messages with pod uids mapped to names."""
    out = []
    for kind, delta in msgs:
        if delta is None:
            out.append((kind, None))
            continue
        out.append((kind, (
            [(slot, [name_of[u] for u in uids]) for slot, uids in delta["claims"]],
            [(name_of[u], node) for u, node in delta["existing"]],
            [(name_of[u], r) for u, r in delta["unsched"]],
        )))
    return out


def _run(side: str, name: str, k: int):
    build, max_claims, budgets, solve_chunk = PROBLEMS[name]
    S = JAX_SIDE if side == "jax" else PORT_SIDE
    templates, pods = build(S)
    msgs: list = []
    with _pipeline_env(k, solve_chunk):
        if side == "jax":
            sched = TPUScheduler(templates, pod_pad=None, max_claims=max_claims)
        else:
            sched = TorchScheduler(templates, max_claims=max_claims, device="cpu")
            if solve_chunk is not None:
                sched.solve_chunk = solve_chunk
        result = sched.solve(pods, budgets=budgets, bound_pods=[], chunk_sink=msgs.append)
    name_of = {p.uid: p.name for p in pods}
    return result, sched.last_timings.get("pipeline"), _stream_view(msgs, name_of), msgs


def _reference(name: str, k: int):
    if (name, k) not in _REF:
        result, pl, stream, _msgs = _run("jax", name, k)
        _REF[(name, k)] = (_view(result), pl["n_chunks"] if pl else None, stream)
    return _REF[(name, k)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_pipelined_solve_matches_reference(name, k):
    """The result, n_chunks and the chunk_sink sequence equal the
    reference's; the pipeline stats carry the reference's keys; the
    streamed deltas add up to the result."""
    view, n_chunks, stream = _reference(name, k)
    result, pl, got_stream, msgs = _run("port", name, k)
    assert pl is not None and 2 <= pl["n_chunks"] <= k, pl
    assert pl["n_chunks"] == n_chunks
    for key in ("overlap_frac", "fused_final", "sync_wire_s", "wire_s", "host_decode_s", "final_fetch_s"):
        assert key in pl, key
    assert all("host_rss_mb" in c and "cpu_s" in c for c in pl["chunks"])
    assert pl["true_overlap_groups"] is None  # no card: no device events
    assert _view(result) == view
    assert got_stream == stream
    # the deltas after the last reset rebuild the result
    last = max(i for i, (kind, _d) in enumerate(msgs) if kind == "reset")
    claims: dict = {}
    existing, unsched = [], []
    for _kind, d in msgs[last + 1:]:
        for slot, uids in d["claims"]:
            claims.setdefault(slot, []).extend(uids)
        existing += d["existing"]
        unsched += d["unsched"]
    assert claims == {c.slot: [p.uid for p in c.pods] for c in result.claims}
    assert existing == list(result.existing_assignments.items())
    assert unsched == [(p.uid, r) for p, r in result.unschedulable]


def _preferring_pods(S, n: int):
    """Pods that prefer a zone no type offers: round 1 treats the
    preference as required and fails them; round 2 relaxes it."""
    aff = S.NodeAffinity(preferred=[S.PreferredSchedulingTerm(
        weight=1, match_expressions=[{"key": "topology.kubernetes.io/zone", "operator": "In", "values": ["nowhere"]}],
    )])
    return [S.make_pod(f"d-{i}", cpu=0.5, memory="1Gi", node_affinity=aff) for i in range(n)]


def test_deadline_stops_the_ladder_after_round_one():
    """A clock past the deadline: both packages return round 1's result
    (the preference still binding); without it both relax and place."""
    results = {}
    for side, mod, S, make in (("jax", j_pod, JAX_SIDE, lambda t: TPUScheduler(t, max_claims=32)),
                               ("port", p_pod, PORT_SIDE, lambda t: TorchScheduler(t, max_claims=32, device="cpu"))):
        sched = make(S.templates(8))
        stopped = sched.solve(_preferring_pods(mod, 6), deadline=1.0, now=lambda: 2.0)
        relaxed = sched.solve(_preferring_pods(mod, 6), deadline=3.0, now=lambda: 2.0)
        results[side] = (_view(stopped), _view(relaxed))
    assert results["jax"] == results["port"]
    stopped, relaxed = results["port"]
    assert len(stopped["unschedulable"]) == 6 and not relaxed["unschedulable"]


def test_resident_full_round_streams_and_delta_round_does_not(monkeypatch):
    """A ResidentSession's full round streams the reference's chunks
    (pipelined at K = 2); its delta round streams nothing."""
    js, ps = sessions(monkeypatch, k=2)
    rounds = [lambda S: kinds(S, "a", 24), lambda S: kinds(S, "a", 24) + kinds(S, "b", 8)]
    for i, make in enumerate(rounds):
        jpods, ppods = make(RJAX), make(RPORT)
        jmsgs, pmsgs = [], []
        jr = js.solve(jpods, chunk_sink=jmsgs.append)
        pr = ps.solve(ppods, chunk_sink=pmsgs.append)
        assert js.last_mode == ps.last_mode == ("full" if i == 0 else "delta")
        assert _view(jr) == _view(pr)
        jname = {p.uid: p.name for p in jpods}
        pname = {p.uid: p.name for p in ppods}
        assert _stream_view(jmsgs, jname) == _stream_view(pmsgs, pname)
        assert any(kind == "chunk" for kind, _d in pmsgs) if i == 0 else not pmsgs
