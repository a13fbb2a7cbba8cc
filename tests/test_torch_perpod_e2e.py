"""End to end on the per-pod scan: TorchScheduler(device="cpu") against
the JAX package's TPUScheduler on workloads the reference routes to its
per-pod scan — perpod_pods (zone and capacity-type spread), chunked with
compactions between the chunks, mixed with fill and kind-scan kinds, with
an existing node, an initially-empty hostname affinity group, a zone key
wider than KSCAN_D, and kinds sharing claims through a custom key (the
reference's full it-compat branch). Assignments, existing-node
assignments, every claim's requirements (narrowed zone and capacity
type), viable types, usage and price are compared. Tolerance: exact
equality."""

import pytest
import torch

from karpenter_tpu.models.pod import NodeAffinity as JNodeAffinity
from karpenter_tpu.models.pod import NodeSelectorTerm as JNodeSelectorTerm
from karpenter_tpu_torch import testing as p_testing
from karpenter_tpu_torch.models import labels as pl
from karpenter_tpu_torch.models.pod import NodeAffinity as PNodeAffinity
from karpenter_tpu_torch.models.pod import NodeSelectorTerm as PNodeSelectorTerm
from test_torch_perpod import JAX_MODELS, tier_pods, tier_templates
from test_torch_scheduler import JAX_SIDE, _compare, _edge_pods, _node_a
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunked(s):
    s.solve_chunk = 24
    s.compact_min_pods = 32


def _perpod_with_node(S):
    pods = S.perpod_pods(24, kinds=2)
    for p in pods:
        p.spec.requests["cpu"] = 0.5
    return S.templates(20), pods, [_node_a(S)]


def _wide_zone_key(S, n_extra=13):
    """Zone-spread kinds (one key, the kind scan's shape) beside pods that
    exclude n_extra more zone names: the zone key holds 4 + n_extra values
    (17; 45 in the wider case, past one 32-bit word of value bits), wider
    than KSCAN_D, so the spread kinds route to the per-pod scan."""
    extra = [f"extra-zone-{i}" for i in range(n_extra)]
    aff, term = (JNodeAffinity, JNodeSelectorTerm) if S is JAX_SIDE else (PNodeAffinity, PNodeSelectorTerm)
    away = [S.make_pod(f"away-{i}", cpu=0.5, memory="512Mi") for i in range(2)]
    for p in away:
        p.spec.node_affinity = aff(required=[term(match_expressions=[
            {"key": S.l.LABEL_TOPOLOGY_ZONE, "operator": "NotIn", "values": extra}])])
    return S.templates(24), S.zonal_pods(24, kinds=2) + away, None


def _tier(S):
    if S is JAX_SIDE:
        return tier_templates(24), tier_pods(JAX_MODELS), None
    return p_testing.tier_templates(24), p_testing.tier_pods(), None


CASES = {
    # name: (build(S) -> (templates, pods, existing), max_claims, tweak)
    "perpod_64x24": (lambda S: (S.templates(24), S.perpod_pods(64, kinds=4), None), 64, None),
    "perpod_64x24_chunked": (lambda S: (S.templates(24), S.perpod_pods(64, kinds=4), None), 64, _chunked),
    "mixed_and_perpod": (lambda S: (S.templates(24), S.mixed_pods(80) + S.perpod_pods(48), None), 128, None),
    "perpod_existing_node": (_perpod_with_node, 32, None),
    "empty_hostname_affinity": (
        lambda S: (S.templates(20), _edge_pods(S, "empty_hostname_affinity") + S.perpod_pods(16, kinds=2), None), 32, None,
    ),
    "wide_zone_key": (_wide_zone_key, 64, None),
    "wider_zone_key": (lambda S: _wide_zone_key(S, 41), 64, None),
    "custom_key_fallback": (_tier, 32, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perpod_workloads_match_reference(case):
    build, max_claims, tweak = CASES[case]
    rp, ps = _compare(case, build, max_claims, tweak)
    st = ps.last_stats
    assert st["perpod_dispatches"] > 0 and rp.node_count > 0
    if case == "perpod_64x24_chunked":
        assert st["perpod_dispatches"] == 3 and st["compactions"] == 2
    if case == "mixed_and_perpod":
        assert st["fill_dispatches"] > 0 and st["kscan_dispatches"] > 0
    if case == "perpod_existing_node":
        assert rp.existing_assignments
    if case in ("wide_zone_key", "wider_zone_key"):
        assert st["kscan_dispatches"] == 0
    if case.startswith("perpod_64"):
        # every claim carries a narrowed zone and a narrowed capacity type
        for c in rp.claims:
            for key in (pl.LABEL_TOPOLOGY_ZONE, pl.CAPACITY_TYPE_LABEL_KEY):
                r = c.requirements.get(key)
                assert not r.complement and len(r.values) == 1, (c.slot, key)
