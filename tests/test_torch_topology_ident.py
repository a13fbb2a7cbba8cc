"""Topology._ensure / _ensure_inverse look a group's identity up before
they build a group (building one copies the key's whole domain set, once
per bound anti-affinity pod). The groups must not change: their digest
(identity, domain counts, owners, inverse groups included) over a what-if
fixture's scenario topologies is pinned to the value the group-first code
gave."""

import hashlib

import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning.topology import TopologyGroup, TopologyType

# the digest of the code that built each group before the lookup
GROUPS_DIGEST = "dcb80c25f4c0d856c8306d220f2a2becfe824f7bc581b8f373a98450812b86c5"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def groups_digest(topo, name_of: dict) -> str:
    """Every group's identity, domain counts and owners (by pod name: uids
    depend on how many pods the process made before)."""
    h = hashlib.sha256()
    for tag, gs in (("g", topo.groups), ("i", topo.inverse_groups)):
        for g in gs:
            owners = sorted(name_of[u] for u in g.owners)
            h.update(repr((tag, g.ident(), sorted(g.domains.items()), owners)).encode())
    return h.hexdigest()


def test_whatif_topology_groups_unchanged():
    cluster = T.bound_cluster(T.mixed_pods(512), T.make_templates(24), max_claims=256, device="cpu")
    pods, specs = T.prefix_scenarios(T.candidates(cluster), 6, T.pending_pods(16))
    factory = T.topology_factory(cluster)
    name_of = {p.uid: p.name for p in pods + [p for ps in cluster.bound.values() for p in ps]}
    h = hashlib.sha256()
    n_inverse = 0
    for excluded, _active, _counted in specs:
        topo = factory(pods, excluded)
        n_inverse += len(topo.inverse_groups)
        h.update(groups_digest(topo, name_of).encode())
    assert n_inverse > 0
    assert h.hexdigest() == GROUPS_DIGEST


def test_make_ident_is_a_groups_identity():
    g = TopologyGroup(TopologyType.SPREAD, "zone", {"b": "2", "a": "1"}, 2, 3, frozenset({"ns"}), {"z1", "z2"})
    assert TopologyGroup.make_ident(TopologyType.SPREAD, "zone", {"a": "1", "b": "2"}, 2, 3,
                                    frozenset({"ns"})) == g.ident()
