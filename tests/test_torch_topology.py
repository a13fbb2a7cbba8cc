"""The port's topology encode against the JAX package's on the same pods:
the host groups (Topology.build), the vocab they extend, the topology
tensors (encode_topology) and the per-kind relations (encode_pod_topology),
as each scheduler's encode builds them. Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.controllers.provisioning.topology import Topology as JTopology
from karpenter_tpu.controllers.provisioning.topology import build_universe_domains as j_universe
from karpenter_tpu_torch import testing as p_testing
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.controllers.provisioning.topology import Topology as PTopology
from karpenter_tpu_torch.controllers.provisioning.topology import build_universe_domains as p_universe
from karpenter_tpu_torch.ops import topology as p_topo
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORKLOADS = {
    "mixed_60": ("mixed_pods", (60,)),
    "zonal_64": ("zonal_pods", (64,)),
    "hostname_64": ("hostname_pods", (64,)),
    "perpod_16": ("perpod_pods", (16,)),
}


def _groups_view(topo):
    def one(g):
        return (g.type.value, g.key, tuple(sorted(g.selector.items())), g.max_skew, g.min_domains,
                tuple(sorted(g.namespaces)), tuple(sorted(g.domains.items())), len(g.owners))

    return [one(g) for g in topo.groups], [one(g) for g in topo.inverse_groups]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_topology_build_matches_reference(name):
    gen, args = WORKLOADS[name]
    jt, pt = bench.make_templates(24), p_testing.make_templates(24)
    jg = JTopology.build(getattr(bench, gen)(*args), lambda: j_universe(jt))
    pg = PTopology.build(getattr(p_testing, gen)(*args), lambda: p_universe(pt))
    assert _groups_view(jg) == _groups_view(pg)
    assert jg.groups or jg.inverse_groups


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name", ["mixed_60", "zonal_64", "hostname_64"])
def test_encode_topology_matches_reference(name):
    """Vocab, topology tensors, per-kind relations and strict masks as the
    two schedulers encode the same pods."""
    gen, args = WORKLOADS[name]
    js = TPUScheduler(bench.make_templates(24), max_claims=64)
    ps = TorchScheduler(p_testing.make_templates(24), max_claims=64, device="cpu")
    _j_sorted, jenc = js._encode(getattr(bench, gen)(*args), None)
    _p_sorted, penc = ps._encode(getattr(p_testing, gen)(*args), None)
    assert js.encoder.vocab.keys == ps.encoder.vocab.keys
    assert js.encoder.vocab.values == ps.encoder.vocab.values
    assert js._pads() == ps._pads()
    jt, ptt = jax.tree.map(np.asarray, jenc["topo_tensors"]), penc["topo_tensors"]
    for f in p_topo.TopologyTensors._fields:
        assert np.array_equal(getattr(jt, f), _np(getattr(ptt, f))), f
    jp, pp = jax.tree.map(np.asarray, jenc["pod_topo_k"]), penc["kinds"]["topo"]
    for f in p_topo.PodTopology._fields:
        assert np.array_equal(getattr(jp, f), _np(getattr(pp, f))), f
    assert jenc["topo_kids"] == penc["topo_kids"]
    assert np.array_equal(jenc["batchable"], penc["batchable"])
    assert np.array_equal(jenc["kscan_key"], penc["kscan_key"])
    assert [tuple(s) for s in jenc["segments"]] == [tuple(s) for s in penc["segments"]]


def test_hg_evaluate_and_commit():
    """The hostname rules on a hand-built count matrix: spread caps at the
    skew, affinity needs a count (or a self-selecting seed of an empty
    group), anti-affinity needs zero; commits add at the winner's slot."""
    topo = p_topo.empty_topology_tensors(8, 6, "cpu")._replace(
        hg_type=torch.tensor([p_topo.TYPE_SPREAD, p_topo.TYPE_AFFINITY, p_topo.TYPE_ANTI], dtype=torch.int32),
        hg_skew=torch.tensor([1, 1, 1], dtype=torch.int32),
        hg_counts0=torch.zeros((3, 6), dtype=torch.int32),
        hg_extra_nonempty=torch.zeros(3, dtype=torch.bool),
        hg_valid=torch.ones(3, dtype=torch.bool),
    )
    counts = torch.tensor([[1, 0, 0, 0, 0, 0], [0, 2, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0]], dtype=torch.int32)
    slots = torch.arange(6, dtype=torch.int32)
    on = torch.ones(3, dtype=torch.bool)
    off = torch.zeros(3, dtype=torch.bool)
    for g, want in ((0, [False, True, True, True, True, True]), (1, [False, True, False, False, False, False]),
                    (2, [True, True, False, True, True, True])):
        applies = off.clone()
        applies[g] = True
        got = p_topo.hg_evaluate(topo, counts, slots, applies, on)
        assert got.tolist() == want, g
    # an empty affinity group admits a self-selecting pod anywhere
    empty = torch.zeros_like(counts)
    applies = torch.tensor([False, True, False])
    assert p_topo.hg_evaluate(topo, empty, slots, applies, on).all()
    assert not p_topo.hg_evaluate(topo, empty, slots, applies, off).any()
    after = p_topo.hg_commit(counts, torch.tensor(4, dtype=torch.int32), torch.tensor([True, False, True]), on)
    assert after[:, 4].tolist() == [1, 0, 1] and after.sum() == counts.sum() + 2
