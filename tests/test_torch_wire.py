"""The wire and the fetch preps (karpenter_tpu_torch/ops/kernels.py
pack_wire_plain / unpack_wire / fetch_tree, and the preps of
controllers/provisioning/scheduler.py) against the JAX package's.

- pack_wire_plain against the JITTED reference _pack_wire, byte for byte,
  on seeded numpy leaf sets covering the layout's edges: 0-d leaves, empty
  leaves, a bool group whose length is not a multiple of 8 (one byte
  straddling two leaves), dtype groups of one leaf, and int16, uint32 and
  float32 groups beside int32. unpack_wire round-trips each set, and
  fetch_tree returns what the reference's _fetch_tree_impl returns.
- The preps (_slim_outputs, _state_reads, _make_fetch_prep,
  _make_group_prep, _make_final_prep, _make_group_final_prep) against the
  reference's on the same state and outputs, leaf for leaf, fill_max
  included (a count past 2^15 in a padding row, which only the full-grid
  max sees), and their wires byte for byte; _partition_ranges likewise.
- Widening: 40000 identical pods land on one existing node, so a fill grid
  holds 40000; the int16 narrowing would wrap it, so both packages must
  refetch the grid at full width (the port's widen fetch is counted) to
  return their equal result.

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.controllers.provisioning import TPUScheduler
from karpenter_tpu.controllers.provisioning import host_scheduler as j_host
from karpenter_tpu.controllers.provisioning import scheduler as j_sched
from karpenter_tpu.models.pod import make_pod as j_make_pod
from karpenter_tpu.ops import kernels as j_kernels
from karpenter_tpu.scheduling import Requirement as JReq
from karpenter_tpu.scheduling import Requirements as JReqs
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.controllers.provisioning import scheduler as p_sched
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.ops import solver as p_solver
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401
from test_torch_kscan import CASES as KSCAN_CASES
from test_torch_scheduler import _view


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(rng, dtype, shape) -> np.ndarray:
    if dtype == np.bool_:
        return np.asarray(rng.random(shape) < 0.5)
    if dtype == np.float32:
        return np.asarray(rng.standard_normal(shape), dtype=np.float32)
    info = np.iinfo(dtype)
    return np.asarray(rng.integers(info.min, info.max, size=shape, dtype=np.int64), dtype=np.int64).astype(dtype)


# name -> [(dtype, shape)]: the layout's edges
LEAF_SETS = {
    "edges": [
        (np.bool_, ()), (np.int32, ()), (np.bool_, (13,)), (np.float32, (3, 2)), (np.int16, (5,)),
        (np.bool_, (0,)), (np.int32, (0,)), (np.uint32, (4,)), (np.bool_, (2, 3)), (np.int32, (7,)),
        (np.float32, ()),
    ],
    "straddling_bools": [(np.bool_, (1,)), (np.bool_, (7,)), (np.bool_, (9,)), (np.bool_, (3, 5)), (np.bool_, (16,))],
    "one_leaf_groups": [(np.int32, (9,)), (np.bool_, (11,)), (np.int16, (3,)), (np.float32, (1,))],
    "only_empty": [(np.bool_, (0,)), (np.int32, (0, 4))],
    "int16_beside_int32": [(np.int32, (4, 5)), (np.int16, (4, 5)), (np.int32, ()), (np.int16, (3,)), (np.bool_, (5,))],
}


def _numpy_set(name, seed=0):
    rng = np.random.default_rng(seed)
    return [_leaf(rng, dt, shape) for dt, shape in LEAF_SETS[name]]


@pytest.mark.parametrize("name", sorted(LEAF_SETS))
def test_pack_wire_plain_matches_reference(name):
    """pack_wire_plain equals the jitted reference _pack_wire byte for
    byte; unpack_wire round-trips; fetch_tree returns the reference
    _fetch_tree_impl's host arrays."""
    arrs = _numpy_set(name)
    want = np.asarray(jax.jit(j_kernels._pack_wire)([jnp.asarray(a) for a in arrs]))
    leaves = [torch.from_numpy(a.copy()) for a in arrs]
    got = p_kernels.pack_wire_plain(leaves)
    assert got.dtype == torch.uint8
    assert np.array_equal(want, got.numpy()), name
    metas = [(tuple(t.shape), t.dtype) for t in leaves]
    assert p_kernels.wire_layout(metas)[1] == want.size
    back = p_kernels.unpack_wire(got.numpy(), metas)
    ref = j_kernels._fetch_tree_impl([jnp.asarray(a) for a in arrs])
    for a, b, r in zip(arrs, back, ref):
        assert b.dtype == a.dtype and b.shape == a.shape and np.array_equal(a, b)
        assert np.array_equal(np.asarray(r), b)
    fetched = p_kernels.fetch_tree(dict(x=leaves))["x"]
    assert all(np.array_equal(a, b) for a, b in zip(arrs, fetched))


def test_wire_leaves_read_in_place():
    """A WireLeaf (a live-row slice, narrowed int32 -> int16) and a
    WireMax pack as the tensors they stand for."""
    rng = np.random.default_rng(3)
    grid = rng.integers(-70000, 70000, size=(6, 5)).astype(np.int32)
    flags = rng.random((6, 3)) < 0.5
    leaves = [p_kernels.WireLeaf(torch.from_numpy(grid), 4, narrow=True), p_kernels.WireLeaf(torch.from_numpy(flags), 2),
              p_kernels.WireMax([torch.from_numpy(grid), torch.from_numpy(grid[:1])])]
    want = np.asarray(jax.jit(j_kernels._pack_wire)(
        [jnp.asarray(grid[:4]).astype(jnp.int16), jnp.asarray(flags[:2]), jnp.max(jnp.asarray(grid))]
    ))
    assert np.array_equal(want, p_kernels.pack_wire_plain(leaves).numpy())
    got = p_kernels.fetch_tree(leaves)
    assert np.array_equal(got[0], grid[:4].astype(np.int16)) and got[0].dtype == np.int16
    assert np.array_equal(got[1], flags[:2]) and int(got[2]) == int(grid.max())


# ---------------------------------------------------------------------------
# the fetch preps
# ---------------------------------------------------------------------------


def _outputs(rng, E: int, W: int):
    """Synthetic dispatch outputs of every kind (numpy), with padding rows
    past each live B, and their specs: a per-pod chunk, a kind scan, a
    gang run, and two fill runs (one with an empty existing-node grid)."""
    i32 = np.int32
    flat, specs = [], []
    flat.append(rng.integers(-2, 40, size=(16,)).astype(i32))
    specs.append(("pods",))
    flat += [rng.integers(-2, 40, size=(4, 8)).astype(i32), rng.random(4) < 0.5]
    specs.append(("kscan", 3))
    flat += [rng.integers(0, 9, size=(8,)).astype(i32) for _ in range(5)]
    specs.append(("gang", 5))
    for e in (E, 0):
        fc = rng.integers(0, 300, size=(6, W)).astype(i32)
        fc[5, 1] = 40000  # a padding row: only the full grid's max sees it
        fe = rng.integers(0, 300, size=(6, e)).astype(i32)
        flat += [fc, fe] + [rng.integers(0, 9, size=(6,)).astype(i32) for _ in range(3)]
        flat.append(rng.integers(0, 64, size=(W,)).astype(i32))
        specs.append(("fill", 4))
    return flat, tuple(specs)


def _materialized(leaves):
    return [p_kernels.materialize(t).numpy() for t in leaves]


def _same_leaves(want, got, what):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        a = p_solver._np_leaf(np.asarray(a))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (what, i)


@pytest.fixture(scope="module")
def prep_problem():
    """A reference state after one kind-scan dispatch of the mixed pods
    (claims open, zone narrowing on the topology key) and the port's copy
    of it, with synthetic outputs for both."""
    prob = KSCAN_CASES["mixed"]()
    jst, pst = prob.initial()
    (key, segs), *_ = prob.kscan_runs()
    jst, _jys, pst, _pys = prob.kscan(jst, pst, key, segs)
    tk = tuple(prob.enc["topo_kids"])
    assert tk, "the mixed problem has a topology key"
    W = int(pst.template.shape[0])
    flat, specs = _outputs(np.random.default_rng(7), E=int(pst.exist_used.shape[0]) or 2, W=W)
    return jst, pst, tk, flat, specs


def test_preps_match_reference(prep_problem):
    """Every prep, leaf for leaf against the jitted reference prep on the
    same state and outputs (fill_max 40000 from a padding row), and the
    wire of each byte for byte."""
    jst, pst, tk, flat, specs = prep_problem
    jflat = [jnp.asarray(a) for a in flat]
    pflat = [torch.from_numpy(a) for a in flat]
    tmpl = np.arange(int(pst.bank_template.shape[0]), dtype=np.int32) % 3
    cases = {
        "fetch": (j_sched._make_fetch_prep(specs, tk), (jst, jflat), p_sched._make_fetch_prep(specs, tk), (pst, pflat)),
        "group": (j_sched._make_group_prep(specs), (jnp.asarray(tmpl), jflat), p_sched._make_group_prep(specs),
                  (torch.from_numpy(tmpl), pflat)),
        "final": (j_sched._make_final_prep(tk), (jst,), p_sched._make_final_prep(tk), (pst,)),
        "group_final": (j_sched._make_group_final_prep(specs, tk), (jnp.asarray(tmpl), jflat, jst),
                        p_sched._make_group_final_prep(specs, tk), (torch.from_numpy(tmpl), pflat, pst)),
        "fetch_no_tk": (j_sched._make_fetch_prep(specs, ()), (jst, jflat), p_sched._make_fetch_prep(specs, ()),
                        (pst, pflat)),
    }
    for name, (jprep, jargs, pprep, pargs) in cases.items():
        want = jax.jit(jprep)(*jargs)
        got = pprep(*pargs)
        _same_leaves(want, _materialized(got), name)
        wire = np.asarray(jax.jit(j_kernels._pack_wire)(list(want)))
        assert np.array_equal(wire, p_kernels.pack_wire_plain(got).numpy()), name
    maxes = [t for t in p_sched._make_group_prep(specs)(torch.from_numpy(tmpl), pflat) if isinstance(t, p_kernels.WireMax)]
    assert len(maxes) == 1 and int(maxes[0].tensor()) == 40000
    assert len(maxes[0].srcs) == 3, "the empty fill_e grid takes no part in the max"


def test_partition_ranges_matches_reference():
    rng = np.random.default_rng(11)
    for n in (1, 2, 5, 17):
        w = rng.integers(0, 50, size=n).tolist()
        for k in (1, 2, 3, 4, 8):
            assert p_sched._partition_ranges(w, k) == j_sched._partition_ranges(w, k), (w, k)


# ---------------------------------------------------------------------------
# widening on overflow
# ---------------------------------------------------------------------------


def _big_node(Node, Reqs, Req):
    return Node(
        name="big", index=0, requirements=Reqs(Req.new(T.l.LABEL_HOSTNAME, "In", "big")),
        available={"cpu": 1e6, "memory": 1e15, "pods": 1e6},
    )


def test_fill_past_int16_takes_the_widen_path(monkeypatch):
    """40000 identical pods, one existing node with room for all: the fill
    grid holds 40000, past int16. Both packages return the same result,
    every pod on the node; the narrowed grid would wrap to -25536, so each
    took its widen path (the port's full-width refetch is seen)."""
    n = 40000
    jpods = [j_make_pod(f"w-{i}", cpu=0.001, memory="1Mi") for i in range(n)]
    ppods = [T.make_pod(f"w-{i}", cpu=0.001, memory="1Mi") for i in range(n)]
    jnode = _big_node(j_host.ExistingSimNode, JReqs, JReq)
    pnode = _big_node(T.ExistingSimNode, T.Requirements, T.Requirement)
    jr = TPUScheduler(bench.make_templates(4), max_claims=64).solve(jpods, [jnode])
    sched = TorchScheduler(T.make_templates(4), max_claims=64, device="cpu")
    widened = []
    real = p_sched.fetch_tree

    def spy(tree):
        if isinstance(tree, dict) and tree and all(isinstance(v, tuple) for v in tree.values()):
            widened.append(tree)
        return real(tree)

    monkeypatch.setattr(p_sched, "fetch_tree", spy)
    pr = sched.solve(ppods, [pnode])
    assert widened, "the port did not refetch the grid at full width"
    assert len(pr.existing_assignments) == n and not pr.claims
    assert _view(jr) == _view(pr)
