"""The port's encoding (karpenter_tpu_torch.ops.encode) against the JAX
package's on the same problems, and its set algebra against the
pure-Python oracle — the golden cases of tests/test_encode.py, run through
both packages. Exact equality throughout."""

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider import fake as j_fake
from karpenter_tpu.models import labels as jl
from karpenter_tpu.models import pod as j_pod
from karpenter_tpu.ops import encode as j_encode
from karpenter_tpu.ops import kernels as j_kernels
from karpenter_tpu.scheduling import Operator as JOp
from karpenter_tpu.scheduling import Requirement as JReq
from karpenter_tpu.scheduling import Requirements as JReqs
from karpenter_tpu_torch.cloudprovider import fake as p_fake
from karpenter_tpu_torch.models import labels as pl
from karpenter_tpu_torch.models import pod as p_pod
from karpenter_tpu_torch.ops import encode as p_encode
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.scheduling import Operator as POp
from karpenter_tpu_torch.scheduling import Requirement as PReq
from karpenter_tpu_torch.scheduling import Requirements as PReqs

KEYS = ["zone", "arch", "team", jl.LABEL_TOPOLOGY_ZONE, "tier"]
VALUES = ["a", "b", "c", "1", "5", "17", "x"]
OPS = ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt", "Gte", "Lte"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_req_pair(rng, key):
    """The same random requirement in both packages."""
    op = OPS[int(rng.integers(0, len(OPS)))]
    if op in ("Gt", "Lt", "Gte", "Lte"):
        vals = (str(rng.integers(0, 20)),)
    elif op in ("Exists", "DoesNotExist"):
        vals = ()
    else:
        n = int(rng.integers(1, 4))
        vals = tuple(str(v) for v in rng.choice(VALUES, size=n, replace=False))
    return JReq.new(key, JOp(op), *vals), PReq.new(key, POp(op), *vals)


def _random_sets(seed, n):
    rng = np.random.default_rng(seed)
    js, ps = [], []
    for _ in range(n):
        n_keys = int(rng.integers(0, len(KEYS) + 1))
        keys = list(rng.choice(KEYS, size=n_keys, replace=False))
        a, b = JReqs(), PReqs()
        for k in keys:
            ja, pa = _random_req_pair(rng, k)
            a.add(ja)
            b.add(pa)
            if rng.random() < 0.3:  # occasionally intersect two reqs on one key
                ja, pa = _random_req_pair(rng, k)
                a.add(ja)
                b.add(pa)
        js.append(a)
        ps.append(b)
    return js, ps


def _vocabs(js, ps):
    jv, pv = j_encode.Vocab(), p_encode.Vocab()
    for a, b in zip(js, ps):
        jv.observe(a)
        pv.observe(b)
    for k in KEYS:
        jv.add_key(k)
        pv.add_key(k)
        for v in VALUES:
            jv.add_value(k, v)
            pv.add_value(k, v)
    return jv, pv


@pytest.fixture(scope="module")
def req_batch():
    js, ps = _random_sets(42, 40)
    jv, pv = _vocabs(js, ps)
    jenc = j_encode.encode_requirements(jv, js)
    penc = p_encode.encode_requirements(pv, ps, device="cpu")
    return js, ps, jv, pv, jenc, penc


def _eq(jarr, tarr):
    a = np.asarray(jarr)
    b = tarr.cpu().numpy() if isinstance(tarr, torch.Tensor) else np.asarray(tarr)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype or (a.dtype == np.uint32 and b.dtype == np.int32), (a.dtype, b.dtype)
    assert np.array_equal(a.view(b.dtype) if a.dtype != b.dtype else a, b)


class TestGoldenKernels:
    def test_encoding_matches_reference(self, req_batch):
        _js, _ps, jv, pv, jenc, penc = req_batch
        assert jv.keys == pv.keys and jv.values == pv.values
        for f in j_encode.ReqSetTensors._fields:
            _eq(getattr(jenc, f), getattr(penc, f))

    def test_mask_matches_has(self, req_batch):
        _js, ps, _jv, pv, _jenc, penc = req_batch
        mask = penc.mask.numpy()
        for b, s in enumerate(ps):
            for r in s:
                k = pv.key_to_id[r.key]
                for vid, val in enumerate(pv.values[k]):
                    assert mask[b, k, vid] == r.has(val), (r, val)

    def test_intersects_golden(self, req_batch):
        js, ps, _jv, _pv, jenc, penc = req_batch
        got = p_kernels.intersects(penc, penc).numpy()
        _eq(j_kernels.intersects(jenc, jenc), got)
        for i, a in enumerate(ps):
            for j, b in enumerate(ps):
                assert got[i, j] == (a.intersects(b) is None), f"{i} vs {j}: {a} || {b}"

    def test_compatible_golden(self, req_batch):
        _js, ps, jv, pv, jenc, penc = req_batch
        wk = torch.from_numpy(pv.well_known_mask())
        n = len(ps)
        rows = torch.arange(n).repeat_interleave(n)
        cols = torch.arange(n).repeat(n)
        got = p_kernels.compatible_elemwise(
            p_kernels.take_set(penc, rows), p_kernels.take_set(penc, cols), wk
        ).reshape(n, n).numpy()
        _eq(j_kernels.compatible(jenc, jenc, jv.well_known_mask()), got)
        for i, a in enumerate(ps):
            for j, b in enumerate(ps):
                want = a.is_compatible(b, allow_undefined=pl.WELL_KNOWN_LABELS)
                assert got[i, j] == want, f"{i} vs {j}: {a} || {b}"

    def test_lenient_golden(self, req_batch):
        _js, ps, _jv, pv, jenc, penc = req_batch
        got = p_kernels.lenient(penc).numpy()
        _eq(j_kernels.lenient(jenc), got)
        for b, s in enumerate(ps):
            for r in s:
                assert got[b, pv.key_to_id[r.key]] == r.is_lenient(), r

    def test_intersect_sets_golden(self, req_batch):
        _js, ps, _jv, pv, jenc, penc = req_batch
        n = len(ps)
        perm = list(range(1, n)) + [0]
        jcomb = j_kernels.intersect_sets(jenc, j_kernels.take_set(jenc, np.array(perm)))
        pcomb = p_kernels.intersect_sets(penc, p_kernels.take_set(penc, torch.tensor(perm)))
        for f in j_encode.ReqSetTensors._fields:
            _eq(getattr(jcomb, f), getattr(pcomb, f))
        for i in range(n):
            host = ps[i].copy()
            host.add(*ps[perm[i]].values())
            host_enc = p_encode.encode_requirements(pv, [host], device="cpu")
            got = p_kernels.take_set(pcomb, i)
            assert torch.equal(got.mask, host_enc.mask[0])
            assert torch.equal(got.defined, host_enc.defined[0])
            assert torch.equal(got.inf, host_enc.inf[0])
            assert torch.equal(
                p_kernels.lenient(p_kernels.take_set(pcomb, torch.tensor([i])))[0],
                p_kernels.lenient(host_enc)[0],
            )

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_intersects_random_batches(self, seed):
        js_a, ps_a = _random_sets(seed, 24)
        js_b, ps_b = _random_sets(seed + 100, 17)
        jv, pv = _vocabs(js_a + js_b, ps_a + ps_b)
        ja = j_encode.encode_requirements(jv, js_a, 8, 8)
        jb = j_encode.encode_requirements(jv, js_b, 8, 8)
        pa = p_encode.encode_requirements(pv, ps_a, 8, 8, device="cpu")
        pb = p_encode.encode_requirements(pv, ps_b, 8, 8, device="cpu")
        _eq(j_kernels.intersects(ja, jb), p_kernels.intersects(pa, pb))
        # symmetric: the solver calls intersects(claims, catalog)
        assert torch.equal(p_kernels.intersects(pa, pb), p_kernels.intersects(pb, pa).T)


class TestEncoder:
    def test_pod_encoding(self):
        def build(pod_mod, l):
            return [
                pod_mod.make_pod("a", cpu=1, memory="1Gi", node_selector={l.LABEL_TOPOLOGY_ZONE: "z1"}),
                pod_mod.make_pod("b", cpu=2, memory="2Gi"),
            ]

        jenc = j_encode.ProblemEncoder()
        penc = p_encode.ProblemEncoder(device="cpu")
        jpods, ppods = build(j_pod, jl), build(p_pod, pl)
        for a, b in zip(jpods, ppods):
            jenc.observe_pod(a)
            penc.observe_pod(b)
        jt, pt = jenc.encode_pods(jpods), penc.encode_pods(ppods)
        _eq(jt.requests, pt.requests)
        for f in j_encode.ReqSetTensors._fields:
            _eq(getattr(jt.reqs, f), getattr(pt.reqs, f))
            _eq(getattr(jt.strict_reqs, f), getattr(pt.strict_reqs, f))
        cpu_id = penc.resource_names.index("cpu")
        assert pt.requests[0, cpu_id] == 1.0 and pt.requests[1, cpu_id] == 2.0
        zk = penc.vocab.key_to_id[pl.LABEL_TOPOLOGY_ZONE]
        assert bool(pt.reqs.defined[0, zk]) and not bool(pt.reqs.defined[1, zk])

    @pytest.mark.parametrize("n", [4, 8, 70])
    def test_instance_type_encoding(self, n):
        jits, pits = j_fake.instance_types(n), p_fake.instance_types(n)
        jenc = j_encode.ProblemEncoder()
        penc = p_encode.ProblemEncoder(device="cpu")
        for a, b in zip(jits, pits):
            jenc.observe_instance_type(a)
            penc.observe_instance_type(b)
        jt, pt = jenc.encode_instance_types(jits), penc.encode_instance_types(pits)
        for f in ("alloc", "cap", "group_valid", "zc_avail", "price_zc", "valid", "res_ofs"):
            _eq(getattr(jt, f), getattr(pt, f))
        for f in j_encode.ReqSetTensors._fields:
            _eq(getattr(jt.reqs, f), getattr(pt.reqs, f))
        zc = pt.zc_avail.numpy()
        assert zc.shape[1] == 1 and int(zc[0, 0].sum()) == 8

    def test_offering_value_allowed(self):
        pits = p_fake.instance_types(4)
        pod = p_pod.make_pod("p", node_selector={pl.LABEL_TOPOLOGY_ZONE: "test-zone-2"})
        enc = p_encode.ProblemEncoder(device="cpu")
        for it in pits:
            enc.observe_instance_type(it)
        enc.observe_pod(pod)
        pt = enc.encode_pods([pod])
        zone_kid, _ = enc.zone_ct_key_ids()
        z2 = enc.vocab.value_to_id[zone_kid]["test-zone-2"]
        z1 = enc.vocab.value_to_id[zone_kid]["test-zone-1"]
        allowed = pt.reqs.mask[:, zone_kid, :][:, [z1, z2]]
        assert not bool(allowed[0, 0]) and bool(allowed[0, 1])
