"""The requirement-intersection kernel (H1), csrc/req_intersects.cu, run on
the CPU.

The CUDA kernel cannot run here, so this file compiles it with the host's
C++ compiler against tests/cuda_emu.h (one fiber per CUDA thread, the
blocks of a grid one after another, barriers for __syncthreads, the
block's dynamic shared memory as a buffer) and routes ops/cuda.py's
launch to that library, so the launcher and its packed catalog
(ops/cuda.py ReqCatalog, cached by packed_catalog beside H2's) run on CPU
tensors. Each case holds the kernel exactly to the plain version,
ops/kernels.py intersects_plain: K of 1, 8 and 70 keys (one, one and
three 32-bit key words), V of 8 and 64, NotIn (lenient infinite) and
DoesNotExist (lenient empty) keys on both sides, bounds compared as
signed int32 (INT_MIN / INT_MAX among them), and row and type counts that
are not multiples of a block's tile, from one row (a lane one type, a
block's warps across the types) to 2053 (a lane four types, eight rows a
warp). The catalog is packed once for a catalog used twice, anew for one
changed in place, and a catalog seen once still gives the right answer. A small CPU solve runs each of its H1
calls through both. The emulation checks the kernel's logic, not its
timing or what the GPU compiler does with it: chip_smoke.py holds the
compiled kernel to the plain version on the card. Every emulated launch
runs under a time limit (cuda_emu_build.limited_call). Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.ops.encode import INT_MAX, INT_MIN, ReqSetTensors
from cuda_emu_build import c_entry, emulated_library, limited_call


def _rewrite(src: str) -> str:
    """The block's dynamic shared memory for the emulator's buffer."""
    old = "extern __shared__ __align__(16) uint32_t smem[];"
    assert old in src
    return src.replace(old, "uint32_t* smem = reinterpret_cast<uint32_t*>(emu_smem());")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """ops/cuda.py's C-entry call routed to the emulated kernel."""
    fn = c_entry(emulated_library(tmp_path_factory, "req_intersects", rewrite=_rewrite), "req_intersects")

    def invoke(source, entry, *args):
        assert (source, entry) == ("req_intersects", "req_intersects")
        rc = limited_call(fn, *args, None)
        if rc:
            raise p_cuda.KernelError(f"emulated req_intersects: error {rc}")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield invoke
    torch.set_num_threads(n)


def _sets(rng, n: int, K: int, V: int, p_def: float = 0.6) -> ReqSetTensors:
    """n seeded requirement sets: In sets (a few values), NotIn (infinite
    with exclusions: lenient), Exists / Gt / Lt (infinite with bounds),
    DoesNotExist (defined with no value: lenient) and undefined keys."""
    kind = rng.integers(0, 5, (n, K))
    mask = rng.random((n, K, V)) < 0.3
    inf = kind >= 2
    excl = kind == 2
    mask[kind == 2] = ~mask[kind == 2]  # NotIn: every value but the excluded
    mask[kind == 4] = False  # DoesNotExist
    inf[kind == 4] = False
    gte = rng.integers(-6, 6, (n, K)).astype(np.int32)
    lte = (gte + rng.integers(-3, 8, (n, K))).astype(np.int32)
    wide = rng.random((n, K)) < 0.3
    gte[wide], lte[wide] = INT_MIN, INT_MAX
    defined = rng.random((n, K)) < p_def
    return ReqSetTensors(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (mask, inf, excl, gte, lte, defined)))


# name: (A rows, B types, K, V)
CASES = {
    "k1_v8": (9, 37, 1, 8),
    "k8_v8_one_row": (1, 1000, 8, 8),
    "k8_v64_few_rows": (5, 300, 8, 64),
    "k8_v8_many_rows": (1024, 45, 8, 8),
    "k70_v8": (37, 133, 70, 8),
    "k70_v64": (13, 70, 70, 64),
    "k33_v16_odd_rows": (67, 129, 33, 16),
    "k8_v16_odd_rows": (131, 200, 8, 16),
    "k8_v8_eight_rows_a_warp": (2053, 45, 8, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_intersects_equals_plain(case, emulated, monkeypatch):
    """[A, B] intersects through the emulated kernel against the plain
    version, and the relation's symmetry through the same kernel."""
    A, B, K, V = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    # about two shared keys a pair, whatever K, so that pairs pass and fail
    a, b = _sets(rng, A, K, V, p_def=min(0.6, 3.0 / K)), _sets(rng, B, K, V, p_def=0.7)
    want = p_kernels.intersects_plain(a, b)
    assert 0 < int(want.sum()) < A * B, "a case that tests nothing"
    before = p_cuda.LAUNCHES["req_intersects"]
    got = p_cuda.req_intersects(a, b)
    assert p_cuda.LAUNCHES["req_intersects"] == before + 1
    assert torch.equal(got, want)
    if A * B <= 5000:
        assert torch.equal(p_cuda.req_intersects(b, a), want.T)


def test_catalog_packed_once_and_anew_when_changed(emulated, monkeypatch):
    """One catalog packed once for two calls; changed in place, packed
    anew (its version counter moved); a catalog seen once is right too."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    rng = np.random.default_rng(11)
    a, b = _sets(rng, 20, 8, 8), _sets(rng, 140, 8, 8)
    first = p_cuda.req_catalog(b)
    assert torch.equal(p_cuda.req_intersects(a, b), p_kernels.intersects_plain(a, b))
    assert p_cuda.req_catalog(b) is first
    b.defined[3] = ~b.defined[3]
    b.gte[5] = INT_MIN
    assert p_cuda.req_catalog(b) is not first
    assert torch.equal(p_cuda.req_intersects(a, b), p_kernels.intersects_plain(a, b))
    once = _sets(rng, 50, 8, 8)
    assert torch.equal(p_cuda.req_intersects(a, once), p_kernels.intersects_plain(a, once))


def test_launcher_refusals(emulated, monkeypatch):
    """The refusals raised before any launch: key/value axes that differ,
    V not a multiple of 8, a misaligned mask, a claim tensor of another
    dtype or not contiguous."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    rng = np.random.default_rng(5)
    b = _sets(rng, 30, 8, 8)
    with pytest.raises(p_cuda.LaunchRefused, match="key/value axes differ"):
        p_cuda.req_intersects(_sets(rng, 4, 8, 16), b)
    with pytest.raises(p_cuda.LaunchRefused, match="must be a multiple of 8"):
        p_cuda.req_intersects(_sets(rng, 4, 8, 12), _sets(rng, 3, 8, 12))
    a = _sets(rng, 4, 8, 8)
    raw = torch.zeros(4 * 64 + 1, dtype=torch.bool)
    shifted = raw[1:].view(4, 8, 8)
    shifted.copy_(a.mask)
    with pytest.raises(p_cuda.LaunchRefused, match="not 8-byte aligned"):
        p_cuda.req_intersects(a._replace(mask=shifted), b)
    with pytest.raises(p_cuda.LaunchRefused, match="a.gte: dtype"):
        p_cuda.req_intersects(a._replace(gte=a.gte.to(torch.int64)), b)
    with pytest.raises(p_cuda.LaunchRefused, match="a.inf: not contiguous"):
        p_cuda.req_intersects(a._replace(inf=a.inf.t().contiguous().t()), b)


def test_small_solve_runs_every_call_through_the_kernel(emulated, monkeypatch):
    """Every H1 call of a small CPU solve (the fill step's and the kind
    step's tier 2 and tier 3) runs through the emulated kernel and the
    plain version alike."""
    monkeypatch.setattr(p_cuda, "_invoke", emulated)
    plain = p_kernels.intersects_plain
    shapes = []

    def both(a, b):
        want = plain(a, b)
        got = p_cuda.req_intersects(ReqSetTensors(*(t.contiguous() for t in a)), b)
        assert torch.equal(got, want)
        shapes.append(tuple(got.shape))
        return want

    monkeypatch.setattr(p_kernels, "intersects_plain", both)
    sched = TorchScheduler(T.make_templates(12), max_claims=48, device="cpu")
    res = sched.solve(T.mixed_pods(20))
    assert res.claims
    assert len({s[0] for s in shapes}) >= 2, shapes
