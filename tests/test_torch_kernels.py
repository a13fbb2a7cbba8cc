"""The plain versions of the port's kernels (H1 req_intersects, H2
fill_count_grid, H3 water_fill, H4 compact_scatter) against the JAX
package's functions on the same seeded inputs, plus the packed-bitset ops
and the one-copy fetch. Exact equality throughout. The CUDA kernels
themselves are held to these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider import fake as j_fake
from karpenter_tpu.ops import encode as j_encode
from karpenter_tpu.ops import kernels as j_kernels
from karpenter_tpu.ops import solver as j_solver
from karpenter_tpu_torch.cloudprovider import fake as p_fake
from karpenter_tpu_torch.ops import cuda as p_cuda
from karpenter_tpu_torch.ops import encode as p_encode
from karpenter_tpu_torch.ops import kernels as p_kernels
from karpenter_tpu_torch.ops import solver as p_solver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def catalog():
    """The same 24-type catalog encoded by both packages (K=V=8 pads)."""
    jits, pits = j_fake.instance_types(24), p_fake.instance_types(24)
    jenc, penc = j_encode.ProblemEncoder(), p_encode.ProblemEncoder(device="cpu")
    for a, b in zip(jits, pits):
        jenc.observe_instance_type(a)
        penc.observe_instance_type(b)
    jit = jenc.encode_instance_types(jits)
    jit = jit._replace(reqs=j_encode.encode_requirements(jenc.vocab, [i.requirements for i in jits], 8, 8, jenc.skip_keys))
    pit = penc.encode_instance_types(pits, 8, 8)
    zone_kid, ct_kid = penc.zone_ct_key_ids()
    return jit, pit, zone_kid, ct_kid


def _rows(rng, jit, B, p_undef=0.6):
    """Claim-side requirement rows: catalog rows with random keys undefined."""
    T = jit.alloc.shape[0]
    pick = rng.integers(0, T, B)
    undef = rng.random((B, 8)) < p_undef
    ident = j_solver.identity_reqs(B, 8, 8)
    cat = j_kernels.take_set(jit.reqs, jnp.asarray(pick))
    sel = j_kernels.select_set(jnp.asarray(undef), ident, cat)
    return sel, p_encode.ReqSetTensors.from_numpy(sel, "cpu")


def _np(x):
    return np.asarray(x)


def _off_reference(comb_mask, it, zone_kid, ct_kid):
    """The JAX package's offering mask (_off_for, solver.py:1478)."""
    Z, C = it.zc_avail.shape[2], it.zc_avail.shape[3]
    return (
        jnp.einsum(
            "tgzc,nz,nc->ntg",
            it.zc_avail.astype(jnp.bfloat16),
            comb_mask[:, zone_kid, :Z].astype(jnp.bfloat16),
            comb_mask[:, ct_kid, :C].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        > 0
    )


class TestReqIntersects:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_plain_matches_reference(self, catalog, seed):
        jit, pit, _z, _c = catalog
        rng = np.random.default_rng(seed)
        jrows, prows = _rows(rng, jit, 40)
        want = _np(j_kernels.intersects(jit.reqs, jrows)).T
        assert np.array_equal(p_kernels.intersects_plain(prows, pit.reqs).numpy(), want)
        # the CPU wrapper runs the plain version and launches nothing
        before = dict(p_cuda.LAUNCHES)
        assert np.array_equal(p_kernels.intersects(prows, pit.reqs).numpy(), want)
        assert p_cuda.LAUNCHES == before


class TestFillCountGrid:
    def _inputs(self, catalog, seed, B=32):
        jit, pit, zone_kid, ct_kid = catalog
        rng = np.random.default_rng(seed)
        T, GR, R = jit.alloc.shape
        jrows, prows = _rows(rng, jit, B)
        top = np.asarray(jit.alloc)[:, 0, :].max(axis=0)
        used = (rng.random((B, R)) * top * 0.6).astype(np.float32)
        used[rng.random(B) < 0.2] = 0.0
        # non-exact quantities cross the one-rounding charge convention
        req = np.array([0.1, 0.3 * 2**30, 1.0, 0.0], dtype=np.float32)[:R]
        viable = rng.random((B, T)) < 0.5
        return jit, pit, zone_kid, ct_kid, jrows, prows, used, req, viable

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_offering_mask_matches_reference(self, catalog, seed):
        jit, pit, zone_kid, ct_kid, jrows, prows, *_ = self._inputs(catalog, seed)
        want = _np(_off_reference(jrows.mask, jit, zone_kid, ct_kid))
        got = p_solver.off_for_plain(prows.mask, pit, zone_kid, ct_kid).numpy()
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_max_count_matches_reference(self, catalog, seed):
        jit, pit, zone_kid, ct_kid, jrows, prows, used, req, viable = self._inputs(catalog, seed)
        off = _off_reference(jrows.mask, jit, zone_kid, ct_kid)
        # jitted, as inside the reference's solve (XLA fuses the charges)
        want = _np(jax.jit(j_solver._claim_fill_caps)(jnp.asarray(used), jnp.asarray(viable), jnp.asarray(req), jit, off))
        got = p_solver.claim_fill_caps(
            torch.from_numpy(used), torch.from_numpy(viable), torch.from_numpy(req),
            pit, prows.mask, zone_kid, ct_kid,
        )
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert want.max() > 0  # the case exercises real fills

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fits_at_count_matches_reference(self, catalog, seed):
        jit, pit, zone_kid, ct_kid, jrows, prows, used, req, _viable = self._inputs(catalog, seed)
        rng = np.random.default_rng(seed + 7)
        B, T, GR = used.shape[0], jit.alloc.shape[0], jit.alloc.shape[1]
        counts = rng.integers(0, 40, B).astype(np.int32)
        off = _off_reference(jrows.mask, jit, zone_kid, ct_kid)
        cgrid = jnp.broadcast_to(jnp.asarray(counts)[:, None, None], (B, T, GR))
        want = _np(jnp.any(jax.jit(j_solver._fits_off_counted)(jnp.asarray(used), cgrid, jnp.asarray(req), jit, off), axis=-1))
        got = p_solver.fits_off_counted(
            torch.from_numpy(used), torch.from_numpy(counts), torch.from_numpy(req),
            pit, prows.mask, zone_kid, ct_kid,
        )
        assert np.array_equal(got.numpy(), want)
        # broadcast row (tier 3's single template) equals the expanded rows
        one = p_solver.fits_off_counted(
            torch.from_numpy(used[:1]), torch.from_numpy(counts), torch.from_numpy(req),
            pit, prows.mask[:1], zone_kid, ct_kid,
        )
        full = p_solver.fits_off_counted(
            torch.from_numpy(np.repeat(used[:1], B, 0)), torch.from_numpy(counts),
            torch.from_numpy(req), pit, prows.mask[:1].expand(B, 8, 8).contiguous(), zone_kid, ct_kid,
        )
        assert torch.equal(one, full)

    def test_no_offering_gate_is_compact_liveness(self, catalog):
        """Mode (b) with counts 1 and no offering gate is compact_state's
        `used + r_min` fit test."""
        jit, pit, _z, _c, _jr, _pr, used, req, _v = self._inputs(catalog, 3)
        B = used.shape[0]
        t = used[:, None, None, :] + req[None, None, None, :]
        alloc = np.asarray(jit.alloc)
        fit = np.all((t <= alloc[None]) | (t == 0.0), axis=-1) & np.asarray(jit.group_valid)[None]
        got = p_solver.fits_off_counted(
            torch.from_numpy(used), torch.ones(B, dtype=torch.int32), torch.from_numpy(req),
            pit, None, 0, 0,
        )
        assert np.array_equal(got.numpy(), fit.any(-1))

    def test_single_rounding_charge(self):
        """used + c*req rounds once, as the reference's compiled (jitted)
        step computes it: 2.1000001 + 6 x 0.1 is 2.7 fused, 2.7000003 with
        two roundings, so a 2.7 limit admits 6 pods, not 5."""
        u, q = np.float32(2.1000001), np.float32(0.1)
        want = np.asarray(jax.jit(j_solver._count_cap_seq)(
            jnp.asarray([[u]]), jnp.asarray([[q]]), jnp.asarray([[np.float32(2.7)]])))
        got = p_solver._count_cap_seq(torch.tensor([[u]]), torch.tensor([[q]]), torch.tensor([[np.float32(2.7)]]))
        assert got.tolist() == want.tolist() == [6]
        assert p_solver._madd(torch.tensor(u), torch.tensor(6), torch.tensor(q)).item() == np.float32(2.7)


class TestWaterFill:
    def test_matches_bruteforce_and_reference(self):
        rng = np.random.default_rng(7)
        for _ in range(50):
            n = 16
            p = rng.integers(0, 6, n).astype(np.int32)
            f = rng.integers(0, 5, n).astype(np.int32)
            rem = int(rng.integers(0, 25))
            got = p_solver.water_fill(torch.from_numpy(p), torch.from_numpy(f), torch.tensor(rem, dtype=torch.int32))
            want = np.asarray(j_solver._water_fill(jnp.asarray(p), jnp.asarray(f), jnp.int32(rem)))
            assert np.array_equal(got.numpy(), want)
            cnt, cap = p.copy(), f.copy()
            fill = np.zeros(n, dtype=np.int32)
            for _ in range(rem):
                cands = np.flatnonzero(cap > 0)
                if len(cands) == 0:
                    break
                j = cands[np.lexsort((cands, cnt[cands]))[0]]
                fill[j] += 1
                cnt[j] += 1
                cap[j] -= 1
            assert np.array_equal(got.numpy(), fill), (p, f, rem)

    @pytest.mark.parametrize("n,rem", [(4096, 3000), (4096, 0), (1000, 250000), (33, 7)])
    def test_window_sizes_match_reference(self, n, rem):
        rng = np.random.default_rng(n + rem)
        p = rng.integers(0, 60, n).astype(np.int32)
        f = np.where(rng.random(n) < 0.3, 0, rng.integers(0, 9, n)).astype(np.int32)
        got = p_solver.water_fill_plain(torch.from_numpy(p), torch.from_numpy(f), torch.tensor(rem, dtype=torch.int32))
        want = np.asarray(j_solver._water_fill(jnp.asarray(p), jnp.asarray(f), jnp.int32(rem)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


class TestCompactScatter:
    def _fields(self, rng, W=12, T=5):
        return [
            torch.from_numpy(rng.random((W, T)) < 0.5),
            torch.from_numpy(rng.integers(-9, 9, (W,)).astype(np.int32)),
            torch.from_numpy(rng.random((W, 3)).astype(np.float32)),
        ]

    def test_compact_is_stable_argsort(self):
        rng = np.random.default_rng(0)
        srcs = self._fields(rng)
        alive = torch.from_numpy(rng.random(12) < 0.5)
        dsts = [torch.zeros_like(s) for s in srcs]
        p_solver.compact_scatter(0, alive, srcs, dsts)
        perm = np.argsort(~alive.numpy(), kind="stable")
        n = int(alive.sum())
        for s, d in zip(srcs, dsts):
            assert torch.equal(d[:n], s[torch.from_numpy(perm[:n])])
            assert not d[n:].any()

    def test_drop_scatter_is_reference_mode_drop(self):
        rng = np.random.default_rng(1)
        srcs = self._fields(rng)
        ids = np.array([3, 12, 0, -1, 7, 40, 5, 11, 2, 12, 9, 1], dtype=np.int32)
        dsts = [torch.from_numpy(rng.random(s.shape) < 2) if s.dtype == torch.bool else torch.ones_like(s) for s in srcs]
        want = [jnp.asarray(d.numpy()).at[ids].set(jnp.asarray(s.numpy()), mode="drop") for s, d in zip(srcs, dsts)]
        p_solver.compact_scatter(1, torch.from_numpy(ids), srcs, dsts)
        for w, d in zip(want, dsts):
            assert np.array_equal(np.asarray(w), d.numpy())


class TestBitsetsAndFetch:
    def test_pack_and_ops_match_reference(self):
        rng = np.random.default_rng(3)
        a = rng.random((5, 70)) < 0.2
        b = rng.random((5, 70)) < 0.2
        ja, jb = j_kernels.pack_bool_np(a), j_kernels.pack_bool_np(b)
        pa, pb = p_kernels.pack_bool_np(a), p_kernels.pack_bool_np(b)
        assert pa.dtype == np.int32 and np.array_equal(ja.view(np.int32), pa)
        ta, tb = torch.from_numpy(pa), torch.from_numpy(pb)
        assert np.array_equal(p_kernels.packed_conflict(ta, tb).numpy(), _np(j_kernels.packed_conflict(jnp.asarray(ja), jnp.asarray(jb))))
        assert np.array_equal(p_kernels.packed_any(ta).numpy(), _np(j_kernels.packed_any(jnp.asarray(ja))))
        assert np.array_equal(
            p_kernels.packed_count_and(ta, tb).numpy(),
            _np(j_kernels.packed_count_and(jnp.asarray(ja), jnp.asarray(jb))),
        )

    def test_fetch_tree_round_trip(self):
        tree = dict(
            a=torch.arange(6, dtype=torch.int32).reshape(2, 3),
            b=[torch.tensor(True), torch.rand(4), torch.zeros((0, 3), dtype=torch.bool)],
            c=p_solver.FillYs(*(torch.tensor(i, dtype=torch.int32) for i in range(7))),
            d="text",
        )
        got = p_kernels.fetch_tree(tree)
        assert np.array_equal(got["a"], tree["a"].numpy()) and got["a"].dtype == np.int32
        assert got["b"][0].shape == () and bool(got["b"][0])
        assert np.array_equal(got["b"][1], tree["b"][1].numpy())
        assert got["b"][2].shape == (0, 3)
        assert isinstance(got["c"], p_solver.FillYs) and int(got["c"].status) == 6
        assert got["d"] == "text"
