"""Placement objectives on the port (karpenter_tpu_torch.objectives, the
K-variant fill dispatch ops/solver.py solve_fill_variants and its verdict)
against the JAX package's, with mesh None on the CPU.

- The registry and the ranks: canonical_rank and variant_ranks equal the
  reference's for all five policies on the four family pools; the policy
  resolves objective= > KTPU_OBJECTIVE > lexical, unknown names to
  lexical; variant_count clamps alike; the price column equals.
- The device programs: the plain solve_fill_variants and its verdict
  against the JITTED reference solve_fill_variants and _objective_score on
  the same encoded inputs (the reference encodes, the port receives the
  tensors through from_numpy), for each objective at KV 1 and 4: the word
  (feasibility bits and winner) and every variant's fill state exactly,
  the scores bit for bit (both sum f32 in XLA's order, ops/solver.py
  xla_tree_sum); every score +inf; frag_aware's
  n·1e6 − landed, which XLA contracts into an fma (measured: one
  rounding), past n = 1074 where one rounding and two differ.
- End to end: TorchScheduler (the plain path on the CPU) against
  TPUScheduler under every non-lexical policy at K = 1 and K = 4 on the
  fill, kind-scan and per-pod workloads and bench.mixed_pods(192): claims,
  placements, reasons, price and digest equal; the cost gate (cost_min
  never pricier than lexical); objective= over the environment; lexical
  unchanged; a what-if batch and a resident session under cost_min; each
  round's verdict winner the argmin of its feasible scores.

Fresh schedulers throughout (the reference warm-sizes its window on a
reused scheduler; the port's window is the claims axis). Tolerance: exact
unless stated.

    python tests/test_torch_objectives.py   # the chip cells' goldens (JAX, CPU)

prints the JAX package's results for chip_smoke.py's objective cells.
"""

import os
import sys
import time
import types
from typing import NamedTuple

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
from karpenter_tpu import gang as j_gang  # noqa: E402
from karpenter_tpu import guard  # noqa: E402
from karpenter_tpu import objectives as j_obj  # noqa: E402
from karpenter_tpu.cloudprovider import fake as j_fake  # noqa: E402
from karpenter_tpu.controllers.provisioning import TPUScheduler  # noqa: E402
from karpenter_tpu.controllers.provisioning import build_templates as j_build_templates  # noqa: E402
from karpenter_tpu.controllers.provisioning import scheduler as j_sched  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.models.nodepool import NodePool as JNodePool  # noqa: E402
from karpenter_tpu.objectives import oracle as j_oracle  # noqa: E402
from karpenter_tpu.objectives import scoring as j_scoring  # noqa: E402
from karpenter_tpu.ops import encode as j_encode  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu_torch import objectives as p_obj  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler  # noqa: E402
from karpenter_tpu_torch.objectives import oracle as p_oracle  # noqa: E402
from karpenter_tpu_torch.objectives import scoring as p_scoring  # noqa: E402
from karpenter_tpu_torch.ops import encode as p_encode  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors  # noqa: E402
from karpenter_tpu_torch.ops.topology import TopologyTensors  # noqa: E402

from test_torch_resident import JAX as RJAX  # noqa: E402
from test_torch_resident import PORT as RPORT  # noqa: E402
from test_torch_resident import assert_round  # noqa: E402
from test_torch_scheduler import _view  # noqa: E402
from test_torch_solver import _assert_leaves_equal, _tonp  # noqa: E402
from test_torch_whatif import JAX as WJAX  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JS = types.SimpleNamespace(**vars(WJAX), fake=j_fake, NodePool=JNodePool, build_templates=j_build_templates,
                           TSC=j_pod.TopologySpreadConstraint, make_gang_pods=j_gang.make_gang_pods)
PS = types.SimpleNamespace(**vars(T.PORT), TSC=T.TopologySpreadConstraint)
NON_LEXICAL = ("cost_min", "frag_aware", "topo_spread", "gang_slice")
SIDES = {"jax": (JS, TPUScheduler, {}, bench.mixed_pods), "port": (PS, TorchScheduler, {"device": "cpu"}, T.mixed_pods)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_objective_env(monkeypatch):
    for var in ("KTPU_OBJECTIVE", "KTPU_OBJECTIVE_K"):
        monkeypatch.delenv(var, raising=False)
    guard.QUARANTINE.reset()
    yield
    guard.QUARANTINE.reset()


# ---------------------------------------------------------------------------
# workloads, built from either package's models (tests/test_shard.py's
# kind builders)
# ---------------------------------------------------------------------------


def mixed_kind_pods(S, n=128, kinds=8, prefix="m"):
    per = n // kinds
    return [S.make_pod(f"{prefix}-{i}", cpu=[0.25, 0.5, 1.0][(i // per) % 3],
                       memory=f"{[0.5, 1.0][(i // per) % 2]}Gi") for i in range(n)]


def _spread_kind_pods(S, n, kinds, prefix, keys):
    pods = []
    per = n // kinds
    for i in range(n):
        k = i // per
        p = S.make_pod(f"{prefix}-{i}", cpu=2.0, memory="1Gi")
        p.metadata.labels = {"grp": str(k), "spread": f"{prefix}{k}"}
        p.spec.topology_spread_constraints = [
            S.TSC(max_skew=1, topology_key=key, label_selector={"spread": f"{prefix}{k}"}) for key in keys
        ]
        pods.append(p)
    return pods


def zonal_kind_pods(S, n=96, kinds=4):
    return _spread_kind_pods(S, n, kinds, "z", (S.l.LABEL_TOPOLOGY_ZONE,))


def perpod_kind_pods(S, n=64, kinds=4):
    return _spread_kind_pods(S, n, kinds, "pp", (S.l.LABEL_TOPOLOGY_ZONE, S.l.CAPACITY_TYPE_LABEL_KEY))


WORKLOADS = {
    # name: (pods(S), n_types, max_claims)
    "mixed_kind_pods": (mixed_kind_pods, 48, 256),
    "zonal_kind_pods": (zonal_kind_pods, 48, 256),
    "perpod_kind_pods": (perpod_kind_pods, 48, 256),
    "bench_mixed_pods_192": (lambda S: SIDES["jax" if S is JS else "port"][3](192), 48, 256),
}


def _solve_both(policy, workload, monkeypatch, k=None, objective_kw=True):
    if k is not None:
        monkeypatch.setenv("KTPU_OBJECTIVE_K", str(k))
    make, n_types, max_claims = WORKLOADS[workload]
    out = []
    for side in ("jax", "port"):
        S, cls, kw, _mixed = SIDES[side]
        sched = cls(T.mixed_pool_templates(n_types, side=S), max_claims=max_claims,
                    objective=policy if objective_kw else None, **kw)
        out.append((sched, sched.solve(make(S))))
    return out


# (policy, workload, K) -> _solve_both's pair, for the cases that solve the
# same problem (a scheduler case and the cost gate); the schedulers and
# results are only read
_SHARED: dict = {}


def _solve_shared(policy, workload, monkeypatch, k):
    if (policy, workload, k) not in _SHARED:
        _SHARED[(policy, workload, k)] = _solve_both(policy, workload, monkeypatch, k)
    return _SHARED[(policy, workload, k)]


# ---------------------------------------------------------------------------
# the registry and the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", j_obj.POLICIES)
def test_ranks_match_reference(policy):
    jt, pt = T.mixed_pool_templates(48, side=JS), T.mixed_pool_templates(48)
    jr, pr = j_scoring.canonical_rank(policy, jt), p_scoring.canonical_rank(policy, pt)
    assert pr.dtype == np.int32 and np.array_equal(jr, pr)
    for kv in (1, 2, 4, 24):
        assert np.array_equal(j_scoring.variant_ranks(jr, kv), p_scoring.variant_ranks(pr, kv))
    if policy in ("cost_min", "frag_aware"):  # e, c, s, m: the weight order reversed
        assert pr.tolist() == [3, 2, 1, 0]
    else:
        assert pr.tolist() == [0, 1, 2, 3]
    if policy == "cost_min":  # a promoted template ranks min - 1 = -1
        assert p_scoring.variant_ranks(pr, 4)[1].tolist() == [3, 2, -1, 0]
    assert [p_scoring.template_price(t) for t in pt] == [j_scoring.template_price(t) for t in jt]


def test_policy_precedence_and_fallback(monkeypatch):
    """objective= > KTPU_OBJECTIVE > lexical; unknown names count as absent."""
    for env in (None, "frag_aware", "bogus", "lexical"):
        if env is None:
            monkeypatch.delenv("KTPU_OBJECTIVE", raising=False)
        else:
            monkeypatch.setenv("KTPU_OBJECTIVE", env)
        for kw in (None, "cost_min", "also_bogus", "gang_slice"):
            assert p_obj.resolve_policy(kw) == j_obj.resolve_policy(kw) == p_obj.active_policy(kw)
    monkeypatch.setenv("KTPU_OBJECTIVE", "frag_aware")
    assert p_obj.resolve_policy() == "frag_aware" and p_obj.resolve_policy("cost_min") == "cost_min"
    assert p_obj.POLICIES == j_obj.POLICIES
    for name in p_obj.POLICIES:
        assert p_obj.objective_id(name) == j_obj.objective_id(name)
    for c in ("OBJ_LEXICAL", "OBJ_COST_MIN", "OBJ_FRAG_AWARE", "OBJ_TOPO_SPREAD", "OBJ_GANG_SLICE", "VARIANT_MAX"):
        assert getattr(p_solver, c) == getattr(j_solver, c), c


def test_variant_count_clamps(monkeypatch):
    for raw in (None, "3", "999", "junk", "-2", "0", "24"):
        if raw is None:
            monkeypatch.delenv("KTPU_OBJECTIVE_K", raising=False)
        else:
            monkeypatch.setenv("KTPU_OBJECTIVE_K", raw)
        for dp in (0, 1, 8, 40):
            assert p_obj.variant_count(dp) == j_obj.variant_count(dp), (raw, dp)
    monkeypatch.setenv("KTPU_OBJECTIVE_K", "999")
    assert p_obj.variant_count(1) == p_solver.VARIANT_MAX == 24


def test_price_column_matches_reference():
    js = TPUScheduler(T.mixed_pool_templates(48, side=JS))
    js._encode(bench.mixed_pods(8), None)
    ps = TorchScheduler(T.mixed_pool_templates(48), device="cpu")
    ps._encode(T.mixed_pods(8), None)
    jp = np.asarray(j_encode.type_price_column(js.it_tensors))
    pp = p_encode.type_price_column(ps.it_tensors).numpy()
    assert np.array_equal(jp, pp) and np.isfinite(pp).all()


# ---------------------------------------------------------------------------
# the device programs on the same encoded inputs
# ---------------------------------------------------------------------------


class _Problem:
    """A fill problem over the four family pools, encoded by the reference
    and carried onto the port."""

    def __init__(self, pods, templates_fn=None, max_claims=128):
        self.js = TPUScheduler((templates_fn or (lambda: T.mixed_pool_templates(24, side=JS)))(),
                               max_claims=max_claims)
        _sorted, enc = self.js._encode(pods, None)
        self.enc = enc
        js = self.js
        self.j_args = (enc["exist_tensors"], js.it_tensors, enc["template_tensors"], js.well_known,
                       enc["topo_tensors"])
        dev = "cpu"
        self.p_args = (
            p_solver.from_numpy(p_solver.ExistingNodes, _tonp(enc["exist_tensors"]), dev),
            p_solver.from_numpy(InstanceTypeTensors, _tonp(js.it_tensors), dev),
            p_solver.from_numpy(p_solver.Templates, _tonp(enc["template_tensors"]), dev),
            torch.from_numpy(np.array(js.well_known)),
            p_solver.from_numpy(TopologyTensors, _tonp(enc["topo_tensors"]), dev),
        )
        self.G = len(js.templates)
        self.price_j = j_encode.type_price_column(js.it_tensors)
        self.price_p = torch.from_numpy(np.array(self.price_j))

    def initial(self):
        enc = self.enc
        st = j_solver.initial_state(
            enc["exist_tensors"], self.js.it_tensors, enc["template_tensors"], enc["topo_tensors"],
            enc["n_claims"], int(enc["ports_k"].shape[1]), self.js._res_cap0, window=enc["window"],
        )
        return st, p_solver.from_numpy(p_solver.SolverState, _tonp(st), "cpu")

    def xs(self, segs):
        enc = self.enc
        xs = j_sched._gather_fill_xs(
            enc["reqs_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"], enc["exist_ok_k"],
            enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"],
            jnp.asarray([s[2] for s in segs]), jnp.asarray([s[1] - s[0] for s in segs], dtype=jnp.int32),
        )
        return xs, p_solver.from_numpy(p_solver.FillXs, _tonp(xs), "cpu")

    def variants(self, jst, pst, segs, ranks: np.ndarray, objective: int, price=None):
        """Both packages' solve_fill_variants of one group: (j spec, j ys,
        j word, j scores, p states, p yss, p word, p scores)."""
        enc = self.enc
        jxs, pxs = self.xs(segs)
        pj = self.price_j if price is None else jnp.asarray(price)
        pp = self.price_p if price is None else torch.from_numpy(np.asarray(price, dtype=np.float32))
        spec, jys, jw, jsc = j_solver.solve_fill_variants(
            jst, jxs, *self.j_args, jnp.asarray(ranks), pj, zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"],
            n_claims=enc["n_claims"], objective=objective,
        )
        states, yss, pw, psc = p_solver.solve_fill_variants(
            pst, pxs, *self.p_args, torch.from_numpy(ranks), pp, enc["zone_kid"], enc["ct_kid"], enc["n_claims"],
            objective,
        )
        return spec, jys, jw, jsc, states, yss, pw, psc


def _word(w) -> int:
    return int(np.asarray(w).reshape(-1)[0]) & 0xFFFFFFFF


def _j_commit(jst, spec, v):
    row = jax.tree.map(lambda a: a[v], spec)
    return jst._replace(**{f: getattr(row, f) for f in p_solver.FILL_COMMIT},
                        w_hw=jnp.maximum(jst.w_hw, row.w_open))


def _check_round(prob, jst, pst, segs, ranks, objective, price=None):
    """One objective round on both packages; returns the two committed
    states (or the bases when nothing was feasible) and the word."""
    before = p_solver.to_numpy(pst)
    spec, jys, jw, jsc, states, yss, pw, psc = prob.variants(jst, pst, segs, ranks, objective, price)
    assert _word(pw) == _word(jw), (hex(_word(pw)), hex(_word(jw)))
    jsc, psc = np.asarray(jsc), psc.numpy()
    assert np.array_equal(jsc.view(np.int32), psc.view(np.int32)), (jsc.tolist(), psc.tolist())
    for v in range(ranks.shape[0]):
        row = jax.tree.map(lambda a: a[v], spec)
        pa = p_solver.to_numpy(states[v])
        for f in p_solver.FILL_COMMIT:
            jv = getattr(row, f)
            pairs = ([(np.asarray(getattr(jv, g)), pa[f"{f}.{g}"]) for g in jv._fields] if hasattr(jv, "_fields")
                     else [(np.asarray(jv), pa[f])])
            for x, y in pairs:
                x = x.view(np.int32) if x.dtype == np.uint32 else x
                assert np.array_equal(x, y), (v, f)
        assert np.array_equal(np.asarray(jys.leftover[v]), yss[v].leftover.numpy()), v
        assert np.array_equal(np.asarray(jys.fill_c[v]), yss[v].fill_c.numpy()), v
    # no variant wrote into the base
    after = p_solver.to_numpy(pst)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    w = _word(pw)
    if not w & 0xFFFFFF:
        return jst, pst, w
    win = (w >> 24) & 0xFF
    jc, pc = _j_commit(jst, spec, win), p_solver.commit_variant(pst, states[win])
    _assert_leaves_equal(jc, pc, "committed")
    # the reference's _objective_score, jitted alone, on the winner
    g = prob.G
    score = jax.jit(lambda b, s, p: j_solver._objective_score(b, s, p, objective, g))(jst, jc, prob.price_j
                                                                                    if price is None else jnp.asarray(price))
    ps = p_solver.objective_score_plain(pst.w_open, p_solver.variant_out(pc, yss[win]),
                                        prob.price_p if price is None else torch.from_numpy(np.asarray(price)), objective, g)
    assert np.asarray(score, dtype=np.float32).view(np.int32) == ps.numpy().view(np.int32), (float(score), float(ps))
    return jc, pc, w


OBJ = {"cost_min": j_solver.OBJ_COST_MIN, "frag_aware": j_solver.OBJ_FRAG_AWARE,
       "topo_spread": j_solver.OBJ_TOPO_SPREAD, "gang_slice": j_solver.OBJ_GANG_SLICE}


@pytest.mark.parametrize("kv", [1, 4])
@pytest.mark.parametrize("policy", NON_LEXICAL)
def test_solve_fill_variants_matches_reference(policy, kv):
    """Two rounds (the segments in two groups, the second from the first's
    committed state or, when no variant was feasible, from the base)
    through both packages' solve_fill_variants: word, scores, every
    variant's fill fields and the committed state."""
    prob = _Problem(bench.selector_pods(160) + mixed_kind_pods(JS, 48))
    pt_templates = prob.js.templates
    ranks = j_scoring.variant_ranks(j_scoring.canonical_rank(policy, pt_templates), kv)
    segs = prob.enc["segments"]
    cut = len(segs) // 2
    jst, pst = prob.initial()
    words = []
    for group in (segs[:cut], segs[cut:]):
        jst, pst, w = _check_round(prob, jst, pst, group, ranks, OBJ[policy])
        words.append(w)
    # a group with a pod no template takes is infeasible in every variant
    # (the reference then replays it); the others commit
    assert any(w & 0xFFFFFF for w in words) and int(pst.n_open) > 0


def test_all_scores_inf_commit_variant_zero():
    """Every type unpriced: every cost_min score +inf, argmin 0 — with
    variant 0 feasible or not, the word's winner is 0."""
    prob = _Problem(mixed_kind_pods(JS, 96))
    ranks = j_scoring.variant_ranks(j_scoring.canonical_rank("cost_min", prob.js.templates), 4)
    inf = np.full(prob.price_p.shape, np.inf, dtype=np.float32)
    jst, pst = prob.initial()
    _jc, _pc, w = _check_round(prob, jst, pst, prob.enc["segments"], ranks, j_solver.OBJ_COST_MIN, price=inf)
    assert w & 0xF and (w >> 24) == 0
    # variant 0 infeasible (a window too small for it), the others not: the
    # reference still commits variant 0
    out = [p_solver.VariantOut(its=torch.ones((8, 2), dtype=torch.bool), open=torch.ones(8, dtype=torch.bool),
                               pods=torch.ones(8, dtype=torch.int32), template=torch.zeros(8, dtype=torch.int32),
                               w_open=torch.tensor(4, dtype=torch.int32), spills=torch.tensor(s, dtype=torch.int32),
                               leftover=torch.zeros(1, dtype=torch.int32)) for s in (1, 0, 0)]
    scores, word = p_solver.objective_verdict_plain(torch.tensor(0, dtype=torch.int32),
                                                    torch.tensor(0, dtype=torch.int32), out,
                                                    torch.full((2,), float("inf")), j_solver.OBJ_COST_MIN, 1)
    assert torch.isinf(scores).all() and _word(word) == 0b110


def test_frag_aware_one_rounding_matches_xla():
    """1075 claims opened in one round (1075 pods, one per node): n·1e6 is
    not a float. The reference's jitted program rounds n·1e6 − landed once
    (XLA contracts it into an fma; two roundings give another value), and
    so does the port."""
    templates = lambda: T.mixed_pool_templates(8, families=("m",), side=JS)  # noqa: E731  (1-cpu m types)
    prob = _Problem([JS.make_pod(f"w-{i}", cpu=0.75, memory="256Mi") for i in range(1075)], templates,
                    max_claims=2048)
    ranks = j_scoring.variant_ranks(j_scoring.canonical_rank("frag_aware", prob.js.templates), 1)
    jst, pst = prob.initial()
    spec, _jys, _jw, jsc, states, _yss, _pw, psc = prob.variants(jst, pst, prob.enc["segments"], ranks,
                                                                j_solver.OBJ_FRAG_AWARE)
    n, landed = int(states[0].w_open), int(states[0].pods.sum())
    assert n == int(np.asarray(spec.w_open)[0]) == 1075 and landed == 1075
    one = np.float32(n * 1e6 - landed)
    two = np.float32(np.float32(np.float32(n) * np.float32(1e6)) - np.float32(landed))
    assert one != two
    assert float(np.asarray(jsc)[0]) == float(one) == float(psc[0])


class _Opened(NamedTuple):
    """The fields the reference's _objective_score reads of a state."""

    open: jnp.ndarray
    w_open: jnp.ndarray
    its: jnp.ndarray
    pods: jnp.ndarray
    template: jnp.ndarray


def _near_tie(n: int = 200, seed: int = 20):
    """Two cost_min fleets of n claims each, one type a claim: fleet A's
    prices drawn from [0.02, 3.0) $/h, fleet B's multiples of the ulp of
    A's exact total that add up to it exactly, in any order. The
    reference's f32 sum of A in XLA's order differs from that total; B
    goes at the index where the port's tie (equal scores, lowest index
    wins) and the reference's strict order pick different fleets. Returns
    (price [2n], the rows' types per variant in variant order, A's index,
    A's reference sum, A's exact total)."""
    rng = np.random.default_rng(seed)
    price_a = rng.uniform(0.02, 3.0, n).astype(np.float32)
    total = np.float32(np.sum(price_a.astype(np.float64)))
    ulp = np.spacing(total)
    units = int(round(float(total) / float(ulp)))
    parts = np.full(n, units // n, dtype=np.int64)
    parts[: units - int(parts.sum())] += 1
    price_b = (parts.astype(np.float64) * float(ulp)).astype(np.float32)
    assert np.float32(np.sum(price_b.astype(np.float64))) == total
    seq = np.float32(0)
    for p in price_b:  # every partial sum is a multiple of ulp below 2^24 ulps: exact in any order
        seq = np.float32(seq + p)
    assert seq == total
    price = np.concatenate([price_a, price_b])
    rows_a, rows_b = list(range(n)), list(range(n, 2 * n))
    j_sum = _reference_cost(np.asarray([rows_a]), price, n + 56)[0]
    assert j_sum != float(total)
    a_first = j_sum > float(total)  # the reference prefers B; the port's tie picks index 0
    return price, ([rows_a, rows_b] if a_first else [rows_b, rows_a]), int(not a_first), j_sum, float(total)


def _reference_cost(fleets: np.ndarray, price: np.ndarray, W: int) -> list:
    """The reference's jitted _objective_score (cost_min) of each fleet
    (row r of the window open, viable for type fleets[v][r] alone)."""
    score = jax.jit(lambda b, st, p: j_solver._objective_score(b, st, p, j_solver.OBJ_COST_MIN, 1))
    out = []
    for rows in fleets:
        its = np.zeros((W, price.shape[0]), bool)
        its[np.arange(len(rows)), rows] = True
        op = np.arange(W) < len(rows)
        st = _Opened(jnp.asarray(op), jnp.asarray(len(rows), jnp.int32), jnp.asarray(its), jnp.zeros(W, jnp.int32),
                     jnp.zeros(W, jnp.int32))
        out.append(float(score(st._replace(w_open=jnp.asarray(0, jnp.int32)), st, jnp.asarray(price))))
    return out


def _near_tie_round():
    """The near-tie round on both sides: (A's index, A's reference sum, the
    exact total, the reference's scores, its winner, the port's scores,
    the port's word)."""
    price, fleets, a_index, j_a, exact = _near_tie()
    n, W = len(fleets[0]), len(fleets[0]) + 56
    j_scores = _reference_cost(np.asarray(fleets), price, W)
    j_winner = int(np.argmin(np.asarray(j_scores, dtype=np.float32)))
    outs = []
    for rows in fleets:
        its = torch.zeros((W, price.shape[0]), dtype=torch.bool)
        its[torch.arange(n), torch.tensor(rows)] = True
        outs.append(p_solver.VariantOut(
            its=its, open=torch.arange(W) < n, pods=torch.ones(W, dtype=torch.int32),
            template=torch.zeros(W, dtype=torch.int32), w_open=torch.tensor(n, dtype=torch.int32),
            spills=torch.tensor(0, dtype=torch.int32), leftover=torch.zeros(1, dtype=torch.int32)))
    zero = torch.tensor(0, dtype=torch.int32)
    p_scores, word = p_solver.objective_verdict_plain(zero, zero, outs, torch.from_numpy(price),
                                                      j_solver.OBJ_COST_MIN, 1)
    return a_index, j_a, exact, j_scores, j_winner, p_scores, _word(word)


def test_cost_min_near_tie_scores():
    """ROADMAP §3's near-tie case, its scores: two cost_min variants whose
    fleets differ (200 claims each, one type a claim): fleet B adds up
    exactly to fleet A's total, and the reference's f32 sum of A in XLA's
    order misses it by one ulp. The port sums in XLA's order too
    (xla_tree_sum), so its scores equal the reference's bit for bit, A's
    one ulp off the exact total included, and both variants are
    feasible."""
    a_index, j_a, exact, j_scores, _jw, p_scores, word = _near_tie_round()
    assert j_scores[a_index] == j_a != exact and j_scores[1 - a_index] == exact
    assert abs(j_a - exact) == float(np.spacing(np.float32(exact)))
    want = np.asarray(j_scores, dtype=np.float32)
    assert np.array_equal(p_scores.numpy().view(np.int32), want.view(np.int32)), (p_scores.tolist(), j_scores)
    assert p_scores[a_index] != p_scores[1 - a_index] and word & 0xFFFFFF == 0b11


def test_cost_min_near_tie_winner_matches_reference():
    """The near-tie case's winner: the reference's argmin over its jitted
    _objective_score of each variant (solve_fill_variants' fold) against
    the port's verdict word."""
    _a, _ja, _exact, j_scores, j_winner, p_scores, word = _near_tie_round()
    assert (word >> 24) & 0xFF == j_winner, (j_scores, p_scores.tolist())


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("policy", NON_LEXICAL)
def test_scheduler_matches_reference(policy, k, workload, monkeypatch):
    (js, rj), (ps, rp) = _solve_shared(policy, workload, monkeypatch, k)
    assert ps._active_policy == js._active_policy == policy
    assert _view(rj) == _view(rp)
    assert T.claims_digest(rp) == T.claims_digest(rj)
    assert p_oracle.total_price_per_hour(rp) == j_oracle.total_price_per_hour(rj)
    assert [(p.name, r) for p, r in rj.unschedulable] == [(p.name, r) for p, r in rp.unschedulable]
    st = ps.last_stats
    if st["fill_dispatches"]:
        assert st["verdict_fetches"] == st["objective_committed"] + st["objective_replayed"] > 0
        assert st["verdict_bytes"] == 4 * st["verdict_fetches"]
        assert st["wins_canonical"] + st["wins_perturbed"] == st["objective_committed"]
        assert st["variant_solves"] == min(k, 4) * st["verdict_fetches"]


@pytest.mark.parametrize("policy", ("cost_min", "gang_slice"))
def test_gangs_under_objective(policy, monkeypatch):
    """Gangs beside singletons under a policy: the gang kernel's slice
    template follows the rank (its plain step here), the singletons' fill
    groups run the K-variant dispatch; the result equals the reference's."""
    monkeypatch.setenv("KTPU_OBJECTIVE_K", "4")
    views = []
    for side in ("jax", "port"):
        S, cls, kw, _mixed = SIDES[side]
        sched = cls(T.mixed_pool_templates(24, side=S), max_claims=128, objective=policy, **kw)
        r = sched.solve(T.gang_storm_pods(4, 4, 32, side=S))
        views.append(_view(r))
        if side == "port":
            assert sched.last_stats["gang_dispatches"] > 0 and sched.last_stats["verdict_fetches"] > 0
            assert sum(1 for c in r.claims if c.gang) >= 4
    assert views[0] == views[1]


def test_cost_gate_and_perturbed_wins(monkeypatch):
    """The reference's objective stage gate: cost_min never buys a pricier
    fleet than lexical (strictly cheaper here); at K = 4 perturbed
    variants win rounds, and the prices equal the reference's."""
    prices = {}
    for policy in ("lexical", "cost_min"):
        (js, rj), (ps, rp) = _solve_shared(policy, "bench_mixed_pods_192", monkeypatch, 4)
        assert not rp.unschedulable and _view(rj) == _view(rp)
        prices[policy] = p_oracle.total_price_per_hour(rp)
        assert prices[policy] == j_oracle.total_price_per_hour(rj)
        if policy == "cost_min":
            assert ps.last_stats["wins_perturbed"] > 0
    assert prices["cost_min"] < prices["lexical"]


def test_objective_keyword_wins_over_env(monkeypatch):
    monkeypatch.setenv("KTPU_OBJECTIVE", "lexical")
    (js, rj), (ps, rp) = _solve_both("cost_min", "mixed_kind_pods", monkeypatch)
    assert ps._active_policy == "cost_min" and _view(rj) == _view(rp)
    assert {c.template.nodepool_name for c in rp.claims} == {"e-pool"}
    monkeypatch.setenv("KTPU_OBJECTIVE", "cost_min")
    (js, rj), (ps, rp) = _solve_both("frag_aware", "zonal_kind_pods", monkeypatch)
    assert ps._active_policy == js._active_policy == "frag_aware" and _view(rj) == _view(rp)
    # the environment alone
    (js, rj), (ps, rp) = _solve_both(None, "zonal_kind_pods", monkeypatch, objective_kw=False)
    assert ps._active_policy == js._active_policy == "cost_min" and _view(rj) == _view(rp)


def test_lexical_unchanged(monkeypatch):
    """lexical — by default, by name, or through an unknown name — keeps
    weight order with no rank column and no objective round, and gives the
    reference's result."""
    digests = set()
    for how in ("default", "lexical", "bogus"):
        if how == "bogus":
            monkeypatch.setenv("KTPU_OBJECTIVE", "cheapest_pls")
        ps = TorchScheduler(T.mixed_pool_templates(48), max_claims=256, device="cpu",
                            objective="lexical" if how == "lexical" else None)
        _sorted, enc = ps._encode(T.mixed_pods(192), None)
        assert enc["template_tensors"].rank is None and ps._active_policy == "lexical"
        rp = ps.solve(T.mixed_pods(192))
        assert ps.last_stats["verdict_fetches"] == 0
        digests.add(T.claims_digest(rp))
    rj = TPUScheduler(T.mixed_pool_templates(48, side=JS), max_claims=256).solve(bench.mixed_pods(192))
    assert len(digests) == 1 and _view(rj) == _view(rp)
    assert {c.template.nodepool_name for c in rp.claims} == {"m-pool"}


def test_verdict_winner_is_round_argmin(monkeypatch):
    """Every verdict word's top byte is the argmin of its round's feasible
    scores (ties to the lowest index; 0 when nothing is feasible)."""
    monkeypatch.setenv("KTPU_OBJECTIVE_K", "4")
    recorded = []
    orig = p_solver.solve_fill_variants

    def spy(*a, **kw):
        out = orig(*a, **kw)
        recorded.append(out)
        return out

    monkeypatch.setattr(p_solver, "solve_fill_variants", spy)
    r = TorchScheduler(T.mixed_pool_templates(48), max_claims=256, device="cpu",
                       objective="cost_min").solve(mixed_kind_pods(PS, 192))
    assert not r.unschedulable and recorded
    for _states, _yss, word, scores in recorded:
        w = _word(word)
        s = scores.numpy()
        feas = np.array([(w >> i) & 1 for i in range(s.shape[0])], dtype=bool)
        want = int(np.argmin(np.where(feas, s, np.inf))) if feas.any() else 0
        assert (w >> 24) & 0xFF == want


def test_whatif_batch_under_cost_min(monkeypatch):
    """A consolidation batch under cost_min: the clusters provisioned under
    cost_min, then the prefix batch — every scenario's per-pod scan under
    cost_min's rank — gives the reference's signals."""
    sigs = []
    for side in ("jax", "port"):
        S, cls, kw, mixed = SIDES[side]
        templates = T.mixed_pool_templates(24, side=S)
        res = cls(templates, objective="cost_min", **kw).solve(mixed(48))
        cl = T.launch_claims(res, templates, side=S)
        pods, specs = T.prefix_scenarios(T.candidates(cl), 6, T.pending_pods(6, side=S))
        sched = cls(templates, objective="cost_min", **kw)
        sigs.append(sched.whatif_batch(pods, [x.clone() for x in cl.nodes], None, specs,
                                       T.topology_factory(cl, side=S)))
        if side == "port":
            assert sched._active_policy == "cost_min"
    assert sigs[0] is not None and sigs[0] == sigs[1]


def test_resident_session_under_cost_min(monkeypatch):
    """A resident session under cost_min on the four family pools: every
    round's mode, packing, digest and fingerprint equal the reference's
    (the arrivals append under the capture's canonical rank)."""
    monkeypatch.setenv("KTPU_RESIDENT", "1")
    monkeypatch.setenv("KTPU_PIPELINE_CHUNKS", "0")
    monkeypatch.delenv("KTPU_SCAN_WINDOW", raising=False)
    monkeypatch.delenv("KTPU_COMPACT_MIN_PODS", raising=False)
    js = TPUScheduler(T.mixed_pool_templates(24, side=JS), max_claims=128, objective="cost_min").resident_session()
    pss = TorchScheduler(T.mixed_pool_templates(24), max_claims=128, device="cpu", objective="cost_min")
    pss.pipeline_chunks = 0
    ps = pss.resident_session()

    def rounds(S):
        base = T.kind_batch("a", 16, side=S) + T.kind_batch("b", 12, side=S)
        d = [T.kind_batch(f"d{r}", 6, side=S) for r in range(2)]
        return [base, base + d[0], base + d[0] + d[1], base + d[0]]

    modes = []
    for i, (pj, pp) in enumerate(zip(rounds(RJAX), rounds(RPORT))):
        rj, rp = js.solve(list(pj)), ps.solve(list(pp))
        assert_round(rj, rp, js, ps, f"round {i}")
        modes.append((ps.last_mode, ps.last_reason))
        # every kind lands on the cheapest family's pool, the last in weight order
        assert {c.template.nodepool_name for c in rp.claims} == {"e-pool"}
    # the arrivals append; the departure of d1, which shares claims with
    # d0, re-solves in full in both packages (retract_impure)
    assert modes == [("full", "cold"), ("delta", "delta"), ("delta", "delta"), ("full", "retract_impure")], modes


# ---------------------------------------------------------------------------
# the chip cells' goldens
# ---------------------------------------------------------------------------

# objectives_mixed_16384x400: mixed_pods(16384) over mixed_pool_templates(400),
# max_claims=4096, KTPU_OBJECTIVE_K=4, under every policy;
# objectives_perpod_4096x400: perpod_pods(4096, kinds=8) over the same
# pools, lexical and cost_min
CHIP_MIXED = dict(pods=16384, types=400, max_claims=4096, k=4)
CHIP_PERPOD = dict(pods=4096, kinds=8, types=400, max_claims=4096, k=4, policies=("lexical", "cost_min"))


def _round_counters(policy: str) -> dict:
    """The reference's objective-round counters for one policy."""
    from karpenter_tpu.utils.metrics import OBJECTIVE_ROUNDS, OBJECTIVE_VARIANT_WINS

    return dict(
        committed=OBJECTIVE_ROUNDS.get(policy=policy, outcome="committed"),
        replayed=OBJECTIVE_ROUNDS.get(policy=policy, outcome="replayed"),
        wins_canonical=OBJECTIVE_VARIANT_WINS.get(policy=policy, variant="canonical"),
        wins_perturbed=OBJECTIVE_VARIANT_WINS.get(policy=policy, variant="perturbed"),
    )


def print_goldens() -> None:
    """The JAX package's results for the two objective cells (TPUScheduler,
    mesh None, a fresh scheduler per solve), with the objective-round
    counters of each solve."""
    import json

    os.environ["KTPU_OBJECTIVE_K"] = str(CHIP_MIXED["k"])
    out = {}
    cells = [("objectives_mixed_16384x400", CHIP_MIXED, j_obj.POLICIES, lambda: bench.mixed_pods(CHIP_MIXED["pods"])),
             ("objectives_perpod_4096x400", CHIP_PERPOD, CHIP_PERPOD["policies"],
              lambda: bench.perpod_pods(CHIP_PERPOD["pods"], kinds=CHIP_PERPOD["kinds"]))]
    for cell, cfg, policies, pods_fn in cells:
        for policy in policies:
            before = _round_counters(policy)
            t0 = time.perf_counter()
            sched = TPUScheduler(T.mixed_pool_templates(cfg["types"], side=JS), max_claims=cfg["max_claims"],
                                 objective=policy)
            r = sched.solve(pods_fn())
            after = _round_counters(policy)
            g = dict(claims=len(r.claims), unschedulable=len(r.unschedulable),
                     price=round(j_oracle.total_price_per_hour(r), 4), digest=T.claims_digest(r),
                     **{k: int(after[k] - before[k]) for k in after}, solve_s=round(time.perf_counter() - t0, 1))
            out.setdefault(cell, {})[policy] = g
            print(cell, policy, json.dumps(g), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    print_goldens()
