"""dp speculation on the port (ops/solver.py solve_fill_dp /
solve_kscan_dp / solve_perpod_dp, their verdict and merge_shard_fill /
merge_shard_kscan; TorchScheduler(dp=N)) against the JAX package's.

- Op level, without a mesh (the reference's dp programs run unmeshed:
  shard_hint is a no-op outside a mesh): the same encoded base state and
  DP rows go through the JITTED reference solve_*_dp and merge_shard_*
  and through the port's plain versions. The verdict words are equal and
  every speculative row's state, FillYs / KindYs / assignment and each
  committed merge (state, shifted slot map, shifted assignment) equal the
  reference's bit for bit, on a round that grafts and on one that
  replays, per family.
- Scheduler level: TorchScheduler(dp=2, device="cpu") (dp=4 for per-pod)
  against its own dp=1 solve and against a meshed TPUScheduler
  (make_mesh(8) split as KTPU_MESH=<dp>x<8/dp>): equal results, and
  last_stats["shard"] counters equal to the reference's
  last_timings["shard"] case by case over tests/test_shard.py's classes
  (fill graft / replay, kscan graft / replay / shared-selector conflict,
  existing contention and commit, hostname-spread and anti-affinity
  topo_fill, per-pod commit / mixed sizes / mv + budget, the opt-outs).

Each case builds its one meshed reference solve when it runs (no module
fixture: an xdist worker builds only the cases it runs). Tolerance: exact.

    python tests/test_torch_shard.py   # the dp chip cells' goldens (JAX, CPU)

prints the JAX package's results and merge counters for chip_smoke.py's
dp cells, each on the virtual 8-device mesh split as its cell's dp.
"""

import os
import sys
import types

if __name__ == "__main__":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
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
from karpenter_tpu.controllers.provisioning import build_templates as j_build_templates  # noqa: E402
from karpenter_tpu.controllers.provisioning import scheduler as j_sched  # noqa: E402
from karpenter_tpu.cloudprovider import fake as j_fake  # noqa: E402
from karpenter_tpu.models import pod as j_pod  # noqa: E402
from karpenter_tpu.models.nodepool import NodePool as JNodePool  # noqa: E402
from karpenter_tpu.ops import kernels as j_kernels  # noqa: E402
from karpenter_tpu.ops import solver as j_solver  # noqa: E402
from karpenter_tpu.parallel import make_mesh  # noqa: E402
from karpenter_tpu_torch import testing as T  # noqa: E402
from karpenter_tpu_torch.controllers.provisioning import TorchScheduler  # noqa: E402
from karpenter_tpu_torch.ops import kernels as p_kernels  # noqa: E402
from karpenter_tpu_torch.ops import solver as p_solver  # noqa: E402
from karpenter_tpu_torch.ops import topology as p_topo  # noqa: E402
from karpenter_tpu_torch.ops.encode import InstanceTypeTensors  # noqa: E402

from test_torch_scheduler import _view  # noqa: E402
from test_torch_solver import _tonp  # noqa: E402
from test_torch_whatif import JAX as WJAX  # noqa: E402
from reference_compile_cache import no_persistent_compile_cache  # noqa: E402,F401

JS = types.SimpleNamespace(**vars(WJAX), fake=j_fake, NodePool=JNodePool, build_templates=j_build_templates,
                           TopologySpreadConstraint=j_pod.TopologySpreadConstraint,
                           PodAffinityTerm=j_pod.PodAffinityTerm, HostPort=j_pod.HostPort)
PS = T.PORT
ENV = ("KTPU_PIPELINE_CHUNKS", "KTPU_PIPELINE_MIN_PODS", "KTPU_SOLVE_CHUNK", "KTPU_SCAN_WINDOW", "KTPU_MESH",
       "KTPU_SHARD_DP", "KTPU_SHARD_KSCAN", "KTPU_SHARD_EXISTING", "KTPU_SHARD_PERPOD", "KTPU_OBJECTIVE",
       "KTPU_OBJECTIVE_K")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _pt(x):
    """A reference array on the port (uint32 bitsets as int32 lanes)."""
    return torch.from_numpy(p_solver._np_leaf(np.array(x)))


def _tmpl(S, n_types=24):
    pool = S.NodePool()
    pool.metadata.name = "default"
    return S.build_templates([(pool, S.fake.instance_types(n_types))])


# ---------------------------------------------------------------------------
# op level: the dp programs on reference-encoded inputs
# ---------------------------------------------------------------------------


def _cmp(jv, pv, what):
    """A reference leaf (jax / numpy; uint32 bitsets as int32) against a
    port tensor, exactly."""
    a = np.asarray(jv)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    b = pv.cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _cmp_fields(jx, px, fields, what, row=None):
    """Every field of a reference container (row `row` of its leading dp
    axis, or whole) against the port container's field of the same name."""
    for f in fields:
        jv, pv = getattr(jx, f), getattr(px, f)
        if hasattr(jv, "_fields"):
            for g in jv._fields:
                x = getattr(jv, g)
                _cmp(x if row is None else np.asarray(x)[row], getattr(pv, g), f"{what}.{f}.{g}")
        else:
            _cmp(jv if row is None else np.asarray(jv)[row], pv, f"{what}.{f}")


class _Problem:
    """One problem encoded by the (unmeshed) reference, carried onto the
    port; the base state is the reference's state after `warm` of its
    segments solved in order (fill or per-pod), so the round base holds
    open claims."""

    def __init__(self, pods, max_claims=128, existing=None, n_types=24, templates=None, budgets=None):
        templates = templates or bench.make_templates(n_types)
        self.js = js = TPUScheduler(templates, max_claims=max_claims)
        js.existing_nodes = list(existing or [])
        _sorted, enc = js._encode(pods, existing, budgets) if budgets else js._encode(pods, existing)
        self.enc = enc
        self.j_args = (enc["exist_tensors"], js.it_tensors, enc["template_tensors"], js.well_known, enc["topo_tensors"])
        self.p_args = (
            p_solver.from_numpy(p_solver.ExistingNodes, _tonp(enc["exist_tensors"]), "cpu"),
            p_solver.from_numpy(InstanceTypeTensors, _tonp(js.it_tensors), "cpu"),
            p_solver.from_numpy(p_solver.Templates, _tonp(enc["template_tensors"]), "cpu"),
            _pt(js.well_known),
            p_solver.from_numpy(p_topo.TopologyTensors, _tonp(enc["topo_tensors"]), "cpu"),
        )
        self.kw = dict(zone_kid=enc["zone_kid"], ct_kid=enc["ct_kid"], n_claims=enc["n_claims"])

    def initial(self):
        enc = self.enc
        return j_solver.initial_state(
            enc["exist_tensors"], self.js.it_tensors, enc["template_tensors"], enc["topo_tensors"],
            enc["n_claims"], int(enc["ports_k"].shape[1]), self.js._res_cap0, window=enc["window"],
            topo_kids=enc["topo_kids"],
        )

    def port_state(self, jst):
        return p_solver.from_numpy(p_solver.SolverState, _tonp(jst), "cpu")

    def rows(self, groups, dp):
        """kind ids and counts [DP, B_pad] of the round's groups (count-0
        padding), as the reference's merge loops build them."""
        B = max(len(g) for g in groups)
        kid = np.zeros((dp, B), dtype=np.int64)
        cnt = np.zeros((dp, B), dtype=np.int32)
        for r, g in enumerate(groups):
            for j, (lo, hi, k) in enumerate(g):
                kid[r, j], cnt[r, j] = k, hi - lo
        return kid, cnt

    def gather(self, fn, kid, cnt, strict=False):
        enc = self.enc
        keys = ["reqs_k"] + (["strict_k"] if strict else []) + [
            "requests_k", "tol_k", "it_allow_k", "exist_ok_k", "ports_k", "conf_k", "vols_k", "pod_topo_k"]
        return fn(*(enc[k] for k in keys), jnp.asarray(kid), jnp.asarray(cnt))


def _row_of(cls, jx, r):
    """Row r of a reference container with a leading dp axis, on the port."""
    return p_solver.from_numpy(cls, jax.tree.map(lambda a: np.asarray(a)[r], jx), "cpu")


def _commit_prefix(word, n):
    return p_kernels.leading_ones(np.asarray(word).view(np.int32), n)


def _check_merges(prob, jbase, pbase, jspec, pspecs, n_commit, kscan=None):
    """Commit rows [0, n_commit) in order through both packages' merges
    from the round base, each merged state and output equal."""
    jc, pc = jbase, pbase
    for r in range(n_commit):
        jrow = j_solver.take_dp_row(jspec, jnp.int32(r))
        if kscan is None:
            jc, jshift = j_solver.merge_shard_fill(jc, jrow, jbase)
            pc, pshift = p_solver.merge_shard_fill(pc, pspecs[r], pbase)
        else:
            ja, pa = kscan
            jc, jshift, jassign = j_solver.merge_shard_kscan(jc, jrow, ja[r], jbase)
            pc, pshift, passign = p_solver.merge_shard_kscan(pc, pspecs[r], pa[r], pbase)
            _cmp(jassign, passign, f"assignment after merge {r}")
        _cmp(jshift, pshift, f"shifted slot map {r}")
        _cmp_fields(jc, pc, j_solver.SolverState._fields, f"merged {r}")
    return jc, pc


FILL_CASES = {
    # saturating kinds: every row grafts
    "graft": dict(pods=lambda: T.sized_kind_pods(96, kinds=6, prefix="g", mixed=False, side=JS)),
    # distinct sizes: later rows fit earlier rows' part-full claims
    "replay": dict(pods=lambda: T.sized_kind_pods(96, kinds=6, prefix="r", side=JS)),
    # existing nodes: the debit bit; hostname spread: the hg bit
    "existing": dict(pods=lambda: T.sized_kind_pods(96, kinds=6, prefix="e", side=JS),
                     existing=lambda: T.existing_sim_nodes(cpu_avail=8.0, side=JS)),
    "topo_fill": dict(pods=lambda: T.spread_kind_pods(96, 6, "h", (JS.l.LABEL_HOSTNAME,), label="hspread",
                                                      side=JS)),
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_solve_fill_dp_and_merge(case):
    c = FILL_CASES[case]
    prob = _Problem(c["pods"](), existing=c["existing"]() if "existing" in c else None)
    segs = prob.enc["segments"]
    assert all(prob.enc["batchable"][k] for _lo, _hi, k in segs)
    # base: the first segment solved; the round: the next segments in 3
    # groups on dp 4 rows (the last a count-0 padding row)
    kid0, cnt0 = prob.rows([segs[:1]], 1)
    jst, _ys = j_solver.solve_fill(prob.initial(), prob.gather(j_sched._gather_fill_xs, kid0[0], cnt0[0]),
                                   *prob.j_args, **prob.kw)
    groups = [segs[1:3], segs[3:4], segs[4:]]
    kid, cnt = prob.rows(groups, 4)
    jxs = prob.gather(j_sched._gather_fill_xs_dp, kid, cnt)
    jspec, jys, jword = j_solver.solve_fill_dp(jst, jxs, *prob.j_args, **prob.kw)
    pbase = prob.port_state(jst)
    pxs = [_row_of(p_solver.FillXs, jxs, r) for r in range(4)]
    pspecs, pyss, pword = p_solver.solve_fill_dp(pbase, pxs, *prob.p_args, *prob.kw.values())
    _cmp(jword, pword, "verdict word")
    for r in range(4):
        _cmp_fields(jspec, pspecs[r], j_solver.ShardFillState._fields, f"row {r}", row=r)
        _cmp_fields(jys, pyss[r], j_solver.FillYs._fields, f"ys {r}", row=r)
    n_commit = _commit_prefix(jword, len(groups))
    if case == "graft":
        assert n_commit == len(groups)
    if case == "replay":
        assert n_commit < len(groups)
    _check_merges(prob, jst, pbase, jspec, pspecs, n_commit)


KSCAN_CASES = {
    "graft": dict(shared=False, mixed=False),
    "replay": dict(shared=False, mixed=True),
    "shared_selector": dict(shared=True, mixed=False),
}


@pytest.mark.parametrize("case", sorted(KSCAN_CASES))
def test_solve_kscan_dp_and_merge(case):
    c = KSCAN_CASES[case]
    pods = T.spread_kind_pods(96, 4, "z", (JS.l.LABEL_TOPOLOGY_ZONE,), side=JS, **c)
    prob = _Problem(pods)
    enc = prob.enc
    segs = enc["segments"]
    key = int(enc["kscan_key"][segs[0][2]])
    assert key >= 0 and all(enc["kscan_key"][k] == key for _lo, _hi, k in segs)
    D = len(prob.js.encoder.vocab.values[key])
    groups = [[s] for s in segs[:3]]
    kid, cnt = prob.rows(groups, 4)
    maxc = int(-(-cnt.max() // 64) * 64)
    kkw = dict(prob.kw, key_kid=key, n_domains=D, maxc=maxc)
    jst = prob.initial()
    jxs = prob.gather(j_sched._gather_kind_xs_dp, kid, cnt, strict=True)
    jspec, jys, jword = j_solver.solve_kscan_dp(jst, jxs, *prob.j_args, **kkw)
    pbase = prob.port_state(jst)
    req = np.asarray(enc["requests_k"], dtype=np.float32)
    pspecs, pyss, pword = p_solver.solve_kscan_dp(
        pbase, [_row_of(p_solver.KindXs, jxs, r) for r in range(4)], *prob.p_args, *prob.kw.values(), key, D, maxc,
        counts_rows=[list(cnt[r]) for r in range(4)], requests_rows=[req[kid[r]] for r in range(4)],
    )
    _cmp(jword, pword, "verdict word")
    for r in range(4):
        _cmp_fields(jspec, pspecs[r], j_solver.ShardKscanState._fields, f"row {r}", row=r)
        _cmp(np.asarray(jys.assignment)[r], pyss[r].assignment, f"assignment {r}")
    n_commit = _commit_prefix(jword, len(groups))
    assert (n_commit == len(groups)) == (case == "graft")
    _check_merges(prob, jst, pbase, jspec, pspecs, n_commit,
                  kscan=(jys.assignment, [ys.assignment for ys in pyss]))


PERPOD_CASES = {
    "graft": dict(pods=lambda: T.spread_kind_pods(64, 4, "pp", (JS.l.LABEL_TOPOLOGY_ZONE, JS.l.CAPACITY_TYPE_LABEL_KEY),
                                                  side=JS)),
    "replay": dict(pods=lambda: T.spread_kind_pods(64, 4, "pm", (JS.l.LABEL_TOPOLOGY_ZONE,
                                                                 JS.l.CAPACITY_TYPE_LABEL_KEY), mixed=True, side=JS)),
    "mv_budget": dict(pods=lambda: T.spread_kind_pods(64, 4, "pb", (JS.l.LABEL_TOPOLOGY_ZONE,
                                                                    JS.l.CAPACITY_TYPE_LABEL_KEY), side=JS),
                      templates=lambda: T.mv_templates(24, side=JS), budgets={"default": {"cpu": 1e6}}),
}


@pytest.mark.parametrize("case", sorted(PERPOD_CASES))
def test_solve_perpod_dp_and_merge(case):
    c = PERPOD_CASES[case]
    prob = _Problem(c["pods"](), templates=c["templates"]() if "templates" in c else None,
                    budgets=c.get("budgets"))
    js, enc = prob.js, prob.enc
    flags = dict(mv_active=js._mv_active and js.min_values_policy != "BestEffort", topo_kids=enc["topo_kids"],
                 rid_kid=js._rid_kid, res_vid=js._res_vid, res_active=js._res_active,
                 res_strict=js.reserved_mode == "strict")
    P = enc["P"]
    L, DP = 16, 4
    chunks = [(lo, min(lo + L, P)) for lo in range(0, P, L)][:DP - 1]
    kidx = np.zeros((DP, L), dtype=np.int64)
    nval = np.zeros(DP, dtype=np.int32)
    for r, (lo, hi) in enumerate(chunks):
        kidx[r, : hi - lo] = enc["kind_of"][lo:hi]
        nval[r] = hi - lo
    j = j_sched._gather_pod_chunk_dp(
        enc["reqs_k"], enc["strict_k"], enc["requests_k"], enc["tol_k"], enc["it_allow_k"], enc["exist_ok_k"],
        enc["ports_k"], enc["conf_k"], enc["vols_k"], enc["pod_topo_k"], jnp.asarray(kidx), jnp.asarray(nval),
    )
    jst = prob.initial()
    jspec, jassign, jword = j_solver.solve_perpod_dp(jst, *j[:7], *prob.j_args, j[7], **prob.kw, **flags)
    # the port's pod block: the reference's [DP, L] rows flattened
    flat = jax.tree.map(lambda a: np.asarray(a).reshape((DP * L,) + np.asarray(a).shape[2:]), j)
    ppods = p_solver.from_numpy(p_solver.PodTensors, flat[0], "cpu")
    prest = [_pt(x) for x in flat[1:7]]
    ptopo = p_solver.from_numpy(p_topo.PodTopology, flat[7], "cpu")
    pbase = prob.port_state(jst)
    pflags = p_solver.PerPodFlags(flags["mv_active"], flags["res_active"], flags["res_strict"], flags["rid_kid"],
                                  flags["res_vid"])
    pspecs, passign, pword = p_solver.solve_perpod_dp(
        pbase, ppods, *prest, torch.arange(DP * L, dtype=torch.int32).reshape(DP, L), _pt(np.asarray(j[0].valid)),
        *prob.p_args[:5], ptopo, *prob.kw.values(), topo_kids=enc["topo_kids"], flags=pflags,
    )
    _cmp(jword, pword, "verdict word")
    _cmp(jassign, passign, "assignment")
    for r in range(DP):
        _cmp_fields(jspec, pspecs[r], j_solver.ShardKscanState._fields, f"row {r}", row=r)
    n_commit = _commit_prefix(jword, len(chunks))
    if case != "replay":
        assert n_commit >= 1
    else:
        assert n_commit < len(chunks)
    _check_merges(prob, jst, pbase, jspec, pspecs, n_commit, kscan=(jassign, passign))


def test_verdict_word_decode():
    """pack_bool / leading_ones / pairwise_commit_ok against the
    reference's, DP = 1, 32 and past 32 (two lanes)."""
    rng = np.random.default_rng(0)
    for n in (1, 5, 32, 33, 40):
        for _ in range(4):
            bits = rng.random(n) < 0.7
            jw = np.asarray(j_kernels.pack_bool(jnp.asarray(bits)))
            pw = p_kernels.pack_bool(torch.from_numpy(bits))
            _cmp(jw, pw, f"pack_bool {n}")
            assert p_kernels.leading_ones(pw.numpy(), n) == j_kernels.leading_ones(jw, n)
            assert np.array_equal(p_kernels.unpack_bool_np(pw.numpy(), n), bits)
        conflict = rng.random((n, n)) < 0.2
        _cmp(j_kernels.pairwise_commit_ok(jnp.asarray(conflict)), p_kernels.pairwise_commit_ok(
            torch.from_numpy(conflict)), f"pairwise_commit_ok {n}")


def test_standalone_predicates():
    """window_live_dead and fill_touched_below against the reference's
    jitted predicates on a solved state."""
    prob = _Problem(T.sized_kind_pods(48, kinds=4, prefix="w", side=JS))
    segs = prob.enc["segments"]
    kid, cnt = prob.rows([segs], 1)
    jst, jys = j_solver.solve_fill(prob.initial(), prob.gather(j_sched._gather_fill_xs, kid[0], cnt[0]),
                                   *prob.j_args, **prob.kw)
    pst = prob.port_state(jst)
    req = np.asarray(prob.enc["requests_k"], dtype=np.float32)
    for rm in (req.min(axis=0), req.max(axis=0), np.full(req.shape[1], np.inf, dtype=np.float32)):
        assert bool(j_solver.window_live_dead(jst, prob.js.it_tensors, jnp.asarray(rm))) == bool(
            p_solver.window_live_dead(pst, prob.p_args[1], torch.from_numpy(rm)))
    for lo in (0, 1, int(pst.w_open)):
        assert bool(j_solver.fill_touched_below(jys.fill_c, jnp.int32(lo))) == bool(
            p_solver.fill_touched_below(_pt(jys.fill_c), torch.tensor(lo, dtype=torch.int32)))


# ---------------------------------------------------------------------------
# scheduler level: TorchScheduler(dp=N) against the meshed TPUScheduler
# ---------------------------------------------------------------------------

L_ZONE, L_CT, L_HOST = T.l.LABEL_TOPOLOGY_ZONE, T.l.CAPACITY_TYPE_LABEL_KEY, T.l.LABEL_HOSTNAME

# name: (pods(S), dp, env, solve_chunk, existing(S) or None, templates(S) or None, budgets)
SCHED_CASES = {
    "fill_graft": (lambda S: T.sized_kind_pods(256, prefix="s", mixed=False, side=S), 2, {}, None, None, None, None),
    "fill_replay": (lambda S: T.sized_kind_pods(256, prefix="m", side=S), 2, {}, None, None, None, None),
    "kscan_graft": (lambda S: T.spread_kind_pods(192, 4, "kg", (L_ZONE,), side=S), 2, {}, None, None, None, None),
    "kscan_replay": (lambda S: T.spread_kind_pods(192, 4, "kr", (L_ZONE,), mixed=True, side=S), 2, {}, None, None,
                     None, None),
    "kscan_shared_selector": (lambda S: T.spread_kind_pods(192, 4, "ks", (L_ZONE,), shared=True, side=S), 2, {},
                              None, None, None, None),
    "existing_commit": (lambda S: T.sized_kind_pods(256, prefix="ex", mixed=False, side=S), 2, {}, None,
                        lambda S: T.existing_sim_nodes(side=S), None, None),
    "existing_contention": (lambda S: T.sized_kind_pods(256, prefix="exr", side=S), 2, {}, None,
                            lambda S: T.existing_sim_nodes(cpu_avail=8.0, side=S), None, None),
    "topo_fill_hostname_spread": (lambda S: T.spread_kind_pods(192, 4, "ts", (L_HOST,), label="hspread", side=S), 2,
                                  {}, None, None, None, None),
    "topo_fill_anti_affinity": (lambda S: T.anti_affinity_pods(side=S), 2, {}, None, None, None, None),
    "perpod_commit": (lambda S: T.spread_kind_pods(256, 4, "pp", (L_ZONE, L_CT), side=S), 2, {}, 64, None, None,
                      None),
    "perpod_commit_dp4": (lambda S: T.spread_kind_pods(256, 4, "p4", (L_ZONE, L_CT), side=S), 4, {}, 64, None, None,
                          None),
    "perpod_mixed_sizes": (lambda S: T.spread_kind_pods(256, 4, "ppm", (L_ZONE, L_CT), mixed=True, side=S), 2, {}, 64,
                           None, None, None),
    "perpod_mv_budget": (lambda S: T.spread_kind_pods(256, 4, "bp", (L_ZONE, L_CT), side=S), 2, {}, 64, None,
                         lambda S: T.mv_templates(24, side=S), {"default": {"cpu": 1e6}}),
    "perpod_tight_budget": (lambda S: T.spread_kind_pods(256, 4, "bt", (L_ZONE, L_CT), side=S), 2, {}, 64, None,
                            None, {"default": {"nodes": 6.0}}),
    "optout_shard_dp": (lambda S: T.sized_kind_pods(128, kinds=4, prefix="o", mixed=False, side=S), 2,
                        {"KTPU_SHARD_DP": "0"}, None, None, None, None),
    "optout_kscan": (lambda S: T.spread_kind_pods(192, 4, "ko", (L_ZONE,), side=S), 2, {"KTPU_SHARD_KSCAN": "0"},
                     None, None, None, None),
    "optout_existing": (lambda S: T.sized_kind_pods(128, kinds=4, prefix="exo", mixed=False, side=S), 2,
                        {"KTPU_SHARD_EXISTING": "0"}, None, lambda S: T.existing_sim_nodes(side=S), None, None),
    "optout_perpod": (lambda S: T.spread_kind_pods(256, 4, "ppo", (L_ZONE, L_CT), side=S), 2,
                      {"KTPU_SHARD_PERPOD": "0"}, 64, None, None, None),
}

def _reference(name, monkeypatch):
    pods_fn, dp, env, chunk, existing_fn, tmpl_fn, budgets = SCHED_CASES[name]
    with monkeypatch.context() as m:
        m.setenv("KTPU_PIPELINE_CHUNKS", "4")
        m.setenv("KTPU_PIPELINE_MIN_PODS", "32")
        m.setenv("KTPU_MESH", f"{dp}x{8 // dp}")
        if chunk:
            m.setenv("KTPU_SOLVE_CHUNK", str(chunk))
        for k, v in env.items():
            m.setenv(k, v)
        sched = TPUScheduler(tmpl_fn(JS) if tmpl_fn else _tmpl(JS), mesh=make_mesh(8))
        kw = dict(budgets={p: dict(b) for p, b in budgets.items()}) if budgets else {}
        result = sched.solve(pods_fn(JS), existing_fn(JS) if existing_fn else None, **kw)
    return result, sched.last_timings["shard"]


def _port(name, dp):
    pods_fn, _dp, env, chunk, existing_fn, tmpl_fn, budgets = SCHED_CASES[name]
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sched = TorchScheduler(tmpl_fn(PS) if tmpl_fn else _tmpl(PS), device="cpu", dp=dp)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sched.pipeline_min_pods = 32
    if chunk:
        sched.solve_chunk = chunk
    kw = dict(budgets={p: dict(b) for p, b in budgets.items()}) if budgets else {}
    result = sched.solve(pods_fn(PS), existing_fn(PS) if existing_fn else [], **kw)
    return result, sched.last_stats


@pytest.mark.parametrize("name", sorted(SCHED_CASES))
def test_scheduler_dp_matches_reference(name, monkeypatch):
    dp = SCHED_CASES[name][1]
    rj, jshard = _reference(name, monkeypatch)
    rp, pstats = _port(name, dp)
    r1, stats1 = _port(name, 1)
    assert "shard" not in stats1
    assert _view(rp) == _view(r1)
    assert _view(rp) == _view(rj)
    assert T.claims_digest(rp) == T.claims_digest(rj)
    want = T.shard_counters(jshard)
    assert T.shard_counters(pstats["shard"]) == want
    fam = want["families"]
    if name.startswith("optout"):
        assert want["merge_rounds"] == 0 or name == "optout_kscan"
    else:
        assert want["merge_rounds"] >= 1
    if name in ("fill_graft", "kscan_graft", "perpod_commit", "perpod_commit_dp4"):
        assert sum(c for c, _r in fam.values()) >= 2 and sum(r for _c, r in fam.values()) == 0
    if "replay" in name or "shared" in name or "contention" in name or "mixed" in name or "anti" in name:
        assert sum(r for _c, r in fam.values()) >= 1
    assert pstats["shard"]["verdict_bytes"] == 4 * pstats["shard"]["verdict_fetches"]


def test_dp_rejects_a_bad_extent():
    with pytest.raises(ValueError):
        TorchScheduler(_tmpl(PS), device="cpu", dp=0)


def test_dp_under_an_objective(monkeypatch):
    """A non-lexical policy with dp = 2: the fill groups go through the
    K-variant dispatch with variant_count(dp) variants, each round one
    merge round and one verdict fetch, as the reference's meshed solve."""
    monkeypatch.setenv("KTPU_OBJECTIVE", "cost_min")
    sched = TorchScheduler(T.mixed_pool_templates(24), device="cpu", dp=2)
    sched.pipeline_min_pods = 32
    rp = sched.solve(T.sized_kind_pods(128, kinds=4, prefix="ob", side=PS))
    stats = sched.last_stats
    monkeypatch.setenv("KTPU_PIPELINE_CHUNKS", "4")
    monkeypatch.setenv("KTPU_PIPELINE_MIN_PODS", "32")
    monkeypatch.setenv("KTPU_MESH", "2x4")
    js = TPUScheduler(T.mixed_pool_templates(24, side=JS), mesh=make_mesh(8))
    rj = js.solve(T.sized_kind_pods(128, kinds=4, prefix="ob", side=JS))
    assert _view(rp) == _view(rj)
    assert stats["variant_solves"] == 2 * stats["verdict_fetches"]
    want = T.shard_counters(js.last_timings["shard"])
    assert T.shard_counters(stats["shard"]) == want and want["merge_rounds"] >= 2


# ---------------------------------------------------------------------------
# the dp chip cells' goldens
# ---------------------------------------------------------------------------


def _golden(label, templates, pods, dp, env, max_claims=None, existing=None, budgets=None, digest=None):
    """One meshed reference solve: its results, its digest and its merge
    counters, printed as chip_smoke.py's goldens (only the cells named on
    the command line, when some are)."""
    import json
    import time

    if sys.argv[1:] and not any(label.startswith(a) for a in sys.argv[1:]):
        return
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update({"KTPU_MESH": f"{dp}x{8 // dp}", **env})
    try:
        t0 = time.perf_counter()
        sched = TPUScheduler(templates, max_claims=max_claims, mesh=make_mesh(8))
        kw = dict(budgets={p: dict(b) for p, b in budgets.items()}) if budgets else {}
        r = sched.solve(pods, existing, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counters = T.shard_counters(sched.last_timings["shard"])
    out = dict(claims=r.node_count, unschedulable=len(r.unschedulable), price=round(r.total_price(), 4),
               digest=(digest or T.claims_digest)(r), shard=counters)
    print(f"{label}: {json.dumps(out)} ({time.perf_counter() - t0:.1f}s)", flush=True)


def main():
    jt200 = bench.make_templates(200)
    _golden("shard_8192x200", jt200, bench.selector_pods(8192), 2, {"KTPU_PIPELINE_MIN_PODS": "1024"},
            max_claims=2048)
    twin = {"KTPU_PIPELINE_MIN_PODS": "256"}
    _golden("shard_8192x200 zonal twin", bench.make_templates(200), bench.zonal_pods(512, kinds=8), 2, twin)
    _golden("shard_8192x200 hostname twin", bench.make_templates(200), bench.hostname_pods(512, kinds=8), 2, twin)
    _golden("shard_8192x200 existing twin", bench.make_templates(200), T.sized_kind_pods(512, kinds=8, prefix="eb", mixed=False, side=JS), 2, twin,
            existing=T.existing_sim_nodes(side=JS))
    _golden("shard_8192x200 perpod twin", bench.make_templates(200), bench.perpod_pods(512, kinds=8), 2,
            dict(twin, KTPU_SOLVE_CHUNK="128"))
    _golden("shard_8192x200 mv+budget twin", T.mv_templates(200, side=JS), bench.perpod_pods(512, kinds=8, prefix="bb"),
            2, dict(twin, KTPU_SOLVE_CHUNK="128"), budgets={"default": {"cpu": 1e6}})
    _golden("shard_northstar_100000x1000_dp2", bench.make_templates(1000), bench.selector_pods(100_000), 2, {},
            max_claims=4096)
    _golden("shard_zonal_4096x400_dp2", bench.make_templates(400), bench.zonal_pods(4096, kinds=8), 2, {},
            max_claims=4096)
    _golden("shard_perpod_4096x400_dp4", bench.make_templates(400), bench.perpod_pods(4096, kinds=8), 4, {},
            max_claims=4096)
    _golden("shard_constrained_4096x400_dp4", T.constrained_templates(400, side=JS),
            bench.mixed_pods(4096) + T.hostport_pods(64, side=JS), 4, {}, max_claims=4096,
            budgets={"default": {"cpu": 4150.0}}, digest=T.result_digest)


if __name__ == "__main__":
    main()
