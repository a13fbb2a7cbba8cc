"""The objective score's f32 sums in XLA's order: ops/solver.py
xla_tree_sum and objective_score_plain against the JAX package, bit for
bit.

- xla_tree_sum against the jitted `jnp.sum` of a masked f32 vector at
  lengths of one block, a padded block, two and three levels of partials
  (XLA:CPU: blocks of 32 after lo = p // 2 leading zeros, partials summed
  again while more than 32 are left), one and batched rows;
- objective_score_plain against the reference's jitted `_objective_score`
  for cost_min, frag_aware, topo_spread and gang_slice at W = 1, 31, 32,
  33, 65, 256, 1000, 1001 and 4152, on seeded states whose sums round
  (prices spanning 10^-3 to 10^3 over the cells' 400 types, large pods,
  template counts whose squares pass 2^24), and cost_min over a catalog
  of 24 types from W = 33 up. (cost_min at W <= 32 over a catalog of
  fewer than about 400 types is not held: there XLA:CPU emits the sum
  over W as one loop around the min over T, and LLVM vectorizes that
  loop in an order that depends on T and on the host's vector width —
  8 or 4 lane accumulators, then a halving tree and a tail in order;
  ROADMAP.md §3 keeps it as an open case.)
- the scores of the reference's `solve_fill_variants` (vmapped over K
  variants) against the port's on one small objectives round.

Tolerance: exact (the f32 bits).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.objectives import scoring as j_scoring
from karpenter_tpu.ops import solver as j_solver
from karpenter_tpu_torch.ops import solver as p_solver

from test_torch_objectives import JS, _Problem, mixed_kind_pods
from reference_compile_cache import no_persistent_compile_cache  # noqa: F401

OBJECTIVES = {"cost_min": p_solver.OBJ_COST_MIN, "frag_aware": p_solver.OBJ_FRAG_AWARE,
              "topo_spread": p_solver.OBJ_TOPO_SPREAD, "gang_slice": p_solver.OBJ_GANG_SLICE}
WIDTHS = (1, 31, 32, 33, 65, 256, 1000, 1001, 4152)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@jax.jit
def _j_masked_sum(m, x):
    return jnp.sum(jnp.where(m, x, 0.0), axis=-1)


@pytest.mark.parametrize("n", [1, 2, 7, 31, 32, 33, 65, 1000, 1023, 1024, 1056, 4097, 40000])
def test_tree_sum_matches_xla(n):
    """Twenty seeded rows of n prices spanning 10^-3 to 10^3, three quarters
    of them kept: each row's sum and the batched [20, n] sum equal the
    jitted reference's bits."""
    rng = np.random.default_rng(n)
    x = (10.0 ** rng.uniform(-3, 3, (20, n))).astype(np.float32)
    m = rng.random((20, n)) < 0.75
    want = _bits(_j_masked_sum(jnp.asarray(m), jnp.asarray(x)))
    xm = torch.from_numpy(np.where(m, x, np.float32(0)))
    assert np.array_equal(_bits(p_solver.xla_tree_sum(xm).numpy()), want)
    for i in (0, 19):
        assert _bits(p_solver.xla_tree_sum(xm[i]).numpy()) == want[i]


def test_tree_sum_differs_from_other_orders():
    """The order matters at these inputs: a left fold and an f64 sum
    rounded once both miss the reference's bits on some row, the tree
    order on none."""
    rng = np.random.default_rng(5)
    x = (10.0 ** rng.uniform(-3, 3, (40, 1001))).astype(np.float32)
    want = _bits(_j_masked_sum(jnp.ones(x.shape, bool), jnp.asarray(x)))
    tree = _bits(p_solver.xla_tree_sum(torch.from_numpy(x)).numpy())
    f64 = _bits(x.astype(np.float64).sum(axis=1).astype(np.float32))
    fold = _bits(np.cumsum(x, axis=1, dtype=np.float32)[:, -1])
    assert np.array_equal(tree, want)
    assert not np.array_equal(f64, want) and not np.array_equal(fold, want)


class _St(NamedTuple):
    """The fields the reference's _objective_score reads of a state."""

    open: jnp.ndarray
    w_open: jnp.ndarray
    its: jnp.ndarray
    pods: jnp.ndarray
    template: jnp.ndarray


_J_SCORE: dict = {}


def _j_score(objective: int, G: int):
    if (objective, G) not in _J_SCORE:
        _J_SCORE[(objective, G)] = jax.jit(lambda b, s, p: j_solver._objective_score(b, s, p, objective, G))
    return _J_SCORE[(objective, G)]


def _state(W: int, seed: int, T_: int = 400, G: int = 3):
    """A seeded state of W window rows over T_ types: base w_open below a
    fifth of W, w_open above it, most rows open; viable types a third of T, prices
    spanning 10^-3 to 10^3 with a tenth unpriced; pods up to 2^20 (a
    block's sum passes 2^24) on a third of the rows, else small; a few
    templates (a count's square passes 2^24 at W = 4152, G = 1)."""
    rng = np.random.default_rng(seed)
    base_w = int(rng.integers(0, max(W // 5, 1)))
    w_open = int(rng.integers(base_w + 1, W + 1)) if W > 1 else 1
    price = (10.0 ** rng.uniform(-3, 3, T_)).astype(np.float32)
    price[rng.random(T_) < 0.1] = np.inf
    its = rng.random((W, T_)) < 0.33
    its[:, int(np.argmin(price))] |= rng.random(W) < 0.5
    its[np.arange(W), rng.integers(0, T_, W)] = True
    big = rng.random(W) < 0.33
    pods = np.where(big, rng.integers(1 << 19, 1 << 20, W), rng.integers(0, 40, W)).astype(np.int32)
    return dict(base_w=base_w, w_open=w_open, price=price, its=its, open=rng.random(W) < 0.9, pods=pods,
                template=rng.integers(0, G, W).astype(np.int32), G=G)


def _both_scores(s: dict, objective: int):
    js = _St(jnp.asarray(s["open"]), jnp.asarray(s["w_open"], jnp.int32), jnp.asarray(s["its"]),
             jnp.asarray(s["pods"]), jnp.asarray(s["template"]))
    want = _j_score(objective, s["G"])(js._replace(w_open=jnp.asarray(s["base_w"], jnp.int32)), js,
                                       jnp.asarray(s["price"]))
    v = p_solver.VariantOut(
        its=torch.from_numpy(s["its"]), open=torch.from_numpy(s["open"]), pods=torch.from_numpy(s["pods"]),
        template=torch.from_numpy(s["template"]), w_open=torch.tensor(s["w_open"], dtype=torch.int32),
        spills=torch.tensor(0, dtype=torch.int32), leftover=torch.zeros(1, dtype=torch.int32))
    got = p_solver.objective_score_plain(torch.tensor(s["base_w"], dtype=torch.int32), v,
                                         torch.from_numpy(s["price"]), objective, s["G"])
    return float(want), float(got), _bits(want) == _bits(got.numpy())


@pytest.mark.parametrize("W", [w for w in WIDTHS if w > 32])
def test_cost_min_small_catalog_matches_reference(W):
    """cost_min over 24 types (the catalog of the objectives suites), from
    W = 33 up, where the sum is XLA's reduce-window: bit for bit."""
    for seed in range(3):
        s = _state(W, 77 * W + seed, T_=24)
        want, got, same = _both_scores(s, p_solver.OBJ_COST_MIN)
        assert same, (W, seed, want, got)


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("W", WIDTHS)
def test_objective_score_matches_reference(W, objective):
    """Three seeded states a width (the third with one template, whose
    count squared passes 2^24 at W = 4152): the port's score equals the
    jitted reference's bit for bit."""
    for seed in range(3):
        s = _state(W, 1000 * W + seed, G=1 if seed == 2 else 3)
        if seed == 2:
            s["open"][:] = True
            s["base_w"], s["w_open"] = 0, W
        want, got, same = _both_scores(s, OBJECTIVES[objective])
        assert same, (W, objective, seed, want, got)


def test_objective_scores_past_2_24_round():
    """The states above reach the roundings the order decides: at W =
    4152 the pods' f32 sum and the one template's count squared pass 2^24
    (not every integer there is a float), so an exact integer sum rounded
    once is not the reference's value in general."""
    s = _state(4152, 4152 * 1000 + 2, G=1)
    s["open"][:] = True
    s["base_w"], s["w_open"] = 0, 4152
    assert int(s["pods"].astype(np.int64).sum()) > 1 << 24 and 4152 * 4152 > 1 << 24
    for objective in ("frag_aware", "topo_spread", "gang_slice"):
        assert _both_scores(s, OBJECTIVES[objective])[2]


@pytest.mark.parametrize("policy", ["cost_min", "gang_slice"])
def test_solve_fill_variants_scores_bit_for_bit(policy):
    """One small objectives round at K = 4 through both packages'
    solve_fill_variants (the reference vmaps _objective_score over the
    variants): the scores' bits and the word equal."""
    prob = _Problem(bench.selector_pods(96) + mixed_kind_pods(JS, 32))
    ranks = j_scoring.variant_ranks(j_scoring.canonical_rank(policy, prob.js.templates), 4)
    jst, pst = prob.initial()
    _spec, _jys, jw, jsc, _states, _yss, pw, psc = prob.variants(jst, pst, prob.enc["segments"], ranks,
                                                                 OBJECTIVES[policy])
    assert np.array_equal(_bits(jsc), _bits(psc.numpy())), (np.asarray(jsc).tolist(), psc.tolist())
    assert int(np.asarray(jw).reshape(-1)[0]) == int(pw[0])
