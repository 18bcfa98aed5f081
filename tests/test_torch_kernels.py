"""The port's kernels against the JAX package's, at the shapes of
tests/test_kernels.py.

On the CPU each wrapper of the port runs its plain PyTorch version; it is
held against the JAX ``ref.py`` and against the Pallas kernel run in
interpret mode, on the same inputs made from a numpy seed.  Routing and
integer-valued counts must be identical; float reductions agree within
the tolerances tests/test_kernels.py uses, because sums are taken in
another order (vht_stats, atol 1e-5) and log2 can differ by an ulp
between libraries (split_gain, atol = rtol = 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.split_gain.ops import split_gain as jax_split_gain
from repro.kernels.split_gain.ref import split_gain_ref as jax_split_gain_ref
from repro.kernels.tree_route.ops import tree_route as jax_tree_route
from repro.kernels.tree_route.ref import tree_route_ref as jax_tree_route_ref
from repro.kernels.vht_stats.ops import stats_update as jax_stats_update
from repro.kernels.vht_stats.ref import stats_update_ref as jax_stats_ref
from repro_torch.kernels.split_gain.ops import NEG, split_gain
from repro_torch.kernels.tree_route.ops import tree_route
from repro_torch.kernels.vht_stats.ops import stats_update


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------ vht_stats -----------------------------------

def _stats_inputs(N, m, nb, C, B, seed, *, integer=False, weights="mixed"):
    rng = np.random.RandomState(seed)
    if integer:
        stats = rng.randint(0, 50, (N, m, nb, C)).astype(np.float32)
    else:
        stats = (rng.uniform(size=(N, m, nb, C)) * 5).astype(np.float32)
    leaf = rng.randint(0, N, B).astype(np.int32)
    xbin = rng.randint(0, nb, (B, m)).astype(np.int32)
    y = rng.randint(0, C, B).astype(np.int32)
    if weights == "mixed":                 # 0/1, as the wok variant sheds
        w = np.where(np.arange(B) % 3 == 0, 0.0, 1.0).astype(np.float32)
    else:
        w = rng.uniform(size=B).astype(np.float32)
    return stats, leaf, xbin, y, w


@pytest.mark.parametrize("N,m,nb,C,B", [
    (16, 8, 4, 2, 32),
    (32, 20, 8, 3, 64),
    (64, 33, 8, 7, 128),
    (8, 5, 16, 2, 16),
])
def test_vht_stats_plain_matches_jax(N, m, nb, C, B):
    args = _stats_inputs(N, m, nb, C, B, seed=N + m)
    stats = _t(args[0])
    out = stats_update(stats, *map(_t, args[1:]))
    assert out is stats                               # updated in place
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_stats_ref(*jargs),
                 jax_stats_update(*jargs, impl="pallas")):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("weights", ["mixed", "fractional"])
def test_vht_stats_counts(weights):
    """0/1 weights on integer counts are exact in any summation order;
    fractional weights agree to the order of the sum (atol 1e-5)."""
    args = _stats_inputs(32, 20, 8, 2, 64, seed=5, integer=True,
                         weights=weights)
    out = stats_update(_t(args[0]), *map(_t, args[1:])).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_stats_ref(*jargs),
                 jax_stats_update(*jargs, impl="pallas")):
        if weights == "mixed":
            np.testing.assert_array_equal(out, np.asarray(want))
        else:
            np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)


def test_vht_stats_weight_zero_is_noop():
    stats = torch.ones((8, 4, 4, 2))
    out = stats_update(stats.clone(), torch.zeros(16, dtype=torch.int32),
                       torch.zeros((16, 4), dtype=torch.int32),
                       torch.zeros(16, dtype=torch.int32), torch.zeros(16))
    torch.testing.assert_close(out, stats, rtol=0, atol=0)


# ------------------------------ split_gain ----------------------------------

@pytest.mark.parametrize("N,m,nb,C", [
    (16, 8, 4, 2),
    (33, 17, 8, 3),
    (64, 32, 8, 7),
])
def test_split_gain_plain_matches_jax(N, m, nb, C):
    rng = np.random.RandomState(N * m)
    stats = (rng.uniform(size=(N, m, nb, C)) * 10).astype(np.float32)
    out = split_gain(_t(stats)).numpy()
    for want in (jax_split_gain_ref(jnp.asarray(stats)),
                 jax_split_gain(jnp.asarray(stats), impl="pallas")):
        np.testing.assert_allclose(out, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_split_gain_sparse_counts_match_jax():
    """Integer counts with many empty bins, as the tree's leaves hold them:
    the NEG mask and the p > 0 terms agree exactly in where they apply."""
    rng = np.random.RandomState(11)
    stats = rng.randint(0, 4, (16, 20, 8, 2)).astype(np.float32)
    stats *= rng.uniform(size=stats.shape) < 0.4
    out = split_gain(_t(stats)).numpy()
    want = np.asarray(jax_split_gain_ref(jnp.asarray(stats)))
    np.testing.assert_array_equal(out == NEG, want == NEG)
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)


def test_split_gain_empty_stats_invalid():
    g = split_gain(torch.zeros((4, 3, 4, 2)))
    assert float(g.max()) <= -1e29


# ------------------------------ tree_route ----------------------------------

def random_trees(M, N, m, nb, seed):
    """M valid trees in node pools of N: leaves split into two fresh
    children, at random, until the pool is full."""
    rng = np.random.RandomState(seed)
    sa = np.full((M, N), -1, np.int32)
    sb = np.zeros((M, N), np.int32)
    ch = np.zeros((M, N, 2), np.int32)
    for t in range(M):
        n_nodes, leaves = 1, [0]
        for _ in range((N - 1) // 2):
            node = leaves.pop(rng.randint(len(leaves)))
            sa[t, node] = rng.randint(m)
            sb[t, node] = rng.randint(nb)
            ch[t, node] = (n_nodes, n_nodes + 1)
            leaves += [n_nodes, n_nodes + 1]
            n_nodes += 2
    return sa, sb, ch


@pytest.mark.parametrize("M", [1, 3])
def test_tree_route_plain_matches_jax(M):
    N, m, nb, B, depth = 31, 12, 8, 64, 24
    sa, sb, ch = random_trees(M, N, m, nb, seed=M)
    xbin = np.random.RandomState(M + 10).randint(0, nb, (B, m)).astype(np.int32)
    out = tree_route(_t(sa), _t(sb), _t(ch), _t(xbin), max_depth=depth)
    assert out.dtype == torch.int32 and out.shape == (M, B)
    j = [jnp.asarray(a) for a in (sa, sb, ch, xbin)]
    for want in (jax_tree_route_ref(*j, depth),
                 jax_tree_route(*j, max_depth=depth, impl="gather"),
                 jax_tree_route(*j, max_depth=depth, impl="pallas")):
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    single = tree_route(_t(sa[0]), _t(sb[0]), _t(ch[0]), _t(xbin),
                        max_depth=depth)
    np.testing.assert_array_equal(single.numpy(), out[0].numpy())


def test_tree_route_depth_cut_matches_jax():
    """A tree deeper than max_depth: routing stops where the reference
    stops, at an inner node."""
    N, m, nb, B = 63, 6, 4, 32
    sa, sb, ch = random_trees(2, N, m, nb, seed=3)
    xbin = np.random.RandomState(4).randint(0, nb, (B, m)).astype(np.int32)
    out = tree_route(_t(sa), _t(sb), _t(ch), _t(xbin), max_depth=2)
    want = jax_tree_route_ref(*[jnp.asarray(a) for a in (sa, sb, ch, xbin)], 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
