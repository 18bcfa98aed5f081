"""The port's kernels against the JAX package's, at the shapes of
tests/test_kernels.py.

On the CPU each wrapper of the port runs its plain PyTorch version; it is
held against the JAX ``ref.py`` and against the Pallas kernel run in
interpret mode, on the same inputs made from a numpy seed.  Routing and
integer-valued counts must be identical; float reductions agree within
the tolerances tests/test_kernels.py uses, because sums are taken in
another order (vht_stats, atol 1e-5) and log2 can differ by an ulp
between libraries (split_gain, atol = rtol = 1e-4).  rule_stats is
bit-identical to the JAX package's segment path, which sums in the same
order; against the one-hot oracle and the Pallas kernel, which sum in
another, it agrees within tests/test_fused.py's rtol 1e-5, atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro.kernels.rule_stats.kernel import rule_stats_pallas
from repro.kernels.rule_stats.ops import rule_moments as jax_rule_moments
from repro.kernels.rule_stats.ops import rule_stats_update as jax_rule_stats
from repro.kernels.rule_stats.ref import rule_stats_ref as jax_rule_stats_ref
from repro.kernels.split_gain.ops import split_gain as jax_split_gain
from repro.kernels.split_gain.ref import split_gain_ref as jax_split_gain_ref
from repro.kernels.tree_route.ops import tree_route as jax_tree_route
from repro.kernels.tree_route.ref import tree_route_ref as jax_tree_route_ref
from repro.kernels.vht_stats.ops import stats_update as jax_stats_update
from repro.kernels.vht_stats.ref import stats_update_ref as jax_stats_ref
from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref
from repro_torch.kernels.rule_stats.ops import (batch_sum, rule_moments,
                                                rule_stats_update)
from repro_torch.kernels.split_gain.ops import NEG, split_gain
from repro_torch.kernels.tree_route.ops import tree_route
from repro_torch.kernels.vht_stats.ops import (BUDGET, DENSE, stats_update,
                                               tile_plan)


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


@pytest.mark.parametrize("N,B,nb,C,plan", [
    (1, 512, 8, 2, (4, 1, 268)),            # one leaf: the most attributes
    (255, 512, 8, 2, (4, 64, 16704)),       # the VHT main path: 250 blocks
    (4096, 512, 8, 2, (4, 64, 17664)),      # B / 8 = 64 leaves at most
    (283, 4096, 8, 2, (4, 283, 73652)),     # the budget's edge at ja = 4
    (284, 4096, 8, 2, (2, 284, 37560)),     # one leaf more: ja = 2
    (4096, 4096, 16, 3, (1, 368, 73728)),   # two passes, the budget filled
    (64, 1024, 64, 32, (1, 8, 65808)),      # eight leaves a pass
])
def test_vht_stats_tile_plan(N, B, nb, C, plan):
    """The kernel's tiling: the most attributes a block (1, 2 or 4) for
    which the histogram's leaves, min(N, B / 8), fit in the shared-memory
    budget, and groups of leaves where they do not fit at one attribute."""
    assert tile_plan(N, B, nb, C) == plan
    assert plan[2] <= BUDGET


@pytest.mark.parametrize("N", [1, 31, 32, 33, 255, 1000, 4096, 70000])
@pytest.mark.parametrize("B,nb,C", [(1, 8, 2), (512, 8, 2), (513, 16, 3),
                                    (4096, 64, 32)])
def test_vht_stats_tile_plan_fits_its_budget(N, B, nb, C):
    """Whatever the shape: the block's bytes within the budget, 1, 2 or 4
    attributes, at least one leaf a pass, and a pass short of the
    histogram's leaves only at one attribute a block."""
    ja, group, smem = tile_plan(N, B, nb, C)
    most = min(N, max(B // DENSE, 1))
    assert smem <= BUDGET and ja in (1, 2, 4) and 1 <= group <= most
    assert group == most or ja == 1
    assert smem == 8 * ((N + 31) // 32) + 4 * most + group * ja * nb * C * 4


def test_vht_stats_tile_plan_refuses_a_leaf_that_does_not_fit():
    with pytest.raises(ValueError):
        tile_plan(255, 512, 64, 300)        # 76.8 KB of cells for one leaf
    with pytest.raises(ValueError):
        tile_plan(400_000, 512, 8, 2)       # the bitmap alone is too large


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


def _gain_inputs(N, m, nb, C, seed):
    """Sparse integer counts with whole rows of zeros and rows of one
    class mixed in, as tests/test_torch_cuda.py holds the kernel to."""
    rng = np.random.RandomState(seed)
    stats = rng.randint(0, 9, (N, m, nb, C)).astype(np.float32)
    stats *= rng.uniform(size=stats.shape) < 0.5
    rows = stats.reshape(N * m, nb, C)
    kind = rng.randint(0, 4, N * m)
    rows[kind == 0] = 0.0
    one = np.flatnonzero(kind == 1)
    rows[one] *= np.eye(C, dtype=np.float32)[rng.randint(0, C, one.size)][
        :, None, :]
    return stats


@pytest.mark.parametrize("N,m,nb,C", [(5, 7, 2, 2), (3, 11, 16, 3),
                                      (4, 9, 64, 5), (2, 13, 8, 32),
                                      (7, 5, 64, 32)])
def test_split_gain_plain_matches_jax_at_the_kernels_card_shapes(N, m, nb, C):
    """bins 2 to 64, C 2 to 32, row counts that fill no whole block of the
    card's kernel, rows of zeros and one-class rows: the NEG mask equal,
    the gains within the tolerance above."""
    stats = _gain_inputs(N, m, nb, C, seed=N * nb + C)
    out = split_gain(_t(stats)).numpy()
    for want in (jax_split_gain_ref(jnp.asarray(stats)),
                 jax_split_gain(jnp.asarray(stats), impl="pallas")):
        want = np.asarray(want)
        np.testing.assert_array_equal(out == NEG, want == NEG)
        np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)


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


# ------------------------------ rule_stats ----------------------------------

def _rule_inputs(R, m, nb, B, seed):
    """Statistics, rows in [0, R] (R is the discard row), bins and the
    (1, y, y^2) moments of targets in [-1, 1), as tests/test_fused.py
    draws them."""
    rng = np.random.RandomState(seed)
    stats = (rng.uniform(size=(R, m, nb, 3)) * 5).astype(np.float32)
    seg = rng.randint(0, R + 1, B).astype(np.int32)
    xbin = rng.randint(0, nb, (B, m)).astype(np.int32)
    y = (rng.uniform(size=B) * 2 - 1).astype(np.float32)
    return stats, seg, xbin, y


RULE_SHAPES = [(1, 11, 8, 64), (16, 11, 8, 64), (1, 5, 4, 100),
               (33, 40, 8, 256), (65, 12, 8, 510)]


@pytest.mark.parametrize("R,m,nb,B", RULE_SHAPES)
def test_rule_stats_plain_bit_identical_to_jax_segment(R, m, nb, B):
    """The JAX package's default path off the TPU: R > 1 scatters in
    instance order, R == 1 sums the batch in XLA's reduction order; the
    port follows both bit for bit, drop row included."""
    stats, seg, xbin, y = _rule_inputs(R, m, nb, B, seed=R + m + B)
    mom = rule_moments(_t(y))
    np.testing.assert_array_equal(mom.numpy(),
                                  np.asarray(jax_rule_moments(jnp.asarray(y))))
    out = rule_stats_update(_t(stats), _t(seg), _t(xbin), mom,
                            impl="segment").numpy()
    want = np.asarray(jax_rule_stats(stats, seg, xbin, mom.numpy(),
                                     impl="segment"))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("R,m,nb,B", RULE_SHAPES[:4])
def test_rule_stats_plain_matches_oracle_and_pallas(R, m, nb, B):
    """Against the one-hot oracle and the Pallas kernel in interpret mode,
    which sum in other orders: tests/test_fused.py's tolerance."""
    stats, seg, xbin, y = _rule_inputs(R, m, nb, B, seed=R * m + B)
    mom = rule_moments(_t(y))
    args = (_t(stats), _t(seg), _t(xbin), mom)
    out = rule_stats_update(*[a.clone() for a in args]).numpy()
    oracle = rule_stats_update(*args, impl="onehot").numpy()
    jargs = (stats, seg, xbin, mom.numpy())
    for want in (oracle, jax_rule_stats_ref(*jargs),
                 rule_stats_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


def test_rule_stats_plain_sums_a_full_cell_in_instance_order():
    """Every instance in one row and one bin: the plain version's passes
    over distinct cells add all B moments to the same cells, one after
    another in instance order, as JAX's segment path does."""
    stats, _, _, y = _rule_inputs(3, 4, 8, 300, seed=5)
    seg = np.zeros(300, np.int32)
    xbin = np.full((300, 4), 2, np.int32)
    mom = rule_moments(_t(y * 1000))
    out = rule_stats_update(_t(stats), _t(seg), _t(xbin), mom,
                            impl="segment").numpy()
    want = np.asarray(jax_rule_stats(stats, seg, xbin, mom.numpy(),
                                     impl="segment"))
    np.testing.assert_array_equal(out, want)


def test_rule_stats_drops_rows_and_bins_out_of_range():
    """Rows past the discard row, negative rows and bins outside [0, bins)
    change nothing; the onehot oracle drops them too."""
    stats = torch.ones((4, 3, 4, 3))
    seg = torch.tensor([4, 5, -1, 0, 1], dtype=torch.int32)
    xbin = torch.tensor([[0, 1, 2], [0, 1, 2], [0, 1, 2], [-1, 4, 7],
                         [9, -3, 4]], dtype=torch.int32)
    mom = rule_moments(torch.arange(5, dtype=torch.float32))
    for impl in ("segment", "onehot"):
        out = rule_stats_update(stats.clone(), seg, xbin, mom, impl=impl)
        torch.testing.assert_close(out, stats, rtol=0, atol=0)


def _rule_case(R, m, nb, C, B, kind, seed):
    """Inputs of the card's rule_stats cases (tests/test_torch_cuda.py):
    "random" rows in [0, R + 2] (R and past it: dropped) and bins in
    [-1, nb] (the ends dropped); "skewed" seven in ten instances in the
    last row, as AMRules' default rule takes most of a batch; "one-cell"
    every instance in row 3 and bin nb - 1; "discard" every row R or past
    it."""
    rng = np.random.RandomState(seed)
    stats = (rng.uniform(size=(R, m, nb, C)) * 5).astype(np.float32)
    seg = rng.randint(0, R + 3, B)
    xbin = rng.randint(-1, nb + 1, (B, m))
    if kind == "skewed":
        seg = np.where(rng.uniform(size=B) < 0.7, R - 1, rng.randint(0, R, B))
        xbin = rng.randint(0, nb, (B, m))
    elif kind == "one-cell":
        seg, xbin = np.full(B, min(3, R - 1)), np.full((B, m), nb - 1)
    elif kind == "discard":
        seg = rng.choice([R, R + 1, R + 7], B)
    mom = (rng.randn(B, C) * 2).astype(np.float32)
    return stats, seg.astype(np.int32), xbin.astype(np.int32), mom


RULE_CASES = [(65, 4, 8, 3, 512, "one-cell"), (65, 4, 8, 3, 512, "discard"),
              (65, 40, 8, 3, 1, "random"), (16, 12, 8, 3, 2049, "skewed"),
              (1, 3, 4, 3, 2049, "one-cell"), (300, 3, 16, 1, 256, "random"),
              (33, 5, 8, 8, 300, "random"), (65, 1, 1, 3, 512, "skewed")]


@pytest.mark.parametrize("R,m,nb,C,B,kind", RULE_CASES)
def test_rule_stats_plain_bit_identical_to_jax_at_the_kernels_card_cases(
        R, m, nb, C, B, kind):
    """The cases the card's kernel is held to: one cell, the discard row,
    B = 1, more instances than one tile (2049), more cells than one block
    ([300, 3, 16, 1]), C = 1 and 8, the per-rule sums' shape; bit for bit
    the JAX package's segment path."""
    stats, seg, xbin, mom = _rule_case(R, m, nb, C, B, kind, seed=R + B + C)
    out = rule_stats_update(_t(stats), _t(seg), _t(xbin), _t(mom),
                            impl="segment").numpy()
    want = np.asarray(jax_rule_stats(stats, seg, xbin, mom, impl="segment"))
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


def _cf_case(K, C, B, kind, seed):
    """CluStream's CF scatter: K + 1 segments (K the discard) of C columns,
    B rows.  "one": every row in one segment; "blob": as a blob stream
    spreads a batch (13 % discarded into segment K, 70 % of the rest in 8
    segments); "random": ids in [0, K + 2], the two past K dropped."""
    rng = np.random.RandomState(seed)
    if kind == "one":
        seg = np.full(B, 5)
    elif kind == "blob":
        seg = np.where(rng.uniform(size=B) < 0.13, K, np.where(
            rng.uniform(size=B) < 0.7, rng.randint(0, 8, B) * (K // 8),
            rng.randint(0, K, B)))
    else:
        seg = rng.randint(0, K + 3, B)
    vals = (rng.randn(B, C) * 2).astype(np.float32)
    old = rng.randn(K + 1, C).astype(np.float32)
    return seg.astype(np.int32), vals, old


@pytest.mark.parametrize("K,C,B,kind", [
    (256, 256, 512, "one"), (256, 256, 512, "blob"), (256, 256, 2048, "blob"),
    (256, 256, 16, "blob"), (100, 64, 512, "one"), (100, 64, 512, "blob"),
    (100, 64, 16, "one"), (100, 33, 1100, "random"), (256, 33, 512, "random")])
def test_cf_scatter_plain_bit_identical_to_jax_segment_sum(K, C, B, kind):
    """The yardstick of the wide segment_sum on the card: the plain scatter
    at CluStream's CF shapes (d128-K256: 257 segments of 256 columns;
    d32-K100: 101 of 64), with every row in one segment and with a blob
    stream's skew, more than one tile (2048), the small-batch size (16) and
    33 columns, bit for bit ``jax.ops.segment_sum`` from zeros
    (repro/ml/clustream.py:142) and XLA's scatter-add onto old sums."""
    seg, vals, old = _cf_case(K, C, B, kind, seed=K + C + B)
    xb = torch.zeros((B, 1), dtype=torch.int32)
    for start, want in (
            (np.zeros_like(old), jax.ops.segment_sum(
                jnp.asarray(vals), jnp.asarray(seg), num_segments=K + 1)),
            (old, jnp.asarray(old).at[jnp.asarray(seg)].add(
                jnp.asarray(vals)))):
        got = rule_stats_scatter_ref(_t(start).view(K + 1, 1, 1, C),
                                     _t(seg), xb, _t(vals)).view(K + 1, C)
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", [(20,), (256,), (510,), (512,), (1100,),
                                   (2, 128), (2, 256), (3, 170)])
def test_batch_sum_bit_identical_to_jax_sum(shape):
    """A whole-array sum in XLA's CPU order: windows of 32 (padded half in
    front), each summed from 0, then the window sums; 2-D arrays as the
    HAMR error sums are."""
    rng = np.random.RandomState(len(shape) * 1000 + shape[-1])
    a = (rng.randn(*shape) * 100).astype(np.float32)
    b = (rng.randn(*shape) * 0.01).astype(np.float32)
    got = batch_sum(_t(np.stack([a.reshape(-1), b.reshape(-1)], -1)), shape)
    for k, x in enumerate((a, b)):
        want = np.asarray(jax.jit(lambda v: v.sum())(x))
        assert got[k].numpy() == want, (k, got[k].item(), want)
