"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main paths' shapes (VHT: B = 512, m = 1000, N = 255,
bins = 8, C = 2; AMRules: [65, 40, 8, 3], B = 512; the LM prefill:
selective_scan at B = 4, S = 2048, dI = 8192, N = 16, flash_attention at
B = 4, S = 2048, 20 heads of 128) and at small shapes, and the LM SMOKE
models on the card against their plain runs; the compiled steps
(core/compiled.py) as CUDA graphs against the eager steps, bit for bit,
with no sync in any replay; and the ensembles' split_poisson kernel
against its plain version, the OzaBag, OzaBoost and ShardingEnsemble steps
compiled against eager, and a short last batch compiled against eager;
the rule_stats kernel's wide form (segment_sum with up to 4096 columns:
CluStream's CF scatter) against its plain version, CluStream d32-K100 on
the chunked runtime eager, compiled and plain alike, a checkpointed
kill/resume on the card, and a capture that another thread's staging of
chunks does not invalidate; train while serving: the pipelined driver
waiting on events (no device-wide wait off the main thread) while a
ModelServer answers, a snapshot unchanged across compiled chunks, a
short batch's capture while the server answers, the predict fast path
against the plain one, and a capture that survives the garbage collector
freeing another graph; the fleet forms of tree_route (a batch per tree,
a tree per row) and of segment_sum (a sum per tenant) against their plain
versions at a fleet of 1000 tenants and at other shapes, and fleets of
VHT and CluStream on the card: compiled against eager against the plain
versions, each tenant's row against its learner alone, the predict and
the server by tenant.  Every test here is marked
``cuda`` and skips without a CUDA device; the file imports nothing of JAX,
so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rule_stats.ops import (MAX_COLUMNS, batch_sum,
                                                rule_moments,
                                                rule_stats_scatter,
                                                rule_stats_update,
                                                segment_sum)
from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.split_gain.ops import NEG, split_gain
from repro_torch.kernels.split_gain.ref import split_gain_ref
from repro_torch.kernels.tree_route.ops import tree_route
from repro_torch.kernels.tree_route.ref import tree_route_ref
from repro_torch.kernels.vht_stats.ops import stats_update, tile_plan
from repro_torch.kernels.vht_stats.ref import stats_update_ref


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launches()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5])
def test_tree_route_kernel_matches_plain(cuda, M):
    sa, sb, ch = random_trees(M, 255, 1000, 8, seed=M)
    xbin = np.random.RandomState(0).randint(0, 8, (512, 1000)).astype(np.int32)
    args = [_t(a).to(cuda) for a in (sa, sb, ch, xbin)]
    out = tree_route(*args, max_depth=24)
    torch.testing.assert_close(out, tree_route_ref(*args, 24), rtol=0, atol=0)
    assert launches()["tree_route"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["mixed", "fractional"])
def test_vht_stats_kernel_matches_plain(cuda, weights):
    rng = np.random.RandomState(1)
    B, m = 512, 1000
    if weights == "mixed":              # 0/1 on integer counts: exact
        stats = rng.randint(0, 50, (255, m, 8, 2)).astype(np.float32)
        w = (rng.uniform(size=B) < 0.8).astype(np.float32)
    else:                               # the order of the sums differs
        stats = (rng.uniform(size=(255, m, 8, 2)) * 5).astype(np.float32)
        w = rng.uniform(size=B).astype(np.float32)
    args = (stats, rng.randint(0, 255, B).astype(np.int32),
            rng.randint(0, 8, (B, m)).astype(np.int32),
            rng.randint(0, 2, B).astype(np.int32), w)
    stats, *rest = [_t(a).to(cuda) for a in args]
    out = stats_update(stats.clone(), *rest)
    want = stats_update_ref(stats.clone(), *rest)
    tol = 0.0 if weights == "mixed" else 1e-5
    torch.testing.assert_close(out, want, rtol=0, atol=tol)
    assert launches()["vht_stats"] == 1


def _vht_case(N, m, nb, C, B, kind, seed):
    """Integer counts and 0/1 weights (exact in any order of the sums):
    "random" leaves, bins and classes (a batch over many leaves, which the
    kernel adds hit by hit); "few" leaves in [0, 20) and "grouped" in
    [0, 40) (summed in the histogram, "grouped" in several passes);
    "one-cell" every instance in leaf 7 and bin nb - 1; "distinct" B = N
    instances, each in its own leaf; "zero" all weights 0; "out-of-range"
    leaves in [-2, N + 2), bins in [-1, nb] and classes in [-1, C], all out
    of range but those dropped; "fractional" few leaves, fractional counts
    and weights."""
    rng = np.random.RandomState(seed)
    stats = rng.randint(0, 50, (N, m, nb, C)).astype(np.float32)
    leaf = rng.randint(0, N, B)
    xbin = rng.randint(0, nb, (B, m))
    y = rng.randint(0, C, B)
    w = (rng.uniform(size=B) < 0.8).astype(np.float32)
    if kind in ("few", "grouped", "fractional"):
        leaf = rng.randint(0, min(N, 20 if kind != "grouped" else 40), B)
    if kind == "fractional":
        stats = (rng.uniform(size=stats.shape) * 5).astype(np.float32)
        w = rng.uniform(size=B).astype(np.float32)
    elif kind == "one-cell":
        leaf, xbin = np.full(B, min(7, N - 1)), np.full((B, m), nb - 1)
    elif kind == "distinct":
        leaf = rng.permutation(N)[:B]
    elif kind == "zero":
        w[:] = 0.0
    elif kind == "out-of-range":
        leaf = rng.randint(-2, N + 2, B)
        xbin = rng.randint(-1, nb + 1, (B, m))
        y = rng.randint(-1, C + 1, B)
    return (stats, leaf.astype(np.int32), xbin.astype(np.int32),
            y.astype(np.int32), w)


def _vht_oracle(stats, leaf, xbin, y, w):
    """The update with out-of-range leaves, bins and classes dropped, by a
    masked index_add_ on the CPU (the plain version takes only ids in
    range)."""
    stats, leaf, xbin, y, w = (a.cpu() for a in (stats, leaf, xbin, y, w))
    N, m, nb, C = stats.shape
    keep = (w != 0) & (leaf >= 0) & (leaf < N) & (y >= 0) & (y < C)
    i, j = (keep[:, None] & (xbin >= 0) & (xbin < nb)).nonzero(as_tuple=True)
    flat = ((leaf[i].long() * m + j) * nb + xbin[i, j].long()) * C \
        + y[i].long()
    return stats.clone().view(-1).index_add_(0, flat, w[i]).view(N, m, nb, C)


VHT_CASES = [(255, 1000, 8, 2, 512, "one-cell"),
             (255, 1000, 8, 2, 255, "distinct"),
             (255, 100, 8, 2, 512, "zero"),
             (255, 40, 8, 2, 512, "out-of-range"),
             (255, 1, 8, 2, 512, "random"), (255, 1, 8, 2, 512, "few"),
             (255, 999, 8, 2, 512, "random"), (255, 999, 8, 2, 513, "few"),
             (255, 1000, 8, 2, 1, "random"), (255, 1000, 8, 2, 513, "random"),
             (255, 200, 16, 3, 512, "random"), (255, 200, 16, 3, 512, "few"),
             (255, 50, 5, 3, 512, "few"), (1, 30, 8, 2, 512, "random"),
             (64, 5, 64, 32, 1024, "grouped"),
             (255, 1000, 8, 2, 512, "fractional")]


@pytest.mark.cuda
@pytest.mark.parametrize("N,m,nb,C,B,kind", VHT_CASES)
def test_vht_stats_kernel_exact_at_edge_cases(cuda, N, m, nb, C, B, kind):
    """One leaf and one bin, 255 distinct leaves, all weights 0, ids out of
    range, m = 1 and 999 (not a multiple of the tile), B = 1 and 513, bins
    x C = 16 x 3 and 5 x 3 (cells that are not a multiple of four), a
    one-leaf pool, and [64, 5, 64, 32] at B = 1024 over
    40 leaves, more than one pass of the histogram holds; batches over
    many leaves and over few: equal to the plain version (the masked
    oracle for ids out of range), bit for bit; fractional weights within
    1e-5 (another order of the sums)."""
    args = [_t(a).to(cuda) for a in _vht_case(N, m, nb, C, B, kind,
                                              seed=N + m + B)]
    stats, rest = args[0], args[1:]
    if kind == "grouped":       # the leaf-group loop runs five times
        assert tile_plan(N, B, nb, C)[1] * 5 == int(
            torch.unique(rest[0]).numel())
    out = stats_update(stats.clone(), *rest)
    if kind == "out-of-range":
        want = _vht_oracle(stats, *rest).to(cuda)
    else:
        want = stats_update_ref(stats.clone(), *rest)
    tol = 1e-5 if kind == "fractional" else 0.0
    torch.testing.assert_close(out, want, rtol=0, atol=tol)
    assert launches()["vht_stats"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["few", "random"])
def test_vht_stats_kernel_unaligned_inputs(cuda, kind):
    """stats and xbin views that start 4 bytes past a 16-byte boundary take
    the 4-byte loads and atomic adds and give the same bits."""
    stats, leaf, xbin, y, w = _vht_case(255, 40, 8, 2, 512, kind, seed=3)

    def shifted(a):
        flat = torch.zeros(a.size + 1, dtype=torch.from_numpy(a).dtype,
                           device=cuda)
        flat[1:] = _t(a.reshape(-1)).to(cuda)
        return flat[1:].view(a.shape)
    stats, xbin = shifted(stats), shifted(xbin)
    assert stats.data_ptr() % 16 != 0 and xbin.data_ptr() % 16 != 0
    leaf, y, w = (_t(a).to(cuda) for a in (leaf, y, w))
    want = stats_update_ref(stats.clone(), leaf, xbin, y, w)
    out = stats_update(stats, leaf, xbin, y, w)     # in place, on the view
    assert out.data_ptr() == stats.data_ptr()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert launches()["vht_stats"] == 1


@pytest.mark.cuda
def test_vht_stats_kernel_plan_is_the_wrappers(cuda):
    """csrc/vht_stats.cu's tiling equals ops.tile_plan's, and both refuse
    a shape whose single leaf does not fit."""
    import ctypes
    from repro_torch.kernels import _build
    fn = _build.function("vht_stats", "vht_stats_plan",
                         (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    out = (ctypes.c_int * 3)()
    for N, B, nb, C in [(1, 512, 8, 2), (255, 512, 8, 2), (4096, 512, 8, 2),
                        (4096, 4096, 16, 3), (283, 4096, 8, 2),
                        (284, 4096, 8, 2), (255, 1, 8, 2), (64, 1024, 64, 32),
                        (9000, 9000, 4, 2)]:
        assert fn(N, B, nb, C, ctypes.addressof(out)) == 0
        assert tuple(out) == tile_plan(N, B, nb, C)
    assert fn(255, 512, 64, 300, ctypes.addressof(out)) != 0
    with pytest.raises(ValueError):
        tile_plan(255, 512, 64, 300)


def _chain(N, m, seed):
    """A chain of (N - 1) / 2 inner nodes, each with a leaf on its left and
    the next inner node on its right, deeper than max_depth = 24."""
    rng = np.random.RandomState(seed)
    sa = np.full((1, N), -1, np.int32)
    sb = np.zeros((1, N), np.int32)
    ch = np.zeros((1, N, 2), np.int32)
    for k in range((N - 1) // 2):
        node = 2 * k
        sa[0, node], sb[0, node] = rng.randint(m), rng.randint(-1, 2)
        ch[0, node] = (node + 1, node + 2)
    return sa, sb, ch


ROUTE_CASES = [(5, 51, 1000, 512, "random"), (1, 1, 1000, 512, "random"),
               (1, 121, 1000, 512, "chain"), (1, 255, 1000, 1, "random"),
               (1, 255, 1000, 513, "random"), (3, 63, 1, 512, "random"),
               (1, 1023, 1000, 512, "random"),
               (2, 14527, 1000, 64, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,m,B,kind", ROUTE_CASES)
def test_tree_route_kernel_exact_at_edge_cases(cuda, M, N, m, B, kind):
    """M = 5 trees of 51 nodes, a one-node tree, a chain deeper than
    max_depth (the cut stops at an inner node), B = 1 and 513, m = 1,
    N = 1023, and N = 14527, the most nodes the first kernel's 16 bytes a
    node took in shared memory: the plain version's leaf ids."""
    if kind == "chain":
        sa, sb, ch = _chain(N, m, seed=N)
    else:
        sa, sb, ch = random_trees(M, N, m, 8, seed=M + N)
    xbin = np.random.RandomState(B).randint(0, 8, (B, m)).astype(np.int32)
    args = [_t(a).to(cuda) for a in (sa, sb, ch, xbin)]
    out = tree_route(*args, max_depth=24)
    torch.testing.assert_close(out, tree_route_ref(*args, 24), rtol=0, atol=0)
    assert launches()["tree_route"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 255])
def test_split_gain_kernel_matches_plain(cuda, N):
    rng = np.random.RandomState(N)
    stats = _t(rng.randint(0, 30, (N, 1000, 8, 2)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(split_gain(stats), split_gain_ref(stats),
                               rtol=1e-4, atol=1e-4)
    assert launches()["split_gain"] == 1


def _gain_inputs(N, m, nb, C, seed):
    """Sparse integer counts with whole rows of zeros and rows of one
    class mixed in."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [2, 8, 16, 64])
@pytest.mark.parametrize("C", [2, 3, 5, 32])
def test_split_gain_kernel_edge_shapes(cuda, nb, C):
    """bins 2 to 64 and C 2 to 32 on 7 x 37 rows (no whole number of
    blocks), with rows of zeros and one-class rows: the NEG mask equal,
    the gains within atol = rtol = 1e-4 of the plain version."""
    stats = _t(_gain_inputs(7, 37, nb, C, seed=nb * C)).to(cuda)
    got, want = split_gain(stats), split_gain_ref(stats)
    assert torch.equal(got == NEG, want == NEG)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert launches()["split_gain"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,m,nb,C", [(160, 1000, 8, 3), (140, 1000, 4, 5),
                                      (136, 1000, 2, 32)])
def test_split_gain_kernel_many_rows(cuda, N, m, nb, C):
    """Enough rows for one thread per row (rows of up to 47 words), and a
    wider row that takes a thread per (row, bin) at any row count."""
    stats = _t(_gain_inputs(N, m, nb, C, seed=N + C)).to(cuda)
    got, want = split_gain(stats), split_gain_ref(stats)
    assert torch.equal(got == NEG, want == NEG)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_split_gain_kernel_unaligned_rows(cuda):
    """Rows of 2 x 3 counts (24 bytes) from a view one row in: blocks
    start off a 16-byte boundary and take the 4-byte copies."""
    stats = _t(_gain_inputs(9, 50, 2, 3, seed=4)).to(cuda)
    view = stats.view(-1, 2, 3)[1:].view(-1, 1, 2, 3)
    assert view.data_ptr() % 16 != 0
    got, want = split_gain(view), split_gain_ref(view)
    assert torch.equal(got == NEG, want == NEG)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _bits(t):
    return (t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32)
            else t)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 510])
def test_rule_stats_kernel_bit_identical_to_plain(cuda, B):
    """Both sum each cell in instance order from its old value: exact, the
    discard row 65 and the rows past it dropped."""
    rng = np.random.RandomState(B)
    stats = _t((rng.uniform(size=(65, 40, 8, 3)) * 5).astype(np.float32))
    seg = _t(rng.randint(0, 67, B).astype(np.int32))
    xbin = _t(rng.randint(0, 8, (B, 40)).astype(np.int32))
    mom = rule_moments(_t((rng.randn(B) * 2).astype(np.float32)))
    stats, seg, xbin, mom = (a.to(cuda) for a in (stats, seg, xbin, mom))
    out = rule_stats_scatter(stats.clone(), seg, xbin, mom)
    want = rule_stats_scatter_ref(stats.clone(), seg, xbin, mom)
    assert torch.equal(_bits(out), _bits(want))
    assert launches()["rule_stats"] == 1


@pytest.mark.cuda
def test_rule_stats_default_rule_path_and_batch_sum_match_plain(cuda):
    """The R == 1 branch (window sums by the kernel) and the whole-batch
    sums in XLA's order give the plain version's bits."""
    rng = np.random.RandomState(7)
    stats = _t((rng.uniform(size=(1, 40, 8, 3)) * 5).astype(np.float32))
    seg = _t(rng.randint(0, 2, 512).astype(np.int32))
    xbin = _t(rng.randint(0, 8, (512, 40)).astype(np.int32))
    mom = rule_moments(_t(rng.randn(512).astype(np.float32)))
    vals = _t(rng.randn(512, 4).astype(np.float32))
    stats, seg, xbin, mom, vals = (a.to(cuda)
                                   for a in (stats, seg, xbin, mom, vals))
    out = rule_stats_update(stats.clone(), seg, xbin, mom)
    want = rule_stats_update(stats.clone(), seg, xbin, mom,
                             scatter=rule_stats_scatter_ref)
    assert torch.equal(_bits(out), _bits(want))
    for shape in [(512,), (2, 256)]:
        got = batch_sum(vals, shape)
        assert torch.equal(_bits(got), _bits(
            batch_sum(vals, shape, scatter=rule_stats_scatter_ref)))
    # one launch for the R == 1 window sums (their sums are the plain
    # version's), two levels of windows for each batch sum
    assert launches()["rule_stats"] == 1
    assert launches()["segment_sum"] == 2 * 2


def _rule_case(R, m, nb, C, B, kind, seed):
    """"random" rows in [0, R + 2] (R and past it: dropped) and bins in
    [-1, nb] (the ends dropped); "skewed" seven in ten instances in the
    last row, as AMRules' default rule takes most of a batch; "one-cell"
    every instance in row 3 and bin nb - 1; "discard" every row R or past
    it.  The same cases as tests/test_torch_kernels.py's, which holds the
    plain version to the JAX package on them."""
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
              (33, 5, 8, 8, 300, "random"), (65, 40, 8, 3, 512, "skewed"),
              (65, 13, 8, 3, 510, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("R,m,nb,C,B,kind", RULE_CASES)
def test_rule_stats_kernel_bit_identical_at_edge_cases(cuda, R, m, nb, C, B,
                                                       kind):
    """One cell, the discard row and past it, B = 1, lists that carry
    across tiles (B = 2049), more cells than one block ([300, 3, 16, 1]),
    C = 1 and 8, an m that is not a multiple of 4 (4-byte copies)."""
    args = [_t(a).to(cuda) for a in _rule_case(R, m, nb, C, B, kind,
                                               seed=R + B + C)]
    stats, rest = args[0], args[1:]
    out = rule_stats_scatter(stats.clone(), *rest)
    want = rule_stats_scatter_ref(stats.clone(), *rest)
    assert torch.equal(_bits(out), _bits(want))
    assert launches()["rule_stats"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C,B,kind", [
    (65, 3, 512, "random"), (65, 3, 512, "skewed"), (65, 3, 512, "one-cell"),
    (16, 4, 512, "windows"), (1, 4, 16, "windows"), (66, 3, 2049, "skewed")])
def test_segment_sum_kernel_bit_identical(cuda, rows, C, B, kind):
    """The AMRules reductions through segment_sum: the per-rule sums
    [65, 1, 1, 3] and the batch sum's levels [16, 1, 1, 4] and
    [1, 1, 1, 4] with their window ids, from zeros as AMRules calls them."""
    from repro_torch.kernels.rule_stats.ref import xla_windows
    _, seg, _, vals = _rule_case(rows, 1, 1, C, B, kind, seed=rows * C + B)
    seg, vals = _t(seg).to(cuda), _t(vals).to(cuda)
    if kind == "windows":       # level 1: 512 into 16; level 2: 16 into 1
        seg, = [ids for ids, _, n in xla_windows((512,), cuda) if n == rows]
    xb = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
    zeros = torch.zeros((rows, 1, 1, C), device=cuda)
    out = segment_sum(zeros.clone(), seg, xb, vals)
    want = rule_stats_scatter_ref(zeros.clone(), seg, xb, vals)
    assert torch.equal(_bits(out), _bits(want))
    assert launches()["segment_sum"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 9, 256])
@pytest.mark.parametrize("B", [16, 512])
def test_segment_sum_wide_columns_bit_identical(cuda, C, B):
    """CluStream's CF scatter through segment_sum: K + 1 = 257 segments,
    K the discard, with ids that take it; C = 9 and 256 take the kernel's
    wide form (a thread per (segment, column)), C <= 8 its register form.
    From zeros as CluStream calls it, and onto old sums."""
    rng = np.random.RandomState(C * 1000 + B)
    K = 256
    seg = rng.randint(0, K + 1, B).astype(np.int32)
    seg[::7] = K                                  # the discard segment
    vals = (rng.randn(B, C) * 3).astype(np.float32)
    seg, vals = _t(seg).to(cuda), _t(vals).to(cuda)
    xb = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
    old = _t(rng.randn(K + 1, 1, 1, C).astype(np.float32)).to(cuda)
    for start in (torch.zeros_like(old), old):
        out = segment_sum(start.clone(), seg, xb, vals)
        want = rule_stats_scatter_ref(start.clone(), seg, xb, vals)
        assert torch.equal(_bits(out), _bits(want))
    assert launches()["segment_sum"] == 2
    assert segment_sum.wide_launches == (2 if C > 8 else 0)


def _wide_ids(rng, R, m, nb, B, kind):
    """Rows and bins of a wide-form case: "random" rows in [-1, R + 1] and
    bins in [-1, nb] (the ends dropped); "one" every row in one segment
    (all in one chain); "blob" as a blob stream spreads a batch over
    CluStream's K + 1 = R segments (13 % discarded into the last, 70 % of
    the rest in 8 segments)."""
    if kind == "random":
        return (rng.randint(-1, R + 2, B),
                rng.randint(-1, nb + 1, (B, m)))
    if kind == "one":
        seg = np.full(B, min(5, R - 1))
    else:
        seg = np.where(rng.uniform(size=B) < 0.13, R - 1, np.where(
            rng.uniform(size=B) < 0.7, rng.randint(0, 8, B) * (R // 8),
            rng.randint(0, R - 1, B)))
    return seg, rng.randint(0, nb, (B, m))


@pytest.mark.cuda
@pytest.mark.parametrize("R,m,nb,C,B,kind", [
    pytest.param(9, 3, 4, 20, 1100, "random", id="9-3-4-20-1100"),
    pytest.param(300, 2, 1, 70, 64, "random", id="300-2-1-70-64"),
    pytest.param(5, 1, 3, 4096, 40, "random", id="5-1-3-4096-40"),
    (257, 1, 1, 256, 512, "one"), (257, 1, 1, 256, 512, "blob"),
    (257, 1, 1, 256, 2048, "blob"), (257, 1, 1, 256, 2048, "one"),
    (101, 1, 1, 64, 512, "blob"), (101, 1, 1, 64, 512, "one"),
    (101, 1, 1, 33, 512, "blob"), (257, 1, 1, 33, 1100, "random"),
    (257, 1, 1, 256, 16, "blob"), (101, 1, 1, 64, 16, "one")])
def test_rule_stats_wide_form_at_other_shapes(cuda, R, m, nb, C, B, kind):
    """The wide form with several attributes and bins, more than one tile
    (1100 and 2048 rows), more cells than a block takes (257, 300), the
    small-batch path (B <= 64) and the most columns it takes; CluStream's
    CF scatter shapes (d128-K256: 257 segments of 256 columns; d32-K100:
    101 of 64) with every row in one segment and with a blob stream's
    skew; 33 columns, whose second slab is one column wide; rows and bins
    out of range dropped.  From zeros, as CluStream calls it, and onto old
    sums.  One column more than it takes raises."""
    rng = np.random.RandomState(R + C + B)
    seg, xbin = _wide_ids(rng, R, m, nb, B, kind)
    seg = _t(seg.astype(np.int32)).to(cuda)
    xbin = _t(xbin.astype(np.int32)).to(cuda)
    vals = _t((rng.randn(B, C) * 2).astype(np.float32)).to(cuda)
    old = _t(rng.randn(R, m, nb, C).astype(np.float32)).to(cuda)
    for stats in (torch.zeros_like(old), old):
        out = segment_sum(stats.clone(), seg, xbin, vals)
        want = rule_stats_scatter_ref(stats.clone(), seg, xbin, vals)
        assert torch.equal(_bits(out), _bits(want))
    wide = MAX_COLUMNS + 1
    with pytest.raises(ValueError, match="columns"):
        segment_sum(torch.zeros((R, m, nb, wide), device=cuda), seg, xbin,
                    torch.zeros((B, wide), device=cuda))


@pytest.mark.cuda
def test_rule_stats_kernel_unaligned_inputs(cuda):
    """Inputs that start off a 16-byte boundary (views one row in) take
    the 4-byte copies and give the same bits."""
    stats, seg, xbin, mom = _rule_case(65, 40, 8, 3, 513, "random", seed=9)
    stats = _t(stats).to(cuda)
    seg, xbin, mom = (_t(a).to(cuda)[1:] for a in (seg, xbin, mom))
    assert mom.data_ptr() % 16 != 0 and seg.data_ptr() % 16 != 0
    out = rule_stats_scatter(stats.clone(), seg, xbin, mom)
    want = rule_stats_scatter_ref(stats.clone(), seg, xbin, mom)
    assert torch.equal(_bits(out), _bits(want))


@pytest.mark.cuda
def test_vamr_on_the_card_equals_its_plain_run_and_itself(cuda):
    """VAMR on the waveform-40 stream: the kernel run equals the plain run
    and a second kernel run, state leaf for leaf and bit for bit."""
    from repro_torch.data.generators import WaveformGenerator, bin_numeric
    from repro_torch.ml import amrules
    from repro_torch.ml.amrules import VAMR, RulesConfig
    gen = WaveformGenerator(device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    batches = [gen.sample_regression(g, 512) for _ in range(12)]
    xs = torch.stack([bin_numeric(x, 8) for x, _ in batches])
    ys = torch.stack([y for _, y in batches])
    learner = VAMR(RulesConfig(n_attrs=40, n_min=200), device=cuda)
    runs = [learner.run(learner.init(), xs, ys) for _ in range(2)]
    # per step: one moment-statistics scatter; the per-rule sums and two
    # levels of the default rule's batch sum
    want = {"rule_stats": 2 * 12, "segment_sum": 2 * 12 * 3}
    assert {k: launches()[k] for k in want} == want
    saved = amrules.rule_stats_scatter, amrules.segment_sum
    amrules.rule_stats_scatter = amrules.segment_sum = rule_stats_scatter_ref
    try:
        runs.append(learner.run(learner.init(), xs, ys))
    finally:
        amrules.rule_stats_scatter, amrules.segment_sum = saved
    assert {k: launches()[k] for k in want} == want
    (st, ms), *others = runs
    assert int(st["n_created"]) > 0
    for other_st, other_ms in others:
        for k in st:
            assert torch.equal(_bits(st[k]), _bits(other_st[k])), k
        for k in ms:
            assert torch.equal(_bits(ms[k]), _bits(other_ms[k])), k


def _scan_inputs(B, c, dI, N, seed, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)

    dt = torch.nn.functional.softplus(r(B, c, dI)) * 0.1
    args = [dt, r(B, c, dI), r(B, c, N) * 0.5, r(B, c, N) * 0.5]
    return [a.to(dtype) for a in args] + [-torch.exp(r(dI, N) * 0.3),
                                          r(B, dI, N) * 0.1]


def _scan_close(got, want):
    """atol 2e-4 (tests/test_kernels.py), scaled to the values' range."""
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,c,dI,N,dtype", [
    (2, 32, 128, 16, torch.float32),
    (1, 100, 320, 5, torch.float32),       # channels not a multiple of 128
    (2, 64, 256, 64, torch.float32),       # the largest state the kernel takes
    (2, 64, 256, 16, torch.bfloat16),
    (4, 2048, 8192, 16, torch.float32),    # falcon_mamba_7b prefill
    (2, 1, 256, 16, torch.float32),        # one step
    (2, 2047, 256, 16, torch.float32),     # L not a multiple of the tile
    (1, 100, 200, 16, torch.float32),      # channels not a multiple of 32
    (2, 50, 99, 8, torch.float32),         # odd channels: plain staging
    (2, 64, 256, 1, torch.float32),        # N = 1
    (2, 100, 320, 5, torch.bfloat16),      # N = 5 in bf16
    (1, 2047, 320, 64, torch.bfloat16),    # the largest state in bf16
    (2, 100, 99, 16, torch.bfloat16),      # odd channels in bf16
])
def test_selective_scan_kernel_matches_plain(cuda, B, c, dI, N, dtype):
    args = _scan_inputs(B, c, dI, N, seed=c, device=cuda, dtype=dtype)
    y, hT = selective_scan(*args)
    y_ref, h_ref = selective_scan_ref(*args)
    assert y.dtype == dtype and hT.dtype == torch.float32
    if dtype == torch.bfloat16:       # one bf16 rounding of y apart
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=2**-7,
                                   atol=2e-4)
    else:
        _scan_close(y, y_ref)
    _scan_close(hT, h_ref)
    assert launches()["selective_scan"] == 1


@pytest.mark.cuda
def test_selective_scan_kernel_carries_the_state(cuda):
    """Two halves with the state carried equal the whole, from a nonzero
    state, on non-contiguous B and C columns (slices of one projection)."""
    dt, x, _, _, A, h0 = _scan_inputs(2, 96, 256, 16, 5, cuda)
    proj = torch.randn((2, 96, 40), device=cuda)
    Bm, Cm = proj[..., 4:20], proj[..., 20:36]
    y_full, h_full = selective_scan(dt, x, Bm, Cm, A, h0)
    h, ys = h0, []
    for s in (slice(0, 50), slice(50, 96)):
        y, h = selective_scan(dt[:, s], x[:, s], Bm[:, s], Cm[:, s], A, h)
        ys.append(y)
    _scan_close(torch.cat(ys, 1), y_full)
    _scan_close(h, h_full)
    _scan_close(y_full, selective_scan_ref(dt, x, Bm, Cm, A, h0)[0])
    assert launches()["selective_scan"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,dtype,causal,window", [
    (4, 2048, 2048, 20, 20, 128, torch.bfloat16, True, 0),   # qwen15_4b
    (2, 512, 512, 8, 2, 64, torch.float32, True, 0),         # GQA
    (1, 512, 512, 8, 1, 128, torch.bfloat16, True, 0),       # MQA
    (2, 512, 512, 4, 2, 64, torch.float32, True, 128),       # window
    (2, 300, 300, 4, 4, 32, torch.float32, False, 0),        # non-causal
    (2, 100, 300, 4, 2, 16, torch.float32, False, 0),        # S != T
    (2, 1000, 1000, 4, 4, 128, torch.bfloat16, True, 0),     # ragged S
    (3, 77, 77, 2, 1, 16, torch.float32, True, 32),          # ragged, window
    (2, 512, 512, 8, 2, 64, torch.bfloat16, True, 0),        # GQA
    (2, 512, 512, 4, 2, 64, torch.bfloat16, True, 128),      # window
    (2, 300, 300, 4, 4, 32, torch.bfloat16, False, 0),       # non-causal
    (2, 100, 300, 4, 2, 16, torch.bfloat16, False, 0),       # S != T
    (3, 77, 77, 2, 1, 16, torch.bfloat16, True, 32),         # ragged, window
    (2, 300, 100, 4, 2, 32, torch.bfloat16, True, 0),        # S > T
    (2, 1, 1, 4, 4, 64, torch.bfloat16, True, 0),            # one position
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, H, K, hd, dtype,
                                              causal, window):
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn((B, n, h, hd), generator=g, device=cuda)
               .to(dtype) for n, h in ((S, H), (T, K), (T, K)))
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    assert launches()["flash_attention"] == 1


def _shifted(logits, V):
    a = logits[..., :V].float()
    return a - a.max(-1, keepdim=True).values


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel", [("falcon_mamba_7b", "selective_scan"),
                                         ("qwen15_4b", "flash_attention")])
def test_lm_smoke_on_the_card_equals_its_plain_run(cuda, arch, kernel):
    """The SMOKE model's forward through the kernels (one launch per layer)
    against the same forward with the plain versions on the card, and its
    decode replay against its forward (tests/test_consistency.py's
    tolerance, atol 0.1, rtol 0.05)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LanguageModel
    from repro_torch.models import layers
    cfg = get_smoke_config(arch)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = LanguageModel.init(cfg, g, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=g,
                           device=cuda)
    logits, _ = model(tokens)
    assert launches()[kernel] == cfg.n_layers
    saved = layers.flash_attention, layers.selective_scan
    layers.flash_attention, layers.selective_scan = (flash_attention_ref,
                                                     selective_scan_ref)
    try:
        plain, _ = model(tokens)
    finally:
        layers.flash_attention, layers.selective_scan = saved
    assert launches()[kernel] == cfg.n_layers
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    V = cfg.vocab_size
    torch.testing.assert_close(_shifted(logits, V), _shifted(plain, V),
                               rtol=0, atol=0.04)
    cache = model.init_cache(2, 48)
    outs = []
    for i in range(48):
        step, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
        outs.append(step[:, 0])
    torch.testing.assert_close(_shifted(torch.stack(outs, 1), V),
                               _shifted(logits, V), rtol=0.05, atol=0.1)


# ------------------------------------------------ compiled steps (graphs)

def _replays_without_syncs(step, state, batches):
    """Every batch through ``step``, the card's sync debug mode set to
    raise on any sync; per-step metrics cloned, as the next replay
    overwrites them."""
    out = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, y in batches:
            state, m = step(state, x, y)
            out.append({k: v.clone() for k, v in m.items()})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}


def _eager_run(learner, batches):
    state, out = learner.init(), []
    for x, y in batches:
        state, m = learner.step(state, x, y)
        out.append(m)
    return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}


def _assert_bits_equal(got, want, path=""):
    """Nested dicts of tensors (None allowed): every leaf bit for bit (a
    uint32 PRNG key through its int32 bits)."""
    if want is None or isinstance(want, dict):
        assert (got is None) == (want is None), path
        if want is not None:
            assert got.keys() == want.keys(), path
            for k in want:
                _assert_bits_equal(got[k], want[k], f"{path}/{k}")
        return
    assert torch.equal(_bits(got), _bits(want)), path


@pytest.mark.cuda
def test_cond_node_runs_only_the_branch_taken(cuda):
    """A captured step with nested conds (csrc/graph_cond.cu): each replay
    gives the branch its predicate picks on the device, the branches'
    kernels run only when taken, and the state advances in place."""
    from repro_torch.core.compiled import compile_step, cond

    def fn(state, x):
        s = x.sum()

        def big(v):
            return cond(s > 10, lambda u: (torch.sort(u * 2).values[:4],),
                        lambda u: (u[:4] * 10,), v)

        out = cond(s > 0, big, lambda v: (v[:4] * 3,), x)
        return {"n": state["n"] + 1, "last": out[0]}, out[0]

    state = {"n": torch.zeros((), dtype=torch.int32, device=cuda),
             "last": torch.zeros(4, device=cuda)}
    x = torch.linspace(-1, 1, 100, device=cuda)
    step = compile_step(fn, state, x)
    st = state
    for n, shift in enumerate((1.0, 0.05, -1.0, 0.5, 0.05)):
        xs = torch.linspace(-1, 1, 100, device=cuda) + shift
        st, out = step(st, xs)
        s = float(xs.sum())
        want = (torch.sort(xs * 2).values[:4] if s > 10 else
                xs[:4] * 10 if s > 0 else xs[:4] * 3)
        assert torch.equal(out, want) and torch.equal(st["last"], want)
        assert int(st["n"]) == n + 1
    assert int(state["n"]) == 0                 # the example is left as it was


def _vht_batches(cuda, m, n):
    from repro_torch.data.generators import RandomTreeGenerator
    from repro_torch.data.pipeline import StreamPipeline
    gen = RandomTreeGenerator(n_cat=m // 2, n_num=m - m // 2, depth=8,
                              device=cuda)
    return list(StreamPipeline(gen, batch=512, n_batches=n, n_bins=8,
                               device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["local", "wok", "wk256"])
def test_compiled_vht_step_bit_identical_to_eager(cuda, variant):
    """The VHT step captured as a graph (its gates conditional nodes)
    against the eager step with the kernels, on dense-200: every per-batch
    metric and state leaf bit for bit, no sync in any replay.  A check tile
    of 2 makes the full fallback of the split check run too."""
    from repro_torch.core.compiled import compile_step
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import VHT, VHTConfig
    kw = {"local": {}, "wok": {"split_delay": 4},
          "wk256": {"split_delay": 4, "buffer_size": 256}}[variant]
    batches = _vht_batches(cuda, 200, 60)
    vht = VHT(VHTConfig(TreeConfig(n_attrs=200, n_min=200, check_tile=2,
                                   **kw)), device=cuda)
    want_st, want_m = _eager_run(vht, batches)
    step = compile_step(vht.step, vht.init(), *batches[0])
    got_st, got_m = _replays_without_syncs(step, vht.init(), batches)
    _assert_bits_equal(got_m, want_m)
    _assert_bits_equal(got_st, want_st)
    assert int(want_st["n_nodes"]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["MAMR", "VAMR", "HAMR-2"])
def test_compiled_amrules_step_bit_identical_to_eager(cuda, variant):
    from repro_torch.core.compiled import compile_step
    from repro_torch.data.generators import WaveformGenerator, bin_numeric
    from repro_torch.ml.amrules import HAMR, VAMR, AMRules, RulesConfig
    gen = WaveformGenerator(device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    batches = [gen.sample_regression(g, 512) for _ in range(30)]
    batches = [(bin_numeric(x, 8), y) for x, y in batches]
    rc = RulesConfig(n_attrs=40, n_min=200)
    learner = {"MAMR": lambda: AMRules(rc, device=cuda),
               "VAMR": lambda: VAMR(rc, device=cuda),
               "HAMR-2": lambda: HAMR(rc, replicas=2, device=cuda)}[variant]()
    want_st, want_m = _eager_run(learner, batches)
    step = compile_step(learner.step, learner.init(), *batches[0])
    got_st, got_m = _replays_without_syncs(step, learner.init(), batches)
    _assert_bits_equal(got_m, want_m)
    _assert_bits_equal(got_st, want_st)
    assert int(want_st["n_created"]) > 0


@pytest.mark.cuda
def test_jit_engine_equals_stream_engine(cuda):
    """The MA/LS topology at dense-200 on JitEngine (one graph per step
    after the first) and on the StreamEngine: predictions and every state
    leaf bit for bit."""
    from repro_torch.core.engines import JitEngine, StreamEngine
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import VHTConfig, build_vht_topology
    payloads = [{"x": x, "y": y} for x, y in _vht_batches(cuda, 200, 60)]
    topo = build_vht_topology(VHTConfig(TreeConfig(n_attrs=200, n_min=200)),
                              device=cuda)
    runs = [eng.run_stream(topo, eng.init(topo), payloads)
            for eng in (JitEngine(), StreamEngine())]
    (got, got_out), (want, want_out) = runs
    assert torch.equal(got_out["prediction"]["pred"],
                       want_out["prediction"]["pred"])
    for name in want["states"]:
        _assert_bits_equal(got["states"][name], want["states"][name])
    assert int(want["states"]["model-aggregator"]["n_nodes"]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "qwen15_4b"])
def test_graph_decode_equals_eager_decode(cuda, arch):
    """serve.generate through one captured decode step against the same
    step run eagerly, on the SMOKE model: the same tokens, and the same
    replay logits bit for bit."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import LanguageModel
    cfg = get_smoke_config(arch)
    if arch == "qwen15_4b":
        cfg = dataclasses.replace(cfg, window=16)       # the cache rolls
    g = torch.Generator(device=cuda).manual_seed(0)
    model = LanguageModel.init(cfg, g, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                           device=cuda, dtype=torch.int32)
    want = serve.generate(model, prompt, 12, compiled=False)
    got = serve.generate(model, prompt, 12)
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["prefill_logits"], want["prefill_logits"])


@pytest.mark.cuda
def test_a_step_that_syncs_does_not_capture(cuda):
    """A failed capture raises: nothing falls back to running eagerly."""
    from repro_torch.core.compiled import compile_step

    def fn(state, x):
        return {"v": state["v"] + float(x.sum())}, x

    with pytest.raises(RuntimeError):
        compile_step(fn, {"v": torch.zeros((), device=cuda)},
                     torch.ones(4, device=cuda))


# ------------------------------------------------- ensembles (slice 8)

@pytest.mark.cuda
@pytest.mark.parametrize("lam,M,B", [
    pytest.param("bagging", 10, 512, id="bagging"),
    pytest.param("boosting", 10, 512, id="boosting"),
    ("9.99", 10, 512), ("mixed", 10, 512), ("9.99", 7, 1000),
    ("bagging", 7, 1000), ("mixed", 64, 4096)])
def test_split_poisson_kernel_matches_plain(cuda, lam, M, B):
    """JAX's split and Knuth Poisson draws: the kernel's key and weights
    equal the plain version's, bit for bit (its logf is torch.log's on the
    card), and the input key is left as it was.  The ensembles' [10, 512]
    at bagging's rate 1 and boosting's in [1, 3]; rates of 9.99, whose
    draws run past 20 rounds, many times the table's chunk; per-element
    rates in [0, 9.99) with zeros; M * B not a multiple of a block's draws
    ([7, 1000]); and a launch of thousands of blocks ([64, 4096])."""
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels.split_poisson.ops import split_poisson
    from repro_torch.kernels.split_poisson.ref import split_poisson_ref
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    if lam == "bagging":
        rates = torch.ones((M, 1), device=cuda)
    elif lam == "9.99":
        rates = torch.full((M, 1), 9.99, device=cuda)
    elif lam == "boosting":
        rates = 1.0 + 2.0 * torch.rand((M, B), generator=g, device=cuda)
    else:
        rates = 9.99 * torch.rand((M, B), generator=g, device=cuda)
        rates[torch.rand((M, B), generator=g, device=cuda) < 0.2] = 0.0
    for seed in range(4):
        key = PRNGKey(seed, cuda)
        before = key.clone()
        got_key, got_w = split_poisson(key, rates, (M, B))
        want_key, want_w = split_poisson_ref(key, rates, (M, B))
        torch.cuda.synchronize()
        _assert_bits_equal({"key": got_key, "w": got_w},
                           {"key": want_key, "w": want_w})
        assert torch.equal(_bits(key), _bits(before))
        assert float(got_w.max()) >= 3
        if lam == "mixed":
            assert torch.equal(got_w[rates == 0],
                               torch.zeros_like(got_w[rates == 0]))
    assert launches()["split_poisson"] == 4


def _ensemble(cuda, kind, m=200):
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import ShardingEnsemble
    tc = TreeConfig(n_attrs=m, n_min=200)
    if kind == "sharding":
        return ShardingEnsemble(tc, 4, device=cuda)
    return OzaEnsemble(EnsembleConfig(tc, n_members=10,
                                      boost=kind == "ozaboost"), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ozabag", "ozaboost", "sharding"])
def test_compiled_ensemble_step_bit_identical_to_eager(cuda, kind):
    """An OzaBag, OzaBoost (M = 10, ADWIN) and ShardingEnsemble (p = 4)
    step captured as a graph against the eager step with the kernels, on
    dense-200: every per-batch metric and state leaf, the key included,
    bit for bit; no sync in any replay; split_poisson launched once a
    step eagerly."""
    from repro_torch.core.compiled import compile_step
    batches = _vht_batches(cuda, 200, 40)
    learner = _ensemble(cuda, kind)
    reset_launches()
    want_st, want_m = _eager_run(learner, batches)
    if kind != "sharding":
        assert launches()["split_poisson"] == len(batches)
        assert launches()["tree_route"] == len(batches)
    step = compile_step(learner.step, learner.init(), *batches[0])
    got_st, got_m = _replays_without_syncs(step, learner.init(), batches)
    _assert_bits_equal(got_m, want_m)
    _assert_bits_equal(got_st, want_st)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vht", "ozabag"])
def test_short_last_batch_compiled_equals_eager(cuda, kind):
    """A stream whose last batch is 200 of B = 512 rows:
    PrequentialEvaluation compiled (a second graph captured for the short
    batch, sharing the state's buffers) against the eager run, bit for
    bit: the curve and the final state."""
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import VHT, VHTConfig
    batches = _vht_batches(cuda, 200, 30)
    batches[-1] = (batches[-1][0][:200].contiguous(),
                   batches[-1][1][:200].contiguous())

    def make():
        if kind == "vht":
            return VHT(VHTConfig(TreeConfig(n_attrs=200, n_min=200,
                                            split_delay=4)), device=cuda)
        return _ensemble(cuda, "ozabag")

    got = PrequentialEvaluation(make(), batches).run()
    want = PrequentialEvaluation(make(), batches, compiled=False).run()
    assert got.curve == want.curve and got.metric == want.metric
    _assert_bits_equal(got.extra["state"], want.extra["state"])


def _blob_fetch(d, chunk_len, batch=512, seed=0, n_blobs=8):
    """Chunk i of benchmarks/clustream_benchmarks.py's blob stream, drawn
    with numpy from (seed, i): points 0.05 (normal) around 8 uniform
    centers in [0, 1)^d."""
    centers = np.random.default_rng(seed).uniform(size=(n_blobs, d))

    def fetch(i):
        rng = np.random.default_rng([seed, i])
        c = rng.integers(0, n_blobs, (chunk_len, batch))
        x = centers[c] + 0.05 * rng.standard_normal((chunk_len, batch, d))
        return {"x": x.astype(np.float32)}
    return fetch


def _clustream(cuda, mode):
    from repro_torch.ml.clustream import CluStream, CluStreamConfig
    return CluStream(CluStreamConfig(n_dims=32, n_micro=100, n_macro=8,
                                     period=2048, macro_impl=mode),
                     device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["step", "boundary"])
def test_clustream_eager_compiled_and_plain_alike(cuda, mode, monkeypatch):
    """CluStream d32-K100, 20 batches of 512 from the blob stream in chunks
    of 4 (period 2048, aligned): the compiled chunked run (JitEngine), the
    eager ChunkedStream loop (LocalEngine) and the eager loop with the
    plain versions give the same per-batch metrics and final state, bit
    for bit; the CF scatter launches segment_sum, the plain run none; the
    macro phase fires."""
    import functools
    from repro_torch.core.engines import JitEngine, LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml import clustream

    stream = ChunkedStream.from_fn(_blob_fetch(32, 4), n_chunks=5,
                                   chunk_len=4)
    learner = _clustream(cuda, mode)
    eng, loc = JitEngine(), LocalEngine()
    carry, outs = eng.run_stream_chunked(learner, eng.init(learner), stream)
    reset_launches()
    states, eager = loc.run_stream(learner, loc.init(learner), stream)
    assert launches()["segment_sum"] >= 20 * 2
    monkeypatch.setattr(clustream, "segment_sum", rule_stats_scatter_ref)
    monkeypatch.setattr(clustream, "batch_sum", functools.partial(
        batch_sum, scatter=rule_stats_scatter_ref))
    reset_launches()
    plain_states, plain = loc.run_stream(learner, loc.init(learner), stream)
    assert sum(launches().values()) == 0
    eager, plain = stack_outputs(eager), stack_outputs(plain)
    for k in ("seen", "ssq", "n_active"):
        assert torch.equal(_bits(outs["metrics"][k]),
                           _bits(eager["metrics"][k]))
        assert torch.equal(_bits(plain["metrics"][k]),
                           _bits(eager["metrics"][k]))
    _assert_bits_equal(carry["states"], states)
    _assert_bits_equal(plain_states, states)
    assert float(states["clustream"]["macro_t"]) == 20 * 512  # 5 periods


@pytest.mark.cuda
def test_clustream_kill_resume_on_the_card(cuda, tmp_path):
    """Boundary-mode CluStream through ChunkedPrequentialEvaluation with a
    checkpoint after every chunk: killed after chunk 2 (the later
    checkpoints gone) and resumed, it ends as the uninterrupted run, bit
    for bit; the carry comes back to the card."""
    import pathlib
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
    from repro_torch.data.pipeline import ChunkedStream

    stream = ChunkedStream.from_fn(_blob_fetch(32, 4), n_chunks=5,
                                   chunk_len=4)
    learner = _clustream(cuda, "boundary")
    want = ChunkedPrequentialEvaluation(learner, stream).run()
    mgr = CheckpointManager(tmp_path, keep=0)
    ChunkedPrequentialEvaluation(learner, stream, checkpoint=mgr).run(
        resume=False)
    for s in mgr.all_steps():
        if s > 2:
            shutil.rmtree(pathlib.Path(tmp_path) / f"step_{s:010d}")
    ev = ChunkedPrequentialEvaluation(learner, stream,
                                      checkpoint=CheckpointManager(tmp_path))
    got = ev.run(resume=True)
    assert ev.report["events"] == [("resume", 2)]
    assert got.curve == want.curve and got.extra["seen"] == 20 * 512
    assert got.extra["carry"]["states"]["clustream"]["n"].is_cuda
    _assert_bits_equal(got.extra["carry"]["states"],
                       want.extra["carry"]["states"])


@pytest.mark.cuda
def test_a_capture_survives_another_thread_staging_chunks(cuda):
    """A chunked stream's producer stages chunks (pinned memory, a copy on
    its own stream, a wait on it) while the consumer captures a step: the
    capture is thread-local, so the producer does not invalidate it."""
    import threading
    from repro_torch.core.compiled import compile_step

    stop = threading.Event()

    def stage():
        side = torch.cuda.Stream(cuda)
        while not stop.is_set():
            with torch.cuda.stream(side):
                torch.ones(1 << 16).pin_memory().to(cuda, non_blocking=True)
            side.synchronize()

    producer = threading.Thread(target=stage)
    producer.start()
    try:
        for _ in range(20):
            zeros = {"a": torch.zeros(1024, device=cuda)}
            ones = torch.ones(1024, device=cuda)
            step = compile_step(lambda s, x: ({"a": s["a"] + x}, {}), zeros,
                                ones)
            state, _ = step(zeros, ones)
            assert torch.equal(state["a"], ones)
    finally:
        stop.set()
        producer.join()


# --------------------------------------------------- train while serving

def _vht_chunked(cuda, n_chunks, chunk_len=4, m=200, short=False):
    """A dense-m VHT stream of n_chunks chunks on the card; with ``short``
    one more chunk holding one batch of 200 of its 512 rows."""
    from repro_torch.data.pipeline import ChunkedStream
    batches = _vht_batches(cuda, m, n_chunks * chunk_len + short)
    xs = torch.stack([x for x, _ in batches])
    ys = torch.stack([y for _, y in batches])
    parts = [{"x": xs[i:i + chunk_len], "y": ys[i:i + chunk_len]}
             for i in range(0, n_chunks * chunk_len, chunk_len)]
    if short:
        parts.append({"x": xs[-1:, :200].contiguous(),
                      "y": ys[-1:, :200].contiguous()})
    return ChunkedStream.from_fn(lambda i: parts[i], len(parts), chunk_len,
                                 device=cuda), xs[0].cpu().numpy()


def _vht(cuda, m=200):
    from repro_torch.ml.htree import TreeConfig
    from repro_torch.ml.vht import VHT, VHTConfig
    return VHT(VHTConfig(TreeConfig(n_attrs=m, n_min=200, split_delay=4)),
               device=cuda)


def _play(srv, rows, until, limit=4000):
    """Requests at the server, one a millisecond at most, until until()."""
    import time
    reqs = []
    while not until() and len(reqs) < limit:
        reqs.append(srv.submit(rows[len(reqs) % len(rows)]))
        time.sleep(0.001)
    return reqs


@pytest.mark.cuda
def test_pipelined_driver_waits_on_events_not_the_device(cuda, tmp_path,
                                                         monkeypatch):
    """A pipelined run with a checkpoint, a publisher and on_chunk while a
    ModelServer answers: only the main thread calls torch.cuda.synchronize
    (the capture, the first chunk's timestamp and the final fence); the
    drain thread waits on each chunk's event; the server answers; the run
    equals the synchronous driver's, bit for bit."""
    import concurrent.futures
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
    from repro_torch.serving import (ModelServer, ServeConfig,
                                     SnapshotPublisher)

    stream, rows = _vht_chunked(cuda, 6)
    learner = _vht(cuda)
    want = ChunkedPrequentialEvaluation(learner, stream,
                                        pipeline=False).run()
    device_waits, event_waits = [], []
    real_sync, real_wait = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def sync(*a, **k):
        device_waits.append(threading.current_thread().name)
        return real_sync(*a, **k)

    def wait(self):
        event_waits.append(threading.current_thread().name)
        return real_wait(self)

    pub = SnapshotPublisher()
    assert pub.publish(-1, learner.init())
    srv = ModelServer(learner, pub, ServeConfig(max_batch=16,
                                                deadline_ms=60_000.0))
    seen = []
    ev = ChunkedPrequentialEvaluation(
        learner, stream, checkpoint=CheckpointManager(tmp_path, keep=2),
        checkpoint_every=2, publisher=pub,
        on_chunk=lambda outs, chunk, carry: seen.append(chunk.index))
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", wait)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_play, srv, rows, lambda: False, 50)
        got = ev.run()
        reqs = fut.result(timeout=60)
    srv.stop()
    monkeypatch.undo()
    assert set(device_waits) == {threading.main_thread().name}
    drain_waits = [n for n in event_waits if n.startswith("chunk-drain")]
    assert len(drain_waits) >= 6 and seen == list(range(6))
    assert all(r.result(timeout=30).status == "answered" for r in reqs)
    assert pub.published == 7
    assert got.curve == want.curve and got.metric == want.metric
    _assert_bits_equal(got.extra["carry"]["states"],
                       want.extra["carry"]["states"])


@pytest.mark.cuda
def test_snapshot_unchanged_across_two_compiled_chunks(cuda):
    """A snapshot of the compiled step's own state buffers (which every
    replay advances in place) stays as it was published while two more
    chunks of replays run."""
    from repro_torch.core.engines import JitEngine
    from repro_torch.serving import SnapshotPublisher, model_state_of

    learner, eng = _vht(cuda), JitEngine()
    batches = [{"x": x, "y": y} for x, y in _vht_batches(cuda, 200, 12)]
    carry = eng.init(learner)
    for p in batches[:4]:
        carry, _ = eng.step(learner, carry, p)
    live = model_state_of(carry)
    pub = SnapshotPublisher()
    assert pub.publish(0, live)
    want = {k: v.clone() for k, v in live.items()}
    for p in batches[4:]:
        carry, _ = eng.step(learner, carry, p)
    stats = model_state_of(carry)["stats"]
    assert stats.data_ptr() == live["stats"].data_ptr()
    assert not torch.equal(live["stats"], want["stats"])   # advanced in place
    _assert_bits_equal(pub.current().state, want)


@pytest.mark.cuda
def test_short_batch_capture_while_a_model_server_answers(cuda):
    """A run whose last chunk holds a 200-row batch captures that batch's
    step mid-run while a ModelServer answers requests on its own stream:
    no capture error, and the run equals the eager run (LocalEngine's
    ChunkedStream loop), per batch and in its final state."""
    import concurrent.futures
    from repro_torch.core.engines import LocalEngine
    from repro_torch.core.evaluation import (ChunkedPrequentialEvaluation,
                                             stack_outputs)
    from repro_torch.serving import (ModelServer, ServeConfig,
                                     SnapshotPublisher)

    stream, rows = _vht_chunked(cuda, 3, short=True)
    learner = _vht(cuda)
    pub = SnapshotPublisher()
    assert pub.publish(-1, learner.init())
    srv = ModelServer(learner, pub, ServeConfig(max_batch=16,
                                                deadline_ms=60_000.0))
    metrics = []
    ev = ChunkedPrequentialEvaluation(
        learner, stream, publisher=pub,
        on_chunk=lambda outs, chunk, carry: metrics.append(outs["metrics"]))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ev.run)
        reqs = _play(srv, rows, fut.done)
        got = fut.result(timeout=300)
    srv.stop()
    assert reqs and all(r.result(timeout=30).status == "answered"
                        for r in reqs)
    loc = LocalEngine()
    states, eager = loc.run_stream(learner, loc.init(learner), stream)
    eager = stack_outputs(eager)["metrics"]
    for key in ("correct", "seen", "dropped", "n_nodes"):
        assert torch.equal(_bits(torch.cat([m[key] for m in metrics])),
                           _bits(eager[key])), key
    assert float(eager["seen"][-1]) == 200.0
    _assert_bits_equal(got.extra["carry"]["states"], states)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vht", "ozabag"])
def test_predict_through_the_kernel_equals_plain(cuda, kind):
    """The serving fast path (tree_route, one launch a call, M = 1 or 10)
    against reference_predict (the plain router) on learned trees at the
    server's batch of 16 and at 512 rows: bit for bit."""
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.serving import make_predict_fn, reference_predict

    learner = _vht(cuda) if kind == "vht" else _ensemble(cuda, "ozabag")
    batches = _vht_batches(cuda, 200, 20)
    state = PrequentialEvaluation(learner, batches[:-1]).run().extra["state"]
    trees = state["trees"] if kind == "ozabag" else state
    assert int(trees["n_nodes"].max()) > 1
    fn = make_predict_fn(learner)
    for x in (batches[-1][0][:16], batches[-1][0]):
        reset_launches()
        got = fn(state, x)
        assert launches()["tree_route"] == 1
        assert torch.equal(got, reference_predict(learner, state, x))


@pytest.mark.cuda
def test_a_capture_survives_the_collector_freeing_another_graph(cuda):
    """An engine whose compiled steps sit in a reference cycle becomes
    garbage in the middle of another step's capture, which then makes
    enough objects for a full collection to fall due: a collection there
    would reset the freed graphs inside the capture and invalidate it."""
    import gc
    from repro_torch.core.compiled import compile_step
    from repro_torch.core.engines import JitEngine

    learner = _vht(cuda)
    batches = [{"x": x, "y": y} for x, y in _vht_batches(cuda, 200, 3)]
    holder, kept = [], []

    def fn(s, x):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()              # the engine is garbage from here
            # long-lived objects past a quarter of the oldest generation:
            # a full collection falls due
            n = len(gc.get_objects(generation=2))
            kept.append([[i] for i in range(n)])
        return {"a": s["a"] + x}, {}

    for _ in range(2):
        eng = JitEngine()
        carry = eng.init(learner)
        for p in batches:
            carry, _ = eng.step(learner, carry, p)
        holder.append(eng)
        del eng, carry
        zeros = {"a": torch.zeros(1024, device=cuda)}
        ones = torch.ones(1024, device=cuda)
        step = compile_step(fn, zeros, ones)
        assert not holder and kept
        kept.clear()
        state, _ = step(zeros, ones)
        assert torch.equal(state["a"], ones)


# ----------------------------------------------------------------- fleets

def _fleet_trees(F, N, m, nb, seed):
    """F random trees of up to N nodes (a random number of splits each)."""
    rng = np.random.RandomState(seed)
    sa = np.full((F, N), -1, np.int32)
    sb = np.zeros((F, N), np.int32)
    ch = np.zeros((F, N, 2), np.int32)
    for t in range(F):
        n_nodes, leaves = 1, [0]
        for _ in range(rng.randint((N - 1) // 2 + 1)):
            node = leaves.pop(rng.randint(len(leaves)))
            sa[t, node], sb[t, node] = rng.randint(m), rng.randint(nb)
            ch[t, node] = (n_nodes, n_nodes + 1)
            leaves += [n_nodes, n_nodes + 1]
            n_nodes += 2
    return sa, sb, ch


@pytest.mark.cuda
@pytest.mark.parametrize("F,N,m,nb,B", [(1000, 31, 8, 4, 16),
                                        (3, 255, 1000, 8, 512),
                                        (7, 63, 12, 8, 5)])
def test_tree_route_batched_matches_plain(cuda, F, N, m, nb, B):
    from repro_torch.kernels.tree_route.ops import tree_route_batched
    from repro_torch.kernels.tree_route.ref import tree_route_batched_ref
    sa, sb, ch = _fleet_trees(F, N, m, nb, F)
    xbin = np.random.RandomState(1).randint(0, nb, (F, B, m)).astype(np.int32)
    args = [_t(a).to(cuda) for a in (sa, sb, ch, xbin)]
    out = tree_route_batched(*args, max_depth=24)
    assert torch.equal(out, tree_route_batched_ref(*args, 24))
    assert launches()["tree_route_batched"] == 1
    assert launches()["tree_route"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("F,N,m,nb,R", [(1000, 31, 8, 4, 16),
                                        (5, 255, 1000, 8, 300)])
def test_tree_route_rows_matches_plain(cuda, F, N, m, nb, R):
    from repro_torch.kernels.tree_route.ops import tree_route_rows
    from repro_torch.kernels.tree_route.ref import tree_route_rows_ref
    rng = np.random.RandomState(2)
    sa, sb, ch = _fleet_trees(F, N, m, nb, 3)
    xbin = rng.randint(0, nb, (R, m)).astype(np.int32)
    member = rng.randint(-1, F + 1, R).astype(np.int32)
    args = [_t(a).to(cuda) for a in (sa, sb, ch, xbin, member)]
    out = tree_route_rows(*args, max_depth=24)
    assert torch.equal(out, tree_route_rows_ref(*args, 24))
    assert launches()["tree_route_rows"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("F,S,C,B", [(1000, 101, 64, 16), (1000, 101, 3, 16),
                                     (1000, 4, 1, 16), (6, 300, 70, 700),
                                     (3, 9, 4096, 40), (2, 1, 33, 1000)])
def test_segment_sum_tenant_bit_identical(cuda, F, S, C, B):
    """The tenant form against its plain version: each tenant's rows
    (segments S and -1 dropped) in its own segments, in instance order,
    bit for bit, the segments no row hits left as they were; more than 32
    columns take more blocks, more than 256 rows a tenant more tiles (a
    segment hit in several is summed on from tile to tile), and S = 1
    chains a third of 1000 rows into one segment."""
    from repro_torch.kernels.rule_stats.ops import segment_sum_tenant
    from repro_torch.kernels.rule_stats.ref import segment_sum_tenant_ref
    rng = np.random.RandomState(S + C)
    seg = _t(rng.randint(-1, S + 1, F * B).astype(np.int32)).to(cuda)
    vals = _t(rng.randn(F * B, C).astype(np.float32)).to(cuda)
    out = _t(rng.randn(F, S, C).astype(np.float32)).to(cuda)
    want = segment_sum_tenant_ref(out.clone(), seg, vals)
    got = segment_sum_tenant(out, seg, vals)
    assert torch.equal(_bits(got), _bits(want))
    assert launches()["segment_sum_tenant"] == 1


# trees that split from the second batch on (any positive gain)
GROW = {"n_min": 8, "tau": 0.5}


def _fleet_vht(cuda, **kw):
    from repro_torch.ml import VHT, VHTConfig
    from repro_torch.ml.htree import TreeConfig
    tc = dict(n_attrs=8, n_bins=4, n_classes=2, max_nodes=31, n_min=16,
              delta=0.05, tau=0.1)
    return VHT(VHTConfig(TreeConfig(**{**tc, **kw})), device=cuda)


def _fleet_stream(F, T, m=8, nb=4, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, nb, (T, F, 16, m)).astype(np.int32)
    y = ((x[..., 0] + x[..., 1]) > nb - 1).astype(np.int32)
    flip = rng.uniform(size=y.shape) < 0.1
    return {"x": x, "y": np.where(flip, 1 - y, y).astype(np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [{}, {"split_delay": 2},
                                     {"split_delay": 2, "buffer_size": 8}],
                         ids=["local", "wok", "wk8"])
def test_vht_fleet_compiled_eager_and_cpu_alike(cuda, variant):
    """A 64-tenant VHT fleet, 8 steps of 16 in chunks of 2: compiled on
    the card (JitEngine), eager on the card (LocalEngine) and on the CPU
    (the plain versions) give the same state and metric columns, bit for
    bit; the eager card run launches tree_route_batched and vht_stats once
    a step each (twice with wk(z)'s replay), whatever the tenant count."""
    from repro_torch.core.engines import JitEngine, LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml import LearnerFleet

    pay = {k: _t(v) for k, v in _fleet_stream(64, 8).items()}
    fleet = LearnerFleet(_fleet_vht(cuda, **GROW, **variant), 64)
    cpu_fleet = LearnerFleet(_fleet_vht("cpu", **GROW, **variant), 64)
    stream = ChunkedStream(pay, 2, device=cuda)
    eng, loc = JitEngine(), LocalEngine()
    carry, outs = eng.run_stream_chunked(fleet, eng.init(fleet), stream)
    reset_launches()
    states, eager = loc.run_stream(fleet, loc.init(fleet), stream)
    per_step = 2 if variant.get("buffer_size") else 1
    assert launches()["tree_route_batched"] == 8 * per_step
    assert launches()["vht_stats"] == 8 * per_step
    assert launches()["tree_route"] == 0
    cpu_states, cpu = loc.run_stream(cpu_fleet, loc.init(cpu_fleet),
                                     ChunkedStream(pay, 2, to_device=False))
    eager = stack_outputs(eager)["metrics"]
    cpu = stack_outputs(cpu)["metrics"]
    _assert_bits_equal(carry["states"], states)
    _assert_bits_equal({k: v.cpu() for k, v in eager.items()}, cpu)
    _assert_bits_equal(outs["metrics"], eager)
    got = {k: v.cpu() for k, v in states["learnerfleet"]["tenant"].items()}
    _assert_bits_equal(got, cpu_states["learnerfleet"]["tenant"])
    assert int(got["n_splits"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["step", "boundary"])
def test_clustream_fleet_kernels_and_plain_alike(cuda, mode, monkeypatch):
    """A 32-tenant fleet of CluStream d32-K100 (period 32, aligned to
    chunks of 2 batches of 16), compiled and eager with the tenant form of
    segment_sum, and eager with its plain version: the same state and
    metrics bit for bit; each tenant's cluster features equal its learner
    run alone on the card (macro centroids within rtol 1e-6)."""
    import functools
    from repro_torch.core import prng
    from repro_torch.core.engines import JitEngine, LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.kernels.rule_stats.ops import batch_sum_tenant
    from repro_torch.kernels.rule_stats.ref import segment_sum_tenant_ref
    from repro_torch.ml import CluStream, CluStreamConfig, LearnerFleet
    from repro_torch.ml import clustream

    F, T = 32, 8
    rng = np.random.default_rng(4)
    centers = rng.uniform(size=(8, 32))
    x = (centers[rng.integers(0, 8, (T, F, 16))]
         + 0.05 * rng.standard_normal((T, F, 16, 32))).astype(np.float32)
    learner = CluStream(CluStreamConfig(n_dims=32, n_micro=100, n_macro=8,
                                        period=32, macro_impl=mode),
                        device=cuda)
    fleet = LearnerFleet(learner, F)
    stream = ChunkedStream({"x": _t(x)}, 2, device=cuda)
    eng, loc = JitEngine(), LocalEngine()
    carry, outs = eng.run_stream_chunked(fleet, eng.init(fleet), stream)
    reset_launches()
    states, eager = loc.run_stream(fleet, loc.init(fleet), stream)
    assert launches()["segment_sum_tenant"] >= 3 * T
    assert launches()["segment_sum"] == 0
    monkeypatch.setattr(clustream, "segment_sum_tenant",
                        segment_sum_tenant_ref)
    monkeypatch.setattr(clustream, "batch_sum_tenant", functools.partial(
        batch_sum_tenant, scatter=segment_sum_tenant_ref))
    reset_launches()
    plain_states, plain = loc.run_stream(fleet, loc.init(fleet), stream)
    assert sum(launches().values()) == 0
    monkeypatch.undo()
    eager, plain = stack_outputs(eager), stack_outputs(plain)
    _assert_bits_equal(outs["metrics"], eager["metrics"])
    _assert_bits_equal(plain["metrics"], eager["metrics"])
    _assert_bits_equal(carry["states"], states)
    _assert_bits_equal(plain_states, states)
    packed = states["learnerfleet"]
    assert float(packed["tenant"]["macro_t"].min()) == T * 16
    keys = fleet.tenant_keys(prng.PRNGKey(0, cuda))    # init(None)
    for f in (0, F // 2, F - 1):
        one = loc.init(learner)
        one["clustream"] = learner.init(keys[f])
        alone, _ = loc.run_stream(learner, one, ChunkedStream(
            {"x": _t(x[:, f])}, 2, device=cuda))
        row = fleet.tenant_state(packed, f)
        for k in ("n", "ls", "ss", "lt", "st", "t", "macro_t"):
            assert torch.equal(_bits(row[k]), _bits(alone["clustream"][k])), k
        torch.testing.assert_close(row["macro"], alone["clustream"]["macro"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fleet_predict_and_server_route_by_tenant(cuda):
    """A trained 64-tenant VHT fleet on the card: the tenant-indexed
    predict (one tree_route_rows launch) equals reference_predict, and a
    ModelServer answers a full batch of mixed tenants in one poll."""
    from repro_torch.core.engines import JitEngine
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml import LearnerFleet
    from repro_torch.serving import (ModelServer, ServeConfig,
                                     SnapshotPublisher, make_predict_fn,
                                     model_state_of, reference_predict)

    pay = {k: _t(v) for k, v in _fleet_stream(64, 8).items()}
    fleet = LearnerFleet(_fleet_vht(cuda), 64)
    eng = JitEngine()
    carry, _ = eng.run_stream_chunked(fleet, eng.init(fleet),
                                      ChunkedStream(pay, 2, device=cuda))
    state = model_state_of(carry)
    rows = pay["x"][7, :16, 0].to(cuda)
    tenants = torch.arange(0, 64, 4, dtype=torch.int32, device=cuda)
    reset_launches()
    got = make_predict_fn(fleet)(state, rows, tenants)
    assert launches()["tree_route_rows"] == 1
    want = reference_predict(fleet, state, rows, tenant=tenants)
    assert torch.equal(got, want)
    pub = SnapshotPublisher()
    assert pub.publish(3, state)
    srv = ModelServer(fleet, pub, ServeConfig(max_batch=16, deadline_ms=6e4),
                      start=False)
    reqs = [srv.submit(rows[i].cpu().numpy(), tenant=int(tenants[i]))
            for i in range(16)]
    assert srv.poll() == 16
    assert [int(r.pred) for r in reqs] == want.cpu().tolist()
    assert [r.meta["tenant"] for r in reqs] == tenants.cpu().tolist()
