"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main path's shapes (B = 512, m = 1000, N = 255, bins = 8,
C = 2).  Every test here is marked ``cuda`` and skips without a CUDA
device; the file imports nothing of JAX, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.split_gain.ops import split_gain
from repro_torch.kernels.split_gain.ref import split_gain_ref
from repro_torch.kernels.tree_route.ops import tree_route
from repro_torch.kernels.tree_route.ref import tree_route_ref
from repro_torch.kernels.vht_stats.ops import stats_update
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


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 255])
def test_split_gain_kernel_matches_plain(cuda, N):
    rng = np.random.RandomState(N)
    stats = _t(rng.randint(0, 30, (N, 1000, 8, 2)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(split_gain(stats), split_gain_ref(stats),
                               rtol=1e-4, atol=1e-4)
    assert launches()["split_gain"] == 1
