"""The VHT statistics update, ``stats[n, j, b, c] += sum_i 1[leaf_i = n]
1[xbin_ij = b] 1[y_i = c] w_i`` (paper Alg. 2), in place.

On a CUDA tensor it launches the hand-written kernel of
``csrc/vht_stats.cu``: a block per tile of ``ja`` attributes sums a batch
of integer weights that falls in few leaves in a shared-memory histogram
over the leaves present, then adds each hit cell into ``stats`` once; a
batch spread over many leaves, or of fractional weights, it adds hit by
hit.  On a CPU tensor it runs the plain version of ``ref.py``.  Unlike
the JAX package, which returns a new array, both update ``stats`` in
place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vht_stats.ref import stats_update_ref

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# csrc/vht_stats.cu's BUDGET, JA_MAX and DENSE: shared memory bytes a block
# may take, the attributes it takes at most, and the instances a leaf
# present from which a batch is summed in the histogram
BUDGET = 72 * 1024
JA_MAX = 4
DENSE = 8


def tile_plan(N: int, B: int, bins: int, C: int) -> tuple[int, int, int]:
    """The kernel's tiling for stats [N, m, bins, C] and a batch of B, as
    ``csrc/vht_stats.cu::make_plan`` computes it: (ja, group, smem).

    A batch of L leaves present is summed in a block's shared histogram
    when L <= B / DENSE, else each hit goes straight to ``stats``; so the
    histogram holds min(N, B / DENSE) leaves (at least one), ``group`` of
    them at a time, of ``ja`` attributes of bins x C 4-byte counts.  Beside
    it lie a bitmap and a prefix count over N (two ints per 32 leaves) and
    the ids of the histogram's leaves.  ja is the largest power of two up
    to JA_MAX for which all those leaves fit in BUDGET bytes; group is all
    of them when they fit, else the leaves of one pass over the batch at
    ja = 1.  smem is the bytes the block takes.  Raises when not even one
    leaf's cells fit, where the kernel's launcher refuses the shape."""
    words = (N + 31) // 32
    worst = min(N, max(B // DENSE, 1))
    fixed = 8 * words + 4 * worst
    cell = 4 * bins * C
    room = BUDGET - fixed
    if worst < 1 or room < cell:
        raise ValueError(
            f"vht_stats kernel: stats [{N}, m, {bins}, {C}] with a batch of "
            f"{B} does not fit its {BUDGET} bytes of shared memory")
    ja = JA_MAX
    while ja > 1 and ja * worst * cell > room:
        ja //= 2
    group = min(room // (ja * cell), worst)
    return ja, group, fixed + group * ja * cell


def stats_update(stats, leaf, xbin, y, w):
    """stats: [N, m, bins, C] f32; leaf, y: [B] i32; xbin: [B, m] i32;
    w: [B] f32.  Updates ``stats`` in place and returns it.  On the card
    it raises for a shape whose histogram does not fit (see tile_plan)."""
    if stats.device.type == "cpu":
        return stats_update_ref(stats, leaf, xbin, y, w)
    N, m, bins, C = stats.shape
    B = leaf.shape[0]
    _build.check_tensor(stats, torch.float32, (N, m, bins, C), "stats")
    _build.check_tensor(leaf, torch.int32, (B,), "leaf", stats.device)
    _build.check_tensor(xbin, torch.int32, (B, m), "xbin", stats.device)
    _build.check_tensor(y, torch.int32, (B,), "y", stats.device)
    _build.check_tensor(w, torch.float32, (B,), "w", stats.device)
    if stats.numel() == 0 or B == 0:
        return stats
    fn = _build.function("vht_stats", "vht_stats_launch", _ARGTYPES)
    with torch.cuda.device(stats.device):
        err = fn(stats.data_ptr(), leaf.data_ptr(), xbin.data_ptr(),
                 y.data_ptr(), w.data_ptr(), N, B, m, bins, C,
                 _build.stream_of(stats))
    _build.check(err, "vht_stats")
    stats_update.launches += 1
    return stats


stats_update.launches = 0

