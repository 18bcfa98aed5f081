"""The VHT statistics update, ``stats[n, j, b, c] += sum_i 1[leaf_i = n]
1[xbin_ij = b] 1[y_i = c] w_i`` (paper Alg. 2), in place.

On a CUDA tensor it launches the hand-written kernel of
``csrc/vht_stats.cu`` (one atomicAdd per instance and attribute); on a CPU
tensor it runs the plain version of ``ref.py``.  Unlike the JAX package,
which returns a new array, both update ``stats`` in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vht_stats.ref import stats_update_ref

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def stats_update(stats, leaf, xbin, y, w):
    """stats: [N, m, bins, C] f32; leaf, y: [B] i32; xbin: [B, m] i32;
    w: [B] f32.  Updates ``stats`` in place and returns it."""
    if stats.device.type == "cpu":
        return stats_update_ref(stats, leaf, xbin, y, w)
    N, m, bins, C = stats.shape
    B = leaf.shape[0]
    _build.check_tensor(stats, torch.float32, (N, m, bins, C), "stats")
    _build.check_tensor(leaf, torch.int32, (B,), "leaf", stats.device)
    _build.check_tensor(xbin, torch.int32, (B, m), "xbin", stats.device)
    _build.check_tensor(y, torch.int32, (B,), "y", stats.device)
    _build.check_tensor(w, torch.float32, (B,), "w", stats.device)
    if B * m == 0:
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

