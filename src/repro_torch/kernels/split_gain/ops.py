"""The split criterion (paper Alg. 3): information gain of every (node,
attribute, threshold bin), ``NEG`` where a side is empty.

On a CUDA tensor it launches the hand-written kernel of
``csrc/split_gain.cu`` (one thread per (node, attribute, bin), the rows
staged in shared memory); on a CPU tensor it runs the plain version of
``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.split_gain.ref import NEG, split_gain_ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
MAX_CLASSES = 32        # the largest class count csrc/split_gain.cu takes
ROW_BYTES = 48 * 1024   # one row's bins x C counts and one float must fit


def split_gain(stats):
    """stats: [N, m, bins, C] f32 -> gains [N, m, bins] f32."""
    if stats.device.type == "cpu":
        return split_gain_ref(stats)
    N, m, bins, C = stats.shape
    _build.check_tensor(stats, torch.float32, (N, m, bins, C), "stats")
    if C > MAX_CLASSES:
        raise ValueError(f"split_gain kernel takes at most {MAX_CLASSES} "
                         f"classes, got {C}")
    if (bins * C + 1) * 4 > ROW_BYTES:
        raise ValueError(f"split_gain kernel stages a row of bins x C = "
                         f"{bins} x {C} counts in {ROW_BYTES} bytes of "
                         "shared memory; it does not fit")
    gain = torch.empty((N, m, bins), dtype=torch.float32, device=stats.device)
    if gain.numel() == 0:
        return gain
    fn = _build.function("split_gain", "split_gain_launch", _ARGTYPES)
    with torch.cuda.device(stats.device):
        err = fn(stats.data_ptr(), gain.data_ptr(), N * m, bins, C,
                 _build.stream_of(stats))
    _build.check(err, "split_gain")
    split_gain.launches += 1
    return gain


split_gain.launches = 0

__all__ = ["NEG", "split_gain"]
