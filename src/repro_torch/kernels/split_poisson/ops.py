"""The ensembles' member weights in one launch: ``(key', k1) = split(key)``
and ``w = poisson(k1, lam, (M, B))`` as float32, JAX's threefry2x32 draws
bit for bit (``repro/ml/ensemble.py:154,178``).

On a CUDA tensor it launches the hand-written kernel of
``csrc/split_poisson.cu``: a warp of each block works out the chain of
round keys, which every draw shares, into a shared table a few rounds
ahead, and a thread per draw runs Knuth's loop on it until the block's
last draw is done, so there is no loop on the host and the launch can be
captured in a CUDA graph.  On a CPU tensor it runs the plain
version of ``ref.py``, whose loop reads its condition on the host.

The kernel replaces no TPU kernel (the JAX package draws with XLA), so it
is counted in ``kernels.COUNTED`` and not in ``kernels.KERNELS``.  It
takes only rates below 10, where JAX runs Knuth's loop, and checks none
(it reads nothing back): the ensembles' rates are 1 + 2 * cum_err, at
most 3.  The plain version raises ``ValueError`` for a rate of 10 or more.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.split_poisson.ref import split_poisson_ref

_ARGTYPES = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) + (ctypes.c_void_p,) * 2
             + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def split_poisson(key, lam, shape):
    """key: [2] uint32; lam: [M, 1] or [M, B] f32, each below 10;
    shape: (M, B).  Returns (key' [2] uint32, w [M, B] f32); ``key`` is
    left as it was."""
    M, B = shape
    if lam.device.type == "cpu":
        return split_poisson_ref(key, lam, shape)
    dev = lam.device
    _build.check_tensor(key, torch.uint32, (2,), "key", dev)
    _build.check_tensor(lam, torch.float32, (M, lam.shape[-1]), "lam", dev)
    if lam.shape[-1] not in (1, B):
        raise ValueError(f"lam must be [{M}, 1] or [{M}, {B}], got "
                         f"{tuple(lam.shape)}")
    w = torch.empty((M, B), dtype=torch.float32, device=dev)
    key_out = torch.empty(2, dtype=torch.uint32, device=dev)
    fn = _build.function("split_poisson", "split_poisson_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(key.data_ptr(), lam.data_ptr(), lam.shape[-1], w.data_ptr(),
                 key_out.data_ptr(), M * B, B, _build.stream_of(lam))
    _build.check(err, "split_poisson")
    split_poisson.launches += 1
    return key_out, w


split_poisson.launches = 0
