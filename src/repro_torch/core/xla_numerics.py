"""Float arithmetic in the order and rounding of the JAX package on the CPU,
so that the port's results agree with it bit for bit.

XLA's CPU backend contracts a product that feeds a sum into one fused
multiply-add, rounded once, and computes ``jnp.cumsum`` as a running sum
from the first element.  PyTorch rounds every product, and its
``torch.cumsum`` adds in float64 on the CPU and in a scan order on the
card.  Whole-array sums in XLA's order are ``kernels.rule_stats.batch_sum``.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c):
    """``a * b + c`` with one rounding to float32, as XLA's CPU backend
    computes it where it contracts the two.  It is taken in float64: the
    product of two float32 is exact there, and the sum is rounded twice
    (to float64, then to float32), which differs from one rounding only
    when the float64 sum falls exactly halfway between two float32 values.
    A Python float is taken as float32 first."""
    def wide(v):
        return v.double() if isinstance(v, torch.Tensor) else \
            float(np.float32(v))

    return (wide(a) * wide(b) + wide(c)).float()


def cumsum(x):
    """``jnp.cumsum`` over the last axis as XLA computes it on the CPU: a
    running sum from the first element."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, -1)
