"""Float arithmetic in the order and rounding of the JAX package on the CPU,
so that the port's results agree with it bit for bit.

XLA's CPU backend contracts a product that feeds a sum into one fused
multiply-add, rounded once, and computes ``jnp.cumsum`` as a running sum
from the first element.  PyTorch rounds every product, and its
``torch.cumsum`` adds in float64 on the CPU and in a scan order on the
card.  Whole-array sums in XLA's order are ``kernels.rule_stats.batch_sum``.
XLA's float32 square root is the processor's, correctly rounded; PyTorch's
vectorized one on the CPU can miss by an ulp.  XLA divides by a scalar
constant as a product with its float32 reciprocal (``reciprocal``).
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


def reciprocal(c):
    """The float32 reciprocal of a Python number ``c``, as a Python float.
    XLA's CPU backend divides by a scalar constant (``jnp.mean`` over a
    fixed axis, too) as a product with it, which differs from the quotient
    in the last bit where ``1 / c`` is not exact."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt(x):
    """The correctly rounded float32 square root, as XLA takes it on the
    CPU: taken in float64 and rounded once to float32, which is exact for
    a square root.  (``torch.sqrt`` of float32 on the CPU is off by an ulp
    in about 0.7 % of arguments.)"""
    return torch.sqrt(x.double()).float()


def cumsum(x):
    """``jnp.cumsum`` over the last axis as XLA computes it on the CPU: a
    running sum from the first element."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, -1)
