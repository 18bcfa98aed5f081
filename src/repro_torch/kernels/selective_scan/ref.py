"""Plain PyTorch version of the Mamba-1 selective scan (mirrors
``repro/kernels/selective_scan/ref.py``): a loop over time in float32."""

from __future__ import annotations

import torch


def selective_scan_ref(dt, x, Bm, Cm, A, h0):
    """dt, x: [B,c,dI]; Bm, Cm: [B,c,N]; A: [dI,N]; h0: [B,dI,N].

    ``h <- exp(dt*A) * h + dt*B*x`` and ``y_t = h . C_t`` for each step.
    Returns (y [B,c,dI] in dt's dtype, hT [B,dI,N] float32); the math is
    float32 throughout."""
    f32 = torch.float32
    dtf, xf, bf, cf = (a.to(f32) for a in (dt, x, Bm, Cm))
    A, h = A.to(f32), h0.to(f32)
    ys = []
    for t in range(dtf.shape[1]):
        dt_t = dtf[:, t, :, None]                          # [B,dI,1]
        h = torch.exp(dt_t * A) * h + dt_t * bf[:, t, None, :] * xf[:, t, :, None]
        ys.append(torch.einsum("ben,bn->be", h, cf[:, t]))
    y = torch.stack(ys, 1) if ys else dtf.new_zeros(dtf.shape)
    return y.to(dt.dtype), h
