"""The Mamba-1 selective scan, ``h <- exp(dt*A)*h + dt*x*B``, ``y_t = h.C_t``,
with the state carried in (``h0``) and out (``hT``).

On CUDA tensors it launches the hand-written kernel of
``csrc/selective_scan.cu`` (four lanes per batch row and channel, each
holding a quarter of the state in registers; tiles of dt, x, B and C
staged in shared memory by ``cp.async`` ahead of the chain; time in
order); on CPU tensors it runs the plain version of ``ref.py``.  Any
other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

N_MAX = 64          # the kernel keeps the state of a channel in registers
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def selective_scan(dt, x, Bm, Cm, A, h0):
    """dt, x: [B,c,dI]; Bm, Cm: [B,c,N], all float32 or all bf16; A: [dI,N]
    f32; h0: [B,dI,N] f32.  Returns (y [B,c,dI] in dt's dtype, hT [B,dI,N]
    f32).  The inputs are made contiguous (dt and the B, C columns are
    often slices of one projection)."""
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, x, Bm, Cm, A, h0)
    B, c, dI = dt.shape
    N = A.shape[-1]
    if dt.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective_scan takes float32 or bf16, got {dt.dtype}")
    if not 1 <= N <= N_MAX:
        raise ValueError(f"selective_scan takes 1 <= N <= {N_MAX}, got {N}")
    dt, x, Bm, Cm, A, h0 = (t.contiguous() for t in (dt, x, Bm, Cm, A, h0))
    _build.check_tensor(dt, dt.dtype, (B, c, dI), "dt")
    _build.check_tensor(x, dt.dtype, (B, c, dI), "x", dt.device)
    _build.check_tensor(Bm, dt.dtype, (B, c, N), "Bm", dt.device)
    _build.check_tensor(Cm, dt.dtype, (B, c, N), "Cm", dt.device)
    _build.check_tensor(A, torch.float32, (dI, N), "A", dt.device)
    _build.check_tensor(h0, torch.float32, (B, dI, N), "h0", dt.device)
    y = torch.empty_like(dt)
    if B * dI == 0 or c == 0:
        return y, h0.clone()
    hT = torch.empty((B, dI, N), dtype=torch.float32, device=dt.device)
    fn = _build.function("selective_scan", "selective_scan_launch", _ARGTYPES)
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                 B, c, dI, N, int(dt.dtype == torch.bfloat16),
                 _build.stream_of(dt))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, hT


selective_scan.launches = 0
