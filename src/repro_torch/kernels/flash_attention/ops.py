"""Attention with an online softmax: causal, sliding-window or full, with
GQA kv heads shared by their query heads.

On CUDA tensors it launches the hand-written kernel of
``csrc/flash_attention.cu``.  bf16 runs on Hopper's tensor cores: one
warpgroup per 64 query rows of one head, K and V tiles by TMA through a
two-stage shared-memory ring, both products as ``wgmma`` with float32
accumulators and the softmax state in registers.  float32 (off every
served path) runs the products as FMAs on the CUDA cores.  On CPU tensors
it runs the plain version of ``ref.py``, which materializes the scores.
Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B,S,H,hd]; k, v: [B,T,K,hd] with H = K*G; float32 or bf16, all
    alike.  Query head h reads kv head h // G (``jnp.repeat`` order),
    without a copy.  Returns [B,S,H,hd] in q's dtype.  S and T are any
    lengths.  A query row with no key to attend to (possible only with a
    window and S > T) has no defined output: the kernel gives the mean of
    the values its tiles visited, or zeros, the plain version the mean of
    all values."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bf16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {hd}")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not share {K} kv heads evenly")
    if B * H > 65535:
        raise ValueError(f"flash_attention takes B*H <= 65535, got {B * H}")
    # the bf16 kernel's tensor maps take 16-byte aligned bases
    q, k, v = (_build.aligned16(t.contiguous()) for t in (q, k, v))
    _build.check_tensor(q, q.dtype, (B, S, H, hd), "q")
    _build.check_tensor(k, q.dtype, (B, T, K, hd), "k", q.device)
    _build.check_tensor(v, q.dtype, (B, T, K, hd), "v", q.device)
    out = torch.empty_like(q)
    if B * S * H == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, T, H, K, hd, int(bool(causal)), int(window or 0),
                 int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
