"""Plain PyTorch version of attention (mirrors
``repro/kernels/flash_attention/ref.py::attention_ref``): the scores are
materialized in float32, masked with -1e30, and the softmax is float32."""

from __future__ import annotations

import math

import torch

NEG = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,S,H,hd]; k, v: [B,T,K,hd] with H = K*G (query head h reads kv
    head h // G: the kv heads are repeated here).  Keys t attend to query
    s where t <= s (causal), s - t < window (window > 0).  Returns
    [B,S,H,hd] in q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    f32 = torch.float32
    s = torch.einsum("bshd,bthd->bhst", q.to(f32), k.to(f32)) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full((), NEG, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v.to(f32))
    return o.to(q.dtype)
