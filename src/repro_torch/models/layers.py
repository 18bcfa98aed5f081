"""Building blocks of the LM zoo for the port: norms, rotary embeddings, GQA
attention, MLPs and the Mamba-1 block (``repro/models/layers.py``).

Conventions, as in the JAX package: activations are [batch, seq, d_model]
bf16, reductions and the softmax and scan arithmetic float32, and each
block keeps its parameters under the JAX package's names.  A temporal
mixing layer has two entry points: the full sequence (prefill), through
the ``flash_attention`` or ``selective_scan`` kernel, and one decode step
against a cache.  The port writes its caches in place (the JAX package
returns new ones): a KV cache at full width is large.  Nothing shards:
the port runs on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.params import ParamDef

f32 = torch.float32
NEG_INF = -1e30


class ParamModule(nn.Module):
    """A module whose parameters are given as a dict of tensors and kept
    under those names, without gradients (the port serves)."""

    def __init__(self, p: dict):
        super().__init__()
        for name, t in p.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def silu(x):
    """x * sigmoid(x), sigmoid = 1 / (1 + exp(-x)), one op at a time in x's
    dtype: ``jax.nn.silu`` as XLA's CPU backend rounds it in bf16."""
    return x * (1 / (1 + torch.exp(-x)))


def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w): x [B,S,D] times w [D, ...]."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:])


# ---------------------------------------------------------------- norms

def norm_defs(cfg, d: int):
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), init="ones", dtype=f32),
                "bias": ParamDef((d,), ("embed",), init="zeros", dtype=f32)}
    return {"scale": ParamDef((d,), ("embed",), init="ones", dtype=f32)}


def apply_norm(p, x, eps: float = 1e-6):
    """RMSNorm (or LayerNorm when ``p`` has a bias) in float32, cast back
    to x's dtype."""
    xf = x.to(f32)
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


class Norm(ParamModule):
    def forward(self, x):
        return apply_norm(dict(self.named_parameters()), x)


# ---------------------------------------------------------------- rotary

def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Rotates
    the two halves of the head dims (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, hd, 2, dtype=f32, device=x.device) / hd)            # [hd/2]
    ang = positions[..., None].to(f32) * freqs                   # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def decode_attention(q, k_cache, v_cache, valid):
    """q: [B,1,H,hd]; caches [B,W,K,hd]; valid: bool [W], the cache entries
    to attend to.  Keys were rotated at their absolute positions before
    they were written, so the storage order of a rolling buffer does not
    matter, only the mask."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qr = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qr.to(f32), k_cache.to(f32))
    s = s * (1.0 / math.sqrt(hd))
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=f32,
                                         device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(f32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_defs(cfg):
    D, H, K, hd = (cfg.d_model, cfg.heads_padded, cfg.kv_heads_padded,
                   cfg.head_dim)
    d = {"wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim")),
         "wk": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim")),
         "wv": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim")),
         "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        d["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        d["bk"] = ParamDef((K, hd), ("kv_heads", "head_dim"), init="zeros")
        d["bv"] = ParamDef((K, hd), ("kv_heads", "head_dim"), init="zeros")
    return d


class Attention(ParamModule):
    """GQA self-attention with rotary embeddings and optional qkv bias."""

    def __init__(self, cfg, p):
        super().__init__(p)
        self.cfg = cfg

    def forward(self, x, *, positions=None, cache=None, index=None):
        """x: [B,S,D].  Without a cache: the full sequence through the
        flash_attention kernel, causal, within ``cfg.window`` when it is
        set; returns (y, None).  With a cache ({"k",
        "v"}: [B,W,K,hd], a rolling buffer when W is the window) and the
        absolute position ``index`` of the first new token (a 0-dim integer
        tensor on x's device, as JAX traces it, or a Python int): writes
        k, v at (index + s) % W in place and returns (y, cache).  Nothing
        here reads the index on the host, so a decode step captures into a
        CUDA graph that advances the index on the device."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = _proj(x, self.wq), _proj(x, self.wk), _proj(x, self.wv)
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        if positions is None:
            positions = torch.arange(S, device=x.device)[None]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        wo = self.wo.reshape(-1, self.wo.shape[-1])
        if cache is not None:
            W = cache["k"].shape[1]
            index = torch.as_tensor(index, device=x.device)
            at = (index + torch.arange(S, device=x.device)) % W
            cache["k"].index_copy_(1, at, k)
            cache["v"].index_copy_(1, at, v)
            valid = torch.arange(W, device=x.device) < torch.clamp(
                index + 1, max=W)
            out = decode_attention(q, cache["k"], cache["v"], valid)
            return out.reshape(B, S, -1) @ wo, cache
        out = flash_attention(q, k, v, causal=True, window=cfg.window)
        return out.reshape(B, S, -1) @ wo, None


# ---------------------------------------------------------------- MLP

def mlp_defs(cfg, d_ff=None, ff_axis="ff"):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    d = {"wo": ParamDef((Fd, D), (ff_axis, "embed")),
         "wi": ParamDef((D, Fd), ("embed", ff_axis))}
    if cfg.act in ("swiglu", "geglu"):
        d["wg"] = ParamDef((D, Fd), ("embed", ff_axis))
    return d


class MLP(ParamModule):
    def __init__(self, cfg, p):
        super().__init__(p)
        self.act = cfg.act

    def forward(self, x):
        h = _proj(x, self.wi)
        if self.act == "swiglu":
            h = silu(_proj(x, self.wg)) * h
        elif self.act == "geglu":
            h = F.gelu(_proj(x, self.wg), approximate="tanh") * h
        elif self.act == "relu2":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return _proj(h, self.wo)


# ---------------------------------------------------------------- Mamba-1

def mamba_defs(cfg):
    D, dI, N, R, Kc = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_dt_rank, cfg.ssm_conv)
    return {
        "in_proj": ParamDef((D, 2 * dI), ("embed", "d_inner")),
        "conv_w": ParamDef((Kc, dI), ("conv", "d_inner"), scale=0.2),
        "conv_b": ParamDef((dI,), ("d_inner",), init="zeros"),
        "x_proj": ParamDef((dI, R + 2 * N), ("d_inner", None)),
        "dt_proj": ParamDef((R, dI), (None, "d_inner")),
        "dt_bias": ParamDef((dI,), ("d_inner",), init="zeros", dtype=f32),
        "A_log": ParamDef((dI, N), ("d_inner", "state"), init="ones",
                          dtype=f32),
        "D": ParamDef((dI,), ("d_inner",), init="ones", dtype=f32),
        "out_proj": ParamDef((dI, D), ("d_inner", "embed")),
    }


def _causal_depthwise_conv(x, w, b, state=None):
    """x: [B,S,C]; w: [K,C]; in x's dtype.  ``state``: the last K-1 inputs
    [B,K-1,C] of the decode path; returns (y, new state or None)."""
    K, S = w.shape[0], x.shape[1]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], 1)              # [B,K-1+S,C]
        new_state = xin[:, -(K - 1):]
    else:
        xin, new_state = F.pad(x, (0, 0, K - 1, 0)), None
    y = sum(xin[:, i:i + S] * w[i] for i in range(K))
    return y + b, new_state


class Mamba(ParamModule):
    """Mamba-1 mixer.  cache: {"conv": [B,K-1,dI] bf16, "ssm": [B,dI,N]
    f32} for a decode step."""

    def __init__(self, cfg, p):
        super().__init__(p)
        self.cfg = cfg

    def forward(self, x, cache=None):
        cfg = self.cfg
        B, S, _ = x.shape
        dI, N, R = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
        xi, z = _proj(x, self.in_proj).split(dI, dim=-1)
        conv_state = cache["conv"] if cache is not None else None
        xi, new_conv = _causal_depthwise_conv(xi, self.conv_w, self.conv_b,
                                              conv_state)
        xi = silu(xi)

        proj = _proj(xi, self.x_proj).to(f32)
        dt, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
        dt = F.softplus(dt @ self.dt_proj.to(f32) + self.dt_bias)  # [B,S,dI]
        A = -torch.exp(self.A_log)                                  # [dI,N]
        xif = xi.to(f32)

        if cache is not None:              # one decode step
            dA = torch.exp(dt[:, 0, :, None] * A)                   # [B,dI,N]
            dBx = dt[:, 0, :, None] * Bm[:, 0, None, :] * xif[:, 0, :, None]
            h = cache["ssm"] * dA + dBx
            y = torch.einsum("ben,bn->be", h, Cm[:, 0]) + self.D * xif[:, 0]
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(h)
            y = y[:, None].to(x.dtype) * silu(z)
            return _proj(y, self.out_proj), cache

        # the whole sequence in one scan from a zero state
        h0 = torch.zeros((B, dI, N), dtype=f32, device=x.device)
        y, _ = selective_scan(dt, xif, Bm, Cm, A, h0)
        y = y + self.D * xif
        y = y.to(x.dtype) * silu(z)
        return _proj(y, self.out_proj), None
