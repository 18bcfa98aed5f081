"""LanguageModel of the port: the ``dense`` (GQA attention + MLP blocks) and
``ssm`` (Mamba-1 blocks) families of ``repro/models/lm.py``.

The JAX package scans one block over layer-stacked parameters; here the
blocks are a ``ModuleList`` run as a Python loop, each holding its own
layer's parameters.  Parameter and cache trees are declared with
``ParamDef`` as in the JAX package, with a list of per-layer trees where
the JAX package has one stacked tree (``convert.params_from_numpy`` splits
the JAX stacks).  Other families (moe, hybrid, vlm, audio), MLA, learned
positions and frontends are not ported and are refused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, init_params, map_defs

f32 = torch.float32
PORTED_FAMILIES = ("dense", "ssm")


def _check_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port runs "
            f"{PORTED_FAMILIES}")
    if (cfg.attn_type == "mla" or cfg.learned_pos_emb or cfg.frontend != "none"
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: MLA, learned positions, frontends and "
            "encoder-decoders are not ported")


def stacks(cfg) -> list[tuple[str, str, int]]:
    """[(stack name, block kind, n layers)], as the JAX package names them."""
    _check_ported(cfg)
    return [("body", "mamba" if cfg.family == "ssm" else "dense",
             cfg.n_layers)]


def block_defs(cfg, kind: str):
    if kind == "mamba":
        return {"ln1": L.norm_defs(cfg, cfg.d_model), "mix": L.mamba_defs(cfg)}
    return {"ln1": L.norm_defs(cfg, cfg.d_model),
            "mix": L.attention_defs(cfg),
            "ln2": L.norm_defs(cfg, cfg.d_model),
            "mlp": L.mlp_defs(cfg)}


def param_defs(cfg):
    V, D = cfg.padded_vocab, cfg.d_model
    defs = {"embed": ParamDef((V, D), ("vocab", "embed"), init="small"),
            "ln_f": L.norm_defs(cfg, D)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("embed", "vocab"), init="small")
    for name, kind, n in stacks(cfg):
        layer = map_defs(lambda d: dataclasses.replace(d, layers=n),
                           block_defs(cfg, kind))
        defs[name] = [layer for _ in range(n)]
    return defs


def cache_defs(cfg, B: int, S: int):
    """Decode-time caches of a batch of B sequences of up to S tokens:
    mamba {"conv": [B,K-1,dI] bf16, "ssm": [B,dI,N] f32}; dense {"k", "v":
    [B,W,K,hd] bf16}, W = S, or min(window, S) for a rolling window."""
    bf = torch.bfloat16
    out = {}
    for name, kind, n in stacks(cfg):
        if kind == "mamba":
            blk = {"conv": ParamDef((B, cfg.ssm_conv - 1, cfg.d_inner),
                                    ("batch", None, "d_inner"), init="zeros",
                                    dtype=bf),
                   "ssm": ParamDef((B, cfg.d_inner, cfg.ssm_state),
                                   ("batch", "d_inner", "state"),
                                   init="zeros", dtype=f32)}
        else:
            W = min(cfg.window or S, S)
            kv = ParamDef((B, W, cfg.kv_heads_padded, cfg.head_dim),
                          ("batch", "kv_seq", "kv_heads", "head_dim"),
                          init="zeros", dtype=bf)
            blk = {"k": kv, "v": kv}
        out[name] = [blk for _ in range(n)]
    return out


class Block(nn.Module):
    """One layer: pre-norm mixer (+ pre-norm MLP for dense), residual."""

    def __init__(self, kind: str, cfg, p):
        super().__init__()
        self.kind = kind
        self.ln1 = L.Norm(p["ln1"])
        if kind == "mamba":
            self.mix = L.Mamba(cfg, p["mix"])
        else:
            self.mix = L.Attention(cfg, p["mix"])
            self.ln2 = L.Norm(p["ln2"])
            self.mlp = L.MLP(cfg, p["mlp"])

    def forward(self, x, *, positions=None, cache=None, index=None):
        h = self.ln1(x)
        if self.kind == "mamba":
            y, cache = self.mix(h, cache=cache)
            return x + y, cache
        y, cache = self.mix(h, positions=positions, cache=cache, index=index)
        x = x + y
        return x + self.mlp(self.ln2(x)), cache


class LanguageModel(nn.Module):
    """A config-driven LM holding its weights (no gradients).

    ``forward(tokens)`` runs the full sequence through the kernels and
    returns (logits [B,S,padded_vocab] f32, aux); ``decode_step(cache,
    token, index)`` runs one token against the caches, which it updates in
    place, and reads nothing on the host."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        ((name, kind, _),) = stacks(cfg)
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.ln_f = L.Norm(params["ln_f"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
        self.body = nn.ModuleList(Block(kind, cfg, p) for p in params[name])

    @classmethod
    def init(cls, cfg, generator=None, device=None):
        """Random weights from ``init_params`` on ``device`` (None means
        cuda, and raises without one)."""
        return cls(cfg, init_params(param_defs(cfg), generator, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, B: int, S: int):
        return init_params(cache_defs(self.cfg, B, S), device=self.device)

    def _embed(self, tokens):
        return F.embedding(tokens, self.embed)

    def _logits(self, x):
        cfg = self.cfg
        x = self.ln_f(x)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = L._proj(x, head).to(f32)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    def forward(self, tokens):
        """Full-sequence forward: (logits, aux).  tokens: [B,S] int."""
        hidden, aux = self.forward_hidden(tokens)
        return self._logits(hidden), aux

    def forward_hidden(self, tokens):
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        for blk in self.body:
            x, _ = blk(x, positions=positions)
        return x, torch.zeros((), dtype=f32, device=x.device)

    def decode_step(self, cache, token, index):
        """One decode step.  token: [B,1] int; index: the absolute position
        of the token, a 0-dim integer tensor on the model's device (as the
        JAX package traces it; ``launch.serve`` advances it on the device)
        or a Python int.  Returns (logits [B,1,V], cache), the caches
        written in place."""
        x = self._embed(token)
        index = torch.as_tensor(index, device=x.device)
        positions = index.reshape(1, 1)
        ((name, _, _),) = stacks(self.cfg)
        for blk, c in zip(self.body, cache[name]):
            x, _ = blk(x, positions=positions, cache=c, index=index)
        return self._logits(x), cache
