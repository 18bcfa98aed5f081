"""The prefill and serve steps of the LM zoo (``repro/launch/steps.py``).

In the JAX package a step takes the parameter tree; here the
``LanguageModel`` holds its weights and takes its place.  Training steps
are not ported yet.
"""

from __future__ import annotations

import torch


def _same_config(model, cfg) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name} got a {model.cfg.name} "
                         "model")


def make_prefill_step(cfg):
    """Full-sequence forward returning the last position's logits (the
    serving TTFT path): the kernels run once per layer."""

    def prefill_step(model, batch):
        _same_config(model, cfg)
        logits, _ = model.forward(batch["tokens"])
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg):
    """One greedy decode step: (next token [B,1] int32, caches updated in
    place).  ``index``, the token's absolute position, is a 0-dim integer
    tensor on the model's device, as the JAX step traces it (or a Python
    int); the step reads nothing on the host, so it captures into a CUDA
    graph (``launch.serve``)."""

    def serve_step(model, cache, token, index):
        _same_config(model, cfg)
        logits, cache = model.decode_step(cache, token, index)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step
