"""Batched serving: prompt replay into the caches, then greedy
decode (``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_4b \\
      --smoke --device cpu --batch 4 --prompt-len 64 --gen-len 32

Without ``--device`` it runs on the CUDA card, and raises without one.
The weights are random, drawn by ``init_params`` from ``--seed``.

The JAX package jits its decode step (``jax.jit(make_serve_step(cfg),
donate_argnums=(1,))``).  Here the decode step is captured once per
``generate`` into a CUDA graph (``core.compiled.compile_step``) over a
carry of the caches, the token and its index: each replay writes the
caches in place, puts the greedy token in the token buffer and advances
the index, all on the device.  The prompt replay runs the same graph, a
prompt token copied into the token buffer before each replay.  On the CPU
the same step runs eagerly; ``compiled=False`` runs it eagerly anywhere.
The full-sequence prefill step (``make_prefill_step``) stays eager: it
keeps the card busy (PERF.md section 5).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.compiled import compile_step
from repro_torch.device import resolve_device
from repro_torch.models.lm import LanguageModel


def decode_carry(cache, token):
    """The decode step's carry from position 0: the caches, the [B,1] int32
    token to run and its absolute position, a 0-dim int32 tensor on the
    token's device."""
    return {"cache": cache, "token": token.to(torch.int32),
            "index": torch.zeros((), dtype=torch.int32, device=token.device)}


def make_decode_step(model):
    """``step(carry) -> (carry, logits [B,1,V])``: the greedy serve step
    (``launch.steps.make_serve_step``) over a carry, its logits kept for
    the prompt replay; the carry's token becomes the greedy next token and
    its index moves one on, on the device."""

    def step(carry):
        logits, cache = model.decode_step(carry["cache"], carry["token"],
                                          carry["index"])
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return {"cache": cache, "token": nxt,
                "index": carry["index"] + 1}, logits

    return step


def _replay(step, carry, tokens):
    """Each token of ``tokens`` [B,P] through ``step`` in turn; returns
    the last step's logits and the carry."""
    logits = None
    for i in range(tokens.shape[1]):
        carry, logits = step({**carry,
                              "token": tokens[:, i:i + 1].to(torch.int32)})
    return logits, carry


def prefill_into_cache(model, tokens, cache):
    """Sequential prefill through the compiled decode step (correct for
    every family; the full-sequence kernels run in ``make_prefill_step``),
    from position 0.  Returns the last step's logits [B,1,V] and the
    caches: on the card the compiled step's own (``cache`` is left as it
    was), on the CPU ``cache`` written in place."""
    carry = decode_carry(cache, tokens[:, :1])
    step = compile_step(make_decode_step(model), carry)
    logits, carry = _replay(step, carry, tokens)
    return logits, carry["cache"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompt, gen_len: int, *, compiled: bool = True):
    """Replay ``prompt`` [B,P] into fresh caches, then decode greedily to
    ``gen_len`` tokens in all, both through one compiled decode step
    (``compiled=False``: the same step, eager).  Returns {"tokens":
    [B,gen_len] int32, "prefill_logits": [B,1,V], "compile_s",
    "prefill_s", "decode_s"} (host clock, each ended by a device
    synchronize; "compile_s" is the capture, 0 when not compiled)."""
    B, P = prompt.shape
    dev = model.device
    carry = decode_carry(model.init_cache(B, P + gen_len), prompt[:, :1])
    step = make_decode_step(model)
    _sync(dev)
    t0 = time.perf_counter()
    if compiled:
        step = compile_step(step, carry)
    _sync(dev)
    t_compile = time.perf_counter() - t0 if compiled else 0.0
    t0 = time.perf_counter()
    logits, carry = _replay(step, carry, prompt)
    logits = logits.clone()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [carry["token"].clone()]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        carry, _ = step(carry)
        out.append(carry["token"].clone())
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, 1), "prefill_logits": logits,
            "compile_s": t_compile, "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model = LanguageModel.init(cfg, g, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=g, device=dev, dtype=torch.int32)
    res = generate(model, prompt, args.gen_len)
    tps = args.batch * (args.gen_len - 1) / max(res["decode_s"], 1e-9)
    print(f"[serve] {cfg.name} on {dev}: prefill {args.prompt_len} tok in "
          f"{res['prefill_s']:.2f}s; decode {tps:.1f} tok/s; "
          f"sample={res['tokens'][0, :8].tolist()}", flush=True)
    return res["tokens"]


if __name__ == "__main__":
    main()
