"""Batched serving: prompt replay into the caches, then greedy
decode (``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_4b \\
      --smoke --device cpu --batch 4 --prompt-len 64 --gen-len 32

Without ``--device`` it runs on the CUDA card, and raises without one.
The weights are random, drawn by ``init_params`` from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.lm import LanguageModel


def prefill_into_cache(model, tokens, cache):
    """Sequential prefill through decode steps (correct for every family;
    the full-sequence kernels run in ``make_prefill_step``).  Returns the
    last step's logits [B,1,V] and the caches."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
    return logits, cache


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompt, gen_len: int):
    """Replay ``prompt`` [B,P] into fresh caches, then decode greedily to
    ``gen_len`` tokens in all.  Returns {"tokens": [B,gen_len] int32,
    "prefill_logits": [B,1,V], "prefill_s", "decode_s"} (host
    clock, each ended by a device synchronize)."""
    B, P = prompt.shape
    dev = model.device
    cache = model.init_cache(B, P + gen_len)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(model, prompt, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    serve = make_serve_step(model.cfg)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        tok, cache = serve(model, cache, tok, P + i)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, 1), "prefill_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


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
