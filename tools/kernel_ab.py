#!/usr/bin/env python3
"""Hold this checkout's LM kernels against another checkout's on one card.

    python3 tools/kernel_ab.py OTHER [--json PATH]

OTHER is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit).  Both checkouts'
``src/repro_torch/csrc/selective_scan.cu`` and ``flash_attention.cu`` are
built with the port's nvcc flags, and both C entry points run on the same
inputs at the LM prefill shapes of ``chip_smoke.py``:

- selective_scan at falcon_mamba_7b's shape (B = 4, L = 2048, dI = 8192,
  N = 16, float32): the number of final-state elements that differ bit for
  bit, and the largest difference of y;
- flash_attention at qwen15_4b's shape (B = 4, S = T = 2048, 20 heads of
  128, bf16, causal): the largest difference of the outputs, each against
  the plain version.

Device ms per launch are taken in turns (other, this, this, other) with
``chip_smoke.device_ms``, beside ``F.scaled_dot_product_attention``'s.
Needs a CUDA device and nvcc; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("selective_scan", "flash_attention")


def build(tag, csrc):
    """Build the LM kernels of ``csrc`` into build/kernel_ab/<tag>/, all
    nvcc processes started together; returns {name: CDLL} and the ptxas
    lines of each."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "kernel_ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in KERNELS}
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {tag} {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs, ptxas


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py: no CUDA device")
    from chip_smoke import LM_B, LM_S, device_ms, max_abs_err, nvidia_smi
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    libs, ptxas = {}, {}
    for tag, root in (("other", args.other.resolve()), ("this", ROOT)):
        libs[tag], ptxas[tag] = build(tag, root / "src" / "repro_torch" / "csrc")
        for name in KERNELS:
            print(f"ptxas {tag} {name}: " + " | ".join(ptxas[tag][name]),
                  flush=True)
    dev = torch.device("cuda")
    stream = _build.stream_of(torch.empty(1, device=dev))
    result = {"device": torch.cuda.get_device_name(0), "smi": smi}

    # selective_scan, falcon_mamba_7b's prefill shape
    Bs, S, dI, N = LM_B, LM_S, 8192, 16
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt, x, Bm, Cm = (F.softplus(r(Bs, S, dI)) * 0.1, r(Bs, S, dI),
                     r(Bs, S, N) * 0.5, r(Bs, S, N) * 0.5)
    A, h0 = -torch.exp(r(dI, N) * 0.3), r(Bs, dI, N) * 0.1
    outs = {}
    for tag in ("other", "this"):
        fn = entry(libs[tag]["selective_scan"], "selective_scan_launch",
                   ss_ops._ARGTYPES)
        y = torch.empty_like(dt)
        hT = torch.empty_like(h0)

        def run(fn=fn, y=y, hT=hT):
            _build.check(fn(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                            Cm.data_ptr(), A.data_ptr(), h0.data_ptr(),
                            y.data_ptr(), hT.data_ptr(), Bs, S, dI, N, 0,
                            stream), "selective_scan")
        run()
        torch.cuda.synchronize()
        outs[tag] = (run, y, hT)
    y_ref, h_ref = selective_scan_ref(dt, x, Bm, Cm, A, h0)
    (run_o, y_o, h_o), (run_t, y_t, h_t) = outs["other"], outs["this"]
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(device_ms(outs[tag][0]))
    scan = {"shape": [Bs, S, dI, N], "dtype": "float32",
            "hT_bits_differing": int((h_o.view(torch.int32)
                                      != h_t.view(torch.int32)).sum()),
            "hT_elements": h_t.numel(),
            "y_max_abs_diff": max_abs_err(y_t, y_o),
            "y_bits_differing": int((y_o.view(torch.int32)
                                     != y_t.view(torch.int32)).sum()),
            "err_vs_plain": {"other": max(max_abs_err(y_o, y_ref),
                                          max_abs_err(h_o, h_ref)),
                             "this": max(max_abs_err(y_t, y_ref),
                                         max_abs_err(h_t, h_ref))},
            "ms": times}
    result["selective_scan"] = scan
    print(f"selective_scan {scan['shape']} f32: hT bits differing "
          f"{scan['hT_bits_differing']} of {scan['hT_elements']}; y max abs "
          f"diff {scan['y_max_abs_diff']:.3g} ({scan['y_bits_differing']} "
          f"elements differ); vs plain {scan['err_vs_plain']}; device ms "
          f"other {times['other']}, this {times['this']} on {smi}",
          flush=True)
    del dt, x, y_o, y_t, y_ref, outs
    torch.cuda.empty_cache()

    # flash_attention, qwen15_4b's prefill shape
    Bq, H, hd = LM_B, 20, 128
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn((Bq, S, H, hd), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    want = flash_attention_ref(q, k, v, causal=True)
    outs = {}
    for tag in ("other", "this"):
        fn = entry(libs[tag]["flash_attention"], "flash_attention_launch",
                   fa_ops._ARGTYPES)
        o = torch.empty_like(q)

        def run(fn=fn, o=o):
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), Bq, S, S, H, H, hd, 1, 0, 1,
                            stream), "flash_attention")
        run()
        torch.cuda.synchronize()
        outs[tag] = (run, o)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    times = {"other": [], "this": [], "sdpa": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(device_ms(outs[tag][0]))
    times["sdpa"].append(device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)))
    att = {"shape": [Bq, S, S, H, H, hd], "dtype": "bfloat16",
           "max_abs_diff": max_abs_err(outs["this"][1], outs["other"][1]),
           "err_vs_plain": {t: max_abs_err(outs[t][1], want)
                            for t in ("other", "this")},
           "ms": times}
    result["flash_attention"] = att
    print(f"flash_attention {att['shape']} bf16 causal: this vs other max abs"
          f" diff {att['max_abs_diff']:.3g}; vs plain {att['err_vs_plain']};"
          f" device ms other {times['other']}, this {times['this']}, SDPA "
          f"{times['sdpa']} on {smi}", flush=True)
    result["ptxas"] = ptxas
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
