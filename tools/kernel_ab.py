#!/usr/bin/env python3
"""Hold this checkout's kernels against another checkout's on one card.

    python3 tools/kernel_ab.py OTHER [--kernels NAME ...] [--json PATH]

OTHER is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit).  Both checkouts'
``src/repro_torch/csrc/<name>.cu`` are built with the port's nvcc flags
(by default all seven: selective_scan, flash_attention, rule_stats,
split_gain, vht_stats, tree_route and split_poisson; ``--kernels`` takes a
subset), and both C entry points run on the same inputs:

- selective_scan at falcon_mamba_7b's prefill shape (B = 4, L = 2048,
  dI = 8192, N = 16, float32): the number of final-state elements that
  differ bit for bit, and the largest difference of y;
- flash_attention at qwen15_4b's prefill shape (B = 4, S = T = 2048, 20
  heads of 128, bf16, causal): the largest difference of the outputs, each
  against the plain version;
- rule_stats at the AMRules main path's moment statistics ([65, 40, 8, 3],
  B = 512 and 510, rows drawn as chip_smoke.py draws them; a skewed batch
  with seven in ten instances in the default rule's row; a batch in one
  cell) and its three segment_sum shapes (the per-rule sums [65, 1, 1, 3],
  the batch sum's levels [16, 1, 1, 4] and [1, 1, 1, 4]), and CluStream's
  CF scatter x | x^2 at d128-K256 ([257, 1, 1, 256]) and d32-K100 ([101,
  1, 1, 64]), B = 512, rows spread as a blob stream spreads them, and all
  in one segment (skipped against a checkout without the wide form): the
  elements that differ bit for bit from each other and from the plain
  version;
- split_gain at the VHT main path's gathered tile [16, 1000, 8, 2] and
  full fallback [255, 1000, 8, 2]: the elements that differ bit for bit,
  and the NEG masks;
- vht_stats at the VHT main path's [255, 1000, 8, 2], B = 512, 0/1
  weights on integer counts: a batch uniform over the 255 leaves (as
  chip_smoke.py draws it), a batch all in leaf 0 (how every stream
  starts), batches routed through seeded random trees of 51 nodes (the
  size of the main path's learned tree) and of 191 and 255 nodes (a
  mature tree's 96 and 128 leaves), batches uniform over 16 to 128
  leaves (around the kernel's switch between its two paths at B / 8 = 64
  leaves), and fractional weights on fractional counts, uniform and
  through the 51-node tree: the elements that differ bit for bit from
  each other and from the plain version (the largest difference for
  fractional weights);
- tree_route at B = 512, m = 1000: a random full tree of 255 nodes at
  M = 1 and M = 5, the seeded tree of 51 nodes, and a one-node tree at
  B = 1, the launch floor: the leaf ids that differ;
- split_poisson at the ensembles' [10, 512]: bagging's rate 1, boosting's
  rates (1 + 2 x a uniform, per element) and rates of 9.99 (the longest
  chains): the keys and weights that differ bit for bit from each other
  and from the plain version, and the largest draw.

Device ms per launch are taken in turns (other, this, this, other) with
``chip_smoke.device_ms``, beside ``F.scaled_dot_product_attention``'s for
attention.  Needs a CUDA device and nvcc; prints one JSON object as its
last line.
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

KERNELS = ("selective_scan", "flash_attention", "rule_stats",
           "split_gain", "vht_stats", "tree_route", "split_poisson")


def build(tag, csrc, kernels):
    """Build ``kernels`` of ``csrc`` into build/kernel_ab/<tag>/, all nvcc
    processes started together; returns {name: CDLL} and the ptxas lines
    of each."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "kernel_ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in kernels}
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


def bits_differing(a, b):
    """Elements of two float32 tensors that differ bit for bit."""
    import torch
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def in_turns(runs):
    """Device ms of each run, in turns other, this, this, other."""
    from chip_smoke import device_ms
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(device_ms(runs[tag]))
    return times


def ab_selective_scan(libs, stream, smi):
    import torch
    import torch.nn.functional as F
    from chip_smoke import LM_B, LM_S, max_abs_err
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    dev = torch.device("cuda")
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
    times = in_turns({tag: outs[tag][0] for tag in outs})
    scan = {"shape": [Bs, S, dI, N], "dtype": "float32",
            "hT_bits_differing": bits_differing(h_o, h_t),
            "hT_elements": h_t.numel(),
            "y_max_abs_diff": max_abs_err(y_t, y_o),
            "y_bits_differing": bits_differing(y_o, y_t),
            "err_vs_plain": {"other": max(max_abs_err(y_o, y_ref),
                                          max_abs_err(h_o, h_ref)),
                             "this": max(max_abs_err(y_t, y_ref),
                                         max_abs_err(h_t, h_ref))},
            "ms": times}
    print(f"selective_scan {scan['shape']} f32: hT bits differing "
          f"{scan['hT_bits_differing']} of {scan['hT_elements']}; y max abs "
          f"diff {scan['y_max_abs_diff']:.3g} ({scan['y_bits_differing']} "
          f"elements differ); vs plain {scan['err_vs_plain']}; device ms "
          f"other {times['other']}, this {times['this']} on {smi}",
          flush=True)
    del dt, x, y_o, y_t, y_ref, outs
    torch.cuda.empty_cache()
    return scan


def ab_flash_attention(libs, stream, smi):
    import torch
    import torch.nn.functional as F
    from chip_smoke import LM_B, LM_S, device_ms, max_abs_err
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    Bq, S, H, hd = LM_B, LM_S, 20, 128
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
    times = in_turns({tag: outs[tag][0] for tag in outs})
    times["sdpa"] = [device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))]
    att = {"shape": [Bq, S, S, H, H, hd], "dtype": "bfloat16",
           "max_abs_diff": max_abs_err(outs["this"][1], outs["other"][1]),
           "err_vs_plain": {t: max_abs_err(outs[t][1], want)
                            for t in ("other", "this")},
           "ms": times}
    print(f"flash_attention {att['shape']} bf16 causal: this vs other max abs"
          f" diff {att['max_abs_diff']:.3g}; vs plain {att['err_vs_plain']};"
          f" device ms other {times['other']}, this {times['this']}, SDPA "
          f"{times['sdpa']} on {smi}", flush=True)
    return att


def rule_stats_cases(dev):
    """{what: (stats, seg, xbin, mom)} of the A/B: the moment statistics as
    chip_smoke.py draws them, a skewed batch, one cell, and the three
    segment_sum shapes with their row ids."""
    import numpy as np
    import torch
    from chip_smoke import B, BINS, MOMENTS, RULES
    from repro_torch.kernels.rule_stats.ops import rule_moments
    from repro_torch.kernels.rule_stats.ref import xla_windows

    rng = np.random.RandomState(3)
    R1, m = RULES + 1, 40

    def t(a):
        return torch.from_numpy(a).to(dev)

    stats = t((rng.uniform(size=(R1, m, BINS, MOMENTS)) * 5)
              .astype(np.float32))
    cases = {}
    for n in (B, (B // 3) * 3):
        cases[f"moment statistics B={n}"] = (
            stats, t(rng.randint(0, R1 + 2, n).astype(np.int32)),
            t(rng.randint(0, BINS, (n, m)).astype(np.int32)),
            rule_moments(t((rng.randn(n) * 2).astype(np.float32))))
    seg = np.where(rng.uniform(size=B) < 0.7, RULES, rng.randint(0, RULES, B))
    xbin = t(rng.randint(0, BINS, (B, m)).astype(np.int32))
    y = t((rng.randn(B) * 2).astype(np.float32))
    cases["moment statistics, skewed"] = (stats, t(seg.astype(np.int32)),
                                          xbin, rule_moments(y))
    cases["moment statistics, one cell"] = (
        stats, t(np.full(B, 5, np.int32)), t(np.full((B, m), 2, np.int32)),
        rule_moments(y))
    xb = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    (ids1, _, n1), (ids2, _, n2) = xla_windows((B,), dev)
    cases["per-rule sums"] = (
        torch.zeros((R1, 1, 1, 3), device=dev),
        t(rng.randint(0, R1 + 1, B).astype(np.int32)), xb,
        t((rng.randn(B, 3) * 2).astype(np.float32)))
    cases["batch sum level 1"] = (
        torch.zeros((n1, 1, 1, 4), device=dev), ids1, xb,
        t((rng.randn(B, 4) * 2).astype(np.float32)))
    cases["batch sum level 2"] = (
        torch.zeros((n2, 1, 1, 4), device=dev), ids2, xb[:n1],
        t((rng.randn(n1, 4) * 2).astype(np.float32)))
    # CluStream's CF scatter x | x^2 at d128-K256 and d32-K100 (the wide
    # form): rows as a blob stream spreads them (13 % discarded into
    # segment K, 70 % of the rest in 8 segments), and all in one segment
    for arm, d, K in (("", 128, 256), (" d32-K100", 32, 100)):
        blob = np.where(rng.uniform(size=B) < 0.13, K, np.where(
            rng.uniform(size=B) < 0.7, rng.randint(0, 8, B) * (K // 8 - 1),
            rng.randint(0, K, B)))
        vals = t(rng.randn(B, 2 * d).astype(np.float32))
        for what, seg in ((f"CF scatter{arm}, blob", blob),
                          (f"CF scatter{arm}, one segment", np.full(B, 5))):
            cases[what] = (torch.zeros((K + 1, 1, 1, 2 * d), device=dev),
                           t(seg.astype(np.int32)), xb, vals)
    return cases


def wide_form(lib_set):
    """Whether a checkout's rule_stats takes more than 8 columns (the wide
    form of CluStream's CF scatter): its launcher refuses a launch of 9
    columns on empty inputs otherwise."""
    import torch
    from repro_torch.kernels.rule_stats import ops as rs_ops
    fn = entry(lib_set["rule_stats"], "rule_stats_launch", rs_ops._ARGTYPES)
    z = torch.zeros(16, device="cuda")
    return fn(z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(), 1, 1,
              1, 9, 0, torch.cuda.current_stream().cuda_stream) == 0


def ab_rule_stats(libs, stream, smi):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rule_stats import ops as rs_ops
    from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref

    out = {}
    for what, (stats, seg, xbin, mom) in rule_stats_cases(
            torch.device("cuda")).items():
        R, m, bins, C = stats.shape
        n = seg.shape[0]
        if C > rs_ops.MAX_MOMENTS and not wide_form(libs["other"]):
            print(f"rule_stats {what}: the other checkout has no wide form "
                  f"(C = {C}); skipped", flush=True)
            continue
        runs, got = {}, {}
        for tag in ("other", "this"):
            fn = entry(libs[tag]["rule_stats"], "rule_stats_launch",
                       rs_ops._ARGTYPES)

            def run(fn=fn, dst=stats.clone()):      # in place, into dst
                _build.check(fn(dst.data_ptr(), seg.data_ptr(),
                                xbin.data_ptr(), mom.data_ptr(), R, m, bins,
                                C, n, stream), "rule_stats")
                return dst
            got[tag] = run(dst=stats.clone())       # one launch from stats
            runs[tag] = run
        torch.cuda.synchronize()
        want = rule_stats_scatter_ref(stats.clone(), seg, xbin, mom)
        e = {"shape": [R, m, bins, C], "B": n,
             "bits_differing": bits_differing(got["other"], got["this"]),
             "bits_differing_vs_plain": {
                 t: bits_differing(got[t], want) for t in got},
             "elements": want.numel(), "ms": in_turns(runs)}
        out[what] = e
        print(f"rule_stats {what} {e['shape']} B={n}: bits differing "
              f"{e['bits_differing']} of {e['elements']}, vs plain "
              f"{e['bits_differing_vs_plain']}; device ms other "
              f"{e['ms']['other']}, this {e['ms']['this']} on {smi}",
              flush=True)
    return out


def ab_split_gain(libs, stream, smi):
    import numpy as np
    import torch
    from chip_smoke import BINS, C, M_ATTRS, N_NODES
    from repro_torch.kernels import _build
    from repro_torch.kernels.split_gain import ops as sg_ops
    from repro_torch.kernels.split_gain.ref import NEG, split_gain_ref

    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    out = {}
    for rows in (16, N_NODES):
        s = rng.randint(0, 30, (rows, M_ATTRS, BINS, C)).astype(np.float32)
        s *= rng.uniform(size=s.shape) < 0.5
        s = torch.from_numpy(s).to(dev)
        runs, got = {}, {}
        for tag in ("other", "this"):
            fn = entry(libs[tag]["split_gain"], "split_gain_launch",
                       sg_ops._ARGTYPES)
            g = torch.empty((rows, M_ATTRS, BINS), device=dev)

            def run(fn=fn, g=g):
                _build.check(fn(s.data_ptr(), g.data_ptr(), rows * M_ATTRS,
                                BINS, C, stream), "split_gain")
            run()
            runs[tag], got[tag] = run, g
        torch.cuda.synchronize()
        want = split_gain_ref(s)
        what = "tile" if rows == 16 else "full"
        e = {"shape": [rows, M_ATTRS, BINS, C],
             "bits_differing": bits_differing(got["other"], got["this"]),
             "neg_mask_equal": {t: bool(torch.equal(got[t] == NEG,
                                                    want == NEG))
                                for t in got},
             "elements": want.numel(), "ms": in_turns(runs)}
        out[what] = e
        print(f"split_gain {what} {e['shape']}: bits differing "
              f"{e['bits_differing']} of {e['elements']}, NEG mask as the "
              f"plain version's {e['neg_mask_equal']}; device ms other "
              f"{e['ms']['other']}, this {e['ms']['this']} on {smi}",
              flush=True)
    return out


def tree_grown(dev, N=51):
    """A seeded random tree grown to N nodes, as [1, N] tables: 51 is the
    size of the VHT main path's learned tree after 200 batches, 191 and 255
    (96 and 128 leaves) those of a mature tree in a 255-node pool."""
    import torch
    from chip_smoke import BINS, M_ATTRS, random_trees
    return [torch.from_numpy(a).to(dev)
            for a in random_trees(1, N, M_ATTRS, BINS, seed=N)]


def vht_stats_cases(dev):
    """{what: (stats, leaf, xbin, y, w, exact)} of the A/B, at the VHT main
    path's [255, 1000, 8, 2] and B = 512."""
    import numpy as np
    import torch
    from chip_smoke import B, BINS, C, DEPTH, M_ATTRS, N_NODES
    from repro_torch.kernels.tree_route.ref import tree_route_ref

    rng = np.random.RandomState(0)             # as chip_smoke.py draws it

    def t(a):
        return torch.from_numpy(a).to(dev)

    xbin = t(rng.randint(0, BINS, (B, M_ATTRS)).astype(np.int32))
    leaf = t(rng.randint(0, N_NODES, B).astype(np.int32))
    y = t(rng.randint(0, C, B).astype(np.int32))
    counts = t(rng.randint(0, 50, (N_NODES, M_ATTRS, BINS, C))
               .astype(np.float32))
    w01 = t((rng.uniform(size=B) < 0.8).astype(np.float32))
    frac = t((rng.uniform(size=(N_NODES, M_ATTRS, BINS, C)) * 5)
             .astype(np.float32))
    wf = t(rng.uniform(size=B).astype(np.float32))
    routed = {n: tree_route_ref(*tree_grown(dev, n), xbin, DEPTH)[0]
              for n in (51, 191, 255)}
    cases = {"uniform over 255 leaves": (counts, leaf, xbin, y, w01, True),
             "one leaf": (counts, torch.zeros_like(leaf), xbin, y, w01, True),
             "51-node tree": (counts, routed[51], xbin, y, w01, True),
             "191-node tree": (counts, routed[191], xbin, y, w01, True),
             "255-node tree": (counts, routed[255], xbin, y, w01, True),
             "fractional weights": (frac, leaf, xbin, y, wf, False),
             "fractional weights, 51-node tree": (frac, routed[51], xbin, y,
                                                  wf, False)}
    for k in (16, 32, 64, 96, 128):     # around the switch at B / 8 leaves
        cases[f"uniform over {k} leaves"] = (
            counts, t(rng.randint(0, k, B).astype(np.int32)), xbin, y, w01,
            True)
    return cases


def ab_vht_stats(libs, stream, smi):
    import torch
    from chip_smoke import max_abs_err
    from repro_torch.kernels import _build
    from repro_torch.kernels.vht_stats import ops as vs_ops
    from repro_torch.kernels.vht_stats.ref import stats_update_ref

    out = {}
    for what, (stats, leaf, xbin, y, w, exact) in vht_stats_cases(
            torch.device("cuda")).items():
        N, m, bins, C = stats.shape
        n = leaf.shape[0]
        runs, got = {}, {}
        for tag in ("other", "this"):
            fn = entry(libs[tag]["vht_stats"], "vht_stats_launch",
                       vs_ops._ARGTYPES)

            def run(fn=fn, dst=stats.clone()):      # in place, into dst
                _build.check(fn(dst.data_ptr(), leaf.data_ptr(),
                                xbin.data_ptr(), y.data_ptr(), w.data_ptr(),
                                N, n, m, bins, C, stream), "vht_stats")
                return dst
            got[tag] = run(dst=stats.clone())       # one launch from stats
            runs[tag] = run
        torch.cuda.synchronize()
        want = stats_update_ref(stats.clone(), leaf, xbin, y, w)
        e = {"shape": [N, m, bins, C], "B": n,
             "leaves": int(torch.unique(leaf).numel()),
             "bits_differing": bits_differing(got["other"], got["this"]),
             "bits_differing_vs_plain": {
                 t: bits_differing(got[t], want) for t in got},
             "max_abs_diff_vs_plain": {
                 t: max_abs_err(got[t], want) for t in got},
             "elements": want.numel(), "exact": exact,
             "ms": in_turns(runs)}
        out[what] = e
        print(f"vht_stats {what} {e['shape']} B={n} ({e['leaves']} leaves): "
              f"bits differing {e['bits_differing']} of {e['elements']}, vs "
              f"plain {e['bits_differing_vs_plain']} (max abs diff "
              f"{e['max_abs_diff_vs_plain']}); device ms other "
              f"{e['ms']['other']}, this {e['ms']['this']} on {smi}",
              flush=True)
    return out


def ab_tree_route(libs, stream, smi):
    import numpy as np
    import torch
    from chip_smoke import B, BINS, DEPTH, M_ATTRS, N_NODES, random_trees
    from repro_torch.kernels import _build
    from repro_torch.kernels.tree_route import ops as tr_ops
    from repro_torch.kernels.tree_route.ref import tree_route_ref

    dev = torch.device("cuda")
    xbin = torch.from_numpy(np.random.RandomState(0).randint(
        0, BINS, (B, M_ATTRS)).astype(np.int32)).to(dev)

    def full(M):
        return [torch.from_numpy(a).to(dev)
                for a in random_trees(M, N_NODES, M_ATTRS, BINS, M)]
    one = [torch.full((1, 1), -1, dtype=torch.int32, device=dev),
           torch.zeros((1, 1), dtype=torch.int32, device=dev),
           torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)]
    cases = {"full 255-node tree, M = 1": (full(1), xbin),
             "full 255-node tree, M = 5": (full(5), xbin),
             "51-node tree": (tree_grown(dev), xbin),
             "one-node tree, B = 1 (launch floor)": (one, xbin[:1])}
    out = {}
    for what, ((sa, sb, ch), xb) in cases.items():
        M, N = sa.shape
        n, m = xb.shape
        runs, got = {}, {}
        for tag in ("other", "this"):
            fn = entry(libs[tag]["tree_route"], "tree_route_launch",
                       tr_ops._ARGTYPES)
            leaf = torch.empty((M, n), dtype=torch.int32, device=dev)

            def run(fn=fn, leaf=leaf):
                _build.check(fn(sa.data_ptr(), sb.data_ptr(), ch.data_ptr(),
                                xb.data_ptr(), leaf.data_ptr(), M, N, n, m,
                                DEPTH, stream), "tree_route")
            run()
            runs[tag], got[tag] = run, leaf
        torch.cuda.synchronize()
        want = tree_route_ref(sa, sb, ch, xb, DEPTH)
        e = {"M": M, "N": N, "B": n,
             "differing": int((got["other"] != got["this"]).sum()),
             "differing_vs_plain": {t: int((got[t] != want).sum())
                                    for t in got},
             "elements": want.numel(), "ms": in_turns(runs)}
        out[what] = e
        print(f"tree_route {what} M={M} N={N} B={n}: leaf ids differing "
              f"{e['differing']} of {e['elements']}, vs plain "
              f"{e['differing_vs_plain']}; device ms other "
              f"{e['ms']['other']}, this {e['ms']['this']} on {smi}",
              flush=True)
    return out


def ab_split_poisson(libs, stream, smi):
    import torch
    from chip_smoke import ENS_M, B
    from repro_torch.core.prng import PRNGKey
    from repro_torch.kernels import _build
    from repro_torch.kernels.split_poisson import ops as sp_ops
    from repro_torch.kernels.split_poisson.ref import split_poisson_ref

    dev = torch.device("cuda")
    M = ENS_M
    g = torch.Generator(device=dev).manual_seed(3)
    cases = {"bagging, lam 1": torch.ones((M, 1), device=dev),
             "boosting, lam in [1, 3)":
                 1.0 + 2.0 * torch.rand((M, B), generator=g, device=dev),
             "lam 9.99": torch.full((M, 1), 9.99, device=dev)}
    key = PRNGKey(0, dev)
    out = {}
    for what, lam in cases.items():
        runs, got = {}, {}
        for tag in ("other", "this"):
            fn = entry(libs[tag]["split_poisson"], "split_poisson_launch",
                       sp_ops._ARGTYPES)
            w = torch.empty((M, B), device=dev)
            k_out = torch.empty(2, dtype=torch.uint32, device=dev)

            def run(fn=fn, w=w, k_out=k_out):
                _build.check(fn(key.data_ptr(), lam.data_ptr(), lam.shape[1],
                                w.data_ptr(), k_out.data_ptr(), M * B, B,
                                stream), "split_poisson")
            run()
            runs[tag], got[tag] = run, (k_out, w)
        torch.cuda.synchronize()
        want = split_poisson_ref(key, lam, (M, B))

        def differing(a, b):
            return (int((a[0].view(torch.int32) != b[0].view(torch.int32))
                        .sum()) + bits_differing(a[1], b[1]))
        e = {"shape": [M, B], "max_draw": int(want[1].max()),
             "rounds": int((want[1] + 1).sum()),
             "bits_differing": differing(got["other"], got["this"]),
             "bits_differing_vs_plain": {t: differing(got[t], want)
                                         for t in got},
             "elements": M * B + 2, "ms": in_turns(runs)}
        out[what] = e
        print(f"split_poisson {what} [{M},{B}] (largest draw "
              f"{e['max_draw']}): bits differing {e['bits_differing']} of "
              f"{e['elements']}, vs plain {e['bits_differing_vs_plain']}; "
              f"device ms other {e['ms']['other']}, this {e['ms']['this']} "
              f"on {smi}", flush=True)
    return out


AB = {"selective_scan": ab_selective_scan,
      "flash_attention": ab_flash_attention, "rule_stats": ab_rule_stats,
      "split_gain": ab_split_gain, "vht_stats": ab_vht_stats,
      "tree_route": ab_tree_route, "split_poisson": ab_split_poisson}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py: no CUDA device")
    from chip_smoke import nvidia_smi
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    libs, ptxas = {}, {}
    for tag, root in (("other", args.other.resolve()), ("this", ROOT)):
        libs[tag], ptxas[tag] = build(
            tag, root / "src" / "repro_torch" / "csrc", args.kernels)
        for name in args.kernels:
            print(f"ptxas {tag} {name}: " + " | ".join(ptxas[tag][name]),
                  flush=True)
    stream = _build.stream_of(torch.empty(1, device="cuda"))
    result = {"device": torch.cuda.get_device_name(0), "smi": smi}
    for name in args.kernels:
        result[name] = AB[name](libs, stream, smi)
    result["ptxas"] = ptxas
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
