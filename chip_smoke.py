#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout:   python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):

  1. device   -- needs a CUDA device; prints the card's name and power limit
                 (nvidia-smi), the torch and CUDA versions; TF32 off.
  2. build    -- builds the hand-written kernels of src/repro_torch/csrc with
                 nvcc into the git-ignored build/ directory, and logs each
                 instantiation's registers, spill bytes and shared memory
                 (selective_scan must not spill).
  3. kernels  -- each kernel against its plain PyTorch version on the card at
                 the main path's shapes, and its median time over 50 launches
                 (CUDA events) beside the plain version's, a PyTorch library
                 call's where one computes the same function, and its bound.
  4. main     -- the VHT prequential path at the full width of the widest
                 dense configuration (benchmarks/vht_benchmarks.py fig89
                 dense-1000, wok): every kernel must have launched, the tree
                 must grow, and a re-run of the same stream with the plain
                 versions on the card must give the same per-batch metrics
                 and the same tree.  tree_route and vht_stats are also
                 checked and timed on the learned tree and the last batch,
                 the inputs the path gives them.
  5. paths    -- dense-20 and dense-200 in the local, wok and wk(256)
                 variants, and the MA/LS topology on the LocalEngine and the
                 StreamEngine at dense-200, each against its plain re-run.
  6. rules    -- AMRules regression (paper section 7) at the repo's widest
                 setup (benchmarks/amrules_benchmarks.py fig12: R = 64 rules,
                 8 bins, n_min = 200, B = 512, 80 batches): MAMR, VAMR and
                 HAMR-2 on the waveform-40 and electricity-12 streams.  The
                 main path is VAMR on waveform-40.  Each run must launch
                 rule_stats for the moment statistics and, counted apart as
                 segment_sum, for the float reductions, create rules, give
                 the same per-batch abs_err, sq_err and n_rules and the same
                 final state, leaf for leaf, as its re-run with the plain
                 versions on the card, and the same state, bit for bit, as
                 a second run with the kernel.  The main path's rule_stats
                 time per step is split between the two uses.
  7. ensembles -- OzaBag and OzaBoost (paper section 5) with M = 10
                 members and ShardingEnsemble, the paper's horizontal
                 baseline, at B = 512, TreeConfig(n_bins=8, max_nodes=255,
                 n_min=200).  The main path is OzaBag with ADWIN at
                 dense-1000 (100 batches); then OzaBoost with ADWIN on
                 covtype-54 (7 classes, 100 batches), OzaBag with DDM on a
                 dense-200 concept switch (its drifts must fire), with EDDM
                 and with Page-Hinkley at dense-200 (50 batches each), and
                 ShardingEnsemble p = 4 at dense-1000 (fig45) and p = 2 at
                 dense-200 (tab34), 100 batches.  Each runs eagerly with
                 the kernels, compiled, and eagerly with the plain
                 versions; per-batch metrics and the final state (PRNG key
                 included) must be bit for bit alike across the three.  The
                 main path also shows tree_route at M = 10 and split_poisson
                 (the members' Poisson weights, a kernel with no TPU
                 counterpart) against their plain versions
                 with their device ms and bounds, the drift reset's device
                 ms, syncs and launches per step and the busy share, eager
                 against compiled.  Last, a short final batch (200 of 512
                 rows) compiled against eager for VHT and OzaBag.
  8. clustream -- CluStream (paper section 5) on the chunked stream
                 runtime at the arms of benchmarks/clustream_benchmarks.py:
                 d128-K256 (the main path, step mode) and d32-K100,
                 CluStreamConfig(n_macro=8, period=4096), B = 512, 200
                 batches of its blob stream (numpy, from the seed) in 25
                 chunks of 8 (the period aligned to the chunk), staged to
                 the card by the stream's producer.  Each arm in step and
                 boundary mode three ways: eagerly with the kernels
                 (LocalEngine's ChunkedStream loop), compiled
                 (ChunkedPrequentialEvaluation on JitEngine) and eagerly
                 with the plain versions; per-batch seen, ssq and n_active
                 and the final state bit for bit alike, segment_sum
                 launched (the CF scatter, the kernel's wide form for
                 x | x^2), the macro phase run, and boundary mode's final
                 state equal to step mode's.  On the main arm in boundary
                 mode a run with checkpoints, killed after its middle
                 checkpoint and resumed, must end as the uninterrupted
                 run.  Prints the wide segment_sum on the main path's last
                 batch, and on its rows all in one segment, against its
                 plain version, index_add_ and its bound, syncs per step (0 in a captured step) and the busy
                 share, eager against compiled.
  9. lm       -- the LM zoo's serving path at full width, one model at a
                 time: falcon_mamba_7b (64 Mamba-1 layers, d_model 4096) and
                 qwen15_4b (40 attention layers, 20 heads of 128), random
                 weights from a seed.  The prefill step on 4 prompts of 2048
                 tokens must launch selective_scan once per falcon layer and
                 flash_attention once per qwen layer, give finite logits,
                 and agree with its re-run with the plain versions on the
                 card; then serve (4 prompts of 256 replayed into the caches,
                 32 greedy tokens), whose last replay logits must agree with
                 the prefill step on the same prompts.  Prints TTFT, decode
                 ms per step and tokens/s, and the device's busy share.
  10. serve   -- the pipelined against the synchronous driver on VHT
                 dense-1000 and CluStream d128-K256, bit for bit, with µs
                 per batch and busy share.  Train while serving: the main
                 path's 25 chunks of 8 (VHT dense-1000 wok) again and again
                 for 500 chunks, publishing a snapshot at every chunk, in
                 five turns: each driver without and with a ModelServer at
                 the JAX serving benchmark's settings (max_batch 16,
                 max_wait_ms 2, queue_limit 128, deadline_ms 250,
                 staleness limit 8) that answers 250 requests/s played open
                 loop from the main thread, and the pipelined driver with
                 the server and a checkpoint every 5 chunks; the collector
                 frozen before each turn, a full collection timed before
                 and after the freeze.  Every request answered (none shed
                 or overloaded), answers from at least two snapshot
                 versions, every tenth equal to reference_predict on the
                 version it names; latency, staleness, a publish's device
                 ms, µs per batch, the host ms of a chunk's dispatch, a
                 publish and a checkpoint save, the longest gap between
                 chunks, the collector's pauses and the process's CPU
                 share.  A NaN in the
                 carry after chunk 5 retried (bit for bit the clean run)
                 and skipped (recorded), a kill after chunk 12 resumed (bit
                 for bit); serve/train parity in VHT, OzaBag (M = 10), VAMR
                 and CluStream at a chunk boundary, the kernel predict bit
                 for bit the plain one; tree_route at the server's batch of
                 16, M = 1 and 10, timed; and a short last batch's step
                 captured while the server answers, the run bit for bit the
                 eager one.
  11. fleet   -- multi-tenant learner fleets (src/repro_torch/ml/fleet.py)
                 after the serve phase: benchmarks/fleet_benchmarks.py's
                 fleet.vht-f1000 arm in its full mode (1000 VHT tenants,
                 TreeConfig(n_attrs=8, n_bins=4, max_nodes=31, n_min=16,
                 delta=0.05, tau=0.1), RandomTreeGenerator(n_cat=4,
                 n_num=4, depth=4, seed=3), 8 steps of 16 a tenant in
                 chunks of 2, a checkpoint after every chunk) and 1000
                 tenants of CluStream d32-K100 (period 32, aligned to the
                 chunk) in step and boundary mode.  Each fleet eager,
                 compiled and plain bit for bit alike (state rows and
                 [steps, F] metric columns); 16 tenants spread over the
                 fleet each equal to their learner alone (CluStream: CF
                 leaves bit for bit, macro rtol 1e-6, ssq within the
                 rounding bound of its expanded distances, a planted stale-
                 macro ssq refused by that bound); the VHT fleet and the
                 boundary-mode CluStream fleet killed after their first
                 chunk and resumed, bit for bit; kernel launches per step
                 the same at 100 and at
                 1000 tenants; the VHT fleet's predict at the server's
                 batch of 16 mixed tenants (one tree_route_rows launch)
                 equal to reference_predict, and a ModelServer answering
                 by tenant; tree_route's batch-per-tree and row forms,
                 segment_sum's tenant form and vht_stats with the tenant
                 axis folded into its leaves, each exact against its plain
                 version on random inputs and the path's, timed beside
                 its bound.  Prints µs per fleet step (eager, compiled)
                 and instances/s.
  12. result  -- one JSON line of per-kernel numbers (rule_stats as
                 segment_sum on its own line, timed on the CluStream CF
                 scatter; split_poisson on the OzaBag path; the fleet
                 forms on lines of their own), then, as
                 the last line, {"ok": true, "device": {...}}.

Phases 4 to 9 also run each path compiled (src/repro_torch/core/
compiled.py: each step one captured CUDA graph, its lax.cond gates
conditional nodes on the device), after its eager kernel run and against
it: the main path through PrequentialEvaluation (its default) and
JitEngine.run_stream on the bare learner, the dense-20 and dense-200
variants, the MA/LS topology on JitEngine against the StreamEngine, MAMR,
VAMR and HAMR-2 on waveform-40, the CluStream arms on JitEngine's chunked
runtime, and both models' prompt replay and decode through one graph
each.  Per-batch metrics and final states must be bit
for bit the eager run's, the 32 tokens equal and the last logits inside
the LM gate.  The replays of a captured step run with the card's sync
debug mode set to raise; the main paths print their syncs per step, the
kernels' launches per step from the trace and the device's busy share,
eager against compiled.  The kernel launch counts stay the eager runs':
a graph's wrappers count only while it is captured.

Phase 3 also checks selective_scan at falcon's prefill shape (B = 4,
S = 2048, dI = 8192, N = 16, float32) and flash_attention at qwen's (B = 4,
S = T = 2048, 20 heads of 128, bf16, causal), plus GQA, MQA, window,
non-causal and ragged cases.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
B, M_ATTRS, N_NODES, BINS, C, DEPTH = 512, 1000, 255, 8, 2, 24
MAIN_BATCHES = 200
# AMRules: RulesConfig(n_attrs=m, n_bins=8, max_rules=64, n_min=200), the
# statistics extended by the default rule's row: [65, 40, 8, 3] at m = 40
RULES, RULES_BATCHES, MOMENTS = 64, 80, 3
VHT_KERNELS = ("tree_route", "vht_stats", "split_gain")
# the ensembles: M members, 100 batches (50 for the dense-200 detector
# runs); the concept switch changes its hidden tree at batch SWITCH_AT
ENS_M, ENS_BATCHES, ENS_DET_BATCHES, SWITCH_AT = 10, 100, 50, 30
# the H100 SXM's INT32 rate: 64 INT32 lanes an SM (Hopper white paper),
# 132 SMs, 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# split_poisson's integer operations: a threefry2x32 hash (about 80 add,
# rotate and xor operations) for each draw's uniform in each of its rounds
# of Knuth's loop, and two a round for the whole launch (the next key and
# the round's subkey, the same for every draw) up to the longest draw
THREEFRY_OPS = 80
# CluStream (benchmarks/clustream_benchmarks.py's arms): CS_CHUNKS chunks of
# CS_CHUNK batches of B; the period, CS_CHUNK * B, aligned to the chunks
CS_CHUNK, CS_CHUNKS, CS_PERIOD = 8, 25, 4096
# the LM serving path: prefill of LM_B prompts of LM_S tokens; serve replays
# SERVE_PROMPT tokens into the caches and decodes SERVE_GEN
LM_B, LM_S, SERVE_PROMPT, SERVE_GEN, PROFILE_DECODE = 4, 2048, 256, 32, 8
LM_ARCHS = {"falcon_mamba_7b": "selective_scan", "qwen15_4b": "flash_attention"}
# the kernel run against the plain run of the prefill step, and the
# prompt replay against the prefill step, compare the max-shifted last
# logits with tests/test_consistency.py's rtol 0.05 and atol 0.1, the atol
# raised to LM_ULPS bf16 ulps of the largest |logit|: the logits are bf16
# before their float32 cast, and at full width they reach about 5 (SMOKE:
# under 1), where one ulp is 0.031.  The replay's decode-shaped products
# round otherwise than the prefill's at every layer (3.1 ulps apart on
# qwen15_4b on an H100); a wrong kernel or cache misses by whole logits.
LM_ULPS = 8


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- helpers

def call_ms(fn, n=50, warmup=5):
    """Median of n CUDA-event timings of single calls of fn(), after
    warmup calls.  The device idles while the host launches, so this is
    the time of a call from the host's side, launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, n=50, reps=7):
    """Device time of one fn(): the median over reps of (events around n
    back-to-back calls) / n.  A spin kernel (torch.cuda._sleep) holds the
    stream first, long enough for the host to queue all n calls, so the
    device runs them without waiting for the host."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * host_s * 2.0e9) + 1_000_000       # 2x the host time
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def timed(fn, n=50, reps=7):
    """{"ms": device ms, "call_ms": ms per call from the host}."""
    return {"ms": device_ms(fn, n=n, reps=reps), "call_ms": call_ms(fn, n=n)}


def max_abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


def bound(moved, ops, rate=FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card needs for
    `moved` bytes at its memory rate and `ops` operations at its peak
    `rate` (float32 outside the tensor cores unless given), and which of
    the two sets it."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def random_trees(M, N, m, nb, seed):
    """M valid trees filling node pools of N: random leaves split into two
    fresh children until the pool is full."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sa = np.full((M, N), -1, np.int32)
    sb = np.zeros((M, N), np.int32)
    ch = np.zeros((M, N, 2), np.int32)
    for t in range(M):
        n_nodes, leaves = 1, [0]
        for _ in range((N - 1) // 2):
            node = leaves.pop(rng.randint(len(leaves)))
            sa[t, node], sb[t, node] = rng.randint(m), rng.randint(nb)
            ch[t, node] = (n_nodes, n_nodes + 1)
            leaves += [n_nodes, n_nodes + 1]
            n_nodes += 2
    return sa, sb, ch


def route_steps(sa, sb, ch, xbin, max_depth):
    """Number of inner nodes each (member, instance) passes: the xbin reads
    that routing needs."""
    import torch
    M, N = sa.shape
    node = torch.zeros((M, xbin.shape[0]), dtype=torch.long, device=xbin.device)
    steps = torch.zeros_like(node)
    rows = torch.arange(M, device=xbin.device)[:, None]
    cols = torch.arange(xbin.shape[0], device=xbin.device)[None]
    for _ in range(max_depth):
        attr = sa[rows, node].long()
        inner = attr >= 0
        v = xbin[cols, attr.clamp(min=0)]
        nxt = ch[rows, node, (v > sb[rows, node]).long()].long()
        node = torch.where(inner, nxt, node)
        steps += inner.long()
    return int(steps.sum())


@contextlib.contextmanager
def plain_kernels():
    """Route the VHT, ensemble, AMRules, CluStream, fleet and LM paths
    through the plain PyTorch versions of the six kernels, of their fleet
    forms and of split_poisson, on the card, for a reference run."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.split_gain.ref import split_gain_ref
    from repro_torch.kernels.split_poisson.ref import split_poisson_ref
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    from repro_torch.kernels.vht_stats.ref import stats_update_ref
    from repro_torch.kernels.rule_stats.ops import batch_sum, batch_sum_tenant
    from repro_torch.kernels.rule_stats.ref import segment_sum_tenant_ref
    from repro_torch.kernels.tree_route.ref import (tree_route_batched_ref,
                                                    tree_route_rows_ref)
    from repro_torch.ml import amrules, clustream, ensemble, htree, vht
    from repro_torch.models import layers
    from repro_torch.serving import predict

    def route_plain(sa, sb, ch, xbin, *, max_depth):
        if sa.dim() == 1:
            return tree_route_ref(sa[None], sb[None], ch[None], xbin,
                                  max_depth)[0]
        return tree_route_ref(sa, sb, ch, xbin, max_depth)

    def batched_plain(sa, sb, ch, xbin, *, max_depth):
        return tree_route_batched_ref(sa, sb, ch, xbin, max_depth)

    def rows_plain(sa, sb, ch, xbin, member, *, max_depth):
        return tree_route_rows_ref(sa, sb, ch, xbin, member, max_depth)

    saved = (htree.tree_route, htree.stats_update, htree.split_gain,
             vht.stats_update, amrules.rule_stats_scatter,
             amrules.segment_sum, layers.selective_scan,
             layers.flash_attention, ensemble.split_poisson,
             clustream.segment_sum, clustream.batch_sum,
             htree.tree_route_batched, clustream.segment_sum_tenant,
             clustream.batch_sum_tenant, predict.tree_route_rows)
    htree.tree_route, htree.split_gain = route_plain, split_gain_ref
    ensemble.split_poisson = split_poisson_ref
    htree.stats_update = vht.stats_update = stats_update_ref
    amrules.rule_stats_scatter = amrules.segment_sum = rule_stats_scatter_ref
    clustream.segment_sum = rule_stats_scatter_ref
    clustream.batch_sum = functools.partial(batch_sum,
                                            scatter=rule_stats_scatter_ref)
    layers.selective_scan = selective_scan_ref
    layers.flash_attention = flash_attention_ref
    htree.tree_route_batched = batched_plain
    clustream.segment_sum_tenant = segment_sum_tenant_ref
    clustream.batch_sum_tenant = functools.partial(
        batch_sum_tenant, scatter=segment_sum_tenant_ref)
    predict.tree_route_rows = rows_plain
    try:
        yield
    finally:
        (htree.tree_route, htree.stats_update, htree.split_gain,
         vht.stats_update, amrules.rule_stats_scatter,
         amrules.segment_sum, layers.selective_scan,
         layers.flash_attention, ensemble.split_poisson,
         clustream.segment_sum, clustream.batch_sum,
         htree.tree_route_batched, clustream.segment_sum_tenant,
         clustream.batch_sum_tenant, predict.tree_route_rows) = saved


class Recording:
    """A learner that keeps every step's metrics."""

    def __init__(self, learner):
        self.learner = learner
        self.device = learner.device
        self.metrics = []

    def init(self, key=None):
        return self.learner.init(key)

    def step(self, state, x, y):
        state, m = self.learner.step(state, x, y)
        self.metrics.append(m)
        return state, m


def stacked(metrics, key):
    import torch
    return torch.stack([m[key] for m in metrics]).cpu()


TREE_KEYS = ("split_attr", "split_bin", "children", "n_nodes")


def same_tree(a, b):
    import torch
    return all(torch.equal(a[k], b[k]) for k in TREE_KEYS)


# ----------------------------------------------------------------- phases

def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def ptxas_report(text):
    """Per kernel instantiation in nvcc's -Xptxas -v output: its name
    (demangled by c++filt where there is one), registers, spill bytes
    (stores + loads) and static shared memory bytes."""
    rows, cur = [], None
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            cur = {"name": m.group(1), "spill_bytes": 0}
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers",
                                                 ln)):
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["name"] for r in rows), capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            short = re.search(r"(\w+<[^()]*>)\(", name)
            r["name"] = short.group(1) if short else name
    return rows


def phase_build():
    """Builds every kernel; logs the ptxas lines of each and registers,
    spills and shared memory per instantiation.  selective_scan must spill
    nothing."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, info in sorted(_build.BUILD_LOG.items()):
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: {info['seconds']:.2f} s cached={info['cached']} "
            + " | ".join(regs))
    report = {}
    for name in (*VHT_KERNELS, "rule_stats", *LM_ARCHS.values()):
        report[name] = ptxas_report(_build.BUILD_LOG[name]["ptxas"])
        require(report[name], f"no ptxas report for {name}")
        for r in report[name]:
            log(f"  ptxas {r['name']}: {r['registers']} registers, "
                f"{r['spill_bytes']} spill bytes, {r['smem_bytes']} bytes "
                "static shared memory")
    require(all(r["spill_bytes"] == 0 for r in report["selective_scan"]),
            f"selective_scan spills: {report['selective_scan']}")
    # vht_stats' histogram over the leaves present and tree_route's staged
    # tree take dynamic shared memory, as their launchers compute it
    plan = (ctypes.c_int * 3)()
    _build.check(_build.function(
        "vht_stats", "vht_stats_plan", (ctypes.c_int,) * 4 + (ctypes.c_void_p,))(
            N_NODES, B, BINS, C, ctypes.addressof(plan)), "vht_stats_plan")
    ja, group, smem = plan
    log(f"  vht_stats dynamic shared memory per block at [{N_NODES}, "
        f"{M_ATTRS}, {BINS}, {C}], B = {B}: {smem} bytes ({ja} attributes "
        f"a block, {group} leaves a pass)")
    smem = _build.function("tree_route", "tree_route_smem",
                           (ctypes.c_int,))(N_NODES)
    log(f"  tree_route dynamic shared memory per block at N = {N_NODES}: "
        f"{smem} bytes")
    # split_gain's thread per (row, bin) takes dynamic shared memory: 256 /
    # bins rows of bins x C counts and their total's entropy (the full
    # fallback's thread per row takes none)
    log(f"  split_gain dynamic shared memory per block at [16, {M_ATTRS}, "
        f"{BINS}, {C}]: {256 // BINS * (BINS * C + 1) * 4} bytes")
    # the bf16 attention kernel's shared memory is dynamic: a Q tile and two
    # stages of K and V tiles of 64 rows, the barriers and 1 KB to align
    log("  flash_attention_wgmma dynamic shared memory per block: " + ", ".join(
        f"hd {hd}: {64 * hd * 2 * 5 + 64 + 1024} bytes"
        for hd in (16, 32, 64, 128)))
    return report


def phase_kernels(dev):
    """Parity and timing of each kernel at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.split_gain.ops import NEG, split_gain
    from repro_torch.kernels.split_gain.ref import split_gain_ref
    from repro_torch.kernels.tree_route.ops import tree_route
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    from repro_torch.kernels.vht_stats.ops import stats_update
    from repro_torch.kernels.vht_stats.ref import stats_update_ref

    rng = np.random.RandomState(0)
    out = {}

    # tree_route: M = 1 and M = 5, exact
    xbin = torch.from_numpy(rng.randint(0, BINS, (B, M_ATTRS)).astype(
        np.int32)).to(dev)
    for M in (1, 5):
        sa, sb, ch = (torch.from_numpy(a).to(dev)
                      for a in random_trees(M, N_NODES, M_ATTRS, BINS, M))
        got = tree_route(sa, sb, ch, xbin, max_depth=DEPTH)
        want = tree_route_ref(sa, sb, ch, xbin, DEPTH)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"tree_route M={M} differs")
        err = max_abs_err(got, want)
        log(f"tree_route M={M} B={B} N={N_NODES}: exact")
        if M == 1:
            steps = route_steps(sa, sb, ch, xbin, DEPTH)
            moved = M * N_NODES * 16 + steps * 4 + M * B * 4
            bound_ms, bound_by = bound(moved, steps)
            kt = timed(lambda: tree_route(sa, sb, ch, xbin, max_depth=DEPTH))
            pt = timed(lambda: tree_route_ref(sa, sb, ch, xbin, DEPTH))
            out["tree_route"] = {
                "ms": kt["ms"], "call_ms": kt["call_ms"],
                "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
                "library_ms": None, "bytes": moved, "ops": steps,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err}

    # vht_stats: [255, 1000, 8, 2], B = 512; exact with 0/1 weights on
    # integer counts, within 1e-5 with fractional weights (order of sums)
    leaf = torch.from_numpy(rng.randint(0, N_NODES, B).astype(np.int32)).to(dev)
    y = torch.from_numpy(rng.randint(0, C, B).astype(np.int32)).to(dev)
    counts = torch.from_numpy(rng.randint(0, 50, (N_NODES, M_ATTRS, BINS, C))
                              .astype(np.float32)).to(dev)
    w01 = torch.from_numpy((rng.uniform(size=B) < 0.8).astype(np.float32)).to(dev)
    got = stats_update(counts.clone(), leaf, xbin, y, w01)
    want = stats_update_ref(counts.clone(), leaf, xbin, y, w01)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "vht_stats (0/1 weights) differs")
    frac = torch.from_numpy((rng.uniform(size=(N_NODES, M_ATTRS, BINS, C)) * 5)
                            .astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.uniform(size=B).astype(np.float32)).to(dev)
    got = stats_update(frac.clone(), leaf, xbin, y, wf)
    want = stats_update_ref(frac.clone(), leaf, xbin, y, wf)
    err = max_abs_err(got, want)
    require(err <= 1e-5, f"vht_stats (fractional) max abs err {err}")
    log(f"vht_stats [{N_NODES},{M_ATTRS},{BINS},{C}] B={B}: exact (0/1), "
        f"fractional max abs err {err:.3g}")
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    jj = torch.arange(M_ATTRS, device=dev)
    flat = (((leaf.long()[:, None] * M_ATTRS + jj) * BINS + xbin.long()) * C
            + y.long()[:, None]).reshape(-1)
    vals = ones[:, None].expand(B, M_ATTRS).reshape(-1).contiguous()
    work = counts.clone()
    cells = int(torch.unique(flat).numel())
    moved = B * 12 + B * M_ATTRS * 4 + cells * 8
    kt = timed(lambda: stats_update(work, leaf, xbin, y, ones))
    pt = timed(lambda: stats_update_ref(work, leaf, xbin, y, ones))
    lt = timed(lambda: work.view(-1).index_put_((flat,), vals,
                                                accumulate=True))
    bound_ms, bound_by = bound(moved, B * M_ATTRS)
    out["vht_stats"] = {
        "ms": kt["ms"], "call_ms": kt["call_ms"],
        "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
        "library_ms": lt["ms"], "library_call_ms": lt["call_ms"],
        "bytes": moved, "ops": B * M_ATTRS,
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}

    # split_gain: the gathered tile [16, ...] and the full fallback [255, ...]
    for rows in (16, N_NODES):
        s = torch.from_numpy(rng.randint(0, 30, (rows, M_ATTRS, BINS, C))
                             .astype(np.float32)).to(dev)
        s *= torch.from_numpy((rng.uniform(size=s.shape) < 0.5)
                              .astype(np.float32)).to(dev)
        got, want = split_gain(s), split_gain_ref(s)
        require(torch.equal(got == NEG, want == NEG),
                f"split_gain [{rows}] NEG mask differs")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        err = max_abs_err(got, want)
        moved = s.numel() * 4 + got.numel() * 4
        per_entropy = 6 * C + 2
        ops = rows * M_ATTRS * (BINS * C + per_entropy + BINS * (
            2 * C + 2 * per_entropy + 7))
        bound_ms, bound_by = bound(moved, ops)
        kt, pt = timed(lambda: split_gain(s)), timed(lambda: split_gain_ref(s))
        entry = {
            "ms": kt["ms"], "call_ms": kt["call_ms"],
            "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
            "library_ms": None, "bytes": moved, "ops": ops,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
        log(f"split_gain [{rows},{M_ATTRS},{BINS},{C}]: max abs err {err:.3g}"
            " (atol=rtol=1e-4)")
        out["split_gain" if rows == 16 else "split_gain_full"] = entry
    for name, e in out.items():
        log_kernel(name, e)
    return out


def kernel_rule_stats(dev):
    """rule_stats at the AMRules main path's [65, 40, 8, 3], B = 512, and
    at HAMR-3's 510 instances: exact against the plain version (both sum
    each cell in instance order), random rows with the discard row 65 and
    rows past it, moments of negative and positive targets."""
    import numpy as np
    import torch
    from repro_torch.kernels.rule_stats.ops import (rule_moments,
                                                    rule_stats_scatter)
    from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref

    rng = np.random.RandomState(3)
    R1, m = RULES + 1, 40

    def t(a):
        return torch.from_numpy(a).to(dev)

    stats = t((rng.uniform(size=(R1, m, BINS, MOMENTS)) * 5)
              .astype(np.float32))
    for n in (B, (B // 3) * 3):
        seg = t(rng.randint(0, R1 + 2, n).astype(np.int32))   # >= 65: drop
        xbin = t(rng.randint(0, BINS, (n, m)).astype(np.int32))
        mom = rule_moments(t((rng.randn(n) * 2).astype(np.float32)))
        got = rule_stats_scatter(stats.clone(), seg, xbin, mom)
        want = rule_stats_scatter_ref(stats.clone(), seg, xbin, mom)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"rule_stats B={n} differs from its plain version")
        err = max_abs_err(got, want)
        log(f"rule_stats [{R1},{m},{BINS},{MOMENTS}] B={n}: bit-identical to "
            f"the plain version (max abs err {err})")
    # timing at B = 512 on the last inputs of that shape
    seg = t(rng.randint(0, R1 + 1, B).astype(np.int32))
    xbin = t(rng.randint(0, BINS, (B, m)).astype(np.int32))
    mom = rule_moments(t((rng.randn(B) * 2).astype(np.float32)))
    work = stats.clone()
    keep = seg < R1
    cells = (((seg.long()[:, None] * m + torch.arange(m, device=dev)) * BINS
              + xbin.long()) * MOMENTS)[keep]                     # [b, m]
    flat = (cells[..., None] + torch.arange(MOMENTS, device=dev)).reshape(-1)
    vals = mom[keep][:, None, :].expand(-1, m, -1).reshape(-1).contiguous()
    valid = int(keep.sum())
    moved = 2 * stats.numel() * 4 + xbin.numel() * 4 + seg.numel() * 4 \
        + mom.numel() * 4
    ops = valid * m * MOMENTS
    kt = timed(lambda: rule_stats_scatter(work, seg, xbin, mom))
    pt = timed(lambda: rule_stats_scatter_ref(work, seg, xbin, mom), n=10)
    lt = timed(lambda: work.view(-1).index_put_((flat,), vals,
                                                accumulate=True))
    bound_ms, bound_by = bound(moved, ops)
    e = {"ms": kt["ms"], "call_ms": kt["call_ms"],
         "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
         "library_ms": lt["ms"], "library_call_ms": lt["call_ms"],
         "bytes": moved, "ops": ops, "bound_ms": bound_ms,
         "bound_by": bound_by, "max_abs_err": err}
    log(f"rule_stats: device ms per launch: kernel {e['ms']:.5f}, plain "
        f"{e['plain_ms']:.5f}, library {e['library_ms']:.5f}, bound "
        f"{e['bound_ms']:.6f} ({e['bound_by']}), kernel/bound "
        f"{e['ms'] / e['bound_ms']:.1f}; ms per call from the host: kernel "
        f"{e['call_ms']:.5f}, plain {e['plain_call_ms']:.5f}, library "
        f"{e['library_call_ms']:.5f}")
    e["sums"] = kernel_segment_sums(dev, rng)
    return e


def kernel_segment_sums(dev, rng):
    """The rule_stats kernel as ``segment_sum``, at the AMRules main path's
    reductions (VAMR, B = 512): the per-rule sums of (1, y, |err|) over
    the 65 rows, and the two levels of the default rule's batch sum of 4
    columns (512 instances into 16 windows, 16 window sums into one).
    Exact against the plain version; device ms of each launch beside its
    bound and ``index_add_``'s on the same tensors (a scratch row takes
    the dropped instances)."""
    import numpy as np
    import torch
    from repro_torch.kernels.rule_stats.ops import segment_sum
    from repro_torch.kernels.rule_stats.ref import (rule_stats_scatter_ref,
                                                    xla_windows)

    def t(a):
        return torch.from_numpy(a).to(dev)

    levels = xla_windows((B,), dev)
    shapes = {"per-rule sums": (RULES + 1, t(rng.randint(
        0, RULES + 1, B).astype(np.int32)), 3)}
    shapes.update({f"batch sum level {k + 1}": (n_win, ids, 4)
                   for k, (ids, _, n_win) in enumerate(levels)})
    out = {}
    for what, (rows, seg, k) in shapes.items():
        n = seg.shape[0]
        xb = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        vals = t((rng.randn(n, k) * 2).astype(np.float32))
        zeros = torch.zeros((rows, 1, 1, k), device=dev)
        got = segment_sum(zeros.clone(), seg, xb, vals)
        want = rule_stats_scatter_ref(zeros.clone(), seg, xb, vals)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"segment_sum {what} differs from its plain version")
        work = zeros.clone()
        e = timed(lambda: segment_sum(work, seg, xb, vals))
        pt = timed(lambda: rule_stats_scatter_ref(work, seg, xb, vals), n=10)
        e.update(plain_ms=pt["ms"], plain_call_ms=pt["call_ms"])
        keep = (seg >= 0) & (seg < rows)
        idx = torch.where(keep, seg, rows).long()
        scratch = torch.zeros((rows + 1, k), device=dev)
        lt = timed(lambda: scratch.index_add_(0, idx, vals))
        # out read and written, seg, xbin and vals read; one add per value
        moved = 2 * zeros.numel() * 4 + 2 * n * 4 + vals.numel() * 4
        bound_ms, bound_by = bound(moved, int(keep.sum()) * k)
        e.update(library_ms=lt["ms"], library_call_ms=lt["call_ms"],
                 bytes=moved, ops=int(keep.sum()) * k, bound_ms=bound_ms,
                 bound_by=bound_by)
        out[what] = e
        log(f"rule_stats as segment_sum, {what} [{rows},1,1,{k}] B={n}: "
            f"exact; device ms {e['ms']:.5f}, plain {e['plain_ms']:.5f}, "
            f"library (index_add_) "
            f"{e['library_ms']:.5f}, bound {bound_ms:.6f} ({bound_by}), "
            f"kernel/bound {e['ms'] / bound_ms:.1f}; call ms "
            f"{e['call_ms']:.5f}")
    return out


def run_pair(make_learner, batches, what):
    """The learner over batches with the kernels, then with the plain
    versions; both must give the same per-batch metrics and tree.  Returns
    (kernel-run result, launches, µs/batch)."""
    import torch
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.kernels import launches, reset_launches

    rec = Recording(make_learner())
    torch.cuda.synchronize()
    reset_launches()
    res = PrequentialEvaluation(rec, batches, compiled=False).run()
    count = launches()
    torch.cuda.synchronize()
    plain = Recording(make_learner())
    with plain_kernels():
        reset_launches()
        ref = PrequentialEvaluation(plain, batches, compiled=False).run()
        require(sum(launches().values()) == 0, "plain run launched a kernel")
    res.extra["metrics"] = rec.metrics
    for key in ("correct", "dropped", "n_nodes"):
        require(torch.equal(stacked(rec.metrics, key),
                            stacked(plain.metrics, key)),
                f"{what}: per-batch {key} differs from the plain run")
    require(same_tree(res.extra["state"], ref.extra["state"]),
            f"{what}: final tree differs from the plain run")
    require(torch.equal(res.extra["state"]["stats"], ref.extra["state"]["stats"]),
            f"{what}: final stats differ from the plain run")
    n_nodes = int(res.extra["state"]["n_nodes"])
    require(n_nodes > 1, f"{what}: the tree did not grow")
    require(0.0 <= res.metric <= 1.0 and math.isfinite(res.metric),
            f"{what}: accuracy {res.metric}")
    us = 1e6 * batches[0][1].shape[0] / res.throughput
    log(f"{what}: acc {res.metric:.4f} nodes {n_nodes} "
        f"dropped {float(stacked(rec.metrics, 'dropped').sum()):.0f} "
        f"{us:.1f} us/batch {res.throughput:.0f} inst/s launches {count}; "
        f"same as plain run")
    return res, count, us


def tree_config(m, n_classes=2, **kw):
    """benchmarks/vht_benchmarks.py::_tc."""
    from repro_torch.ml.htree import TreeConfig
    return TreeConfig(n_attrs=m, n_bins=8, n_classes=n_classes,
                      max_nodes=255, n_min=200, **kw)


def stream(m, n_batches, dev):
    from repro_torch.data.generators import RandomTreeGenerator
    from repro_torch.data.pipeline import StreamPipeline
    gen = RandomTreeGenerator(n_cat=m // 2, n_num=m - m // 2, depth=8,
                              device=dev)
    return list(StreamPipeline(gen, batch=B, n_batches=n_batches, n_bins=BINS,
                               device=dev))


def count_syncs(learner, state, batches):
    """Device-to-host syncs per step, counted by torch's sync debug mode."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for x, y in batches:
            state, _ = learner.step(state, x, y)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in syncs)
    log(f"  syncs by source line over {len(batches)} steps: {dict(where)}")
    return len(syncs) / len(batches)


def profile_steps(learner, state, batches, kernel=None, order=()):
    """Device busy share and device time by kernel over the steps, from a
    torch.profiler trace (the profiler's own cost is in the wall time).
    With ``kernel`` and ``order``: the step launches that kernel once for
    each name of ``order``, in that order; the device µs per step of each
    launch, from the trace's kernel records in time order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            state, _ = learner.step(state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    require(busy_us > 0, "profiler trace shows no device time")
    n = len(batches)
    log(f"profile of {n} steps: wall {wall_us / n:.1f} us/step, device busy "
        f"{busy_us / n:.1f} us/step ({100 * busy_us / wall_us:.1f} %), "
        f"{sum(r[1] for r in rows) / n:.1f} device ops/step")
    for us, count, key in rows[:10]:
        log(f"  {us / n:9.2f} us/step  {count / n:5.2f}/step  {key[:90]}")
    # the port's own kernels, in or out of the ten above, and the one-thread
    # kernel that sets a conditional node's condition (graph_cond.cu)
    ours = {}
    for us, count, key in rows:
        m = re.search(r"(\w+_(?:kernel|wgmma|conditions)\w*(?:<[^(]*>)?)\(",
                      key)
        if m and m.group(1).startswith(
                (*VHT_KERNELS, "rule_stats", "segment_sum",
                 *LM_ARCHS.values(), "split_poisson", "set_conditions")):
            ours[m.group(1)] = {"us_per_step": us / n, "per_step": count / n}
    log("  the port's kernels per step: " + ", ".join(
        f"{k} {v['us_per_step']:.2f} us ({v['per_step']:.2f} launches)"
        for k, v in ours.items()))
    split = {}
    if kernel is not None:
        runs = sorted((e.time_range.start, e.time_range.elapsed_us())
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA and kernel in e.name)
        require(len(runs) == len(order) * n,
                f"{kernel}: {len(runs)} launches in {n} steps, expected "
                f"{len(order)} per step")
        split = {what: sum(d for _, d in runs[k::len(order)]) / n
                 for k, what in enumerate(order)}
        log(f"  {kernel} per step by launch: " + ", ".join(
            f"{what} {us:.2f} us" for what, us in split.items()))
    return {"split": split, "port_kernels": ours,
            "wall_us_per_step": wall_us / n, "busy_us_per_step": busy_us / n,
            "busy_share": busy_us / wall_us,
            "device_ops_per_step": sum(r[1] for r in rows) / n}


@contextlib.contextmanager
def no_syncs():
    """The card's sync debug mode set to raise on any device-to-host sync,
    around the replays of a captured step."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_compiled(make_learner, batches, eager, keys, what, jit_engine=True):
    """The learner compiled, as a user runs it: PrequentialEvaluation (whose
    default is one captured graph replayed per batch), then, unless
    ``jit_engine`` is False, JitEngine.run_stream on the bare learner (the
    first step eager, then one graph).  Against ``eager``, the eager kernel run's result with its
    per-batch metrics: the curve and the final state of the first, the
    per-batch ``keys`` and the final state of the second, bit for bit.
    Returns (us/batch, first batch's s: the capture and its warm-up)."""
    import torch
    from repro_torch.core.engines import JitEngine
    from repro_torch.core.evaluation import PrequentialEvaluation

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = PrequentialEvaluation(make_learner(), batches).run()
    total_s = time.perf_counter() - t0
    require(res.curve == eager.curve and res.metric == eager.metric,
            f"{what} compiled: the curve differs from the eager run's")
    require(same_state(res.extra["state"], eager.extra["state"]),
            f"{what} compiled: the final state differs from the eager run's")
    us = 1e6 * batches[0][1].shape[0] / res.throughput
    first_s = total_s - (len(batches) - 1) * us * 1e-6
    if not jit_engine:
        log(f"{what} compiled: {us:.1f} us/batch {res.throughput:.0f} "
            f"inst/s (first batch, with the capture: {first_s:.2f} s); "
            "curve and final state bit for bit the eager run's, through "
            "PrequentialEvaluation")
        return us, first_s
    learner = make_learner()
    eng = JitEngine()
    carry, outs = eng.run_stream(learner, eng.init(learner),
                                 [{"x": x, "y": y} for x, y in batches])
    for key in keys:
        require(torch.equal(outs["metrics"][key].cpu().view(torch.int32),
                            stacked(eager.extra["metrics"], key)
                            .view(torch.int32)),
                f"{what} on JitEngine: per-batch {key} differs from the "
                "eager run's")
    require(same_state(carry["states"][type(learner).__name__.lower()],
                       eager.extra["state"]),
            f"{what} on JitEngine: the final state differs from the eager "
            "run's")
    log(f"{what} compiled: {us:.1f} us/batch {res.throughput:.0f} inst/s "
        f"(first batch, with the capture: {first_s:.2f} s); curve, "
        f"per-batch {', '.join(keys)} and final state bit for bit the eager "
        "run's, through PrequentialEvaluation and JitEngine.run_stream")
    return us, first_s


def graph_profile(make_learner, state, batches, what):
    """One captured step of the learner, from ``state``: its replays over
    20 batches with syncs raising, the syncs per step counted again in the
    warn mode (0), and a profile of 50 replays."""
    from repro_torch.core.compiled import compile_step
    from repro_torch.core.pytree import tree_clone
    from repro_torch.kernels import launches, reset_launches

    learner = make_learner()
    reset_launches()
    # a learner whose step is the captured one
    step = types.SimpleNamespace(step=compile_step(learner.step, state,
                                                   *batches[0]))
    captured = {k: v for k, v in launches().items() if v}
    st = tree_clone(state)
    with no_syncs():
        for x, y in batches[:20]:
            st, _ = step.step(st, x, y)
    syncs = count_syncs(step, st, batches[:20])
    require(syncs == 0, f"{what} compiled: {syncs} syncs per replay")
    prof = profile_steps(step, st, batches[:50])
    log(f"{what} compiled: {syncs:.2f} device-to-host syncs per step, "
        f"{prof['device_ops_per_step']:.1f} device ops per step, busy "
        f"{100 * prof['busy_share']:.1f} %; the wrappers called in the "
        f"warm-up and the capture: {captured}")
    return {"syncs_per_step": syncs, "profile": prof,
            "wrapper_calls_at_capture": captured}


def phase_main(dev, smi):
    import torch
    from repro_torch.kernels.tree_route.ops import tree_route
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    from repro_torch.core.pytree import tree_clone
    from repro_torch.ml.vht import VHT, VHTConfig

    batches = stream(M_ATTRS, MAIN_BATCHES, dev)
    cfg = VHTConfig(tree_config(M_ATTRS, split_delay=4))
    res, count, us = run_pair(lambda: VHT(cfg, device=dev), batches,
                              "main dense-1000 wok")
    for name in VHT_KERNELS:
        require(count[name] > 0, f"main path: {name} was not launched")
    log(f"main path dense-1000 wok B={B} x {MAIN_BATCHES}: {us:.1f} us/batch, "
        f"{res.throughput:.0f} instances/s on {smi}")

    # tree_route on the learned tree, exact
    st = res.extra["state"]
    xb = batches[-1][0]
    got = tree_route(st["split_attr"], st["split_bin"], st["children"], xb,
                     max_depth=DEPTH)
    want = tree_route_ref(st["split_attr"][None], st["split_bin"][None],
                          st["children"][None], xb, DEPTH)[0]
    torch.cuda.synchronize()
    require(torch.equal(got, want), "tree_route differs on the learned tree")
    log(f"tree_route on the learned tree ({int(st['n_nodes'])} nodes): exact")
    on_path = kernels_on_path(st, xb, batches[-1][1], got, smi)

    syncs = count_syncs(VHT(cfg, device=dev), tree_clone(st), batches[:20])
    log(f"main path: {syncs:.2f} device-to-host syncs per step "
        "(VHT.step alone, torch sync debug mode)")
    prof = profile_steps(VHT(cfg, device=dev), tree_clone(st), batches[:50])

    what = "main dense-1000 wok"
    us_c, first_s = run_compiled(lambda: VHT(cfg, device=dev), batches, res,
                                 ("correct", "dropped", "n_nodes"), what)
    graph = graph_profile(lambda: VHT(cfg, device=dev), st, batches, what)
    compare_paths(what, (us, syncs, prof), (us_c, graph), smi)
    return {"us_per_batch": us, "inst_per_s": res.throughput,
            "acc": res.metric, "n_nodes": int(st["n_nodes"]),
            "launches": count, "syncs_per_step": syncs, "profile": prof,
            "kernels_on_path": on_path,
            "compiled": {"us_per_batch": us_c, "first_batch_s": first_s,
                         **graph}}


def compare_paths(what, eager, compiled, smi):
    """One line: a main path eager against compiled."""
    (us, syncs, prof), (us_c, graph) = eager, compiled
    g = graph["profile"]

    def kernels(p):
        return ", ".join(f"{k.split('<')[0]} {v['per_step']:.2f}"
                         for k, v in p["port_kernels"].items())

    log(f"{what}, eager against compiled: {us:.1f} against {us_c:.1f} "
        f"us/batch; {syncs:.2f} against {graph['syncs_per_step']:.2f} syncs "
        f"per step; device busy {prof['busy_us_per_step']:.1f} against "
        f"{g['busy_us_per_step']:.1f} us per step, {100 * prof['busy_share']:.1f}"
        f" against {100 * g['busy_share']:.1f} % of the wall; "
        f"{prof['device_ops_per_step']:.1f} against "
        f"{g['device_ops_per_step']:.1f} device ops per step; the port's "
        f"kernels' launches per step in the trace: {kernels(prof)} against "
        f"{kernels(g)}; on {smi}")


def kernels_on_path(st, xb, y, leaf, smi):
    """tree_route and vht_stats on the inputs the main path gives them:
    the learned tree and the last batch, routed to its leaves (weights 1,
    on a copy of the learned statistics).  vht_stats must equal its plain
    version bit for bit; device ms of each beside its plain version's and
    its bound."""
    import torch
    from repro_torch.kernels.tree_route.ops import tree_route
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    from repro_torch.kernels.vht_stats.ops import stats_update
    from repro_torch.kernels.vht_stats.ref import stats_update_ref

    tables = (st["split_attr"], st["split_bin"], st["children"])
    ones = torch.ones(B, dtype=torch.float32, device=xb.device)
    got = stats_update(st["stats"].clone(), leaf, xb, y, ones)
    want = stats_update_ref(st["stats"].clone(), leaf, xb, y, ones)
    torch.cuda.synchronize()
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            "vht_stats differs from its plain version on the main path's "
            "inputs")
    steps = route_steps(*(a[None] for a in tables), xb, DEPTH)
    work = st["stats"].clone()
    jj = torch.arange(M_ATTRS, device=xb.device)
    flat = (((leaf.long()[:, None] * M_ATTRS + jj) * BINS + xb.long()) * C
            + y.long()[:, None]).reshape(-1)
    cells = int(torch.unique(flat).numel())
    vals = ones[:, None].expand(B, M_ATTRS).reshape(-1).contiguous()
    out = {}
    for name, fn, plain, moved, ops in (
            ("tree_route",
             lambda: tree_route(*tables, xb, max_depth=DEPTH),
             lambda: tree_route_ref(*(a[None] for a in tables), xb, DEPTH),
             st["split_attr"].numel() * 16 + steps * 4 + B * 4, steps),
            ("vht_stats",
             lambda: stats_update(work, leaf, xb, y, ones),
             lambda: stats_update_ref(work, leaf, xb, y, ones),
             B * 12 + B * M_ATTRS * 4 + cells * 8, B * M_ATTRS)):
        kt, pt = timed(fn), timed(plain)
        bound_ms, bound_by = bound(moved, ops)
        out[name] = {"ms": kt["ms"], "call_ms": kt["call_ms"],
                     "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
                     "bytes": moved, "ops": ops, "bound_ms": bound_ms,
                     "bound_by": bound_by}
    # the library call that computes the same update (a yardstick only)
    lt = timed(lambda: work.view(-1).index_put_((flat,), vals,
                                                accumulate=True))
    out["vht_stats"].update(library_ms=lt["ms"],
                            library_call_ms=lt["call_ms"])
    out["vht_stats"]["leaves"] = int(torch.unique(leaf).numel())
    out["tree_route"]["n_nodes"] = int(st["n_nodes"])
    log(f"on the main path's inputs ({int(st['n_nodes'])}-node tree, the "
        f"last batch in {out['vht_stats']['leaves']} leaves; vht_stats "
        f"bit-identical to its plain version): " + "; ".join(
            f"{k} device ms {v['ms']:.5f} (plain {v['plain_ms']:.5f}, library "
            f"{v.get('library_ms')}, bound {v['bound_ms']:.3g} "
            f"{v['bound_by']}), call ms {v['call_ms']:.5f}"
            for k, v in out.items()) + f" on {smi}")
    return out


def phase_paths(dev):
    import torch
    from repro_torch.core.engines import LocalEngine, StreamEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.ml.vht import VHT, VHTConfig, build_vht_topology

    n_batches = 100
    variants = {"local": {}, "wok": {"split_delay": 4},
                "wk256": {"split_delay": 4, "buffer_size": 256}}
    out = {}
    for m in (20, 200):
        batches = stream(m, n_batches, dev)
        for name, kw in variants.items():
            cfg = VHTConfig(tree_config(m, **kw))
            what = f"dense-{m} {name}"
            res, count, us = run_pair(lambda: VHT(cfg, device=dev), batches,
                                      what)
            us_c, _ = run_compiled(lambda: VHT(cfg, device=dev), batches, res,
                                   ("correct", "dropped", "n_nodes"), what)
            out[what] = {"us_per_batch": us, "launches": count,
                         "compiled_us_per_batch": us_c}

    batches = stream(200, n_batches, dev)
    payloads = [{"x": x, "y": y} for x, y in batches]
    cfg = VHTConfig(tree_config(200))
    kernel_runs = {}
    for engine in (LocalEngine(), StreamEngine()):
        ename = type(engine).__name__
        topo = build_vht_topology(cfg, device=dev)
        init = engine.init(topo)
        engine.run_stream(topo, init, payloads[:2])            # warm up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        final, outs = engine.run_stream(topo, init, payloads)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        count = launches()
        with plain_kernels():
            ref_final, ref_outs = engine.run_stream(topo, init, payloads)
        states = final if ename == "LocalEngine" else final["states"]
        ref_states = ref_final if ename == "LocalEngine" else ref_final["states"]
        pred = stack_outputs(outs)["prediction"]["pred"]
        ref_pred = stack_outputs(ref_outs)["prediction"]["pred"]
        require(torch.equal(pred, ref_pred),
                f"topology {ename}: predictions differ from the plain run")
        require(same_tree(states["model-aggregator"],
                          ref_states["model-aggregator"]),
                f"topology {ename}: tree differs from the plain run")
        require(torch.equal(states["local-statistic"]["stats"],
                            ref_states["local-statistic"]["stats"]),
                f"topology {ename}: stats differ from the plain run")
        n_nodes = int(states["model-aggregator"]["n_nodes"])
        require(n_nodes > 1, f"topology {ename}: the tree did not grow")
        require(all(count[name] > 0 for name in VHT_KERNELS),
                f"topology {ename}: launches {count}")
        acc = float((pred == torch.stack([y for _, y in batches])).float()
                    .mean())
        us = dt / n_batches * 1e6
        log(f"topology dense-200 {ename}: acc {acc:.4f} nodes {n_nodes} "
            f"{us:.1f} us/batch launches {count}; same as plain run")
        out[f"topology dense-200 {ename}"] = {"us_per_batch": us,
                                              "launches": count}
        kernel_runs[ename] = (states, pred)
    out["topology dense-200 JitEngine"] = jit_topology(
        cfg, payloads, kernel_runs["StreamEngine"], dev)
    return out


def jit_topology(cfg, payloads, stream_run, dev):
    """The MA/LS topology on JitEngine (the first step eager, then one
    captured graph per step) against the StreamEngine's kernel run: the
    predictions and every state leaf, bit for bit; twice, the second time
    replaying the graph the first captured."""
    import torch
    from repro_torch.core.engines import JitEngine
    from repro_torch.ml.vht import build_vht_topology

    want_states, want_pred = stream_run
    eng = JitEngine()
    topo = build_vht_topology(cfg, device=dev)
    init = eng.init(topo)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs = eng.run_stream(topo, init, payloads)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(torch.equal(outs["prediction"]["pred"], want_pred),
                "topology JitEngine: predictions differ from the "
                "StreamEngine's")
        for name, st in want_states.items():
            require(same_state(final["states"][name], st),
                    f"topology JitEngine: {name} state differs from the "
                    "StreamEngine's")
    us = times[1] / len(payloads) * 1e6
    log(f"topology dense-200 JitEngine: {us:.1f} us/batch (first run, with "
        f"the capture: {times[0]:.2f} s); predictions and every state leaf "
        "bit for bit the StreamEngine's")
    return {"us_per_batch": us, "first_run_s": times[0]}


def rules_stream(name, n_batches, dev):
    """(m, batches of (xbin [B, m] i32, y [B] f32)) of the regression
    streams of benchmarks/amrules_benchmarks.py, drawn on the card."""
    import torch
    from repro_torch.data.generators import (ElectricityLikeGenerator,
                                             WaveformGenerator, bin_numeric)
    if name == "waveform":
        gen = WaveformGenerator(device=dev)
        sample, m = gen.sample_regression, gen.n_attrs
    else:
        gen = ElectricityLikeGenerator()
        sample, m = gen.sample, gen.n_attrs
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    batches = []
    for _ in range(n_batches):
        x, y = sample(g, B)
        batches.append((bin_numeric(x, BINS), y))
    return m, batches


def same_state(a, b):
    """Every leaf of two nested dicts equal (None allowed), float and
    uint32 leaves bit for bit."""
    import torch
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def run_rules(make_learner, batches, what):
    """One AMRules learner over batches: with the kernel, again with the
    kernel, and with the plain versions.  Returns (result, launches of the
    first run, us/batch)."""
    import torch
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.kernels import launches, reset_launches

    rec = Recording(make_learner())
    torch.cuda.synchronize()
    reset_launches()
    res = PrequentialEvaluation(rec, batches, compiled=False).run()
    count = launches()
    again = PrequentialEvaluation(Recording(make_learner()), batches,
                                  compiled=False).run()
    require(same_state(res.extra["state"], again.extra["state"]),
            f"{what}: two runs with the kernel differ")
    plain = Recording(make_learner())
    with plain_kernels():
        reset_launches()
        ref = PrequentialEvaluation(plain, batches, compiled=False).run()
        require(sum(launches().values()) == 0, "plain run launched a kernel")
    for key in ("abs_err", "sq_err", "n_rules"):
        require(torch.equal(stacked(rec.metrics, key),
                            stacked(plain.metrics, key)),
                f"{what}: per-batch {key} differs from the plain run")
    st = res.extra["state"]
    require(same_state(st, ref.extra["state"]),
            f"{what}: final state differs from the plain run")
    require(count["rule_stats"] > 0,
            f"{what}: the moment statistics did not launch rule_stats")
    require(count["segment_sum"] > 0,
            f"{what}: the reductions did not launch rule_stats")
    require(int(st["n_created"]) > 0, f"{what}: no rule was created")
    require(math.isfinite(res.metric) and res.metric >= 0,
            f"{what}: MAE {res.metric}")
    us = 1e6 * batches[0][1].shape[0] / res.throughput
    log(f"{what}: MAE {res.metric:.4f} rules {int(st['n_rules'])} created "
        f"{int(st['n_created'])} removed {int(st['n_removed'])} feats "
        f"{int(st['n_feats'])} {us:.1f} us/batch {res.throughput:.0f} "
        f"inst/s launches {count}; same as a second run and as the plain "
        "run")
    res.extra["metrics"] = rec.metrics
    return res, count, us


def phase_rules(dev, smi):
    """MAMR, VAMR and HAMR-2 on both streams; VAMR on waveform-40 first, as
    the main path, with its syncs per step and a profile."""
    from repro_torch.core.pytree import tree_clone
    from repro_torch.ml.amrules import AMRules, HAMR, RulesConfig, VAMR

    learners = {"VAMR": VAMR, "MAMR": AMRules,
                "HAMR-2": lambda rc, device: HAMR(rc, replicas=2,
                                                  device=device)}
    out = {}
    for stream_name in ("waveform", "electricity"):
        m, batches = rules_stream(stream_name, RULES_BATCHES, dev)
        rc = RulesConfig(n_attrs=m, n_bins=BINS, max_rules=RULES, n_min=200)
        for name, mk in learners.items():
            what = f"{stream_name}-{m} {name}"
            res, count, us = run_rules(lambda: mk(rc, device=dev), batches,
                                       what)
            out[what] = {"us_per_batch": us, "inst_per_s": res.throughput,
                         "mae": res.metric, "launches": count,
                         "n_created": int(res.extra["state"]["n_created"])}
            if stream_name == "waveform":
                us_c, first_s = run_compiled(
                    lambda: mk(rc, device=dev), batches, res,
                    ("abs_err", "sq_err", "n_rules"), what)
                out[what]["compiled"] = {"us_per_batch": us_c,
                                         "first_batch_s": first_s}
            if what != "waveform-40 VAMR":
                continue
            st = res.extra["state"]
            syncs = count_syncs(VAMR(rc, device=dev), tree_clone(st),
                                batches[:20])
            log(f"amrules main path: {syncs:.2f} device-to-host syncs per "
                "step (VAMR.step alone, torch sync debug mode)")
            prof = profile_steps(VAMR(rc, device=dev), tree_clone(st),
                                 batches[:50], "rule_stats_kernel",
                                 ("per-rule sums", "moment statistics",
                                  "batch sum level 1", "batch sum level 2"))
            out[what].update(syncs_per_step=syncs, profile=prof)
            log(f"amrules main path waveform-40 VAMR B={B} x {RULES_BATCHES}:"
                f" {us:.1f} us/batch, {res.throughput:.0f} instances/s on "
                f"{smi}")
            graph = graph_profile(lambda: VAMR(rc, device=dev), st, batches,
                                  what)
            out[what]["compiled"].update(graph)
            compare_paths(f"amrules main path {what}", (us, syncs, prof),
                          (out[what]["compiled"]["us_per_batch"], graph), smi)
    return out


def ensemble_stream(kind, n_batches, dev):
    """The ensembles' streams, drawn on the card at B = 512 and 8 bins:
    dense-m (benchmarks/vht_benchmarks.py's RandomTreeGenerator(n_cat=m/2,
    n_num=m/2, depth=8)), covtype-54 (CovtypeLikeGenerator, 7 classes),
    and the concept switch at dense-200 (hidden trees of depth 2, seed 7,
    then seed 11 from batch SWITCH_AT on, a concept the trees learn before
    it switches, so that DDM sees the switch)."""
    from repro_torch.data.generators import (CovtypeLikeGenerator,
                                             RandomTreeGenerator)
    from repro_torch.data.pipeline import StreamPipeline
    if kind.startswith("dense-"):
        return stream(int(kind[6:]), n_batches, dev)
    if kind == "covtype-54":
        return list(StreamPipeline(CovtypeLikeGenerator(device=dev), batch=B,
                                   n_batches=n_batches, n_bins=BINS,
                                   device=dev))
    out = []
    for seed, n, pipe_seed in ((7, SWITCH_AT, 0), (11, n_batches - SWITCH_AT,
                                                   1)):
        gen = RandomTreeGenerator(n_cat=100, n_num=100, depth=2, seed=seed,
                                  device=dev)
        out += list(StreamPipeline(gen, batch=B, n_batches=n, n_bins=BINS,
                                   seed=pipe_seed, device=dev))
    return out


def run_ensemble(make_learner, batches, keys, what):
    """An ensemble over batches three ways: eagerly with the kernels, then
    compiled (PrequentialEvaluation's captured graph), then eagerly with
    the plain versions; every per-batch metric of ``keys`` and the final
    state, key included, bit for bit across the three.  Returns (eager
    result, launches, eager us/batch, compiled us/batch)."""
    import torch
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.kernels import launches, reset_launches

    rec = Recording(make_learner())
    torch.cuda.synchronize()
    reset_launches()
    res = PrequentialEvaluation(rec, batches, compiled=False).run()
    count = launches()
    res.extra["metrics"] = rec.metrics
    us = 1e6 * B / res.throughput
    us_c, _ = run_compiled(make_learner, batches, res, keys, what,
                           jit_engine=False)
    plain = Recording(make_learner())
    with plain_kernels():
        reset_launches()
        ref = PrequentialEvaluation(plain, batches, compiled=False).run()
        require(sum(launches().values()) == 0, "plain run launched a kernel")
    for key in keys:
        require(torch.equal(stacked(rec.metrics, key).view(torch.int32),
                            stacked(plain.metrics, key).view(torch.int32)),
                f"{what}: per-batch {key} differs from the plain run")
    require(same_state(res.extra["state"], ref.extra["state"]),
            f"{what}: the final state differs from the plain run's")
    st = res.extra["state"]
    trees = st["trees"] if "trees" in st else st
    nodes = trees["n_nodes"].tolist()
    require(sum(nodes) > len(nodes), f"{what}: no member grew")
    require(0.0 <= res.metric <= 1.0 and math.isfinite(res.metric),
            f"{what}: accuracy {res.metric}")
    drifts = (float(stacked(rec.metrics, "drifts").sum())
              if "drifts" in keys else None)
    log(f"{what}: acc {res.metric:.4f} nodes {nodes} drifts {drifts} "
        f"{us:.1f} us/batch eager, {us_c:.1f} compiled; launches {count}; "
        "eager, compiled and plain bit for bit alike")
    return res, count, us, us_c


def ensemble_kernels(st, xb, smi):
    """On the main path's final state and last batch: tree_route at M = 10
    on the learned trees, and split_poisson drawing the members' weights
    (bagging's rates), each against its plain version and timed (device
    ms, CUDA events over 50 launches) beside its bound; and the drift
    reset as the JAX package writes it, where(drift, fresh, old) over
    every leaf, against the port's gated form, both for one member."""
    import torch
    from repro_torch.core.prng import ROUNDS
    from repro_torch.core.pytree import tree_clone, tree_map
    from repro_torch.kernels.split_poisson.ops import split_poisson
    from repro_torch.kernels.split_poisson.ref import split_poisson_ref
    from repro_torch.kernels.tree_route.ops import tree_route
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    from repro_torch.ml.htree import init_tree

    trees = st["trees"]
    M = trees["split_attr"].shape[0]
    tables = (trees["split_attr"], trees["split_bin"], trees["children"])
    got = tree_route(*tables, xb, max_depth=DEPTH)
    want = tree_route_ref(*tables, xb, DEPTH)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "tree_route differs at M = 10 on the "
            "learned trees")
    steps = route_steps(*tables, xb, DEPTH)
    moved = tables[0].numel() * 16 + steps * 4 + M * B * 4
    bound_ms, bound_by = bound(moved, steps)
    kt = timed(lambda: tree_route(*tables, xb, max_depth=DEPTH))
    pt = timed(lambda: tree_route_ref(*tables, xb, DEPTH))
    route = {"M": M, "n_nodes": trees["n_nodes"].tolist(), "ms": kt["ms"],
             "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
             "ops": steps, "library_ms": None}
    log(f"tree_route M={M} N={N_NODES} B={B} on the learned trees "
        f"({route['n_nodes']} nodes; exact): device ms {kt['ms']:.5f}, plain "
        f"{pt['ms']:.5f}, bound {bound_ms:.3g} ({bound_by}), kernel/bound "
        f"{kt['ms'] / bound_ms:.0f}, call ms {kt['call_ms']:.5f} on {smi}")

    key = st["key"]
    lam = torch.ones((M, 1), dtype=torch.float32, device=xb.device)
    k_got, w_got = split_poisson(key, lam, (M, B))
    k_want, w_want = split_poisson_ref(key, lam, (M, B))
    torch.cuda.synchronize()
    require(same_state({"k": k_got, "w": w_got}, {"k": k_want, "w": w_want}),
            "split_poisson differs from its plain version")
    rounds = int((w_got + 1).sum())            # Knuth's rounds these draws take
    max_draw = int(w_got.max())
    moved = M * 4 + M * B * 4 + 16
    # the shared chain: max_draw + 1 rounds, and the first split
    ops = (rounds + 2 * (max_draw + 2)) * THREEFRY_OPS
    bound_ms, bound_by = bound(moved, ops, INT32_OPS_PER_S)
    kt = timed(lambda: split_poisson(key, lam, (M, B)))
    pt = timed(lambda: split_poisson_ref(key, lam, (M, B)), n=10, reps=3)
    poisson = {"ms": kt["ms"], "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
               "ops": ops, "rounds": rounds, "max_draw": max_draw,
               "max_abs_err": max_abs_err(w_got, w_want), "library_ms": None}
    log(f"split_poisson [{M},{B}] (bagging, lam 1; {rounds} rounds, largest "
        f"draw {poisson['max_draw']}; bit for bit its plain version): device "
        f"ms {kt['ms']:.5f}, plain {pt['ms']:.5f} (its loop reads the host "
        f"every {ROUNDS} rounds), bound {bound_ms:.3g} ({bound_by}, INT32 at "
        f"{INT32_OPS_PER_S / 1e12:.1f} TOP/s), kernel/bound "
        f"{kt['ms'] / bound_ms:.0f}, call ms {kt['call_ms']:.5f} on {smi}")

    fresh = init_tree(tree_config(M_ATTRS), xb.device)
    drift = torch.zeros(M, dtype=torch.bool, device=xb.device)
    drift[3] = True
    work = tree_clone(trees)

    def jax_form():
        return tree_map(lambda old, fr: torch.where(
            drift.view((-1,) + (1,) * (old.dim() - 1)), fr[None], old),
            work, fresh)

    def gated_form():
        work["stats"].masked_fill_(drift.view(-1, 1, 1, 1, 1), 0.0)
        return {k: torch.where(drift.view((-1,) + (1,) * (v.dim() - 1)),
                               fresh[k][None], v)
                for k, v in work.items() if k != "stats"}

    jt, gt = timed(jax_form, n=20, reps=5), timed(gated_form, n=20, reps=5)
    reset = {"where_every_leaf_ms": jt["ms"], "in_place_ms": gt["ms"],
             "stats_bytes": work["stats"].numel() * 4}
    log(f"drift reset of one member of {M} at dense-{M_ATTRS}: where(drift, "
        f"fresh, old) over every leaf (the JAX form) {jt['ms']:.5f} device "
        f"ms, the port's in-place form {gt['ms']:.5f} (it runs only on a "
        f"step with a drift) on {smi}")
    return {"tree_route_m10": route, "split_poisson": poisson,
            "drift_reset": reset}


def short_last_batch(dev):
    """A VHT (wok) and an OzaBag stream at dense-200 whose last batch is
    200 of B = 512 rows: compiled (a second graph captured for the short
    batch, sharing the state's buffers) against eager, bit for bit."""
    from repro_torch.core.evaluation import PrequentialEvaluation
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.vht import VHT, VHTConfig

    batches = stream(200, 30, dev)
    batches[-1] = (batches[-1][0][:200].contiguous(),
                   batches[-1][1][:200].contiguous())
    makers = {
        "VHT wok": lambda: VHT(VHTConfig(tree_config(200, split_delay=4)),
                               device=dev),
        "OzaBag": lambda: OzaEnsemble(EnsembleConfig(
            tree_config(200), n_members=ENS_M), device=dev)}
    for what, make in makers.items():
        got = PrequentialEvaluation(make(), batches).run()
        want = PrequentialEvaluation(make(), batches, compiled=False).run()
        require(got.curve == want.curve and got.metric == want.metric
                and same_state(got.extra["state"], want.extra["state"]),
                f"short last batch {what}: compiled differs from eager")
        log(f"short last batch ({what}, dense-200, 29 x 512 + 200 rows): "
            "compiled bit for bit the eager run")


def phase_ensembles(dev, smi):
    """OzaBag and OzaBoost (M = 10) and ShardingEnsemble; the main path is
    OzaBag with ADWIN at dense-1000."""
    import torch
    from repro_torch.core.pytree import tree_clone
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.vht import ShardingEnsemble

    t0 = time.perf_counter()
    oza_keys = ("correct", "seen", "drifts")
    shard_keys = ("correct", "seen", "dropped", "n_nodes")
    out = {}
    dense = {m: ensemble_stream(f"dense-{m}", ENS_BATCHES, dev)
             for m in (M_ATTRS, 200)}

    def oza(tc, **kw):
        ec = EnsembleConfig(tc, n_members=ENS_M, **kw)
        return lambda: OzaEnsemble(ec, device=dev)

    # the main path
    what = f"OzaBag adwin dense-{M_ATTRS}"
    make = oza(tree_config(M_ATTRS))
    res, count, us, us_c = run_ensemble(make, dense[M_ATTRS], oza_keys, what)
    steps = len(dense[M_ATTRS])
    per_step = {k: v / steps for k, v in count.items() if v}
    for name in ("tree_route", "vht_stats", "split_poisson"):
        require(count[name] > 0, f"{what}: {name} was not launched")
    require(count["tree_route"] == steps and count["split_poisson"] == steps,
            f"{what}: tree_route and split_poisson launch once a step, got "
            f"{count}")
    log(f"{what}: launches per step {per_step}")
    st = res.extra["state"]
    main = {"us_per_batch": us, "compiled_us_per_batch": us_c,
            "acc": res.metric, "launches": count,
            "launches_per_step": per_step,
            "n_nodes": st["trees"]["n_nodes"].tolist()}
    main["kernels"] = ensemble_kernels(st, dense[M_ATTRS][-1][0], smi)
    syncs = count_syncs(make(), tree_clone(st), dense[M_ATTRS][:20])
    prof = profile_steps(make(), tree_clone(st), dense[M_ATTRS][:30])
    graph = graph_profile(make, st, dense[M_ATTRS], what)
    compare_paths(what, (us, syncs, prof), (us_c, graph), smi)
    main.update(syncs_per_step=syncs, profile=prof, compiled=graph)
    out[what] = main

    covtype = ensemble_stream("covtype-54", ENS_BATCHES, dev)
    what = "OzaBoost adwin covtype-54"
    res, count, us, us_c = run_ensemble(
        oza(tree_config(54, n_classes=7), boost=True), covtype, oza_keys,
        what)
    out[what] = {"us_per_batch": us, "compiled_us_per_batch": us_c,
                 "acc": res.metric, "launches": count}

    switch = ensemble_stream("switch", ENS_DET_BATCHES, dev)
    for det, batches in (("ddm", switch),
                         ("eddm", dense[200][:ENS_DET_BATCHES]),
                         ("ph", dense[200][:ENS_DET_BATCHES])):
        what = (f"OzaBag {det} " + ("dense-200 concept switch" if det == "ddm"
                                     else "dense-200"))
        res, count, us, us_c = run_ensemble(oza(tree_config(200),
                                                detector=det),
                                            batches, oza_keys, what)
        drifts = float(stacked(res.extra["metrics"], "drifts").sum())
        if det == "ddm":
            require(drifts > 0, f"{what}: no drift fired")
        out[what] = {"us_per_batch": us, "compiled_us_per_batch": us_c,
                     "acc": res.metric, "drifts": drifts, "launches": count}

    for p, m, cell in ((4, M_ATTRS, "fig45"), (2, 200, "tab34")):
        what = f"ShardingEnsemble p={p} dense-{m} ({cell})"
        res, count, us, us_c = run_ensemble(
            lambda: ShardingEnsemble(tree_config(m), p, device=dev),
            dense[m], shard_keys, what)
        require(count["tree_route"] >= ENS_BATCHES,
                f"{what}: the vote did not route through tree_route")
        out[what] = {"us_per_batch": us, "compiled_us_per_batch": us_c,
                     "acc": res.metric, "launches": count}

    short_last_batch(dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    log(f"ensembles phase: {total:.1f} s on {smi}")
    out["phase_s"] = total
    return out


def rules_split(e, amr):
    """The AMRules main path's rule_stats device time per step, split
    between the moment statistics and the reductions of segment_sum
    (per-rule sums, then the batch sum's levels; one launch each per
    step): from the profile's kernel records of the path, and from the
    launch timings of the kernel phase on its random inputs."""
    steps = RULES_BATCHES
    n_stats = amr["launches"]["rule_stats"] / steps
    n_sums = amr["launches"]["segment_sum"] / steps
    require(n_stats == 1 and n_sums == len(e["sums"]),
            f"main path: {n_stats} statistics and {n_sums} reduction "
            f"launches per step, timed 1 and {len(e['sums'])}")
    prof = amr["profile"]["split"]
    split = {"profile": {"stats_us_per_step": prof["moment statistics"],
                         "sums_us_per_step": sum(
                             v for k, v in prof.items()
                             if k != "moment statistics")},
             "launch_timings": {"stats_us_per_step": 1e3 * e["ms"],
                                "sums_us_per_step": 1e3 * sum(
                                    v["ms"] for v in e["sums"].values())}}
    amr["rule_stats_split"] = split
    for src, v in split.items():
        log(f"amrules main path rule_stats device time per step ({src}): "
            f"moment statistics {v['stats_us_per_step']:.2f} us, reductions "
            f"{v['sums_us_per_step']:.2f} us")


def log_kernel(name, e):
    vs_library = ("" if e["library_ms"] is None else
                  f", kernel/library {e['ms'] / e['library_ms']:.2f}")
    log(f"{name}: device ms per launch: kernel {e['ms']:.5f}, plain "
        f"{e['plain_ms']:.5f}, library {e['library_ms']}, bound "
        f"{e['bound_ms']:.6f} ({e['bound_by']}), kernel/bound "
        f"{e['ms'] / e['bound_ms']:.1f}{vs_library}; ms per call from the "
        f"host: kernel "
        f"{e['call_ms']:.5f}, plain {e['plain_call_ms']:.5f}, library "
        f"{e.get('library_call_ms')}")


def blob_stream(d, n_batches, seed=0, n_blobs=8):
    """benchmarks/clustream_benchmarks.py's _blob_stream, drawn with numpy
    from the seed: [n_batches, B, d] float32 points 0.05 (normal) around
    8 centers uniform in [0, 1)^d, made on the host before the clock
    starts (the chunked stream stages them on the card chunk by chunk)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(n_blobs, d))
    c = rng.integers(0, n_blobs, (n_batches, B))
    x = centers[c] + 0.05 * rng.standard_normal((n_batches, B, d))
    return x.astype(np.float32)


def clustream_segments(state, x, cc):
    """Each instance's CF segment as ml/clustream.py's update takes it
    (K = discard)."""
    import torch
    from repro_torch.ml import clustream as cs
    d2 = cs.pairwise_d2(x, cs._centroids(state), cs._impl(cc))
    nearest = torch.argmin(d2, -1)
    ndist = cs.sqrt(torch.gather(d2, 1, nearest[:, None])[:, 0])
    rad = cs._radius(state)[nearest] * cc.radius_factor + 1e-6
    return torch.where(ndist <= rad, nearest, cc.n_micro).to(torch.int32)


def kernel_cf_scatter(state, x, cc, smi):
    """The wide segment_sum on the CF scatter's inputs at the end of the
    main path: [K + 1, 1, 1, 2d] from zeros, x | x^2 of the last batch by
    its segments.  Bit for bit its plain version; device ms beside its
    bound, the plain version's and index_add_'s (atomics' order: no
    replacement), and with the same rows all in one segment (one chain of
    B adds a column).  The 3-column launch (1 | t | t^2) is timed too."""
    import torch
    from repro_torch.kernels.rule_stats.ops import segment_sum
    from repro_torch.kernels.rule_stats.ref import rule_stats_scatter_ref
    K, d = cc.n_micro, cc.n_dims
    seg = clustream_segments(state, x, cc)
    xb = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
    t = state["t"] + torch.arange(1, B + 1, dtype=torch.float32,
                                  device=x.device)
    out = {}
    for what, vals in (("x|x^2", torch.cat([x, x * x], 1)),
                       ("1|t|t^2", torch.stack([torch.ones_like(t), t,
                                                t * t], 1))):
        C = vals.shape[1]
        zeros = torch.zeros((K + 1, 1, 1, C), device=x.device)
        got = segment_sum(zeros.clone(), seg, xb, vals)
        want = rule_stats_scatter_ref(zeros.clone(), seg, xb, vals)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"segment_sum CF scatter {what} differs from its plain "
                "version")
        work = zeros.clone()
        kt = timed(lambda: segment_sum(work, seg, xb, vals))
        pt = timed(lambda: rule_stats_scatter_ref(work, seg, xb, vals),
                   n=10, reps=3)
        scratch = torch.zeros((K + 1, C), device=x.device)
        idx = seg.long()
        lt = timed(lambda: scratch.index_add_(0, idx, vals))
        # the same rows all in one segment: one chain of B adds a column
        one = torch.full_like(seg, 5)
        got1 = segment_sum(zeros.clone(), one, xb, vals)
        want1 = rule_stats_scatter_ref(zeros.clone(), one, xb, vals)
        torch.cuda.synchronize()
        require(torch.equal(got1.view(torch.int32), want1.view(torch.int32)),
                f"segment_sum CF scatter {what}, one segment, differs from "
                "its plain version")
        ot = timed(lambda: segment_sum(work, one, xb, vals))
        # vals, seg and xbin read once, and a read and a write of each
        # segment's C sums that a row hits (the kernel writes no other);
        # one add a value
        hits = int(torch.unique(seg[(seg >= 0) & (seg <= K)]).numel())
        moved = vals.numel() * 4 + 2 * B * 4 + 2 * hits * C * 4
        ops = B * C
        bound_ms, bound_by = bound(moved, ops)
        e = {"shape": [K + 1, 1, 1, C], "B": B, "ms": kt["ms"],
             "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
             "plain_call_ms": pt["call_ms"], "library_ms": lt["ms"],
             "library_call_ms": lt["call_ms"], "bytes": moved, "ops": ops,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "max_abs_err": max_abs_err(got, want),
             "discarded": int((seg == K).sum()), "segments_hit": hits,
             "one_segment_ms": ot["ms"]}
        out[what] = e
        log(f"segment_sum CF scatter {what} [{K + 1},1,1,{C}] B={B} on the "
            f"main path's last batch ({e['discarded']} discarded, {hits} of "
            f"{K + 1} segments hit; bit for bit its plain version): device "
            f"ms {kt['ms']:.5f}, all rows in "
            f"one segment {ot['ms']:.5f}, plain {pt['ms']:.5f}, index_add_ "
            f"{lt['ms']:.5f}, bound {bound_ms:.6f} ({bound_by}, {moved} "
            f"bytes), kernel/bound {kt['ms'] / bound_ms:.1f}, call ms "
            f"{kt['call_ms']:.5f} on {smi}")
    return out


class XStep:
    """A CluStream step (or a captured one) called as step(state, x, y),
    the form count_syncs and profile_steps take."""

    def __init__(self, step):
        self._step = step

    def step(self, state, x, y=None):
        return self._step(state, x)


def run_clustream(arm, d, K, mode, n_chunks, dev, smi):
    """One CluStream arm and mode over n_chunks chunks of CS_CHUNK batches
    of the blob stream: eagerly with the kernels (LocalEngine's
    ChunkedStream loop, the launches counted), compiled
    (ChunkedPrequentialEvaluation on JitEngine, its default, each step a
    captured graph and the boundary hook one more), and eagerly with the
    plain versions: per-batch metrics and the final state bit for bit
    alike.  Returns (result, the eager run's states, launches)."""
    import torch
    from repro_torch.core.engines import LocalEngine
    from repro_torch.core.evaluation import (ChunkedPrequentialEvaluation,
                                             stack_outputs)
    from repro_torch.core.prng import PRNGKey
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.rule_stats.ops import segment_sum
    from repro_torch.ml.clustream import CluStream, CluStreamConfig

    cc = CluStreamConfig(n_dims=d, n_micro=K, n_macro=8, period=CS_PERIOD,
                         macro_impl=mode)
    xs = torch.from_numpy(blob_stream(d, n_chunks * CS_CHUNK))
    stream = ChunkedStream({"x": xs}, CS_CHUNK, device=dev)
    what = f"clustream {arm} {mode}"
    learner = CluStream(cc, device=dev)
    loc = LocalEngine()
    # the evaluation's key: PRNGKey(0), split over the topology's processors
    init = loc.init(learner, PRNGKey(0, dev))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    states, eager = loc.run_stream(learner, init, stream)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    count = launches()
    # the wide form's launches (the x | x^2 CF scatter), within segment_sum's
    count["segment_sum_wide"] = segment_sum.wide_launches
    eager = stack_outputs(eager)["metrics"]
    n_batches = n_chunks * CS_CHUNK
    chunks_seen = []
    res = ChunkedPrequentialEvaluation(
        CluStream(cc, device=dev), stream,
        on_chunk=lambda outs, chunk, carry: chunks_seen.append(
            outs["metrics"])).run()
    compiled = {k: torch.cat([m[k] for m in chunks_seen]) for k in eager}
    with plain_kernels():
        reset_launches()
        plain_states, plain = loc.run_stream(learner, init, stream)
        require(sum(launches().values()) == 0, "plain run launched a kernel")
    plain = stack_outputs(plain)["metrics"]
    for k in ("seen", "ssq", "n_active"):
        for other, name in ((compiled, "compiled"), (plain, "plain")):
            require(torch.equal(other[k].view(torch.int32),
                                eager[k].view(torch.int32)),
                    f"{what}: per-batch {k} of the {name} run differs from "
                    "the eager run's")
    require(same_state(res.extra["carry"]["states"], states),
            f"{what}: the compiled run's final state differs from the eager "
            "run's")
    require(same_state(plain_states, states),
            f"{what}: the plain run's final state differs from the eager "
            "run's")
    st = states["clustream"]
    require(count["segment_sum"] >= 2 * n_batches
            and count["segment_sum_wide"] == n_batches,
            f"{what}: the CF scatter did not launch segment_sum, its wide "
            f"form once a step ({count})")
    require(float(st["macro_t"]) > 0, f"{what}: the macro phase never ran")
    ssq = eager["ssq"].double()
    require(bool(torch.isfinite(ssq).all()) and bool((ssq >= 0).all()),
            f"{what}: ssq not finite and non-negative")
    mass = float(st["n"].sum()) / (n_batches * B)
    us_eager = 1e6 * eager_s / n_batches
    us_c = 1e6 * B / res.throughput
    log(f"{what} B={B} x {n_batches} ({n_chunks} chunks of {CS_CHUNK}): "
        f"{us_eager:.1f} us/batch eager, {us_c:.1f} compiled; last ssq/B "
        f"{float(ssq[-1]) / B:.5f}, active micro-clusters "
        f"{int(eager['n_active'][-1])}, CF mass {mass:.3f} of the instances, "
        f"macro_t {float(st['macro_t']):.0f}; "
        f"launches {count}; eager, compiled and plain bit for bit alike "
        f"on {smi}")
    return {"us_per_batch": us_eager, "compiled_us_per_batch": us_c,
            "launches": count, "last_ssq": float(ssq[-1]), "cf_mass": mass,
            "macro_t": float(st["macro_t"])}, states, stream, cc


def clustream_kill_resume(cc, stream, want_states, dev):
    """The compiled run through ChunkedPrequentialEvaluation with a
    checkpoint every CS_CHUNKS // 6 chunks (asynchronous writer), killed
    after the middle checkpoint (the later ones gone), resumed: the same
    final state as the eager run, bit for bit, back on the card."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
    from repro_torch.ml.clustream import CluStream

    ckpt = ROOT / "build" / "clustream_checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)
    every = max(1, stream.n_chunks // 6)
    t0 = time.perf_counter()
    full = ChunkedPrequentialEvaluation(
        CluStream(cc, device=dev), stream,
        checkpoint=CheckpointManager(ckpt, keep=0),
        checkpoint_every=every).run(resume=False)
    mgr = CheckpointManager(ckpt, keep=0)
    steps = mgr.all_steps()
    kill = steps[len(steps) // 2]
    for s in steps:
        if s > kill:
            shutil.rmtree(ckpt / f"step_{s:010d}")
    ev = ChunkedPrequentialEvaluation(CluStream(cc, device=dev), stream,
                                      checkpoint=mgr, checkpoint_every=every)
    got = ev.run(resume=True)
    require(ev.report["events"] == [("resume", kill)],
            f"kill/resume: resumed at {ev.report['events']}, not {kill}")
    require(got.curve == full.curve and got.extra["seen"] == full.extra["seen"],
            "kill/resume: the curve differs from the uninterrupted run's")
    require(same_state(got.extra["carry"]["states"], want_states),
            "kill/resume: the final state differs from the uninterrupted "
            "run's")
    require(got.extra["carry"]["states"]["clustream"]["n"].device.type
            == dev.type, "kill/resume: the carry did not come back to the "
            "card")
    total = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"clustream kill/resume ({cc.macro_impl}): checkpoints after chunks "
        f"{[s - 1 for s in steps]}, killed after chunk {kill - 1}, resumed "
        f"for {got.extra['chunks']} chunks: final state bit for bit the "
        f"uninterrupted run's ({total:.1f} s for both runs)")
    return {"checkpoints": steps, "resumed_at": kill,
            "resumed_chunks": got.extra["chunks"]}


def phase_clustream(dev, smi):
    """CluStream on the chunked runtime (paper section 5) at the widest arm
    of benchmarks/clustream_benchmarks.py, d128-K256 (the main path, step
    mode), and d32-K100: CluStreamConfig(n_macro=8, period=4096), B = 512,
    200 batches in chunks of 8 (4096 instances: the period is aligned, so
    boundary mode fires where step mode does).  Each arm in step and
    boundary mode, eager, compiled and plain bit for bit alike; boundary
    mode's final state equal to step mode's; a kill and resume on the
    main arm; the wide segment_sum on the main path's inputs; syncs per
    captured step, and the device busy share eager against compiled."""
    import torch
    from repro_torch.core.compiled import compile_step
    from repro_torch.core.pytree import tree_clone
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.ml.clustream import CluStream

    t0 = time.perf_counter()
    out = {}
    main = None
    for arm, d, K in (("d128-K256", 128, 256), ("d32-K100", 32, 100)):
        finals = {}
        for mode in ("step", "boundary"):
            e, states, stream, cc = run_clustream(arm, d, K, mode, CS_CHUNKS,
                                                  dev, smi)
            out[f"{arm} {mode}"] = e
            finals[mode] = states
            if arm == "d128-K256" and mode == "step":
                main = (e, states, stream, cc)
            if arm == "d128-K256" and mode == "boundary":
                out["kill_resume"] = clustream_kill_resume(cc, stream, states,
                                                           dev)
        require(same_state(finals["step"], finals["boundary"]),
                f"clustream {arm}: boundary mode's final state differs from "
                "step mode's (period aligned to the chunk)")
        log(f"clustream {arm}: boundary mode's final state bit for bit step "
            "mode's")

    e, states, stream, cc = main
    st = states["clustream"]
    it = iter(stream.starting_at(CS_CHUNKS - 1))
    chunk = next(it)
    it.close()
    xs = [chunk.payload["x"][i] for i in range(CS_CHUNK)]
    e["kernels"] = kernel_cf_scatter(st, xs[-1], cc, smi)
    learner = CluStream(cc, device=dev)
    syncs = count_syncs(XStep(learner.step), tree_clone(st),
                        [(x, None) for x in xs])
    prof = profile_steps(XStep(learner.step), tree_clone(st),
                         [(x, None) for x in xs * 4])
    reset_launches()
    captured = compile_step(learner.step, tree_clone(st), xs[0])
    at_capture = {k: v for k, v in launches().items() if v}
    state = tree_clone(st)
    with no_syncs():
        for x in xs:
            state, _ = captured(state, x)
    graph_syncs = count_syncs(XStep(captured), state, [(x, None) for x in xs])
    require(graph_syncs == 0, f"clustream compiled: {graph_syncs} syncs per "
            "replay")
    gprof = profile_steps(XStep(captured), state, [(x, None) for x in xs * 4])
    graph = {"syncs_per_step": graph_syncs, "profile": gprof,
             "wrapper_calls_at_capture": at_capture}
    compare_paths("clustream main path d128-K256 step",
                  (e["us_per_batch"], syncs, prof),
                  (e["compiled_us_per_batch"], graph), smi)
    e.update(syncs_per_step=syncs, profile=prof, compiled=graph)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t0
    log(f"clustream phase: {out['phase_s']:.1f} s on {smi}")
    return out


# ------------------------------------------------------------ serve phase

# the JAX serving benchmark's configuration (benchmarks/serving_benchmarks.py:
# max_batch 16, max_wait_ms 2, queue_limit 128, deadline_ms 250, staleness
# limit 8 chunks), played open-loop at SERVE_RATE requests/s
SERVE_CFG = {"max_batch": 16, "max_wait_ms": 2.0, "queue_limit": 128,
             "deadline_ms": 250.0}
SERVE_STALENESS, SERVE_RATE = 8, 250.0
# train while serving trains over the main path's 25 chunks again and again
# for SERVE_CHUNKS chunks (4000 batches: seconds a turn, over a thousand
# requests at SERVE_RATE); the turn that checkpoints, and the rollback
# checks, save every CKPT_EVERY chunks
SERVE_CHUNKS, CKPT_EVERY = 500, 5
# the requests a served turn may shed or refuse as overloaded: none, so a
# stall that holds a request past its deadline or fills the queue fails
SERVE_LOST = 0
# the train-while-serving turns, in this order: (driver, server, checkpoint)
SERVE_TURNS = (("sync", False, False), ("pipelined", False, False),
               ("pipelined", True, False), ("sync", True, False),
               ("pipelined", True, True))
# what VHT's predict reads of a snapshot
PREDICT = ("split_attr", "split_bin", "children", "class_counts")


def dense_batches(dev, n_batches, seed):
    """The main path's dense-1000 batches drawn on the card from ``seed``,
    stacked: (x [n, B, 1000] int32, y [n, B])."""
    from repro_torch.data.generators import RandomTreeGenerator
    from repro_torch.data.pipeline import StreamPipeline
    gen = RandomTreeGenerator(n_cat=M_ATTRS // 2, n_num=M_ATTRS // 2,
                              depth=8, device=dev)
    return StreamPipeline(gen, batch=B, n_batches=n_batches, n_bins=BINS,
                          seed=seed, device=dev).materialize()


def serve_stream(x, y, dev):
    """The main path's batches (x, y: [MAIN_BATCHES, B, ...] on the card)
    as a ChunkedStream of SERVE_CHUNKS chunks of CS_CHUNK: chunk i is the
    main path's chunk i mod CS_CHUNKS."""
    from repro_torch.data.pipeline import ChunkedStream

    def fetch(i):
        at = i % CS_CHUNKS * CS_CHUNK
        return {"x": x[at:at + CS_CHUNK], "y": y[at:at + CS_CHUNK]}
    return ChunkedStream.from_fn(fetch, SERVE_CHUNKS, CS_CHUNK, device=dev)


def request_rows(dev):
    """2048 rows of the same generator from another seed, on the host: one
    request each."""
    x, _ = dense_batches(dev, 4, 1)
    return x.reshape(-1, M_ATTRS).cpu().numpy()


def evaluation(learner, stream, engine=None, **kw):
    """ChunkedPrequentialEvaluation on the learner, on ``engine`` when one
    is given: an engine that ran the learner before holds its captured
    steps, so the run captures nothing."""
    from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
    ev = ChunkedPrequentialEvaluation(learner, stream, **kw)
    if engine is not None:
        ev.engine = engine
    return ev


def same_run(a, b, what):
    """Two evaluation results alike: metric, curve and the final carry, bit
    for bit."""
    require(a.metric == b.metric and a.curve == b.curve,
            f"{what}: the metric or curve differs")
    require(same_state(a.extra["carry"]["states"], b.extra["carry"]["states"]),
            f"{what}: the final carry differs")


def busy_run(run):
    """run() under torch.profiler: (its result, device busy µs over the
    run's wall µs); the trace must hold device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    require(busy > 0, "profiler trace shows no device time")
    names = " ".join(e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    return res, busy / wall_us, names


def drivers(what, learner, stream, engine, smi):
    """The pipelined and the synchronous driver on the learner, on the
    engine (the first run captures its steps), in turns: pipelined, sync,
    sync, pipelined, for the µs per batch (the mean of each driver's two),
    then once each under the profiler for the device busy share.  Every run
    bit for bit alike.  Returns (a pipelined result, numbers, the profile's
    kernel names)."""
    out = {"pipelined": {"us_per_batch_runs": []},
           "sync": {"us_per_batch_runs": []}}
    first = None
    for name in ("pipelined", "sync", "sync", "pipelined"):
        r = evaluation(learner, stream, engine,
                       pipeline=name == "pipelined").run()
        first = first or r
        same_run(r, first, f"{what} {name}: against the first run")
        out[name]["us_per_batch_runs"].append(1e6 * B / r.throughput)
    names = ""
    for name in ("pipelined", "sync"):
        r, share, names = busy_run(lambda: evaluation(
            learner, stream, engine, pipeline=name == "pipelined").run())
        same_run(r, first, f"{what} {name} profiled: against the first run")
        runs = out[name]["us_per_batch_runs"]
        out[name].update(us_per_batch=sum(runs) / len(runs),
                         busy_share=share)
    log(f"{what} ({stream.n_chunks} chunks of {CS_CHUNK}), pipelined "
        f"against synchronous driver (in turns P S S P): "
        f"{out['pipelined']['us_per_batch_runs']} against "
        f"{out['sync']['us_per_batch_runs']} us/batch, device busy "
        f"{100 * out['pipelined']['busy_share']:.1f} against "
        f"{100 * out['sync']['busy_share']:.1f} % of the wall (profiled "
        f"runs); metric, curve and final carry bit for bit alike on {smi}")
    return first, out, names


class HostClock:
    """Host seconds spent in wrapped calls, by name (wall time: time that
    another thread holds the interpreter lock counts), the longest call of
    each, and, as a ``gc.callbacks`` entry, the garbage collector's pauses
    by generation; with the process's CPU seconds per wall second between
    ``start()`` and ``summary()``."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.longest = collections.Counter()
        self.pauses: list = []
        self._start = None
        self._host = None

    def wrap(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                self.seconds[name] += dt
                self.calls[name] += 1
                self.longest[name] = max(self.longest[name], dt)
        return timed

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.pauses.append((info["generation"],
                                1e3 * (time.perf_counter() - self._start)))
            self._start = None

    def start(self):
        self._host = (time.perf_counter(), time.process_time())

    def summary(self):
        wall = time.perf_counter() - self._host[0]
        cpu = time.process_time() - self._host[1]
        full = [ms for gen, ms in self.pauses if gen == 2]
        return {"ms_per_call": {k: 1e3 * v / self.calls[k]
                                for k, v in self.seconds.items()},
                "max_ms": {k: 1e3 * v for k, v in self.longest.items()},
                "gc_pauses": len(self.pauses),
                "gc_ms": sum(ms for _, ms in self.pauses),
                "gc_max_ms": max((ms for _, ms in self.pauses), default=0.0),
                "gc_full": len(full), "gc_full_max_ms": max(full, default=0.0),
                "cpu_per_wall": cpu / wall}


def serve_requests(srv, rows, until, rate=SERVE_RATE):
    """Open loop: one request every 1/rate s (late ones at once) from the
    calling thread until ``until()``; returns the requests."""
    reqs, t0 = [], time.perf_counter()
    while not until():
        target = t0 + len(reqs) / rate
        now = time.perf_counter()
        if now < target:
            time.sleep(min(target - now, 0.005))
            continue
        reqs.append(srv.submit(rows[len(reqs) % len(rows)]))
    return reqs


def served_checks(srv, reqs, snaps, learner, count):
    """A served turn's books and answers: every request answered or
    accounted for, at most SERVE_LOST shed or refused as overloaded, none
    unavailable, answers from at least two snapshot versions, every tenth
    answer equal to reference_predict on the version it names.  Returns the
    turn's serving numbers."""
    import torch
    from repro_torch.serving import reference_predict
    srv.stop(drain=True)
    for r in reqs:
        r.result(timeout=30)
    st = srv.status()
    require(st["accounting_ok"] and st["pending"] == 0
            and st["submitted"] == len(reqs) == st["answered"]
            + st["shed"] + st["rejected_overloaded"]
            + st["rejected_unavailable"],
            f"train while serving: the books do not balance: {st}")
    lost = st["shed"] + st["rejected_overloaded"]
    require(lost <= SERVE_LOST and st["rejected_unavailable"] == 0,
            f"train while serving: {st['shed']} requests shed, "
            f"{st['rejected_overloaded']} overloaded and "
            f"{st['rejected_unavailable']} unavailable of {len(reqs)} (at "
            f"most {SERVE_LOST} shed or overloaded): a stall")
    answered = [r for r in reqs if r.status == "answered"]
    versions = sorted({r.meta["snapshot_version"] for r in answered})
    require(len(versions) >= 2, "train while serving: the answers came "
            f"from snapshot versions {versions}")
    for r in answered[::10]:
        tree = snaps[r.meta["snapshot_version"]]
        want = reference_predict(learner, tree,
                                 torch.from_numpy(r.x[None].copy()))
        require(int(r.pred) == int(want[0]),
                "train while serving: an answer differs from "
                "reference_predict on the snapshot it names")
    require(count["tree_route"] >= st["batches"] and count["vht_stats"],
            f"train while serving: launches {count}, {st['batches']} "
            "served batches")
    lat = sorted(r.meta["latency_ms"] for r in answered)
    stale = [r.meta["staleness_chunks"] for r in answered]
    return {"requests": len(reqs), "answered": len(answered),
            "shed": st["shed"], "overloaded": st["rejected_overloaded"],
            "batches": st["batches"], "versions": len(versions),
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "latency_max_ms": lat[-1],
            "staleness_mean": sum(stale) / len(stale),
            "staleness_max": max(stale),
            "tree_route_per_request": st["batches"] / len(answered),
            "checked": len(answered[::10])}


def train_while_serving(learner, stream, engine, rows, smi):
    """SERVE_TURNS: the run over ``stream`` (SERVE_CHUNKS chunks) on a
    worker thread, published at every chunk, on either driver, with a
    checkpoint every CKPT_EVERY chunks or none, and with a ModelServer
    (SERVE_CFG) that the main thread plays requests at from the start, or
    without (the same run, no requests).  The server's first snapshot is
    the untrained model; each served turn passes ``served_checks``.

    Before each turn the garbage collector freezes what the process holds
    (``gc.freeze``), as a long-running server does after its start-up: a
    full collection walks every object it tracks while it holds the
    interpreter lock, and on the heap that the smoke's earlier phases
    leave it stops the server long enough to shed requests.  One full
    collection is timed before the first freeze and one after it.  Each
    turn records its µs per batch, the host ms of a chunk's dispatch, of a
    publish and of a checkpoint save (mean and longest), the median and
    the longest gap between two chunks' ends, the collector's pauses and
    the process's CPU seconds per wall second: what a stall shows in."""
    import concurrent.futures
    import gc
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import (ModelServer, ServeConfig,
                                     SnapshotPublisher)

    ckpt = ROOT / "build" / "serve_checkpoints"
    runs, served = [], None
    heap = {"objects": len(gc.get_objects())}
    for when in ("before", "after"):
        t0 = time.perf_counter()
        gc.collect()
        heap[f"full_collection_ms_{when}_freeze"] = \
            1e3 * (time.perf_counter() - t0)
        gc.freeze()
    for driver, serve, with_ckpt in SERVE_TURNS:
        gc.collect()
        gc.freeze()
        shutil.rmtree(ckpt, ignore_errors=True)
        pub = SnapshotPublisher(max_staleness_chunks=SERVE_STALENESS)
        snaps, ends = {}, []

        def keep(outs, chunk, carry, pub=pub, snaps=snaps, ends=ends):
            # the tree of each version on the host (a snapshot kept alive on
            # the card would make every publish allocate anew), and the time
            # the chunk's host work ended
            snap = pub.current()
            snaps[snap.version] = {k: snap.state[k].cpu() for k in PREDICT}
            ends.append(time.perf_counter())

        require(pub.publish(-1, learner.init()), "the first snapshot")
        keep(None, None, None)
        cm = CheckpointManager(ckpt, keep=2) if with_ckpt else None
        ev = evaluation(learner, stream, engine, publisher=pub, on_chunk=keep,
                        checkpoint=cm, checkpoint_every=CKPT_EVERY,
                        pipeline=driver == "pipelined")
        srv = ModelServer(learner, pub, ServeConfig(**SERVE_CFG)) \
            if serve else None
        # the host time of the chunks' dispatch, the publishes and the
        # checkpoint saves, through instance attributes dropped after
        clock = HostClock()
        engine.run_stream_chunked = clock.wrap("chunk_dispatch",
                                               engine.run_stream_chunked)
        pub.publish = clock.wrap("publish", pub.publish)
        if cm is not None:
            cm.save = clock.wrap("checkpoint_save", cm.save)
        torch.cuda.synchronize()
        reset_launches()
        gc.callbacks.append(clock)
        clock.start()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(ev.run, resume=False)
            reqs = (serve_requests(srv, rows, fut.done) if serve else [])
            res = fut.result()
        gc.callbacks.remove(clock)
        del engine.run_stream_chunked
        count = launches()
        gaps = [b - a for a, b in zip(ends[1:], ends[2:])]
        run = {"driver": driver, "server": serve,
               "checkpoint_every": CKPT_EVERY if with_ckpt else None,
               "us_per_batch": 1e6 * B / res.throughput,
               "published": pub.published,
               "chunk_gap_max_ms": 1e3 * max(gaps),
               "chunk_gap_median_ms": 1e3 * statistics.median(gaps),
               **clock.summary()}
        if serve:
            run.update(served_checks(srv, reqs, snaps, learner, count))
            if served is None:
                served = (run, pub.current().state)
        runs.append(run)
        ckpt_says = (f"a checkpoint every {CKPT_EVERY} chunks" if with_ckpt
                     else "no checkpoint")
        log(f"train while serving, {driver} driver, "
            f"{'with' if serve else 'without'} the server, {ckpt_says}: "
            f"{run['us_per_batch']:.1f} us/batch; host ms per call "
            f"{run['ms_per_call']}, longest {run['max_ms']}; gap between "
            f"chunk ends median {run['chunk_gap_median_ms']:.2f} ms, longest "
            f"{run['chunk_gap_max_ms']:.2f}; {run['gc_pauses']} collector "
            f"pauses, {run['gc_ms']:.1f} ms, the longest "
            f"{run['gc_max_ms']:.2f}, {run['gc_full']} full; CPU s per wall "
            f"s {run['cpu_per_wall']:.2f}"
            + (f"; {run['requests']} requests, {run['answered']} answered "
               f"from {run['versions']} snapshot versions, shed "
               f"{run['shed']}, overloaded {run['overloaded']}; latency p50 "
               f"{run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f}, max "
               f"{run['latency_max_ms']:.3f}; staleness mean "
               f"{run['staleness_mean']:.2f}, max {run['staleness_max']}; "
               f"{run['batches']} served batches" if serve else ""))
    gc.unfreeze()
    shutil.rmtree(ckpt, ignore_errors=True)
    run, state = served
    copy = timed(lambda: {k: v.detach().clone() for k, v in state.items()},
                 n=20, reps=3)
    log(f"train while serving (VHT dense-1000 wok, {SERVE_CHUNKS} chunks of "
        f"{CS_CHUNK}, the main path's {CS_CHUNKS} again and again, published "
        f"every chunk; server {SERVE_CFG}, {SERVE_RATE:.0f} requests/s open "
        f"loop): every request answered, sampled answers equal "
        f"reference_predict on their snapshot; a publish's copy "
        f"{copy['ms']:.4f} device ms; the collector: a full collection of "
        f"the {heap['objects']} objects the process held "
        f"{heap['full_collection_ms_before_freeze']:.1f} ms, "
        f"{heap['full_collection_ms_after_freeze']:.2f} ms once they were "
        f"frozen, on {smi}")
    return {"runs": runs, "publish_copy_ms": copy["ms"], "heap": heap,
            "tree_route_per_request": run["tree_route_per_request"]}, state


def poison_and_resume(learner, stream, engine, clean, smi):
    """On the pipelined driver: a NaN in the carry after chunk 5, retried
    from the checkpoint before it, ends as the clean run; skipped, the
    chunk is recorded and its batches are missing; a run killed after chunk
    12 and resumed ends as the clean run."""
    import concurrent.futures
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import FaultInjector, SimulatedKill

    ckpt = ROOT / "build" / "serve_checkpoints"
    out = {}
    for policy in ("retry", "skip"):
        shutil.rmtree(ckpt, ignore_errors=True)
        ev = evaluation(learner, stream, engine,
                        checkpoint=CheckpointManager(ckpt, keep=0),
                        checkpoint_every=CKPT_EVERY,
                        injector=FaultInjector(poison_at_chunk=5),
                        poison_policy=policy)
        r = ev.run(resume=False)
        rep = ev.report
        require(rep["events"][:1] == [("poison", 5, policy, 5)]
                and rep["rollbacks"] == 1,
                f"poison {policy}: report {rep['events']}")
        if policy == "retry":
            same_run(r, clean, "poison at chunk 5, retried")
        else:
            require(rep["skipped_chunks"] == [5] and r.extra["seen"]
                    == clean.extra["seen"] - CS_CHUNK * B,
                    f"poison skipped: {rep['skipped_chunks']}, seen "
                    f"{r.extra['seen']}")
        out[policy] = {"events": [list(e) for e in rep["events"]]}
    shutil.rmtree(ckpt, ignore_errors=True)
    killed = evaluation(learner, stream, engine,
                        checkpoint=CheckpointManager(ckpt, keep=0),
                        checkpoint_every=CKPT_EVERY,
                        injector=FaultInjector(kill_at_chunk=12))
    # the run dies on a worker, whose future holds the SimulatedKill
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        death = pool.submit(killed.run, resume=False).exception()
    require(isinstance(death, SimulatedKill),
            f"the kill at chunk 12 did not fire: {death!r}")
    killed.checkpoint.wait()
    ev = evaluation(learner, stream, engine,
                    checkpoint=CheckpointManager(ckpt, keep=0),
                    checkpoint_every=CKPT_EVERY)
    r = ev.run(resume=True)
    require(ev.report["events"] == [("resume", 10)],
            f"kill/resume: {ev.report['events']}")
    same_run(r, clean, "killed after chunk 12 and resumed")
    shutil.rmtree(ckpt, ignore_errors=True)
    out["kill_resume"] = {"resumed_at": 10}
    log(f"pipelined poison at chunk 5: retried, bit for bit the clean run; "
        f"skipped, chunk 5 recorded and its {CS_CHUNK * B} instances "
        f"missing; killed after chunk 12, resumed from the checkpoint before "
        f"chunk 10, bit for bit the clean run on {smi}")
    return out


def parity_streams(dev):
    """The four families at their smoke widths, 4 chunks of CS_CHUNK
    batches each: (learner, chunk payloads, the metric to hold the answer
    against)."""
    import torch
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml.amrules import RulesConfig, VAMR
    from repro_torch.ml.clustream import CluStream, CluStreamConfig
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.vht import VHT, VHTConfig
    n = 4 * CS_CHUNK
    dense = stream(M_ATTRS, n, dev)
    xy = {"x": torch.stack([x for x, _ in dense]),
          "y": torch.stack([y for _, y in dense])}
    m, rules = rules_stream("waveform", n, dev)
    rxy = {"x": torch.stack([x for x, _ in rules]),
           "y": torch.stack([y for _, y in rules])}
    blobs = {"x": torch.from_numpy(blob_stream(128, n)).to(dev)}
    cc = CluStreamConfig(n_dims=128, n_micro=256, n_macro=8,
                         period=CS_PERIOD)
    return {
        "VHT dense-1000 wok": (VHT(VHTConfig(tree_config(
            M_ATTRS, split_delay=4)), device=dev), xy, "correct"),
        "OzaBag adwin dense-1000": (OzaEnsemble(EnsembleConfig(
            tree_config(M_ATTRS), n_members=ENS_M), device=dev), xy,
            "correct"),
        "VAMR waveform-40": (VAMR(RulesConfig(n_attrs=m, n_bins=BINS,
                                              max_rules=RULES, n_min=200),
                                  device=dev), rxy, "abs_err"),
        "CluStream d128-K256": (CluStream(cc, device=dev), blobs, "ssq")}


def serve_train_parity(dev, smi):
    """For each family: a snapshot published at chunk boundary 2 answers
    chunk 3's first batch as the training step predicted it (correct,
    abs_err rtol 1e-5 or ssq rtol 1e-5), and the fast path (the kernels)
    equals reference_predict (the plain versions) bit for bit."""
    import torch
    from repro_torch.core.engines import JitEngine
    from repro_torch.core.prng import PRNGKey
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml.clustream import pairwise_d2
    from repro_torch.serving import (SnapshotPublisher, make_predict_fn,
                                     model_state_of, reference_predict)
    out, states = {}, {}
    for what, (learner, payload, metric) in parity_streams(dev).items():
        eng = JitEngine()
        carry = eng.init(learner, PRNGKey(0, dev))
        carries, outs = [], []
        for chunk in ChunkedStream(payload, CS_CHUNK, device=dev):
            carry, o = eng.run_stream_chunked(learner, carry, [chunk])
            carries.append(carry)
            outs.append(o["metrics"])
        k = 2
        pub = SnapshotPublisher()
        require(pub.publish(k, model_state_of(carries[k])),
                f"{what}: the snapshot was rejected")
        state = pub.current().state
        x = payload["x"][(k + 1) * CS_CHUNK]
        pred = make_predict_fn(learner)(state, x)
        want = reference_predict(learner, state, x)
        require(torch.equal(pred, want), f"{what}: the kernel predict differs "
                "from the plain predict")
        got = float(outs[k + 1][metric][0])
        if metric == "correct":
            y = payload["y"][(k + 1) * CS_CHUNK]
            ours = float((pred == y).sum())
            require(ours == got, f"{what}: {ours} correct, the step {got}")
        elif metric == "abs_err":
            y = payload["y"][(k + 1) * CS_CHUNK]
            ours = float((y - pred).abs().double().sum())
            require(abs(ours - got) <= 1e-5 * abs(got),
                    f"{what}: abs_err {ours}, the step's {got}")
        else:
            ours = float(pairwise_d2(x, state["macro"]).amin(-1).double()
                         .sum())
            require(abs(ours - got) <= 1e-5 * abs(got),
                    f"{what}: ssq {ours}, the step's {got}")
        out[what] = {metric: got, "served": ours}
        states[what] = state
    log(f"serve/train parity at boundary 2 (chunk 3's first batch): "
        f"{json.dumps(out)}; kernel predict bit for bit the plain predict, "
        f"in all four families on {smi}")
    return out, states


def tree_route_at_serve_shape(what, tables, rows, dev, smi):
    """tree_route at the server's batch (max_batch rows) on ``tables``
    ([M, N], [M, N], [M, N, 2]) against its plain version, timed (device
    ms, CUDA events), beside its bound."""
    import torch
    from repro_torch.kernels.tree_route.ops import tree_route
    from repro_torch.kernels.tree_route.ref import tree_route_ref
    nb = SERVE_CFG["max_batch"]
    xb = torch.from_numpy(rows[:nb].copy()).to(dev)
    M = tables[0].shape[0]
    got = tree_route(*tables, xb, max_depth=DEPTH)
    want = tree_route_ref(*tables, xb, DEPTH)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"tree_route {what} differs from its "
            "plain version")
    steps = route_steps(*tables, xb, DEPTH)
    moved = tables[0].numel() * 16 + steps * 4 + M * nb * 4
    bound_ms, bound_by = bound(moved, steps)
    kt = timed(lambda: tree_route(*tables, xb, max_depth=DEPTH))
    pt = timed(lambda: tree_route_ref(*tables, xb, DEPTH))
    e = {"M": M, "B": nb, "ms": kt["ms"], "call_ms": kt["call_ms"],
         "plain_ms": pt["ms"], "plain_call_ms": pt["call_ms"],
         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
         "ops": steps, "library_ms": None}
    log(f"tree_route at the server's shape, {what} (M={M}, B={nb}; exact): "
        f"device ms {kt['ms']:.5f}, plain {pt['ms']:.5f}, bound "
        f"{bound_ms:.3g} ({bound_by}), kernel/bound {kt['ms'] / bound_ms:.0f}"
        f", call ms {kt['call_ms']:.5f} on {smi}")
    return e


def capture_while_serving(learner, engine, rows, dev, smi):
    """A run whose last chunk holds one short batch (200 of 512 rows): its
    step is captured anew, mid-run, while a server answers requests; the
    run raises nothing, and its per-batch metrics and final state equal
    the eager run's (LocalEngine's ChunkedStream loop)."""
    import concurrent.futures
    import torch
    from repro_torch.core.engines import LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.serving import ModelServer, ServeConfig, SnapshotPublisher

    x, y = dense_batches(dev, 2 * CS_CHUNK + 1, 2)
    parts = [{"x": x[i:i + CS_CHUNK], "y": y[i:i + CS_CHUNK]}
             for i in (0, CS_CHUNK)]
    parts.append({"x": x[-1:, :200].contiguous(),
                  "y": y[-1:, :200].contiguous()})
    short = ChunkedStream.from_fn(lambda i: parts[i], 3, CS_CHUNK, device=dev)
    pub = SnapshotPublisher()
    require(pub.publish(-1, learner.init()), "the first snapshot")
    srv = ModelServer(learner, pub, ServeConfig(**SERVE_CFG))
    seen = []
    ev = evaluation(learner, short, engine, publisher=pub,
                    on_chunk=lambda outs, chunk, carry: seen.append(
                        outs["metrics"]))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ev.run, resume=False)
        reqs = serve_requests(srv, rows, fut.done)
        res = fut.result()
    srv.stop(drain=True)
    for r in reqs:
        r.result(timeout=30)
    require(srv.status()["accounting_ok"] and srv.status()["pending"] == 0,
            "capture while serving: the books do not balance")
    loc = LocalEngine()
    states, eager = loc.run_stream(learner, loc.init(learner), short)
    eager = stack_outputs(eager)["metrics"]
    for key in ("correct", "seen", "dropped", "n_nodes"):
        got = torch.cat([m[key] for m in seen])
        require(torch.equal(got.view(torch.int32),
                            eager[key].view(torch.int32)),
                f"capture while serving: per-batch {key} differs from eager")
    require(same_state(res.extra["carry"]["states"], states),
            "capture while serving: the final state differs from eager")
    answered = sum(r.status == "answered" for r in reqs)
    log(f"capture while serving: 2 chunks of {CS_CHUNK} x {B} rows and a "
        f"last chunk of one 200-row batch, its graph captured mid-run while "
        f"the server answered {answered} of {len(reqs)} requests; per-batch "
        f"metrics and final state bit for bit the eager run on {smi}")
    return {"requests": len(reqs), "answered": answered}


def phase_serve(dev, smi):
    """The pipelined driver against the synchronous one on VHT dense-1000
    and CluStream d128-K256, train while serving (``train_while_serving``),
    poison/rollback and kill/resume on the pipelined driver,
    serve/train parity in four families, tree_route at the server's
    shapes, and a capture while the server answers."""
    import torch
    from repro_torch.core.engines import JitEngine
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.ml.clustream import CluStream, CluStreamConfig
    from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
    from repro_torch.ml.vht import VHT, VHTConfig
    from repro_torch.serving import ModelServer, ServeConfig, SnapshotPublisher

    t0 = time.perf_counter()
    out = {}
    learner = VHT(VHTConfig(tree_config(M_ATTRS, split_delay=4)), device=dev)
    engine = JitEngine()
    x, y = dense_batches(dev, MAIN_BATCHES, 0)
    chunks = ChunkedStream({"x": x, "y": y}, CS_CHUNK, device=dev)
    rows = request_rows(dev)
    # the drivers first: the pipelined run captures the steps on the engine
    clean, out["vht_drivers"], names = drivers(
        "VHT dense-1000 wok", learner, chunks, engine, smi)
    for name in VHT_KERNELS:
        require(name in names, f"the pipelined VHT run's trace has no {name}")
    cc = CluStreamConfig(n_dims=128, n_micro=256, n_macro=8,
                         period=CS_PERIOD)
    cs_stream = ChunkedStream({"x": torch.from_numpy(blob_stream(
        128, CS_CHUNKS * CS_CHUNK))}, CS_CHUNK, device=dev)
    _, out["clustream_drivers"], _ = drivers(
        "CluStream d128-K256 step", CluStream(cc, device=dev), cs_stream,
        JitEngine(), smi)
    tws, learned = train_while_serving(learner, serve_stream(x, y, dev),
                                       engine, rows, smi)
    out["train_while_serving"] = tws
    out["rollback"] = poison_and_resume(learner, chunks, engine, clean, smi)
    out["parity"], states = serve_train_parity(dev, smi)
    out["tree_route_m1"] = tree_route_at_serve_shape(
        "M = 1 on the learned dense-1000 tree",
        tuple(learned[k][None] for k in PREDICT[:3]), rows, dev, smi)
    out["tree_route_m1"]["launches_per_request"] = \
        tws["tree_route_per_request"]
    trees = states["OzaBag adwin dense-1000"]["trees"]
    out["tree_route_m10"] = tree_route_at_serve_shape(
        "M = 10 on OzaBag's learned trees",
        (trees["split_attr"], trees["split_bin"], trees["children"]), rows,
        dev, smi)
    # OzaBag served: 64 requests in 4 full batches, one launch each
    pub = SnapshotPublisher()
    require(pub.publish(2, states["OzaBag adwin dense-1000"]),
            "the OzaBag snapshot was rejected")
    srv = ModelServer(OzaEnsemble(EnsembleConfig(tree_config(M_ATTRS),
                                                 n_members=ENS_M), device=dev),
                      pub, ServeConfig(**{**SERVE_CFG, "deadline_ms": 6e4}),
                      start=False)
    reqs = [srv.submit(r) for r in rows[:64]]
    reset_launches()
    while srv.poll():
        pass
    count = launches()["tree_route"]
    require(all(r.status == "answered" for r in reqs) and count == 4,
            f"OzaBag served: {count} tree_route launches for 64 requests")
    out["tree_route_m10"]["launches_per_request"] = count / len(reqs)
    out["capture_while_serving"] = capture_while_serving(learner, engine,
                                                         rows, dev, smi)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve phase: {out['phase_s']:.1f} s on {smi}")
    return out


# ------------------------------------------------------------ fleet phase

# benchmarks/fleet_benchmarks.py's fleet.vht-f1000 arm in its full mode
# (its TreeConfig at :46-48, the arm at :77-85): FLEET_F tenants of VHT,
# FLEET_T steps of FLEET_B instances a tenant in chunks of FLEET_CHUNK,
# a checkpoint after every chunk; and FLEET_F tenants of CluStream
# d32-K100 (benchmarks/clustream_benchmarks.py:75) at the same batch and
# length, step and boundary mode, the period aligned to the chunk so the
# macro phase fires.  Launches per step are counted again at FLEET_SMALL
# tenants; FLEET_ALONE tenants spread over the fleet also run alone.
FLEET_F, FLEET_SMALL, FLEET_ALONE = 1000, 100, 16
FLEET_T, FLEET_B, FLEET_CHUNK, FLEET_BINS = 8, 16, 2, 4
FLEET_PERIOD = FLEET_CHUNK * FLEET_B


def fleet_tree_config():
    from repro_torch.ml.htree import TreeConfig
    return TreeConfig(n_attrs=8, n_bins=FLEET_BINS, n_classes=2,
                      max_nodes=31, n_min=16, delta=0.05, tau=0.1)


def fleet_vht_payload(dev):
    """[T, F, B, 8] binned attributes and [T, F, B] labels of
    RandomTreeGenerator(n_cat=4, n_num=4, depth=4, seed=3), the JAX
    benchmark's generator, drawn on the card in one pass (seed 11): each
    tenant's rows are draws of their own."""
    import torch
    from repro_torch.data.generators import RandomTreeGenerator, bin_numeric
    gen = RandomTreeGenerator(n_cat=4, n_num=4, depth=4, seed=3, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    x, y = gen.sample(g, FLEET_T * FLEET_F * FLEET_B)
    return {"x": bin_numeric(x, FLEET_BINS).reshape(
                FLEET_T, FLEET_F, FLEET_B, 8),
            "y": y.reshape(FLEET_T, FLEET_F, FLEET_B)}


def fleet_blob_payload(d, seed=0, n_blobs=8):
    """The blob stream of benchmarks/clustream_benchmarks.py per tenant,
    drawn with numpy from the seed: [T, F, B, d] float32 points 0.05
    (normal) around 8 centers of the tenant's own, uniform in [0, 1)^d."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(FLEET_F, n_blobs, d))
    c = rng.integers(0, n_blobs, (FLEET_T, FLEET_F, FLEET_B))
    x = (centers[np.arange(FLEET_F)[None, :, None], c]
         + 0.05 * rng.standard_normal((FLEET_T, FLEET_F, FLEET_B, d)))
    return {"x": torch.from_numpy(x.astype(np.float32))}


def fleet_route_steps(sa, sb, ch, xbin, tree, max_depth):
    """Inner nodes passed by each row of xbin [R, m] through tree[r] of
    the tables: the xbin reads and table entries routing needs."""
    import torch
    node = torch.zeros_like(tree)
    steps = torch.zeros_like(tree)
    rows = torch.arange(xbin.shape[0], device=xbin.device)
    for _ in range(max_depth):
        attr = sa[tree, node].long()
        inner = attr >= 0
        v = xbin[rows, attr.clamp(min=0)]
        nxt = ch[tree, node, (v > sb[tree, node]).long()].long()
        node = torch.where(inner, nxt, node)
        steps += inner.long()
    return int(steps.sum())


def fleet_launches_per_step(count, n_steps):
    return {k: v / n_steps for k, v in sorted(count.items()) if v}


def run_fleet(what, fleet, payload, dev, smi, checkpoint=False):
    """One fleet over the payload's T steps in chunks of FLEET_CHUNK:
    eagerly with the kernels (LocalEngine's chunked loop, launches
    counted, the counts set to 0 just before), compiled (the chunked
    evaluation on JitEngine, its captured steps; timed on a second run),
    and eagerly with the plain versions.  The eager and the plain runs'
    per-step metric columns and final state bit for bit alike, and the
    compiled run's.  With ``checkpoint`` the compiled run saves after
    every chunk, and a run killed after its first chunk and resumed must
    end as it did.  Returns (numbers, the eager run's fleet state and
    metrics)."""
    import numpy as np
    import torch
    from repro_torch.core.engines import JitEngine, LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.core.prng import PRNGKey
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.kernels import launches, reset_launches

    on_card = payload["x"].is_cuda
    stream = (ChunkedStream(payload, FLEET_CHUNK, to_device=False) if on_card
              else ChunkedStream(payload, FLEET_CHUNK, device=dev))
    F = fleet.n_tenants
    n_inst = FLEET_T * F * FLEET_B
    loc = LocalEngine()
    init = loc.init(fleet, PRNGKey(0, dev))
    torch.cuda.synchronize()
    reset_launches()
    states, eager = loc.run_stream(fleet, init, stream)
    torch.cuda.synchronize()
    count = {k: v for k, v in launches().items() if v}
    # timed again, warm: the first run also pays the allocator's first
    # blocks at the fleet's sizes
    t0 = time.perf_counter()
    again, _ = loc.run_stream(fleet, init, stream)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    require(same_state(again, states), f"{what}: a second eager run "
            "differs from the first")
    eager = stack_outputs(eager)["metrics"]
    state = states["learnerfleet"]
    out = {"F": F, "launches": count,
           "launches_per_step": fleet_launches_per_step(count, FLEET_T),
           "eager_us_per_step": 1e6 * eager_s / FLEET_T}

    # compiled: a first run captures the steps, the second is timed
    eng = JitEngine()
    chunks = []
    first = evaluation(fleet, stream, engine=eng, on_chunk=lambda o, c, k:
                       chunks.append(o["metrics"])).run()
    compiled = {k: torch.cat([m[k] for m in chunks]) for k in eager}
    for k in eager:
        require(same_state(compiled[k], eager[k]),
                f"{what}: the compiled run's {k} columns differ from the "
                "eager run's")
    require(same_state(first.extra["carry"]["states"], states),
            f"{what}: the compiled run's final state differs from the "
            "eager run's")
    timed_run = evaluation(fleet, stream, engine=eng).run()
    us_c = 1e6 * F * FLEET_B / timed_run.throughput
    out.update(compiled_us_per_step=us_c,
               instances_per_s=timed_run.throughput,
               eager_instances_per_s=n_inst / eager_s)
    require(np.array_equal(np.asarray(timed_run.metric),
                           np.asarray(first.metric)),
            f"{what}: a second compiled run's metric columns differ")

    with plain_kernels():
        reset_launches()
        plain_states, plain = loc.run_stream(fleet, init, stream)
        require(sum(launches().values()) == 0,
                f"{what}: the plain run launched a kernel")
    plain = stack_outputs(plain)["metrics"]
    for k in eager:
        require(same_state(plain[k], eager[k]),
                f"{what}: the plain run's {k} columns differ from the eager "
                "run's")
    require(same_state(plain_states, states),
            f"{what}: the plain run's final state differs from the eager "
            "run's")
    require(torch.equal(state["cursor"].cpu(),
                        torch.full((F,), FLEET_T, dtype=torch.int32)),
            f"{what}: cursors {state['cursor']}")
    if checkpoint:
        out["kill_resume"] = fleet_kill_resume(what, fleet, stream, eng,
                                               first)
    out["profile"] = fleet_profile(what, fleet, state, payload, dev)
    log(f"{what}: F={F} x {FLEET_T} steps of {FLEET_B} ({FLEET_T // FLEET_CHUNK}"
        f" chunks of {FLEET_CHUNK}): {out['eager_us_per_step']:.1f} us per "
        f"fleet step eager, {us_c:.1f} compiled ({timed_run.throughput:.0f} "
        f"instances/s compiled, {n_inst / eager_s:.0f} eager); launches per "
        f"step {out['launches_per_step']}; eager, compiled and plain bit for "
        f"bit alike on {smi}")
    return out, state, eager


def fleet_profile(what, fleet, state, payload, dev):
    """The fleet's step captured on the final state and replayed over the
    payload's T batches twice under torch.profiler: device busy µs per
    step, the busy share and the kernels' device µs (``profile_steps``),
    the numbers the host clock's spread between runs does not move."""
    from repro_torch.core.compiled import compile_step
    from repro_torch.core.pytree import tree_clone
    batches = [(payload["x"][t].to(dev),
                payload["y"][t].to(dev) if "y" in payload else None)
               for t in range(FLEET_T)]
    args = [a for a in batches[0] if a is not None]
    captured = compile_step(fleet.step, tree_clone(state), *args)
    stepper = XStep(captured) if "y" not in payload else types.SimpleNamespace(
        step=captured)
    log(f"{what}: the captured fleet step replayed:")
    return profile_steps(stepper, tree_clone(state), batches * 2)


def fleet_kill_resume(what, fleet, stream, eng, want):
    """The compiled run with a checkpoint after every chunk, killed after
    its first chunk (the later checkpoints gone) and resumed: metric
    columns, curve and final carry bit for bit the uninterrupted run's."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    ckpt = ROOT / "build" / "fleet_checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    full = evaluation(fleet, stream, engine=eng,
                      checkpoint=CheckpointManager(ckpt, keep=0),
                      checkpoint_every=1).run(resume=False)
    mgr = CheckpointManager(ckpt, keep=0)
    steps = mgr.all_steps()
    for s in steps:
        if s > 1:
            shutil.rmtree(ckpt / f"step_{s:010d}")
    ev = evaluation(fleet, stream, engine=eng, checkpoint=mgr,
                    checkpoint_every=1)
    got = ev.run(resume=True)
    total = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    require(ev.report["events"] == [("resume", 1)],
            f"{what} kill/resume: resumed at {ev.report['events']}")
    for r, name in ((full, "the checkpointed run"), (got, "the resumed run")):
        require(np.array_equal(np.asarray(r.metric), np.asarray(want.metric))
                and np.array_equal(np.asarray(r.curve),
                                   np.asarray(want.curve)),
                f"{what} kill/resume: {name}'s metric columns differ")
        require(same_state(r.extra["carry"]["states"],
                           want.extra["carry"]["states"]),
                f"{what} kill/resume: {name}'s final carry differs")
    log(f"{what} kill/resume: checkpoints after chunks "
        f"{[s - 1 for s in steps]}, killed after chunk 0, resumed for "
        f"{got.extra['chunks']} chunks: metric columns, curve and carry bit "
        f"for bit ({total:.1f} s for both runs)")
    return {"checkpoints": steps, "resumed_chunks": got.extra["chunks"],
            "s": total}


def fleet_alone(what, fleet, payload, state, metrics, dev, exact):
    """FLEET_ALONE tenants spread over the fleet, each its learner alone
    on its own stream from its own init: its row and metric columns equal
    (``exact``: bit for bit; else CluStream's, whose distances come from
    float32 products, batched over the tenants in the fleet and single
    alone, which round otherwise: CF leaves, seen and n_active bit for
    bit, macro centroids rtol 1e-6, and each batch's ssq within the
    rounding bound of its expanded distances |x|^2 + |c|^2 - 2 x.c, d eps
    sum_i 2 |x_i|^2 (eps = 2^-24), since near a centroid the expansion
    cancels and its rounding dominates the small distance).  For
    CluStream a planted fault must fail that bound in every tenant: each
    batch's ssq from step 4 on against the macro centroids two steps
    stale (one macro phase behind, and past the initial centroids), from
    the learner stepped alone again."""
    import torch
    from repro_torch.core.engines import LocalEngine
    from repro_torch.core.evaluation import stack_outputs
    from repro_torch.core.prng import PRNGKey, split
    from repro_torch.data.pipeline import ChunkedStream
    from repro_torch.ml.clustream import ssq
    learner = fleet.learner
    keys = fleet.tenant_keys(split(PRNGKey(0, dev), 1)[0])
    loc = LocalEngine()
    name = next(iter(loc.init(learner, PRNGKey(0, dev))))
    tenants = [round(i * (fleet.n_tenants - 1) / (FLEET_ALONE - 1))
               for i in range(FLEET_ALONE)]
    worst = worst_of_bound = 0.0
    fault_of_bound = []
    for f in tenants:
        one = {k: v[:, f] for k, v in payload.items()}
        stream = (ChunkedStream(one, FLEET_CHUNK, to_device=False)
                  if one["x"].is_cuda else
                  ChunkedStream(one, FLEET_CHUNK, device=dev))
        alone, m = loc.run_stream(learner, {name: learner.init(keys[f])},
                                  stream)
        m = stack_outputs(m)["metrics"]
        row = fleet.tenant_state(state, f)
        if exact:
            require(same_state(row, alone[name]),
                    f"{what}: tenant {f}'s row differs from its learner "
                    "alone")
            for k in m:
                require(same_state(metrics[k][:, f].contiguous(), m[k]),
                        f"{what}: tenant {f}'s {k} column differs")
            continue
        for k in ("n", "ls", "ss", "lt", "st", "t", "macro_t"):
            require(same_state(row[k], alone[name][k]),
                    f"{what}: tenant {f}'s {k} differs from its learner "
                    "alone")
        torch.testing.assert_close(row["macro"], alone[name]["macro"],
                                   rtol=1e-6, atol=1e-6)
        xs = one["x"].to(dev)
        tol = (xs.shape[-1] * 2.0 ** -24 * 2
               * torch.square(xs.double()).sum((-1, -2)))
        want = m["ssq"].double()
        gap = (metrics["ssq"][:, f].double() - want).abs()
        require(bool((gap <= tol).all()),
                f"{what}: tenant {f}'s ssq column differs by {gap.tolist()}"
                f" beyond the rounding bound {tol.tolist()}")
        worst = max(worst, float((gap / want.abs()).max()))
        worst_of_bound = max(worst_of_bound, float((gap / tol).max()))
        # the planted fault: the macro centroids each step's ssq used,
        # from the learner stepped alone, taken two steps late; from step
        # 4 on, so that the stale centroids are learned ones, not init's
        st, used = learner.init(keys[f]), []
        boundary = getattr(learner, "boundary", None)
        for t in range(FLEET_T):
            st, _ = learner.step(st, xs[t])
            used.append(st["macro"])
            if boundary is not None and (t + 1) % FLEET_CHUNK == 0:
                st = boundary(st)
        stale = torch.stack([ssq(used[t - 2], xs[t])
                             for t in range(4, FLEET_T)]).double()
        fault = float(((stale - want[4:]).abs() / tol[4:]).max())
        require(fault > 1.0,
                f"{what}: tenant {f}'s ssq against stale macro centroids "
                f"stays within the rounding bound ({fault:.3g} of it): the "
                "bound cannot tell a stale macro")
        fault_of_bound.append(fault)
        for k in ("seen", "n_active"):
            require(torch.equal(metrics[k][:, f], m[k]),
                    f"{what}: tenant {f}'s {k} column differs")
    if exact:
        log(f"{what}: tenants {tenants} each equal their learner alone bit "
            "for bit")
        return {"tenants": tenants}
    log(f"{what}: tenants {tenants} each equal their learner alone (CF "
        f"leaves bit for bit, macro rtol 1e-6, ssq within its rounding "
        f"bound); largest ssq gap {worst:.3g} relative, {worst_of_bound:.3g}"
        f" of the bound; a stale-macro ssq reaches {min(fault_of_bound):.3g}"
        f" to {max(fault_of_bound):.3g} times the bound")
    return {"tenants": tenants, "ssq_rel_gap": worst,
            "ssq_gap_of_bound": worst_of_bound,
            "stale_macro_gap_of_bound": {"min": min(fault_of_bound),
                                         "max": max(fault_of_bound)}}


def fleet_kernel_entry(what, kt, pt, moved, ops, lt=None, **extra):
    bound_ms, bound_by = bound(moved, ops)
    e = {"ms": kt["ms"], "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
         "plain_call_ms": pt["call_ms"],
         "library_ms": None if lt is None else lt["ms"],
         "library_call_ms": None if lt is None else lt["call_ms"],
         "bytes": moved, "ops": ops, "bound_ms": bound_ms,
         "bound_by": bound_by, "max_abs_err": 0.0, **extra}
    log_kernel(what, e)
    return e


def fleet_route_kernels(state, payload, rows, tenants, dev, smi):
    """The two fleet forms of tree_route against their plain versions on
    random trees and batches at the fleet's shape and on the path's
    inputs (the learned trees; the last step's batches; the served rows),
    exact, timed beside their bounds."""
    import numpy as np
    import torch
    from repro_torch.kernels.tree_route.ops import (tree_route_batched,
                                                    tree_route_rows)
    from repro_torch.kernels.tree_route.ref import (tree_route_batched_ref,
                                                    tree_route_rows_ref)
    tc = fleet_tree_config()
    F, N, m, D = FLEET_F, tc.max_nodes, tc.n_attrs, tc.max_depth
    rng = np.random.RandomState(7)
    rand = [torch.from_numpy(a).to(dev)
            for a in random_trees(F, N, m, FLEET_BINS, 7)]
    rand_x = torch.from_numpy(rng.randint(0, FLEET_BINS, (F, FLEET_B, m))
                              .astype(np.int32)).to(dev)
    rand_t = torch.from_numpy(rng.randint(0, F, 16).astype(np.int32)).to(dev)
    learned = [state["tenant"][k] for k in ("split_attr", "split_bin",
                                            "children")]
    xb = payload["x"][FLEET_T - 1].contiguous()
    for tables, x, name in ((rand, rand_x, "random"), (learned, xb, "path")):
        require(torch.equal(tree_route_batched(*tables, x, max_depth=D),
                            tree_route_batched_ref(*tables, x, D)),
                f"tree_route_batched ({name}) differs from its plain version")
    for tables, x, t, name in ((rand, rand_x[0], rand_t, "random"),
                               (learned, rows, tenants, "served rows")):
        require(torch.equal(tree_route_rows(*tables, x, t, max_depth=D),
                            tree_route_rows_ref(*tables, x, t, D)),
                f"tree_route_rows ({name}) differs from its plain version")
    out = {}
    flat = xb.reshape(F * FLEET_B, m)
    tree = torch.arange(F, device=dev).repeat_interleave(FLEET_B)
    steps = fleet_route_steps(*learned, flat, tree, D)
    # the tables read (4 ints a node), the xbin reads, the leaves written
    moved = F * N * 16 + steps * 4 + F * FLEET_B * 4
    out["tree_route_batched"] = fleet_kernel_entry(
        "tree_route_batched", timed(lambda: tree_route_batched(
            *learned, xb, max_depth=D)),
        timed(lambda: tree_route_batched_ref(*learned, xb, D), n=10, reps=3),
        moved, steps, M=F, B=FLEET_B, N=N)
    steps = fleet_route_steps(*learned, rows, tenants.long(), D)
    # each row's path: split attribute, bin and child of every inner node
    # it passes, the leaf's attribute, its xbin reads; member and leaf
    moved = steps * (12 + 4) + rows.shape[0] * (4 + 4 + 4)
    out["tree_route_rows"] = fleet_kernel_entry(
        "tree_route_rows", timed(lambda: tree_route_rows(
            *learned, rows, tenants, max_depth=D)),
        timed(lambda: tree_route_rows_ref(*learned, rows, tenants, D), n=10,
              reps=3),
        moved, steps, R=rows.shape[0], M=F, N=N)
    log(f"tree_route fleet forms on {smi}: exact on random trees and on the "
        "path's inputs")
    return out


def fleet_vht_stats(state, payload, dev, smi):
    """vht_stats with the tenant axis folded into its leaf axis, as the
    VHT fleet step launches it: stats [F * N, 8, 4, 2] and the last step's
    F * B rows routed through the learned trees; exact against its plain
    version, timed; its block count, 8 attributes / ja."""
    import torch
    from repro_torch.kernels.tree_route.ops import tree_route_batched
    from repro_torch.kernels.vht_stats.ops import stats_update, tile_plan
    from repro_torch.kernels.vht_stats.ref import stats_update_ref
    tc = fleet_tree_config()
    F, N, m, nb, Cc = FLEET_F, tc.max_nodes, tc.n_attrs, FLEET_BINS, 2
    tables = [state["tenant"][k] for k in ("split_attr", "split_bin",
                                           "children")]
    xb = payload["x"][FLEET_T - 1].contiguous()
    leaf = tree_route_batched(*tables, xb, max_depth=tc.max_depth)
    leaf = (leaf + torch.arange(F, dtype=torch.int32, device=dev)[:, None]
            * N).reshape(-1)
    Bf = F * FLEET_B
    x = xb.reshape(Bf, m)
    y = payload["y"][FLEET_T - 1].reshape(-1).contiguous()
    w = torch.ones(Bf, device=dev)
    stats = state["tenant"]["stats"].reshape(F * N, m, nb, Cc).clone()
    got = stats_update(stats.clone(), leaf, x, y, w)
    want = stats_update_ref(stats.clone(), leaf, x, y, w)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "vht_stats folded differs from its plain "
            "version")
    ja, group, smem = tile_plan(F * N, Bf, nb, Cc)
    jj = torch.arange(m, device=dev)
    flat = (((leaf.long()[:, None] * m + jj) * nb + x.long()) * Cc
            + y.long()[:, None]).reshape(-1)
    vals = w[:, None].expand(Bf, m).reshape(-1).contiguous()
    cells = int(torch.unique(flat).numel())
    work = stats.clone()
    e = fleet_kernel_entry(
        "vht_stats folded", timed(lambda: stats_update(work, leaf, x, y, w)),
        timed(lambda: stats_update_ref(work, leaf, x, y, w), n=10, reps=3),
        Bf * 12 + Bf * m * 4 + cells * 8, Bf * m,
        timed(lambda: work.view(-1).index_put_((flat,), vals,
                                               accumulate=True)),
        shape=[F * N, m, nb, Cc], rows=Bf, ja=ja, group=group, smem=smem,
        blocks=m // ja, leaves_hit=int(torch.unique(leaf).numel()))
    log(f"vht_stats folded [{F * N},{m},{nb},{Cc}] B={Bf}: exact; {m // ja} "
        f"blocks (ja {ja}, {group} leaves a pass, {smem} bytes of shared "
        f"memory), {e['leaves_hit']} leaves hit, on {smi}")
    return e


def fleet_segment_sum(state, payload, cc, dev, smi):
    """segment_sum's tenant form on the CF scatter x | x^2 of the fleet's
    last batch ([F, K + 1, 2d], B a tenant), and on random rows at that
    shape, exact against its plain version; timed beside its bound, the
    plain version and index_add_ on the folded segment ids (the same
    sums in the order of its atomics)."""
    import torch
    from repro_torch.kernels.rule_stats.ops import segment_sum_tenant
    from repro_torch.kernels.rule_stats.ref import segment_sum_tenant_ref
    from repro_torch.ml import clustream as cs
    F, K, d = FLEET_F, cc.n_micro, cc.n_dims
    S = K + 1
    st = state["tenant"]
    x = payload["x"][FLEET_T - 1].to(dev)
    d2 = cs.pairwise_d2(x, cs._centroids(st))
    nearest = torch.argmin(d2, -1)
    ndist = cs.sqrt(torch.gather(d2, -1, nearest[..., None])[..., 0])
    rad = torch.gather(cs._radius(st), -1, nearest) * cc.radius_factor + 1e-6
    seg = torch.where(ndist <= rad, nearest, K).to(torch.int32).reshape(-1)
    vals = torch.cat([x, x * x], -1).reshape(F * FLEET_B, 2 * d)
    g = torch.Generator(device=dev).manual_seed(3)
    rand_seg = torch.randint(-1, S + 1, (F * FLEET_B,), generator=g,
                             device=dev, dtype=torch.int32)
    rand_vals = torch.randn((F * FLEET_B, 2 * d), generator=g, device=dev)
    zeros = torch.zeros((F, S, 2 * d), device=dev)
    for sg, v, name in ((rand_seg, rand_vals, "random"),
                        (seg, vals, "path")):
        got = segment_sum_tenant(zeros.clone(), sg, v)
        want = segment_sum_tenant_ref(zeros.clone(), sg, v)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"segment_sum_tenant ({name}) differs from its plain version")
    work = zeros.clone()
    folded = (seg.long().view(F, FLEET_B)
              + torch.arange(F, device=dev)[:, None] * S).reshape(-1)
    scratch = torch.zeros((F * S, 2 * d), device=dev)
    # the rows and their segment ids read once, and a read and a write of
    # each (tenant, segment) row of sums that a row hits
    hits = int(torch.unique(folded).numel())
    moved = vals.numel() * 4 + seg.numel() * 4 + 2 * hits * 2 * d * 4
    e = fleet_kernel_entry(
        "segment_sum_tenant", timed(lambda: segment_sum_tenant(work, seg,
                                                               vals)),
        timed(lambda: segment_sum_tenant_ref(work, seg, vals), n=10, reps=3),
        moved, F * FLEET_B * 2 * d,
        timed(lambda: scratch.index_add_(0, folded, vals)),
        shape=[F, S, 2 * d], B=FLEET_B, discarded=int((seg == K).sum()),
        segments_hit=hits)
    log(f"segment_sum_tenant CF scatter [{F},{S},{2 * d}] B={FLEET_B} a "
        f"tenant ({e['discarded']} of {F * FLEET_B} rows discarded, {hits} "
        f"of {F * S} segments hit): exact on random rows and on the path's "
        f"last batch, on {smi}")
    return e


def fleet_serving(fleet, state, payload, dev, smi):
    """The VHT fleet's predict at the server's batch of 16 rows of 16
    tenants (one tree_route_rows launch, the counts set to 0 just before)
    against reference_predict, and a ModelServer over the fleet answering
    64 requests of mixed tenants in 4 full batches by tenant."""
    import numpy as np
    import torch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import (ModelServer, ServeConfig,
                                     SnapshotPublisher, make_predict_fn,
                                     reference_predict)
    nb = SERVE_CFG["max_batch"]
    x = payload["x"][FLEET_T - 1]
    tenants = torch.arange(0, FLEET_F, FLEET_F // nb, dtype=torch.int32,
                           device=dev)[:nb]
    rows = x[tenants.long(), 0].contiguous()
    fn = make_predict_fn(fleet)
    torch.cuda.synchronize()
    reset_launches()
    got = fn(state, rows, tenants)
    torch.cuda.synchronize()
    count = {k: v for k, v in launches().items() if v}
    require(count == {"tree_route_rows": 1},
            f"fleet predict at the server's batch launched {count}")
    want = reference_predict(fleet, state, rows, tenant=tenants)
    require(torch.equal(got, want), "fleet predict differs from "
            "reference_predict")
    pub = SnapshotPublisher()
    require(pub.publish(FLEET_T // FLEET_CHUNK - 1, state),
            "the fleet snapshot was rejected")
    srv = ModelServer(fleet, pub, ServeConfig(**{**SERVE_CFG,
                                                 "deadline_ms": 6e4}),
                      start=False)
    rng = np.random.RandomState(5)
    req_t = rng.randint(0, FLEET_F, 64)
    req_x = x[torch.from_numpy(req_t).to(dev),
              torch.from_numpy(rng.randint(0, FLEET_B, 64)).to(dev)]
    host_x = req_x.cpu().numpy()
    reqs = [srv.submit(host_x[i], tenant=int(req_t[i])) for i in range(64)]
    reset_launches()
    t0 = time.perf_counter()
    while srv.poll():
        pass
    served_s = time.perf_counter() - t0
    served = launches()["tree_route_rows"]
    want = reference_predict(fleet, state, req_x, tenant=req_t.tolist())
    require(all(r.status == "answered" for r in reqs) and served == 4,
            f"fleet server: {served} tree_route_rows launches for 64 "
            "requests")
    require([int(r.pred) for r in reqs] == want.cpu().tolist(),
            "fleet server: an answer differs from its tenant's model")
    require([r.meta["tenant"] for r in reqs] == req_t.tolist(),
            "fleet server: meta['tenant'] does not name the tenant")
    require(srv.status()["accounting_ok"], "fleet server accounting")
    log(f"fleet serving: predict at {nb} rows of {nb} tenants one "
        f"tree_route_rows launch, equal to reference_predict; a ModelServer "
        f"answered 64 requests of {len(set(req_t.tolist()))} tenants in "
        f"{served} batches ({1e3 * served_s / served:.3f} ms a batch from "
        f"the host), each from its tenant's model, on {smi}")
    return {"launches": served, "requests": 64,
            "ms_per_batch": 1e3 * served_s / served}, rows, tenants


def phase_fleet(dev, smi):
    """Multi-tenant learner fleets (src/repro_torch/ml/fleet.py) at the
    JAX benchmark's fleet.vht-f1000 arm and a fleet of CluStream d32-K100:
    each fleet eager, compiled and plain bit for bit alike; FLEET_ALONE
    tenants each equal to their learner alone; kill/resume; launches per
    step the same at FLEET_SMALL and FLEET_F tenants; the VHT fleet's
    predict and a ModelServer by tenant; each fleet form of a kernel
    against its plain version, timed."""
    import torch
    from repro_torch.ml import (CluStream, CluStreamConfig, LearnerFleet,
                                VHT, VHTConfig)

    t0 = time.perf_counter()
    out = {}
    payload = fleet_vht_payload(dev)
    small = {k: v[:, :FLEET_SMALL].contiguous() for k, v in payload.items()}
    vht = VHT(VHTConfig(fleet_tree_config()), device=dev)
    fleet = LearnerFleet(vht, FLEET_F)
    e, state, metrics = run_fleet(f"fleet VHT f{FLEET_F}", fleet, payload, dev,
                                  smi, checkpoint=True)
    acc = metrics["correct"].sum(0) / metrics["seen"].sum(0)
    e["accuracy"] = {"mean": float(acc.mean()), "min": float(acc.min()),
                     "max": float(acc.max())}
    e["n_nodes_mean"] = float(state["tenant"]["n_nodes"].float().mean())
    require(int(state["tenant"]["n_splits"].sum()) > 0,
            "fleet VHT: no tenant's tree split")
    e["alone"] = fleet_alone(f"fleet VHT f{FLEET_F}", fleet, payload, state,
                             metrics, dev, exact=True)
    e_small, _, _ = run_fleet(f"fleet VHT f{FLEET_SMALL}",
                              LearnerFleet(vht, FLEET_SMALL), small, dev,
                              smi)
    require(e_small["launches_per_step"] == e["launches_per_step"],
            f"fleet VHT: launches per step {e['launches_per_step']} at "
            f"F={FLEET_F}, {e_small['launches_per_step']} at F={FLEET_SMALL}")
    e["launches_per_step_small"] = e_small["launches_per_step"]
    e["small_us_per_step"] = {"eager": e_small["eager_us_per_step"],
                              "compiled": e_small["compiled_us_per_step"]}
    out["vht"] = e
    serve, rows, tenants = fleet_serving(fleet, state, payload, dev, smi)
    out["serve"] = serve
    out["kernels"] = fleet_route_kernels(state, payload, rows, tenants, dev,
                                         smi)
    out["kernels"]["vht_stats_folded"] = fleet_vht_stats(state, payload, dev,
                                                         smi)
    log(f"fleet VHT f{FLEET_F}: accuracy mean {e['accuracy']['mean']:.4f} (min "
        f"{e['accuracy']['min']:.4f}, max {e['accuracy']['max']:.4f}), "
        f"{e['n_nodes_mean']:.2f} nodes a tree; launches per step at "
        f"F={FLEET_F} {e['launches_per_step']}, at F={FLEET_SMALL} "
        f"{e_small['launches_per_step']}")

    blobs = fleet_blob_payload(32)
    small = {k: v[:, :FLEET_SMALL].contiguous() for k, v in blobs.items()}
    for mode in ("step", "boundary"):
        cc = CluStreamConfig(n_dims=32, n_micro=100, n_macro=8,
                             period=FLEET_PERIOD, macro_impl=mode)
        cs = CluStream(cc, device=dev)
        what = f"fleet CluStream d32-K100 {mode}"
        fleet = LearnerFleet(cs, FLEET_F)
        e, state, metrics = run_fleet(what, fleet, blobs, dev, smi,
                                      checkpoint=mode == "boundary")
        require(float(state["tenant"]["macro_t"].min()) > 0,
                f"{what}: the macro phase never ran")
        ssq = metrics["ssq"].double()
        require(bool(torch.isfinite(ssq).all()) and bool((ssq >= 0).all()),
                f"{what}: ssq not finite and non-negative")
        e["last_ssq_per_instance"] = float(ssq[-1].mean()) / FLEET_B
        e["alone"] = fleet_alone(what, fleet, blobs, state, metrics, dev,
                                 exact=False)
        e_small, _, _ = run_fleet(f"{what} f{FLEET_SMALL}",
                                  LearnerFleet(cs, FLEET_SMALL), small, dev,
                                  smi)
        require(e_small["launches_per_step"] == e["launches_per_step"],
                f"{what}: launches per step {e['launches_per_step']} at "
                f"F={FLEET_F}, {e_small['launches_per_step']} at "
                f"F={FLEET_SMALL}")
        e["launches_per_step_small"] = e_small["launches_per_step"]
        e["small_us_per_step"] = {"eager": e_small["eager_us_per_step"],
                                  "compiled": e_small["compiled_us_per_step"]}
        out[f"clustream {mode}"] = e
        if mode == "step":
            out["kernels"]["segment_sum_tenant"] = fleet_segment_sum(
                state, blobs, cc, dev, smi)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t0
    log(f"fleet phase: {out['phase_s']:.1f} s on {smi}")
    return out


def kernel_selective_scan(dev):
    """selective_scan at falcon_mamba_7b's prefill shape (B = 4, S = 2048,
    dI = 8192, N = 16, float32; tests/test_kernels.py's input scales)
    against its plain version, within 2e-4 of the values' range
    (tests/test_kernels.py's atol), and two halves with the state carried
    against the whole."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    Bs, S, dI, N = LM_B, LM_S, 8192, 16
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    args = (F.softplus(r(Bs, S, dI)) * 0.1, r(Bs, S, dI), r(Bs, S, N) * 0.5,
            r(Bs, S, N) * 0.5, -torch.exp(r(dI, N) * 0.3), r(Bs, dI, N) * 0.1)
    dt, x, Bm, Cm, A, h0 = args
    y, hT = selective_scan(*args)
    y_ref, h_ref = selective_scan_ref(*args)
    torch.cuda.synchronize()
    tol = 2e-4 * max(1.0, float(y_ref.abs().max()), float(h_ref.abs().max()))
    err = max(max_abs_err(y, y_ref), max_abs_err(hT, h_ref))
    require(err <= tol, f"selective_scan max abs err {err} > {tol}")
    half = S // 2
    y1, h1 = selective_scan(dt[:, :half], x[:, :half], Bm[:, :half],
                            Cm[:, :half], A, h0)
    y2, h2 = selective_scan(dt[:, half:], x[:, half:], Bm[:, half:],
                            Cm[:, half:], A, h1)
    chain = max(max_abs_err(torch.cat([y1, y2], 1), y), max_abs_err(h2, hT))
    require(chain <= tol, f"selective_scan two halves differ by {chain}")
    log(f"selective_scan [{Bs},{S},{dI}] N={N} f32: max abs err {err:.3g} "
        f"(tol {tol:.3g}); two halves chained vs the whole {chain:.3g}")
    # dt, x, y [B,S,dI] + Bm, Cm [B,S,N] + A + h0, hT, float32; per (b, t,
    # channel): dt*x, and per state n: dt*A, exp, *h, +, *B, *C, + (7)
    moved = 4 * (3 * Bs * S * dI + 2 * Bs * S * N + dI * N + 2 * Bs * dI * N)
    ops = Bs * S * dI * (7 * N + 1)
    bound_ms, bound_by = bound(moved, ops)
    kt = timed(lambda: selective_scan(*args))
    pt = timed(lambda: selective_scan_ref(*args), n=3, reps=3)
    e = {"ms": kt["ms"], "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
         "plain_call_ms": pt["call_ms"], "library_ms": None, "bytes": moved,
         "ops": ops, "bound_ms": bound_ms, "bound_by": bound_by,
         "max_abs_err": err, "chain_err": chain}
    log_kernel("selective_scan", e)
    return e


def kernel_flash_attention(dev):
    """flash_attention at qwen15_4b's prefill shape (B = 4, S = T = 2048,
    H = K = 20, hd = 128, bf16, causal) and in each other mode against its
    plain version, atol 2e-2 (bf16, tests/test_kernels.py); timed beside
    F.scaled_dot_product_attention on the same tensors (a yardstick only:
    the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16

    def qkv(Bq, S, T, H, K, hd):
        return [torch.randn((Bq, n, h, hd), generator=g, device=dev).to(bf16)
                for n, h in ((S, H), (T, K), (T, K))]

    cases = {"qwen15_4b causal": ((LM_B, LM_S, LM_S, 20, 20, 128), True, 0),
             "GQA 8/2": ((2, 512, 512, 8, 2, 128), True, 0),
             "MQA 8/1": ((2, 512, 512, 8, 1, 128), True, 0),
             "window 128": ((LM_B, LM_S, LM_S, 20, 20, 128), True, 128),
             "non-causal": ((2, 512, 512, 20, 20, 128), False, 0),
             "ragged S = T = 1000": ((LM_B, 1000, 1000, 20, 20, 128), True, 0)}
    errs = {}
    for what, (shape, causal, window) in cases.items():
        q, k, v = qkv(*shape)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        errs[what] = max_abs_err(got, want)
        require(errs[what] <= 2e-2,
                f"flash_attention {what} max abs err {errs[what]}")
        log(f"flash_attention {what} {list(shape)} bf16: max abs err "
            f"{errs[what]:.3g} (atol 2e-2)")
    Bq, S, H, hd = LM_B, LM_S, 20, 128
    q, k, v = qkv(Bq, S, S, H, H, hd)
    qt, kt_, vt = (t.transpose(1, 2) for t in (q, k, v))
    moved = 4 * Bq * S * H * hd * 2                  # q, k, v, o in bf16
    ops = 4 * Bq * H * hd * (S * (S + 1) // 2)       # two products, causal
    bound_ms, bound_by = bound(moved, ops, rate=BF16_OPS_PER_S)
    kt = timed(lambda: flash_attention(q, k, v, causal=True))
    pt = timed(lambda: flash_attention_ref(q, k, v, causal=True), n=5,
               reps=3)
    lt = timed(lambda: F.scaled_dot_product_attention(qt, kt_, vt,
                                                      is_causal=True))
    e = {"ms": kt["ms"], "call_ms": kt["call_ms"], "plain_ms": pt["ms"],
         "plain_call_ms": pt["call_ms"], "library_ms": lt["ms"],
         "library_call_ms": lt["call_ms"],
         "bytes": moved, "ops": ops, "bound_ms": bound_ms,
         "bound_by": bound_by, "max_abs_err": errs["qwen15_4b causal"],
         "case_errs": errs}
    log_kernel("flash_attention", e)
    return e


def profile_calls(fn, n):
    """Wall and device-busy ms per call of fn over n calls, from a
    torch.profiler trace, and the kernels that took most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    require(busy_us > 0, "profiler trace shows no device time")
    top = [{"us_per_call": us / n, "per_call": c / n, "kernel": key[:80]}
           for us, c, key in rows[:8]]
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "busy_share": busy_us / wall_us,
            "device_ops_per_call": sum(r[1] for r in rows) / n, "top": top}


def shifted(logits, V):
    """Max-shifted logits over the true vocabulary, float64."""
    a = logits[..., :V].double()
    return a - a.max(-1, keepdim=True).values


def bf16_ulp(v):
    """The spacing of bf16 numbers (8 significant bits) at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def logits_check(got, want, V, what):
    """got's max-shifted logits against want's: |a - b| <= atol + 0.05|b|,
    atol = max(0.1, LM_ULPS bf16 ulps of want's largest |logit|).  Returns
    the max abs difference, the atol and the largest |logit|."""
    a, b = shifted(got, V), shifted(want, V)
    top = float(want[..., :V].abs().max())
    atol = max(0.1, LM_ULPS * bf16_ulp(top))
    diff = (a - b).abs()
    excess = float((diff - 0.05 * b.abs()).max())
    require(math.isfinite(excess) and excess <= atol,
            f"{what}: max-shifted logits differ beyond atol {atol} + rtol "
            f"0.05 (by {excess}; max abs diff {float(diff.max())}, largest "
            f"|logit| {top})")
    return {"max_abs_diff": float(diff.max()), "atol": atol,
            "max_abs_logit": top}


def run_lm(arch, dev, smi):
    """One model of the LM zoo at full width: the prefill step through
    the kernels (launches counted), its TTFT and plain re-run, then the
    serve path and its consistency with the prefill step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.core.compiled import compile_step
    from repro_torch.launch.serve import (decode_carry, generate,
                                          make_decode_step)
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import LanguageModel

    cfg = get_config(arch)
    kernel, V = LM_ARCHS[arch], cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = LanguageModel.init(cfg, g, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{arch}: {n_params / 1e9:.3f} B parameters initialised on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, V, (LM_B, LM_S), generator=g, device=dev,
                            dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    batch = {"tokens": prompts}

    # the path: one prefill, with the counts set to 0 just before it
    torch.cuda.synchronize()
    reset_launches()
    last = prefill(model, batch)
    torch.cuda.synchronize()
    count = launches()
    require(count[kernel] == cfg.n_layers,
            f"{arch} prefill: {count[kernel]} {kernel} launches, expected "
            f"one per layer ({cfg.n_layers})")
    require(sum(count.values()) == count[kernel],
            f"{arch} prefill launched other kernels: {count}")
    require(bool(torch.isfinite(last[:, :V]).all()),
            f"{arch} prefill: non-finite logits")
    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, batch)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t0) * 1e3)
    ttft_ms = statistics.median(ttft)

    with plain_kernels():
        reset_launches()
        t0 = time.perf_counter()
        plain = prefill(model, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        require(sum(launches().values()) == 0, "plain run launched a kernel")
    err = logits_check(last, plain, V, f"{arch} prefill, kernel vs plain")
    log(f"{arch} prefill B={LM_B} S={LM_S}: {count[kernel]} {kernel} "
        f"launches, finite logits, kernel vs plain run (S={LM_S}, plain "
        f"took {plain_s:.1f} s): max abs diff {err['max_abs_diff']:.4g} "
        f"(atol {err['atol']:.4g} + rtol 0.05, largest |logit| "
        f"{err['max_abs_logit']:.3f}); "
        f"TTFT {ttft_ms:.1f} ms (median of 3: {[round(t, 1) for t in ttft]})"
        f" on {smi}")

    # serve: prompt replay into the caches, then greedy decode; the same
    # decode step eagerly, then through one captured graph
    prompt = prompts[:, :SERVE_PROMPT]
    want = prefill(model, {"tokens": prompt})
    runs = {}
    for mode in ("eager", "graph"):
        res = generate(model, prompt, SERVE_GEN, compiled=mode == "graph")
        gap = logits_check(res["prefill_logits"][:, -1], want, V,
                           f"{arch} {mode}: prompt replay vs prefill step")
        tokens = res["tokens"]
        require(tokens.shape == (LM_B, SERVE_GEN) and int(tokens.min()) >= 0
                and int(tokens.max()) < V,
                f"{arch} {mode}: generated tokens {tokens}")
        decode_ms = res["decode_s"] / (SERVE_GEN - 1) * 1e3
        tok_s = LM_B * (SERVE_GEN - 1) / res["decode_s"]
        runs[mode] = {"tokens": tokens, "logits": res["prefill_logits"],
                      "replay_vs_prefill": gap, "replay_s": res["prefill_s"],
                      "capture_s": res["compile_s"],
                      "decode_ms_per_step": decode_ms, "tokens_per_s": tok_s}
        log(f"{arch} serve {mode} B={LM_B} prompt {SERVE_PROMPT} gen "
            f"{SERVE_GEN}: capture {res['compile_s']:.2f} s, replay "
            f"{res['prefill_s']:.2f} s, decode {decode_ms:.2f} ms per token "
            f"step, {tok_s:.1f} tokens/s; replay vs prefill step: max abs "
            f"diff {gap['max_abs_diff']:.4g} (atol {gap['atol']:.4g} + rtol "
            f"0.05, largest |logit| {gap['max_abs_logit']:.3f}); sample "
            f"{tokens[0, :8].tolist()} on {smi}")
    eager, graph = runs.pop("eager"), runs.pop("graph")
    require(torch.equal(graph.pop("tokens"), eager.pop("tokens")),
            f"{arch}: the graph's {SERVE_GEN} tokens differ from the eager "
            "decode's")
    graph_gap = logits_check(graph.pop("logits")[:, -1],
                             eager.pop("logits")[:, -1], V,
                             f"{arch}: graph replay vs eager replay")
    graph["vs_eager"] = graph_gap
    log(f"{arch} serve graph against eager: the {SERVE_GEN} tokens equal; "
        f"last replay logits max abs diff {graph_gap['max_abs_diff']:.4g} "
        f"(gate: atol {graph_gap['atol']:.4g} + rtol 0.05); decode "
        f"{eager['decode_ms_per_step']:.2f} against "
        f"{graph['decode_ms_per_step']:.2f} ms per step, "
        f"{eager['tokens_per_s']:.1f} against {graph['tokens_per_s']:.1f} "
        f"tokens/s on {smi}")

    # device busy share: one prefill, and PROFILE_DECODE decode steps from
    # fresh caches, eager and replayed (after PROFILE_DECODE replays with
    # syncs raising)
    prof_prefill = profile_calls(lambda: prefill(model, batch), 1)
    cache = model.init_cache(LM_B, PROFILE_DECODE)
    serve_step = make_serve_step(cfg)
    state = {"tok": prompt[:, :1], "i": 0}

    def step():
        state["tok"], _ = serve_step(model, cache, state["tok"], state["i"])
        state["i"] += 1

    prof_decode = profile_calls(step, PROFILE_DECODE)
    carry = decode_carry(model.init_cache(LM_B, 2 * PROFILE_DECODE),
                         prompt[:, :1])
    box = {"step": compile_step(make_decode_step(model), carry),
           "carry": carry}

    def replay():
        box["carry"], _ = box["step"](box["carry"])

    with no_syncs():
        for _ in range(PROFILE_DECODE):
            replay()
    prof_graph = profile_calls(replay, PROFILE_DECODE)
    for what, p in (("prefill", prof_prefill), ("decode step", prof_decode),
                    ("decode step replayed", prof_graph)):
        log(f"{arch} {what}: wall {p['wall_ms']:.2f} ms, device busy "
            f"{p['busy_ms']:.2f} ms ({100 * p['busy_share']:.1f} %), "
            f"{p['device_ops_per_call']:.0f} device ops; top: "
            + "; ".join(f"{t['kernel'][:40]} {t['us_per_call']:.0f} us"
                        for t in p["top"][:4]) + f" on {smi}")
    # the graph and its pool go before the next model loads
    del model, cache, carry, box
    torch.cuda.empty_cache()
    graph["profile_decode"] = prof_graph
    return {"launches": count, "n_params": n_params, "ttft_ms": ttft_ms,
            "ttft_runs_ms": ttft, "plain_vs_kernel": err, "plain_s": plain_s,
            "replay_vs_prefill": eager["replay_vs_prefill"],
            "replay_s": eager["replay_s"],
            "decode_ms_per_step": eager["decode_ms_per_step"],
            "tokens_per_s": eager["tokens_per_s"],
            "profile_prefill": prof_prefill, "profile_decode": prof_decode,
            "graph": graph}


def phase_lm(dev, smi):
    return {arch: run_lm(arch, dev, smi) for arch in LM_ARCHS}


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke.py: src/repro_torch not found; run it from the "
                 "root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's kernels need one")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    ptxas = phase_build()
    kern = phase_kernels(dev)
    kern["rule_stats"] = kernel_rule_stats(dev)
    kern["selective_scan"] = kernel_selective_scan(dev)
    kern["flash_attention"] = kernel_flash_attention(dev)
    main_path = phase_main(dev, smi)
    paths = phase_paths(dev)
    rules = phase_rules(dev, smi)
    ens = phase_ensembles(dev, smi)
    cs = phase_clustream(dev, smi)
    sv = phase_serve(dev, smi)
    fl = phase_fleet(dev, smi)
    lm = phase_lm(dev, smi)

    names = ("tree_route", "vht_stats", "split_gain", "rule_stats",
             "selective_scan", "flash_attention")
    replaces = {
        "tree_route": "src/repro/kernels/tree_route/kernel.py:68",
        "vht_stats": "src/repro/kernels/vht_stats/kernel.py:69",
        "split_gain": "src/repro/kernels/split_gain/kernel.py:58",
        "rule_stats": "src/repro/kernels/rule_stats/kernel.py:71",
        "selective_scan": "src/repro/kernels/selective_scan/kernel.py:54",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85"}
    # each kernel's launches on the main path that runs it; rule_stats
    # counts the moment statistics, the work of the TPU kernel it replaces
    path_launches = dict(main_path["launches"])
    amr = rules["waveform-40 VAMR"]
    path_launches["rule_stats"] = amr["launches"]["rule_stats"]
    for arch, kernel in LM_ARCHS.items():
        path_launches[kernel] = lm[arch]["launches"][kernel]
    rules_split(kern["rule_stats"], amr)
    rows = []
    for name in names:
        e = kern[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces[name],
                     "launches": path_launches[name],
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                     "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    # the rule_stats kernel as segment_sum, on the CluStream main path: its
    # wide form's CF scatter x | x^2 [257, 1, 1, 256] (launches: the eager
    # d128-K256 step-mode run's launches of the wide form, one a step)
    cs_main = cs["d128-K256 step"]
    e = cs_main["kernels"]["x|x^2"]
    rows.append({"name": "segment_sum", "route": "cuda",
                 "source": "src/repro_torch/csrc/rule_stats.cu",
                 "replaces": replaces["rule_stats"],
                 "launches": cs_main["launches"]["segment_sum_wide"],
                 "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                 "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                 "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    # split_poisson on the ensembles' main path (OzaBag ADWIN dense-1000,
    # one launch a step); it replaces no TPU kernel but the JAX package's
    # jax.random.poisson call, which XLA runs
    ens_main = ens[f"OzaBag adwin dense-{M_ATTRS}"]
    e = ens_main["kernels"]["split_poisson"]
    rows.append({"name": "split_poisson", "route": "cuda",
                 "source": "src/repro_torch/csrc/split_poisson.cu",
                 "replaces": "src/repro/ml/ensemble.py:178",
                 "launches": ens_main["launches"]["split_poisson"],
                 "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                 "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                 "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    # the fleet forms (phase 11): tree_route's batch per tree on the VHT
    # fleet's path (its eager F = 1000 run) and its tree per row on the
    # fleet's served batches; segment_sum's tenant form on the CluStream
    # fleet's path (step mode, F = 1000)
    fleet_launches = {
        "tree_route_batched": fl["vht"]["launches"]["tree_route_batched"],
        "tree_route_rows": fl["serve"]["launches"],
        "segment_sum_tenant":
            fl["clustream step"]["launches"]["segment_sum_tenant"]}
    for name, src, rep in (
            ("tree_route_batched", "tree_route", "tree_route"),
            ("tree_route_rows", "tree_route", "tree_route"),
            ("segment_sum_tenant", "rule_stats", "rule_stats")):
        e = fl["kernels"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}.cu",
                     "replaces": replaces[rep],
                     "launches": fleet_launches[name],
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                     "bound_by": e["bound_by"], "library_ms": e["library_ms"]})
    log(f"split_gain full fallback [{N_NODES},{M_ATTRS},{BINS},{C}]: "
        f"{json.dumps(kern['split_gain_full'])}")
    log(f"paths: {json.dumps(paths)}")
    log(f"rules: {json.dumps(rules)}")
    log(f"ensembles: {json.dumps(ens)}")
    log(f"clustream: {json.dumps(cs)}")
    log(f"serve: {json.dumps(sv)}")
    log(f"fleet: {json.dumps(fl)}")
    log(f"lm: {json.dumps(lm)}")
    log(f"ptxas: {json.dumps(ptxas)}")
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
