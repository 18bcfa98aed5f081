"""Hand-written Hopper kernels of the port, one package each: ``ops.py``
(the wrapper), ``ref.py`` (the plain PyTorch version) and the CUDA source
in ``src/repro_torch/csrc/<name>.cu``.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors.  Each counts its launches in ``<wrapper>.launches``, so a
run can show that it went through the kernels.  The counts are of calls
from Python: in a step captured as a CUDA graph (``core.compiled``) a
wrapper counts once while the step is captured (and once more in the
warm-up before it), and a replay counts nothing, nor does a count say
whether a kernel inside a conditional node ran.  A graph run's launches
are read from the device trace (``chip_smoke.py``).  The ``rule_stats``
wrappers also count the launches of the kernel's wide form (more than 8
columns) in ``<wrapper>.wide_launches``.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rule_stats.ops import (rule_stats_scatter,
                                                segment_sum,
                                                segment_sum_tenant)
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.split_gain.ops import split_gain
from repro_torch.kernels.split_poisson.ops import split_poisson
from repro_torch.kernels.tree_route.ops import (tree_route,
                                                tree_route_batched,
                                                tree_route_rows)
from repro_torch.kernels.vht_stats.ops import stats_update

KERNELS = {"tree_route": tree_route, "vht_stats": stats_update,
           "split_gain": split_gain, "rule_stats": rule_stats_scatter,
           "selective_scan": selective_scan, "flash_attention": flash_attention}
# the rule_stats kernel also sums AMRules' float reductions in instance
# order; those launches are counted apart from the moment statistics'.
# split_poisson (the ensembles' member weights) replaces no TPU kernel.
# A fleet's forms of tree_route (a batch per tree, a tree per row) and of
# segment_sum (a sum per tenant) count apart from the forms they extend.
COUNTED = {**KERNELS, "segment_sum": segment_sum,
           "split_poisson": split_poisson,
           "tree_route_batched": tree_route_batched,
           "tree_route_rows": tree_route_rows,
           "segment_sum_tenant": segment_sum_tenant}


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    rule_stats_scatter.wide_launches = segment_sum.wide_launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}
