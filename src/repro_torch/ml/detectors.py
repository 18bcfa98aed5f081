"""Change detectors (paper section 5): the Page-Hinkley-over-EMA family
that AMRules attaches to each rule, and ``DetectorBank``, which keeps N
such detectors as one packed state and advances them in one pass.

Port of the ``ph_ema`` parts of ``repro/ml/detectors.py``; the other
families (Page-Hinkley, DDM, EDDM, ADWIN) come with the ensembles.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pytree import tree_map
from repro_torch.core.xla_numerics import fma
from repro_torch.device import resolve_device

f32 = torch.float32
FAMILIES = ("ph_ema",)


@dataclasses.dataclass(frozen=True)
class PhEmaConfig:
    """AMRules' Page-Hinkley variant: the deviation is measured against an
    exponential moving average of the monitored statistic instead of the
    running mean, and steps without a sample leave the state untouched."""
    alpha: float = 0.005
    lam: float = 35.0
    decay: float = 0.99       # EMA decay of the error baseline


def phema_init(device=None):
    z = torch.zeros((), dtype=f32, device=resolve_device(device))
    return {"m": z, "min": z.clone(), "err": z.clone()}


def phema_update(state, x, pe: PhEmaConfig | None = None, has=None):
    """Page-Hinkley against an EMA error baseline (AMRules per-rule drift).

    ``has`` masks steps that carried no sample for this detector: the
    cumulative statistic and the baseline hold still, while the running
    minimum and the threshold test are evaluated unconditionally.  The
    EMA is a fused multiply-add, as XLA computes it on the CPU."""
    pe = pe if pe is not None else PhEmaConfig()
    has = torch.ones_like(x, dtype=torch.bool) if has is None else has
    mt = torch.where(has, state["m"] + x - state["err"] - pe.alpha,
                     state["m"])
    err = torch.where(has, fma(1.0 - pe.decay, x, pe.decay * state["err"]),
                      state["err"])
    mn = torch.minimum(state["min"], mt)
    drift = mt - mn > pe.lam
    return {"m": mt, "min": mn, "err": err}, drift


class DetectorBank:
    """N change detectors of one family as a packed struct-of-arrays state:
    every leaf of the scalar state gains a leading ``[N]`` axis, and
    ``update`` advances all N in one elementwise pass."""

    def __init__(self, family: str, n: int, config=None, device=None):
        if family not in FAMILIES:
            raise ValueError(f"unknown detector family {family!r} "
                             f"(the port has: {', '.join(FAMILIES)})")
        self.family = family
        self.n = n
        self.config = config if config is not None else PhEmaConfig()
        self.device = device

    def init(self):
        """Packed [N] state: the scalar init broadcast across rows."""
        return tree_map(lambda x: x.expand(self.n).clone(),
                        phema_init(self.device))

    def update(self, state, x, has=None):
        """x: [N] monitored values; ``has`` [N] bool masks detectors that
        got no sample this step.  Returns (state, drift [N] bool)."""
        return phema_update(state, x, self.config, has=has)

    def reset(self, state, mask):
        """Re-initialize the detectors where ``mask`` ([N] bool) holds."""
        fresh = phema_init(mask.device)
        return tree_map(lambda z, a: torch.where(mask, z, a), fresh, state)
