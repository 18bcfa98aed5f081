"""Change detectors (paper section 5): ADWIN, DDM, EDDM and Page-Hinkley,
which the adaptive ensembles attach to each member, and the
Page-Hinkley-over-EMA family that AMRules attaches to each rule -- each a
pure function (state, value) -> (state, drift).  ``DetectorBank`` keeps N
detectors of one family as one packed state (every leaf gains a leading
``[N]`` axis) and advances them in one pass.

Port of ``repro/ml/detectors.py``.  Each family is configured by a frozen
dataclass; the JAX package's deprecated loose keyword arguments have no
caller in the port and are not taken.  Where XLA contracts a product into
a sum on the CPU, the port takes the fused multiply-add
(``core.xla_numerics.fma``), so the states match the JAX package's bit for
bit.

The monitored value may come as a product ``x * scale`` (the ensembles'
error rate: a count of errors times XLA's float32 ``1 / B``).  XLA fuses
that product into the first sums it enters, each rounded once to float32
(``_plus``); elsewhere the product is rounded first.

ADWIN here is the exponential-bucket variant with a fixed number of bucket
rows (capacity-bounded): adjacent-subwindow mean comparison with the
Hoeffding-style cut threshold.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.pytree import tree_map
from repro_torch.core.xla_numerics import cumsum, fma, sqrt
from repro_torch.device import resolve_device

f32 = torch.float32
FAMILIES = ("ph", "ddm", "eddm", "adwin", "ph_ema")


@dataclasses.dataclass(frozen=True)
class PageHinkleyConfig:
    alpha: float = 0.005      # drift magnitude allowance per step
    lam: float = 50.0         # cumulative-deviation threshold


@dataclasses.dataclass(frozen=True)
class DdmConfig:
    warn_k: float = 2.0       # warning-zone multiplier (reported, not acted on)
    drift_k: float = 3.0      # drift-zone multiplier


@dataclasses.dataclass(frozen=True)
class EddmConfig:
    beta: float = 0.9         # distance-ratio drift threshold


@dataclasses.dataclass(frozen=True)
class AdwinConfig:
    n_buckets: int = 32       # exponential histogram rows
    delta: float = 0.002


@dataclasses.dataclass(frozen=True)
class PhEmaConfig:
    """AMRules' Page-Hinkley variant: the deviation is measured against an
    exponential moving average of the monitored statistic instead of the
    running mean, and steps without a sample leave the state untouched."""
    alpha: float = 0.005
    lam: float = 35.0
    decay: float = 0.99       # EMA decay of the error baseline


CONFIGS = {"ph": PageHinkleyConfig, "ddm": DdmConfig, "eddm": EddmConfig,
           "adwin": AdwinConfig, "ph_ema": PhEmaConfig}


def _scalars(device, **values):
    dev = resolve_device(device)
    return {k: torch.full((), v, dtype=f32, device=dev)
            for k, v in values.items()}


def _plus(x, c, scale=None):
    """``x * scale + c`` rounded once to float32, as XLA's fused
    multiply-add; ``x + c`` without a scale."""
    return x + c if scale is None else fma(x, scale, c)


def _value(x, scale=None):
    """The monitored value ``x * scale`` (``x`` without a scale), rounded
    to float32."""
    return x if scale is None else x * scale


def _reset_where(drift, fresh, new):
    """``where(drift, fresh, new)`` leaf by leaf: the post-drift reset."""
    return tree_map(lambda a, b: torch.where(drift, a, b), fresh, new)


# ------------------------------- Page-Hinkley -------------------------------

def ph_init(device=None):
    return _scalars(device, m=0.0, min=0.0, mean=0.0, n=0.0)


def ph_update(state, x, pc: PageHinkleyConfig | None = None, scale=None):
    pc = pc if pc is not None else PageHinkleyConfig()
    n = state["n"] + 1
    mean = state["mean"] + _plus(x, -state["mean"], scale) / n
    m = _plus(x, state["m"], scale) - mean - pc.alpha
    mn = torch.minimum(state["min"], m)
    drift = m - mn > pc.lam
    return {"m": m, "min": mn, "mean": mean, "n": n}, drift


# ------------------------------------ DDM -----------------------------------

def ddm_init(device=None):
    return _scalars(device, n=0.0, p=1.0, s=0.0, pmin=1e9, smin=1e9)


def ddm_update(state, error, dc: DdmConfig | None = None, scale=None):
    """error: the misclassification rate (0/1 for one instance)."""
    dc = dc if dc is not None else DdmConfig()
    n = state["n"] + 1
    p = state["p"] + _plus(error, -state["p"], scale) / n
    s = sqrt(p * (1 - p) / torch.clamp(n, min=1.0))
    # only track minima once the estimate has stabilized, otherwise an
    # early lucky streak (p=0, s=0) makes every later point look like drift
    better = (n >= 30) & (p + s < state["pmin"] + state["smin"])
    pmin = torch.where(better, p, state["pmin"])
    smin = torch.where(better, s, state["smin"])
    drift = (n > 30) & (p + s > fma(dc.drift_k, smin, pmin))
    new = {"n": n, "p": p, "s": s, "pmin": pmin, "smin": smin}
    return _reset_where(drift, ddm_init(n.device), new), drift


# ----------------------------------- EDDM -----------------------------------

def eddm_init(device=None):
    return _scalars(device, n=0.0, last_err=0.0, mean_d=0.0, var_d=0.0,
                    m2smax=0.0, n_err=0.0)


def eddm_update(state, error, ec: EddmConfig | None = None, scale=None):
    """Distance-between-errors detector."""
    ec = ec if ec is not None else EddmConfig()
    n = state["n"] + 1
    is_err = _value(error, scale) > 0.5
    dist = n - state["last_err"]
    n_err = state["n_err"] + is_err
    delta = dist - state["mean_d"]
    mean_d = torch.where(
        is_err, state["mean_d"] + delta / torch.clamp(n_err, min=1),
        state["mean_d"])
    var_d = torch.where(is_err, fma(delta, dist - mean_d, state["var_d"]),
                        state["var_d"])
    std = sqrt(torch.clamp(var_d / torch.clamp(n_err - 1, min=1),
                                 min=0))
    m2s = mean_d + 2 * std
    m2smax = torch.maximum(state["m2smax"],
                           torch.where(is_err, m2s, state["m2smax"]))
    ratio = m2s / torch.clamp(m2smax, min=1e-9)
    drift = is_err & (n_err > 30) & (ratio < ec.beta)
    new = {"n": n, "last_err": torch.where(is_err, n, state["last_err"]),
           "mean_d": mean_d, "var_d": var_d, "m2smax": m2smax, "n_err": n_err}
    return _reset_where(drift, eddm_init(n.device), new), drift


# ----------------------------------- ADWIN ----------------------------------

def adwin_init(ac: AdwinConfig | None = None, device=None):
    ac = ac if ac is not None else AdwinConfig()
    dev = resolve_device(device)
    return {"sum": torch.zeros(ac.n_buckets, dtype=f32, device=dev),
            "cnt": torch.zeros(ac.n_buckets, dtype=f32, device=dev),
            "n": torch.zeros((), dtype=f32, device=dev)}


def adwin_update(state, x, ac: AdwinConfig | None = None, scale=None):
    """Exponential-histogram ADWIN (bucket 0 newest) of one detector, or
    of a packed [N, n_buckets] bank with values x [N] in one tensor pass:
    when a bucket's count reaches twice its capacity it cascades into the
    next (a soft cascade each step, capacity-bounded); then the
    prefix/suffix cut scan, and, on drift, the eviction of the oldest half
    of the window."""
    ac = ac if ac is not None else AdwinConfig()
    s, c, n = state["sum"], state["cnt"], state["n"]
    nb = ac.n_buckets
    s = torch.cat([_plus(x[..., None], s[..., :1], scale), s[..., 1:]], -1)
    c = torch.cat([c[..., :1] + 1.0, c[..., 1:]], -1)
    cap = 2.0 ** torch.arange(nb, dtype=f32, device=s.device)
    overflow = c >= 2 * cap
    carry_c = torch.where(overflow, cap, 0.0)
    carry_s = torch.where(
        overflow, s * torch.where(c > 0, cap / torch.clamp(c, min=1e-9), 0.0),
        0.0)

    def shifted(v):                     # jnp.roll(v, 1).at[0].set(0)
        return torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)

    c = c - carry_c + shifted(carry_c)
    s = s - carry_s + shifted(carry_s)
    n = n + 1

    # every prefix/suffix cut, its mean difference against eps_cut; the
    # running sums in XLA's order
    csum = cumsum(s)
    ccnt = cumsum(c)
    tot_s, tot_c = csum[..., -1:], ccnt[..., -1:]
    n0 = torch.clamp(ccnt, min=1e-9)            # newest-side window
    n1 = torch.clamp(tot_c - ccnt, min=1e-9)
    mu0 = csum / n0
    mu1 = (tot_s - csum) / n1
    m_inv = 1 / n0 + 1 / n1
    dd = math.log(2.0 / ac.delta)
    mean = tot_s / torch.clamp(tot_c, min=1e-9)
    var = torch.clamp(mean * (1 - mean), 0.0, 0.25)
    eps = fma(2.0 / 3.0 * m_inv, dd, sqrt(2 * m_inv * var * dd))
    valid = (ccnt > 5) & ((tot_c - ccnt) > 5)
    drift = torch.any(valid & (torch.abs(mu0 - mu1) > eps), dim=-1)
    half = torch.arange(nb, device=s.device) < nb // 2
    evict = drift[..., None] & ~half
    s = torch.where(evict, 0.0, s)
    c = torch.where(evict, 0.0, c)
    return {"sum": s, "cnt": c, "n": n}, drift


# ---------------------------- PH-over-EMA (AMRules) --------------------------

def phema_init(device=None):
    return _scalars(device, m=0.0, min=0.0, err=0.0)


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


# ------------------------------- DetectorBank --------------------------------

class DetectorBank:
    """N change detectors of one family as a packed struct-of-arrays state.

    Every leaf of the scalar state gains a leading ``[N]`` axis; ``update``
    advances all N in one batched pass (every recurrence is elementwise
    over the detectors, so the scalar updates run unchanged on the packed
    state).  ``reset`` re-initializes a masked subset of rows."""

    def __init__(self, family: str, n: int, config=None, device=None):
        if family not in FAMILIES:
            raise ValueError(f"unknown detector family {family!r} "
                             f"(available: {', '.join(FAMILIES)})")
        self.family = family
        self.n = n
        self.config = config if config is not None else CONFIGS[family]()
        self.device = device

    def _init_one(self, device):
        if self.family == "ph":
            return ph_init(device)
        if self.family == "ddm":
            return ddm_init(device)
        if self.family == "eddm":
            return eddm_init(device)
        if self.family == "adwin":
            return adwin_init(self.config, device)
        return phema_init(device)

    def init(self):
        """Packed [N, ...] state: the scalar init broadcast across rows."""
        one = self._init_one(self.device)
        return tree_map(lambda x: x.expand(self.n, *x.shape).clone(), one)

    def update(self, state, x, has=None, scale=None):
        """x: [N] monitored values, one per detector, or with ``scale``
        the values ``x * scale`` (``_plus``).  ``has`` ([N] bool) is
        honoured by the ph_ema family only (rules with no covered instance
        this step).  Returns (state, drift [N] bool)."""
        if self.family == "ph":
            return ph_update(state, x, self.config, scale)
        if self.family == "ddm":
            return ddm_update(state, x, self.config, scale)
        if self.family == "eddm":
            return eddm_update(state, x, self.config, scale)
        if self.family == "adwin":
            return adwin_update(state, x, self.config, scale)
        return phema_update(state, x, self.config, has=has)

    def reset(self, state, mask):
        """Re-initialize the detectors where ``mask`` ([N] bool) holds."""
        fresh = self._init_one(mask.device)

        def pick(z, a):
            return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                               z, a)
        return tree_map(pick, fresh, state)
