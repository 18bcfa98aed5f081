"""The port's change detectors (``repro_torch.ml.detectors``) against the
JAX package's, on the CPU, bit for bit: every state leaf and every drift
flag of Page-Hinkley, DDM, EDDM and ADWIN, scalar and as a
``DetectorBank`` (with ``reset``), over 0/1 error streams and per-batch
error rates that drift at step 200, the rates also as the ensembles hand
them on (a count and XLA's float32 reciprocal of the batch size).  The
port follows XLA's fused multiply-add in EDDM's variance and its
correctly rounded square root (``core/xla_numerics.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro.ml import detectors as jdet
from repro_torch.core.xla_numerics import reciprocal
from repro_torch.ml import detectors as tdet

CPU = "cpu"
STEPS, DRIFT_AT, N = 400, 200, 5
FAMILIES = ("ph", "ddm", "eddm", "adwin")
SCALAR = {"ph": ("ph_init", "ph_update"), "ddm": ("ddm_init", "ddm_update"),
          "eddm": ("eddm_init", "eddm_update"),
          "adwin": ("adwin_init", "adwin_update")}


_BANKS = {}


def _jax_bank(family):
    """The JAX package's bank of N detectors and its compiled update, one
    per family for every test here."""
    if family not in _BANKS:
        jb = jdet.DetectorBank(family, N)
        _BANKS[family] = jb, jax.jit(jb.update)
    return _BANKS[family]


def _stream(kind, n=N, seed=0):
    """[STEPS, n] f32: 0/1 errors ("binary") or error rates ("rate"),
    their mean rising at DRIFT_AT."""
    rng = np.random.RandomState(seed)
    step = np.arange(STEPS)[:, None]
    if kind == "binary":
        p = np.where(step < DRIFT_AT, 0.1, 0.6)
        return (rng.uniform(size=(STEPS, n)) < p).astype(np.float32)
    p = np.where(step < DRIFT_AT, 0.15, 0.55)
    return np.clip(p + 0.05 * rng.randn(STEPS, n), 0, 1).astype(np.float32)


def _assert_state_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f"{where} {k}")


@pytest.mark.parametrize("kind", ["binary", "rate"])
@pytest.mark.parametrize("family", FAMILIES)
def test_bank_bit_identical_to_jax(family, kind):
    xs = _stream(kind)
    jb, update = _jax_bank(family)
    tb = tdet.DetectorBank(family, N, device=CPU)
    js, ts = jb.init(), tb.init()
    _assert_state_equal(ts, js, "init")
    drifts = 0
    for t in range(STEPS):
        js, jd = update(js, jnp.asarray(xs[t]))
        ts, td = tb.update(ts, torch.from_numpy(xs[t]))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd),
                                      err_msg=f"drift at step {t}")
        _assert_state_equal(ts, js, f"step {t}")
        drifts += int(td.sum())
    assert drifts > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_scalar_update_bit_identical_to_jax(family):
    xs = _stream("rate", n=1, seed=1)[:, 0]
    init, update = SCALAR[family]
    jupdate = jax.jit(getattr(jdet, update))
    tupdate = getattr(tdet, update)
    if family == "adwin":
        js = jdet.adwin_init(jdet.AdwinConfig())
        ts = tdet.adwin_init(tdet.AdwinConfig(), CPU)
    else:
        js, ts = getattr(jdet, init)(), getattr(tdet, init)(CPU)
    for t in range(STEPS):
        js, jd = jupdate(js, jnp.float32(xs[t]))
        ts, td = tupdate(ts, torch.tensor(xs[t]))
        assert bool(td) == bool(jd), f"drift at step {t}"
        _assert_state_equal(ts, js, f"step {t}")


def test_adwin_batch_bit_identical_to_jax_batch():
    """The port's ``adwin_update`` on packed [N, 32] histograms, against
    the JAX package's own batched form, ``_adwin_update_batch``."""
    ac = jdet.AdwinConfig()
    xs = _stream("binary", seed=2)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N, *x.shape)),
                      jdet.adwin_init(ac))
    ts = tdet.DetectorBank("adwin", N, device=CPU).init()
    update = jax.jit(lambda s, x: jdet._adwin_update_batch(s, x, ac))
    for t in range(STEPS):
        js, jd = update(js, jnp.asarray(xs[t]))
        ts, td = tdet.adwin_update(ts, torch.from_numpy(xs[t]),
                                   tdet.AdwinConfig())
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        _assert_state_equal(ts, js, f"step {t}")


@pytest.mark.parametrize("family", FAMILIES)
def test_bank_on_a_batch_mean_bit_identical_to_jax(family):
    """The monitored value as the ensembles hand it on: the mean of a
    batch of 40 0/1 errors, which XLA computes as the count times its
    float32 1 / 40 and fuses into the detector's first sums; the port
    passes the count and ``scale=reciprocal(40)``."""
    rng = np.random.RandomState(4)
    p = np.where(np.arange(STEPS) < DRIFT_AT, 0.1, 0.6)[:, None, None]
    errs = (rng.uniform(size=(STEPS, N, 40)) < p).astype(np.float32)
    jb, tb = jdet.DetectorBank(family, N), tdet.DetectorBank(family, N,
                                                             device=CPU)
    js, ts = jb.init(), tb.init()
    update = jax.jit(lambda s, e: jb.update(s, jnp.mean(e, -1)))
    scale = reciprocal(40)
    drifts = 0
    for t in range(STEPS):
        js, jd = update(js, jnp.asarray(errs[t]))
        ts, td = tb.update(ts, torch.from_numpy(errs[t].sum(-1)),
                           scale=scale)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd),
                                      err_msg=f"drift at step {t}")
        _assert_state_equal(ts, js, f"step {t}")
        drifts += int(td.sum())
    assert drifts > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_bank_reset_bit_identical_to_jax(family):
    """``reset(mask)`` re-initializes exactly the masked rows of a state
    taken mid-stream."""
    xs = _stream("rate", seed=3)
    jb, update = _jax_bank(family)
    tb = tdet.DetectorBank(family, N, device=CPU)
    js, ts = jb.init(), tb.init()
    for t in range(DRIFT_AT + 20):
        js, _ = update(js, jnp.asarray(xs[t]))
        ts, _ = tb.update(ts, torch.from_numpy(xs[t]))
    mask = np.array([True, False, True, False, False])
    _assert_state_equal(tb.reset(ts, torch.from_numpy(mask)),
                        jb.reset(js, jnp.asarray(mask)), "reset")


def test_bank_refuses_an_unknown_family():
    with pytest.raises(ValueError, match="unknown detector family"):
        tdet.DetectorBank("cusum", 3, device=CPU)
