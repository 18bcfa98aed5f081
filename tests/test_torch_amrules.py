"""The port's AMRules path (MAMR, VAMR, HAMR-2) against the JAX package, on
the CPU.

The same regression streams (made by the JAX package's own generators, as
tests/test_fused.py makes ``reg_stream``, passed on as numpy arrays) go
through ``repro`` (``jax.jit(learner.run)``) and ``repro_torch``.  On CPU
tensors the port runs the plain version of its ``rule_stats`` kernel.  The
port takes every float sum in XLA's CPU order and rounding (the scatter in
instance order, whole-batch sums in windows of 32, fused multiply-adds
where XLA contracts), so the comparison is exact: every state leaf, dtype
included, and every per-batch metric.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro.core.engines import JitEngine
from repro.core.engines import LocalEngine as JaxLocalEngine
from repro.core.evaluation import PrequentialEvaluation as JaxPrequential
from repro.data.generators import (ElectricityLikeGenerator,
                                   WaveformGenerator, bin_numeric)
from repro.ml.amrules import HAMR as JaxHAMR
from repro.ml.amrules import VAMR as JaxVAMR
from repro.ml.amrules import AMRules as JaxAMRules
from repro.ml.amrules import RulesConfig as JaxRulesConfig
from repro.ml.detectors import DetectorBank as JaxDetectorBank
from repro.ml.detectors import PhEmaConfig as JaxPhEmaConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engines import LocalEngine, StreamEngine
from repro_torch.core.evaluation import PrequentialEvaluation, stack_outputs
from repro_torch.ml.amrules import HAMR, VAMR, AMRules, RulesConfig
from repro_torch.ml.detectors import DetectorBank, PhEmaConfig

CPU = "cpu"
N_BATCHES, BATCH = 25, 256
STREAMS = {"electricity-12": (ElectricityLikeGenerator, 12),
           "waveform-40": (WaveformGenerator, 40)}
VARIANTS = {"MAMR": (JaxAMRules, AMRules),
            "VAMR": (JaxVAMR, VAMR),
            "HAMR-2": (lambda rc: JaxHAMR(rc, replicas=2),
                       lambda rc, device: HAMR(rc, replicas=2,
                                               device=device))}
# leaves that hold the rule structure: integers and booleans
STRUCTURE = ("active", "pred_attr", "pred_op", "pred_bin", "pred_valid",
             "pend_rule_valid", "pend_attr", "pend_op", "pend_bin",
             "pend_timer", "n_rules", "n_created", "n_removed", "n_feats")

_CACHE = {}


def _stream(name):
    """[T, B, m] i32 bins and [T, B] f32 targets, as tests/test_fused.py
    builds ``reg_stream``."""
    if name not in _CACHE:
        gen_cls, _ = STREAMS[name]
        gen = gen_cls()
        key = jax.random.PRNGKey(1)
        xs, ys = [], []
        for _ in range(N_BATCHES):
            key, k = jax.random.split(key)
            x, y = gen.sample(k, BATCH)
            xs.append(np.asarray(bin_numeric(x, 8), np.int32))
            ys.append(np.asarray(y, np.float32))
        _CACHE[name] = (np.stack(xs), np.stack(ys))
    return _CACHE[name]


def _rc_kwargs(stream, **kw):
    """RulesConfig(n_attrs=m, n_bins=8, max_rules=32, n_min=150), as
    tests/test_fused.py's RC, with overrides."""
    return {**dict(n_attrs=STREAMS[stream][1], n_bins=8, max_rules=32,
                   n_min=150), **kw}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state_equal(got, want):
    """Same keys, dtypes and values, leaf for leaf."""
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_run(variant, rc_kwargs, xs, ys, state=None):
    learner = VARIANTS[variant][0](JaxRulesConfig(**rc_kwargs))
    st, ms = jax.jit(learner.run)(
        learner.init() if state is None else state, jnp.asarray(xs),
        jnp.asarray(ys))
    return _np(st), _np(ms)


def _port(variant, rc_kwargs):
    return VARIANTS[variant][1](RulesConfig(**rc_kwargs), device=CPU)


def _port_run(variant, rc_kwargs, xs, ys, state=None):
    learner = _port(variant, rc_kwargs)
    st, ms = learner.run(learner.init() if state is None else state,
                         torch.from_numpy(xs), torch.from_numpy(ys))
    return state_to_numpy(st), state_to_numpy(ms)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_run_bit_identical_to_jax(stream, variant):
    """Rule structure, every float leaf and the per-batch abs_err, sq_err,
    seen and n_rules are identical to ``jax.jit(learner.run)``."""
    xs, ys = _stream(stream)
    kw = _rc_kwargs(stream)
    want_st, want_ms = _jax_run(variant, kw, xs, ys)
    got_st, got_ms = _port_run(variant, kw, xs, ys)
    assert int(want_st["n_created"]) > 0          # expansions really fired
    for k in STRUCTURE:
        np.testing.assert_array_equal(got_st[k], want_st[k], err_msg=k)
    _assert_state_equal(got_st, want_st)
    _assert_state_equal(got_ms, want_ms)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ungated_expansions_bit_identical_to_jax(variant):
    """gate_expansions=False runs the SDR decision on every step."""
    xs, ys = _stream("waveform-40")
    kw = _rc_kwargs("waveform-40", gate_expansions=False)
    want_st, want_ms = _jax_run(variant, kw, xs, ys)
    got_st, got_ms = _port_run(variant, kw, xs, ys)
    assert int(want_st["n_created"]) > 0
    _assert_state_equal(got_st, want_st)
    _assert_state_equal(got_ms, want_ms)


@pytest.mark.parametrize("detector_impl", ["bank", "inline"])
@pytest.mark.parametrize("variant", ["MAMR", "VAMR"])
def test_drift_eviction_bit_identical_to_jax(variant, detector_impl):
    """A low Page-Hinkley threshold evicts rules: the detector bank, its
    reset and the inline formulation follow the JAX package."""
    xs, ys = _stream("electricity-12")
    kw = _rc_kwargs("electricity-12", ph_lambda=0.5, n_min=100,
                    detector_impl=detector_impl)
    want_st, want_ms = _jax_run(variant, kw, xs, ys)
    got_st, got_ms = _port_run(variant, kw, xs, ys)
    assert int(want_st["n_removed"]) > 0          # evictions really fired
    _assert_state_equal(got_st, want_st)
    _assert_state_equal(got_ms, want_ms)


def test_onehot_stats_impl_bit_identical_to_jax():
    """stats_impl="onehot": the two one-hot updates of the oracle."""
    xs, ys = _stream("waveform-40")
    kw = _rc_kwargs("waveform-40", stats_impl="onehot")
    want_st, want_ms = _jax_run("MAMR", kw, xs, ys)
    got_st, got_ms = _port_run("MAMR", kw, xs, ys)
    _assert_state_equal(got_st, want_st)
    _assert_state_equal(got_ms, want_ms)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_carries_across_both_ways_mid_stream(variant):
    """A JAX state after 12 batches, carried into the port through
    ``convert.py``, and a port state carried back into JAX, both finish
    the stream as the JAX package's uninterrupted run does."""
    xs, ys = _stream("electricity-12")
    kw = _rc_kwargs("electricity-12")
    full_st, full_ms = _jax_run(variant, kw, xs, ys)
    half_st, _ = _jax_run(variant, kw, xs[:12], ys[:12])
    got_st, got_ms = _port_run(variant, kw, xs[12:], ys[12:],
                               state=state_from_numpy(half_st, device=CPU))
    _assert_state_equal(got_st, full_st)
    _assert_state_equal(got_ms, {k: v[12:] for k, v in full_ms.items()})
    port_half, _ = _port_run(variant, kw, xs[:12], ys[:12])
    back_st, _ = _jax_run(variant, kw, xs[12:], ys[12:],
                          state=jax.tree.map(jnp.asarray, port_half))
    _assert_state_equal(back_st, full_st)


def test_run_leaves_its_input_state_as_it_was():
    xs, ys = _stream("electricity-12")
    learner = _port("MAMR", _rc_kwargs("electricity-12"))
    init = learner.init()
    before = state_to_numpy(init)
    learner.run(init, torch.from_numpy(xs[:6]), torch.from_numpy(ys[:6]))
    _assert_state_equal(state_to_numpy(init), before)


@pytest.mark.parametrize("variant", ["VAMR", "HAMR-2"])
def test_engines_match_jax(variant):
    """The learner as a one-processor topology: the port's LocalEngine and
    StreamEngine against the JAX package's LocalEngine and JitEngine, over
    the first 12 batches."""
    xs, ys = (a[:12] for a in _stream("waveform-40"))
    kw = _rc_kwargs("waveform-40")
    learner = VARIANTS[variant][0](JaxRulesConfig(**kw))
    payloads = [{"x": jnp.asarray(x), "y": jnp.asarray(y)}
                for x, y in zip(xs, ys)]
    port_payloads = [{"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
                     for x, y in zip(xs, ys)]
    key = jax.random.PRNGKey(0)
    jax_local = JaxLocalEngine()
    jl_states, jl_outs = jax_local.run_stream(
        learner, jax_local.init(learner, key), payloads)
    jit = JitEngine()
    jj_carry, jj_outs = jit.run_stream(learner, jit.init(learner, key),
                                       payloads)
    port = _port(variant, kw)
    local = LocalEngine()
    pl_states, pl_outs = local.run_stream(port, local.init(port),
                                          port_payloads)
    stream = StreamEngine()
    ps_carry, ps_outs = stream.run_stream(port, stream.init(port),
                                          port_payloads)
    (name,) = pl_states
    _assert_state_equal(state_to_numpy(pl_states[name]),
                        _np(jl_states[name]))
    _assert_state_equal(state_to_numpy(ps_carry["states"][name]),
                        _np(jj_carry["states"][name]))
    want = _np(jl_outs[-1]["metrics"])
    _assert_state_equal(state_to_numpy(stack_outputs(pl_outs)["metrics"]),
                        _np(jax.tree.map(lambda *v: jnp.stack(v),
                                         *[o["metrics"] for o in jl_outs])))
    _assert_state_equal(state_to_numpy(ps_outs["metrics"]),
                        _np(jj_outs["metrics"]))
    assert set(want) == {"abs_err", "sq_err", "seen", "n_rules"}


def test_prequential_curve_matches_jax():
    """``PrequentialEvaluation`` (regression: the metric is the MAE and the
    curve the negated per-batch MAE) gives the JAX package's numbers."""
    xs, ys = _stream("waveform-40")
    kw = _rc_kwargs("waveform-40")
    want = JaxPrequential(JaxVAMR(JaxRulesConfig(**kw)),
                          list(zip(jnp.asarray(xs), jnp.asarray(ys)))).run()
    got = PrequentialEvaluation(
        _port("VAMR", kw),
        list(zip(torch.from_numpy(xs), torch.from_numpy(ys)))).run()
    assert got.metric == want.metric
    assert got.curve == want.curve
    _assert_state_equal(state_to_numpy(got.extra["state"]),
                        _np(want.extra["state"]))


def test_detector_bank_update_and_reset_match_jax():
    """DetectorBank("ph_ema"): the batched update (with the ``has`` mask)
    and the masked reset, jitted in JAX as the learners run them."""
    rng = np.random.RandomState(0)
    n = 16
    cfg = dict(alpha=0.005, lam=0.3)
    jb = JaxDetectorBank("ph_ema", n, JaxPhEmaConfig(**cfg))
    pb = DetectorBank("ph_ema", n, PhEmaConfig(**cfg), device=CPU)
    js, ps = jb.init(), pb.init()
    _assert_state_equal(state_to_numpy(ps), _np(js))
    update, reset = jax.jit(jb.update), jax.jit(jb.reset)
    drifts = 0
    for t in range(30):
        x = rng.uniform(size=n).astype(np.float32) * (1 + t / 10)
        has = rng.uniform(size=n) < 0.7
        js, jd = update(js, x, has)
        ps, pd = pb.update(ps, torch.from_numpy(x), torch.from_numpy(has))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        drifts += int(pd.sum())
        _assert_state_equal(state_to_numpy(ps), _np(js))
        if t % 7 == 6:
            mask = np.asarray(jd) | (rng.uniform(size=n) < 0.2)
            js = reset(js, mask)
            ps = pb.reset(ps, torch.from_numpy(mask))
            _assert_state_equal(state_to_numpy(ps), _np(js))
    assert drifts > 0                             # drift really fired


def test_config_refuses_what_the_port_does_not_have():
    with pytest.raises(ValueError, match="stats_impl"):
        RulesConfig(n_attrs=4, stats_impl="pallas")
    with pytest.raises(ValueError, match="detector"):
        RulesConfig(n_attrs=4, detector_impl="adwin")
    with pytest.raises(ValueError, match="family"):
        DetectorBank("cusum", 4)
    rc = dataclasses.replace(RulesConfig(n_attrs=4), delay=0)
    assert VAMR(rc, device=CPU).rc.delay == 1
    assert HAMR(rc, device=CPU).rc.delay == 1
