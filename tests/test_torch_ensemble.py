"""The port's ensembles against the JAX package, on the CPU, bit for bit:
OzaBag and OzaBoost (``repro_torch.ml.ensemble``) with each detector
family and none, and the pooled and per-member split checks, from
``PRNGKey(0)``; the horizontal ``ShardingEnsemble`` at p = 2 and 4; both
through ``PrequentialEvaluation``, with a short last batch; and their
states carried across with ``convert``.

The streams are the JAX generators' (numpy arrays given to both).  The
members' weights are JAX's Poisson draws, reproduced by the port's PRNG,
so every counter is the same integer-valued float in both packages:
per-batch ``correct``, ``seen`` and ``drifts``, every tree leaf, every
detector leaf and the key are compared exactly.
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

from repro.core.evaluation import PrequentialEvaluation as JaxPrequential
from repro.data.generators import RandomTreeGenerator, bin_numeric
from repro.ml.ensemble import EnsembleConfig as JaxEnsembleConfig
from repro.ml.ensemble import OzaEnsemble as JaxOzaEnsemble
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import ShardingEnsemble as JaxShardingEnsemble
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import prng
from repro_torch.core.evaluation import PrequentialEvaluation
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import ShardingEnsemble

CPU = "cpu"
T, B, M = 20, 128, 3
TREE = dict(n_attrs=20, n_bins=8, n_classes=2, max_nodes=63, n_min=50)
# (boost, detector, split_check): each family and none, with bagging and
# boosting, and each split check
CASES = [(False, "adwin", "pool"), (False, "ddm", "member"),
         (False, "eddm", "pool"), (False, "ph", "member"),
         (False, "none", "pool"), (True, "adwin", "member"),
         (True, "ddm", "pool"), (True, "eddm", "member"),
         (True, "ph", "pool")]
METRICS = ("correct", "seen", "drifts")
# the concept switch: two hidden trees of other seeds, switched halfway;
# a concept the trees learn within 30 batches, so DDM sees the switch
SWITCH = dict(T=60, B=64, m=4, depth=2, seeds=(7, 11))
SWITCH_TREE = dict(n_attrs=4, n_bins=8, n_classes=2, max_nodes=63, n_min=20)

_CACHE = {}


def _stream(T=T, B=B, m=20, depth=3, seeds=(7,), switch_at=None):
    """[T, B, m] i32 bins and [T, B] i32 labels from the JAX generator (the
    second seed's from ``switch_at`` on)."""
    key = ("stream", T, B, m, depth, seeds, switch_at)
    if key not in _CACHE:
        gens = [jax.jit(RandomTreeGenerator(n_cat=m // 2, n_num=m - m // 2,
                                            depth=depth, seed=s).sample,
                        static_argnums=(1,)) for s in seeds]
        rk = jax.random.PRNGKey(1)
        xs, ys = [], []
        for t in range(T):
            rk, k = jax.random.split(rk)
            gen = gens[1 if switch_at is not None and t >= switch_at else 0]
            x, y = gen(k, B)
            xs.append(np.asarray(bin_numeric(x, 8), np.int32))
            ys.append(np.asarray(y, np.int32))
        _CACHE[key] = (np.stack(xs), np.stack(ys))
    return _CACHE[key]


def _switch_stream():
    s = SWITCH
    return _stream(s["T"], s["B"], s["m"], s["depth"], s["seeds"],
                   switch_at=s["T"] // 2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_equal(got, want, path="state"):
    """Nested dicts of arrays (None allowed): same keys, dtypes and bits."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
    if w.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=path)


def _configs(boost, detector, split_check, tree=TREE, **kw):
    jec = JaxEnsembleConfig(JaxTreeConfig(**tree), n_members=M, boost=boost,
                            detector=detector, split_check=split_check, **kw)
    ec = EnsembleConfig(TreeConfig(**tree), n_members=M, boost=boost,
                        detector=detector, split_check=split_check, **kw)
    return jec, ec


def _jax_halves(name, learner, start, xs, ys):
    """The JAX learner's run over the stream in two halves, with one
    compiled ``run`` (the halves have one shape): (the state after the
    first half, the final state, the second half's metrics, the metrics of
    the whole run).  Kept per learner, so that a test resuming from the
    middle takes the run another test made."""
    key = ("jax", name, xs.shape)
    if key not in _CACHE:
        run = jax.jit(learner.run)
        h = xs.shape[0] // 2
        mid, m1 = run(start, jnp.asarray(xs[:h]), jnp.asarray(ys[:h]))
        end, m2 = run(mid, jnp.asarray(xs[h:]), jnp.asarray(ys[h:]))
        m1, m2 = _np(m1), _np(m2)
        _CACHE[key] = (_np(mid), _np(end), m2,
                       {k: np.concatenate([m1[k], m2[k]]) for k in m1})
    return _CACHE[key]


def _jax_run(jec, xs, ys):
    ens = JaxOzaEnsemble(jec)
    _, st, _, ms = _jax_halves(jec, ens, ens.init(jax.random.PRNGKey(0)),
                               xs, ys)
    return st, ms


def _jax_sharding(p, xs, ys):
    jse = JaxShardingEnsemble(JaxTreeConfig(**TREE), p)
    return _jax_halves(("sharding", p), jse, jse.init(), xs, ys)


def _port_run(ec, xs, ys):
    ens = OzaEnsemble(ec, device=CPU)
    st, ms = ens.run(ens.init(prng.PRNGKey(0, CPU)), torch.from_numpy(xs),
                     torch.from_numpy(ys))
    return state_to_numpy(st), state_to_numpy(ms)


@pytest.mark.parametrize("boost,detector,split_check", CASES,
                         ids=lambda v: {False: "bag", True: "boost"}.get(v, v)
                         if isinstance(v, bool) else v)
def test_ensemble_run_bit_identical_to_jax(boost, detector, split_check):
    xs, ys = _stream()
    jec, ec = _configs(boost, detector, split_check)
    want_state, want_m = _jax_run(jec, xs, ys)
    got_state, got_m = _port_run(ec, xs, ys)
    for k in METRICS:
        _assert_equal(got_m[k], want_m[k], k)
    _assert_equal(got_state, want_state)
    assert got_state["key"].dtype == np.uint32
    assert want_state["trees"]["n_nodes"].sum() > M    # the members grew


@pytest.mark.parametrize("boost", [False, True], ids=["bag", "boost"])
def test_gated_checks_equal_the_ungated_oracle(boost):
    """The pooled check (a tile of 4, so that the full fallback runs too)
    and the per-member check give the ungated run's state and metrics."""
    xs, ys = _stream()
    tree = dict(TREE, check_tile=4)
    _, oracle = _configs(boost, "adwin", "pool", tree, gate_members=False)
    want_state, want_m = _port_run(oracle, xs, ys)
    for ec in (dataclasses.replace(oracle, gate_members=True),
               dataclasses.replace(oracle, gate_members=True,
                                   split_check="member")):
        got_state, got_m = _port_run(ec, xs, ys)
        _assert_equal(got_m, want_m, "metrics")
        _assert_equal(got_state, want_state)


def test_concept_switch_drift_resets_members_as_jax_does():
    """Two hidden trees switched halfway: DDM flags drifts, the drifted
    members are reset to fresh trees, and all of it bit for bit the JAX
    package's."""
    xs, ys = _switch_stream()
    jec, ec = _configs(False, "ddm", "pool", SWITCH_TREE)
    want_state, want_m = _jax_run(jec, xs, ys)
    got_state, got_m = _port_run(ec, xs, ys)
    assert want_m["drifts"].sum() > 0
    for k in METRICS:
        _assert_equal(got_m[k], want_m[k], k)
    _assert_equal(got_state, want_state)


@pytest.mark.parametrize("p", [2, 4])
def test_sharding_ensemble_bit_identical_to_jax(p):
    xs, ys = _stream()
    _, want_state, _, want_m = _jax_sharding(p, xs, ys)
    se = ShardingEnsemble(TreeConfig(**TREE), p, device=CPU)
    state, m = se.run(se.init(), torch.from_numpy(xs), torch.from_numpy(ys))
    for k in ("correct", "seen", "dropped", "n_nodes"):
        _assert_equal(m[k].numpy(), want_m[k], k)
    _assert_equal(state_to_numpy(state), want_state)
    assert int(want_state["n_nodes"].sum()) > p


def _short_last_batch():
    """The stream's batches, the last one cut to 40 of B rows."""
    xs, ys = _stream()
    batches = [(xs[t], ys[t]) for t in range(T)]
    batches[-1] = (xs[-1][:40], ys[-1][:40])
    return batches


LEARNERS = {
    "ozabag": (lambda: JaxOzaEnsemble(_configs(False, "adwin", "pool")[0]),
               lambda: OzaEnsemble(_configs(False, "adwin", "pool")[1],
                                   device=CPU)),
    "sharding-2": (lambda: JaxShardingEnsemble(JaxTreeConfig(**TREE), 2),
                   lambda: ShardingEnsemble(TreeConfig(**TREE), 2,
                                            device=CPU))}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_prequential_evaluation_with_a_short_last_batch_matches_jax(name):
    """``PrequentialEvaluation`` (compiled, its default, and eager) gives
    the learner ``PRNGKey(0)`` and takes a last batch of another shape,
    as the JAX package's (``jax.jit`` traces again)."""
    make_jax, make_port = LEARNERS[name]
    batches = _short_last_batch()
    want = JaxPrequential(make_jax(), [(jnp.asarray(x), jnp.asarray(y))
                                       for x, y in batches]).run()
    port_batches = [(torch.from_numpy(x), torch.from_numpy(y))
                    for x, y in batches]
    for compiled in (True, False):
        got = PrequentialEvaluation(make_port(), port_batches,
                                    compiled=compiled).run()
        assert got.curve == want.curve and got.metric == want.metric
        _assert_equal(state_to_numpy(got.extra["state"]),
                      _np(want.extra["state"]))


@pytest.mark.parametrize("kind", ["ozaboost", "sharding"])
def test_states_carry_across_and_resume_as_jax(kind):
    """A JAX mid-stream state (stacked trees, the detector bank, the uint32
    key) goes to the port with ``state_from_numpy`` and back with
    ``state_to_numpy`` unchanged; both packages resume from it alike."""
    xs, ys = _stream()
    half = T // 2
    if kind == "ozaboost":
        jec, ec = _configs(True, "eddm", "member")
        tl = OzaEnsemble(ec, device=CPU)
        jl = JaxOzaEnsemble(jec)
        mid, want, want_m, _ = _jax_halves(
            jec, jl, jl.init(jax.random.PRNGKey(0)), xs, ys)
    else:
        tl = ShardingEnsemble(TreeConfig(**TREE), 4, device=CPU)
        mid, want, want_m, _ = _jax_sharding(4, xs, ys)
    carried = state_from_numpy(mid, CPU)
    _assert_equal(state_to_numpy(carried), mid)
    got, got_m = tl.run(carried, torch.from_numpy(xs[half:]),
                        torch.from_numpy(ys[half:]))
    _assert_equal(state_to_numpy(got), want)
    _assert_equal(state_to_numpy(got_m), want_m, "metrics")
    _assert_equal(state_to_numpy(carried), mid)    # run left it


def test_the_port_takes_only_its_own_router_and_known_options():
    """The port routes with its ``tree_route`` kernel and updates the
    detectors as one bank: the JAX package's ``route_impl`` and
    ``detector_impl`` are no options of its config."""
    tc = TreeConfig(n_attrs=4)
    for field in ("route_impl", "detector_impl"):
        with pytest.raises(TypeError, match=field):
            EnsembleConfig(tc, **{field: "pallas"})
    with pytest.raises(ValueError, match="split check"):
        OzaEnsemble(EnsembleConfig(tc, split_check="tile"), device=CPU)
