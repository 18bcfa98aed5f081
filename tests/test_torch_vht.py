"""The port's VHT prequential path against the JAX package, on the CPU.

The same streams (made by the JAX package's own generators, passed on as
numpy arrays) go through ``repro`` and ``repro_torch``.  On CPU tensors the
port runs the plain versions of its kernels.  Every weight on the VHT path
is 0 or 1, so every counter is an integer-valued float and the comparison
is exact: per-batch metrics, the final tree and every state leaf.
"""

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
from repro.core.evaluation import stack_outputs as jax_stack_outputs
from repro.data.generators import RandomTreeGenerator, bin_numeric
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import VHT as JaxVHT
from repro.ml.vht import VHTConfig as JaxVHTConfig
from repro.ml.vht import build_vht_topology as jax_build_vht_topology
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engines import LocalEngine, StreamEngine
from repro_torch.core.evaluation import PrequentialEvaluation, stack_outputs
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig, build_vht_topology

CPU = "cpu"
N_BATCHES, BATCH = 30, 128
# (name, n_cat, n_num, depth) as benchmarks/vht_benchmarks.py builds them
STREAMS = {"dense-10-10": (10, 10, 6), "dense-100-100": (100, 100, 8)}
# (name, TreeConfig overrides): the local, wok (D=4) and wk(256) variants,
# and wok with the split checks ungated (fig89's "before" arm)
VARIANTS = {"local": {}, "wok": {"split_delay": 4},
            "wk256": {"split_delay": 4, "buffer_size": 256},
            "wok-ungated": {"split_delay": 4, "gate_splits": False}}
# the keys of the tree that the issue's parity statement names
TREE_KEYS = ("split_attr", "split_bin", "children", "n_nodes")

_CACHE = {}


def _stream(name):
    """[T, B, m] i32 bins and [T, B] i32 labels, made as
    benchmarks/common.py::make_stream makes them (the sampler jitted, as
    StreamPipeline jits it)."""
    if name not in _CACHE:
        n_cat, n_num, depth = STREAMS[name]
        gen = RandomTreeGenerator(n_cat=n_cat, n_num=n_num, depth=depth)
        sample = jax.jit(gen.sample, static_argnums=(1,))
        key = jax.random.PRNGKey(0)
        xs, ys = [], []
        for _ in range(N_BATCHES):
            key, k = jax.random.split(key)
            x, y = sample(k, BATCH)
            xs.append(np.asarray(bin_numeric(x, 8), np.int32))
            ys.append(np.asarray(y, np.int32))
        _CACHE[name] = (np.stack(xs), np.stack(ys))
    return _CACHE[name]


def _tc_kwargs(stream, variant):
    n_cat, n_num, _ = STREAMS[stream]
    return dict(n_attrs=n_cat + n_num, n_bins=8, n_classes=2, max_nodes=255,
                n_min=200, **VARIANTS[variant])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want, keys=None, path=""):
    """Nested dicts of arrays: same keys, dtypes and values."""
    keys = keys if keys is not None else sorted(want)
    assert set(got) == set(want), path
    for k in keys:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], path=f"{path}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (f"{path}/{k}", g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _jax_run(stream, variant):
    key = ("run", stream, variant)
    if key not in _CACHE:
        xs, ys = _stream(stream)
        vht = JaxVHT(JaxVHTConfig(JaxTreeConfig(**_tc_kwargs(stream, variant))))
        st, ms = jax.jit(vht.run)(vht.init(), jnp.asarray(xs), jnp.asarray(ys))
        _CACHE[key] = (_np(st), _np(ms))
    return _CACHE[key]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_vht_run_bit_identical_to_jax(stream, variant):
    xs, ys = _stream(stream)
    want_state, want_m = _jax_run(stream, variant)
    vht = VHT(VHTConfig(TreeConfig(**_tc_kwargs(stream, variant))), device=CPU)
    state, m = vht.run(vht.init(), torch.from_numpy(xs), torch.from_numpy(ys))
    got_state, got_m = state_to_numpy(state), state_to_numpy(m)
    for k in ("correct", "dropped", "n_nodes", "seen"):
        np.testing.assert_array_equal(got_m[k], want_m[k], err_msg=k)
    _assert_tree_equal(got_state, want_state, TREE_KEYS)
    _assert_tree_equal(got_state, want_state)   # stats, class_counts, all
    assert int(want_state["n_nodes"]) > 1      # the tree grew
    if variant.startswith("wok"):
        assert want_m["dropped"].sum() > 0     # and load was shed


def test_vht_continues_from_a_jax_state():
    """Both packages resume from one mid-stream state (carried over with
    state_from_numpy) and stay identical; the caller's state is left as it
    was by ``run``."""
    xs, ys = _stream("dense-10-10")
    kw = _tc_kwargs("dense-10-10", "wk256")
    jvht = JaxVHT(JaxVHTConfig(JaxTreeConfig(**kw)))
    run = jax.jit(jvht.run)
    half = N_BATCHES // 2
    mid, _ = run(jvht.init(), jnp.asarray(xs[:half]), jnp.asarray(ys[:half]))
    want, want_m = run(mid, jnp.asarray(xs[half:]), jnp.asarray(ys[half:]))

    vht = VHT(VHTConfig(TreeConfig(**kw)), device=CPU)
    start = state_from_numpy(_np(mid), CPU)
    before = state_to_numpy(start)
    got, got_m = vht.run(start, torch.from_numpy(xs[half:]),
                         torch.from_numpy(ys[half:]))
    _assert_tree_equal(state_to_numpy(got), _np(want))
    for k in ("correct", "n_nodes"):
        np.testing.assert_array_equal(got_m[k].numpy(), np.asarray(want_m[k]))
    _assert_tree_equal(state_to_numpy(start), before)


def _payloads(xs, ys):
    return [{"x": x, "y": y} for x, y in zip(xs, ys)]


PREFIX = 25        # JitEngine steps before the root splits (at step 26)


def _jax_jit_engine(stream):
    """JitEngine.run_stream on the MA/LS topology: the carry after PREFIX
    steps, and the carry and stacked outputs after all N_BATCHES."""
    key = ("jit", stream)
    if key not in _CACHE:
        xs, ys = _stream(stream)
        kw = _tc_kwargs(stream, "local")
        topo = jax_build_vht_topology(JaxVHTConfig(JaxTreeConfig(**kw)))
        eng = JitEngine()
        carry, head = eng.run_stream(
            topo, eng.init(topo, jax.random.PRNGKey(0)),
            {"x": jnp.asarray(xs[:PREFIX]), "y": jnp.asarray(ys[:PREFIX])})
        mid = _np(carry)
        carry, tail = eng.run_stream(
            topo, carry,
            {"x": jnp.asarray(xs[PREFIX:]), "y": jnp.asarray(ys[PREFIX:])})
        outs = jax.tree.map(lambda a, b: np.concatenate([a, b]),
                            _np(head), _np(tail))
        _CACHE[key] = (mid, _np(carry), outs)
    return _CACHE[key]


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_topology_local_engine_matches_jax(stream):
    """The MA/LS topology of Figure 2 on the LocalEngine (feedback within
    the step) against the JAX LocalEngine.  The JAX LocalEngine runs
    eagerly and slowly, so both start from the states that JitEngine
    reaches after PREFIX steps (carried over with state_from_numpy) and
    run the last steps, in which the root splits."""
    xs, ys = _stream(stream)
    kw = _tc_kwargs(stream, "local")
    start = _jax_jit_engine(stream)[0]["states"]
    jtopo = jax_build_vht_topology(JaxVHTConfig(JaxTreeConfig(**kw)))
    jstates, jouts = JaxLocalEngine().run_stream(
        jtopo, jax.tree.map(jnp.asarray, start),
        _payloads(jnp.asarray(xs[PREFIX:]), jnp.asarray(ys[PREFIX:])))

    topo = build_vht_topology(VHTConfig(TreeConfig(**kw)), device=CPU)
    eng = LocalEngine()
    init = state_from_numpy(start, CPU)
    states, outs = eng.run_stream(
        topo, init, _payloads(torch.from_numpy(xs[PREFIX:]),
                              torch.from_numpy(ys[PREFIX:])))
    _assert_tree_equal(state_to_numpy(stack_outputs(outs))["prediction"],
                       _np(jax_stack_outputs(jouts))["prediction"])
    _assert_tree_equal(state_to_numpy(states), _np(jstates))
    assert (int(jstates["model-aggregator"]["n_nodes"])
            > int(start["model-aggregator"]["n_nodes"]))        # a split
    _assert_tree_equal(state_to_numpy(init), start)
    assert not eng.init(topo)["local-statistic"]["stats"].any()


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_topology_stream_engine_matches_jit_engine(stream):
    """The MA/LS topology on the StreamEngine (feedback next step, first
    step primes the carry) against JitEngine.run_stream."""
    xs, ys = _stream(stream)
    _, want, want_outs = _jax_jit_engine(stream)
    topo = build_vht_topology(
        VHTConfig(TreeConfig(**_tc_kwargs(stream, "local"))), device=CPU)
    eng = StreamEngine()
    init = eng.init(topo)
    carry, outs = eng.run_stream(
        topo, init, {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
    _assert_tree_equal(state_to_numpy(outs)["prediction"],
                       want_outs["prediction"])
    _assert_tree_equal(state_to_numpy(carry), want)
    assert int(want["states"]["model-aggregator"]["n_nodes"]) > 1
    assert init["feedback"] is None
    assert not init["states"]["local-statistic"]["stats"].any()


def test_prequential_evaluation_curves_match_jax():
    xs, ys = _stream("dense-100-100")
    kw = _tc_kwargs("dense-100-100", "wok")
    jres = JaxPrequential(JaxVHT(JaxVHTConfig(JaxTreeConfig(**kw))),
                          list(zip(jnp.asarray(xs), jnp.asarray(ys)))).run()
    res = PrequentialEvaluation(
        VHT(VHTConfig(TreeConfig(**kw)), device=CPU),
        list(zip(torch.from_numpy(xs), torch.from_numpy(ys)))).run()
    assert res.curve == jres.curve
    assert res.metric == jres.metric
    assert len(res.curve) == N_BATCHES - 1      # batch 0 is left out
    _assert_tree_equal(state_to_numpy(res.extra["state"]),
                       _np(jres.extra["state"]))


def test_state_numpy_round_trip_keeps_dtypes():
    kw = _tc_kwargs("dense-10-10", "wk256")
    jstate = _np(JaxVHT(JaxVHTConfig(JaxTreeConfig(**kw))).init())
    state = state_from_numpy(jstate, CPU)
    want = {np.dtype(np.float32): torch.float32,
            np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}
    for k, v in jstate.items():
        assert state[k].dtype == want[v.dtype], k
    _assert_tree_equal(state_to_numpy(state), jstate)
    _assert_tree_equal(state_to_numpy(VHT(VHTConfig(TreeConfig(**kw)),
                                          device=CPU).init()), jstate)
    with pytest.raises(TypeError):
        state_from_numpy({"x": np.zeros(3)}, CPU)         # float64
    with pytest.raises(TypeError):
        state_from_numpy({"x": np.zeros(3, np.int64)}, CPU)
