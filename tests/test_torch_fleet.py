"""The port's learner fleets (src/repro_torch/ml/fleet.py) against the JAX
package's ``LearnerFleet`` on the CPU, on the same inputs: the small
configurations of tests/test_fleet.py (TreeConfig(12 attributes, 8 bins,
63 nodes, n_min 20), CluStreamConfig(12 dims, 16 micro-clusters, 3 macro,
period 2B), B = 16, per-tenant RandomTreeGenerator streams from
PRNGKey(100 + f)), F <= 4 tenants, T <= 6 steps, chunk_len 2.

Tolerances: VHT fleet state rows, cursor and ``[steps, F]`` metric
columns bit for bit; CluStream's cluster features (n, ls, ss, lt, st),
clock and counts bit for bit, its macro centroids within rtol 1e-6 and
its ssq metric within rtol 2e-6 (batched float32 products, as in
tests/test_torch_clustream.py).  The kernels' fleet forms are held to
their plain versions composed tenant by tenant, exactly (integers, and
sums in instance order).  One JAX run of each family is shared through
module-scoped fixtures."""

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.engines import JitEngine as JaxJitEngine
from repro.core.evaluation import \
    ChunkedPrequentialEvaluation as JaxChunkedEval
from repro.data.generators import RandomTreeGenerator as JaxTreeGen
from repro.data.generators import bin_numeric as jax_bin
from repro.data.pipeline import ChunkedStream as JaxChunkedStream
from repro.ml import CluStream as JaxCluStream
from repro.ml import CluStreamConfig as JaxCluStreamConfig
from repro.ml import LearnerFleet as JaxFleet
from repro.ml import VHT as JaxVHT
from repro.ml import VHTConfig as JaxVHTConfig
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.serving import model_state_of as jax_model_state_of

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import fleet_state_from_numpy, state_to_numpy
from repro_torch.core import prng
from repro_torch.core.engines import JitEngine, LocalEngine
from repro_torch.core.evaluation import (ChunkedPrequentialEvaluation,
                                         MetricAccumulator, stack_outputs)
from repro_torch.data.pipeline import ChunkedStream
from repro_torch.kernels.rule_stats.ops import (batch_sum, batch_sum_tenant,
                                                segment_sum_tenant)
from repro_torch.kernels.rule_stats.ref import (rule_stats_scatter_ref,
                                                segment_sum_tenant_ref)
from repro_torch.kernels.tree_route.ops import (tree_route_batched,
                                                tree_route_rows)
from repro_torch.kernels.tree_route.ref import (tree_route_batched_ref,
                                                tree_route_ref,
                                                tree_route_rows_ref)
from repro_torch.ml import (AMRules, HAMR, VAMR, CluStream, CluStreamConfig,
                            EnsembleConfig, LearnerFleet, OzaEnsemble,
                            RulesConfig, VHT, VHTConfig, stack_payloads)
from repro_torch.ml.htree import TreeConfig
from repro_torch.serving import (ModelServer, ServeConfig, SnapshotPublisher,
                                 make_predict_fn, model_state_of,
                                 reference_predict, tenant_state_of)

B, T_MAX, F_MAX, C_LEN = 16, 6, 4, 2
CPU = "cpu"
TC = dict(n_attrs=12, n_bins=8, n_classes=2, max_nodes=63, n_min=20,
          delta=0.05, tau=0.1)
CC = dict(n_dims=12, n_micro=16, n_macro=3, period=2 * B)
# TC's trees barely split in 6 batches of 16; these split from the
# second batch on (the Hoeffding bound under tau: any positive gain)
GROW = dict(n_min=8, tau=0.5)
CF_KEYS = ("n", "ls", "ss", "lt", "st", "t", "macro_t")
KEY_SEED = 7


def _tenant_stream(f):
    """Tenant f's own stream (test_fleet.py's), T_MAX batches as numpy."""
    gen = JaxTreeGen(n_cat=6, n_num=6, depth=5, seed=3)
    key = jax.random.PRNGKey(100 + f)
    xs, ys = [], []
    for _ in range(T_MAX):
        key, k = jax.random.split(key)
        x, y = gen.sample(k, B)
        xs.append(jax_bin(x, 8))
        ys.append(y)
    return (np.asarray(jnp.stack(xs)).astype(np.int32),
            np.asarray(jnp.stack(ys)).astype(np.int32))


STREAMS = [_tenant_stream(f) for f in range(F_MAX)]


def _payload(family, f, t):
    xs, ys = STREAMS[f]
    if family == "clustream":
        return {"x": xs[:t].astype(np.float32)}
    return {"x": xs[:t], "y": ys[:t]}


def _fleet_payload(family, n, t):
    """numpy [T, F, B, ...] payload of tenants 0 .. n-1."""
    per = [_payload(family, f, t) for f in range(n)]
    return {k: np.stack([p[k] for p in per], 1) for k in per[0]}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _port_learner(family, **kw):
    if family == "vht":
        return VHT(VHTConfig(TreeConfig(**{**TC, **kw})), device=CPU)
    return CluStream(CluStreamConfig(**{**CC, **kw}), device=CPU)


def _jax_learner(family, **kw):
    if family == "vht":
        return JaxVHT(JaxVHTConfig(JaxTreeConfig(**{**TC, **kw})))
    return JaxCluStream(JaxCluStreamConfig(**{**CC, **kw}))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what=""):
    """Every leaf bit for bit (float leaves compared as bits)."""
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k], f"{what}{k}.")
            continue
        np.testing.assert_array_equal(_bits(_np(got[k])), _bits(want[k]),
                                      err_msg=f"{what}{k}")


def _assert_clustream(got, want, what=""):
    """CF leaves bit for bit; the macro centroids within rtol 1e-6."""
    for k in CF_KEYS:
        np.testing.assert_array_equal(_bits(_np(got[k])), _bits(want[k]),
                                      err_msg=f"{what} {k}")
    np.testing.assert_allclose(_np(got["macro"]), want["macro"], rtol=1e-6,
                               atol=1e-6, err_msg=f"{what} macro")


def _jax_key():
    return jax.random.PRNGKey(KEY_SEED)


def _port_key():
    return prng.PRNGKey(KEY_SEED, CPU)


def _jax_run(family, n, t, **kw):
    fleet = JaxFleet(_jax_learner(family, **kw), n)
    eng = JaxJitEngine()
    carry = eng.init(fleet, _jax_key())
    carry, outs = eng.run_stream(
        fleet, carry, jax.tree.map(jnp.asarray, _fleet_payload(family, n, t)),
        chunk_len=C_LEN)
    return (jax.tree.map(np.asarray, jax_model_state_of(carry)),
            jax.tree.map(np.asarray, outs["metrics"]))


def _port_run(fleet, family, n, t):
    eng = JitEngine()
    carry = eng.init(fleet, _port_key())
    carry, outs = eng.run_stream(fleet, carry,
                                 _torch(_fleet_payload(family, n, t)),
                                 chunk_len=C_LEN)
    return model_state_of(carry), outs["metrics"]


ARMS = {"vht": ("vht", {}), "vht-grow": ("vht", GROW),
        "clustream": ("clustream", {}),
        "clustream-boundary": ("clustream", {"macro_impl": "boundary"})}


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX package's fleet runs, one compile each: each arm at F = 3,
    T = 4, and VHT's ChunkedPrequentialEvaluation (metric and curve)."""
    out = {arm: _jax_run(family, 3, 4, **kw)
           for arm, (family, kw) in ARMS.items()}
    r = JaxChunkedEval(JaxFleet(_jax_learner("vht"), 3), JaxChunkedStream(
        jax.tree.map(jnp.asarray, _fleet_payload("vht", 3, 4)), C_LEN,
        to_device=False)).run()
    out["vht-eval"] = (np.asarray(r.metric), np.asarray(r.curve))
    return out


@pytest.fixture(scope="module")
def port_fleets():
    """The port's runs of the same arms (F = 3, T = 4)."""
    out = {}
    for arm, (family, kw) in ARMS.items():
        fleet = LearnerFleet(_port_learner(family, **kw), 3)
        out[arm] = (fleet,) + _port_run(fleet, family, 3, 4)
    return out


# ---------------------------------------------------------------- fleets

@pytest.mark.parametrize("family", ["vht", "clustream"])
def test_init_rows_match_jax_and_separate_init(family):
    """Row f of the packed init is the single learner's init from row f
    of ``tenant_keys``, and the JAX fleet's row f, bit for bit."""
    fleet = LearnerFleet(_port_learner(family), 3)
    jfleet = JaxFleet(_jax_learner(family), 3)
    packed = fleet.init(prng.PRNGKey(42, CPU))
    jpacked = jax.tree.map(np.asarray, jfleet.init(jax.random.PRNGKey(42)))
    assert packed["cursor"].dtype == torch.int32
    _assert_same(packed, jpacked)
    keys = fleet.tenant_keys(prng.PRNGKey(42, CPU))
    for f in range(3):
        _assert_same(fleet.tenant_state(packed, f),
                     state_to_numpy(fleet.learner.init(keys[f])))


@pytest.mark.parametrize("arm", ["vht", "vht-grow"])
def test_vht_fleet_matches_jax_bit_for_bit(jax_fleets, port_fleets, arm):
    """The chunked run of a 3-tenant VHT fleet: every state row, the
    cursor and every [steps, F] metric column equal the JAX fleet's; with
    TC the trees stay single leaves for 4 batches, with GROW they split."""
    _, state, metrics = port_fleets[arm]
    jstate, jmetrics = jax_fleets[arm]
    _assert_same(state, jstate)
    np.testing.assert_array_equal(_np(state["cursor"]), [4, 4, 4])
    assert metrics["correct"].shape == (4, 3)
    _assert_same(metrics, jmetrics)
    if arm == "vht-grow":
        assert int(state["tenant"]["n_nodes"].min()) > 1


@pytest.mark.parametrize("arm", ["clustream", "clustream-boundary"])
def test_clustream_fleet_matches_jax(jax_fleets, port_fleets, arm):
    """Step and boundary mode: CF leaves bit for bit, macro centroids
    within rtol 1e-6, seen and n_active exactly, ssq within rtol 2e-6."""
    _, state, metrics = port_fleets[arm]
    jstate, jmetrics = jax_fleets[arm]
    _assert_clustream(state["tenant"], jstate["tenant"], arm)
    np.testing.assert_array_equal(_np(state["cursor"]), jstate["cursor"])
    for k in ("seen", "n_active"):
        np.testing.assert_array_equal(_np(metrics[k]), jmetrics[k])
    np.testing.assert_allclose(_np(metrics["ssq"]), jmetrics["ssq"],
                               rtol=2e-6)
    assert float(state["tenant"]["macro_t"].min()) > 0    # macro ran


def _separate(fleet, f, t, key):
    """Tenant f's learner alone on its own stream, from the fleet's init
    of that tenant (the engine splits ``key`` first), through the chunked
    engine."""
    learner = fleet.learner
    eng = JitEngine()
    carry = eng.init(learner, key)
    name = next(iter(carry["states"]))
    carry["states"][name] = learner.init(
        fleet.tenant_keys(prng.split(key, 1)[0])[f])
    family = "vht" if isinstance(learner, VHT) else "clustream"
    carry, outs = eng.run_stream(learner, carry,
                                 _torch(_payload(family, f, t)),
                                 chunk_len=C_LEN)
    return model_state_of(carry), outs["metrics"]


VARIANTS = {"vht-local": ("vht", GROW),
            "vht-wok": ("vht", {**GROW, "split_delay": 2}),
            "vht-wk8": ("vht", {**GROW, "split_delay": 2, "buffer_size": 8}),
            "clustream-onehot": ("clustream", {"stats_impl": "onehot"})}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fleet_rows_equal_separate_runs(variant):
    """F = 4, T = 6: each tenant's row and metric column equal its own
    single-learner run on the port, bit for bit (CluStream: CF leaves,
    macro rtol 1e-6, ssq rtol 2e-6), in the variants the JAX fleet test
    does not run: wok, wk(z) and CluStream's one-hot statistics."""
    family, kw = VARIANTS[variant]
    fleet = LearnerFleet(_port_learner(family, **kw), F_MAX)
    state, metrics = _port_run(fleet, family, F_MAX, T_MAX)
    for f in range(F_MAX):
        alone, m = _separate(fleet, f, T_MAX, _port_key())
        row = fleet.tenant_state(state, f)
        if family == "vht":
            _assert_same(row, state_to_numpy(alone), f"tenant {f} ")
            _assert_same({k: v[:, f] for k, v in metrics.items()},
                         state_to_numpy(m), f"tenant {f} metrics ")
        else:
            _assert_clustream(row, state_to_numpy(alone), f"tenant {f}")
            np.testing.assert_allclose(_np(metrics["ssq"][:, f]),
                                       _np(m["ssq"]), rtol=2e-6)
    if family == "vht":
        assert int(state["tenant"]["n_splits"].sum()) > 0


def test_fleet_on_local_engine_equals_jit_engine(port_fleets):
    """The eager oracle (LocalEngine's chunked loop, boundary hook fired
    between chunks) and JitEngine's compiled steps give the same fleet."""
    for arm in ("vht", "clustream-boundary"):
        fleet, state, metrics = port_fleets[arm]
        family = ARMS[arm][0]
        eng = LocalEngine()
        states = eng.init(fleet, _port_key())
        states, outs = eng.run_stream(fleet, states, ChunkedStream(
            _torch(_fleet_payload(family, 3, 4)), C_LEN, to_device=False))
        _assert_same(model_state_of({"states": states}),
                     state_to_numpy(state), arm + " ")
        _assert_same(stack_outputs(outs)["metrics"],
                     state_to_numpy(metrics), arm + " metrics ")


def test_fleet_cursor_ignores_padding_steps():
    """T = 5 in chunks of 2: the padded step advances no cursor."""
    fleet = LearnerFleet(_port_learner("vht"), 2)
    state, metrics = _port_run(fleet, "vht", 2, 5)
    np.testing.assert_array_equal(_np(state["cursor"]), [5, 5])
    assert metrics["seen"].shape == (5, 2)


def test_stack_unstack_and_payloads():
    learner = _port_learner("clustream")
    fleet = LearnerFleet(learner, 3)
    seps = [learner.init(k) for k in fleet.tenant_keys(_port_key())]
    packed = fleet.stack(seps, cursor=[4, 5, 6])
    np.testing.assert_array_equal(_np(packed["cursor"]), [4, 5, 6])
    back = fleet.unstack(packed)
    assert len(back) == 3
    for sep, b in zip(seps, back):
        _assert_same(b, state_to_numpy(sep))
    fp = stack_payloads([_torch(_payload("vht", f, 4)) for f in range(3)])
    assert fp["x"].shape == (4, 3, B, TC["n_attrs"])
    assert fp["y"].shape == (4, 3, B)
    np.testing.assert_array_equal(fp["x"].numpy(),
                                  _fleet_payload("vht", 3, 4)["x"])
    with pytest.raises(ValueError, match="at least one"):
        stack_payloads([])
    with pytest.raises(ValueError, match="expected 3 tenant states"):
        fleet.stack(seps[:2])
    bad = dict(seps[2])
    bad.pop("macro")
    with pytest.raises(ValueError, match="structure differs"):
        fleet.stack(seps[:2] + [bad])


def test_clustream_merge_matches_per_tenant_merge():
    """Merging two halves of a fleet run tenant by tenant equals merging
    each tenant's halves; the cursors add; VHT has no merge."""
    from repro_torch.ml.clustream import merge as clustream_merge
    fleet = LearnerFleet(_port_learner("clustream"), 2)
    pay = _torch(_fleet_payload("clustream", 2, 4))
    halves = []
    for lo, hi in ((0, 2), (2, 4)):
        eng = JitEngine()
        carry = eng.init(fleet, _port_key())
        carry, _ = eng.run_stream(fleet, carry,
                                  {k: v[lo:hi] for k, v in pay.items()},
                                  chunk_len=C_LEN)
        halves.append(model_state_of(carry))
    merged = fleet.merge(halves)
    np.testing.assert_array_equal(_np(merged["cursor"]), [4, 4])
    for f in range(2):
        want = clustream_merge([fleet.tenant_state(h, f) for h in halves])
        _assert_same(fleet.tenant_state(merged, f), state_to_numpy(want))
    vht = LearnerFleet(_port_learner("vht"), 2)
    with pytest.raises(TypeError, match="no merge"):
        vht.merge([vht.init(_port_key())])


def test_fleet_refusals():
    vht = _port_learner("vht")
    fleet = LearnerFleet(vht, 2)
    with pytest.raises(TypeError, match="do not nest"):
        LearnerFleet(fleet, 2)
    with pytest.raises(TypeError, match="no fleet support"):
        LearnerFleet(object(), 2)
    rc = RulesConfig(n_attrs=12, n_bins=8, max_rules=16, n_min=100)
    for learner in (OzaEnsemble(EnsembleConfig(tree=TreeConfig(**TC),
                                               n_members=3), device=CPU),
                    AMRules(rc, device=CPU), VAMR(rc, device=CPU),
                    HAMR(rc, device=CPU)):
        with pytest.raises(TypeError, match="item 8"):
            LearnerFleet(learner, 2)
    with pytest.raises(ValueError, match="n_tenants"):
        LearnerFleet(vht, 0)
    with pytest.raises(ValueError, match="outside"):
        fleet.tenant_state(fleet.init(_port_key()), 2)
    with pytest.raises(NotImplementedError, match="items 7 and 10"):
        fleet.state_sharding()
    assert not hasattr(fleet, "boundary")
    assert hasattr(LearnerFleet(_port_learner(
        "clustream", macro_impl="boundary"), 2), "boundary")


# ------------------------------------------------ evaluation and resume

def test_fleet_metric_columns_never_mix(jax_fleets):
    """ChunkedPrequentialEvaluation over a fleet: an [F] metric and a
    [T, F] curve, column f the JAX fleet evaluation's, equal to a single
    learner's MetricAccumulator on tenant f alone; the streams differ."""
    fleet = LearnerFleet(_port_learner("vht"), 3)
    r = ChunkedPrequentialEvaluation(fleet, ChunkedStream(
        _torch(_fleet_payload("vht", 3, 4)), C_LEN, to_device=False)).run()
    jmetric, jcurve = jax_fleets["vht-eval"]
    metric, curve = np.asarray(r.metric), np.asarray(r.curve)
    assert metric.shape == (3,) and curve.shape == (4, 3)
    np.testing.assert_array_equal(metric, jmetric)
    np.testing.assert_array_equal(curve, jcurve)
    for f in range(3):
        _, m = _separate(fleet, f, 4, prng.PRNGKey(0, CPU))
        acc = MetricAccumulator()
        acc.update(m)
        assert metric[f] == acc.metric
        np.testing.assert_array_equal(curve[:, f], acc.curve)
    assert len(set(np.round(metric, 12))) > 1


def test_accumulator_tenant_columns_round_trip():
    """[steps, F] leaves: a zero-weight column reads 0.0 (never NaN) and
    carries its curve forward; state()/load() round-trips the columns."""
    acc = MetricAccumulator()
    acc.update({"correct": torch.tensor([[3.0, 0.0], [2.0, 0.0]]),
                "seen": torch.tensor([[4.0, 0.0], [4.0, 0.0]])})
    np.testing.assert_array_equal(acc.metric, [5 / 8, 0.0])
    np.testing.assert_array_equal(np.asarray(acc.curve), [[0.75, 0.0],
                                                          [0.5, 0.0]])
    back = MetricAccumulator().load(acc.state())
    np.testing.assert_array_equal(back.metric, acc.metric)
    np.testing.assert_array_equal(np.asarray(back.curve),
                                  np.asarray(acc.curve))
    back.update({"correct": torch.tensor([[1.0, 2.0]]),
                 "seen": torch.tensor([[2.0, 4.0]])})
    np.testing.assert_array_equal(back.metric, [6 / 10, 0.5])


@pytest.mark.parametrize("family", ["vht", "clustream"])
def test_fleet_kill_resume_bit_for_bit(tmp_path, family):
    """A fleet run checkpointed every chunk, killed after its first chunk
    and resumed: carry, cursors, [F] metric and [T, F] curve equal the
    uninterrupted run's, bit for bit."""
    n, t = 3, 6
    kw = {"macro_impl": "boundary"} if family == "clustream" else {}
    fleet = LearnerFleet(_port_learner(family, **kw), n)
    stream = ChunkedStream(_torch(_fleet_payload(family, n, t)), C_LEN,
                           to_device=False)
    r0 = ChunkedPrequentialEvaluation(fleet, stream).run()
    mgr = CheckpointManager(tmp_path, keep=0)
    r1 = ChunkedPrequentialEvaluation(fleet, stream, checkpoint=mgr,
                                      checkpoint_every=1).run(resume=False)
    np.testing.assert_array_equal(np.asarray(r1.metric),
                                  np.asarray(r0.metric))
    for s in mgr.all_steps():
        if s > 1:
            shutil.rmtree(pathlib.Path(tmp_path) / f"step_{s:010d}")
    assert mgr.latest_step() == 1
    r2 = ChunkedPrequentialEvaluation(
        fleet, stream, checkpoint=CheckpointManager(tmp_path, keep=0),
        checkpoint_every=10 ** 9).run(resume=True)
    assert r2.extra["report"]["events"][0] == ("resume", 1)
    np.testing.assert_array_equal(np.asarray(r2.metric),
                                  np.asarray(r0.metric))
    np.testing.assert_array_equal(np.asarray(r2.curve),
                                  np.asarray(r0.curve))
    _assert_same(r2.extra["carry"]["states"],
                 state_to_numpy(r0.extra["carry"]["states"]))
    np.testing.assert_array_equal(
        _np(model_state_of(r2.extra["carry"])["cursor"]), np.full(n, t))


def test_jax_fleet_state_converts_and_steps_alike(jax_fleets):
    """A JAX fleet state carried across (``fleet_state_from_numpy``) and
    stepped once more in both packages gives the same state and metrics."""
    jstate, _ = jax_fleets["vht"]
    state = fleet_state_from_numpy(jstate, CPU)
    fleet = LearnerFleet(_port_learner("vht"), 3)
    jfleet = JaxFleet(_jax_learner("vht"), 3)
    x = np.stack([STREAMS[f][0][5] for f in range(3)])
    y = np.stack([STREAMS[f][1][5] for f in range(3)])
    got, m = fleet.step(state, torch.from_numpy(x), torch.from_numpy(y))
    want, jm = jax.jit(jfleet.step)(jax.tree.map(jnp.asarray, jstate),
                                    jnp.asarray(x), jnp.asarray(y))
    _assert_same(got, jax.tree.map(np.asarray, want))
    _assert_same(m, jax.tree.map(np.asarray, jm))
    with pytest.raises(ValueError, match="fleet axis"):
        fleet_state_from_numpy({"tenant": {"n": np.zeros(2, np.float32)},
                                "cursor": np.zeros(3, np.int32)}, CPU)


# --------------------------------------------------------------- serving

def test_fleet_predict_matches_reference_and_tenant_slices(port_fleets):
    """The tenant-indexed fast path answers every row as that tenant's
    model alone: against reference_predict and against the single
    learner's fast path on the sliced tenant state (VHT and CluStream)."""
    tenants = torch.tensor([0, 2, 1, 1, 0, 2], dtype=torch.int32)
    for arm in ("vht", "clustream"):
        fleet, state, _ = port_fleets[arm]
        xs = torch.from_numpy(_payload(arm, 0, 6)["x"][5][:6].copy())
        got = make_predict_fn(fleet)(state, xs, tenants)
        want = reference_predict(fleet, state, xs, tenant=tenants)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        single = make_predict_fn(fleet.learner)
        for i, f in enumerate(tenants.tolist()):
            sliced = tenant_state_of(state, f)
            np.testing.assert_array_equal(
                got[i].numpy(), single(sliced, xs[i][None])[0].numpy())
        with pytest.raises(ValueError, match="tenant"):
            reference_predict(fleet, state, xs)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_fleet_server_routes_requests_by_tenant(port_fleets):
    """``ModelServer`` over a fleet snapshot, without its thread (polled,
    on an injected clock: nothing races a batching window): one full
    batch of mixed tenants answered in one poll, each from its tenant's
    model, ``meta["tenant"]`` set; refusals before any accounting."""
    fleet, state, _ = port_fleets["vht"]
    pub = SnapshotPublisher()
    assert pub.publish(0, state)
    srv = ModelServer(fleet, pub, ServeConfig(max_batch=4, max_wait_ms=1.0),
                      start=False, clock=_Clock())
    xs = torch.from_numpy(_payload("vht", 0, 6)["x"][5][:4].copy())
    tenants = [2, 0, 1, 2]
    reqs = [srv.submit(xs[i].numpy(), tenant=f)
            for i, f in enumerate(tenants)]
    assert srv.poll() == 4
    want = reference_predict(fleet, state, xs,
                             tenant=torch.tensor(tenants)).numpy()
    assert [r.status for r in reqs] == ["answered"] * 4
    np.testing.assert_array_equal([int(r.pred) for r in reqs], want)
    assert [r.meta["tenant"] for r in reqs] == tenants
    before = srv.status()["submitted"]
    with pytest.raises(ValueError, match="tenant=<id>"):
        srv.submit(xs[0].numpy())
    with pytest.raises(ValueError, match="outside"):
        srv.submit(xs[0].numpy(), tenant=3)
    st = srv.status()
    assert st["submitted"] == before and st["accounting_ok"]
    assert st["answered"] == 4 and st["batches"] == 1
    single = ModelServer(fleet.learner, pub, start=False)
    with pytest.raises(ValueError, match="requires a LearnerFleet"):
        single.submit(xs[0].numpy(), tenant=0)


# ------------------------------------------------- the kernels' fleet forms

def _random_trees(M, N, m, nb, seed):
    rng = np.random.RandomState(seed)
    sa = np.full((M, N), -1, np.int32)
    sb = np.zeros((M, N), np.int32)
    ch = np.zeros((M, N, 2), np.int32)
    for t in range(M):
        n_nodes, leaves = 1, [0]
        for _ in range(rng.randint((N - 1) // 2 + 1)):
            node = leaves.pop(rng.randint(len(leaves)))
            sa[t, node], sb[t, node] = rng.randint(m), rng.randint(nb)
            ch[t, node] = (n_nodes, n_nodes + 1)
            leaves += [n_nodes, n_nodes + 1]
            n_nodes += 2
    return torch.from_numpy(sa), torch.from_numpy(sb), torch.from_numpy(ch)


def test_tree_route_fleet_forms_equal_per_tree_plain_version():
    """Both fleet forms against ``tree_route_ref`` tree by tree: the
    batched form on each tree's own batch, the row form on each row's
    tree (an out-of-range member gives -1)."""
    M, N, m, nb, Bq = 5, 31, 8, 4, 16
    sa, sb, ch = _random_trees(M, N, m, nb, 0)
    rng = np.random.RandomState(1)
    xb = torch.from_numpy(rng.randint(0, nb, (M, Bq, m)).astype(np.int32))
    got = tree_route_batched(sa, sb, ch, xb, max_depth=24)
    assert torch.equal(got, tree_route_batched_ref(sa, sb, ch, xb, 24))
    for t in range(M):
        assert torch.equal(got[t], tree_route_ref(
            sa[t:t + 1], sb[t:t + 1], ch[t:t + 1], xb[t], 24)[0])
    rows = xb.reshape(M * Bq, m)[:21]
    member = torch.from_numpy(rng.randint(-1, M + 1, 21).astype(np.int32))
    leaf = tree_route_rows(sa, sb, ch, rows, member, max_depth=24)
    assert torch.equal(leaf, tree_route_rows_ref(sa, sb, ch, rows, member,
                                                 24))
    for i, t in enumerate(member.tolist()):
        want = (-1 if not 0 <= t < M else
                int(tree_route_ref(sa[t:t + 1], sb[t:t + 1], ch[t:t + 1],
                                   rows[i:i + 1], 24)[0, 0]))
        assert int(leaf[i]) == want


@pytest.mark.parametrize("C", [1, 3, 24, 70])
def test_segment_sum_tenant_equals_per_tenant_scatter(C):
    """The tenant form's plain version against ``rule_stats_scatter_ref``
    tenant by tenant: each tenant's rows into its own S segments (the
    last, S, and -1 dropped), in instance order, bit for bit."""
    Fn, S, Bq = 4, 9, 40
    rng = np.random.RandomState(C)
    seg = torch.from_numpy(rng.randint(-1, S + 1, Fn * Bq).astype(np.int32))
    vals = torch.from_numpy(rng.randn(Fn * Bq, C).astype(np.float32))
    out = torch.from_numpy(rng.randn(Fn, S, C).astype(np.float32))
    want = out.clone()
    got = segment_sum_tenant(out, seg, vals)
    assert got is out
    for f in range(Fn):
        rows = slice(f * Bq, (f + 1) * Bq)
        rule_stats_scatter_ref(want[f].view(S, 1, 1, C), seg[rows],
                               torch.zeros((Bq, 1), dtype=torch.int32),
                               vals[rows])
    assert torch.equal(got, want)
    again = segment_sum_tenant_ref(want.clone(), seg, vals)
    assert torch.equal(again, segment_sum_tenant(out.clone(), seg, vals))


@pytest.mark.parametrize("N", [16, 100, 1500])
def test_batch_sum_tenant_equals_per_tenant_batch_sum(N):
    """Each tenant's batch sum in XLA's CPU order, as ``batch_sum`` on
    that tenant alone, bit for bit."""
    rng = np.random.RandomState(N)
    vals = torch.from_numpy(rng.randn(3, N, 5).astype(np.float32))
    got = batch_sum_tenant(vals)
    assert got.shape == (3, 5)
    for f in range(3):
        assert torch.equal(got[f], batch_sum(vals[f]))
