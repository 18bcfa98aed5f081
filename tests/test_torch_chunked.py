"""The port's chunked stream runtime on the CPU: ``ChunkedStream``,
``JitEngine.run_stream_chunked`` (and ``run_stream``'s chunk knobs),
``LocalEngine``'s eager ChunkedStream loop, ``MetricAccumulator``,
``CheckpointManager`` and the synchronous ``ChunkedPrequentialEvaluation``,
against one another and against the JAX package.

The stream and learners are tests/test_chunked.py's (B = 64, 12 binned
attributes, VHT and OzaBag on TreeConfig(max_nodes=63, n_min=20), AMRules
with 16 rules, CluStream(n_dims=12, n_micro=16, n_macro=3, period=2 * B)),
drawn once as numpy arrays and fed to both packages.  Within the port,
chunked, monolithic and eager runs are bit for bit alike for every family,
and so is a killed run resumed from its checkpoint.  Against the JAX
package, VHT, OzaBag and AMRules are bit for bit; CluStream's CF leaves
too, its macro centroids within rtol 1e-6 and its ssq metric within rtol
2e-6 (float32 products, tests/test_torch_clustream.py)."""

import collections
import pathlib
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.core.engines import JitEngine as JaxJitEngine
from repro.core.evaluation import ChunkedPrequentialEvaluation as JaxChunked
from repro.core.evaluation import MetricAccumulator as JaxAccumulator
from repro.data.generators import RandomTreeGenerator as JaxTreeGen
from repro.data.generators import bin_numeric as jax_bin
from repro.data.pipeline import ChunkedStream as JaxStream
from repro.ml.amrules import AMRules as JaxAMRules
from repro.ml.amrules import RulesConfig as JaxRulesConfig
from repro.ml.clustream import CluStream as JaxCluStream
from repro.ml.clustream import CluStreamConfig as JaxCluStreamConfig
from repro.ml.ensemble import EnsembleConfig as JaxEnsembleConfig
from repro.ml.ensemble import OzaEnsemble as JaxOza
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import VHT as JaxVHT
from repro.ml.vht import VHTConfig as JaxVHTConfig

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (accumulator_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import prng
from repro_torch.core.engines import JitEngine, LocalEngine
from repro_torch.core.evaluation import (ChunkedPrequentialEvaluation,
                                         MetricAccumulator, stack_outputs)
from repro_torch.data import pipeline
from repro_torch.data.generators import RandomTreeGenerator
from repro_torch.data.pipeline import (ChunkedStream, StreamPipeline,
                                       StreamSourceError, TransientSourceError)
from repro_torch.ml.amrules import AMRules, RulesConfig
from repro_torch.ml.clustream import CluStream, CluStreamConfig
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig

B, T_MAX = 64, 9
CPU = "cpu"
TC = dict(n_attrs=12, n_bins=8, n_classes=2, max_nodes=63, n_min=20,
          delta=0.05, tau=0.1)
RC = dict(n_attrs=12, n_bins=8, max_rules=16, n_min=100)
CC = dict(n_dims=12, n_micro=16, n_macro=3, period=2 * B)
FAMILIES = ("vht", "ozabag", "amrules", "clustream")
NAMES = {"vht": "vht", "ozabag": "ozaensemble", "amrules": "amrules",
         "clustream": "clustream"}


def _make_stream():
    gen = JaxTreeGen(n_cat=6, n_num=6, depth=5, seed=3)
    key = jax.random.PRNGKey(0)
    xs, ys = [], []
    for _ in range(T_MAX):
        key, k = jax.random.split(key)
        x, y = gen.sample(k, B)
        xs.append(jax_bin(x, 8))
        ys.append(y)
    return (np.asarray(jnp.stack(xs)).astype(np.int32),
            np.asarray(jnp.stack(ys)).astype(np.int32))


XS, YS = _make_stream()


def _payload(family, t):
    """numpy payload of the first t batches."""
    if family == "clustream":
        return {"x": XS[:t].astype(np.float32)}
    if family == "amrules":
        return {"x": XS[:t], "y": YS[:t].astype(np.float32)}
    return {"x": XS[:t], "y": YS[:t]}


def _tpayload(family, t):
    return {k: torch.from_numpy(v.copy()) for k, v in
            _payload(family, t).items()}


def _port(family, **cc):
    if family == "vht":
        return VHT(VHTConfig(TreeConfig(**TC)), device=CPU)
    if family == "ozabag":
        return OzaEnsemble(EnsembleConfig(tree=TreeConfig(**TC), n_members=3),
                           device=CPU)
    if family == "amrules":
        return AMRules(RulesConfig(**RC), device=CPU)
    return CluStream(CluStreamConfig(**{**CC, **cc}), device=CPU)


def _jax(family, **cc):
    if family == "vht":
        return JaxVHT(JaxVHTConfig(JaxTreeConfig(**TC)))
    if family == "ozabag":
        return JaxOza(JaxEnsembleConfig(tree=JaxTreeConfig(**TC),
                                        n_members=3))
    if family == "amrules":
        return JaxAMRules(JaxRulesConfig(**RC))
    return JaxCluStream(JaxCluStreamConfig(**{**CC, **cc}))


KEY = prng.PRNGKey(0, CPU)
LEARNERS = {f: _port(f) for f in FAMILIES}
_MONO: dict = {}


def _monolithic(family, t):
    """The port's monolithic JitEngine run of t batches (cached)."""
    if (family, t) not in _MONO:
        eng, learner = JitEngine(), LEARNERS[family]
        _MONO[(family, t)] = eng.run_stream(learner, eng.init(learner, KEY),
                                            _tpayload(family, t))
    return _MONO[(family, t)]


def _assert_same(a, b, path=""):
    """Two trees of tensors alike, dtypes and bits."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
        return
    if a is None:
        assert b is None, path
        return
    assert a.dtype == b.dtype and torch.equal(a, b), path


def _assert_like_jax(got, want, family, path=""):
    """A port tree (numpy) against a JAX tree (numpy): bit for bit, but
    CluStream's macro centroids (rtol 1e-6) and ssq metric (rtol 2e-6)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_like_jax(got[k], want[k], family, f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    if family == "clustream" and path.endswith(("/macro", "/ssq")):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6, err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


# --------------------- chunked == monolithic == eager, all four families

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("t,c", [(8, 3),   # T % C != 0: a padded tail
                                 (2, 5),   # T < C: one mostly padded chunk
                                 (3, 3),   # T == C: one full chunk
                                 (4, 1)])  # C == 1: every chunk one step
def test_chunked_equals_monolithic_equals_eager(family, t, c):
    """The chunked runtime changes not a bit of the final carry or the
    per-step outputs against the monolithic run, and LocalEngine's eager
    ChunkedStream loop gives the same states and outputs; the padding is
    dropped from the outputs."""
    c0, o0 = _monolithic(family, t)
    eng, learner = JitEngine(), LEARNERS[family]
    c1, o1 = eng.run_stream(learner, eng.init(learner, KEY),
                            _tpayload(family, t), chunk_len=c)
    _assert_same(c1, c0)
    _assert_same(o1, o0)
    assert o1["metrics"]["seen"].shape[0] == t
    loc = LocalEngine()
    states, outs = loc.run_stream(
        learner, loc.init(learner, KEY),
        ChunkedStream(_tpayload(family, t), c, device=CPU))
    _assert_same(states, c0["states"])
    _assert_same(stack_outputs(outs), o0)


@pytest.fixture(scope="module")
def jax_monolithic():
    """The JAX package's monolithic run of 8 batches per family (its
    chunked runs equal it, tests/test_chunked.py)."""
    out = {}
    for family in FAMILIES:
        learner, eng = _jax(family), JaxJitEngine()
        carry, outs = eng.run_stream(learner,
                                     eng.init(learner, jax.random.PRNGKey(0)),
                                     _payload(family, 8))
        out[family] = jax.tree.map(np.asarray, (carry, outs))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_matches_jax(jax_monolithic, family):
    """8 batches in chunks of 3 on the port against the JAX package from
    PRNGKey(0): the carry (states and feedback) and every per-step
    output; the learners learn (a tree splits, rules are created, the
    macro phase fires)."""
    eng, learner = JitEngine(), LEARNERS[family]
    carry, outs = eng.run_stream(learner, eng.init(learner, KEY),
                                 _tpayload(family, 8), chunk_len=3)
    want_carry, want_outs = jax_monolithic[family]
    _assert_like_jax(state_to_numpy(carry), want_carry, family)
    _assert_like_jax(state_to_numpy(outs), want_outs, family)
    st = want_carry["states"][NAMES[family]]
    grew = {"vht": lambda: st["n_nodes"] > 1,
            "ozabag": lambda: st["trees"]["n_nodes"].max() > 1,
            "amrules": lambda: st["n_created"] > 0,
            "clustream": lambda: st["macro_t"] > 0}[family]
    assert grew()


@pytest.fixture(scope="module")
def jax_vht_evaluation():
    """The JAX package's ChunkedPrequentialEvaluation of VHT over 8
    batches in chunks of 3: (its learner, its engine, the result)."""
    learner, eng = _jax("vht"), JaxJitEngine()
    res = JaxChunked(learner, JaxStream(_payload("vht", 8), 3),
                     engine=eng).run()
    return learner, eng, res


def test_chunked_evaluation_matches_jax(jax_vht_evaluation):
    """ChunkedPrequentialEvaluation over 8 batches in chunks of 3 on the
    port and on the JAX package: the same metric, curve and final carry,
    bit for bit."""
    want = jax_vht_evaluation[2]
    got = ChunkedPrequentialEvaluation(
        LEARNERS["vht"], ChunkedStream(_tpayload("vht", 8), 3,
                                       device=CPU)).run()
    assert got.metric == want.metric and got.curve == want.curve
    assert got.extra["seen"] == want.extra["seen"] == 8 * B
    assert 0.5 < got.metric < 1.0
    _assert_like_jax(state_to_numpy(got.extra["carry"]),
                     jax.tree.map(np.asarray, want.extra["carry"]), "vht")


# -------------------------------------------------- kill and resume

@pytest.mark.parametrize("family,cc", [("vht", {}), ("ozabag", {}),
                                       ("clustream",
                                        {"macro_impl": "boundary"})],
                         ids=["vht", "ozabag", "clustream-boundary"])
def test_kill_resume_bit_identical(tmp_path, family, cc):
    """A run killed after chunk 1 resumes from its checkpoint (carry,
    cursor, stream key and accumulator, restored with no template) and
    ends with the uninterrupted run's final carry, metric and curve, bit
    for bit.  The writer is asynchronous; the run joins it at its end."""
    learner = _port(family, **cc)
    stream = ChunkedStream(_tpayload(family, 8), 3, device=CPU)
    r0 = ChunkedPrequentialEvaluation(learner, stream).run()
    mgr = CheckpointManager(tmp_path, keep=0)
    r1 = ChunkedPrequentialEvaluation(learner, stream, checkpoint=mgr,
                                      checkpoint_every=1).run(resume=False)
    assert mgr.all_steps() == [1, 2, 3]
    assert r1.metric == r0.metric and r1.curve == r0.curve
    _assert_same(r1.extra["carry"], r0.extra["carry"])
    for s in mgr.all_steps():               # the kill: chunk 1 was the last
        if s > 1:
            shutil.rmtree(pathlib.Path(tmp_path) / f"step_{s:010d}")
    resumed = ChunkedPrequentialEvaluation(
        learner, stream, checkpoint=CheckpointManager(tmp_path, keep=0),
        checkpoint_every=10 ** 9)
    r2 = resumed.run(resume=True)
    assert resumed.report["events"] == [("resume", 1)]
    assert r2.extra["chunks"] == 2
    assert r2.metric == r0.metric and r2.curve == r0.curve
    _assert_same(r2.extra["carry"], r0.extra["carry"])
    if family == "clustream":
        assert float(r0.extra["carry"]["states"]["clustream"]["macro_t"]) > 0


def test_port_resumes_a_checkpoint_the_jax_package_wrote(
        tmp_path, jax_vht_evaluation):
    """The checkpoint format is the JAX package's: a JAX run killed after
    chunk 1 resumes on the port (carry, uint32 key and accumulator
    converted on restore) and ends as the uninterrupted JAX run, bit for
    bit."""
    learner, eng, want = jax_vht_evaluation
    JaxChunked(learner, JaxStream(_payload("vht", 8), 3), engine=eng,
               checkpoint=JaxCheckpoints(tmp_path, keep=0,
                                         async_write=False)).run(resume=False)
    for s in (2, 3):
        shutil.rmtree(pathlib.Path(tmp_path) / f"step_{s:010d}")
    ev = ChunkedPrequentialEvaluation(
        LEARNERS["vht"], ChunkedStream(_tpayload("vht", 8), 3, device=CPU),
        checkpoint=CheckpointManager(tmp_path))
    got = ev.run(resume=True)
    assert ev.key.dtype == torch.uint32
    assert got.metric == want.metric and got.curve == want.curve
    _assert_like_jax(state_to_numpy(got.extra["carry"]),
                     jax.tree.map(np.asarray, want.extra["carry"]), "vht")


# ------------------------------------------------ CheckpointManager

def test_checkpoint_keep_collects_the_oldest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 5):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    tree, step = mgr.restore_structured(device=CPU)
    assert step == 4 and torch.equal(tree["w"], torch.full((3,), 4.0))


def test_checkpoint_checksum_falls_back_to_the_newest_intact(tmp_path):
    """A corrupted newest checkpoint fails its checksum: restore falls back
    to the newest intact one, a pinned step raises."""
    mgr = CheckpointManager(tmp_path, keep=0)
    for s in (1, 2):
        mgr.save(s, {"w": np.full((4,), s, np.float32)})
    mgr.wait()
    npz = pathlib.Path(tmp_path) / "step_0000000002" / "tensors.npz"
    blob = dict(np.load(npz))
    blob["t0"] = np.full((4,), 9, np.float32)
    np.savez(npz, **blob)
    tree, step = mgr.restore_structured()
    assert step == 1 and tree["w"].tolist() == [1.0] * 4
    with pytest.raises(IOError, match="checksum"):
        mgr.restore_structured(step=2)
    back, step = mgr.restore({"w": torch.zeros(4)})
    assert step == 1 and torch.equal(back["w"], torch.ones(4))


def test_checkpoint_sweeps_stale_tmp_and_round_trips_structure(tmp_path):
    """tmp directories a killed writer left are swept when a manager
    opens its directory; the structure (lists, tuples, None, uint32 keys,
    bf16, numpy scalars) comes back without a template; a dict subclass
    is refused by the structured restore and taken by the template one."""
    (pathlib.Path(tmp_path) / "tmp.7.12345").mkdir()
    mgr = CheckpointManager(tmp_path, keep=0)
    assert mgr.swept_tmp == 1 and not list(pathlib.Path(tmp_path).glob("tmp*"))
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": [torch.tensor(1.5), (prng.PRNGKey(7, CPU), None)],
            "h": torch.ones(3, dtype=torch.bfloat16),
            "z": {"cursor": np.int64(3)}}
    mgr.save(3, tree)
    back, step = mgr.restore_structured(device=CPU)
    assert step == 3 and back["b"][1][1] is None
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)
    assert back["b"][1][0].dtype == torch.uint32
    assert torch.equal(back["b"][1][0], tree["b"][1][0])
    assert back["h"].dtype == torch.bfloat16 and int(back["z"]["cursor"]) == 3
    od = {"od": collections.OrderedDict([("b", torch.ones(2)),
                                         ("a", torch.zeros(3))])}
    mgr.save(4, od)
    mgr.wait()
    with pytest.raises(ValueError, match="no stored structure"):
        mgr.restore_structured(step=4)
    back, _ = mgr.restore(od, step=4)
    assert torch.equal(back["od"]["a"], torch.zeros(3))


# ------------------------------------------------ MetricAccumulator

def test_metric_accumulator_state_round_trip_and_jax_parity():
    """The same chunks folded by the port and by the JAX package give the
    same state; state()/load() round-trips exactly; a JAX state converts;
    zero-weight steps carry the curve forward."""
    chunks = [{"seen": np.full((3,), 4.0, np.float32),
               "correct": np.asarray([1.0, 2.0, 3.0], np.float32)},
              {"seen": np.zeros((2,), np.float32),
               "correct": np.zeros((2,), np.float32)}]
    acc, jacc = MetricAccumulator(), JaxAccumulator()
    for m in chunks:
        acc.update({k: torch.from_numpy(v) for k, v in m.items()})
        jacc.update({k: jnp.asarray(v) for k, v in m.items()})
    for k, v in jacc.state().items():
        np.testing.assert_array_equal(acc.state()[k], v)
    assert acc.curve[-2:] == [0.75, 0.75] and acc.metric == 6.0 / 12.0
    clone = MetricAccumulator().load(acc.state())
    assert clone.metric == acc.metric and clone.curve == acc.curve
    clone.update({"seen": torch.ones(1), "abs_err": torch.ones(1)})
    assert clone.seen == acc.seen + 1
    conv = accumulator_from_numpy(jacc.state())
    assert conv.curve == acc.curve and conv.metric == acc.metric
    assert MetricAccumulator().metric == 0.0


def test_convert_carries_a_jax_chunked_carry_across(jax_monolithic):
    """A JAX carry (CluStream's, after 8 batches) read out as numpy comes
    across with its dtypes and bits, and the port continues it."""
    want = jax_monolithic["clustream"][0]
    carry = state_from_numpy(want, CPU)
    assert carry["feedback"] == {}
    _assert_like_jax(state_to_numpy(carry), want, "clustream")
    eng = JitEngine()
    learner = LEARNERS["clustream"]
    more, outs = eng.run_stream(learner, carry, {"x": torch.from_numpy(
        XS[8:9].astype(np.float32))}, chunk_len=1)
    assert float(more["states"]["clustream"]["t"]) == 9 * B


# ------------------------------------------------------ ChunkedStream

def _producers():
    return [t for t in threading.enumerate() if t.name == "chunked-stream"]


def test_chunked_stream_pads_masks_and_joins_its_producer():
    stream = ChunkedStream({"x": torch.arange(10.0)}, 4, device=CPU)
    chunks = list(stream)
    assert [c.length for c in chunks] == [4, 4, 2]
    tail = chunks[-1]
    assert tail.chunk_len == 4 and tail.padded
    assert tail.valid.tolist() == [True, True, False, False]
    assert tail.payload["x"].tolist() == [8.0, 9.0, 0.0, 0.0]
    it = iter(stream)
    next(it)
    it.close()                         # an abandoned iteration
    assert not _producers()
    listed = ChunkedStream([{"x": np.full((2,), float(i), np.float32)}
                            for i in range(5)], 2, device=CPU)
    assert listed.n_chunks == 3
    assert [c.length for c in listed] == [2, 2, 1]
    assert next(iter(listed)).payload["x"].shape == (2, 2)
    assert not _producers()


def test_chunked_stream_from_fn_restarts_and_resumes():
    calls = []

    def fetch(i):
        calls.append(i)
        return {"x": torch.full((3,), float(i))}

    stream = ChunkedStream.from_fn(fetch, n_chunks=4, chunk_len=3,
                                   device=CPU)
    assert len(stream) == 4
    assert [float(c.payload["x"][0]) for c in stream] == [0, 1, 2, 3]
    assert [c.index for c in stream] == [0, 1, 2, 3]        # restartable
    resumed = stream.starting_at(2)
    assert [c.index for c in resumed] == [2, 3] and len(resumed) == 2
    with pytest.raises(ValueError):
        ChunkedStream({"x": torch.arange(4.0)}, 0)
    with pytest.raises(ValueError):
        stream.starting_at(7)
    for n in (5, 0):              # more steps than chunk_len; no steps
        with pytest.raises(ValueError):
            list(ChunkedStream.from_fn(lambda i, n=n: {"x": torch.zeros(n)},
                                       n_chunks=1, chunk_len=3, device=CPU))
    assert not _producers()


def test_chunked_stream_retries_and_shares_its_counts_across_views(
        monkeypatch):
    """Transient errors are retried with backoff and logged in one list
    that starting_at views share; past the retries the chunk is lost with
    its index."""
    monkeypatch.setattr(pipeline, "BACKOFF_S", 1e-4)
    fails = {i: 1 for i in range(4)}

    def flaky(i):
        if fails.get(i, 0) > 0:
            fails[i] -= 1
            raise TransientSourceError(f"flap {i}")
        return {"x": torch.zeros((1, 2))}

    base = ChunkedStream.from_fn(flaky, n_chunks=4, chunk_len=1, device=CPU)
    assert len(list(base.starting_at(0))) == 4
    fails.update({2: 1, 3: 1})
    view = base.starting_at(2)
    assert len(list(view)) == 2
    for s in (base, view):
        assert [e[:2] for e in s.retry_events] == [
            (0, 1), (1, 1), (2, 1), (3, 1), (2, 1), (3, 1)]
        assert all(0 < e[2] <= 1e-4 for e in s.retry_events)
    dead = ChunkedStream.from_fn(
        lambda i: (_ for _ in ()).throw(TransientSourceError("down")),
        n_chunks=2, chunk_len=1, device=CPU)
    with pytest.raises(StreamSourceError,
                       match=f"chunk 0 after {pipeline.RETRIES + 1}"):
        list(dead)
    assert not _producers()


# -------------------------------------------- the runtime's knobs

def test_run_stream_chunk_knobs():
    """on_chunk sees each chunk (index, length, padding) after its
    boundary; collect_outputs=False keeps no outputs; the monolithic run
    refuses both knobs; the evaluation takes no engine (JitEngine is its
    one) and none of the options the port does not have (the supervisor
    and distribution's)."""
    eng, learner = JitEngine(), LEARNERS["amrules"]
    seen, tally = [], MetricAccumulator()

    def on_chunk(outs, chunk, carry):
        seen.append((chunk.index, chunk.length, chunk.padded))
        tally.update(outs["metrics"])

    carry, outs = eng.run_stream(learner, eng.init(learner, KEY),
                                 _tpayload("amrules", 8), chunk_len=3,
                                 on_chunk=on_chunk, collect_outputs=False)
    assert outs is None and seen == [(0, 3, False), (1, 3, False),
                                     (2, 2, True)]
    c0, o0 = _monolithic("amrules", 8)
    _assert_same(carry, c0)
    mono = MetricAccumulator()
    mono.update(o0["metrics"])
    assert tally.abs_err == mono.abs_err and tally.curve == mono.curve
    for kw in ({"on_chunk": on_chunk}, {"collect_outputs": False}):
        with pytest.raises(ValueError, match="chunked"):
            eng.run_stream(learner, eng.init(learner), _tpayload("amrules", 2),
                           **kw)
    stream = ChunkedStream(_tpayload("amrules", 2), 2, device=CPU)
    with pytest.raises(TypeError):
        ChunkedPrequentialEvaluation(learner, stream, engine=LocalEngine())
    for kw in ({"supervisor": object()}, {"model_parallel": 2}):
        with pytest.raises(TypeError, match="items 6 and 10"):
            ChunkedPrequentialEvaluation(learner, stream, **kw)


def test_stream_pipeline_materializes_its_batches():
    gen = RandomTreeGenerator(n_cat=3, n_num=3, depth=3, device=CPU)
    x, y = StreamPipeline(gen, batch=16, n_batches=3, n_bins=8,
                          device=CPU).materialize()
    assert x.shape == (3, 16, 6) and y.shape == (3, 16)
    batches = list(StreamPipeline(gen, batch=16, n_batches=3, n_bins=8,
                                  device=CPU))
    assert all(torch.equal(x[i], b[0]) for i, b in enumerate(batches))
