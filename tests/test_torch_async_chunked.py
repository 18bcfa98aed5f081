"""The port's pipelined chunk driver on the CPU:
``ChunkedPrequentialEvaluation`` with ``pipeline`` on (the default)
against the synchronous driver and against the JAX package's pipelined
driver, ``MetricAccumulator``'s deferred fold and forks, and the
asynchronous ``SnapshotPublisher``.

The stream and learners are tests/test_async_chunked.py's (B = 64, 8
batches in chunks of 3, 12 binned attributes, a padded last chunk; 6
batches in chunks of 2 against the JAX package, whose chunk programs take
seconds to compile; VHT and OzaBag on
TreeConfig(max_nodes=63, n_min=20), AMRules with 16 rules,
CluStream(n_dims=12, n_micro=16, n_macro=3, period=2 * B)), drawn once as
numpy arrays and fed to both packages.  Pipelined and synchronous runs of
the port are bit for bit alike: metric, curve, final carry and checkpoint
manifests.  Against the JAX package, VHT, OzaBag and AMRules are bit for
bit; CluStream's macro centroids are within rtol 2e-6 (float32 products,
tests/test_torch_clustream.py)."""

import concurrent.futures
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.engines import JitEngine as JaxJitEngine
from repro.core.evaluation import ChunkedPrequentialEvaluation as JaxChunked
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
from repro.serving.snapshot import SnapshotPublisher as JaxPublisher

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import state_to_numpy
from repro_torch.core import evaluation
from repro_torch.core.evaluation import (ChunkedPrequentialEvaluation,
                                         MetricAccumulator)
from repro_torch.data.pipeline import ChunkedStream
from repro_torch.ml.amrules import AMRules, RulesConfig
from repro_torch.ml.clustream import CluStream, CluStreamConfig
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig
from repro_torch.runtime import FaultInjector
from repro_torch.serving import SnapshotPublisher

B, T, C = 64, 8, 3
JAX_T, JAX_C = 6, 2
CPU = "cpu"
TC = dict(n_attrs=12, n_bins=8, n_classes=2, max_nodes=63, n_min=20,
          delta=0.05, tau=0.1)
RC = dict(n_attrs=12, n_bins=8, max_rules=16, n_min=100)
CC = dict(n_dims=12, n_micro=16, n_macro=3, period=2 * B)
FAMILIES = ("vht", "ozabag", "amrules", "clustream")


def _make_stream():
    gen = JaxTreeGen(n_cat=6, n_num=6, depth=5, seed=3)
    key = jax.random.PRNGKey(0)
    xs, ys = [], []
    for _ in range(T):
        key, k = jax.random.split(key)
        x, y = gen.sample(k, B)
        xs.append(jax_bin(x, 8))
        ys.append(y)
    return (np.asarray(jnp.stack(xs)).astype(np.int32),
            np.asarray(jnp.stack(ys)).astype(np.int32))


XS, YS = _make_stream()


def _payload(family, t=T):
    if family == "clustream":
        return {"x": XS[:t].astype(np.float32)}
    if family == "amrules":
        return {"x": XS[:t], "y": YS[:t].astype(np.float32)}
    return {"x": XS[:t], "y": YS[:t]}


def _stream(family, t=T, c=C):
    return ChunkedStream({k: torch.from_numpy(v.copy()) for k, v in
                          _payload(family, t).items()}, c, device=CPU)


LEARNERS = {
    "vht": VHT(VHTConfig(TreeConfig(**TC)), device=CPU),
    "ozabag": OzaEnsemble(EnsembleConfig(tree=TreeConfig(**TC), n_members=3),
                          device=CPU),
    "amrules": AMRules(RulesConfig(**RC), device=CPU),
    "clustream": CluStream(CluStreamConfig(**CC), device=CPU),
}


def _jax_learner(family):
    if family == "vht":
        return JaxVHT(JaxVHTConfig(JaxTreeConfig(**TC)))
    if family == "ozabag":
        return JaxOza(JaxEnsembleConfig(tree=JaxTreeConfig(**TC),
                                        n_members=3))
    if family == "amrules":
        return JaxAMRules(JaxRulesConfig(**RC))
    return JaxCluStream(JaxCluStreamConfig(**CC))


def _evaluation(family, t=T, c=C, **kw):
    return ChunkedPrequentialEvaluation(LEARNERS[family],
                                        _stream(family, t, c), **kw)


_SYNC: dict = {}


def _sync_reference(family):
    """The port's synchronous run, which every pipelined run reproduces."""
    if family not in _SYNC:
        _SYNC[family] = _evaluation(family, pipeline=False).run(resume=False)
    return _SYNC[family]


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
    CluStream's macro centroids (rtol 2e-6)."""
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
    if family == "clustream" and path.endswith("/macro"):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6, err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture(scope="module")
def jax_pipelined():
    """The JAX package's pipelined run of each family (its default
    driver), on the same numpy stream: JAX_T batches in chunks of JAX_C.
    The four run in threads of their own, so that their compilations
    overlap."""
    def run(family):
        r = JaxChunked(_jax_learner(family),
                       JaxStream(_payload(family, JAX_T), JAX_C),
                       engine=JaxJitEngine(), pipeline=True).run(resume=False)
        return (r.metric, r.curve, jax.tree.map(np.asarray, r.extra["carry"]))

    with concurrent.futures.ThreadPoolExecutor(len(FAMILIES)) as pool:
        return dict(zip(FAMILIES, pool.map(run, FAMILIES)))


# --------------- pipelined == synchronous == the JAX package's pipelined

@pytest.mark.parametrize("family", FAMILIES)
def test_pipelined_equals_sync_and_jax(jax_pipelined, family):
    """The pipelined run (the default) against the synchronous run, bit
    for bit, and against the JAX package's pipelined run from PRNGKey(0)
    on JAX_T batches; the learners learn."""
    ref = _sync_reference(family)
    r = _evaluation(family).run(resume=False)
    assert r.metric == ref.metric and r.curve == ref.curve
    _assert_same(r.extra["carry"], ref.extra["carry"])
    r = _evaluation(family, JAX_T, JAX_C).run(resume=False)
    metric, curve, carry = jax_pipelined[family]
    assert r.curve == curve and r.metric == metric
    _assert_like_jax(state_to_numpy(r.extra["carry"]), carry, family)
    st = r.extra["carry"]["states"]
    grew = {"vht": lambda: int(st["vht"]["n_nodes"]) > 1,
            "ozabag": lambda: int(st["ozaensemble"]["trees"]["n_nodes"]
                                  .max()) > 1,
            "amrules": lambda: int(st["amrules"]["n_created"]) > 0,
            "clustream": lambda: float(st["clustream"]["macro_t"]) > 0}
    assert grew[family]()


@pytest.mark.parametrize("window,delay", [(1, None), (4, None), (2, 1)],
                         ids=["window1", "window4", "delay-chunk1"])
def test_pipelined_any_window_or_delay_equals_sync(window, delay):
    """In-flight windows of 1 (lockstep, the drain deferred) and 4 (more
    than the chunks), and a straggler chunk, change nothing."""
    ref = _sync_reference("amrules")
    inj = None if delay is None else FaultInjector().delay_chunk(delay, 0.01)
    r = _evaluation("amrules", max_inflight_chunks=window,
                    injector=inj).run(resume=False)
    assert r.metric == ref.metric and r.curve == ref.curve
    _assert_same(r.extra["carry"], ref.extra["carry"])
    if inj is not None:
        assert inj.delays_fired == {delay}


def _manifest(directory, step):
    d = pathlib.Path(directory) / f"step_{step:010d}"
    m = json.loads((d / "manifest.json").read_text())
    m.pop("time")                     # the wall clock, the one difference
    return m


def test_pipelined_checkpoint_manifests_equal_sync(tmp_path):
    """Every checkpoint a pipelined run writes (carry, cursor, key and the
    accumulator state forked at dispatch) has the synchronous run's
    manifest: the same tensors and checksums."""
    runs = {}
    for mode, flag in (("sync", False), ("pipe", True)):
        mgr = CheckpointManager(tmp_path / mode, keep=0)
        r = _evaluation("vht", checkpoint=mgr, pipeline=flag).run(
            resume=False)
        runs[mode] = (r, mgr)
    (rs, ms), (rp, mp) = runs["sync"], runs["pipe"]
    assert rp.metric == rs.metric and rp.curve == rs.curve
    steps = ms.all_steps()
    assert steps == mp.all_steps() == [1, 2, 3]
    for s in steps:
        assert _manifest(tmp_path / "sync", s) == _manifest(tmp_path / "pipe",
                                                            s)


def test_pipelined_main_thread_waits_twice(monkeypatch):
    """The dispatch loop waits on the device twice a run (the first chunk's
    timestamp and the final fence), never once a chunk, and no other
    thread calls the device-wide wait."""
    calls = {"main": 0, "other": 0}
    real = evaluation._sync

    def counting(t):
        where = ("main" if threading.current_thread()
                 is threading.main_thread() else "other")
        calls[where] += 1
        return real(t)

    monkeypatch.setattr(evaluation, "_sync", counting)
    r = _evaluation("amrules").run(resume=False)
    assert r.extra["chunks"] == 3
    assert calls == {"main": 2, "other": 0}


# ------------------------------------------------------ MetricAccumulator

def test_metric_accumulator_defers_and_forks():
    """update() keeps the chunk's leaves unread; a fork covers exactly the
    chunks updated before it, whenever it folds; the fold is the JAX
    package's, in update order."""
    acc = MetricAccumulator()
    first = {"seen": torch.full((2,), 8.0),
             "correct": torch.tensor([6.0, 7.0])}
    acc.update(first)
    assert acc._pending[0][0] is first          # unread
    fork = acc.fork()
    acc.update({"seen": torch.full((1,), 8.0), "correct": torch.tensor([8.0])})
    assert fork.metric == 13.0 / 16.0 and fork.curve == [0.75, 0.875]
    assert acc.metric == 21.0 / 24.0 and acc._pending == []
    assert acc.curve == [0.75, 0.875, 1.0]
    assert fork.curve == [0.75, 0.875]          # the fork kept its own


# ------------------------------------------------ the async publisher

def test_async_publisher_equals_sync_and_jax_after_flush():
    """async_publish validates and installs on a worker in publication
    order: after flush() its counters, breaker events and snapshot equal
    the synchronous publisher's, and the JAX package's for the same
    sequence."""
    good, bad = [1.0, 1.0, 1.0], [1.0, float("nan"), 1.0]
    seq = [(0, good), (1, bad), (2, bad), (3, bad), (4, good)]
    pubs = {"sync": SnapshotPublisher(breaker_threshold=3),
            "async": SnapshotPublisher(breaker_threshold=3,
                                       async_publish=True, max_pending=2)}
    jpub = JaxPublisher(breaker_threshold=3)
    for i, w in seq:
        for pub in pubs.values():
            pub.publish(i, {"w": torch.tensor(w)})
        jpub.publish(i, {"w": jnp.asarray(w)})
    pubs["async"].flush()
    s, a, j = (p.status() for p in (pubs["sync"], pubs["async"], jpub))
    assert a.pop("pending_publishes") == 0
    s.pop("pending_publishes"), j.pop("pending_publishes")
    assert a == s == j
    assert pubs["async"].events == pubs["sync"].events == jpub.events
    cur = pubs["async"].current()
    assert cur.chunk_index == 4 and cur.version == 2
    pubs["async"].close()


def test_pipelined_with_async_publisher_matches_sync_snapshots():
    """A pipelined run publishing through an async publisher ends with the
    synchronous run's counters and final snapshot (the epilogue flushes
    before it reads the status)."""
    stats = {}
    for mode, flag in (("sync", False), ("pipe", True)):
        pub = SnapshotPublisher(async_publish=flag)
        r = _evaluation("vht", publisher=pub, pipeline=flag).run(
            resume=False)
        st = dict(r.extra["report"]["snapshots"])
        assert st.pop("pending_publishes") == 0
        stats[mode] = (st, pub.current())
        pub.close()
    assert stats["pipe"][0] == stats["sync"][0]
    assert stats["pipe"][0]["published"] == 3
    _assert_same(stats["pipe"][1].state, stats["sync"][1].state)
    assert stats["pipe"][1].chunk_index == stats["sync"][1].chunk_index == 2
