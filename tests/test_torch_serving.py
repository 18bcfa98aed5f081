"""The port's serving path on the CPU: ``SnapshotPublisher``, the predict
fast paths and ``ModelServer`` (``repro_torch.serving``), against the JAX
package's and against the training loop itself.

Snapshot publication (validation, the double buffer, the circuit breaker,
the staleness limit, the spill to a checkpoint), serve/train parity for
the four learner families (a snapshot published at chunk boundary k
answers chunk k+1's first batch as the training step predicted it, bit
for bit, and as the JAX package's predict on the same state), and the
server's micro-batching, admission control, deadline shedding and truthful
accounting, also while a pipelined run trains and publishes.  The stream
and learners are tests/test_serving.py's (B = 64, 8 batches in chunks of
2, 12 binned attributes), drawn once as numpy arrays.

No test here depends on a wall-clock window: the server's batching window,
deadlines and latencies run on an injected clock, batches are formed with
``poll()`` on a server made with ``start=False`` where their size is
checked, and every wait has a timeout."""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data.generators import RandomTreeGenerator as JaxTreeGen
from repro.data.generators import bin_numeric as jax_bin
from repro.ml.amrules import AMRules as JaxAMRules
from repro.ml.amrules import RulesConfig as JaxRulesConfig
from repro.ml.clustream import CluStream as JaxCluStream
from repro.ml.clustream import CluStreamConfig as JaxCluStreamConfig
from repro.ml.ensemble import EnsembleConfig as JaxEnsembleConfig
from repro.ml.ensemble import OzaEnsemble as JaxOza
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import VHT as JaxVHT
from repro.ml.vht import VHTConfig as JaxVHTConfig
from repro.serving import SnapshotPublisher as JaxPublisher
from repro.serving import make_predict_fn as jax_predict_fn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import state_to_numpy
from repro_torch.core import prng
from repro_torch.core.engines import JitEngine
from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
from repro_torch.data.pipeline import ChunkedStream
from repro_torch.ml.amrules import AMRules, RulesConfig
from repro_torch.ml.clustream import CluStream, CluStreamConfig, pairwise_d2
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig
from repro_torch.runtime import FaultInjector, request_burst
from repro_torch.serving import (ModelServer, ServeConfig, SnapshotPublisher,
                                 make_predict_fn, model_state_of,
                                 reference_predict, tenant_state_of)

B, T, C = 64, 8, 2
N_CHUNKS = T // C
CPU = "cpu"
TC = dict(n_attrs=12, n_bins=8, n_classes=2, max_nodes=63, n_min=20,
          delta=0.05, tau=0.1)
RC = dict(n_attrs=12, n_bins=8, max_rules=16, n_min=100)
# period > T * B: the macro centroids stay put through the stream, so the
# training step's ssq reads the centres a snapshot holds
CC = dict(n_dims=12, n_micro=16, n_macro=3, period=100_000)
FAMILIES = ("vht", "ozabag", "amrules", "clustream")
TERMINAL = {"answered", "shed", "overloaded", "unavailable"}


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
LEARNERS = {
    "vht": VHT(VHTConfig(TreeConfig(**TC)), device=CPU),
    "ozabag": OzaEnsemble(EnsembleConfig(tree=TreeConfig(**TC), n_members=3),
                          device=CPU),
    "amrules": AMRules(RulesConfig(**RC), device=CPU),
    "clustream": CluStream(CluStreamConfig(**CC), device=CPU),
}
JAX_LEARNERS = {
    "vht": lambda: JaxVHT(JaxVHTConfig(JaxTreeConfig(**TC))),
    "ozabag": lambda: JaxOza(JaxEnsembleConfig(tree=JaxTreeConfig(**TC),
                                               n_members=3)),
    "amrules": lambda: JaxAMRules(JaxRulesConfig(**RC)),
    "clustream": lambda: JaxCluStream(JaxCluStreamConfig(**CC)),
}


def _payload(family):
    if family == "clustream":
        return {"x": XS.astype(np.float32)}
    if family == "amrules":
        return {"x": XS, "y": YS.astype(np.float32)}
    return {"x": XS, "y": YS}


def _stream(family="vht"):
    return ChunkedStream({k: torch.from_numpy(v.copy()) for k, v in
                          _payload(family).items()}, C, device=CPU)


_TRACE: dict = {}


def _trace(family):
    """The carry after each chunk (the boundary states a publisher takes)
    and each chunk's stacked metrics, chunk by chunk on JitEngine."""
    if family not in _TRACE:
        learner, eng = LEARNERS[family], JitEngine()
        carry = eng.init(learner, prng.PRNGKey(0, CPU))
        carries, outs = [], []
        for chunk in _stream(family):
            carry, o = eng.run_stream_chunked(learner, carry, [chunk])
            carries.append(carry)
            outs.append(o)
        _TRACE[family] = (carries, outs)
    return _TRACE[family]


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
        return
    assert a.dtype == b.dtype and torch.equal(a, b), path


class Clock:
    """An injected clock: ``tick`` seconds later at every reading."""

    def __init__(self, tick: float = 0.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _served_publisher(**kw):
    pub = SnapshotPublisher(**kw)
    assert pub.publish(0, model_state_of(_trace("vht")[0][0]))
    return pub


def _server(pub=None, clock=None, **cfg):
    cfg = {"max_batch": 8, "max_wait_ms": 1.0, "queue_limit": 16,
           "deadline_ms": 60_000.0, **cfg}
    return ModelServer(LEARNERS["vht"], pub or _served_publisher(),
                       ServeConfig(**cfg), start=False,
                       clock=clock or Clock())


def _row(i):
    return XS[0][i % B]


def _accounted(st):
    return (st["accounting_ok"] and st["pending"] == 0
            and st["submitted"] == st["answered"] + st["shed"]
            + st["rejected_overloaded"] + st["rejected_unavailable"])


# ------------------------------------------------------------- publisher

def test_model_state_of_unwraps_single_processor_carry():
    state = {"w": torch.ones(2)}
    assert model_state_of({"states": {"vht": state},
                           "feedback": None}) is state
    assert model_state_of(state) is state       # a state passes as it is
    fleet = {"tenant": {"w": torch.arange(6.0).reshape(3, 2)},
             "cursor": torch.zeros(3)}
    assert torch.equal(tenant_state_of(fleet, 1)["w"], torch.tensor([2., 3.]))
    with pytest.raises(TypeError, match="not a fleet"):
        tenant_state_of(state, 0)


@pytest.mark.parametrize("reason", ["non_finite", "structure"])
def test_publisher_rejects_and_keeps_the_last_good(reason):
    """A non-finite candidate, or one whose structure would not round-trip
    a checkpoint manifest, is rejected; the last good snapshot stays, the
    train cursor moves on, and the events are the JAX package's."""
    good = {"w": [1.0, 2.0, 3.0]}
    bad = ({"w": [1.0, float("nan"), 2.0]} if reason == "non_finite" else
           collections.OrderedDict([("w", [1.0, 2.0, 3.0])]))

    def run(pub, tensor):
        assert pub.publish(0, {"w": tensor(good["w"])})
        assert not pub.publish(1, type(bad)((k, tensor(v))
                                            for k, v in bad.items()))
        return pub

    pub = run(SnapshotPublisher(), torch.tensor)
    jpub = run(JaxPublisher(), jnp.asarray)
    snap = pub.current()
    assert snap.version == 1 and snap.chunk_index == 0
    assert torch.equal(snap.state["w"], torch.tensor(good["w"]))
    assert pub.rejected_snapshots == 1 and pub.staleness() == 1
    assert pub.events == jpub.events == [("reject", 1, reason)]


def test_publisher_double_buffer_survives_in_place_writes():
    """The published state is a copy: an add_ on the carry it came from,
    and two more chunks of the compiled step on that carry, leave the
    snapshot as it was published."""
    learner, eng = LEARNERS["vht"], JitEngine()
    chunks = list(_stream())
    carry, _ = eng.run_stream_chunked(
        learner, eng.init(learner, prng.PRNGKey(0, CPU)), chunks[:1])
    pub = SnapshotPublisher()
    assert pub.publish(0, model_state_of(carry))
    want = {k: v.clone() for k, v in model_state_of(carry).items()}
    model_state_of(carry)["stats"].add_(1.0)
    model_state_of(carry)["n_nodes"].add_(5)
    eng.run_stream_chunked(learner, carry, chunks[1:3])
    _assert_same(pub.current().state, want)


def test_publisher_breaker_trips_after_consecutive_rejects_and_heals():
    pub = SnapshotPublisher(breaker_threshold=2)
    good, bad = {"w": torch.ones(2)}, {"w": torch.tensor([float("inf"), 0.])}
    assert pub.publish(0, good)
    assert not pub.publish(1, bad)
    assert not pub.breaker_open              # 1 in a row < 2
    assert not pub.publish(2, bad)
    assert pub.breaker_open and pub.breaker_trips == 1 and pub.degraded()
    assert pub.publish(3, good)              # heals without a restart
    assert not pub.breaker_open and not pub.degraded()
    assert pub.consecutive_rejections == 0
    assert pub.events[-2:] == [("breaker_open", 2), ("breaker_close", 3)]


def test_publisher_staleness_limit_flips_degraded_and_recovers():
    pub = SnapshotPublisher(max_staleness_chunks=2)
    good = {"w": torch.ones(2)}
    assert pub.degraded()                    # nothing published yet
    assert pub.publish(0, good) and not pub.degraded()
    for i in (1, 2):
        pub.observe(i)                       # stalled; training goes on
    assert pub.staleness() == 2 and not pub.degraded()   # at the limit
    pub.observe(3)
    assert pub.staleness() == 3 and pub.degraded()
    assert pub.publish(4, good)
    assert pub.staleness() == 0 and not pub.degraded()


def test_publisher_spills_accepted_snapshots_to_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path)
    pub = SnapshotPublisher(checkpoint=mgr)
    assert pub.publish(2, {"w": torch.arange(4, dtype=torch.float32)})
    assert not pub.publish(3, {"w": torch.tensor([float("nan")])})
    blob, step = mgr.restore_structured()
    assert step == 2 and mgr.all_steps() == [2]
    np.testing.assert_array_equal(blob["w"], np.arange(4, dtype=np.float32))


# ---------------------------------------------------- serve/train parity

@pytest.mark.parametrize("family", FAMILIES)
def test_snapshot_predict_parity(family):
    """At every chunk boundary k, the snapshot's fast-path predict on chunk
    k+1's first batch equals reference_predict (the plain versions) bit for
    bit, the JAX package's predict on the same state, and the training
    step's own metric for that batch: correct (VHT, OzaBag), abs_err
    (AMRules, rtol 1e-5) or ssq (CluStream, rtol 1e-5)."""
    learner = LEARNERS[family]
    carries, outs = _trace(family)
    fast = make_predict_fn(learner)
    jax_fn = jax_predict_fn(JAX_LEARNERS[family]())
    payload = _payload(family)
    for k in range(N_CHUNKS - 1):
        pub = SnapshotPublisher()
        assert pub.publish(k, model_state_of(carries[k]))
        state = pub.current().state
        x = torch.from_numpy(payload["x"][(k + 1) * C].copy())
        pred = fast(state, x)
        assert torch.equal(pred, reference_predict(
            learner, model_state_of(carries[k]), x))
        jstate = jax.tree.map(jnp.asarray, state_to_numpy(state))
        np.testing.assert_array_equal(
            pred.numpy(), np.asarray(jax_fn(jstate, jnp.asarray(x.numpy()))))
        m = {key: float(v[0]) for key, v in outs[k + 1]["metrics"].items()}
        p = pred.numpy()
        if family in ("vht", "ozabag"):
            y = payload["y"][(k + 1) * C]
            assert m["correct"] == float(np.sum(p == y))
        elif family == "amrules":
            y = payload["y"][(k + 1) * C]
            np.testing.assert_allclose(m["abs_err"],
                                       float(np.sum(np.abs(y - p))),
                                       rtol=1e-5)
        else:
            d2 = pairwise_d2(x, state["macro"]).numpy()
            np.testing.assert_allclose(m["ssq"], float(d2.min(-1).sum()),
                                       rtol=1e-5)


# ---------------------------------------------------------------- server

@pytest.mark.parametrize("at", ["max_batch", "max_wait"])
def test_microbatch_flushes(at):
    """A batch closes at max_batch requests, or when max_wait_ms has passed
    on the server's clock (here 1 ms a reading, so the window of 2.5 ms
    takes the first request and the next two); it is padded to max_batch
    rows and its answers are the fast path's on the real rows."""
    if at == "max_batch":
        srv = _server(max_batch=4, max_wait_ms=50.0)
        sizes = (4, 2)
    else:
        srv = _server(max_batch=64, max_wait_ms=2.5, clock=Clock(1e-3))
        sizes = (3, 3)
    reqs = [srv.submit(_row(i)) for i in range(6)]
    assert [srv.poll() for _ in sizes] == list(sizes)
    assert srv.poll() == 0
    assert [r.meta["batch_size"] for r in reqs] == \
        [n for n in sizes for _ in range(n)]
    state = srv.publisher.current().state
    want = reference_predict(LEARNERS["vht"], state,
                             torch.from_numpy(XS[0][:6].copy())).numpy()
    assert [int(r.pred) for r in reqs] == want.tolist()
    assert srv.status()["batches"] == 2 and _accounted(srv.status())


def test_admission_control_bounded_queue_explicit_overload():
    srv = _server(queue_limit=6)       # no dispatcher: the queue must bound
    reqs = [srv.submit(_row(i)) for i in range(10)]
    over = [r for r in reqs if r.status == "overloaded"]
    assert len(over) == 4 and all(r.done() for r in over)
    assert all(r.meta["reason"] == "queue_full" for r in over)
    assert srv.max_queue_depth == 6
    assert srv.poll() == 6
    st = srv.status()
    assert st["answered"] == 6 and st["rejected_overloaded"] == 4
    assert _accounted(st)


def test_deadline_expired_requests_are_shed_not_answered():
    clock = Clock()
    srv = _server(clock=clock)
    dead = [srv.submit(_row(i), deadline_ms=0.5) for i in range(3)]
    live = [srv.submit(_row(i)) for i in range(3, 5)]
    clock.t += 1e-3                     # the short deadlines pass
    assert srv.poll() == 5
    assert [r.status for r in dead] == ["shed"] * 3
    assert all(r.meta["reason"] == "deadline_expired" for r in dead)
    assert [r.status for r in live] == ["answered"] * 2
    assert all(r.meta["batch_size"] == 2 for r in live)
    st = srv.status()
    assert st["shed"] == 3 and st["answered"] == 2 and _accounted(st)


def test_requests_before_first_snapshot_rejected_unavailable():
    srv = _server(pub=SnapshotPublisher())      # nothing published
    r = srv.submit(_row(0))
    assert r.done() and r.status == "unavailable"
    assert r.meta["reason"] == "no_snapshot"
    assert srv.status()["rejected_unavailable"] == 1
    with pytest.raises(ValueError, match="requires a LearnerFleet"):
        srv.submit(_row(0), tenant=0)       # routing needs a fleet


def test_answers_report_staleness_and_degraded_truthfully():
    clock = Clock()
    pub = _served_publisher(max_staleness_chunks=1)
    for i in (1, 2, 3):
        pub.observe(i)                  # stalled publisher, training at 3
    srv = _server(pub=pub, clock=clock)
    r = srv.submit(_row(0))
    clock.t += 0.004
    assert srv.poll() == 1
    assert r.status == "answered"
    assert r.meta["staleness_chunks"] == 3 and r.meta["degraded"] is True
    assert r.meta["snapshot_version"] == 1 and r.meta["snapshot_chunk"] == 0
    assert r.meta["latency_ms"] == pytest.approx(4.0)
    assert srv.status()["degraded_answers"] == 1


def test_request_burst_10x_bounded_queue_exact_accounting():
    """Ten times the queue's bound, back to back: exactly queue_limit are
    admitted, the rest answered overloaded at once; every admitted one is
    answered, finite."""
    srv = _server(queue_limit=16, max_batch=8)
    xs = np.random.default_rng(0).integers(0, 8, (160, 12)).astype(np.int32)
    reqs = request_burst(srv, xs)
    assert sum(r.status == "overloaded" for r in reqs) == 144
    assert srv.poll() == 8 and srv.poll() == 8 and srv.poll() == 0
    st = srv.status()
    assert st["submitted"] == 160 and st["answered"] == 16
    assert st["rejected_overloaded"] == 144 and st["max_queue_depth"] == 16
    assert _accounted(st)
    for r in reqs:
        assert r.status in TERMINAL
        if r.status == "answered":
            assert np.isfinite(float(r.pred))


def test_submit_after_stop_resolves_unavailable():
    srv = _server()
    srv.start()
    srv.stop()
    r = srv.submit(_row(0))
    assert r.done() and r.status == "unavailable"
    assert r.meta["reason"] == "server_stopped"
    assert _accounted(srv.status())


@pytest.mark.parametrize("round_", range(3))
def test_submit_hammering_concurrent_stop_never_hangs(round_):
    """Four threads submit while the main thread stops the server (without
    draining): every request reaches a terminal state, the books balance,
    and a submit after the stop is unavailable."""
    srv = _server(max_batch=8, queue_limit=32, max_wait_ms=0.5)
    srv.start()
    reqs, lock, go = [], threading.Lock(), threading.Event()

    def hammer():
        go.wait(timeout=30)
        mine = [srv.submit(_row(i)) for i in range(200)]
        with lock:
            reqs.extend(mine)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    go.set()
    for _ in range(round_ * 50):        # vary where the stop lands
        srv.publisher.status()
    srv.stop(drain=False)
    for t in threads:
        t.join(timeout=60)
    for r in reqs:
        assert r.result(timeout=10).status in TERMINAL
    st = srv.status()
    assert st["submitted"] == len(reqs) == 800 and _accounted(st)
    late = srv.submit(_row(0))
    assert late.status == "unavailable"
    assert late.meta["reason"] == "server_stopped"


# ----------------------------------- the server while training publishes

def test_poison_snapshot_rejected_training_untouched():
    """A NaN in chunk 1's published snapshot (not in the training carry)
    never reaches readers, and the run ends as a clean one."""
    inj = FaultInjector(poison_snapshot_at_chunk=1)
    pub = SnapshotPublisher()
    res = ChunkedPrequentialEvaluation(
        LEARNERS["vht"], _stream(), publisher=inj.wrap_publisher(pub),
        check_finite=False).run(resume=False)
    assert pub.rejected_snapshots == 1 and inj.snapshot_poisoned
    assert pub.published == N_CHUNKS - 1
    assert pub.current().chunk_index == N_CHUNKS - 1
    assert pub.staleness() == 0 and not pub.degraded()
    assert res.extra["report"]["snapshots"]["rejected_snapshots"] == 1
    _assert_same(res.extra["carry"], _trace("vht")[0][-1])


def test_publisher_stall_degrades_then_recovers_while_serving():
    """Publications of chunks 1 and 2 stall while a server answers: after
    chunk 2 the staleness passes its limit of 1 and the answers say
    degraded; chunk 3's publication heals it without a restart.  The
    states are read at each chunk's boundary (on_chunk), not timed."""
    inj = FaultInjector(stall_publish_chunks=(1, 2))
    pub = SnapshotPublisher(max_staleness_chunks=1)
    srv = ModelServer(LEARNERS["vht"], pub,
                      ServeConfig(max_batch=8, max_wait_ms=1.0,
                                  queue_limit=64, deadline_ms=60_000.0))
    seen, reqs = [], []

    def on_chunk(outs, chunk, carry):
        seen.append((chunk.index, pub.staleness(), pub.degraded()))
        reqs.append(srv.submit(_row(chunk.index)))

    res = ChunkedPrequentialEvaluation(
        LEARNERS["vht"], _stream(), publisher=inj.wrap_publisher(pub),
        injector=inj, check_finite=False, on_chunk=on_chunk).run(resume=False)
    last = srv.submit(_row(0)).result(timeout=30)
    for r in reqs:
        r.result(timeout=30)
    srv.stop()
    assert inj.stalled_publishes == 2
    assert seen == [(0, 0, False), (1, 1, False), (2, 2, True),
                    (3, 0, False)]
    assert last.status == "answered" and last.meta["degraded"] is False
    assert last.meta["snapshot_version"] == 2
    assert all(r.status == "answered" and np.isfinite(float(r.pred))
               for r in reqs)
    assert _accounted(srv.status())
    _assert_same(res.extra["carry"], _trace("vht")[0][-1])


# the most requests the train-while-serve test submits during the run
MAX_REQUESTS = 2000


def test_train_while_serve_answers_from_the_named_snapshot():
    """A pipelined run trains and publishes at every chunk while the main
    thread plays requests at a running server: every request is answered,
    the books balance, the run equals a clean one, and each answer equals
    reference_predict on the snapshot version it names.  The server's clock
    stands still, so no deadline passes, and its queue holds more than the
    test sends: however the threads are scheduled, nothing is shed or
    refused."""
    pub = SnapshotPublisher()
    srv = ModelServer(LEARNERS["vht"], pub,
                      ServeConfig(max_batch=4, max_wait_ms=1.0,
                                  queue_limit=MAX_REQUESTS + 8,
                                  deadline_ms=1.0),
                      clock=lambda: 0.0)
    snaps = {}

    def on_chunk(outs, chunk, carry):
        snap = pub.current()
        snaps[snap.version] = snap

    # a first snapshot before the requests start, from the untrained state
    learner = LEARNERS["vht"]
    assert pub.publish(-1, learner.init())
    snaps[1] = pub.current()
    done, result = threading.Event(), {}

    def train():
        result["res"] = ChunkedPrequentialEvaluation(
            learner, _stream(), publisher=pub,
            on_chunk=on_chunk).run(resume=False)
        done.set()

    t = threading.Thread(target=train)
    t.start()
    reqs = []
    while not done.is_set() and len(reqs) < MAX_REQUESTS:
        reqs.append(srv.submit(_row(len(reqs))))
        done.wait(timeout=0.001)
    t.join(timeout=120)
    reqs += [srv.submit(_row(i)) for i in range(4)]
    for r in reqs:
        r.result(timeout=30)
    srv.stop()
    assert _accounted(srv.status())
    assert all(r.status == "answered" for r in reqs)
    assert sorted(snaps) == list(range(1, N_CHUNKS + 2))
    assert {r.meta["snapshot_version"] for r in reqs} <= set(snaps)
    assert reqs[-1].meta["snapshot_version"] == N_CHUNKS + 1
    for r in reqs:
        state = snaps[r.meta["snapshot_version"]].state
        want = reference_predict(learner, state,
                                 torch.from_numpy(r.x[None].copy()))
        assert int(r.pred) == int(want[0])
    _assert_same(result["res"].extra["carry"], _trace("vht")[0][-1])
