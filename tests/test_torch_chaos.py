"""The port's chaos layer (``repro_torch.runtime.chaos``) against its
recovery machinery on the CPU, and against the JAX package's.

Every fault the ``FaultInjector`` produces must be survived as the JAX
package survives it: a killed run resumes bit for bit, on both drivers; a
corrupt checkpoint falls back to the newest intact one; a flaky source
retries with the JAX package's deterministic backoff and the report counts
its retries exactly past the ring buffer's cap; a poisoned chunk rolls
back and is retried or skipped with the JAX package's report events, bit
for bit its final carry, metric and curve.  The stream and learner are
tests/test_chaos.py's: VHT on TreeConfig(max_nodes=63, n_min=20), B = 64,
8 batches of 12 binned attributes in chunks of 3 (chunks 0, 1 and 2, the
last padded), drawn once as numpy arrays and fed to both packages."""

import json
import os
import pathlib
import subprocess
import sys

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
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import VHT as JaxVHT
from repro.ml.vht import VHTConfig as JaxVHTConfig
from repro.runtime import FaultInjector as JaxInjector
from repro.runtime import poison_carry as jax_poison_carry

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import state_to_numpy
from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
from repro_torch.data.pipeline import (ChunkedStream, StreamSourceError,
                                       TransientSourceError)
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig
from repro_torch.runtime import (FaultInjector, SimulatedKill, chaos,
                                 carry_all_finite, carry_finite_flag,
                                 corrupt_checkpoint, poison_carry)

B, T, C = 64, 8, 3
N_CHUNKS = -(-T // C)
CPU = "cpu"
TC = dict(n_attrs=12, n_bins=8, n_classes=2, max_nodes=63, n_min=20,
          delta=0.05, tau=0.1)
DRIVERS = {"sync": {"pipeline": False},
           "pipelined": {"pipeline": True, "max_inflight_chunks": 4}}


def _make_payload():
    gen = JaxTreeGen(n_cat=6, n_num=6, depth=5, seed=3)
    key = jax.random.PRNGKey(0)
    xs, ys = [], []
    for _ in range(T):
        key, k = jax.random.split(key)
        x, y = gen.sample(k, B)
        xs.append(jax_bin(x, 8))
        ys.append(y)
    return {"x": np.asarray(jnp.stack(xs)).astype(np.int32),
            "y": np.asarray(jnp.stack(ys)).astype(np.int32)}


PAYLOAD = _make_payload()
LEARNER = VHT(VHTConfig(TreeConfig(**TC)), device=CPU)
# one JAX learner and engine for the module: its chunk programs compile
# once and every later JAX run reuses them
JAX_LEARNER = JaxVHT(JaxVHTConfig(JaxTreeConfig(**TC)))
JAX_ENGINE = JaxJitEngine()


def _fetch(i):
    return {k: torch.from_numpy(v[i * C:(i + 1) * C].copy())
            for k, v in PAYLOAD.items()}


def _stream():
    return ChunkedStream({k: torch.from_numpy(v.copy())
                          for k, v in PAYLOAD.items()}, C, device=CPU)


def _evaluation(driver="sync", **kw):
    return ChunkedPrequentialEvaluation(LEARNER, _stream(), **DRIVERS[driver],
                                        **kw)


def _jax_evaluation(**kw):
    return JaxChunked(JAX_LEARNER, JaxStream(PAYLOAD, C), engine=JAX_ENGINE,
                      **kw)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
        return
    if a is None:
        assert b is None, path
        return
    assert a.dtype == b.dtype and torch.equal(a, b), path


def _assert_like_jax(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_like_jax(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=path)


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted run that every recovery must reproduce."""
    r = _evaluation().run(resume=False)
    assert int(r.extra["carry"]["states"]["vht"]["n_nodes"]) > 1
    return r


# ---------------------------------------------------------------- injector

def test_poison_carry_and_finite_flag():
    """The finite flag is a 0-dim bool tensor, read by nobody; poison_carry
    NaNs element 0 of the JAX package's first float leaf (keys sorted) in a
    new tree and writes none of the caller's tensors; an all-integer carry
    cannot be poisoned."""
    carry = {"b": {"w": torch.ones((2, 2))}, "a": torch.arange(3),
             "c": torch.zeros(2)}
    flag = carry_finite_flag(carry)
    assert flag.dtype == torch.bool and flag.dim() == 0 and bool(flag)
    bad = poison_carry(carry)
    assert carry_all_finite(carry) and not carry_all_finite(bad)
    assert torch.equal(carry["b"]["w"], torch.ones((2, 2)))   # untouched
    assert bad["c"] is carry["c"] and bad["a"] is carry["a"]
    want = jax_poison_carry(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                         carry))
    for k, v in (("a", bad["a"]), ("c", bad["c"]), ("w", bad["b"]["w"])):
        w = want[k] if k != "w" else want["b"]["w"]
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))
    assert bool(carry_finite_flag({"n": torch.arange(4)}))
    assert bool(carry_finite_flag({"big": torch.full((4,), 3e38)}))
    for bad in (float("inf"), float("-inf"), float("nan")):
        mixed = {"f": torch.ones(3), "h": torch.tensor([1.0, bad],
                                                       dtype=torch.bfloat16)}
        assert not bool(carry_finite_flag(mixed))
    with pytest.raises(ValueError, match="no inexact leaf"):
        poison_carry({"n": torch.arange(4)})


def test_injector_kill_latches_and_rejects_unknown_mode():
    inj = FaultInjector(kill_at_chunk=2)
    inj.maybe_kill(0)
    inj.maybe_kill(1)
    with pytest.raises(SimulatedKill) as e:
        inj.maybe_kill(2)
    assert e.value.chunk_index == 2
    inj.maybe_kill(2)               # latched: the fault happened once
    assert inj.killed
    with pytest.raises(ValueError, match="kill_mode"):
        FaultInjector(kill_at_chunk=0, kill_mode="sigpwr")


def test_delay_chunk_fires_once(monkeypatch):
    """A straggler sleeps once, before its chunk; the sleep is recorded,
    not timed."""
    slept = []
    monkeypatch.setattr(chaos.time, "sleep", slept.append)
    inj = FaultInjector()
    assert inj.delay_chunk(1, 0.15) is inj
    for i in (0, 1, 1, 2):
        inj.maybe_delay(i)
    assert slept == [0.15] and inj.delays_fired == {1}


# --------------------------------------------- poisoned chunks roll back

SCENARIOS = {
    "retry": (dict(poison_at_chunk=1), "retry", True),
    "skip-inf": (dict(poison_at_chunk=1, poison_value=float("inf")), "skip",
                 True),
    "retry-no-checkpoint": (dict(poison_at_chunk=1), "retry", False),
}
_JAX_POISON: dict = {}


def _jax_poisoned(name, tmp_path_factory):
    """The JAX package's run of a poison scenario (cached)."""
    if name not in _JAX_POISON:
        inj, policy, ckpt = SCENARIOS[name]
        from repro.checkpoint.manager import CheckpointManager as JaxCkpt
        mgr = (JaxCkpt(tmp_path_factory.mktemp(f"jax-{name}"), keep=0,
                       async_write=False) if ckpt else None)
        ev = _jax_evaluation(checkpoint=mgr, injector=JaxInjector(**inj),
                             poison_policy=policy)
        r = ev.run(resume=False)
        _JAX_POISON[name] = (r, ev.report)
    return _JAX_POISON[name]


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_poison_rolls_back_as_the_jax_package(tmp_path, tmp_path_factory,
                                              reference, scenario, driver):
    """A NaN (or inf) in the carry after chunk 1: the run rolls back to the
    newest checkpoint, or to the initial state without one, and retries or
    skips the chunk; the report's events, rollbacks and skipped chunks are
    the JAX package's, and so are the final carry, metric and curve.  A
    retried run equals the clean one; a skipped chunk's batches are
    missing from the metric."""
    inj, policy, ckpt = SCENARIOS[scenario]
    ev = _evaluation(driver, checkpoint=(CheckpointManager(tmp_path, keep=0)
                                         if ckpt else None),
                     injector=FaultInjector(**inj), poison_policy=policy)
    r = ev.run(resume=False)
    want, want_report = _jax_poisoned(scenario, tmp_path_factory)
    for k in ("events", "skipped_chunks", "rollbacks"):
        assert ev.report[k] == want_report[k], k
    assert r.metric == want.metric and r.curve == want.curve
    assert r.extra["seen"] == want.extra["seen"]
    _assert_like_jax(state_to_numpy(r.extra["carry"]),
                     jax.tree.map(np.asarray, want.extra["carry"]))
    if policy == "retry":
        assert ev.report["rollbacks"] == 1
        assert r.metric == reference.metric and r.curve == reference.curve
        _assert_same(r.extra["carry"], reference.extra["carry"])
    else:
        assert ev.report["skipped_chunks"] == [1]
        assert r.extra["seen"] == reference.extra["seen"] - C * B
        assert len(r.curve) == len(reference.curve) - C


# ------------------------------------------------------ kill and resume

@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("kill_at", range(N_CHUNKS))
def test_kill_then_resume_bit_identical(reference, tmp_path, kill_at, driver):
    """Wherever the run dies, the checkpoints on disk are those written
    before the killed chunk (none when it is chunk 0), and the resumed run
    reproduces the uninterrupted one, bit for bit, on either driver."""
    mgr = CheckpointManager(tmp_path, keep=0)
    killed = _evaluation(driver, checkpoint=mgr,
                         injector=FaultInjector(kill_at_chunk=kill_at))
    with pytest.raises(SimulatedKill):
        killed.run(resume=False)
    mgr.wait()
    assert mgr.latest_step() == (kill_at if kill_at else None)
    ev = _evaluation(driver, checkpoint=CheckpointManager(tmp_path, keep=0))
    r = ev.run(resume=True)
    assert ev.report["events"] == ([("resume", kill_at)] if kill_at else [])
    assert r.metric == reference.metric and r.curve == reference.curve
    _assert_same(r.extra["carry"], reference.extra["carry"])


# the kill phase of the round trip, in a fresh interpreter that imports
# the port alone: argv is (checkpoint directory, payload .npz, tree config,
# chunk length)
KILL_PHASE = """
import json, sys
import numpy as np, torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.evaluation import ChunkedPrequentialEvaluation
from repro_torch.data.pipeline import ChunkedStream
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import VHT, VHTConfig
from repro_torch.runtime import FaultInjector
ckpt, payload, tc, chunk_len = sys.argv[1:5]
data = np.load(payload)
stream = ChunkedStream({k: torch.from_numpy(data[k]) for k in data.files},
                       int(chunk_len), device="cpu")
ChunkedPrequentialEvaluation(
    VHT(VHTConfig(TreeConfig(**json.loads(tc))), device="cpu"), stream,
    checkpoint=CheckpointManager(ckpt, keep=0),
    injector=FaultInjector(kill_at_chunk=1, kill_mode="exit")).run(
        resume=False)
sys.exit("the kill phase finished without dying")
"""


def test_subprocess_kill_resume_round_trip(reference, tmp_path):
    """A real death: a process running the stream leaves by os._exit after
    chunk 1 (its asynchronous checkpoint writer dies with it, and the
    atomic rename keeps the disk intact), and a resume from what it left
    ends as the uninterrupted run, bit for bit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(pathlib.Path(__file__).resolve().parents[1]
                             / "src") + os.pathsep + env.get("PYTHONPATH", ""))
    payload = tmp_path / "payload.npz"
    np.savez(payload, **PAYLOAD)
    kill = subprocess.run(
        [sys.executable, "-c", KILL_PHASE, str(tmp_path / "ckpt"),
         str(payload), json.dumps(TC), str(C)],
        env=env, capture_output=True, text=True, timeout=300)
    assert kill.returncode == 113, kill.stderr[-2000:]
    mgr = CheckpointManager(tmp_path / "ckpt", keep=0)
    assert mgr.latest_step() == 1     # chunk 1's checkpoint never landed
    ev = _evaluation("pipelined", checkpoint=mgr)
    r = ev.run(resume=True)
    assert ev.report["events"] == [("resume", 1)]
    assert r.metric == reference.metric and r.curve == reference.curve
    _assert_same(r.extra["carry"], reference.extra["carry"])


# ------------------------------------------- corrupt-checkpoint fallback

@pytest.mark.parametrize("mode", ["tensor", "truncate", "manifest"])
def test_corrupt_latest_checkpoint_falls_back_to_previous(tmp_path, mode):
    mgr = CheckpointManager(tmp_path, keep=0)
    mgr.save(1, {"x": torch.arange(4.0)})
    mgr.save(2, {"x": torch.arange(4.0) + 10.0})
    mgr.wait()
    assert corrupt_checkpoint(tmp_path, mode=mode) == 2
    tree, step = mgr.restore_structured()
    assert step == 1
    np.testing.assert_array_equal(tree["x"], np.arange(4.0, dtype=np.float32))
    back, step = mgr.restore({"x": torch.zeros(4)})      # a template too
    assert step == 1 and torch.equal(back["x"], torch.arange(4.0))
    with pytest.raises(Exception):
        mgr.restore_structured(step=2)       # the pinned step's bytes
    corrupt_checkpoint(tmp_path, step=1, mode=mode)
    with pytest.raises(Exception):
        mgr.restore_structured()             # no intact checkpoint left


def test_corrupted_latest_resume_replays_bit_identically(reference,
                                                         tmp_path):
    """A run killed after its last chunk, whose newest checkpoint then rots
    on disk: the resume falls back one chunk and replays, and ends as the
    uninterrupted run."""
    mgr = CheckpointManager(tmp_path, keep=0)
    with pytest.raises(SimulatedKill):
        _evaluation(checkpoint=mgr, injector=FaultInjector(
            kill_at_chunk=N_CHUNKS - 1)).run(resume=False)
    mgr.wait()
    corrupt_checkpoint(tmp_path, mode="tensor")
    ev = _evaluation(checkpoint=CheckpointManager(tmp_path, keep=0))
    r = ev.run(resume=True)
    assert ev.report["events"] == [("resume", N_CHUNKS - 2)]
    assert r.metric == reference.metric and r.curve == reference.curve
    _assert_same(r.extra["carry"], reference.extra["carry"])


# ------------------------------------------------ self-healing ingestion

def test_flaky_source_retries_as_the_jax_package(reference):
    """Chunk 1's fetch fails twice and heals: the retries (chunk, attempt
    and the jittered backoff) are the JAX package's, and the evaluation
    over the flaky source equals the clean run and reports its retry."""
    def retries_of(stream_cls, inj_cls, to_tensor):
        inj = inj_cls(flaky_chunks=[1], flaky_failures=2)
        s = stream_cls.from_fn(
            inj.wrap_fetch(lambda i: {"x": to_tensor(
                np.full((2,), i, np.float32))}),
            n_chunks=3, chunk_len=2, retries=3, backoff=0.001,
            to_device=False)
        assert [c.index for c in s] == [0, 1, 2]
        return list(s.retry_events)

    got = retries_of(ChunkedStream, FaultInjector, torch.from_numpy)
    want = retries_of(JaxStream, JaxInjector, jnp.asarray)
    assert [e[:3] for e in got] == [e[:3] for e in want]
    assert [e[:2] for e in got] == [(1, 1), (1, 2)]
    inj = FaultInjector(flaky_chunks=[1], flaky_failures=1)
    stream = ChunkedStream.from_fn(inj.wrap_fetch(_fetch), n_chunks=N_CHUNKS,
                                   chunk_len=C, device=CPU, backoff=1e-4)
    ev = ChunkedPrequentialEvaluation(LEARNER, stream, injector=inj)
    r = ev.run(resume=False)
    assert r.metric == reference.metric and r.curve == reference.curve
    _assert_same(r.extra["carry"], reference.extra["carry"])
    rep = r.extra["report"]
    assert [e[:2] for e in rep["source_retries"]] == [(1, 1)]
    assert rep["source_retry_count"] == 1
    assert rep["source_retries_dropped"] == 0


def test_retry_events_ring_buffer_caps_with_exact_count():
    """The retry log keeps its newest events; the count stays exact, also
    through a starting_at view and in the evaluation's report."""
    fails = {i: 2 for i in range(4)}    # 8 retries in all

    def flaky(i):
        if fails.get(i, 0) > 0:
            fails[i] -= 1
            raise TransientSourceError(f"flap {i}")
        return {"x": torch.zeros((1, 2))}

    s = ChunkedStream.from_fn(flaky, n_chunks=4, chunk_len=1, retries=3,
                              backoff=1e-4, backoff_cap=1e-4,
                              retry_events_cap=3, to_device=False)
    assert len(list(s.starting_at(0))) == 4
    assert s.retry_count == 8 and s.retry_events_dropped == 5
    assert [(c, a) for c, a, _, _ in s.retry_events] == [(2, 2), (3, 1),
                                                         (3, 2)]
    inj = FaultInjector(flaky_chunks=(0, 1, 2), flaky_failures=1)
    stream = ChunkedStream.from_fn(inj.wrap_fetch(_fetch), n_chunks=N_CHUNKS,
                                   chunk_len=C, device=CPU, retries=2,
                                   backoff=1e-4, backoff_cap=1e-4,
                                   retry_events_cap=2)
    rep = ChunkedPrequentialEvaluation(LEARNER, stream).run(
        resume=False).extra["report"]
    assert rep["source_retry_count"] == 3
    assert len(rep["source_retries"]) == 2
    assert rep["source_retries_dropped"] == 1


def test_fatal_source_error_names_the_failing_chunk():
    inj = FaultInjector(flaky_chunks=[2], flaky_failures=99)
    s = ChunkedStream.from_fn(inj.wrap_fetch(lambda i: {"x": torch.zeros(2)}),
                              n_chunks=4, chunk_len=2, retries=2, backoff=0.0,
                              to_device=False)
    with pytest.raises(StreamSourceError) as e:
        list(s)
    assert e.value.chunk_index == 2 and e.value.attempts == 3
    assert "chunk 2" in str(e.value)
