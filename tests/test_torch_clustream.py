"""The port's CluStream (src/repro_torch/ml/clustream.py) against the JAX
package's on the CPU, on the same inputs: the stream and configuration of
tests/test_chunked.py (RandomTreeGenerator(6 + 6, depth 5) binned to 8,
B = 64, CluStreamConfig(n_dims=12, n_micro=16, n_macro=3, period=2 * B)).

Tolerances, leaf by leaf.  The CF sums (n, ls, ss, lt, st), the clock and
every instance's segment are bit for bit: the port's CF scatter sums in
XLA's instance order, and the init draws JAX's uniforms.  The macro
centroids come out of the k-means' float32 products (``oh.T @ cent``),
which sum in another order than XLA's dot: they are held within rtol 1e-6
(they have been equal on this stream).  The ``ssq`` metric sums squared
distances made by ``x @ c.T``: rtol 2e-6 (it differs by an ulp or two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.engines import JitEngine as JaxJitEngine
from repro.data.generators import RandomTreeGenerator as JaxTreeGen
from repro.data.generators import bin_numeric as jax_bin
from repro.ml import clustream as jcs

from repro_torch.core import compiled, prng
from repro_torch.core.compiled import compile_step
from repro_torch.core.engines import JitEngine, LocalEngine
from repro_torch.core.evaluation import stack_outputs
from repro_torch.core.topology import LearnerProcessor
from repro_torch.data.pipeline import ChunkedStream
from repro_torch.kernels.rule_stats import ops as rule_stats_ops
from repro_torch.ml import clustream as tcs

B, T = 64, 9
CPU = "cpu"
CC = dict(n_dims=12, n_micro=16, n_macro=3, period=2 * B)
CF_KEYS = ("n", "ls", "ss", "lt", "st", "t", "macro_t")


def _make_stream():
    gen = JaxTreeGen(n_cat=6, n_num=6, depth=5, seed=3)
    key = jax.random.PRNGKey(0)
    xs = []
    for _ in range(T):
        key, k = jax.random.split(key)
        x, _ = gen.sample(k, B)
        xs.append(jax_bin(x, 8))
    return np.asarray(jnp.stack(xs)).astype(np.float32)


XS = _make_stream()


def _x(t):
    return torch.from_numpy(XS[t].copy())


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_state(got, want, what=""):
    """CF leaves bit for bit; the macro centroids within rtol 1e-6."""
    assert set(got) == set(want)
    for k in CF_KEYS:
        np.testing.assert_array_equal(_bits(_np(got[k])), _bits(want[k]),
                                      err_msg=f"{what} {k}")
    np.testing.assert_allclose(_np(got["macro"]), want["macro"], rtol=1e-6,
                               atol=1e-6, err_msg=f"{what} macro")


def _cfg(**kw):
    return {**CC, **kw}


def _segments_jax(state, x, cc):
    """Each instance's segment as the JAX package's update takes it."""
    cent = jcs._centroids(state)
    d2 = jcs.pairwise_d2(x, cent, jcs._impl(cc))
    nearest = jnp.argmin(d2, -1)
    ndist = jnp.sqrt(jnp.take_along_axis(d2, nearest[:, None], 1)[:, 0])
    rad = jcs._radius(state)[nearest] * cc.radius_factor + 1e-6
    return jnp.where(ndist <= rad, nearest, cc.n_micro)


def _segments_port(state, x, cc):
    cent = tcs._centroids(state)
    d2 = tcs.pairwise_d2(x, cent, tcs._impl(cc))
    nearest = torch.argmin(d2, -1)
    ndist = tcs.sqrt(torch.gather(d2, 1, nearest[:, None])[:, 0])
    rad = tcs._radius(state)[nearest] * cc.radius_factor + 1e-6
    return torch.where(ndist <= rad, nearest, cc.n_micro).numpy()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's step-mode runs (segment and onehot), batch by
    batch: [(state before, metrics)] and the final state; one compile
    each."""
    out = {}
    for impl in ("segment", "onehot"):
        cc = jcs.CluStreamConfig(**_cfg(stats_impl=impl))
        learner = jcs.CluStream(cc)
        step = jax.jit(learner.step)
        st = learner.init(jax.random.PRNGKey(0))
        trace = []
        jax_seg = jax.jit(lambda s, x, cc=cc: _segments_jax(s, x, cc))
        for t in range(T):
            before = jax.tree.map(np.asarray, st)
            seg = np.asarray(jax_seg(st, XS[t]))
            st, m = step(st, XS[t])
            trace.append((before, seg, jax.tree.map(np.asarray, m)))
        out[impl] = (trace, jax.tree.map(np.asarray, st))
    return out


def test_init_draws_jax_centers_bit_for_bit():
    j = jcs.CluStream(jcs.CluStreamConfig(**CC)).init(jax.random.PRNGKey(3))
    t = tcs.CluStream(tcs.CluStreamConfig(**CC), device=CPU).init(
        prng.PRNGKey(3, CPU))
    for k in j:
        np.testing.assert_array_equal(_bits(t[k].numpy()), _bits(j[k]),
                                      err_msg=k)
    default = tcs.CluStream(tcs.CluStreamConfig(**CC), device=CPU).init()
    assert torch.equal(default["ls"], tcs.CluStream(
        tcs.CluStreamConfig(**CC), device=CPU).init(
            prng.PRNGKey(0, CPU))["ls"])


@pytest.mark.parametrize("impl", ["segment", "onehot"])
def test_step_mode_matches_jax_batch_by_batch(jax_runs, impl):
    """Every batch: each instance's segment and the CF state bit for bit,
    the macro centroids within rtol 1e-6, seen and n_active exactly, ssq
    within rtol 2e-6; the macro phase fires (period = 2 batches)."""
    trace, final = jax_runs[impl]
    cc = tcs.CluStreamConfig(**_cfg(stats_impl=impl))
    learner = tcs.CluStream(cc, device=CPU)
    st = learner.init(prng.PRNGKey(0, CPU))
    for t, (before, seg, m) in enumerate(trace):
        _assert_state(st, before, f"batch {t}")
        np.testing.assert_array_equal(_segments_port(st, _x(t), cc), seg)
        st, got = learner.step(st, _x(t))
        assert float(got["seen"]) == m["seen"]
        assert float(got["n_active"]) == m["n_active"]
        np.testing.assert_allclose(float(got["ssq"]), m["ssq"], rtol=2e-6)
    _assert_state(st, final, "final")
    assert float(st["macro_t"]) == 8 * B


def test_run_matches_the_jax_scan_and_refuses_boundary_mode(jax_runs):
    trace, final = jax_runs["segment"]
    learner = tcs.CluStream(tcs.CluStreamConfig(**CC), device=CPU)
    st, ms = learner.run(learner.init(prng.PRNGKey(0, CPU)),
                         torch.from_numpy(XS))
    _assert_state(st, final)
    np.testing.assert_allclose(ms["ssq"].numpy(),
                               [m["ssq"] for _, _, m in trace], rtol=2e-6)
    bdry = tcs.CluStream(tcs.CluStreamConfig(**_cfg(macro_impl="boundary")),
                         device=CPU)
    with pytest.raises(ValueError, match="boundary"):
        bdry.run(bdry.init(), torch.from_numpy(XS[:2]))


def test_cf_scatter_goes_through_segment_sum(monkeypatch):
    """The segment path scatters x | x^2 (2d columns) and 1 | t | t^2 (3)
    through segment_sum, two calls a step; onehot takes none."""
    calls = []
    real = rule_stats_ops.segment_sum

    def spy(out, seg, xbin, vals):
        calls.append(tuple(out.shape))
        return real(out, seg, xbin, vals)

    monkeypatch.setattr(tcs, "segment_sum", spy)
    for impl, want in (("segment", [(17, 1, 1, 24), (17, 1, 1, 3)]),
                       ("onehot", [])):
        calls.clear()
        learner = tcs.CluStream(tcs.CluStreamConfig(**_cfg(stats_impl=impl)),
                                device=CPU)
        learner.step(learner.init(), _x(0))
        assert calls == want


@pytest.fixture(scope="module")
def jax_boundary_run():
    """The JAX package's boundary-mode run on its chunked driver (7
    batches in chunks of 2, period 3 batches): final carry and outputs."""
    cc = jcs.CluStreamConfig(**_cfg(macro_impl="boundary", period=3 * B))
    learner = jcs.CluStream(cc)
    eng = JaxJitEngine()
    carry = eng.init(learner, jax.random.PRNGKey(0))
    carry, outs = eng.run_stream(learner, carry, {"x": XS[:7]}, chunk_len=2)
    return jax.tree.map(np.asarray, carry), jax.tree.map(np.asarray, outs)


def test_boundary_mode_chunked_matches_jax_and_the_eager_oracle(
        jax_boundary_run):
    """Boundary mode on the port's chunked runtime: against the JAX
    package's chunked run (the per-leaf tolerances above) and, bit for
    bit, against LocalEngine's eager ChunkedStream loop; the macro phase
    fires mid-stream."""
    want_carry, want_outs = jax_boundary_run
    cs = tcs.CluStream(tcs.CluStreamConfig(
        **_cfg(macro_impl="boundary", period=3 * B)), device=CPU)
    payload = {"x": torch.from_numpy(XS[:7])}
    eng = JitEngine()
    carry, outs = eng.run_stream(cs, eng.init(cs, prng.PRNGKey(0, CPU)),
                                 payload, chunk_len=2)
    _assert_state(carry["states"]["clustream"],
                  want_carry["states"]["clustream"])
    np.testing.assert_allclose(outs["metrics"]["ssq"].numpy(),
                               want_outs["metrics"]["ssq"], rtol=2e-6)
    np.testing.assert_array_equal(outs["metrics"]["n_active"].numpy(),
                                  want_outs["metrics"]["n_active"])
    loc = LocalEngine()
    states, louts = loc.run_stream(
        cs, loc.init(cs, prng.PRNGKey(0, CPU)),
        ChunkedStream(payload, 2, device=CPU))
    for k, v in states["clustream"].items():
        assert torch.equal(v, carry["states"]["clustream"][k]), k
    for k, v in stack_outputs(louts)["metrics"].items():
        assert torch.equal(v, outs["metrics"][k]), k
    assert float(states["clustream"]["macro_t"]) > 0


def test_boundary_mode_equals_step_mode_when_aligned():
    """With the period aligned to chunk_len * B, the boundary hook fires
    where the gate in the step would: the same final state, bit for
    bit."""
    payload = {"x": torch.from_numpy(XS[:8])}
    key = prng.PRNGKey(0, CPU)
    step_cs = tcs.CluStream(tcs.CluStreamConfig(**CC), device=CPU)
    bdry_cs = tcs.CluStream(tcs.CluStreamConfig(**_cfg(macro_impl="boundary")),
                            device=CPU)
    e1, e2 = JitEngine(), JitEngine()
    c1, _ = e1.run_stream(step_cs, e1.init(step_cs, key), payload)
    c2, _ = e2.run_stream(bdry_cs, e2.init(bdry_cs, key), payload,
                          chunk_len=2)
    assert float(c1["states"]["clustream"]["macro_t"]) > 0
    for k, v in c1["states"]["clustream"].items():
        assert torch.equal(v, c2["states"]["clustream"][k]), k


def test_boundary_hooks_refuse_drivers_that_are_not_chunked():
    cs = tcs.CluStream(tcs.CluStreamConfig(**_cfg(macro_impl="boundary")),
                       device=CPU)
    payload = {"x": torch.from_numpy(XS[:2])}
    eng = JitEngine()
    with pytest.raises(ValueError, match="boundary"):
        eng.run_stream(cs, eng.init(cs), payload)
    with pytest.raises(ValueError, match="boundary"):
        LocalEngine().run_stream(cs, LocalEngine().init(cs), payload)
    carry, _ = JitEngine().run_stream(cs, JitEngine().init(cs), payload,
                                      chunk_len=2)
    assert carry["states"]["clustream"]["t"] == 2 * B


def test_step_mode_exposes_no_boundary_hook_and_configs_are_checked():
    assert LearnerProcessor(tcs.CluStream(tcs.CluStreamConfig(**CC),
                                          device=CPU)).boundary is None
    assert LearnerProcessor(tcs.CluStream(tcs.CluStreamConfig(
        **_cfg(macro_impl="boundary")), device=CPU)).boundary is not None
    with pytest.raises(ValueError):
        tcs.CluStream(tcs.CluStreamConfig(**_cfg(macro_impl="nope")))
    with pytest.raises(ValueError):
        learner = tcs.CluStream(tcs.CluStreamConfig(**_cfg(stats_impl="x")),
                                device=CPU)
        learner.step(learner.init(), _x(0))


def test_merge_assign_and_ssq_match_jax(jax_runs):
    """merge adds every CF leaf (the clock too) and keeps the first
    shard's macro; assign and ssq against the JAX package's functions."""
    (a, _, _), (b, _, _) = jax_runs["segment"][0][3], jax_runs["segment"][0][6]
    want = jcs.merge([a, b])
    got = tcs.merge([{k: torch.from_numpy(v.copy()) for k, v in s.items()}
                     for s in (a, b)])
    for k in want:
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(np.asarray(want[k])), err_msg=k)
    centers = b["macro"]
    np.testing.assert_array_equal(
        tcs.assign(torch.from_numpy(centers.copy()), _x(4)).numpy(),
        np.asarray(jcs.assign(centers, XS[4])))
    np.testing.assert_allclose(
        float(tcs.ssq(torch.from_numpy(centers.copy()), _x(4))),
        float(jcs.ssq(centers, XS[4])), rtol=2e-6)


@pytest.mark.parametrize("mode", ["step", "boundary"])
def test_capturable_step_reads_nothing_on_the_host(mode, monkeypatch):
    """The step (and, in boundary mode, the boundary hook) in its
    capturable form converts no tensor to a Python value outside cond's
    read of its predicate and the kernel's plain version; it gives the
    eager step's bits."""
    learner = tcs.CluStream(tcs.CluStreamConfig(**_cfg(macro_impl=mode)),
                            device=CPU)
    eager = learner.init()
    state = learner.init()
    step = compile_step(learner.step, state, _x(0))
    hook = compile_step(lambda s: (learner.boundary(s), {}), state) \
        if mode == "boundary" else None
    allowed, reads = [0], []

    def guard(name, orig):
        def call(self, *a, **kw):
            if not allowed[0]:
                raise AssertionError(f"Tensor.{name} in a capturable step")
            return orig(self, *a, **kw)
        return call

    def allow(orig):
        def call(*a, **kw):
            allowed[0] += 1
            out = orig(*a, **kw)
            allowed[0] -= 1
            return out
        return call

    read = compiled._read
    monkeypatch.setattr(compiled, "_read",
                        allow(lambda p: reads.append(1) or read(p)))
    monkeypatch.setattr(rule_stats_ops, "rule_stats_scatter_ref",
                        allow(rule_stats_ops.rule_stats_scatter_ref))
    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "nonzero", "numpy"):
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))
    outs = []
    for t in range(4):
        state, m = step(state, _x(t))
        if hook is not None and t % 2:
            state, _ = hook(state)
        outs.append(m["ssq"].clone())
    monkeypatch.undo()
    assert reads
    for t in range(4):
        eager, m = learner.step(eager, _x(t))
        if hook is not None and t % 2:
            eager = learner.boundary(eager)
        assert torch.equal(m["ssq"], outs[t])
    for k, v in eager.items():
        assert torch.equal(v, state[k]), k
