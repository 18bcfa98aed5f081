"""The port's compiled steps on the CPU: ``core.compiled`` (``compile_step``,
``cond``), the ``JitEngine`` of ``core.engines``, the capturable gates of
``ml.htree`` and ``ml.amrules``, and the decode step that ``launch.serve``
captures.

On the CPU ``compile_step`` runs a step eagerly in its capturable form, the
form that the card captures into a CUDA graph, and ``cond`` reads its
predicate there, the one place that may; so these tests run the code the
graph holds.  Streams are drawn with numpy and fed to both packages.  The
VHT and AMRules paths add integer counts, or take every float sum in XLA's
CPU order, so they are compared bit for bit; the LM decode step within
tests/test_torch_lm.py's LOGITS_ATOL and bf16 ulps.  The graphs themselves
are held against the eager steps on the card in tests/test_torch_cuda.py.
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

from repro.configs import base as jax_configs
from repro.core.engines import JitEngine as JaxJitEngine
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.ml.amrules import RulesConfig as JaxRulesConfig
from repro.ml.amrules import VAMR as JaxVAMR
from repro.ml.htree import TreeConfig as JaxTreeConfig
from repro.ml.vht import VHT as JaxVHT
from repro.ml.vht import VHTConfig as JaxVHTConfig
from repro.ml.vht import build_vht_topology as jax_build_vht_topology
from repro.models.lm import LanguageModel as JaxLM
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import base as configs
from repro_torch.convert import params_from_numpy, state_to_numpy
from repro_torch.core import compiled
from repro_torch.core.compiled import compile_step
from repro_torch.core.engines import JitEngine, StreamEngine
from repro_torch.core.evaluation import PrequentialEvaluation
from repro_torch.kernels.rule_stats import ops as rule_stats_ops
from repro_torch.kernels.split_poisson import ops as split_poisson_ops
from repro_torch.launch import serve
from repro_torch.ml import amrules, htree
from repro_torch.ml.amrules import HAMR, VAMR, AMRules, RulesConfig
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig
from repro_torch.ml.vht import (VHT, ShardingEnsemble, VHTConfig,
                                build_vht_topology)
from repro_torch.models.lm import LanguageModel

CPU = "cpu"
T, B, M = 24, 256, 12
# a small tree pool and a looser Hoeffding bound, so that the stream splits
# often; a grace period near the batch, so that some steps have no leaf due;
# a check tile of 2, so that more than two leaves due at once take the full
# fallback of the split check
TREE = dict(n_attrs=M, n_bins=8, n_classes=2, max_nodes=31, n_min=200,
            delta=1e-3, check_tile=2)
VHT_VARIANTS = {"local": {}, "wok": {"split_delay": 3},
                "wk64": {"split_delay": 3, "buffer_size": 64}}
RULES = dict(n_attrs=M, n_bins=8, max_rules=16, n_min=100)
RULE_LEARNERS = {"MAMR": AMRules, "VAMR": VAMR,
                 "HAMR-2": lambda rc, device: HAMR(rc, replicas=2,
                                                   device=device)}
LOGITS_ATOL = 0.04      # tests/test_torch_lm.py's, on max-shifted logits


def _stream(kind):
    """[T, B, M] i32 bins, and [T, B] targets: i32 classes of a depth-2
    tree of thresholds on three attributes with 5 % of labels flipped
    (kind "vht"), or f32 a sum of steps and a slope in the bins plus noise
    (kind "rules")."""
    rng = np.random.RandomState(0 if kind == "vht" else 1)
    x = rng.randint(0, 8, (T, B, M)).astype(np.int32)
    if kind == "vht":
        y = np.where(x[..., 0] >= 4, x[..., 1] >= 2, x[..., 2] >= 6)
        y ^= rng.uniform(size=y.shape) < 0.05
        return x, y.astype(np.int32)
    y = (3.0 * (x[..., 0] >= 4) - 2.0 * (x[..., 1] < 3) + 0.5 * x[..., 2]
         + rng.randn(T, B))
    return x, y.astype(np.float32)


def _torch(a):
    return torch.from_numpy(a)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want, path=""):
    """Nested dicts of arrays: same keys, dtypes and values, bit for bit."""
    assert set(got) == set(want), path
    for k in sorted(want):
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (f"{path}/{k}", g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


# ---------------------------------------------------- JitEngine against JAX

def _learners(kind):
    """(JAX learner or topology, port learner or topology)."""
    if kind == "vht-topology":
        return (jax_build_vht_topology(JaxVHTConfig(JaxTreeConfig(**TREE))),
                build_vht_topology(VHTConfig(TreeConfig(**TREE)), device=CPU))
    if kind == "vht":
        kw = {**TREE, **VHT_VARIANTS["wok"]}
        return (JaxVHT(JaxVHTConfig(JaxTreeConfig(**kw))),
                VHT(VHTConfig(TreeConfig(**kw)), device=CPU))
    return (JaxVAMR(JaxRulesConfig(**RULES)),
            VAMR(RulesConfig(**RULES), device=CPU))


@pytest.mark.parametrize("kind", ["vht-topology", "vht", "amrules"])
def test_jit_engine_run_stream_bit_identical_to_jax(kind):
    """JitEngine.run_stream over the whole stream, the first step priming
    the carry: the carry (every processor's state and the feedback in
    flight) and the stacked outputs equal the JAX engine's bit for bit."""
    x, y = _stream("rules" if kind == "amrules" else "vht")
    jlearner, learner = _learners(kind)
    jeng = JaxJitEngine()
    want, want_outs = jeng.run_stream(
        jlearner, jeng.init(jlearner, jax.random.PRNGKey(0)),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    eng = JitEngine()
    init = eng.init(learner)
    got, outs = eng.run_stream(learner, init,
                               {"x": _torch(x), "y": _torch(y)})
    _assert_tree_equal(state_to_numpy(outs), _np(want_outs))
    _assert_tree_equal(state_to_numpy(got), _np(want))
    assert init["feedback"] is None
    states = _np(want)["states"]
    if kind == "amrules":
        assert int(states["vamr"]["n_created"]) > 0
    else:
        tree = states["model-aggregator" if kind == "vht-topology" else "vht"]
        assert int(tree["n_nodes"]) > 1                  # it split


def test_jit_engine_step_advances_its_own_carry():
    """step() primes eagerly, then replays one compiled step per topology;
    it equals the StreamEngine step by step.  The chunked runtime's knobs
    are refused without a chunked stream; with chunk_len the same steps
    run chunk by chunk, bit for bit the monolithic run."""
    x, y = _stream("vht")
    topo = build_vht_topology(VHTConfig(TreeConfig(**TREE)), device=CPU)
    eng, ref = JitEngine(), StreamEngine()
    carry, want = eng.init(topo), ref.init(topo)
    for t in range(6):
        p = {"x": _torch(x[t]), "y": _torch(y[t])}
        carry, out = eng.step(topo, carry, p)
        want, want_out = ref.step(topo, want, p)
        _assert_tree_equal(state_to_numpy(out), state_to_numpy(want_out))
        _assert_tree_equal(state_to_numpy(carry), state_to_numpy(want))
    assert len(eng._compiled) == 1
    for kw in ({"on_chunk": print}, {"collect_outputs": False}):
        with pytest.raises(ValueError, match="chunked"):
            eng.run_stream(topo, eng.init(topo), [p], **kw)
    payloads = {"x": _torch(x[:6]), "y": _torch(y[:6])}
    mono = eng.run_stream(topo, eng.init(topo), payloads)
    chunked = eng.run_stream(topo, eng.init(topo), payloads, chunk_len=4)
    for got, want in zip(chunked, mono):
        _assert_tree_equal(state_to_numpy(got), state_to_numpy(want))


# ------------------------------------- capturable steps against the eager

class _Rows:
    """Records the row count of every split-gain reduction (htree's
    split_gains) or every SDR decision (amrules' _expansion_decision)."""

    def __init__(self, monkeypatch, module, name, rows_of):
        self.rows, fn = [], getattr(module, name)

        def spy(*args, **kw):
            self.rows.append(rows_of(args))
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, spy)


def _run_steps(step, state, x, y):
    metrics = []
    for t in range(T):
        state, m = step(state, _torch(x[t]), _torch(y[t]))
        metrics.append({k: v.clone() for k, v in m.items()})
    return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


@pytest.mark.parametrize("variant", sorted(VHT_VARIANTS))
def test_capturable_vht_step_bit_identical_to_eager(variant, monkeypatch):
    """The VHT step in its capturable form (its gates conds) against the
    eager step with its host reads: every per-batch metric and state leaf.
    The stream splits, steps with nothing due skip the check (idle), and
    both the gathered tile and the full fallback run."""
    x, y = _stream("vht")
    vht = VHT(VHTConfig(TreeConfig(**{**TREE, **VHT_VARIANTS[variant]})),
              device=CPU)
    want_st, want_m = _run_steps(vht.step, vht.init(), x, y)
    spy = _Rows(monkeypatch, htree, "split_gains", lambda a: a[0].shape[0])
    got_st, got_m = _run_steps(compile_step(vht.step, vht.init(), _torch(x[0]),
                                            _torch(y[0])), vht.init(), x, y)
    _assert_tree_equal(state_to_numpy(got_m), state_to_numpy(want_m))
    _assert_tree_equal(state_to_numpy(got_st), state_to_numpy(want_st))
    assert int(want_st["n_nodes"]) > 5                       # splits
    assert {2, TREE["max_nodes"]} <= set(spy.rows)          # tile, full
    assert len(spy.rows) < T                                 # idle steps


@pytest.mark.parametrize("variant", sorted(RULE_LEARNERS))
def test_capturable_amrules_step_bit_identical_to_eager(variant,
                                                        monkeypatch):
    """MAMR, VAMR and HAMR-2 in their capturable form against the eager
    step: every per-batch metric and state leaf, bit for bit.  Rules are
    created and expanded, and the gates both open and stay closed."""
    x, y = _stream("rules")
    learner = RULE_LEARNERS[variant](RulesConfig(**RULES), device=CPU)
    want_st, want_m = _run_steps(learner.step, learner.init(), x, y)
    spy = _Rows(monkeypatch, amrules, "_expansion_decision",
                lambda a: a[0].shape[0])
    got_st, got_m = _run_steps(
        compile_step(learner.step, learner.init(), _torch(x[0]),
                     _torch(y[0])), learner.init(), x, y)
    _assert_tree_equal(state_to_numpy(got_m), state_to_numpy(want_m))
    _assert_tree_equal(state_to_numpy(got_st), state_to_numpy(want_st))
    assert int(want_st["n_created"]) > 0 and int(want_st["n_feats"]) > 0
    # two gates a step: the open ones ran the decision, and not all opened
    assert 0 < len(spy.rows) < 2 * T


def test_prequential_evaluation_compiled_equals_eager():
    x, y = _stream("vht")
    batches = list(zip(_torch(x), _torch(y)))
    cfg = VHTConfig(TreeConfig(**{**TREE, **VHT_VARIANTS["wk64"]}))
    got = PrequentialEvaluation(VHT(cfg, device=CPU), batches).run()
    want = PrequentialEvaluation(VHT(cfg, device=CPU), batches,
                                 compiled=False).run()
    assert got.curve == want.curve and got.metric == want.metric
    _assert_tree_equal(state_to_numpy(got.extra["state"]),
                       state_to_numpy(want.extra["state"]))


# --------------------------------------------- nothing read on the host

SYNCING = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
           "nonzero", "numpy")
# the kernels' plain versions, which run where the card launches a kernel
PLAIN = [(rule_stats_ops, "rule_stats_scatter_ref"),
         (split_poisson_ops, "split_poisson_ref")]


def _decode_case():
    cfg = configs.get_smoke_config("qwen15_4b")
    model = LanguageModel.init(cfg, torch.Generator().manual_seed(0), CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 3), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    carry = serve.decode_carry(model.init_cache(2, 6), tokens[:, :1])
    return serve.make_decode_step(model), carry, ()


def _learner_case(kind):
    def case():
        x, y = _stream("rules" if kind in RULE_LEARNERS else "vht")
        if kind in RULE_LEARNERS:
            learner = RULE_LEARNERS[kind](RulesConfig(**RULES), device=CPU)
        else:
            learner = VHT(VHTConfig(TreeConfig(**{**TREE,
                                                 **VHT_VARIANTS[kind]})),
                          device=CPU)
        return learner.step, learner.init(), (x, y)
    return case


def _ensemble_case(kind):
    def case():
        x, y = _stream("vht")
        tc = TreeConfig(**TREE)
        if kind == "sharding":
            learner = ShardingEnsemble(tc, 2, device=CPU)
        else:
            learner = OzaEnsemble(EnsembleConfig(
                tc, n_members=3, boost=kind == "ozaboost", detector="ddm"),
                device=CPU)
        return learner.step, learner.init(), (x, y)
    return case


def _topology_case():
    x, y = _stream("vht")
    topo = build_vht_topology(VHTConfig(TreeConfig(**TREE)), device=CPU)
    eng = StreamEngine()
    carry = eng.init(topo)
    carry, _ = eng.step(topo, carry, {"x": _torch(x[0]), "y": _torch(y[0])})

    def step(c, xb, yb):
        return eng.step(topo, c, {"x": xb, "y": yb})
    return step, carry, (x, y)


CASES = {"vht-wk64": _learner_case("wk64"), "vht-local": _learner_case("local"),
         "VAMR": _learner_case("VAMR"), "HAMR-2": _learner_case("HAMR-2"),
         "topology": _topology_case, "decode": _decode_case,
         "ozabag": _ensemble_case("ozabag"),
         "ozaboost": _ensemble_case("ozaboost"),
         "sharding": _ensemble_case("sharding")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_capturable_step_reads_nothing_on_the_host(case, monkeypatch):
    """A step in its capturable form converts no tensor to a Python value
    (what would sync with the card, or fail in a capture) outside cond's
    read of its predicate and the kernels' plain versions."""
    fn, state, data = CASES[case]()
    allowed = [0]

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

    step = compile_step(fn, state, *(_torch(d[0]) for d in data))
    reads, read = [], compiled._read

    def counted(pred):
        reads.append(1)
        return read(pred)

    monkeypatch.setattr(compiled, "_read", allow(counted))
    for module, name in PLAIN:
        monkeypatch.setattr(module, name, allow(getattr(module, name)))
    for name in SYNCING:
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))
    for t in range(T if data else 4):
        state, _ = step(state, *(_torch(d[t]) for d in data))
    monkeypatch.undo()
    assert reads or case == "decode"


# ------------------------------------------- decode with a device index

def _lm(arch, window):
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if window:
        jcfg = dataclasses.replace(jcfg, window=window)
        cfg = dataclasses.replace(cfg, window=window)
    jm = JaxLM(jcfg)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, CPU)
    return jcfg, jm, jp, cfg, LanguageModel(cfg, params)


def _shifted(logits, V):
    a = np.asarray(logits, np.float32)[..., :V]
    return a - a.max(-1, keepdims=True)


@pytest.mark.parametrize("arch,window", [("falcon_mamba_7b", 0),
                                         ("qwen15_4b", 0), ("qwen15_4b", 5)])
def test_graph_decode_matches_jax_serve_step(arch, window):
    """serve.generate's compiled decode step (the index a device scalar,
    advanced by the step) against the JAX package's prefill_into_cache and
    serve_step: the last replay logits, and each generated token while the
    JAX top-2 margin exceeds LOGITS_ATOL.  Window 5 over 11 positions: the
    rolling cache wraps twice."""
    jcfg, jm, jp, cfg, model = _lm(arch, window)
    Bq, P, G = 2, 6, 5
    tokens = np.random.RandomState(9).randint(
        0, cfg.vocab_size, (Bq, P)).astype(np.int32)
    res = serve.generate(model, torch.from_numpy(tokens), G)
    if window:
        assert model.init_cache(Bq, P + G)["body"][0]["k"].shape[1] == window

    jcache = jax_init_params(jm.cache_defs(Bq, P + G), jax.random.PRNGKey(0))
    jlogits, jcache = jax_prefill_into_cache(jm, jp, jnp.asarray(tokens),
                                             jcache)
    V = cfg.vocab_size
    np.testing.assert_allclose(
        _shifted(res["prefill_logits"].float().numpy(), V),
        _shifted(jlogits, V), atol=LOGITS_ATOL)
    jserve = jax.jit(jax_make_serve_step(jcfg))
    jdecode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    got = res["tokens"].numpy()
    for i in range(G):
        top2 = np.sort(np.asarray(jlogits[:, -1, :V]), -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGITS_ATOL
        np.testing.assert_array_equal(got[clear, i],
                                      np.asarray(jtok)[clear, 0])
        if not np.array_equal(got[:, i], np.asarray(jtok)[:, 0]):
            break                       # parted after a near tie
        if i + 1 < G:
            jlogits, _ = jdecode(jp, jcache, jtok, jnp.int32(P + i))
            jtok, jcache = jserve(jp, jcache, jtok, jnp.int32(P + i))


def test_decode_step_takes_a_python_or_a_device_index():
    """The eager decode with a Python int index, as before, and with the
    index a device scalar give the same logits and caches, bit for bit."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen15_4b"), window=3)
    model = LanguageModel.init(cfg, torch.Generator().manual_seed(0), CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    a, b = model.init_cache(2, 5), model.init_cache(2, 5)
    for i in range(5):
        la, a = model.decode_step(a, tokens[:, i:i + 1], i)
        lb, b = model.decode_step(b, tokens[:, i:i + 1],
                                  torch.tensor(i, dtype=torch.int32))
        assert torch.equal(la, lb)
    for x, y in zip(a["body"], b["body"]):
        assert all(torch.equal(x[k], y[k]) for k in x)
