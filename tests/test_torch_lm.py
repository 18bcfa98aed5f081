"""The port's LM serving path (falcon_mamba_7b and qwen15_4b SMOKE configs)
against the JAX package, on the CPU.

The weights come from the JAX package's ``init_params`` and reach the port
through ``convert.params_from_numpy``; tokens and activations come from a
numpy seed.  On CPU tensors the port's kernels run their plain versions,
and the JAX model runs its XLA paths (``chunked_attention`` and the chunked
associative scan of ``apply_mamba``); the Pallas kernels are not called.

Tolerances.  The port rounds to bf16 where the JAX code casts, and
computes silu op by op as XLA's CPU backend does, so the norm, attention
and MLP agree with the JAX package to the last bf16 bit or nearly; they
are held within BF16_ULPS ulps of each array's largest magnitude.  exp,
cos, sin and softplus differ between the two libraries by float32 ulps,
and the sequential scan sums in another order than the associative one,
so the Mamba block and the whole path differ by a few bf16 ulps more: the
Mamba block within PATH_ULPS, the logits (scale about 1) within LOGITS_ATOL
after the max shift that tests/test_consistency.py applies, and the
caches within PATH_ULPS.  The port's own decode-vs-forward check keeps
tests/test_consistency.py's atol 0.1, rtol 0.05.
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
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import layers as JL
from repro.models.lm import LanguageModel as JaxLM
from repro.models.params import count_params as jax_count_params
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import base as configs
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as L
from repro_torch.models.lm import LanguageModel, cache_defs, param_defs
from repro_torch.models.params import ParamDef, init_params

ARCHS = ["falcon_mamba_7b", "qwen15_4b"]
BF16_ULPS = 2
PATH_ULPS = 8
LOGITS_ATOL = 0.04
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tensor(a):
    """numpy or JAX array -> CPU tensor with the same bits (bf16 kept)."""
    return state_from_numpy(np.asarray(a), CPU)


def assert_ulps(got, want, ulps):
    """|got - want| <= ulps bf16 ulps (2**-8 relative) of want's largest
    magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * 2**-8 * scale)


_CACHE = {}


def _model(arch):
    """(JAX cfg, JAX model, JAX params, port cfg, port model), built once."""
    if arch not in _CACHE:
        jcfg = jax_configs.get_smoke_config(arch)
        jm = JaxLM(jcfg)
        jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
        cfg = configs.get_smoke_config(arch)
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, CPU)
        _CACHE[arch] = (jcfg, jm, jp, cfg, LanguageModel(cfg, params))
    return _CACHE[arch]


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _shifted(logits, V):
    a = _np(logits)[..., :V]
    return a - a.max(-1, keepdims=True)


# ------------------------------------------------------------ configs, defs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for name in ("get_config", "get_smoke_config"):
        cfg = getattr(configs, name)(arch)
        jcfg = getattr(jax_configs, name)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.padded_vocab, cfg.d_inner, cfg.heads_padded) == (
            jcfg.padded_vocab, jcfg.d_inner, jcfg.heads_padded)
        assert cfg.n_params() == jax_count_params(JaxLM(jcfg).param_defs())
    assert configs.SHAPES.keys() == jax_configs.SHAPES.keys()


def test_only_ported_archs_are_known():
    assert configs.ARCHS == ("qwen15_4b", "falcon_mamba_7b")
    with pytest.raises(KeyError, match="falcon_mamba_7b"):
        configs.get_config("yi_34b")
    with pytest.raises(KeyError, match="qwen15_4b"):
        configs.get_smoke_config("recurrentgemma_9b")
    moe = dataclasses.replace(configs.get_smoke_config("qwen15_4b"),
                              family="moe")
    with pytest.raises(NotImplementedError, match="family"):
        LanguageModel.init(moe, device=CPU)


def _dtype_name(dt):
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else \
        np.dtype(dt).name


def _same_defs(port, jax_def, stacked, weights):
    """A port def against the JAX one; a stacked weight's layer count is
    the leading axis, which the port keeps for its fan-in."""
    shape, axes, layers = jax_def.shape, jax_def.axes, 0
    if stacked:
        shape, axes = shape[1:], axes[1:]
        layers = jax_def.shape[0] if weights else 0
    assert (port.shape, port.axes, port.init, port.scale, port.layers) == (
        shape, axes, jax_def.init, jax_def.scale, layers)
    assert _dtype_name(port.dtype) == _dtype_name(jax_def.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_defs_match_jax(arch):
    cfg = configs.get_config(arch)
    jm = JaxLM(jax_configs.get_config(arch))
    is_def = lambda d: isinstance(d, type(jm.param_defs()["embed"]))  # noqa
    for port, jax_tree, weights in (
            (param_defs(cfg), jm.param_defs(), True),
            (cache_defs(cfg, 2, 16), jm.cache_defs(2, 16), False)):
        assert port.keys() == jax_tree.keys()
        for key, sub in port.items():
            jleaves, jdef = jax.tree.flatten(jax_tree[key], is_leaf=is_def)
            if isinstance(sub, list):
                assert len(sub) == cfg.n_layers
                layers = sub
            else:
                layers = [sub]
            for layer in layers:
                pleaves, pdef = jax.tree.flatten(
                    layer, is_leaf=lambda d: isinstance(d, ParamDef))
                assert pdef == jdef
                for p, j in zip(pleaves, jleaves):
                    _same_defs(p, j, isinstance(sub, list), weights)


def test_init_params_follow_the_jax_initializers():
    """Zeros and ones exactly; normal draws with the fan-in std (or the
    def's scale, or 0.02 for ``small``) in distribution, as JAX's draws.
    The JAX package takes a block weight's fan-in on its layer-stacked
    shape, layer axis included; so does the port."""
    cfg = configs.get_smoke_config("falcon_mamba_7b")
    g = torch.Generator().manual_seed(3)
    params = init_params(param_defs(cfg), g, CPU)
    jp = jax_init_params(JaxLM(jax_configs.get_smoke_config(
        "falcon_mamba_7b")).param_defs(), jax.random.PRNGKey(3))
    layer, jlayer = params["body"][0]["mix"], jp["body"]["mix"]
    assert torch.equal(layer["A_log"], torch.ones_like(layer["A_log"]))
    assert torch.equal(layer["conv_b"], torch.zeros_like(layer["conv_b"]))
    assert layer["dt_bias"].dtype == torch.float32
    assert layer["in_proj"].dtype == torch.bfloat16
    for name, want in (("in_proj", (4 * 64) ** -0.5), ("conv_w", 0.2),
                       ("out_proj", (4 * 128) ** -0.5)):
        std = float(layer[name].float().std())
        assert abs(std - want) < 0.1 * want, (name, std)
        jstd = float(np.asarray(jlayer[name][0], np.float32).std())
        assert abs(std - jstd) < 0.1 * want, (name, std, jstd)
    assert abs(float(params["embed"].float().std()) - 0.02) < 0.002


# ------------------------------------------------------------ modules

def test_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 24, 64) * 3, jnp.bfloat16)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    for p in ({"scale": scale}, {"scale": scale, "bias": bias}):
        want = JL.apply_norm(p, x)
        got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           _tensor(x))
        assert got.dtype == torch.bfloat16
        assert_ulps(got, want, BF16_ULPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 40, 4, 16), dtype)
    pos = rng.randint(0, 2048, (1, 40))
    want = JL.rope(x, jnp.asarray(pos), 10_000.0)
    got = L.rope(_tensor(x), torch.from_numpy(pos), 10_000.0)
    if dtype == "float32":
        # cos and sin of angles up to 2048 differ by float32 ulps
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
    else:
        assert_ulps(got, want, BF16_ULPS)


def _layer(arch, key):
    jcfg, _, jp, cfg, model = _model(arch)
    return jcfg, jax.tree.map(lambda a: a[0], jp["body"][key]), cfg, \
        model.body[0]


def _x(seed, B, S, D):
    return jnp.asarray(np.random.RandomState(seed).randn(B, S, D),
                       jnp.bfloat16)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_full_sequence_matches_jax(window):
    jcfg, jp, cfg, blk = _layer("qwen15_4b", "mix")
    jcfg = dataclasses.replace(jcfg, window=window)
    att = L.Attention(dataclasses.replace(cfg, window=window),
                      dict(blk.mix.named_parameters()))
    x = _x(2, 2, 24, jcfg.d_model)
    want, _ = jax.jit(lambda p, x: JL.attention(p, x, jcfg))(jp, x)
    got, cache = att(_tensor(x))
    assert cache is None
    assert_ulps(got, want, BF16_ULPS)


def test_attention_decode_into_a_rolling_cache_matches_jax():
    """Window 8: a rolling cache of width 8, written at index % 8, over 12
    steps; the outputs and the cache after each step."""
    jcfg, jp, cfg, blk = _layer("qwen15_4b", "mix")
    jcfg, cfg = (dataclasses.replace(c, window=8) for c in (jcfg, cfg))
    att = L.Attention(cfg, dict(blk.mix.named_parameters()))
    K, hd = cfg.n_kv_heads, cfg.head_dim
    jcache = {"k": jnp.zeros((2, 8, K, hd), jnp.bfloat16),
              "v": jnp.zeros((2, 8, K, hd), jnp.bfloat16)}
    cache = {k: _tensor(v) for k, v in jcache.items()}
    xs = _x(3, 2, 12, cfg.d_model)

    @jax.jit
    def jstep(p, x, cache, i):
        return JL.attention(p, x, jcfg, positions=jnp.full((1, 1), i),
                            cache={**cache, "index": i})

    for i in range(12):
        want, jnew = jstep(jp, xs[:, i:i + 1], jcache, jnp.int32(i))
        jcache = {"k": jnew["k"], "v": jnew["v"]}
        got, cache = att(_tensor(xs[:, i:i + 1]),
                         positions=torch.full((1, 1), i), cache=cache,
                         index=i)
        assert_ulps(got, want, BF16_ULPS)
        for k in ("k", "v"):
            assert_ulps(cache[k], jcache[k], BF16_ULPS)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_jax(act):
    jcfg, jp, cfg, blk = _layer("qwen15_4b", "mlp")
    jcfg, cfg = (dataclasses.replace(c, act=act) for c in (jcfg, cfg))
    p = dict(blk.mlp.named_parameters())
    if act not in ("swiglu", "geglu"):
        p.pop("wg")
        jp = {k: v for k, v in jp.items() if k != "wg"}
    x = _x(4, 2, 24, cfg.d_model)
    want = jax.jit(lambda p, x: JL.apply_mlp(p, x, jcfg))(jp, x)
    assert_ulps(L.MLP(cfg, p)(_tensor(x)), want,
                BF16_ULPS if act == "swiglu" else PATH_ULPS)


def test_mamba_prefill_matches_jax():
    """S = 24 with ssm_chunk 16: the JAX block pads to two chunks of its
    associative scan; the port scans the whole sequence at once."""
    jcfg, jp, cfg, blk = _layer("falcon_mamba_7b", "mix")
    x = _x(5, 2, 24, cfg.d_model)
    want, _ = jax.jit(lambda p, x: JL.apply_mamba(p, x, jcfg))(jp, x)
    reset_launches()
    got, cache = blk.mix(_tensor(x))
    assert cache is None and launches()["selective_scan"] == 0
    assert_ulps(got, want, PATH_ULPS)


def test_mamba_decode_matches_jax():
    """Four decode steps from a random conv and ssm state."""
    jcfg, jp, cfg, blk = _layer("falcon_mamba_7b", "mix")
    rng = np.random.RandomState(6)
    B, dI, N = 2, cfg.d_inner, cfg.ssm_state
    jcache = {"conv": jnp.asarray(rng.randn(B, 3, dI), jnp.bfloat16),
              "ssm": jnp.asarray(rng.randn(B, dI, N) * 0.1, jnp.float32)}
    cache = {k: _tensor(v) for k, v in jcache.items()}
    xs = _x(7, B, 4, cfg.d_model)
    jstep = jax.jit(lambda p, x, c: JL.apply_mamba(p, x, jcfg, cache=c))
    for i in range(4):
        want, jcache = jstep(jp, xs[:, i:i + 1], jcache)
        got, cache = blk.mix(_tensor(xs[:, i:i + 1]), cache=cache)
        assert_ulps(got, want, PATH_ULPS)
        assert_ulps(cache["conv"], jcache["conv"], BF16_ULPS)
        # B, C and dt come from a bf16 projection: a bf16 ulp there moves
        # the float32 state by as much
        assert_ulps(cache["ssm"], jcache["ssm"], PATH_ULPS)


# ------------------------------------------------------------ whole path

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jm, jp, cfg, model = _model(arch)
    tokens = _tokens(cfg, 2, 24, seed=8)
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got, aux = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == want.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_array_equal(_np(got)[..., cfg.vocab_size:],
                                  np.asarray(want)[..., cfg.vocab_size:])
    np.testing.assert_allclose(_shifted(got, cfg.vocab_size),
                               _shifted(want, cfg.vocab_size),
                               atol=LOGITS_ATOL)
    step = make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(_np(step), _np(got)[:, -1])


def _assert_caches_close(cache, jcache):
    for i, layer in enumerate(cache["body"]):
        for k, t in layer.items():
            assert t.dtype == {"ssm": torch.float32}.get(k, torch.bfloat16)
            assert_ulps(t, jcache["body"][k][i], PATH_ULPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    """The prompt replayed into the caches, then 8 greedy serve steps, in
    both packages on the same weights: the caches after the replay, the
    last replay logits, and each generated token while the JAX top-2
    margin exceeds LOGITS_ATOL; after a near tie the sequences may part,
    and the comparison ends there.  (With these weights and tokens they do
    not part, and the caches after the 8 steps are compared too.)"""
    jcfg, jm, jp, cfg, model = _model(arch)
    B, P, G = 2, 16, 8
    tokens = _tokens(cfg, B, P, seed=9)
    jcache = jax_init_params(jm.cache_defs(B, P + G), jax.random.PRNGKey(0))
    cache = params_from_numpy(jax.tree.map(np.asarray, jcache), cfg, CPU)
    jlogits, jcache = jax_prefill_into_cache(jm, jp, jnp.asarray(tokens),
                                             jcache)
    logits, cache = serve.prefill_into_cache(model, torch.from_numpy(tokens),
                                             cache)
    np.testing.assert_allclose(_shifted(logits, cfg.vocab_size),
                               _shifted(jlogits, cfg.vocab_size),
                               atol=LOGITS_ATOL)
    _assert_caches_close(cache, jcache)

    jserve = jax.jit(jax_make_serve_step(jcfg))
    jdecode = jax.jit(jm.decode_step)
    serve_step = make_serve_step(cfg)
    jtok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for i in range(G):
        index = P + i
        jl, _ = jdecode(jp, jcache, jtok, jnp.int32(index))
        top2 = np.sort(np.asarray(jl[:, -1, :cfg.vocab_size]), -1)[:, -2:]
        jnext, jcache = jserve(jp, jcache, jtok, jnp.int32(index))
        nxt, cache = serve_step(model, cache, tok, index)
        assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
        np.testing.assert_array_equal(np.asarray(jnext),
                                      np.asarray(jnp.argmax(jl[:, -1], -1)
                                                 )[:, None])
        clear = (top2[:, 1] - top2[:, 0]) > LOGITS_ATOL
        np.testing.assert_array_equal(nxt.numpy()[clear],
                                      np.asarray(jnext)[clear])
        if not np.array_equal(nxt.numpy(), np.asarray(jnext)):
            break                       # parted after a near tie
        jtok, tok = jnext, nxt
    else:
        _assert_caches_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_consistency.py's invariant on the port: the prompt replayed
    through decode steps gives the full-sequence forward's logits."""
    _, _, _, cfg, model = _model(arch)
    S = 48
    tokens = torch.from_numpy(_tokens(cfg, 2, S, seed=10))
    full, _ = model(tokens)
    cache = model.init_cache(2, S)
    outs = []
    for i in range(S):
        logits, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(_shifted(full, cfg.vocab_size),
                               _shifted(dec, cfg.vocab_size),
                               atol=0.1, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--gen-len", "4"])
    cfg = configs.get_smoke_config(arch)
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out
