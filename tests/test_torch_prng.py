"""The port's PRNG (``repro_torch.core.prng``) and the ensembles' member
weights against ``jax.random``, on the CPU, bit for bit: keys, splits,
random bits, uniforms and Knuth's Poisson draws on seeds 0-7, and
``OzaEnsemble.member_weights`` against the JAX step's ``split`` and
``poisson``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro_torch.core import prng
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.htree import TreeConfig

CPU = "cpu"
SEEDS = range(8)
SHAPE = (10, 512)


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, CPU)


def _equal_bits(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_jax_uses_the_partitionable_threefry():
    """The port follows threefry2x32 with jax_threefry_partitionable=True;
    a change of JAX's default would change every draw."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_bits_and_uniforms_equal_jax(seed):
    jk, tk = _key(seed)
    _equal_bits(tk, jk)
    _equal_bits(prng.split(tk, 5), jax.random.split(jk, 5))
    for _ in range(50):                    # a chain 50 splits deep
        jk, jsub = jax.random.split(jk)
        pair = prng.split(tk)
        tk, tsub = pair[0], pair[1]
    _equal_bits(tk, jk)
    _equal_bits(tsub, jsub)
    _equal_bits(prng.uniform(tk, SHAPE), jax.random.uniform(jk, SHAPE))
    bits = prng.random_bits(tk, SHAPE)
    _equal_bits(prng.to_uint32(bits),
                jax.random.bits(jk, SHAPE, jnp.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_draws_equal_jax(seed):
    """lam = 1 (bagging) and lam in [1, 3] (boosting's range), [10, 512]."""
    jk, tk = _key(seed)
    boost = np.random.RandomState(seed).uniform(1, 3, SHAPE).astype(np.float32)
    for lam in (np.ones((10, 1), np.float32), boost):
        want = jax.random.poisson(jk, jnp.asarray(lam), SHAPE)
        got = prng.poisson_knuth(tk, torch.from_numpy(lam), SHAPE)
        _equal_bits(got, want)


@pytest.mark.parametrize("rates,shape", [
    ("9.99", (10, 512)), ("9.99", (7, 1000)), ("zero", (10, 512)),
    ("mixed", (10, 512)), ("mixed", (7, 1000)), ("below 10", (10, 512))])
def test_poisson_draws_equal_jax_at_the_kernels_card_rates(rates, shape):
    """The yardstick of the split_poisson kernel on the card: rates of 9.99
    (draws past 20 rounds), a rate of 0 (every draw 0), per-element rates
    in [0, 9.99) with a fifth of them 0, and per-element rates just below
    10; [7, 1000] is no multiple of a block's draws."""
    rng = np.random.RandomState(len(rates) + shape[0])
    if rates == "9.99":
        lam = np.full((shape[0], 1), 9.99, np.float32)
    elif rates == "zero":
        lam = np.zeros((shape[0], 1), np.float32)
    elif rates == "mixed":
        lam = (rng.uniform(size=shape) * 9.99).astype(np.float32)
        lam[rng.uniform(size=shape) < 0.2] = 0.0
    else:
        lam = rng.uniform(9.9, 10.0, shape).astype(np.float32)
        lam = np.minimum(lam, np.float32(9.999))
    for seed in (0, 5):
        jk, tk = _key(seed)
        want = jax.random.poisson(jk, jnp.asarray(lam), shape)
        got = prng.poisson_knuth(tk, torch.from_numpy(lam), shape)
        _equal_bits(got, want)
        if rates == "zero":
            assert not got.any()


def test_poisson_refuses_rates_of_ten_and_more():
    key = prng.PRNGKey(0, CPU)
    with pytest.raises(ValueError, match="below 10"):
        prng.poisson_knuth(key, torch.full((2, 3), 10.0), (2, 3))
    zero = prng.poisson_knuth(key, torch.zeros((2, 3)), (2, 3))
    assert torch.equal(zero, torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("boost", [False, True], ids=["bag", "boost"])
@pytest.mark.parametrize("seed", [0, 3])
def test_member_weights_equal_the_jax_steps_draws(seed, boost):
    """repro/ml/ensemble.py:154,170-178: (key, k1) = split(key), lam from
    the members' votes, w = poisson(k1, lam, (M, B)) as f32."""
    M, B = 5, 128
    rng = np.random.RandomState(seed)
    votes = rng.randint(0, 3, (M, B)).astype(np.int32)
    y = rng.randint(0, 3, B).astype(np.int32)
    jk, tk = _key(seed)
    jkey, k1 = jax.random.split(jk)
    lam = jnp.ones((M, 1), jnp.float32)
    if boost:
        member_err = (jnp.asarray(votes) != jnp.asarray(y)[None]).astype(
            jnp.float32)
        cum_err = jnp.cumsum(member_err, 0) / jnp.arange(1, M + 1)[:, None]
        lam = 1.0 + 2.0 * jnp.concatenate(
            [jnp.zeros((1, B)), cum_err[:-1]], 0)
    want = jax.random.poisson(k1, lam, (M, B)).astype(jnp.float32)
    ens = OzaEnsemble(EnsembleConfig(TreeConfig(n_attrs=4, n_classes=3),
                                     n_members=M, boost=boost), device=CPU)
    key, w = ens.member_weights(tk, torch.from_numpy(votes),
                                torch.from_numpy(y))
    _equal_bits(key, jkey)
    _equal_bits(w, want)
    assert float(w.max()) >= 3.0          # draws above 1 occur
