"""The port's stream generators and pipeline against the JAX package, on
the CPU.

The hidden tree comes from the same numpy draws in both packages, so it is
identical, and the port labels the JAX sampler's instances as JAX does; the
waveform generator's base waveforms are the same too.  The port samples
from a ``torch.Generator``, so its instances match the JAX sampler's in
distribution only; those are checked for shape, dtype, range, determinism,
agreement with the hidden tree, and (the regression streams) per-column
means and spreads against a large JAX sample.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro.data.generators import CovtypeLikeGenerator as JaxCovtype
from repro.data.generators import ElectricityLikeGenerator as JaxElectricity
from repro.data.generators import RandomTweetGenerator as JaxTweet
from repro.data.generators import RandomTreeGenerator as JaxGenerator
from repro.data.generators import WaveformGenerator as JaxWaveform
from repro.data.generators import bin_numeric as jax_bin_numeric
from repro_torch.data.generators import (CovtypeLikeGenerator,
                                         ElectricityLikeGenerator,
                                         RandomTreeGenerator,
                                         RandomTweetGenerator,
                                         WaveformGenerator, bin_numeric)
from repro_torch.data.pipeline import StreamPipeline

CPU = "cpu"
# (n_cat, n_num, depth) as benchmarks/vht_benchmarks.py builds them
GENERATORS = {"dense-10-10": (10, 10, 6), "dense-100-100": (100, 100, 8)}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_hidden_tree_and_labels_match_jax(name):
    n_cat, n_num, depth = GENERATORS[name]
    jgen = JaxGenerator(n_cat=n_cat, n_num=n_num, depth=depth)
    tgen = RandomTreeGenerator(n_cat=n_cat, n_num=n_num, depth=depth,
                               device=CPU)
    for key in ("_attr", "_thresh", "_leaf_label"):
        want = np.asarray(getattr(jgen, key))
        got = getattr(tgen, key).numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    x, y = jgen.sample(jax.random.PRNGKey(3), 256)
    x = torch.from_numpy(np.array(x))
    np.testing.assert_array_equal(tgen._label(x).numpy(), np.asarray(y))
    np.testing.assert_array_equal(bin_numeric(x, 8).numpy(),
                                  np.asarray(jax_bin_numeric(x.numpy(), 8)))


@pytest.mark.parametrize("n_bins", [0, 8])
def test_stream_pipeline_batches(n_bins):
    gen = RandomTreeGenerator(n_cat=10, n_num=10, depth=6, device=CPU)
    pipe = StreamPipeline(gen, batch=64, n_batches=5, n_bins=n_bins,
                          seed=1, device=CPU)
    batches = list(pipe)
    assert len(batches) == 5
    for x, y in batches:
        assert x.shape == (64, 20) and y.shape == (64,)
        assert y.dtype == torch.int32
        if n_bins:
            assert x.dtype == torch.int32
            assert int(x.min()) >= 0 and int(x.max()) < n_bins
        else:
            assert x.dtype == torch.float32
            assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
            assert torch.equal(y, gen._label(x))
    again = list(pipe)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(batches, again))
    other = list(StreamPipeline(gen, batch=64, n_batches=5, n_bins=n_bins,
                                seed=2, device=CPU))
    assert not all(torch.equal(a[0], b[0]) for a, b in zip(batches, other))


def test_waveform_constants_match_jax():
    jgen, tgen = JaxWaveform(), WaveformGenerator(device=CPU)
    want = np.asarray(jgen._wave)
    got = tgen._wave.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (tgen.n_attrs, tgen.n_classes) == (jgen.n_attrs, jgen.n_classes)


@pytest.mark.parametrize("name", ["waveform", "electricity"])
def test_regression_streams_match_jax_in_distribution(name):
    """Shapes, dtypes, ranges and determinism; per-column means and
    standard deviations within 0.02 of a JAX sample of 20000 instances
    (the standard error of a mean there is under 0.005)."""
    n = 20000
    if name == "waveform":
        jx, jy = JaxWaveform().sample_regression(jax.random.PRNGKey(0), n)
        gen = WaveformGenerator(device=CPU)
        draw = gen.sample_regression
    else:
        jx, jy = JaxElectricity().sample(jax.random.PRNGKey(0), n)
        gen = ElectricityLikeGenerator()
        draw = gen.sample
    g = torch.Generator().manual_seed(0)
    x, y = draw(g, n)
    assert x.shape == tuple(jx.shape) and y.shape == tuple(jy.shape)
    assert x.dtype == torch.float32 and y.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    for got, want in ((x, np.asarray(jx)), (y[:, None], np.asarray(jy)[:, None])):
        np.testing.assert_allclose(got.mean(0).numpy(), want.mean(0),
                                   atol=0.02)
        np.testing.assert_allclose(got.std(0).numpy(), want.std(0),
                                   atol=0.02)
    again = draw(torch.Generator().manual_seed(0), n)
    assert torch.equal(again[0], x) and torch.equal(again[1], y)
    if name == "waveform":
        assert set(np.unique(y.numpy())) == {0.0, 1.0, 2.0}
        assert gen.sample(torch.Generator().manual_seed(0), 8)[1].dtype \
            == torch.int32


def test_classification_constants_match_jax():
    """The covtype-like rule and the tweet generator's two Zipf word
    distributions are the JAX package's own numpy draws."""
    jc, tc = JaxCovtype(), CovtypeLikeGenerator(device=CPU)
    for key in ("_w", "_b"):
        np.testing.assert_array_equal(getattr(tc, key).numpy(),
                                      np.asarray(getattr(jc, key)))
    jt, tt = JaxTweet(), RandomTweetGenerator(device=CPU)
    np.testing.assert_array_equal(tt._p.numpy(),
                                  np.stack([np.asarray(jt._p0),
                                            np.asarray(jt._p1)]))
    for j, t in ((jc, tc), (jt, tt), (JaxElectricity(),
                                      ElectricityLikeGenerator())):
        assert (t.n_attrs, t.n_classes) == (j.n_attrs, j.n_classes)


@pytest.mark.parametrize("name", ["covtype", "tweet", "electricity"])
def test_classification_streams_match_jax_in_distribution(name):
    """Shapes, dtypes, ranges and determinism; the class frequencies and
    the per-column means within 0.02 of a JAX sample of 4000 instances."""
    n = 4000
    key = jax.random.PRNGKey(0)
    if name == "covtype":
        jx, jy = JaxCovtype().sample(key, n)
        gen = CovtypeLikeGenerator(device=CPU)
    elif name == "tweet":
        jx, jy = JaxTweet().sample(key, n)
        gen = RandomTweetGenerator(device=CPU)
    else:
        jx, jy = JaxElectricity().sample_classification(key, n)
        gen = ElectricityLikeGenerator()
    batches = list(StreamPipeline(gen, batch=n, n_batches=1, seed=0,
                                  device=CPU))
    x, y = batches[0]
    assert x.shape == tuple(jx.shape) and y.shape == tuple(jy.shape)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    C = gen.n_classes
    assert int(y.min()) >= 0 and int(y.max()) < C
    np.testing.assert_allclose(
        np.bincount(y.numpy(), minlength=C) / n,
        np.bincount(np.asarray(jy), minlength=C) / n, atol=0.02)
    np.testing.assert_allclose(x.mean(0).numpy(), np.asarray(jx).mean(0),
                               atol=0.02)
    again = list(StreamPipeline(gen, batch=n, n_batches=1, seed=0,
                                device=CPU))[0]
    assert torch.equal(again[0], x) and torch.equal(again[1], y)
    if name == "electricity":
        _, target = list(StreamPipeline(gen, batch=n, n_batches=1, seed=0,
                                        classification=False,
                                        device=CPU))[0]
        assert target.dtype == torch.float32
        assert torch.equal((target > 0.5).to(torch.int32), y)
