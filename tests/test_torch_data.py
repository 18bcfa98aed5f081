"""The port's stream generator and pipeline against the JAX package, on the CPU.

The hidden tree comes from the same numpy draws in both packages, so it is
identical, and the port labels the JAX sampler's instances as JAX does.
The port samples from a ``torch.Generator``, so its instances match the
JAX sampler's in distribution only; those are checked for shape, dtype,
range, determinism and agreement with the hidden tree.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.generators import RandomTreeGenerator as JaxGenerator
from repro.data.generators import bin_numeric as jax_bin_numeric
from repro_torch.data.generators import RandomTreeGenerator, bin_numeric
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
