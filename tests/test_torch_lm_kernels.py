"""The plain versions of the port's LM kernels against the JAX package's
plain paths, on the CPU, at the shapes of tests/test_kernels.py.

``selective_scan`` (a loop over time in float32) is held against
``repro.kernels.selective_scan.ref.selective_scan_ref`` with the
tolerance tests/test_kernels.py uses, atol 2e-4: exp and the order of the
products differ by float32 ulps.  ``flash_attention`` (scores
materialized in float32) is held against ``attention_ref`` (through the
JAX wrapper's plain path, which repeats the GQA kv heads) and against the
model's own ``layers.chunked_attention``, atol 2e-3 for float32 and 2e-2
for bf16, as there.  The Pallas kernels are not called: they do not trace
on this jax (``pl.load``/``pl.store`` are gone).  On CPU tensors the
wrappers take the plain path and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and these
# small tensors gain nothing from more
torch.set_num_threads(1)

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models.layers import chunked_attention
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.selective_scan.ops import selective_scan


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    ("float32" or "bfloat16"), bit for bit."""
    j = jnp.asarray(a, dtype)
    if dtype == "bfloat16":
        bits = np.asarray(j).view(np.int16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.float().numpy()


# --------------------------- selective_scan ---------------------------------

def _scan_inputs(B, c, dI, N, seed):
    rng = np.random.RandomState(seed)
    softplus = lambda v: np.log1p(np.exp(v))                     # noqa: E731
    return [a.astype(np.float32) for a in (
        softplus(rng.randn(B, c, dI)) * 0.1,                     # dt
        rng.randn(B, c, dI),                                     # x
        rng.randn(B, c, N) * 0.5,                                # Bm
        rng.randn(B, c, N) * 0.5,                                # Cm
        -np.exp(rng.randn(dI, N) * 0.3),                         # A
        rng.randn(B, dI, N) * 0.1)]                              # h0


@pytest.mark.parametrize("B,c,dI,N", [
    (2, 32, 128, 16),
    (1, 16, 512, 16),
    (4, 64, 256, 8),
])
def test_selective_scan_plain_matches_jax(B, c, dI, N):
    args = _scan_inputs(B, c, dI, N, seed=B * c)
    reset_launches()
    y, hT = selective_scan(*map(torch.from_numpy, args))
    assert y.dtype == torch.float32 and hT.dtype == torch.float32
    assert launches()["selective_scan"] == 0
    jy, jh = jax_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=2e-4)


def test_selective_scan_state_chaining():
    """Two halves with the state carried equal one scan over the whole,
    and the JAX reference over the whole."""
    B, c, dI, N = 2, 32, 64, 8
    dt, x, Bm, Cm, A, _ = map(torch.from_numpy, _scan_inputs(B, c, dI, N, 9))
    h = torch.zeros((B, dI, N))
    y_full, h_full = selective_scan(dt, x, Bm, Cm, A, h)
    ys = []
    for s in (slice(0, 16), slice(16, 32)):
        y, h = selective_scan(dt[:, s], x[:, s], Bm[:, s], Cm[:, s], A, h)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=2e-4)
    jy, jh = jax_scan_ref(*(jnp.asarray(t.numpy()) for t in
                            (dt, x, Bm, Cm, A, torch.zeros((B, dI, N)))))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(jh), atol=2e-4)


def test_selective_scan_bf16_inputs_give_bf16_y():
    """bf16 inputs: float32 math, y rounded to bf16 (the reference keeps
    float32), so within atol 2e-4 plus one bf16 rounding (rtol 2**-8)."""
    args = _scan_inputs(2, 32, 128, 16, seed=3)
    pairs = [_pair(a, "bfloat16") for a in args[:4]]
    A, h0 = args[4:]
    y, hT = selective_scan(*(t for _, t in pairs), torch.from_numpy(A),
                           torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    jy, jh = jax_scan_ref(*(j for j, _ in pairs), jnp.asarray(A),
                          jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=2e-4, rtol=2**-8)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=2e-4)


# --------------------------- flash_attention --------------------------------

ATOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _attention_case(B, S, T, H, K, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    return [_pair(rng.randn(B, n, h, hd).astype(np.float32), dtype)
            for n, h in ((S, H), (T, K), (T, K))]


def _check_attention(B, S, H, K, hd, dtype, *, causal=True, window=0,
                     seed=0):
    (jq, q), (jk, k), (jv, v) = _attention_case(B, S, S, H, K, hd, dtype,
                                                seed)
    reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert launches()["flash_attention"] == 0
    ref = jax_flash(jq, jk, jv, causal=causal, window=window,
                    use_pallas=False)
    chunked = chunked_attention(jq, jk, jv, causal=causal, window=window,
                                q_chunk=64, kv_chunk=64)
    for want in (ref, chunked):
        np.testing.assert_allclose(_np(out), np.asarray(want, np.float32),
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("B,S,H,K,hd,dtype", [
    (2, 256, 4, 4, 64, "float32"),
    (2, 256, 4, 2, 64, "float32"),      # GQA
    (1, 512, 8, 1, 64, "float32"),      # MQA
    (2, 128, 4, 4, 128, "bfloat16"),
])
def test_flash_attention_plain_matches_jax(B, S, H, K, hd, dtype):
    _check_attention(B, S, H, K, hd, dtype, seed=S + H)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_plain_window(window):
    _check_attention(2, 256, 4, 2, 64, "float32", window=window, seed=7)


def test_flash_attention_plain_noncausal():
    _check_attention(1, 128, 2, 2, 64, "float32", causal=False, seed=9)


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("bfloat16", 0),
                                          ("float32", 48)])
def test_flash_attention_plain_ragged_sequence(dtype, window):
    """S = 200 is no multiple of any tile: chunked_attention pads to its
    chunks and masks the padding; the port masks rows and keys itself."""
    _check_attention(2, 200, 4, 2, 64, dtype, window=window, seed=11)
