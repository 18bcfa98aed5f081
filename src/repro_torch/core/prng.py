"""The part of ``jax.random`` the port uses, bit for bit: the default
``threefry2x32`` generator with ``jax_threefry_partitionable=True`` (the
default since jax 0.5), its key split, 32-bit random bits, float32
uniforms and Knuth's Poisson sampler for rates below 10.

A key is a ``[2]`` ``torch.uint32`` tensor: the two words of a JAX key
(``jax.random.PRNGKey``'s raw ``uint32[2]``).  The arithmetic here is
int64 masked to 32 bits, on the key's device; ``uint32`` words pass to and
from it through their int32 bit patterns, the conversions that every
PyTorch build has on the CPU and the card.

  threefry2x32(k1, k2, x1, x2)   the Threefry-2x32 hash of 20 rounds
                                 (``jax/_src/prng.py``, ``_threefry2x32_lowering``)
  split(key, num)                ``jax.random.split``: key i is the hash of
                                 the counter pair (0, i) (``_threefry_split_foldlike``)
  random_bits(key, shape)        32 bits per element: the hash of (high,
                                 low) words of the flat index, its two
                                 outputs xor-ed (``_threefry_random_bits_partitionable``)
  uniform(key, shape)            float32 in [0, 1): the top 23 bits as a
                                 mantissa of [1, 2), minus 1 (``random.py::_uniform``)
  poisson_knuth(key, lam, shape) ``jax.random.poisson`` for lam < 10
                                 (``random.py::_poisson_knuth``)

``poisson_knuth`` is the plain version of the ``split_poisson`` kernel
(``kernels/split_poisson``), which the ensembles draw their member weights
with; CluStream and the learner fleets, still to port, split keys too.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

MASK = 0xFFFFFFFF
# the rotation constants of the two alternating groups of four rounds and
# the key-schedule parity word
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# Knuth's rounds that poisson_knuth draws in one pass
ROUNDS = 8


def words(key) -> torch.Tensor:
    """A uint32 tensor -> int64 values in [0, 2**32)."""
    return key.view(torch.int32).to(torch.int64) & MASK


def to_uint32(values) -> torch.Tensor:
    """int64 values in [0, 2**32) -> a uint32 tensor of those words."""
    signed = torch.where(values >= 2 ** 31, values - 2 ** 32, values)
    return signed.to(torch.int32).view(torch.uint32)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed
    mod 2**32)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return to_uint32(torch.tensor([0, seed & MASK], dtype=torch.int64,
                                  device=resolve_device(device)))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter words (x1, x2) under the key
    words (k1, k2): int64 tensors of 32-bit values, or Python ints,
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _counters(n, device):
    """The (high, low) words of the flat indices 0 .. n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def _split_words(k, num):
    hi, lo = _counters(num, k.device)
    return torch.stack(threefry2x32(k[0], k[1], hi, lo), -1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] uint32 keys."""
    return to_uint32(_split_words(words(key), num))


def _bits_words(k, shape):
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, k.device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def random_bits(key, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 values in
    [0, 2**32)."""
    return _bits_words(words(key), tuple(shape))


def _uniform_of(bits):
    mant = (bits >> 9) | 0x3F800000
    # [1, 2) minus 1 is exact, so JAX's max(0, .) after it changes nothing
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _uniform_words(k, shape):
    return _uniform_of(_bits_words(k, shape))


def uniform(key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    return _uniform_words(words(key), tuple(shape))


def poisson_knuth(key, lam, shape) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` for every lam < 10, as int32.

    Knuth's loop: each round splits the key, counts one more for every
    element whose running sum of log-uniforms is still above -lam, then
    adds the log of a uniform drawn at the element's flat index.  The
    loop ends when no element is above (a host read each round, which is
    why the card launches the ``split_poisson`` kernel instead).  An
    element that is done keeps its count, so its draw depends only on
    its own uniforms, and rounds past the end change no count: the
    rounds go in groups of ``ROUNDS``, their keys hashed on the host in
    Python ints and their uniforms at every element in one pass.  Rates
    of 10 and more take JAX's rejection sampler, which is not ported:
    ``ValueError``."""
    shape = tuple(shape)
    lam = torch.broadcast_to(lam.to(torch.float32), shape)
    if bool((lam >= 10).any()):
        raise ValueError("poisson_knuth takes rates below 10 only")
    dev = lam.device
    r1, r2 = words(key).tolist()
    hi, lo = _counters(lam.numel(), dev)
    k = torch.zeros(shape, dtype=torch.int32, device=dev)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=dev)
    active = log_prod > -lam
    while bool(active.any()):
        subs = []
        for _ in range(ROUNDS):
            # the split: this round's key (0, 1) and the next round's (0, 0)
            subs.append(threefry2x32(r1, r2, 0, 1))
            r1, r2 = threefry2x32(r1, r2, 0, 0)
        subs = torch.tensor(subs, dtype=torch.int64, device=dev)
        b1, b2 = threefry2x32(subs[:, :1], subs[:, 1:], hi, lo)
        logs = torch.log(_uniform_of(b1 ^ b2)).reshape((ROUNDS,) + shape)
        for i in range(ROUNDS):
            k = torch.where(active, k + 1, k)
            log_prod = log_prod + logs[i]
            active = log_prod > -lam
    return torch.where(lam == 0, 0, k - 1).to(torch.int32)


__all__ = ["PRNGKey", "poisson_knuth", "random_bits", "split",
           "threefry2x32", "to_uint32", "uniform", "words"]
