"""Explicit key stream: threefry2x32 keys plus the counter-hash uniforms.

Keys are host-side pairs of 32-bit words held as Python ints, so deriving a
key never touches the device. The layout is JAX's partitionable threefry
(the default of current JAX releases):

  * ``PRNGKey(s)`` is the word pair ``(0, s mod 2**32)`` (JAX without
    64-bit mode keeps the low 32 bits of the seed);
  * ``split(k, num)[i]`` is ``threefry2x32(k, (0, i))``;
  * ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  * ``random_bits(k, shape)`` is ``x0 ^ x1`` of ``threefry2x32(k, (hi(i), lo(i)))``
    over the flat index ``i``, and ``uniform`` maps those bits into [1, 2)
    and subtracts 1.

``uniform_pair``/``uniform_quad`` are the dispatch engine's counter-hash
uniforms (a Weyl sequence seeded by the key words, mixed by the murmur3
finaliser). They are integer-only, so they match the reference bit for bit.

All 32-bit arithmetic on tensors runs in int64 and is masked back to 32
bits after every step. A product of two 32-bit words does not fit in int64,
so ``_mul32`` splits the constant into 16-bit halves.
"""
from __future__ import annotations

import torch

Key = tuple[int, int]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry_rounds(k0, k1, x0, x1, add, rotl):
    """threefry2x32 (20 rounds) over any word type given add/rotl."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _add_int(a, b):
    return (a + b) & M32


def _rotl_int(v, r):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """One threefry2x32 block on host ints."""
    return _threefry_rounds(key[0], key[1], x0, x1, _add_int, _rotl_int)


def PRNGKey(seed: int) -> Key:
    return 0, int(seed) & M32


def split(key: Key, num: int = 2) -> list[Key]:
    return [threefry2x32(key, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, int(data) & M32)


def _rotl_t(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """u32 bits (as int64) of ``jax.random.bits(key, (n,))``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = _threefry_rounds(key[0], key[1], i >> 32, i & M32, _add_int, _rotl_t)
    return x0 ^ x1


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """f32[n] in [0, 1): ``jax.random.uniform(key, (n,))``."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000  # 1.0f's exponent
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x < 2**32, without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser, a full-avalanche 32-bit mix."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _weyl(key: Key, B: int, device) -> torch.Tensor:
    i = torch.arange(B, dtype=torch.int64, device=device)
    return (_mul32(i, 0x9E3779B9) + key[0]) & M32


def _halves(h: torch.Tensor):
    scale = 1.0 / 65536.0
    return ((h >> 16).to(torch.float32) * scale,
            (h & 0xFFFF).to(torch.float32) * scale)


def uniform_pair(key: Key, B: int, device=None):
    """Two f32[B] uniforms on a 2**-16 grid from one counter-hash sweep."""
    x = _weyl(key, B, device)
    return _halves(fmix32(x ^ ((key[1] * 0x85EBCA6B) & M32)))


def uniform_quad(key: Key, B: int, device=None):
    """(u1, u2, v1, v2): the alias sampler's four uniforms per task. The
    first sweep is ``uniform_pair``; the second re-mixes the same counter
    against another key schedule for the acceptance draws."""
    x = _weyl(key, B, device)
    h1 = fmix32(x ^ ((key[1] * 0x85EBCA6B) & M32))
    h2 = fmix32(((x + 0x7F4A7C15) & M32) ^ ((key[1] * 0xC2B2AE35) & M32))
    u1, u2 = _halves(h1)
    v1, v2 = _halves(h2)
    return u1, u2, v1, v2
