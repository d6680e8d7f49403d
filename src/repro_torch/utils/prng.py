"""Explicit key stream: threefry2x32 keys plus the counter-hash uniforms.

Keys are pairs of 32-bit words. The host loop holds them as Python ints,
so deriving a key never touches the device; the device-resident turn
(``serving.scanloop``) holds them as an int64 tensor of shape [2], and
every function here takes either form and gives the same words. The
layout is JAX's partitionable threefry (the default of current JAX
releases):

  * ``PRNGKey(s)`` is the word pair ``(0, s mod 2**32)`` (JAX without
    64-bit mode keeps the low 32 bits of the seed);
  * ``split(k, num)[i]`` is ``threefry2x32(k, (0, i))``;
  * ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  * ``random_bits(k, shape)`` is ``x0 ^ x1`` of ``threefry2x32(k, (hi(i), lo(i)))``
    over the flat index ``i``, and ``uniform`` maps those bits into [1, 2)
    and subtracts 1;
  * ``randint(k, shape, lo, hi)`` splits ``k`` in two, draws 32 bits from
    each half and folds the pair into ``[lo, hi)`` by JAX's modulus rule;
  * ``gumbel`` is JAX's default ("low") mode, ``-log(-log(u))`` of a
    uniform on ``[tiny, 1)``, and ``categorical`` the argmax of Gumbel noise
    plus the logits.

Everything but ``gumbel`` and ``categorical`` is integer work and
matches JAX bit for bit. Their ``log`` is torch's, which may differ from
XLA's in the last bit, so a categorical draw can differ where the two
largest scores lie within a few ulps of each other.

``uniform_pair``/``uniform_quad`` are the dispatch engine's counter-hash
uniforms (a Weyl sequence seeded by the key words, mixed by the murmur3
finaliser). They are integer-only, so they match the reference bit for bit.

All 32-bit arithmetic on tensors runs in int64 and is masked back to 32
bits after every step. A product of two 32-bit words does not fit in int64,
so ``_mul32`` splits the constant into 16-bit halves.
"""
from __future__ import annotations

import math

import torch

Key = tuple[int, int]  # or an int64 tensor [2] (a device key)

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


def _threefry_t(key: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """threefry2x32(key, (0, x1)) of a device key over int64 words x1 [m]:
    the blocks as an int64 tensor [m, 2]."""
    x0, y1 = _threefry_rounds(key[0], key[1], torch.zeros_like(x1), x1, _add_int,
                              _rotl_t)
    return torch.stack([x0, y1], -1)


def split(key: Key, num: int = 2):
    """``num`` keys: a list of host keys, or an int64 tensor [num, 2] (which
    unpacks row by row) for a device key."""
    if isinstance(key, torch.Tensor):
        return _threefry_t(key, torch.arange(num, dtype=torch.int64, device=key.device))
    return [threefry2x32(key, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    if isinstance(key, torch.Tensor):
        x1 = torch.full((1,), int(data) & M32, dtype=torch.int64, device=key.device)
        return _threefry_t(key, x1)[0]
    return threefry2x32(key, 0, int(data) & M32)


def device_key(key: Key, device) -> torch.Tensor:
    """A host key as a device key."""
    return torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64, device=device)


def host_key(key: torch.Tensor) -> Key:
    """A device key as a host key (one device-to-host copy)."""
    k0, k1 = key.tolist()
    return int(k0), int(k1)


def _rotl_t(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(d) for d in shape)


def _device(key: Key, device):
    return key.device if device is None and isinstance(key, torch.Tensor) else device


def _bits(k0, k1, shape: tuple[int, ...], device) -> torch.Tensor:
    """``x0 ^ x1`` of threefry2x32 over the flat index, under the key words
    (k0, k1): ints, 0-d tensors, or [K, 1] columns that draw K rows at once."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = _threefry_rounds(k0, k1, i >> 32, i & M32, _add_int, _rotl_t)
    return x0 ^ x1


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """u32 bits (as int64) of ``jax.random.bits(key, shape)``; ``shape`` an
    int or a tuple. A device key draws on its own device."""
    shape = _shape(shape)
    return _bits(key[0], key[1], shape, _device(key, device)).view(shape)


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """f32 in [0, 1): ``jax.random.uniform(key, shape)``."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000  # 1.0f's exponent
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: Key, shape, lo: int, hi: int, device=None) -> torch.Tensor:
    """i32 in [lo, hi): ``jax.random.randint(key, shape, lo, hi)``.

    Two 32-bit draws (one from each half of ``split(key)``) fold into the
    span as ``(hi_bits * 2**32 + lo_bits) mod span``, computed as JAX does
    in u32: ``multiplier = (2**16 mod span)**2 mod span`` and
    ``((hi_bits mod span) * multiplier + lo_bits mod span) mod span``,
    where every product and sum wraps at 2**32 (so a span above 2**16 has
    multiplier 0)."""
    span = int(hi) - int(lo) if int(hi) > int(lo) else 1
    shape, dev = _shape(shape), _device(key, device)
    halves = split(key)  # both halves' bits in one pass, as two rows
    if isinstance(halves, torch.Tensor):
        k0, k1 = halves[:, :1], halves[:, 1:]
    else:
        first = torch.arange(2, device=dev)[:, None] == 0
        k0 = torch.where(first, halves[0][0], halves[1][0])
        k1 = torch.where(first, halves[0][1], halves[1][1])
    hi_bits, lo_bits = _bits(k0, k1, shape, dev).view(2, *shape)
    mult = (((65536 % span) ** 2) & M32) % span
    off = ((((hi_bits % span) * mult) & M32) + lo_bits % span) & M32
    return (off % span + int(lo)).to(torch.int32)


#: float32's smallest normal number, Gumbel's lower bound on u
F32_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: Key, shape, device=None) -> torch.Tensor:
    """f32 Gumbel noise, ``jax.random.gumbel(key, shape)`` in its default
    "low" mode: ``-log(-log(u))`` with u uniform on [tiny, 1). The span
    1 - tiny rounds to 1.0 in f32, so u is ``max(tiny, uniform + tiny)``."""
    u = (uniform(key, shape, device) + F32_TINY).clamp(min=F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (last axis): the argmax of Gumbel
    noise plus the logits, the first index on a tie, as
    ``jax.random.categorical``. i32 of the batch shape."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x < 2**32 (an int or an int64 tensor), without
    overflowing int64."""
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
    # _mul32: on a device key the plain product leaves int64 with bit 31 set
    return _halves(fmix32(x ^ _mul32(key[1], 0x85EBCA6B)))


def uniform_quad(key: Key, B: int, device=None):
    """(u1, u2, v1, v2): the alias sampler's four uniforms per task. The
    first sweep is ``uniform_pair``; the second re-mixes the same counter
    against another key schedule for the acceptance draws."""
    x = _weyl(key, B, device)
    h1 = fmix32(x ^ _mul32(key[1], 0x85EBCA6B))
    h2 = fmix32(((x + 0x7F4A7C15) & M32) ^ _mul32(key[1], 0xC2B2AE35))
    u1, u2 = _halves(h1)
    v1, v2 = _halves(h2)
    return u1, u2, v1, v2


def exponential(key: Key, shape, device=None) -> torch.Tensor:
    """f32 Exp(1) draws, ``jax.random.exponential(key, shape)``: ``-log1p(-u)``
    of a uniform on [0, 1). Its ``log1p`` is torch's, which may differ from
    XLA's in the last bit."""
    return -torch.log1p(-uniform(key, shape, device))


# -- the same draws for a batch of keys ----------------------------------------
#
# Each ``v*`` function takes keys as an int64 tensor [R, 2] and returns the
# draws of every key stacked on a leading axis of R: row r equals the
# single-key function on key r (``jax.vmap`` of the single-key draw).


def _cols(keys: torch.Tensor):
    """The two key words of a [R, 2] batch as [R, 1] columns."""
    return keys[:, :1], keys[:, 1:]


def vsplit(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """int64 [R, num, 2]: ``split(keys[r], num)`` for every r."""
    k0, k1 = _cols(keys)
    x1 = torch.arange(num, dtype=torch.int64, device=keys.device)[None, :]
    x0, y1 = _threefry_rounds(k0, k1, torch.zeros_like(x1), x1, _add_int, _rotl_t)
    return torch.stack([x0, y1], -1)


def vfold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """int64 [R, 2]: ``fold_in(keys[r], data)`` for every r."""
    k0, k1 = _cols(keys)
    x1 = torch.full((1, 1), int(data) & M32, dtype=torch.int64, device=keys.device)
    x0, y1 = _threefry_rounds(k0, k1, torch.zeros_like(x1), x1, _add_int, _rotl_t)
    return torch.cat([x0, y1], -1)


def vrandom_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """u32 bits (as int64) [R, *shape] of every key."""
    shape = _shape(shape)
    k0, k1 = _cols(keys)
    return _bits(k0, k1, shape, keys.device).view(keys.shape[0], *shape)


def vuniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """f32 [R, *shape] in [0, 1)."""
    bits = (vrandom_bits(keys, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def vrandint(keys: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """i32 [R, *shape] in [lo, hi), by ``randint``'s fold of two 32-bit draws."""
    span = int(hi) - int(lo) if int(hi) > int(lo) else 1
    halves = vsplit(keys, 2)
    hi_bits, lo_bits = vrandom_bits(halves[:, 0], shape), vrandom_bits(halves[:, 1], shape)
    mult = (((65536 % span) ** 2) & M32) % span
    off = ((((hi_bits % span) * mult) & M32) + lo_bits % span) & M32
    return (off % span + int(lo)).to(torch.int32)


def vgumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """f32 [R, *shape] Gumbel noise (``gumbel``'s "low" mode)."""
    u = (vuniform(keys, shape) + F32_TINY).clamp(min=F32_TINY)
    return -torch.log(-torch.log(u))


def vcategorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """i32 [R]: one draw over the 1-d ``logits`` for every key."""
    g = vgumbel(keys, logits.shape)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def vexponential(keys: torch.Tensor, shape) -> torch.Tensor:
    """f32 [R, *shape] Exp(1) draws."""
    return -torch.log1p(-vuniform(keys, shape))


def vuniform_pair(keys: torch.Tensor, B: int):
    """Two f32 [R, B] counter-hash uniforms, ``uniform_pair`` of every key
    (its arithmetic is elementwise in the key words, so [R, 1] columns
    broadcast against the [B] counter)."""
    return uniform_pair(_cols(keys), B, keys.device)


def vuniform_quad(keys: torch.Tensor, B: int):
    """(u1, u2, v1, v2), each f32 [R, B]: ``uniform_quad`` of every key."""
    return uniform_quad(_cols(keys), B, keys.device)
