"""XXH3-64 with a seed (``XXH3_64bits_withSeed``), in pure Python.

The hash behind the KV block keys (``tokens.py``) and the trace
head-sampling decision (``tracing/collector.py``). The JAX package computes
both with ``xxhash.xxh3_64_intdigest``; this package may not import
``xxhash``, and the values must be the same in both packages, because their
processes share one store and one wire: a router indexes the block hashes
that workers publish, and every process must keep or drop a trace alike.

Every length class of the reference is here: 0, 1-3, 4-8, 9-16, 17-128,
129-240 bytes, and the long path over 240 bytes (stripes of 64 bytes
accumulated against a secret derived from the seed, scrambled after each
block of 16 stripes). Seeds are u64: like ``xxhash``, any Python int is
masked to its low 64 bits (seed -1 hashes as 2**64 - 1).

Translated from xxHash's ``xxhash.h`` (version 0.8.3), whose notice
follows:

    xxHash - Extremely Fast Hash algorithm
    Header File
    Copyright (C) 2012-2023 Yann Collet

    BSD 2-Clause License (https://www.opensource.org/licenses/bsd-license.php)

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met:

       * Redistributions of source code must retain the above copyright
         notice, this list of conditions and the following disclaimer.
       * Redistributions in binary form must reproduce the above
         copyright notice, this list of conditions and the following disclaimer
         in the documentation and/or other materials provided with the
         distribution.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
    "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
    LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
    A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
    OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
    SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
    LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
    DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
    THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
    (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
    OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.

    You can contact the author at:
      - xxHash homepage: https://www.xxhash.com
      - xxHash source repository: https://github.com/Cyan4973/xxHash
"""

from __future__ import annotations

import struct
from functools import lru_cache

__all__ = ["xxh3_64"]

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

_PRIME32_1 = 0x9E3779B1
_PRIME32_2 = 0x85EBCA77
_PRIME32_3 = 0xC2B2AE3D
_PRIME64_1 = 0x9E3779B185EBCA87
_PRIME64_2 = 0xC2B2AE3D27D4EB4F
_PRIME64_3 = 0x165667B19E3779F9
_PRIME64_4 = 0x85EBCA77C2B2AE63
_PRIME64_5 = 0x27D4EB2F165667C5
_PRIME_MX1 = 0x165667919E3779F9
_PRIME_MX2 = 0x9FB21C651E98DF25

# XXH3_kSecret: 192 pseudorandom bytes taken from FARSH
_K_SECRET = bytes((
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
))
_SECRET_SIZE_MIN = 136
_MIDSIZE_MAX = 240
_STRIPE_LEN = 64
_SECRET_CONSUME_RATE = 8
_SECRET_LASTACC_START = 7
_SECRET_MERGEACCS_START = 11
_MIDSIZE_STARTOFFSET = 3
_MIDSIZE_LASTOFFSET = 17

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x2 = struct.Struct("<QQ").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from
# the secret read as u64 at every byte offset, as the paths below read it
_K64 = tuple(_u64(_K_SECRET, i)[0] for i in range(len(_K_SECRET) - 7))


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _PRIME64_2) & _M64
    h ^= h >> 29
    h = (h * _PRIME64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PRIME_MX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, length: int) -> int:
    h ^= (((h << 49) | (h >> 15)) ^ ((h << 24) | (h >> 40))) & _M64
    h = (h * _PRIME_MX2) & _M64
    h ^= (h >> 35) + length
    h = (h * _PRIME_MX2) & _M64
    return h ^ (h >> 28)


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _mix16(data: bytes, off: int, soff: int, seed: int) -> int:
    lo, hi = _u64x2(data, off)
    return _mul128_fold64(lo ^ ((_K64[soff] + seed) & _M64),
                          hi ^ ((_K64[soff + 8] - seed) & _M64))


def _len_0to16(data: bytes, n: int, seed: int) -> int:
    if n > 8:
        lo = _u64(data, 0)[0] ^ ((_K64[24] ^ _K64[32]) + seed) & _M64
        hi = _u64(data, n - 8)[0] ^ ((_K64[40] ^ _K64[48]) - seed) & _M64
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _mul128_fold64(lo, hi))
                          & _M64)
    if n >= 4:
        seed ^= int.from_bytes((seed & _M32).to_bytes(4, "little"),
                               "big") << 32
        in1 = _u32(data, 0)[0]
        in2 = _u32(data, n - 4)[0]
        bitflip = ((_K64[8] ^ _K64[16]) - seed) & _M64
        return _rrmxmx((in2 + (in1 << 32)) ^ bitflip, n)
    if n:
        combined = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                    | (n << 8))
        bitflip = ((_u32(_K_SECRET, 0)[0] ^ _u32(_K_SECRET, 4)[0]) + seed) \
            & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    return _xxh64_avalanche(seed ^ _K64[56] ^ _K64[64])


@lru_cache(maxsize=16)
def _mid_keys(seed: int) -> tuple:
    """The pairs of secret words ``XXH3_mix16B`` keys with the seed, at
    the 8 secret offsets 0, 16, ..., 112 that the 17-128 byte path reads."""
    return tuple(((_K64[o] + seed) & _M64, (_K64[o + 8] - seed) & _M64)
                 for o in range(0, 128, 16))


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    # XXH3_mix16B inlined: this path hashes every KV block (64 or 72 bytes
    # at block size 16) and every trace id (32 bytes)
    keys = _mid_keys(seed)
    acc = n * _PRIME64_1
    pairs = [(0, 0), (n - 16, 1)]
    if n > 32:
        pairs += [(16, 2), (n - 32, 3)]
        if n > 64:
            pairs += [(32, 4), (n - 48, 5)]
            if n > 96:
                pairs += [(48, 6), (n - 64, 7)]
    for off, k in pairs:
        lo, hi = _u64x2(data, off)
        klo, khi = keys[k]
        p = (lo ^ klo) * (hi ^ khi)
        acc += (p ^ (p >> 64)) & _M64
    return _avalanche(acc & _M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    acc = n * _PRIME64_1
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i, seed)
    acc_end = _mix16(data, n - 16, _SECRET_SIZE_MIN - _MIDSIZE_LASTOFFSET,
                     seed)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc_end += _mix16(data, 16 * i, 16 * (i - 8) + _MIDSIZE_STARTOFFSET,
                          seed)
    return _avalanche((acc + acc_end) & _M64)


def _custom_secret(seed: int) -> tuple:
    """XXH3_initCustomSecret: the default secret with the seed added to
    its even u64 words and taken from its odd ones, read back as u64 at
    every byte offset."""
    words = struct.unpack("<24Q", _K_SECRET)
    secret = struct.pack("<24Q", *(
        (w + seed if i % 2 == 0 else w - seed) & _M64
        for i, w in enumerate(words)))
    return tuple(_u64(secret, i)[0] for i in range(len(secret) - 7))


def _accumulate_512(acc: list, data: bytes, off: int, sec: tuple,
                    soff: int) -> None:
    vals = _u64x8(data, off)
    for lane in range(8):
        v = vals[lane]
        key = v ^ sec[soff + 8 * lane]
        acc[lane ^ 1] = (acc[lane ^ 1] + v) & _M64
        acc[lane] = ((key & _M32) * (key >> 32) + acc[lane]) & _M64


def _scramble(acc: list, sec: tuple, soff: int) -> None:
    for lane in range(8):
        a = acc[lane]
        a ^= a >> 47
        a ^= sec[soff + 8 * lane]
        acc[lane] = (a * _PRIME32_1) & _M64


def _hash_long(data: bytes, n: int, seed: int) -> int:
    sec = _K64 if seed == 0 else _custom_secret(seed)
    secret_size = len(_K_SECRET)
    acc = [_PRIME32_3, _PRIME64_1, _PRIME64_2, _PRIME64_3,
           _PRIME64_4, _PRIME32_2, _PRIME64_5, _PRIME32_1]
    stripes_per_block = (secret_size - _STRIPE_LEN) // _SECRET_CONSUME_RATE
    block_len = _STRIPE_LEN * stripes_per_block
    n_blocks = (n - 1) // block_len
    for b in range(n_blocks):
        for s in range(stripes_per_block):
            _accumulate_512(acc, data, b * block_len + s * _STRIPE_LEN, sec,
                            s * _SECRET_CONSUME_RATE)
        _scramble(acc, sec, secret_size - _STRIPE_LEN)
    # the last partial block, then the last stripe
    n_stripes = ((n - 1) - block_len * n_blocks) // _STRIPE_LEN
    for s in range(n_stripes):
        _accumulate_512(acc, data, n_blocks * block_len + s * _STRIPE_LEN,
                        sec, s * _SECRET_CONSUME_RATE)
    _accumulate_512(acc, data, n - _STRIPE_LEN, sec,
                    secret_size - _STRIPE_LEN - _SECRET_LASTACC_START)
    # merge the accumulators
    result = (n * _PRIME64_1) & _M64
    for i in range(4):
        soff = _SECRET_MERGEACCS_START + 16 * i
        result += _mul128_fold64(acc[2 * i] ^ sec[soff],
                                 acc[2 * i + 1] ^ sec[soff + 8])
    return _avalanche(result & _M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """``XXH3_64bits_withSeed(data, len(data), seed)`` as an unsigned int;
    equal to ``xxhash.xxh3_64_intdigest(data, seed=seed)``."""
    seed &= _M64
    n = len(data)
    if n <= 16:
        return _len_0to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= _MIDSIZE_MAX:
        return _len_129to240(data, n, seed)
    return _hash_long(data, n, seed)
