"""Thomas Wang's 64-bit mixer on int64 tensors, and its numpy twin.

Counterpart of dashing_tpu/hashes.py:wang_hash, which emulates uint64 on
uint32 pairs for the TPU.  Here a uint64 value lives in an int64 tensor
with the same bit pattern: additions and left shifts wrap identically in
two's complement, and right shifts are made logical with a mask (torch has
no CPU `>>` for uint64).  `wang_hash_np` is the host version on uint64
arrays (the rolling hashes' tables and the
host HLL inserts, with `clz64_np`); `seeded_wang_hash_np` and
`poisson_min_cardinality` serve the host set sketches
(sketch/setsketches.py).  `gf64_mul` and `clhash` (with their numpy
forms) are the carry-less multiplication hash of the JAX package: in the
hash stack, called by no sketch path.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int64 bit patterns left by n mod 64."""
    n %= 64
    return x if n == 0 else (x << n) | shr(x, 64 - n)


def wang_hash_np(x: np.ndarray) -> np.ndarray:
    """Host numpy WangHash (uint64 in and out); equal to `wang_hash` on
    the int64 view."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (~x) + (x << np.uint64(21))
        x = x ^ (x >> np.uint64(24))
        x = (x + (x << np.uint64(3))) + (x << np.uint64(8))
        x = x ^ (x >> np.uint64(14))
        x = (x + (x << np.uint64(2))) + (x << np.uint64(4))
        x = x ^ (x >> np.uint64(28))
        x = x + (x << np.uint64(31))
    return x


def seeded_wang_hash_np(x: np.ndarray, seed: int) -> np.ndarray:
    """WangHash of x ^ seed (the Bloom filter's hash functions)."""
    return wang_hash_np(np.asarray(x, np.uint64) ^ np.uint64(seed))


def poisson_min_cardinality(mins: np.ndarray, m: int) -> float:
    """Cardinality from the FILLED buckets' uint64 minima of m buckets
    (an empty bucket counts as min = 1): invert E[min of Poisson(lambda)
    uniforms] = (1 - e^-lambda) / lambda by 100 log-space bisection steps;
    cardinality = lambda * m.  The JAX package's float64 operations, in
    its order (the b-bit sketch writes the result into its file)."""
    nfill = len(mins)
    if nfill == 0:
        return 0.0
    u = np.asarray(mins, np.uint64).astype(np.float64) / 2.0 ** 64
    u = np.concatenate([u, np.ones(m - nfill)])
    mean = min(max(float(u.mean()), 1e-18), 1.0 - 1e-12)
    lo, hi = 1e-9, 1e12
    for _ in range(100):
        lam = math.sqrt(lo * hi)
        if -math.expm1(-lam) / lam > mean:
            lo = lam
        else:
            hi = lam
    return math.sqrt(lo * hi) * m


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Bitwise equal to dashing_tpu.hashes.wang_hash_np on int64 views."""
    x = (~x) + (x << 21)
    x = x ^ shr(x, 24)
    x = (x + (x << 3)) + (x << 8)
    x = x ^ shr(x, 14)
    x = (x + (x << 2)) + (x << 4)
    x = x ^ shr(x, 28)
    return x + (x << 31)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero int64 bit patterns, by a 6-step binary
    search on shifts (a float log2 rounds 2^61-1 up to 2^61)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        z = shr(x, 64 - s) == 0
        n = n + z.to(x.dtype) * s
        x = torch.where(z, x << s, x)
    return n


def clz64_np(x: np.ndarray) -> np.ndarray:
    """Leading zeros of nonzero uint64s (host; JAX `hashes.clz64_np`),
    by the same 6-step search on shifts."""
    y = np.atleast_1d(np.asarray(x, np.uint64)).copy()
    cnt = np.zeros(len(y), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        zt = (y >> np.uint64(64 - s)) == 0
        cnt += np.where(zt, s, 0)
        y = np.where(zt, y << np.uint64(s), y)
    return cnt


# ---------------------------------------------------------------------------
# clhash: carry-less-multiplication hashing (Lemire & Kaser, "Faster 64-bit
# universal hashing using carry-less multiplications", 2015), the single-
# word case: (x ^ K1) * K2 in GF(2^64), modulo the irreducible
# x^64 + x^4 + x^3 + x + 1.  The reference links clhash but calls it from
# no sketch path; so do both packages.
# ---------------------------------------------------------------------------

def gf64_mul(a: torch.Tensor, b) -> torch.Tensor:
    """GF(2^64) product of int64 bit patterns (b broadcasts against a):
    64 rounds of mask-select, shift and XOR give the 128-bit carry-less
    product, then its high word folds back through the polynomial."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    lo = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                     dtype=torch.int64, device=a.device)
    hi = torch.zeros_like(lo)
    for i in range(64):
        mask = -((shr(b, i) if i else b) & 1)
        lo = lo ^ ((a << i) & mask)
        if i:
            hi = hi ^ (shr(a, 64 - i) & mask)
    # hi * x^64 == hi * (x^4 + x^3 + x + 1); the bits the shifts push out
    # (at most 4) fold once more through the same polynomial
    t = (hi << 4) ^ (hi << 3) ^ (hi << 1) ^ hi
    top = shr(hi, 60) ^ shr(hi, 61) ^ shr(hi, 63)
    return lo ^ t ^ (top << 4) ^ (top << 3) ^ (top << 1) ^ top


def _clhash_keys(seed: int):
    """(K1, K2) as uint64, derived from the seed by WangHash (K2 odd)."""
    k1 = wang_hash_np(np.asarray([seed ^ 0x2127599BF4325C37], np.uint64))[0]
    k2 = wang_hash_np(np.asarray([seed ^ 0x9FB21C651E98DF25],
                                 np.uint64))[0] | np.uint64(1)
    return k1, k2


def clhash(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Carry-less universal hash of int64 bit patterns: (x ^ K1) * K2 in
    GF(2^64), equal to `clhash_np` on the uint64 view."""
    k1, k2 = (int(np.asarray(k).view(np.int64)) for k in _clhash_keys(seed))
    return gf64_mul(x ^ k1, k2)


def gf64_mul_np(a: np.ndarray, b) -> np.ndarray:
    """Host numpy gf64_mul (uint64 in and out)."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    hi = np.zeros(np.broadcast_shapes(a.shape, b.shape), np.uint64)
    lo = np.zeros_like(hi)
    with np.errstate(over="ignore"):   # 0 - 1 wraps to all ones on purpose
        for i in range(64):
            mask = np.uint64(0) - ((b >> np.uint64(i)) & np.uint64(1))
            lo = lo ^ ((a << np.uint64(i)) & mask)
            if i:
                hi = hi ^ ((a >> np.uint64(64 - i)) & mask)
    t = (hi << np.uint64(4)) ^ (hi << np.uint64(3)) \
        ^ (hi << np.uint64(1)) ^ hi
    top = (hi >> np.uint64(60)) ^ (hi >> np.uint64(61)) \
        ^ (hi >> np.uint64(63))
    lo = lo ^ t
    return lo ^ ((top << np.uint64(4)) ^ (top << np.uint64(3))
                 ^ (top << np.uint64(1)) ^ top)


def clhash_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Host numpy clhash (uint64 in and out)."""
    k1, k2 = _clhash_keys(seed)
    return gf64_mul_np(np.asarray(x, np.uint64) ^ k1, k2)
