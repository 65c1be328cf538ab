"""Thomas Wang's 64-bit mixer on int64 tensors, and its numpy twin.

Counterpart of dashing_tpu/hashes.py:wang_hash, which emulates uint64 on
uint32 pairs for the TPU.  Here a uint64 value lives in an int64 tensor
with the same bit pattern: additions and left shifts wrap identically in
two's complement, and right shifts are made logical with a mask (torch has
no CPU `>>` for uint64).  `wang_hash_np` is the host version on uint64
arrays (the rolling hashes' tables, the benchmark's host baseline and the
host HLL inserts, with `clz64_np`).
"""
from __future__ import annotations

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
