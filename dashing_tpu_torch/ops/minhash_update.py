"""Device construction of the b-bit MinHash bucket minima and the bottom-k
values (port of dashing_tpu/ops/minhash_update.py), as PyTorch ops on
int64.

A uint64 hash lives in an int64 tensor with the same bit pattern
(hashes.py).  Flipping its top bit, h ^ (1 << 63), maps the unsigned
order onto the signed one, so an int64 minimum or sort is the unsigned
one; the b-bit sketch's EMPTY (all ones) maps to INT64_MAX.

  bbmh_update     bucket = h >>> (64 - p) (a logical shift), value =
                  h << p (wrapping); one scatter_reduce_ "amin" of the
                  flipped values into a (2^p,) int64 bank that stays on
                  the device until the file ends; an invalid window
                  scatters INT64_MAX, which changes nothing
  bottomk_update  a tile's valid flipped hashes sorted and deduplicated
                  (torch.unique), the first kk merged into the running kk

The JAX package's TPU workarounds are not ported: two int32 scatter-min
passes over (hi, lo) words (it has no uint64), bottom-k candidates by a
`lax.top_k` of high words with a coverage check and an exact fallback,
and its refusal of p > 25 (int32 scatter indices).  Nor is its loss of
the all-ones hash: its bottom-k route pads invalid lanes with all ones
and filters that value, so it drops a genuine all-ones hash (P = 2^-64
an element); here invalid lanes are masked out, so a genuine one is kept
and both routes equal the host `addh_np` route in every case.

Each function has its plain numpy version beside it (`*_np`), for the
tests.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hashes import shr

SIGN = -(1 << 63)                 # the top bit, as an int64
EMPTY_FLIPPED = (1 << 63) - 1     # the flipped all-ones value, INT64_MAX


def flip(h: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns in int64 -> int64 of the same order."""
    return h ^ SIGN


def to_numpy(flipped: torch.Tensor) -> np.ndarray:
    """Flipped int64 values on any device -> host uint64."""
    return flip(flipped).cpu().numpy().view(np.uint64)


def empty_bank(p: int, device: torch.device) -> torch.Tensor:
    """(2^p,) flipped bucket minima, every bucket EMPTY."""
    return torch.full((1 << p,), EMPTY_FLIPPED, dtype=torch.int64,
                      device=device)


def bbmh_update(bank: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
                p: int) -> torch.Tensor:
    """Fold WangHashed windows `h` (int64, any shape) where `valid` into
    the flipped bucket minima `bank`, in place: bucket h >>> (64 - p),
    value h << p, the unsigned minimum per bucket."""
    idx = shr(h, 64 - p)
    val = torch.where(valid, flip(h << p), EMPTY_FLIPPED)
    return bank.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1), "amin")


def bbmh_update_np(mins: np.ndarray, h: np.ndarray, valid: np.ndarray,
                   p: int) -> np.ndarray:
    """Plain version of bbmh_update on host uint64 minima (not flipped):
    `np.minimum.at`, as BBitMinHash.add_np inserts."""
    h = np.asarray(h, np.uint64)[np.asarray(valid, bool)]
    np.minimum.at(mins, (h >> np.uint64(64 - p)).astype(np.int64),
                  h << np.uint64(p))
    return mins


def empty_values(device: torch.device) -> torch.Tensor:
    """No bottom-k values yet (flipped int64, sorted)."""
    return torch.zeros(0, dtype=torch.int64, device=device)


def bottomk_update(run: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
                   kk: int) -> torch.Tensor:
    """The kk smallest distinct values of `run` (flipped, sorted) and the
    valid hashes `h`: a new sorted flipped tensor of at most kk."""
    cand = torch.unique(flip(h[valid]))[:kk]
    return torch.unique(torch.cat([run, cand]))[:kk]


def bottomk_update_np(values: np.ndarray, h: np.ndarray, valid: np.ndarray,
                      kk: int) -> np.ndarray:
    """Plain version of bottomk_update on host uint64 values (not
    flipped): `np.union1d(...)[:kk]`, as BottomK.add_np inserts."""
    h = np.asarray(h, np.uint64)[np.asarray(valid, bool)]
    return np.union1d(values, h)[:kk]
