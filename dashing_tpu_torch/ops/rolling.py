"""Rolling DNA hashes for any k: ntHash and a cyclic-polynomial hash
(port of dashing_tpu/ops/rolling.py, --use-nthash / --use-cyclic-hash).

Both are linear over GF(2):

    hash(window) = XOR_t rotl64(table[base_t], (k-1-t) mod 64)

so each window's hash is a windowed XOR of position-rotated per-base
constants, computed for a whole tile at once like the exact encoder.
Canonical mode takes the unsigned min of the forward and the
reverse-complement hash.  k > 32 is legal: rotations are taken mod 64.
Values are int64 bit patterns of the JAX package's uint64 hashes; they run
as PyTorch ops on the tile's device (XLA code in the JAX package, no
Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..hashes import rotl, wang_hash_np
from .encode import (_CODE_LUT, _SENTINEL, base_codes, full_window_valid,
                     sliding_min, umin)

# ntHash per-base seeds (public constants of the ntHash paper and code).
NT_SEEDS = np.array([0x3c8bfbb395c60474,   # A
                     0x3193c18562a02b4c,   # C
                     0x20323ed082572324,   # G
                     0x295549f54be24456],  # T
                    dtype=np.uint64)

# Cyclic-polynomial per-base table: fixed, derived from WangHash (the
# product wraps mod 2^64).
with np.errstate(over="ignore"):
    CYCLIC_SEEDS = wang_hash_np(np.arange(1, 5, dtype=np.uint64)
                                * np.uint64(0x2545F4914F6CDD1D))

_COMP = [3, 2, 1, 0]  # A<->T, C<->G

_TABLES: Dict[Tuple[int, str, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(k: int, kind: str, device: torch.device = torch.device("cpu")
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, 4) int64 rotated-constant tables for the forward and the
    reverse-complement hash: fwd[t, b] = rotl(seed[b], (k-1-t) mod 64),
    rc[t, b] = rotl(seed[3-b], t mod 64)."""
    key = (k, kind, str(device))
    if key not in _TABLES:
        seeds = torch.from_numpy(
            (NT_SEEDS if kind == "nthash" else CYCLIC_SEEDS).view(np.int64))
        fwd = torch.stack([rotl(seeds, k - 1 - t) for t in range(k)])
        rc = torch.stack([rotl(seeds[_COMP], t) for t in range(k)])
        _TABLES[key] = (fwd.to(device), rc.to(device))
    return _TABLES[key]


def rolling_hash_tile(tile: torch.Tensor, *, k: int, kind: str, canon: bool,
                      w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) uint8 ASCII tile -> (hashes, valid), both (R, C - max(w, k)
    + 1).  w > k emits each w-window's minimum hash, and only where every
    k-mer of the window is valid (the bonsai encoder's full-window
    emission)."""
    code, valid = base_codes(tile)
    W = tile.shape[-1] - k + 1
    ftab, rtab = _tables(k, kind, tile.device)
    fh = torch.zeros(tile.shape[:-1] + (W,), dtype=torch.int64,
                     device=tile.device)
    rh = torch.zeros_like(fh)
    wvalid = torch.ones(fh.shape, dtype=torch.bool, device=tile.device)
    for t in range(k):
        c_t = code[..., t:t + W]
        wvalid = wvalid & valid[..., t:t + W]
        fh = fh ^ ftab[t][c_t]
        if canon:
            rh = rh ^ rtab[t][c_t]
    h = umin(fh, rh) if canon else fh
    if w > k:
        win = w - k + 1
        h = sliding_min(torch.where(wvalid, h, _SENTINEL), win)
        wvalid = full_window_valid(wvalid, win)
    return h, wvalid


def rolling_hash_oracle(seq: bytes, k: int, kind: str, canon: bool,
                        w: int = 0) -> np.ndarray:
    """Slow host reference (uint64 hashes of the valid windows; w > k: the
    minimum hash of each w-window whose k-mers are all valid)."""
    codes = _CODE_LUT[np.frombuffer(seq, np.uint8)]
    ftab, rtab = (t.numpy().view(np.uint64) for t in _tables(k, kind))
    hashes, valid = [], []
    for i in range(len(codes) - k + 1):
        win = codes[i:i + k]
        if (win == 255).any():
            hashes.append(np.uint64(0))
            valid.append(False)
            continue
        fh = np.uint64(0)
        rh = np.uint64(0)
        for t in range(k):
            fh ^= ftab[t][win[t]]
            rh ^= rtab[t][win[t]]
        hashes.append(min(fh, rh) if canon else fh)
        valid.append(True)
    if w <= k:
        return np.asarray([h for h, v in zip(hashes, valid) if v], np.uint64)
    win = w - k + 1
    return np.asarray([min(hashes[i:i + win])
                       for i in range(len(hashes) - win + 1)
                       if all(valid[i:i + win])], np.uint64)
