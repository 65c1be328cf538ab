"""HLL register update (port of dashing_tpu/ops/hll_update.py).

Register semantics are the JAX package's:

    index = h >> (64 - p)                    (top p bits)
    rank  = clz((h << p) | 1 << (p - 1)) + 1 (leading zeros of the low
                                              64-p bits, plus one)
    reg[index] = max(reg[index], rank)

The TPU compaction machinery (top_k survivor cascades, adaptive caps, the
matmul update) exists only because scatter is slow on a TPU; a GPU scatter
(and the fused kernel in ops/encode_hash.py) gives bitwise the same
registers without it, so it is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..hashes import clz64, shr


def bucket_rank(h: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 hashes -> (bucket index int64, rank int64 in [1, 65-p])."""
    if not 1 <= p <= 31:
        # p == 32 would overflow the int32 register index on the device
        # paths and silently drop every hash with the top bit set
        raise ValueError(f"p must be in [1, 31] on the device update path, got {p}")
    idx = shr(h, 64 - p)
    rest = (h << p) | (1 << (p - 1))
    return idx, clz64(rest) + 1


def update_registers(regs: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
                     p: int) -> torch.Tensor:
    """Scatter-max a batch of hashes into (2^p,) int32 registers, in place;
    invalid lanes contribute rank 0 (a no-op under max)."""
    idx, rank = bucket_rank(h, p)
    rank = torch.where(valid, rank, 0).to(regs.dtype)
    return regs.scatter_reduce_(0, idx.reshape(-1), rank.reshape(-1), "amax")


def update_banks(regs: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
                 bank: torch.Tensor, p: int) -> torch.Tensor:
    """Scatter-max (R, W) hashes into a (B, 2^p) int32 register bank, in
    place: row r into regs[bank[r]] (the JAX package's
    `_banks_from_idx_rank`, an index offset by bank * 2^p).  A row whose
    bank lies outside [0, B) folds nothing, as the JAX scatter's
    mode="drop" drops it."""
    idx, rank = bucket_rank(h, p)
    bank = bank.to(torch.int64)
    ok = (bank >= 0) & (bank < regs.shape[0])
    rank = torch.where(valid & ok[:, None], rank, 0).to(regs.dtype)
    flat = idx + (torch.where(ok, bank, 0) << p)[:, None]
    regs.view(-1).scatter_reduce_(0, flat.reshape(-1), rank.reshape(-1),
                                  "amax")
    return regs
