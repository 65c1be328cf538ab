"""Plain HyperLogLog registers of a FASTQ read set through a count-min
filter, in PyTorch.

Written from the definitions, not from the program under test:

- a FASTQ record is four lines: `@` and a name, the bases, `+`, the
  qualities; the bases of the records are joined by one invalid byte (a
  read's own newline), so no k-mer spans two reads;
- k-mers, their canonical codes, Thomas Wang's 64-bit hash h of a
  canonical code, and a hash's bucket and rank are those of sketch.py;
- the filter has `rows` rows of 2^size counters; row r's constant is
  c_r = (seed + r * 0x9E3779B9) | 1 as a 64-bit pattern, and a window's
  counter in row r is the top `size` bits of wang64(h ^ c_r);
- pass 1 adds 1 to each row's counter of every valid window (every
  occurrence counts);
- pass 2 admits a valid window where the minimum over the rows of its
  counters is at least `min_count`, and a register is the largest rank of
  the admitted windows of its bucket;
- without the filter, every valid window is admitted.

The read set is hashed in blocks of reads on `device`, and each pass
takes the blocks' hashes in turn.
Nothing here imports the program, the JAX package or JAX.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .sketch import bucket_rank, canonical_kmers, shr, wang64

GOLDEN = 0x9E3779B9


def row_constant(seed: int, row: int) -> int:
    """c_r as the int64 of its 64-bit pattern."""
    c = ((seed + row * GOLDEN) | 1) & ((1 << 64) - 1)
    return c - (1 << 64) if c >> 63 else c


def counter_index(h: torch.Tensor, row: int, size: int,
                  seed: int) -> torch.Tensor:
    return shr(wang64(h ^ row_constant(seed, row)), 64 - size)


def read_fastq(path: str) -> np.ndarray:
    """The whole file's bytes (uint8)."""
    return np.fromfile(path, np.uint8)


def sequence_blocks(data: np.ndarray, block_reads: int, device
                    ) -> Iterator[torch.Tensor]:
    """The bases of the file's records, `block_reads` records a block, each
    read followed by its newline, as uint8 tensors on `device`.  A byte
    belongs to a record's bases where the newlines before it in its
    block, which begins at a record, number 1 modulo 4."""
    nl = np.flatnonzero(data == ord("\n"))
    n_reads = nl.size // 4
    for r0 in range(0, n_reads, block_reads):
        r1 = min(r0 + block_reads, n_reads)
        start = 0 if r0 == 0 else int(nl[4 * r0 - 1]) + 1
        end = int(nl[4 * r1 - 1]) + 1
        b = torch.from_numpy(data[start:end]).to(device)
        is_nl = (b == ord("\n")).to(torch.int32)
        line = torch.cumsum(is_nl, 0, dtype=torch.int32) - is_nl
        yield b[(line & 3) == 1]


def window_hashes(data: np.ndarray, k: int, device,
                  block_reads: int = 1 << 18) -> List[torch.Tensor]:
    """h of every valid window of the file's reads, a tensor a block."""
    out = []
    for seq in sequence_blocks(data, block_reads, device):
        km, ok = canonical_kmers(seq, k)
        out.append(wang64(km)[ok])
    return out


def twice_seen(hashes: List[torch.Tensor]) -> int:
    """Distinct canonical k-mers seen at least twice (wang64 is one to one
    on 64-bit words, so distinct hashes are distinct k-mers), by a sort."""
    _, n = torch.unique(torch.cat(hashes), return_counts=True)
    return int((n >= 2).sum())


def plain_registers(hashes: List[torch.Tensor], p: int, device
                    ) -> torch.Tensor:
    """(2^p,) int32 registers of every window, unfiltered."""
    regs = torch.zeros(1 << p, dtype=torch.int32, device=device)
    for h in hashes:
        idx, rank = bucket_rank(h, p)
        regs.scatter_reduce_(0, idx, rank.to(torch.int32), "amax")
    return regs


def filtered_registers(hashes: List[torch.Tensor], p: int, rows: int,
                       size: int, seed: int, min_count: int, device
                       ) -> torch.Tensor:
    """(2^p,) int32 registers of the windows the filter admits: pass 1
    counts every window, pass 2 admits by the minimum over the rows."""
    counts = torch.zeros((rows, 1 << size), dtype=torch.int32,
                         device=device)
    for h in hashes:
        for r in range(rows):
            idx = counter_index(h, r, size, seed)
            counts[r].index_add_(0, idx, torch.ones_like(idx,
                                                         dtype=torch.int32))
    regs = torch.zeros(1 << p, dtype=torch.int32, device=device)
    for h in hashes:
        est = counts[0][counter_index(h, 0, size, seed)]
        for r in range(1, rows):
            est = torch.minimum(est, counts[r][counter_index(h, r, size,
                                                             seed)])
        idx, rank = bucket_rank(h, p)
        rank = torch.where(est >= min_count, rank, 0).to(torch.int32)
        regs.scatter_reduce_(0, idx, rank, "amax")
    return regs
