"""Plain HyperLogLog sketches of FASTA genomes, in PyTorch.

Written from the definitions, not from the program under test:

- a base is A, C, G or T in either case, coded 0, 1, 2, 3; any other byte
  (N, a record's end) ends every k-mer that would hold it;
- a k-mer's code has its first base in the most significant bits; its
  canonical form is the smaller of the code and its reverse complement's
  code, both unsigned;
- the hash is Thomas Wang's 64-bit mixer;
- a hash h falls in bucket h >> (64 - p) with rank 1 + the count of
  leading zeros of (h << p) | 2^(p-1) as a 64-bit word, and a register is
  the largest rank of its bucket;
- with a minimizer window of w bases (w > k), each run of w - k + 1
  consecutive k-mer positions whose k-mers are all valid gives the
  smallest canonical code among them, and that code is hashed.

Values are int64 tensors holding the uint64 bit patterns.  Nothing here
imports the program, the JAX package or JAX.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch

_SIGN = -(1 << 63)


def read_fasta(path: str) -> List[np.ndarray]:
    """The records of a FASTA file as uint8 arrays of their bases (lines
    joined, headers dropped)."""
    with open(path, "rb") as fp:
        data = fp.read()
    records: List[np.ndarray] = []
    for block in data.split(b">")[1:]:
        _, _, body = block.partition(b"\n")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        records.append(np.frombuffer(seq, np.uint8))
    return records


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns, 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def wang64(x: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 64-bit integer mixer (hash64shift)."""
    x = (~x) + (x << 21)
    x = x ^ shr(x, 24)
    x = x + (x << 3) + (x << 8)
    x = x ^ shr(x, 14)
    x = x + (x << 2) + (x << 4)
    x = x ^ shr(x, 28)
    return x + (x << 31)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero 64-bit words."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top = shr(x, 64 - s) == 0
        n = n + torch.where(top, s, 0)
        x = torch.where(top, x << s, x)
    return n


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 bit patterns."""
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), a, b)


def joined(records: Sequence[np.ndarray], device) -> torch.Tensor:
    """The records joined by one invalid byte, as a uint8 tensor."""
    parts: List[np.ndarray] = []
    for r in records:
        parts += [r, np.frombuffer(b"\n", np.uint8)]
    return torch.from_numpy(np.concatenate(parts)).to(device)


def canonical_kmers(seq: torch.Tensor, k: int):
    """(canonical codes, valid) of every k-mer position of a 1-D uint8
    tensor, k <= 32."""
    up = seq.to(torch.int64) & 0xDF
    code = torch.full_like(up, -1)
    for c, base in enumerate(b"ACGT"):
        code = torch.where(up == base, c, code)
    ok = code >= 0
    code = torch.where(ok, code, 0)
    n = seq.numel() - k + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=seq.device)
        return empty, empty.bool()
    fwd = torch.zeros(n, dtype=torch.int64, device=seq.device)
    rc = torch.zeros_like(fwd)
    for t in range(k):
        c = code[t:t + n]
        fwd = fwd | (c << (2 * (k - 1 - t)))
        rc = rc | ((3 - c) << (2 * t))
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=seq.device),
                     torch.cumsum((~ok).to(torch.int64), 0)])
    valid = (bad[k:] - bad[:n]) == 0
    return umin(fwd, rc), valid


def window_minimizers(km: torch.Tensor, valid: torch.Tensor, win: int):
    """(smallest code of each run of `win` k-mer positions, whether all
    of them are valid)."""
    n = km.numel() - win + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=km.device)
        return empty, empty.bool()
    flipped = km ^ _SIGN                       # unsigned order as signed
    mins = flipped.unfold(0, win, 1).amin(dim=1) ^ _SIGN
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=km.device),
                     torch.cumsum((~valid).to(torch.int64), 0)])
    return mins, (bad[win:] - bad[:n]) == 0


def bucket_rank(h: torch.Tensor, p: int):
    """(bucket, rank) of 64-bit hashes."""
    rest = (h << p) | (1 << (p - 1))
    return shr(h, 64 - p), clz64(rest) + 1


def genome_registers(records: Sequence[np.ndarray], k: int, p: int,
                     window: int = 0, device="cpu", block: int = 1 << 24
                     ) -> torch.Tensor:
    """(2^p,) int32 registers of one genome's records, the joined
    sequence taken in blocks of `block` k-mer positions."""
    seq = joined(records, device)
    span = max(window, k)
    regs = torch.zeros(1 << p, dtype=torch.int32, device=device)
    for s in range(0, max(seq.numel() - span + 1, 0), block):
        part = seq[s:s + block + span - 1]
        km, ok = canonical_kmers(part, k)
        if window > k:
            km, ok = window_minimizers(km, ok, window - k + 1)
        idx, rank = bucket_rank(wang64(km), p)
        rank = torch.where(ok, rank, 0).to(torch.int32)
        regs.scatter_reduce_(0, idx, rank, "amax")
    return regs


def collection_registers(genomes: Iterable[Sequence[np.ndarray]], k: int,
                         p: int, window: int = 0, device="cpu"
                         ) -> torch.Tensor:
    """(n, 2^p) int32 registers, a row a genome."""
    return torch.stack([genome_registers(r, k, p, window, device)
                        for r in genomes])
