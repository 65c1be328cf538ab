"""The check of a dist job over a large collection, a block of rows at a
time, so that no array over every pair is ever held.

`collection_registers` builds the registers of many genomes at once, from
the definitions of sketch.py (its canonical k-mers, WangHash, bucket and
rank) over the genomes joined back to back: each genome's records end in
one invalid byte, as sketch.joined ends them, so no valid k-mer spans two
genomes, and each valid k-mer lands in the registers of the genome it
starts in.  The registers equal sketch.collection_registers' bit for bit.

`jaccard_gap` walks the upper triangle a block of rows at a time, in the
row-major condensed order of the `-b` matrix, about PAIR_BLOCK pairs a
block: the block's float64 union histograms (compare.union_histograms),
their MLE and the Jaccard index by inclusion and exclusion (estimators),
against the same rows of the job's matrix, read through a memory map and
turned back into Jaccard indices (estimators.jaccard_of_mash); or, for
the control, against the same estimators in a lower precision.  Only the
widest gap is kept.
Nothing here imports the program, the JAX package or JAX.
"""
from __future__ import annotations

import struct
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import estimators as est
from . import sketch
from .compare import union_histograms

PAIR_BLOCK = 1 << 22          # pairs a step (~19 GB in the float64 MLE)
SEQ_BLOCK = 1 << 25           # bases of joined genomes hashed at once


def collection_registers(genomes: Iterable[Sequence[np.ndarray]], k: int,
                         p: int, device="cpu", block: int = SEQ_BLOCK
                         ) -> torch.Tensor:
    """(n, 2^p) int32 registers, a row a genome (its records), the genomes
    hashed about `block` bases at a time."""
    parts: List[np.ndarray] = []
    owner: List[int] = []
    rows: List[torch.Tensor] = []
    n = 0
    sep = np.frombuffer(b"\n", np.uint8)

    def fold(regs: torch.Tensor) -> None:
        seq = torch.from_numpy(np.concatenate(parts)).to(device)
        gid = torch.from_numpy(np.repeat(
            np.asarray(owner, np.int64) - owner[0],
            [x.size for x in parts])).to(device)
        km, ok = sketch.canonical_kmers(seq, k)
        idx, rank = sketch.bucket_rank(sketch.wang64(km), p)
        rank = torch.where(ok, rank, 0).to(torch.int32)
        regs.view(-1).scatter_reduce_(0, (gid[:km.numel()] << p) + idx,
                                      rank, "amax")

    held = 0
    first = 0
    for records in genomes:
        for r in records:
            parts += [r, sep]
            owner += [n, n]
            held += r.size + 1
        n += 1
        if held >= block:
            regs = torch.zeros((n - first, 1 << p), dtype=torch.int32,
                               device=device)
            fold(regs)
            rows.append(regs)
            parts, owner, held, first = [], [], 0, n
    if n > first:
        regs = torch.zeros((n - first, 1 << p), dtype=torch.int32,
                           device=device)
        if parts:
            fold(regs)
        rows.append(regs)
    if not rows:
        return torch.zeros((0, 1 << p), dtype=torch.int32, device=device)
    return torch.cat(rows)


def registers_of_files(paths: Sequence[str], k: int, p: int,
                       device="cpu") -> torch.Tensor:
    """(n, 2^p) registers of the FASTA files, read again from disk."""
    return collection_registers((sketch.read_fasta(path) for path in paths),
                                k, p, device)


def open_condensed(path: str) -> np.ndarray:
    """The `-b` file's n(n-1)/2 float32 entries as a read-only memory map
    (a dtype byte 0, n as a little-endian uint64, then the entries of the
    upper triangle, row-major)."""
    with open(path, "rb") as fp:
        head = fp.read(9)
    if len(head) != 9 or head[0] != 0:
        raise ValueError(f"{path}: not a float32 condensed matrix")
    n = struct.unpack("<Q", head[1:])[0]
    size = n * (n - 1) // 2
    if size == 0:
        return np.zeros(0, np.float32)
    cond = np.memmap(path, dtype="<f4", mode="r", offset=9)
    if cond.size != size:
        raise ValueError(f"{path}: {cond.size} entries for n = {n}")
    return cond


def row_start(i: int, n: int) -> int:
    """Where row i's pairs (i, j > i) begin in the condensed order."""
    return i * (2 * n - i - 1) // 2


def _jaccard(sizes: torch.Tensor, ia: torch.Tensor, jb: torch.Tensor,
             union: torch.Tensor, p: int) -> torch.Tensor:
    return est.jaccard(est.incl_excl(sizes[ia], sizes[jb],
                                     est.mle(union, p))).double()


def jaccard_gap(regs: torch.Tensor, p: int, k: int,
                cond: Optional[np.ndarray], dtype=None,
                pair_block: int = PAIR_BLOCK) -> float:
    """The widest gap between the float64 reference's Jaccard index of a
    pair and the one the condensed matrix `cond` (Mash distances, in the
    order of regs' rows) stands for, over every pair; with cond None, the
    widest gap between the float64 estimators and the same estimators in
    `dtype` (the control).  Each step takes as many rows as hold about
    `pair_block` pairs (one row at least), and its pairs are solved in
    calls of at most `pair_block`: the MLE's cost is nearly that of its
    calls, whatever their size."""
    n = regs.shape[0]
    sizes = est.mle(est.histogram(regs, p), p)
    low = None if cond is not None else est.mle(
        est.histogram(regs, p, dtype), p)
    gap = 0.0
    i0 = 0
    while i0 < n - 1:
        a = regs[i0:i0 + max(1, pair_block // (n - 1 - i0))]
        hist = union_histograms(a, regs[i0 + 1:], p)
        ii = torch.arange(i0, i0 + a.shape[0], device=regs.device)[:, None]
        jj = torch.arange(i0 + 1, n, device=regs.device)[None, :]
        keep = (jj > ii).reshape(-1)
        ia = ii.expand(-1, jj.shape[1]).reshape(-1)[keep]
        jb = jj.expand(ii.shape[0], -1).reshape(-1)[keep]
        union = hist.reshape(-1, hist.shape[-1])[keep]
        del hist
        base = row_start(i0, n)
        for s in range(0, ia.numel(), pair_block):
            sl = slice(s, s + pair_block)
            want = _jaccard(sizes, ia[sl], jb[sl], union[sl], p)
            if cond is None:
                got = _jaccard(low, ia[sl], jb[sl], union[sl].to(dtype), p)
            else:
                mash = torch.from_numpy(np.array(
                    cond[base + s:base + s + want.numel()]))
                got = est.jaccard_of_mash(mash, k).to(want.device)
            gap = max(gap, float((got - want).abs().max()))
        del union
        i0 += a.shape[0]
    return gap
