"""Weighted (multiset) Jaccard by labelled shingles (port of
dashing_tpu/sketch/weighted.py: `--wj`, `--wj-exact`).

The i-th occurrence of a k-mer value v is the distinct element
wang_hash(v ^ i * GOLDEN) (i >= 1), so a plain set sketch of the labelled
elements estimates the multiset Jaccard sum min(a, b) / sum max(a, b).
Counts are exact (--wj-exact) or count-min estimates (--wj: 2^22 counters
a row, 10 rows by default).  The membership of (v, i) depends only on v's
final count, so counting the whole stream first gives the same element
set as counting as it streams.

The host functions are the JAX package's, numpy on uint64.
`occurrence_labels_device` labels a k-mer stream on the device: one sort
of the valid values, each value's occurrence index from its position in
its run of equal values, then the labels with int64 wraparound (the same
bits as the host's uint64 arithmetic).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..hashes import wang_hash, wang_hash_np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_GOLDEN_I64 = int(_GOLDEN) - (1 << 64)     # the same bits as an int64


def occurrence_expand(kmers: np.ndarray, counts_cap: int = 0) -> np.ndarray:
    """Raw k-mer stream (with multiplicity) -> labelled elements, the i-th
    occurrence (i >= 1) of v as wang_hash(v ^ (i * GOLDEN))."""
    kmers = np.asarray(kmers, np.uint64)
    if kmers.size == 0:
        return kmers
    uniq, counts = np.unique(kmers, return_counts=True)
    if counts_cap:
        counts = np.minimum(counts, counts_cap)
    return expand_unique_counts(uniq, counts)


def expand_unique_counts(uniq: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(unique values, multiplicities) -> labelled elements (see
    occurrence_expand)."""
    if uniq.size == 0:
        return np.asarray(uniq, np.uint64)
    reps = np.repeat(np.asarray(uniq, np.uint64), counts)
    offs = np.arange(int(counts.sum()), dtype=np.uint64)
    starts = np.repeat(np.cumsum(counts) - counts, counts).astype(np.uint64)
    occ = offs - starts + np.uint64(1)
    with np.errstate(over="ignore"):
        return wang_hash_np(reps ^ (occ * _GOLDEN))


def cm_estimated_counts(kmers: np.ndarray, cmsize_log2: int = 22,
                        nhashes: int = 10, seed: int = 1337
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Count-min multiplicity estimate of each distinct k-mer (host):
    (unique values, estimates)."""
    kmers = np.asarray(kmers, np.uint64)
    uniq, counts = np.unique(kmers, return_counts=True)
    m = 1 << cmsize_log2
    est = None
    for row in range(nhashes):
        h = wang_hash_np(uniq ^ np.uint64((seed + row * 0x9E3779B9) | 1))
        idx = (h >> np.uint64(64 - cmsize_log2)).astype(np.int64)
        table = np.bincount(idx, weights=counts, minlength=m
                            ).astype(np.int64)
        v = table[idx]
        est = v if est is None else np.minimum(est, v)
    return uniq, est


def weighted_elements(kmers: np.ndarray, exact: bool, cmsize_log2: int = 22,
                      nhashes: int = 10, seed: int = 1337) -> np.ndarray:
    """The labelled elements of a k-mer stream, by exact or count-min
    counts."""
    if exact:
        return occurrence_expand(kmers)
    uniq, est = cm_estimated_counts(kmers, cmsize_log2, nhashes, seed)
    return expand_unique_counts(uniq, est)


def occurrence_labels_device(h: torch.Tensor,
                             valid: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 k-mer values of any shape + validity (None: every lane valid)
    -> (labels, validity), both flat and of the stream's length: the
    valid lanes' labels first, in sorted order of their values, then the
    invalid lanes, masked.  The valid labels are the host's
    `occurrence_expand` of the same values, element for element as a
    multiset (the JAX package sorts by unsigned value, this by signed:
    both group equal values into one run, and a run's labels do not
    depend on where it lies).  The run arithmetic works in place: its
    peak is the sort's."""
    flat = h.reshape(-1)
    s = torch.sort(flat if valid is None else flat[valid.reshape(-1)]
                   ).values
    n = s.numel()
    occ = torch.arange(n, dtype=torch.int64, device=s.device)
    start = torch.ones(n, dtype=torch.bool, device=s.device)
    torch.ne(s[1:], s[:-1], out=start[1:])
    run_start = torch.cummax(torch.where(start, occ, 0), 0).values
    del start
    occ.sub_(run_start).add_(1)
    del run_start
    labels = torch.zeros_like(flat)
    labels[:n] = wang_hash(occ.mul_(_GOLDEN_I64).bitwise_xor_(s))
    sv = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    sv[:n] = True
    return labels, sv
