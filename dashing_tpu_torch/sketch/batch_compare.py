"""Batched all-pairs comparison of the set-sketch families (port of
dashing_tpu/sketch/batch_compare.py, numpy on the host as there): each
engine gives the (onlyA, onlyB, shared) triples of every pair with the
same float64 arithmetic as the pair's full_set_comparison, vectorised
over pair tiles:

  b-bit MinHash (+ counting): tiled register-equality counts (the b-bit
      collision-corrected JI; the counting form's histogram intersection)
  Bloom filter: AND-popcount via np.bitwise_count and inclusion-exclusion
      on fill-ratio cardinalities
  bottom-k (+ counting): one vectorised sorted-merge pass per B sketch
      against every A row at once (union[:kk] threshold by merged sort,
      shared membership by searchsorted)
  SuperMinHash, densified MinHash: tiled b-bit register-equality means
  HyperMinHash: tiled equal-and-filled over filled register counts

Every engine returns (na, nb, 3) float64 with [i, j] =
A[i].full_set_comparison(B[j]); `batch_triples` dispatches by type (None
for a type without an engine).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .extra import DensifiedMinHash, HyperMinHash, SuperMinHash
from .setsketches import (BBitMinHash, BloomFilter, BottomK,
                          CountingBBitMinHash, CountingBottomK)

_TILE = 64          # A-side rows per broadcast tile (bounds memory)


def _cards(sketches) -> np.ndarray:
    return np.array([s.report() for s in sketches], np.float64)


def _ji_to_triple(ji: np.ndarray, ca: np.ndarray, cb: np.ndarray):
    """(ca + cb)/(1 + ji) union estimate -> triple, the shared tail of
    every minhash-family full_set_comparison."""
    cu = (ca[:, None] + cb[None, :]) / (1.0 + ji)
    sh = ji * cu
    return np.stack([np.maximum(ca[:, None] - sh, 0.0),
                     np.maximum(cb[None, :] - sh, 0.0), sh], axis=-1)


def _bbmh_rect(A: List[BBitMinHash], B: List[BBitMinHash]) -> np.ndarray:
    ra = np.stack([s._regs_b() for s in A])
    rb = np.stack([s._regs_b() for s in B])
    occa = np.stack([s.mins != s.EMPTY for s in A])
    occb = np.stack([s.mins != s.EMPTY for s in B])
    ca, cb = _cards(A), _cards(B)
    c = 2.0 ** -A[0].b
    na, nb = ra.shape[0], rb.shape[0]
    ji = np.zeros((na, nb), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        occ = occa[sl][:, None, :] | occb[None, :, :]
        eq = ((ra[sl][:, None, :] == rb[None, :, :]) & occ).sum(-1)
        nocc = occ.sum(-1)
        f = np.divide(eq, nocc, out=np.zeros_like(ji[sl]), where=nocc > 0)
        j = np.maximum(0.0, (f - c) / (1.0 - c))
        ji[sl] = np.where(nocc > 0, j, 0.0)
    return _ji_to_triple(ji, ca, cb)


def _cbbmh_rect(A: List[CountingBBitMinHash], B) -> np.ndarray:
    """Weighted-Jaccard ratio estimator over bucket minima, mirroring
    CountingBBitMinHash.histogram_intersection exactly: matched b-bit
    registers contribute min/max multiplicities; a mismatched bucket
    contributes only the multiplicity of the side holding the smaller
    (full, untruncated) minimum — the sampled union element."""
    ra = np.stack([s._regs_b() for s in A])
    rb = np.stack([s._regs_b() for s in B])
    ma = np.stack([s.mins for s in A])
    mb = np.stack([s.mins for s in B])
    occa = np.stack([s.mins != s.EMPTY for s in A])
    occb = np.stack([s.mins != s.EMPTY for s in B])
    cnta = np.stack([s.counts for s in A]).astype(np.int64)
    cntb = np.stack([s.counts for s in B]).astype(np.int64)
    ca, cb = _cards(A), _cards(B)
    na, nb = ra.shape[0], rb.shape[0]
    ji = np.zeros((na, nb), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        eq = ((ra[sl][:, None, :] == rb[None, :, :])
              & occa[sl][:, None, :] & occb[None, :, :])
        xa, xb = cnta[sl][:, None, :], cntb[None, :, :]
        va, vb = ma[sl][:, None, :], mb[None, :, :]
        num = np.where(eq, np.minimum(xa, xb), 0).sum(-1)
        argmin_cnt = np.where(va < vb, xa,
                              np.where(vb < va, xb, np.maximum(xa, xb)))
        den = np.where(eq, np.maximum(xa, xb), argmin_cnt).sum(-1)
        ji[sl] = np.divide(num, den, out=np.zeros_like(ji[sl]),
                           where=den > 0)
    return _ji_to_triple(ji, ca, cb)


def _densified_rect(A: List[DensifiedMinHash], B) -> np.ndarray:
    ra = np.stack([s._regs_b() for s in A])
    rb = np.stack([s._regs_b() for s in B])
    ca, cb = _cards(A), _cards(B)
    c = 2.0 ** -A[0].b
    na, nb = ra.shape[0], rb.shape[0]
    ji = np.zeros((na, nb), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        f = (ra[sl][:, None, :] == rb[None, :, :]).mean(-1)
        ji[sl] = np.maximum(0.0, (f - c) / (1.0 - c))
    return _ji_to_triple(ji, ca, cb)


def _smh_rect(A: List[SuperMinHash], B) -> np.ndarray:
    """As _densified_rect, a pair with an empty sketch at Jaccard 0."""
    ra = np.stack([s._regs_b() for s in A])
    rb = np.stack([s._regs_b() for s in B])
    fa = np.array([bool(np.isfinite(s.h).any()) for s in A])
    fb = np.array([bool(np.isfinite(s.h).any()) for s in B])
    ca, cb = _cards(A), _cards(B)
    c = 2.0 ** -A[0].b
    na, nb = ra.shape[0], rb.shape[0]
    ji = np.zeros((na, nb), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        f = (ra[sl][:, None, :] == rb[None, :, :]).mean(-1)
        ji[sl] = np.where(fa[sl][:, None] & fb[None, :],
                          np.maximum(0.0, (f - c) / (1.0 - c)), 0.0)
    return _ji_to_triple(ji, ca, cb)


def _hmh_rect(A: List[HyperMinHash], B) -> np.ndarray:
    ra = np.stack([s.regs for s in A])
    rb = np.stack([s.regs for s in B])
    ca, cb = _cards(A), _cards(B)
    c = 2.0 ** -A[0].rbits
    na, nb = ra.shape[0], rb.shape[0]
    ji = np.zeros((na, nb), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        a = ra[sl][:, None, :]
        b = rb[None, :, :]
        both = ((a == b) & (a != 0)).sum(-1)
        filled = ((a != 0) | (b != 0)).sum(-1)
        f = np.divide(both, filled, out=np.zeros((a.shape[0], nb)),
                      where=filled > 0)
        j = np.maximum(0.0, (f - c) / (1.0 - c))
        ji[sl] = np.where(filled > 0, j, 0.0)
    return _ji_to_triple(ji, ca, cb)


def _bf_rect(A: List[BloomFilter], B) -> np.ndarray:
    ba = np.stack([s.bits for s in A])
    bb = np.stack([s.bits for s in B])
    pa = np.bitwise_count(ba).sum(-1).astype(np.int64)
    pb = np.bitwise_count(bb).sum(-1).astype(np.int64)
    m = float(A[0].m)
    k = float(A[0].nhashes)

    def fill_card(bits):
        with np.errstate(divide="ignore"):   # log1p(-1) -> -inf is the
            return np.where(bits >= m, np.inf,  # saturated case, handled
                            -(m / k) * np.log1p(-bits / m))

    ca, cb = fill_card(pa.astype(np.float64)), fill_card(pb.astype(np.float64))
    na, nb = ba.shape[0], bb.shape[0]
    tris = np.empty((na, nb, 3), np.float64)
    for i0 in range(0, na, _TILE):
        sl = slice(i0, i0 + _TILE)
        inter = np.bitwise_count(
            ba[sl][:, None, :] & bb[None, :, :]).sum(-1).astype(np.int64)
        union_bits = pa[sl][:, None] + pb[None, :] - inter
        cu = fill_card(union_bits.astype(np.float64))
        with np.errstate(invalid="ignore"):
            sh = ca[sl][:, None] + cb[None, :] - cu
        # inf - inf -> nan here; the per-pair path's Python max(0.0, nan)
        # returns 0.0, so match it (saturated-filter comparisons)
        sh = np.where(np.isnan(sh), 0.0, np.maximum(sh, 0.0))
        tris[sl, :, 0] = np.maximum(ca[sl][:, None] - sh, 0.0)
        tris[sl, :, 1] = np.maximum(cb[None, :] - sh, 0.0)
        tris[sl, :, 2] = sh
    return tris


_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _pad_values(sketches, kk: int):
    """(n, kk) u64 value matrix padded with the max sentinel + lengths."""
    n = len(sketches)
    vals = np.full((n, kk), _SENT, np.uint64)
    lens = np.zeros(n, np.int64)
    for i, s in enumerate(sketches):
        v = s.values[:kk]
        vals[i, :v.size] = v
        lens[i] = v.size
    return vals, lens


def _bottomk_ji(A: List[BottomK], B: List[BottomK], counting: bool):
    """Vectorized sorted-merge bottom-k (optionally counting) JI.

    Per B sketch, one pass handles every A row: shared membership by
    searchsorted into B's sorted values, the union[:kk] threshold as the
    kk-th entry of the merged sort with shared B values masked out
    (so the merged list holds distinct values only).
    """
    kk = A[0].kk
    va, la = _pad_values(A, kk)
    na, nb = len(A), len(B)
    ji = np.zeros((na, nb), np.float64)
    valid_a = np.arange(kk)[None, :] < la[:, None]
    if counting:
        cnta = np.zeros((na, kk), np.int64)
        for i, s in enumerate(A):
            cnta[i, :min(s.counts.size, kk)] = s.counts[:kk]
    rows = np.arange(na)[:, None]
    for j, sb in enumerate(B):
        bv = np.asarray(sb.values[:kk], np.uint64)
        lb = bv.size
        if lb == 0:
            ji[:, j] = 0.0
            continue
        pos = np.searchsorted(bv, va).clip(max=max(lb - 1, 0))
        hit = valid_a & (lb > 0) & (bv[pos] == va)
        # mask B's shared values per row so the merged sort is duplicate-free
        flag = np.zeros((na, max(lb, 1)), bool)
        np.logical_or.at(flag, (np.broadcast_to(rows, hit.shape), pos), hit)
        bm = np.where(flag[:, :lb], _SENT, bv[None, :lb])
        merged = np.sort(np.concatenate(
            [va, np.pad(bm, ((0, 0), (0, kk - lb)),
                        constant_values=_SENT)], axis=1), axis=1)
        nshared = hit.sum(1)
        distinct = la + lb - nshared
        usize = np.minimum(distinct, kk)
        x = merged[:, kk - 1]                      # kk-th distinct (or SENT)
        shared_le = (hit & (va <= x[:, None])).sum(1)
        if counting:
            cntb = np.zeros(max(lb, 1), np.int64)
            cntb[:min(sb.counts.size, lb)] = sb.counts[:lb]
            cum_b = np.concatenate([[0], np.cumsum(cntb[:lb])])
            cb_at_a = np.where(hit, cntb[pos], 0)
            le_x = va <= x[:, None]
            num = np.where(hit & le_x, np.minimum(cnta, cb_at_a), 0).sum(1)
            sum_a = np.where(valid_a & le_x, cnta, 0).sum(1)
            nb_le = np.searchsorted(bv, x, side="right")
            sum_b = cum_b[nb_le]
            den = sum_a + sum_b - num
            ji[:, j] = np.divide(num, den, out=np.zeros(na),
                                 where=den > 0)
        else:
            ji[:, j] = np.divide(shared_le, usize, out=np.zeros(na),
                                 where=usize > 0)
    return ji


def _bottomk_rect(A, B, counting: bool) -> np.ndarray:
    ji = _bottomk_ji(A, B, counting)
    return _ji_to_triple(ji, _cards(A), _cards(B))


_ENGINES = {
    BBitMinHash: _bbmh_rect,
    CountingBBitMinHash: _cbbmh_rect,
    DensifiedMinHash: _densified_rect,
    SuperMinHash: _smh_rect,
    HyperMinHash: _hmh_rect,
    BloomFilter: _bf_rect,
    CountingBottomK: lambda A, B: _bottomk_rect(A, B, True),
    BottomK: lambda A, B: _bottomk_rect(A, B, False),
}


def supports(sketches) -> bool:
    """Whether batch_triples has an engine for this sketch type."""
    return type(sketches[0]) in _ENGINES


def _row_nbytes(s) -> int:
    """Approximate bytes ONE B-side sketch contributes per A row in the
    broadcast temporaries (with slack for the boolean/count intermediates
    that live alongside)."""
    if hasattr(s, "bits"):
        return int(np.asarray(s.bits).nbytes) * 4
    if hasattr(s, "_regs_b"):
        return int(np.asarray(s._regs_b()).nbytes) * 8
    if hasattr(s, "regs"):
        return int(np.asarray(s.regs).nbytes) * 4
    if hasattr(s, "values"):
        return int(getattr(s, "kk", 256)) * 16
    return 1 << 16


def batch_triples(A, B) -> Optional[np.ndarray]:
    """(na, nb, 3) float64 triples with [i, j] = A[i].full_set_comparison(
    B[j]), or None when the type has no batched engine.

    The engines tile the A axis internally (_TILE rows), and THIS wrapper
    tiles the B axis so the (tile_A, nb, m) broadcast temporaries stay
    bounded (~DASHING_TPU_HOST_TILE_MB, default 256) no matter how many
    sketches the caller passes (compare_condensed hands in entire
    sketches[i0:] suffixes: at bloom -S 20 x 1000 genomes, tens of GB
    unbounded).  Per-pair values are computed independently,
    so B-chunking is bitwise-exact."""
    fn = _ENGINES.get(type(A[0]))
    if fn is None:
        return None
    budget = int(float(os.environ.get(
        "DASHING_TPU_HOST_TILE_MB", "256")) * 1e6)
    per_b = _TILE * _row_nbytes(B[0])
    b_tile = max(16, budget // max(per_b, 1))
    if len(B) <= b_tile:
        return fn(A, B)
    return np.concatenate([fn(A, B[j0:j0 + b_tile])
                           for j0 in range(0, len(B), b_tile)], axis=1)
