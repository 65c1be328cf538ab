"""Sparse HLL queries: short reads against one dense reference sketch
(port of dashing_tpu/sketch/sparse.py, the engine behind `readfilt`).

A read of L bases occupies at most L of the reference's 2^p buckets, so
its joint-MLE statistics come from the reference's register histogram
plus a correction at the occupied buckets: O(L) a read, not O(2^p).  With
the query register a_j = 0 everywhere, the statistics against dense
registers b are (bins = register values)

    gt_a = 0                 lt_a[0] = m - C_B[0]      gt_b[k>0] = C_B[k]
    lt_b = 0                 eq[0]   = C_B[0]          hist_a[0] = m
    hist_u = C_B

and an occupied bucket (a > 0, b) replaces its a = 0 contribution with
the true one: the change depends on (a, b) only, so one scatter-add of
0/1 indicators a statistic collects every bucket's.

A batch of reads is computed with PyTorch ops on the device (the JAX
package computes them in XLA, with no kernel of its own): a per-row sort
of one int64 key bucket << 6 | rank (invalid slots last; an int32 key
would overflow at p = 26), the run ends (a bucket's largest rank), a
gather of the reference registers there, and the histograms by
`scatter_add_` of 0/1 indicators: integer counts, so bitwise the JAX
package's one-hot einsum while a count stays below 2^24, with the
corrections added in its order.  The cardinalities then come from the
row-estimate kernel (the direct MLE: c_b once, c_a and c_u a launch each)
and the triples from the joint-MLE kernel given c_u, on the K-first
layout (K, B, 1) against the reference's (K, 1).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.joint_mle import joint_triples
from ..ops.union_mle import estimate_rows
from . import estimators as est
from .. import device as devmod
from .hll import HLL

STAT_KEYS = ("gt_a", "lt_a", "gt_b", "lt_b", "eq", "hist_a", "hist_b",
             "hist_u")


def stats_kfirst(idx: torch.Tensor, rank: torch.Tensor,
                 ref_regs: torch.Tensor, ref_hist: torch.Tensor, p: int,
                 nbins: int) -> Dict[str, torch.Tensor]:
    """sparse_pair_stats with every statistic K-first, (nbins, B)."""
    m = 1 << p
    B = idx.shape[0]
    dev = idx.device
    rank = rank.to(torch.int64)
    key = torch.where(rank > 0, (idx.to(torch.int64) << 6) | rank, m << 6)
    key = torch.sort(key, dim=1).values
    sidx, srank = key >> 6, key & 63
    # a bucket's largest rank is the last slot of its run
    keep = srank > 0
    keep[:, :-1] &= sidx[:, :-1] != sidx[:, 1:]
    a = torch.where(keep, srank, 0)
    b = torch.where(keep, ref_regs.to(torch.int64)[sidx.clamp(max=m - 1)], 0)

    def hist(bins, w):
        # (B, L) bins and weights -> (nbins, B); bins past the window drop
        # out, as they match no column of the JAX package's one-hot
        ok = bins < nbins
        out = torch.zeros((nbins, B), dtype=torch.float32, device=dev)
        return out.scatter_add_(0, torch.where(ok, bins, 0).T.contiguous(),
                                torch.where(ok, w, 0.0).T.contiguous())

    f = lambda c: c.to(torch.float32)  # noqa: E731
    agtb, altb, aeqb = (a > b) & keep, (a < b) & keep, (a == b) & keep
    b_pos, b_zero = (b > 0) & keep, (b == 0) & keep
    col = ref_hist[:, None].expand(nbins, B)
    zeros = torch.zeros((nbins, B), dtype=torch.float32, device=dev)
    base_lt_a, base_eq, base_hist_a = zeros.clone(), zeros.clone(), zeros
    base_lt_a[0] = float(m) - ref_hist[0]
    base_eq[0] = ref_hist[0]
    base_hist_a[0] = float(m)
    base_gt_b = col.clone()
    base_gt_b[0] = 0.0
    at0 = lambda base, corr: torch.cat(  # noqa: E731
        [base[:1] + (-f(corr).sum(-1))[None], base[1:]])
    b_corr = hist(b, f(altb) - f(b_pos))
    lt_b = hist(b, f(agtb))
    return dict(
        gt_a=hist(a, f(agtb)),
        lt_a=at0(base_lt_a + hist(a, f(altb)), b_pos),
        gt_b=base_gt_b + b_corr,
        lt_b=lt_b,
        eq=at0(base_eq + hist(a, f(aeqb)), b_zero),
        hist_a=at0(base_hist_a + hist(a, f(keep)), keep),
        hist_b=col,
        hist_u=(col + hist(torch.maximum(a, b), f(agtb))) - lt_b)


def sparse_pair_stats(idx: torch.Tensor, rank: torch.Tensor,
                      ref_regs: torch.Tensor, ref_hist: torch.Tensor,
                      p: int, kbins: int = 0) -> Dict[str, torch.Tensor]:
    """Joint-MLE statistics of a batch of sparse queries against one dense
    reference.

    idx, rank: (B, L) int bucket indices and ranks of each query's
    k-mers, rank 0 marking padding and invalid windows; ref_regs: (2^p,)
    int reference registers; ref_hist: (kbins,) float32 histogram of
    ref_regs.  `kbins` windows the levels to [0, kbins): exact when every
    rank and register lies below it; 0 means the full q+2.  Returns the
    eight statistics (STAT_KEYS), each (B, kbins) float32."""
    nbins = kbins if kbins else 64 - p + 2
    st = stats_kfirst(idx, rank, ref_regs, ref_hist, p, nbins)
    return {key: st[key].T for key in STAT_KEYS}


def sparse_joint_triples(idx: torch.Tensor, rank: torch.Tensor,
                         ref_regs: torch.Tensor, ref_hist: torch.Tensor,
                         p: int, kbins: int = 0) -> torch.Tensor:
    """(B, 3) float32 joint-MLE triples (onlyQ, onlyRef, shared) of a
    sparse batch against the reference (arguments as sparse_pair_stats)."""
    nbins = kbins if kbins else 64 - p + 2
    return triples_kfirst(stats_kfirst(idx, rank, ref_regs, ref_hist, p,
                                       nbins), ref_hist, p)


def triples_kfirst(st: Dict[str, torch.Tensor], ref_hist: torch.Tensor,
                   p: int, c_b: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """K-first sparse statistics -> (B, 3) float32 triples: the queries'
    and the unions' cardinalities by one row-estimate launch each (the
    direct MLE), then K5 given c_u.  `c_b`, the reference's cardinality
    on this level window ((1,) float32, from `reference_cardinalities`),
    is estimated here when not given: a caller comparing many batches
    against one reference estimates it once a window."""
    def mle(h):
        return estimate_rows(h, p=p, kmin=0, method=est.ERTL_MLE)

    if c_b is None:
        c_b = mle(ref_hist[None].contiguous())
    c_a = mle(st["hist_a"].T.contiguous())
    c_u = mle(st["hist_u"].T.contiguous())
    tri = joint_triples(st["eq"][:, :, None], st["gt_a"][:, :, None],
                        st["gt_b"][:, :, None], st["hist_a"],
                        ref_hist[:, None].contiguous(), c_a, c_b,
                        c_u[:, None], p=p, kmin=0)
    return tri[:, :, 0].T


def reference_cardinalities(ref_hist: torch.Tensor, p: int
                            ) -> Callable[[int], torch.Tensor]:
    """kbins -> (1,) float32 direct-MLE cardinality of the reference's
    (q+2,) histogram `ref_hist` windowed to its first kbins bins
    (triples_kfirst's c_b), each window estimated once."""
    cards: Dict[int, torch.Tensor] = {}

    def card(kbins: int) -> torch.Tensor:
        if kbins not in cards:
            cards[kbins] = estimate_rows(ref_hist[None, :kbins].contiguous(),
                                         p=p, kmin=0, method=est.ERTL_MLE)
        return cards[kbins]
    return card


def level_window_bins(max_rank: int, q: int) -> int:
    """Bins of a sparse batch: the largest level seen + slack, rounded up
    to a multiple of 8, at most the full q+2 (the JAX package's rule; the
    result is exact whatever the window, as long as it holds every
    level)."""
    return min(((max_rank + 2 + 7) // 8) * 8, q + 2)


class SparseHLL:
    """An HLL stored as its occupied buckets: sorted (bucket, rank)
    pairs.  Compared against a dense HLL in O(occupied)."""

    def __init__(self, p: int, idx: Optional[np.ndarray] = None,
                 rank: Optional[np.ndarray] = None):
        if not 4 <= p <= 26:
            raise ValueError("sparse representation supports p in [4, 26]")
        self.p = int(p)
        self.idx = np.zeros(0, np.int32) if idx is None else idx
        self.rank = np.zeros(0, np.int32) if rank is None else rank

    @classmethod
    def from_hashes(cls, hashes: np.ndarray, p: int) -> "SparseHLL":
        """Hashed 64-bit values -> sparse sketch (host)."""
        tmp = HLL(p)
        tmp.add_np(np.asarray(hashes, np.uint64))
        occ = np.nonzero(tmp.regs)[0]
        return cls(p, occ.astype(np.int32), tmp.regs[occ].astype(np.int32))

    @property
    def m(self) -> int:
        return 1 << self.p

    def to_dense(self) -> HLL:
        out = HLL(self.p)
        out.regs[self.idx] = np.asarray(self.rank, np.uint8)
        return out

    def pair_query(self, ref: HLL, ref_hist: Optional[np.ndarray] = None,
                   device: Optional[torch.device] = None
                   ) -> Tuple[float, float, float]:
        """(onlySelf, onlyRef, shared) joint-MLE triple against a dense
        HLL, on `device` (default: the CLI's, `device.from_env`)."""
        device = devmod.or_env(device)
        if ref.p != self.p:
            raise ValueError("precision mismatch")
        hist = ref.histogram() if ref_hist is None else ref_hist
        L = max(len(self.idx), 1)
        idx = np.zeros((1, L), np.int32)
        rank = np.zeros((1, L), np.int32)
        idx[0, :len(self.idx)] = self.idx
        rank[0, :len(self.rank)] = self.rank
        kb = level_window_bins(max(int(np.max(self.rank, initial=0)),
                                   int(np.max(ref.regs, initial=0))),
                               64 - self.p)
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        tri = sparse_joint_triples(
            put(idx), put(rank), put(ref.regs.astype(np.int32)),
            put(np.asarray(hist, np.float32)[:kb].copy()), self.p, kb)
        a, b, x = tri[0].cpu().tolist()
        return float(a), float(b), float(x)
