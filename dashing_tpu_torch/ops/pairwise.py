"""All-pairs HLL comparison (port of dashing_tpu/ops/pairwise.py).

Every statistic the estimators need is a dot product over the register
axis:

    cum_union[i, j, l] = #(max(a_i, b_j) <= kmin + l) = [a_i <= k] . [b_j <= k]

so a tile of pairs on the main path is K indicator products, counted by
the X-only form of kernel K4 (ops/joint_stats.cum_union_counts: binary
MMAs of the indicators' bit planes on the tensor cores, exact int32
counts, where the JAX package's `_dot` counts int8 indicators), then
kernel K3 (ops/union_mle.py) turns the cumulative counts into set
triples, and `measure_from_triples` into the requested measure.

On the CPU the counts are K4's plain version: float32 matmuls of the 0/1
indicators with TF32 off; every count is an integer below 2^24, so the
result is exact.  The CLI turns TF32 off where it resolves the device
(device.from_env); a caller that turned it on gets an error from the plain
version rather than rounded counts.

The joint MLE (-J, jestim = ERTL_JOINT_MLE) takes the other route: kernel
K4 (ops/joint_stats.py) counts the joint statistics eq, gt_a, gt_b (and
cum_union) of a tile, and kernel K5 (ops/joint_mle.py) solves each pair's
joint likelihood.

Not ported yet: rectangular and nearest-neighbour compares, and the TPU
kernel-probe machinery (which exists only because Mosaic compiles crash).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..sketch import estimators as est
from .joint_mle import joint_triples
from .joint_stats import cum_union_counts, joint_pair_stats
from .union_mle import estimate_rows, union_triples

MASH_DIST = 0
JI = 1
SIZES = 2
FULL_MASH_DIST = 3
FULL_CONTAINMENT_DIST = 4
CONTAINMENT_INDEX = 5
CONTAINMENT_DIST = 6
SYMMETRIC_CONTAINMENT_INDEX = 7
SYMMETRIC_CONTAINMENT_DIST = 8

def marginal_histograms(regs: torch.Tensor, kmin: int, K: int
                        ) -> torch.Tensor:
    """(n, m) registers -> (n, K) float32 counts of values kmin..kmin+K-1,
    by one bincount over row * K + level (no (n, m, K) one-hot)."""
    n = regs.shape[0]
    v = regs.to(torch.int64) - kmin
    keep = (v >= 0) & (v < K)
    rows = torch.arange(n, device=regs.device, dtype=torch.int64)[:, None]
    flat = (rows * K + v)[keep]
    return torch.bincount(flat, minlength=n * K).reshape(n, K).to(torch.float32)


def pair_stats(a: torch.Tensor, b: torch.Tensor, kmax: int, kmin: int = 0,
               same: bool = False, joint: bool = False
               ) -> Dict[str, torch.Tensor]:
    """Pairwise statistics over levels kmin..kmax: cum_union (na, nb, K)
    float32 plus the marginal histograms hist_a (na, K), hist_b (nb, K);
    with `joint`, also eq, gt_a, gt_b (na, nb, K).  All from kernel K4
    (its X-only form without `joint`), as views of its K-first output.
    same=True asserts a and b are the same bank (diagonal tiles): the
    diagonal of cum_union is then each row's cumulative histogram, and
    differencing it gives the marginals exactly."""
    K = kmax - kmin + 1
    if joint:
        st = joint_pair_stats(a, b, kmin=kmin, kmax=kmax, same=same)
        out = {key: t.permute(1, 2, 0) for key, t in st.items()}
    else:
        out = {"cum_union": cum_union_counts(a, b, kmin=kmin,
                                             kmax=kmax).permute(1, 2, 0)}
    if same:
        d = torch.diagonal(out["cum_union"], dim1=0, dim2=1).T   # (na, K)
        out["hist_a"] = torch.cat([d[:, :1], d[:, 1:] - d[:, :-1]], dim=-1)
        out["hist_b"] = out["hist_a"]
    else:
        out["hist_a"] = marginal_histograms(a, kmin, K)
        out["hist_b"] = marginal_histograms(b, kmin, K)
    return out


def triples_from_stats(stats: Dict[str, torch.Tensor], p: int, estim: int,
                       jestim: int, kmin: int = 0) -> torch.Tensor:
    """(na, nb, 3) set triples (onlyA, onlyB, shared) for every pair."""
    if jestim == est.ERTL_JOINT_MLE:
        # the joint start takes MLE marginals whatever the estimator
        c_a = estimate_rows(stats["hist_a"], p=p, kmin=kmin,
                            method=est.ERTL_MLE)
        c_b = (c_a if stats["hist_b"] is stats["hist_a"] else
               estimate_rows(stats["hist_b"], p=p, kmin=kmin,
                             method=est.ERTL_MLE))
        kfirst = {key: stats[key].permute(2, 0, 1)
                  for key in ("eq", "gt_a", "gt_b")}
        tri = joint_triples(kfirst["eq"], kfirst["gt_a"], kfirst["gt_b"],
                            stats["hist_a"].T, stats["hist_b"].T, c_a, c_b,
                            p=p, kmin=kmin)
        return tri.permute(1, 2, 0)
    # the marginals by the union kernel's own form of the estimator
    c_a = estimate_rows(stats["hist_a"], p=p, kmin=kmin, method=estim,
                        chain=True)
    c_b = (c_a if stats["hist_b"] is stats["hist_a"] else
           estimate_rows(stats["hist_b"], p=p, kmin=kmin, method=estim,
                         chain=True))
    cumT = stats["cum_union"].permute(2, 0, 1)
    tri = union_triples(cumT, c_a, c_b, p=p, kmin=kmin, method=estim)
    return tri.permute(1, 2, 0)


def measure_from_triples(tri: torch.Tensor, result_type: int, ksinv: float
                         ) -> torch.Tensor:
    """(..., 3) triples -> (...) float32 measure, formula for formula the
    JAX package's (including its quirk that --containment-index in dist
    mode divides by the union, i.e. equals Jaccard)."""
    t0, t1, t2 = tri[..., 0], tri[..., 1], tri[..., 2]
    if result_type in (MASH_DIST, FULL_MASH_DIST, JI):
        denom = t0 + t1 + t2
        ji = torch.where(denom > 0, t2 / torch.clamp(denom, min=1e-30), 0.0)
        if result_type == JI:
            return ji.to(torch.float32)
        ratio = 2.0 * ji / (1.0 + ji)
        if result_type == MASH_DIST:
            return torch.where(ji > 0,
                               -torch.log(torch.clamp(ratio, min=1e-38)) * ksinv,
                               1.0).to(torch.float32)
        return (1.0 - ratio ** ksinv).to(torch.float32)
    if result_type == SIZES:
        return t2.to(torch.float32)
    if result_type in (SYMMETRIC_CONTAINMENT_INDEX, SYMMETRIC_CONTAINMENT_DIST):
        c = t2 / torch.clamp(torch.minimum(t0, t1) + t2, min=1e-30)
        if result_type == SYMMETRIC_CONTAINMENT_INDEX:
            return c.to(torch.float32)
        return torch.where(c > 0, -torch.log(torch.clamp(c, min=1e-38)) * ksinv,
                           1.0).to(torch.float32)
    c = t2 / torch.clamp(t0 + t1 + t2, min=1e-30)
    if result_type == CONTAINMENT_INDEX:
        return c.to(torch.float32)
    if result_type == CONTAINMENT_DIST:
        return torch.where(c > 0, -torch.log(torch.clamp(c, min=1e-38)) * ksinv,
                           1.0).to(torch.float32)
    return (1.0 - c ** ksinv).to(torch.float32)


# ---------------------------------------------------------------------------
# Host orchestration: tiled all-pairs comparison.
# ---------------------------------------------------------------------------

def _stack_regs(sketches) -> np.ndarray:
    return np.stack([s.regs for s in sketches]).astype(np.int32)


def _device_regs(regs: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload the register matrix once as int8.  Clamp before the cast:
    legitimate registers are <= 64, but a corrupt presketched file could
    carry values >= 128 that would wrap negative in int8."""
    return torch.from_numpy(np.minimum(regs, 127).astype(np.int8)).to(device)


# Bucketed window widths, as in the JAX package (there they bound jit
# variants; here they keep the two packages' windows, and hence their
# float summation, identical).
_K_BUCKETS = (8, 16, 24, 32, 44, 58, 66)


def _tile_window(tmin: int, tmax1: int, q: int):
    """Bucket a tile pair's exact level window [tmin, tmax1]; widening is
    exact (the extra levels hold empty histogram bins)."""
    kmin = max(0, tmin - (tmin & 3))
    K = tmax1 - kmin + 1
    for b in _K_BUCKETS:
        if b >= K:
            K = b
            break
    kmax = kmin + K - 1
    if kmax > q + 1:
        kmin = max(0, kmin - (kmax - (q + 1)))
        kmax = q + 1
    return kmin, kmax


def _block_minmax(regs: np.ndarray, n: int, tile: int):
    """Per-row-block register (min, max+1) for per-tile windows."""
    return {i0: (int(regs[i0:i0 + tile].min(initial=255)),
                 int(regs[i0:i0 + tile].max(initial=0)) + 1)
            for i0 in range(0, n, tile)}


def _pair_window(mm_a, mm_b, q: int):
    """(kmax, kmin) for a tile pair."""
    lo = min(mm_a[0], mm_b[0])
    hi = min(max(mm_a[1], mm_b[1]), q + 1)
    kmin, kmax = _tile_window(lo, hi, q)
    return kmax, kmin


def compare_tile(regs_a: torch.Tensor, regs_b: torch.Tensor, p: int,
                 result_type: int, ksinv: float, estim: int, jestim: int,
                 kmax: int, kmin: int, same: bool = False) -> torch.Tensor:
    """One (na, nb) tile of the measure matrix, left on the registers'
    device (the work is queued on its stream; nothing synchronises)."""
    stats = pair_stats(regs_a, regs_b, kmax, kmin, same,
                       joint=jestim == est.ERTL_JOINT_MLE)
    tri = triples_from_stats(stats, p, estim, jestim, kmin)
    return measure_from_triples(tri, result_type, ksinv)


DEFAULT_TILE = 1024
_IN_FLIGHT = 2            # tiles queued on the device ahead of the pull


def all_pairs_condensed(sketches, result_type: int, k: int, estim: int,
                        jestim: int, device: torch.device,
                        tile: int = DEFAULT_TILE,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Symmetric comparison -> condensed upper triangle of length
    n(n-1)/2, row-major (the reference DistanceMatrix order).  `out` may
    be a preallocated array such as an io.distmat binary memmap."""
    regs = _stack_regs(sketches)
    n = regs.shape[0]
    p = sketches[0].p
    ksinv = 1.0 / k
    q = 64 - p
    mm = _block_minmax(regs, n, tile)
    if out is None:
        out = np.empty(n * (n - 1) // 2, np.float32)
    if out.shape != (n * (n - 1) // 2,):
        raise ValueError(f"output shape {out.shape} does not fit n={n}")

    def put(i0, j0, block):
        bi, bj = block.shape
        gi = (i0 + np.arange(bi, dtype=np.int64))[:, None]
        gj = (j0 + np.arange(bj, dtype=np.int64))[None, :]
        idx = (gi * (2 * n - gi - 1)) // 2 + gj - gi - 1
        if j0 >= i0 + bi:
            out[idx.reshape(-1)] = block.reshape(-1)
        else:
            sel = gj > gi
            out[idx[sel]] = block[sel]

    regs_d = _device_regs(regs, device)
    pending: deque = deque()
    for i0 in range(0, n, tile):
        for j0 in range(i0, n, tile):
            dev = compare_tile(regs_d[i0:i0 + tile], regs_d[j0:j0 + tile], p,
                               result_type, ksinv, estim, jestim,
                               *_pair_window(mm[i0], mm[j0], q),
                               same=(i0 == j0))
            pending.append((i0, j0, dev))
            if len(pending) > _IN_FLIGHT:
                i, j, d = pending.popleft()
                put(i, j, d.cpu().numpy())
    while pending:
        i, j, d = pending.popleft()
        put(i, j, d.cpu().numpy())
    return out
