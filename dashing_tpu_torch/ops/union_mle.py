"""Windowed union-cardinality estimate -> set triples (kernel K3,
csrc/union_mle.cu).

Counterpart of dashing_tpu/ops/pallas_mle.py `pallas_union_triples`: from
the K-first cumulative union counts cum[l, i, j] = #(max(a_i, b_j) <=
kmin + l) and the marginal cardinalities, estimate each pair's union c_u
with the chosen estimator and return (3, na, nb) float32
(onlyA, onlyB, shared) with shared = max(0, c_a + c_b - c_u).

`estimate_rows` runs the same estimators on (n, K) histogram rows, by
the row-estimate kernel (csrc/estimate_rows.cu): the marginal
cardinalities of a compare tile (MLE by the chain, as union_triples), the
sizes of `dist -o` and readfilt's cardinalities (MLE by the direct form,
an expm1 per level).

Both wrappers launch their CUDA kernel for CUDA tensors and run the plain
PyTorch version (the windowed estimators of sketch/estimators.py) for CPU
tensors; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from ..sketch import estimators as est
from . import _build

# launches of each CUDA kernel since the last reset (chip_smoke.py reads them)
launches = 0               # union_triples
estimate_launches = 0      # estimate_rows

KMAX = 66   # largest level window the kernel holds (pairwise._K_BUCKETS)
_MLE_CHAIN = 3   # dtt_estimate_rows' code for ERTL_MLE by the chain


def union_triples_plain(cum: torch.Tensor, c_a: torch.Tensor,
                        c_b: torch.Tensor, *, p: int, kmin: int,
                        method: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same layout in and out; MLE by
    the complement chain, as the kernel and the TPU kernel run it."""
    cumL = cum.permute(1, 2, 0)                       # (na, nb, K)
    hist = torch.cat([cumL[..., :1], cumL[..., 1:] - cumL[..., :-1]], dim=-1)
    if method == est.ERTL_MLE:
        c_u = est.mle_estimate_windowed_chain(hist, p, kmin)
    else:
        c_u = est.estimate_windowed(hist, p, kmin, method)
    shared = torch.clamp(c_a[:, None] + c_b[None, :] - c_u, min=0.0)
    only_a = torch.clamp(c_a[:, None] - shared, min=0.0)
    only_b = torch.clamp(c_b[None, :] - shared, min=0.0)
    return torch.stack([only_a, only_b, shared])


def _check_window(K, p, kmin, method):
    if not 4 <= p <= 31:
        raise ValueError(f"p must be in [4, 31], got {p}")
    if not 1 <= K <= KMAX or kmin < 0 or kmin + K - 1 > 64 - p + 1:
        raise ValueError(f"level window kmin={kmin} K={K} outside "
                         f"[0, {64 - p + 1}] or wider than {KMAX}")
    if method not in (est.ORIGINAL, est.ERTL_IMPROVED, est.ERTL_MLE):
        raise ValueError(f"estimator {method} has no union kernel")


def _check(cum, c_a, c_b, p, kmin, method):
    if cum.dim() != 3 or cum.dtype != torch.float32:
        raise TypeError("cum must be (K, na, nb) float32")
    K, na, nb = cum.shape
    if c_a.shape != (na,) or c_b.shape != (nb,):
        raise ValueError(f"marginals {tuple(c_a.shape)}, {tuple(c_b.shape)} "
                         f"do not match cum {tuple(cum.shape)}")
    if c_a.dtype != torch.float32 or c_b.dtype != torch.float32:
        raise TypeError("marginal cardinalities must be float32")
    _check_window(K, p, kmin, method)
    if not (cum.device == c_a.device == c_b.device):
        raise ValueError("cum, c_a and c_b must share a device")


def union_triples(cum: torch.Tensor, c_a: torch.Tensor, c_b: torch.Tensor,
                  *, p: int, kmin: int, method: int) -> torch.Tensor:
    """(K, na, nb) cumulative counts + (na,), (nb,) cardinalities ->
    (3, na, nb) float32 triples.  Pairs with an all-zero histogram give
    c_u = 0 for MLE; saturated ones c_u = inf, as in the JAX package."""
    _check(cum, c_a, c_b, p, kmin, method)
    if cum.device.type == "cpu":
        return union_triples_plain(cum, c_a, c_b, p=p, kmin=kmin,
                                   method=method)
    if cum.device.type != "cuda":
        raise ValueError(f"unsupported device {cum.device}")
    K, na, nb = cum.shape
    cum = cum.contiguous()
    c_a = c_a.contiguous()
    c_b = c_b.contiguous()
    out = torch.empty((3, na, nb), dtype=torch.float32, device=cum.device)
    _build.launch(_lib(), "dtt_union_triples", cum.device, cum.data_ptr(),
                  c_a.data_ptr(), c_b.data_ptr(), out.data_ptr(), K, na, nb,
                  p, kmin, method)
    global launches
    launches += 1
    return out


def estimate_rows_plain(hist: torch.Tensor, *, p: int, kmin: int,
                        method: int, iters: int = est.WINDOW_MLE_ITERS,
                        chain: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the row-estimate kernel."""
    if method == est.ERTL_MLE:
        if chain:
            return est.mle_estimate_windowed_chain(hist, p, kmin, iters=iters)
        return est.mle_estimate_windowed(hist, p, kmin, iters=iters)
    return est.estimate_windowed(hist, p, kmin, method)


def row_lanes(n: int, method: int) -> int:
    """Lanes a row the row-estimate kernel takes for n rows: for an MLE a
    warp a row up to a compare tile's 1,024 rows (the Newton steps'
    latency spread over its lanes), 8 lanes a row above (enough warps to
    fill the card at a readfilt batch's 8,192 rows, 3 levels a lane at
    K = 24); ORIGINAL and ERTL_IMPROVED a thread a row.  chip_smoke.py
    times both MLE forms at every row shape of the main path (PERF.md
    section 6)."""
    if method != est.ERTL_MLE:
        return 1
    return 32 if n <= 1024 else 8


def estimate_rows(hist: torch.Tensor, *, p: int, kmin: int, method: int,
                  iters: int = est.WINDOW_MLE_ITERS,
                  chain: bool = False) -> torch.Tensor:
    """(n, K) float32 histograms over levels kmin..kmin+K-1 -> (n,) float32
    cardinality estimates; `iters` Newton steps for ERTL_MLE, by the
    direct form or, with `chain`, by the complement chain that
    union_triples takes (the marginals of a compare tile: a pair's union
    and its marginals then come from one function, so a pair beside an
    empty sketch shares exactly 0 and identical sketches share all)."""
    if hist.dim() != 2 or hist.dtype != torch.float32:
        raise TypeError("hist must be (n, K) float32")
    n, K = hist.shape
    _check_window(K, p, kmin, method)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if hist.device.type == "cpu":
        return estimate_rows_plain(hist, p=p, kmin=kmin, method=method,
                                   iters=iters, chain=chain)
    return _launch_rows(hist, p=p, kmin=kmin, method=method, iters=iters,
                        chain=chain, lanes=row_lanes(n, method))


def _launch_rows(hist: torch.Tensor, *, p: int, kmin: int, method: int,
                 iters: int, chain: bool, lanes: int) -> torch.Tensor:
    """The row-estimate kernel on a CUDA `hist` that estimate_rows has
    checked, in the form `lanes` (1 for ORIGINAL and ERTL_IMPROVED, 8 or
    32 for ERTL_MLE; the kernel refuses any other); the card's tests and
    chip_smoke.py force each form through it."""
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    n, K = hist.shape
    hist = hist.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=hist.device)
    code = _MLE_CHAIN if chain and method == est.ERTL_MLE else method
    _build.launch(_rows_lib(), "dtt_estimate_rows", hist.device,
                  hist.data_ptr(), out.data_ptr(), n, K, p, kmin, code, iters,
                  lanes)
    global estimate_launches
    estimate_launches += 1
    return out

def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("union_mle", {
        "dtt_union_triples": ([vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp],
                              ci)},
        # no FMA contraction: the plain version rounds every operation
        flags=["-fmad=false"])


def _rows_lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("estimate_rows", {
        "dtt_estimate_rows": ([vp, vp] + [ci] * 7 + [vp], ci)},
        flags=["-fmad=false"])
