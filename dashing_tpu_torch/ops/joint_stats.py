"""Pair statistics of two register banks (kernel K4, csrc/joint_stats.cu):
the joint statistics of the -J path and, in its X-only form, the
cumulative union counts of the main path.

Counterpart of dashing_tpu/ops/pallas_stats.py `pallas_pair_stats` (and of
the joint branch of dashing_tpu/ops/pairwise.py `pair_stats`).  For every
pair (i, j) of register rows and every level k of the window [kmin, kmax]:

    X[k] = #(a <= k   & b <= k)       Y[k] = #(a <= k & b <= k-1)
    Z[k] = #(a <= k-1 & b <= k)

and from them, exactly (integer counts, float32 like the JAX package):

    cum_union = X,  eq = X - Y - Z + X[k-1],  gt_a = Y - X[k-1],
    gt_b = Z - X[k-1]

with X[kmin-1] counted as well (0 when every register is >= kmin).  Out:
a dict of (K, na, nb) float32, K-first, the layout the joint-MLE kernel
reads.  `cum_union_counts` is X alone, (K, na, nb) float32 K-first, the
layout the union-MLE kernel reads.

Both entries launch the CUDA kernel (binary MMAs of indicator bit planes
on the tensor cores, exact int32 counts) for CUDA tensors and run their
plain PyTorch versions (float32 indicator matmuls, TF32 off, as the JAX
package's XLA path) for CPU tensors; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

# launches of each form of the CUDA kernel since the last reset
# (chip_smoke.py reads them)
launches = 0
cum_union_launches = 0

KMAX = 66   # widest level window (pairwise._K_BUCKETS)


def indicator_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(na, m) . (nb, m)^T of 0/1 indicators, exact in float32 (counts
    below 2^24).  A bf16/fp16 product would RETURN bf16/fp16 and round
    counts above 256/2048; TF32 would round the operands' sums."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact indicator counts need full float32 "
                           "matmuls: torch.backends.cuda.matmul.allow_tf32 "
                           "is True")
    return torch.matmul(x.to(torch.float32), y.to(torch.float32).T)


def joint_pair_stats_plain(a: torch.Tensor, b: torch.Tensor, *, kmin: int,
                           kmax: int, same: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: three indicator matmuls per level (two when
    `same` says a and b are one bank, where Z[k] = Y[k]^T)."""
    ca_prev, cb_prev = a <= kmin - 1, b <= kmin - 1
    x_prev = indicator_dot(ca_prev, cb_prev)
    cums, eqs, gtas, gtbs = [], [], [], []
    for k in range(kmin, kmax + 1):
        ca, cb = a <= k, b <= k
        x = indicator_dot(ca, cb)
        y = indicator_dot(ca, cb_prev)
        z = y.T if same else indicator_dot(ca_prev, cb)
        cums.append(x)
        eqs.append(x - y - z + x_prev)
        gtas.append(y - x_prev)
        gtbs.append(z - x_prev)
        x_prev, ca_prev, cb_prev = x, ca, cb
    return {"cum_union": torch.stack(cums), "eq": torch.stack(eqs),
            "gt_a": torch.stack(gtas), "gt_b": torch.stack(gtbs)}


def cum_union_counts_plain(a: torch.Tensor, b: torch.Tensor, *, kmin: int,
                           kmax: int) -> torch.Tensor:
    """Plain PyTorch version of the X-only form: one indicator matmul per
    level, stacked K-first."""
    return torch.stack([indicator_dot(a <= k, b <= k)
                        for k in range(kmin, kmax + 1)])


def _check(a, b, kmin, kmax):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"register rows {tuple(a.shape)}, {tuple(b.shape)} "
                         "must be (na, m) and (nb, m)")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("registers must be int8")
    if a.device != b.device:
        raise ValueError("a and b must share a device")
    if kmin < 0 or kmax > 64 or not 1 <= kmax - kmin + 1 <= KMAX:
        raise ValueError(f"level window [{kmin}, {kmax}] must lie in "
                         f"[0, 64] and hold 1..{KMAX} levels")


def joint_pair_stats(a: torch.Tensor, b: torch.Tensor, *, kmin: int,
                     kmax: int, same: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """(na, m), (nb, m) int8 registers -> {cum_union, eq, gt_a, gt_b}, each
    (K, na, nb) float32 over levels kmin..kmax.  `same` asserts a and b
    are one bank (a diagonal tile), where the plain version takes Z =
    Y^T; the kernel takes that symmetry (and X's) whenever a and b are
    one tensor."""
    _check(a, b, kmin, kmax)
    if a.device.type == "cpu":
        return joint_pair_stats_plain(a, b, kmin=kmin, kmax=kmax, same=same)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _launch(a, b, kmin, kmax, joint=True)
    global launches
    launches += 1
    return dict(zip(("cum_union", "eq", "gt_a", "gt_b"), out.unbind(0)))


def cum_union_counts(a: torch.Tensor, b: torch.Tensor, *, kmin: int,
                     kmax: int) -> torch.Tensor:
    """(na, m), (nb, m) int8 registers -> (K, na, nb) float32 cumulative
    union counts X[k] = #(a <= k & b <= k) over levels kmin..kmax (K4's
    X-only form).  For one bank on both sides (one tensor: the kernel
    then counts each unordered pair once) the diagonal holds each row's
    cumulative histogram."""
    _check(a, b, kmin, kmax)
    if a.device.type == "cpu":
        return cum_union_counts_plain(a, b, kmin=kmin, kmax=kmax)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _launch(a, b, kmin, kmax, joint=False)
    global cum_union_launches
    cum_union_launches += 1
    return out


def _launch(a, b, kmin, kmax, *, joint):
    """Run one form of the kernel on CUDA tensors: (4, K, na, nb) joint
    statistics or (K, na, nb) cumulative union counts."""
    (na, m), nb = a.shape, b.shape[0]
    a = a.contiguous()
    b = b.contiguous()
    K = kmax - kmin + 1
    out = torch.empty((4, K, na, nb) if joint else (K, na, nb),
                      dtype=torch.float32, device=a.device)
    lib = _lib()
    # scratch: each bank's indicator bit planes (K + 1 levels joint, K
    # X-only); one scratch for one bank, which the kernel takes as its
    # sign to count each unordered pair once
    words = (K + 1 if joint else K) * lib.dtt_joint_plane_words(m)
    planes_a = torch.empty(words * na, dtype=torch.int32, device=a.device)
    one_bank = a.data_ptr() == b.data_ptr() and na == nb
    planes_b = planes_a if one_bank else torch.empty(
        words * nb, dtype=torch.int32, device=a.device)
    _build.launch(lib, "dtt_joint_pair_stats" if joint else "dtt_cum_union",
                  a.device, a.data_ptr(), b.data_ptr(), planes_a.data_ptr(),
                  planes_b.data_ptr(), out.data_ptr(), na, nb, m, kmin, K)
    return out


def _lib():
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load("joint_stats", {
        "dtt_joint_plane_words": ([cll], cll),
        "dtt_joint_pair_stats": ([vp] * 5 + [ci, ci, cll, ci, ci, vp], ci),
        "dtt_cum_union": ([vp] * 5 + [ci, ci, cll, ci, ci, vp], ci)})
