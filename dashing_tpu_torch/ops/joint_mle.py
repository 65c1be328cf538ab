"""Joint-MLE Newton solve -> set triples (kernel K5, csrc/joint_mle.cu).

Counterpart of dashing_tpu/ops/pallas_jmle.py `pallas_joint_mle`: from the
K-first joint statistics of a tile (eq, gt_a, gt_b, each (K, na, nb)), the
marginal histograms ha (K, na), hb (K, nb), the marginal cardinalities
c_a (na,), c_b (nb,) and, as the TPU kernel takes it, the union estimate
c_u (na, nb) that seeds the inclusion-exclusion start, run Ertl's joint
MLE per pair and return (3, na, nb) float32 (onlyA, onlyB, shared).
lt_a = ha - eq - gt_a and lt_b = hb - eq - gt_b are derived inside.  With
no c_u the union estimate is derived inside too: ERTL_IMPROVED on hist_u
= eq + gt_a + gt_b (which equals the union histogram exactly), as the
JAX package's all-pairs engine seeds it; the sparse read filter and
`ertl_joint` pass the MLE of the union histogram instead.

`joint_triples` launches the CUDA kernel for CUDA tensors and runs the
plain PyTorch version (sketch/estimators.py `joint_mle_core`) for CPU
tensors; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..sketch import estimators as est
from . import _build

# launches of the CUDA kernel since the last reset (chip_smoke.py reads it)
launches = 0

KMAX = 66   # widest level window (pairwise._K_BUCKETS)


def joint_triples_plain(eq: torch.Tensor, gt_a: torch.Tensor,
                        gt_b: torch.Tensor, ha: torch.Tensor,
                        hb: torch.Tensor, c_a: torch.Tensor,
                        c_b: torch.Tensor, c_u: Optional[torch.Tensor] = None,
                        *, p: int, kmin: int,
                        iters: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same layout in and out;
    `iters` Newton steps (default est.jmle_iters(p), the kernel's; 0 gives
    the start)."""
    q = 64 - p
    if c_u is None:
        hist_u = (eq + gt_a + gt_b).permute(1, 2, 0)
        c_u = est.improved_estimate_windowed(hist_u, p, kmin)
    stats = {"eq": eq, "gt_a": gt_a, "gt_b": gt_b,
             "lt_a": ha[:, :, None] - eq - gt_a,
             "lt_b": hb[:, None, :] - eq - gt_b}
    la, lb, lx = est.joint_mle_core(stats, (c_a[:, None], c_b[None, :], c_u),
                                    float(1 << p), q, kmin,
                                    est.jmle_iters(p) if iters is None
                                    else iters)
    return torch.stack([la, lb, lx])


def _check(eq, gt_a, gt_b, ha, hb, c_a, c_b, c_u, p, kmin):
    ts = (eq, gt_a, gt_b, ha, hb, c_a, c_b) + (() if c_u is None else (c_u,))
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("joint statistics and cardinalities must be float32")
    if eq.dim() != 3 or gt_a.shape != eq.shape or gt_b.shape != eq.shape:
        raise ValueError("eq, gt_a, gt_b must be (K, na, nb) alike")
    K, na, nb = eq.shape
    if (ha.shape != (K, na) or hb.shape != (K, nb) or c_a.shape != (na,)
            or c_b.shape != (nb,)):
        raise ValueError(f"marginals {tuple(ha.shape)}, {tuple(hb.shape)}, "
                         f"{tuple(c_a.shape)}, {tuple(c_b.shape)} do not "
                         f"match statistics {tuple(eq.shape)}")
    if c_u is not None and c_u.shape != (na, nb):
        raise ValueError(f"union seeds {tuple(c_u.shape)} do not match "
                         f"statistics {tuple(eq.shape)}")
    if not 4 <= p <= 31:
        raise ValueError(f"p must be in [4, 31], got {p}")
    if not 1 <= K <= KMAX or kmin < 0 or kmin + K - 1 > 64 - p + 1:
        raise ValueError(f"level window kmin={kmin} K={K} outside "
                         f"[0, {64 - p + 1}] or wider than {KMAX}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must share a device")


def joint_triples(eq: torch.Tensor, gt_a: torch.Tensor, gt_b: torch.Tensor,
                  ha: torch.Tensor, hb: torch.Tensor, c_a: torch.Tensor,
                  c_b: torch.Tensor, c_u: Optional[torch.Tensor] = None,
                  *, p: int, kmin: int) -> torch.Tensor:
    """K-first joint statistics + marginals (+ the union seeds c_u, else
    derived) -> (3, na, nb) float32 triples, est.jmle_iters(p) Newton
    steps per pair."""
    _check(eq, gt_a, gt_b, ha, hb, c_a, c_b, c_u, p, kmin)
    if eq.device.type == "cpu":
        return joint_triples_plain(eq, gt_a, gt_b, ha, hb, c_a, c_b, c_u,
                                   p=p, kmin=kmin)
    if eq.device.type != "cuda":
        raise ValueError(f"unsupported device {eq.device}")
    K, na, nb = eq.shape
    eq, gt_a, gt_b, ha, hb, c_a, c_b = (
        t.contiguous() for t in (eq, gt_a, gt_b, ha, hb, c_a, c_b))
    if c_u is not None:
        c_u = c_u.contiguous()
    out = torch.empty((3, na, nb), dtype=torch.float32, device=eq.device)
    _build.launch(_lib(), "dtt_joint_mle", eq.device, eq.data_ptr(),
                  gt_a.data_ptr(), gt_b.data_ptr(), ha.data_ptr(),
                  hb.data_ptr(), c_a.data_ptr(), c_b.data_ptr(),
                  None if c_u is None else c_u.data_ptr(), out.data_ptr(), K,
                  na, nb, p, kmin, est.jmle_iters(p))
    global launches
    launches += 1
    return out


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _build.load("joint_mle", {
        "dtt_joint_mle": ([vp] * 9 + [ci] * 6 + [vp], ci)},
        # no FMA contraction: a Newton solve along a flat likelihood
        # direction turns last-bit differences into whole units of a
        # triple; rounding every operation as the plain version does keeps
        # the two within the bar (they agree bit for bit on the card)
        flags=["-fmad=false"])
