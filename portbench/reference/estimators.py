"""Ertl's maximum-likelihood cardinality estimators, written from the
paper (O. Ertl, New cardinality estimation methods for HyperLogLog
sketches, arXiv:1706.07290, 2017: the Poisson model, the MLE of one
sketch, and the joint MLE of two), in plain PyTorch of any float dtype.

Registers of a sketch with 2^p buckets take values 0..q+1, q = 64 - p.
Under the Poisson model a bucket of a set of rate x (cardinality / m) has

    P(0) = e^-x,  P(k) = e^(-x 2^-k) (1 - e^(-x 2^-k))  (1 <= k <= q),
    P(q+1) = 1 - e^(-x 2^-q).

`mle` maximises the log-likelihood of a register histogram over log x.
`joint_mle` maximises the joint log-likelihood of a pair of sketches A, B
over the rates of A\\B, B\\A and A&B, from the histograms of the register
pairs: a > b (a's value and b's value), a < b, and a == b.  Both solve by
Newton steps on the logarithms with a backtracking line search, to
convergence; no step count, damping or start is taken from the program.
In float64 they are the reference; in bfloat16 they are the control.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

MLE_STEPS = 60
JOINT_STEPS = 60
HALVINGS = 20


def levels(p: int, dtype, device) -> torch.Tensor:
    """z_k = 2^-k for k = 0..q+1 (z_{q+1} unused: it repeats z_q)."""
    q = 64 - p
    k = torch.arange(q + 2, device=device, dtype=torch.float64)
    z = torch.pow(2.0, -torch.clamp(k, max=q))
    return z.to(dtype)


def log_p(x: torch.Tensor, p: int) -> torch.Tensor:
    """log P(k | x) for every level k = 0..q+1, x (...,) -> (..., q+2)."""
    q = 64 - p
    z = levels(p, x.dtype, x.device)
    t = x[..., None] * z
    lp = -t + torch.log(-torch.expm1(-t))
    lp0 = -x[..., None]
    lpt = torch.log(-torch.expm1(-t[..., q:q + 1]))
    return torch.cat([lp0, lp[..., 1:q + 1], lpt], dim=-1)


def histogram(regs: torch.Tensor, p: int, dtype=torch.float64
              ) -> torch.Tensor:
    """(n, m) registers -> (n, q+2) counts of each value."""
    q = 64 - p
    n = regs.shape[0]
    flat = regs.to(torch.int64) + (q + 2) * torch.arange(
        n, device=regs.device)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=n * (q + 2)).reshape(
        n, q + 2).to(dtype)


def _start(hist: torch.Tensor, p: int) -> torch.Tensor:
    """log x from the raw harmonic-mean estimate, a start for Newton."""
    m = float(1 << p)
    z = levels(p, hist.dtype, hist.device)
    denom = (hist * z).sum(-1)
    x0 = 0.7213 / (1.0 + 1.079 / m) * m / denom
    return torch.log(torch.clamp(x0, min=1e-9))


def _wsum(h: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """sum of h * lp over levels, levels with no registers left out (their
    log-probability may be -inf)."""
    return torch.where(h > 0, h * lp, 0.0).sum(-1)


def _mle_loglik(u: torch.Tensor, hist: torch.Tensor, p: int) -> torch.Tensor:
    return _wsum(hist, log_p(torch.exp(u), p))


def mle(hist: torch.Tensor, p: int) -> torch.Tensor:
    """Cardinalities (n,) of histograms (n, q+2): the Poisson MLE times m.
    An empty sketch gives 0, a full one inf."""
    m = float(1 << p)
    q = 64 - p
    total = hist.sum(-1)
    empty = hist[:, 0] >= total
    full = hist[:, q + 1] >= total
    u = maximise(lambda v, rows: _mle_loglik(v[:, 0], hist[rows], p),
                 _start(hist, p)[:, None], MLE_STEPS, max_step=1.0)[:, 0]
    est = torch.exp(u) * m
    est = torch.where(full, torch.inf, est)
    return torch.where(empty, 0.0, est)


def _derivatives(f, u: torch.Tensor, rows: torch.Tensor):
    """(f, gradient, Hessian) of a function of each row of u (r, d) whose
    rows do not interact."""
    uu = u.clone().requires_grad_(True)
    L = f(uu, rows)
    (g,) = torch.autograd.grad(L.sum(), uu, create_graph=True)
    d = u.shape[1]
    H = torch.stack([torch.autograd.grad(g[:, i].sum(), uu,
                                         retain_graph=i < d - 1)[0]
                     for i in range(d)], 1)
    return L.detach(), g.detach(), H.detach()


def maximise(f, u: torch.Tensor, steps: int, max_step: float,
             floor: torch.Tensor = None) -> torch.Tensor:
    """Maximise f(u[rows], rows) (r,) for each row of u (n, d), d <= 3:
    Newton steps where the Hessian is negative definite, else gradient
    steps, each at most max_step long, with a backtracking line search
    that never lowers f.  A row stops once no step moves it by more than
    1e-13; `floor` bounds u from below."""
    u = u.clone()
    active = torch.arange(u.shape[0], device=u.device)
    for _ in range(steps):
        if active.numel() == 0:
            break
        ua = u[active]
        L, g, H = _derivatives(f, ua, active)
        if ua.shape[1] == 1:
            nd = H[:, 0, 0] < 0
            newton = g / torch.where(nd, H[:, 0, 0], -1.0)[:, None]
        else:
            newton, nd = _solve3(H, g)
        step = torch.where(nd[:, None], -newton, g)
        norm = step.norm(dim=-1, keepdim=True)
        step = step * torch.clamp(max_step / torch.clamp(norm, min=1e-30),
                                  max=1.0)
        step = torch.where(torch.isfinite(step), step, 0.0)
        new = ua.clone()
        done = torch.zeros_like(L, dtype=torch.bool)
        pending = torch.arange(ua.shape[0], device=u.device)
        t = 1.0
        for _ in range(HALVINGS):
            cand = ua[pending] + t * step[pending]
            if floor is not None:
                cand = torch.maximum(cand, floor)
            with torch.no_grad():
                Lc = f(cand, active[pending])
            ok = torch.isfinite(Lc) & (Lc >= L[pending])
            new[pending[ok]] = cand[ok]
            done[pending[ok]] = True
            pending = pending[~ok]
            if pending.numel() == 0:
                break
            t *= 0.5
        moved = done & ((new - ua).abs().amax(-1) > 1e-13)
        u[active] = new
        active = active[moved]
    return u


# --------------------------------------------------------------------------
# the joint MLE of two sketches

def pair_statistics(a: torch.Tensor, b: torch.Tensor, p: int,
                    dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """Histograms of register pairs for every pair of rows of a (na, m)
    and b (nb, m), each (na, nb, q+2): gt_a (a's value where a > b), lt_b
    (b's value where a > b), gt_b (b's value where b > a), lt_a (a's value
    where a < b), eq (the value where a == b).  Counted exactly by float64
    products of level indicators."""
    q = 64 - p
    na, nb = a.shape[0], b.shape[0]
    out = {key: torch.zeros(na, nb, q + 2, dtype=torch.float64,
                            device=a.device)
           for key in ("gt_a", "lt_b", "gt_b", "lt_a", "eq")}
    lo = int(min(a.min(), b.min()))
    hi = int(max(a.max(), b.max()))
    for k in range(lo, hi + 1):
        ak, bk = (a == k).double(), (b == k).double()
        alt, blt = (a < k).double(), (b < k).double()
        agt, bgt = (a > k).double(), (b > k).double()
        out["eq"][:, :, k] = ak @ bk.T
        out["gt_a"][:, :, k] = ak @ blt.T
        out["lt_a"][:, :, k] = ak @ bgt.T
        out["gt_b"][:, :, k] = alt @ bk.T
        out["lt_b"][:, :, k] = agt @ bk.T
    return {key: v.to(dtype) for key, v in out.items()}


def _log_peq(xa, xb, xx, p: int) -> torch.Tensor:
    """log P(a == b == k) for every level k, (...,) -> (..., q+2)."""
    q = 64 - p
    z = levels(p, xa.dtype, xa.device)
    s = (xa + xb + xx)[..., None]
    one_uw = -torch.expm1(-(xa + xx)[..., None] * z)
    one_vw = -torch.expm1(-(xb + xx)[..., None] * z)
    one_w = -torch.expm1(-xx[..., None] * z)
    inner = torch.log(one_uw * one_vw + torch.exp(-s * z) * one_w)
    mid = -s * z + inner
    return torch.cat([-s, mid[..., 1:q + 1], inner[..., q:q + 1]], dim=-1)


def joint_loglik(theta: torch.Tensor, st: Dict[str, torch.Tensor],
                 p: int) -> torch.Tensor:
    """Joint log-likelihood (P,) at theta = log(x_a, x_b, x_x), (P, 3)."""
    xa, xb, xx = torch.exp(theta).unbind(-1)
    return (_wsum(st["gt_a"], log_p(xa, p))
            + _wsum(st["lt_b"], log_p(xb + xx, p))
            + _wsum(st["gt_b"], log_p(xb, p))
            + _wsum(st["lt_a"], log_p(xa + xx, p))
            + _wsum(st["eq"], _log_peq(xa, xb, xx, p)))


def _solve3(H: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(H^-1 g by the adjugate, whether H is negative definite), for
    symmetric (P, 3, 3) H in any dtype."""
    a, b, c = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    d, e, f = H[:, 1, 1], H[:, 1, 2], H[:, 2, 2]
    A, B, C = d * f - e * e, c * e - b * f, b * e - c * d
    det = a * A + b * B + c * C
    D, E, F = a * f - c * c, b * c - a * e, a * d - b * b
    nd = (a < 0) & (F > 0) & (det < 0)
    safe = torch.where(det == 0, 1.0, det)
    x = torch.stack([(A * g[:, 0] + B * g[:, 1] + C * g[:, 2]) / safe,
                     (B * g[:, 0] + D * g[:, 1] + E * g[:, 2]) / safe,
                     (C * g[:, 0] + E * g[:, 1] + F * g[:, 2]) / safe], -1)
    return x, nd


def joint_mle(st: Dict[str, torch.Tensor], c_a: torch.Tensor,
              c_b: torch.Tensor, c_u: torch.Tensor, p: int) -> torch.Tensor:
    """(P, 3) cardinalities of A\\B, B\\A and A&B for P pairs, given the
    pairs' statistics (each (P, q+2)) and the single MLEs of A, B and the
    union, which give the start by inclusion and exclusion.  A rate is not
    followed below 1e-9 elements: it adds nothing to a Jaccard index."""
    m = float(1 << p)
    tiny = 1e-3
    theta = torch.log(torch.stack([
        torch.clamp(c_u - c_b, min=tiny), torch.clamp(c_u - c_a, min=tiny),
        torch.clamp(c_a + c_b - c_u, min=tiny)], -1) / m)
    floor = torch.full((3,), math.log(1e-9 / m), dtype=theta.dtype,
                       device=theta.device)
    theta = maximise(
        lambda th, rows: joint_loglik(th, {key: v[rows]
                                           for key, v in st.items()}, p),
        theta, JOINT_STEPS, max_step=2.0, floor=floor)
    out = torch.exp(theta) * m
    empty_a, empty_b = c_a <= 0, c_b <= 0
    out[:, 0] = torch.where(empty_a, 0.0, out[:, 0])
    out[:, 1] = torch.where(empty_b, 0.0, out[:, 1])
    out[:, 2] = torch.where(empty_a | empty_b, 0.0, out[:, 2])
    return out


# --------------------------------------------------------------------------
# distances

def incl_excl(c_a, c_b, c_u) -> torch.Tensor:
    """(..., 3) (A\\B, B\\A, A&B) by inclusion and exclusion."""
    shared = torch.clamp(c_a + c_b - c_u, min=0.0)
    return torch.stack([torch.clamp(c_a - shared, min=0.0),
                        torch.clamp(c_b - shared, min=0.0), shared], -1)


def jaccard(tri: torch.Tensor) -> torch.Tensor:
    """Jaccard index of (..., 3) triples, 0 where the union is empty."""
    den = tri.sum(-1)
    return torch.where(den > 0, tri[..., 2] / torch.where(den > 0, den, 1.0),
                       0.0)


def mash(ji: torch.Tensor, k: int) -> torch.Tensor:
    """Mash distance -ln(2J / (1 + J)) / k, 1 where J is 0."""
    pos = ji > 0
    r = 2.0 * ji / (1.0 + ji)
    return torch.where(pos, -torch.log(torch.where(pos, r, 1.0)) / k, 1.0)


def jaccard_of_mash(d: torch.Tensor, k: int) -> torch.Tensor:
    """The Jaccard index a Mash distance stands for (0 for d = 1)."""
    x = torch.exp(-k * d.to(torch.float64))
    return torch.where(d >= 1.0, 0.0, x / (2.0 - x))
