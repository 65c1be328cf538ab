"""HyperLogLog cardinality estimators (port of dashing_tpu/sketch/estimators.py).

ORIGINAL (Flajolet with the small-range correction), ERTL_IMPROVED and
ERTL_MLE (Poisson maximum likelihood by damped Newton on u = log x), on
register histograms C[..., k] = #registers with value k, float32 like the
JAX package.  Levels are on the LAST axis (the JAX package's K-last XLA
form); the windowed forms take levels kmin..kmin+K-1 only, exact when
every register lies inside the window.

These are the plain versions of the estimators in csrc/union_mle.cu (the
union-MLE kernel and the row-estimate kernel, ops/union_mle.py); on the
card those kernels run instead.  Single-sketch estimates (`-o` sizes,
HLL.report) take the direct MLE, an expm1 per level, as the JAX package
does; a compare tile's unions and marginals take the complement chain
(`mle_estimate_windowed_chain`, the TPU kernel's form).  They are written
in the kernels' operation order: sums over levels run level by level
(from the lowest, the chain's from the top), every operation rounds on
its own (the kernel is built without FMA contraction), and
scalar-over-tensor divisions are true divisions (torch's `scalar /
tensor` is a reciprocal and a multiply).  Union estimates of millions
then agree to the last bits, which matters because the set triples
difference them.

The joint MLE (-J, `joint_mle_core`) is the plain version of the joint-MLE
kernel (csrc/joint_mle.cu, ops/joint_mle.py); `joint_mle` runs it on one
pair's full histograms, or on a batch of queries against one reference,
through that kernel's wrapper.  It takes the statistics
K-FIRST, (K, *batch), as the JAX package's fused kernel does, and runs in
the kernel's operation order: every level sum runs from the top level
down, as the complement chains are walked.
"""
from __future__ import annotations

import math

import torch

ORIGINAL = 0
ERTL_IMPROVED = 1
ERTL_MLE = 2
ERTL_JOINT_MLE = 3

_ALPHA_INF = 1.0 / (2.0 * math.log(2.0))

WINDOW_MLE_ITERS = 12   # Newton steps on a compare window (as the JAX package)
FULL_MLE_ITERS = 24     # Newton steps on a full single-sketch histogram


def _alpha(m: float) -> float:
    if m >= 128:
        return 0.7213 / (1.0 + 1.079 / m)
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(int(m),
                                                 0.7213 / (1.0 + 1.079 / m))


def _sigma(x: torch.Tensor, iters: int) -> torch.Tensor:
    """sigma(x) = x + sum_{k>=1} x^(2^k) 2^(k-1); sigma(1) = +inf."""
    xx, y, z = x, torch.ones_like(x), x
    for _ in range(iters):
        xx = xx * xx
        z = z + xx * y
        y = y * 2.0
    return torch.where(x >= 1.0, torch.inf, z)


def _tau(x: torch.Tensor, iters: int) -> torch.Tensor:
    """tau(x) = (1/3)(1 - x - sum_{k>=1} (1 - x^(2^-k))^2 2^-k)."""
    xx, y, z = x, torch.ones_like(x), 1.0 - x
    for _ in range(iters):
        xx = torch.sqrt(xx)
        y = y * 0.5
        z = z - (1.0 - xx) ** 2 * y
    return torch.where((x <= 0.0) | (x >= 1.0), 0.0, z * (1.0 / 3.0))


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as a true float32 division."""
    return torch.full_like(t, num) / t


def _win_parts(Cw: torch.Tensor, p: int, kmin: int):
    """Split a K-last windowed histogram into (C0, Ctop, [(C_l, 2^-l) for
    the mid levels l = max(kmin,1)..min(kmax,q)])."""
    q = 64 - p
    K = Cw.shape[-1]
    kmax = kmin + K - 1
    lo, hi = max(kmin, 1), min(kmax, q)
    zeros = torch.zeros(Cw.shape[:-1], dtype=Cw.dtype, device=Cw.device)
    c0 = Cw[..., 0] if kmin == 0 else zeros
    ctop = Cw[..., -1] if kmax == q + 1 else zeros
    mid = [(Cw[..., l - kmin], 2.0 ** -l) for l in range(lo, hi + 1)]
    return c0, ctop, mid


def original_estimate_windowed(Cw: torch.Tensor, p: int, kmin: int
                               ) -> torch.Tensor:
    m = float(1 << p)
    K = Cw.shape[-1]
    denom = torch.zeros(Cw.shape[:-1], dtype=Cw.dtype, device=Cw.device)
    for l in range(K):
        denom = denom + Cw[..., l] * (2.0 ** -(kmin + l))
    c0 = Cw[..., 0] if kmin == 0 else torch.zeros_like(denom)
    e = _rdiv(_alpha(m) * m * m, denom)
    small = (e <= 2.5 * m) & (c0 > 0)
    e_small = m * torch.log(_rdiv(m, torch.clamp(c0, min=1e-9)))
    return torch.where(small, e_small, e)


def improved_estimate_windowed(Cw: torch.Tensor, p: int, kmin: int
                               ) -> torch.Tensor:
    m = float(1 << p)
    q = 64 - p
    K = Cw.shape[-1]
    c0, ctop, mid = _win_parts(Cw, p, kmin)
    denom = torch.zeros(Cw.shape[:-1], dtype=Cw.dtype, device=Cw.device)
    for c, z in mid:
        denom = denom + c * z
    if kmin == 0:
        denom = denom + m * _sigma(c0 / m, iters=p + 6)
    if kmin + K - 1 == q + 1:
        denom = denom + m * _tau(1.0 - ctop / m, iters=24) * (2.0 ** -q)
    return _rdiv(_ALPHA_INF * m * m, denom)


def _mle_dlogl12(x, c0, ctop, mid, q: int):
    """(L'(x), L''(x)) of the Poisson log-likelihood on a window; w =
    z / expm1(x z) <= 1/x stays finite in float32."""
    d1 = torch.zeros_like(x)
    d2 = torch.zeros_like(x)
    for c, z in mid:
        w = _rdiv(z, torch.expm1(torch.clamp(x * z, min=1e-30)))
        d1 = d1 + c * (w - z)
        d2 = d2 + c * (-(w * w + z * w))
    d1 = d1 - c0
    zq = 2.0 ** -q
    wq = _rdiv(zq, torch.expm1(torch.clamp(x * zq, min=1e-30)))
    return d1 + ctop * wq, d2 + ctop * (-(wq * wq + zq * wq))


def mle_estimate_windowed(Cw: torch.Tensor, p: int, kmin: int,
                          iters: int = WINDOW_MLE_ITERS) -> torch.Tensor:
    """Poisson MLE on a level window: improved init clipped to
    [1e-12, 2^(q+1)], `iters` damped Newton steps on u = log x with the
    step clipped to +-1."""
    m = float(1 << p)
    q = 64 - p
    c0, ctop, mid = _win_parts(Cw, p, kmin)
    mtot = Cw.sum(-1)                   # integer counts: exact in any order
    empty = c0 >= mtot
    full = ctop >= mtot
    x0 = torch.clamp(improved_estimate_windowed(Cw, p, kmin) / m,
                     1e-12, 2.0 ** (q + 1))
    u = torch.log(x0)
    for _ in range(iters):
        x = torch.exp(u)
        g, gp = _mle_dlogl12(x, c0, ctop, mid, q)
        dldu = x * g
        d2 = dldu + x * x * gp
        step = dldu / torch.clamp(d2, max=-1e-9)
        u = u - torch.clamp(step, -1.0, 1.0)
    est = torch.exp(u) * m
    # full first, empty LAST: a zero-mass histogram satisfies both masks
    # and must give 0, not inf
    est = torch.where(full, torch.inf, est)
    return torch.where(empty, 0.0, est)


def mle_estimate_windowed_chain(Cw: torch.Tensor, p: int, kmin: int,
                                iters: int = WINDOW_MLE_ITERS
                                ) -> torch.Tensor:
    """mle_estimate_windowed by the complement chain, the form of the TPU
    kernel (the JAX package's K-first `_mle_dlogl12_chain`) and of the
    union-MLE kernel (csrc/hll_estimators.cuh `mle_chain_win`), in that
    kernel's operation order.  Per Newton step ONE expm1 seed at the
    window's highest mid level hi (q when the window holds the top bin)
    gives c = 1 - exp(-x 2^-l) at every mid level l by c[l-1] = c[l] (2 -
    c[l]), and w = z ((1 - c) / c) takes the place of z / expm1(x z);
    mid levels are summed from the top down."""
    m = float(1 << p)
    q = 64 - p
    K = Cw.shape[-1]
    kmax = kmin + K - 1
    lo, hi = max(kmin, 1), min(kmax, q)
    c0, ctop, _ = _win_parts(Cw, p, kmin)
    mtot = Cw.sum(-1)
    empty = c0 >= mtot
    full = ctop >= mtot
    x0 = torch.clamp(improved_estimate_windowed(Cw, p, kmin) / m,
                     1e-12, 2.0 ** (q + 1))
    u = torch.log(x0)
    zq, zhi = 2.0 ** -q, 2.0 ** -hi
    for _ in range(iters):
        x = torch.exp(u)
        chi = torch.clamp(-torch.expm1(-(x * zhi)), min=1e-30)
        c = chi
        d1 = torch.zeros_like(x)
        d2 = torch.zeros_like(x)
        for l in range(hi, lo - 1, -1):
            z = 2.0 ** -l
            w = z * ((1.0 - c) / c)
            h = Cw[..., l - kmin]
            d1 = d1 + h * (w - z)
            d2 = d2 + h * (-(w * w + z * w))
            c = c * (2.0 - c)
        d1 = d1 - c0
        if kmax == q + 1:               # c_q is the seed: hi = q
            wq = zq * (1.0 - chi) / chi
            d1 = d1 + ctop * wq
            d2 = d2 + ctop * (-(wq * wq + zq * wq))
        dldu = x * d1
        d2 = dldu + x * x * d2
        step = dldu / torch.clamp(d2, max=-1e-9)
        u = u - torch.clamp(step, -1.0, 1.0)
    est = torch.exp(u) * m
    est = torch.where(full, torch.inf, est)
    return torch.where(empty, 0.0, est)


def estimate_windowed(Cw: torch.Tensor, p: int, kmin: int,
                      method: int = ERTL_MLE) -> torch.Tensor:
    if method == ORIGINAL:
        return original_estimate_windowed(Cw, p, kmin)
    if method == ERTL_IMPROVED:
        return improved_estimate_windowed(Cw, p, kmin)
    if method == ERTL_MLE:
        return mle_estimate_windowed(Cw, p, kmin)
    raise ValueError(f"estimator {method} is not ported (joint MLE: see ROADMAP)")


# Full-histogram forms (levels 0..q+1): the single-sketch estimates that
# HLL.report and the -o cardinality file use.

def original_estimate(C: torch.Tensor, p: int) -> torch.Tensor:
    return original_estimate_windowed(C, p, 0)


def improved_estimate(C: torch.Tensor, p: int) -> torch.Tensor:
    return improved_estimate_windowed(C, p, 0)


def mle_estimate(C: torch.Tensor, p: int, iters: int = FULL_MLE_ITERS
                 ) -> torch.Tensor:
    return mle_estimate_windowed(C, p, 0, iters=iters)


def estimate(C: torch.Tensor, p: int, method: int = ERTL_MLE) -> torch.Tensor:
    if method == ORIGINAL:
        return original_estimate(C, p)
    if method == ERTL_IMPROVED:
        return improved_estimate(C, p)
    if method == ERTL_MLE:
        return mle_estimate(C, p)
    raise ValueError(f"estimator {method} is not ported (joint MLE: see ROADMAP)")


# ---------------------------------------------------------------------------
# Joint MLE over register pairs (K-first; the -J path).
#
# Ertl's 3-parameter joint maximum likelihood on (la, lb, lx) = (|A\B|,
# |B\A|, |A&B|): a damped Newton solve in theta = log lambda with the
# analytic gradient and Hessian (autodiff of the likelihood is NaN), from an
# inclusion-exclusion start, guarded at the end by one likelihood
# comparison against that start.  Every e^{-x z_k} comes from one expm1
# seed per chain (_compl_chain); levels are walked from the top down.
# ---------------------------------------------------------------------------

def jmle_iters(p: int) -> int:
    """Newton iterations of the joint MLE at precision p (the JAX
    package's measured choice: converged at 8 for p >= 12, 10 below)."""
    return 8 if p >= 12 else 10


def _compl_chain(x: torch.Tensor, c_lo: int, c_hi: int) -> dict:
    """{k: 1 - exp(-x 2^-k)} for k = c_lo..c_hi from ONE expm1 seed at the
    deepest level, walked down by c[k-1] = c[k] (2 - c[k])."""
    c = {c_hi: torch.clamp(-torch.expm1(-(x * (2.0 ** -c_hi))), min=1e-30)}
    for k in range(c_hi - 1, c_lo - 1, -1):
        ck = c[k + 1]
        c[k] = ck * (2.0 - ck)
    return c


def _comb(c1, c2):
    """Complement of a product of two exponentials: c1 + c2 - c1 c2."""
    return c1 + c2 - c1 * c2


def _chain_T_P(cu, cv, cx, k: int, q: int):
    """(T1, T2, T3, T4, P) of the equal-level probability at level k from
    the complement chains, P in the cancellation-free form
    T1 (cA cB + T1 cx) (P = T1 at level 0; the top level q+1 has T1 = 1)."""
    if k == 0:
        t1 = (1.0 - cu[0]) * (1.0 - cv[0]) * (1.0 - cx[0])
        zero = torch.zeros_like(t1)
        return t1, zero, zero, zero, t1
    kk = q if k == q + 1 else k
    u, v, xh = 1.0 - cu[kk], 1.0 - cv[kk], 1.0 - cx[kk]
    cA = _comb(cu[kk], cx[kk])
    cB = _comb(cv[kk], cx[kk])
    if k == q + 1:
        g = u * v * xh
        return (torch.ones_like(g), u * xh, v * xh, g,
                cA * cB + g * cx[kk])
    u1, v1, x1 = 1.0 - cu[k - 1], 1.0 - cv[k - 1], 1.0 - cx[k - 1]
    t1 = u * v * xh
    vx1 = v1 * x1
    return (t1, (u1 * x1) * v, vx1 * u, u1 * vx1,
            t1 * (cA * cB + t1 * cx[k]))


def _levels(K: int, kmin: int, q: int):
    kmax = kmin + K - 1
    return kmax, max(kmin, 1), min(kmax, q), max(kmin - 1, 0)


def _marginal_d1_d2(h, kmin: int, q: int, cs, ps):
    """(d1, d2) of one single-sketch likelihood in x = lambda/m from the
    chains: w_k = z_k * prod(ps) / comb(cs), summed from the top level."""
    K = h.shape[0]
    kmax, lo, hi, _ = _levels(K, kmin, q)

    def c_at(k):
        return cs[0][k] if len(cs) == 1 else _comb(cs[0][k], cs[1][k])

    def p_at(k):
        return ps[0][k] if len(ps) == 1 else ps[0][k] * ps[1][k]

    d1 = torch.zeros_like(h[0])
    d2 = torch.zeros_like(h[0])
    for k in range(hi, lo - 1, -1):
        z = 2.0 ** -k
        w = z * (p_at(k) / c_at(k))
        hm = h[k - kmin]
        d1 = d1 + hm * (w - z)
        d2 = d2 + hm * (-(w * w + z * w))
    if kmin == 0:
        d1 = d1 - h[0]
    if kmax == q + 1:
        zq = 2.0 ** -q
        wq = zq * ps[0][q]
        if len(ps) == 2:
            wq = wq * ps[1][q]
        wq = wq / c_at(q)
        d1 = d1 + h[K - 1] * wq
        d2 = d2 + h[K - 1] * (-(wq * wq + zq * wq))
    return d1, d2


def _chains(theta, m: float, kmin: int, hi: int):
    la, lb, lx = torch.exp(theta[0]), torch.exp(theta[1]), torch.exp(theta[2])
    c_lo = max(kmin - 1, 0)
    return ((la, lb, lx), _compl_chain(la / m, c_lo, hi),
            _compl_chain(lb / m, c_lo, hi), _compl_chain(lx / m, c_lo, hi))


def _joint_grad_hess_chain(theta, stats, m: float, q: int, kmin: int):
    """Analytic (gradient, Hessian) of the joint log-likelihood at theta =
    log lambda: three expm1 per pair, the rest algebra on the chains."""
    K = stats["eq"].shape[0]
    kmax, lo, hi, _ = _levels(K, kmin, q)
    (la, lb, lx), cu, cv, cx = _chains(theta, m, kmin, hi)
    u = {k: 1.0 - c for k, c in cu.items()}
    v = {k: 1.0 - c for k, c in cv.items()}
    xh = {k: 1.0 - c for k, c in cx.items()}

    gA, hA = _marginal_d1_d2(stats["gt_a"], kmin, q, (cu,), (u,))
    gB, hB = _marginal_d1_d2(stats["gt_b"], kmin, q, (cv,), (v,))
    gAB, hAB = _marginal_d1_d2(stats["lt_b"], kmin, q, (cv, cx), (v, xh))
    gBA, hBA = _marginal_d1_d2(stats["lt_a"], kmin, q, (cu, cx), (u, xh))

    # equal-level (diagonal) terms, from the top level down
    zero = torch.zeros_like(gA)
    sga = sgb = sgx = zero
    sHaa = sHbb = sHxx = sHab = sHax = sHbx = zero
    for k in range(kmax, kmin - 1, -1):
        zk = 2.0 ** -k if k <= q else 0.0
        zk1 = 2.0 ** -(k - 1) if k >= 1 else 0.0
        T1, T2, T3, T4, P = _chain_T_P(cu, cv, cx, k, q)
        P = torch.clamp(P, min=1e-30)
        w = stats["eq"][k - kmin]
        wpos = w > 0
        Sa = -T1 * zk + T2 * zk1 + T3 * zk - T4 * zk1
        Sb = -T1 * zk + T2 * zk + T3 * zk1 - T4 * zk1
        Sx = -T1 * zk + T2 * zk1 + T3 * zk1 - T4 * zk1
        wp = torch.where(wpos, w / P, 0.0)
        wp2 = torch.where(wpos, wp / P, 0.0)
        z2, z12, zz1 = zk * zk, zk1 * zk1, zk * zk1
        sga = sga + wp * Sa
        sgb = sgb + wp * Sb
        sgx = sgx + wp * Sx
        sHaa = sHaa + (wp * (T1 * z2 - T2 * z12 - T3 * z2 + T4 * z12)
                       - wp2 * Sa * Sa)
        sHbb = sHbb + (wp * (T1 * z2 - T2 * z2 - T3 * z12 + T4 * z12)
                       - wp2 * Sb * Sb)
        sHxx = sHxx + (wp * (T1 * z2 - T2 * z12 - T3 * z12 + T4 * z12)
                       - wp2 * Sx * Sx)
        sHab = sHab + (wp * (T1 * z2 - T2 * zz1 - T3 * zz1 + T4 * z12)
                       - wp2 * Sa * Sb)
        sHax = sHax + (wp * (T1 * z2 - T2 * z12 - T3 * zz1 + T4 * z12)
                       - wp2 * Sa * Sx)
        sHbx = sHbx + (wp * (T1 * z2 - T2 * zz1 - T3 * z12 + T4 * z12)
                       - wp2 * Sb * Sx)
    g = ((gA + gBA) + sga, (gB + gAB) + sgb, (gAB + gBA) + sgx)
    H = {(0, 0): (hA + hBA) + sHaa, (1, 1): (hB + hAB) + sHbb,
         (2, 2): (hAB + hBA) + sHxx, (0, 1): sHab, (0, 2): hBA + sHax,
         (1, 2): hAB + sHbx}
    lam = (la, lb, lx)
    grad = [lam[i] * (g[i] / m) for i in range(3)]
    hess = {}
    for (i, j), Hij in H.items():
        hij = (lam[i] * lam[j] / (m * m)) * Hij
        hess[i, j] = hij + grad[i] if i == j else hij
    return grad, hess


def _joint_logl_chain(theta, stats, m: float, q: int, kmin: int):
    """Joint log-likelihood at theta by the same chains (the final guard)."""
    K = stats["eq"].shape[0]
    kmax, lo, hi, _ = _levels(K, kmin, q)
    (la, lb, lx), cu, cv, cx = _chains(theta, m, kmin, hi)

    def log_f(h, x, cs):
        L = torch.zeros_like(h[0])
        for k in range(hi, lo - 1, -1):
            c = cs[0][k] if len(cs) == 1 else _comb(cs[0][k], cs[1][k])
            L = L + h[k - kmin] * (-(x * (2.0 ** -k)) + torch.log(c))
        if kmin == 0:
            L = L + h[0] * (-x)
        if kmax == q + 1:
            c = cs[0][q] if len(cs) == 1 else _comb(cs[0][q], cs[1][q])
            L = L + h[K - 1] * torch.log(c)
        return L

    L = log_f(stats["gt_a"], la / m, (cu,))
    L = L + log_f(stats["lt_b"], (lb + lx) / m, (cv, cx))
    L = L + log_f(stats["gt_b"], lb / m, (cv,))
    L = L + log_f(stats["lt_a"], (la + lx) / m, (cu, cx))
    Ld = torch.zeros_like(L)
    for k in range(kmax, kmin - 1, -1):
        P = torch.clamp(_chain_T_P(cu, cv, cx, k, q)[4], min=1e-30)
        w = stats["eq"][k - kmin]
        Ld = Ld + torch.where(w > 0, w * torch.log(P), 0.0)
    return L + Ld


def _solve3_sym(H, g):
    """Closed-form symmetric 3x3 solve by adjugate, with tiny determinants
    floored to +-1e-30 (sign kept)."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 1], H[1, 2], H[2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-30,
                      torch.where(det < 0, -1e-30, 1e-30), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    return ((A * g[0] + B * g[1] + C * g[2]) / det,
            (B * g[0] + D * g[1] + E * g[2]) / det,
            (C * g[0] + E * g[1] + F * g[2]) / det)


def joint_mle_core(stats, cards, m: float, q: int, kmin: int, iters: int):
    """The joint-MLE Newton solve on K-first statistics.

    stats: eq, gt_a, gt_b, lt_a, lt_b, each (K, *batch) float32 over levels
    kmin..kmin+K-1; cards: (c_a, c_b, c_u) broadcastable to batch.  Returns
    (la, lb, lx) = (|A\\B|, |B\\A|, |A&B|), zero for empty sketches."""
    c_a, c_b, c_u = cards
    tiny = 1e-3
    theta0 = torch.stack(torch.broadcast_tensors(
        torch.log(torch.clamp(c_u - c_b, min=tiny)),
        torch.log(torch.clamp(c_u - c_a, min=tiny)),
        torch.log(torch.clamp(c_a + c_b - c_u, min=tiny))))
    theta = theta0
    for _ in range(iters):
        g, H = _joint_grad_hess_chain(theta, stats, m, q, kmin)
        Hd = {(0, 0): H[0, 0] - 1e-4, (1, 1): H[1, 1] - 1e-4,
              (2, 2): H[2, 2] - 1e-4, (0, 1): H[0, 1], (0, 2): H[0, 2],
              (1, 2): H[1, 2]}
        Hd[1, 0], Hd[2, 0], Hd[2, 1] = Hd[0, 1], Hd[0, 2], Hd[1, 2]
        step = [torch.where(torch.isfinite(s), s, 0.0)
                for s in _solve3_sym(Hd, g)]
        norm = torch.sqrt(step[0] * step[0] + step[1] * step[1]
                          + step[2] * step[2])
        scale = torch.clamp(_rdiv(2.0, torch.clamp(norm, min=1e-9)), max=1.0)
        new = torch.stack([theta[i] - step[i] * scale for i in range(3)])
        theta = torch.where(torch.isfinite(new).all(0), new, theta)
    final_val = _joint_logl_chain(theta, stats, m, q, kmin)
    init_val = _joint_logl_chain(theta0, stats, m, q, kmin)
    theta = torch.where(torch.isfinite(final_val) & (final_val >= init_val),
                        theta, theta0)
    la, lb, lx = torch.exp(theta[0]), torch.exp(theta[1]), torch.exp(theta[2])
    a_empty = c_a <= 0.0
    b_empty = c_b <= 0.0
    la = torch.where(a_empty, 0.0, la)
    lx = torch.where(a_empty | b_empty, 0.0, lx)
    lb = torch.where(b_empty, 0.0, lb)
    return la, lb, lx


# ---------------------------------------------------------------------------
# Full-histogram set comparisons (HLL.full_set_comparison, ertl_joint, the
# sparse read filter): K-LAST statistics, as the JAX package's XLA form.
# ---------------------------------------------------------------------------

def pair_statistics(a: torch.Tensor, b: torch.Tensor, q: int) -> dict:
    """Sufficient statistics of register pairs (each (..., m) int): (...,
    q+2) float32 histograms gt_a, lt_a, gt_b, lt_b, eq (of a's value where
    a > b, a < b, of b's value where b > a, b < a, of the value where a ==
    b), the marginals hist_a, hist_b and the union (max) histogram hist_u.
    Integer counts, so equal in any summation order to the JAX package's
    one-hot sums."""
    nb = q + 2

    def hist(v, mask):
        v, mask = torch.broadcast_tensors(v.to(torch.int64), mask)
        ok = mask & (v >= 0) & (v < nb)
        out = torch.zeros(v.shape[:-1] + (nb,), dtype=torch.float32,
                          device=v.device)
        return out.scatter_add_(-1, torch.where(ok, v, 0),
                                ok.to(torch.float32))

    agtb, altb, aeqb = a > b, a < b, a == b
    return dict(gt_a=hist(a, agtb), lt_a=hist(a, altb), gt_b=hist(b, altb),
                lt_b=hist(b, agtb), eq=hist(a, aeqb),
                hist_a=hist(a, torch.ones_like(a, dtype=torch.bool)),
                hist_b=hist(b, torch.ones_like(b, dtype=torch.bool)),
                hist_u=hist(torch.maximum(a, b), torch.ones_like(agtb)))


def joint_mle(stats: dict, p: int, kmin: int = 0, cards=None
              ) -> torch.Tensor:
    """Ertl's joint MLE on K-last statistics -> (3, *batch) float32
    (|A\\B|, |B\\A|, |A&B|).

    stats: eq, gt_a, gt_b, hist_a and hist_u of shape (*batch, K) over
    levels kmin..kmin+K-1 (kmin 0, K = q+2: full histograms), and hist_b
    of shape (K,): the pairs share their b side (one pair, or a batch of
    queries against one reference).  lt_a and lt_b are derived from the
    marginals, as the joint-MLE kernel derives them.  `cards` is the
    (c_a, c_b, c_u) triple that seeds the inclusion-exclusion start; by
    default the direct MLE of hist_a, hist_b and hist_u (the JAX
    package's choice).  CUDA tensors run the joint-MLE kernel given c_u
    and the row-estimate kernel; CPU tensors their plain versions."""
    from ..ops.joint_mle import joint_triples
    from ..ops.union_mle import estimate_rows
    K = stats["eq"].shape[-1]
    batch = stats["eq"].shape[:-1]
    hb = stats["hist_b"]
    if hb.shape != (K,):
        raise ValueError(f"hist_b must be one histogram ({K},), got "
                         f"{tuple(hb.shape)}")

    def rows(t):
        return t.reshape(-1, K)

    n = rows(stats["eq"]).shape[0]
    if cards is None:
        def mle(h):
            return estimate_rows(h.contiguous(), p=p, kmin=kmin,
                                 method=ERTL_MLE)
        cards = (mle(rows(stats["hist_a"])), mle(hb[None]),
                 mle(rows(stats["hist_u"])))
    c_a, c_b, c_u = (torch.as_tensor(c, dtype=torch.float32,
                                     device=hb.device).reshape(-1)
                     for c in cards)
    kf = [rows(stats[key]).T.contiguous()[:, :, None]
          for key in ("eq", "gt_a", "gt_b")]
    tri = joint_triples(*kf, rows(stats["hist_a"]).T.contiguous(),
                        hb[:, None].contiguous(), c_a.expand(n).contiguous(),
                        c_b.reshape(1), c_u.expand(n).reshape(n, 1)
                        .contiguous(), p=p, kmin=kmin)
    return tri.reshape((3,) + tuple(batch))


def union_triple_incl_excl(hist_a: torch.Tensor, hist_b: torch.Tensor,
                           hist_u: torch.Tensor, p: int,
                           method: int = ERTL_MLE) -> torch.Tensor:
    """(..., 3) (onlyA, onlyB, shared) by inclusion-exclusion on the three
    full-histogram estimates (the non-joint comparison), by the
    row-estimate kernel on a card."""
    from ..ops.union_mle import estimate_rows
    K = hist_a.shape[-1]

    def card(h):
        return estimate_rows(h.reshape(-1, K).contiguous(), p=p, kmin=0,
                             method=method, iters=FULL_MLE_ITERS
                             ).reshape(h.shape[:-1])

    c_a, c_b, c_u = card(hist_a), card(hist_b), card(hist_u)
    shared = torch.clamp(c_a + c_b - c_u, min=0.0)
    return torch.stack([torch.clamp(c_a - shared, min=0.0),
                        torch.clamp(c_b - shared, min=0.0), shared], dim=-1)
