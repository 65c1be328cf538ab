// Joint-MLE Newton solve per pair -> (onlyA, onlyB, shared) set triples.
//
// Replaces the Pallas kernel dashing_tpu/ops/pallas_jmle.py
// `pallas_joint_mle` (body `_kernel` -> dashing_tpu/sketch/estimators.py
// `joint_mle_core` with kfirst=True).  Inputs are the K-first joint
// statistics eq, gt_a, gt_b (K, na, nb) of levels kmin..kmin+K-1, the
// marginal histograms ha (K, na), hb (K, nb) and the marginal
// cardinalities c_a (na,), c_b (nb,); output (3, na, nb) float32
// (la, lb, lx) = (|A\B|, |B\A|, |A&B|).
//
// Per pair: the union estimate c_u (ERTL_IMPROVED on hist_u = eq + gt_a +
// gt_b, which is the union histogram exactly) seeds the inclusion-exclusion
// start theta0 = log max(., 1e-3); then `iters` damped Newton steps in theta
// = log lambda with the analytic gradient and Hessian (diagonal damped by
// 1e-4, adjugate 3x3 solve with tiny determinants floored to +-1e-30, step
// clamped to norm 2); then one guard: the final likelihood must be finite
// and not below the start's, else the start is returned; then the
// empty-sketch masks.  Every e^{-x z_k} of a pass comes from ONE expm1f
// seed per chain (three per pass: la, lb, lx), walked down the levels by
// c[k-1] = c[k] (2 - c[k]); the equal-level probability uses the
// cancellation-free form T1 (cA cB + T1 cx).
//
// What bounds it on an H100: FP32 arithmetic per pair, not bytes.  A pair
// reads 3K + 2K + 2 floats once (at K=32 under 0.7 KB) and then runs
// `iters` passes of ~150 FP32 operations per level (chains, four marginal
// likelihoods, the diagonal term and its ten gradient/Hessian sums) plus
// two likelihood passes with a log per level per chain.  The simple design
// gives each thread one pair (neighbouring threads take neighbouring j, so
// every level's load is coalesced): the thread copies its eq, gt_a, gt_b
// into local arrays once (the TPU kernel's point, reading the statistics
// once instead of once per iteration), derives lt_a = ha - eq - gt_a and
// lt_b = hb - eq - gt_b from the row marginals on the fly, and keeps the
// whole trajectory in registers.  Levels are walked from the top down, so
// no chain is stored.  The ragged edge is masked by the thread index, so
// callers need no padding.
//
// Built with -fmad=false.  The plain version (sketch/estimators.py
// `joint_mle_core`) runs in this operation order: every level sum from the
// top level down, the four marginal sums kept apart and combined as
// written there.  Along a flat likelihood direction the Newton solve turns
// last-bit differences into whole units of a triple, so with FMA
// contraction the kernel missed the bar against the plain version; with
// every operation rounded on its own the two agree.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "hll_estimators.cuh"

namespace {

constexpr int THREADS = 128;

struct Pair {
    const float* eq;      // local copies, K levels each
    const float* ga;
    const float* gb;
    const float* ha;      // column i of (K, na), stride na
    const float* hb;      // column j of (K, nb), stride nb
    int na, nb;
};

__device__ __forceinline__ float comb(float c1, float c2) {
    return c1 + c2 - c1 * c2;
}

__device__ __forceinline__ float lt_a(const Pair& s, int l) {
    return __ldg(s.ha + (long long)l * s.na) - s.eq[l] - s.ga[l];
}

__device__ __forceinline__ float lt_b(const Pair& s, int l) {
    return __ldg(s.hb + (long long)l * s.nb) - s.eq[l] - s.gb[l];
}

// 1 - exp(-x 2^-hi): the seed of a complement chain at its deepest level
__device__ __forceinline__ float chain_seed(float x, int hi) {
    return nmax(-expm1f(-(x * pow2neg(hi))), 1e-30f);
}

// (T1..T4, P) of the equal-level probability at level k from the chain
// values at k (cu, cv, cx) and at k-1 (cu1, cv1, cx1); at the top level
// q+1 the values at q are passed as (cu, cv, cx).
__device__ __forceinline__ void chain_T_P(int k, int q, float cu, float cv,
                                          float cx, float cu1, float cv1,
                                          float cx1, float* T) {
    if (k == 0) {
        const float t1 = (1.f - cu) * (1.f - cv) * (1.f - cx);
        T[0] = t1; T[1] = 0.f; T[2] = 0.f; T[3] = 0.f; T[4] = t1;
        return;
    }
    const float u = 1.f - cu, v = 1.f - cv, xh = 1.f - cx;
    const float cA = comb(cu, cx), cB = comb(cv, cx);
    if (k == q + 1) {
        const float g = u * v * xh;
        T[0] = 1.f; T[1] = u * xh; T[2] = v * xh; T[3] = g;
        T[4] = cA * cB + g * cx;
        return;
    }
    const float u1 = 1.f - cu1, v1 = 1.f - cv1, x1 = 1.f - cx1;
    const float t1 = u * v * xh;
    const float vx1 = v1 * x1;
    T[0] = t1; T[1] = (u1 * x1) * v; T[2] = vx1 * u; T[3] = u1 * vx1;
    T[4] = t1 * (cA * cB + t1 * cx);
}

// one marginal level term: d1 += h (w - z), d2 += h (-(w w + z w)) with
// w = z * num / c
__device__ __forceinline__ void marg(float h, float z, float num, float c,
                                     float& d1, float& d2) {
    const float w = z * (num / c);
    d1 = d1 + h * (w - z);
    d2 = d2 + h * (-(w * w + z * w));
}

__device__ __forceinline__ void marg_top(float h, float wq, float zq,
                                         float& t1, float& t2) {
    t1 = h * wq;
    t2 = h * (-(wq * wq + zq * wq));
}

// Analytic gradient g[3] and Hessian H[6] (00, 11, 22, 01, 02, 12) of the
// joint log-likelihood at theta.
__device__ void grad_hess(const float th[3], const Pair& s, const Window& w,
                          float g[3], float H[6]) {
    const int q = w.q, kmin = w.kmin, K = w.K, kmax = kmin + K - 1;
    const float m = w.m;
    const float la = expf(th[0]), lb = expf(th[1]), lx = expf(th[2]);
    float cu = chain_seed(la / m, w.hi);
    float cv = chain_seed(lb / m, w.hi);
    float cx = chain_seed(lx / m, w.hi);
    // marginal sums: gt_a (A), gt_b (B), lt_b (AB), lt_a (BA)
    float d1A = 0.f, d2A = 0.f, d1B = 0.f, d2B = 0.f;
    float d1AB = 0.f, d2AB = 0.f, d1BA = 0.f, d2BA = 0.f;
    float tA1 = 0.f, tA2 = 0.f, tB1 = 0.f, tB2 = 0.f;
    float tAB1 = 0.f, tAB2 = 0.f, tBA1 = 0.f, tBA2 = 0.f;
    // diagonal sums
    float sga = 0.f, sgb = 0.f, sgx = 0.f;
    float sHaa = 0.f, sHbb = 0.f, sHxx = 0.f, sHab = 0.f, sHax = 0.f,
          sHbx = 0.f;
    for (int k = kmax; k >= kmin; --k) {
        const int l = k - kmin;
        float cu1 = 0.f, cv1 = 0.f, cx1 = 0.f;
        if (k == q + 1) {
            // top bin: the chain stays at q for the next level
            const float zq = pow2neg(q);
            const float u = 1.f - cu, v = 1.f - cv, xh = 1.f - cx;
            marg_top(s.ga[l], (zq * u) / cu, zq, tA1, tA2);
            marg_top(s.gb[l], (zq * v) / cv, zq, tB1, tB2);
            marg_top(lt_b(s, l), ((zq * v) * xh) / comb(cv, cx), zq, tAB1,
                     tAB2);
            marg_top(lt_a(s, l), ((zq * u) * xh) / comb(cu, cx), zq, tBA1,
                     tBA2);
        } else {
            if (k >= 1) {
                cu1 = cu * (2.f - cu);
                cv1 = cv * (2.f - cv);
                cx1 = cx * (2.f - cx);
            }
            if (k >= w.lo) {
                const float z = pow2neg(k);
                const float u = 1.f - cu, v = 1.f - cv, xh = 1.f - cx;
                marg(s.ga[l], z, u, cu, d1A, d2A);
                marg(s.gb[l], z, v, cv, d1B, d2B);
                marg(lt_b(s, l), z, v * xh, comb(cv, cx), d1AB, d2AB);
                marg(lt_a(s, l), z, u * xh, comb(cu, cx), d1BA, d2BA);
            }
        }
        const float zk = k <= q ? pow2neg(k) : 0.f;
        const float zk1 = k >= 1 ? pow2neg(k - 1) : 0.f;
        float T[5];
        chain_T_P(k, q, cu, cv, cx, cu1, cv1, cx1, T);
        const float T1 = T[0], T2 = T[1], T3 = T[2], T4 = T[3];
        const float P = nmax(T[4], 1e-30f);
        const float wt = s.eq[l];
        const bool wpos = wt > 0.f;
        const float Sa = -T1 * zk + T2 * zk1 + T3 * zk - T4 * zk1;
        const float Sb = -T1 * zk + T2 * zk + T3 * zk1 - T4 * zk1;
        const float Sx = -T1 * zk + T2 * zk1 + T3 * zk1 - T4 * zk1;
        const float wp = wpos ? wt / P : 0.f;
        const float wp2 = wpos ? wp / P : 0.f;
        const float z2 = zk * zk, z12 = zk1 * zk1, zz1 = zk * zk1;
        sga = sga + wp * Sa;
        sgb = sgb + wp * Sb;
        sgx = sgx + wp * Sx;
        sHaa = sHaa + (wp * (T1 * z2 - T2 * z12 - T3 * z2 + T4 * z12)
                       - wp2 * Sa * Sa);
        sHbb = sHbb + (wp * (T1 * z2 - T2 * z2 - T3 * z12 + T4 * z12)
                       - wp2 * Sb * Sb);
        sHxx = sHxx + (wp * (T1 * z2 - T2 * z12 - T3 * z12 + T4 * z12)
                       - wp2 * Sx * Sx);
        sHab = sHab + (wp * (T1 * z2 - T2 * zz1 - T3 * zz1 + T4 * z12)
                       - wp2 * Sa * Sb);
        sHax = sHax + (wp * (T1 * z2 - T2 * z12 - T3 * zz1 + T4 * z12)
                       - wp2 * Sa * Sx);
        sHbx = sHbx + (wp * (T1 * z2 - T2 * zz1 - T3 * z12 + T4 * z12)
                       - wp2 * Sb * Sx);
        if (k != q + 1) {
            cu = cu1;
            cv = cv1;
            cx = cx1;
        }
    }
    if (w.has0) {
        d1A = d1A - s.ga[0];
        d1B = d1B - s.gb[0];
        d1AB = d1AB - lt_b(s, 0);
        d1BA = d1BA - lt_a(s, 0);
    }
    if (w.hastop) {
        d1A = d1A + tA1;  d2A = d2A + tA2;
        d1B = d1B + tB1;  d2B = d2B + tB2;
        d1AB = d1AB + tAB1;  d2AB = d2AB + tAB2;
        d1BA = d1BA + tBA1;  d2BA = d2BA + tBA2;
    }
    const float gg[3] = {(d1A + d1BA) + sga, (d1B + d1AB) + sgb,
                         (d1AB + d1BA) + sgx};
    const float HH[6] = {(d2A + d2BA) + sHaa, (d2B + d2AB) + sHbb,
                         (d2AB + d2BA) + sHxx, sHab, d2BA + sHax,
                         d2AB + sHbx};
    const float lam[3] = {la, lb, lx};
    const float mm = m * m;
    for (int a = 0; a < 3; ++a) g[a] = lam[a] * (gg[a] / m);
    const int ia[6] = {0, 1, 2, 0, 0, 1}, ib[6] = {0, 1, 2, 1, 2, 2};
    for (int e = 0; e < 6; ++e) {
        const float h = (lam[ia[e]] * lam[ib[e]] / mm) * HH[e];
        H[e] = e < 3 ? h + g[e] : h;
    }
}

// Joint log-likelihood at theta (the final guard), by the same chains.
__device__ float logl(const float th[3], const Pair& s, const Window& w) {
    const int q = w.q, kmin = w.kmin, K = w.K, kmax = kmin + K - 1;
    const float m = w.m;
    const float la = expf(th[0]), lb = expf(th[1]), lx = expf(th[2]);
    const float xa = la / m, xb = lb / m, xab = (lb + lx) / m,
                xba = (la + lx) / m;
    float cu = chain_seed(la / m, w.hi);
    float cv = chain_seed(lb / m, w.hi);
    float cx = chain_seed(lx / m, w.hi);
    float LA = 0.f, LB = 0.f, LAB = 0.f, LBA = 0.f, Ld = 0.f;
    float tA = 0.f, tB = 0.f, tAB = 0.f, tBA = 0.f;
    for (int k = kmax; k >= kmin; --k) {
        const int l = k - kmin;
        float cu1 = 0.f, cv1 = 0.f, cx1 = 0.f;
        if (k == q + 1) {
            tA = s.ga[l] * logf(cu);
            tB = s.gb[l] * logf(cv);
            tAB = lt_b(s, l) * logf(comb(cv, cx));
            tBA = lt_a(s, l) * logf(comb(cu, cx));
        } else {
            if (k >= 1) {
                cu1 = cu * (2.f - cu);
                cv1 = cv * (2.f - cv);
                cx1 = cx * (2.f - cx);
            }
            if (k >= w.lo) {
                const float z = pow2neg(k);
                LA = LA + s.ga[l] * (-(xa * z) + logf(cu));
                LAB = LAB + lt_b(s, l) * (-(xab * z) + logf(comb(cv, cx)));
                LB = LB + s.gb[l] * (-(xb * z) + logf(cv));
                LBA = LBA + lt_a(s, l) * (-(xba * z) + logf(comb(cu, cx)));
            }
        }
        float T[5];
        chain_T_P(k, q, cu, cv, cx, cu1, cv1, cx1, T);
        const float P = nmax(T[4], 1e-30f);
        const float wt = s.eq[l];
        Ld = Ld + (wt > 0.f ? wt * logf(P) : 0.f);
        if (k != q + 1) {
            cu = cu1;
            cv = cv1;
            cx = cx1;
        }
    }
    if (w.has0) {
        LA = LA + s.ga[0] * (-xa);
        LAB = LAB + lt_b(s, 0) * (-xab);
        LB = LB + s.gb[0] * (-xb);
        LBA = LBA + lt_a(s, 0) * (-xba);
    }
    if (w.hastop) {
        LA = LA + tA;
        LAB = LAB + tAB;
        LB = LB + tB;
        LBA = LBA + tBA;
    }
    return (((LA + LAB) + LB) + LBA) + Ld;
}

__device__ void solve3_sym(const float H[6], const float g[3], float x[3]) {
    const float a = H[0], b = H[3], c = H[4], d = H[1], e = H[5], f = H[2];
    const float A = d * f - e * e;
    const float B = c * e - b * f;
    const float C = b * e - c * d;
    float det = a * A + b * B + c * C;
    if (fabsf(det) < 1e-30f) det = det < 0.f ? -1e-30f : 1e-30f;
    const float D = a * f - c * c;
    const float E = b * c - a * e;
    const float F = a * d - b * b;
    x[0] = (A * g[0] + B * g[1] + C * g[2]) / det;
    x[1] = (B * g[0] + D * g[1] + E * g[2]) / det;
    x[2] = (C * g[0] + E * g[1] + F * g[2]) / det;
}

__global__ void joint_mle_kernel(const float* __restrict__ eq,
                                 const float* __restrict__ gta,
                                 const float* __restrict__ gtb,
                                 const float* __restrict__ ha,
                                 const float* __restrict__ hb,
                                 const float* __restrict__ ca,
                                 const float* __restrict__ cb,
                                 float* __restrict__ out, int na, int nb,
                                 Window w, int iters) {
    const long long npairs = (long long)na * nb;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= npairs) return;
    const int i = (int)(idx / nb);
    const int j = (int)(idx - (long long)i * nb);
    float e[KMAX], ga[KMAX], gb[KMAX];
    float c_u;
    {
        float hu[KMAX];
        for (int l = 0; l < w.K; ++l) {
            e[l] = __ldg(eq + (long long)l * npairs + idx);
            ga[l] = __ldg(gta + (long long)l * npairs + idx);
            gb[l] = __ldg(gtb + (long long)l * npairs + idx);
            hu[l] = e[l] + ga[l] + gb[l];
        }
        c_u = improved_est(hu, w);
    }
    const Pair s{e, ga, gb, ha + i, hb + j, na, nb};
    const float c_a = __ldg(ca + i), c_b = __ldg(cb + j);
    const float tiny = 1e-3f;
    const float th0[3] = {logf(nmax(c_u - c_b, tiny)),
                          logf(nmax(c_u - c_a, tiny)),
                          logf(nmax(c_a + c_b - c_u, tiny))};
    float th[3] = {th0[0], th0[1], th0[2]};
    for (int it = 0; it < iters; ++it) {
        float g[3], H[6], st[3];
        grad_hess(th, s, w, g, H);
        H[0] = H[0] - 1e-4f;
        H[1] = H[1] - 1e-4f;
        H[2] = H[2] - 1e-4f;
        solve3_sym(H, g, st);
        for (int a = 0; a < 3; ++a) st[a] = isfinite(st[a]) ? st[a] : 0.f;
        const float norm = sqrtf(st[0] * st[0] + st[1] * st[1]
                                 + st[2] * st[2]);
        const float scale = fminf(2.f / nmax(norm, 1e-9f), 1.f);
        float nw[3];
        for (int a = 0; a < 3; ++a) nw[a] = th[a] - st[a] * scale;
        if (isfinite(nw[0]) && isfinite(nw[1]) && isfinite(nw[2]))
            for (int a = 0; a < 3; ++a) th[a] = nw[a];
    }
    const float final_val = logl(th, s, w);
    const float init_val = logl(th0, s, w);
    if (!(isfinite(final_val) && final_val >= init_val))
        for (int a = 0; a < 3; ++a) th[a] = th0[a];
    float la = expf(th[0]), lb = expf(th[1]), lx = expf(th[2]);
    const bool a_empty = c_a <= 0.f, b_empty = c_b <= 0.f;
    if (a_empty) la = 0.f;
    if (a_empty || b_empty) lx = 0.f;
    if (b_empty) lb = 0.f;
    out[idx] = la;
    out[npairs + idx] = lb;
    out[2 * npairs + idx] = lx;
}

}  // namespace

// K-first statistics (K, na, nb) + marginals -> (3, na, nb) triples;
// `iters` Newton steps.
extern "C" int dtt_joint_mle(const void* eq, const void* gta, const void* gtb,
                             const void* ha, const void* hb, const void* ca,
                             const void* cb, void* out, int K, int na, int nb,
                             int p, int kmin, int iters, void* stream) {
    Window w;
    if (!make_window(K, p, kmin, &w) || na < 0 || nb < 0 || iters < 0)
        return (int)cudaErrorInvalidValue;
    const long long npairs = (long long)na * nb;
    if (npairs == 0) return (int)cudaGetLastError();
    const long long blocks = (npairs + THREADS - 1) / THREADS;
    joint_mle_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)eq, (const float*)gta, (const float*)gtb,
        (const float*)ha, (const float*)hb, (const float*)ca,
        (const float*)cb, (float*)out, na, nb, w, iters);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
