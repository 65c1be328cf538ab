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
// Per pair: the union estimate c_u seeds the inclusion-exclusion start
// theta0 = log max(., 1e-3).  The TPU kernel takes c_u (na, nb) as an
// input, and so does this one when the caller passes it (the sparse read
// filter and ertl_joint seed it by the MLE of the union histogram); with
// no c_u it is computed here, ERTL_IMPROVED on hist_u = eq + gt_a + gt_b
// (the union histogram exactly), as the all-pairs engine seeds it.  Then `iters` damped Newton steps in theta
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
// terms with a true division each, the equal-level term with two) plus two
// likelihood passes with a log per level per chain.  Each thread takes one
// pair (neighbouring threads take neighbouring j, so every level's load is
// coalesced) and reads its statistics once, as the TPU kernel does: eq,
// gt_a, gt_b and lt_a = (ha - eq) - gt_a, lt_b = (hb - eq) - gt_b (derived
// once) stay in shared memory for all the passes, laid out
// [statistic][level][thread], so every access is conflict-free and no
// thread shares anything (40 KB a 64-thread block at K = 32: five blocks
// an SM, 92 registers a thread).  The level loop is unrolled by two only:
// unrolled over all 32 levels the Newton step was 8,156 SASS instructions
// and 255 registers and ran no faster than the parent (the step outgrows
// the instruction caches; 1.09 ms unrolled against 0.83 rolled at 256 x
// 1000 on an H100).  The top bin and level 0 are peeled off the loop, so
// its body
// has no special case.  Levels are walked from the top
// down, so no chain is stored.  A level whose eq is 0 adds exactly +-0 to
// every equal-level sum, and those sums are skipped there (a zero's sign
// never reaches a triple).  The ragged edge is masked by the thread index,
// so callers need no padding.
//
// Built with -fmad=false.  The plain version (sketch/estimators.py
// `joint_mle_core`) runs in this operation order: every level sum from the
// top level down, the four marginal sums kept apart and combined as
// written there.  Along a flat likelihood direction the Newton solve turns
// last-bit differences into whole units of a triple, so with FMA
// contraction the kernel missed the bar against the plain version; with
// every operation rounded on its own the two agree bit for bit.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "hll_estimators.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int NSTATS = 5;               // eq, gt_a, gt_b, lt_a, lt_b

// one thread's column of the shared statistics, each K levels with a
// stride of THREADS floats
struct Column {
    float* s;
    int K;
    __device__ __forceinline__ float& at(int stat, int l) const {
        return s[(stat * K + l) * THREADS];
    }
    __device__ __forceinline__ float& eq(int l) const { return at(0, l); }
    __device__ __forceinline__ float& ga(int l) const { return at(1, l); }
    __device__ __forceinline__ float& gb(int l) const { return at(2, l); }
    __device__ __forceinline__ float& lta(int l) const { return at(3, l); }
    __device__ __forceinline__ float& ltb(int l) const { return at(4, l); }
};

__device__ __forceinline__ float comb(float c1, float c2) {
    return c1 + c2 - c1 * c2;
}

// 1 - exp(-x z_hi): the seed of a complement chain at its deepest level
__device__ __forceinline__ float chain_seed(float x, float zhi) {
    return nmax(-expm1f(-(x * zhi)), 1e-30f);
}

// The three complement chains at a level, and one level down (c1).
struct Chains {
    float u, v, x;          // cu, cv, cx
    __device__ __forceinline__ Chains step() const {
        return {u * (2.f - u), v * (2.f - v), x * (2.f - x)};
    }
};

// (T1..T4, P) of the equal-level probability at a level from the chain
// values there (c) and one level down (c1); at the top level q+1 the
// values at q are passed as c.
__device__ __forceinline__ void chain_T_P(bool top, bool bottom,
                                          const Chains& c, const Chains& c1,
                                          float* T) {
    if (bottom) {
        const float t1 = (1.f - c.u) * (1.f - c.v) * (1.f - c.x);
        T[0] = t1; T[1] = 0.f; T[2] = 0.f; T[3] = 0.f; T[4] = t1;
        return;
    }
    const float u = 1.f - c.u, v = 1.f - c.v, xh = 1.f - c.x;
    const float cA = comb(c.u, c.x), cB = comb(c.v, c.x);
    if (top) {
        const float g = u * v * xh;
        T[0] = 1.f; T[1] = u * xh; T[2] = v * xh; T[3] = g;
        T[4] = cA * cB + g * c.x;
        return;
    }
    const float u1 = 1.f - c1.u, v1 = 1.f - c1.v, x1 = 1.f - c1.x;
    const float t1 = u * v * xh;
    const float vx1 = v1 * x1;
    T[0] = t1; T[1] = (u1 * x1) * v; T[2] = vx1 * u; T[3] = u1 * vx1;
    T[4] = t1 * (cA * cB + t1 * c.x);
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

// The sums of the equal-level (diagonal) terms of the gradient and
// Hessian.  A level whose eq is 0 adds exactly +-0 to each (its T are
// finite or, with non-finite chains, the marginal sums are NaN anyway),
// so the level is skipped.
struct Diag {
    float ga = 0.f, gb = 0.f, gx = 0.f;
    float Haa = 0.f, Hbb = 0.f, Hxx = 0.f, Hab = 0.f, Hax = 0.f, Hbx = 0.f;

    __device__ __forceinline__ void add(float wt, bool top, bool bottom,
                                        const Chains& c, const Chains& c1,
                                        float zk, float zk1) {
        if (!(wt > 0.f)) return;
        float Tv[5];
        chain_T_P(top, bottom, c, c1, Tv);
        const float T1 = Tv[0], T2 = Tv[1], T3 = Tv[2], T4 = Tv[3];
        const float P = nmax(Tv[4], 1e-30f);
        const float Sa = -T1 * zk + T2 * zk1 + T3 * zk - T4 * zk1;
        const float Sb = -T1 * zk + T2 * zk + T3 * zk1 - T4 * zk1;
        const float Sx = -T1 * zk + T2 * zk1 + T3 * zk1 - T4 * zk1;
        const float wp = wt / P;
        const float wp2 = wp / P;
        const float z2 = zk * zk, z12 = zk1 * zk1, zz1 = zk * zk1;
        ga = ga + wp * Sa;
        gb = gb + wp * Sb;
        gx = gx + wp * Sx;
        Haa = Haa + (wp * (T1 * z2 - T2 * z12 - T3 * z2 + T4 * z12)
                     - wp2 * Sa * Sa);
        Hbb = Hbb + (wp * (T1 * z2 - T2 * z2 - T3 * z12 + T4 * z12)
                     - wp2 * Sb * Sb);
        Hxx = Hxx + (wp * (T1 * z2 - T2 * z12 - T3 * z12 + T4 * z12)
                     - wp2 * Sx * Sx);
        Hab = Hab + (wp * (T1 * z2 - T2 * zz1 - T3 * zz1 + T4 * z12)
                     - wp2 * Sa * Sb);
        Hax = Hax + (wp * (T1 * z2 - T2 * z12 - T3 * zz1 + T4 * z12)
                     - wp2 * Sa * Sx);
        Hbx = Hbx + (wp * (T1 * z2 - T2 * zz1 - T3 * z12 + T4 * z12)
                     - wp2 * Sb * Sx);
    }
};

// Analytic gradient g[3] and Hessian H[6] (00, 11, 22, 01, 02, 12) of the
// joint log-likelihood at theta.
__device__ void grad_hess(const float th[3], const Column& s,
                          const Window& w, float g[3], float H[6]) {
    const float m = w.m;
    const float la = expf(th[0]), lb = expf(th[1]), lx = expf(th[2]);
    const float zhi = pow2neg(w.hi);
    Chains c{chain_seed(la / m, zhi), chain_seed(lb / m, zhi),
             chain_seed(lx / m, zhi)};
    // marginal sums: gt_a (A), gt_b (B), lt_b (AB), lt_a (BA)
    float d1A = 0.f, d2A = 0.f, d1B = 0.f, d2B = 0.f;
    float d1AB = 0.f, d2AB = 0.f, d1BA = 0.f, d2BA = 0.f;
    float tA1 = 0.f, tA2 = 0.f, tB1 = 0.f, tB2 = 0.f;
    float tAB1 = 0.f, tAB2 = 0.f, tBA1 = 0.f, tBA2 = 0.f;
    Diag dg;
    int l = w.K - 1;
    if (w.hastop) {
        // top bin q+1: the chain stays at q for the next level
        const float zq = pow2neg(w.q);
        const float u = 1.f - c.u, v = 1.f - c.v, xh = 1.f - c.x;
        marg_top(s.ga(l), (zq * u) / c.u, zq, tA1, tA2);
        marg_top(s.gb(l), (zq * v) / c.v, zq, tB1, tB2);
        marg_top(s.ltb(l), ((zq * v) * xh) / comb(c.v, c.x), zq, tAB1,
                 tAB2);
        marg_top(s.lta(l), ((zq * u) * xh) / comb(c.u, c.x), zq, tBA1,
                 tBA2);
        dg.add(s.eq(l), true, false, c, Chains{0.f, 0.f, 0.f}, 0.f, zq);
        --l;
    }
    const int lmid = w.has0 ? 1 : 0;        // level 0 is peeled below
#pragma unroll 2
    for (; l >= lmid; --l) {
        const int k = w.kmin + l;
        const Chains c1 = c.step();
        const float z = pow2neg(k);
        const float u = 1.f - c.u, v = 1.f - c.v, xh = 1.f - c.x;
        marg(s.ga(l), z, u, c.u, d1A, d2A);
        marg(s.gb(l), z, v, c.v, d1B, d2B);
        marg(s.ltb(l), z, v * xh, comb(c.v, c.x), d1AB, d2AB);
        marg(s.lta(l), z, u * xh, comb(c.u, c.x), d1BA, d2BA);
        dg.add(s.eq(l), false, false, c, c1, z, pow2neg(k - 1));
        c = c1;
    }
    if (w.has0) {
        dg.add(s.eq(0), false, true, c, Chains{0.f, 0.f, 0.f}, 1.f, 0.f);
        d1A = d1A - s.ga(0);
        d1B = d1B - s.gb(0);
        d1AB = d1AB - s.ltb(0);
        d1BA = d1BA - s.lta(0);
    }
    if (w.hastop) {
        d1A = d1A + tA1;  d2A = d2A + tA2;
        d1B = d1B + tB1;  d2B = d2B + tB2;
        d1AB = d1AB + tAB1;  d2AB = d2AB + tAB2;
        d1BA = d1BA + tBA1;  d2BA = d2BA + tBA2;
    }
    const float gg[3] = {(d1A + d1BA) + dg.ga, (d1B + d1AB) + dg.gb,
                         (d1AB + d1BA) + dg.gx};
    const float HH[6] = {(d2A + d2BA) + dg.Haa, (d2B + d2AB) + dg.Hbb,
                         (d2AB + d2BA) + dg.Hxx, dg.Hab, d2BA + dg.Hax,
                         d2AB + dg.Hbx};
    const float lam[3] = {la, lb, lx};
    const float mm = m * m;
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = lam[a] * (gg[a] / m);
    const int ia[6] = {0, 1, 2, 0, 0, 1}, ib[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
        const float h = (lam[ia[e]] * lam[ib[e]] / mm) * HH[e];
        H[e] = e < 3 ? h + g[e] : h;
    }
}

// Joint log-likelihood at theta (the final guard), by the same chains.
__device__ float logl(const float th[3], const Column& s, const Window& w) {
    const float m = w.m;
    const float la = expf(th[0]), lb = expf(th[1]), lx = expf(th[2]);
    const float xa = la / m, xb = lb / m, xab = (lb + lx) / m,
                xba = (la + lx) / m;
    const float zhi = pow2neg(w.hi);
    Chains c{chain_seed(la / m, zhi), chain_seed(lb / m, zhi),
             chain_seed(lx / m, zhi)};
    const Chains none{0.f, 0.f, 0.f};
    float LA = 0.f, LB = 0.f, LAB = 0.f, LBA = 0.f, Ld = 0.f;
    float tA = 0.f, tB = 0.f, tAB = 0.f, tBA = 0.f;
    float Tv[5];
    int l = w.K - 1;
    if (w.hastop) {
        tA = s.ga(l) * logf(c.u);
        tB = s.gb(l) * logf(c.v);
        tAB = s.ltb(l) * logf(comb(c.v, c.x));
        tBA = s.lta(l) * logf(comb(c.u, c.x));
        const float wt = s.eq(l);
        if (wt > 0.f) {
            chain_T_P(true, false, c, none, Tv);
            Ld = Ld + wt * logf(nmax(Tv[4], 1e-30f));
        }
        --l;
    }
    const int lmid = w.has0 ? 1 : 0;
#pragma unroll 1
    for (; l >= lmid; --l) {
        const Chains c1 = c.step();
        const float z = pow2neg(w.kmin + l);
        LA = LA + s.ga(l) * (-(xa * z) + logf(c.u));
        LAB = LAB + s.ltb(l) * (-(xab * z) + logf(comb(c.v, c.x)));
        LB = LB + s.gb(l) * (-(xb * z) + logf(c.v));
        LBA = LBA + s.lta(l) * (-(xba * z) + logf(comb(c.u, c.x)));
        const float wt = s.eq(l);
        if (wt > 0.f) {
            chain_T_P(false, false, c, c1, Tv);
            Ld = Ld + wt * logf(nmax(Tv[4], 1e-30f));
        }
        c = c1;
    }
    if (w.has0) {
        const float wt = s.eq(0);
        if (wt > 0.f) {
            chain_T_P(false, true, c, none, Tv);
            Ld = Ld + wt * logf(nmax(Tv[4], 1e-30f));
        }
        LA = LA + s.ga(0) * (-xa);
        LAB = LAB + s.ltb(0) * (-xab);
        LB = LB + s.gb(0) * (-xb);
        LBA = LBA + s.lta(0) * (-xba);
    }
    if (w.hastop) {
        LA = LA + tA;
        LAB = LAB + tAB;
        LB = LB + tB;
        LBA = LBA + tBA;
    }
    return (((LA + LAB) + LB) + LBA) + Ld;
}

__device__ __forceinline__ void solve3_sym(const float H[6], const float g[3],
                                           float x[3]) {
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

__global__ void __launch_bounds__(THREADS)
joint_mle_kernel(const float* __restrict__ eq, const float* __restrict__ gta,
                 const float* __restrict__ gtb, const float* __restrict__ ha,
                 const float* __restrict__ hb, const float* __restrict__ ca,
                 const float* __restrict__ cb, const float* __restrict__ cu,
                 float* __restrict__ out, int na, int nb, Window w,
                 int iters) {
    extern __shared__ float smem[];            // [NSTATS][K][THREADS]
    const long long npairs = (long long)na * nb;
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= npairs) return;
    const int i = (int)(idx / nb);
    const int j = (int)(idx - (long long)i * nb);
    const Column s{smem + threadIdx.x, w.K};
    for (int l = 0; l < w.K; ++l) {
        const long long o = (long long)l * npairs + idx;
        const float eql = __ldg(eq + o), ga = __ldg(gta + o),
                    gb = __ldg(gtb + o);
        s.eq(l) = eql;
        s.ga(l) = ga;
        s.gb(l) = gb;
        s.lta(l) = (__ldg(ha + (long long)l * na + i) - eql) - ga;
        s.ltb(l) = (__ldg(hb + (long long)l * nb + j) - eql) - gb;
    }
    const float c_u = cu != nullptr ? __ldg(cu + idx) : improved_win<KMAX>(
        [&](int l) { return (s.eq(l) + s.ga(l)) + s.gb(l); }, w.K, w);
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
#pragma unroll
        for (int a = 0; a < 3; ++a) st[a] = isfinite(st[a]) ? st[a] : 0.f;
        const float norm = sqrtf(st[0] * st[0] + st[1] * st[1]
                                 + st[2] * st[2]);
        const float scale = fminf(2.f / nmax(norm, 1e-9f), 1.f);
        float nw[3];
#pragma unroll
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
// `iters` Newton steps; `cu` the (na, nb) union seeds, or null to compute
// them (ERTL_IMPROVED on the union histogram).
extern "C" int dtt_joint_mle(const void* eq, const void* gta, const void* gtb,
                             const void* ha, const void* hb, const void* ca,
                             const void* cb, const void* cu, void* out, int K,
                             int na, int nb, int p, int kmin, int iters,
                             void* stream) {
    Window w;
    if (!make_window(K, p, kmin, &w) || na < 0 || nb < 0 || iters < 0)
        return (int)cudaErrorInvalidValue;
    const long long npairs = (long long)na * nb;
    if (npairs == 0) return (int)cudaGetLastError();
    const int smem = NSTATS * K * THREADS * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        joint_mle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NSTATS * KMAX * THREADS * (int)sizeof(float));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            joint_mle_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((npairs + THREADS - 1) / THREADS);
    joint_mle_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)eq, (const float*)gta, (const float*)gtb,
        (const float*)ha, (const float*)hb, (const float*)ca,
        (const float*)cb, (const float*)cu, (float*)out, na, nb, w, iters);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
