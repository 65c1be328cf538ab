// HLL cardinality estimators on a level window, shared by the kernels of
// union_mle.cu (K3), estimate_rows.cu (the row estimates) and
// joint_mle.cu (K5's union estimate for the inclusion-exclusion start).
//
// The math is dashing_tpu/sketch/estimators.py `*_estimate_windowed`, on a
// histogram h[l] of levels kmin..kmin+K-1.  The plain versions
// (dashing_tpu_torch/sketch/estimators.py) follow this operation order:
// levels summed one by one from the lowest (the chain's from the top),
// every operation rounded on its own when the including file is built with
// -fmad=false.
//
// Every form takes a histogram h(l), l = 0..K-1, read through an accessor
// (a register array, or a warp shuffle in the row-estimate kernel's
// group form), and is a template over KT, a width from pairwise._K_BUCKETS:
// the level loops are unrolled over KT, so a histogram read as h(l) with
// a compile-time l stays in registers; a narrower runtime K skips the
// levels l >= K.  Inside a window, level kmin + l is level 0 only at
// l = 0 with has0 and the top bin q+1 only at l = K-1 with hastop, so
// those two flags, not comparisons of levels, pick the special levels.
#pragma once
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 66;       // largest level window (pairwise._K_BUCKETS)

// jnp.maximum / torch.clamp semantics: NaN in either operand gives NaN
// (fmaxf and fminf would return the other operand)
__device__ __forceinline__ float nmax(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float nmin(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__device__ float sigma(float x, int iters) {
    if (x >= 1.f) return INFINITY;
    float xx = x, y = 1.f, z = x;
    for (int i = 0; i < iters; ++i) {
        xx = xx * xx;
        z = z + xx * y;
        y = y * 2.f;
    }
    return z;
}

__device__ float tau(float x, int iters) {
    if (x <= 0.f || x >= 1.f) return 0.f;
    float xx = x, y = 1.f, z = 1.f - x;
    for (int i = 0; i < iters; ++i) {
        xx = sqrtf(xx);
        y = y * 0.5f;
        z = z - (1.f - xx) * (1.f - xx) * y;
    }
    return z * (1.f / 3.f);
}

struct Window {
    int p, q, kmin, K, lo, hi;
    bool has0, hastop;
    float m;
    float orig_am2;     // alpha_m * m^2 (ORIGINAL), formed in double on the host
    float imp_am2;      // m^2 / (2 ln 2) (ERTL_IMPROVED), likewise
};

// exact 2^-l for integer 0 <= l <= 126 (a window's levels stay below 62),
// built from its exponent bits (exp2f need not be exact)
__device__ __forceinline__ float pow2neg(int l) {
    return __int_as_float((127 - l) << 23);
}

template <int KT, class H>
__device__ __forceinline__ float original_win(const H& h, int K,
                                              const Window& w) {
    float denom = 0.f;
#pragma unroll
    for (int l = 0; l < KT; ++l)
        if (l < K) denom += h(l) * pow2neg(w.kmin + l);
    const float m = w.m;
    const float e = w.orig_am2 / denom;
    const float c0 = w.has0 ? h(0) : 0.f;
    if (e <= 2.5f * m && c0 > 0.f) return m * logf(m / fmaxf(c0, 1e-9f));
    return e;
}

// the window's top bin h(K-1) (a select per level when K is not KT).
// improved_win also takes it as `top` from a caller that can read it
// directly: with a runtime K, the compiler may fold this select chain
// into h[K-1] and move the whole histogram to local memory (it did, at
// KT = 16-32, in the row-estimate kernel).
template <int KT, class H>
__device__ __forceinline__ float top_bin(const H& h, int K) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < KT; ++l)
        if (l == K - 1) t = h(l);
    return t;
}

// `top`: h(K-1), read only when the window holds the top bin
template <int KT, class H>
__device__ __forceinline__ float improved_win(const H& h, int K,
                                              const Window& w, float top) {
    float denom = 0.f;
#pragma unroll
    for (int l = 0; l < KT; ++l)
        if (l < K && !(l == 0 && w.has0) && !(l == K - 1 && w.hastop))
            denom += h(l) * pow2neg(w.kmin + l);
    const float m = w.m;
    if (w.has0) denom += m * sigma(h(0) / m, w.p + 6);
    if (w.hastop) denom += m * tau(1.f - top / m, 24) * pow2neg(w.q);
    return w.imp_am2 / denom;
}

template <int KT, class H>
__device__ __forceinline__ float improved_win(const H& h, int K,
                                              const Window& w) {
    return improved_win<KT>(h, K, w, w.hastop ? top_bin<KT>(h, K) : 0.f);
}

// Empty levels add exactly +-0 to the Newton sums of the MLE (the chain
// below, the row-estimate kernel's group form) while w w is finite: w <=
// 1/x (w = z / expm1(max(x z, 1e-30)), and expm1 is at least its
// argument) and x >= 1e-12 e^{-iters}, so up to 16 steps such a level may
// be skipped; with more, 0 w w may be 0 inf = NaN, which the plain
// versions compute, so every level is computed.
constexpr int SKIP_EMPTY_ITERS = 16;

// ERTL_MLE by the complement chain, the form the TPU kernel runs
// (dashing_tpu/sketch/estimators.py `_mle_dlogl12_chain`): per Newton
// step ONE expm1f seed at the window's highest mid level hi (q when the
// window holds the top bin), walked down the levels by c[k-1] = c[k] (2 -
// c[k]); every mid level takes w = z ((1 - c) / c) and the top bin
// w_q = (z_q (1 - c_q)) / c_q.  Mid levels are summed from the top down,
// so no chain value is stored.
template <int KT, class H>
__device__ __forceinline__ float mle_chain_win(const H& h, int K, float mtot,
                                               const Window& w, int iters) {
    const float c0 = w.has0 ? h(0) : 0.f;
    const float ctop = w.hastop ? top_bin<KT>(h, K) : 0.f;
    const bool empty = c0 >= mtot;
    const bool full = ctop >= mtot;
    const float x0 = nmin(nmax(improved_win<KT>(h, K, w, ctop) / w.m, 1e-12f),
                          ldexpf(1.f, w.q + 1));
    float u = logf(x0);
    const float zq = pow2neg(w.q), zhi = pow2neg(w.hi);
    for (int it = 0; it < iters; ++it) {
        const float x = expf(u);
        const float chi = nmax(-expm1f(-(x * zhi)), 1e-30f);
        float c = chi, d1 = 0.f, d2 = 0.f;
#pragma unroll
        for (int l = KT - 1; l >= 0; --l) {
            if (l >= K || (l == K - 1 && w.hastop) || (l == 0 && w.has0))
                continue;
            // empty levels skipped up to SKIP_EMPTY_ITERS steps (K3
            // takes 12)
            const float hl = h(l);
            if (hl != 0.f || iters > SKIP_EMPTY_ITERS) {
                const float z = pow2neg(w.kmin + l);
                const float wl = z * ((1.f - c) / c);
                d1 = d1 + hl * (wl - z);
                d2 = d2 + hl * (-(wl * wl + z * wl));
            }
            c = c * (2.f - c);
        }
        d1 = d1 - c0;
        if (w.hastop) {                 // c_q is the seed: hi = q
            const float wq = (zq * (1.f - chi)) / chi;
            d1 = d1 + ctop * wq;
            d2 = d2 + ctop * (-(wq * wq + zq * wq));
        }
        const float dldu = x * d1;
        const float dd = dldu + x * x * d2;
        const float step = dldu / nmin(dd, -1e-9f);
        u = u - nmin(nmax(step, -1.f), 1.f);
    }
    float est = expf(u) * w.m;
    if (full) est = INFINITY;      // full first, empty last
    if (empty) est = 0.f;
    return est;
}

// Fills *w for a window of K levels from kmin at precision p; false if
// the window is out of range.
bool make_window(int K, int p, int kmin, Window* w) {
    if (K < 1 || K > KMAX || p < 4 || p > 31 || kmin < 0
            || kmin + K - 1 > 64 - p + 1)
        return false;
    w->p = p;
    w->q = 64 - p;
    w->kmin = kmin;
    w->K = K;
    w->lo = kmin > 1 ? kmin : 1;
    w->hi = kmin + K - 1 < w->q ? kmin + K - 1 : w->q;
    w->has0 = kmin == 0;
    w->hastop = kmin + K - 1 == w->q + 1;
    const double m = (double)(1u << p);
    const double alpha = m >= 128 ? 0.7213 / (1.0 + 1.079 / m)
                       : m == 16 ? 0.673 : m == 32 ? 0.697
                       : m == 64 ? 0.709 : 0.7213 / (1.0 + 1.079 / m);
    w->m = (float)m;
    w->orig_am2 = (float)(alpha * m * m);
    w->imp_am2 = (float)(m * m / (2.0 * std::log(2.0)));
    return true;
}

}  // namespace
