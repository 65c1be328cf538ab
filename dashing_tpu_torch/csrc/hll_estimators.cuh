// HLL cardinality estimators on a level window, shared by the kernels of
// union_mle.cu (K3 and the row estimates) and joint_mle.cu (K5's union
// estimate for the inclusion-exclusion start).
//
// The math is dashing_tpu/sketch/estimators.py `*_estimate_windowed`, on a
// histogram h[l] of levels kmin..kmin+K-1.  The plain versions
// (dashing_tpu_torch/sketch/estimators.py) follow this operation order:
// levels summed one by one from the lowest, every operation rounded on its
// own when the including file is built with -fmad=false.
#pragma once
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 66;       // largest level window (pairwise._K_BUCKETS)

// jnp.maximum semantics: NaN in either operand gives NaN (fmaxf would not)
__device__ __forceinline__ float nmax(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
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

// exact 2^-l for integer l (exp2f need not be exact)
__device__ __forceinline__ float pow2neg(int l) { return ldexpf(1.f, -l); }

__device__ float original_est(const float* h, const Window& w) {
    float denom = 0.f;
    for (int l = 0; l < w.K; ++l) denom += h[l] * pow2neg(w.kmin + l);
    const float m = w.m;
    const float e = w.orig_am2 / denom;
    const float c0 = w.has0 ? h[0] : 0.f;
    if (e <= 2.5f * m && c0 > 0.f) return m * logf(m / fmaxf(c0, 1e-9f));
    return e;
}

__device__ float improved_est(const float* h, const Window& w) {
    float denom = 0.f;
    for (int l = w.lo; l <= w.hi; ++l) denom += h[l - w.kmin] * pow2neg(l);
    const float m = w.m;
    if (w.has0) denom += m * sigma(h[0] / m, w.p + 6);
    if (w.hastop) denom += m * tau(1.f - h[w.K - 1] / m, 24) * pow2neg(w.q);
    return w.imp_am2 / denom;
}

__device__ float mle_est(const float* h, float mtot, const Window& w,
                         int iters) {
    const float c0 = w.has0 ? h[0] : 0.f;
    const float ctop = w.hastop ? h[w.K - 1] : 0.f;
    const bool empty = c0 >= mtot;
    const bool full = ctop >= mtot;
    const float x0 = fminf(fmaxf(improved_est(h, w) / w.m, 1e-12f),
                           ldexpf(1.f, w.q + 1));
    float u = logf(x0);
    const float zq = pow2neg(w.q);
    for (int it = 0; it < iters; ++it) {
        const float x = expf(u);
        float d1 = 0.f, d2 = 0.f;
        for (int l = w.lo; l <= w.hi; ++l) {
            const float z = pow2neg(l);
            const float wl = z / expm1f(fmaxf(x * z, 1e-30f));
            const float c = h[l - w.kmin];
            d1 += c * (wl - z);
            d2 += c * (-(wl * wl + z * wl));
        }
        d1 -= c0;
        const float wq = zq / expm1f(fmaxf(x * zq, 1e-30f));
        d1 += ctop * wq;
        d2 += ctop * (-(wq * wq + zq * wq));
        const float dldu = x * d1;
        const float dd = dldu + x * x * d2;
        const float step = dldu / fminf(dd, -1e-9f);
        u = u - fminf(fmaxf(step, -1.f), 1.f);
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
