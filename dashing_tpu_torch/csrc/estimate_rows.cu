// Row estimates: (n, K) histograms over levels kmin..kmin+K-1 -> (n,)
// cardinality estimates (ORIGINAL, ERTL_IMPROVED, ERTL_MLE by the direct
// form, or by the complement chain).
//
// Replaces the estimators of the Pallas kernel dashing_tpu/ops/pallas_mle.py
// `pallas_union_triples` (math from dashing_tpu/sketch/estimators.py
// `*_estimate_windowed`; the JAX package runs them on rows through XLA)
// where the port needs them on rows: the marginal cardinalities c_a, c_b of
// a compare tile (the chain, so that a pair's union and marginals come from
// one function and a pair beside an empty sketch shares exactly 0), the
// per-sketch sizes of `dist -o` and HLL.report (the direct form, 24 Newton
// steps on full histograms), readfilt's c_a, c_b and c_u and the joint
// MLE's start (the direct form, 12 steps).
//
// What bounds it on an H100: the latency of a row's Newton chain, and,
// at a readfilt batch's 8,192 rows, issue.  The operations are few (the
// bound is well under a microsecond), but a row runs 12 or 24 dependent
// Newton steps; each step of the direct form takes an expm1f and a true
// division at every level (some 120 instructions a level), the chain form
// a division a level after a serial walk c <- c (2 - c) down the levels.
// The design:
//   - every kernel is a template over the window width KT (the smallest
//     width of pairwise._K_BUCKETS that holds K; levels past the runtime K
//     are skipped) and the method, its level loops unrolled, so the
//     histogram stays in registers and no level is indexed at run time;
//   - G lanes a row for an MLE (row_group_kernel; G = 32 up to a compare
//     tile's 1,024 rows, 8 above): lane g of a group holds levels g,
//     g + G, g + 2G, ..., computes their terms in parallel, and every
//     lane of the group then sums all the terms in the plain version's
//     order, each term broadcast by __shfl_sync from the lane that holds
//     it (the broadcasts do not depend on each other, so they pipeline)
//     and each add rounded on its own.  The chain is walked by every lane
//     in step, each lane keeping c at its own levels.  Every lane of a
//     group ends with the same estimate; its first lane writes it;
//   - a thread a row (row_thread_kernel) for ORIGINAL and ERTL_IMPROVED,
//     which take no Newton steps.
// The wrapper (ops/union_mle.py `estimate_rows`, `row_lanes`) picks G
// from n.
//
// Built with -fmad=false: the plain versions (sketch/estimators.py) round
// every operation on its own and sum levels in the same order, and the
// kernel equals them bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "hll_estimators.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREAD_BLOCK = 32;     // threads a block, a thread a row
constexpr int GROUP_BLOCK = 64;      // threads a block, G lanes a row

// METHOD: ORIGINAL 0, ERTL_IMPROVED 1
template <int KT, int METHOD>
__global__ void __launch_bounds__(THREAD_BLOCK)
row_thread_kernel(const float* __restrict__ hist, float* __restrict__ out,
                  int n, Window w) {
    const int row = blockIdx.x * THREAD_BLOCK + threadIdx.x;
    if (row >= n) return;
    const int K = w.K;
    const float* src = hist + (long long)row * K;
    float h[KT];
#pragma unroll
    for (int l = 0; l < KT; ++l) h[l] = l < K ? __ldg(src + l) : 0.f;
    const auto hf = [&](int l) { return h[l]; };
    const float top = __ldg(src + K - 1);    // h(K-1), never h[K - 1]
    if constexpr (METHOD == 0) out[row] = original_win<KT>(hf, K, w);
    else out[row] = improved_win<KT>(hf, K, w, top);
}

// A mid level of the window: l < K, neither bin 0 nor the top bin q+1.
__device__ __forceinline__ bool mid_level(int l, int K, const Window& w) {
    return l < K && !(l == 0 && w.has0) && !(l == K - 1 && w.hastop);
}

// ERTL_MLE, G lanes a row (G = 8 or 32; a group is G neighbouring
// lanes of a warp); METHOD 2 the direct form, 3 the chain.  Lane g of a
// group holds levels s * G + g (slot s < S).  Every lane of a group
// computes its row's estimate in step; the Newton sums take every mid
// level in the plain version's order.  A level whose count is 0 adds
// exactly +-0 and up to SKIP_EMPTY_ITERS steps is not computed (its term
// is +0: a sum can then differ only in the sign of a zero, which the
// Newton step cannot tell: it moves u by -0 or +0 and exp(u) is the
// same).  Rows past n compute on zeros and are not written: every lane of
// a warp takes part in every shuffle.
template <int KT, int METHOD, int G>
__global__ void __launch_bounds__(GROUP_BLOCK)
row_group_kernel(const float* __restrict__ hist, float* __restrict__ out,
                 int n, Window w, int iters) {
    constexpr int S = (KT + G - 1) / G;
    const int g = threadIdx.x % G;
    const int row = (blockIdx.x * GROUP_BLOCK + threadIdx.x) / G;
    const bool live = row < n;
    const int K = w.K;
    const float* src = hist + (long long)(live ? row : 0) * K;
    float hs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int l = s * G + g;
        hs[s] = live && l < K ? __ldg(src + l) : 0.f;
    }
    // level l (a compile-time constant in the unrolled loops) on every
    // lane of the group, from the lane that holds it
    const auto at = [&](const float (&v)[S], int l) {
        return __shfl_sync(FULL, v[l / G], l % G, G);
    };
    const auto hf = [&](int l) { return at(hs, l); };
    float mtot = 0.f;
#pragma unroll
    for (int l = 0; l < KT; ++l) {
        const float v = hf(l);
        if (l < K) mtot += v;
    }
    const float top = live ? __ldg(src + K - 1) : 0.f;
    const float c0 = w.has0 ? hf(0) : 0.f;
    const float ctop = w.hastop ? top : 0.f;
    const bool empty = c0 >= mtot;
    const bool full = ctop >= mtot;
    const float x0 = nmin(nmax(improved_win<KT>(hf, K, w, top) / w.m,
                               1e-12f), ldexpf(1.f, w.q + 1));
    float u = logf(x0);
    const float zq = pow2neg(w.q), zhi = pow2neg(w.hi);
    const bool skip = iters <= SKIP_EMPTY_ITERS;
    // 2^-(kmin + l) of this lane's levels (clamped past the window), and
    // whether each takes a term: a mid level, not skipped as empty.  The
    // others' terms are +0, added in their place: before the first mid
    // term a sum stays +0, after the last it can change only the sign of
    // a zero sum, so every add needs no test
    float z[S];
    bool use[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int l = s * G + g;
        z[s] = pow2neg(min(w.kmin + l, 126));
        use[s] = mid_level(l, K, w) && (hs[s] != 0.f || !skip);
    }
    const int lhi = w.hi - w.kmin;          // the highest mid level
    for (int it = 0; it < iters; ++it) {
        const float x = expf(u);
        float t1[S], t2[S], d1 = 0.f, d2 = 0.f;
        if constexpr (METHOD == 2) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
                t1[s] = t2[s] = 0.f;
                if (use[s]) {
                    const float wl = z[s] / expm1f(nmax(x * z[s], 1e-30f));
                    t1[s] = hs[s] * (wl - z[s]);
                    t2[s] = hs[s] * (-(wl * wl + z[s] * wl));
                }
            }
#pragma unroll
            for (int l = 0; l < KT; ++l) {          // lo..hi, ascending
                d1 = d1 + at(t1, l);
                d2 = d2 + at(t2, l);
            }
            d1 = d1 - c0;
            const float wq = zq / expm1f(nmax(x * zq, 1e-30f));
            d1 = d1 + ctop * wq;
            d2 = d2 + ctop * (-(wq * wq + zq * wq));
        } else {
            // the chain from ONE expm1f seed at hi, walked down the mid
            // levels by every lane; each keeps c at its own levels
            const float chi = nmax(-expm1f(-(x * zhi)), 1e-30f);
            float c = chi, cs[S];
#pragma unroll
            for (int s = 0; s < S; ++s) cs[s] = 1.f;
#pragma unroll
            for (int l = KT - 1; l >= 0; --l) {
                if (l <= lhi) {     // past level lo, c is no longer read
                    if (g == l % G) cs[l / G] = c;
                    c = c * (2.f - c);
                }
            }
#pragma unroll
            for (int s = 0; s < S; ++s) {
                t1[s] = t2[s] = 0.f;
                if (use[s]) {
                    const float wl = z[s] * ((1.f - cs[s]) / cs[s]);
                    t1[s] = hs[s] * (wl - z[s]);
                    t2[s] = hs[s] * (-(wl * wl + z[s] * wl));
                }
            }
#pragma unroll
            for (int l = KT - 1; l >= 0; --l) {     // hi..lo, descending
                d1 = d1 + at(t1, l);
                d2 = d2 + at(t2, l);
            }
            d1 = d1 - c0;
            if (w.hastop) {                 // c_q is the seed: hi = q
                const float wq = (zq * (1.f - chi)) / chi;
                d1 = d1 + ctop * wq;
                d2 = d2 + ctop * (-(wq * wq + zq * wq));
            }
        }
        const float dldu = x * d1;
        const float dd = dldu + x * x * d2;
        const float step = dldu / nmin(dd, -1e-9f);
        u = u - nmin(nmax(step, -1.f), 1.f);
    }
    float est = expf(u) * w.m;
    if (full) est = INFINITY;      // full first, empty last
    if (empty) est = 0.f;
    if (live && g == 0) out[row] = est;
}

template <int KT, int G>
void launch_group(int method, int n, cudaStream_t stream, const float* hist,
                  float* out, const Window& w, int iters) {
    const unsigned blocks = (unsigned)(((long long)n * G + GROUP_BLOCK - 1)
                                       / GROUP_BLOCK);
    if (method == 2)
        row_group_kernel<KT, 2, G><<<blocks, GROUP_BLOCK, 0, stream>>>(
            hist, out, n, w, iters);
    else
        row_group_kernel<KT, 3, G><<<blocks, GROUP_BLOCK, 0, stream>>>(
            hist, out, n, w, iters);
}

template <int KT>
void launch_rows(int method, int lanes, int n, cudaStream_t stream,
                 const float* hist, float* out, const Window& w, int iters) {
    if (lanes == 32) return launch_group<KT, 32>(method, n, stream, hist,
                                                 out, w, iters);
    if (lanes == 8) return launch_group<KT, 8>(method, n, stream, hist, out,
                                               w, iters);
    const unsigned blocks = (n + THREAD_BLOCK - 1) / THREAD_BLOCK;
    if (method == 0)
        row_thread_kernel<KT, 0><<<blocks, THREAD_BLOCK, 0, stream>>>(
            hist, out, n, w);
    else
        row_thread_kernel<KT, 1><<<blocks, THREAD_BLOCK, 0, stream>>>(
            hist, out, n, w);
}

}  // namespace

// (n, K) row-major histograms over levels kmin..kmin+K-1 -> (n,) estimates;
// `iters` Newton steps for ERTL_MLE (12 windowed, 24 on full histograms);
// method 3 is ERTL_MLE by the complement chain, as union_triples takes it
// (a compare tile's marginals).  lanes: 1 (a thread a row) for methods 0
// and 1, 8 or 32 lanes a row for methods 2 and 3.
extern "C" int dtt_estimate_rows(const void* hist, void* out, int n, int K,
                                 int p, int kmin, int method, int iters,
                                 int lanes, void* stream) {
    Window w;
    if (!make_window(K, p, kmin, &w) || method < 0 || method > 3 || n < 0
            || iters < 0
            || (method < 2 ? lanes != 1 : lanes != 8 && lanes != 32))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const auto s = (cudaStream_t)stream;
    const float* h = (const float*)hist;
    float* o = (float*)out;
    if (K <= 8) launch_rows<8>(method, lanes, n, s, h, o, w, iters);
    else if (K <= 16) launch_rows<16>(method, lanes, n, s, h, o, w, iters);
    else if (K <= 24) launch_rows<24>(method, lanes, n, s, h, o, w, iters);
    else if (K <= 32) launch_rows<32>(method, lanes, n, s, h, o, w, iters);
    else if (K <= 44) launch_rows<44>(method, lanes, n, s, h, o, w, iters);
    else if (K <= 58) launch_rows<58>(method, lanes, n, s, h, o, w, iters);
    else launch_rows<KMAX>(method, lanes, n, s, h, o, w, iters);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
