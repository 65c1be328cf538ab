// Windowed union-cardinality estimate -> (onlyA, onlyB, shared) set triples.
//
// Replaces the Pallas kernel dashing_tpu/ops/pallas_mle.py
// `pallas_union_triples` (body `_kernel`, math from
// dashing_tpu/sketch/estimators.py `*_estimate_windowed`).  Input is the
// K-first stack of cumulative union counts cum[l, i, j] = #(max(a_i, b_j)
// <= kmin + l) and the marginal cardinalities c_a, c_b; output (3, na, nb).
//
// What bounds it on an H100: FP32 arithmetic per pair.  With ERTL_MLE (the
// default) every pair runs 12 Newton steps over its K levels against only
// 4K + 12 bytes of input.  The TPU kernel's form is used: one expm1f per
// pair per step seeds the complement chain (hll_estimators.cuh
// `mle_chain_win`), and each level then costs a true division and about a
// dozen multiplies and adds.  Each thread takes one pair (neighbouring
// threads take neighbouring j, so every level's load is coalesced),
// differences its K cumulative counts into a histogram held in registers
// (the kernel is a template over the window widths of pairwise._K_BUCKETS,
// every level loop unrolled, so the histogram is never indexed at run
// time), and runs the estimator with no shared memory and no cross-thread
// traffic.  A width outside the buckets runs the 66-level instantiation
// with the levels past K skipped.  The ragged edge is masked by the thread
// index, so callers need no padding.
//
// The same estimators on (n, K) histogram rows (a compare tile's
// marginals, the sizes of `dist -o`) are the row-estimate kernel of
// estimate_rows.cu.
//
// Built with -fmad=false: the plain versions (sketch/estimators.py) round
// every operation on its own and sum levels in the same order, so the two
// agree to the last bits on union estimates of millions, whose differences
// are the triples.
#include <cstdint>
#include <cuda_runtime.h>

#include "hll_estimators.cuh"

namespace {

// 128 threads a block: with 256, ptxas kept the 32-level MLE form in 80
// registers with 16 bytes of spills around the divisions' slow-path calls
// (0.387 against 0.42 ms at 1024^2 pairs on an H100); with 128 no width
// has a stack frame
constexpr int THREADS = 128;

// KT: the window width the loops are unrolled to; EXACT: K == KT (else the
// runtime K <= KT); METHOD: ORIGINAL 0, IMPROVED 1, MLE 2
template <int KT, bool EXACT, int METHOD>
__global__ void __launch_bounds__(THREADS)
union_triples_kernel(const float* __restrict__ cum,
                     const float* __restrict__ ca,
                     const float* __restrict__ cb, float* __restrict__ out,
                     int na, int nb, Window w) {
    const int K = EXACT ? KT : w.K;
    const long long npairs = (long long)na * nb;
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= npairs) return;
    const int i = (int)(idx / nb);
    const int j = (int)(idx - (long long)i * nb);
    float h[KT];
    float prev = 0.f, mtot = 0.f;
#pragma unroll
    for (int l = 0; l < KT; ++l) {
        h[l] = 0.f;
        if (l < K) {
            const float c = __ldg(cum + (long long)l * npairs + idx);
            h[l] = c - prev;
            prev = c;
            mtot += h[l];
        }
    }
    const auto hist = [&](int l) { return h[l]; };
    float cu;
    if constexpr (METHOD == 0) cu = original_win<KT>(hist, K, w);
    else if constexpr (METHOD == 1) cu = improved_win<KT>(hist, K, w);
    else cu = mle_chain_win<KT>(hist, K, mtot, w, 12);
    const float a = __ldg(ca + i), b = __ldg(cb + j);
    const float shared = nmax(0.f, a + b - cu);
    out[idx] = nmax(a - shared, 0.f);
    out[npairs + idx] = nmax(b - shared, 0.f);
    out[2 * npairs + idx] = shared;
}

template <int KT, bool EXACT>
void launch_triples(int method, unsigned blocks, cudaStream_t stream,
                    const float* cum, const float* ca, const float* cb,
                    float* out, int na, int nb, const Window& w) {
    if (method == 0)
        union_triples_kernel<KT, EXACT, 0><<<blocks, THREADS, 0, stream>>>(
            cum, ca, cb, out, na, nb, w);
    else if (method == 1)
        union_triples_kernel<KT, EXACT, 1><<<blocks, THREADS, 0, stream>>>(
            cum, ca, cb, out, na, nb, w);
    else
        union_triples_kernel<KT, EXACT, 2><<<blocks, THREADS, 0, stream>>>(
            cum, ca, cb, out, na, nb, w);
}

}  // namespace

extern "C" int dtt_union_triples(const void* cum, const void* ca,
                                 const void* cb, void* out, int K, int na,
                                 int nb, int p, int kmin, int method,
                                 void* stream) {
    Window w;
    if (!make_window(K, p, kmin, &w) || method < 0 || method > 2)
        return (int)cudaErrorInvalidValue;
    const long long npairs = (long long)na * nb;
    if (npairs == 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((npairs + THREADS - 1) / THREADS);
    const auto s = (cudaStream_t)stream;
    const float *c = (const float*)cum, *a = (const float*)ca,
                *b = (const float*)cb;
    float* o = (float*)out;
    switch (K) {
        case 8: launch_triples<8, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        case 16: launch_triples<16, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        case 24: launch_triples<24, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        case 32: launch_triples<32, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        case 44: launch_triples<44, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        case 58: launch_triples<58, true>(method, blocks, s, c, a, b, o, na, nb, w); break;
        default: launch_triples<KMAX, false>(method, blocks, s, c, a, b, o, na, nb, w);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
