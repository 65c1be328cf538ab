// Windowed union-cardinality estimate -> (onlyA, onlyB, shared) set triples.
//
// Replaces the Pallas kernel dashing_tpu/ops/pallas_mle.py
// `pallas_union_triples` (body `_kernel`, math from
// dashing_tpu/sketch/estimators.py `*_estimate_windowed`).  Input is the
// K-first stack of cumulative union counts cum[l, i, j] = #(max(a_i, b_j)
// <= kmin + l) and the marginal cardinalities c_a, c_b; output (3, na, nb).
//
// What bounds it on an H100: FP32 transcendental throughput per pair.  With
// ERTL_MLE (the default) every pair runs 12 Newton steps, each an expm1f per
// level of the window (K up to 66) plus exp/log: a few hundred special-
// function calls per pair against 4K + 12 bytes of input.  Bytes are small
// beside that.  The simple design gives each thread one pair: it reads its
// K cumulative counts (neighbouring threads take neighbouring j, so every
// level's load is coalesced), differences them into a histogram held in
// the thread's own local array, and runs the estimator with no shared
// memory and no cross-thread traffic.  The ragged edge is masked by the
// thread index, so callers need no padding.  The expm1f-per-level form of
// the Newton pass is used (the JAX K-last path); the TPU kernel's
// complement chain, one transcendental per pair per step, is a later
// speed-up.
//
// A second entry, dtt_estimate_rows, runs the same estimators on (n, K)
// histogram rows, one thread per row: the marginal cardinalities c_a, c_b
// of a compare tile and the per-sketch sizes of `dist -o`.  Both then come
// from one copy of the math on the card (hll_estimators.cuh, which the
// joint-MLE kernel shares).
//
// Built with -fmad=false: the plain version (sketch/estimators.py) rounds
// every operation on its own and sums levels in the same order, so the two
// agree to the last bits on union estimates of millions, whose differences
// are the triples.
#include <cstdint>
#include <cuda_runtime.h>

#include "hll_estimators.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void union_triples_kernel(const float* __restrict__ cum,
                                     const float* __restrict__ ca,
                                     const float* __restrict__ cb,
                                     float* __restrict__ out,
                                     int na, int nb, Window w, int method) {
    const long long npairs = (long long)na * nb;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= npairs) return;
    const int i = (int)(idx / nb);
    const int j = (int)(idx - (long long)i * nb);
    float h[KMAX];
    float prev = 0.f, mtot = 0.f;
    for (int l = 0; l < w.K; ++l) {
        const float c = __ldg(cum + (long long)l * npairs + idx);
        h[l] = c - prev;
        prev = c;
        mtot += h[l];
    }
    float cu;
    if (method == 0) cu = original_est(h, w);
    else if (method == 1) cu = improved_est(h, w);
    else cu = mle_est(h, mtot, w, 12);
    const float a = __ldg(ca + i), b = __ldg(cb + j);
    const float shared = nmax(0.f, a + b - cu);
    out[idx] = nmax(a - shared, 0.f);
    out[npairs + idx] = nmax(b - shared, 0.f);
    out[2 * npairs + idx] = shared;
}

__global__ void estimate_rows_kernel(const float* __restrict__ hist,
                                     float* __restrict__ out, int n, Window w,
                                     int method, int iters) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    float h[KMAX];
    float mtot = 0.f;
    for (int l = 0; l < w.K; ++l) {
        h[l] = __ldg(hist + (long long)row * w.K + l);
        mtot += h[l];
    }
    float c;
    if (method == 0) c = original_est(h, w);
    else if (method == 1) c = improved_est(h, w);
    else c = mle_est(h, mtot, w, iters);
    out[row] = c;
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
    const long long blocks = (npairs + THREADS - 1) / THREADS;
    union_triples_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)cum, (const float*)ca, (const float*)cb, (float*)out,
        na, nb, w, method);
    return (int)cudaGetLastError();
}

// (n, K) row-major histograms over levels kmin..kmin+K-1 -> (n,) estimates;
// `iters` Newton steps for ERTL_MLE (12 windowed, 24 on full histograms).
extern "C" int dtt_estimate_rows(const void* hist, void* out, int n, int K,
                                 int p, int kmin, int method, int iters,
                                 void* stream) {
    Window w;
    if (!make_window(K, p, kmin, &w) || method < 0 || method > 2 || n < 0
            || iters < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    estimate_rows_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const float*)hist, (float*)out, n, w, method, iters);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
