// Fused encode -> canonical k-mer -> WangHash -> (bucket, rank), on 2-bit
// packed codes or on raw ASCII, into HLL registers or into int32 keys.
//
// Replaces the two Pallas kernels of dashing_tpu/ops/pallas_encode.py:
//   K1 `encode_hash_keys_from_codes` (body `_codes_kernel`), with the XLA
//      `unpack_2bit` before it and the register update
//      (`hll_update.update_from_idx_rank`) after it: input PACKED, output
//      REGS (`dtt_encode_hash_regs`);
//   K2 `encode_hash_keys` (body `_kernel`), the same tail on raw ASCII
//      tiles: input ASCII, output KEYS (`dtt_ascii_hash_keys`, the TPU
//      kernel's own output, for holding the kernel bitwise) or REGS
//      (`dtt_ascii_hash_regs`, the fused form the benchmark and the ASCII
//      route use).
// The rolling k-mer, WangHash, bucket and rank are written once
// (`encode_hash_kernel`), as `_keys_from_code_valid` is in the JAX package.
// The TPU kernels built k-mers by log-doubling over whole rows and wrote a
// key per window to HBM; here each thread rolls its k-mer one base at a
// time and, in the REGS form, folds the rank straight into the registers,
// so no key reaches device memory.
//
// What bounds it on an H100: bytes in (0.375 B/base packed, 1 B/base
// ASCII) and the register atomics.  Per window the arithmetic is a few
// dozen 64-bit integer ops, far below the card's integer rate; ASCII adds
// a byte classification per base.  Global atomics are the risk: every
// window of a fresh sketch would hit one.  The simple design reads the
// register first and issues atomicMax only when the rank is larger, so
// once a sketch has filled (a few thousand windows per register at p=14)
// almost no atomics remain.  Registers stay in global memory for every p:
// a shared-memory bank for p <= 15 is later work.  The max is
// order-independent, so the result is bitwise deterministic.
//
// Layouts: PACKED is (R, C/4) uint8 codes, base j of a byte at bits 2j,
// plus (R, C/8) uint8 validity, bit j of a byte = base j (little bit
// order), as io/native.py `pack2bit` makes them (C % 8 == 0).  ASCII is
// (R, C) uint8 for any R and C; a byte is a base exactly as `base_codes`
// classifies it: (b & 0xDF) in {A, C, G, T} -> 0..3, anything else
// (N, IUPAC, 0x00 separators, bytes >= 0x80, whose bit 7 survives the
// mask) invalid with code 0.  KEYS is (R, C-k+1) int32 `bucket << 6 |
// rank`, rank 0 on invalid windows (the bucket is still that of the hash
// of the window's codes), p <= 25 so the key fits int32.  Each block
// covers STRIP * blockDim.x consecutive windows of a row; each thread a
// strip of STRIP windows, read from global memory (the (k-1)-base halo each
// thread re-reads is served by L1).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STRIP = 32;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

enum class In { PACKED, ASCII };
enum class Out { REGS, KEYS };

__device__ __forceinline__ uint64_t wang_hash(uint64_t x) {
    x = (~x) + (x << 21);
    x = x ^ (x >> 24);
    x = (x + (x << 3)) + (x << 8);
    x = x ^ (x >> 14);
    x = (x + (x << 2)) + (x << 4);
    x = x ^ (x >> 28);
    x = x + (x << 31);
    return x;
}

// base i of a row: its 2-bit code (0 when invalid) and whether it is valid
template <In IN>
__device__ __forceinline__ uint32_t load_base(const uint8_t* __restrict__ a,
                                              const uint8_t* __restrict__ v,
                                              int i, bool& ok) {
    if constexpr (IN == In::PACKED) {
        ok = (__ldg(v + (i >> 3)) >> (i & 7)) & 1u;
        return (__ldg(a + (i >> 2)) >> (2 * (i & 3))) & 3u;
    } else {
        const uint32_t up = __ldg(a + i) & 0xDFu;
        ok = up == 'A' || up == 'C' || up == 'G' || up == 'T';
        return up == 'C' ? 1u : up == 'G' ? 2u : up == 'T' ? 3u : 0u;
    }
}

template <In IN, Out OUT>
__global__ void encode_hash_kernel(const uint8_t* __restrict__ a,
                                   const uint8_t* __restrict__ v,
                                   int32_t* __restrict__ out, int R, int C,
                                   int k, int p, int canon) {
    const int W = C - k + 1;
    const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * STRIP;
    if (w0 >= W) return;
    const int w1 = min(w0 + STRIP, W);          // windows [w0, w1)
    const uint64_t mask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
    const int rshift = 2 * (k - 1);
    for (int row = blockIdx.y; row < R; row += gridDim.y) {
        const uint8_t* arow;
        const uint8_t* vrow = nullptr;
        if constexpr (IN == In::PACKED) {
            arow = a + (size_t)row * (C >> 2);
            vrow = v + (size_t)row * (C >> 3);
        } else {
            arow = a + (size_t)row * C;
        }
        int32_t* krow = OUT == Out::KEYS ? out + (size_t)row * W : nullptr;
        uint64_t fwd = 0, rc = 0;
        int run = 0;                             // consecutive valid bases
        for (int i = w0; i < w1 + k - 1; ++i) {
            bool ok;
            const uint64_t c = load_base<IN>(arow, vrow, i, ok);
            fwd = ((fwd << 2) | c) & mask;
            rc = (rc >> 2) | ((3ull - c) << rshift);
            run = ok ? run + 1 : 0;
            if (i - w0 < k - 1) continue;        // window i-k+1 incomplete
            const bool valid = run >= k;
            if constexpr (OUT == Out::REGS) {
                if (!valid) continue;
            }
            const uint64_t km = (canon && rc < fwd) ? rc : fwd;
            const uint64_t h = wang_hash(km);
            const uint32_t bucket = (uint32_t)(h >> (64 - p));
            const int rank =
                __clzll((long long)((h << p) | (1ull << (p - 1)))) + 1;
            if constexpr (OUT == Out::REGS) {
                if (rank > out[bucket]) atomicMax(out + bucket, rank);
            } else {
                krow[i - k + 1] = (int32_t)((bucket << 6) | (valid ? rank : 0));
            }
        }
    }
}

template <In IN, Out OUT>
int launch(const void* a, const void* v, void* out, int R, int C, int k,
           int p, int canon, void* stream) {
    const int W = C - k + 1;
    if (R <= 0 || W <= 0) return (int)cudaGetLastError();
    const int per_block = STRIP * THREADS;
    dim3 grid((W + per_block - 1) / per_block, R < MAX_GRID_Y ? R : MAX_GRID_Y);
    encode_hash_kernel<IN, OUT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a, (const uint8_t*)v, (int32_t*)out, R, C, k, p,
        canon);
    return (int)cudaGetLastError();
}

}  // namespace

// K1: packed codes + validity bits -> registers
extern "C" int dtt_encode_hash_regs(const void* packed, const void* vbits,
                                    void* regs, int R, int C, int k, int p,
                                    int canon, void* stream) {
    return launch<In::PACKED, Out::REGS>(packed, vbits, regs, R, C, k, p,
                                         canon, stream);
}

// K2 fused: ASCII -> registers
extern "C" int dtt_ascii_hash_regs(const void* tile, void* regs, int R,
                                   int C, int k, int p, int canon,
                                   void* stream) {
    return launch<In::ASCII, Out::REGS>(tile, nullptr, regs, R, C, k, p,
                                        canon, stream);
}

// K2 as the TPU kernel: ASCII -> (R, C-k+1) int32 keys
extern "C" int dtt_ascii_hash_keys(const void* tile, void* keys, int R,
                                   int C, int k, int p, int canon,
                                   void* stream) {
    return launch<In::ASCII, Out::KEYS>(tile, nullptr, keys, R, C, k, p,
                                        canon, stream);
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
