// Minimizer windows on raw ASCII, fused into the HLL register max: an
// (R, C) uint8 chunk -> for every window of w bases, the unsigned minimum
// of its win = w - k + 1 canonical k-mers -> WangHash -> (bucket, rank)
// -> max into (2^p,) int32 registers; a window emits only when all of its
// w bases are valid.  One launch a chunk.
//
// It replaces no TPU kernel.  The JAX package computes this step in XLA
// code (dashing_tpu/pipeline.py `_tile_to_registers` under -w: the
// shift-or k-mers and the log-doubling sliding min of ops/encode.py
// `encode_tile`, `wang_hash`, the register update), and the port ran the
// same as ~300 PyTorch ops on int64 tensors a chunk (ops/encode.py,
// ops/hll_update.py), which the host queued one by one.  It serves
// exact contiguous k-mers (k <= 32) with WangHash under -w; spaced seeds,
// entropy minimizers and the rolling hashes keep the ops.
//
// What bounds it on an H100: the integer issue rate.  The bytes are few
// (1 B a base, 2.1 MB a 256-row chunk: 0.6 us of HBM).  Every k-mer costs
// its extraction, the pair reversal of the forward k-mer and the
// canonical min in 32-bit halves; every window its share of the sliding
// minimum (two 64-bit compare-and-selects and the validity flags) and its
// emission test.  The WangHash, the bucket, the rank and the register
// compare run only where the minimizer changes.
//
// The design:
//   - A block stages one segment of one row, its windows plus the w - 1
//     bases of halo, into shared memory with aligned 16-byte loads,
//     classifying four bytes at a time as K2 does (csrc/encode_hash.cu):
//     (b & 0xDF) in {A, C, G, T} -> 0..3, anything else, bytes >= 0x80
//     included, invalid with code 0.
//   - Each k-mer of the segment is read whole from the staged codes (one
//     funnel shift, __brevll and a pair swap for the forward k-mer; rc =
//     ~x & mask), and its canonical value goes to shared memory as one
//     64-bit word beside a byte that flags an invalid base.
//   - The sliding minimum is van Herk / Gil-Werman's: the k-mers are cut
//     into blocks of win; a thread takes a block, writes the suffix minima
//     of its block walking backwards, then walks forwards into the next
//     block with a running prefix minimum, so that window i's minimum is
//     min(suffix[i], prefix[i + win - 1]): two compares a window whatever
//     win is, against log-doubling's log2(win) levels.  The validity of a
//     window rides along as the OR of the same flags.
//   - A valid window emits only where its minimizer differs from the
//     previous window's in the segment, or that window was invalid: the
//     register max is idempotent, so a repeat changes nothing, and a
//     random sequence changes minimizer about 2 / (win + 1) of its
//     windows.  A warp ballot packs the emitting windows' minimizers into
//     a queue in shared memory, so that the hashes run on full warps.
//   - The fold is K2's: a thread hashes GROUP minimizers, reads their
//     registers together, and issues atomicMax only where its rank is
//     larger.  The max is order-independent, so the result is bitwise
//     deterministic.
//   - Segments of equal length along a row, at most KM_MAX k-mers each:
//     a 256-row chunk of ~8,200 windows a row at win = 20 is 4 blocks a
//     row.  R beyond 65,535 loops over grid y.  win is at most WIN_MAX,
//     so a segment always holds KM_MAX - WIN_MAX + 1 windows or more.
// CUDA C++ rather than Triton: funnel shifts, __brevll, byte staging,
// warp ballots and the register atomics are native here.
//
// Layout: TILE is (R, C) uint8 for any R and C, rows contiguous, so base
// n of row r is base r*C + n of one flat stream; any data pointer is
// taken (a row-offset view included): the staged bytes start at the
// 16-byte boundary at or below the segment's first byte.  REGS is (2^p,)
// int32.  1 <= k <= 32, k < w, w - k + 1 <= WIN_MAX, 1 <= p <= 31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 2;                      // queued minimizers a thread
constexpr int KM_MAX = 2560;                  // k-mers a segment, at most
constexpr int WIN_MAX = 1024;                 // k-mers a window, at most
constexpr int MAX_GRID_Y = 65535;
// staged words: 2-bit codes 16 bases a word, validity 32 bases a word,
// with room for the k - 1 bases past the last k-mer, the alignment lead
// and the funnel's next words
constexpr int CODE_WORDS = KM_MAX / 16 + 16;
constexpr int VALID_WORDS = KM_MAX / 32 + 16;

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

// Four ASCII bytes -> their four 2-bit codes (byte j at bits 2j, 0 when
// invalid) and, in `valid4`, their four validity bits, as `base_codes`
// classifies them.
__device__ __forceinline__ uint32_t classify4(uint32_t w, uint32_t& valid4) {
    constexpr uint32_t ACGT[4] = {0x41414141u, 0x43434343u, 0x47474747u,
                                  0x54545454u};
    const uint32_t up = w & 0xDFDFDFDFu;
    uint32_t any_zero = 0xFFFFFFFFu;     // bit 7 of a byte clears on a match
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t y = up ^ ACGT[i];
        any_zero &= ((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y;
    }
    const uint32_t v = (~any_zero >> 7) & 0x01010101u;     // 1 a valid byte
    uint32_t t = (up >> 1) & 0x03030303u;                  // A0 C1 G3 T2
    t = (t ^ ((t >> 1) & 0x01010101u)) & (v * 3u);         // A0 C1 G2 T3
    t = (t | (t >> 6)) & 0x000F000Fu;
    uint32_t b = v | (v >> 7);
    valid4 = (b | (b >> 14)) & 0xFu;
    return (t | (t >> 12)) & 0xFFu;
}

// Classify the ASCII bytes of flat bases [g0, g0 + nb) into the staged
// code and validity streams (16 bases per aligned 16-byte load).
// Returns the position of base g0 in both.
__device__ __forceinline__ int stage_ascii(const uint8_t* base, size_t g0,
                                           int nb, uint32_t* codes,
                                           uint32_t* valid) {
    const uintptr_t first = (uintptr_t)(base + g0);
    const uintptr_t a0 = first & ~(uintptr_t)15;
    const int chunks = (int)((first + nb - 1 - a0) >> 4) + 1;
    const uint4* src = reinterpret_cast<const uint4*>(a0);
    uint16_t* v16 = reinterpret_cast<uint16_t*>(valid);
    for (int i = threadIdx.x; i < chunks; i += THREADS) {
        const uint4 q = __ldg(src + i);
        uint32_t v0, v1, v2, v3;
        const uint32_t c0 = classify4(q.x, v0), c1 = classify4(q.y, v1),
                       c2 = classify4(q.z, v2), c3 = classify4(q.w, v3);
        codes[i] = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
        v16[i] = (uint16_t)(v0 | (v1 << 4) | (v2 << 8) | (v3 << 12));
    }
    return (int)(first - a0);
}

// The canonical k-mer at position s of the staged streams, or ~0 with
// `bad` set when one of its k bases is invalid: x holds its base j at bits
// 2j, so rc = ~x & mask, and the forward k-mer (first base on top) is x
// with its 2-bit fields reversed: __brevll, a swap within each pair, a
// shift by 64 - 2k.
__device__ __forceinline__ uint64_t staged_kmer(const uint32_t* scode,
                                                const uint32_t* svalid, int s,
                                                uint64_t mask, uint32_t kmask,
                                                int fshift, int canon,
                                                uint8_t& bad) {
    const uint32_t vw = __funnelshift_r(svalid[s >> 5], svalid[(s >> 5) + 1],
                                        s & 31);
    bad = (vw & kmask) != kmask;
    const uint32_t* cw = scode + (s >> 4);
    const int sh = 2 * (s & 15);
    const uint64_t x = ((uint64_t)__funnelshift_r(cw[1], cw[2], sh) << 32)
                       | __funnelshift_r(cw[0], cw[1], sh);
    uint64_t y = __brevll(x);
    y = ((y >> 1) & 0x5555555555555555ull)
        | ((y & 0x5555555555555555ull) << 1);
    const uint64_t fwd = y >> fshift;
    const uint64_t rc = ~x & mask;
    const uint64_t km = canon && rc < fwd ? rc : fwd;
    return bad ? ~0ull : km;
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
    return a < b ? a : b;
}

__global__ void __launch_bounds__(THREADS)
minimizer_regs_kernel(const uint8_t* __restrict__ tile,
                      int32_t* __restrict__ regs, int R, int C, int k, int w,
                      int p, int canon, int seg) {
    __shared__ __align__(16) uint32_t scode[CODE_WORDS];
    __shared__ __align__(16) uint32_t svalid[VALID_WORDS];
    // the segment's k-mers; after the sliding minimum, the queue of
    // minimizers to fold
    __shared__ uint64_t km[KM_MAX];
    // suffix minima, then each window's minimizer in place
    __shared__ uint64_t mins[KM_MAX];
    __shared__ uint8_t bad[KM_MAX];       // the k-mer holds an invalid base
    // the OR of `bad` over the suffix, then over each window
    __shared__ uint8_t wbad[KM_MAX];
    __shared__ int queued;
    const int win = w - k + 1;
    const int W = C - w + 1;                     // windows a row
    const int o0 = blockIdx.x * seg;             // the segment's first window
    if (o0 >= W) return;
    const int len = min(seg, W - o0);
    const int N = len + win - 1;                 // k-mers
    const int nb = N + k - 1;                    // bases staged
    const int blocks = (len + win - 1) / win;    // van Herk blocks
    const uint64_t mask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint32_t kmask = k == 32 ? ~0u : ((1u << k) - 1);
    const int fshift = 64 - 2 * k;
    const int lane = threadIdx.x & 31;
    for (int row = blockIdx.y; row < R; row += gridDim.y) {
        const int s0 = stage_ascii(tile, (size_t)row * C + o0, nb, scode,
                                   svalid);
        if (threadIdx.x == 0) queued = 0;
        __syncthreads();
        for (int j = threadIdx.x; j < N; j += THREADS) {
            uint8_t flag;
            km[j] = staged_kmer(scode, svalid, s0 + j, mask, kmask, fshift,
                                canon, flag);
            bad[j] = flag;
        }
        __syncthreads();
        // block a = b * win holds windows [a, a + win) of the segment and
        // k-mers [a, a + win), all inside N since a < len; window a + d
        // spans the suffix of the block from a + d and the first d k-mers
        // of the next block
        for (int b = threadIdx.x; b < blocks; b += THREADS) {
            const int a = b * win;
            uint64_t s = ~0ull;
            uint32_t f = 0;
            for (int j = a + win - 1; j >= a; --j) {
                s = umin64(s, km[j]);
                f |= bad[j];
                mins[j] = s;
                wbad[j] = (uint8_t)f;
            }
            const int end = min(win, len - a);
            uint64_t pre = ~0ull;
            f = 0;
            for (int d = 1; d < end; ++d) {
                const int j = a + win - 1 + d;
                pre = umin64(pre, km[j]);
                f |= bad[j];
                mins[a + d] = umin64(mins[a + d], pre);
                wbad[a + d] |= (uint8_t)f;
            }
        }
        __syncthreads();
        // the windows that emit, their minimizers packed into the queue
        // (km is free now) a warp at a time
        for (int i0 = 0; i0 < len; i0 += THREADS) {
            const int i = i0 + threadIdx.x;
            bool emit = false;
            uint64_t m = 0;
            if (i < len) {
                m = mins[i];
                emit = !wbad[i] && (i == 0 || wbad[i - 1] || mins[i - 1] != m);
            }
            const unsigned ball = __ballot_sync(0xFFFFFFFFu, emit);
            int at = 0;
            if (lane == 0 && ball) at = atomicAdd(&queued, __popc(ball));
            at = __shfl_sync(0xFFFFFFFFu, at, 0);
            if (emit) km[at + __popc(ball & ((1u << lane) - 1u))] = m;
        }
        __syncthreads();
        const int n = queued;
        // GROUP minimizers a thread at once, so that their register reads
        // are in flight together
        for (int q0 = threadIdx.x; q0 < n; q0 += GROUP * THREADS) {
            uint32_t bucket[GROUP];
            int rank[GROUP];                     // 0: nothing to fold
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const int q = q0 + g * THREADS;
                bucket[g] = 0;
                rank[g] = 0;
                if (q >= n) continue;
                const uint64_t h = wang_hash(km[q]);
                bucket[g] = (uint32_t)(h >> (64 - p));
                rank[g] = __clzll((long long)((h << p) | (1ull << (p - 1))))
                          + 1;
            }
            int cur[GROUP];
#pragma unroll
            for (int g = 0; g < GROUP; ++g)
                cur[g] = rank[g] ? regs[bucket[g]] : 0;
#pragma unroll
            for (int g = 0; g < GROUP; ++g)
                if (rank[g] > cur[g]) atomicMax(regs + bucket[g], rank[g]);
        }
        __syncthreads();                    // before the next row's staging
    }
}

struct Geometry {
    int seg, grid_x, grid_y;
};

// segments of equal length along a row, each at most KM_MAX k-mers
Geometry geometry(int R, int C, int k, int w) {
    const int W = C - w + 1;
    const int most = KM_MAX - (w - k);           // windows a segment
    const int nseg = (W + most - 1) / most;
    const int seg = (W + nseg - 1) / nseg;
    return {seg, (W + seg - 1) / seg, R < MAX_GRID_Y ? R : MAX_GRID_Y};
}

bool supported(int k, int w, int p) {
    return k >= 1 && k <= 32 && w > k && w - k + 1 <= WIN_MAX && p >= 1
           && p <= 31;
}

}  // namespace

// ASCII chunk -> minimizer windows -> registers
extern "C" int dtt_minimizer_regs(const void* tile, void* regs, int R, int C,
                                  int k, int w, int p, int canon,
                                  void* stream) {
    if (!supported(k, w, p)) return (int)cudaErrorInvalidValue;
    if (R <= 0 || C - w + 1 <= 0) return (int)cudaGetLastError();
    const Geometry g = geometry(R, C, k, w);
    minimizer_regs_kernel<<<dim3(g.grid_x, g.grid_y), THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)tile, (int32_t*)regs, R, C, k, w, p, canon, g.seg);
    return (int)cudaGetLastError();
}

// The launch geometry for (R, C, k, w): windows a block, grid x, grid y,
// threads a block and WIN_MAX, into out[0..4].  Returns 0, 1 when there is
// no window, or 2 when (k, w) is out of the kernel's range.
extern "C" int dtt_minimizer_geometry(int R, int C, int k, int w, int* out) {
    out[4] = WIN_MAX;
    if (!supported(k, w, 1)) return 2;
    if (R <= 0 || C - w + 1 <= 0) return 1;
    const Geometry g = geometry(R, C, k, w);
    out[0] = g.seg;
    out[1] = g.grid_x;
    out[2] = g.grid_y;
    out[3] = THREADS;
    return 0;
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
