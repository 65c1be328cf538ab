// The count-min filter's two passes over raw ASCII, one launch a tile a
// pass: an (R, C) uint8 tile -> the canonical k-mer of every valid window
// -> its WangHash h -> for each row r < nh the counter index
// wang_hash(h ^ c_r) >> (64 - size_log2), with c_r = (seed + r *
// 0x9E3779B9) | 1 taken to 64 bits; then
//   pass 1 (`cm_add_kernel`): add 1 to counter (r, idx_r) of the
//     (nh, 2^size_log2) int32 table, every row;
//   pass 2 (`cm_admit_kernel`): a window whose counters all read at least
//     min_count (the count-min estimate, their minimum, reaches it) folds
//     its (bucket, rank) into the (2^p,) int32 HLL registers by max.
// The counts are exact integers and the register max is order-independent,
// so the table and the registers equal the plain chain's bit for bit
// (ops/countmin.py: `encode_tile`, `wang_hash`, the row hashes, index_add_,
// the gathers and their minimum, `update_registers`).
//
// It replaces no Pallas kernel.  The JAX package's count-min is XLA
// scatter and gather (dashing_tpu/pipeline.py `_cm_add`, `_cm_query`),
// and the port ran the same as ~100 PyTorch ops on int64 tensors a tile,
// which the host queued one by one: the row hashes of every window, valid
// or not, kept in device memory, then one index_add_ and one gather a row.
//
// What bounds it on an H100: random sector traffic.  A 4 x 2^28 table is
// 4 GiB, far beyond the 50 MB L2, so each counter update of pass 1 reads
// and writes back one 32-byte sector (64 B a row-update) and each counter
// read of pass 2 reads one (32 B); the tile's bytes (1 B a base) and the
// registers are small beside it.  The hashing, ~250 32-bit integer
// instructions a window, comes second.
//
// The design spends the table's traffic on valid windows only and keeps
// every hash in registers:
//   - A block stages one segment of one row, its windows plus the k - 1
//     bases of halo, into shared memory with aligned 16-byte loads,
//     classifying four bytes at a time exactly as `base_codes` does
//     ((b & 0xDF) in {A, C, G, T} -> 0..3, anything else, bytes >= 0x80
//     included, invalid with code 0) into 2-bit codes and validity bits.
//     The staging helpers are copies of csrc/encode_hash.cu's (K2).
//   - Thread t takes windows t, t + 256, ... of the segment, GROUP at a
//     time, and skips an invalid window outright: no hash, no atomic, no
//     load.  In a read set about 46 % of a tile's windows are invalid
//     (read separators, the halo, padding), and the plain chain spent an
//     index_add_ of 0 on each.
//   - Pass 1 issues atomicAdd with its result unused, which compiles to a
//     reduction (RED) that no thread waits for.
//   - Pass 2 issues the counter loads of ROWS rows of GROUP windows
//     together, on the read-only path (the table does not change in pass
//     2), and stops a window at the first row below min_count (the
//     minimum's test, so the same result).  An admitted window reads its
//     register and issues atomicMax only where its rank is larger, as K2
//     does.
//   - No hash reaches device memory, so nothing is kept between the
//     passes: hashing again in pass 2 costs far less than keeping 9 B a
//     tile byte.
//   - Segments of at most SEG_MAX windows, of equal length within a row:
//     a 256-row tile of ~8 K windows a row is 4 blocks a row.  R beyond
//     65,535 loops over grid y.
// CUDA C++ rather than Triton: funnel shifts, __brevll, bit-level staging,
// 64-bit offsets and the reductions are native here.
//
// Layout: TILE is (R, C) uint8 for any R and C, rows contiguous, so base
// n of row r is base r*C + n of one flat stream; any data pointer is
// taken (a row-offset view included): the staged bytes start at the
// 16-byte boundary at or below the segment's first byte.  COUNTS is
// (nh, 2^size_log2) int32, row-major; counter (r, i) at r << size_log2 | i
// in 64 bits.  REGS is (2^p,) int32.  1 <= k <= 32, nh >= 1,
// 1 <= size_log2 <= 32, 1 <= p <= 31.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 2;                      // windows a thread at once
constexpr int ROWS = 4;                       // counter loads a window at once
constexpr int SEG_MAX = 2048 + 64;            // windows a block, at most
constexpr int MAX_GRID_Y = 65535;
// staged words: 2-bit codes 16 bases a word, validity 32 bases a word,
// with room for the halo, the alignment lead and the funnel's next words
constexpr int CODE_WORDS = SEG_MAX / 16 + 16;
constexpr int VALID_WORDS = SEG_MAX / 32 + 16;
constexpr uint64_t ROW_STEP = 0x9E3779B9ull;

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

// Whether the k bases of the window at position s of the staged validity
// bits are all valid.
__device__ __forceinline__ bool window_valid(const uint32_t* svalid, int s,
                                             uint32_t kmask) {
    const uint32_t w = __funnelshift_r(svalid[s >> 5], svalid[(s >> 5) + 1],
                                       s & 31);
    return (w & kmask) == kmask;
}

// The WangHash of the canonical k-mer of the window at position s of the
// staged codes: x holds its base j at bits 2j, so rc = ~x & mask, and the
// forward k-mer (first base on top) is x with its 2-bit fields reversed:
// __brevll, a swap within each pair, a shift by 64 - 2k.
__device__ __forceinline__ uint64_t window_hash(const uint32_t* scode, int s,
                                               uint64_t mask, int fshift,
                                               int canon) {
    const uint32_t* cw = scode + (s >> 4);
    const int sh = 2 * (s & 15);
    const uint64_t x = ((uint64_t)__funnelshift_r(cw[1], cw[2], sh) << 32)
                       | __funnelshift_r(cw[0], cw[1], sh);
    uint64_t y = __brevll(x);
    y = ((y >> 1) & 0x5555555555555555ull)
        | ((y & 0x5555555555555555ull) << 1);
    const uint64_t fwd = y >> fshift;
    const uint64_t rc = ~x & mask;
    return wang_hash(canon && rc < fwd ? rc : fwd);
}

// The flat index of row r's counter for the window hash h
__device__ __forceinline__ size_t counter(uint64_t h, int r, int size_log2,
                                          uint64_t seed) {
    const uint64_t c = (seed + (uint64_t)r * ROW_STEP) | 1ull;
    return ((size_t)r << size_log2) + (wang_hash(h ^ c) >> (64 - size_log2));
}

struct Tile {
    const uint8_t* tile;
    int R, C, k, canon, seg;
};

// The window loop both passes share: stages each (row, segment) of the
// block and calls visit(h[GROUP], ok[GROUP]) for each GROUP of the
// thread's windows, ok[g] set where window g is valid and h[g] is its hash.
template <typename Visit>
__device__ __forceinline__ void each_window(const Tile& t, Visit visit) {
    __shared__ __align__(16) uint32_t scode[CODE_WORDS];
    __shared__ __align__(16) uint32_t svalid[VALID_WORDS];
    const int W = t.C - t.k + 1;
    const int w0 = blockIdx.x * t.seg;           // the segment's first window
    if (w0 >= W) return;
    const int len = min(t.seg, W - w0);
    const int nb = len + t.k - 1;                // bases staged
    const uint64_t mask = t.k == 32 ? ~0ull : ((1ull << (2 * t.k)) - 1);
    const uint32_t kmask = t.k == 32 ? ~0u : ((1u << t.k) - 1);
    const int fshift = 64 - 2 * t.k;
    for (int row = blockIdx.y; row < t.R; row += gridDim.y) {
        const int s0 = stage_ascii(t.tile, (size_t)row * t.C + w0, nb, scode,
                                   svalid);
        __syncthreads();
        for (int o0 = threadIdx.x; o0 < len; o0 += GROUP * THREADS) {
            uint64_t h[GROUP];
            bool ok[GROUP];
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const int o = o0 + g * THREADS;
                h[g] = 0;
                ok[g] = o < len && window_valid(svalid, s0 + o, kmask);
                if (ok[g])
                    h[g] = window_hash(scode, s0 + o, mask, fshift, t.canon);
            }
            visit(h, ok);
        }
        __syncthreads();                    // before the next row's staging
    }
}

__global__ void __launch_bounds__(THREADS)
cm_add_kernel(Tile t, int32_t* __restrict__ counts, int nh, int size_log2,
              uint64_t seed) {
    each_window(t, [&](const uint64_t* h, const bool* ok) {
        for (int r = 0; r < nh; ++r) {
#pragma unroll
            for (int g = 0; g < GROUP; ++g)
                if (ok[g]) atomicAdd(counts + counter(h[g], r, size_log2,
                                                      seed), 1);
        }
    });
}

__global__ void __launch_bounds__(THREADS)
cm_admit_kernel(Tile t, const int32_t* __restrict__ counts, int nh,
                int size_log2, uint64_t seed, int min_count,
                int32_t* __restrict__ regs, int p) {
    each_window(t, [&](const uint64_t* h, const bool* ok) {
        bool live[GROUP];
        bool any = false;
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
            live[g] = ok[g];
            any |= ok[g];
        }
        // ROWS rows of every live window at once; a window leaves at its
        // first row below min_count
        for (int r0 = 0; any && r0 < nh; r0 += ROWS) {
            int c[GROUP][ROWS];
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
#pragma unroll
                for (int j = 0; j < ROWS; ++j) {
                    c[g][j] = INT_MAX;
                    if (live[g] && r0 + j < nh)
                        c[g][j] = __ldg(counts + counter(h[g], r0 + j,
                                                         size_log2, seed));
                }
            }
            any = false;
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
#pragma unroll
                for (int j = 0; j < ROWS; ++j)
                    live[g] = live[g] && c[g][j] >= min_count;
                any |= live[g];
            }
        }
        if (!any) return;
        uint32_t bucket[GROUP];
        int rank[GROUP];                         // 0: nothing to fold
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
            bucket[g] = (uint32_t)(h[g] >> (64 - p));
            rank[g] = live[g] ? __clzll((long long)((h[g] << p)
                                                    | (1ull << (p - 1)))) + 1
                              : 0;
        }
        int cur[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
            cur[g] = rank[g] ? regs[bucket[g]] : 0;
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
            if (rank[g] > cur[g]) atomicMax(regs + bucket[g], rank[g]);
    });
}

struct Geometry {
    int seg, grid_x, grid_y;
};

// segments of equal length (a multiple of 32, at most SEG_MAX) along a row
Geometry geometry(int R, int C, int k) {
    const int W = C - k + 1;
    const int nseg = (W + SEG_MAX - 1) / SEG_MAX;
    const int seg = ((W + nseg - 1) / nseg + 31) & ~31;
    return {seg, (W + seg - 1) / seg, R < MAX_GRID_Y ? R : MAX_GRID_Y};
}

bool supported(int k, int nh, int size_log2) {
    return k >= 1 && k <= 32 && nh >= 1 && size_log2 >= 1 && size_log2 <= 32;
}

}  // namespace

// pass 1: ASCII tile -> +1 on each valid window's nh counters
extern "C" int dtt_cm_add(const void* tile, void* counts, int R, int C,
                          int k, int canon, int nh, int size_log2,
                          uint64_t seed, void* stream) {
    if (!supported(k, nh, size_log2)) return (int)cudaErrorInvalidValue;
    if (R <= 0 || C - k + 1 <= 0) return (int)cudaGetLastError();
    const Geometry g = geometry(R, C, k);
    const Tile t{(const uint8_t*)tile, R, C, k, canon, g.seg};
    cm_add_kernel<<<dim3(g.grid_x, g.grid_y), THREADS, 0,
                    (cudaStream_t)stream>>>(t, (int32_t*)counts, nh,
                                            size_log2, seed);
    return (int)cudaGetLastError();
}

// pass 2: ASCII tile -> the windows whose nh counters all reach min_count
// -> register max
extern "C" int dtt_cm_admit(const void* tile, const void* counts, void* regs,
                            int R, int C, int k, int canon, int nh,
                            int size_log2, uint64_t seed, int min_count,
                            int p, void* stream) {
    if (!supported(k, nh, size_log2) || p < 1 || p > 31)
        return (int)cudaErrorInvalidValue;
    if (R <= 0 || C - k + 1 <= 0) return (int)cudaGetLastError();
    const Geometry g = geometry(R, C, k);
    const Tile t{(const uint8_t*)tile, R, C, k, canon, g.seg};
    cm_admit_kernel<<<dim3(g.grid_x, g.grid_y), THREADS, 0,
                      (cudaStream_t)stream>>>(t, (const int32_t*)counts, nh,
                                              size_log2, seed, min_count,
                                              (int32_t*)regs, p);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
