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
// Both REGS forms also come banked (`dtt_encode_hash_banks`,
// `dtt_ascii_hash_banks`): an int32 vector bank[R] sends row r's ranks to
// the registers regs + (bank[r] << p) of a (B, 2^p) bank, so one launch
// folds many small files (or sequence records) at once.  That replaces
// the JAX package's keys form plus a scatter-max with bank offsets
// (dashing_tpu/pipeline.py `_banks_from_idx_rank`, the `vmap` of
// `_records_to_registers`).  A row whose bank lies outside [0, B) folds
// nothing (the JAX scatter's mode="drop").  Banked K1 keeps each bank's
// registers on chip up to p = ONCHIP_MAX_P (below); banked K2, whose
// callers give each record a bank of its own, is the single form with
// one bank load a row.
// The TPU kernels built k-mers by log-doubling over whole rows and wrote a
// key per window to HBM.  Here the REGS form folds each rank straight into
// the registers, so no key reaches device memory.
//
// What bounds it on an H100: the integer issue rate, then the register
// update.  The bytes are few (0.375 B a base packed, 1 B ASCII: 0.8 or 2.1
// MB a 256-row chunk, well under a microsecond of HBM), while every window
// costs about 80 32-bit integer instructions: extraction, the pair
// reversal of the forward k-mer, the canonical min, a 64-bit WangHash done
// in 32-bit halves, the bucket, the rank and the register compare
// (chip_smoke.py counts them).  The KEYS form, which has the same
// arithmetic and no register traffic, runs close to that bound.  The REGS
// form adds a register read per window and the atomics: on a fresh sketch
// (the first chunk of a genome) most reads find a register below the rank,
// so atomics dominate; on a filled sketch few atomics remain, and at p = 16
// the 256 KB of registers do not all stay in L1, so reads go to L2.
//
// The design spends its instructions on windows only:
//   - A block stages one segment of one row, its windows plus the k-1
//     bases of halo, into shared memory with aligned 16-byte loads: PACKED
//     copies the code and validity bytes as they are; ASCII classifies
//     each byte exactly as `base_codes` does ((b & 0xDF) in {A, C, G, T}
//     -> 0..3, anything else, bytes >= 0x80 included, invalid with code 0),
//     four bytes at a time, into the same two packed streams.  From there
//     both input forms share one back half.
//   - Each window is read whole, with no rolling: with base n at bits 2n
//     of the staged stream, the window's 2k bits are one funnel shift of
//     three 32-bit words x; rc = ~x & mask; fwd = pairrev64(x) >> (64 -
//     2k), pairrev64 being __brevll and then a swap of the two bits of
//     each pair; valid = the k validity bits at the same offset all set.
//     Thread t takes windows t, t + 256, ... of the segment, so the KEYS
//     form's stores are coalesced and no base is read twice by a thread.
//   - Segments of at most SEG_MAX windows, of equal length within a row,
//     give a 256-row chunk of ~8 K windows a row 4 blocks a row, 1,024 in
//     all: one wave of 8 blocks on each of 132 SMs.  R beyond 65,535 loops
//     over grid y.
//   - The REGS form reads the register before an atomicMax and issues it
//     only when the rank is larger (an unconditional atomicMax was slower
//     still).  A thread hashes GROUP windows before it reads their
//     registers, so that those reads are in flight together.  The max is
//     order-independent, so the result is bitwise deterministic.
//     The single forms keep their registers in global memory at every p:
//     a block sees ~2,000 windows, far fewer than the 2^14 or 2^16
//     registers a shared-memory copy would have to merge back.
//   - Banked K1 is the other way round.  A file's rows are contiguous in
//     the bank vector, so a block can stay on one bank for many segments
//     (64 files of 25 rows at p = 14: ~34,000 windows a block against
//     2^14 registers), while 64 fresh banks are 4 MB of int32 whose
//     scattered reads miss L1 and wait on L2, and whose zeros let most
//     atomics through the read filter.  So a block folds a run of (row,
//     segment) units into a copy of its bank in shared memory and merges
//     the copy once a bank (`banks_onchip_kernel`), the next unit staged by
//     cp.async while it hashes this one.  Above ONCHIP_MAX_P the banked
//     form is the single form with one bank load a row.
// CUDA C++ rather than Triton: funnel shifts, __brevll, bit-level
// staging and the register atomics are native here and not Triton's.
//
// Layouts: PACKED is (R, C/4) uint8 codes, base j of a byte at bits 2j,
// plus (R, C/8) uint8 validity, bit j of a byte = base j (little bit
// order), as io/native.py `pack2bit` makes them (C % 8 == 0).  ASCII is
// (R, C) uint8 for any R and C.  Rows are contiguous, so base n of row r
// is base r*C + n of one flat stream; any data pointer is taken (a
// row-offset view included): the staged bytes start at the 16-byte
// boundary at or below the segment's first byte, and the aligned loads
// never leave the 16-byte blocks that hold the segment's bytes.  The banked
// forms take BANK (R,) int32 and REGS (nbanks, 2^p) int32, row-major, and
// banked K1 an ORDER (R,) int32 permutation of the rows or null.  KEYS is
// (R, C-k+1) int32 `bucket << 6 | rank`, rank 0 on invalid windows (the
// bucket is still that of the hash of the window's codes), p <= 25 so the
// key fits int32.
#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 2;                      // windows a thread at once
// windows a block, at most: a pipeline row of 8,192 windows, plus the few
// its packing pad adds, is 4 segments
constexpr int SEG_MAX = 2048 + 64;
constexpr int MAX_GRID_Y = 65535;
// staged words: 2-bit codes 16 bases a word, validity 32 bases a word,
// with room for the halo, the alignment lead and the funnel's next words
constexpr int CODE_WORDS = SEG_MAX / 16 + 16;
constexpr int VALID_WORDS = SEG_MAX / 32 + 16;

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

// Copy the bytes that hold flat bases [g0, g0 + nb) of a stream of
// BITS-bit fields (little bit order) into shared memory with aligned
// 16-byte loads.  Returns the position of base g0 in the staged stream.
template <int BITS>
__device__ __forceinline__ int stage_bits(const uint8_t* base, size_t g0,
                                          int nb, uint32_t* dst) {
    constexpr int PER_BYTE = 8 / BITS;
    const uintptr_t first = (uintptr_t)(base + g0 / PER_BYTE);
    const uintptr_t last = (uintptr_t)(base + (g0 + nb - 1) / PER_BYTE);
    const uintptr_t a0 = first & ~(uintptr_t)15;
    const int chunks = (int)((last - a0) >> 4) + 1;
    const uint4* src = reinterpret_cast<const uint4*>(a0);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < chunks; i += THREADS) d[i] = __ldg(src + i);
    return (int)((first - a0) * PER_BYTE + g0 % PER_BYTE);
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

// Whether the k bases of the window at position sv of the staged
// validity bits are all valid.
__device__ __forceinline__ bool window_valid(const uint32_t* svalid, int sv,
                                             uint32_t kmask) {
    const uint32_t w = __funnelshift_r(svalid[sv >> 5], svalid[(sv >> 5) + 1],
                                       sv & 31);
    return (w & kmask) == kmask;
}

// The WangHash of the canonical k-mer of the window at position sc of the
// staged codes: x holds its base j at bits 2j, so rc = ~x & mask, and the
// forward k-mer (first base on top) is x with its 2-bit fields reversed:
// __brevll, a swap within each pair, a shift by 64 - 2k.
__device__ __forceinline__ uint64_t window_hash(const uint32_t* scode, int sc,
                                                uint64_t mask, int fshift,
                                                int canon) {
    const uint32_t* cw = scode + (sc >> 4);
    const int sh = 2 * (sc & 15);
    const uint64_t x = ((uint64_t)__funnelshift_r(cw[1], cw[2], sh) << 32)
                       | __funnelshift_r(cw[0], cw[1], sh);
    uint64_t y = __brevll(x);
    y = ((y >> 1) & 0x5555555555555555ull)
        | ((y & 0x5555555555555555ull) << 1);
    const uint64_t fwd = y >> fshift;
    const uint64_t rc = ~x & mask;
    return wang_hash(canon && rc < fwd ? rc : fwd);
}

// BANKS: the banked REGS form (a template parameter, so that the single
// forms compile without the per-row bank load and branch)
template <In IN, Out OUT, bool BANKS>
__global__ void __launch_bounds__(THREADS)
encode_hash_kernel(const uint8_t* __restrict__ a,
                   const uint8_t* __restrict__ v,
                   const int32_t* __restrict__ bank, int nbanks,
                   int32_t* __restrict__ out, int R, int C, int k, int p,
                   int canon, int seg) {
    __shared__ __align__(16) uint32_t scode[CODE_WORDS];
    __shared__ __align__(16) uint32_t svalid[VALID_WORDS];
    const int W = C - k + 1;
    const int w0 = blockIdx.x * seg;             // the segment's first window
    if (w0 >= W) return;
    const int len = min(seg, W - w0);
    const int nb = len + k - 1;                  // bases staged
    const uint64_t mask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint32_t kmask = k == 32 ? ~0u : ((1u << k) - 1);
    const int fshift = 64 - 2 * k;
    for (int row = blockIdx.y; row < R; row += gridDim.y) {
        // the row's registers: the one array, or its bank's row
        int32_t* regs = out;
        if constexpr (BANKS) {
            const int b = __ldg(bank + row);
            if (b < 0 || b >= nbanks) continue;     // uniform in the block
            regs = out + ((size_t)b << p);
        }
        const size_t g0 = (size_t)row * C + w0;
        int s0c, s0v;
        if constexpr (IN == In::PACKED) {
            s0c = stage_bits<2>(a, g0, nb, scode);
            s0v = stage_bits<1>(v, g0, nb, svalid);
        } else {
            s0c = s0v = stage_ascii(a, g0, nb, scode, svalid);
        }
        __syncthreads();
        int32_t* krow =
            OUT == Out::KEYS ? out + (size_t)row * W + w0 : nullptr;
        // GROUP windows a thread at once, so that their register reads
        // are in flight together
        for (int o0 = threadIdx.x; o0 < len; o0 += GROUP * THREADS) {
            uint32_t bucket[GROUP];
            int rank[GROUP];                     // 0: no window to fold
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const int o = o0 + g * THREADS;
                bucket[g] = 0;
                rank[g] = 0;
                if (o >= len) continue;
                const bool valid = window_valid(svalid, s0v + o, kmask);
                if (OUT == Out::REGS && !valid) continue;
                const uint64_t h = window_hash(scode, s0c + o, mask, fshift,
                                               canon);
                bucket[g] = (uint32_t)(h >> (64 - p));
                rank[g] = __clzll((long long)((h << p) | (1ull << (p - 1))))
                          + 1;
                if constexpr (OUT == Out::KEYS) {
                    krow[o] = (int32_t)((bucket[g] << 6)
                                        | (valid ? rank[g] : 0));
                }
            }
            if constexpr (OUT == Out::REGS) {
                int cur[GROUP];
#pragma unroll
                for (int g = 0; g < GROUP; ++g)
                    cur[g] = rank[g] ? regs[bucket[g]] : 0;
#pragma unroll
                for (int g = 0; g < GROUP; ++g)
                    if (rank[g] > cur[g]) atomicMax(regs + bucket[g], rank[g]);
            }
        }
        __syncthreads();                    // before the next row's staging
    }
}

// The banked REGS form with each bank's registers on chip.  The rows are
// walked in runs of one bank (`order`, when given, is the row order that
// groups them; otherwise the rows' own order).  A launch cuts the run of
// (row, segment) units into `nblocks` contiguous ranges of nearly equal
// length, one a block; a block folds its units' windows into a copy of the
// bank's 2^p int32 registers in shared memory (the native shared
// atomicMax, after a read), and merges the copy into the global
// (nbanks, 2^p) bank when the bank changes and at its end: each nonzero
// entry by one atomicMax, whose result nobody waits for, a warp's 32 on
// one 128-byte line.  The max is order-independent, so the banks are
// bitwise those of the global form, whatever the order and the split.
__device__ __forceinline__ void merge_bank(int* sreg, int32_t* g, int p) {
    for (int j = threadIdx.x; j < (1 << p); j += THREADS) {
        const int s = sreg[j];
        if (s) {
            atomicMax(g + j, s);
            sreg[j] = 0;
        }
    }
}

// stage_bits with cp.async: the same 16-byte chunks, copied to shared
// memory without passing through registers (completed by
// __pipeline_wait_prior and a __syncthreads)
template <int BITS>
__device__ __forceinline__ int stage_bits_async(const uint8_t* base,
                                                size_t g0, int nb,
                                                uint32_t* dst) {
    constexpr int PER_BYTE = 8 / BITS;
    const uintptr_t first = (uintptr_t)(base + g0 / PER_BYTE);
    const uintptr_t last = (uintptr_t)(base + (g0 + nb - 1) / PER_BYTE);
    const uintptr_t a0 = first & ~(uintptr_t)15;
    const int chunks = (int)((last - a0) >> 4) + 1;
    const uint4* src = reinterpret_cast<const uint4*>(a0);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < chunks; i += THREADS)
        __pipeline_memcpy_async(d + i, src + i, 16);
    return (int)((first - a0) * PER_BYTE + g0 % PER_BYTE);
}

// the first unit at or after u whose bank lies in [0, nbanks), or u1; its
// row and bank
__device__ __forceinline__ long long next_unit(
        long long u, long long u1, int nseg, const int32_t* bank,
        const int32_t* order, int nbanks, int& row, int& b) {
    for (; u < u1; ++u) {
        const long long i = u / nseg;            // the row's place in order
        row = order ? __ldg(order + i) : (int)i;
        b = __ldg(bank + row);
        if (b >= 0 && b < nbanks) break;
    }
    return u;
}

// The next unit's rows are staged by cp.async into the second buffer
// while the block hashes this one's.
__global__ void __launch_bounds__(THREADS)
banks_onchip_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ v,
                    const int32_t* __restrict__ bank,
                    const int32_t* __restrict__ order, int nbanks,
                    int32_t* __restrict__ out, int R, int C, int k, int p,
                    int canon, int seg, int nseg, int nblocks) {
    extern __shared__ __align__(16) int sreg[];
    // buffers of whole 16-byte chunks, so that the second one is aligned
    __shared__ __align__(16) uint32_t scode[2][(CODE_WORDS + 3) & ~3];
    __shared__ __align__(16) uint32_t svalid[2][(VALID_WORDS + 3) & ~3];
    const int W = C - k + 1;
    const long long U = (long long)R * nseg;
    const long long u1 = U * (blockIdx.x + 1) / nblocks;
    const uint64_t mask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint32_t kmask = k == 32 ? ~0u : ((1u << k) - 1);
    const int fshift = 64 - 2 * k;
    for (int j = threadIdx.x; j < (1 << p); j += THREADS) sreg[j] = 0;
    int row = 0, b = 0, held = -1;               // held: the bank on chip
    long long u = next_unit(U * blockIdx.x / nblocks, u1, nseg, bank, order,
                            nbanks, row, b);
    // stage unit un of row r into buffer buf; its staged positions into
    // (pc, pv)
    auto stage = [&](long long un, int r, int buf, int& pc, int& pv) {
        const int w0 = (int)(un % nseg) * seg;
        const int nb = min(seg, W - w0) + k - 1;
        const size_t g0 = (size_t)r * C + w0;
        pc = stage_bits_async<2>(a, g0, nb, scode[buf]);
        pv = stage_bits_async<1>(v, g0, nb, svalid[buf]);
        __pipeline_commit();
    };
    int s0c = 0, s0v = 0, n0c = 0, n0v = 0;   // this unit's, the next's
    if (u < u1) stage(u, row, 0, s0c, s0v);
    for (int cur = 0; u < u1; cur ^= 1) {
        // the last unit ended with __syncthreads, so its updates are in;
        // the __syncthreads after the staging orders the zeroed copy
        // before this unit's updates
        if (b != held) {
            if (held >= 0) merge_bank(sreg, out + ((size_t)held << p), p);
            held = b;
        }
        const int len = min(seg, W - (int)(u % nseg) * seg);
        int nrow = 0, nbank = 0;
        const long long un = next_unit(u + 1, u1, nseg, bank, order, nbanks,
                                       nrow, nbank);
        if (un < u1) {
            stage(un, nrow, cur ^ 1, n0c, n0v);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        const uint32_t* sc = scode[cur];
        const uint32_t* sv = svalid[cur];
        // GROUP windows a thread at once, so that their shared reads are
        // in flight together
        for (int o0 = threadIdx.x; o0 < len; o0 += GROUP * THREADS) {
            uint32_t bucket[GROUP];
            int rank[GROUP];                     // 0: no window to fold
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const int o = o0 + g * THREADS;
                rank[g] = 0;
                bucket[g] = 0;
                if (o >= len || !window_valid(sv, s0v + o, kmask)) continue;
                const uint64_t h = window_hash(sc, s0c + o, mask, fshift,
                                               canon);
                bucket[g] = (uint32_t)(h >> (64 - p));
                rank[g] = __clzll((long long)((h << p) | (1ull << (p - 1))))
                          + 1;
            }
            int now[GROUP];
#pragma unroll
            for (int g = 0; g < GROUP; ++g)
                now[g] = rank[g] ? sreg[bucket[g]] : 0;
#pragma unroll
            for (int g = 0; g < GROUP; ++g)
                if (rank[g] > now[g]) atomicMax(sreg + bucket[g], rank[g]);
        }
        __syncthreads();                    // before the next staging
        u = un;
        row = nrow;
        b = nbank;
        s0c = n0c;
        s0v = n0v;
    }
    if (held >= 0) merge_bank(sreg, out + ((size_t)held << p), p);
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

template <In IN, Out OUT, bool BANKS = false>
int launch(const void* a, const void* v, const void* bank, int nbanks,
           void* out, int R, int C, int k, int p, int canon, void* stream) {
    if (R <= 0 || C - k + 1 <= 0) return (int)cudaGetLastError();
    const Geometry g = geometry(R, C, k);
    encode_hash_kernel<IN, OUT, BANKS>
        <<<dim3(g.grid_x, g.grid_y), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)a, (const uint8_t*)v, (const int32_t*)bank,
            nbanks, (int32_t*)out, R, C, k, p, canon, g.seg);
    return (int)cudaGetLastError();
}

// The on-chip route of banked K1, p up to ONCHIP_MAX_P: 2^p int32
// registers, 64 KB a block at p = 14, three blocks an SM.  Above it the
// global form (encode_hash_kernel<PACKED, REGS, true>): at p = 15 the
// 128 KB copy leaves room for one block an SM, and one block an SM was
// slower than the global form at p = 14; bytes with a 32-bit CAS max,
// which fit to p = 16, were slower than the global form at p = 14 and 16.
// ops/encode_hash.py ONCHIP_MAX_P repeats it (it orders rows only here).
constexpr int ONCHIP_MAX_P = 14;
constexpr int MAX_DEVICES = 16;

// SMs of the current device and resident blocks an SM of the on-chip
// kernel at p, cached a device (the first call also lifts the kernel's
// dynamic shared memory limit above 48 KB where p needs it)
cudaError_t onchip_fit(int p, int& sms, int& occ) {
    static std::atomic<int> cache[MAX_DEVICES][ONCHIP_MAX_P + 1];
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) {
        const int c = cache[dev][p].load(std::memory_order_relaxed);
        if (c) {
            sms = c >> 8;
            occ = c & 255;
            return cudaSuccess;
        }
    }
    const int smem = 4 << p;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute(banks_onchip_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, banks_onchip_kernel, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES)
        cache[dev][p].store(sms << 8 | occ, std::memory_order_relaxed);
    return cudaSuccess;
}

struct BankGeometry {
    int onchip, seg, nseg, blocks, smem, per_sm;
};

// The launch of banked K1: on chip (one wave, as many blocks an SM as
// fit, or fewer when there are fewer units) or the global form.
cudaError_t bank_geometry(int R, int C, int k, int p, BankGeometry& b) {
    const Geometry g = geometry(R, C, k);
    b = {0, g.seg, g.grid_x, g.grid_x * g.grid_y, 0, 0};
    if (p > ONCHIP_MAX_P) return cudaSuccess;
    int sms;
    const cudaError_t e = onchip_fit(p, sms, b.per_sm);
    if (e != cudaSuccess) return e;
    b.onchip = 1;
    b.smem = 4 << p;
    const long long units = (long long)R * g.grid_x;
    const long long wave = (long long)sms * b.per_sm;
    b.blocks = (int)(units < wave ? units : wave);
    return cudaSuccess;
}

}  // namespace

// K1: packed codes + validity bits -> registers
extern "C" int dtt_encode_hash_regs(const void* packed, const void* vbits,
                                    void* regs, int R, int C, int k, int p,
                                    int canon, void* stream) {
    return launch<In::PACKED, Out::REGS>(packed, vbits, nullptr, 0, regs, R,
                                         C, k, p, canon, stream);
}

// K1 banked: packed rows -> the (nbanks, 2^p) registers of bank[row],
// the rows taken in `order` (null: their own order) on chip
extern "C" int dtt_encode_hash_banks(const void* packed, const void* vbits,
                                     const void* bank, const void* order,
                                     int nbanks, void* regs, int R, int C,
                                     int k, int p, int canon, void* stream) {
    if (R <= 0 || C - k + 1 <= 0) return (int)cudaGetLastError();
    BankGeometry b;
    const cudaError_t e = bank_geometry(R, C, k, p, b);
    if (e != cudaSuccess) return (int)e;
    if (!b.onchip)
        return launch<In::PACKED, Out::REGS, true>(packed, vbits, bank,
                                                   nbanks, regs, R, C, k, p,
                                                   canon, stream);
    banks_onchip_kernel<<<b.blocks, THREADS, b.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)vbits, (const int32_t*)bank,
        (const int32_t*)order, nbanks, (int32_t*)regs, R, C, k, p, canon,
        b.seg, b.nseg, b.blocks);
    return (int)cudaGetLastError();
}

// K2 fused: ASCII -> registers
extern "C" int dtt_ascii_hash_regs(const void* tile, void* regs, int R,
                                   int C, int k, int p, int canon,
                                   void* stream) {
    return launch<In::ASCII, Out::REGS>(tile, nullptr, nullptr, 0, regs, R,
                                        C, k, p, canon, stream);
}

// K2 banked: ASCII rows -> the (nbanks, 2^p) registers of bank[row]
extern "C" int dtt_ascii_hash_banks(const void* tile, const void* bank,
                                    int nbanks, void* regs, int R, int C,
                                    int k, int p, int canon, void* stream) {
    return launch<In::ASCII, Out::REGS, true>(tile, nullptr, bank, nbanks,
                                              regs, R, C, k, p, canon,
                                              stream);
}

// K2 as the TPU kernel: ASCII -> (R, C-k+1) int32 keys
extern "C" int dtt_ascii_hash_keys(const void* tile, void* keys, int R,
                                   int C, int k, int p, int canon,
                                   void* stream) {
    return launch<In::ASCII, Out::KEYS>(tile, nullptr, nullptr, 0, keys, R,
                                        C, k, p, canon, stream);
}

// The launch geometry for (R, C, k): windows a block, grid x, grid y and
// threads a block, into out[0..3].  Returns 0, or 1 when there is no window.
extern "C" int dtt_encode_hash_geometry(int R, int C, int k, int* out) {
    if (R <= 0 || C - k + 1 <= 0) return 1;
    const Geometry g = geometry(R, C, k);
    out[0] = g.seg;
    out[1] = g.grid_x;
    out[2] = g.grid_y;
    out[3] = THREADS;
    return 0;
}

// Banked K1's launch for (R, C, k, p) on the current device: on chip (1)
// or global (0), windows a block, segments a row, blocks, threads a block,
// dynamic shared bytes and blocks an SM, into out[0..6].  Returns 0, 1
// when there is no window, or a CUDA error.
extern "C" int dtt_banks_geometry(int R, int C, int k, int p, int* out) {
    if (R <= 0 || C - k + 1 <= 0) return 1;
    BankGeometry b;
    const cudaError_t e = bank_geometry(R, C, k, p, b);
    if (e != cudaSuccess) return (int)e;
    const int v[7] = {b.onchip, b.seg, b.nseg, b.blocks, THREADS, b.smem,
                      b.per_sm};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
