// Pair statistics of two register banks on the tensor cores: the joint
// statistics of the joint MLE (-J), and their first count alone, the
// cumulative union counts of the main path.
//
// Replaces the Pallas kernel dashing_tpu/ops/pallas_stats.py
// `pallas_pair_stats` (body `_kernel`; the XLA form is
// dashing_tpu/ops/pairwise.py `pair_stats`, joint and not).  Inputs: int8
// registers a (na, m) and b (nb, m), a level window [kmin, kmin+K-1].  For
// every pair (i, j) and level k it counts
//     X[k] = #(a <= k & b <= k),  Y[k] = #(a <= k & b <= k-1),
//     Z[k] = #(a <= k-1 & b <= k)
// The joint form writes, as float32 (4, K, na, nb) K-first,
//     cum_union = X, eq = X - Y - Z + X[k-1], gt_a = Y - X[k-1],
//     gt_b = Z - X[k-1]
// with X[kmin-1] counted too; the X-only form writes cum_union = X alone,
// (K, na, nb).  Every value is an exact integer count.
//
// What bounds it on an H100: operations.  Each count is a product of 0/1
// indicator matrices over the register axis (K na nb m multiply-adds per
// count) against 4 bytes per output.  The SIMT popcount of a bit-plane AND
// that this kernel used before tops out near 1/12 of the int8 tensor-core
// rate.  An int8 `wgmma` form (0/1 bytes expanded from the bit planes, A
// in registers, b in shared memory) reached about a third of that rate
// (PERF.md): the expansion is integer work, 4-5 operations per 4
// bytes, and the SM's integer pipes (64 lanes a clock) could not keep up
// with the tensor cores.  The binary MMA (`mma.sync.aligned.m16n8k256
// .b1 .and.popc`) needs no expansion: it reads the bit planes as they
// are, and does 8x the work per instruction of the int8 `mma.sync` at the
// same instruction rate.  NVIDIA's data sheet gives no rate for one-bit
// operands, so chip_smoke.py times register-operand loops of this MMA and
// of the warpgroup form (`wgmma ... m64n128k256 .b1 .and.popc`, about 1.5x
// faster in those loops; PERF.md) with b1_peak.cu beside it, and reckons
// the bound against the faster; this kernel issues the `mma.sync` form, so
// its MMAs alone take 1.5x the bound's operation term.  What else holds it
// below the bound is data movement (each 128-row tile copies its chunks of
// both banks' planes from L2, and the float32 outputs, 16 bytes per pair
// and level in the joint form, go to memory) and, in the joint form, the
// MMA issue of a single 8-warp block per SM, whose four sets of
// accumulators fill the registers.
//
// Design.  A first pass turns each bank into indicator bit planes: for
// every level of the window and row, the (reg <= k) indicators packed 32
// registers to a word (bit j = register 32 w + j), rows padded to a whole
// number of 16-word chunks with zero words (registers past m read as 127,
// above every level).  A same-bank call builds its planes once.  The count
// pass gives a block of 8 warps a 128-row slice of a and a 64-row (joint)
// or 128-row (X-only) slice of b.  It walks its levels in order (X[k-1] in
// registers) and each level's words in chunks of 16 (512 registers, two
// k256 steps), copied with cp.async into a three-deep ring in shared
// memory, rows padded to 80 bytes so that ldmatrix reads them without bank
// conflicts.  Each warp loads its fragments with ldmatrix (a plane word is
// 32 one-bit elements of the MMA) and counts a 32 x 32 (joint: X =
// a_k.b_k, Y = a_k.b_{k-1}, Z = a_{k-1}.b_k) or 64 x 32 (X-only) tile of
// pairs with m16n8k256 binary MMAs into int32 accumulators (exact), which
// are converted to float32 and stored from the fragments when a level
// ends.  Rows past na or nb are zero-filled by the copy, so ragged tiles
// need no padding.  Calls split the output levels into segments where
// that shortens the run: as many as give the fewest waves of blocks times
// the levels a block counts (free for the X-only form; the joint form
// recounts the level below each segment for its X[k-1], so its segments
// hold at least 4 levels).  Small calls then split the register axis, whose
// blocks add their partial counts (all statistics are linear in the
// counts and each partial is a count itself) to the zeroed outputs with
// float atomics, exact and order-free for integer sums below 2^24.  When a
// and b are one bank (the caller passes one scratch for both), X is
// symmetric and Z = Y^T: only the tiles that hold pairs i <= j are
// counted, and each writes, beside its pairs i <= j, the mirrors (j, i) of
// its pairs i < j (X as it is, Y and Z traded), which saves nearly half
// of a large call's products and copies.  The planes are scratch that the
// caller allocates: levels * rows * words_per_row(m) uint32 per bank
// (levels = K + 1 joint, K X-only).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int BM = 128;               // rows of a per block
constexpr int KW = 16;                // plane words per chunk (two k256 steps)
constexpr int ROW = KW * 4 + 16;      // bytes of a chunk row in shared memory
constexpr int STAGES = 3;             // chunks in flight

__host__ __device__ inline long long words_per_row(long long m) {
    return (m + 32 * KW - 1) / (32 * KW) * KW;
}

// planes[l][row][w] = bits j of (src[row][32 w + j] <= kfirst + l)
__global__ void planes_kernel(const int8_t* __restrict__ src,
                              uint32_t* __restrict__ planes, int n,
                              long long m, long long W, int kfirst, int L) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * W) return;
    const long long row = t / W, w = t - row * W;
    const int8_t* r = src + row * m;
    const long long base = 32 * w;
    alignas(16) int8_t v[32];
    if (m % 16 == 0 && base + 32 <= m) {
        const int4 lo = __ldg((const int4*)(r + base));
        const int4 hi = __ldg((const int4*)(r + base + 16));
        *(int4*)v = lo;
        *(int4*)(v + 16) = hi;
    } else {
#pragma unroll
        for (int j = 0; j < 32; ++j)
            v[j] = base + j < m ? __ldg(r + base + j) : (int8_t)127;
    }
    for (int l = 0; l < L; ++l) {
        const int k = kfirst + l;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) word |= (uint32_t)(v[j] <= k) << j;
        planes[((long long)l * n + row) * W + w] = word;
    }
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
                 "[%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// d (16 x 8, int32) += popc(a (16 x 256 bits) & b (256 x 8 bits))
__device__ __forceinline__ void mma_b1(uint32_t (&d)[4],
                                       const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void put(float* p, uint32_t v, bool atomic) {
    if (atomic) atomicAdd(p, (float)v);
    else *p = (float)v;
}

// Two horizontally adjacent outputs (gj even): one 8-byte store where the
// row length allows it.
__device__ __forceinline__ void put2(float* p, uint32_t v0, uint32_t v1,
                                     bool two, bool vec, bool atomic) {
    if (vec && !atomic) {
        *(float2*)p = make_float2((float)v0, (float)v1);
        return;
    }
    put(p, v0, atomic);
    if (two) put(p + 1, v1, atomic);
}

// One pair's statistics from its counts, at offset `off` of each (K, na,
// nb) stack (the stacks `stride` floats apart): cum_union, and joint also
// eq, gt_a, gt_b.
template <bool JOINT>
__device__ __forceinline__ void emit(float* cum, long long stride,
                                     long long off, uint32_t x, uint32_t y,
                                     uint32_t z, uint32_t p, bool atomic) {
    put(cum + off, x, atomic);
    if constexpr (JOINT) {
        put(cum + stride + off, x - y - z + p, atomic);
        put(cum + 2 * stride + off, y - p, atomic);
        put(cum + 3 * stride + off, z - p, atomic);
    }
}

template <bool JOINT>
struct Tile {
    static constexpr int BN = JOINT ? 64 : 128;    // rows of b per block
    static constexpr int NP = JOINT ? 2 : 1;       // planes a side: k, k-1
    static constexpr int WM = JOINT ? 4 : 2;       // warps along a
    static constexpr int TM = BM / WM / 16;        // m16 tiles per warp
    static constexpr int TN = BN / (8 / WM) / 8;   // n8 tiles per warp
    static constexpr int ROWS = NP * (BM + BN);    // chunk rows per stage
    static constexpr int SMEM = STAGES * ROWS * ROW;
};

// Copy chunk c of plane level l into a stage of shared memory: a's rows
// (plane l, then l - 1 for the joint form), then b's, each KW words padded
// to ROW bytes; rows past na or nb zero-filled.  Thread t copies 16-byte
// part t % 4 of rows t / 4, t / 4 + 64, ...
template <bool JOINT>
__device__ __forceinline__ void load_chunk(
        uint8_t* stage, const uint32_t* __restrict__ pa,
        const uint32_t* __restrict__ pb, int na, int nb, long long W, int i0,
        int j0, int l, int c) {
    using T = Tile<JOINT>;
    constexpr int STEP = THREADS / 4;          // rows per pass
    const int part = threadIdx.x & 3, r0 = threadIdx.x >> 2;
    const long long col = (long long)c * KW + part * 4;
#pragma unroll
    for (int R = r0; R < T::NP * BM; R += STEP) {
        const int P = R / BM, r = R % BM;      // constants after unrolling
        const int pl = P == 0 ? l : max(l - 1, 0);
        const bool valid = i0 + r < na;
        copy16(stage + R * ROW + part * 16,
               pa + ((long long)pl * na + (valid ? i0 + r : 0)) * W + col,
               valid);
    }
#pragma unroll
    for (int R = r0; R < T::NP * T::BN; R += STEP) {
        const int P = R / T::BN, r = R % T::BN;
        const int pl = P == 0 ? l : max(l - 1, 0);
        const bool valid = j0 + r < nb;
        copy16(stage + (T::NP * BM + R) * ROW + part * 16,
               pb + ((long long)pl * nb + (valid ? j0 + r : 0)) * W + col,
               valid);
    }
}

// Does the tile of rows i0.. of a and j0.. of b hold a pair i <= j?  With
// one bank on both sides only such tiles are counted (`sym`).
template <bool JOINT>
__host__ __device__ inline bool upper_tile(int i0, int j0) {
    return i0 <= j0 + Tile<JOINT>::BN - 1;
}

// One block: rows i0.. of a against rows j0.. of b, output levels
// [o_begin, o_end) of segment blockIdx.z / nsplit, plane chunks of range
// blockIdx.z % nsplit.  Joint planes: plane l is level kmin - 1 + l, output
// level o reads planes o + 1 and o; X-only: plane l is level kmin + l =
// output l.  `sym`: a and b are one bank; the block writes its pairs
// i <= j and, for i < j, their mirrors (j, i) too, and a tile without
// such pairs is left to the tiles that mirror it.
template <bool JOINT>
__global__ void __launch_bounds__(THREADS, JOINT ? 1 : 2)
count_kernel(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ pb,
             float* __restrict__ out, int na, int nb, long long W, int K,
             int per_seg, int nsplit, int chunks_per_split, bool sym) {
    using T = Tile<JOINT>;
    constexpr int BN = T::BN, NP = T::NP, TM = T::TM, TN = T::TN;
    constexpr int SM = JOINT ? TM : 1;   // extent of the joint-only arrays
    extern __shared__ __align__(128) uint8_t smem[];
    const int seg = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
    const int nchunks = (int)(W / KW);
    const int c_begin = split * chunks_per_split;
    const int c_end = min(c_begin + chunks_per_split, nchunks);
    const int o_begin = seg * per_seg, o_end = min(o_begin + per_seg, K);
    if (c_begin >= c_end || o_begin >= o_end) return;      // whole block
    const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
    if (sym && !upper_tile<JOINT>(i0, j0)) return;         // whole block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp % T::WM, wn = warp / T::WM;
    const int gid = lane >> 2, tq = lane & 3;
    const bool atomic = nsplit > 1;
    const bool vec = nb % 2 == 0;
    const long long plane = (long long)na * nb;
    // joint: the level below the segment first, for its X[k-1]
    const int nst = ((JOINT ? o_end + 1 : o_end) - o_begin) * (c_end - c_begin);

    uint32_t x[TM][TN][4], y[SM][TN][4], z[SM][TN][4], xp[SM][TN][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[i][j][e] = 0;
#pragma unroll
    for (int i = 0; i < SM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[i][j][e] = z[i][j][e] = xp[i][j][e] = 0;

    // ldmatrix row addresses of this lane within a stage: the a fragment
    // of an m16 tile (x4: rows 0-7 / 8-15, words 0-3 / 4-7 of a k256 step)
    // and the b fragments of two n8 tiles (x4: tile, words 0-3 / 4-7)
    const int a_off = (wm * TM * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW
                      + (lane >> 4) * 16;
    const int b_off = (NP * BM + wn * TN * 8 + (lane >> 4) * 8 + (lane & 7))
                      * ROW + ((lane >> 3) & 1) * 16;

    // prologue: the first STAGES - 1 chunks in flight
    int ll = o_begin, cl = c_begin;          // next chunk to load
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nst) {
            load_chunk<JOINT>(smem + s * T::ROWS * ROW, pa, pb, na, nb, W, i0,
                              j0, ll, cl);
            if (++cl == c_end) { cl = c_begin; ++ll; }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    int lc = o_begin, cc = c_begin;          // chunk being counted
    int slot = 0;                            // its stage
    for (int st = 0; st < nst; ++st) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2)
                     : "memory");
        __syncthreads();                     // chunk st landed; st - 1 done
        if (st + STAGES - 1 < nst) {             // into the stage of st - 1
            const int ls = slot == 0 ? STAGES - 1 : slot - 1;
            load_chunk<JOINT>(smem + ls * T::ROWS * ROW, pa, pb, na, nb, W,
                              i0, j0, ll, cl);
            if (++cl == c_end) { cl = c_begin; ++ll; }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        const uint8_t* stage = smem + slot * T::ROWS * ROW;
        slot = slot == STAGES - 1 ? 0 : slot + 1;
#pragma unroll
        for (int ks = 0; ks < KW / 8; ++ks) {    // two k256 steps
            uint32_t ak[TM][4], ap[SM][4];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const uint8_t* p = stage + a_off + i * 16 * ROW + ks * 32;
                ldmatrix4(ak[i], p);
                if constexpr (JOINT) ldmatrix4(ap[i], p + BM * ROW);
            }
#pragma unroll
            for (int j = 0; j < TN; j += 2) {
                const uint8_t* p = stage + b_off + j * 8 * ROW + ks * 32;
                uint32_t bk[4], bp[4];
                ldmatrix4(bk, p);
                if constexpr (JOINT) ldmatrix4(bp, p + BN * ROW);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    mma_b1(x[i][j], ak[i], bk[0], bk[1]);
                    mma_b1(x[i][j + 1], ak[i], bk[2], bk[3]);
                    if constexpr (JOINT) {
                        mma_b1(y[i][j], ak[i], bp[0], bp[1]);
                        mma_b1(y[i][j + 1], ak[i], bp[2], bp[3]);
                        mma_b1(z[i][j], ap[i], bk[0], bk[1]);
                        mma_b1(z[i][j + 1], ap[i], bk[2], bk[3]);
                    }
                }
            }
        }
        if (cc + 1 == c_end) {               // level lc is counted
            if (!JOINT || lc > o_begin) {
                const int o = JOINT ? lc - 1 : lc;
                float* cum = out + (long long)o * plane;
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        const int gj = j0 + (wn * TN + j) * 8 + 2 * tq;
                        if (gj >= nb) continue;
                        const bool two = gj + 1 < nb;
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int gi = i0 + (wm * TM + i) * 16 + gid
                                           + 8 * h;
                            if (gi >= na) continue;
                            const long long off = (long long)gi * nb + gj;
                            const uint32_t x0 = x[i][j][2 * h];
                            const uint32_t x1 = x[i][j][2 * h + 1];
                            if (sym && gi >= gj) {
                                // on or below the diagonal: scalar writes
                                // of the pairs i <= j and their mirrors
#pragma unroll
                                for (int c = 0; c < 2; ++c) {
                                    const int gc = gj + c;
                                    if (gc >= nb || gi > gc) continue;
                                    uint32_t yv = 0, zv = 0, pv = 0;
                                    if constexpr (JOINT) {
                                        yv = y[i][j][2 * h + c];
                                        zv = z[i][j][2 * h + c];
                                        pv = xp[i][j][2 * h + c];
                                    }
                                    const uint32_t xv = c ? x1 : x0;
                                    emit<JOINT>(cum, (long long)K * plane,
                                                off + c, xv, yv, zv, pv,
                                                atomic);
                                    if (gi < gc)               // (gc, gi)
                                        emit<JOINT>(
                                            cum, (long long)K * plane,
                                            (long long)gc * nb + gi, xv, zv,
                                            yv, pv, atomic);
                                }
                                continue;
                            }
                            put2(cum + off, x0, x1, two, vec, atomic);
                            if (sym) {                 // gi < gj: mirrors
#pragma unroll
                                for (int c = 0; c < 2; ++c) {
                                    const int gc = gj + c;
                                    if (gc >= nb) continue;
                                    uint32_t yv = 0, zv = 0, pv = 0;
                                    if constexpr (JOINT) {
                                        // (gc, gi): Y and Z trade places
                                        zv = y[i][j][2 * h + c];
                                        yv = z[i][j][2 * h + c];
                                        pv = xp[i][j][2 * h + c];
                                    }
                                    emit<JOINT>(cum, (long long)K * plane,
                                                (long long)gc * nb + gi,
                                                c ? x1 : x0, yv, zv, pv,
                                                atomic);
                                }
                            }
                            if constexpr (JOINT) {
                                float* eq = cum + (long long)K * plane;
                                float* gta = eq + (long long)K * plane;
                                float* gtb = gta + (long long)K * plane;
                                const uint32_t y0 = y[i][j][2 * h];
                                const uint32_t y1 = y[i][j][2 * h + 1];
                                const uint32_t z0 = z[i][j][2 * h];
                                const uint32_t z1 = z[i][j][2 * h + 1];
                                const uint32_t p0 = xp[i][j][2 * h];
                                const uint32_t p1 = xp[i][j][2 * h + 1];
                                put2(eq + off, x0 - y0 - z0 + p0,
                                     x1 - y1 - z1 + p1, two, vec, atomic);
                                put2(gta + off, y0 - p0, y1 - p1, two, vec,
                                     atomic);
                                put2(gtb + off, z0 - p0, z1 - p1, two, vec,
                                     atomic);
                            }
                        }
                    }
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if constexpr (JOINT) {
                            xp[i][j][e] = x[i][j][e];
                            y[i][j][e] = z[i][j][e] = 0;
                        }
                        x[i][j][e] = 0;
                    }
        }
        if (++cc == c_end) { cc = c_begin; ++lc; }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int sm_count() {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

template <bool JOINT>
int launch(const void* a, const void* b, void* planes_a, void* planes_b,
           void* out, int na, int nb, long long m, int kmin, int K,
           void* stream) {
    if (na < 0 || nb < 0 || m < 1 || kmin < 0 || K < 1 || kmin + K - 1 > 64)
        return (int)cudaErrorInvalidValue;
    if (na == 0 || nb == 0) return (int)cudaGetLastError();
    using T = Tile<JOINT>;
    const cudaStream_t st = (cudaStream_t)stream;
    const long long W = words_per_row(m);
    const int L = JOINT ? K + 1 : K;
    const int kfirst = JOINT ? kmin - 1 : kmin;
    const int pt = 256;
    planes_kernel<<<(unsigned)((na * W + pt - 1) / pt), pt, 0, st>>>(
        (const int8_t*)a, (uint32_t*)planes_a, na, m, W, kfirst, L);
    if (planes_b != planes_a)
        planes_kernel<<<(unsigned)((nb * W + pt - 1) / pt), pt, 0, st>>>(
            (const int8_t*)b, (uint32_t*)planes_b, nb, m, W, kfirst, L);
    // one bank on both sides: only the tiles that hold pairs i <= j count
    const bool sym = planes_b == planes_a;
    const int tiles_a = (na + BM - 1) / BM, tiles_b = (nb + T::BN - 1) / T::BN;
    long long tiles = (long long)tiles_a * tiles_b;
    if (sym) {
        tiles = 0;
        for (int ti = 0; ti < tiles_a; ++ti)
            for (int tj = 0; tj < tiles_b; ++tj)
                tiles += upper_tile<JOINT>(ti * BM, tj * T::BN);
    }
    const long long want = (long long)sm_count() * (JOINT ? 1 : 2);
    // level segments first: as many as give the fewest waves of `want`
    // blocks times the levels a block counts (the joint form recounts the
    // level below its segment); then the register axis
    const long long seg_max = JOINT ? (K / 4 < 1 ? 1 : K / 4) : K;
    long long seg = 1, per_seg = K, best = -1;
    for (long long s = 1; s <= seg_max; ++s) {
        const long long per_s = (K + s - 1) / s;
        const long long n_s = (K + per_s - 1) / per_s;
        const long long cost = (tiles * n_s + want - 1) / want
                               * (per_s + (JOINT ? 1 : 0));
        if (best < 0 || cost < best) {
            best = cost;
            seg = n_s;
            per_seg = per_s;
        }
    }
    const long long nchunks = W / KW;
    long long splits = want / (tiles * seg);
    if (splits > nchunks) splits = nchunks;
    if (splits < 1) splits = 1;
    const long long per = (nchunks + splits - 1) / splits;
    splits = (nchunks + per - 1) / per;
    if (splits > 1) {
        const cudaError_t err = cudaMemsetAsync(
            out, 0, sizeof(float) * (JOINT ? 4 : 1) * (size_t)K * na * nb,
            st);
        if (err != cudaSuccess) return (int)err;
    }
    const cudaError_t err = cudaFuncSetAttribute(
        count_kernel<JOINT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(tiles_b, tiles_a, (unsigned)(seg * splits));
    count_kernel<JOINT><<<grid, THREADS, T::SMEM, st>>>(
        (const uint32_t*)planes_a, (const uint32_t*)planes_b, (float*)out,
        na, nb, W, K, (int)per_seg, (int)splits, (int)per, sym);
    return (int)cudaGetLastError();
}

}  // namespace

// Words of one row of a bank's indicator planes (the caller sizes the
// scratch as levels * rows * this: K + 1 levels joint, K X-only).
extern "C" long long dtt_joint_plane_words(long long m) {
    return words_per_row(m);
}

// (na, m), (nb, m) int8 -> out (4, K, na, nb) float32: cum_union, eq,
// gt_a, gt_b over levels kmin..kmin+K-1 (kmin + K - 1 <= 64).  planes_a,
// planes_b: scratch of (K + 1) * rows * dtt_joint_plane_words(m) uint32;
// when a and b are one bank, pass the same scratch twice: it is built once
// and each unordered pair is counted once.
extern "C" int dtt_joint_pair_stats(const void* a, const void* b,
                                    void* planes_a, void* planes_b,
                                    void* out, int na, int nb, long long m,
                                    int kmin, int K, void* stream) {
    return launch<true>(a, b, planes_a, planes_b, out, na, nb, m, kmin, K,
                        stream);
}

// The X-only form: out (K, na, nb) float32 cum_union; scratch of K * rows *
// dtt_joint_plane_words(m) uint32 per bank, shared as above.
extern "C" int dtt_cum_union(const void* a, const void* b, void* planes_a,
                             void* planes_b, void* out, int na, int nb,
                             long long m, int kmin, int K, void* stream) {
    return launch<false>(a, b, planes_a, planes_b, out, na, nb, m, kmin, K,
                         stream);
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
