// Joint pair statistics of two register banks, for the joint MLE (-J).
//
// Replaces the Pallas kernel dashing_tpu/ops/pallas_stats.py
// `pallas_pair_stats` (body `_kernel`; the XLA form is the joint branch of
// dashing_tpu/ops/pairwise.py `pair_stats`).  Inputs: int8 registers a
// (na, m) and b (nb, m), a level window [kmin, kmin+K-1].  For every pair
// (i, j) and level k it counts
//     X[k] = #(a <= k & b <= k),  Y[k] = #(a <= k & b <= k-1),
//     Z[k] = #(a <= k-1 & b <= k)
// and writes, as float32 (4, K, na, nb) K-first,
//     cum_union = X, eq = X - Y - Z + X[k-1], gt_a = Y - X[k-1],
//     gt_b = Z - X[k-1]
// with X[kmin-1] counted too.  Every value is an exact integer count.
//
// What bounds it on an H100: integer operations, not bytes.  The TPU kernel
// runs 0/1 indicator dots on the MXU; here the same linear algebra runs on
// 1-bit operands: each row's (reg <= k) indicator over 32 registers is one
// 32-bit word, and a count over 32 registers is one __popc of an AND.  Per
// pair and level that is 3 m/32 AND + popc + add, against 4 K float32
// outputs per pair; at p=14 and 1000 x 1000 pairs, ~5e10 popc beside
// 0.5 GB written.  Moving it
// onto the tensor cores (mma .b1 .and.popc, or int8) is later work.
//
// Design.  A first pass turns each bank into indicator bit planes: for
// every level kmin-1..kmax and row, the (reg <= k) indicators packed 32
// registers to a word, rows padded to a whole number of chunks with zero
// words (one thread per word; registers past m read as 127, which is above
// every level).  A same-bank tile builds its planes once.  The count pass
// gives a block a 64 x 64 tile of pairs (256 threads, 4 x 4 pairs each,
// rows ty + 16 ii and columns tx + 16 jj), walks the levels in order
// keeping X[k-1] in registers, and for each level walks the words in
// chunks of 16: the block copies the chunk of planes k and k-1 of its 128
// rows into shared memory with 16-byte loads (rows padded to 65 words so
// the reads do not conflict), and every thread ANDs and popcounts its 16
// pairs.  Rows past na or nb read as zero words, so ragged tiles need no
// padding by the caller.  Small tiles are split along the register axis
// too, so that the grid fills the card: then every block adds its partial
// counts (all four statistics are linear in X, Y, Z) to the zeroed
// outputs with float atomics, which are exact and order-free for integer
// sums below 2^24.  The diagonal-tile cut of the XLA path (Z = Y^T when a
// and b are one bank) is not taken: Z is counted directly and equals Y^T
// there.  The planes are scratch that the caller allocates:
// (K + 1) * rows * words_per_row(m) uint32 per bank.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;            // pairs per block edge
constexpr int THREADS = 256;        // 16 x 16, 4 x 4 pairs each
constexpr int WC = 16;              // words per chunk
constexpr int TP = TILE + 1;        // padded row stride of the word arrays

__host__ __device__ inline long long words_per_row(long long m) {
    return (m + 32 * WC - 1) / (32 * WC) * WC;
}

// planes[l][row][w] = bits j of (src[row][32 w + j] <= kmin - 1 + l)
__global__ void planes_kernel(const int8_t* __restrict__ src,
                              uint32_t* __restrict__ planes, int n,
                              long long m, long long W, int kmin, int L) {
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
        const int k = kmin - 1 + l;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) word |= (uint32_t)(v[j] <= k) << j;
        planes[((long long)l * n + row) * W + w] = word;
    }
}

__device__ __forceinline__ void put(float* p, uint32_t v, bool atomic) {
    if (atomic) atomicAdd(p, (float)v);
    else *p = (float)v;
}

__global__ void __launch_bounds__(THREADS, 2)
joint_stats_kernel(const uint32_t* __restrict__ pa,
                   const uint32_t* __restrict__ pb, float* __restrict__ out,
                   int na, int nb, long long W, int K, int chunks_per_split) {
    // [side][plane k / k-1][word][row]
    __shared__ uint32_t sw[2][2][WC][TP];
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
    const long long nchunks = W / WC;
    const long long c_begin = (long long)blockIdx.z * chunks_per_split;
    const long long c_end = min(c_begin + chunks_per_split, nchunks);
    const bool atomic = gridDim.z > 1;
    const long long plane = (long long)na * nb;

    uint32_t xprev[4][4] = {};
    for (int l = 0; l <= K; ++l) {            // level kmin - 1 + l
        uint32_t X[4][4] = {}, Y[4][4] = {}, Z[4][4] = {};
        for (long long c = c_begin; c < c_end; ++c) {
            __syncthreads();                  // the last chunk is consumed
            // 2 sides x 2 planes x 64 rows x 4 int4 per row
            for (int u = threadIdx.x; u < 4 * 4 * TILE; u += THREADS) {
                const int part = u & 3, row = (u >> 2) & (TILE - 1);
                const int pl = (u >> 8) & 1, side = u >> 9;
                const int n = side ? nb : na;
                const int grow = (side ? j0 : i0) + row;
                int4 val = make_int4(0, 0, 0, 0);
                if (grow < n && l - pl >= 0) {
                    const uint32_t* src = (side ? pb : pa)
                        + ((long long)(l - pl) * n + grow) * W + c * WC;
                    val = __ldg((const int4*)src + part);
                }
                sw[side][pl][4 * part + 0][row] = (uint32_t)val.x;
                sw[side][pl][4 * part + 1][row] = (uint32_t)val.y;
                sw[side][pl][4 * part + 2][row] = (uint32_t)val.z;
                sw[side][pl][4 * part + 3][row] = (uint32_t)val.w;
            }
            __syncthreads();
#pragma unroll 4
            for (int wd = 0; wd < WC; ++wd) {
                uint32_t ak[4], ap[4], bk[4], bp[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    ak[t] = sw[0][0][wd][ty + 16 * t];
                    ap[t] = sw[0][1][wd][ty + 16 * t];
                    bk[t] = sw[1][0][wd][tx + 16 * t];
                    bp[t] = sw[1][1][wd][tx + 16 * t];
                }
#pragma unroll
                for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        X[ii][jj] += __popc(ak[ii] & bk[jj]);
                        Y[ii][jj] += __popc(ak[ii] & bp[jj]);
                        Z[ii][jj] += __popc(ap[ii] & bk[jj]);
                    }
            }
        }
        if (l > 0) {
            float* cum = out + (long long)(l - 1) * plane;
            float* eq = cum + (long long)K * plane;
            float* gta = eq + (long long)K * plane;
            float* gtb = gta + (long long)K * plane;
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
                const int gi = i0 + ty + 16 * ii;
                if (gi >= na) continue;
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int gj = j0 + tx + 16 * jj;
                    if (gj >= nb) continue;
                    const long long o = (long long)gi * nb + gj;
                    const uint32_t x = X[ii][jj], xp = xprev[ii][jj];
                    const uint32_t y = Y[ii][jj], z = Z[ii][jj];
                    put(cum + o, x, atomic);
                    put(eq + o, x - y - z + xp, atomic);
                    put(gta + o, y - xp, atomic);
                    put(gtb + o, z - xp, atomic);
                }
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) xprev[ii][jj] = X[ii][jj];
    }
}

}  // namespace

// Words of one row of a bank's indicator planes (the caller sizes the
// scratch as (K + 1) * rows * this).
extern "C" long long dtt_joint_plane_words(long long m) {
    return words_per_row(m);
}

// (na, m), (nb, m) int8 -> out (4, K, na, nb) float32: cum_union, eq,
// gt_a, gt_b over levels kmin..kmin+K-1 (kmin + K - 1 <= 64).  planes_a,
// planes_b: scratch of (K + 1) * rows * dtt_joint_plane_words(m) uint32;
// when a and b are one bank, pass the same scratch twice: it is built once.
extern "C" int dtt_joint_pair_stats(const void* a, const void* b,
                                    void* planes_a, void* planes_b,
                                    void* out, int na, int nb, long long m,
                                    int kmin, int K, void* stream) {
    if (na < 0 || nb < 0 || m < 1 || kmin < 0 || K < 1 || kmin + K - 1 > 64)
        return (int)cudaErrorInvalidValue;
    if (na == 0 || nb == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const long long W = words_per_row(m);
    const int L = K + 1;
    const int pt = 256;
    planes_kernel<<<(unsigned)((na * W + pt - 1) / pt), pt, 0, st>>>(
        (const int8_t*)a, (uint32_t*)planes_a, na, m, W, kmin, L);
    if (planes_b != planes_a)
        planes_kernel<<<(unsigned)((nb * W + pt - 1) / pt), pt, 0, st>>>(
            (const int8_t*)b, (uint32_t*)planes_b, nb, m, W, kmin, L);
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long tiles = (long long)((na + TILE - 1) / TILE)
                            * ((nb + TILE - 1) / TILE);
    const long long nchunks = W / WC;
    // split the register axis until the grid holds about two blocks per SM
    long long splits = (2LL * sms + tiles - 1) / tiles;
    if (splits > nchunks) splits = nchunks;
    if (splits < 1) splits = 1;
    const long long per = (nchunks + splits - 1) / splits;
    splits = (nchunks + per - 1) / per;
    if (splits > 1) {
        const cudaError_t err = cudaMemsetAsync(
            out, 0, sizeof(float) * 4 * (size_t)K * na * nb, st);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((nb + TILE - 1) / TILE, (na + TILE - 1) / TILE,
                    (unsigned)splits);
    joint_stats_kernel<<<grid, THREADS, 0, st>>>(
        (const uint32_t*)planes_a, (const uint32_t*)planes_b, (float*)out,
        na, nb, W, K, (int)per);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
