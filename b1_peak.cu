// Throughput probe of the binary tensor-core MMAs (one-bit operands,
// `.and.popc`, int32 accumulators), an instrument of chip_smoke.py and not
// part of the port.  NVIDIA's H100 data sheet gives no rate for one-bit
// operands, so chip_smoke.py times both instructions that take them and
// reckons kernel K4's bound against the faster:
//   - `mma.sync.aligned.m16n8k256` (the one K4 issues): every warp of
//     `blocks` blocks of 256 threads issues `iters` x 8 independent MMAs
//     (16 x 8 x 256 one-bit multiply-adds each) on register operands;
//   - `wgmma.mma_async.sync.aligned.m64n128k256`: every warpgroup of
//     `blocks` blocks of 128 threads issues `iters` groups of 8 MMAs
//     (64 x 128 x 256 one-bit multiply-adds each, A in registers, B from
//     4 KiB of shared memory) and waits for each group.
// Neither touches global memory in its loop; the caller times the launch.
// A third entry, dtt_empty, launches an empty <<<1, 32>>> kernel: the
// floor against which chip_smoke.py reads the times of short kernels.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256, 1)
mma_sync_kernel(int iters, uint32_t seed, uint32_t* __restrict__ out) {
    uint32_t a[4], b[2], d[8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 7 + i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[j][i] = 0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                  "r"(b[1]));
    }
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s += d[j][i];
    out[blockIdx.x * 256 + threadIdx.x] = s;     // keeps the loop alive
}

#define ACC4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)

// d (64 x 128, int32) += popc(a (64 x 256 bits, registers) & b (128 x 256
// bits, shared memory at descriptor bd))
__device__ __forceinline__ void wgmma_b1(uint32_t (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t bd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd));
}

#undef ACC16
#undef ACC4

__global__ void __launch_bounds__(128)
wgmma_kernel(int iters, uint32_t seed, uint32_t* __restrict__ out) {
    // b: 128 rows x 32 bytes, K-major without swizzle: core matrices of 8
    // rows x 16 bytes, the two along K 128 bytes apart, 8-row groups 256
    // bytes apart (both offsets in 16-byte units in the descriptor)
    __shared__ __align__(128) uint32_t b[128 * 8];
    for (int i = threadIdx.x; i < 128 * 8; i += blockDim.x)
        b[i] = seed * (i + 1);
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(b);
    const uint64_t bd = (uint64_t)((addr & 0x3FFFF) >> 4)
                        | ((uint64_t)(128 >> 4) << 16)
                        | ((uint64_t)(256 >> 4) << 32);
    uint32_t a[4], d[64];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i + 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int it = 0; it < iters; ++it) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < 8; ++s) wgmma_b1(d, a, bd);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) s += d[i];
    out[blockIdx.x * 128 + threadIdx.x] = s;     // keeps the loop alive
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int dtt_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// out: blocks * 256 uint32 of scratch.  One-bit multiply-adds done:
// blocks * 8 warps * iters * 8 MMAs * 16 * 8 * 256.
extern "C" int dtt_b1_peak(int blocks, int iters, void* out, void* stream) {
    mma_sync_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        iters, 3u, (uint32_t*)out);
    return (int)cudaGetLastError();
}

// out: blocks * 128 uint32 of scratch.  One-bit multiply-adds done:
// blocks * iters * 8 MMAs * 64 * 128 * 256.
extern "C" int dtt_b1_peak_wgmma(int blocks, int iters, void* out,
                                 void* stream) {
    wgmma_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        iters, 3u, (uint32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" const char* dtt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
