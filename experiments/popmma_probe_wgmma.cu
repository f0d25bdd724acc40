// wgmma rate probe for K4 (experiments/popmma_probe.py), built once per
// candidate with -DUNIT_B1 or -DUNIT_S8, so that a form ptxas refuses
// costs only its own library:
//
//   UNIT_B1  wgmma.mma_async m64n128k256 .s32.b1.b1.and.popc
//            (64 x 128 x 256 = 2,097,152 binary MACs an instruction)
//   UNIT_S8  wgmma.mma_async m64n128k32 .s32.s8.s8 on bits held as int8
//            (64 x 128 x 32 = 262,144 binary MACs an instruction)
//
// One warpgroup per block issues ``rounds`` groups of kPerGroup
// instructions into one 64-register accumulator, from an A and a B tile
// in shared memory (no swizzle; the tile layout does not change the
// rate, only which bits meet).  The sums are written out so that nothing
// is optimised away.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPerGroup = 4;

__device__ __forceinline__ uint64_t desc(const void* p) {
    const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
    // start >> 4 | leading byte offset 128 >> 4 | stride byte offset 256
    // >> 4; base offset 0, no swizzle
    return ((addr >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16)
           | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                      uint64_t db) {
#if defined(UNIT_B1)
#define WGMMA_OP "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
#else
#define WGMMA_OP "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
#endif
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        WGMMA_OP
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
#undef WGMMA_OP
}

__global__ void __launch_bounds__(128)
wgmma_rate_kernel(int* __restrict__ out, int rounds) {
    __shared__ __align__(128) uint32_t tiles[2048];     // A 2 KB, B 4 KB
    for (int i = threadIdx.x; i < 2048; i += blockDim.x) {
        uint32_t x = (i + 1) * 2654435761u ^ blockIdx.x;
#if !defined(UNIT_B1)
        x &= 0x01010101u;
#endif
        tiles[i] = x;
    }
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint64_t da = desc(tiles), db = desc(tiles + 512);
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int r = 0; r < rounds; ++r) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < kPerGroup; ++k) wgmma(d, da, db);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    int total = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) total += d[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = total;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int wgmma_rate_launch(void* out, int blocks, int rounds, void* stream) {
    wgmma_rate_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), rounds);
    return static_cast<int>(cudaGetLastError());
}

int per_group() { return kPerGroup; }

}  // extern "C"
