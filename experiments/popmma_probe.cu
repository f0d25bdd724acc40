// Unit-rate probe for K4 (experiments/popmma_probe.py): how many binary
// multiply-accumulates a second each candidate unit of an H100 runs, fed
// from registers, so that no memory traffic enters the rate.
//
//   unit 0  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
//           16 x 8 x 256 = 32,768 binary MACs an instruction
//   unit 1  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on bits held
//           as int8 {0, 1}: 16 x 8 x 32 = 4,096 binary MACs
//   unit 2  __popc(a & w) on the CUDA cores: 32 binary MACs a thread
//
// Each warp runs ``rounds`` rounds of kChains independent instructions (a
// warp's 32 x 32 output tile is 2 x 4 mma), so latency is hidden the way
// a GEMM's main loop hides it.  The sums are written out so that nothing
// is optimised away.  The wgmma forms are in popmma_probe_wgmma.cu.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kUnit>
__global__ void rate_kernel(const uint32_t* __restrict__ seed,
                            int* __restrict__ out, int rounds) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = seed[(tid + i) & 255];
#pragma unroll
    for (int i = 0; i < 2; ++i) b[i] = seed[(tid + 7 + i) & 255];
    if (kUnit == 1) {                 // int8 {0, 1}: bit 0 of each byte
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] &= 0x01010101u;
#pragma unroll
        for (int i = 0; i < 2; ++i) b[i] &= 0x01010101u;
    }
    int acc[kChains][4] = {};
    if (kUnit == 2) {
        int s[kChains] = {};
        for (int r = 0; r < rounds; ++r) {
#pragma unroll
            for (int c = 0; c < kChains; ++c)
                s[c] += __popc(a[c & 3] & (b[c & 1] ^ (uint32_t)s[c]));
        }
#pragma unroll
        for (int c = 0; c < kChains; ++c) acc[c][0] = s[c];
    } else {
        for (int r = 0; r < rounds; ++r) {
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
                if (kUnit == 0) mma_b1(acc[c], a, b);
                else mma_s8(acc[c], a, b);
            }
        }
    }
    int total = 0;
#pragma unroll
    for (int c = 0; c < kChains; ++c)
        total += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
    out[tid] = total;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// unit as above; blocks x threads threads, each warp `rounds` rounds of
// kChains instructions (unit 2: per thread)
int rate_launch(int unit, const void* seed, void* out, int blocks,
                int threads, int rounds, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* sd = static_cast<const uint32_t*>(seed);
    auto* o = static_cast<int*>(out);
    if (unit == 0) rate_kernel<0><<<blocks, threads, 0, s>>>(sd, o, rounds);
    else if (unit == 1) rate_kernel<1><<<blocks, threads, 0, s>>>(sd, o, rounds);
    else if (unit == 2) rate_kernel<2><<<blocks, threads, 0, s>>>(sd, o, rounds);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

int chains() { return kChains; }

}  // extern "C"
