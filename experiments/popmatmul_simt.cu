// K4's earlier design, kept to be timed beside the kernel that replaced
// it (experiments/popmma_probe.py builds and loads it; nothing in the port
// uses it): the binary popcount matmul out[m,n] = sum_k popc(a[m,k] &
// w[k,n]) on the CUDA cores.
//
// A block computes a 64 x 64 output tile with 256 threads, each a 4 x 4
// register tile (rows ty + 16 i, columns tx + 16 j).  Word tiles of A
// (64 x 32, stored transposed with a padded row) and W (32 x 64) are
// staged in shared memory by plain loads, with no second buffer, and
// every step is __popc(a & w) accumulated in int32 registers.  K is never
// split across blocks.  Its bound was the CUDA cores' popcount rate, 16 a
// clock per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;     // output rows per block
constexpr int kBN = 64;     // output columns per block
constexpr int kBK = 32;     // words per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
popmatmul_simt_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ w,
                 int* __restrict__ out, int m, int n, int kw) {
    __shared__ uint32_t as[kBK][kBM + 1];   // as[k][row]
    __shared__ uint32_t ws[kBK][kBN];       // ws[k][col]
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const long long m0 = (long long)blockIdx.x * kBM;
    const long long n0 = (long long)blockIdx.y * kBN;

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < kw; k0 += kBK) {
        // A tile: 64 rows x 32 words, read along k (coalesced)
        for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
            const int r = e / kBK, k = e % kBK;
            const long long gm = m0 + r;
            const int gk = k0 + k;
            as[k][r] = (gm < m && gk < kw) ? a[gm * kw + gk] : 0u;
        }
        // W tile: 32 words x 64 columns, read along n (coalesced)
        for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
            const int k = e / kBN, c = e % kBN;
            const int gk = k0 + k;
            const long long gn = n0 + c;
            ws[k][c] = (gk < kw && gn < n) ? w[(long long)gk * n + gn] : 0u;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
            uint32_t ar[4], wr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ar[i] = as[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) wr[j] = ws[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += __popc(ar[i] & wr[j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long gm = m0 + ty + 16 * i;
        if (gm >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const long long gn = n0 + tx + 16 * j;
            if (gn < n) out[gm * n + gn] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a: (m, kw) words; w: (kw, n) words; out: (m, n) int32
int popmatmul_simt_launch(const void* a, const void* w, void* out, int m, int n,
                     int kw, void* stream) {
    if (m <= 0 || n <= 0 || kw < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long grid_y = (n + kBN - 1) / kBN;
    if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + kBM - 1) / kBM, static_cast<unsigned>(grid_y));
    popmatmul_simt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
        static_cast<int*>(out), m, n, kw);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
