// K1/K2: the transposition unit, horizontal <-> vertical bit layout.
//
// Replaces the Pallas kernels h2v_pallas and v2h_pallas of
// src/repro/kernels/transpose_kernel.py (a 5-round SWAR 32x32 bit
// transpose per tile).  Layout: plane j, word b holds bit j of lanes
// 32b .. 32b+31, lane l at bit l % 32.
//
// Bound on an H100: bytes.  Each lane value is read once and each plane
// word written once: 4 + n_bits / 8 bytes per lane (1.6 us at 8 planes,
// 2.5 us at 32 for 1,048,576 lanes at 3.35 TB/s); the transpose itself
// is a few dozen bitwise instructions per 32 lanes.
//
// K1 (h2v) design: every thread issues its one 16-byte load before any
// other work, so the whole input is in flight at once (32 words, 1 KB of
// lanes per 256-thread block; 1,048,576 lanes fit the card's resident
// blocks in one wave).  A thread's four values are four rows of one
// word's 32x32 bit tile; the tile is transposed in registers by the SWAR
// network, two rounds within the thread and three across lanes with
// __shfl_xor_sync, so thread t ends up holding planes 4(t%8)..4(t%8)+3 of
// word t/8 of its warp's four words.  The block stages the (32 planes x
// 32 words) result in shared memory and writes only the n_bits planes
// asked for, each plane's 32 words as 16-byte stores of 8 threads (plain
// stores at a ragged edge or a word count not a multiple of 4).  The
// earlier design, 32 warp ballots per word with one 4-byte load per loop
// trip, took 16 us at every width on an H100: its loads were never in
// flight together.
//
// K2 (v2h) design, the mirror of K1's: every thread issues its one
// 16-byte load first, four words of one plane (thread t: plane t/8, words
// 4(t%8)..4(t%8)+3 of the block's 32); only the k planes asked for load,
// the rest read as zero, so the bytes are those the bound counts.  The
// block stages the (32 planes x 32 words) tile in shared memory; a thread
// then takes four rows of one word's 32x32 bit tile (planes 4(t%8)..+3 of
// word t/8) and runs the same SWAR network, ending with lane values
// 4(t%8)..4(t%8)+3 of that word, which it stores as one 16-byte store
// (plain stores at a ragged edge).  With ``sign_extend`` the store
// sign-extends k-bit values from bit k-1 (k < 32), as ops.v2h(signed=True)
// does, so no elementwise pass follows the kernel.  The earlier design,
// one warp per word and 32 warp ballots after loads issued one per loop
// trip, took 16 us at every width on an H100.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kWordsPerBlock = 32;    // words (32 lanes each) per block

// rows lo and hi of a 32x32 bit tile exchange the off-diagonal d x d
// blocks of one SWAR round (m selects the low d bits of each 2d)
__device__ __forceinline__ void swar_pair(uint32_t& lo, uint32_t& hi, int d,
                                          uint32_t m) {
    const uint32_t a = lo, b = hi;
    lo = (a & m) | ((b & m) << d);
    hi = ((a >> d) & m) | (b & ~m);
}

// the same round between the rows of lane t and lane t ^ lanes
__device__ __forceinline__ void swar_lanes(uint32_t& x, int d, uint32_t m,
                                           int lanes, bool hi) {
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, lanes);
    x = hi ? ((y >> d) & m) | (x & ~m) : (x & m) | ((y & m) << d);
}

// four SWAR rounds per thread and three across lanes: the thread's rows
// 4(t%8)..4(t%8)+3 of one 32x32 bit tile (lanes t..t^7 hold the others)
// become rows 4(t%8)..+3 of its transpose
__device__ __forceinline__ void swar_tile(uint32_t& x0, uint32_t& x1,
                                          uint32_t& x2, uint32_t& x3,
                                          int lane) {
    swar_pair(x0, x1, 1, 0x55555555u);
    swar_pair(x2, x3, 1, 0x55555555u);
    swar_pair(x0, x2, 2, 0x33333333u);
    swar_pair(x1, x3, 2, 0x33333333u);
#pragma unroll
    for (int s = 0; s < 3; ++s) {       // rows 4, 8, 16 apart: lanes 1, 2, 4
        const int d = 4 << s, lanes = 1 << s;
        const uint32_t m = s == 0 ? 0x0F0F0F0Fu
                         : s == 1 ? 0x00FF00FFu : 0x0000FFFFu;
        const bool hi = lane & lanes;
        swar_lanes(x0, d, m, lanes, hi);
        swar_lanes(x1, d, m, lanes, hi);
        swar_lanes(x2, d, m, lanes, hi);
        swar_lanes(x3, d, m, lanes, hi);
    }
}

// values: (32 * n_words,) lane values; planes: (n_bits, n_words)
__global__ void __launch_bounds__(kWarps * 32)
h2v_kernel(const uint32_t* __restrict__ values,
           uint32_t* __restrict__ planes, int n_words, int n_bits) {
    __shared__ uint32_t tile[32][kWordsPerBlock + 1];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long b0 = (long long)blockIdx.x * kWordsPerBlock;
    // values 4t..4t+3 of the block: rows 4(t%8)..4(t%8)+3 of word t/8
    const long long v = b0 * 32 + 4 * threadIdx.x;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (v < 32LL * n_words)
        q = __ldg(reinterpret_cast<const uint4*>(values + v));
    uint32_t x0 = q.x, x1 = q.y, x2 = q.z, x3 = q.w;
    swar_tile(x0, x1, x2, x3, lane);
    const int b = 4 * warp + (lane >> 3), p = 4 * (lane & 7);
    tile[p][b] = x0;
    tile[p + 1][b] = x1;
    tile[p + 2][b] = x2;
    tile[p + 3][b] = x3;
    __syncthreads();
    const int plane = threadIdx.x >> 3, k = 4 * (threadIdx.x & 7);
    if (plane >= n_bits) return;
    uint32_t* row = planes + (long long)plane * n_words + b0 + k;
    const uint4 w = make_uint4(tile[plane][k], tile[plane][k + 1],
                               tile[plane][k + 2], tile[plane][k + 3]);
    if ((n_words & 3) == 0 && b0 + k + 4 <= n_words) {
        *reinterpret_cast<uint4*>(row) = w;
    } else {
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (b0 + k + i < n_words) row[i] = ws[i];
    }
}

// planes: (k_planes, n_words), planes k..31 read as zero;
// values: (32 * n_words,), 16-byte aligned
__global__ void __launch_bounds__(kWarps * 32)
v2h_kernel(const uint32_t* __restrict__ planes,
           uint32_t* __restrict__ values, int n_words, int k_planes,
           int sign_extend) {
    __shared__ uint32_t tile[32][kWordsPerBlock + 1];
    const int lane = threadIdx.x & 31;
    const long long b0 = (long long)blockIdx.x * kWordsPerBlock;
    // words 4(t%8)..4(t%8)+3 of plane t/8
    const int plane = threadIdx.x >> 3, k = 4 * (threadIdx.x & 7);
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (plane < k_planes) {
        const uint32_t* row = planes + (long long)plane * n_words + b0 + k;
        if ((n_words & 3) == 0
                && (reinterpret_cast<uintptr_t>(planes) & 15) == 0
                && b0 + k + 4 <= n_words) {
            q = __ldg(reinterpret_cast<const uint4*>(row));
        } else {
            uint32_t ws[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (b0 + k + i < n_words) ws[i] = __ldg(row + i);
            q = make_uint4(ws[0], ws[1], ws[2], ws[3]);
        }
    }
    tile[plane][k] = q.x;
    tile[plane][k + 1] = q.y;
    tile[plane][k + 2] = q.z;
    tile[plane][k + 3] = q.w;
    __syncthreads();
    // rows 4(t%8)..4(t%8)+3 (planes) of word t/8's bit tile
    const int b = threadIdx.x >> 3, p = 4 * (threadIdx.x & 7);
    uint32_t x0 = tile[p][b], x1 = tile[p + 1][b];
    uint32_t x2 = tile[p + 2][b], x3 = tile[p + 3][b];
    swar_tile(x0, x1, x2, x3, lane);
    if (b0 + b >= n_words) return;
    if (sign_extend && k_planes < 32) {    // from bit k-1, in place
        const int sh = 32 - k_planes;
        x0 = (uint32_t)((int32_t)(x0 << sh) >> sh);
        x1 = (uint32_t)((int32_t)(x1 << sh) >> sh);
        x2 = (uint32_t)((int32_t)(x2 << sh) >> sh);
        x3 = (uint32_t)((int32_t)(x3 << sh) >> sh);
    }
    // lane values 32(b0+b) + p .. + p+3
    *reinterpret_cast<uint4*>(values + (b0 + b) * 32 + p) =
        make_uint4(x0, x1, x2, x3);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int h2v_launch(const void* values, void* planes, int n_words, int n_bits,
               void* stream) {
    if (n_words <= 0 || n_bits < 1 || n_bits > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
    h2v_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(values), static_cast<uint32_t*>(planes),
        n_words, n_bits);
    return static_cast<int>(cudaGetLastError());
}

int v2h_launch(const void* planes, void* values, int n_words, int k_planes,
               int sign_extend, void* stream) {
    if (n_words <= 0 || k_planes < 1 || k_planes > 32
            || (reinterpret_cast<uintptr_t>(values) & 15) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
    v2h_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(values),
        n_words, k_planes, sign_extend);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
