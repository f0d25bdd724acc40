// K4: the binary popcount matmul, out[m,n] = sum_k popc(a[m,k] & w[k,n]),
// and the fused bit-serial product over every plane pair in one launch.
//
// Replaces binary_matmul of src/repro/kernels/bitserial_matmul.py (a
// Pallas kernel whose sequential K grid axis carries the int32 sum in the
// output block).  A (M, Kw) and W (Kw, N) are uint32 words, 32 binary
// features each; out is (M, N) int32.  The fused entry takes the stacked
// planes of a bit-serial product, A (n_a, M, Kw) and W (n_w, Kw, N), and
// writes sum_{i,j} s_i s_j 2^(i+j) (A_i . W_j) with the int32 wrap of
// src/repro/kernels/ops.py bitserial_matmul (s = -1 on the MSB plane of a
// signed operand; a shift of 32 or more gives 0, as XLA's does).
//
// Bound on an H100: the larger of the bytes (A and W read once, out written
// once, at 3.35 TB/s) and the binary MACs over the fastest exact unit's
// rate: wgmma .b1 .and.popc, 7.6 T binary MACs a second as
// experiments/popmma_probe.py measures it (mma.sync .b1, which this kernel
// runs, 5.1 T; PERF.md).  At the three VGG-16 shapes the bytes bound it.
//
// Design: tensor cores.  mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// computes popc(a & w) summed over 256 features into int32, exactly the
// inner loop, and its fragments are whole words: a thread's A registers
// are words t and t+4 of rows g and g+8 of a 16 x 8-word tile, its B
// registers words t and t+4 of column g (g = lane/4, t = lane%4).  So the
// tiles stay in their global layouts in shared memory: A rows of 16 words
// at a stride of 20 and W rows of 64 columns at a stride of 72 make every
// fragment load free of bank conflicts.  A block of four warps computes a
// 64 x 64 output tile (each warp 32 x 32: 2 x 4 mma per 256 features) in
// 32 accumulator registers, and six blocks fit an SM.  Tiles of 16 words
// of K are staged by cp.async (16-, 8- or 4-byte copies, whatever the row
// length and pointer allow; out-of-range words are zero-filled by the copy
// and change no sum) in a ring of three stages.  The fused product walks
// (plane pair, K tile) as one sequence through the same ring, the pairs in
// decreasing weight, and one accumulator takes them all Horner's way: it
// is shifted left by the drop in exponent between pairs and negated around
// a pair of negative weight (mod 2^32 every step is exact), so the output
// is written once.  The sums go through a shared tile to 16-byte stores.
// The stages a tile needs come one after another, each a round trip to
// memory, so where one wave of resident clusters (the runtime's
// occupancy count) holds more blocks than there are M x N tiles, the
// tile's (pair, K tile) sequence is cut into as many as 8 runs of at least
// two stages, one per block of a thread-block cluster, as many as still
// fit in one wave; a run may begin or end inside a pair, and its
// block opens and closes the pair's sign and weight there.  Each block
// leaves its partial tile in shared memory and sums its share of the
// rows over the cluster's tiles through distributed shared memory, so no
// atomics, no zeroed output and no second pass.  The earlier
// design, __popc on the CUDA cores with 64 x 64 tiles staged synchronously
// and K never split, took 0.029-0.032 ms a binary product at these shapes
// on an H100.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kThreads = 128;   // four warps, 2 x 2, each 32 x 32
constexpr int kMinBlocks = 6;   // resident blocks an SM (85 registers)
constexpr int kSW = 16;         // words of K per stage: two m16n8k256 steps
constexpr int kStages = 3;      // cp.async ring
constexpr int kAS = kSW + 4;    // A stage row stride in words
constexpr int kWS = kBN + 8;    // W stage row stride in words
constexpr int kOS = kBN + 4;    // output tile row stride in words
constexpr int kMaxSplits = 8;   // a portable cluster

struct Stage {
    uint32_t a[kBM * kAS];      // a[row][k]
    uint32_t w[kSW * kWS];      // w[k][col]
};
static_assert(sizeof(Stage) * kStages >= sizeof(int) * kBM * kOS,
              "the output tile reuses the ring");

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? kBytes : 0;          // 0: zero-fill, read nothing
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(n));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(kBytes), "r"(n));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// c += popc(a & b) over 16 x 8 x 256 bits, int32, wrapping
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVA, kVW: words per cp.async of A rows and of W rows (4, 2 or 1)
template <int kVA, int kVW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
popmatmul_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ w,
                 int* __restrict__ out, int m, int n, int kw, int n_a,
                 int n_w, int sign_a, int sign_w, int chunk) {
    __shared__ __align__(16) Stage st[kStages];
    __shared__ unsigned short order[32 * 32];   // pair q: i << 8 | j
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const long long m0 = (long long)blockIdx.x * kBM;
    const long long n0 = (long long)blockIdx.y * kBN;
    const int nk = (kw + kSW - 1) / kSW;        // K tiles a pair
    const int pairs = n_a * n_w;
    // this block's share of the tile's (pair, K tile) sequence
    const int q_lo = blockIdx.z * chunk;
    const int q_hi = min(pairs * nk, q_lo + chunk);

    // the plane pairs in decreasing weight 2^(i+j): one accumulator then
    // takes them all, Horner's way (shifted left between weights, negated
    // around a pair of weight -2^(i+j))
    if (tid == 0) {
        int q = 0;
        for (int e = n_a + n_w - 2; e >= 0; --e)
            for (int i = max(0, e - n_w + 1); i <= min(e, n_a - 1); ++i)
                order[q++] = (unsigned short)(i << 8 | (e - i));
    }
    __syncthreads();

    // stage q of the (pair, K tile) sequence into ring slot s
    auto load = [&](int q, int s) {
        const int ij = order[q / nk], k0 = (q % nk) * kSW;
        const uint32_t* ap = a + (long long)(ij >> 8) * m * kw;
        const uint32_t* wp = w + (long long)(ij & 255) * kw * n;
        constexpr int kAC = kSW / kVA;              // copies per A row
        for (int e = tid; e < kBM * kAC; e += kThreads) {
            const int r = e / kAC, c = (e % kAC) * kVA;
            const long long gm = m0 + r;
            const int gk = k0 + c;
            const bool ok = gm < m && gk < kw;
            cp_async<4 * kVA>(&st[s].a[r * kAS + c],
                              ok ? ap + gm * kw + gk : ap, ok);
        }
        constexpr int kWC = kBN / kVW;              // copies per W row
        for (int e = tid; e < kSW * kWC; e += kThreads) {
            const int r = e / kWC, c = (e % kWC) * kVW;
            const int gk = k0 + r;
            const long long gn = n0 + c;
            const bool ok = gk < kw && gn < n;
            cp_async<4 * kVW>(&st[s].w[r * kWS + c],
                              ok ? wp + (long long)gk * n + gn : wp, ok);
        }
    };
    // pair p's weight: 2^(i+j), negative on the last plane of a signed
    // operand (one of the two, not both)
    auto weight = [&](int p, int& e) {
        const int ij = order[p], i = ij >> 8, j = ij & 255;
        e = i + j;
        return (sign_a && i == n_a - 1) != (sign_w && j == n_w - 1);
    };

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    auto negate = [&]() {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    acc[i][j][r] = (int)(0u - (uint32_t)acc[i][j][r]);
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (q_lo + s < q_hi) load(q_lo + s, s);
        cp_async_commit();
    }
    for (int q = q_lo; q < q_hi; ++q) {
        const int slot = (q - q_lo) % kStages;
        cp_async_wait<kStages - 2>();
        __syncthreads();            // stage q landed; slot q-1 is free
        if (q + kStages - 1 < q_hi)
            load(q + kStages - 1, (slot + kStages - 1) % kStages);
        cp_async_commit();
        // a pair runs from its first K tile (or the block's first) to its
        // last (or the block's last)
        const int p = q / nk, kt = q % nk;
        int e;
        const bool neg = weight(p, e);
        if ((kt == 0 || q == q_lo) && neg) negate();
        const Stage& sq = st[slot];
#pragma unroll
        for (int kk = 0; kk < kSW; kk += 8) {
            uint32_t af[2][4], bf[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint32_t* ar = sq.a + (wm + 16 * i + g) * kAS + kk + t;
                af[i][0] = ar[0];
                af[i][1] = ar[8 * kAS];
                af[i][2] = ar[4];
                af[i][3] = ar[8 * kAS + 4];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t* wr = sq.w + (kk + t) * kWS + wn + 8 * j + g;
                bf[j][0] = wr[0];
                bf[j][1] = wr[4 * kWS];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_b1(acc[i][j], af[i], bf[j]);
        }
        if (kt == nk - 1 || q == q_hi - 1) {
            if (neg) negate();
            int e_next = 0;
            if (q + 1 < q_hi) weight(p + 1, e_next);
            const int d = e - e_next;   // to the next weight, or to 2^0
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        acc[i][j][r] = d < 32
                            ? (int)((uint32_t)acc[i][j][r] << d) : 0;
        }
    }
    cp_async_wait<0>();
    __syncthreads();                // every warp is done with the ring

    // the block's sums into a shared 64 x 64 tile (over the ring), then
    // out in 16-byte rows; the blocks of one tile's cluster add their
    // tiles through distributed shared memory, each block summing and
    // storing its share of the rows
    int* tile = reinterpret_cast<int*>(st);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<int2*>(
                    tile + (wm + 16 * i + g + 8 * h) * kOS + wn + 8 * j
                    + 2 * t) = make_int2(acc[i][j][2 * h],
                                         acc[i][j][2 * h + 1]);
    const int splits = gridDim.z;
    int rank = 0;
    if (splits > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        rank = (int)cluster.block_rank();
    } else {
        __syncthreads();
    }
    const int r_lo = rank * kBM / splits, r_hi = (rank + 1) * kBM / splits;
    const bool vec = (n & 3) == 0;
    for (int e = r_lo * (kBN / 4) + tid; e < r_hi * (kBN / 4);
         e += kThreads) {
        const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
        const long long gm = m0 + r, gn = n0 + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        for (int z = 0; z < splits; ++z) {
            const int* src = tile + r * kOS + c;
            if (splits > 1)
                src = cg::this_cluster().map_shared_rank(
                    const_cast<int*>(src), z);
            const uint4 x = *reinterpret_cast<const uint4*>(src);
            v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
        }
        if (gm >= m) continue;
        int* o = out + gm * n + gn;
        if (vec && gn + 4 <= n) {
            *reinterpret_cast<uint4*>(o) = v;
        } else {
            const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (gn + i < n) o[i] = (int)vs[i];
        }
    }
    if (splits > 1) cg::this_cluster().sync();  // peers read our tile
}

// the widest copy (4, 2 or 1 words) that divides a row and the alignment
int copy_words(const void* p, int row) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if (row % 4 == 0 && addr % 16 == 0) return 4;
    if (row % 2 == 0 && addr % 8 == 0) return 2;
    return 1;
}

template <int kVA, int kVW>
cudaLaunchConfig_t config(dim3 grid, cudaStream_t s,
                          cudaLaunchAttribute* cluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cluster->id = cudaLaunchAttributeClusterDimension;
    cluster->val.clusterDim.x = 1;
    cluster->val.clusterDim.y = 1;
    cluster->val.clusterDim.z = grid.z;         // the runs of one tile
    cfg.attrs = cluster;
    cfg.numAttrs = grid.z > 1 ? 1 : 0;
    return cfg;
}

// clusters of `size` blocks the card holds at once (blocks, for size 1),
// asked of the runtime once a size
template <int kVA, int kVW>
long long resident(int size) {
    static long long cache[kMaxSplits + 1] = {};
    if (cache[size] == 0) {
        int n = 0;
        if (size == 1) {
            int dev = 0, sms = 0;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, popmatmul_kernel<kVA, kVW>, kThreads, 0);
            n *= sms;
        } else {
            cudaLaunchAttribute cluster;
            const cudaLaunchConfig_t cfg = config<kVA, kVW>(
                dim3(1, 1, size), nullptr, &cluster);
            cudaOccupancyMaxActiveClusters(&n, popmatmul_kernel<kVA, kVW>,
                                           &cfg);
        }
        (void)cudaGetLastError();   // a refused query only means no split
        cache[size] = n > 0 ? n : -1;
    }
    return cache[size];
}

template <int kVA, int kVW>
cudaError_t launch_vw(long long tiles_m, long long tiles_n, cudaStream_t s,
                      const uint32_t* a, const uint32_t* w, int* out, int m,
                      int n, int kw, int n_a, int n_w, int sign_a,
                      int sign_w) {
    // cut each tile's (pair, K tile) sequence into the most runs of at
    // least two stages (one block each, one cluster a tile, at most 8)
    // that one wave of resident clusters still holds
    const long long seq = (long long)n_a * n_w * ((kw + kSW - 1) / kSW);
    const long long tiles = tiles_m * tiles_n;
    long long chunk = std::max(1LL, seq);
    for (long long r = std::min(seq / 2, (long long)kMaxSplits); r >= 2;
         --r) {
        const long long c = (seq + r - 1) / r;
        if (tiles <= resident<kVA, kVW>((int)((seq + c - 1) / c))) {
            chunk = c;
            break;
        }
    }
    const long long splits = std::max(1LL, (seq + chunk - 1) / chunk);
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = config<kVA, kVW>(
        dim3(static_cast<unsigned>(tiles_m), static_cast<unsigned>(tiles_n),
             static_cast<unsigned>(splits)), s, &cluster);
    return cudaLaunchKernelEx(&cfg, popmatmul_kernel<kVA, kVW>, a, w, out,
                              m, n, kw, n_a, n_w, sign_a, sign_w,
                              static_cast<int>(chunk));
}

template <int kVA>
cudaError_t launch_va(int vw, long long tiles_m, long long tiles_n,
                      cudaStream_t s, const uint32_t* a, const uint32_t* w,
                      int* out, int m, int n, int kw, int n_a, int n_w,
                      int sign_a, int sign_w) {
    if (vw == 4)
        return launch_vw<kVA, 4>(tiles_m, tiles_n, s, a, w, out, m, n, kw,
                                 n_a, n_w, sign_a, sign_w);
    if (vw == 2)
        return launch_vw<kVA, 2>(tiles_m, tiles_n, s, a, w, out, m, n, kw,
                                 n_a, n_w, sign_a, sign_w);
    return launch_vw<kVA, 1>(tiles_m, tiles_n, s, a, w, out, m, n, kw, n_a,
                             n_w, sign_a, sign_w);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a: (n_a, m, kw) words; w: (n_w, kw, n) words; out: (m, n) int32.
// n_a = n_w = 1 with no signs is one binary product.
int popmatmul_launch(const void* a, const void* w, void* out, int m, int n,
                     int kw, int n_a, int n_w, int sign_a, int sign_w,
                     void* stream) {
    if (m <= 0 || n <= 0 || kw < 0 || n_a < 1 || n_w < 1 || n_a > 32
            || n_w > 32 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles_m = (m + kBM - 1) / kBM;
    const long long tiles_n = (n + kBN - 1) / kBN;
    if (tiles_m > 2147483647LL || tiles_n > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* pa = static_cast<const uint32_t*>(a);
    const auto* pw = static_cast<const uint32_t*>(w);
    auto* po = static_cast<int*>(out);
    const int va = copy_words(a, kw), vw = copy_words(w, n);
    cudaError_t e;
    if (va == 4)
        e = launch_va<4>(vw, tiles_m, tiles_n, s, pa, pw, po, m, n, kw, n_a,
                         n_w, sign_a, sign_w);
    else if (va == 2)
        e = launch_va<2>(vw, tiles_m, tiles_n, s, pa, pw, po, m, n, kw, n_a,
                         n_w, sign_a, sign_w);
    else
        e = launch_va<1>(vw, tiles_m, tiles_n, s, pa, pw, po, m, n, kw, n_a,
                         n_w, sign_a, sign_w);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
