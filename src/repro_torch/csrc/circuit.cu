// K3: one synthesized SIMDRAM circuit on bit-planes, as a level-parallel
// slot program.
//
// Replaces the Pallas kernel circuit_on_planes of
// src/repro/kernels/bitplane_ops.py (:57), whose body (_make_kernel, :37)
// unrolls Circuit.evaluate_outputs into straight-line vector code over a
// block of words, generated per circuit.
//
// Bound on an H100: bytes for every circuit of the repository at its real
// width (each operand plane word read once, each output plane word written
// once: 16-bit multiplication over 1,048,576 lanes moves 8.4 MB, 2.5 us at
// 3.35 TB/s), with the gates' bitwise operations close behind on the wide
// circuits (one LOP3 per gate and word at 64 per clock per SM: the 976
// gates of 16-bit multiplication take 1.9 us).  What holds this kernel
// (experiments/circuit_probe.py, PERF.md) is the slot file's shared-memory
// traffic, three 8-byte loads and one 8-byte store per lane and gate, and
// on deep, narrow circuits each level's chain of dependent shared-memory
// round trips; the serial design it replaced ran one dependent chain per
// instruction on 8 warps an SM.
//
// Design.  One generic kernel serves every op, width and style (MIG or
// AIG); the host (kernels/bitplane_ops.py: lower_circuit) turns a circuit
// into steps, one per level of the circuit, so that no gate of a step
// reads a slot the same step writes: a step's gates run in any order, on
// any warp.  A block of W warps (two to four, from the circuit's mean
// level width) shares one tile of 64 words, two per lane, and the tile's
// slot file in shared memory: slot-major, 256 bytes a slot, so a warp's
// 8-byte accesses are consecutive.  Each step, the warps
//   1. issue cp.async copies of the input planes the program needs
//      kAhead steps later into their slots (a partial tile reads zeros),
//   2. run the step's gates, dealt round-robin, four at a time so that a
//      warp's loads of four independent gates are in flight together,
//   3. store the output planes computed by the previous step,
//   4. wait for the copies issued kAhead - 1 steps ago, and meet at one
//      barrier.
// A gate is one branch-free 16-byte entry: byte offsets of its arguments
// a, b, c and of its result; bit 0 of a marks XOR, bit 0 of c a
// complemented c:
//   r = XOR ? a ^ b ^ c : MAJ(a, b, c or ~c).
// The host folds NOT into its readers and tracks which slots hold a
// node's complement (MAJ is self-dual, so a MAJ keeps at most one
// complemented argument); AND and OR are MAJ with slot 0, which holds
// zeros (complemented for OR).  The gate entries and the step, load and
// store tables are staged in shared memory and read by broadcast: the
// tables once per block, the gates once per block where they fit one
// chunk, else chunk by chunk for every tile.  Blocks are persistent over
// tiles, as many as fit on the card at once.  The launcher sets the
// kernels' shared-memory limit and works out their occupancy once per
// size.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 64;              // words per tile, two per lane
constexpr int kSlotBytes = 4 * kTileWords;
constexpr int kAhead = 8;                   // steps from a load to its use
constexpr int kGateInts = 4;
constexpr int kBatch = 4;                   // gates a warp runs together
constexpr int kMaxWarps = 8;
constexpr int kMaxSharedBytes = 232448;     // 227 KB per block on sm_90

__device__ __forceinline__ void cp_async4(uint32_t dst, const uint32_t* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint2 slot(const unsigned char* my, int off) {
    return *reinterpret_cast<const uint2*>(my + off);
}

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b,
                                         uint32_t c) {
    return (a & b) | (a & c) | (b & c);
}

// K gates g, g + stride, ... (with kClamp, those at or past end run gate
// g again: the same result to the same slot): all loads first, then the
// results, then the stores (no gate of a step reads what another writes)
template <bool kXor, int K, bool kClamp>
__device__ __forceinline__ void run_gates(const int4* __restrict__ sg,
                                          unsigned char* my, int g,
                                          int stride, int end) {
    int4 e[K];
    uint2 a[K], b[K], c[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
        e[k] = sg[!kClamp || g + k * stride < end ? g + k * stride : g];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        a[k] = slot(my, kXor ? e[k].x & ~1 : e[k].x);
        b[k] = slot(my, e[k].y);
        c[k] = slot(my, e[k].z & ~1);
    }
    // keep every load above every result: a warp then waits for one
    // round trip to shared memory per batch, not one per gate
    asm volatile("" ::: "memory");
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const uint32_t cm = 0u - static_cast<uint32_t>(e[k].z & 1);
        uint2 r;
        r.x = maj3(a[k].x, b[k].x, c[k].x ^ cm);
        r.y = maj3(a[k].y, b[k].y, c[k].y ^ cm);
        if (kXor) {
            const uint32_t x = 0u - static_cast<uint32_t>(e[k].x & 1);
            r.x = (r.x & ~x) | ((a[k].x ^ b[k].x ^ c[k].x) & x);
            r.y = (r.y & ~x) | ((a[k].y ^ b[k].y ^ c[k].y) & x);
        }
        *reinterpret_cast<uint2*>(my + e[k].w) = r;
    }
}

// copy n int4 into shared memory (cp.async, then wait and meet)
__device__ __forceinline__ void stage(int4* dst, const int4* src, int n) {
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(base + 16 * i), "l"(src + i) : "memory");
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
}

// int32 of the tables after the gates: steps, loads, stores, chunks,
// padded to whole 16-byte words (lower_circuit pads the program so)
__host__ __device__ __forceinline__ int table_ints(int n_steps, int n_loads,
                                                   int n_stores,
                                                   int n_chunks) {
    const int n = 3 * (n_steps + 1) + 3 * n_loads + 3 * n_stores
        + n_chunks + 1;
    return (n + 3) & ~3;
}

// prog: gates (n_gates, 4), steps (n_steps + 1, 3), loads (n_loads, 3),
// stores (n_stores, 3), chunks (n_chunks + 1), as lower_circuit lays
// them out; in0..in3: operand planes (n_planes_i, n_words); out:
// (n_outputs, n_words)
template <bool kXor>
__global__ void __launch_bounds__(kMaxWarps * 32)
circuit_kernel(const int* __restrict__ prog, int n_gates, int n_steps,
               int n_loads, int n_stores, int n_chunks, int chunk_cap,
               const uint32_t* __restrict__ in0,
               const uint32_t* __restrict__ in1,
               const uint32_t* __restrict__ in2,
               const uint32_t* __restrict__ in3,
               uint32_t* __restrict__ out, int n_words, int n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    int4* sg = reinterpret_cast<int4*>(smem);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int n_table = table_ints(n_steps, n_loads, n_stores, n_chunks);
    int* table = reinterpret_cast<int*>(smem + chunk_cap * kGateInts * 4);
    unsigned char* my = reinterpret_cast<unsigned char*>(table + n_table)
        + 8 * lane;
    const uint32_t my_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(my));
    const int4* gates = reinterpret_cast<const int4*>(prog);
    const int* steps = table;                       // in shared memory
    const int* loads = steps + 3 * (n_steps + 1);
    const int* stores = loads + 3 * n_loads;
    const int* chunks = stores + 3 * n_stores;

    if (warp == 0)                                  // slot 0: zeros
        *reinterpret_cast<uint2*>(my) = make_uint2(0u, 0u);
    const bool resident = n_chunks == 1;
    stage(reinterpret_cast<int4*>(table), gates + n_gates, n_table / 4);
    if (resident) stage(sg, gates, n_gates);

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long w0 = (long long)tile * kTileWords + 2 * lane;
        const bool ok0 = w0 < n_words, ok1 = w0 + 1 < n_words;
        for (int ch = 0; ch < n_chunks; ++ch) {
            const int s_begin = chunks[ch], s_end = chunks[ch + 1];
            const int g_base = steps[3 * s_begin];
            if (!resident)      // the last step's barrier freed the buffer
                stage(sg, gates + g_base, steps[3 * s_end] - g_base);
            // this step's first gate, load and store, and the next one's
            // (read a step ahead)
            int g0 = steps[3 * s_begin] - g_base;
            int l0 = steps[3 * s_begin + 1], o0 = steps[3 * s_begin + 2];
            int g1 = steps[3 * s_begin + 3] - g_base;
            int l1 = steps[3 * s_begin + 4], o1 = steps[3 * s_begin + 5];
            for (int s = s_begin; s < s_end; ++s) {
                const int* after =
                    steps + 3 * (s + 2 <= n_steps ? s + 2 : n_steps);
                const int g2 = after[0] - g_base, l2 = after[1];
                const int o2 = after[2];
                for (int i = l0 + warp; i < l1; i += n_warps) {
                    const int* ld = loads + 3 * i;
                    const uint32_t* src = (ld[0] == 0 ? in0 : ld[0] == 1 ? in1
                                           : ld[0] == 2 ? in2 : in3)
                        + (long long)ld[1] * n_words;
                    const uint32_t dst = my_s + ld[2];
                    cp_async4(dst, src + (ok0 ? w0 : 0), ok0 ? 4 : 0);
                    cp_async4(dst + 4, src + (ok1 ? w0 + 1 : 0), ok1 ? 4 : 0);
                }
                cp_async_commit();
                int g = g0 + warp;
                for (; g + (kBatch - 1) * n_warps < g1;
                     g += kBatch * n_warps)
                    run_gates<kXor, kBatch, false>(sg, my, g, n_warps, g1);
                for (; g < g1; g += 2 * n_warps)   // the last one to three
                    run_gates<kXor, 2, true>(sg, my, g, n_warps, g1);
                for (int i = o0 + warp; i < o1; i += n_warps) {
                    const int* st = stores + 3 * i;
                    uint32_t* dst = out + (long long)st[0] * n_words;
                    const uint2 v = slot(my, st[1]);
                    const uint32_t mask = st[2];
                    if (ok0) dst[w0] = v.x ^ mask;
                    if (ok1) dst[w0 + 1] = v.y ^ mask;
                }
                cp_async_wait<kAhead - 1>();
                __syncthreads();
                g0 = g1, l0 = l1, o0 = o1;
                g1 = g2, l1 = l2, o1 = o2;
            }
        }
    }
}

// blocks of one kernel configuration that fit on the current device at
// once; the shared-memory limit is raised once per kernel and device
std::mutex g_mutex;
std::map<std::tuple<int, int, int, long long>, int> g_fit;
bool g_raised[2][64];

cudaError_t blocks_that_fit(bool has_xor, int warps, long long smem,
                            int* fit) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(g_mutex);
    const auto key = std::make_tuple(dev, int(has_xor), warps, smem);
    const auto it = g_fit.find(key);
    if (it != g_fit.end()) {
        *fit = it->second;
        return cudaSuccess;
    }
    const void* fn = has_xor
        ? reinterpret_cast<const void*>(circuit_kernel<true>)
        : reinterpret_cast<const void*>(circuit_kernel<false>);
    if (!g_raised[has_xor][dev]) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
        if (err != cudaSuccess) return err;
        g_raised[has_xor][dev] = true;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, warps * 32, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *fit = g_fit[key] = per_sm * sms;
    return cudaSuccess;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int circuit_launch(const void* prog, int n_gates, int n_steps, int n_loads,
                   int n_stores, int n_chunks, int chunk_cap, int n_slots,
                   int warps, int has_xor, const void* in0, const void* in1,
                   const void* in2, const void* in3, void* out, int n_words,
                   void* stream) {
    if (n_words <= 0 || n_steps <= 0 || n_chunks <= 0 || n_slots <= 0 ||
        n_gates < 0 || n_loads < 0 || n_stores < 0 || chunk_cap < 0 ||
        warps < 1 || warps > kMaxWarps)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = (long long)chunk_cap * kGateInts * 4
        + 4LL * table_ints(n_steps, n_loads, n_stores, n_chunks)
        + (long long)n_slots * kSlotBytes;
    if (smem > kMaxSharedBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    int fit = 0;
    cudaError_t err = blocks_that_fit(has_xor != 0, warps, smem, &fit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int n_tiles = (n_words + kTileWords - 1) / kTileWords;
    const int blocks = n_tiles < fit ? n_tiles : fit;
    auto kernel = has_xor ? circuit_kernel<true> : circuit_kernel<false>;
    kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(prog), n_gates, n_steps, n_loads, n_stores,
        n_chunks, chunk_cap, static_cast<const uint32_t*>(in0),
        static_cast<const uint32_t*>(in1), static_cast<const uint32_t*>(in2),
        static_cast<const uint32_t*>(in3), static_cast<uint32_t*>(out),
        n_words, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
