// K5 with 8-byte command entries decoded in the replay loop: the design
// that src/repro_torch/csrc/replay.cu weighed and did not take, kept so
// that experiments/replay_probe.py can time it beside the kernel.
//
// Everything but the entries is replay.cu's (it is included whole): one
// block per 32 word columns of a unit, warp 0 replays with the rows in
// shared memory, a producer warp stages the table with cp.async three
// chunks ahead, each block stops at its unit's real command count, and
// the blocks go to units in decreasing order of it.  The producer packs
// each command into 8 bytes: six 8-bit row numbers and seven flag bits.
// Warp 0 reads the next command's entry before it runs the current one,
// then decodes the current one (shifts and masks), loads its three rows
// after the previous command's stores, one LOP3, and stores three rows.
//
// Build: nvcc <flags of kernels/build.py> -I src/repro_torch/csrc.

#include "replay.cu"

namespace {

// x = r0 | r1 << 8 | r2 << 16 | w0 << 24;
// y = w1 | w2 << 8 | n0 << 16 | n1 << 17 | n2 << 18 | nw0 << 19 |
//     nw1 << 20 | nw2 << 21.  An AAP's ports 1 and 2 repeat port 0.
__device__ __forceinline__ uint2 narrow(const int* c) {
    const bool ap = c[0] != 0;
    const int p1 = ap ? 3 : 1, p2 = ap ? 5 : 1;
    auto row = [](int r) { return static_cast<uint32_t>(r) & 0xFFu; };
    auto bit = [](int b) { return static_cast<uint32_t>(b) & 1u; };
    uint2 e;
    e.x = row(c[1]) | row(c[p1]) << 8 | row(c[p2]) << 16 | row(c[7]) << 24;
    e.y = row(c[9]) | row(c[11]) << 8 | bit(c[2]) << 16 |
          bit(c[p1 + 1]) << 17 | bit(c[p2 + 1]) << 18 | bit(c[8]) << 19 |
          bit(c[10]) << 20 | bit(c[12]) << 21;
    return e;
}

constexpr int kNarrowRingBytes = kRings * kChunk * 8;

__global__ void narrow_replay_kernel(const uint32_t* __restrict__ states,
                                     uint32_t* __restrict__ out,
                                     const int* __restrict__ tables,
                                     long long table_stride,
                                     const int* __restrict__ schedule,
                                     int n_units, int n_rows, int n_words,
                                     int n_cmds) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* rings = reinterpret_cast<uint2*>(smem);
    int* staged = reinterpret_cast<int*>(smem + kNarrowRingBytes);
    uint32_t* rows =
        reinterpret_cast<uint32_t*>(smem + kNarrowRingBytes + kStageBytes);
    const int n_producers = blockDim.x - kCols;
    const int unit = schedule[n_units + blockIdx.y];
    const int count = min(max(schedule[unit], 0), n_cmds);
    const int* table = tables + unit * table_stride;
    const int n_chunks = (count + kChunk - 1) / kChunk;
    const int lane = threadIdx.x % kCols;
    const int warp = threadIdx.x / kCols;
    const int t = threadIdx.x - kCols;
    const long long word = (long long)blockIdx.x * kCols + lane;
    const bool live = word < n_words;
    uint32_t* col = rows + lane;
    const long long base = (long long)unit * n_rows * n_words + word;
    auto chunk_size = [&](int c) { return min(kChunk, count - c * kChunk); };
    auto ring_of = [&](int c) { return rings + (c % kRings) * kChunk; };
    auto staged_of = [&](int c) { return staged + (c & 1) * kStageInts; };
    auto pack = [&](uint2* ring, const int* raw, int n) {
        for (int i = t; i < n; i += n_producers)
            ring[i] = narrow(raw + i * kCmdWidth);
    };

    if (warp == 0) {
        if (live)
            for (int r = 0; r < n_rows; ++r)
                cp_async4(col + r * kCols,
                          states + base + (long long)r * n_words);
        cp_async_commit();
        cp_async_wait<0>();
    } else {
        stage(staged_of(0), table, 0, chunk_size(0), t, n_producers);
        stage(staged_of(1), table, kChunk, chunk_size(1), t, n_producers);
        for (int v = t; v < kRings * kChunk; v += n_producers)
            rings[v] = make_uint2(0u, 0u);
        cp_async_wait<1>();
        producers_sync(n_producers);
        pack(ring_of(0), staged_of(0), chunk_size(0));
        cp_async_wait<0>();
        producers_sync(n_producers);
        stage(staged_of(2), table, 2 * kChunk, chunk_size(2), t,
              n_producers);
        pack(ring_of(1), staged_of(1), chunk_size(1));
    }
    __syncthreads();

    uint2 e = rings[0];                    // the command to run
    for (int k = 0; k < n_chunks; ++k) {
        if (warp > 0) {
            cp_async_wait<0>();
            producers_sync(n_producers);
            stage(staged_of(k + 3), table, (k + 3) * kChunk,
                  chunk_size(k + 3), t, n_producers);
            pack(ring_of(k + 2), staged_of(k + 2), chunk_size(k + 2));
        } else if (live) {
            const uint2* ring = ring_of(k);
            const int n = chunk_size(k);
            auto step = [&](uint2 next) {
                const uint32_t v0 = at(col, row_offset(e.x)) ^
                                    ones_if(static_cast<int>(e.y >> 16));
                const uint32_t v1 = at(col, row_offset(e.x >> 8)) ^
                                    ones_if(static_cast<int>(e.y >> 17));
                const uint32_t v2 = at(col, row_offset(e.x >> 16)) ^
                                    ones_if(static_cast<int>(e.y >> 18));
                const uint32_t val = maj(v0, v1, v2);
                put(col, row_offset(e.x >> 24),
                    val ^ ones_if(static_cast<int>(e.y >> 19)));
                put(col, row_offset(e.y),
                    val ^ ones_if(static_cast<int>(e.y >> 20)));
                put(col, row_offset(e.y >> 8),
                    val ^ ones_if(static_cast<int>(e.y >> 21)));
                e = next;
            };
            int i = 0;
#pragma unroll 3
            for (; i < n - 1; ++i) step(ring[i + 1]);
            if (i < n) step(ring_of(k + 1)[0]);
        }
        __syncthreads();
    }
    if (warp > 0 || !live) return;
    for (int r = 0; r < n_rows; ++r)
        out[base + (long long)r * n_words] = col[r * kCols];
}

}  // namespace

extern "C" int narrow_replay_launch(const void* states, void* out,
                                    const void* tables,
                                    long long table_stride,
                                    const void* schedule, int n_units,
                                    int n_rows, int n_words, int n_cmds,
                                    void* stream) {
    if (n_units <= 0 || n_units > 65535 || n_rows <= 0 ||
        n_rows > kMaxRows || n_words <= 0 || n_cmds < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kNarrowRingBytes + kStageBytes + n_rows * kCols * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        narrow_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_words + kCols - 1) / kCols, n_units);
    narrow_replay_kernel<<<grid, 2 * kCols, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(states), static_cast<uint32_t*>(out),
        static_cast<const int*>(tables), table_stride,
        static_cast<const int*>(schedule), n_units, n_rows, n_words,
        n_cmds);
    return static_cast<int>(cudaGetLastError());
}
