// K5 and K6: the control unit's command-table replay over subarray
// states, without and with fault injection.
//
// K5 replaces the lax.scan of _step in src/repro/core/control_unit.py
// (run_command_table, batched_interpreter, hetero_batched_interpreter).
// That loop is not Pallas, but in PyTorch a loop over commands would
// launch one tiny op per command, and a table holds up to 32768 of them.
//
// K6 replaces faulty_bank_replay of the same file (a vmapped lax.scan
// that weaves the paper's section 5 failure modes into the replay): a
// Bernoulli(p) bit mask XORed into every AP result, stuck-at-0/1 column
// masks forced on the initial state and on every write, per-unit counts
// of the injected flips, and random garbage XORed over dead units after
// the last command.
//
// Design, shared by both: the grid is (word tiles, units) with one
// thread per word column.  A block loads its columns' state rows into
// shared memory once (up to 256 rows x 128 columns x 4 B = 128 KB),
// replays every command on them and stores them once, so device memory
// sees the state twice no matter how long the table is.  Each block
// reads its own unit's table (units * table_stride ints in), which covers
// hetero waves; a table_stride of 0 shares one table across units.
// Threads never share a column, so the loop needs no barriers.  One
// template body serves both kernels; its fault hooks compile away in K5.
//
// Command word (13 x int32): [is_ap, r0, n0, r1, n1, r2, n2, w0, nw0,
// w1, nw1, w2, nw2].  A port with n = 1 reads and writes the complement.
// AP writes MAJ of the three reads, AAP writes the first read; all three
// ports are read before w0, w1, w2 are written in that order, as in the
// reference.  An all-zero word is a NOP (row 0 copied onto itself).
//
// K6's random bits: jax.random cannot be reproduced, so every random word
// is Philox4x32-10 (the Random123 reference) keyed by the unit's two key
// words, with the counter (word, command, stream, call); stream 0 is
// flips, stream 1 dead-unit garbage.  A flip mask takes 8 calls per word
// per AP command: output lane l of call c is the uniform of bit 4c + l,
// which is set when the uniform is below thr = round(p * 2^32).  Garbage
// word (row, word) is output lane row & 3 of the call with counter
// (word, row >> 2, 1, 0).  repro_torch.core.control_unit's plain version
// computes the same bits.  thr == 0 and thr == 2^32 need no random bits
// (nothing flips, or everything does), and AAP commands draw none.  The
// thread keeps its column's two stuck masks and its flip count in
// registers and adds the count to its unit's with one atomic at the end.
//
// Bound on an H100: K5 is bound by bytes for short tables and by bitwise
// operations for long ones.  The bytes are each state word read once and
// written once plus each table read once; the operations are one LOP3 per
// majority and per complemented port value, per command and word.  K6
// reads and writes K5's bytes plus the keys and masks, and is bound by
// integer operations whenever p is strictly between 0 and 1: per word
// and AP command, 8 Philox calls of 10 rounds of 4 multiplies (high and
// low halves of two products) and two 3-input XORs (one LOP3 each), plus
// a compare and an OR per uniform, plus the XOR, popcount and count
// addition of the mask: 8 x 68 + 3 = 547 operations.  The key schedule
// (18 additions) is needed once per thread.  Rate: 64 per clock per SM x
// 132 SMs x 1.98 GHz = 16.7 T/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxSharedBytes = 232448;   // 227 KB per block on sm_90
constexpr int kCmdWidth = 13;
constexpr int kFlipCalls = 8;
constexpr uint32_t kStreamFlip = 0, kStreamDead = 1;

struct U4 {
    uint32_t x[4];
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
        const uint32_t lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
        const uint32_t lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    U4 out;
    out.x[0] = c0;
    out.x[1] = c1;
    out.x[2] = c2;
    out.x[3] = c3;
    return out;
}

__device__ __forceinline__ uint32_t flip_mask(uint32_t word, uint32_t cmd,
                                              uint32_t k0, uint32_t k1,
                                              unsigned long long thr) {
    if (thr == 0ull) return 0u;
    if (thr >= (1ull << 32)) return 0xFFFFFFFFu;
    const uint32_t t = static_cast<uint32_t>(thr);
    uint32_t mask = 0u;
#pragma unroll
    for (int call = 0; call < kFlipCalls; ++call) {
        const U4 u = philox4x32_10(word, cmd, kStreamFlip, call, k0, k1);
#pragma unroll
        for (int l = 0; l < 4; ++l)
            mask |= static_cast<uint32_t>(u.x[l] < t) << (4 * call + l);
    }
    return mask;
}

// The fault arguments (keys .. thr) are unused when kFault is false.
struct Fault {
    const uint32_t* keys;          // (n_units, 2)
    const uint32_t* stuck0;        // (n_units, n_words)
    const uint32_t* stuck1;        // (n_units, n_words)
    const unsigned char* dead;     // (n_units,)
    unsigned long long* counts;    // (n_units,)
    unsigned long long thr;
};

template <bool kFault>
__device__ __forceinline__ void replay_body(
        const uint32_t* __restrict__ states, uint32_t* __restrict__ out,
        const int* __restrict__ tables, long long table_stride,
        const Fault& f, int n_rows, int n_words, int n_cmds) {
    extern __shared__ uint32_t rows[];
    const long long word = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (word >= n_words) return;         // no barriers below
    const int unit = blockIdx.y;
    const int stride = blockDim.x;
    uint32_t* col = rows + threadIdx.x;  // row r lives at col[r * stride]
    const long long base = (long long)unit * n_rows * n_words + word;
    uint32_t s0 = 0u, s1 = 0u, k0 = 0u, k1 = 0u;
    if (kFault) {
        s0 = f.stuck0[(long long)unit * n_words + word];
        s1 = f.stuck1[(long long)unit * n_words + word];
        k0 = f.keys[2 * unit];
        k1 = f.keys[2 * unit + 1];
    }
    for (int r = 0; r < n_rows; ++r) {
        const uint32_t v = states[base + (long long)r * n_words];
        col[r * stride] = kFault ? (v | s1) & ~s0 : v;
    }

    unsigned long long n_flips = 0;
    const int* cmd = tables + unit * table_stride;
    for (int c = 0; c < n_cmds; ++c, cmd += kCmdWidth) {
        const int is_ap = __ldg(cmd + 0);
        const uint32_t v0 = col[__ldg(cmd + 1) * stride] ^ (0u - __ldg(cmd + 2));
        const uint32_t v1 = col[__ldg(cmd + 3) * stride] ^ (0u - __ldg(cmd + 4));
        const uint32_t v2 = col[__ldg(cmd + 5) * stride] ^ (0u - __ldg(cmd + 6));
        uint32_t val = is_ap ? ((v0 & v1) | (v0 & v2) | (v1 & v2)) : v0;
        if (kFault && is_ap) {
            const uint32_t flip = flip_mask(static_cast<uint32_t>(word), c,
                                            k0, k1, f.thr);
            val ^= flip;
            n_flips += __popc(flip);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const uint32_t w = val ^ (0u - __ldg(cmd + 8 + 2 * p));
            col[__ldg(cmd + 7 + 2 * p) * stride] = kFault ? (w | s1) & ~s0 : w;
        }
    }

    if (kFault && f.dead[unit]) {
        for (int q = 0; q < n_rows; q += 4) {
            const U4 g = philox4x32_10(static_cast<uint32_t>(word), q >> 2,
                                       kStreamDead, 0, k0, k1);
            for (int l = 0; l < 4 && q + l < n_rows; ++l)
                col[(q + l) * stride] ^= g.x[l];
        }
    }
    for (int r = 0; r < n_rows; ++r)
        out[base + (long long)r * n_words] = col[r * stride];
    if (kFault && n_flips) atomicAdd(f.counts + unit, n_flips);
}

// Two names, so that a profile tells K5 from K6.
__global__ void replay_kernel(const uint32_t* __restrict__ states,
                              uint32_t* __restrict__ out,
                              const int* __restrict__ tables,
                              long long table_stride, Fault f, int n_rows,
                              int n_words, int n_cmds) {
    replay_body<false>(states, out, tables, table_stride, f, n_rows,
                       n_words, n_cmds);
}

__global__ void faulty_replay_kernel(const uint32_t* __restrict__ states,
                                     uint32_t* __restrict__ out,
                                     const int* __restrict__ tables,
                                     long long table_stride, Fault f,
                                     int n_rows, int n_words, int n_cmds) {
    replay_body<true>(states, out, tables, table_stride, f, n_rows,
                      n_words, n_cmds);
}

using Kernel = void (*)(const uint32_t*, uint32_t*, const int*, long long,
                        Fault, int, int, int);

int launch(Kernel kernel, const void* states, void* out, const void* tables,
           long long table_stride, const Fault& f, int n_units, int n_rows,
           int n_words, int n_cmds, void* stream) {
    if (n_units <= 0 || n_units > 65535 || n_rows <= 0 || n_words <= 0 ||
        n_cmds < 0 || f.thr > (1ull << 32))
        return static_cast<int>(cudaErrorInvalidValue);
    int threads = kMaxThreads;
    while (threads > 32 && (long long)n_rows * threads * 4 > kMaxSharedBytes)
        threads /= 2;
    const long long smem = (long long)n_rows * threads * 4;
    if (smem > kMaxSharedBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_words + threads - 1) / threads, n_units);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(states), static_cast<uint32_t*>(out),
        static_cast<const int*>(tables), table_stride, f, n_rows, n_words,
        n_cmds);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5.  states, out: (n_units, n_rows, n_words); tables: n_units tables
// of (n_cmds, 13) at table_stride ints apart (0 = one shared table)
int replay_launch(const void* states, void* out, const void* tables,
                  long long table_stride, int n_units, int n_rows,
                  int n_words, int n_cmds, void* stream) {
    const Fault none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0ull};
    return launch(replay_kernel, states, out, tables, table_stride, none,
                  n_units, n_rows, n_words, n_cmds, stream);
}

// K6.  As K5, plus keys: (n_units, 2); stuck0, stuck1: (n_units,
// n_words); dead: (n_units,) bytes; counts: (n_units,) 64-bit, zeroed by
// the caller; thr: the flip threshold, at most 2^32
int faulty_replay_launch(const void* states, void* out, const void* tables,
                         long long table_stride, const void* keys,
                         const void* stuck0, const void* stuck1,
                         const void* dead, void* counts,
                         unsigned long long thr, int n_units, int n_rows,
                         int n_words, int n_cmds, void* stream) {
    const Fault f = {static_cast<const uint32_t*>(keys),
                     static_cast<const uint32_t*>(stuck0),
                     static_cast<const uint32_t*>(stuck1),
                     static_cast<const unsigned char*>(dead),
                     static_cast<unsigned long long*>(counts), thr};
    return launch(faulty_replay_kernel, states, out, tables, table_stride, f,
                  n_units, n_rows, n_words, n_cmds, stream);
}

}  // extern "C"
