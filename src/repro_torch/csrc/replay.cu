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
// Command word (13 x int32): [is_ap, r0, n0, r1, n1, r2, n2, w0, nw0,
// w1, nw1, w2, nw2].  A port with n = 1 reads and writes the complement.
// AP writes MAJ of the three reads, AAP writes the first read; all three
// ports are read before w0, w1, w2 are written in that order, as in the
// reference.  An all-zero word is a NOP (row 0 copied onto itself).
// Rows are below n_rows <= 256 and flags are 0 or 1 (the wrappers check
// host tables; device tables are trusted).
//
// What bounds it.  Each command is a dependent chain per word column:
// read three state rows, one majority, write three rows, and the next
// command may read what this one wrote.  Here a row the previous command
// wrote comes from registers, so the serial part is two bitwise ops; a
// command's other rows are loaded from shared memory a command ahead.
// What is left is the replay warp's own instruction stream (entry loads,
// row loads and stores, address and mask arithmetic): one warp starts at
// most one instruction a cycle, so a unit's replay takes at least its
// real command count times the loop's instructions per command
// (experiments/replay_probe.py counts them in the SASS), whatever the
// card's bandwidth; the bytes bound is far below that.  K6 adds 8
// Philox4x32-10 calls per word and AP command (547 integer operations,
// the 64-bit multiplies the dearest), which no state feeds: over a wave
// they are bound by the card's integer rate, and on the longest units by
// the instruction rate of the warps that draw them.
//
// Design, shared by both (one template body; the fault hooks compile
// away in K5):
// - A block owns 32 word columns of one unit.  Warp 0 replays, one lane
//   per column, with the columns' state rows in shared memory (row r of
//   a lane's column at col[r * 32], so a warp touches 32 banks), copied
//   in by cp.async and stored once.  Small blocks spread the longest
//   units' columns over every SM.
// - Each block stops at its unit's real command count (schedule row 0:
//   the index of the last non-NOP command + 1).  Trailing NOPs are the
//   identity in K5 and in K6 (an AAP draws no random bits, row 0 is
//   already stuck-masked, and the Philox counter is the command's index),
//   so the states and flip counts are those of the padded table.
// - Blocks go to units in decreasing order of real command count
//   (schedule row 1, worked out with the counts once per table), so the
//   longest units' blocks start first.
// - The table reaches the chain through shared memory only, and warp 0
//   never waits for it.  Producer warps copy commands asynchronously
//   (cp.async, 4 bytes each, since a unit's table need not be 16-byte
//   aligned) in chunks of kChunk, three chunks ahead, and decode each
//   chunk once into one of three rings of 80-byte entries: row byte
//   offsets and XOR masks ready to use (an AAP's three read ports become
//   its first, so MAJ of the reads is its value and the chain needs no
//   select).  Warp 0 replays chunk k while they pack chunk k + 2; one
//   block barrier per chunk.
// - Warp 0 reads each entry by broadcast two commands ahead (a chunk's
//   last two commands read the next ring's first entries) and loads a
//   command's rows before the previous command stores.  A row that the
//   previous command wrote comes from registers instead (the entry
//   marks such ports), so the serial chain per command is two bitwise
//   ops and the shared-memory round trip is off it.
// - K6, when the flip masks need random bits: three producer warps also
//   draw the masks of chunk k + 1's APs (8 independent Philox calls per
//   mask, dealt out an AP at a time) into a shared ring while warp 0
//   replays chunk k, so the Philox work runs beside the chain and
//   spreads over the whole card.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                  // word columns per block (a warp)
constexpr int kDrawers = 3;                // K6: producer warps with Philox
constexpr int kMaxRows = 256;
constexpr int kMaxSharedBytes = 232448;    // 227 KB per block on sm_90
constexpr int kCmdWidth = 13;
constexpr int kChunk = 64;                 // commands per staged chunk
// A command in a ring: five uint4 (see Op).  Three rings hold the chunk
// being replayed, the next one and the one being packed.
constexpr int kOpVecs = 5;
constexpr int kRingVecs = kChunk * kOpVecs;
constexpr int kRings = 3;
constexpr int kRingBytes = kRings * kRingVecs * 16;
constexpr int kStageInts = kChunk * kCmdWidth;
constexpr int kStageBytes = 2 * kStageInts * 4;
constexpr int kMaskBytes = 2 * kChunk * kCols * 4;   // K6 with producers
constexpr int kHeadBytes = kRingBytes + kStageBytes;
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

// The flip mask of AP command cmd on a word, for 0 < thr < 2^32: 8
// independent Philox calls, which keep a warp's multiplier busy.
__device__ __forceinline__ uint32_t flip_mask(uint32_t word, uint32_t cmd,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t thr) {
    uint32_t mask = 0u;
#pragma unroll
    for (int call = 0; call < kFlipCalls; ++call) {
        const U4 u = philox4x32_10(word, cmd, kStreamFlip, call, k0, k1);
#pragma unroll
        for (int l = 0; l < 4; ++l)
            mask |= static_cast<uint32_t>(u.x[l] < thr) << (4 * call + l);
    }
    return mask;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The producer warps' own barrier (warp 0 replays meanwhile).
__device__ __forceinline__ void producers_sync(int n_threads) {
    asm volatile("bar.sync 1, %0;" :: "r"(n_threads) : "memory");
}

// Start copying commands [first, first + n) of a table into a staging
// buffer, as one cp.async group (an empty one when n <= 0); thread t of
// n_threads copies every n_threads-th word.
__device__ __forceinline__ void stage(int* buf, const int* table, int first,
                                      int n, int t, int n_threads) {
    const int* src = table + static_cast<long long>(first) * kCmdWidth;
    for (int i = t; i < n * kCmdWidth; i += n_threads)
        cp_async4(buf + i, src + i);
    cp_async_commit();
}

__device__ __forceinline__ uint32_t row_offset(int r) {
    return static_cast<uint32_t>(r & 0xFF) * (kCols * 4);
}

__device__ __forceinline__ uint32_t ones_if(int flag) {
    return 0u - static_cast<uint32_t>(flag & 1);
}

// A ring entry, five uint4:
//   {r0, r1, r2, w0} {w1, w2, mw0, mw1} {mw2, f0, f1, f2} {g0, g1, g2, is_ap}
//   {x0, x1, x2, 0}
// r and w are the rows as byte offsets from a lane's column, m and mw
// the ports' negations as XOR masks (0 or all ones).  An AAP reads port
// 0 three times, so MAJ of its reads is the value it writes and the
// chain needs no select.  f_i is all ones when read port i reads a row
// that the previous command wrote: the replay loads a command's rows
// before the previous command stores, so that value comes from
// registers.  x_i is then the negation of the last port that wrote the
// row (0 otherwise), and g_i = x_i ^ m_i turns the previous command's
// value into this port's.  K5 reads the first four vectors only.
struct Op {
    uint32_t r[3], w[3], m[3], mw[3], f[3], x[3], g[3], ap;
};

__device__ __forceinline__ Op decode(const int* c) {
    Op op;
    op.ap = c[0] != 0;
    const int p1 = op.ap ? 3 : 1, p2 = op.ap ? 5 : 1;
    const int port[3] = {1, p1, p2};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        op.r[i] = row_offset(c[port[i]]);
        op.m[i] = ones_if(c[port[i] + 1]);
        op.w[i] = row_offset(c[7 + 2 * i]);
        op.mw[i] = ones_if(c[8 + 2 * i]);
    }
    return op;
}

// Fill in op's forwarding from the previous command's writes (w, mw).
__device__ __forceinline__ void forward(Op& op, const uint32_t* w,
                                        const uint32_t* mw) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        op.f[i] = op.x[i] = 0u;
        for (int k = 0; k < 3; ++k) {      // the last write wins
            if (w[k] == op.r[i]) {
                op.f[i] = 0xFFFFFFFFu;
                op.x[i] = mw[k];
            }
        }
        op.g[i] = op.x[i] ^ op.m[i];
    }
}

__device__ __forceinline__ void store(uint4* e, const Op& op) {
    e[0] = make_uint4(op.r[0], op.r[1], op.r[2], op.w[0]);
    e[1] = make_uint4(op.w[1], op.w[2], op.mw[0], op.mw[1]);
    e[2] = make_uint4(op.mw[2], op.f[0], op.f[1], op.f[2]);
    e[3] = make_uint4(op.g[0], op.g[1], op.g[2], op.ap);
    e[4] = make_uint4(op.x[0], op.x[1], op.x[2], 0u);
}

// Decode n staged commands into a ring.  ``prev`` is the ring entry of
// the command before the first (nullptr at the table's start).
__device__ __forceinline__ void pack(uint4* ring, const int* raw, int n,
                                     const uint4* prev, int t,
                                     int n_threads) {
    for (int i = t; i < n; i += n_threads) {
        Op op = decode(raw + i * kCmdWidth);
        if (i > 0) {
            const Op before = decode(raw + (i - 1) * kCmdWidth);
            forward(op, before.w, before.mw);
        } else if (prev != nullptr) {
            const uint32_t w[3] = {prev[0].w, prev[1].x, prev[1].y};
            const uint32_t mw[3] = {prev[1].z, prev[1].w, prev[2].x};
            forward(op, w, mw);
        } else {
            const uint32_t none[3] = {~0u, ~0u, ~0u};
            forward(op, none, none);
        }
        store(ring + kOpVecs * i, op);
    }
}

// K6's producer warps: the flip masks of a ring's AP commands for the
// block's columns, the APs dealt out in turn over the drawers.
__device__ __forceinline__ void draw_masks(uint32_t* masks, const uint4* ring,
                                           int n, int first, int drawer,
                                           int lane, uint32_t word,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t thr) {
    int rank = 0;
    for (int i = 0; i < n; ++i) {
        if (!ring[kOpVecs * i + 3].w) continue;
        if (rank++ % kDrawers == drawer)
            masks[i * kCols + lane] = flip_mask(word, first + i, k0, k1, thr);
    }
}

__device__ __forceinline__ uint32_t at(const uint32_t* col, uint32_t off) {
    return *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const char*>(col) + off);
}

__device__ __forceinline__ void put(uint32_t* col, uint32_t off,
                                    uint32_t v) {
    *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(col) + off) = v;
}

__device__ __forceinline__ uint32_t pick(uint32_t mask, uint32_t a,
                                         uint32_t b) {
    return (a & mask) | (b & ~mask);       // a where mask is set, else b
}

__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;                            // one LOP3
    asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
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
        const int* __restrict__ schedule, const Fault& f, int n_units,
        int n_rows, int n_words, int n_cmds) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* rings = reinterpret_cast<uint4*>(smem);
    int* staged = reinterpret_cast<int*>(smem + kRingBytes);
    // warp 0 replays; the producer warps stage and pack the table and,
    // in K6 when the flip masks need random bits, draw them
    const int n_producers = blockDim.x - kCols;
    const bool drawn = kFault && n_producers == kDrawers * kCols;
    uint32_t* masks = reinterpret_cast<uint32_t*>(smem + kHeadBytes);
    uint32_t* rows = reinterpret_cast<uint32_t*>(
        smem + kHeadBytes + (drawn ? kMaskBytes : 0));

    const int unit = schedule[n_units + blockIdx.y];
    const int count = min(max(schedule[unit], 0), n_cmds);
    const int* table = tables + unit * table_stride;
    const int n_chunks = (count + kChunk - 1) / kChunk;
    const int lane = threadIdx.x % kCols;
    const int warp = threadIdx.x / kCols;
    const int t = threadIdx.x - kCols;     // a producer's index
    const long long word = (long long)blockIdx.x * kCols + lane;
    const bool live = word < n_words;      // a ragged block's spare lanes
    uint32_t* col = rows + lane;           // row r lives at col[r * kCols]
    const long long base = (long long)unit * n_rows * n_words + word;
    auto chunk_size = [&](int c) { return min(kChunk, count - c * kChunk); };
    auto ring_of = [&](int c) { return rings + (c % kRings) * kRingVecs; };
    auto staged_of = [&](int c) { return staged + (c & 1) * kStageInts; };

    uint32_t s0 = 0u, s1 = 0u, k0 = 0u, k1 = 0u;
    if (kFault) {
        k0 = f.keys[2 * unit];
        k1 = f.keys[2 * unit + 1];
        if (live) {
            s0 = f.stuck0[(long long)unit * n_words + word];
            s1 = f.stuck1[(long long)unit * n_words + word];
        }
    }
    // without random bits every AP flips nothing, or every bit
    const uint32_t fixed_flip = f.thr >= (1ull << 32) ? 0xFFFFFFFFu : 0u;
    const uint32_t thr = static_cast<uint32_t>(f.thr);

    if (warp == 0) {                       // the state rows
        if (live)
            for (int r = 0; r < n_rows; ++r)
                cp_async4(col + r * kCols,
                          states + base + (long long)r * n_words);
        cp_async_commit();
        cp_async_wait<0>();
        if (kFault && live)
            for (int r = 0; r < n_rows; ++r)
                col[r * kCols] = (col[r * kCols] | s1) & ~s0;
    } else {                               // chunks 0 and 1 packed, 2 staged
        stage(staged_of(0), table, 0, chunk_size(0), t, n_producers);
        stage(staged_of(1), table, kChunk, chunk_size(1), t, n_producers);
        // the replay reads up to two entries past its unit's last command:
        // zeros (row 0) where no command was ever packed
        for (int v = t; v < kRings * kRingVecs; v += n_producers)
            rings[v] = make_uint4(0u, 0u, 0u, 0u);
        cp_async_wait<1>();
        producers_sync(n_producers);
        pack(ring_of(0), staged_of(0), chunk_size(0), nullptr, t,
             n_producers);
        cp_async_wait<0>();
        producers_sync(n_producers);
        stage(staged_of(2), table, 2 * kChunk, chunk_size(2), t,
              n_producers);
        pack(ring_of(1), staged_of(1), chunk_size(1),
             ring_of(0) + kOpVecs * (chunk_size(0) - 1), t, n_producers);
        if (drawn && live)
            draw_masks(masks, ring_of(0), chunk_size(0), 0, warp - 1, lane,
                       static_cast<uint32_t>(word), k0, k1, thr);
    }
    __syncthreads();

    // warp 0 carries, from one command to the next, the entries of the
    // command to run (q) and of the next (p), the command's three rows
    // (loaded before the previous command's stores), and the previous
    // command's value as stored through a port that does not complement
    // it (u) and one that does (ubar)
    uint4 q0 = rings[0], q1 = rings[1], q2 = rings[2], q3 = rings[3];
    uint4 q4 = kFault ? rings[4] : make_uint4(0u, 0u, 0u, 0u);
    uint32_t l0 = at(col, q0.x), l1 = at(col, q0.y), l2 = at(col, q0.z);
    uint4 p0 = rings[5], p1 = rings[6], p2 = rings[7], p3 = rings[8];
    uint4 p4 = kFault ? rings[9] : make_uint4(0u, 0u, 0u, 0u);
    uint32_t u = 0u, ubar = 0u;
    uint32_t n_flips = 0;                  // at most 32 per AP: 2^20 in all
    // phase k: warp 0 replays chunk k while the producers pack chunk
    // k + 2 (whose copy landed), start copying chunk k + 3 and draw the
    // masks of chunk k + 1; one block barrier ends the phase
    for (int k = 0; k < n_chunks; ++k) {
        if (warp > 0) {
            cp_async_wait<0>();
            producers_sync(n_producers);   // chunk k + 2 staged
            stage(staged_of(k + 3), table, (k + 3) * kChunk,
                  chunk_size(k + 3), t, n_producers);
            pack(ring_of(k + 2), staged_of(k + 2), chunk_size(k + 2),
                 ring_of(k + 1) + kOpVecs * (chunk_size(k + 1) - 1), t,
                 n_producers);
            if (drawn && live && k + 1 < n_chunks)
                draw_masks(masks + ((k + 1) & 1) * kChunk * kCols,
                           ring_of(k + 1), chunk_size(k + 1),
                           (k + 1) * kChunk, warp - 1, lane,
                           static_cast<uint32_t>(word), k0, k1, thr);
        } else if (live) {
            const uint4* ring = ring_of(k);
            const uint32_t* mask = masks + (k & 1) * kChunk * kCols + lane;
            const int n = chunk_size(k);
            // command i of the chunk, given the entry two commands ahead;
            // the next command's rows are loaded before this one stores
            auto step = [&](int i, const uint4* e) {
                const uint4 n0 = e[0], n1 = e[1], n2 = e[2], n3 = e[3];
                const uint4 n4 = kFault ? e[4] : make_uint4(0u, 0u, 0u, 0u);
                const uint32_t nl0 = at(col, p0.x), nl1 = at(col, p0.y),
                               nl2 = at(col, p0.z);
                // a port's value: the row it loaded, or where f is set
                // the previous command's value as stored (through a port
                // complementing it where x is set), then complemented
                // where the port is (m = g ^ x)
                uint32_t v0, v1, v2;
                if (kFault) {
                    v0 = pick(q2.y, pick(q4.x, ubar, u), l0) ^ q3.x ^ q4.x;
                    v1 = pick(q2.z, pick(q4.y, ubar, u), l1) ^ q3.y ^ q4.y;
                    v2 = pick(q2.w, pick(q4.z, ubar, u), l2) ^ q3.z ^ q4.z;
                } else {                   // u stored as is, so g suffices
                    const uint32_t z0 = (l0 & ~q2.y) ^ q3.x;
                    const uint32_t z1 = (l1 & ~q2.z) ^ q3.y;
                    const uint32_t z2 = (l2 & ~q2.w) ^ q3.z;
                    v0 = (u & q2.y) ^ z0;  // one op after u
                    v1 = (u & q2.z) ^ z1;
                    v2 = (u & q2.w) ^ z2;
                }
                uint32_t flip = 0u;
                if (kFault && q3.w) {
                    flip = drawn ? mask[i * kCols] : fixed_flip;
                    n_flips += __popc(flip);
                }
                const uint32_t val = maj(v0, v1, v2) ^ flip;
                u = kFault ? (val | s1) & ~s0 : val;
                ubar = kFault ? (~val | s1) & ~s0 : ~val;
                put(col, q0.w, pick(q1.z, ubar, u));
                put(col, q1.x, pick(q1.w, ubar, u));
                put(col, q1.y, pick(q2.x, ubar, u));
                q0 = p0;
                q1 = p1;
                q2 = p2;
                q3 = p3;
                q4 = p4;
                p0 = n0;
                p1 = n1;
                p2 = n2;
                p3 = n3;
                p4 = n4;
                l0 = nl0;
                l1 = nl1;
                l2 = nl2;
            };
            int i = 0;
#pragma unroll 3
            for (; i < n - 2; ++i) step(i, ring + kOpVecs * (i + 2));
            // the last two read ahead into the next ring, packed a phase
            // ago (or holding no command, after the unit's last)
            const uint4* next = ring_of(k + 1);
            for (; i < n; ++i) step(i, next + kOpVecs * (i + 2 - n));
        }
        __syncthreads();
    }
    if (warp > 0 || !live) return;         // no barriers below

    if (kFault && f.dead[unit]) {
        for (int q = 0; q < n_rows; q += 4) {
            const U4 g = philox4x32_10(static_cast<uint32_t>(word), q >> 2,
                                       kStreamDead, 0, k0, k1);
            for (int l = 0; l < 4 && q + l < n_rows; ++l)
                col[(q + l) * kCols] ^= g.x[l];
        }
    }
    for (int r = 0; r < n_rows; ++r)
        out[base + (long long)r * n_words] = col[r * kCols];
    if (kFault && n_flips)
        atomicAdd(f.counts + unit, static_cast<unsigned long long>(n_flips));
}

// Two names, so that a profile tells K5 from K6.
__global__ void replay_kernel(const uint32_t* __restrict__ states,
                              uint32_t* __restrict__ out,
                              const int* __restrict__ tables,
                              long long table_stride,
                              const int* __restrict__ schedule, Fault f,
                              int n_units, int n_rows, int n_words,
                              int n_cmds) {
    replay_body<false>(states, out, tables, table_stride, schedule, f,
                       n_units, n_rows, n_words, n_cmds);
}

__global__ void faulty_replay_kernel(const uint32_t* __restrict__ states,
                                     uint32_t* __restrict__ out,
                                     const int* __restrict__ tables,
                                     long long table_stride,
                                     const int* __restrict__ schedule,
                                     Fault f, int n_units, int n_rows,
                                     int n_words, int n_cmds) {
    replay_body<true>(states, out, tables, table_stride, schedule, f,
                      n_units, n_rows, n_words, n_cmds);
}

using Kernel = void (*)(const uint32_t*, uint32_t*, const int*, long long,
                        const int*, Fault, int, int, int, int);

// One block per 32 word columns of a unit: warp 0 replays, one producer
// warp stages and packs the table, or kDrawers in K6 when the flip masks
// need random bits.
int launch(Kernel kernel, bool drawn, const void* states, void* out,
           const void* tables, long long table_stride, const void* schedule,
           const Fault& f, int n_units, int n_rows, int n_words, int n_cmds,
           void* stream) {
    if (n_units <= 0 || n_units > 65535 || n_rows <= 0 ||
        n_rows > kMaxRows || n_words <= 0 || n_cmds < 0 ||
        f.thr > (1ull << 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = kCols * (1 + (drawn ? kDrawers : 1));
    const int smem = kHeadBytes + (drawn ? kMaskBytes : 0) +
                     n_rows * kCols * 4;
    if (smem > kMaxSharedBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_words + kCols - 1) / kCols, n_units);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(states), static_cast<uint32_t*>(out),
        static_cast<const int*>(tables), table_stride,
        static_cast<const int*>(schedule), f, n_units, n_rows, n_words,
        n_cmds);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5.  states, out: (n_units, n_rows <= 256, n_words); tables: n_units
// tables of (n_cmds, 13) at table_stride ints apart (0 = one shared
// table); schedule: (2, n_units) int32, row 0 each unit's real command
// count, row 1 the units in decreasing order of it (a permutation)
int replay_launch(const void* states, void* out, const void* tables,
                  long long table_stride, const void* schedule, int n_units,
                  int n_rows, int n_words, int n_cmds, void* stream) {
    const Fault none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0ull};
    return launch(replay_kernel, false, states, out, tables, table_stride,
                  schedule, none, n_units, n_rows, n_words, n_cmds, stream);
}

// K6.  As K5, plus keys: (n_units, 2); stuck0, stuck1: (n_units,
// n_words); dead: (n_units,) bytes; counts: (n_units,) 64-bit, zeroed by
// the caller; thr: the flip threshold, at most 2^32
int faulty_replay_launch(const void* states, void* out, const void* tables,
                         long long table_stride, const void* schedule,
                         const void* keys, const void* stuck0,
                         const void* stuck1, const void* dead, void* counts,
                         unsigned long long thr, int n_units, int n_rows,
                         int n_words, int n_cmds, void* stream) {
    const Fault f = {static_cast<const uint32_t*>(keys),
                     static_cast<const uint32_t*>(stuck0),
                     static_cast<const uint32_t*>(stuck1),
                     static_cast<const unsigned char*>(dead),
                     static_cast<unsigned long long*>(counts), thr};
    return launch(faulty_replay_kernel, thr > 0 && thr < (1ull << 32),
                  states, out, tables, table_stride, schedule, f, n_units,
                  n_rows, n_words, n_cmds, stream);
}

}  // extern "C"
