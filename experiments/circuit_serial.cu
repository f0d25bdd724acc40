// The serial design of K3, kept to be timed beside csrc/circuit.cu by
// experiments/circuit_probe.py (which also holds its host lowering).
//
// Replaces the Pallas kernel circuit_on_planes of
// src/repro/kernels/bitplane_ops.py, whose body is generated per circuit
// (Circuit.evaluate_outputs unrolled into straight-line bitwise code).
//
// Bound on an H100: bitwise operations for the wide circuits
// (multiplication, division), bytes for the narrow ones.  The bytes are
// each operand plane word read once and each output plane word written
// once; the operations are one 32-bit LOP3 per NOT/AND/OR/XOR/MAJ node
// per word, at 64 per clock per SM.
//
// Design: one generic kernel serves every op and width.  The host lowers
// a circuit to a straight-line program over "slots" (serial_program in
// experiments/circuit_probe.py), reusing slots by liveness, so a 16-bit
// multiplication needs 76 slots instead of thousands of nodes.
// One thread owns one uint32 word (32 SIMD lanes) and keeps its slot
// file in dynamic shared memory, laid out slot-major so that the threads
// of a warp touch 32 consecutive banks.  Code generated per circuit would
// compile sources that are not in the repository and would spill
// registers on the wide circuits.
//
// Instruction word (int4): x = opcode | dst << 8, y = a, z = b, w = c.
//   IN   slot[dst] = in[a][word]        OUT  out[dst][word] = slot[a]
//   C0   slot[dst] = 0                  C1   slot[dst] = ~0
//   NOT  slot[dst] = ~slot[a]           AND/OR/XOR  slot[a] op slot[b]
//   MAJ  slot[dst] = maj(slot[a], slot[b], slot[c])
// All operands are read before dst is written, so dst may reuse a slot
// freed by this instruction's last use of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Opcode : int {
    kIn = 0, kOut = 1, kC0 = 2, kC1 = 3, kNot = 4,
    kAnd = 5, kOr = 6, kXor = 7, kMaj = 8,
};

constexpr int kMaxThreads = 128;
constexpr int kMaxSharedBytes = 232448;   // 227 KB per block on sm_90

__global__ void circuit_kernel(const int4* __restrict__ prog, int n_instr,
                               const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, int n_words) {
    extern __shared__ uint32_t slots[];
    const long long word = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (word >= n_words) return;         // no barriers below
    const int stride = blockDim.x;
    uint32_t* my = slots + threadIdx.x;  // slot s lives at my[s * stride]
    for (int i = 0; i < n_instr; ++i) {
        const int4 ins = __ldg(prog + i);
        const int op = ins.x & 0xff;
        const int dst = ins.x >> 8;
        uint32_t r;
        switch (op) {
        case kIn:  r = in[(long long)ins.y * n_words + word]; break;
        case kOut: out[(long long)dst * n_words + word] = my[ins.y * stride];
                   continue;
        case kC0:  r = 0u; break;
        case kC1:  r = 0xffffffffu; break;
        case kNot: r = ~my[ins.y * stride]; break;
        case kAnd: r = my[ins.y * stride] & my[ins.z * stride]; break;
        case kOr:  r = my[ins.y * stride] | my[ins.z * stride]; break;
        case kXor: r = my[ins.y * stride] ^ my[ins.z * stride]; break;
        default: {
            const uint32_t a = my[ins.y * stride];
            const uint32_t b = my[ins.z * stride];
            const uint32_t c = my[ins.w * stride];
            r = (a & b) | (a & c) | (b & c);
        }
        }
        my[dst * stride] = r;
    }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// prog: (n_instr,) int4; in: (n_in_planes, n_words); out: (n_out, n_words)
int circuit_launch(const void* prog, int n_instr, int n_slots,
                   const void* in, void* out, int n_words, void* stream) {
    if (n_words <= 0 || n_instr <= 0 || n_slots <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int threads = kMaxThreads;
    while (threads > 32 &&
           (long long)n_slots * threads * 4 > kMaxSharedBytes)
        threads /= 2;
    const long long smem = (long long)n_slots * threads * 4;
    if (smem > kMaxSharedBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        circuit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n_words + threads - 1) / threads;
    circuit_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(prog), n_instr,
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        n_words);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
