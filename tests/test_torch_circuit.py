"""K3 (the fused circuit): the port's plain version against the JAX
package's Pallas kernel in interpret mode, and the level-parallel
slot-program lowering that the CUDA kernel executes against
``Circuit.evaluate_outputs``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.isa import SimdramDevice as RefDevice
from repro.kernels import ops as ref_ops
from repro.kernels.bitplane_ops import circuit_on_planes as ref_circuit
from repro_torch.core import bitplane
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.kernels import ops
from repro_torch.kernels.bitplane_ops import (CHUNK_GATES, LOOKAHEAD,
                                              MAX_SHARED_BYTES, SLOT_BYTES,
                                              circuit_on_planes,
                                              lower_circuit)

# 16-bit multiplication runs slowly in interpret mode: see
# test_torch_circuit_wide.py
WIDE = [("addition", 16), ("greater", 16), ("relu", 16)]


def _operands(spec, lanes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << w, size=lanes).astype(np.int64)
            for w in spec.operand_bits]


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("op,n_bits",
                         [(op, 8) for op in ALL_OPS] + WIDE)
@pytest.mark.parametrize("signed_out", [False, True])
def test_bbop_cuda_plain_matches_bbop_pallas(op, n_bits, signed_out):
    spec = get_op(op, n_bits)
    vals = _operands(spec, 200, n_bits * 31 + len(op))
    want = _as_tuple(ref_ops.bbop_pallas(
        op, n_bits, *[jnp.asarray(v.astype(np.int32)) for v in vals],
        signed_out=signed_out, block_w=8))
    got = _as_tuple(ops.bbop_cuda(op, n_bits, *vals, signed_out=signed_out,
                                  device="cpu"))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _planes(spec, vals, style_circ_ids):
    circ, ids = style_circ_ids
    return [bitplane.pack(torch.from_numpy(v), len(i))
            for v, i in zip(vals, ids)]


@pytest.mark.parametrize("op", ["addition", "xor_red", "if_else", "equal",
                                "multiplication"])
def test_aig_circuits_match_reference_kernel(op):
    """The raw AIG descriptions carry AND/OR/XOR gates, which the
    synthesized MIG circuits never do; K3 runs both."""
    spec = get_op(op, 8)
    circ, ids = spec.build("aig")
    assert {circ.ops[n] for n in circ.live_nodes()} & {"and", "or", "xor"}
    vals = _operands(spec, 256, 5)
    planes = _planes(spec, vals, (circ, ids))
    got = circuit_on_planes(circ, ids, planes)
    from repro.core.bitplane import pack as ref_pack
    from repro.core.ops_library import get_op as ref_get_op
    rcirc, rids = ref_get_op(op, 8).build("aig")
    rplanes = [ref_pack(jnp.asarray(v.astype(np.uint32)), len(i))
               for v, i in zip(vals, rids)]
    want = ref_circuit(rcirc, rids, rplanes, block_w=8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def run_slot_program(prog, operands) -> torch.Tensor:
    """What csrc/circuit.cu does with a slot program, in torch, step by
    step: a step's loads land first, then every gate of the step and
    every store read the slots as they stood, then the gates write.  A
    gate that read a slot its own step writes would read the value
    before the write, and the result would be wrong."""
    w = operands[0].shape[1]
    slots = torch.zeros((prog.n_slots, w), dtype=torch.int32)
    out = torch.zeros((prog.n_outputs, w), dtype=torch.int32)
    for s in range(prog.n_steps):
        (g0, l0, o0), (g1, l1, o1) = prog.steps[s], prog.steps[s + 1]
        for op, plane, dst in prog.loads[l0:l1].tolist():
            slots[dst // SLOT_BYTES] = operands[op][plane]
        old = slots.clone()
        for xa, xb, xc, dst in prog.gates[g0:g1].tolist():
            a, b, c = (old[x // SLOT_BYTES] for x in (xa, xb, xc))
            if xa & 1:
                r = a ^ b ^ c
            else:
                c = c ^ -(xc & 1)
                r = (a & b) | (a & c) | (b & c)
            slots[dst // SLOT_BYTES] = r
        for plane, src, m in prog.stores[o0:o1].tolist():
            out[plane] = old[src // SLOT_BYTES] ^ m
    return out


def _style_circuit(op, n_bits, style):
    if style == "mig":
        _, circ, ids = bitplane._compiled_op(op, n_bits)
    else:
        circ, ids = get_op(op, n_bits).build("aig")
    return circ, ids


@pytest.mark.parametrize("n_bits", [8, 16, 32])
@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("style", ["mig", "aig"])
def test_slot_program_equals_circuit(op, style, n_bits):
    """Up to the widest ops the repo compiles (32-bit division has the
    most gates and levels), the program fits a block's shared memory."""
    spec = get_op(op, n_bits)
    circ, ids = _style_circuit(op, n_bits, style)
    prog = lower_circuit(circ, ids)
    assert prog.n_slots <= len(circ.live_nodes())
    assert prog.shared_bytes <= MAX_SHARED_BYTES
    vals = _operands(spec, 128, 11)
    planes = _planes(spec, vals, (circ, ids))
    want = circuit_on_planes(circ, ids, planes)
    got = run_slot_program(prog, planes)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("op", ALL_OPS)
@pytest.mark.parametrize("style", ["mig", "aig"])
def test_slot_program_reads_only_earlier_levels(op, style):
    """Every gate reads values written at earlier steps (a load counts
    from LOOKAHEAD steps after its issue), no step reads a slot that it
    writes or that a load still in flight writes, and the slot count
    stays within the live node count."""
    circ, ids = _style_circuit(op, 16 if style == "mig" else 8, style)
    prog = lower_circuit(circ, ids)
    assert prog.n_slots <= len(circ.live_nodes())
    assert prog.n_levels <= prog.n_steps - LOOKAHEAD
    ready = {0: -1}            # slot -> first step that may read it
    busy = {}                  # slot -> last step of a load in flight
    for s in range(prog.n_steps):
        (g0, l0, o0), (g1, l1, o1) = prog.steps[s], prog.steps[s + 1]
        gates = prog.gates[g0:g1]
        reads = {int(x) // SLOT_BYTES for x in gates[:, :3].ravel()}
        reads |= {int(x) // SLOT_BYTES for x in prog.stores[o0:o1, 1]}
        writes = [int(x) // SLOT_BYTES for x in gates[:, 3]]
        assert len(set(writes)) == len(writes)
        assert not reads & set(writes), f"step {s} reads what it writes"
        for _, _, dst in prog.loads[l0:l1].tolist():
            slot = dst // SLOT_BYTES
            assert slot != 0
            ready[slot], busy[slot] = s + LOOKAHEAD, s + LOOKAHEAD - 1
        for r in reads:
            assert ready[r] <= s, f"step {s} reads slot {r} too early"
        for slot in writes:
            assert slot != 0 and busy.get(slot, -1) < s
            ready[slot] = s + 1
    assert (prog.chunks[1:] > prog.chunks[:-1]).all()
    assert np.diff(prog.steps[prog.chunks, 0]).max(initial=0) \
        <= prog.chunk_cap <= CHUNK_GATES
    assert 1 <= prog.warps <= 8
    assert prog.has_xor or not (prog.gates[:, 0] & 1).any()


@pytest.mark.parametrize("op,n_bits", [("addition", 8), ("bitcount", 8),
                                       ("min", 16)])
def test_bitplane_backend_matches_reference(op, n_bits):
    spec = get_op(op, n_bits)
    vals = _operands(spec, 100, 3)
    got = _as_tuple(SimdramDevice(backend="bitplane", device="cpu").bbop(
        op, *vals, n_bits=n_bits, signed_out=True))
    want = _as_tuple(RefDevice(backend="bitplane").bbop(
        op, *vals, n_bits=n_bits, signed_out=True))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(e))


def test_batch_axis_folds_into_one_circuit_call():
    spec = get_op("subtraction", 8)
    sets = [_operands(spec, 64, s) for s in range(3)]
    stacked = [bitplane.pack(torch.from_numpy(np.stack([s[k] for s in sets])),
                             8) for k in range(2)]
    batch = bitplane.op_on_planes_batch("subtraction", 8, *stacked)[0]
    for s, vals in enumerate(sets):
        one = bitplane.op_on_planes(
            "subtraction", 8,
            *[bitplane.pack(torch.from_numpy(v), 8) for v in vals])[0]
        np.testing.assert_array_equal(batch[s].numpy(), one.numpy())


@pytest.mark.parametrize("op", ALL_OPS)
def test_elementwise_circuit_ref_equals_reference(op):
    """``kernels/ref.elementwise_circuit_ref`` (K3's oracle: the port's
    eager bitplane backend on the CPU) ``==`` the reference's at 8 bits,
    every output, on lanes that are not a multiple of 32."""
    from repro.kernels.ref import elementwise_circuit_ref as ref_oracle
    from repro_torch.kernels.ref import elementwise_circuit_ref

    spec = get_op(op, 8)
    vals = _operands(spec, 100, seed=len(op))
    got = _as_tuple(elementwise_circuit_ref(op, 8, *vals))
    want = _as_tuple(ref_oracle(op, 8, *[jnp.asarray(v) for v in vals]))
    assert len(got) == len(want) == len(spec.out_bits)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
