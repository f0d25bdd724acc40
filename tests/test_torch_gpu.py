"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip without a CUDA device (decided in the ``cuda``
fixture, never at import).  Run them on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import bitplane
from repro_torch.core import bank as pt_bank
from repro_torch.core.control_unit import (replay, replay_plain,
                                           tables_from_numpy)
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.ops_library import ALL_OPS, get_op
from repro_torch.core.timing import DramConfig
from repro_torch.kernels import build
from repro_torch.kernels.bitplane_ops import circuit_on_planes, circuit_plain
from repro_torch.kernels.transpose_kernel import (h2v_cuda, h2v_plain,
                                                  v2h_cuda, v2h_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("n", [32, 1056, 1 << 16])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_transpose_kernels_match_plain(cuda, n, k):
    vals = _lanes(n, n + k).to(cuda)
    before = dict(build.LAUNCHES)
    planes = h2v_cuda(vals, k)
    torch.testing.assert_close(planes, h2v_plain(vals, k), rtol=0, atol=0)
    back = v2h_cuda(planes)
    torch.testing.assert_close(back, v2h_plain(planes), rtol=0, atol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["h2v"] == before["h2v"] + 1
    assert build.LAUNCHES["v2h"] == before["v2h"] + 1


@pytest.mark.parametrize("op,n_bits", [(op, 8) for op in ALL_OPS]
                         + [("multiplication", 16), ("division", 16)])
def test_circuit_kernel_matches_plain(cuda, op, n_bits):
    spec, circ, ids = bitplane._compiled_op(op, n_bits)
    planes = [h2v_cuda(_lanes(4096 + 32 * 7, len(op) + j).to(cuda), w)
              for j, w in enumerate(spec.operand_bits)]
    got = circuit_on_planes(circ, ids, planes)
    torch.testing.assert_close(got, circuit_plain(circ, ids, planes),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_bits", [1, 8, 16, 31, 32])
@pytest.mark.parametrize("n_words", [1, 3, 33, 4096 + 5])
def test_h2v_kernel_on_ragged_word_counts(cuda, n_bits, n_words):
    vals = _lanes(32 * n_words, 7 * n_words + n_bits).to(cuda)
    torch.testing.assert_close(h2v_cuda(vals, n_bits),
                               h2v_plain(vals, n_bits), rtol=0, atol=0)


def test_h2v_kernel_on_an_unaligned_view(cuda):
    vals = _lanes(32 * 70 + 1, 3).to(cuda)[1:]     # 4 bytes past 16
    torch.testing.assert_close(h2v_cuda(vals, 16), h2v_plain(vals, 16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("k", range(1, 33))
@pytest.mark.parametrize("signed", [False, True])
def test_v2h_kernel_at_every_width(cuda, k, signed):
    """K2 at every plane count, on ragged word counts (the tail of a
    32-word block, and word counts not a multiple of 4: plain loads)."""
    before = build.LAUNCHES["v2h"]
    for n_words in (1, 3, 33, 64, 4096 + 5):
        planes = _lanes(k * n_words, 31 * k + n_words).reshape(
            k, n_words).to(cuda)
        torch.testing.assert_close(v2h_cuda(planes, signed),
                                   v2h_plain(planes, signed), rtol=0, atol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["v2h"] == before + 5


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("k", [1, 8, 31])
def test_v2h_kernel_on_an_unaligned_view(cuda, signed, k):
    planes = _lanes(k * 64 + 1, k).to(cuda)[1:].reshape(k, 64)  # 4 bytes
    assert planes.data_ptr() % 16                               # past 16
    torch.testing.assert_close(v2h_cuda(planes, signed),
                               v2h_plain(planes, signed), rtol=0, atol=0)


def _k3_bare(prog, circ, ids, planes):
    """K3 launched on ``prog`` directly (no counter), and the plain
    circuit on the same planes."""
    from repro_torch.kernels.bitplane_ops import _launch
    out = torch.full((prog.n_outputs, planes[0].shape[1]), 7,
                     dtype=torch.int32, device=planes[0].device)
    _launch(prog, torch.from_numpy(prog.code).to(out.device), planes, out)
    return out, circuit_plain(circ, ids, planes)


@pytest.mark.parametrize("warps", range(1, 9))
@pytest.mark.parametrize("op,n_bits,style", [
    ("multiplication", 16, "mig"), ("xor_red", 8, "aig")])
def test_circuit_kernel_at_every_warp_count(cuda, warps, op, n_bits, style):
    """Every W the host can pick, on a word count that is not a multiple
    of the 64-word tile; the AIG circuit runs the XOR form."""
    import dataclasses
    from repro_torch.kernels.bitplane_ops import lower_circuit
    spec = get_op(op, n_bits)
    if style == "mig":
        _, circ, ids = bitplane._compiled_op(op, n_bits)
    else:
        circ, ids = spec.build("aig")
    planes = [h2v_cuda(_lanes(32 * 999, j).to(cuda), w)
              for j, w in enumerate(spec.operand_bits)]
    prog = dataclasses.replace(lower_circuit(circ, ids), warps=warps)
    assert prog.has_xor == (style == "aig")
    got, want = _k3_bare(prog, circ, ids, planes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("op,n_bits,chunk_gates", [
    ("multiplication", 16, None), ("multiplication", 8, 64),
    ("division", 16, None), ("multiplication", 32, None),
    ("division", 32, None)])
def test_circuit_kernel_over_many_tiles_per_block(cuda, monkeypatch, op,
                                                  n_bits, chunk_gates):
    """More tiles than resident blocks, so each block loops over tiles;
    a program streamed through shared memory in chunks (16- and 32-bit
    multiplication and division, and 8-bit multiplication cut into
    chunks of 64 gates) reloads every chunk for every tile."""
    from repro_torch.kernels import bitplane_ops
    if chunk_gates:
        monkeypatch.setattr(bitplane_ops, "CHUNK_GATES", chunk_gates)
    spec, circ, ids = bitplane._compiled_op(op, n_bits)
    prog = bitplane_ops.lower_circuit(circ, ids)
    n_words = (1 << 17) + 37
    planes = [h2v_cuda(_lanes(32 * n_words, 5 + j).to(cuda), w)
              for j, w in enumerate(spec.operand_bits)]
    got, want = _k3_bare(prog, circ, ids, planes)
    if chunk_gates or op == "division" or n_bits == 32:
        assert len(prog.chunks) > 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_circuit_kernel_runs_aig_gates(cuda):
    spec = get_op("xor_red", 8)
    circ, ids = spec.build("aig")
    planes = [h2v_cuda(_lanes(2048, j).to(cuda), w)
              for j, w in enumerate(spec.operand_bits)]
    torch.testing.assert_close(circuit_on_planes(circ, ids, planes),
                               circuit_plain(circ, ids, planes),
                               rtol=0, atol=0)


def _wave(ops, lanes, n_rows=None):
    rng = np.random.default_rng(0)
    metas = [pt_bank.cached_table(op, w) for op, w in ops]
    n_rows = n_rows or max(m[1].n_rows_total for m in metas)
    from repro_torch.core.control_unit import load_state
    states = np.zeros((len(ops), n_rows, lanes // 32), np.uint32)
    for s, (spec, uprog, _) in enumerate(metas):
        load_state(uprog, [rng.integers(0, 1 << b, lanes).astype(np.uint64)
                           for b in spec.operand_bits],
                   lanes, n_rows=n_rows, out=states[s])
    return states, [m[2] for m in metas]


@pytest.mark.parametrize("ops,n_rows", [
    ([("addition", 8), ("greater", 16), ("multiplication", 8)], None),
    ([("division", 16), ("relu", 8)], 256),     # 128 KB of shared memory
])
def test_replay_kernel_matches_plain(cuda, ops, n_rows):
    states_np, tables = _wave(ops, 4096 + 32 * 3, n_rows)
    states = torch.from_numpy(states_np.view(np.int32)).to(cuda)
    ct = tables_from_numpy(tables, device=cuda)
    torch.testing.assert_close(replay(states, ct),
                               replay_plain(states, ct.tables),
                               rtol=0, atol=0)
    shared = ct.tables[0]
    torch.testing.assert_close(replay(states, shared),
                               replay_plain(states, shared), rtol=0, atol=0)


def _random_tables(rng, counts, n_cmds, n_rows):
    """(len(counts), n_cmds, 13) random command tables, unit u real up to
    counts[u] (its last real command reads a row above 0, so it is not a
    NOP) and NOP-padded after it; flags 0 or 1, rows below n_rows."""
    t = np.zeros((len(counts), n_cmds, 13), np.int32)
    for u, c in enumerate(counts):
        t[u, :c, 0::2] = rng.integers(0, 2, (c, 7))
        t[u, :c, 1::2] = rng.integers(0, n_rows, (c, 6))
        if c:
            t[u, c - 1, 1] = rng.integers(1, n_rows)
    return torch.from_numpy(t)


def _random_states(rng, n_units, n_rows, n_words):
    return torch.from_numpy(rng.integers(
        0, 2**32, (n_units, n_rows, n_words), dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("n_rows", [64, 240, 256])
def test_replay_kernel_stops_at_each_units_count(cuda, n_rows):
    """Ragged counts (0 and the full bucket among them), a ragged last
    block, up to 256 rows beside the staging ring: the kernel, with the
    schedule carried by CommandTables or worked out on the card, equals
    the plain replay of the padded tables."""
    from repro_torch.core.control_unit import CommandTables, command_schedule
    rng = np.random.default_rng(n_rows)
    n_cmds, n_words = 300, 1000 + 7
    counts = [0, n_cmds, 1, 64, 65, 129, 250]
    states = _random_states(rng, len(counts), n_rows, n_words).to(cuda)
    t = _random_tables(rng, counts, n_cmds, n_rows).to(cuda)
    schedule = command_schedule(t)
    assert schedule[0].tolist() == counts
    want = replay_plain(states, t)
    before = build.LAUNCHES["replay"]
    torch.testing.assert_close(replay(states, CommandTables(t, schedule)),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(replay(states, t), want, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["replay"] == before + 2


@pytest.mark.parametrize("n_words", [1, 33, 4096 + 5])
def test_replay_kernel_shared_random_table(cuda, n_words):
    rng = np.random.default_rng(n_words)
    states = _random_states(rng, 5, 96, n_words).to(cuda)
    t = _random_tables(rng, [200], 256, 96)[0].to(cuda)
    torch.testing.assert_close(replay(states, t), replay_plain(states, t),
                               rtol=0, atol=0)


def test_replay_kernel_at_the_largest_bucket(cuda):
    """A synthetic table at the 32,768-command bucket, one unit real to
    its end; plain compared over the whole length."""
    rng = np.random.default_rng(32768)
    states = _random_states(rng, 3, 128, 40).to(cuda)
    t = _random_tables(rng, [32768, 20000, 0], 32768, 128).to(cuda)
    torch.testing.assert_close(replay(states, t), replay_plain(states, t),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_rows", [2, 5])
@pytest.mark.parametrize("p_flip", [None, 0.3])
def test_replay_kernels_on_rows_just_written(cuda, n_rows, p_flip):
    """Random tables over a few rows: most reads hit a row the previous
    command wrote, often through two or three of its ports; K5 (and K6
    with stuck masks) equal their plain versions."""
    from repro_torch.core.control_unit import (faulty_bank_replay,
                                               faulty_replay_plain)
    rng = np.random.default_rng(n_rows)
    n_words = 300
    counts = [500, 64, 65, 1]
    states = _random_states(rng, len(counts), n_rows, n_words).to(cuda)
    t = _random_tables(rng, counts, 500, n_rows).to(cuda)
    if p_flip is None:
        torch.testing.assert_close(replay(states, t),
                                   replay_plain(states, t), rtol=0, atol=0)
        return
    n_units = len(counts)
    keys = _lanes(2 * n_units, 21).reshape(n_units, 2).to(cuda)
    s0 = _lanes(n_units * n_words, 22).reshape(n_units, n_words).to(cuda)
    s1 = _lanes(n_units * n_words, 23).reshape(n_units, n_words).to(cuda)
    args = (states, t, keys, s0 & 0x00030000, s1 & 0x0C000001,
            torch.zeros(n_units, dtype=torch.bool, device=cuda), p_flip)
    got, n_got = faulty_bank_replay(*args)
    want, n_want = faulty_replay_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(n_got, n_want, rtol=0, atol=0)


def test_replay_kernel_rejects_more_than_256_rows(cuda):
    states = torch.zeros((2, 257, 4), dtype=torch.int32, device=cuda)
    t = torch.zeros((2, 8, 13), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 256 state rows"):
        replay(states, t)


@pytest.mark.parametrize("engine", ["bitplane", "cuda"])
def test_bank_engines_launch_the_circuit_kernel(cuda, engine):
    rng = np.random.default_rng(1)
    x, y = (rng.integers(0, 256, 1000).astype(np.uint64) for _ in range(2))
    bank = pt_bank.Bank(n_subarrays=4, engine=engine, device=cuda)
    before = build.LAUNCHES["circuit"]
    got = bank.bbop("addition", x, y, n_bits=8)
    assert build.LAUNCHES["circuit"] > before
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  (x + y).astype(np.int64) % 256)


def test_bitplane_backend_launches_the_circuit_kernel(cuda):
    x = np.arange(3000, dtype=np.int64) % 256
    before = build.LAUNCHES["circuit"]
    got = SimdramDevice(backend="bitplane", device="cuda").bbop(
        "subtraction", x, x[::-1].copy(), n_bits=8)
    assert build.LAUNCHES["circuit"] == before + 1
    np.testing.assert_array_equal(got.astype(np.int64) & 0xFF,
                                  (x - x[::-1]) & 0xFF)


def _chained_queue(device, lanes=256):
    """Mixed ops and widths, a Ref chain, a VerticalOperand entering
    through K1 and a keep_vertical result leaving through K2."""
    rng = np.random.default_rng(3)
    x, y = (rng.integers(0, 256, lanes).astype(np.uint64) for _ in range(2))
    z = rng.integers(0, 1 << 16, lanes).astype(np.uint64)
    instr, ref = pt_bank.BbopInstr, pt_bank.Ref
    return [
        instr("multiplication", (x, y), 8),
        instr("greater", (x, z), 16),
        instr("addition", (ref(0), pt_bank.VerticalOperand.from_values(
            z, 16, device=device)), 16),
        instr("relu", (ref(2),), 16, signed_out=True, keep_vertical=True),
        instr("subtraction", (y, x), 8),
    ]


def test_bank_dispatch_on_card_equals_cpu(cuda):
    cfg = DramConfig(n_banks=4, columns_per_subarray=256)
    runs = []
    for dev in ("cuda", "cpu"):
        d = SimdramDevice(backend="bank", device=dev, cfg=cfg)
        before = dict(build.LAUNCHES)
        res = d.dispatch(_chained_queue(dev))
        flat = [x for r in res for x in pt_bank.flatten_result(r)]
        torch.cuda.synchronize()
        if dev == "cuda":
            for k in ("h2v", "v2h", "replay"):
                assert build.LAUNCHES[k] > before[k], k
        stats = d.bank().stats.as_dict()
        stats.pop("wall_s"), stats.pop("pack_wall_s")
        runs.append((flat, stats))
    for g, e in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[0][1] == runs[1][1]


# -- K4: the binary popcount matmul ------------------------------------------

@pytest.mark.parametrize("m,kw,n", [
    (100, 7, 70), (64, 32, 64), (1, 1, 1), (3136, 72, 256),
    (65, 17, 63), (64, 16, 64), (130, 34, 129),    # tile and stage edges
    (5, 64, 5), (200, 130, 70), (70, 49, 200),     # split K, ragged splits
    (50176, 18, 64), (784, 144, 512),              # VGG-16 conv1_2, conv4_2
])
def test_popmatmul_kernel_matches_plain(cuda, m, kw, n):
    from repro_torch.kernels.bitserial_matmul import binary_matmul
    from repro_torch.kernels.ref import binary_matmul_ref
    a = _lanes(m * kw, m + kw).reshape(m, kw).to(cuda)
    w = _lanes(kw * n, n + 7).reshape(kw, n).to(cuda)
    before = build.LAUNCHES["popmatmul"]
    got = binary_matmul(a, w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["popmatmul"] == before + 1
    torch.testing.assert_close(got, binary_matmul_ref(a, w), rtol=0, atol=0)


def test_bitserial_and_quantized_matmul_on_card_equal_cpu(cuda):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(0, 4, (300, 200)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2, 2, (200, 90)).astype(np.int32))
    want = a.to(torch.int64) @ w.to(torch.int64)
    before = build.LAUNCHES["popmatmul"]
    got = ops.bitserial_matmul(a.to(cuda), w.to(cuda), 2, 2)
    assert build.LAUNCHES["popmatmul"] == before + 1     # pairs fused
    torch.testing.assert_close(got.cpu(), want.to(torch.int32), rtol=0,
                               atol=0)
    a8 = torch.from_numpy(rng.integers(-2**15, 2**15, (64, 96))
                          .astype(np.int32))
    w8 = torch.from_numpy(rng.integers(-2**15, 2**15, (96, 32))
                          .astype(np.int32))
    torch.testing.assert_close(
        ops.quantized_matmul(a8.to(cuda), w8.to(cuda), 16, 16).cpu(),
        ops.quantized_matmul(a8, w8, 16, 16), rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n,a_bits,w_bits,a_signed,w_signed", [
    (100, 300, 70, 1, 1, False, False),
    (100, 300, 70, 2, 2, False, True),
    (65, 1000, 129, 3, 4, True, True),   # runs that begin inside pairs
    (33, 2304, 40, 8, 8, True, True),
    (20, 64, 9, 32, 32, True, True),     # weights of 2**32 and more
    (784, 4608, 512, 2, 2, False, True),  # VGG-16 conv4_2
])
def test_fused_planes_kernel_matches_plain(cuda, m, k, n, a_bits, w_bits,
                                           a_signed, w_signed):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(m + k + n + a_bits)
    lo_a = -(1 << (a_bits - 1)) if a_signed else 0
    lo_w = -(1 << (w_bits - 1)) if w_signed else 0
    a = torch.from_numpy(rng.integers(lo_a, lo_a + (1 << a_bits), (m, k))
                         .astype(np.int32))
    w = torch.from_numpy(rng.integers(lo_w, lo_w + (1 << w_bits), (k, n))
                         .astype(np.int32))
    before = build.LAUNCHES["popmatmul"]
    got = ops.bitserial_matmul(a.to(cuda), w.to(cuda), a_bits, w_bits,
                               a_signed=a_signed, w_signed=w_signed)
    torch.cuda.synchronize()
    assert build.LAUNCHES["popmatmul"] == before + 1
    want = ops.bitserial_matmul(a, w, a_bits, w_bits, a_signed=a_signed,
                                w_signed=w_signed)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# -- K6: the fault-injected replay -------------------------------------------

@pytest.mark.parametrize("p_flip", [0.0, 1e-3, 0.5, 1.0])
@pytest.mark.parametrize("shared", [False, True])
def test_faulty_replay_kernel_matches_plain(cuda, p_flip, shared):
    from repro_torch.core.control_unit import (faulty_bank_replay,
                                               faulty_replay_plain)
    states_np, tables = _wave([("addition", 8), ("greater", 16),
                               ("multiplication", 8)], 4096 + 32 * 3, 64)
    states = torch.from_numpy(states_np.view(np.int32)).to(cuda)
    t = tables_from_numpy(tables, device=cuda).tables
    t = t[1] if shared else t
    n_units, _, n_words = states.shape
    keys = _lanes(2 * n_units, 1).reshape(n_units, 2).to(cuda)
    s0 = _lanes(n_units * n_words, 2).reshape(n_units, n_words).to(cuda)
    s1 = _lanes(n_units * n_words, 3).reshape(n_units, n_words).to(cuda)
    s0, s1 = s0 & (s1 >> 3) & 0x01010101, s1 & 0x00100010 & ~s0
    dead = torch.tensor([False, True, False], device=cuda)
    before = build.LAUNCHES["faulty_replay"]
    got, n_got = faulty_bank_replay(states, t, keys, s0, s1, dead, p_flip)
    torch.cuda.synchronize()
    assert build.LAUNCHES["faulty_replay"] == before + 1
    want, n_want = faulty_replay_plain(states, t, keys, s0, s1, dead, p_flip)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(n_got, n_want, rtol=0, atol=0)


@pytest.mark.parametrize("p_flip", [0.0, 7e-5, 1.0])
@pytest.mark.parametrize("n_rows", [64, 256])
def test_faulty_replay_kernel_stops_at_each_units_count(cuda, p_flip,
                                                        n_rows):
    """K6 on ragged counts with stuck masks and dead units: states and
    flip counts equal the plain version on the padded tables."""
    from repro_torch.core.control_unit import (CommandTables,
                                               command_schedule,
                                               faulty_bank_replay,
                                               faulty_replay_plain)
    rng = np.random.default_rng(n_rows + int(p_flip * 1e5))
    n_cmds, n_words = 200, 700 + 3
    counts = [0, n_cmds, 1, 64, 65, 129]
    n_units = len(counts)
    states = _random_states(rng, n_units, n_rows, n_words).to(cuda)
    t = _random_tables(rng, counts, n_cmds, n_rows).to(cuda)
    keys = _lanes(2 * n_units, 11).reshape(n_units, 2).to(cuda)
    s0 = _lanes(n_units * n_words, 12).reshape(n_units, n_words).to(cuda)
    s1 = _lanes(n_units * n_words, 13).reshape(n_units, n_words).to(cuda)
    s0, s1 = s0 & 0x00010200, s1 & 0x40000004
    dead = torch.tensor([False, True, False, False, True, False],
                        device=cuda)
    args = (keys, s0, s1, dead, p_flip)
    want, n_want = faulty_replay_plain(states, t, *args)
    for tables in (CommandTables(t, command_schedule(t)), t):
        got, n_got = faulty_bank_replay(states, tables, *args)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(n_got, n_want, rtol=0, atol=0)
    if p_flip == 1.0:
        assert int(n_want[1]) == 32 * n_words * int(t[1, :, 0].sum())


def _fault_queue(lanes=300):
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, lanes).astype(np.uint64) for _ in range(2))
    instr, ref = pt_bank.BbopInstr, pt_bank.Ref
    return [instr("addition", (a, b), 8),
            instr("multiplication", (ref(0), b), 8),
            instr("greater", (a, b), 8)]


@pytest.mark.parametrize("kw", [
    {"p_flip": 1e-4, "spare_lanes": 1, "seed": 1},
    {"p_flip": 3e-4, "spare_lanes": 0, "seed": 2},
    {"p_flip": 0.0, "dead_unit_rate": 0.4, "spare_lanes": 1, "seed": 11},
])
def test_fault_dispatch_on_card_equals_cpu(cuda, kw):
    """Philox gives the card and the CPU the same bits, so a
    fault-injected dispatch — results and every FaultStats field — is
    the same on both."""
    from repro_torch.core.fault import FaultModel
    runs = []
    for dev in ("cuda", "cpu"):
        bank = pt_bank.Bank(n_subarrays=4, fault=FaultModel(**kw),
                            device=dev)
        before = build.LAUNCHES["faulty_replay"]
        res = bank.dispatch(_fault_queue())
        if dev == "cuda":
            assert build.LAUNCHES["faulty_replay"] > before
        runs.append(([x for r in res for x in pt_bank.flatten_result(r)],
                     bank.stats.faults.as_dict()))
    for g, e in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[0][1] == runs[1][1]


def test_disabled_fault_model_launches_no_faulty_replay(cuda):
    from repro_torch.core.fault import FaultModel
    before = dict(build.LAUNCHES)
    bank = pt_bank.Bank(n_subarrays=4, fault=FaultModel(enabled=False),
                        device=cuda)
    bank.dispatch(_fault_queue())
    assert build.LAUNCHES["faulty_replay"] == before["faulty_replay"]
    assert build.LAUNCHES["replay"] > before["replay"]


# -- the ladder: one K5 launch per stacked round ------------------------------

def _ladder_queue(device, lanes=300):
    rng = np.random.default_rng(7)
    instr, ref = pt_bank.BbopInstr, pt_bank.Ref
    q = []
    for op, w in [("addition", 8), ("multiplication", 16), ("greater", 8),
                  ("min", 16), ("and_red", 8), ("subtraction", 8)] * 2:
        q.append(instr(op, tuple(
            rng.integers(0, 1 << b, lanes).astype(np.uint64)
            for b in get_op(op, w).operand_bits), w))
    z = rng.integers(0, 1 << 16, lanes).astype(np.uint64)
    q.append(instr("addition", (ref(1), pt_bank.VerticalOperand.from_values(
        z, 16, device=device)), 16))
    q.append(instr("relu", (ref(len(q) - 1),), 16, signed_out=True,
                   keep_vertical=True))
    return q


@pytest.mark.parametrize("backend,geo", [
    ("chip", {"n_banks": 4, "subarrays_per_bank": 2}),
    ("channel", {"n_chips": 2, "n_banks": 2, "subarrays_per_bank": 2}),
    ("rank", {"n_channels": 2, "n_chips": 2, "n_banks": 2,
              "subarrays_per_bank": 1}),
])
def test_ladder_dispatch_on_card_equals_cpu(cuda, backend, geo):
    """Each stacked round is one K5 launch over every unit of the tier,
    and results and modeled stats equal the CPU run's."""
    cfg = DramConfig(columns_per_subarray=512, **geo)
    runs = []
    for dev in ("cuda", "cpu"):
        d = SimdramDevice(backend=backend, device=dev, cfg=cfg)
        queue = _ladder_queue(dev)
        build.reset_launches()
        res = d.dispatch(queue)
        flat = [x for r in res for x in pt_bank.flatten_result(r)]
        x = np.arange(4000, dtype=np.uint64) % np.uint64(256)
        flat.append(d.bbop("addition", x, x, n_bits=8))
        torch.cuda.synchronize()
        eng = getattr(d, backend)()
        rounds = (eng.stats.rounds if backend == "chip"
                  else eng.stats.super_rounds)
        if dev == "cuda":
            assert build.LAUNCHES["replay"] == rounds > 1
            assert build.LAUNCHES["faulty_replay"] == 0
            assert build.LAUNCHES["v2h"] > 0
        stats = eng.stats.as_dict()
        stats.pop("wall_s"), stats.pop("pack_wall_s")
        runs.append((flat, stats))
    for g, e in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("backend,geo", [
    ("chip", {"n_banks": 2, "subarrays_per_bank": 2}),
    ("channel", {"n_chips": 2, "n_banks": 2, "subarrays_per_bank": 1}),
])
@pytest.mark.parametrize("kw", [
    {"p_flip": 1e-4, "spare_lanes": 1, "seed": 1},
    {"p_flip": 0.0, "dead_unit_rate": 0.3, "spare_lanes": 1, "seed": 11},
    {"p_flip": 0.0, "stuck_lane_rate": 0.02, "spare_lanes": 2, "seed": 13},
])
def test_faulty_ladder_on_card_equals_cpu(cuda, backend, geo, kw):
    """One K6 launch over every unit per attempt of a round; Philox gives
    the card and the CPU the same bits, so results, FaultStats and the
    blacklists are the same on both."""
    from repro_torch.core.fault import FaultModel
    cfg = DramConfig(columns_per_subarray=1024, **geo)
    runs = []
    for dev in ("cuda", "cpu"):
        d = SimdramDevice(backend=backend, device=dev, cfg=cfg,
                          fault=FaultModel(**kw))
        eng = getattr(d, backend)()
        calls = []
        run = eng._faulty_executor.run
        eng._faulty_executor = type(eng._faulty_executor)(
            lambda *a: (calls.append(1), run(*a))[1], None, False)
        build.reset_launches()
        res = d.dispatch(_fault_queue())
        torch.cuda.synchronize()
        if dev == "cuda":
            assert build.LAUNCHES["faulty_replay"] == len(calls) > 0
            assert build.LAUNCHES["replay"] == 0
        banks = (eng.banks if backend == "chip"
                 else [b for c in eng.chips for b in c.banks])
        runs.append(([x for r in res for x in pt_bank.flatten_result(r)],
                     eng.stats.faults.as_dict(),
                     [sorted(b._blacklist) for b in banks]))
    for g, e in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[0][1:] == runs[1][1:]


def _split_tier(backend, geo, dev, mesh=None, **kw):
    """A ladder tier on ``dev`` at ``geo`` over 512-column subarrays,
    split over ``mesh`` when one is given."""
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.rank import SimdramRank
    cls = {"chip": SimdramChip, "channel": SimdramChannel,
           "rank": SimdramRank}[backend]
    return cls(cfg=DramConfig(columns_per_subarray=512), device=dev,
               mesh=mesh, use_shard_map=None if mesh else False, **geo,
               **kw)


SPLITS = [
    ("chip", {"n_banks": 4, "n_subarrays": 2}, (4,), ("data",)),
    ("channel", {"n_chips": 2, "n_banks": 2, "n_subarrays": 2}, (2, 2),
     ("channel", "data")),
    ("rank", {"n_channels": 2, "n_chips": 2, "n_banks": 2,
              "n_subarrays": 1}, (2, 2, 2), ("rank", "channel", "data")),
]


@pytest.mark.parametrize("backend,geo,sizes,axes", SPLITS)
def test_split_ladder_on_card_equals_unsplit(cuda, backend, geo, sizes,
                                             axes):
    """A tier split over ``cuda:0`` repeated, each position on its own
    stream: one K5 launch a slab of every round, results and modeled
    stats equal the unsplit run's on the card and the CPU run's, and a
    traced split round's span carries ``device_s``."""
    from repro_torch import obs
    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(sizes))
    mesh = Mesh(sizes, axes, [torch.device("cuda", 0)] * n)
    runs = []
    for dev, m in (("cuda", mesh), ("cuda", None), ("cpu", None)):
        eng = _split_tier(backend, geo, dev, m)
        assert eng.executor.sharded == (m is not None)
        build.reset_launches()
        res = eng.dispatch(_ladder_queue(dev))
        torch.cuda.synchronize()
        rounds = (eng.stats.rounds if backend == "chip"
                  else eng.stats.super_rounds)
        if dev == "cuda":
            assert build.LAUNCHES["replay"] == rounds * (n if m else 1)
        stats = eng.stats.as_dict()
        stats.pop("wall_s"), stats.pop("pack_wall_s")
        runs.append(([x for r in res for x in pt_bank.flatten_result(r)],
                     stats))
    for other in runs[1:]:
        for g, e in zip(runs[0][0], other[0]):
            np.testing.assert_array_equal(g, e)
        assert runs[0][1] == other[1]
    eng = _split_tier(backend, geo, "cuda", mesh)
    with obs.enabled() as tr:
        eng.dispatch(_ladder_queue("cuda"))
    spans = [s for r in tr.roots for s in r.walk()
             if s.name == f"{backend}.replay"]
    assert spans and all(s.attrs.get("device_s", 0) > 0 for s in spans)


@pytest.mark.parametrize("backend,geo,sizes,axes", SPLITS[:2])
def test_split_faulty_ladder_on_card_equals_unsplit(cuda, backend, geo,
                                                    sizes, axes):
    """The chip and channel fault wrappers split over ``cuda:0`` repeated:
    one K6 launch a slab of every attempt, and results, ``FaultStats``
    and every attempt's flip counts equal the unsplit run's (K6 keys
    its Philox counter by each unit's own key)."""
    from repro_torch.core.fault import FaultModel
    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(sizes))
    mesh = Mesh(sizes, axes, [torch.device("cuda", 0)] * n)
    model = dict(p_flip=1e-4, spare_lanes=1, seed=1, max_retries=10)
    runs = []
    for m in (mesh, None):
        eng = _split_tier(backend, geo, "cuda", m,
                          fault=FaultModel(**model))
        counts = []
        run = eng._faulty_executor.run
        eng._faulty_executor = type(eng._faulty_executor)(
            lambda *a: (lambda o: (counts.append(o[1].cpu().numpy()),
                                   o)[1])(run(*a)),
            eng._faulty_executor.mesh, eng._faulty_executor.sharded)
        build.reset_launches()
        res = eng.dispatch(_fault_queue())
        torch.cuda.synchronize()
        assert build.LAUNCHES["faulty_replay"] == len(counts) * (
            n if m else 1) > 0
        runs.append(([x for r in res for x in pt_bank.flatten_result(r)],
                     eng.stats.faults.as_dict(), counts))
    for g, e in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[0][1] == runs[1][1] and runs[0][1]["injected"] > 0
    for g, e in zip(runs[0][2], runs[1][2]):
        np.testing.assert_array_equal(g, e)


def test_launch_follows_the_current_stream(cuda):
    """K5 launched inside ``torch.cuda.device(0)`` under a side stream
    runs on that stream: while the default stream sleeps, the replay and
    a copy queued behind it on the side stream finish, and the copy
    equals the plain replay."""
    ops = [("addition", 8), ("multiplication", 16)]
    tabs = tables_from_numpy([pt_bank.cached_table(op, w)[2]
                              for op, w in ops] * 2, device="cuda")
    n_rows = int(tabs.tables[..., 1::2].max()) + 1
    rng = np.random.default_rng(3)
    states = torch.from_numpy(rng.integers(
        0, 2**32, (4, n_rows, 64), dtype=np.uint32).view(np.int32)).cuda()
    want = replay_plain(states, tabs.tables)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.device(0):
        torch.cuda._sleep(500_000_000)       # about 0.3 s on the default
        with torch.cuda.stream(side):
            before = build.LAUNCHES["replay"]
            got = replay(states, tabs).clone()
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        assert not torch.cuda.default_stream().query()
    assert build.LAUNCHES["replay"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()


def _apps():
    """The seven apps at ``tests/test_apps.py``'s ladder sizes."""
    from repro_torch.apps import (bitweaving, brightness, knn, lenet,
                                  nn_layers, tpch, vgg)
    return {
        "knn": lambda d: knn.run(n_points=96, n_features=3, n_bits=5,
                                 device=d),
        "tpch": lambda d: tpch.run(n_rows=128, device=d),
        "bitweaving": lambda d: bitweaving.run(n_rows=160, n_bits=6,
                                               device=d),
        "brightness": lambda d: brightness.run(h=6, w=6, delta=60, device=d),
        "nn_layers": lambda d: nn_layers.run(device=d),
        "lenet": lambda d: lenet.run(device=d, conv_channels=(2, 3),
                                     fc_dims=(12, 10)),
        "vgg13": lambda d: vgg.run("vgg13", img_hw=8, n_layers=3, device=d),
    }


@pytest.mark.parametrize("name", sorted(_apps()))
@pytest.mark.parametrize("backend", ["bitplane", "cuda", "bank", "chip",
                                     "channel"])
def test_apps_on_card_equal_cpu(cuda, name, backend):
    """Each app on each rung of the card equals the same app with
    ``torch_device="cpu"``: the output, every other key of the result
    dict and every modeled engine field.  The sequential rungs launch K3
    (``cuda`` with K1 and K2 around it), the fused rungs K5 only."""
    from repro_torch.apps.runtime import engine_stats
    fn = _apps()[name]
    cfg = DramConfig(n_banks=2, subarrays_per_bank=2, n_chips=2)
    runs = []
    for dev in ("cuda", "cpu"):
        d = SimdramDevice(backend=backend, cfg=cfg, device=dev)
        build.reset_launches()
        r = fn(d)
        torch.cuda.synchronize()
        if dev == "cuda":
            n = dict(build.LAUNCHES)
            if backend in ("bitplane", "cuda"):
                assert n["circuit"] > 0 and n["replay"] == 0
                assert (n["h2v"] > 0 and n["v2h"] > 0) == (backend == "cuda")
            else:
                assert n["replay"] > 0 and n["circuit"] == 0
            assert n["faulty_replay"] == 0 and n["popmatmul"] == 0
        stats = engine_stats(d)
        if stats is not None:
            stats.pop("wall_s"), stats.pop("pack_wall_s")
        assert r["verified"] is True
        runs.append((r, d.totals(), stats))
    (got, t_got, s_got), (want, t_want, s_want) = runs
    np.testing.assert_array_equal(np.asarray(got["output"]).astype(np.int64),
                                  np.asarray(want["output"]).astype(np.int64))
    assert {k: v for k, v in got.items() if k != "output"} == {
        k: v for k, v in want.items() if k != "output"}
    assert t_got == t_want and s_got == s_want


@pytest.mark.parametrize("tier", ["bank", "chip", "channel", "rank"])
def test_traced_dispatch_on_card_has_device_time(cuda, tier):
    """Under a tracer every ``*.replay`` span of a dispatch on the card
    carries ``device_s`` (CUDA events around its K5 launch, read at
    harvest), the modeled charges equal the CPU run's span by span, and
    results and launch counts equal the untraced dispatch's."""
    from repro_torch import obs
    from repro_torch.core.bank import Bank
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.rank import SimdramRank

    def engine(dev):
        if tier == "bank":
            return Bank(n_subarrays=2, device=dev)
        if tier == "chip":
            return SimdramChip(n_banks=2, n_subarrays=2, device=dev)
        if tier == "channel":
            return SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2,
                                  device=dev)
        return SimdramRank(device=dev)

    from repro_torch.core.control_unit import TABLE_CACHE

    runs = {}
    for dev, traced in (("cuda", False), ("cuda", True), ("cpu", True)):
        TABLE_CACHE.clear()          # the same cache hits and misses
        build.reset_launches()
        eng = engine(dev)
        if traced:
            with obs.enabled() as tr:
                res = eng.dispatch(_ladder_queue(dev))
        else:
            tr, res = None, eng.dispatch(_ladder_queue(dev))
        torch.cuda.synchronize()
        flat = [x for r in res for x in pt_bank.flatten_result(r)]
        runs[(dev, traced)] = (flat, dict(build.LAUNCHES), tr)
    for key in (("cuda", True), ("cpu", True)):
        for g, e in zip(runs[key][0], runs[("cuda", False)][0]):
            np.testing.assert_array_equal(g, e)
    assert runs[("cuda", True)][1] == runs[("cuda", False)][1]
    tr_card, tr_cpu = runs[("cuda", True)][2], runs[("cpu", True)][2]
    replays = [s for r in tr_card.roots for s in r.walk()
               if s.name == f"{tier}.replay"]
    assert len(replays) == runs[("cuda", True)][1]["replay"] > 0
    assert all(s.attrs["device_s"] > 0.0 for s in replays)
    assert not any("device_s" in s.attrs
                   for r in tr_cpu.roots for s in r.walk())
    card = [(s.name, s.charges) for r in tr_card.roots for s in r.walk()]
    cpu = [(s.name, s.charges) for r in tr_cpu.roots for s in r.walk()]
    assert card == cpu


def _served_window(dev, worker=False, traced=False):
    """The soak's traffic (two windows of 16 requests at 256 lanes) on a
    2 x 2 x 2 channel on ``dev``: the tickets' values, ``resolved_s``,
    the frontend stats and the ``serving.*`` registry, and the threads
    and streams the engine dispatched from."""
    import threading

    from repro_torch import obs
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.telemetry import REGISTRY
    from repro_torch.serving import (AdmissionRejected, DeadlineExceeded,
                                     ServingFrontend)

    REGISTRY.reset()
    ops = ("addition", "subtraction", "multiplication", "min", "max",
           "relu", "bitcount", "division")
    eng = SimdramChannel(n_chips=2, n_banks=2, n_subarrays=2, device=dev)
    seen = []
    dispatch = eng.dispatch

    def watched(queue, cancel=None):
        seen.append((threading.get_ident(),
                     torch.cuda.current_stream().cuda_stream))
        return dispatch(queue, cancel=cancel)

    eng.dispatch = watched
    fe = ServingFrontend(eng, max_queue_depth=12, window=16, max_retries=2)
    rng = np.random.default_rng(0)
    tickets = []
    with (obs.enabled() if traced else contextlib.nullcontext()):
        for _ in range(2):
            mine = []
            for i in range(16):
                op = ops[int(rng.integers(len(ops)))]
                w = (8, 16)[int(rng.integers(2))]
                operands = tuple(rng.integers(0, 1 << w, 256)
                                 for _ in range(get_op(op, w).n_operands))
                try:
                    mine.append(fe.submit(
                        ("alice", "bob", "carol")[i % 3], op, operands, w,
                        deadline_s=fe.now_s + (1e-7 if i % 4 == 3 else 10.0),
                        priority=1 if i % 5 == 0 else 0))
                except AdmissionRejected:
                    pass
            if worker:
                fe.start()
                try:
                    for t in mine:
                        try:
                            t.result(timeout=120)
                        except DeadlineExceeded:
                            pass
                finally:
                    fe.stop()
            else:
                fe.drain()
            tickets += mine
    rows = []
    for t in tickets:
        try:
            v = t.result(timeout=0)
            v = [np.asarray(x).tolist()
                 for x in (v if isinstance(v, tuple) else (v,))]
        except DeadlineExceeded as e:
            v = e.where
        rows.append((t.seq, t.tenant, v, t.resolved_s))
    return (rows, fe.stats.as_dict(), REGISTRY.snapshot("serving.")), seen


def test_served_window_on_card_equals_cpu(cuda):
    """The soak's traffic served on the card resolves every ticket to the
    CPU run's value at the CPU run's modeled time, with equal frontend
    stats and registry; each window is one K5 launch a super-round."""
    build.reset_launches()
    card, _ = _served_window("cuda")
    assert build.LAUNCHES["replay"] > 0
    cpu, _ = _served_window("cpu")
    assert card == cpu


def test_worker_thread_on_card_equals_the_pump(cuda):
    """``start()``/``stop()`` on the card, with a tracer on: the worker
    dispatches from its own thread on the main thread's stream, and
    resolves the same tickets to the same values and times as the
    synchronous pump."""
    import threading
    main = (threading.get_ident(), torch.cuda.current_stream().cuda_stream)
    sync, _ = _served_window("cuda")
    worker, seen = _served_window("cuda", worker=True, traced=True)
    assert worker == sync
    assert seen and all(t != main[0] and s == main[1] for t, s in seen)


# -- the LM stack -------------------------------------------------------------

LM_TOL = 1e-3        # cuBLAS against CPU BLAS, float32 (no TF32)


def _lm_runs(cfg, device, params):
    """lm_forward and two decode steps of ``cfg`` on ``device``: the
    logits, aux, decode logits and every cache leaf."""
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                lm_forward)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    kw = {}
    if cfg.is_encdec:
        kw["encoder_feats"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        kw["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.frontend_seq, cfg.d_model)).astype(
                np.float32))
    kw = {k: v.to(device) for k, v in kw.items()}
    with torch.no_grad():
        logits, aux = lm_forward(params, toks.to(device), cfg, **kw)
        caches = init_caches(cfg, 2, 16, device)
        steps = []
        for t in range(2):
            lg, caches = decode_step(
                params, caches, toks[:, t].to(device),
                torch.full((2,), t, dtype=torch.int32, device=device), cfg,
                memory=kw.get("encoder_feats"))
            steps.append(lg)
    return [logits, aux, torch.stack(steps)] + [
        t for kind in sorted(caches) for _, t in sorted(caches[kind].items())]


def _smoke_arch_names():
    from repro_torch.configs import ARCHS
    return sorted(ARCHS)


def _on(params, device):
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: t.to(device), params)


@pytest.mark.parametrize("arch", _smoke_arch_names())
def test_lm_on_card_equals_cpu(cuda, arch):
    """Every arch at smoke_config (float32): the forward, its aux loss,
    two decode steps and the caches on the card within 1e-3 of the CPU
    run of the same weights (int8 cache entries within 1)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_lm
    cfg = smoke_config(arch).replace(param_dtype="float32")
    params = init_lm(cfg, device="cpu")
    cpu = _lm_runs(cfg, "cpu", params)
    card = _lm_runs(cfg, cuda, _on(params, cuda))
    for got, want in zip(card, cpu):
        if want.dtype == torch.int8:
            assert (got.cpu().int() - want.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=LM_TOL, atol=LM_TOL)


def test_pum_mlp_on_card_launches_k3(cuda):
    """The PuM MLP (relu as a bbop) makes one K3 launch a layer on the
    card, its integer stage equals the CPU's plain circuit bit for bit,
    and the logits equal the CPU's within 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.layers import relu_stage
    from repro_torch.models.transformer import init_lm, lm_forward
    cfg = smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", pum_bits=8, param_dtype="float32")
    params = init_lm(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    feats = torch.zeros((1, 4, cfg.d_model))
    with torch.no_grad():
        want, _ = lm_forward(params, toks, cfg, encoder_feats=feats)
        build.reset_launches()
        got, _ = lm_forward(_on(params, cuda), toks.to(cuda), cfg,
                            encoder_feats=feats.to(cuda))
    assert build.LAUNCHES["circuit"] == cfg.n_layers + cfg.n_encoder_layers
    torch.testing.assert_close(got.cpu(), want, rtol=LM_TOL, atol=LM_TOL)
    up = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 8, 128)).astype(np.float32))
    assert torch.equal(relu_stage(up.to(cuda)).cpu(), relu_stage(up))


def test_lm_server_on_card_with_offload(cuda):
    """Smoke yi-6b (float32) served on the card through PumServeOffload
    on a card chip: every step's offload returns the logits it was given
    and one K5 launch a stacked round; fed the logits the CPU run's
    offload was given (the card's own may part from them at a near-tie),
    a card chip's modeled stats equal the CPU chip's."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.chip import SimdramChip
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve import PumServeOffload, Request, Server
    cfg = smoke_config("yi-6b").replace(param_dtype="float32")
    params = init_lm(cfg, device="cpu")

    def stats(off):
        return {k: v for k, v in off.chip.stats.as_dict().items()
                if k not in ("wall_s", "pack_wall_s")}

    def serve(device, p):
        off = PumServeOffload(chip=SimdramChip(n_banks=2, n_subarrays=2,
                                               device=device))
        given = []

        def watched(x):
            y = off(x)
            given.append((x.copy(), np.array_equal(y, x)))
            return y

        server = Server(cfg, p, batch_slots=2, max_len=32,
                        pum_offload=watched, device=device)
        reqs = [Request(prompt=pr, max_new=4) for pr in ([5, 6, 7], [9], [3])]
        for r in reqs:
            server.submit(r)
        server.run(max_steps=64)
        assert all(r.done for r in reqs) and all(ok for _, ok in given)
        return stats(off), [x for x, _ in given]

    want_stats, given = serve("cpu", params)
    build.reset_launches()
    got_stats, _ = serve(cuda, _on(params, cuda))
    assert build.LAUNCHES["replay"] == got_stats["rounds"] > 0
    off = PumServeOffload(chip=SimdramChip(n_banks=2, n_subarrays=2,
                                           device=cuda))
    for x in given:
        assert np.array_equal(off(x), x)
    fed = stats(off)
    assert fed.keys() == want_stats.keys()
    for k, v in want_stats.items():
        assert np.array_equal(np.asarray(fed[k]), np.asarray(v)), k


# -- training -------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)


def _train_steps(cfg, device, params, steps=2, n_microbatches=1):
    """``steps`` train steps on ``synth_batch``es on ``device``: the final
    params and each step's metrics (eps 1e-3: see
    tests/test_torch_train_step.py)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.train_loop import make_train_step
    step = make_train_step(cfg, opt.AdamWConfig(**TRAIN_OPT),
                           n_microbatches=n_microbatches)
    state, metrics = opt.init(params), []
    for s in range(steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in synth_batch(
            cfg, DataConfig(16, 4, 0), s).items()}
        params, state, m = step(params, state, b)
        metrics.append(m)
    return params, metrics


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", _smoke_arch_names())
def test_train_step_on_card_equals_cpu(cuda, arch, n_microbatches):
    """Every arch at smoke_config (float32): two train steps on the card,
    their losses, grad norms and final params within 1e-3 of the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.params import flatten
    from repro_torch.models.transformer import init_lm
    cfg = smoke_config(arch).replace(param_dtype="float32")
    params = init_lm(cfg, device="cpu")
    want_p, want_m = _train_steps(cfg, "cpu", params,
                                  n_microbatches=n_microbatches)
    got_p, got_m = _train_steps(cfg, cuda, _on(params, cuda),
                                n_microbatches=n_microbatches)
    for g, w in zip(got_m, want_m):
        for k in ("loss", "aux", "grad_norm", "lr"):
            torch.testing.assert_close(g[k].cpu(), w[k], rtol=LM_TOL,
                                       atol=LM_TOL)
    for g, w in zip(flatten(got_p), flatten(want_p)):
        torch.testing.assert_close(g.cpu(), w, rtol=LM_TOL, atol=LM_TOL)


def test_pum_train_step_on_card_launches_k3(cuda):
    """The PuM relu MLP trains on the card through K3 (forward and
    recompute), ``up`` moves by decay alone, and the params equal the
    CPU's within 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.params import flatten
    from repro_torch.models.transformer import init_lm
    cfg = smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", pum_bits=8, param_dtype="float32")
    params = init_lm(cfg, device="cpu")
    want, _ = _train_steps(cfg, "cpu", params)
    build.reset_launches()
    got, _ = _train_steps(cfg, cuda, _on(params, cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES["circuit"] >= 2 * (cfg.n_layers
                                             + cfg.n_encoder_layers)
    for g, w in zip(flatten(got), flatten(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=LM_TOL, atol=LM_TOL)
    assert torch.equal(got["blocks"]["mlp"]["up"]["w"].cpu(),
                       want["blocks"]["mlp"]["up"]["w"])


def test_checkpoint_roundtrip_on_card(cuda, tmp_path):
    """A card tree (bf16, fp32 and an OptState) saved and restored onto
    the card ``==``; a flipped byte makes restore raise."""
    from repro_torch.models.params import flatten
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    tree = {"w": torch.randn(64, 300, device=cuda).to(torch.bfloat16),
            "b": {"g": torch.randn(4096, device=cuda)}}
    state = opt.init(tree)
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, {"p": tree, "s": state})
    back = ckpt.restore(d, 2, {"p": tree, "s": state}, device=cuda)
    assert isinstance(back["s"], opt.OptState)
    for a, b in zip(flatten({"p": tree, "s": state}), flatten(back)):
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    shard = tmp_path / "ck" / "step_00000002" / "shard_0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore(d, 2, {"p": tree, "s": state}, device=cuda)


def test_compressed_grad_transform_on_card_equals_cpu(cuda):
    from repro_torch.models.params import flatten
    from repro_torch.train.compression import compressed_grad_transform
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.normal(size=(33, 70)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=513).astype(
            np.float32))}
    res = {k: 1e-3 * torch.ones_like(v) for k, v in grads.items()}
    want = compressed_grad_transform(res)(grads)
    got = compressed_grad_transform(_on(res, cuda))(_on(grads, cuda))
    for g, w in zip(flatten(got), flatten(want)):
        assert torch.equal(g.cpu(), w)


def test_resumed_training_on_card_is_exact(cuda, tmp_path, monkeypatch):
    """launch.train on the card: a run's step-2 checkpoints, moved to a
    new directory, resume it bit for bit under deterministic algorithms."""
    import shutil

    import torch.utils.deterministic as deterministic

    from repro_torch.launch.train import train
    from repro_torch.models.params import flatten
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    a, b = tmp_path / "A", tmp_path / "B"
    kw = dict(arch="internvl2-1b", steps=4, seq_len=32, batch=4,
              n_microbatches=2, ckpt_every=2, device=cuda)
    fill = deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        ra = train(ckpt_dir=str(a), **kw)
        for suffix in ("", "_opt"):
            shutil.copytree(f"{a}{suffix}/step_00000002",
                            f"{b}{suffix}/step_00000002")
        rb = train(ckpt_dir=str(b), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
        deterministic.fill_uninitialized_memory = fill
    assert [r["step"] for r in rb["logs"]] == [3, 4]
    assert [r["loss"] for r in rb["logs"]] == [r["loss"] for r in
                                               ra["logs"][2:]]
    for x, y in zip(flatten(rb["params"]), flatten(ra["params"])):
        assert torch.equal(x, y)


# the examples of examples_torch/ on the card: the launches of each
# example that launches a kernel (chip_smoke.py phase 14 holds every one
# against the plain version and each example's results against its CPU
# run); chip_offload's decode steps set its K5 count, so it is bounded
EXAMPLE_LAUNCHES = {
    "quickstart": {"h2v": 2, "v2h": 1, "circuit": 2, "replay": 1},
    "bank_scaling_quickstart": {"replay": 3},
    "fused_dispatch_quickstart": {"h2v": 1, "v2h": 4, "replay": 13},
    "compaction_quickstart": {"v2h": 2, "replay": 18},
    "simdram_database": {"circuit": 21},
    "chip_offload_quickstart": {"v2h": 3, "replay": None},
    "channel_quickstart": {"v2h": 3, "replay": 6},
    "rank_overlap_quickstart": {"v2h": 3, "replay": 16},
    "fault_tolerance_quickstart": {"replay": 8, "faulty_replay": 21},
    "telemetry_quickstart": {"replay": 2, "faulty_replay": 4},
    "serving_quickstart": {"replay": 3, "faulty_replay": 6},
    "pum_offload_demo": {"circuit": 4},
}


@pytest.mark.parametrize("name", sorted(EXAMPLE_LAUNCHES))
def test_example_launches_its_kernels(cuda, name, tmp_path, monkeypatch):
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    from repro_torch import obs
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", root / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    # the telemetry example exports to /tmp; here under tmp_path
    for fn in ("write_chrome_trace", "write_jsonl"):
        orig = getattr(obs, fn)
        monkeypatch.setattr(obs, fn, lambda path, *a, _f=orig, **k: _f(
            str(tmp_path / Path(path).name), *a, **k))
    build.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main(["--device", "cuda"])
    torch.cuda.synchronize()
    got = {k: v for k, v in build.LAUNCHES.items() if v}
    want = EXAMPLE_LAUNCHES[name]
    assert got.keys() == want.keys(), got
    assert all(got[k] == n or (n is None and got[k] > 0)
               for k, n in want.items()), got
    assert out["launches"] == build.LAUNCHES


# -- the LM side over a mesh of cuda:0 positions (chip_smoke.py phase 16) ----

def _card_mesh(sizes, axes):
    from repro_torch.launch.mesh import Mesh
    return Mesh(sizes, axes, [torch.device("cuda", 0)] * int(np.prod(sizes)))


def _smoke_moe():
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_lm
    cfg = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")
    gen = torch.Generator().manual_seed(21)
    p = {k: v[0] for k, v in init_lm(cfg, generator=gen, device="cpu")
         ["blocks"]["moe"].items()}
    return cfg, p, torch.randn((4, 8, cfg.d_model), generator=gen)


@pytest.mark.parametrize("sizes", [(1, 4), (2, 4), (4, 2)])
def test_moe_ep_on_card_positions_equals_cpu_positions(cuda, sizes):
    """moe_forward_ep over cuda:0 repeated (a stream a position) against
    the same mesh of CPU positions, within rtol = atol = 1e-4 (float32,
    no TF32); the positions' streams are the mesh's own."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import moe_forward_ep
    cfg, p, x = _smoke_moe()
    n = int(np.prod(sizes))
    kw = dict(top_k=cfg.experts_per_token, act=cfg.act)
    want = moe_forward_ep(p, x, mesh=Mesh(sizes, ("data", "model"),
                                          [torch.device("cpu")] * n), **kw)
    mesh = _card_mesh(sizes, ("data", "model"))
    got = moe_forward_ep({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                         mesh=mesh, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)
    assert len(mesh._streams) == n
    assert torch.cuda.default_stream(cuda) not in mesh._streams.values()


def test_server_serves_moe_ep_on_card_positions(cuda):
    """Smoke granite-moe-1b-a400m with moe_impl="ep" served on the card
    under a (1, 4) mesh of cuda:0 through PumServeOffload on a card chip:
    K5 launched once a chip round; every step's logits within rtol =
    atol = 1e-4 of the grouped server's on the card, tokens equal."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.chip import SimdramChip
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.serve import PumServeOffload, Request, Server
    cfg = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")
    from repro_torch.models.params import tree_map
    params = tree_map(lambda t: t.to(cuda), init_lm(
        cfg, generator=torch.Generator().manual_seed(22), device="cpu"))

    def serve(c, mesh):
        off = PumServeOffload(chip=SimdramChip(n_banks=4, n_subarrays=2,
                                               device=cuda))
        server = Server(c, params, batch_slots=4, max_len=32,
                        pum_offload=off, device=cuda)
        step, logits = server.step_fn, []

        def kept(*args):
            out = step(*args)
            logits.append(out[0].cpu())
            return out

        server.step_fn = kept
        reqs = [Request(prompt=p, max_new=4)
                for p in ([5, 6, 7], [9, 3], [11, 12, 13, 14], [2])]
        for r in reqs:
            server.submit(r)
        before = build.LAUNCHES["replay"]
        with mesh if mesh is not None else contextlib.nullcontext():
            server.run()
        torch.cuda.synchronize()
        assert build.LAUNCHES["replay"] - before == off.chip.stats.rounds > 0
        return [r.out for r in reqs], torch.stack(logits)

    ep = serve(cfg.replace(moe_impl="ep"), _card_mesh((1, 4),
                                                       ("data", "model")))
    grouped = serve(cfg, None)
    torch.testing.assert_close(ep[1], grouped[1], rtol=1e-4, atol=1e-4)
    assert ep[0] == grouped[0]


def test_elastic_drill_on_card_positions(cuda, tmp_path, monkeypatch):
    """The elastic drill on cuda:0 positions under deterministic
    algorithms: 4 sharded steps on (4, 2), checkpoint, reshard_restore
    onto (2, 2), 4 more; the 8 losses == the unsharded card run's."""
    import torch.utils.deterministic as deterministic

    from repro_torch.configs import smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.train_loop import make_train_step
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = smoke_config("yi-6b").replace(param_dtype="float32")
    p0 = init_lm(cfg, generator=torch.Generator(cuda).manual_seed(23),
                 device=cuda)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in synth_batch(
        cfg, DataConfig(seq_len=32, global_batch=8, seed=0), s).items()}
        for s in range(8)]
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, eps=1e-3,
                                                warmup_steps=2,
                                                total_steps=40))

    def sharded(sizes):
        m = _card_mesh(sizes, ("data", "model"))
        ps = shd.param_shardings(p0, m)
        os_ = shd.opt_shardings(opt.init(p0), p0, m)
        return ps, os_, shd.sharded_step(
            step, (ps, os_, shd.batch_shardings(batches[0], m)),
            (ps, os_, None))

    fill = deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        params, state, straight = p0, opt.init(p0), []
        for b in batches:
            params, state, m = step(params, state, b)
            straight.append(float(m["loss"]))
        ps, os_, step8 = sharded((4, 2))
        params, state = shd.place(p0, ps), shd.place(opt.init(p0), os_)
        losses = []
        for b in batches[:4]:
            params, state, m = step8(params, state, b)
            losses.append(float(m["loss"]))
        ckpt.save(str(tmp_path / "p"), 4, params)
        ckpt.save(str(tmp_path / "o"), 4, state)
        ps4, os4, step4 = sharded((2, 2))
        params = ckpt.reshard_restore(str(tmp_path / "p"), 4, p0, ps4)
        state = ckpt.reshard_restore(str(tmp_path / "o"), 4, opt.init(p0),
                                     os4)
        for b in batches[4:]:
            params, state, m = step4(params, state, b)
            losses.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
        deterministic.fill_uninitialized_memory = fill
    assert losses == straight
    assert all(s.is_cuda for s in params["embed"]["emb"].shards)


def test_gpipe_on_card_positions_uses_their_streams(cuda):
    """gpipe over 4 positions of cuda:0: each stage computes on its
    position's own stream; the output within 2e-5 of the sequential
    blocks and the gradients within rtol 5e-4, atol 5e-5."""
    from repro_torch.distributed.pipeline import gpipe, split_stages
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.normal(size=(8, 16, 16)) * 0.3).astype(
        np.float32)).to(cuda).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).to(cuda)
    mesh = _card_mesh((4,), ("pod",))
    seen = []

    def stage_fn(stage_ws, h):
        seen.append(torch.cuda.current_stream(h.device))
        for w in stage_ws:
            h = torch.tanh(h @ w)
        return h

    out = gpipe(stage_fn, split_stages(ws, 4), x, mesh=mesh, n_micro=4)
    streams = [mesh._streams[k] for k in range(4)]
    assert seen == streams * 7
    assert torch.cuda.default_stream(cuda) not in streams
    seq = x
    for i in range(8):
        seq = torch.tanh(seq @ ws[i])
    torch.testing.assert_close(out, seq, rtol=2e-5, atol=2e-5)
    g_pipe, = torch.autograd.grad((out ** 2).sum(), ws)
    g_seq, = torch.autograd.grad((seq ** 2).sum(), ws)
    torch.testing.assert_close(g_pipe, g_seq, rtol=5e-4, atol=5e-5)
