"""K5's and K6's early stop: each unit replays only up to its last real
command.  The per-unit counts and the block order the port works out
(``command_schedule``), and the plain replays of tables cut at those
counts against the padded tables and against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as ref_bank
from repro.core import control_unit as ref_cu
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core.ops_library import ALL_OPS, get_op

MIX_OPS = ("addition", "multiplication", "greater", "and_red")


def _last_real_plus_one(table: np.ndarray) -> int:
    """Index of the last command that is not all zeros, + 1 (0 if none)."""
    live = np.flatnonzero(np.asarray(table).reshape(-1, 13).any(axis=1))
    return int(live[-1]) + 1 if live.size else 0


def _mix_queue(mod, lanes=256, n_instrs=8, seed=0):
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(n_instrs):
        op = MIX_OPS[i % len(MIX_OPS)]
        w = (8, 16)[(i // len(MIX_OPS)) % 2]
        ops = tuple(rng.integers(0, 1 << b, lanes).astype(np.uint64)
                    for b in get_op(op, w).operand_bits)
        queue.append(mod.BbopInstr(op, ops, w))
    return queue


def _mix_waves(n_subarrays=4):
    """The mix queue's packed waves on the port (CPU) and the reference:
    ``[(port states, port CommandTables, reference tables)]``."""
    pt = pt_bank.Bank(n_subarrays=n_subarrays, device="cpu")
    ref = ref_bank.Bank(n_subarrays=n_subarrays)
    out = []
    for bank, mod in ((pt, pt_bank), (ref, ref_bank)):
        queue = _mix_queue(mod)
        lanes, stage, _ = mod.plan_queue(queue)
        waves = bank._build_waves(queue, list(range(len(queue))), stage,
                                  lanes)
        out.append([bank._pack_wave(queue, w, lanes, {})[:2]
                    for w in waves])
    return [(s, t, np.asarray(rt)) for (s, t), (_, rt) in zip(*out)]


def _cut_replay(replay_one, states, tables, counts):
    """Replay each unit alone on its table cut at its count."""
    return torch.cat([replay_one(u, tables[u, :int(counts[u])])
                      for u in range(states.shape[0])])


@pytest.mark.parametrize("style", ["mig", "aig"])
@pytest.mark.parametrize("n_bits", [8, 16])
@pytest.mark.parametrize("op", ALL_OPS)
def test_count_is_last_real_command_plus_one(op, n_bits, style):
    _, uprog, table = pt_bank.cached_table(op, n_bits, style)
    schedule = cu.command_schedule(table[None])
    want = _last_real_plus_one(table)
    assert schedule.dtype == torch.int32
    assert schedule.tolist() == [[want], [0]]
    assert 0 < want <= len(uprog.commands) <= table.shape[0]


def test_mix_wave_counts_and_tables_match_the_reference():
    for states, (tables, schedule), ref_tables in _mix_waves():
        np.testing.assert_array_equal(tables.numpy(), ref_tables)
        want = [_last_real_plus_one(t) for t in ref_tables]
        assert schedule[0].tolist() == want
        assert 0 < min(w for w in want if w) < tables.shape[1]


def test_cached_tables_carry_their_schedule():
    cache = cu.TableCache()
    table = np.zeros((3, 16, 13), np.int32)
    table[0, :5, 1] = 1
    table[2, :9, 0] = 1
    got = cache.get("k", lambda: table, torch.device("cpu"))
    assert got.schedule.tolist() == [[5, 0, 9], [2, 0, 1]]
    assert cache.get("k", lambda: 1 / 0, torch.device("cpu")) is got
    assert cache.stats()["bytes"] == table.nbytes + 2 * 3 * 4


@pytest.mark.parametrize("seed", range(4))
def test_block_order_is_a_permutation_sorted_by_count(seed):
    rng = np.random.default_rng(seed)
    n_units, n_cmds = 17, 40
    counts = rng.integers(0, n_cmds + 1, n_units)
    counts[:3] = counts[3]                       # ties keep unit order
    tables = np.zeros((n_units, n_cmds, 13), np.int32)
    for u, c in enumerate(counts):
        tables[u, :c, 1] = rng.integers(1, 16, c)
    counts_got, order = cu.command_schedule(torch.from_numpy(tables))
    np.testing.assert_array_equal(counts_got.numpy(), counts)
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(n_units))
    want = sorted(range(n_units), key=lambda u: (-counts[u], u))
    assert order.tolist() == want


def test_shared_table_schedule_repeats_its_count():
    _, _, table = pt_bank.cached_table("addition", 8)
    got = cu.command_schedule(torch.from_numpy(table), n_units=3)
    n = _last_real_plus_one(table)
    assert got.tolist() == [[n, n, n], [0, 1, 2]]
    empty = cu.command_schedule(np.zeros((2, 0, 13), np.int32))
    assert empty.tolist() == [[0, 0], [0, 1]]


def test_plain_replay_of_cut_tables_equals_padded():
    for states_np, (tables, schedule), _ in _mix_waves():
        states = torch.from_numpy(states_np.view(np.int32))
        want = cu.replay_plain(states, tables)
        got = _cut_replay(
            lambda u, t: cu.replay_plain(states[u:u + 1], t[None]),
            states, tables, schedule[0])
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("idle", [0, 2])
def test_cpu_replay_with_a_schedule_skips_idle_units_exactly(idle):
    """On the CPU, ``replay`` of a :class:`CommandTables` replays only
    the units with a real command, up to the longest count; bit for bit
    the plain replay of the padded tables, idle (all-NOP) units
    included."""
    for states_np, (tables, schedule), _ in _mix_waves():
        states = torch.from_numpy(states_np.view(np.int32))
        if idle:
            states = torch.cat([states, states[:idle] ^ 0x5A5A5A5A])
            tables = torch.cat([tables, torch.zeros_like(tables[:idle])])
        ct = cu.CommandTables(tables, cu.command_schedule(tables))
        torch.testing.assert_close(cu.replay(states, ct),
                                   cu.replay_plain(states, tables),
                                   rtol=0, atol=0)


def test_reference_padded_equals_port_plain_cut():
    for states_np, (tables, schedule), ref_tables in _mix_waves():
        want = np.asarray(ref_cu.hetero_batched_interpreter()(
            jnp.asarray(states_np), jnp.asarray(ref_tables)))
        states = torch.from_numpy(states_np.view(np.int32))
        got = _cut_replay(
            lambda u, t: cu.replay_plain(states[u:u + 1], t[None]),
            states, tables, schedule[0])
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("p_flip", [1e-3, 0.25])
def test_faulty_plain_replay_of_cut_tables_equals_padded(p_flip):
    rng = np.random.default_rng(7)
    for states_np, (tables, schedule), _ in _mix_waves():
        states = torch.from_numpy(states_np.view(np.int32))
        n_units, _, n_words = states.shape
        keys = torch.from_numpy(rng.integers(0, 2**32, (n_units, 2),
                                             dtype=np.uint32).view(np.int32))
        s1 = torch.from_numpy(
            (rng.integers(0, 2**32, (n_units, n_words), dtype=np.uint32)
             & np.uint32(0x00400001)).view(np.int32))
        s0 = torch.from_numpy(
            (rng.integers(0, 2**32, (n_units, n_words), dtype=np.uint32)
             & np.uint32(0x02000100)).view(np.int32))
        dead = torch.zeros(n_units, dtype=torch.bool)
        dead[1] = True
        want, n_want = cu.faulty_replay_plain(states, tables, keys, s0, s1,
                                              dead, p_flip)
        parts = [cu.faulty_replay_plain(
            states[u:u + 1], tables[u:u + 1, :int(schedule[0, u])],
            keys[u:u + 1], s0[u:u + 1], s1[u:u + 1], dead[u:u + 1], p_flip)
            for u in range(n_units)]
        torch.testing.assert_close(torch.cat([p[0] for p in parts]), want,
                                   rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([p[1] for p in parts]), n_want,
                                   rtol=0, atol=0)
        assert int(n_want.sum()) > 0


def test_replay_checks_a_given_schedule():
    states = torch.zeros((2, 16, 3), dtype=torch.int32)
    tables, schedule = cu.tables_from_numpy(
        [np.ones((2, 13), np.int32), np.zeros((2, 13), np.int32)],
        device="cpu")
    assert schedule.tolist() == [[2, 0], [0, 1]]
    with pytest.raises(ValueError, match="schedule must be int32"):
        cu._kernel_schedule(states, tables, schedule[:, :1])
    with pytest.raises(ValueError, match="at most 256 state rows"):
        cu._kernel_schedule(torch.zeros((2, 257, 3), dtype=torch.int32),
                            tables, schedule)
    assert cu._kernel_schedule(states, tables, None).tolist() == \
        schedule.tolist()


def test_entry_points_take_command_tables():
    """replay, faulty_bank_replay and the interpreters take the tables
    with their schedule as they take the bare tensor."""
    rng = np.random.default_rng(3)
    for states_np, ct, _ in _mix_waves():
        states = torch.from_numpy(states_np.view(np.int32))
        n_units, _, n_words = states.shape
        want = cu.replay_plain(states, ct.tables)
        for got in (cu.replay(states, ct),
                    cu.hetero_batched_interpreter("cpu")(states_np, ct)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        keys = torch.from_numpy(rng.integers(0, 2**32, (n_units, 2),
                                             dtype=np.uint32).view(np.int32))
        zeros = torch.zeros((n_units, n_words), dtype=torch.int32)
        dead = torch.zeros(n_units, dtype=torch.bool)
        args = (keys, zeros, zeros, dead, 0.01)
        want, n_want = cu.faulty_replay_plain(states, ct.tables, *args)
        for got, n_got in (cu.faulty_bank_replay(states, ct, *args),
                           cu.faulty_batched_interpreter("cpu")(
                               states, ct, *args)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            torch.testing.assert_close(n_got, n_want, rtol=0, atol=0)
