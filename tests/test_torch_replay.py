"""K5 (the command-table replay): the port's plain version against the
JAX package's scan interpreters, on the reference's own tables and
states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as ref_bank
from repro.core import control_unit as ref_cu
from repro_torch.core import control_unit as cu

HETERO = [("addition", 8), ("greater", 8), ("relu", 16), ("bitcount", 8),
          ("multiplication", 8)]


def _ref_wave(ops, lanes=128, seed=0):
    """Host states and tables of one hetero wave, built by the reference."""
    rng = np.random.default_rng(seed)
    metas = [ref_bank.cached_table(op, w, "mig") for op, w in ops]
    n_rows = ref_cu.shape_bucket(max(m[1].n_rows_total for m in metas), 16)
    states = np.zeros((len(ops), n_rows, lanes // 32), np.uint32)
    for s, (spec, uprog, _) in enumerate(metas):
        vals = [rng.integers(0, 1 << b, lanes).astype(np.uint64)
                for b in spec.operand_bits]
        ref_cu.load_state(uprog, vals, lanes, n_rows=n_rows, out=states[s])
    return states, [m[2] for m in metas]


def test_hetero_replay_matches_reference_on_reference_tables():
    states, tables = _ref_wave(HETERO)
    width = max(t.shape[0] for t in tables)
    stacked = np.stack([ref_cu.pad_command_table(t, width) for t in tables])
    want = np.asarray(ref_cu.hetero_batched_interpreter()(
        jnp.asarray(states), jnp.asarray(stacked)))
    got = cu.hetero_batched_interpreter("cpu")(
        states, cu.tables_from_numpy(tables, device="cpu"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("op,n_bits", [("addition", 8), ("if_else", 8),
                                       ("xor_red", 16)])
def test_run_command_table_matches_reference(op, n_bits):
    states, tables = _ref_wave([(op, n_bits)], lanes=96, seed=n_bits)
    raw = ref_cu.encode_uprogram(ref_bank.cached_table(op, n_bits)[1])
    want = np.asarray(ref_cu.make_interpreter()(
        jnp.asarray(states[0]), jnp.asarray(raw)))
    got = cu.run_command_table(states[0], raw, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    run = cu.make_interpreter("cpu")
    np.testing.assert_array_equal(run(states[0], raw).numpy(), got.numpy())


def test_shared_table_batched_replay_matches_reference():
    spec, uprog, table = ref_bank.cached_table("subtraction", 8)
    rng = np.random.default_rng(4)
    n_rows = uprog.n_rows_total
    states = np.stack([
        ref_cu.load_state(uprog, [rng.integers(0, 256, 64).astype(np.uint64)
                                  for _ in range(2)], 64)
        for _ in range(3)])
    want = np.asarray(ref_cu.batched_interpreter()(
        jnp.asarray(states), jnp.asarray(table)))
    got = cu.batched_interpreter("cpu")(states, table)
    assert got.shape == (3, n_rows, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_tables_from_numpy_pads_with_nops():
    a = np.ones((3, 13), np.int32)
    b = np.zeros((5, 13), np.int32)
    t, schedule = cu.tables_from_numpy([a, b], device="cpu", n_cmds=8)
    assert t.shape == (2, 8, 13) and t.dtype == torch.int32
    assert t[0, 3:].abs().sum() == 0 and t[0, :3].eq(1).all()
    assert schedule.tolist() == [[3, 0], [0, 1]]


@pytest.mark.parametrize("bad,match", [
    (np.full((1, 13), 0, np.int32) + np.eye(1, 13, 1, dtype=np.int32) * 99,
     "outside"),
    (np.eye(1, 13, 2, dtype=np.int32) * 2, "0 or 1"),
    (np.zeros((2, 12), np.int32), "n_cmds, 13"),
])
def test_malformed_host_tables_are_rejected(bad, match):
    with pytest.raises(ValueError, match=match):
        cu.run_command_table(np.zeros((16, 2), np.uint32), bad, device="cpu")


def test_nop_rows_are_inert():
    states, tables = _ref_wave([("addition", 8)], lanes=64)
    padded = cu.pad_command_table(tables[0], 4 * tables[0].shape[0])
    a = cu.run_command_table(states[0], tables[0], device="cpu")
    b = cu.run_command_table(states[0], padded, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
