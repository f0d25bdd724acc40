"""The ladder split across devices on the port, against the JAX package,
on the CPU.

Mirrors the reference's sharded-executor cases of ``tests/test_chip.py``,
``test_channel.py`` and ``test_rank.py``
(``test_sharded_executor_multi_device`` and the forced-device
subprocesses), which the reference runs over the
host devices ``--xla_force_host_platform_device_count`` makes.  The
port's mesh names ``torch.device("cpu")`` 2, 4 or 8 times instead; each
position replays its slab of a round on its own.

- ``pum_mesh``, ``channel_mesh`` and ``rank_mesh`` give the reference's
  shapes over 1-8 devices (the reference's, built in one subprocess with
  8 forced host devices: meshes only, nothing compiled);
- the split chip, channel and rank give results and every modeled
  ``*Stats`` field ``==`` the reference's unsplit run and the port's,
  MIG and AIG, with one replay a slab of every round;
- the split fault wrappers of the chip and channel: stuck-only ``==``
  the reference; with flips ``==`` the port's unsplit run, flip counts
  and ``FaultStats`` included;
- ``describe()`` and the ``pum.executor`` events ``==`` the reference's;
- a mesh that is not a :class:`Mesh`, is abstract or names a missing
  device raises.
"""

import functools
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bank as ref_bank
from repro.core import channel as ref_channel
from repro.core import chip as ref_chip
from repro.core import fault as ref_fault
from repro.core import rank as ref_rank
from repro_torch.core import bank as pt_bank
from repro_torch.core import control_unit as cu
from repro_torch.core import telemetry as pt_telemetry
from repro_torch.core.channel import SimdramChannel
from repro_torch.core.chip import SimdramChip
from repro_torch.core.fault import FaultExhaustedError, FaultModel
from repro_torch.core.ops_library import get_op
from repro_torch.core.rank import SimdramRank
from repro_torch.distributed import pum
from repro_torch.launch.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = torch.device("cpu")
LANES = 64
MEASURED = ("wall_s", "pack_wall_s")

# the grids the mesh builders are held to, over 1-8 devices
BANKS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16)
CHANNEL_GRIDS = [(c, b) for c in (1, 2, 3, 4, 8) for b in (1, 2, 3, 4, 6, 16)]
RANK_GRIDS = [(r, c, b) for r in (1, 2, 3) for c in (1, 2, 4)
              for b in (1, 2, 3, 4)]

# executors built over a given mesh: (tier, fault, unit counts, mesh axes,
# mesh sizes, use_shard_map); sizes that do not divide the units give the
# unsplit executor, which still reports the mesh
EXECUTORS = [
    ("chip", False, (4,), ("data",), (4,), None),
    ("chip", False, (4,), ("data",), (2,), True),
    ("chip", False, (4,), ("data",), (3,), None),
    ("chip", False, (4,), ("data",), (4,), False),
    ("chip", False, (4,), ("data", "model"), (2, 2), None),
    ("chip", True, (4,), ("data",), (4,), None),
    ("channel", False, (2, 4), ("channel", "data"), (2, 4), True),
    ("channel", False, (2, 4), ("channel", "data"), (1, 2), None),
    ("channel", False, (2, 4), ("channel", "data"), (2, 3), None),
    ("channel", True, (2, 2), ("channel", "data"), (2, 2), None),
    ("rank", False, (2, 2, 2), ("rank", "channel", "data"), (2, 2, 2), True),
    ("rank", False, (2, 2, 2), ("rank", "channel", "data"), (2, 1, 1), None),
    ("rank", False, (2, 2, 2), ("rank", "channel", "data"), (1, 1, 1), None),
]

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.core import telemetry
    from repro.distributed import pum

    banks, channel, rank, executors = json.loads(sys.argv[1])
    devs = jax.devices()
    assert len(devs) == 8, devs

    def shape(m):
        return None if m is None else [
            list(m.axis_names), [int(m.shape[a]) for a in m.axis_names]]

    out = {"pum": {}, "channel": {}, "rank": {}, "executors": []}
    for k in range(1, 9):
        d = devs[:k]
        out["pum"][k] = [shape(pum.pum_mesh(n, d)) for n in banks]
        out["channel"][k] = [shape(pum.channel_mesh(c, b, d))
                             for c, b in channel]
        out["rank"][k] = [shape(pum.rank_mesh(r, c, b, d))
                          for r, c, b in rank]
    make = {("chip", False): pum.make_chip_executor,
            ("chip", True): pum.make_faulty_chip_executor,
            ("channel", False): pum.make_channel_executor,
            ("channel", True): pum.make_faulty_channel_executor,
            ("rank", False): pum.make_rank_executor}
    for tier, fault, units, axes, sizes, use in executors:
        mesh = Mesh(np.array(devs[:int(np.prod(sizes))]).reshape(sizes),
                    tuple(axes))
        with telemetry.enabled() as tr:
            ex = make[(tier, fault)](*units, mesh=mesh, use_shard_map=use)
        events = [dict(s.attrs) for r in tr.roots for s in r.walk()
                  if s.name == "pum.executor"]
        out["executors"].append({"describe": ex.describe(),
                                 "events": events})
    print("REF_MESHES " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    """The reference's mesh shapes, ``describe()`` and events, from one
    subprocess with 8 forced host devices (meshes only; a jitted
    ``shard_map`` is wrapped, never compiled)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    args = json.dumps([BANKS, CHANNEL_GRIDS, RANK_GRIDS, EXECUTORS])
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, args],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("REF_MESHES "))
    return json.loads(line[len("REF_MESHES "):])


def _shape(m):
    return None if m is None else [list(m.axis_names),
                                   [m.shape[a] for a in m.axis_names]]


# --- the meshes -------------------------------------------------------------

@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("tier", ["pum", "channel", "rank"])
def test_mesh_shapes_equal_reference(reference, tier, k):
    """The largest grid that divides the unit axes, devices on the outer
    axes at equal totals, None below two devices: over ``k`` devices,
    every tested grid ``==`` the reference's."""
    devs = [CPU] * k
    if tier == "pum":
        got = [_shape(pum.pum_mesh(n, devs)) for n in BANKS]
    elif tier == "channel":
        got = [_shape(pum.channel_mesh(c, b, devs)) for c, b in CHANNEL_GRIDS]
    else:
        got = [_shape(pum.rank_mesh(r, c, b, devs)) for r, c, b in RANK_GRIDS]
    assert got == reference[tier][str(k)]


def test_one_visible_device_builds_no_mesh():
    """Without ``devices`` a mesh spans the visible devices of the tier's
    type: the one CPU here, so no mesh, and every tier is unsplit."""
    assert pum.visible_devices("cpu") == [CPU]
    assert pum.pum_mesh(4, device="cpu") is None
    assert pum.channel_mesh(2, 4, device="cpu") is None
    assert pum.rank_mesh(2, 2, 2, device="cpu") is None
    for eng in (SimdramChip(n_banks=4, device="cpu"),
                SimdramChannel(device="cpu"), SimdramRank(device="cpu")):
        assert not eng.executor.sharded and eng.executor.mesh is None


@pytest.mark.parametrize("case", range(len(EXECUTORS)))
def test_executor_describe_and_event_equal_reference(reference, case):
    """``describe()`` and the ``pum.executor`` event (kind, sharded,
    devices) ``==`` the reference's for the same mesh; an unsplit
    executor handed a mesh reports the mesh's size, as the reference's
    does."""
    tier, fault, units, axes, sizes, use = EXECUTORS[case]
    make = {("chip", False): pum.make_chip_executor,
            ("chip", True): pum.make_faulty_chip_executor,
            ("channel", False): pum.make_channel_executor,
            ("channel", True): pum.make_faulty_channel_executor,
            ("rank", False): pum.make_rank_executor}[(tier, fault)]
    mesh = Mesh(sizes, axes, [CPU] * math.prod(sizes))
    with pt_telemetry.enabled() as tr:
        ex = make(*units, mesh=mesh, use_shard_map=use, device="cpu")
    events = [dict(s.attrs) for r in tr.roots for s in r.walk()
              if s.name == "pum.executor"]
    want = reference["executors"][case]
    assert ex.describe() == want["describe"]
    assert events == want["events"]


# --- meshes the split refuses ------------------------------------------------

def test_a_mesh_must_name_devices_that_exist():
    """No fallback: a mesh that is not a Mesh, an abstract one, one whose
    devices are of another type than the tier's, or one that names a
    card that does not exist, raises."""
    with pytest.raises(ValueError, match="mesh"):
        SimdramChip(n_banks=4, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="abstract"):
        SimdramChip(n_banks=4, mesh=Mesh((2,), ("data",)), device="cpu")
    missing = Mesh((2,), ("data",), [CPU, torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="cuda:1"):
        SimdramChip(n_banks=4, mesh=missing, device="cpu")
    with pytest.raises(ValueError, match="cuda:1"):
        SimdramChannel(n_chips=2, n_banks=2, mesh=Mesh(
            (1, 2), ("channel", "data"), missing.devices), device="cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cards = Mesh((2,), ("data",), [torch.device("cuda", n),
                                   torch.device("cuda", n + 1)])
    with pytest.raises(ValueError, match="does not exist"):
        pum._check_mesh(cards, torch.device("cuda"))


def test_shard_map_true_needs_a_mesh_that_fits():
    """``use_shard_map=True`` over a mesh that does not divide the units
    raises with the reference's text; over the one CPU as well."""
    with pytest.raises(ValueError, match="shard_map requested but no "
                       "multi-device mesh fits n_banks=4"):
        SimdramChip(n_banks=4, use_shard_map=True, device="cpu",
                    mesh=Mesh((3,), ("data",), [CPU] * 3))
    with pytest.raises(ValueError, match=r"\(channel, data\) mesh fits "
                       "n_chips=2 × n_banks=4"):
        SimdramChannel(n_chips=2, n_banks=4, use_shard_map=True,
                       device="cpu")
    with pytest.raises(ValueError, match=r"\(rank, channel, data\) mesh "
                       "fits n_channels=2 × n_chips=2 × n_banks=2"):
        SimdramRank(use_shard_map=True, device="cpu")


# --- the split tiers against the reference ---------------------------------

def _rand_instr(mod, rng, op, n_bits, lanes=LANES, **kw):
    spec = get_op(op, n_bits)
    ops = tuple(rng.integers(0, 1 << w, lanes).astype(np.uint64)
                for w in spec.operand_bits)
    return mod.BbopInstr(op, ops, n_bits, **kw)


def _queue(mod, seed):
    """The reference's ``test_sharded_executor_multi_device`` queue: four
    ops at 8 and 16 bits, then a product whose relu stays vertical."""
    rng = np.random.default_rng(seed)
    queue = [_rand_instr(mod, rng, op, w)
             for op in ("addition", "multiplication", "greater", "min")
             for w in (8, 16)]
    base = len(queue)
    queue.append(_rand_instr(mod, rng, "multiplication", 8))
    queue.append(mod.BbopInstr("relu", (mod.Ref(base),), 8,
                               keep_vertical=True))
    return queue


def _values(result):
    outs = result if isinstance(result, tuple) else (result,)
    return [o.to_values() if hasattr(o, "to_values") else np.asarray(o)
            for o in outs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        fa, fb = _values(a), _values(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y, err_msg=f"instr {i}")


def _modeled(stats):
    return {k: v for k, v in stats.as_dict().items() if k not in MEASURED}


# tier -> (reference class, port class, geometry, queue seed, mesh axes)
TIERS = {
    "chip": (ref_chip.SimdramChip, SimdramChip,
             dict(n_banks=4, n_subarrays=2), 10, ("data",)),
    "channel": (ref_channel.SimdramChannel, SimdramChannel,
                dict(n_chips=2, n_banks=4, n_subarrays=2), 11,
                ("channel", "data")),
    "rank": (ref_rank.SimdramRank, SimdramRank,
             dict(n_channels=2, n_chips=2, n_banks=2, n_subarrays=2), 11,
             ("rank", "channel", "data")),
}


@functools.lru_cache(maxsize=None)
def _unsplit(tier, style):
    """(reference results, reference modeled stats, port results, port
    modeled stats) of the tier's queue, both unsplit."""
    ref_cls, pt_cls, geo, seed, _ = TIERS[tier]
    ref = ref_cls(style=style, use_shard_map=False, **geo)
    port = pt_cls(style=style, use_shard_map=False, device="cpu", **geo)
    return (ref.dispatch(_queue(ref_bank, seed)), _modeled(ref.stats),
            port.dispatch(_queue(pt_bank, seed)), _modeled(port.stats))


SPLITS = [("chip", (2,)), ("chip", (4,)),
          ("channel", (2, 1)), ("channel", (2, 2)), ("channel", (2, 4)),
          ("rank", (2, 1, 1)), ("rank", (2, 2, 1)), ("rank", (2, 2, 2))]


@pytest.mark.parametrize("style", ["mig", "aig"])
@pytest.mark.parametrize("tier,sizes", SPLITS)
def test_split_tier_equals_reference(monkeypatch, tier, sizes, style):
    """The tier split over 2, 4 or 8 CPU positions: results ``==`` the
    reference's unsplit run and the port's, every modeled stats field
    ``==`` both, and one replay a slab of every round."""
    _, pt_cls, geo, seed, axes = TIERS[tier]
    want, want_stats, port, port_stats = _unsplit(tier, style)
    calls = []
    replay = cu.replay

    def counting(states, tables):
        calls.append(tuple(states.shape))
        return replay(states, tables)

    monkeypatch.setattr(cu, "replay", counting)
    n = math.prod(sizes)
    split = pt_cls(style=style, device="cpu", **geo,
                   mesh=Mesh(sizes, axes, [CPU] * n))
    assert split.executor.sharded and split.executor.mesh.size == n
    got = split.dispatch(_queue(pt_bank, seed))
    _assert_same(got, want)
    _assert_same(got, port)
    assert _modeled(split.stats) == want_stats == port_stats
    rounds = (split.stats.rounds if tier == "chip"
              else split.stats.super_rounds)
    units = math.prod(geo.values())
    assert len(calls) == rounds * n
    assert all(s[0] == units // n for s in calls)


def test_split_chip_repeat_cuts_no_table():
    """A repeated split dispatch misses the table cache no more than the
    unsplit repeat (none), and reuses every slab's tables."""
    mesh = Mesh((4,), ("data",), [CPU] * 4)
    chip = SimdramChip(n_banks=4, n_subarrays=2, device="cpu", mesh=mesh)
    chip.dispatch(_queue(pt_bank, 10))
    cuts = []
    cut = cu._cut_tables
    try:
        cu._cut_tables = lambda *a: cuts.append(a) or cut(*a)
        misses = cu.TABLE_CACHE.stats()["misses"]
        chip.reset_stats()
        chip.dispatch(_queue(pt_bank, 10))
    finally:
        cu._cut_tables = cut
    assert cu.TABLE_CACHE.stats()["misses"] == misses
    assert cuts == []


# --- the fault wrappers ----------------------------------------------------

def _small_queue(mod, seed=3, lanes=LANES):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, lanes).astype(np.uint64)
    b = rng.integers(0, 256, lanes).astype(np.uint64)
    return [mod.BbopInstr("addition", (a, b), 8),
            mod.BbopInstr("min", (a, b), 8),
            mod.BbopInstr("multiplication", (mod.Ref(0), b), 8)]


def _dispatch_or_exhaust(eng, queue, exc):
    try:
        return "ok", eng.dispatch(queue)
    except exc as e:
        return "exhausted", e.context()


FAULT_TIERS = {
    "chip": (ref_chip.SimdramChip, SimdramChip,
             dict(n_banks=2, n_subarrays=2), ("data",), (2,)),
    "channel": (ref_channel.SimdramChannel, SimdramChannel,
                dict(n_chips=2, n_banks=2, n_subarrays=2),
                ("channel", "data"), (2, 2)),
}


def _blacklists(eng):
    chips = eng.chips if hasattr(eng, "chips") else [eng]
    return [b._blacklist for c in chips for b in c.banks]


@pytest.mark.parametrize("kw", [
    {"stuck_lane_rate": 0.02, "spare_lanes": 2, "seed": 13},
    {"stuck_lane_rate": 0.05, "spare_lanes": 0, "seed": 7},
])
@pytest.mark.parametrize("tier", ["chip", "channel"])
def test_split_stuck_only_equals_reference(tier, kw):
    """Stuck columns, no flips: nothing is drawn with jax.random, so the
    split run's results (or exhaustion), ``FaultStats``, modeled stats
    and blacklists ``==`` the reference's unsplit run."""
    ref_cls, pt_cls, geo, axes, sizes = FAULT_TIERS[tier]
    model = dict(p_flip=0.0, **kw)
    ref = ref_cls(use_shard_map=False, fault=ref_fault.FaultModel(**model),
                  **geo)
    port = pt_cls(device="cpu", fault=FaultModel(**model), **geo,
                  mesh=Mesh(sizes, axes, [CPU] * math.prod(sizes)))
    assert port._faulty_executor.sharded
    want = _dispatch_or_exhaust(ref, _small_queue(ref_bank),
                                ref_fault.FaultExhaustedError)
    got = _dispatch_or_exhaust(port, _small_queue(pt_bank),
                               FaultExhaustedError)
    assert got[0] == want[0]
    if got[0] == "ok":
        _assert_same(got[1], want[1])
    else:
        assert got[1] == want[1]
    assert port.stats.faults.as_dict() == ref.stats.faults.as_dict()
    assert _modeled(port.stats) == _modeled(ref.stats)
    assert _blacklists(port) == _blacklists(ref)


def _recorded(eng, outs):
    """``eng``'s faulty executor, keeping each attempt's (states, flip
    counts) as host arrays."""
    run = eng._faulty_executor.run

    def rec(*args):
        st, counts = run(*args)
        outs.append((st.cpu().numpy(), counts.cpu().numpy()))
        return st, counts

    eng._faulty_executor = type(eng._faulty_executor)(
        rec, eng._faulty_executor.mesh, eng._faulty_executor.sharded)


@pytest.mark.parametrize("model", [
    dict(sigma=0.15, spare_lanes=1, seed=0, max_retries=10),
    dict(p_flip=1e-3, stuck_lane_rate=0.02, spare_lanes=2, seed=4),
])
@pytest.mark.parametrize("tier", ["chip", "channel"])
def test_split_flips_equal_unsplit(tier, model):
    """With flips the split run equals the port's unsplit run bit for
    bit: K6's Philox counter is keyed by each unit's own key, so every
    attempt's states and per-unit flip counts, the results, ``FaultStats``
    and the modeled stats are ``==``."""
    _, pt_cls, geo, axes, sizes = FAULT_TIERS[tier]
    geo = dict(geo, n_banks=4)
    sizes = sizes[:-1] + (4,)
    split = pt_cls(device="cpu", fault=FaultModel(**model), **geo,
                   mesh=Mesh(sizes, axes, [CPU] * math.prod(sizes)))
    whole = pt_cls(device="cpu", fault=FaultModel(**model), **geo,
                   use_shard_map=False)
    got_runs, want_runs = [], []
    _recorded(split, got_runs)
    _recorded(whole, want_runs)
    got = _dispatch_or_exhaust(split, _small_queue(pt_bank),
                               FaultExhaustedError)
    want = _dispatch_or_exhaust(whole, _small_queue(pt_bank),
                                FaultExhaustedError)
    assert got[0] == want[0] == "ok"
    _assert_same(got[1], want[1])
    assert len(got_runs) == len(want_runs) > 0
    for (gs, gc), (ws, wc) in zip(got_runs, want_runs):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gc, wc)
    fs = split.stats.faults.as_dict()
    assert fs == whole.stats.faults.as_dict() and fs["injected"] > 0
    assert _modeled(split.stats) == _modeled(whole.stats)


# --- the tier replays cut by hand --------------------------------------------

def test_split_replays_equal_flat_replays():
    """The split interpreters over a (2, 2) channel mesh against the
    flattened ones, on tensors: K5's states, and K6's states and flip
    counts in the unit order."""
    rng = np.random.default_rng(5)
    ops = [("addition", 8), ("multiplication", 8), ("greater", 16),
           ("min", 8)]
    tabs = [ref_bank.cached_table(op, w)[2] for op, w in ops]
    width = max(t.shape[0] for t in tabs)
    tables = torch.from_numpy(np.stack([
        np.pad(t, ((0, width - t.shape[0]), (0, 0))) for t in tabs * 4
    ]).reshape(2, 4, 2, width, 13))
    states = torch.from_numpy(rng.integers(
        0, 2**32, (2, 4, 2, 64, 3), dtype=np.uint32).view(np.int32))
    mesh = Mesh((2, 2), ("channel", "data"), [CPU] * 4)
    split = cu.split_tier_interpreter(3, mesh, ("channel", "data"), "cpu")
    flat = cu.tier_interpreter(3, "cpu")
    round_ = split(states, tables)
    assert isinstance(round_, cu.SlabRound) and len(round_.slabs) == 4
    host, events = round_.to_host()
    assert events is None
    assert torch.equal(host.assemble(), flat(states, tables))
    keys = torch.from_numpy(rng.integers(0, 2**32, (2, 4, 2, 2),
                                         dtype=np.uint32).view(np.int32))
    stuck = torch.zeros((2, 4, 2, 3), dtype=torch.int32)
    dead = torch.zeros((2, 4, 2), dtype=torch.bool)
    dead[1, 2, 0] = True
    args = (states, tables, keys, stuck, stuck, dead, 0.01)
    s_split, c_split = cu.split_tier_interpreter(
        3, mesh, ("channel", "data"), "cpu", fault=True)(*args)
    s_flat, c_flat = cu.tier_interpreter(3, "cpu", fault=True)(*args)
    assert torch.equal(s_split, s_flat) and torch.equal(c_split, c_flat)
    assert int(c_flat.sum()) > 0


def test_split_round_device_time_is_its_longest_slab():
    """A traced split round adds the longest of its slabs' event pairs to
    the span's ``device_s``, once every pair has completed; launches
    outside a group add their own."""
    class Event:
        def __init__(self, t, done=True):
            self.t, self.done = t, done

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return end.t - self.t

    tr = pt_telemetry.Tracer()
    sp = tr.begin("chip.replay", cat="replay")
    with tr.launch_group():
        tr._launches += [(sp, Event(0.0), Event(2.0), tr._group),
                         (sp, Event(0.0), Event(5.0, done=False), tr._group)]
    tr._launches.append((sp, Event(0.0), Event(1.0), None))
    tr.resolve_device()
    assert sp.attrs["device_s"] == 1.0 / 1e3
    tr._launches[-1][2].done = True
    tr.resolve_device()
    assert sp.attrs["device_s"] == 1.0 / 1e3 + 5.0 / 1e3
    assert not tr._launches


# --- the forced-device subprocesses (slow, as the reference marks them) -----

def _run_script(body: str) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


_QUEUE = """
    import numpy as np
    import torch
    from repro_torch.core.bank import BbopInstr, Ref, flatten_result
    from repro_torch.core.ops_library import get_op
    from repro_torch.launch.mesh import Mesh

    rng = np.random.default_rng(0)
    queue = []
    for op in ("addition", "multiplication", "greater", "xor_red"):
        spec = get_op(op, 8)
        ops = tuple(rng.integers(0, 1 << w, 64).astype(np.uint64)
                    for w in spec.operand_bits)
        queue.append(BbopInstr(op, ops, 8))
    queue.append(BbopInstr("relu", (Ref(0),), 8))

    def same(*runs):
        for rs in zip(*runs):
            for xs in zip(*(flatten_result(r) for r in rs)):
                for x in xs[1:]:
                    np.testing.assert_array_equal(xs[0], x)
"""


@pytest.mark.slow
def test_chip_sharded_executor_forced_devices_subprocess():
    """The chip split over 4 CPU positions in a fresh process, against
    the sequential per-bank drain."""
    out = _run_script(_QUEUE + """
    from repro_torch.core.chip import SimdramChip, sequential_dispatch
    from repro_torch.distributed.pum import pum_mesh
    chip = SimdramChip(n_banks=4, n_subarrays=2, use_shard_map=True,
                       mesh=pum_mesh(4, [torch.device("cpu")] * 4),
                       device="cpu")
    assert chip.executor.sharded
    rs, _ = sequential_dispatch(queue, 4, 2, device="cpu")
    same(chip.dispatch(queue), rs)
    print("SHARDED_CHIP_OK", chip.executor.mesh.shape["data"])
    """)
    assert "SHARDED_CHIP_OK 4" in out


@pytest.mark.slow
def test_channel_sharded_executor_forced_devices_subprocess():
    """The channel split over a (2, 4) mesh of CPU positions in a fresh
    process, against the unsplit channel and the sequential drain."""
    out = _run_script(_QUEUE + """
    from repro_torch.core.channel import (SimdramChannel,
                                          sequential_channel_dispatch)
    from repro_torch.distributed.pum import channel_mesh
    sharded = SimdramChannel(n_chips=2, n_banks=4, n_subarrays=2,
                             use_shard_map=True, device="cpu",
                             mesh=channel_mesh(2, 4,
                                               [torch.device("cpu")] * 8))
    mesh = sharded.executor.mesh
    assert mesh.shape["channel"] == 2 and mesh.shape["data"] == 4
    fallback = SimdramChannel(n_chips=2, n_banks=4, n_subarrays=2,
                              use_shard_map=False, device="cpu")
    rs, _ = sequential_channel_dispatch(queue, 2, 4, 2, device="cpu")
    same(sharded.dispatch(queue), fallback.dispatch(queue), rs)
    print("SHARDED_CHANNEL_OK", mesh.shape["channel"], mesh.shape["data"])
    """)
    assert "SHARDED_CHANNEL_OK 2 4" in out


@pytest.mark.slow
def test_rank_sharded_executor_forced_devices_subprocess():
    """The rank split over a (2, 2, 2) mesh of CPU positions in a fresh
    process, against the unsplit rank and the sequential per-channel
    drain."""
    out = _run_script(_QUEUE + """
    from repro_torch.core.rank import SimdramRank, sequential_rank_dispatch
    from repro_torch.distributed.pum import rank_mesh
    sharded = SimdramRank(n_channels=2, n_chips=2, n_banks=2, n_subarrays=2,
                          use_shard_map=True, device="cpu",
                          mesh=rank_mesh(2, 2, 2, [torch.device("cpu")] * 8))
    mesh = sharded.executor.mesh
    assert [mesh.shape[a] for a in ("rank", "channel", "data")] == [2, 2, 2]
    fallback = SimdramRank(n_channels=2, n_chips=2, n_banks=2,
                           n_subarrays=2, use_shard_map=False, device="cpu")
    rs, _ = sequential_rank_dispatch(queue, 2, 2, 2, 2, device="cpu")
    same(sharded.dispatch(queue), fallback.dispatch(queue), rs)
    print("SHARDED_RANK_OK", mesh.shape["rank"], mesh.shape["channel"],
          mesh.shape["data"])
    """)
    assert "SHARDED_RANK_OK 2 2 2" in out
